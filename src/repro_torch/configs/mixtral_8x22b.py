"""mixtral-8x22b — 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
Sliding-window attention (window 4096) ⇒ eligible for long_500k with a
rotating KV cache bounded by the window.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    attn_pattern="sliding",
    sliding_window=4096,
    mlp_type="swiglu",
    num_experts=8,
    experts_per_token=2,
    optimizer="adamw",
    grad_accum_train=16,
    seq_shard_train=True,
)
