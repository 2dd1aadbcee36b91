"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded 92672).
The InternViT-6B vision frontend is a STUB per the assignment: input_specs
provides precomputed patch embeddings (256 tokens × 3200) which a linear
projector maps into the LM's embedding space.  Full attention (skip
long_500k).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    attn_pattern="global",
    mlp_type="swiglu",
    frontend="vit_stub",
    frontend_tokens=256,
    frontend_dim=3200,
    optimizer="adamw",
    seq_shard_train=True,
)
