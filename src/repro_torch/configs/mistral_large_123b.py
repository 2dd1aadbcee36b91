"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.  Full attention
(skip long_500k).  SwiGLU, RMSNorm.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    attn_pattern="global",
    mlp_type="swiglu",
    optimizer="adamw",
    grad_accum_train=16,
    seq_shard_train=True,
)
