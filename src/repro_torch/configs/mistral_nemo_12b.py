"""mistral-nemo-12b — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  Full attention
(skip long_500k).  SwiGLU, RMSNorm, rope theta 1e6 for long context.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    attn_pattern="global",
    mlp_type="swiglu",
    rope_theta=1e6,
    optimizer="adamw",
)
