"""zamba2-1.2b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 (padded 32256),
ssm_state=64.  Mamba2 (SSD) layers with ONE shared full-attention block
applied every 6 layers (Zamba2 interleaves shared blocks; we use a single
shared block).  Hybrid ⇒ long_500k eligible.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    shared_attn_every=6,
    mlp_type="swiglu",
    optimizer="adamw",
)
