"""gemma3-27b — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-*; unverified].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.  Every 6th layer
is global attention; local layers use a 1024-token sliding window (the
Gemma-3 report's local window).  GeGLU MLP, RMSNorm, logit softcapping.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=168,
    attn_pattern="local_global",
    local_global_ratio=5,
    sliding_window=1024,
    mlp_type="geglu",
    logit_softcap=30.0,
    rope_theta=1e6,
    tie_embeddings=True,
    optimizer="adamw",
)
