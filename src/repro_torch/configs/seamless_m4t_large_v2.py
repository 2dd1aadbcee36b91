"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (padded to 256256 for
TP).  Encoder-decoder: 24 encoder + 24 decoder layers (the text backbone;
the speech frontend is a stub that supplies precomputed frame embeddings
per the assignment spec).  Full attention decoder → long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,            # decoder layers
    enc_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    attn_pattern="global",
    mlp_type="gelu",
    norm_type="layernorm",
    frontend="audio_stub",
    frontend_dim=1024,
    optimizer="adamw",
)
