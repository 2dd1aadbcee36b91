"""nemotron-4-340b — GQA, squared-ReLU MLP [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  Full attention
(skip long_500k).  Adafactor optimizer, as the JAX package chose it for
this arch's optimizer state.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    attn_pattern="global",
    mlp_type="squared_relu",
    norm_type="layernorm",
    optimizer="adafactor",
    grad_accum_train=16,
    seq_shard_train=True,
)
