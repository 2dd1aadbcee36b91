"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0 means the xLSTM
blocks carry their own pre/post projections (projection factor 2 for
mLSTM); there is no separate MLP.  We use the xLSTM[7:1]-style mix: one
sLSTM block every 4 layers (3 of 12), the rest mLSTM.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    ssm_state=0,            # mLSTM matrix memory is (head_dim x head_dim)
    ssm_expand=2,
    slstm_every=4,
    optimizer="adamw",
)
