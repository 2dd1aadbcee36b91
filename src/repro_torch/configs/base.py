"""Architecture & shape configuration dataclasses (a copy of the JAX
package's ``configs/base.py``; no field or default differs).

Every assigned architecture is a frozen :class:`ArchConfig`; the four
input-shape cells are :class:`ShapeConfig`.  ``reduced()`` produces the
same-family tiny config of the per-arch CPU parity tests; it is kept
bit-for-bit, since those tests hold the port to the JAX package on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "shape_by_name"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // num_heads

    # attention pattern
    attn_pattern: str = "global"     # global | sliding | local_global
    sliding_window: int = 4096
    local_global_ratio: int = 5      # local:global when attn_pattern=local_global
    rope_theta: float = 1e4

    # block family details
    mlp_type: str = "swiglu"         # swiglu | geglu | squared_relu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0             # xLSTM: one sLSTM block every N layers
    shared_attn_every: int = 0       # Zamba2: shared attention block period

    # encoder-decoder
    enc_layers: int = 0              # >0 => encoder-decoder

    # modality frontend stub
    frontend: Optional[str] = None   # vit_stub | audio_stub
    frontend_tokens: int = 0         # image patch tokens per example
    frontend_dim: int = 0            # stub embedding dim

    # training details
    optimizer: str = "adamw"         # adamw | adafactor
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False

    # dry-run tuning (per-shape grad accumulation chosen in launch/steps.py)
    grad_accum_train: int = 8
    # sequence-parallel activations at scan boundaries (SP): shards the
    # saved layer-boundary activations over the model axis of a mesh
    # (LM.forward_train's constrain at each period's end)
    seq_shard_train: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must divide by num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 for clean TP sharding."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (non-full attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_pattern in ("sliding", "local_global")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, derived from the family/pattern fields."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                if self.slstm_every and (i + 1) % self.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "hybrid":
                kinds.append("mamba")      # shared attn handled separately
            elif self.family == "moe":
                kinds.append("attn_moe")
            else:
                kinds.append("attn_mlp")
        return tuple(kinds)

    def attn_layer_is_local(self, i: int) -> bool:
        if self.attn_pattern == "sliding":
            return True
        if self.attn_pattern == "local_global":
            return (i + 1) % (self.local_global_ratio + 1) != 0
        return False

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4) if not self.slstm_every
            else 4,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads
            < self.num_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            slstm_every=2 if self.slstm_every else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
            frontend_dim=64 if self.frontend_dim else 0,
            sliding_window=16,
            # alternate local/global so the reduced config still exercises
            # both attention paths within its 4 layers
            local_global_ratio=1 if self.attn_pattern == "local_global"
            else self.local_global_ratio,
            grad_accum_train=1,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
