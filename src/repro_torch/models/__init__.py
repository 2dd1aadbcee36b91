"""Architecture zoo on PyTorch: every family of the config registry,
ParamSpec-based.

* :mod:`repro_torch.models.params` — specs, initialisation, counts.
* :mod:`repro_torch.models.layers` — norms, RoPE, attention (self and
  cross), MLPs, head.
* :mod:`repro_torch.models.moe` — the top-k Mixture-of-Experts block.
* :mod:`repro_torch.models.ssm` — Mamba-2, mLSTM and sLSTM blocks.
* :mod:`repro_torch.models.lm` — :class:`LM`, the decoder of the dense,
  vlm, MoE, SSM and hybrid families.
* :mod:`repro_torch.models.encdec` — :class:`EncDecLM`, the
  encoder-decoder (seamless-m4t-large-v2).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import LM

__all__ = ["build_model", "LM", "EncDecLM"]


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                generator: Optional[torch.Generator] = None) -> LM | EncDecLM:
    """Factory: the model of an ArchConfig, its parameters on ``device``."""
    model = EncDecLM if cfg.is_encdec else LM
    return model(cfg, device=device, generator=generator)
