"""Architecture zoo on PyTorch: the decoder LM of every layer kind (the
dense, vlm, MoE, SSM and hybrid families), ParamSpec-based.

* :mod:`repro_torch.models.params` — specs, initialisation, counts.
* :mod:`repro_torch.models.layers` — norms, RoPE, attention, MLPs, head.
* :mod:`repro_torch.models.moe` — the top-k Mixture-of-Experts block.
* :mod:`repro_torch.models.ssm` — Mamba-2, mLSTM and sLSTM blocks.
* :mod:`repro_torch.models.lm` — :class:`LM`.

The encoder-decoder family (seamless-m4t-large-v2) raises
``NotImplementedError`` (ROADMAP.md §1 item 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM, not_ported

__all__ = ["build_model", "LM"]


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda",
                generator: Optional[torch.Generator] = None) -> LM:
    """Factory: the model of an ArchConfig, its parameters on ``device``."""
    if cfg.is_encdec:
        raise not_ported("encdec", cfg)
    return LM(cfg, device=device, generator=generator)
