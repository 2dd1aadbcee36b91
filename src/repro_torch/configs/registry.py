"""Architecture registry: ``--arch <id>`` resolution for every driver."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "nemotron-4-340b": "repro_torch.configs.nemotron4_340b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe_42b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {aid: get_config(aid) for aid in ARCH_IDS}
