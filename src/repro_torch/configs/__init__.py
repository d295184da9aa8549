"""Architecture registry: ``get_config("<arch-id>")``.

Only the architectures the port serves and trains are registered (the
dense zoo: gemma3-1b, gemma2-2b, granite-8b and qwen1.5-4b; the MoE
family: grok-1-314b and deepseek-v3-671b; the SSM family: mamba2-2.7b
and the hybrid jamba-1.5-large-398b); the others are still on
ROADMAP.md's queue and raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from .common import (ArchConfig, EncoderConfig, LayerSpec, MLAConfig,
                     MoEConfig, SSMConfig)

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "gemma2-2b": "gemma2_2b",
    "granite-8b": "granite_8b",
    "qwen1.5-4b": "qwen15_4b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-2.7b": "mamba2_27b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
}

ARCH_NAMES = tuple(_MODULES)

__all__ = ["ArchConfig", "EncoderConfig", "LayerSpec", "MLAConfig",
           "MoEConfig", "SSMConfig", "ARCH_NAMES", "get_config"]


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet (ported: "
            f"{', '.join(ARCH_NAMES)}); see ROADMAP.md for the port's queue")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG
