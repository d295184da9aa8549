"""Architecture registry: ``get_config("<arch-id>")``.

Every architecture of the reference's registry: the dense zoo
(gemma3-1b, gemma2-2b, granite-8b, qwen1.5-4b), the MoE family
(grok-1-314b, deepseek-v3-671b), the SSM family (mamba2-2.7b and the
hybrid jamba-1.5-large-398b), the vision-prefix llava-next-34b and the
encoder-decoder seamless-m4t-large-v2; ``"paper-mlp"`` gives the
paper's MLP config, as the reference's registry does.  An unknown name
raises ``KeyError`` and lists the known ones.
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
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "paper-mlp": "paper_mlp",
}

ARCH_NAMES = tuple(n for n in _MODULES if n != "paper-mlp")

__all__ = ["ArchConfig", "EncoderConfig", "LayerSpec", "MLAConfig",
           "MoEConfig", "SSMConfig", "ARCH_NAMES", "get_config"]


def get_config(name: str):
    """The :class:`ArchConfig` of ``name`` (``_`` may stand for ``-``), or
    the paper MLP's ``MLPConfig`` for ``"paper-mlp"``."""
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{', '.join(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG
