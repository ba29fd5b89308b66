"""Architecture registry: ``--arch <id>`` -> RunConfig (FULL or SMOKE).

The ten config modules are the port's own copies of the JAX package's
pure-dataclass configs; a parity test holds them equal field by field.
"""

from __future__ import annotations

from ..config import RunConfig, SHAPES
from . import (gemma_2b, gemma_7b, granite_moe_3b_a800m, grok_1_314b,
               mamba2_130m, musicgen_large, nemotron_4_15b, qwen2_vl_72b,
               qwen3_1_7b, zamba2_2_7b)

_MODULES = {
    "qwen2-vl-72b": qwen2_vl_72b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen3-1.7b": qwen3_1_7b,
    "gemma-2b": gemma_2b,
    "gemma-7b": gemma_7b,
    "musicgen-large": musicgen_large,
    "mamba2-130m": mamba2_130m,
    "grok-1-314b": grok_1_314b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCH_NAMES = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> RunConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_NAMES}")
    return _MODULES[arch].SMOKE if smoke else _MODULES[arch].FULL


__all__ = ["ARCH_NAMES", "get_config", "SHAPES"]
