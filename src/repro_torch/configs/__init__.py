"""Architecture registry: ``--arch <id>`` -> RunConfig (FULL or SMOKE),
plus the (arch x shape) cell definitions.

The ten config modules are the port's own copies of the JAX package's
pure-dataclass configs; a parity test holds them equal field by field.
"""

from __future__ import annotations

import torch

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

#: stub vision frontend: number of (precomputed) patch embeddings per sample
VLM_PATCHES = 256


def get_config(arch: str, smoke: bool = False) -> RunConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_NAMES}")
    return _MODULES[arch].SMOKE if smoke else _MODULES[arch].FULL


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Is (arch x shape) a valid cell?  Returns (ok, reason-if-not).

    long_500k requires sub-quadratic attention; all ten archs are
    decoder-style so decode/prefill shapes run everywhere.
    """
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.model.subquadratic:
        return False, ("full-attention arch: 512k dense-KV decode is "
                       "quadratic-cost; skipped per shape definition")
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch, shape, applicable, reason) for the 40 cells."""
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            ok, why = cell_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why


def input_specs(cfg: RunConfig, shape: str, seq_len: int | None = None,
                global_batch: int | None = None) -> dict:
    """Stand-ins for every model input of a shape cell: meta tensors of the
    inputs' shapes and dtypes (no allocation).

    train/prefill: token batches; decode: a single new token per sequence.
    """
    s, b, kind = SHAPES[shape]
    s = seq_len or s
    b = global_batch or b
    m = cfg.model
    spec = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        if m.family == "audio":
            return {"tokens": spec(b, s, m.n_codebooks), "labels": spec(b, s, m.n_codebooks)}
        if m.family == "vlm":
            st = s - VLM_PATCHES
            return {"tokens": spec(b, st), "labels": spec(b, st),
                    "patch_embeds": spec(b, VLM_PATCHES, m.d_model, dtype=torch.bfloat16)}
        return {"tokens": spec(b, s), "labels": spec(b, s)}

    if kind == "prefill":
        if m.family == "audio":
            return {"tokens": spec(b, s, m.n_codebooks)}
        return {"tokens": spec(b, s)}

    # decode: one new token; cache length s
    if m.family == "audio":
        return {"token": spec(b, m.n_codebooks)}
    return {"token": spec(b)}


__all__ = ["ARCH_NAMES", "VLM_PATCHES", "get_config", "cell_applicable", "all_cells",
           "input_specs", "SHAPES"]
