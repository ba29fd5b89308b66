"""Model zoo of the port: the dense decoder (transformer.py) for now.

All GEMMs route through the configurable matrix engine
(:func:`repro_torch.models.common.matmul`).
"""

from __future__ import annotations

import torch

from ..config import RunConfig
from .common import resolve_device
from .convert import params_from_jax
from .transformer import DecodeState, DenseTransformer, init_params


def build_model(cfg: RunConfig, device="cuda", seed: int = 0) -> DenseTransformer:
    """The model of ``cfg`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return DenseTransformer(cfg, init_params(cfg.model, gen, device))


__all__ = ["build_model", "params_from_jax", "resolve_device",
           "DenseTransformer", "DecodeState"]
