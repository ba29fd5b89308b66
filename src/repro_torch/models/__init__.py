"""Model zoo of the port: the decoder of the dense, moe, vlm and audio
families (transformer.py, moe.py) and the ssm / hybrid language models
(ssm_lm.py).

All GEMMs route through the configurable matrix engine
(:func:`repro_torch.models.common.matmul`).
"""

from __future__ import annotations

import torch

from ..config import RunConfig
from . import ssm_lm, transformer
from .common import resolve_device
from .convert import params_from_jax
from .ssm_lm import HybridState, SSMLanguageModel
from .transformer import DecodeState, Transformer

#: either model class, the port's counterpart of the reference's ModelApi:
#: the same loss / prefill / decode_step / init_decode_state (parameters
#: are made trainable by ``training.init_train_state``)
Model = Transformer | SSMLanguageModel


def build_model(cfg: RunConfig, device="cuda", seed: int = 0) -> Model:
    """The model of ``cfg`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model_of(cfg, init_params(cfg, gen, device))


def init_params(cfg: RunConfig, gen: torch.Generator, device) -> dict:
    """The parameters of ``cfg``'s model family, drawn from ``gen`` on
    ``device`` ("meta" draws nothing and allocates nothing)."""
    transformer.check_family(cfg.model, (*transformer.FAMILIES, *ssm_lm.SSM_FAMILIES))
    family = ssm_lm if cfg.model.family in ssm_lm.SSM_FAMILIES else transformer
    return family.init_params(cfg.model, gen, device)


def model_of(cfg: RunConfig, params: dict) -> Model:
    """The model class of ``cfg``'s family around ``params`` (of
    ``init_params``)."""
    if cfg.model.family in ssm_lm.SSM_FAMILIES:
        return SSMLanguageModel(cfg, params)
    return Transformer(cfg, params)


__all__ = ["build_model", "init_params", "model_of", "params_from_jax", "resolve_device",
           "Model", "Transformer", "DecodeState", "SSMLanguageModel", "HybridState"]
