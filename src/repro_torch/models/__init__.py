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
    transformer.check_family(cfg.model, (*transformer.FAMILIES, *ssm_lm.SSM_FAMILIES))
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.model.family in ssm_lm.SSM_FAMILIES:
        return SSMLanguageModel(cfg, ssm_lm.init_params(cfg.model, gen, device))
    return Transformer(cfg, transformer.init_params(cfg.model, gen, device))


__all__ = ["build_model", "params_from_jax", "resolve_device", "Model",
           "Transformer", "DecodeState", "SSMLanguageModel", "HybridState"]
