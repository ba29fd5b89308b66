"""Carry the JAX package's parameters over into the port's model.

``jax.random`` cannot be reproduced in torch, so parity with the reference
uses the reference's own initialised weights.  The tree comes in as numpy
arrays (``jax.tree.map(np.asarray, params)``) with stacked [L, ...] layer
leaves (the MoE's expert weights [L, E, ...] unstack like any other; the
hybrid's ``shared_attn`` and the vision frontend's ``patch_proj`` are not
stacked); bf16
(``ml_dtypes.bfloat16``) is copied bit for bit through an int16 view, and
f32 leaves (the SSM's ``dt_bias``, ``A_log``, ``D_skip``) stay f32.
Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import RunConfig
from .common import resolve_device
from .ssm_lm import SSM_FAMILIES, SSMLanguageModel
from .transformer import FAMILIES, Transformer, check_family


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy array (bf16 via ml_dtypes, or a numpy dtype) as a torch tensor,
    bit for bit."""
    a = np.array(a, order="C")  # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: RunConfig, tree: dict,
                    device="cuda") -> Transformer | SSMLanguageModel:
    """The port's model holding the reference's parameters ``tree``."""
    check_family(cfg.model, (*FAMILIES, *SSM_FAMILIES))
    device = resolve_device(device)
    conv = lambda a: tensor_from_numpy(a, device)
    layers = tree["layers"]
    params = {
        "embedding": conv(tree["embedding"]),
        "layers": [{name: conv(leaf[i]) for name, leaf in layers.items()}
                   for i in range(cfg.model.n_layers)],
        "final_norm": conv(tree["final_norm"]),
    }
    for name in ("lm_head", "patch_proj"):
        if name in tree:
            params[name] = conv(tree[name])
    if cfg.model.family in SSM_FAMILIES:
        if "shared_attn" in tree:
            params["shared_attn"] = {name: conv(leaf)
                                     for name, leaf in tree["shared_attn"].items()}
        return SSMLanguageModel(cfg, params)
    return Transformer(cfg, params)
