"""Decoder-only transformer backbone, dense family.

Counterpart of the JAX package's ``models/transformer.py``.  The model is an
``nn.Module`` (``DenseTransformer``) holding a ``ModuleList`` of decoder
blocks; the layer loop is a plain Python loop (the reference scans over
stacked [L, ...] parameters; ``convert.params_from_jax`` unstacks them).
Parameters keep the reference's names and [in, out] layouts, and are
inference-only (``requires_grad=False``).  The ssm and hybrid families live
in ``ssm_lm.py``; the moe, vlm and audio families wait for ROADMAP queue 1,
item 8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import EngineConfig, ModelConfig, RunConfig
from .common import dtype_of, embed_init, he_init, matmul
from .layers import (KVCache, attention_block, mlp_block, rms_norm, rope_freqs,
                     rope_from_freqs)

_LATER_FAMILIES = {"moe": "ROADMAP queue 1, item 8 (MoE)",
                   "vlm": "ROADMAP queue 1, item 8 (VLM)",
                   "audio": "ROADMAP queue 1, item 8 (audio)"}


def check_family(cfg: ModelConfig, families: tuple[str, ...] = ("dense",)) -> None:
    """Raise unless ``cfg.family`` is one of ``families``."""
    if cfg.family in _LATER_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{_LATER_FAMILIES[cfg.family]}")
    if cfg.family not in families:
        raise ValueError(f"family {cfg.family!r} is not one of {families}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamBlock(nn.Module):
    """One layer's parameters, under the reference's names."""

    def __init__(self, params_l: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in params_l.items():
            self.register_parameter(name, _param(t))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters


# ------------------------------------------------------------------- params


def init_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                      device) -> dict[str, torch.Tensor]:
    """One layer's parameters (the reference's names, without the [L] dim)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    init = lambda shape, fan_in: he_init(gen, shape, dtype, fan_in, device)
    p = {
        "norm1": zeros(d),
        "wq": init((d, cfg.n_heads * hd), d),
        "wk": init((d, cfg.n_kv_heads * hd), d),
        "wv": init((d, cfg.n_kv_heads * hd), d),
        "wo": init((cfg.n_heads * hd, d), cfg.n_heads * hd),
        "norm2": zeros(d),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(hd)
        p["k_norm"] = zeros(hd)
    f = cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    if gated and cfg.fuse_gate_up:
        p["w_gate_up"] = init((d, 2, f), d)
    else:
        if gated:
            p["w_gate"] = init((d, f), d)
        p["w_up"] = init((d, f), d)
    p["w_down"] = init((f, d), f)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device) -> dict:
    """Random parameters from ``gen``: {"embedding", "layers": [dict per
    layer], "final_norm", "lm_head" (untied only)}."""
    check_family(cfg)
    dtype = dtype_of(cfg)
    d = cfg.d_model
    params = {
        "embedding": embed_init(gen, (cfg.vocab, d), dtype, device),
        "layers": [init_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(d, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (d, cfg.vocab), dtype, d, device)
    return params


# ------------------------------------------------------------------ blocks


def decoder_block(params_l, x: torch.Tensor, cfg: ModelConfig,
                  engine: EngineConfig, sin, cos,
                  cache: Optional[KVCache] = None):
    """Pre-norm block; returns (x, new_cache)."""
    h = rms_norm(x, params_l["norm1"], cfg.rms_eps)
    attn_out, new_cache = attention_block(params_l, h, cfg, engine, sin, cos,
                                          cache)
    x = x + attn_out
    h = rms_norm(x, params_l["norm2"], cfg.rms_eps)
    return x + mlp_block(params_l, h, cfg, engine), new_cache


class DecoderBlock(ParamBlock):
    """One decoder layer's parameters; calling it runs the block."""

    def forward(self, x, cfg, engine, sin, cos, cache=None):
        return decoder_block(self, x, cfg, engine, sin, cos, cache)


def run_layers(blocks: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
               engine: EngineConfig, sin, cos,
               caches: Optional[list[KVCache]] = None) -> torch.Tensor:
    """The decoder stack as a Python loop; the caches, when given, are
    filled in place."""
    for i, block in enumerate(blocks):
        x, _ = block(x, cfg, engine, sin, cos, None if caches is None else caches[i])
    return x


# ---------------------------------------------------------------- embedding


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, S] -> [B, S, D]."""
    return embedding[tokens.long()]


def positions_for(batch: int, seq: int, offset: int | torch.Tensor = 0,
                  device=None) -> torch.Tensor:
    """[B, S] positions offset..offset+seq-1; ``offset`` may be a 0-d device
    tensor (the decode position), read on the device."""
    pos = torch.arange(seq, device=device)[None, :] + offset
    return pos.expand(batch, seq)


# ------------------------------------------------------------------ serving


def logits_from(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head (the embedding, transposed, when tied) of
    either family's model; fp32 logits."""
    m = model.cfg.model
    x = rms_norm(x, model.final_norm, m.rms_eps)
    head = model.embedding.T if m.tie_embeddings else model.lm_head
    return matmul(x, head, model.cfg.engine, out_dtype=torch.float32)


class DecodeState(NamedTuple):
    """Updated in place by prefill and decode_step, so a replayed CUDA graph
    sees the new values."""
    caches: list[KVCache]      # one per layer, views of the stacked buffers
    position: torch.Tensor     # next position, int32 0-d (uniform over the batch)
    buffers: tuple[torch.Tensor, ...]   # stacked k, v [L, ...] and lengths [L]

    def zero_(self) -> None:
        """Back to the state init_decode_state made, in place."""
        for t in (*self.buffers, self.position):
            t.zero_()


class DenseTransformer(nn.Module):
    """The dense decoder: embedding, ``ModuleList`` of blocks, final norm,
    and an LM head (tied to the embedding when the config says so)."""

    def __init__(self, cfg: RunConfig, params: dict):
        super().__init__()
        check_family(cfg.model)
        self.cfg = cfg
        self.embedding = _param(params["embedding"])
        self.layers = nn.ModuleList(DecoderBlock(p) for p in params["layers"])
        self.final_norm = _param(params["final_norm"])
        if not cfg.model.tie_embeddings:
            self.lm_head = _param(params["lm_head"])
        m = cfg.model
        self.register_buffer("rope_freqs", rope_freqs(
            m.resolved_head_dim, m.rope_theta, self.device), persistent=False)

    @property
    def model(self) -> ModelConfig:
        return self.cfg.model

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def _rope(self, batch: int, seq: int, offset: int | torch.Tensor):
        return rope_from_freqs(positions_for(batch, seq, offset, self.device),
                               self.rope_freqs)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype: torch.dtype | None = None) -> DecodeState:
        m = self.model
        shape = (m.n_layers, batch, m.n_kv_heads, max_seq, m.resolved_head_dim)
        dtype = dtype or dtype_of(m)
        k = torch.zeros(shape, dtype=dtype, device=self.device)
        v = torch.zeros(shape, dtype=dtype, device=self.device)
        lengths = torch.zeros(m.n_layers, dtype=torch.int32, device=self.device)
        position = torch.zeros((), dtype=torch.int32, device=self.device)
        return DecodeState([KVCache(k[i], v[i], lengths[i]) for i in range(m.n_layers)],
                           position, (k, v, lengths))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
        """Run the prompt [B, S] through the stack, filling the caches and
        setting the position in place; returns the last position's logits
        [B, V] and the state."""
        b, s = tokens.shape
        x = embed_tokens(self.embedding, tokens)
        sin, cos = self._rope(b, s, 0)
        x = run_layers(self.layers, x, self.model, self.cfg.engine, sin, cos,
                       state.caches)
        logits = logits_from(self, x[:, -1:])
        state.position.fill_(s)
        return logits[:, 0], state

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor,
                    state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
        """One decode step: token [B] -> logits [B, V]; the state advances
        in place by one position."""
        b = token.shape[0]
        x = embed_tokens(self.embedding, token[:, None])
        sin, cos = self._rope(b, 1, state.position)
        x = run_layers(self.layers, x, self.model, self.cfg.engine, sin, cos,
                       state.caches)
        logits = logits_from(self, x)
        state.position.add_(1)
        return logits[:, 0], state
