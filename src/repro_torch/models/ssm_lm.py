"""Pure-SSM language model (mamba2-130m) and the Zamba2-style hybrid.

Counterpart of the JAX package's ``models/ssm_lm.py``.  hybrid (zamba2):
all layers are Mamba2 blocks; ONE shared attention+MLP block (a single
weight set) is applied after every ``attn_every`` Mamba layers, each
application with its own KV cache (the reference's single-shared-block
simplification of Zamba2).  The layer loop is a plain Python loop (the
reference's scanned and unrolled forms give the same numbers).  Serving
runs ``prefill``/``decode_step`` on a ``HybridState`` updated in place;
training runs ``loss`` on a stateless backbone (``run_backbone_train``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import EngineConfig, ModelConfig, RunConfig
from ..distributed.sharding import constrain, place_state, shard_like
from .common import dtype_of, embed_init, he_init
from .layers import (KVCache, attention_block, mlp_block, rms_norm, rope_freqs,
                     rope_from_freqs)
from .ssm import SSMState, init_ssm_state, mamba2_block, ssm_dims
from .transformer import (ParamBlock, _param, batch_tensor, check_family,
                          embed_tokens, head_loss, logits_from, positions_for,
                          remat)

SSM_FAMILIES = ("ssm", "hybrid")


# ------------------------------------------------------------------- params


def init_mamba_layer_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                            device) -> dict[str, torch.Tensor]:
    """One Mamba2 layer's parameters (the reference's names, without the
    [L] dim); dt_bias, A_log and D_skip are f32 as in the reference."""
    d = cfg.d_model
    s = cfg.ssm
    d_inner, n_heads, conv_ch = ssm_dims(cfg)
    proj = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    dt0 = torch.linspace(0.001, 0.1, n_heads, **f32)
    return {
        "norm1": torch.zeros(d, dtype=dtype, device=device),
        "in_proj": he_init(gen, (d, proj), dtype, d, device),
        "conv_w": he_init(gen, (s.d_conv, conv_ch), dtype, s.d_conv, device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "A_log": torch.log(torch.arange(1, n_heads + 1, **f32)),
        "D_skip": torch.ones(n_heads, **f32),
        "ssm_norm": torch.zeros(d_inner, dtype=dtype, device=device),
        "out_proj": he_init(gen, (d_inner, d), dtype, d_inner, device),
    }


def init_shared_attn_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                            device) -> dict[str, torch.Tensor]:
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    init = lambda shape, fan_in: he_init(gen, shape, dtype, fan_in, device)
    return {
        "norm1": torch.zeros(d, dtype=dtype, device=device),
        "wq": init((d, cfg.n_heads * hd), d),
        "wk": init((d, cfg.n_kv_heads * hd), d),
        "wv": init((d, cfg.n_kv_heads * hd), d),
        "wo": init((cfg.n_heads * hd, d), cfg.n_heads * hd),
        "norm2": torch.zeros(d, dtype=dtype, device=device),
        "w_gate": init((d, f), d),
        "w_up": init((d, f), d),
        "w_down": init((f, d), f),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters from ``gen``: {"embedding", "layers": [dict per
    layer], "final_norm", "lm_head" (untied only), "shared_attn" (hybrid)}."""
    check_family(cfg, SSM_FAMILIES)
    dtype = dtype_of(cfg)
    params = {
        "embedding": embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device),
        "layers": [init_mamba_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab), dtype,
                                    cfg.d_model, device)
    if cfg.family == "hybrid":
        params["shared_attn"] = init_shared_attn_params(cfg, gen, dtype, device)
    return params


# ------------------------------------------------------------------ forward


class HybridState(NamedTuple):
    """Updated in place by prefill and decode_step, so a replayed CUDA graph
    sees the new values."""
    ssm: SSMState              # stacked [L, ...] leaves
    attn: list[KVCache]        # one per shared-block application
    position: torch.Tensor     # next position, int32 0-d (uniform over the batch)
    buffers: tuple[torch.Tensor, ...]   # stacked k, v [apps, ...] and lengths [apps]

    def zero_(self) -> None:
        """Back to the state init_decode_state made, in place."""
        for t in (*self.ssm, *self.buffers, self.position):
            t.zero_()


def n_shared_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every if cfg.family == "hybrid" else 0


def _shared_block(sp, x: torch.Tensor, cfg: ModelConfig, engine: EngineConfig,
                  sin, cos, cache: Optional[KVCache]):
    h = rms_norm(x, sp["norm1"], cfg.rms_eps)
    attn_out, new_cache = attention_block(sp, h, cfg, engine, sin, cos, cache)
    x = constrain(x + attn_out, "btd")
    h = rms_norm(x, sp["norm2"], cfg.rms_eps)
    return constrain(x + mlp_block(sp, h, cfg, engine), "btd"), new_cache


def run_backbone(model: "SSMLanguageModel", x: torch.Tensor, state: HybridState,
                 sin=None, cos=None):
    """Mamba2 layers in order; hybrid: the shared block after every
    ``attn_every`` of them.  Each layer's conv window and SSM state are
    written back into the state's stacked buffers in place, and each
    application's KV cache is filled in place.  Returns x."""
    cfg, engine = model.model, model.cfg.engine
    every = cfg.hybrid.attn_every if cfg.family == "hybrid" else 0
    for i, layer in enumerate(model.layers):
        st_l = SSMState(state.ssm.conv[i], state.ssm.ssm[i])
        out, new_st = mamba2_block(layer, rms_norm(x, layer["norm1"], cfg.rms_eps),
                                   cfg, engine, st_l)
        x = constrain(x + out, "btd")
        for dst, new in ((st_l.conv, new_st.conv), (st_l.ssm, new_st.ssm)):
            dst, new = shard_like(new, dst)
            dst.copy_(new)
        if every and (i + 1) % every == 0:
            x, _ = _shared_block(model.shared_attn, x, cfg, engine, sin, cos,
                                 state.attn[i // every])
    return x


def run_backbone_train(model: "SSMLanguageModel", x: torch.Tensor, sin=None, cos=None,
                       policy: str = "full") -> torch.Tensor:
    """The backbone with no state, for training: every Mamba2 layer runs the
    chunked SSD from a zero state, the hybrid's shared block attends
    causally over x with no cache, and each of them is rematerialised per
    ``remat(policy)`` (the reference also nests each group of layers in a
    checkpoint, which changes only memory).  Returns x."""
    cfg, engine = model.model, model.cfg.engine
    every = cfg.hybrid.attn_every if cfg.family == "hybrid" else 0

    def mamba_layer(layer, h):
        out, _ = mamba2_block(layer, rms_norm(h, layer["norm1"], cfg.rms_eps), cfg, engine)
        return constrain(h + out, "btd")

    def shared(h, sin, cos):
        return _shared_block(model.shared_attn, h, cfg, engine, sin, cos, None)[0]

    mamba_layer, shared = remat(mamba_layer, policy), remat(shared, policy)
    for i, layer in enumerate(model.layers):
        x = mamba_layer(layer, x)
        if every and (i + 1) % every == 0:
            x = shared(x, sin, cos)
    return x


class SSMLanguageModel(nn.Module):
    """The ssm / hybrid language model: embedding, ``ModuleList`` of Mamba2
    layers, the hybrid's shared attention block, final norm and LM head
    (tied to the embedding when the config says so).  Same serving surface
    as ``Transformer``."""

    def __init__(self, cfg: RunConfig, params: dict):
        super().__init__()
        check_family(cfg.model, SSM_FAMILIES)
        self.cfg = cfg
        self.embedding = _param(params["embedding"])
        self.layers = nn.ModuleList(ParamBlock(p) for p in params["layers"])
        self.final_norm = _param(params["final_norm"])
        if not cfg.model.tie_embeddings:
            self.lm_head = _param(params["lm_head"])
        if cfg.model.family == "hybrid":
            self.shared_attn = ParamBlock(params["shared_attn"])
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
        if self.model.family != "hybrid":
            return None, None
        return rope_from_freqs(positions_for(self.model, batch, seq, offset, self.device),
                               self.rope_freqs)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype: torch.dtype | None = None) -> HybridState:
        m = self.model
        dtype = dtype or dtype_of(m)
        layer = init_ssm_state(m, batch, dtype, self.device)
        ssm = SSMState(*(place_state(m, t.expand(m.n_layers, *t.shape).clone())
                         for t in layer))
        apps = n_shared_apps(m)
        shape = (apps, batch, m.n_kv_heads, max_seq, m.resolved_head_dim)
        k, v = (place_state(m, torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(2))
        lengths = torch.zeros(apps, dtype=torch.int32, device=self.device)
        position = torch.zeros((), dtype=torch.int32, device=self.device)
        return HybridState(ssm, [KVCache(k[i], v[i], lengths[i]) for i in range(apps)],
                           position, (k, v, lengths))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss of the reference's ``loss_fn``: batch holds
        tokens [B, S] and labels [B, S] (S a multiple of the SSD chunk, or
        below it); the hybrid's RoPE runs at positions 0..S-1.  Returns (ce,
        {"ce", "aux_loss" (0), "n_valid"})."""
        tokens = batch_tensor(self, batch, "tokens")
        b, s = tokens.shape
        x = constrain(embed_tokens(self, tokens), "btd")
        sin, cos = self._rope(b, s, 0)
        x = run_backbone_train(self, x, sin, cos, self.cfg.parallel.remat)
        ce, n_valid = head_loss(self, x, batch_tensor(self, batch, "labels"))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return ce, {"ce": ce, "aux_loss": aux, "n_valid": n_valid}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                state: HybridState) -> tuple[torch.Tensor, HybridState]:
        """Run the prompt [B, S] (S a multiple of the SSD chunk, or below
        it) through the stack at positions 0..S-1, as the reference does,
        updating the state in place (the position advances by S); returns
        the last position's logits [B, V] and the state."""
        b, s = tokens.shape
        x = constrain(embed_tokens(self, tokens), "btd")
        sin, cos = self._rope(b, s, 0)
        x = run_backbone(self, x, state, sin, cos)
        logits = logits_from(self, x[:, -1:])
        state.position.add_(s)
        return logits[:, 0], state

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor,
                    state: HybridState) -> tuple[torch.Tensor, HybridState]:
        """One decode step: token [B] -> logits [B, V]; the state advances
        in place by one position."""
        b = token.shape[0]
        x = embed_tokens(self, token[:, None])
        sin, cos = self._rope(b, 1, state.position)
        x = run_backbone(self, x, state, sin, cos)
        logits = logits_from(self, x)
        state.position.add_(1)
        return logits[:, 0], state
