"""Decoder-only transformer backbone: dense, MoE, VLM and audio families.

Counterpart of the JAX package's ``models/transformer.py``.  The model is an
``nn.Module`` (``Transformer``) holding a ``ModuleList`` of decoder blocks;
the layer loop is a plain Python loop (the reference scans over stacked
[L, ...] parameters; ``convert.params_from_jax`` unstacks them).
Parameters keep the reference's names and [in, out] layouts; they are
built with ``requires_grad=False`` and made trainable by
``training.init_train_state``.  Serving runs ``prefill``/``decode_step``
under ``torch.no_grad()``; training runs ``loss``, the reference's
``loss_fn``, with each layer rematerialised per ``ParallelConfig.remat``.
The families:

- dense: the GQA decoder (nemotron, qwen3, gemma);
- moe: the same with a top-k MoE FFN (grok, granite; ``moe.py``);
- vlm: dense with M-RoPE and a stub patch projection (qwen2-vl); serving
  passes text only, so its positions are t = h = w;
- audio: dense over the sum of per-codebook embeddings, with one head per
  codebook (musicgen); its tokens are [B, S, n_codebooks].

The ssm and hybrid families live in ``ssm_lm.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import EngineConfig, ModelConfig, RunConfig
from ..distributed.sharding import (NamedSharding, constrain, distribute, is_dtensor,
                                    place_state, reshape, single_split)
from .common import chunked_cross_entropy, dtype_of, embed_init, he_init, matmul
from .layers import (KVCache, attention_block, mlp_block, rms_norm, rope_freqs,
                     rope_from_freqs)
from .moe import moe_block, moe_forward

FAMILIES = ("dense", "moe", "vlm", "audio")


def check_family(cfg: ModelConfig, families: tuple[str, ...] = FAMILIES) -> None:
    """Raise unless ``cfg.family`` is one of ``families``."""
    if cfg.family not in families:
        raise ValueError(f"family {cfg.family!r} is not one of {families}")


def token_shape(cfg: ModelConfig, batch: int) -> tuple[int, ...]:
    """A decode step's tokens: [B], or [B, n_codebooks] for the audio
    family (a prompt adds the sequence axis after B)."""
    return (batch, cfg.n_codebooks) if cfg.family == "audio" else (batch,)


def prompt_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple[int, ...]:
    """A prompt's tokens: [B, S], or [B, S, n_codebooks] for the audio family."""
    return (batch, seq, *token_shape(cfg, batch)[1:])


def head_width(cfg: ModelConfig) -> int:
    """The LM head's columns and the embedding's rows: the vocab, times
    n_codebooks for the audio family."""
    return cfg.vocab * (cfg.n_codebooks if cfg.family == "audio" else 1)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Temporal/height/width frequency splits, proportioned like qwen2-vl
    (16/24/24 of the 64 half-dims at head_dim=128)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


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
    if cfg.moe is not None:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        p["router"] = init((d, e), d)
        if cfg.fuse_gate_up:
            p["experts_w_gate_up"] = init((e, d, 2, fe), d)
        else:
            p["experts_w_gate"] = init((e, d, fe), d)
            p["experts_w_up"] = init((e, d, fe), d)
        p["experts_w_down"] = init((e, fe, d), fe)
        return p
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
    """Random parameters from ``gen``: {"embedding" ([vocab * n_codebooks,
    d] for audio), "layers": [dict per layer], "final_norm", "lm_head"
    (untied only; [d, vocab * n_codebooks]), "patch_proj" (vision
    frontend)}."""
    check_family(cfg)
    dtype = dtype_of(cfg)
    d = cfg.d_model
    params = {
        "embedding": embed_init(gen, (head_width(cfg), d), dtype, device),
        "layers": [init_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros(d, dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (d, head_width(cfg)), dtype, d, device)
    if cfg.frontend == "vision":
        params["patch_proj"] = he_init(gen, (d, d), dtype, d, device)
    return params


# ------------------------------------------------------------------ blocks


def decoder_block(params_l, x: torch.Tensor, cfg: ModelConfig,
                  engine: EngineConfig, sin, cos,
                  cache: Optional[KVCache] = None):
    """Pre-norm block; returns (x, new_cache).  The MoE's auxiliary loss is
    not computed: serving discards it, as the reference's compiled steps do."""
    h = rms_norm(x, params_l["norm1"], cfg.rms_eps)
    attn_out, new_cache = attention_block(params_l, h, cfg, engine, sin, cos,
                                          cache)
    x = constrain(x + attn_out, "btd")
    h = rms_norm(x, params_l["norm2"], cfg.rms_eps)
    if cfg.moe is not None:
        return constrain(x + moe_forward(params_l, h, cfg)[0], "btd"), new_cache
    return constrain(x + mlp_block(params_l, h, cfg, engine), "btd"), new_cache


def train_block(params_l, x: torch.Tensor, cfg: ModelConfig, engine: EngineConfig,
                sin, cos) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The training form of decoder_block (no cache): returns (x, the MoE's
    auxiliary loss, or None for a dense FFN), as the reference's
    decoder_block does for training."""
    h = rms_norm(x, params_l["norm1"], cfg.rms_eps)
    attn_out, _ = attention_block(params_l, h, cfg, engine, sin, cos)
    x = constrain(x + attn_out, "btd")
    h = rms_norm(x, params_l["norm2"], cfg.rms_eps)
    if cfg.moe is not None:
        ffn_out, aux = moe_block(params_l, h, cfg)
        return constrain(x + ffn_out, "btd"), aux
    return constrain(x + mlp_block(params_l, h, cfg, engine), "btd"), None


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2D products (the reference's
    checkpoint_dots_with_no_batch_dims), recompute everything else."""
    if op._overloadpacket is torch.ops.aten.mm:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str):
    """fn rematerialised in the backward per ``ParallelConfig.remat``, as
    the reference's ``_remat``: "full" keeps only fn's inputs
    (non-reentrant ``torch.utils.checkpoint``), "dots" also keeps the
    outputs of its 2D products (selective checkpointing), "none" keeps
    everything.  No policy changes a number."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_products))
    raise ValueError(f"unknown remat policy {policy!r}; one of full, dots, none")


def run_layers_train(blocks: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                     engine: EngineConfig, sin, cos,
                     policy: str = "full") -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack for training, each layer under ``remat(policy)``;
    returns (x, the sum of the layers' auxiliary losses, fp32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = remat(functools.partial(train_block, cfg=cfg, engine=engine), policy)
    for layer in blocks:
        x, aux_l = block(layer, x, sin=sin, cos=cos)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux


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


class _Lookup(torch.autograd.Function):
    """``table[ids]`` for a DTensor table, with a backward that adds the
    gradient's rows into a local gradient of the whole table on each rank
    (partial sums over the mesh dims that split ids) and reduces it onto
    the table's layout: DTensor's own rule for that scatter-add fails on
    some torch versions.  The adds are the index backward's own
    (``index_put_`` with accumulation, in the table's dtype)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table = (table.shape, table.dtype, table.device_mesh, tuple(table.placements))
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        (ids,) = ctx.saved_tensors
        shape, dtype, mesh, placements = ctx.table
        split = (tuple(ids.placements) if is_dtensor(ids)
                 else (Replicate(),) * mesh.ndim)
        g = g.redistribute(mesh, split) if is_dtensor(g) else distribute(
            g, NamedSharding(mesh, split))
        ids = ids.to_local() if is_dtensor(ids) else distribute(
            ids, NamedSharding(mesh, split)).to_local()
        grad = torch.zeros(shape, dtype=dtype, device=g.device).index_put_(
            (ids,), g.to_local().to(dtype), accumulate=True)
        partial = tuple(Partial() if p.is_shard() else Replicate() for p in split)
        return (DTensor.from_local(grad, mesh, partial, run_check=False)
                .redistribute(mesh, placements), None)


def embed_tokens(model: nn.Module, tokens: torch.Tensor,
                 patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: [B, S] (audio: [B, S, n_codebooks]) -> [B, S, D].  Audio
    sums the per-codebook embeddings (offsets into one stacked table; the
    sum accumulates in fp32 and rounds once, which gives the reference's
    bits); for the vlm family, ``patch_embeds`` [B, P, D] (the stub
    frontend's output) go through ``patch_proj`` and are prepended."""
    cfg = model.model
    emb = model.embedding
    # a lookup's sharding rule takes one mesh dim a tensor dim: a dim split
    # over pod and data (FSDP's d_model, the batch of the tokens) keeps the
    # data split alone
    emb, tokens = (single_split(t) for t in (emb, tokens))
    lookup = _Lookup.apply if is_dtensor(emb) else (lambda table, ids: table[ids])
    if cfg.family == "audio":
        offsets = torch.arange(cfg.n_codebooks, device=tokens.device) * cfg.vocab
        x = lookup(emb, (tokens + offsets).long()).sum(dim=2)
    else:
        x = lookup(emb, tokens.long())
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = matmul(patch_embeds.to(x.dtype), model.patch_proj)
        x = torch.cat([pe, x], dim=1)
    return x


def positions_for(cfg: ModelConfig, batch: int, seq: int,
                  offset: int | torch.Tensor = 0, device=None) -> torch.Tensor:
    """[B, S] positions offset..offset+seq-1 ([3, B, S] under M-RoPE, with
    t = h = w as the reference gives text tokens); ``offset`` may be a 0-d
    device tensor (the decode position), read on the device."""
    pos = (torch.arange(seq, device=device)[None, :] + offset).expand(batch, seq)
    if cfg.rope == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos


# ------------------------------------------------------------------ serving


def logits_from(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head (the embedding, transposed, when tied) of
    either model class; fp32 logits [B, S, V] (audio: [B, S, n_codebooks,
    V])."""
    m = model.cfg.model
    x = rms_norm(x, model.final_norm, m.rms_eps)
    head = model.embedding.T if m.tie_embeddings else model.lm_head
    logits = matmul(x, head, model.cfg.engine, out_dtype=torch.float32)
    if m.family == "audio":
        return reshape(logits, *logits.shape[:2], m.n_codebooks, m.vocab)
    return logits


def head_loss(model: nn.Module, x: torch.Tensor,
              labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Final norm, then the chunked CE of the LM head (the embedding,
    transposed, when tied) against labels, for either model class: (ce, the
    count of valid labels).  Audio's logits are split per codebook."""
    m = model.cfg.model
    x = rms_norm(x, model.final_norm, m.rms_eps)
    head = model.embedding.T if m.tie_embeddings else model.lm_head
    logits_fn = None
    if m.family == "audio":
        logits_fn = lambda lg: reshape(lg, *lg.shape[:-1], m.n_codebooks, m.vocab)
    return chunked_cross_entropy(x, head, labels, chunk=model.cfg.engine.ce_chunk,
                                 logits_fn=logits_fn)


def batch_tensor(model: nn.Module, batch: dict, name: str) -> torch.Tensor | None:
    """batch[name] (a tensor or a numpy array) on the model's device, or None."""
    t = batch.get(name)
    return None if t is None else torch.as_tensor(t, device=model.device)


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


class Transformer(nn.Module):
    """The decoder of the dense, moe, vlm and audio families: embedding,
    ``ModuleList`` of blocks, final norm, an LM head (tied to the embedding
    when the config says so) and, for the vision frontend, the patch
    projection."""

    def __init__(self, cfg: RunConfig, params: dict):
        super().__init__()
        check_family(cfg.model)
        self.cfg = cfg
        self.embedding = _param(params["embedding"])
        self.layers = nn.ModuleList(DecoderBlock(p) for p in params["layers"])
        self.final_norm = _param(params["final_norm"])
        if not cfg.model.tie_embeddings:
            self.lm_head = _param(params["lm_head"])
        if "patch_proj" in params:
            self.patch_proj = _param(params["patch_proj"])
        m = cfg.model
        self.register_buffer("rope_freqs", rope_freqs(
            m.resolved_head_dim, m.rope_theta, self.device), persistent=False)
        self.rope_sections = mrope_sections(m.resolved_head_dim) if m.rope == "mrope" else None

    @property
    def model(self) -> ModelConfig:
        return self.cfg.model

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def _rope(self, batch: int, seq: int, offset: int | torch.Tensor):
        return rope_from_freqs(positions_for(self.model, batch, seq, offset, self.device),
                               self.rope_freqs, self.rope_sections)

    def init_decode_state(self, batch: int, max_seq: int,
                          dtype: torch.dtype | None = None) -> DecodeState:
        m = self.model
        shape = (m.n_layers, batch, m.n_kv_heads, max_seq, m.resolved_head_dim)
        dtype = dtype or dtype_of(m)
        k, v = (place_state(m, torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(2))
        lengths = torch.zeros(m.n_layers, dtype=torch.int32, device=self.device)
        position = torch.zeros((), dtype=torch.int32, device=self.device)
        return DecodeState([KVCache(k[i], v[i], lengths[i]) for i in range(m.n_layers)],
                           position, (k, v, lengths))

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss of the reference's ``loss_fn``: batch holds
        tokens [B, S] and labels [B, S] (audio: [B, S, n_codebooks]; vlm:
        also patch_embeds [B, P, D], whose positions carry label -100).
        Returns (ce + the MoE's auxiliary loss, {"ce", "aux_loss",
        "n_valid"}).  Differentiable under the xla engine."""
        m = self.model
        patches = batch_tensor(self, batch, "patch_embeds")
        x = constrain(embed_tokens(self, batch_tensor(self, batch, "tokens"), patches), "btd")
        b, s = x.shape[:2]
        sin, cos = self._rope(b, s, 0)
        x, aux = run_layers_train(self.layers, x, m, self.cfg.engine, sin, cos,
                                  self.cfg.parallel.remat)
        labels = batch_tensor(self, batch, "labels")
        if m.family == "vlm" and patches is not None:
            pad = torch.full((b, patches.shape[1], *labels.shape[2:]), -100,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        ce, n_valid = head_loss(self, x, labels)
        return ce + aux, {"ce": ce, "aux_loss": aux, "n_valid": n_valid}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
        """Run the prompt [B, S] (audio: [B, S, n_codebooks]) through the
        stack, filling the caches and setting the position in place; returns
        the last position's logits [B, V] (audio: [B, n_codebooks, V]) and
        the state."""
        b, s = tokens.shape[:2]
        x = embed_tokens(self, tokens)
        sin, cos = self._rope(b, s, 0)
        x = run_layers(self.layers, x, self.model, self.cfg.engine, sin, cos,
                       state.caches)
        logits = logits_from(self, x[:, -1:])
        state.position.fill_(s)
        return logits[:, 0], state

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor,
                    state: DecodeState) -> tuple[torch.Tensor, DecodeState]:
        """One decode step: token [B] (audio: [B, n_codebooks]) -> logits
        [B, V] (audio: [B, n_codebooks, V]); the state advances in place by
        one position."""
        b = token.shape[0]
        x = embed_tokens(self, token[:, None])
        sin, cos = self._rope(b, 1, state.position)
        x = run_layers(self.layers, x, self.model, self.cfg.engine, sin, cos,
                       state.caches)
        logits = logits_from(self, x)
        state.position.add_(1)
        return logits[:, 0], state
