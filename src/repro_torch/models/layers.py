"""Core layers: norms, rotary embeddings, attention, MLPs.

Counterpart of the JAX package's ``models/layers.py``; same layouts (weights
are [in, out], activations [B, S, ...]).  Per-layer parameters come in as a
mapping of name -> tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..config import EngineConfig, ModelConfig
from ..distributed.sharding import (constrain, is_dtensor, map_shards, reshape, write_at,
                                    write_prefix)
from .common import dot_f32, matmul

# --------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


# --------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The rotary frequencies theta^(-i / (hd/2)), [hd//2] f32.  Its base
    is a tensor copied from the host, so the models compute it once, when
    they are built, and never inside a step."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def rope_from_freqs(positions: torch.Tensor, freqs: torch.Tensor,
                    sections: tuple[int, ...] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables [B, S, hd//2].  positions: [B, S] (standard) or
    [3, B, S] (M-RoPE: temporal/height/width streams), where the hd/2
    frequency slots are split into ``sections``, each driven by its own
    stream; text tokens pass identical t/h/w, so M-RoPE reduces to standard
    RoPE for them."""
    ang = positions.float()[..., None] * freqs
    if positions.dim() == 3:
        if sections is None or sum(sections) != freqs.shape[0]:
            raise ValueError(f"M-RoPE sections {sections} must sum to {freqs.shape[0]}")
        parts, start = [], 0
        for stream, sec in zip(ang, sections):
            parts.append(stream[..., start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)
    return torch.sin(ang), torch.cos(ang)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: tuple[int, ...] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables, as rope_from_freqs, with the frequencies computed
    here."""
    return rope_from_freqs(positions, rope_freqs(head_dim, theta, positions.device),
                           sections)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; sin/cos: [B, S, hd//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------------- attention


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, scale: float, q_chunk: int = 1024,
                             kv_chunk: int = 2048,
                             logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention with a flash-style online softmax over kv chunks,
    looped over q chunks; -1e30 masking as in the reference.

    q: [B, H, S, d], k/v: [B, H, S, d] (self-attention).
    """
    b, h, s, d = q.shape
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"seq {s} not divisible by chunks ({q_chunk}, {kv_chunk})")
    rows_in = torch.arange(q_chunk, device=q.device)[:, None]
    cols_in = torch.arange(kv_chunk, device=q.device)[None, :]
    outs = []
    for qi in range(s // q_chunk):
        qf = q[:, :, qi * q_chunk:(qi + 1) * q_chunk].float() * scale
        m_p = torch.full((b, h, q_chunk, 1), -1e30, device=q.device)
        l_p = torch.zeros((b, h, q_chunk, 1), device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), device=q.device)
        for kj in range(s // kv_chunk):
            kblk = k[:, :, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            vblk = v[:, :, kj * kv_chunk:(kj + 1) * kv_chunk].float()
            s_ij = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
            if logit_softcap:
                s_ij = logit_softcap * torch.tanh(s_ij / logit_softcap)
            causal = (qi * q_chunk + rows_in) >= (kj * kv_chunk + cols_in)
            s_ij = torch.where(causal, s_ij, -1e30)
            m_c = torch.maximum(m_p, s_ij.amax(dim=-1, keepdim=True))
            p = torch.exp(s_ij - m_c)
            alpha = torch.exp(m_p - m_c)
            l_p = l_p * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
            m_p = m_c
        outs.append((acc / torch.clamp(l_p, min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=2)


@dataclasses.dataclass
class KVCache:
    """Decode-time cache: k/v [B, Hkv, S_max, hd]; length = filled prefix,
    an int32 0-d tensor on the cache's device.

    All three are updated in place (views into the model's stacked cache and
    lengths), so that a replayed CUDA graph sees the new values.
    """
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor


def gqa_expand(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, Hkv, ...] -> [B, H, ...] by repeating kv groups."""
    hkv = x.shape[1]
    if hkv == n_heads:
        return x
    return torch.repeat_interleave(x, n_heads // hkv, dim=1)


def attention_block(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, engine: EngineConfig,
                    sin: torch.Tensor, cos: torch.Tensor,
                    cache: Optional[KVCache] = None
                    ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Pre-norm attention residual branch.

    Prefill (cache None, or s > 1): chunked causal attention over x, writing
    the cache from position 0.  Decode: x is [B, 1, D]; appends to the cache
    and attends over the valid prefix.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    q = reshape(matmul(x, p["wq"], engine), b, s, h, hd)
    k = reshape(matmul(x, p["wk"], engine), b, s, hkv, hd)
    v = reshape(matmul(x, p["wv"], engine), b, s, hkv, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if cfg.rope != "none":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    q = q.transpose(1, 2)      # [B, H, S, hd]
    k = k.transpose(1, 2)      # [B, Hkv, S, hd]
    v = v.transpose(1, 2)
    scale = hd ** -0.5

    if cache is None or s > 1:
        if cache is not None:
            # in-place: the prompt's k/v fill the cache from position 0
            for dst, new in ((cache.k, k), (cache.v, v)):
                write_prefix(dst, 2, new.to(dst.dtype))
            cache.length.fill_(s)
        # each (batch, head) on its own: on each rank's shards under a mesh
        out = map_shards(
            lambda q_, k_, v_: chunked_causal_attention(
                q_, k_, v_, scale=scale, q_chunk=engine.attn_q_chunk,
                kv_chunk=engine.attn_kv_chunk, logit_softcap=cfg.logit_softcap),
            (q, gqa_expand(k, h), gqa_expand(v, h)), ((0, 1),) * 3, (0, 1))
    else:
        # single-token decode; in-place append at the cache's length (read
        # on the device: no host sync), then grouped-query attention without
        # expanding the cache.  Past a full cache the write lands at
        # smax - s, as dynamic_update_slice clamps it in the reference; the
        # length and the mask's positions keep counting.
        ck, cv = cache.k, cache.v
        smax = ck.shape[2]
        steps = torch.arange(s, device=x.device)
        write = torch.clamp(cache.length, max=smax - s) + steps
        for dst, new in ((ck, k), (cv, v)):
            write_at(dst, 2, write, new.to(dst.dtype))
        pos = cache.length + steps
        cache.length.add_(s)
        group = h // hkv
        # queries are (group-major) the s new positions repeated per group
        qpos = pos.repeat(group)

        def attend(qg, ck, cv):
            logits = torch.einsum("bhqd,bhkd->bhqk", qg, ck.float())
            if cfg.logit_softcap:
                logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
            mask = (torch.arange(smax, device=qg.device)[None, None, None, :]
                    <= qpos[None, None, :, None])
            logits = torch.where(mask, logits, -1e30)
            probs = torch.softmax(logits, dim=-1)
            return torch.einsum("bhqk,bhkd->bhqd", probs, cv.float()).to(x.dtype)

        qg = reshape(q, b, hkv, group * s, hd).float() * scale
        if is_dtensor(ck) and any(p.is_shard() and p.dim not in (0, 1) for p in ck.placements):
            out = attend(qg, ck, cv)        # a cache split along the sequence or head_dim
        else:                               # each (batch, kv head) on its own
            out = map_shards(attend, (qg, ck, cv), ((0, 1),) * 3, (0, 1))
        out = reshape(out, b, h, s, hd)

    out = reshape(out.transpose(1, 2), b, s, h * hd)
    return matmul(out, p["wo"], engine), cache


# ----------------------------------------------------------------------- mlp


def mlp_block(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              engine: EngineConfig) -> torch.Tensor:
    act = cfg.act
    if act in ("swiglu", "geglu"):
        if "w_gate_up" in p:
            # fused gate+up: one GEMM, x read once (WL-skip analogue)
            w = p["w_gate_up"]
            gu = dot_f32(torch.mm, reshape(x, -1, w.shape[0]), w.reshape(w.shape[0], -1),
                         x.dtype)
            gu = reshape(gu, *x.shape[:2], *w.shape[1:])
            g, u = gu[:, :, 0], gu[:, :, 1]
        else:
            g = matmul(x, p["w_gate"], engine)
            u = matmul(x, p["w_up"], engine)
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        hid = constrain(g * u, "btf")
    else:
        u = matmul(x, p["w_up"], engine)
        if act == "relu2":               # nemotron squared-ReLU
            hid = torch.square(F.relu(u))
        else:
            hid = F.gelu(u, approximate="tanh")
        hid = constrain(hid, "btf")
    return matmul(hid, p["w_down"], engine)
