"""Plain-torch oracles for the kernels (bf16-in / fp32-accumulate PE
semantics), the counterparts of the JAX package's ``kernels/ref.py``."""

from __future__ import annotations

import torch


def ref_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with fp32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def ref_matmul_accum(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C += A @ B (the rasa_mm contract)."""
    return (c.float() + torch.matmul(a.float(), b.float())).to(out_dtype)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool = True, scale: float | None = None,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head attention oracle.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0 (GQA: kv
    heads are broadcast over query-head groups).  fp32 softmax.  The causal
    mask is bottom-right aligned (query i sees keys j <= i + Skv - Sq), with
    -inf; the flash kernel's is top-left aligned with -1e30, so the two
    agree only at Sq == Skv.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if group > 1:
        kf = torch.repeat_interleave(kf, group, dim=1)
        vf = torch.repeat_interleave(vf, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if bias is not None:
        logits = logits + bias
    if causal:
        skv = k.shape[2]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device).tril(skv - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def ref_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Single-token decode attention oracle.

    q: [B, Hq, D]; caches: [B, Hkv, S, D]; lengths: [B] valid cache lengths
    (None = all valid).  Returns [B, Hq, D].
    """
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(b, hkv, group, d) * scale
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float())
    if lengths is not None:
        mask = (torch.arange(s, device=q.device)[None, None, None, :]
                < lengths.to(q.device)[:, None, None, None])
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)
