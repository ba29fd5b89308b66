"""Mamba2 (SSD -- state-space duality) blocks, chunked.

Counterpart of the JAX package's ``models/ssm.py``.  Layer = in_proj ->
short causal conv (x, B, C) -> SSD -> gated RMSNorm -> out_proj.  Decode
keeps (conv window, SSM state) per layer: O(1) per token.

``ssd_chunked`` reproduces the reference's casts: in bf16 the scaled
inputs, the intra-chunk weights, the carried state and ``exp(seg)`` are
rounded to the activations' dtype before their products, so it is not the
fused kernel's all-f32 function.  Like the reference model,
``mamba2_block`` calls ``ssd_chunked``, not the kernel
(``repro_torch.kernels.ssd_chunk``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from ..config import EngineConfig, ModelConfig
from ..distributed.sharding import map_shards, reshape
from .common import matmul
from .layers import rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor     # [B, d_conv-1, conv_channels]
    ssm: torch.Tensor      # [B, H, P, N], f32


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """in_proj output -> (z, xBC, dt)."""
    d_inner, _, conv_ch = ssm_dims(cfg)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_ch, zxbcdt.shape[-1] - d_inner - conv_ch],
                             dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d, window k.  xbc: [B, S, C]; w: [k, C].

    With ``state`` ([B, k-1, C], the trailing window of the previous tokens)
    this is the streaming/decode form; returns (out, new_state).
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                   # [B, S+k-1, C]
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    out = F.silu(out + b[None, None, :])
    return out, xp[:, -(k - 1):, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """Chunked SSD, one chunk at a time.

    x:  [b, s, h, p]   inputs per head
    dt: [b, s, h]      positive step sizes (f32)
    A:  [h]            negative decay rates (f32)
    B:  [b, s, g, n]   input projections (groups broadcast over heads)
    C:  [b, s, g, n]   output projections
    Returns y [b, s, h, p] in x's dtype and the final state [b, h, p, n] f32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    rep = h // g
    dtype = x.dtype
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, s, chunk):
        x_c, dt_c = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        B_h = torch.repeat_interleave(B[:, c0:c0 + chunk], rep, dim=2)   # [b,q,h,n]
        C_h = torch.repeat_interleave(C[:, c0:c0 + chunk], rep, dim=2)
        seg = torch.cumsum(dt_c * A[None, None, :], dim=1)              # [b,q,h]
        # dt folded into x once, rounded to x's dtype as in the reference
        xdt = (x_c.float() * dt_c[..., None]).to(dtype)                 # [b,q,h,p]

        # intra-chunk: scores[i,j] = C_i.B_j exp(seg_i - seg_j), i >= j
        cb = torch.einsum("bihn,bjhn->bhij", C_h.float(), B_h.float())
        segh = seg.transpose(1, 2)                                      # [b,h,q]
        diff = torch.where(mask, segh[..., :, None] - segh[..., None, :], -1e30)
        w_ij = cb * torch.exp(diff)
        y_intra = torch.einsum("bhij,bjhp->bihp", w_ij.to(dtype).float(), xdt.float())

        # inter-chunk: y_i += C_i . state_prev * exp(seg_i)
        y_inter = (torch.einsum("bihn,bhpn->bihp", C_h.float(),
                                state.to(dtype).float())
                   * torch.exp(seg).to(dtype).float()[..., None])

        # chunk state + recurrence
        last = seg[:, -1:, :]                                           # [b,1,h]
        wj = torch.exp(last - seg).to(dtype)                            # [b,q,h]
        st_c = torch.einsum("bjhn,bjhp->bhpn", B_h.float() * wj.float()[..., None],
                            xdt.float())
        state = state * torch.exp(last[:, 0, :])[:, :, None, None] + st_c
        ys.append((y_intra + y_inter).to(dtype))
    return torch.cat(ys, dim=1), state


def _ssm_step(Bx: torch.Tensor, Cx: torch.Tensor, x0: torch.Tensor, dt0: torch.Tensor,
              A: torch.Tensor, ssm: torch.Tensor, dtype: torch.dtype):
    """One token's recurrent update, in f32 as the reference's mixed
    einsums: Bx, Cx [B, G, N], x0 [B, H, P], dt0 [B, H], A [H], ssm [B, H,
    P, N] -> (y [B, H, P] in ``dtype``, the new state)."""
    rep = x0.shape[1] // Bx.shape[1]
    Bh = torch.repeat_interleave(Bx, rep, dim=1).float()
    Ch = torch.repeat_interleave(Cx, rep, dim=1)
    st = (ssm * torch.exp(dt0 * A[None, :])[:, :, None, None]
          + torch.einsum("bhn,bhp,bh->bhpn", Bh, x0.float(), dt0))
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), st.to(dtype).float())
    return y.to(dtype), st


def mamba2_block(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                 engine: EngineConfig, state: SSMState | None = None
                 ) -> tuple[torch.Tensor, SSMState | None]:
    """Full Mamba2 residual branch.  state None: chunked SSD from zero.
    With a state: prefill (x [B, S, D], S > 1) carries it through the
    chunks; decode (x [B, 1, D]) is the single-token recurrent update.
    Returns (out, new state or None); the state passed in is not modified."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    b, s, _ = x.shape
    hdim, nst, g = s_cfg.head_dim, s_cfg.d_state, s_cfg.n_groups

    zxbcdt = matmul(x, p["in_proj"], engine)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())

    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   None if state is None else state.conv)
    x_in, Bx, Cx = torch.split(xbc, [d_inner, g * nst, g * nst], dim=-1)
    xh = reshape(x_in, b, s, n_heads, hdim)
    # each (batch, head) on its own: on each rank's shards under a mesh; a
    # group's B and C go with its heads (heads are group-major), one group
    # with every head
    grp = -2 if g > 1 else None                 # the group dim of B and C
    if state is None or s > 1:
        chunk = min(s_cfg.chunk, s)
        y, final = map_shards(
            lambda *a: ssd_chunked(*a[:5], chunk, a[5]),
            (xh, dt, A, reshape(Bx, b, s, g, nst), reshape(Cx, b, s, g, nst),
             None if state is None else state.ssm),
            ((0, 2), (0, 2), (None, 0), (0, grp), (0, grp), (0, 1)), ((0, 2), (0, 1)))
        new_state = None if state is None else SSMState(conv=conv_state, ssm=final)
    else:
        y, st = map_shards(
            lambda *a: _ssm_step(*a, x.dtype),
            (reshape(Bx, b, g, nst), reshape(Cx, b, g, nst), xh[:, 0], dt[:, 0], A, state.ssm),
            ((0, grp), (0, grp), (0, 1), (0, 1), (None, 0), (0, 1)), ((0, 1), (0, 1)))
        y = reshape(y[:, None], b, s, n_heads, hdim)
        new_state = SSMState(conv=conv_state, ssm=st)

    y = y + p["D_skip"].to(x.dtype)[None, None, :, None] * xh.to(x.dtype)
    y = reshape(y, b, s, d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["ssm_norm"], cfg.rms_eps)
    return matmul(y, p["out_proj"], engine), new_state


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> SSMState:
    s = cfg.ssm
    _, n_heads, conv_ch = ssm_dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
        ssm=torch.zeros((batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                        device=device))
