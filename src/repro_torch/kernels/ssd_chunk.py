"""Fused Mamba2 SSD (state-space duality) chunk scan: the hand-written CUDA
kernel, its wrapper, and the plain PyTorch version it is held against.

Counterpart of the JAX package's ``kernels/ssd_chunk.py``.  Layout (heads
flattened into the leading dim): x [BH, S, P], dt [BH, S], a [BH] (f32,
negative decay rates), b/c [BH, S, N].  Returns y [BH, S, P] in x's dtype
and the final state [BH, N, P] in f32 (the reference's docstring says
[BH, P, N]; its code, followed here, returns [BH, N, P]).  Everything is
computed in f32, chunk after chunk:

  intra  y_i  = sum_{j<=i} (c_i . b_j) exp(seg_i - seg_j) x_j dt_j
  inter  y_i += (c_i . state) exp(seg_i)          (state before the chunk)
  state  = state exp(seg_last) + sum_j (b_j exp(seg_last - seg_j)) (x_j dt_j)^T

with seg = cumsum(dt * a) within the chunk.  ``ssd_chunk_fused`` takes the
plain version for a tensor on the CPU and the kernels for one on the card.
The kernels split the chunk loop as the SSD algorithm allows: each chunk's
own state contribution, a recurrence over the chunks, then y per (chunk,
row tile), so no limit on the chunk; bf16 inputs take N <= 128
(``MAX_STATE_BF16``), f32 inputs any N; any P.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: N the bf16 kernel takes: it holds a row tile's C fragments in registers
#: (csrc/ssd_chunk.cu); f32 inputs take any N, both any P and any chunk
MAX_STATE_BF16 = 128

#: the entry point and its device kernels, as named in csrc/ssd_chunk.cu:
#: each chunk's own state (f32 SIMT, bf16 tensor cores), the recurrence
#: over the chunks, then y (f32 SIMT, bf16 tensor cores)
KERNEL_NAMES = {"ssd": "ssd_chunk_fwd", "state_simt": "ssd_state_simt",
                "state_tc": "ssd_state_tc", "pass": "ssd_state_pass",
                "out_simt": "ssd_out_simt", "out_tc": "ssd_out_tc"}
#: the device kernels each input dtype's route launches, once each per call
ROUTES = {torch.float32: ("state_simt", "pass", "out_simt"),
          torch.bfloat16: ("state_tc", "pass", "out_tc")}
#: launches counted where the wrapper launches: "ssd" per call, and each
#: device kernel's under its KERNEL_NAMES key
launches = {key: 0 for key in KERNEL_NAMES}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def hbm_bytes_fused(bh: int, s: int, p: int, n: int, in_bytes: int = 2) -> int:
    """Cost model: streamed operands only (x, dt, b, c in; y out; the final
    state) -- the reference's napkin (``ssd_chunk.py:117-121``)."""
    return bh * s * (2 * p + 2 * n + 1) * in_bytes + bh * n * p * 4


def _check(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, chunk: int) -> int:
    """Shape checks; returns the chunk actually used (at most S)."""
    if x.dim() != 3 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"want x [BH,S,P], b/c [BH,S,N]; got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bh, s, _ = x.shape
    if b.shape[:2] != (bh, s) or tuple(dt.shape) != (bh, s) or tuple(a.shape) != (bh,):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not match x {tuple(x.shape)}")
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    return chunk


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the reference kernel's per-chunk f32
    arithmetic, batched over BH, chunk after chunk."""
    chunk = _check(x, dt, a, b, c, chunk)
    bh, s, p = x.shape
    n = b.shape[-1]
    dev = x.device
    state = torch.zeros((bh, n, p), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    lower = (torch.arange(chunk, device=dev)[:, None]
             >= torch.arange(chunk, device=dev)[None, :])
    neg = torch.tensor(-1e30, device=dev)
    af = a.float()[:, None]
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk].float()
        dtc = dt[:, c0:c0 + chunk].float()
        bc = b[:, c0:c0 + chunk].float()
        cc = c[:, c0:c0 + chunk].float()
        # the running sum of the f32 products, accumulated in f64 and rounded
        # once (what torch.cumsum does on the CPU, and the kernel): the
        # weights exp(seg_i - seg_j) inherit seg's absolute error
        seg = torch.cumsum((dtc * af).double(), dim=1).float()   # [bh, q]
        xdt = xc * dtc[..., None]                                # [bh, q, p]
        diff = torch.where(lower, seg[:, :, None] - seg[:, None, :], neg)
        w = (cc @ bc.transpose(1, 2)) * torch.exp(diff)          # [bh, q, q]
        yc = w @ xdt + (cc @ state) * torch.exp(seg)[..., None]
        wj = torch.exp(seg[:, -1:] - seg)                        # [bh, q]
        st_c = (bc * wj[..., None]).transpose(1, 2) @ xdt        # [bh, n, p]
        state = state * torch.exp(seg[:, -1])[:, None, None] + st_c
        y[:, c0:c0 + chunk] = yc.to(x.dtype)
    return y, state


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _lib():
    lib = _build.load("ssd_chunk")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_fwd.argtypes = [i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.ssd_chunk_fwd.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, *,
                   chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan through the CUDA kernels, on the current stream: each
    chunk's own state (one CTA per chunk and 64 x 64 tile of [N, P]), the
    recurrence over the chunks, then y (one CTA per chunk, row tile and 64
    columns of P).  The workspace comes from torch's allocator.

    x/b/c bf16 or f32 (one dtype), dt f32 or x's dtype, a f32, all
    contiguous on one CUDA device; any P and chunk, N <= 128 with bf16
    inputs (any with f32).  Raises on anything else, including a tensor on
    the CPU.
    """
    chunk = _check(x, dt, a, b, c, chunk)
    bh, s, p = x.shape
    n = b.shape[-1]
    tensors = (x, dt, a, b, c)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("ssd_chunk_cuda needs tensors on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if (x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype
            or dt.dtype not in (torch.float32, x.dtype) or a.dtype != torch.float32):
        raise TypeError(f"ssd_chunk_cuda takes x/b/c bf16 or f32 of one dtype, dt "
                        f"f32 or x's dtype, a f32; got x {x.dtype}, dt {dt.dtype}, "
                        f"a {a.dtype}, b {b.dtype}, c {c.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunk_cuda takes contiguous tensors")
    if p < 1 or n < 1 or (x.dtype == torch.bfloat16 and n > MAX_STATE_BF16):
        raise ValueError(f"P={p}, N={n} outside the kernel's range (P >= 1; N >= 1, "
                         f"and N <= {MAX_STATE_BF16} with bf16 inputs, whose kernel "
                         "holds C's fragments for all of N in registers)")
    if bh * s * max(p, n) >= 2**31:
        raise ValueError(f"shapes too large for the kernel: x {tuple(x.shape)}")
    y = torch.empty_like(x)
    fin = torch.empty((bh, n, p), dtype=torch.float32, device=x.device)
    if bh == 0:
        return y, fin
    # the workspace (csrc/ssd_chunk.cu, Plan): the state entering each chunk
    # [BH, S / chunk, N, P], then seg and dt of every row, then each chunk's
    # seg_last
    nc = s // chunk
    ws = torch.empty(bh * (nc * n * p + 2 * s + nc), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_fwd(_DTYPES[x.dtype], _DTYPES[dt.dtype], x.data_ptr(),
                                dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                y.data_ptr(), fin.data_ptr(), ws.data_ptr(), bh, s, p, n,
                                chunk, stream)
    _build.raise_if(err, lib.ssd_error_string, "ssd_chunk_fwd launch")
    launches["ssd"] += 1
    for key in ROUTES[x.dtype]:
        launches[key] += 1
    return y, fin


def ssd_chunk_fused(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *,
                    chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [BH, S, P]; dt: [BH, S]; a: [BH]; b/c: [BH, S, N] -> (y [BH, S, P],
    final state [BH, N, P] f32).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    fn = ssd_chunk_plain if x.device.type == "cpu" else ssd_chunk_cuda
    return fn(x, dt, a, b, c, chunk=chunk)
