"""Blockwise (flash) attention: the hand-written CUDA kernel, its wrapper,
and the plain PyTorch version it is held against.

Counterpart of the JAX package's ``kernels/flash_attention.py``.  Layout:
q [BH, Sq, D], k/v [BHkv, Skv, D] with BH a multiple of BHkv; query row
``bh`` reads kv row ``bh // (BH // BHkv)``, which is GQA when the rows are
(batch, head) pairs, so the kv heads are never copied.  fp32 softmax state,
a finite -1e30 mask (top-left aligned: row i sees columns j <= i), output
divided by ``max(l, 1e-30)`` and cast to q's dtype.

``block_q``/``block_kv`` keep the reference's meaning: the sequences count
as zero-padded to multiples of them (a kv position in [Skv, Skv_padded) is
a zero key and a zero value, seen by the rows the causal mask lets see it),
and, in the plain version, kv blocks wholly above the diagonal are skipped.
Without the causal mask every row sees the padded positions, as in the
reference (``ops.flash_mha`` refuses such inputs where the reference
does).  The kernels pick their own CTA tiles (``csrc/flash_attention.cu``);
the padding costs them no copy.  ``flash_route`` picks the kernel: bf16 runs
on the tensor cores (``flash_fwd_tc``), f32 on the SIMT fp32 kernel
(``flash_fwd_kernel``).

The f32 kernel is bound by shared-memory cycles rather than by the FMA
pipes: a warp's 16-byte shared load costs four SM cycles whatever its
broadcast, so it reads every operand as a float4 into thread tiles of up
to 8 x 8 products, brings K and V through a ``cp.async`` ring, keeps each
row's softmax in the lanes that own the row, and passes P through the
warp's own shared memory.  Its tile follows the head dim and, at D <= 128,
the grid: ``simt_tile`` says which (query rows, keys, warps) a call takes.
Each score is one fmaf chain over the columns, of ``q * scale`` and k, as
the plain version forms it, so large logits match it too.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

#: the entry point and the device kernel of each route, as named in
#: csrc/flash_attention.cu
KERNEL_NAMES = {"flash": "flash_attention_fwd", "tc": "flash_fwd_tc",
                "simt": "flash_fwd_kernel"}
#: kernel launches, counted where the wrapper launches: every launch, and
#: each route's
launches = {"flash": 0, "flash_tc": 0, "flash_simt": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def flash_route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes q/k/v of ``dtype`` with head dim ``d``: "tc"
    (tensor cores, bf16) or "simt" (fp32 FMA, f32: the reference holds f32
    to 1e-5, which TF32 would break)."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernel's range 1..{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"flash_attention takes bf16 or f32, got {dtype}")


def _padded(n: int, block: int) -> int:
    return -(-n // block) * block


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
           block_kv: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q [BH,Sq,D], k/v [BHkv,Skv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] != q.shape[2] or q.shape[0] % max(k.shape[0], 1):
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if block_q <= 0 or block_kv <= 0:
        raise ValueError(f"bad blocks ({block_q}, {block_kv})")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, scale: float | None = None,
                          block_q: int = 512,
                          block_kv: int = 512) -> torch.Tensor:
    """The plain PyTorch version: the reference kernel's blocked online
    softmax in fp32 over zero-padded inputs, block by block, with its
    -1e30 mask and its skip rule, batched over BH."""
    _check(q, k, v, block_q, block_kv)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    group = bh // k.shape[0]
    sqp, skvp = _padded(sq, block_q), _padded(skv, block_kv)
    qf = torch.zeros((bh, sqp, d), dtype=torch.float32, device=q.device)
    qf[:, :sq] = q.float()
    kf = torch.zeros((k.shape[0], skvp, d), dtype=torch.float32, device=q.device)
    vf = torch.zeros_like(kf)
    kf[:, :skv] = k.float()
    vf[:, :skv] = v.float()
    if group > 1:
        kf = torch.repeat_interleave(kf, group, dim=0)
        vf = torch.repeat_interleave(vf, group, dim=0)
    rows = torch.arange(block_q, device=q.device)[:, None]
    cols = torch.arange(block_kv, device=q.device)[None, :]
    out = torch.empty((bh, sqp, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sqp, block_q):
        qb = qf[:, q0:q0 + block_q] * scale
        m = torch.full((bh, block_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((bh, block_q, 1), device=q.device)
        acc = torch.zeros((bh, block_q, d), device=q.device)
        for k0 in range(0, skvp, block_kv):
            if causal and k0 > q0 + block_q - 1:   # wholly above the diagonal
                continue
            s = qb @ kf[:, k0:k0 + block_kv].transpose(1, 2)
            if causal:
                s = torch.where(q0 + rows >= k0 + cols, s,
                                torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, k0:k0 + block_kv]
            m = m_new
        out[:, q0:q0 + block_q] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out[:, :sq]


_DTYPES = (torch.bfloat16, torch.float32)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with its C signatures declared (ctypes would otherwise pass
    every argument as a 32-bit int)."""
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [i, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_simt_tile.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.flash_simt_tile.restype = i
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _lib() -> ctypes.CDLL:
    return _typed(_build.load("flash_attention"))


def simt_tile(bh: int, sq: int, d: int) -> tuple[int, int, int]:
    """The CTA tile (query rows, keys, warps) that the f32 kernel takes for
    ``bh`` rows of ``sq`` queries at head dim ``d`` on the current CUDA
    device: it follows d, the grid and the SM count, and changes no number."""
    lib = _lib()
    tile = (ctypes.c_int * 3)()
    _build.raise_if(lib.flash_simt_tile(bh, sq, d, tile), lib.flash_error_string,
                    "flash_simt_tile")
    return tuple(tile)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, scale: float | None = None,
                    block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """Attention through the CUDA kernel of ``flash_route``: q [BH,Sq,D],
    k/v [BHkv,Skv,D] -> [BH,Sq,D] in q's dtype.

    All three bf16 or all f32, contiguous, on one CUDA device, D <= 256.
    Raises on anything else, including a tensor on the CPU:
    ``ops.flash_mha`` dispatches.  ``block_kv`` sets the padded kv extent;
    ``block_q`` changes nothing here (the kernels choose their own q tiles
    and padded q rows are never written), and is kept for the reference's
    signature.
    """
    _check(q, k, v, block_q, block_kv)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention needs tensors on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes bf16 or f32 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q/k/v")
    route = flash_route(q.dtype, d)
    if bh > 65535 or max(bh * sq, k.shape[0] * skv) * d >= 2**31 or skv == 0:
        raise ValueError(f"shapes outside the kernel's range: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    out = torch.empty_like(q)
    if sq == 0 or bh == 0:
        return out
    if scale is None:
        scale = d ** -0.5
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        int(route == "tc"), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
        bh // k.shape[0], sq, skv, _padded(skv, block_kv), d, scale, int(causal), stream)
    _build.raise_if(err, lib.flash_error_string, "flash_attention_fwd launch")
    launches["flash"] += 1
    launches[f"flash_{route}"] += 1
    return out
