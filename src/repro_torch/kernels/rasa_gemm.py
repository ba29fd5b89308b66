"""RASA-scheduled GEMM: the hand-written CUDA kernels, their wrapper, and
the plain PyTorch version they are held against.

Counterpart of the JAX package's ``kernels/rasa_gemm.py``.  The schedules
keep the paper's meaning (``csrc/rasa_gemm.cu`` says how each maps onto a
Hopper CTA):

  schedule="base"  weight-stationary, one launch per k-chunk; every output
                   tile reloads its B slab (WL before every rasa_mm).
  schedule="wlbp"  weight-stationary, one launch per k-chunk; a cluster of
                   CTAs along M keeps the chunk's B block on chip and walks
                   every M tile over it (the WL skip).
  schedule="wls"   output-stationary, one launch; an fp32 accumulator seeded
                   from C walks all k-chunks and writes C once.

``GemmBlocks`` keep their meaning: ``bk`` is the k-chunk, which fixes the
fp32 reduction's chunking and so the numbers; ``bm``/``bn`` are the
reference's traversal blocks.  The CUDA CTA tile is the source's own
choice, inside them (227 KB of shared memory does not hold a 256x512x256
tile).  All three schedules give bit-identical results.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

SCHEDULES = ("base", "wlbp", "wls")

#: kernel launches per schedule, counted where the wrapper launches
launches = {s: 0 for s in SCHEDULES}

#: the kernel each schedule launches, as named in csrc/rasa_gemm.cu
KERNEL_NAMES = {"base": "rasa_ws_chunk<base>", "wlbp": "rasa_ws_chunk<wlbp>",
                "wls": "rasa_wls"}


def reset_launches() -> None:
    for s in SCHEDULES:
        launches[s] = 0


@dataclasses.dataclass(frozen=True)
class GemmBlocks:
    bm: int = 256
    bk: int = 512
    bn: int = 256

    def vmem_bytes(self, in_dtype_bytes: int = 2) -> int:
        """Working set per pipeline stage of the reference's tiling (x2 when
        double buffered); ``default_blocks`` keeps its rule so that ``bk``,
        and with it the numbers, match the reference."""
        return (self.bm * self.bk * in_dtype_bytes
                + self.bk * self.bn * in_dtype_bytes
                + self.bm * self.bn * 4)


def default_blocks(m: int, k: int, n: int,
                   vmem_budget_bytes: int = 8 * 2**20) -> GemmBlocks:
    """The reference's block rule: 128-multiples under a VMEM budget."""
    def shrink(x, b):
        while b > 128 and x % b != 0:
            b //= 2
        return min(b, max(128, x))
    bm = shrink(m, 256)
    bk = shrink(k, 512)
    bn = shrink(n, 256)
    blocks = GemmBlocks(bm, bk, bn)
    while 2 * blocks.vmem_bytes() > vmem_budget_bytes and blocks.bk > 128:
        blocks = GemmBlocks(blocks.bm, blocks.bk // 2, blocks.bn)
    return blocks


def schedule_cost(m: int, k: int, n: int, blocks: GemmBlocks,
                  schedule: str, in_bytes: int = 2, out_bytes: int = 4) -> dict:
    """Bytes moved per schedule by the reference's tiling (napkin math)."""
    mt, kt, nt = m // blocks.bm, k // blocks.bk, n // blocks.bn
    a_bytes = m * k * in_bytes
    b_bytes = k * n * in_bytes
    c_bytes = m * n * out_bytes
    if schedule == "base":
        traffic = {"A": a_bytes, "B": b_bytes * mt, "C": 2 * c_bytes * kt}
    elif schedule == "wlbp":
        traffic = {"A": a_bytes * nt, "B": b_bytes, "C": 2 * c_bytes * kt}
    else:  # wls
        traffic = {"A": a_bytes * nt, "B": b_bytes * mt, "C": 2 * c_bytes}
    total = sum(traffic.values())
    flops = 2 * m * k * n
    return {"schedule": schedule, "traffic_bytes": traffic,
            "total_bytes": total, "flops": flops,
            "arithmetic_intensity": flops / total}


def _check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None,
           schedule: str, blocks: GemmBlocks) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if c is not None and tuple(c.shape) != (a.shape[0], b.shape[1]):
        raise ValueError(f"c has shape {tuple(c.shape)}, want "
                         f"{(a.shape[0], b.shape[1])}")
    if blocks.bk <= 0:
        raise ValueError(f"bad blocks {blocks}")


def rasa_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor | None = None, *, schedule: str = "wls",
                    blocks: GemmBlocks | None = None,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version: the same k-chunk chain as the kernels
    (C + A[:, chunk] @ B[chunk] in fp32, chunk after chunk), which is the
    same sum for every schedule."""
    m, k = a.shape
    n = b.shape[1]
    blocks = blocks or default_blocks(m, k, n)
    _check(a, b, c, schedule, blocks)
    out = (torch.zeros((m, n), dtype=torch.float32, device=a.device)
           if c is None else c.to(torch.float32).clone())
    af, bf = a.float(), b.float()
    for k0 in range(0, k, blocks.bk):
        out += af[:, k0:k0 + blocks.bk] @ bf[k0:k0 + blocks.bk]  # in place on our buffer
    return out.to(out_dtype)


_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def _lib():
    lib = _build.load("rasa_gemm")
    if not getattr(lib, "_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.rasa_ws_chunk.argtypes = [i, i, p, ll, p, ll, ll, p, i, i, i, i, i, i, p]
        lib.rasa_ws_chunk.restype = i
        lib.rasa_wls.argtypes = [i, p, ll, p, ll, ll, p, i, i, i, i, i, p]
        lib.rasa_wls.restype = i
        lib.rasa_sgemm_tile.argtypes = [i, i, i]
        lib.rasa_sgemm_tile.restype = i
        lib.rasa_sgemm_wlbp_cluster.argtypes = [i, i]
        lib.rasa_sgemm_wlbp_cluster.restype = i
        lib.rasa_error_string.argtypes = [i]
        lib.rasa_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def simt_tile(schedule: str, m: int, n: int) -> tuple[int, int]:
    """The CTA tile (rows, columns) that ``schedule``'s f32 M > 4 kernel takes
    at (M, N) on the current CUDA device: it follows M, N and the SM count,
    and changes no number."""
    return _lib().rasa_sgemm_tile(int(schedule == "wlbp"), m, n), 64


def rasa_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
              *, schedule: str = "wls", blocks: GemmBlocks | None = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C (+)= A @ B through the CUDA kernel of ``schedule``, any 2D shapes.

    a: [M, K] and b: [K, N], both bf16 or both f32, on one CUDA device; a
    unit-stride along K, b any strides (``embedding.T`` is read in place).
    Optional c: [M, N] accumulator input (not modified).  Raises on anything
    else, including a tensor on the CPU: ``ops.rasa_matmul`` dispatches; and
    on an f32 ``wlbp`` chunk at M > 4 deeper than a cluster of 8 CTAs holds
    (3072 rows).
    """
    m, k = a.shape
    n = b.shape[1]
    blocks = blocks or default_blocks(m, k, n)
    _check(a, b, c, schedule, blocks)
    if a.device.type != "cuda" or b.device != a.device or (
            c is not None and c.device != a.device):
        raise ValueError(f"rasa_gemm needs tensors on one CUDA device, got "
                         f"{a.device}, {b.device}"
                         + ("" if c is None else f", {c.device}"))
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"rasa_gemm takes bf16 or f32 inputs of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if a.stride(1) != 1:
        raise ValueError(f"a must be unit-stride along K, got strides {a.stride()}")
    if max(m, n, k) >= 2**31:
        raise ValueError(f"dims too large for int32 indexing: {(m, k, n)}")
    # the wrapper owns C: a fresh f32 buffer the kernels update in place.
    # With no c and M <= 4 it stays unfilled: the decode kernels add their
    # first sum to zero instead of reading it (c_init 0).
    fresh = c is None and m <= 4 and k > 0
    out = (c.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
           if c is not None else
           (torch.empty if fresh else torch.zeros)((m, n), dtype=torch.float32,
                                                   device=a.device))
    if m == 0 or n == 0 or k == 0:
        return out.to(out_dtype)
    lib = _lib()
    if schedule == "wlbp" and a.dtype == torch.float32 and m > 4:
        depth = min(blocks.bk, k)  # the first chunk is the deepest
        if lib.rasa_sgemm_wlbp_cluster(m, depth) == 0:
            raise ValueError(f"an f32 wlbp chunk {depth} deep at M={m} does not fit in "
                             "the shared memory of a cluster of 8 CTAs")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (_DTYPES[a.dtype], a.data_ptr(), a.stride(0), b.data_ptr(),
            b.stride(0), b.stride(1), out.data_ptr(), m, n, k)
    if schedule == "wls":
        _build.raise_if(lib.rasa_wls(*args, blocks.bk, int(not fresh), stream),
                        lib.rasa_error_string, "rasa_wls launch")
        launches["wls"] += 1
    else:
        wlbp, what = int(schedule == "wlbp"), f"rasa_ws_chunk<{schedule}> launch"
        for k0 in range(0, k, blocks.bk):
            _build.raise_if(lib.rasa_ws_chunk(wlbp, *args, k0, blocks.bk,
                                              int(not fresh or k0 > 0), stream),
                            lib.rasa_error_string, what)
            launches[schedule] += 1
    return out.to(out_dtype)
