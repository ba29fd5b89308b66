"""Shared model plumbing: the matrix-engine dispatch + init helpers.

Every GEMM of the models routes through :func:`matmul`, which selects the
engine per config: ``xla`` (a plain product with fp32 accumulation) or
``pallas_rasa`` (the RASA-scheduled CUDA kernels of
``repro_torch.kernels``; their plain version on the CPU).  The engine names
are the JAX package's.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import register_flop_formula

from ..config import EngineConfig, ModelConfig
from ..distributed.sharding import is_dtensor, map_shards, reshape, unshard_dim
from ..kernels import GemmBlocks, rasa_matmul
from ..kernels.ops import _mm_strategies


def matmul(x: torch.Tensor, w: torch.Tensor, engine: EngineConfig | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] with fp32 accumulation, cast to out_dtype
    (default: x.dtype).  Differentiable under the ``xla`` engine; the
    ``pallas_rasa`` engine is forward-only, as in the reference."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = reshape(x, -1, x.shape[-1])
    if engine is not None and engine.kind == "pallas_rasa":
        blocks = GemmBlocks(engine.block_m, engine.block_k, engine.block_n)
        out = rasa_matmul(x2, w, schedule=engine.schedule, blocks=blocks).to(out_dtype)
    else:
        out = dot_f32(torch.mm, x2, w, out_dtype)
    return reshape(out, *lead, w.shape[-1])


def _product(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(a, b) with fp32 accumulation and an fp32 result.  On a CUDA device
    with bf16 operands this is the library's ``out_dtype`` overload, which
    reads the operands as they are; elsewhere (that overload has no CPU
    kernel, and takes no f32 operand) the operands are cast to fp32 first.
    Products of bf16 values are exact in fp32, so the two differ only in the
    order of the sums."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


#: the longest contraction one ``out_dtype`` product of the backward takes
#: at once: longer ones are summed in pieces, in fp32 (``_grad_product``)
GRAD_K_PIECE = 1024


def _grad_product(op, a: torch.Tensor, b: torch.Tensor,
                  piece: int = GRAD_K_PIECE) -> torch.Tensor:
    """A transposed product of the backward, fp32: ``_product``, except that
    on the ``out_dtype`` route a contraction longer than ``piece`` is taken
    in pieces of ``piece`` whose fp32 results are added in fp32.
    The tensor cores' fp32 accumulation loses precision in proportion to
    the length of the sum: on an H100, at a contraction of 8192 or 12288 it
    is 9e-6 to 1.5e-5 (max error over max) from the exact product, in
    pieces of 1024 1.3e-6 at most, the f32-cast product's level
    (``chip_smoke.py``'s product_precision).  The backward contracts over
    the tokens of a microbatch and over the forward's output width (2 d_ff
    for the fused gate/up)."""
    k = a.shape[-1]
    if not (a.is_cuda and a.dtype == b.dtype == torch.bfloat16) or k <= piece:
        return _product(op, a, b)
    if is_dtensor(a) or is_dtensor(b):
        return torch.ops.repro_torch.product_in_pieces(a, b, piece)
    return _in_pieces(a, b, piece)


def _in_pieces(a: torch.Tensor, b: torch.Tensor, piece: int) -> torch.Tensor:
    """``_product`` of a [.., M, K] and b [.., K, N] (mm, or bmm for a
    leading batch) summed over pieces of ``piece`` along K, in fp32."""
    op = torch.bmm if a.dim() == 3 else torch.mm
    out = _product(op, a[..., :piece], b[..., :piece, :])
    for k0 in range(piece, a.shape[-1], piece):
        out += _product(op, a[..., k0:k0 + piece], b[..., k0:k0 + piece, :])
    return out


@torch.library.custom_op("repro_torch::product_in_pieces", mutates_args=())
def _product_in_pieces(a: torch.Tensor, b: torch.Tensor, piece: int) -> torch.Tensor:
    """``_in_pieces`` as one operator, for DTensor operands: each rank sums
    the pieces of its own shards (``_pieces_sharding``; a contraction split
    over ranks then adds their partial sums), where slicing a DTensor along
    a split contraction would gather it for every piece."""
    return _in_pieces(a, b, piece)


@_product_in_pieces.register_fake
def _(a, b, piece):
    return a.new_empty((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.product_in_pieces)
def _pieces_flops(a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * math.prod(a_shape) * b_shape[-1]


if torch.distributed.is_available():
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.product_in_pieces.default)
    def _pieces_sharding(a, b, piece):
        return [(o, [*i[:2], None]) for o, i in _mm_strategies(False, batch=a.ndim == 3)]


class _DotF32(torch.autograd.Function):
    """op(a, b) accumulated in fp32 and cast to out_dtype, with the
    reference's derivative (``jax.grad`` of ``jnp.dot(...,
    preferred_element_type=float32).astype(out_dtype)``): the cotangent G
    (out_dtype) is upcast to fp32, dA = G bᵀ and dB = aᵀ G are accumulated
    in fp32 and cast to each operand's dtype.  When out_dtype is bf16, G is
    bf16 and both products take the ``out_dtype`` overload on the card (no
    fp32 copy; ``_grad_product``); when it is fp32 (the CE head, the MoE
    router), the fp32 product of the upcast operands.  With no input that
    needs a gradient, or under ``torch.no_grad()``, ``apply`` records
    nothing and this is the forward alone."""

    @staticmethod
    def forward(ctx, op, a, b, out_dtype):
        ctx.op = op
        ctx.save_for_backward(a, b)
        return _product(op, a, b).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        op = ctx.op
        da = db = None
        if ctx.needs_input_grad[1]:
            da = _grad_product(op, g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[2]:
            db = _grad_product(op, a.transpose(-1, -2), g).to(b.dtype)
        return None, da, db, None


def dot_f32(op, a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``op`` (``torch.mm`` or ``torch.bmm``) of a and b with fp32
    accumulation, cast to out_dtype, as ``jnp.dot(...,
    preferred_element_type=float32).astype(out_dtype)``: differentiable,
    with the reference's transposed products as its derivative
    (``_DotF32``), and no fp32 copy of a bf16 operand in the forward on a
    CUDA device."""
    return _DotF32.apply(op, a, b, out_dtype)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present (there is
    no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "present; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def he_init(gen: torch.Generator, shape, dtype, fan_in=None,
            device=None) -> torch.Tensor:
    """He-scaled normal truncated to [-2, 2], drawn in fp32 from ``gen``."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (2.0 / max(fan_in, 1)) ** 0.5
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    x = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return (x * 0.02).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over valid labels (fp32).  logits [..., V], labels [...].
    Returns (loss, the count of valid labels, at least 1)."""
    tot, n = _nll_sum(logits, labels, ignore_index)
    n = torch.clamp(n, min=1)
    return tot / n, n


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of -log p(label) over valid labels in fp32, their count)."""
    # a DTensor's partial sums are reduced and its vocab gathered first, and
    # each rank takes its own rows (DTensor's rule for the gather fails on a
    # split vocab, and its gather's backward makes zeros of the whole batch)
    logits = unshard_dim(logits.float(), -1)
    valid = labels != ignore_index
    nll = map_shards(lambda lg, lb: _nll_rows(lg, lb, ignore_index), (logits, labels),
                     ((0, None), (0, None)), (0, None))
    return nll.sum(), valid.sum(dtype=torch.int32)


def _nll_rows(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """-log p(label) at each position, 0 where the label is ignored."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    return (logz - ll) * valid


def chunked_cross_entropy(x: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 256,
                          ignore_index: int = -100,
                          logits_fn=None) -> tuple[torch.Tensor, torch.Tensor]:
    """CE of x @ head_w without materialising full-sequence logits.

    x: [B, S, D]; head_w: [D, V]; labels: [B, S] (or [B, S, cb] with
    logits_fn reshaping the logits [B, chunk, cb * V]).  A loop over
    S-chunks, each under ``torch.utils.checkpoint`` (non-reentrant), so one
    [B, chunk, V] fp32 logits block lives at a time, in the forward and in
    the backward.  The head product is ``dot_f32`` (fp32 logits), never the
    RASA engine, as the reference's ``jnp.dot``.  Returns (loss, the count
    of valid labels, at least 1).
    """
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the CE chunk {chunk}")
    # the head gathered over its FSDP split (d_model) once, as FSDP does: a
    # product against the split head could move the batch instead, and the
    # logits would then hold every row of the batch on every rank
    head_w = unshard_dim(head_w, 0)

    def chunk_loss(x_c, l_c):
        logits = dot_f32(torch.mm, reshape(x_c, -1, x_c.shape[-1]), head_w)
        logits = reshape(logits, *x_c.shape[:2], -1)
        if logits_fn is not None:
            logits = logits_fn(logits)
        return _nll_sum(logits, l_c, ignore_index)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.int32, device=x.device)
    for c0 in range(0, s, chunk):
        dt, dn = checkpoint(chunk_loss, x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                            use_reentrant=False)
        tot, n = tot + dt, n + dn
    n = torch.clamp(n, min=1)
    return tot / n, n
