"""ModelConfig -> chip Workload compilation (the workload frontend).

This is the missing layer between the ten model configs under
:mod:`repro_torch.configs` and the chip model: it turns any
:class:`repro_torch.config.ModelConfig` plus an inference point ``(batch, seq,
phase)`` into a :class:`Workload` -- the per-layer GEMM stream the
multi-core schedulers, both arbiter clients, and the serving batcher eat.

Phase semantics
---------------
``phase="prefill"``
    All ``batch * seq`` prompt tokens flow through every projection, so
    projection GEMMs carry ``M = batch * seq``; SSM blocks run the chunked
    SSD scan (see below).
``phase="decode"``
    One new token per sequence: projection GEMMs carry ``M = batch`` (the
    small-M regime the paper's register-aware techniques target), ``seq``
    is the KV/context length (it sizes the optional attention-score GEMMs
    and the SSD recurrent state reads), and SSM blocks run the O(1)
    recurrent update.

Lowering per block
------------------
* Attention: fused ``qkv`` ([d, (h + 2*kv) * hd]) and ``wo`` ([h * hd, d]);
  with ``CompileOptions.attention_scores`` also the ``QK^T`` / ``PV`` score
  GEMMs, folded along M over the ``batch * n_heads`` instances (a
  block-diagonal approximation: MAC-exact, reuse-approximate).
* Dense FFN: ``swiglu``/``geglu`` emit gate + up + down (one fused
  [d, 2*d_ff] gate-up GEMM under ``fuse_gate_up``); other activations
  emit up + down.
* MoE: balanced ("uniform") routing over ``n_active = min(n_experts,
  routed_tokens, max_experts)`` experts, ``ceil(routed_tokens /
  n_active)`` tokens each, where ``routed_tokens = M * top_k``.  Each
  modeled expert's GEMM pair is one *placement group* (``L{i}.e{j}``):
  schedulers place a group atomically on one core, so distinct experts
  spreading over cores is exactly expert parallelism.
* SSM (Mamba2): ``in_proj`` / ``out_proj`` projections plus the SSD core
  costed via the :mod:`repro_torch.kernels.ssd_chunk` decomposition -- per
  (batch, head, chunk) the chunked scan is four matmuls (``cb = C @ B^T``,
  intra-chunk ``y = w @ xdt``, inter-chunk ``y += C @ state``, and the
  state update), folded along M over their instances; decode degenerates
  to the recurrent ``y = C @ state`` read plus the rank-1 state update.

Dedup / caching
---------------
Spec names are canonical per *block kind*, not per layer index
(``gemma-2b.attn.qkv``, never ``...L17.qkv``), so the ``n_layers``
repetitions of a layer produce literally equal ``GemmSpec``s: the lowering
cache (:func:`repro_torch.core.tiling.lowered_stream`), the trace compiler
(:func:`repro_torch.core.trace.compiled_trace`) and the scheduler's cost cache
all compile a repeated layer once.  :class:`WorkloadOp` carries the layer
index separately for reporting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from ..config import ModelConfig
from ..core.tiling import GemmSpec

PHASES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Explicit knobs of the compile layer.

    ``dim_cap`` caps every GEMM dimension (the LLM-projection benchmark's
    heuristic, now a first-class option: relative BASE -> RASA behaviour in
    the small-M regime is insensitive to K/N beyond a few thousand, while
    simulation cost is not).  ``max_layers`` lowers only the first L layers
    (the workload records the full depth for scaled reporting).
    ``max_experts`` caps the modeled expert-parallel width per MoE layer;
    the routed token count is conserved, so capped experts are fewer but
    proportionally fatter.  ``attention_scores`` adds the ``QK^T`` / ``PV``
    GEMMs; ``include_head`` appends the LM head(s) (``n_codebooks`` of
    them for audio models).
    """

    dim_cap: int | None = None
    max_layers: int | None = None
    max_experts: int | None = None
    attention_scores: bool = False
    include_head: bool = False

    def cap(self, dim: int) -> int:
        return max(1, min(dim, self.dim_cap)) if self.dim_cap else dim


#: default options: the uncapped, projection-only lowering
DEFAULT_OPTIONS = CompileOptions()


@dataclasses.dataclass(frozen=True)
class WorkloadOp:
    """One GEMM of a compiled workload, with its provenance.

    ``group`` is the placement-group key (MoE expert-parallel hint): ops
    sharing a group must land on one core as a unit; ``None`` ops are
    free-standing.
    """

    spec: GemmSpec
    layer: int                      # layer index (-1 for the LM head)
    block: str                      # attn | ffn | moe | ssm | head
    group: str | None = None


@dataclasses.dataclass(frozen=True)
class Workload:
    """A compiled model inference point: the chip-schedulable GEMM stream."""

    name: str
    arch: str
    phase: str
    batch: int
    seq: int
    #: layers actually lowered (== n_layers unless max_layers cut the stack)
    layers_modeled: int
    #: the model's full depth, for scaled single-core projections
    n_layers: int
    ops: tuple[WorkloadOp, ...]

    @property
    def specs(self) -> tuple[GemmSpec, ...]:
        return tuple(op.spec for op in self.ops)

    @property
    def macs(self) -> int:
        return sum(op.spec.macs for op in self.ops)

    def units(self) -> list[tuple[GemmSpec, ...]]:
        """Scheduler items: placement groups as atomic spec tuples.

        Consecutive ops sharing a ``group`` key collapse into one unit (a
        MoE expert's GEMM pair); ungrouped ops are singleton units.  Order
        follows the op stream, so single-core placement preserves the
        layer order exactly.
        """
        units: list[tuple[GemmSpec, ...]] = []
        open_key: str | None = None
        for op in self.ops:
            if op.group is not None and op.group == open_key:
                units[-1] = units[-1] + (op.spec,)
            else:
                units.append((op.spec,))
                open_key = op.group
        return units

    def unique_specs(self) -> list[tuple[GemmSpec, int]]:
        """The distinct GEMMs with multiplicities (the dedup view: repeated
        layers share canonically-named, literally equal specs)."""
        counts: dict[GemmSpec, int] = {}
        for op in self.ops:
            counts[op.spec] = counts.get(op.spec, 0) + 1
        return list(counts.items())


def _resolve_model(model) -> tuple[ModelConfig, str]:
    if isinstance(model, ModelConfig):
        return model, model.name
    from ..configs import get_config
    return get_config(model).model, model


def _attention_ops(m: ModelConfig, arch: str, layer: int, m_tokens: int,
                   batch: int, seq: int, phase: str, o: CompileOptions
                   ) -> Iterable[WorkloadOp]:
    d, hd = o.cap(m.d_model), m.resolved_head_dim
    n_qkv = o.cap((m.n_heads + 2 * m.n_kv_heads) * hd)
    mk = lambda op, M, K, N: WorkloadOp(
        GemmSpec(f"{arch}.attn.{op}", M, K, N), layer, "attn")
    yield mk("qkv", m_tokens, d, n_qkv)
    if o.attention_scores:
        # per-(batch, head) score/context GEMMs folded along M; decode has
        # one query row per instance, prefill a full seq x seq block
        q_rows = seq if phase == "prefill" else 1
        M = o.cap(batch * m.n_heads * q_rows)
        kv = o.cap(seq)
        yield mk("scores", M, hd, kv)
        yield mk("context", M, kv, hd)
    yield mk("wo", m_tokens, o.cap(m.n_heads * hd), d)


def _ffn_ops(m: ModelConfig, arch: str, layer: int, m_tokens: int,
             o: CompileOptions) -> Iterable[WorkloadOp]:
    d, ff = o.cap(m.d_model), o.cap(m.d_ff)
    mk = lambda op, M, K, N: WorkloadOp(
        GemmSpec(f"{arch}.ffn.{op}", M, K, N), layer, "ffn")
    if m.act in ("swiglu", "geglu"):
        if m.fuse_gate_up:
            yield mk("gate_up", m_tokens, d, o.cap(2 * m.d_ff))
        else:
            yield mk("gate", m_tokens, d, ff)
            yield mk("up", m_tokens, d, ff)
    else:
        yield mk("up", m_tokens, d, ff)
    yield mk("down", m_tokens, ff, d)


def _moe_ops(m: ModelConfig, arch: str, layer: int, m_tokens: int,
             o: CompileOptions) -> Iterable[WorkloadOp]:
    moe = m.moe
    assert moe is not None
    d, ffe = o.cap(m.d_model), o.cap(moe.d_ff_expert)
    routed = m_tokens * moe.top_k
    n_active = min(moe.n_experts, routed)
    if o.max_experts:
        n_active = min(n_active, o.max_experts)
    m_e = math.ceil(routed / n_active)
    for e in range(n_active):
        group = f"L{layer}.e{e}"
        mk = lambda op, M, K, N: WorkloadOp(
            GemmSpec(f"{arch}.moe.{op}", M, K, N), layer, "moe", group)
        if m.act in ("swiglu", "geglu") and not m.fuse_gate_up:
            yield mk("gate", m_e, d, ffe)
        yield mk("up", m_e, d, ffe)
        yield mk("down", m_e, ffe, d)


def _ssm_ops(m: ModelConfig, arch: str, layer: int, m_tokens: int,
             batch: int, seq: int, phase: str, o: CompileOptions
             ) -> Iterable[WorkloadOp]:
    s = m.ssm
    assert s is not None
    d = o.cap(m.d_model)
    di = s.expand * m.d_model
    h = di // s.head_dim
    P, N = s.head_dim, s.d_state
    n_in = o.cap(2 * di + 2 * s.n_groups * N + h)
    mk = lambda op, M, K, Nn: WorkloadOp(
        GemmSpec(f"{arch}.ssm.{op}", M, K, Nn), layer, "ssm")
    yield mk("in_proj", m_tokens, d, n_in)
    if phase == "prefill":
        # chunked SSD (Dao & Gu): per (batch, head, chunk) four matmuls,
        # folded along M over their instances (MAC-exact)
        q = min(s.chunk, seq)
        nc = math.ceil(seq / q)
        rows = o.cap(batch * h * nc * q)
        yield mk("ssd.cb", rows, N, o.cap(q))          # C @ B^T
        yield mk("ssd.intra", rows, o.cap(q), P)       # w @ xdt
        yield mk("ssd.inter", rows, N, P)              # C @ state
        yield mk("ssd.state", o.cap(batch * h * nc * N), o.cap(q), P)
    else:
        # recurrent step: y = C @ state per (batch, head), plus the rank-1
        # state update outer(B, x * dt)
        yield mk("ssd.out", o.cap(batch * h), N, P)
        yield mk("ssd.state", o.cap(batch * h * N), 1, P)
    yield mk("out_proj", m_tokens, o.cap(di), d)


def layer_ops(model, layer: int, *, batch: int, seq: int,
              phase: str = "decode",
              options: CompileOptions = DEFAULT_OPTIONS
              ) -> list[WorkloadOp]:
    """The GEMM ops of one layer at one inference point.

    Hybrid models (Zamba2-style) interleave: every layer runs the SSM
    block, and layers at the shared-attention stride additionally run the
    attention + FFN block.
    """
    m, arch = _resolve_model(model)
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; available: {PHASES}")
    m_tokens = batch * seq if phase == "prefill" else batch
    m_tokens = options.cap(m_tokens)
    out: list[WorkloadOp] = []
    attn_layer = m.n_heads > 0
    if m.hybrid is not None:
        attn_layer = m.n_heads > 0 and layer % m.hybrid.attn_every == 0
    if m.ssm is not None:
        out += _ssm_ops(m, arch, layer, m_tokens, batch, seq, phase, options)
    if attn_layer:
        out += _attention_ops(m, arch, layer, m_tokens, batch, seq, phase,
                              options)
        if m.moe is not None:
            out += _moe_ops(m, arch, layer, m_tokens, options)
        elif m.d_ff:
            out += _ffn_ops(m, arch, layer, m_tokens, options)
    return out


def compile_workload(model, *, batch: int, seq: int,
                     phase: str = "decode",
                     options: CompileOptions = DEFAULT_OPTIONS) -> Workload:
    """Compile ``model`` at ``(batch, seq, phase)`` into a :class:`Workload`.

    ``model`` is a :class:`repro_torch.config.ModelConfig` or an arch name from
    :data:`repro_torch.configs.ARCH_NAMES`.  The resulting op stream is
    layer-ordered; repeated layers share canonically-named specs, so the
    trace compiler lowers each distinct shape once no matter the depth.
    """
    m, arch = _resolve_model(model)
    if batch < 1 or seq < 1:
        raise ValueError("batch and seq must be >= 1")
    n = m.n_layers
    modeled = min(n, options.max_layers) if options.max_layers else n
    ops: list[WorkloadOp] = []
    for layer in range(modeled):
        ops += layer_ops(m, layer, batch=batch, seq=seq, phase=phase,
                         options=options)
    if options.include_head:
        m_tokens = options.cap(batch * seq if phase == "prefill" else batch)
        for cb in range(m.n_codebooks):
            ops.append(WorkloadOp(
                GemmSpec(f"{arch}.head", m_tokens,
                         options.cap(m.d_model), options.cap(m.vocab)),
                -1, "head"))
    if not ops:
        raise ValueError(f"{arch}: no GEMMs lowered -- "
                         f"check the model's block configuration")
    return Workload(
        name=f"{arch}/{phase}[b{batch},s{seq}]",
        arch=arch, phase=phase, batch=batch, seq=seq,
        layers_modeled=modeled, n_layers=n, ops=tuple(ops))
