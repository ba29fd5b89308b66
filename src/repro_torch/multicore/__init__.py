"""Multi-core RASA CMP: contention-aware chip-level simulation.

Counterpart of the JAX package's ``multicore/``, with the same layers and
exports; the simulations run on the port's backends (``cuda`` by default,
see :data:`repro_torch.multicore.chip.CHIP_BACKENDS`), and the serving
batcher's whole-trace program (:mod:`repro_torch.multicore.jitarb`) is the
hand-written kernel of ``kernels/csrc/jitarb.cu``.

The paper evaluates one RASA engine in one CPU core; this subsystem composes
``n_cores`` per-core :class:`~repro_torch.core.timing.PipelineSimulator` instances
into a chip model and answers the next question up the stack: how does a
RASA CMP behave on a model's worth of GEMMs under shared-memory bandwidth
contention?

Layers
------
:mod:`~repro_torch.multicore.arbiter`
    The **single** bandwidth-arbitration implementation: a monotone
    fixed-point relaxation over generic activity spans ``[start, end)``
    with pluggable share policies (equal / demand-weighted) and a
    settled-prefix cache.  The closed batch is the "all spans start at
    epoch 0" special case; the online model staggers the starts.
:mod:`~repro_torch.multicore.chip`
    ``ChipConfig`` (a ``CoreSpec`` per core -- one design replicated or a
    mixed BASE/RASA vector -- x bandwidth budget x arbitration x share
    policy), the ``EpochBandwidthLoadModel`` epoch-sliced token-bucket
    arbiter (default) and the ``SharedBandwidthLoadModel`` static-share
    baseline, both plugged into each core's load/store ports,
    ``CoreCluster`` (the arbiter's closed-batch client: one stream per
    core, re-simulations batched through the fast backends), and
    ``ChipReport`` aggregates (makespan, per-core utilization, bandwidth
    stalls, per-epoch share/active traces, WLBP hit rate,
    speedup/efficiency vs. one core, core designs/weights).
:mod:`~repro_torch.multicore.partition`
    Intra-GEMM parallelism: M-split / N-split / 2D block-cyclic sharding of
    one ``GemmSpec`` into per-core sub-GEMMs (output-space only; K is never
    split, so no cross-core reduction).
:mod:`~repro_torch.multicore.scheduler`
    Inter-GEMM parallelism: static round-robin and dynamic work-queue /
    LPT placement of layer-level GEMM workloads, plus the ``gang``
    scheduler that splits a dominant GEMM across soon-idle cores
    (combined inter+intra parallelism) and ``assign_incremental`` for
    mid-run injection onto already-loaded cores.
:mod:`~repro_torch.multicore.online`
    Open-arrival form of the chip model: segments of scheduled work
    arrive and depart at epoch boundaries while the chip is mid-run -- a
    thin incremental client of the same span arbiter, with retired-span
    pruning for thousand-request serving traces (drives the serving
    batcher in :mod:`repro_torch.serving.simbatch`; see
    ``docs/serving_sim.md``).  ``OnlineChip.snapshot()`` /
    ``OnlineChip.restore()`` checkpoint long runs bit-exactly.
:mod:`~repro_torch.multicore.faults`
    Deterministic fault injection over either client: timed ``core_down``
    / ``core_up`` events (preemption + migration), ``bw_derate`` thermal
    windows (scaled arbiter budgets) and ``slow_core`` DVFS throttles,
    described by a seedable ``FaultPlan`` on ``ChipConfig.fault_plan``
    (see ``docs/resilience.md``).

Modelling assumptions (see ``docs/multicore.md`` for details)
-------------------------------------------------------------
* Cores are homogeneous and private resources (register file, issue port,
  weight-insertion network) are per-core; tile loads *and* ``rasa_ts``
  stores share the chip's memory bandwidth (``store_bytes_shared=False``
  recovers the loads-only accounting).
* Contention is arbitrated in scheduling epochs (``epoch_cycles``): each
  epoch's equal share is recomputed over the cores still drawing on the
  budget, so early finishers return their bandwidth.  Bursts up to
  ``bw_burst_bytes`` pass at full LSQ rate, but unused allowance is capped
  at the burst -- bytes granted per epoch never exceed the epoch's budget
  (plus the burst and one in-flight tile).  ``arbitration="static"`` keeps
  the frozen equal-share model for comparison.
* At ``n_cores=1`` the full budget exceeds one engine's demand by design,
  so the chip model reduces exactly to the single-core simulator.

:mod:`~repro_torch.multicore.jitarb`
    The serving batcher's whole-trace arbitration program on the fault-free
    domain: host planning in numpy, the settle on the card
    (:mod:`repro_torch.kernels.jitarb`).

Entry point: :func:`simulate_chip` -- pass one ``GemmSpec`` (partitioned) or
a list of them (scheduled).
"""

from .arbiter import (MAX_ARBITER_ROUNDS, SHARE_POLICIES, ArbiterTrace,
                      DemandWeightedShare, SharePolicy, Span, SpanArbiter,
                      build_share_schedule, get_share_policy)
from .chip import (ARBITRATIONS, CHIP_BACKENDS, ChipConfig, ChipReport,
                   CoreCluster, CoreSpec, EpochBandwidthLoadModel,
                   SharedBandwidthLoadModel, partitioned_chip_report,
                   simulate_chip)
from .faults import (EMPTY_PLAN, FAULT_KINDS, PREEMPTION_POLICIES,
                     FaultEvent, FaultPlan, bw_derate, core_down, core_up,
                     faulted_chip_report, random_plan, slow_core)
from .online import OnlineChip, OnlineSnapshot, Segment
from .partition import PARTITIONERS, partition_gemm, split_ways
from .scheduler import (SCHEDULERS, assign, assign_incremental,
                        scheduled_chip_report)

__all__ = [
    "ARBITRATIONS", "CHIP_BACKENDS", "ArbiterTrace", "ChipConfig",
    "ChipReport", "CoreCluster", "CoreSpec",
    "EpochBandwidthLoadModel", "SharedBandwidthLoadModel",
    "MAX_ARBITER_ROUNDS", "SHARE_POLICIES", "SharePolicy",
    "DemandWeightedShare", "Span", "SpanArbiter", "get_share_policy",
    "build_share_schedule", "partitioned_chip_report", "simulate_chip",
    "OnlineChip", "OnlineSnapshot", "Segment",
    "EMPTY_PLAN", "FAULT_KINDS", "PREEMPTION_POLICIES", "FaultEvent",
    "FaultPlan", "bw_derate", "core_down", "core_up",
    "faulted_chip_report", "random_plan", "slow_core",
    "PARTITIONERS", "partition_gemm", "split_ways",
    "SCHEDULERS", "assign", "assign_incremental", "scheduled_chip_report",
]
