"""Cycle-level timing model of the RASA matrix engine (paper §IV-B, Fig. 4).

The execution of one ``rasa_mm`` on the weight-stationary array is divided
into four sub-stages (durations in engine cycles, array of ``rows x cols``):

  WL  (Weight Load)   rows          stream B top->bottom
  FF  (Feed First)    tm            feed A/C until the first array row is done
  FS  (Feed Second)   rows - 1      drain the feed skew through lower rows
  DR  (Drain)         cols (+1 DM)  eject remaining outputs (+ DM merge row)

Scheduling rules per design (cf. DESIGN.md §1 for the validation targets):

  BASE   : fully serial -- WL_i >= DR_end_{i-1}.
  PIPE   : WL_i overlaps the previous DR -- WL_i >= FS_end_{i-1}.
  WLBP   : if the B register is reused & clean (dirty bit), skip WL and let
           FF_i overlap the previous FS/DR -- FF_i >= FF_end_{i-1}.
  WLS+DB : WL_i streams into the shadow buffer behind the previous
           instruction's compute wavefront (extra per-PE links); effectively
           hidden whenever the array is still busy, so FF_i >= FF_end_{i-1}.
           A cold WL (idle array) still pays the full `rows` cycles.

True data dependencies are honoured through register ready-times: a tile
load's consumer waits `load_latency`; an ``rasa_mm`` accumulating into the
same C register as a previous ``rasa_mm`` must wait for that instruction's
DR to complete (C streams through the array) -- this is why Algorithm 1 in
the paper round-robins four C registers, and it is what makes the register
*allocation* policy performance-relevant ("register-aware").
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .designs import EngineConfig
from .isa import Instr, Op, TileRegisterFile, tile_bytes


class LoadStreamModel:
    """Reusable stream-timing hook: arbitrates tile load *and* store slots.

    The default model reproduces the paper's idealized LSQ -- ``load_ports``
    tile loads sustained per engine cycle, never bandwidth-limited ("the
    memory system never throttles throughput"), and ``rasa_ts`` stores
    retiring for free (``store_ports=None``).  Subclasses may impose an
    aggregate, possibly *time-varying* bandwidth budget and serialize stores
    on dedicated ports (see :mod:`repro_torch.multicore`); the simulator calls
    :meth:`acquire` once per ``rasa_tl`` and :meth:`acquire_store` once per
    ``rasa_ts``, both in issue order, and :meth:`reset` at the start of every
    :meth:`PipelineSimulator.run`.

    ``last_grant`` records the start time of the latest memory access the
    model has granted; chip-level arbiters use it to decide until when a
    core keeps drawing on the shared budget (its *activity* horizon).
    """

    def __init__(self, load_ports: int, store_ports: int | None = None):
        self.load_ports = load_ports
        #: stores per cycle the store path sustains; ``None`` keeps the
        #: paper's loads-only model where stores never serialize.
        self.store_ports = store_ports
        self.reset()

    def reset(self) -> None:
        self._next_free = 0.0
        self._store_next_free = 0.0
        self.last_grant = 0.0

    def acquire(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        """Claim a load slot for ``n_bytes`` requested at ``t_request``.

        Returns ``(t_start, bw_stall)``: when the load actually starts and
        how many cycles of that wait are attributable to bandwidth throttling
        (always 0 for the unthrottled port model).
        """
        start = max(t_request, self._next_free)
        self._next_free = start + 1.0 / self.load_ports
        self.last_grant = max(self.last_grant, start)
        return start, 0.0

    def acquire_store(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        """Claim a store slot; same contract as :meth:`acquire`.

        With ``store_ports=None`` stores are free (no serialization, no
        bytes) -- the paper's idealized model.
        """
        if self.store_ports is None:
            return t_request, 0.0
        start = max(t_request, self._store_next_free)
        self._store_next_free = start + 1.0 / self.store_ports
        self.last_grant = max(self.last_grant, start)
        return start, 0.0


@dataclasses.dataclass
class MMSchedule:
    index: int
    wl_start: float
    wl_skipped: bool
    ff_start: float
    ff_end: float
    fs_end: float
    dr_end: float


@dataclasses.dataclass
class TimingResult:
    cycles: float                      # engine cycles until everything retires
    n_mm: int
    n_tl: int
    n_ts: int
    wl_skips: int                      # WLBP hits
    useful_macs: float                 # sum(tm*tk*tn) over mm instructions
    peak_macs_per_cycle: int
    #: cumulative load/store-start delay imposed by the bandwidth arbiter.
    #: This counts delays the pipeline may absorb (loads run far ahead of
    #: their consumers); the end-to-end cost of contention is
    #: ``ChipReport.bw_stall_cycles`` in :mod:`repro_torch.multicore`.  Zero here
    #: guarantees the run is identical to an unthrottled one.
    bw_stall_cycles: float = 0.0
    schedules: list[MMSchedule] | None = None

    @property
    def load_stall_cycles(self) -> float:
        """Deprecated alias of :attr:`bw_stall_cycles` (pre-PR-6 name)."""
        return self.bw_stall_cycles

    @property
    def utilization(self) -> float:
        """Average MAC-unit utilization (useful MACs / peak MAC slots)."""
        if self.cycles <= 0:
            return 0.0
        return self.useful_macs / (self.cycles * self.peak_macs_per_cycle)

    def runtime_seconds(self, clock_hz: float) -> float:
        """Wall time at the given engine clock (cycles are clock-agnostic)."""
        return self.cycles / clock_hz


class PipelineSimulator:
    """In-order issue, cycle-level sub-stage pipeline simulator."""

    def __init__(self, config: EngineConfig, keep_schedules: bool = False,
                 load_model: LoadStreamModel | None = None):
        self.cfg = config
        self.keep_schedules = keep_schedules
        #: stream-timing hook for tile loads; reset at the start of each run.
        self.load_model = load_model or LoadStreamModel(config.load_ports)

    def run(self, stream: Sequence[Instr]) -> TimingResult:
        cfg = self.cfg
        wl = cfg.wl_cycles
        fs = cfg.fs_cycles
        dr = cfg.dr_cycles
        # core->engine issue bandwidth: instructions issued per engine cycle.
        issue_per_cycle = cfg.core_issue_width * (cfg.core_clock_hz / cfg.engine_clock_hz)
        load_lat = float(cfg.load_latency)
        load_model = self.load_model
        load_model.reset()

        regfile = TileRegisterFile()
        reg_ready = [0.0] * len(regfile.regs)

        # previous MM stage times (engine constraints are chained through these)
        p_ff_start = -1.0
        p_ff_end = 0.0
        p_fs_end = 0.0
        p_dr_end = 0.0
        have_prev = False
        # the weight-insertion network is a single resource: real WLs are
        # serialized on it (monotonic), independent of WLBP skips in between.
        wl_port_free = 0.0

        t_end = 0.0
        n_mm = n_tl = n_ts = wl_skips = 0
        useful = 0.0
        bw_stall = 0.0
        schedules: list[MMSchedule] = [] if self.keep_schedules else None  # type: ignore

        for idx, ins in enumerate(stream):
            t_issue = idx / issue_per_cycle

            if ins.op is Op.TL:
                n_tl += 1
                start, stall = load_model.acquire(t_issue, tile_bytes(ins))
                bw_stall += stall
                done = start + load_lat
                regfile.write(ins.dst, ins.addr)       # type: ignore[arg-type]
                reg_ready[ins.dst] = done              # type: ignore[index]
                t_end = max(t_end, done)
                continue

            if ins.op is Op.TS:
                n_ts += 1
                t_avail = max(t_issue, reg_ready[ins.src1])    # type: ignore[index]
                start, stall = load_model.acquire_store(t_avail, tile_bytes(ins))
                bw_stall += stall
                t_end = max(t_end, start + 1.0)
                continue

            # ---- rasa_mm ---------------------------------------------------
            n_mm += 1
            c, a, b = ins.dst, ins.src1, ins.src2
            t_ready_ac = max(t_issue, reg_ready[a], reg_ready[c])  # type: ignore[index]
            t_ready_b = max(t_issue, reg_ready[b])                 # type: ignore[index]

            reuse = cfg.wlbp and regfile.mm_weight_reusable(b)     # type: ignore[arg-type]

            if reuse:
                wl_start = t_ready_b
                wl_skipped = True
                ff_start = max(t_ready_ac, p_ff_end if have_prev else 0.0)
            elif cfg.wls:
                # prefetch into shadow buffer; hidden behind an active array
                wl_start = max(t_ready_b,
                               p_ff_start if have_prev else 0.0,
                               wl_port_free)
                hidden = have_prev and wl_start <= p_fs_end
                weights_ready = (wl_start + 1.0) if hidden else (wl_start + wl)
                wl_skipped = False
                ff_start = max(t_ready_ac,
                               p_ff_end if have_prev else 0.0,
                               weights_ready)
            elif cfg.pipe:
                wl_start = max(t_ready_b, p_fs_end if have_prev else 0.0,
                               wl_port_free)
                wl_skipped = False
                ff_start = max(t_ready_ac, wl_start + wl,
                               p_dr_end if have_prev else 0.0)
            else:  # BASE
                wl_start = max(t_ready_b, p_dr_end if have_prev else 0.0,
                               wl_port_free)
                wl_skipped = False
                ff_start = max(t_ready_ac, wl_start + wl)

            if reuse:
                wl_skips += 1
            else:
                regfile.latch_weights(b)               # type: ignore[arg-type]

            ff_end = ff_start + cfg.ff_cycles(ins.tm)
            fs_end = ff_end + fs
            dr_end = fs_end + dr

            # C register is rewritten by this MM; ready when fully drained.
            regfile.write(c, ("mm-out", idx))          # type: ignore[arg-type]
            reg_ready[c] = dr_end                      # type: ignore[index]
            # writing C does not disturb the latched weights; re-mark B latched
            regfile.latch_weights(b)                   # type: ignore[arg-type]

            useful += ins.tm * ins.tk * ins.tn
            t_end = max(t_end, dr_end)

            if self.keep_schedules:
                schedules.append(MMSchedule(idx, wl_start, wl_skipped,
                                            ff_start, ff_end, fs_end, dr_end))

            if not wl_skipped:
                wl_port_free = wl_start + wl
            p_ff_start, p_ff_end, p_fs_end, p_dr_end = ff_start, ff_end, fs_end, dr_end
            have_prev = True

        return TimingResult(
            cycles=t_end,
            n_mm=n_mm, n_tl=n_tl, n_ts=n_ts,
            wl_skips=wl_skips,
            useful_macs=useful,
            peak_macs_per_cycle=cfg.peak_macs_per_cycle,
            bw_stall_cycles=bw_stall,
            schedules=schedules,
        )


def serial_mm_latency(rows: int, cols: int, tm: int) -> int:
    """Closed form used by Fig. 2: WL + FF + FS + DR = 2*rows + tm + cols - 1."""
    return 2 * rows + tm + cols - 1


def steady_state_interval(cfg: EngineConfig, tm: int, weight_reused: bool) -> float:
    """Analytic issue-to-issue interval of back-to-back rasa_mm (for tests
    and napkin math; the simulator must agree on ideal streams)."""
    if cfg.wlbp and weight_reused:
        return tm
    if cfg.wls:
        # the shadow buffer hides WL behind compute, but the single weight
        # insertion network still serializes *fresh* weight sets: one WL
        # (`rows` cycles) per rasa_mm floors the interval.
        return max(tm, cfg.wl_cycles)
    if cfg.pipe:
        # WL overlaps the previous DR, but FF still waits for both this WL
        # and the previous drain: whichever is longer paces the pipeline
        # (DR > WL only with DM's +1 merge-row cycle).
        return max(cfg.wl_cycles, cfg.dr_cycles) + tm + cfg.fs_cycles
    return cfg.serial_latency(tm)
