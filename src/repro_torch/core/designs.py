"""The eight evaluated designs (paper §V): baseline + seven RASA variants.

Naming follows the paper: RASA-Control optimizations {PIPE, WLBP, WLS} and
RASA-Data optimizations {DB, DM, DMDB}.  WLS requires a double weight buffer
(DB); DM halves the rows of the array and puts two multipliers in each PE
("for fair comparisons, we use the same number of multipliers in all systolic
arrays": 32x16x1 == 16x16x2).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Physical + scheduling configuration of the matrix engine."""

    name: str
    rows: int = 32               # physical PE rows (the T_K direction)
    cols: int = 16               # physical PE cols (the T_N direction)
    macs_per_pe: int = 1         # 2 with DM
    pipe: bool = False           # PIPE: overlap next WL with previous DR
    wlbp: bool = False           # skip WL on clean weight-register reuse
    wls: bool = False            # prefetch WL into shadow buffer (needs DB)
    double_buffer: bool = False  # DB: shadow weight buffer + links
    #: engine clock (paper: 500 MHz) and host core clock (2 GHz, 4-wide)
    engine_clock_hz: float = 500e6
    core_clock_hz: float = 2e9
    core_issue_width: int = 4
    #: tile-load latency in *engine* cycles (cold); paper assumes the memory
    #: system never throttles throughput, so this only delays true deps.
    load_latency: int = 5
    #: number of in-flight tile loads the LSQ sustains per engine cycle
    load_ports: int = 2
    #: tile stores retired per engine cycle once store traffic is modelled
    #: (the chip-level arbiter serializes ``rasa_ts`` on this; the paper's
    #: single-core model leaves stores free -- see LoadStreamModel).
    store_ports: int = 1

    def __post_init__(self):
        if self.wls and not self.double_buffer:
            raise ValueError("WLS requires a double (shadow) weight buffer [paper §IV-B]")

    # -- derived stage latencies (engine cycles) ---------------------------
    @property
    def wl_cycles(self) -> int:
        """Weight Load: stream `rows` weight rows top->bottom.  With DM the
        array has half the rows (each PE buffers two weights fed over the
        doubled links), so WL shortens accordingly."""
        return self.rows

    @property
    def fs_cycles(self) -> int:
        return self.rows - 1

    @property
    def dr_cycles(self) -> int:
        # DM adds a merge row of adders at the bottom: +1 drain cycle.
        return self.cols + (1 if self.macs_per_pe == 2 else 0)

    def ff_cycles(self, tm: int) -> int:
        return tm

    def serial_latency(self, tm: int) -> int:
        """BASE occupancy of one rasa_mm: WL + FF + FS + DR.

        For the paper's 32x16 / T_M=16 configuration this is 95 cycles
        ("L_baseline = 95"), i.e. Eq. (1) in its non-overlapped '-1' form --
        see DESIGN.md §1.
        """
        return self.wl_cycles + self.ff_cycles(tm) + self.fs_cycles + self.dr_cycles

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.rows * self.cols * self.macs_per_pe


def _mk(name: str, *, dm: bool = False, db: bool = False, pipe: bool = False,
        wlbp: bool = False, wls: bool = False) -> EngineConfig:
    return EngineConfig(
        name=name,
        rows=16 if dm else 32,
        cols=16,
        macs_per_pe=2 if dm else 1,
        pipe=pipe or wlbp or wls,   # WLBP/WLS subsume basic pipelining
        wlbp=wlbp,
        wls=wls,
        double_buffer=db,
    )


#: Baseline + the seven RASA designs evaluated in Fig. 5.
DESIGNS: dict[str, EngineConfig] = {
    "BASE":           _mk("BASE"),
    "RASA-PIPE":      _mk("RASA-PIPE", pipe=True),
    "RASA-WLBP":      _mk("RASA-WLBP", wlbp=True),
    "RASA-DB-WLS":    _mk("RASA-DB-WLS", db=True, wls=True, wlbp=True),
    "RASA-DM-PIPE":   _mk("RASA-DM-PIPE", dm=True, pipe=True),
    "RASA-DM-WLBP":   _mk("RASA-DM-WLBP", dm=True, wlbp=True),
    "RASA-DMDB-WLS":  _mk("RASA-DMDB-WLS", dm=True, db=True, wls=True, wlbp=True),
    # DB alone enables WLS-less double buffering; included for the PPA study.
    "RASA-DB-WLBP":   _mk("RASA-DB-WLBP", db=True, wlbp=True),
}


def get_design(name: str) -> EngineConfig:
    try:
        return DESIGNS[name]
    except KeyError:
        raise KeyError(f"unknown design {name!r}; available: {sorted(DESIGNS)}") from None
