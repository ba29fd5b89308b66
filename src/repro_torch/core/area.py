"""Area / power / energy-efficiency model (paper §V, Fig. 6).

We cannot re-run Synopsys DC + Cadence Innovus on Nangate-15nm here, so the
published physical-design measurements are model *constants*, and the derived
quantities (PPA, energy-efficiency ratios) are produced by the same
arithmetic the paper uses:

  * baseline 32x16 array = 0.7 % of an Intel Skylake GT2 4C die;
  * area overhead over baseline: DB +3.1 %, DM +2.6 %, DMDB +5.5 %;
  * "RASA-Control + RASA-Data ... total 0.847 mm^2" => baseline
    ~= 0.847 / 1.055 = 0.803 mm^2 (consistent with 0.7 % of ~115 mm^2);
  * energy efficiency ~= speedup / (power ratio), power ~ area at iso-activity,
    which reproduces the paper's 4.38x / 2.19x / 4.59x from its own runtime
    numbers (validated in tests/test_area.py).
"""

from __future__ import annotations

BASELINE_AREA_MM2 = 0.847 / 1.055          # ~0.803 mm^2 (32x16 PEs)
SKYLAKE_GT2_4C_DIE_MM2 = BASELINE_AREA_MM2 / 0.007

#: multiplicative area overhead of the RASA-Data options over baseline
AREA_OVERHEAD = {
    "baseline": 1.0,
    "DB": 1.031,
    "DM": 1.026,
    "DMDB": 1.055,
}

#: dirty bits for WLBP: 8 bits -- negligible, modelled as zero area.

def data_opt_of(design_name: str) -> str:
    if "DMDB" in design_name:
        return "DMDB"
    if "DM" in design_name:
        return "DM"
    if "DB" in design_name:
        return "DB"
    return "baseline"


def area_mm2(design_name: str) -> float:
    return BASELINE_AREA_MM2 * AREA_OVERHEAD[data_opt_of(design_name)]


def perf_per_area(design_name: str, speedup: float) -> float:
    """Performance-per-area normalized to the baseline (Fig. 6)."""
    return speedup / AREA_OVERHEAD[data_opt_of(design_name)]


def energy_efficiency(design_name: str, speedup: float) -> float:
    """ops/J vs baseline at iso-activity: speedup / power-ratio, power ~ area.

    With the paper's own speedups (DB-WLS 1/(1-0.781), DM-WLBP 1/(1-0.555),
    DMDB-WLS 1/(1-0.792)) this yields 4.43x / 2.19x / 4.56x vs the published
    4.38x / 2.19x / 4.59x -- within 1.2 %.
    """
    return speedup / AREA_OVERHEAD[data_opt_of(design_name)]


#: published validation targets (paper §V)
PAPER_RUNTIME_REDUCTION = {
    "RASA-PIPE": 0.157,
    "RASA-WLBP": 0.309,
    "RASA-DB-WLS": 0.781,
    "RASA-DM-WLBP": 0.555,
    "RASA-DMDB-WLS": 0.792,
}
PAPER_ENERGY_EFFICIENCY = {"DB": 4.38, "DM": 2.19, "DMDB": 4.59}
PAPER_BEST_NORMALIZED_RUNTIME = 16 / 95    # DMDB-WLS steady-state bound
