"""Three-term roofline from the dry run's artifacts.

Counterpart of the JAX package's ``roofline/analysis.py``: the same terms,
names, artifact keys and depth extrapolation.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes accessed per device / HBM bandwidth
    collective term = collective bytes per device / link bandwidth

The per-device counts come from ``launch/dryrun.py``'s traced step.  The
reference reconstructs totals from reduced-depth compiles because XLA's
``cost_analysis`` counts a scan body once:

    total = embed_head + n_units x per_unit

where a "unit" is one layer (transformers/ssm) or one group of
``attn_every`` layers + the shared block (hybrid).  The port's eager trace
already counts every layer: its artifacts say so (``counts_every_layer``)
and ``analyze_all`` takes their own totals.  Its ``__d0`` / ``__d<unit>``
artifacts give a unit's cost: the extrapolation gives the total FLOPs
back exactly, and bytes and collective bytes up to the placements the
head receives at depth 0 (the embedding's output, not a layer's).

Hardware constants.  ``H100`` (the default) is the H100 SXM data sheet:
989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB, and NVLink 4's 900 GB/s
bidirectional taken as 450 GB/s a direction.  A mesh larger than one
8-GPU node crosses InfiniBand (~50 GB/s a GPU with ConnectX-7 NDR), so
there the collective term is a lower bound.  ``V5E`` is the reference's
TPU v5e (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s a link).  These
constants are data-sheet figures, not measurements.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..config import SHAPES


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12         # bf16 / chip
    hbm_bw: float = 819e9              # bytes/s / chip
    ici_bw: float = 50e9               # bytes/s / link
    hbm_bytes: float = 16 * 2**30      # v5e HBM capacity


V5E = HW()
H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    devices: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float                 # 6*N*D (dense) / 6*N_active*D (moe)
    peak_mem_bytes: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    extrapolated: bool = False
    #: the hardware of the last ``finalize`` (``mfu`` divides by its peak;
    #: the reference's divides by v5e's whatever the cell was finalized with)
    hw: HW = H100

    def finalize(self, hw: HW = H100) -> "CellRoofline":
        self.hw = hw
        self.compute_s = self.flops_per_device / hw.peak_flops
        self.memory_s = self.bytes_per_device / hw.hbm_bw
        self.collective_s = self.coll_bytes_per_device / hw.ici_bw
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total traced FLOPs (remat/padding/masked-attention
        waste shows up here)."""
        total = self.flops_per_device * self.devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time, against the
        peak of the cell's hardware."""
        denom = self.step_time_s * self.devices * self.hw.peak_flops
        return self.model_flops / denom if denom else 0.0


def model_flops_for(arch: str, shape: str) -> float:
    """6*N*D (N = active params, D = tokens processed).  For decode shapes
    D = batch (one token per sequence) but attention also reads the cache:
    +2*cache_token_kv_flops; we report the 6*N*D convention and note cache
    reads separately."""
    from ..configs import get_config
    cfg = get_config(arch)
    seq, batch, kind = SHAPES[shape]
    n_active = cfg.model.active_param_count()
    if kind == "train":
        tokens = seq * batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq * batch
        return 2.0 * n_active * tokens     # forward only
    return 2.0 * n_active * batch          # decode: one token/sequence


def load_cell(results_dir: Path, arch: str, shape: str,
              multi_pod: bool = False) -> dict | None:
    pod = "pod2" if multi_pod else "pod1"
    p = results_dir / f"{arch}__{shape}__{pod}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _coll_sum(cell: dict) -> float:
    colls = cell.get("collectives_per_device_bytes", {})
    return sum(v for k, v in colls.items() if not k.endswith("_count"))


def analyze_cell(cell: dict, hw: HW = H100,
                 d0: dict | None = None, du: dict | None = None) -> CellRoofline:
    """Roofline terms for one cell.  With the reduced-depth artifacts (d0 =
    embed+head only, du = one unit of layers), totals are

        total = d0 + n_units * (du - d0)

    (for the port's eager counts, the full-depth artifact's own numbers).
    Without them, the full-depth artifact's numbers are used."""
    flops = cell["cost_per_device"]["flops"]
    byts = cell["cost_per_device"]["bytes_accessed"]
    coll = _coll_sum(cell)
    extrapolated = False
    if d0 is not None and du is not None and not d0.get("skipped"):
        unit = cell.get("unit_layers", 1)
        n_units = cell.get("total_layers", unit) // unit
        def comb(a, b):
            return a + n_units * max(b - a, 0.0)
        flops = comb(d0["cost_per_device"]["flops"],
                     du["cost_per_device"]["flops"])
        byts = comb(d0["cost_per_device"]["bytes_accessed"],
                    du["cost_per_device"]["bytes_accessed"])
        coll = comb(_coll_sum(d0), _coll_sum(du))
        extrapolated = True
    r = CellRoofline(
        arch=cell["arch"], shape=cell["shape"], devices=cell["devices"],
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=coll,
        model_flops=model_flops_for(cell["arch"], cell["shape"]),
        peak_mem_bytes=cell["memory"]["peak_bytes_per_device"],
        extrapolated=extrapolated,
    )
    return r.finalize(hw)


def _load_depth(results_dir: Path, arch: str, shape: str, depth: int) -> dict | None:
    p = results_dir / f"{arch}__{shape}__pod1__d{depth}.json"
    return json.loads(p.read_text()) if p.exists() else None


def analyze_all(results_dir: str | Path, multi_pod: bool = False,
                hw: HW = H100) -> list[CellRoofline]:
    results_dir = Path(results_dir)
    from ..configs import all_cells
    out = []
    for arch, shape, ok, why in all_cells():
        cell = load_cell(results_dir, arch, shape, multi_pod)
        if cell is None or cell.get("skipped"):
            continue
        unit = cell.get("unit_layers", 1)
        d0 = du = None
        if not cell.get("counts_every_layer"):     # the port's eager counts are totals
            d0 = _load_depth(results_dir, arch, shape, 0)
            du = _load_depth(results_dir, arch, shape, unit)
        out.append(analyze_cell(cell, hw, d0=d0, du=du))
    return out


def format_report(cells: list[CellRoofline], hw: HW = H100) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'bound':>10s} {'mem_GiB':>8s} {'MFU%':>6s} "
           f"{'useful%':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        lines.append(
            f"{c.arch:24s} {c.shape:12s} {c.compute_s:10.4f} "
            f"{c.memory_s:10.4f} {c.collective_s:10.4f} {c.dominant:>10s} "
            f"{c.peak_mem_bytes/2**30:8.2f} {100*c.mfu:6.1f} "
            f"{100*c.useful_flops_ratio:8.1f}")
    return "\n".join(lines)
