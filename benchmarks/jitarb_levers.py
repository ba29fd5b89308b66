"""The shares of jitarb_kernel's two shared-memory levers, on one H100.

Builds csrc/jitarb.cu four ways -- its instruction stream through the TMA
ring or read straight from device memory, this round's shares in shared
memory where they fit or always in device memory -- under build/levers/,
checks that the four agree bit for bit, and times each on the inputs of
chip_smoke.py's phase 12 (the 8 cases of 200 requests, the rate sweep's
launch, the 4-request full-width settle) with CUDA events, twice, in the
order A B C D D C B A.  The PyTorch port only; needs the card and nvcc:

    python3 benchmarks/jitarb_levers.py
"""
import ctypes
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

R = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(R / "src"))
sys.path.insert(0, str(R))
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import jitarb as kj
from repro_torch.multicore import chip as chip_mod
from repro_torch.multicore import jitarb

B = R / "build" / "levers"
src = (_build.CSRC / "jitarb.cu").read_text()
RUN_OLD = """        const int err = rg.run(p.code + row, p.val + row, p.L, lo, hi,
                               [&](long long i, int c, const double* vp) {
                                 const int e = step<true>(s, c, vp, clk.at(dz, i), dz, bk);
                                 if (!e && (i + 1) % kBlock == 0)
                                   pack(s, lsnap + (size_t)((i + 1) / kBlock) * kSnap);
                                 return e;
                               });"""
RUN_NEW = """#ifdef JITARB_DIRECT
        int err = 0;
        {
          const int32_t* cd = p.code + row;
          const double* vl = p.val + row;
          for (long long i = lo; i < hi; ++i) {
            err = step<true>(s, cd[i], vl + i, clk.at(dz, i), dz, bk);
            if (err) break;
            if ((i + 1) % kBlock == 0) pack(s, lsnap + (size_t)((i + 1) / kBlock) * kSnap);
          }
        }
#else
""" + RUN_OLD + "\n#endif"
assert RUN_OLD in src
src = src.replace(RUN_OLD, RUN_NEW)
ST_OLD = "  p.sh_staged = (long long)C * S <= slots;"
assert ST_OLD in src
src = src.replace(ST_OLD, """#ifdef JITARB_GLOBAL
  p.sh_staged = 0;
#else
  p.sh_staged = (long long)C * S <= slots;
#endif""")
VARIANTS = {"ring_staged": [], "ring_global": ["JITARB_GLOBAL"],
            "direct_staged": ["JITARB_DIRECT"], "direct_global": ["JITARB_DIRECT", "JITARB_GLOBAL"]}


def build(name):
    d = B / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    (d / "jitarb.cu").write_text("".join(f"#define {m} 1\n" for m in VARIANTS[name]) + src)
    out = d / f"libjitarb_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build._flags("jitarb"), "-o", str(out),
                           str(d / "jitarb.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    rep = [l for l in proc.stderr.splitlines() if "registers" in l or "spill" in l]
    return out, rep


t0 = time.time()
with ThreadPoolExecutor(4) as ex:
    built = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
print(f"built in {time.time() - t0:.1f} s", flush=True)
for k, (_, rep) in built.items():
    print(k, rep)
libs = {k: ctypes.CDLL(str(p)) for k, (p, _) in built.items()}

cases, trace, variants = cs.batch_cases()
inputs = {}
for p, v in cases:
    plan, why = jitarb.plan_ex(cs.batch_traffic(trace), cs.batch_chip(chip_mod, v, "cuda"), policy=p)
    inputs[f"{p}/{v}"] = jitarb._inputs([plan])
cuda_chip = chip_mod.ChipConfig(backend="cuda", **cs.BATCH_CHIP)
inputs["sweep"] = jitarb._inputs(jitarb.plan_many([cs.batch_traffic(x) for x in variants], cuda_chip))
full4 = cs.full_requests(cs.FULL_N_NUMPY)
plan, why = jitarb.plan_ex(cs.batch_traffic(full4), cuda_chip, policy="occupancy")
inputs["full4"] = jitarb._inputs([plan])
print(f"inputs in {time.time() - t0:.1f} s", flush=True)


def use(name):
    _build._loaded["jitarb"] = libs[name]


ref = {}
for name in VARIANTS:
    use(name)
    for key, (args, kw) in inputs.items():
        out = [t.cpu() for t in kj.jitarb_cuda(*args, **kw)]
        torch.cuda.synchronize()
        if name == "ring_staged":
            ref[key] = out
        elif not all(torch.equal(a, b) for a, b in zip(out, ref[key])):
            raise SystemExit(f"{name} {key} differs")
print("all variants bit-equal; paths", dict(kj.launch_paths), flush=True)

order = list(VARIANTS) + list(VARIANTS)[::-1]
times = {n: {} for n in VARIANTS}
for name in order:
    use(name)
    for key, (args, kw) in inputs.items():
        ms = cs.event_ms(torch, lambda: kj.jitarb_cuda(*args, **kw), 1 if key == "full4" else 3)
        times[name].setdefault(key, []).append(ms)
for name in VARIANTS:
    t = times[name]
    cases8 = [sum(t[k]) / len(t[k]) for k in t if "/" in k]
    print(name, "8 cases sum ms (mean of 2 passes):", round(sum(cases8), 4),
          "| sweep", [round(x, 4) for x in t["sweep"]],
          "| full4", [round(x, 2) for x in t["full4"]])
print(json.dumps(times))
print(cs.card_line())
