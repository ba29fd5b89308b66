"""The examples' twins (examples/torch_*.py) on the CPU.

Each twin runs as the script it is, in a subprocess, with ``--device cpu``
and small arguments, and exits 0.  The design-space twins print the
reference examples' output line for line (the simulator's numpy lane
equals the reference's numbers), and the quickstart's part 1 prints the
reference functions' own numbers: L = 95, the normalized runtimes and the
utilizations of ``repro.core``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import TABLE_I, get_design, normalized_runtime, simulate

ROOT = Path(__file__).resolve().parents[1]
TWINS = {
    "torch_quickstart": [],
    "torch_serve_lm": ["--batch", "2", "--prompt-len", "8", "--steps", "6"],
    "torch_train_lm": ["--arch", "qwen3-1.7b", "--steps", "4", "--batch", "2", "--seq", "32"],
    "torch_chip_design_space": [],
    "torch_rasa_design_space": [],
}
#: the reference examples whose whole output the twins reproduce
SAME_OUTPUT = {"torch_chip_design_space": "chip_design_space",
               "torch_rasa_design_space": "rasa_design_space"}


def _start(script: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{script}.py"), *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every twin on the CPU and the two reference examples, all at once:
    {script: (exit code, stdout, stderr)}."""
    ckpt = str(tmp_path_factory.mktemp("train_lm"))
    procs = {name: _start(name, *args, "--device", "cpu",
                          *(("--ckpt", ckpt) if name == "torch_train_lm" else ()))
             for name, args in TWINS.items()}
    procs.update({ref: _start(ref) for ref in SAME_OUTPUT.values()})
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("script", TWINS)
def test_twin_runs_on_the_cpu(outputs, script):
    rc, stdout, stderr = outputs[script]
    assert rc == 0, stderr[-4000:]
    assert stdout.strip()


@pytest.mark.parametrize("script", SAME_OUTPUT)
def test_design_space_twin_prints_the_reference_output(outputs, script):
    assert outputs[script][1] == outputs[SAME_OUTPUT[script]][1]


def test_quickstart_prints_the_reference_numbers(outputs):
    lines = outputs["torch_quickstart"][1].splitlines()
    base = get_design("BASE")
    want = [f"L_baseline = {base.serial_latency(16)} cycles (paper: 95)"]
    for design in ("RASA-PIPE", "RASA-WLBP", "RASA-DMDB-WLS"):
        r = normalized_runtime(TABLE_I["DLRM-2"], design)
        want.append(f"{design:16s} normalized runtime on DLRM-2: {r:.3f}")
    rep = simulate(TABLE_I["DLRM-2"], "RASA-DMDB-WLS")
    want.append(f"RASA-DMDB-WLS utilization: {rep.utilization:.1%} "
                f"(BASE: {simulate(TABLE_I['DLRM-2'], 'BASE').utilization:.1%})")
    assert lines[:len(want)] == want
    assert want[0] == "L_baseline = 95 cycles (paper: 95)"
    assert "kernel vs plain version rel_err: 0.00e+00" in lines
    assert lines[-1] == "quickstart OK"


def test_train_twin_trains(outputs):
    last = outputs["torch_train_lm"][1].splitlines()[-1]
    assert last.startswith("loss: ") and last.endswith("over 4 steps"), last
