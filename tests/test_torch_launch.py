"""The port's launchers and cell helpers.

``python -m repro_torch.launch.serve`` and ``.train`` run as the CLIs they
are (a subprocess each, ``--smoke --device cpu``, a world of one gloo
rank and a (1, 1) mesh): they print the reference's summary lines, the
train CLI resumes from its own checkpoint, and without ``--device cpu``
on a host with no card they raise instead of falling back.  The configs'
``cell_applicable``, ``all_cells`` and ``input_specs`` equal the
reference's (shapes and dtypes; the port's stand-ins are meta tensors).
"""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_cells as j_all_cells
from repro.configs import cell_applicable as j_cell_applicable
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro_torch.configs import (ARCH_NAMES, SHAPES, all_cells, cell_applicable, get_config,
                                 input_specs)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_cli(module: str, *args: str, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT), env=env)


def test_serve_cli_on_cpu():
    res = run_cli("repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
                  "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--steps", "4")
    assert res.returncode == 0, res.stderr
    line = next(l for l in res.stdout.splitlines() if l.startswith("[serve]"))
    assert re.search(r"2 seqs x 4 tokens in .* tok/s\); prefill .* ms, decode .* ms/step "
                     r"on mesh \(1, 1\); sample: \[", line), line


def test_train_cli_on_cpu_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--global-batch", "4",
              "--seq-len", "32", "--checkpoint-dir", ckpt, "--checkpoint-every", "2")
    res = run_cli("repro_torch.launch.train", *common, "--steps", "4")
    assert res.returncode == 0, res.stderr
    done = re.search(r"\[train\] done: 4 steps, loss ([\d.]+) -> ([\d.]+), stragglers "
                     r"flagged: \d+ on mesh \(1, 1\)", res.stdout)
    assert done, res.stdout
    assert sorted(p.name for p in pathlib.Path(ckpt).iterdir()) == ["step_00000002",
                                                                   "step_00000004"]
    again = run_cli("repro_torch.launch.train", *common, "--steps", "6")
    assert again.returncode == 0, again.stderr
    assert "[loop] restored checkpoint at step 4" in again.stdout, again.stdout
    assert re.search(r"\[train\] done: 2 steps", again.stdout), again.stdout
    assert (pathlib.Path(ckpt) / "step_00000006").is_dir()


@pytest.mark.parametrize("module", ["repro_torch.launch.serve", "repro_torch.launch.train"])
def test_cli_without_a_card_raises(module):
    """The launchers run on the card by default; with no card they raise
    and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is there")
    res = run_cli(module, "--arch", "qwen3-1.7b", "--smoke", "--steps", "1")
    assert res.returncode != 0
    assert "no CUDA device is present" in res.stderr, res.stderr[-2000:]
    assert "[serve]" not in res.stdout and "[train]" not in res.stdout


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_helpers_match_reference(arch):
    for shape in SHAPES:
        assert cell_applicable(arch, shape) == j_cell_applicable(arch, shape)
        for kw in ({}, {"seq_len": 512, "global_batch": 4}):
            want = j_input_specs(j_get_config(arch), shape, **kw)
            got = input_specs(get_config(arch), shape, **kw)
            assert got.keys() == want.keys()
            for name, spec in want.items():
                assert got[name].device.type == "meta"
                assert tuple(got[name].shape) == spec.shape, (shape, name)
                assert got[name].dtype == getattr(torch, jnp.dtype(spec.dtype).name)


@pytest.mark.parametrize("skipped", [False, True])
def test_all_cells_match_reference(skipped):
    assert list(all_cells(skipped)) == list(j_all_cells(skipped))
