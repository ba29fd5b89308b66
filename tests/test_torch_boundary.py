"""The port stands alone: nothing in src/repro_torch/ or chip_smoke.py
imports jax or the JAX package, the port imports with jax absent, and its
entry points refuse the card when there is none instead of falling back."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models import build_model
from repro_torch.serving import ServeSession

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = {name for name in imported_modules(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.serving, repro_torch.kernels, "
            "repro_torch.models, repro_torch.models.ssm_lm, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_chunk, "
            "repro_torch.optim, repro_torch.training, repro_torch.checkpoint, "
            "repro_torch.data, repro_torch.core, repro_torch.multicore, "
            "repro_torch.kernels.fastsim_scan, repro_torch.kernels.jitarb, "
            "repro_torch.obs, repro_torch.workload, repro_torch.multicore.jitarb, "
            "repro_torch.multicore.online, repro_torch.multicore.scheduler, "
            "repro_torch.multicore.faults, repro_torch.serving.simbatch\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_missing_card():
    """With no CUDA device, device='cuda' (the default) raises; there is no
    silent CPU fallback.  Both families."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for arch in ("qwen3-1.7b", "mamba2-130m", "zamba2-2.7b"):
        cfg = get_config(arch, smoke=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
        model = build_model(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeSession(model, max_seq=16)
        tokens = ServeSession(model, max_seq=16, device="cpu").generate(
            torch.zeros((1, 4), dtype=torch.int32), 3)
        assert tokens.shape == (1, 3) and tokens.dtype == torch.int32


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise: a CPU tensor never reaches a
    plain version through them (only the dispatching entry points take it)."""
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)
    x, dt, a = torch.zeros((2, 8, 4)), torch.zeros((2, 8)), torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA device"):
        sc.ssd_chunk_cuda(x, dt, a, x, x, chunk=8)
    assert fa.launches["flash"] == 0 and sc.launches["ssd"] == 0


def test_every_config_builds():
    """build_model builds every smoke config of the ten, each family's
    model class; check_family refuses a family that does not exist."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.models import SSMLanguageModel, Transformer, transformer
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, device="cpu")
        ssm = cfg.model.family in ("ssm", "hybrid")
        assert isinstance(model, SSMLanguageModel if ssm else Transformer)
    cfg = get_config("qwen3-1.7b", smoke=True).model
    with pytest.raises(ValueError, match="not one of"):
        transformer.check_family(dataclasses.replace(cfg, family="diffusion"))
