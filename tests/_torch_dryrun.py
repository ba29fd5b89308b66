"""Cases of the dry-run tests that start a fake process group: each runs
in a subprocess of its own (``run_case``), so that no process group
outlives it in the test worker, and prints its result as one JSON line.
torch only: the test files hold the results against the reference."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_cases(*calls, timeout: float = 600.0) -> list:
    """Each (case, *args) of ``calls`` in a fresh interpreter, all at once;
    their JSON results in order."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, __file__, case, json.dumps(args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT) for case, *args in calls]
    results = []
    try:
        for (case, *_), proc in zip(calls, procs):
            out, err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"{case} failed ({proc.returncode}):\n{err[-6000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def run_case(case: str, *args, timeout: float = 600.0):
    """``case(*args)`` in a fresh interpreter; its JSON result."""
    return run_cases((case, *args), timeout=timeout)[0]


def _mesh(shape):
    from repro_torch.launch.mesh import _mesh
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return _mesh("cpu", tuple(shape), names)


# ------------------------------------------------------------------- cases

def argument_bytes(cells, multi_pod):
    """Rank 0's argument bytes of each (arch, shape) FULL cell on the
    production mesh, the step built (not traced) on a fake world."""
    from repro_torch.config import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for arch, shape in cells:
            seq, batch, kind = SHAPES[shape]
            cfg = dryrun.cell_config(arch, shape, multi_pod)
            out[f"{arch}|{shape}"] = dryrun.step_arguments(cfg, kind, seq, batch, mesh, "cpu")
    return out


def _no_checkpoint():
    """torch.utils.checkpoint off in the models (each checkpointed
    function called directly)."""
    from repro_torch.models import common, transformer

    def direct(fn, *args, use_reentrant=None, context_fn=None, **kwargs):
        return fn(*args, **kwargs)

    common.checkpoint = transformer.checkpoint = direct


def flops(cells, no_checkpoint):
    """The dry run's FLOPs of each (arch, kind, remat, batch, seq) smoke
    cell on a fake world of one ((1, 1) mesh); with ``no_checkpoint`` the
    models' checkpoints are off."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    if no_checkpoint:
        _no_checkpoint()
    out = {}
    with dryrun.fake_world(1):
        mesh = _mesh((1, 1))
        for arch, kind, remat, batch, seq in cells:
            cfg = get_config(arch, smoke=True)
            cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                        remat=remat))
            r = dryrun.trace(cfg, kind, seq, batch, mesh, "cpu")
            out[f"{arch}|{kind}|{remat}|{seq}"] = r["cost_per_device"]["flops"]
    return out


def collectives():
    """The counter over DTensor redistributions on a fake (2, 2) world:
    {case: (collectives, the result's local bytes)}."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import dryrun
    out = {}
    cases = {"shard_to_replicate": ((Shard(0), Replicate()), (Replicate(), Replicate())),
             "partial_to_replicate": ((Partial(), Replicate()), (Replicate(), Replicate())),
             "partial_to_shard": ((Partial(), Replicate()), (Shard(1), Replicate()))}
    with dryrun.fake_world(4):
        mesh = _mesh((2, 2))
        for name, (src, dst) in cases.items():
            counter = dryrun.StepCounter()
            with FakeTensorMode(), dryrun.dtensor_on_fake(counter):
                local = torch.zeros((64, 96), dtype=torch.float32)
                t = DTensor.from_local(local, mesh, src, run_check=False)
                with counter:
                    got = t.redistribute(mesh, dst).to_local()
                out[name] = (counter.collectives, got.numel() * got.element_size())
    return out


def layer_costs(archs, kinds, batch, seq):
    """FLOPs of the smoke config of each arch at depth 0, one unit and full
    depth, for each kind, on a fake (2, 2) world."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    out = {}
    with dryrun.fake_world(4):
        mesh = _mesh((2, 2))
        for arch in archs:
            base = get_config(arch, smoke=True)
            m = base.model
            unit = m.hybrid.attn_every if m.family == "hybrid" else 1
            for kind in kinds:
                flops = []
                for depth in (0, unit, m.n_layers):
                    cfg = dataclasses.replace(base, model=dataclasses.replace(m, n_layers=depth))
                    flops.append(dryrun.trace(cfg, kind, seq, batch, mesh,
                                              "cpu")["cost_per_device"]["flops"])
                out[f"{arch}|{kind}"] = {"unit": unit, "layers": m.n_layers, "flops": flops}
    return out


if __name__ == "__main__":
    result = globals()[sys.argv[1]](*json.loads(sys.argv[2]))
    print(json.dumps(result))
