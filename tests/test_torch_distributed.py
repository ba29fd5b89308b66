"""The port's distributed pieces on gloo worlds of CPU processes.

Counterpart of tests/test_distributed.py's multi-device snippet (a (4, 2)
mesh of 8 ranks, its numpy inputs) and tests/test_pipeline.py's: every
case spawns its ranks on a free local port with a timeout of its own
(``_torch_dist.run_ranks``) and holds them against the port's unsharded
code and against the reference:

- sp_flash_decode against the port's and the reference's
  ``ref_decode_attention`` (rtol = atol = 2e-4);
- compressed_psum within 0.05 of 4 g, and within 1e-6 of the reference's
  collective run as its own test runs it (a subprocess with 8 host
  devices);
- the sharded train step of smoke qwen3-1.7b: in f32 its losses and
  updated parameters within 1e-5 relative of the unsharded step; in the
  config's dtype (bf16) its loss within the reference's 5e-2 of the
  reference's jitted step on the same weights;
- ServeSession under a (1, 2) TP mesh in f32: greedy tokens equal to the
  unsharded session's and the reference's, the RASA GEMM on local shards,
  and a step outside the mesh refused (a session keeps its first step's
  context; in one process, an unmeshed session refuses a meshed step);
- a checkpoint written on (2, 2) restored bit for bit onto (1, 2) and onto
  no mesh, and one written without a mesh onto (2, 2);
- pipeline_apply on 4 ranks against sequential execution: forward within
  2e-5, gradients within 5e-4.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_parity import reference
from repro.configs import get_config as j_get_config
from repro.data import SyntheticLMDataset
from repro.kernels.ref import ref_decode_attention as j_ref_decode_attention
from repro.models import build_model as j_build_model
from repro.training import init_train_state as j_init_train_state
from repro.training.step import build_train_step as j_build_train_step
from repro_torch.kernels.ref import ref_decode_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 300


def snippet_inputs():
    """tests/test_distributed.py's inputs, drawn in its order."""
    rng = np.random.default_rng(0)
    b, h, s, d = 2, 4, 64, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v = rng.normal(size=(b, h, s, d)).astype(np.float32)
    lengths = np.asarray([37, 64], np.int32)
    g = rng.normal(size=(64,)).astype(np.float32)
    return q, k, v, lengths, g


def test_sp_flash_decode_matches_both_references():
    q, k, v, lengths, _ = snippet_inputs()
    outs = run_ranks("sp_decode", 8, q, k, v, lengths, timeout=TIMEOUT)
    port = ref_decode_attention(*map(torch.from_numpy, (q, k, v, lengths))).numpy()
    ref = np.asarray(j_ref_decode_attention(*map(jnp.asarray, (q, k, v, lengths))))
    for got in outs:
        np.testing.assert_allclose(got, port, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


JAX_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import numpy as np
    import jax.numpy as jnp
    from repro.launch.mesh import _auto_mesh
    from repro.optim import compressed_psum
    mesh = _auto_mesh((4, 2), ("data", "model"))
    g = np.load(sys.argv[1])
    summed, _ = compressed_psum({"w": jnp.asarray(g)}, {"w": jnp.zeros(g.shape)}, mesh,
                                axis_names=("data",))
    np.save(sys.argv[2], np.asarray(summed["w"]))
""")


def test_compressed_psum_matches_reference_collective(tmp_path):
    g = snippet_inputs()[-1]
    outs = run_ranks("psum", 8, g, timeout=TIMEOUT)
    np.save(tmp_path / "g.npy", g)
    res = subprocess.run([sys.executable, "-c", JAX_PSUM, str(tmp_path / "g.npy"),
                          str(tmp_path / "want.npy")], capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    want = np.load(tmp_path / "want.npy")
    for summed, residual in outs:
        np.testing.assert_allclose(summed, 4 * g, atol=0.05)
        np.testing.assert_allclose(summed, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(residual, outs[0][1])


TRAIN = dict(global_batch=4, seq_len=32, lr=1e-2, warmup_steps=1, total_steps=4,
             microbatches=2)


def test_sharded_train_step_f32_matches_unsharded():
    """Two steps (the first at lr 0, the second updating) on (4, 2) with
    FSDP x TP, two microbatches: losses and parameters within 1e-5."""
    m = j_get_config("qwen3-1.7b", smoke=True).model
    data = SyntheticLMDataset(m, seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
                              seed=0)
    batches = [data.batch(s) for s in range(2)]
    outs = run_ranks("train_step", 8, "qwen3-1.7b", "float32", (4, 2), None, batches,
                     TRAIN, timeout=TIMEOUT)
    for losses, rel, placements in outs:
        for got, want in losses:
            assert abs(got - want) <= 1e-5 * abs(want), losses
        assert rel <= 1e-5, rel
    # FSDP over data and TP over model, as the rules say
    assert outs[0][2]["layers.0.wq"] == "(Shard(dim=0), Shard(dim=1))"
    assert outs[0][2]["layers.0.wo"] == "(Shard(dim=1), Shard(dim=0))"


def test_sharded_train_step_matches_reference_in_config_dtype():
    """The reference's test: a sharded step's loss within 5e-2 of the
    reference's jitted step, here on the reference's weights carried over."""
    cfg = j_get_config("qwen3-1.7b", smoke=True)
    api = j_build_model(cfg)
    state = j_init_train_state(api, jax.random.key(0))
    batch = SyntheticLMDataset(cfg.model, seq_len=32, global_batch=4, seed=0).batch(0)
    _, metrics = jax.jit(j_build_train_step(api))(state, batch)
    tree = jax.tree.map(np.asarray, state.params)
    outs = run_ranks("train_step", 8, "qwen3-1.7b", cfg.model.dtype, (4, 2), tree, [batch],
                     dict(global_batch=4, seq_len=32), timeout=TIMEOUT)
    want = float(metrics["loss"])
    for losses, _, _ in outs:
        assert abs(losses[0][0] - want) < 5e-2, (losses, want)


@pytest.fixture(scope="module")
def served_reference():
    return reference("qwen3-1.7b", "float32")


@pytest.mark.parametrize("engine", ["xla", "pallas_rasa"])
def test_tp_serving_tokens_match(served_reference, engine):
    from _torch_parity import MAX_SEQ, STEPS
    ref = served_reference
    outs = run_ranks("serve_tp", 2, "qwen3-1.7b", ref["tree"], ref["tokens_in"], STEPS,
                     MAX_SEQ, engine, timeout=TIMEOUT)
    for plain, meshed, seen, placements, refused in outs:
        np.testing.assert_array_equal(meshed, plain)
        assert refused and "another mesh context" in refused
        np.testing.assert_array_equal(meshed, ref["generate"][engine])
        assert placements["layers.0.wq"] == "(Replicate(), Shard(dim=1))"
        if engine == "pallas_rasa":
            # column-parallel GEMMs ran on half of wq's columns: the operator
            # took the local shards, not the gathered weights
            wq_cols = ref["tree"]["layers"]["wq"].shape[-1]
            assert any(b[1] == wq_cols // 2 for _, b in seen), seen[:8]
        else:
            assert not seen


def test_session_refuses_a_step_under_another_context(monkeypatch):
    import types
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession, engine
    session = ServeSession(build_model(get_config("qwen3-1.7b", smoke=True), device="cpu",
                                       seed=0), 16, device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    first = session.generate(prompts, 2)
    ctx = types.SimpleNamespace(mesh="another mesh", parallel=None)
    with monkeypatch.context() as m:
        m.setattr(engine, "current_ctx", lambda: ctx)
        with pytest.raises(RuntimeError, match="another mesh context"):
            session.generate(prompts, 2)
    assert torch.equal(session.generate(prompts, 2), first)


def test_checkpoint_restores_onto_other_meshes(tmp_path):
    outs = run_ranks("checkpoint_reshard", 4, str(tmp_path), timeout=TIMEOUT)
    written = outs[0]["written"]
    for r, out in enumerate(outs):
        assert out["written"].keys() == written.keys()
        keys = ["plain_onto_2x2"] + (["onto_1x2", "into_1x2"] if r < 2 else []) + (
            ["onto_none"] if r == 0 else [])
        for key in keys:
            for name, leaf in written.items():
                got = out[key][name]
                assert got.dtype == leaf.dtype and np.array_equal(got, leaf), (r, key, name)
    assert outs[0]["onto_1x2_placements"]["layers.0.wq"] == "(Replicate(), Shard(dim=1))"


def test_pipeline_matches_sequential():
    L, D, B = 8, 16, 8
    rng = np.random.default_rng(0)
    params = {"w": (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32),
              "b": (rng.normal(size=(L, D)) * 0.1).astype(np.float32)}
    x = rng.normal(size=(B, D)).astype(np.float32)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt
    for i in range(L):
        h = torch.tanh(h @ p["w"][i] + p["b"][i])
    h.sum().backward()
    want = {"w": p["w"].grad.numpy(), "b": p["b"].grad.numpy(), "x": xt.grad.numpy()}
    outs = run_ranks("pipeline", 4, params, x, timeout=TIMEOUT)
    for y, grads in outs:
        np.testing.assert_allclose(y, h.detach().numpy(), rtol=2e-5, atol=2e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want[k], rtol=5e-4, atol=5e-4)
