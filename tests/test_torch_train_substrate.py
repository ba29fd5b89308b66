"""The port's training substrate against the reference's: AdamW and the
LR schedule on the same numbers, the data pipeline bit for bit, int8
gradient compression with error feedback, and the checkpoint store
(round trip, atomicity, corruption, async save and retention), after
tests/test_substrate.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_model_cfg, rel_err, to_np, to_torch
from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.data import SyntheticLMDataset as JDataset
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_int8 as j_compress_int8
from repro.optim import linear_warmup_cosine as j_schedule
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, restore_into,
                                    save_checkpoint)
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.optim import (adamw_init, adamw_update, compress_int8,
                               decompress_int8, linear_warmup_cosine)
from repro_torch.optim.adamw import tree_order

# ------------------------------------------------------------------- adamw

SHAPES = {"embedding": (16, 8), "final_norm": (8,), "layers.0.wq": (8, 8),
          "layers.1.wq": (8, 8), "layers.0.norm1": (8,), "layers.1.norm1": (8,)}


def _tree(named: dict) -> dict:
    """The reference's tree of the port's names: per-layer names stacked."""
    tree = {k: v for k, v in named.items() if not k.startswith("layers.")}
    for sub in ("wq", "norm1"):
        tree.setdefault("layers", {})[sub] = jnp.stack(
            [named[f"layers.{i}.{sub}"] for i in range(2)])
    return tree


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference(moments, clip):
    """Five AdamW steps on the same numpy params and grads (bf16 params,
    the grads' norm above the clip): params and moments within rel_err 1e-6
    in their storage dtype (bf16 storage: one ulp, 2 ** -8), grad_norm
    within 1e-6."""
    rng = np.random.default_rng(0)
    params = {n: rng.normal(size=s).astype(jnp.bfloat16) for n, s in SHAPES.items()}
    port = {n: to_torch(p) for n, p in params.items()}
    ref = _tree({n: jnp.asarray(p) for n, p in params.items()})
    opt, j_opt = adamw_init(port, moments), j_adamw_init(ref, moments)
    tol = 1e-6 if moments == "float32" else 2 ** -8
    for step in range(5):
        grads = {n: (rng.normal(size=s) * 3).astype(np.float32) for n, s in SHAPES.items()}
        lr = j_schedule(step, peak_lr=1e-2, warmup_steps=2, total_steps=5)
        ref, j_opt, metrics = j_adamw_update(
            ref, _tree({n: jnp.asarray(g) for n, g in grads.items()}), j_opt,
            lr=lr, grad_clip=clip)
        port_lr = linear_warmup_cosine(step, peak_lr=1e-2, warmup_steps=2, total_steps=5)
        _, opt, got = adamw_update(port, {n: torch.from_numpy(g) for n, g in grads.items()},
                                   opt, lr=port_lr, grad_clip=clip)
        assert rel_err(got["grad_norm"], metrics["grad_norm"]) < 1e-6
        assert int(opt.step) == int(j_opt.step) == step + 1
        assert float(metrics["grad_norm"]) > 1.0          # clipping is active when on
        for mine, theirs in ((port, ref), (opt.m, j_opt.m), (opt.v, j_opt.v)):
            for n, t in mine.items():
                want = (np.asarray(theirs["layers"][n.split(".")[2]][int(n.split(".")[1])])
                        if n.startswith("layers.") else np.asarray(theirs[n]))
                assert t.dtype == (torch.bfloat16 if mine is port else getattr(torch, moments))
                assert rel_err(to_np(t), want.astype(np.float32)) <= tol, (step, n)


def test_tree_order_is_the_references():
    names = ["layers.10.wq", "final_norm", "layers.2.wq", "layers.2.norm1", "embedding",
             "shared_attn.wq", "lm_head", "layers.2.A_log"]
    assert tree_order(names) == ["embedding", "final_norm", "layers.2.A_log",
                                 "layers.2.norm1", "layers.2.wq", "layers.10.wq",
                                 "lm_head", "shared_attn.wq"]


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(300):
        adamw_update(params, {"w": 2 * params["w"]}, opt, lr=0.1, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("kw", [dict(peak_lr=3e-4, warmup_steps=2, total_steps=8),
                                dict(peak_lr=1.0, warmup_steps=10, total_steps=100),
                                dict(peak_lr=1e-3, warmup_steps=0, total_steps=50,
                                     min_ratio=0.0)])
def test_schedule_matches_reference(kw):
    """Every step to past the end, from a number and from a 0-d int32
    tensor: equal to the reference's in fp32 up to the cosine's last ulp
    (rel_err 1e-6; XLA's fp32 cosine is not correctly rounded), and equal
    bit for bit in the warm-up and at the ends."""
    for step in range(kw["total_steps"] + 5):
        want = np.float32(j_schedule(step, **kw))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = linear_warmup_cosine(arg, **kw)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 1e-6 * abs(want)
            if step <= kw["warmup_steps"] or step >= kw["total_steps"]:
                assert np.float32(float(got)) == want


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_data_equals_reference(arch):
    """The port's pipeline gives the reference's batches bit for bit, at
    every family (audio's codebooks, vlm's patch embeddings), for two hosts
    of a global batch and across steps."""
    m = j_get_config(arch, smoke=True).model
    for host in (0, 1):
        kw = dict(seq_len=16, global_batch=4, seed=3, n_hosts=2, host_id=host)
        mine, theirs = SyntheticLMDataset(port_model_cfg(m), **kw), JDataset(m, **kw)
        for step in (0, 7):
            a, b = mine.batch(step), theirs.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, step)
    it = make_batch_iterator(mine, start_step=5)
    step, batch = next(it)
    assert step == 5 and np.array_equal(batch["tokens"], mine.batch(5)["tokens"])


# ------------------------------------------------------------- compression


def test_int8_matches_reference_and_error_is_bounded():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128,)).astype(np.float32)
    q, s = compress_int8(torch.from_numpy(x))
    jq, js = j_compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = (decompress_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_unbiased_over_time():
    """With error feedback the accumulated compressed sum tracks the true
    accumulated gradient: their difference is the last residual."""
    rng = np.random.default_rng(1)
    residual = torch.zeros(64)
    true_acc, comp_acc = torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) * 0.1
        true_acc += g
        gf = g + residual
        deq = decompress_int8(*compress_int8(gf))
        residual = gf - deq
        comp_acc += deq
    torch.testing.assert_close(true_acc - comp_acc, residual, atol=1e-5, rtol=0)
    assert float(residual.abs().max()) < 0.01


# -------------------------------------------------------------- checkpoints


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=gen),
                       "b": torch.randn(8, generator=gen).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(state):
    return {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
            "step": torch.zeros_like(state["step"])}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 7, state)
    restored, step = restore_checkpoint(tmp_path, _zeros_like(state))
    assert step == 7
    for k, v in state["params"].items():
        got = restored["params"][k]
        assert got.dtype == v.dtype and torch.equal(got, v)
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    # bf16 through its bytes: equal bit for bit
    assert torch.equal(restored["params"]["b"].view(torch.int16),
                       state["params"]["b"].view(torch.int16))


def test_checkpoint_atomicity(tmp_path, monkeypatch):
    """A crash mid-save must not clobber the previous checkpoint."""
    state = _state()
    save_checkpoint(tmp_path, 1, state)

    def boom(*a, **kw):
        raise IOError("disk full")
    with monkeypatch.context() as mp:
        mp.setattr(np, "savez", boom)
        with pytest.raises(IOError):
            save_checkpoint(tmp_path, 2, _state(1))
    assert latest_step(tmp_path) == 1
    restored, step = restore_checkpoint(tmp_path, _zeros_like(state))
    assert step == 1 and torch.equal(restored["params"]["w"], state["params"]["w"])
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]


def test_checkpoint_corruption_detected(tmp_path):
    state = _state()
    d = save_checkpoint(tmp_path, 3, state)
    f = d / "arrays.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        restore_checkpoint(tmp_path, _zeros_like(state))


def test_checkpoint_shape_mismatch_and_missing_leaf(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 1, state)
    bad = _zeros_like(state)
    bad["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, bad)
    extra = _zeros_like(state)
    extra["params"]["u"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(tmp_path, extra)


def test_restore_into_writes_the_state_in_place(tmp_path):
    """restore_into writes each leaf into the template's own tensor (the
    same storage; parameters that require a gradient included), bit for
    bit, and returns the step."""
    state = _state()
    save_checkpoint(tmp_path, 7, state)
    into = _zeros_like(state)
    into["params"]["w"].requires_grad_(True)
    ptrs = {k: v.data_ptr() for k, v in into["params"].items()}
    assert restore_into(tmp_path, into) == 7
    for k, v in state["params"].items():
        got = into["params"][k]
        assert got.data_ptr() == ptrs[k] and got.dtype == v.dtype
        assert torch.equal(got.view(torch.uint8), v.view(torch.uint8))
    assert int(into["step"]) == 7 and into["params"]["w"].requires_grad


def test_restore_into_refuses_before_writing(tmp_path):
    """A missing leaf or a shape that differs raises before restore_into
    writes any leaf; a corrupt leaf raises too."""
    state = _state()
    d = save_checkpoint(tmp_path, 1, state)
    extra = _zeros_like(state)
    extra["params"]["u"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        restore_into(tmp_path, extra)
    bad = _zeros_like(state)
    bad["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        restore_into(tmp_path, bad)
    for tree in (extra, bad):
        assert all(not t.any() for t in (*tree["params"].values(), tree["step"]))
    f = d / "arrays.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        restore_into(tmp_path, _zeros_like(state))


def test_checkpoint_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    states = {s: _state(s) for s in (1, 2, 3, 4)}
    saved = states[4]["params"]["w"].clone()
    for s, st in states.items():
        mgr.save_async(s, st)
        st["params"]["w"].add_(1.0)        # the host copy was taken at save time
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [3, 4]
    restored, step = mgr.restore_latest(_zeros_like(states[4]))
    assert step == 4
    assert torch.equal(restored["params"]["w"], saved)


# ------------------------------------------------------------ cross entropy


def test_cross_entropy_matches_reference():
    """cross_entropy and chunked_cross_entropy (labels -100 ignored; audio's
    codebook split through logits_fn; chunks of 8 over 32 positions)
    against the reference's, f32: rel_err < 1e-5, the same valid count;
    and the chunked form's gradients with respect to x and the head
    against jax.grad of the reference's."""
    from repro.models.common import chunked_cross_entropy as j_chunked
    from repro.models.common import cross_entropy as j_ce
    from repro_torch.models.common import chunked_cross_entropy, cross_entropy
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 32, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 32)).astype(np.int32)
    labels[0, :5] = -100
    got, n = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want, jn = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert rel_err(got, want) < 1e-5 and int(n) == int(jn) == 59
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    for cb, lab in ((1, labels), (2, rng.integers(0, 20, (2, 32, 2)).astype(np.int32))):
        head = rng.normal(size=(16, 40)).astype(np.float32) * 0.5
        fn = (lambda lg: lg.reshape(*lg.shape[:-1], 2, 20)) if cb == 2 else None

        def ref(x_, h_):
            return j_chunked(x_, h_, jnp.asarray(lab), chunk=8, logits_fn=fn)[0]
        want, (wx, wh) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
        tx = torch.from_numpy(x).requires_grad_(True)
        th = torch.from_numpy(head).requires_grad_(True)
        got, n = chunked_cross_entropy(tx, th, torch.from_numpy(lab), chunk=8, logits_fn=fn)
        gx, gh = torch.autograd.grad(got, (tx, th))
        assert rel_err(got.detach(), want) < 1e-5 and int(n) == lab.size - (cb == 1) * 5
        assert rel_err(gx, wx) < 1e-5 and rel_err(gh, wh) < 1e-5
    with pytest.raises(ValueError, match="multiple of the CE chunk"):
        chunked_cross_entropy(tx[:, :30], th, torch.from_numpy(lab[:, :30]), chunk=8)
