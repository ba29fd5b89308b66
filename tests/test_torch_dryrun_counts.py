"""The port's dry-run counts against the reference's (FLOPs, remat, layer
costs), and serving on a sequence-split KV cache.

Each case that starts a process group runs in a subprocess of its own
(``_torch_dryrun.run_cases``, ``_torch_dist.run_ranks``).

- FLOPs: for each family's smoke config and each step kind, the dry run's
  count on a world of one equals the sum of 2 x prod over the contracting
  ``dot_general``s in the jaxpr of the reference's step (layers unrolled),
  recursing into sub-jaxprs (a scan's body times its length).  XLA's
  ``flops`` also counts elementwise work, and a ``dot_general`` without a
  contracting dimension is an elementwise product, so only contractions
  are compared.  The train steps are compared with every checkpoint off on
  both sides: JAX's remat recomputes only the residuals the backward reads
  (a product whose output no backward needs is not recomputed), torch's
  checkpoint reruns its region up to its last saved tensor, so the
  recomputed products differ by design; and the SSM's train steps less
  the products that only the reference's chunk scan computes
  (``scan_only_flops``).  The port's own recompute is checked on its own:
  remat "full" adds exactly the layers' forward;
- layer costs: full-depth FLOPs = d0 + n_units x (d_unit - d0) for the
  qwen3 and zamba2 smoke configs (zamba2's unit is ``attn_every`` layers
  and the shared block);
- a sequence-split KV cache (``sequence_parallel_decode``, the long_500k
  cells) prefills and decodes on a gloo world of two CPU ranks as the
  unsharded model does, and the MoE serves on a (1, 2) mesh.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.extend import core as jcore

import pytest

from _torch_dist import run_ranks
from _torch_dryrun import run_cases
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.models import build_model as j_build_model
from repro.training.step import build_train_step as j_build_train_step
from repro.training.step import init_train_state as j_init_train_state
from repro_torch.configs import get_config


# ------------------------------------------------------------------- FLOPs

def jaxpr_flops(jaxpr) -> int:
    """2 x prod over the contracting dot_generals of a jaxpr and its
    sub-jaxprs (a scan's body times its length)."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            if lc:
                lhs = eqn.invars[0].aval.shape
                total += (2 * math.prod(eqn.outvars[0].aval.shape)
                          * math.prod(lhs[i] for i in lc))
        times = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (tuple, list)) else (value,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += times * jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += times * jaxpr_flops(sub)
    return total


def reference_flops(arch: str, kind: str, batch: int, seq: int, monkeypatch) -> int:
    """Product FLOPs of the reference's step, layers unrolled, every
    ``jax.checkpoint`` off."""
    monkeypatch.setattr(jax, "checkpoint", lambda fn=None, **kw: fn if fn else (lambda f: f))
    cfg = j_get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                scan_layers=False))
    api = j_build_model(cfg)
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    if kind == "train":
        state = jax.eval_shape(lambda: j_init_train_state(api, jax.random.key(0)))
        specs = j_input_specs(cfg, "train_4k", seq_len=seq, global_batch=batch)
        return jaxpr_flops(jax.make_jaxpr(j_build_train_step(api))(state, specs).jaxpr)
    params = jax.eval_shape(api.init, jax.random.key(0))
    state = jax.eval_shape(lambda: api.init_decode_state(batch, seq))
    cb = (cfg.model.n_codebooks,) if cfg.model.family == "audio" else ()
    if kind == "prefill":
        return jaxpr_flops(jax.make_jaxpr(api.prefill)(params, i32(batch, seq, *cb),
                                                       state).jaxpr)
    return jaxpr_flops(jax.make_jaxpr(api.decode_step)(params, i32(batch, *cb),
                                                       state).jaxpr)


FAMILY_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m", "qwen2-vl-72b", "musicgen-large",
                "mamba2-130m", "zamba2-2.7b")
KINDS = ("prefill", "decode", "train")
BATCH, SEQ = 2, 64
LAYER_ARCHS = ("qwen3-1.7b", "zamba2-2.7b")
REMAT_ARCH = "qwen3-1.7b"


def _seq(arch: str, kind: str) -> int:
    """The vlm's train batch holds 256 patch positions before its text."""
    return 512 if kind == "train" and get_config(arch).model.family == "vlm" else SEQ


def scan_only_flops(arch: str, batch: int, seq: int) -> int:
    """The products of the reference's train step that its SSD chunk scan
    computes and the port's unrolled chunk loop does not: per SSM layer,
    the backward of the last chunk's state update (its cotangent is zero:
    no loss reads the final state) and of the first chunk's state read
    (the initial state is a constant), 6 B H P N Q, and per chunk the
    gradients of the three-operand einsums' elementwise factors, which
    JAX contracts and the port sums, 2 B Q H (P + N)."""
    m = get_config(arch, smoke=True).model
    if m.ssm is None:
        return 0
    s = m.ssm
    q = min(s.chunk, seq)
    h, p, n = s.expand * m.d_model // s.head_dim, s.head_dim, s.d_state
    per_layer = 6 * batch * h * p * n * q + (seq // q) * 2 * batch * q * h * (p + n)
    return m.n_layers * per_layer


def _family_cells() -> list:
    return [[a, k, "none", BATCH, _seq(a, k)] for a in FAMILY_ARCHS for k in KINDS]


@pytest.fixture(scope="module")
def counted():
    """Every fake-world case of this file, run at once: (the family
    cells' FLOPs with checkpoints off, the remat cells' FLOPs, the layer
    costs of each of LAYER_ARCHS)."""
    remat = [[REMAT_ARCH, "train", "none", BATCH, SEQ], [REMAT_ARCH, "train", "full", BATCH, SEQ],
             [REMAT_ARCH, "prefill", "none", BATCH, SEQ]]
    families, rematted, *layers = run_cases(
        ("flops", _family_cells(), True), ("flops", remat, False),
        *(("layer_costs", [a], list(KINDS), BATCH, SEQ) for a in LAYER_ARCHS))
    return families, rematted, {k: v for d in layers for k, v in d.items()}


def test_flops_match_reference_per_family_and_kind(counted, monkeypatch):
    cells = _family_cells()
    got = counted[0]
    assert {get_config(a).model.family for a in FAMILY_ARCHS} == {
        "dense", "moe", "vlm", "audio", "ssm", "hybrid"}
    for arch, kind, remat, batch, seq in cells:
        want = reference_flops(arch, kind, batch, seq, monkeypatch)
        if kind == "train":
            want -= scan_only_flops(arch, batch, seq)
        assert got[f"{arch}|{kind}|{remat}|{seq}"] == want, (arch, kind)


def test_remat_recompute_is_counted(counted):
    """qwen3 smoke: remat "full" adds exactly the layers' forward products
    (prefill's count less its head, 2 B D V at the last position)."""
    arch, got = REMAT_ARCH, counted[1]
    m = get_config(arch, smoke=True).model
    layers = got[f"{arch}|prefill|none|{SEQ}"] - 2 * BATCH * m.d_model * m.vocab
    assert got[f"{arch}|train|full|{SEQ}"] - got[f"{arch}|train|none|{SEQ}"] == layers


# ------------------------------------------------------------- layer costs

def test_full_depth_flops_are_the_layer_cost_extrapolation(counted):
    """qwen3 and zamba2 smoke (zamba2's unit: ``attn_every`` layers and the
    shared block), every kind: full = d0 + n_units x (d_unit - d0)."""
    got = counted[2]
    assert len(got) == len(LAYER_ARCHS) * len(KINDS)
    for key, r in got.items():
        d0, du, full = r["flops"]
        assert full == d0 + r["layers"] // r["unit"] * (du - d0), key
        assert full > du > d0 >= 0, key


# ------------------------------------------------------ sequence-split KV cache

def test_sequence_split_cache_and_moe_serve_as_unsharded():
    (r0, r1) = run_ranks("sp_serve", 2, timeout=300)
    for rank, res in enumerate((r0, r1)):
        for name, (meshed, plain, placements) in res.items():
            assert np.array_equal(meshed["tokens"], plain["tokens"]), (rank, name)
            for part in ("prefill", "decode"):
                err = np.abs(meshed[part] - plain[part]).max() / np.abs(plain[part]).max()
                assert err < 1e-5, (rank, name, part, err)
            if name != "granite-moe-3b-a800m":
                assert "Shard(dim=3)" in placements, (name, placements)   # along the sequence
