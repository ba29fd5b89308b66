"""Serving parity of the moe, vlm and audio families: granite-moe-3b-a800m
(40 -> smoke 8 experts, top-4), grok-1-314b (smoke 4 experts, top-2),
qwen2-vl-72b (M-RoPE with t = h = w, the patch projection unused by
serving) and musicgen-large (4 codebooks: [B, S, 4] prompts, [B, 4]
decode tokens, [B, 4, V] logits).  As tests/test_torch_serving_dense.py:
the port's prefill logits, teacher-forced decode logits and ServeSession
tokens against the reference's, with the reference's weights carried over
through params_from_jax; then embed_tokens of the audio and vlm families
(the latter with patch_embeds, which only the training loss passes).

Tolerances: f32 logits rel_err < 1e-5 (fp32 on both sides, sums in another
order) and identical greedy tokens; bf16 logits within the reference's
decode-vs-prefill tolerance, rtol = atol = 0.15 (test_arch_smoke.py:83);
the audio embedding sum bit for bit (it accumulates in fp32 and rounds
once on both sides); the patch projection at the layer tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import transformer as jt
from repro_torch.models.transformer import embed_tokens, prompt_shape

from _torch_parity import ENGINES, TOL, port_model, port_outputs, reference, rel_err, to_np

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b", "qwen2-vl-72b", "musicgen-large"]
F32_TOL = 1e-5
BF16_TOL = 0.15

_refs = {}
_outputs = {}


def ref(arch, dtype):
    """The reference's outputs, computed once per module."""
    if (arch, dtype) not in _refs:
        _refs[arch, dtype] = reference(arch, dtype)
    return _refs[arch, dtype]


def outputs(arch, dtype, kind, schedule):
    """The port's outputs under one engine, computed once per module."""
    key = (arch, dtype, kind, schedule)
    if key not in _outputs:
        r = ref(arch, dtype)
        _outputs[key] = port_outputs(
            port_model(arch, dtype, r["tree"], kind, schedule), r["tokens_in"])
    return _outputs[key]


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_logits(arch, name, kind, schedule):
    out, want = outputs(arch, "float32", kind, schedule), ref(arch, "float32")
    assert rel_err(out["prefill"], want["prefill"]) < F32_TOL
    for got, w in zip(out["decode"], want["decode"]):
        assert rel_err(got, w) < F32_TOL


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_greedy_tokens(arch, name, kind, schedule):
    out, want = outputs(arch, "float32", kind, schedule), ref(arch, "float32")
    np.testing.assert_array_equal(out["tokens"], want["generate"]["xla"])
    np.testing.assert_array_equal(out["tokens"], want["generate"]["pallas_rasa"])


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits(arch, name, kind, schedule):
    out, want = outputs(arch, "bfloat16", kind, schedule), ref(arch, "bfloat16")
    np.testing.assert_allclose(out["prefill"], want["prefill"],
                               rtol=BF16_TOL, atol=BF16_TOL)
    for got, w in zip(out["decode"], want["decode"]):
        np.testing.assert_allclose(got, w, rtol=BF16_TOL, atol=BF16_TOL)
    # the port's own decode path reproduces its prefill (cache correctness)
    np.testing.assert_allclose(out["decode"][-1], out["prefill"],
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_schedules_bit_identical(arch):
    outs = [outputs(arch, "bfloat16", "pallas_rasa", s)
            for s in ("wls", "wlbp", "base")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["tokens"], outs[0]["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b"])
def test_embed_tokens(arch, dtype):
    r = ref(arch, dtype)
    model = port_model(arch, dtype, r["tree"], "xla", "wls")
    m = model.model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, m.vocab, prompt_shape(m, 2, 5)).astype(np.int32)
    tree = {n: jnp.asarray(r["tree"][n]) for n in ("embedding", "patch_proj") if n in r["tree"]}
    patches = None
    if m.family == "vlm":
        patches = rng.normal(size=(2, 3, m.d_model)).astype(np.float32)
    want = np.asarray(jt.embed_tokens(tree, r["cfg"], jnp.asarray(toks),
                                      None if patches is None else jnp.asarray(patches)),
                      np.float32)
    got = embed_tokens(model, torch.from_numpy(toks),
                       None if patches is None else torch.from_numpy(patches))
    assert got.dtype == getattr(torch, dtype)
    if patches is None:
        np.testing.assert_array_equal(to_np(got), want)
    else:
        assert got.shape == (2, 3 + 5, m.d_model)
        np.testing.assert_array_equal(to_np(got[:, 3:]), want[:, 3:])
        assert rel_err(to_np(got[:, :3]), want[:, :3]) < TOL[dtype]
