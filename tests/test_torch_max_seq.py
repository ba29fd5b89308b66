"""Decode past a full KV cache, against the reference.

The reference's decode append is ``dynamic_update_slice_in_dim``, which
clamps its start to [0, max_seq - 1]: once the cache is full each step
rewrites its last slot, the length keeps counting and the mask keeps the
unclamped position, so every slot stays visible.  The port does the same
on the device (no host sync).  qwen3-1.7b (the decoder's cache) and
zamba2-2.7b (the hybrid's shared-attention caches) smoke, f32, max_seq 10,
a prompt of 8 and 4 teacher-forced steps, the last two past the cache:
logits rel_err < 1e-5 at every step (fp32 on both sides, sums in another
order).  ServeSession.generate keeps refusing a generation that does not
fit max_seq.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import EngineConfig as JEngine
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch import config as tconfig
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import ServeSession

from _torch_parity import BLOCKS, rel_err, with_dtype

BATCH, PROMPT, STEPS, MAX_SEQ = 2, 8, 4, 10
ENGINES = {"xla": {}, "wls": dict(kind="pallas_rasa", schedule="wls", **BLOCKS)}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_decode_past_max_seq_matches_reference(arch, engine):
    cfg = dataclasses.replace(with_dtype(j_get_config(arch, smoke=True), "float32"),
                              engine=JEngine(**ENGINES[engine]))
    api = j_build_model(cfg)
    params = api.init(jax.random.key(0))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.model.vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    logits, state = jax.jit(api.prefill)(params, jnp.asarray(toks[:, :PROMPT]),
                                         api.init_decode_state(BATCH, MAX_SEQ))
    want = [np.asarray(logits)]
    decode = jax.jit(api.decode_step)
    for i in range(STEPS):
        logits, state = decode(params, jnp.asarray(toks[:, PROMPT + i]), state)
        want.append(np.asarray(logits))

    tcfg = dataclasses.replace(with_dtype(get_config(arch, smoke=True), "float32"),
                               engine=tconfig.EngineConfig(**ENGINES[engine]))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    t = torch.from_numpy(toks)
    st = model.init_decode_state(BATCH, MAX_SEQ)
    logits, _ = model.prefill(t[:, :PROMPT], st)
    got = [logits.numpy().copy()]
    for i in range(STEPS):
        logits, _ = model.decode_step(t[:, PROMPT + i], st)
        got.append(logits.numpy().copy())
    for step, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        assert rel_err(g, w) < 1e-5, f"step {step}"
    assert st.position.item() == PROMPT + STEPS
    assert (st.buffers[2] == PROMPT + STEPS).all()       # the lengths keep counting


def test_generate_refuses_past_max_seq():
    model = build_model(get_config("qwen3-1.7b", smoke=True), device="cpu")
    session = ServeSession(model, MAX_SEQ, device="cpu")
    toks = torch.zeros((BATCH, PROMPT), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        session.generate(toks, MAX_SEQ - PROMPT + 1)
    assert session.generate(toks, MAX_SEQ - PROMPT).shape == (BATCH, MAX_SEQ - PROMPT)
