"""Shared plumbing of the parity tests (tests/test_torch_*.py): numpy <->
torch, the layer tests' configs and tolerances, and for the serving tests
the reference's smoke model and its outputs on numpy inputs, and the port's
model holding the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import EngineConfig as JEngine
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serving import ServeSession as JSession
from repro_torch import config as tconfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import prompt_shape
from repro_torch.serving import ServeSession

BATCH, PROMPT, STEPS, MAX_SEQ = 2, 8, 6, 32
BLOCKS = dict(block_m=128, block_k=128, block_n=128)
#: (name, engine kind, schedule) of the port's engines under test
ENGINES = [("xla", "xla", "wls"), ("wls", "pallas_rasa", "wls"),
           ("wlbp", "pallas_rasa", "wlbp"), ("base", "pallas_rasa", "base")]


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


#: layer tolerances (rel_err): f32 differs only in the order of sums; bf16
#: rounds at other places in the two frameworks (one ulp is 3.9e-3, a layer
#: rounds a few times; the reference's bf16 tolerance, test_kernels.py:112)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = list(TOL)


def to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.array(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def normal(rng, shape, dtype, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(jnp.dtype(dtype))


def engines(kind):
    if kind == "xla":
        return JEngine(), tconfig.EngineConfig()
    kw = dict(kind="pallas_rasa", schedule="wls", block_m=128, block_k=128,
              block_n=128)
    return JEngine(**kw), tconfig.EngineConfig(**kw)


def model_cfg(arch, dtype, softcap=0.0, **kw):
    """(reference, port) ModelConfig of the smoke arch, with overrides."""
    m = dataclasses.replace(j_get_config(arch, smoke=True).model, dtype=dtype,
                            logit_softcap=softcap, **kw)
    return m, port_model_cfg(m)


def port_model_cfg(m):
    """The port's ModelConfig equal to the reference's ``m``, its nested
    configs (moe, ssm, hybrid) included."""
    nested = {"moe": tconfig.MoEConfig, "ssm": tconfig.SSMConfig,
              "hybrid": tconfig.HybridConfig}
    fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
    for name, cls in nested.items():
        if fields[name] is not None:
            fields[name] = cls(**dataclasses.asdict(fields[name]))
    return tconfig.ModelConfig(**fields)


def with_dtype(cfg, dtype):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))


def reference(arch: str, dtype: str) -> dict:
    """The reference's weights (jax.random.key(0)) and its outputs on a
    seeded prompt: prefill logits, teacher-forced decode logits, and greedy
    tokens under the xla engine and the pallas_rasa (wls) engine.  The
    prompt is [B, S], or [B, S, n_codebooks] for the audio family."""
    cfg = with_dtype(j_get_config(arch, smoke=True), dtype)
    api = j_build_model(cfg)
    params = api.init(jax.random.key(0))
    toks = np.random.default_rng(2).integers(
        0, cfg.model.vocab, prompt_shape(cfg.model, BATCH, PROMPT)).astype(np.int32)
    prefill, _ = jax.jit(api.prefill)(params, jnp.asarray(toks),
                                      api.init_decode_state(BATCH, MAX_SEQ))
    decode = jax.jit(api.decode_step)
    state = api.init_decode_state(BATCH, MAX_SEQ)
    steps = []
    for i in range(PROMPT):
        logits, state = decode(params, jnp.asarray(toks[:, i]), state)
        steps.append(np.asarray(logits, np.float32))
    out = {"cfg": cfg.model, "tree": jax.tree.map(np.asarray, params), "tokens_in": toks,
           "prefill": np.asarray(prefill, np.float32), "decode": steps,
           "generate": {"xla": np.asarray(JSession(api, params, MAX_SEQ).generate(
               jnp.asarray(toks), STEPS))}}
    if dtype == "float32":
        api_p = j_build_model(dataclasses.replace(
            cfg, engine=JEngine(kind="pallas_rasa", schedule="wls", **BLOCKS)))
        out["generate"]["pallas_rasa"] = np.asarray(
            JSession(api_p, params, MAX_SEQ).generate(jnp.asarray(toks), STEPS))
    return out


def port_model(arch: str, dtype: str, tree: dict, kind: str, schedule: str):
    """The port's model on the CPU holding the reference's weights."""
    cfg = with_dtype(t_get_config(arch, smoke=True), dtype)
    engine = tconfig.EngineConfig(kind=kind, schedule=schedule, **BLOCKS)
    return params_from_jax(dataclasses.replace(cfg, engine=engine), tree,
                           device="cpu")


def port_outputs(model, toks: np.ndarray) -> dict:
    t = torch.from_numpy(toks)
    prefill, _ = model.prefill(t, model.init_decode_state(BATCH, MAX_SEQ))
    state = model.init_decode_state(BATCH, MAX_SEQ)
    steps = []
    for i in range(PROMPT):
        logits, state = model.decode_step(t[:, i], state)
        steps.append(logits.numpy())
    tokens = ServeSession(model, MAX_SEQ, device="cpu").generate(toks, STEPS)
    return {"prefill": prefill.numpy(), "decode": steps, "tokens": tokens.numpy()}
