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


# ------------------------------------------------------------------ training

#: the training tests' batch: B x S tokens from the reference's pipeline
TRAIN_BATCH, TRAIN_SEQ = 2, 32


def train_batch(m, step: int = 0, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """A batch of the reference's SyntheticLMDataset for ModelConfig m (numpy)."""
    from repro.data import SyntheticLMDataset
    return SyntheticLMDataset(m, seq_len=seq, global_batch=batch, seed=1).batch(step)


def stacked(tree: dict, port: dict) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """(name, reference leaf, the port's tensors by name stacked like it) for
    every leaf of the reference's tree (params, grads or moments), as f32."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        leaf = np.asarray(leaf, np.float32)
        if keys[0] == "layers":
            got = np.stack([to_np(port[f"layers.{i}.{keys[1]}"].detach())
                            for i in range(leaf.shape[0])])
        else:
            got = to_np(port[".".join(keys)].detach())
        out.append(("/".join(keys), leaf, got))
    return out


def reference_loss_and_grads(arch: str, dtype: str, grads: bool = True):
    """The reference's smoke model (jax.random.key(0)) in ``dtype``, its
    weights as numpy, a batch, and its loss, metrics and (with ``grads``)
    gradients from jax.value_and_grad of api.loss under the xla engine."""
    cfg = with_dtype(j_get_config(arch, smoke=True), dtype)
    api = j_build_model(cfg)
    params = api.init(jax.random.key(0))
    batch = train_batch(cfg.model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if grads:
        (loss, metrics), g = jax.value_and_grad(api.loss, has_aux=True)(params, jbatch)
    else:
        (loss, metrics), g = api.loss(params, jbatch), None
    return jax.tree.map(np.asarray, params), batch, loss, metrics, g


def port_train_model(arch: str, dtype: str, tree: dict, remat: str = "full",
                     kind: str = "xla", schedule: str = "wls", **train):
    """The port's smoke model on the CPU holding the reference's weights
    ``tree``, with the remat policy, engine and TrainConfig fields given."""
    cfg = with_dtype(t_get_config(arch, smoke=True), dtype)
    cfg = dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat=remat),
        engine=tconfig.EngineConfig(kind=kind, schedule=schedule, **BLOCKS),
        train=dataclasses.replace(cfg.train, **train))
    return params_from_jax(cfg, tree, device="cpu")


#: the training tolerances: f32 loss and every gradient leaf (rel_err; the
#: GEMM tolerance), and the bf16 loss (rel_err; the layers' bf16 tolerance)
GRAD_TOL, BF16_LOSS_TOL = 1e-5, 2e-2


def port_loss_and_grads(model, batch: dict):
    """The port's Model.loss on batch and torch.autograd.grad of it with
    respect to every parameter, by name."""
    model.requires_grad_(True)
    loss, metrics = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return loss, metrics, dict(zip(names, torch.autograd.grad(loss, params)))


def assert_loss_and_grads(arch: str) -> None:
    """f32: the port's loss, metrics and every gradient leaf against
    jax.value_and_grad of the reference's api.loss on its weights."""
    tree, batch, loss, metrics, grads = reference_loss_and_grads(arch, "float32")
    got, got_metrics, got_grads = port_loss_and_grads(
        port_train_model(arch, "float32", tree), batch)
    assert rel_err(got.detach(), loss) < GRAD_TOL
    for key in ("ce", "aux_loss"):
        assert rel_err(got_metrics[key].detach(), metrics[key]) < GRAD_TOL, key
    assert int(got_metrics["n_valid"]) == int(metrics["n_valid"])
    leaves = stacked(grads, got_grads)
    assert sum(np.prod(w.shape) for _, w, _ in leaves) == sum(
        g.numel() for g in got_grads.values())    # every parameter is compared
    for name, want, have in leaves:
        assert np.isfinite(have).all() and np.abs(want).max() > 0, name
        assert rel_err(have, want) < GRAD_TOL, (name, rel_err(have, want))


def assert_bf16_loss(arch: str) -> None:
    """bf16: the port's loss against the reference's on the same weights."""
    tree, batch, loss, _, _ = reference_loss_and_grads(arch, "bfloat16", grads=False)
    with torch.no_grad():
        got, _ = port_train_model(arch, "bfloat16", tree).loss(batch)
    assert np.isfinite(float(got))
    assert rel_err(got, loss) < BF16_LOSS_TOL
