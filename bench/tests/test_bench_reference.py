"""The plain references (bench/reference/) held against the port's SMOKE
models on the CPU, on the same weights, in fp32: served logits (prefill,
then decode over the cache), the MoE with its capacity dropping tokens,
and the training loss, gradients and AdamW steps."""

import dataclasses

import pytest
import torch

from bench import harness, weights
from bench.reference import common

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.models import model_of
from repro_torch.models.moe import capacity
from repro_torch.serving import ServeSession
from repro_torch.training import build_train_step, init_train_state

TOL = 1e-4       # fp32 on both sides: only the order of the sums differs


def smoke(arch: str, **moe):
    run = get_config(arch, smoke=True)
    m = dataclasses.replace(run.model, dtype="float32")
    if moe:
        m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, **moe))
    return dataclasses.replace(run, model=m)


def served(run, params, batch=4, prompt=16, steps=6, engine="xla"):
    run = dataclasses.replace(run, engine=dataclasses.replace(run.engine, kind=engine))
    session = ServeSession(model_of(run, params), max_seq=prompt + steps, device="cpu")
    prompts = torch.randint(0, run.model.vocab, (batch, prompt), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(5))
    logits = [session.prefill(prompts)]
    toks = [logits[0].argmax(-1).int()]
    for _ in range(steps - 1):
        logits.append(session.decode_step(toks[-1]))
        toks.append(logits[-1].argmax(-1).int())
    return prompts, torch.stack(toks, 1), torch.stack(logits, 1)


@pytest.mark.parametrize("engine", ["xla", "pallas_rasa"])
@pytest.mark.parametrize("arch,moe", [("qwen3-1.7b", {}),
                                      ("granite-moe-3b-a800m", {}),
                                      ("granite-moe-3b-a800m", {"capacity_factor": 1.0})])
def test_served_logits_match_the_port(arch, moe, engine):
    run = smoke(arch, **moe)
    spec = harness.spec_of_model(run.model)
    params = weights.draw(spec, 31, "cpu", dtype=torch.float32)
    prompts, toks, logits = served(run, params, engine=engine)
    ref = common.Reference(spec, params)
    want = common.served_logits(ref, prompts, toks, step_by_step=True)
    assert torch.allclose(want, logits, atol=TOL, rtol=TOL), (want - logits).abs().max()
    if not run.model.moe:       # rows are independent: one forward a sequence
        whole = common.served_logits(ref, prompts, toks, step_by_step=False)
        assert torch.allclose(whole, logits, atol=TOL, rtol=TOL)
    assert common.token_gaps(want, toks).max() < TOL


def test_capacity_drops_tokens_in_the_checked_case():
    """The capacity of 1.0 above does drop entries, so the reference's
    dispatch is held where it matters."""
    run = smoke("granite-moe-3b-a800m", capacity_factor=1.0)
    spec = harness.spec_of_model(run.model)
    params = weights.draw(spec, 31, "cpu", dtype=torch.float32)
    ref = common.Reference(spec, params)
    x = torch.randn(4, 16, spec["d_model"], generator=torch.Generator().manual_seed(2))
    p = ref.layers[0]
    probs = torch.softmax(x.reshape(-1, spec["d_model"]) @ p["router"], -1)
    top = probs.topk(spec["moe"]["top_k"], -1).indices.reshape(16, 4, -1)
    loads = torch.stack([(top == e).any(-1).sum(1) for e in range(spec["moe"]["n_experts"])])
    assert (loads > capacity(4, run.model)).any()


def test_train_steps_match_the_port():
    run = smoke("qwen3-1.7b")
    tr = TrainConfig(global_batch=4, seq_len=32, microbatches=2, lr=1e-3, warmup_steps=1,
                     total_steps=10)
    run = dataclasses.replace(run, train=tr, engine=dataclasses.replace(run.engine, kind="xla"))
    spec = harness.spec_of_model(run.model)
    gen = torch.Generator().manual_seed(3)
    batches = []
    for _ in range(3):
        t = torch.randint(0, spec["vocab"], (4, 33), generator=gen, dtype=torch.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    model = model_of(run, weights.draw(spec, 9, "cpu", dtype=torch.float32))
    state, step = init_train_state(model), build_train_step(model)
    losses, first = [], None
    for b in batches:
        state, metrics = step(state, b)
        losses.append(metrics["loss"].item())
        if first is None:
            first = {n: (m / (1 - tr.b1)).norm().item() for n, m in state.opt.m.items()}
    start = common.flat_leaves(weights.draw(spec, 9, "cpu", dtype=torch.float32))
    change = {n: (p.detach() - start[n]).norm().item() for n, p in state.params.items()}
    opt = {k: getattr(tr, k) for k in ("lr", "warmup_steps", "total_steps", "weight_decay",
                                       "grad_clip", "b1", "b2")}
    ref = common.train_steps(spec, weights.draw(spec, 9, "cpu", dtype=torch.float32),
                             batches, opt, storage=torch.float32)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    assert set(first) == set(ref["first_grad"]) == set(change)
    for n in first:
        assert first[n] == pytest.approx(ref["first_grad"][n], rel=1e-4, abs=1e-9)
        assert change[n] == pytest.approx(ref["change"][n], rel=1e-3, abs=1e-9)
    assert min(change.values()) > 0


def test_fp8_control_rounds_to_eight_bits():
    x = torch.linspace(-3, 3, 1001)
    q = common.fp8(x)
    assert 0 < (q - x).abs().max() <= 3 / 448 * 32
    assert len(torch.unique(q)) <= 256
