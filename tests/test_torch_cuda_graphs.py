"""ServeSession's CUDA graphs against its eager path, on the card.

The graphed session (the default on a CUDA device) must give the eager
session's tokens and prefill logits bit for bit: the graphs replay the same
kernels on the same inputs.  Smoke configs, random weights from a seed.
Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py
"""

import dataclasses

import pytest
import torch

from repro_torch.config import EngineConfig
from repro_torch.configs import get_config
from repro_torch.kernels import rasa_gemm as rk
from repro_torch.models import build_model
from repro_torch.models.transformer import prompt_shape
from repro_torch.serving import ServeSession

BATCH, PROMPT, STEPS, MAX_SEQ = 2, 8, 6, 32
BLOCKS = dict(block_m=128, block_k=128, block_n=128)
ENGINES = {"xla": EngineConfig(**BLOCKS),
           **{s: EngineConfig(kind="pallas_rasa", schedule=s, **BLOCKS)
              for s in rk.SCHEDULES}}

pytestmark = pytest.mark.cuda


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def model_of(arch, engine):
    cfg = get_config(arch, smoke=True)
    return build_model(dataclasses.replace(cfg, engine=ENGINES[engine]),
                       device="cuda", seed=0)


def prompts(m, seed, batch=BATCH):
    """[B, S] prompts of model config m, or [B, S, n_codebooks] for audio."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, m.vocab, prompt_shape(m, batch, PROMPT), generator=gen,
                         device="cuda", dtype=torch.int32)


def run(session, toks):
    """(prefill logits, tokens) of one generation, as generate makes it."""
    logits = session.prefill(toks).clone()
    return logits, session.generate(toks, STEPS)


def assert_same(graphed, eager, toks):
    got, want = run(graphed, toks), run(eager, toks)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]), "prefill logits differ"
    assert torch.equal(got[1], want[1]), "tokens differ"


@pytest.mark.parametrize("engine", list(ENGINES))
def test_qwen3_graphs_equal_eager(engine):
    need_cuda()
    model = model_of("qwen3-1.7b", engine)
    graphed = ServeSession(model, MAX_SEQ, device="cuda")
    assert graphed.graphed
    assert_same(graphed, ServeSession(model, MAX_SEQ, device="cuda", eager=True),
                prompts(model.model, 1))


@pytest.mark.parametrize("engine", ["wls", "xla"])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_graphs_equal_eager(arch, engine):
    need_cuda()
    model = model_of(arch, engine)
    assert_same(ServeSession(model, MAX_SEQ, device="cuda"),
                ServeSession(model, MAX_SEQ, device="cuda", eager=True),
                prompts(model.model, 1))


@pytest.mark.parametrize("engine", ["wls", "xla"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-large"])
def test_moe_and_audio_graphs_equal_eager(arch, engine):
    """The MoE dispatch and combine (no atomics) and the audio family's
    [B, n_codebooks] tokens replay as they run eagerly."""
    need_cuda()
    model = model_of(arch, engine)
    toks = prompts(model.model, 1)
    assert_same(ServeSession(model, MAX_SEQ, device="cuda"),
                ServeSession(model, MAX_SEQ, device="cuda", eager=True), toks)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_decode_past_max_seq_replays(arch):
    """Decode steps past a full cache replay as they run eagerly: the
    append's clamped index is computed on the device, so no replay goes out
    of bounds (which would poison the context) and the logits stay finite."""
    need_cuda()
    model = model_of(arch, "wls")
    toks = prompts(model.model, 1)
    outs = []
    for session in (ServeSession(model, PROMPT + 2, device="cuda"),
                    ServeSession(model, PROMPT + 2, device="cuda", eager=True)):
        logits = session.prefill(toks)
        steps = []
        for _ in range(4):
            logits = session.decode_step(torch.argmax(logits, dim=-1).to(torch.int32))
            steps.append(logits.clone())
        outs.append(torch.stack(steps))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_successive_calls_and_two_batch_sizes(arch):
    """Two prompts, then a second batch size (a second capture of each
    step), then the first prompt again: each as the eager session gives it,
    and a replay launches no kernel from Python."""
    need_cuda()
    model = model_of(arch, "wls")
    graphed = ServeSession(model, MAX_SEQ, device="cuda")
    eager = ServeSession(model, MAX_SEQ, device="cuda", eager=True)
    m = model.model
    cases = [prompts(m, 1), prompts(m, 2), prompts(m, 3, batch=BATCH + 1), prompts(m, 1)]
    for toks in cases:
        assert_same(graphed, eager, toks)
    assert sorted((k[0], k[1]) for k in graphed._graphs) == [
        ("decode", BATCH), ("decode", BATCH + 1), ("prefill", BATCH), ("prefill", BATCH + 1)]
    rk.reset_launches()
    model.prefill(cases[0], model.init_decode_state(BATCH, MAX_SEQ))
    per_forward = rk.launches["wls"]
    rk.reset_launches()
    graphed.generate(cases[0], STEPS)
    assert rk.launches["wls"] == 0
    eager.generate(cases[0], STEPS)
    assert rk.launches["wls"] == (1 + STEPS) * per_forward > 0


def test_engine_change_captures_anew():
    """A graph captured under one engine never replays under another."""
    need_cuda()
    model = model_of("qwen3-1.7b", "wls")
    graphed = ServeSession(model, MAX_SEQ, device="cuda")
    toks = prompts(model.model, 1)
    graphed.generate(toks, STEPS)
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, engine=ENGINES["base"])
    rk.reset_launches()
    graphed.generate(toks, STEPS)
    assert rk.launches["base"] > 0 and rk.launches["wls"] == 0   # base was captured
    assert len(graphed._graphs) == 4
    model.cfg = cfg


def test_failed_capture_raises():
    """No fallback: a step that cannot be captured raises, and runs only
    when eager=True was asked for."""
    need_cuda()
    model = model_of("qwen3-1.7b", "wls")
    step = model.decode_step

    def syncing_step(token, state):
        int(state.position)          # a host sync: not allowed while capturing
        return step(token, state)

    model.decode_step = syncing_step
    toks = prompts(model.model, 1)
    with pytest.raises(RuntimeError):
        ServeSession(model, MAX_SEQ, device="cuda").generate(toks, STEPS)
    torch.cuda.synchronize()
    tokens = ServeSession(model, MAX_SEQ, device="cuda", eager=True).generate(toks, STEPS)
    assert tokens.shape == (BATCH, STEPS)
