"""The static decode state the CUDA graphs of ServeSession replay over, on
the CPU (smoke configs, random weights from a seed).

- prefill and decode_step run no op that needs the host: no
  ``aten.lift_fresh`` (a tensor built on the host and copied to the device)
  and no ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``bool(t)``).
  On a CUDA device either would stop a capture, so this is the CPU's proxy
  for "capturable";
- the position and the caches' lengths are int32 tensors that prefill sets
  to S and each decode step advances by one, in place;
- one session's static state is reset between generate calls: two calls
  give the tokens of two fresh sessions.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import EngineConfig
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.transformer import prompt_shape
from repro_torch.serving import ServeSession

ARCHS = ["qwen3-1.7b", "mamba2-130m", "zamba2-2.7b", "granite-moe-3b-a800m",
         "grok-1-314b", "qwen2-vl-72b", "musicgen-large"]
ENGINES = {"xla": EngineConfig(),
           "wls": EngineConfig(kind="pallas_rasa", schedule="wls", block_m=128,
                               block_k=128, block_n=128)}
BATCH, PROMPT, MAX_SEQ = 2, 8, 16
HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense")


class OpNames(TorchDispatchMode):
    """Records the name of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def model_of(arch, engine="xla", seed=0):
    cfg = get_config(arch, smoke=True)
    return build_model(dataclasses.replace(cfg, engine=ENGINES[engine]),
                       device="cpu", seed=seed)


def prompts(m, seed, batch=BATCH):
    """[B, S] prompts of model config m, or [B, S, n_codebooks] for audio."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, m.vocab, prompt_shape(m, batch, PROMPT), generator=gen,
                         dtype=torch.int32)


def lengths(state):
    return state.buffers[2]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_need_no_host(arch, engine):
    model = model_of(arch, engine)
    state = model.init_decode_state(BATCH, MAX_SEQ)
    toks = prompts(model.model, 1)
    with OpNames() as ops:
        logits, _ = model.prefill(toks, state)
        model.decode_step(torch.argmax(logits, -1).to(torch.int32), state)
    assert "aten.mm" in ops.names or "aten.bmm" in ops.names   # the mode saw the steps
    assert not [n for n in ops.names if n in HOST_OPS]


@pytest.mark.parametrize("arch", ARCHS)
def test_position_and_lengths_advance_in_place(arch):
    model = model_of(arch)
    state = model.init_decode_state(BATCH, MAX_SEQ)
    position, lens = state.position, lengths(state)
    assert position.dtype == lens.dtype == torch.int32 and position.dim() == 0
    apps = len(state.caches if hasattr(state, "caches") else state.attn)
    assert lens.shape == (apps,)
    toks = prompts(model.model, 1)
    logits, after = model.prefill(toks, state)
    assert after.position is position and lengths(after) is lens
    assert position.item() == PROMPT and (lens == PROMPT).all()
    for i in range(1, 3):
        logits, after = model.decode_step(torch.argmax(logits, -1).to(torch.int32), state)
        assert after.position is position
        assert position.item() == PROMPT + i and (lens == PROMPT + i).all()
    state.zero_()
    assert position.item() == 0 and (lens == 0).all()
    assert all(not t.any() for t in state.buffers)


@pytest.mark.parametrize("arch", ARCHS)
def test_session_resets_its_state_between_calls(arch):
    model = model_of(arch)
    a, b = prompts(model.model, 2), prompts(model.model, 3)
    c = prompts(model.model, 4, batch=1)
    session = ServeSession(model, MAX_SEQ, device="cpu")
    assert not session.graphed
    got = [session.generate(p, 5) for p in (a, b, c, a)]
    want = [ServeSession(model, MAX_SEQ, device="cpu").generate(p, 5) for p in (a, b, c)]
    assert not torch.equal(want[0], want[1])
    for g, w in zip(got, want + want[:1]):
        assert torch.equal(g, w)


def test_decode_step_follows_a_prefill_of_its_batch():
    model = model_of("qwen3-1.7b")
    session = ServeSession(model, MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="after a prefill"):
        session.decode_step(torch.zeros(BATCH, dtype=torch.int32))
    session.prefill(prompts(model.model, 1))
    with pytest.raises(ValueError, match="after a prefill"):
        session.decode_step(torch.zeros(BATCH + 1, dtype=torch.int32))
