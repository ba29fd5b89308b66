"""Training on the card: the train step against the same step on the CPU,
the derivative of the xla engine's product (``dot_f32``), and the RASA
engine's refusal of a backward.

Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""

import copy
import dataclasses

import pytest
import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels import rasa_matmul
from repro_torch.models import build_model
from repro_torch.models.common import _grad_product, dot_f32
from repro_torch.training import build_train_step, init_train_state

#: one smoke arch per family
FAMILY_ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "qwen2-vl-72b", "musicgen-large",
                "mamba2-130m", "zamba2-2.7b"]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def rel_err(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def one_step(model, batch):
    state = init_train_state(model)
    return state, build_train_step(model)(state, batch)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_train_step_matches_cpu(arch, dtype):
    """Two train steps (lr 0 at the first, microbatches 2) on the card from
    the CPU model's weights against the same steps on the CPU.  f32: loss
    and grad_norm within rel_err 1e-5, parameters within 1e-4 (the sums'
    order differs; Adam's m / sqrt(v) carries it into the update).  bf16 (the
    out_dtype products of the forward and the backward, the MoE's bmm
    included): loss and grad_norm within 2e-2, the layers' bf16 tolerance."""
    need_cuda()
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=dtype),
        train=TrainConfig(global_batch=4, seq_len=32, microbatches=2, lr=1e-3,
                          warmup_steps=1, total_steps=4))
    cpu = build_model(cfg, device="cpu", seed=0)
    card = copy.deepcopy(cpu).to("cuda")
    assert card.device.type == "cuda"
    data = SyntheticLMDataset(cfg.model, seq_len=32, global_batch=4, seed=1)
    s_cpu, s_card = init_train_state(cpu), init_train_state(card)
    step_cpu, step_card = build_train_step(cpu), build_train_step(card)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for s in range(2):
        _, want = step_cpu(s_cpu, data.batch(s))
        _, got = step_card(s_card, data.batch(s))
        assert got["loss"].is_cuda and torch.isfinite(got["loss"])
        for key in ("loss", "grad_norm"):
            assert rel_err(got[key], want[key]) < tol, (s, key)
    for name, p in s_card.params.items():
        assert p.is_cuda and torch.isfinite(p).all()
        if dtype == "float32":
            assert rel_err(p, s_cpu.params[name]) < 1e-4, name


@pytest.mark.cuda
def test_cuda_serving_graphs_after_init_train_state():
    """init_train_state leaves serving's graphed steps as they were: the
    graphed session gives the tokens it gave before, and the eager ones."""
    need_cuda()
    from repro_torch.serving import ServeSession
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, cfg.model.vocab, (2, 8), device="cuda", generator=gen,
                            dtype=torch.int32)
    before = ServeSession(model, max_seq=32, device="cuda").generate(prompts, 4).clone()
    init_train_state(model)
    graphed = ServeSession(model, max_seq=32, device="cuda")
    assert graphed.graphed
    assert torch.equal(graphed.generate(prompts, 4), before)
    eager = ServeSession(model, max_seq=32, device="cuda", eager=True)
    assert torch.equal(eager.generate(prompts, 4), before)


#: the backward's products against the exact (f64) product, max error over
#: max.  On an H100 (chip_smoke.py's product_precision) the f32-cast product
#: reads up to 4.2e-6 at these contractions, the out_dtype overload over the
#: whole contraction 9.3e-6 to 1.5e-5, and in pieces of GRAD_K_PIECE (1024)
#: up to 1.3e-6: this limit passes the first and the last, and fails the
#: out_dtype overload taken over the whole contraction.
GRAD_TOL = 6e-6


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mm", "bmm"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cuda_dot_f32_backward(op, out_dtype):
    """dot_f32's derivative on the card, bf16 operands, at the backward's
    contractions on the train path: a [8192, 2048] @ b [2048, 12288], so G bᵀ
    contracts over 12288 (2 d_ff of qwen3-1.7b, the fused gate/up) and aᵀ G
    over 8192 (the tokens of a microbatch of 16 x 512).  Each transposed
    product before its cast (``_grad_product`` at the backward's layouts, the
    transposes read in place) and the f32-cast product against the f64
    product: GRAD_TOL; the two against each other: 1e-5, the GEMM
    tolerance.  dot_f32's gradients against autograd of the f32-cast
    product: one rounding to bf16 (2 ** -8)."""
    need_cuda()
    fn = getattr(torch, op)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lead = (2,) if op == "bmm" else ()
    m, k, n = 8192, 2048, 12288
    a = torch.randn(*lead, m, k, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(*lead, k, n, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(*lead, m, n, device="cuda", generator=gen).to(out_dtype)
    t = lambda x: x.transpose(-1, -2)
    f = lambda x: x.float()
    rel64 = lambda x, ref: ((x.double() - ref).abs().max() / ref.abs().max()).item()
    for x, y in ((g, t(b)), (t(a), g)):
        exact = fn(x.double(), y.double())
        got, f32 = _grad_product(fn, x, y), fn(f(x), f(y))
        assert rel64(got, exact) < GRAD_TOL, (tuple(x.shape), "dot_f32's route")
        assert rel64(f32, exact) < GRAD_TOL, (tuple(x.shape), "the f32-cast product")
        assert rel_err(got, f32) < 1e-5, tuple(x.shape)
        del exact, got, f32
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = dot_f32(fn, a, b, out_dtype)
    assert out.dtype == out_dtype
    da, db = torch.autograd.grad(out, (a, b), g)
    assert da.dtype == db.dtype == torch.bfloat16
    af, bf = f(a.detach()).requires_grad_(True), f(b.detach()).requires_grad_(True)
    want_a, want_b = torch.autograd.grad(fn(af, bf).to(out_dtype), (af, bf), g)
    assert rel_err(da, want_a) < 2 ** -8 and rel_err(db, want_b) < 2 ** -8


@pytest.mark.cuda
def test_cuda_rasa_backward_raises():
    """A backward through the RASA kernel raises on the card: its output
    has no derivative of its own, and the weights behind it must not
    silently get no gradient."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(64, 128, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(128, 32, device="cuda", generator=gen).to(torch.bfloat16)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = rasa_matmul(a, b, schedule="wls")
    with pytest.raises(RuntimeError, match="forward-only"):
        out.sum().backward()
    assert a.grad is None and b.grad is None
