"""Operations and bytes, from a configuration's shapes: the benchmark's own
frozen copy (it reads neither ``repro_torch.roofline`` nor the GEMM
wrapper's ``schedule_cost``).

``spec`` is the dict of sizes ``harness.spec_of`` reads from a
configuration's file.  Model FLOPs count the work a token needs, not what a
kernel happens to do: 2 per multiply-add of each product, the causal half
of attention (a token at position p attends to p + 1 positions), the
experts a token is routed to (not the capacity's empty slots), and the LM
head only for the rows whose logits are produced.
"""

from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One call of the matrix engine: [M, K] @ [K, N], ``count`` times."""
    name: str
    m: int
    k: int
    n: int
    count: int = 1
    in_bytes: int = 2
    out_bytes: int = 4       # the RASA GEMM writes an fp32 C

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n * self.count

    @property
    def bytes(self) -> int:
        """Each operand read once and the output written once."""
        return (self.m * self.k * self.in_bytes + self.k * self.n * self.in_bytes
                + self.m * self.n * self.out_bytes) * self.count

    def bound_s(self, peak_flops: float = PEAK_BF16_FLOPS,
                hbm: float = HBM_BYTES_PER_S) -> float:
        """The least time of the calls: each call's larger of its operations
        over the peak and its bytes over the HBM rate."""
        return max(self.flops / peak_flops, self.bytes / hbm)


def engine_gemms(spec: dict, rows: int, head_rows: int) -> list[Gemm]:
    """The products a forward of ``rows`` tokens sends through the model's
    matrix engine (``models.common.matmul`` with the config's engine): every
    layer's attention projections, the dense MLP's three products, and the
    LM head on ``head_rows`` rows.  The MoE's router and experts are library
    products, not the engine's."""
    d, hd, L = spec["d_model"], spec["head_dim"], spec["n_layers"]
    q, kv = spec["n_heads"] * hd, spec["n_kv_heads"] * hd
    out = [Gemm("wq", rows, d, q, L), Gemm("wk", rows, d, kv, L), Gemm("wv", rows, d, kv, L),
           Gemm("wo", rows, q, d, L)]
    if not spec.get("moe"):
        f = spec["d_ff"]
        out += [Gemm("w_gate", rows, d, f, L), Gemm("w_up", rows, d, f, L),
                Gemm("w_down", rows, f, d, L)]
    out.append(Gemm("head", head_rows, d, spec["vocab"]))
    return out


def engine_calls(spec: dict) -> int:
    """The engine products of one forward (each a GEMM kernel record)."""
    return sum(g.count for g in engine_gemms(spec, 1, 1))


def engine_bound_s(spec: dict, rows: int, head_rows: int) -> float:
    return sum(g.bound_s() for g in engine_gemms(spec, rows, head_rows))


def matmul_params(spec: dict) -> int:
    """Weights a token multiplies in the layers (routed experts: top_k of
    them, and the router), without the embedding lookup and the head."""
    d, hd = spec["d_model"], spec["head_dim"]
    q, kv = spec["n_heads"] * hd, spec["n_kv_heads"] * hd
    per_layer = 2 * d * q + 2 * d * kv
    moe = spec.get("moe")
    if moe:
        per_layer += moe["top_k"] * 3 * d * moe["d_ff_expert"] + d * moe["n_experts"]
    else:
        per_layer += 3 * d * spec["d_ff"]
    return spec["n_layers"] * per_layer


def attention_flops(spec: dict, start: int, n: int) -> int:
    """QK^T and PV of one sequence's tokens at positions start..start+n-1,
    each over the positions up to its own."""
    positions = n * start + n * (n + 1) // 2
    return 4 * spec["n_layers"] * spec["n_heads"] * spec["head_dim"] * positions


def forward_flops(spec: dict, batch: int, start: int, n: int, logit_rows: int) -> int:
    """Model FLOPs of a forward of ``batch`` sequences, ``n`` new tokens each
    after ``start`` cached ones, with logits for ``logit_rows`` rows."""
    return (batch * (2 * matmul_params(spec) * n + attention_flops(spec, start, n))
            + 2 * spec["d_model"] * spec["vocab"] * logit_rows)


def generation_flops(spec: dict, batch: int, prompt: int, out: int) -> int:
    """A request's model FLOPs: the prefill of ``prompt`` tokens (logits for
    the last) and ``out - 1`` decode steps (each token after the first)."""
    return (forward_flops(spec, batch, 0, prompt, batch)
            + sum(forward_flops(spec, batch, prompt + j, 1, batch) for j in range(out - 1)))


def train_flops(spec: dict, rows: int, seq: int) -> int:
    """A train step's model FLOPs: three times the forward over every
    position (logits for all), the backward's two products a forward
    product; no credit for the recomputed forward."""
    return 3 * forward_flops(spec, rows, 0, seq, rows * seq)
