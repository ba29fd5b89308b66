"""The traffic generators, one a driver kind, reading the parameters of a
mix (``bench/traffic/<mix>.json``) and drawing everything from the seed.

Every seed gets the same work in another order: a mix's lengths form a
fixed cycle (each prompt length by its weight, crossed with each output
length by its weight), and the seed permutes each cycle and draws the
token ids.  So runs with different seeds differ in order and content, not
in the sizes they send.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .weights import sub_seed

#: sub-streams of the seed
ORDER_STREAM, TOKENS_STREAM, SAMPLE_STREAM, TRAIN_STREAM = 2, 3, 4, 5


@dataclasses.dataclass(frozen=True)
class Request:
    """A request of the serving mixes: ``batch`` prompts of ``prompt_len``
    tokens, each answered with ``out_len`` greedy tokens."""
    index: int
    batch: int
    prompt_len: int
    out_len: int


def _multiset(weights: dict) -> list[int]:
    return [int(k) for k, w in weights.items() for _ in range(int(w))]


def cycle(mix: dict) -> list[tuple[int, int]]:
    """The (prompt length, output length) pairs of one cycle, unordered."""
    return [(p, o) for p in _multiset(mix["prompt_len"]) for o in _multiset(mix["output_len"])]


def requests(mix: dict, seed: int):
    """The requests of a serving mix, endlessly: cycle after cycle, each in
    an order drawn from the seed.  One client in a closed loop is the only
    arrival process this generator makes."""
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError(f"the serving generator runs one closed-loop client, not {mix}")
    rng = np.random.default_rng(sub_seed(seed, ORDER_STREAM))
    pairs = cycle(mix)
    index = 0
    while True:
        for j in rng.permutation(len(pairs)):
            p, o = pairs[j]
            yield Request(index, mix["batch"], p, o)
            index += 1


def longest(mix: dict) -> tuple[int, int]:
    """The pair of the cycle with the most tokens (prompt and output)."""
    return max(cycle(mix), key=lambda po: (po[0] + po[1], po[1]))


def prompt(req: Request, vocab: int, seed: int, device) -> torch.Tensor:
    """The prompts of ``req``: [batch, prompt_len] int32 token ids uniform
    over the vocabulary, from the seed and the request's index alone."""
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, TOKENS_STREAM * 2**20 + req.index))
    return torch.randint(0, vocab, (req.batch, req.prompt_len), generator=gen,
                         device=device, dtype=torch.int32)


def zipf_tokens(rows: int, seq: int, vocab: int, seed: int, step: int) -> np.ndarray:
    """[rows, seq + 1] int32 token ids of a training step: a Zipf draw
    (exponent 1.3, clipped to the vocabulary) in which each position copies
    its predecessor plus one with probability 0.35, so that the text has
    short-range structure a model can learn."""
    rng = np.random.default_rng(np.random.SeedSequence([sub_seed(seed, TRAIN_STREAM), step]))
    base = np.clip(rng.zipf(1.3, size=(rows, seq + 1)), 1, vocab - 1).astype(np.int64)
    copy = rng.random((rows, seq + 1)) < 0.35
    out = base
    for i in range(1, seq + 1):
        out[:, i] = np.where(copy[:, i], (out[:, i - 1] + 1) % vocab, out[:, i])
    return out.astype(np.int32)


def train_batch(mix: dict, vocab: int, seed: int, step: int) -> dict[str, np.ndarray]:
    """The host batch of ``step``: tokens and labels [rows, seq] (labels are
    the tokens shifted by one)."""
    t = zipf_tokens(mix["rows"], mix["seq_len"], vocab, seed, step)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}
