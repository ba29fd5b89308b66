"""Deterministic synthetic LM data pipeline: the port's copy of the JAX
package's ``data/pipeline.py`` (pure numpy; batches equal the reference's
bit for bit, held so by ``tests/test_torch_train_substrate.py``).

Step-indexed and stateless: batch(step) is a pure function of (seed, step),
so a restarted/elastically-resized job resumes mid-stream with no data
skips or repeats -- the property the fault-tolerance tests assert.  Tokens
follow a Zipf-ish distribution with short-range structure (a Markov-y mix)
so losses actually decrease during the example runs.

Per-host sharding: each host materializes only its slice of the global
batch (process_index-based), matching multi-host TPU input pipelines.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def _tokens(self, step: int, extra: int = 0) -> np.ndarray:
        """[host_batch, seq_len + 1 + extra] int32 (shift -> inputs/labels)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s = self.host_batch, self.seq_len + 1 + extra
        v = self.cfg.vocab
        # Zipf base distribution
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        base = np.clip(base, 1, v - 1)
        # short-range structure: with p=0.35, copy the previous token + 1
        copy = rng.random((b, s)) < 0.35
        out = base.copy()
        for i in range(1, s):
            out[:, i] = np.where(copy[:, i], (out[:, i - 1] + 1) % v,
                                 out[:, i])
        return out.astype(np.int32)

    def batch(self, step: int) -> dict:
        m = self.cfg
        toks = self._tokens(step)
        if m.family == "audio":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, self.host_id, 7]))
            t = rng.integers(0, m.vocab,
                             (self.host_batch, self.seq_len + 1,
                              m.n_codebooks)).astype(np.int32)
            return {"tokens": t[:, :-1], "labels": t[:, 1:]}
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if m.family == "vlm":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, self.host_id, 11]))
            batch["patch_embeds"] = rng.normal(
                size=(self.host_batch, 8, m.d_model)).astype(np.float32)
        return batch


def make_batch_iterator(dataset: SyntheticLMDataset, start_step: int = 0):
    step = start_step
    while True:
        yield step, dataset.batch(step)
        step += 1
