"""Greedy batched serving on one device.

Counterpart of the JAX package's ``serving/engine.py::ServeSession``, whose
``_fns`` compiles ``prefill`` and ``decode_step`` once per batch size.
Here, on a CUDA device, the session captures each in a CUDA graph once per
key and replays it: ``decode_step`` per (batch, model config), ``prefill``
per (batch, prompt length, model config).  The key holds the model's whole
``RunConfig``, so a graph captured under one engine never replays under
another.  The graphs read and write one static state per batch size and
static token and prompt buffers, which each call fills in place; every
graph of a session allocates from one memory pool.  On the CPU, or with
``eager=True``, the same steps run eagerly on the same static state.  A
capture or a replay that fails raises: there is no fallback to the eager
path.  The sharded paths wait for the distributed slice (ROADMAP queue 1,
item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import Model, resolve_device
from ..models.transformer import token_shape


@dataclasses.dataclass
class _Graph:
    """A captured step: replay() re-runs it; ``out`` is its output tensor,
    rewritten by every replay."""
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out


@dataclasses.dataclass
class ServeSession:
    """Greedy batched decoding session over ``model`` (either family) on
    ``device``; ``eager=True`` runs a CUDA session without graphs."""
    model: Model
    max_seq: int = 128
    device: str | torch.device = "cuda"
    eager: bool = False
    #: static decode state and token buffer per batch size
    _slots: dict = dataclasses.field(default_factory=dict, repr=False)
    #: static prompt buffer per (batch, prompt length)
    _prompts: dict = dataclasses.field(default_factory=dict, repr=False)
    _graphs: dict = dataclasses.field(default_factory=dict, repr=False)
    _pool: object = dataclasses.field(default=None, repr=False)
    _batch: int | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.model.device != self.device:
            raise ValueError(f"model lives on {self.model.device}, session "
                             f"asked for {self.device}")

    @property
    def graphed(self) -> bool:
        """Whether the steps replay CUDA graphs (a CUDA device, not eager)."""
        return self.device.type == "cuda" and not self.eager

    def _slot(self, batch: int):
        """(state, token buffer) of ``batch``, made on first use; the
        buffer is [B], or [B, n_codebooks] for the audio family."""
        slot = self._slots.get(batch)
        if slot is None:
            slot = (self.model.init_decode_state(batch, self.max_seq),
                    torch.zeros(token_shape(self.model.model, batch), dtype=torch.int32,
                                device=self.device))
            self._slots[batch] = slot
        return slot

    def _capture(self, key, fn: Callable[[], torch.Tensor]) -> None:
        """Capture ``fn`` under ``key`` unless done, after one warm-up call
        on a side stream (the first launch of a kernel builds it and sets
        its attributes, which a capture may not do).  The warm-up writes
        the static state: the caller zeroes it before the first replay."""
        if key in self._graphs:
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        self._graphs[key] = _Graph(graph, out)

    @torch.no_grad()
    def prefill(self, prompts) -> torch.Tensor:
        """Start a generation: the state of this batch size zeroed, then
        the prompts [B, S] (audio: [B, S, n_codebooks]) through the model;
        returns the last position's logits [B, V] (audio: [B, n_codebooks,
        V]; graphed: a static buffer, rewritten by the next
        replay of this prefill).  Graphed, the first prefill of a key
        captures it and this batch's decode step."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s = prompts.shape[:2]
        if s > self.max_seq:
            raise ValueError(f"prompt {s} exceeds max_seq {self.max_seq}")
        state, token = self._slot(b)
        self._batch = b
        if not self.graphed:
            state.zero_()
            return self.model.prefill(prompts, state)[0]
        buf = self._prompts.get((b, s))
        if buf is None:
            buf = self._prompts[(b, s)] = torch.zeros(
                prompts.shape, dtype=prompts.dtype, device=self.device)
        cfg = self.model.cfg
        self._capture(("prefill", b, s, cfg), lambda: self.model.prefill(buf, state)[0])
        self._capture(("decode", b, cfg), lambda: self.model.decode_step(token, state)[0])
        buf.copy_(prompts)
        state.zero_()
        return self._graphs[("prefill", b, s, cfg)].replay()

    @torch.no_grad()
    def decode_step(self, tokens) -> torch.Tensor:
        """One greedy step after ``prefill``: tokens [B] (audio: [B,
        n_codebooks]) -> logits [B, V] (audio: [B, n_codebooks, V]; graphed:
        a static buffer, rewritten by the next step)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        if b != self._batch:
            raise ValueError(f"decode_step of batch {b} after a prefill of "
                             f"batch {self._batch}")
        state, token = self._slot(b)
        if not self.graphed:
            return self.model.decode_step(tokens, state)[0]
        graph = self._graphs.get(("decode", b, self.model.cfg))
        if graph is None:
            raise RuntimeError("the model's config changed after prefill: "
                               "no decode step was captured under it")
        token.copy_(tokens)
        return graph.replay()

    @torch.no_grad()
    def generate(self, prompts, steps: int) -> torch.Tensor:
        """prompts: [B, S] int -> generated tokens [B, steps] (int32); audio:
        [B, S, n_codebooks] -> [B, steps, n_codebooks].  The prompt and the
        steps must fit ``max_seq``: the model itself computes past it, as
        the reference does (the cache's last slot is rewritten), but a
        generation that needs it is refused here."""
        prompts = torch.as_tensor(prompts, device=self.device)
        s = prompts.shape[1]
        if s + steps > self.max_seq:
            raise ValueError(f"prompt {s} + steps {steps} exceeds max_seq "
                             f"{self.max_seq}")
        logits = self.prefill(prompts)
        outs = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(steps):
            outs.append(tok)
            logits = self.decode_step(tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(outs, dim=1)
