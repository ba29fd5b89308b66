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
path.

Inside an active ``distributed.mesh_context`` the session takes the
sharded steps, ``jit_prefill`` / ``jit_decode_step``: the model's
parameters distributed by ``_params_shardings`` (``serve_param_sharding``
"tp" drops FSDP), the decode state by ``decode_state_shardings`` (its KV
caches written on each rank's shards), the tokens batch over DP.  The
first step fixes the session's context, no mesh or (mesh, parallel): a
meshed step distributes the model's own parameters in place, so a step
under any other context raises.  Its states, graphs and steps are keyed
on the batch under that context, as the reference's compiled functions
are on (batch, mesh, parallel).  Logits come back gathered, as plain
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..distributed.sharding import (MeshContext, NamedSharding, activation_spec,
                                    current_ctx, distribute, full, shardings_for)
from ..distributed.sharding import decode_state_shardings  # noqa: F401 -- the reference's name
from ..models import Model, resolve_device
from ..models.transformer import token_shape


def _params_shardings(model: Model, ctx: MeshContext) -> dict:
    """Distribute the model's parameters for serving (in place) and return
    {name: NamedSharding}: the training layout, or with
    ``serve_param_sharding="tp"`` TP only (no FSDP gathers per step)."""
    if model.cfg.parallel.serve_param_sharding == "tp":
        ctx = MeshContext(mesh=ctx.mesh,
                          parallel=dataclasses.replace(ctx.parallel, fsdp=False))
    return shardings_for(model, ctx)


def _token_sharding(ctx: MeshContext, shape) -> NamedSharding:
    """Tokens batch over DP (when the batch divides): a prompt [B, S(, cb)]
    or a decode step's [B(, cb)]."""
    return NamedSharding(ctx.mesh, activation_spec("tokens", ctx, tuple(shape)))


def jit_prefill(model: Model, ctx: MeshContext) -> Callable:
    """The sharded prefill: (tokens, state) -> (logits, state), with the
    parameters distributed (``_params_shardings``), the tokens placed batch
    over DP and the state as ``init_decode_state`` made it under ``ctx``."""
    _params_shardings(model, ctx)

    def prefill(tokens, state):
        return model.prefill(distribute(tokens, _token_sharding(ctx, tokens.shape)), state)
    return prefill


def jit_decode_step(model: Model, ctx: MeshContext) -> Callable:
    """The sharded decode step: (token, state) -> (logits, state), placed
    as ``jit_prefill``."""
    _params_shardings(model, ctx)

    def decode_step(token, state):
        return model.decode_step(distribute(token, _token_sharding(ctx, token.shape)), state)
    return decode_step


_NO_STEP = object()   # a session's context before its first step


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
    #: static decode state and token buffer per batch
    _slots: dict = dataclasses.field(default_factory=dict, repr=False)
    #: (prefill, decode_step) per batch
    _fns_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    #: static prompt buffer per (batch, prompt length)
    _prompts: dict = dataclasses.field(default_factory=dict, repr=False)
    _graphs: dict = dataclasses.field(default_factory=dict, repr=False)
    _pool: object = dataclasses.field(default=None, repr=False)
    _batch: int | None = dataclasses.field(default=None, repr=False)
    #: the context of the first step: (mesh, parallel), or None for no mesh
    _mesh: object = dataclasses.field(default=_NO_STEP, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.model.device != self.device:
            raise ValueError(f"model lives on {self.model.device}, session "
                             f"asked for {self.device}")

    @property
    def graphed(self) -> bool:
        """Whether the steps replay CUDA graphs (a CUDA device, not eager)."""
        return self.device.type == "cuda" and not self.eager

    def _check_mesh(self) -> None:
        """Fix the session's context at its first step; raise under another."""
        ctx = current_ctx()
        key = None if ctx is None else (ctx.mesh, ctx.parallel)
        if self._mesh is _NO_STEP:
            self._mesh = key
        elif self._mesh != key:
            raise RuntimeError(
                "ServeSession: a step under another mesh context than its first "
                f"({'no mesh' if self._mesh is None else self._mesh}): a meshed "
                "step distributes the model's parameters in place; make a session "
                "(and a model) for each context")

    def _fns(self, batch: int):
        """(prefill, decode_step) for ``batch`` under the session's mesh
        (the model's own steps without one), made once per batch."""
        fns = self._fns_cache.get(batch)
        if fns is None:
            ctx = current_ctx()
            fns = ((self.model.prefill, self.model.decode_step) if ctx is None else
                   (jit_prefill(self.model, ctx), jit_decode_step(self.model, ctx)))
            self._fns_cache[batch] = fns
        return fns

    def _slot(self, batch: int):
        """(state, token buffer) of ``batch``, made on first use; the buffer
        is [B], or [B, n_codebooks] for the audio family."""
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
        self._check_mesh()
        prefill, decode = self._fns(b)
        state, token = self._slot(b)
        self._batch = b
        if not self.graphed:
            state.zero_()
            return full(prefill(prompts, state)[0])
        buf = self._prompts.get((b, s))
        if buf is None:
            buf = self._prompts[(b, s)] = torch.zeros(
                prompts.shape, dtype=prompts.dtype, device=self.device)
        cfg = self.model.cfg
        self._capture(("prefill", b, s, cfg), lambda: prefill(buf, state)[0])
        self._capture(("decode", b, cfg), lambda: decode(token, state)[0])
        buf.copy_(prompts)
        state.zero_()
        return full(self._graphs[("prefill", b, s, cfg)].replay())

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
        self._check_mesh()
        state, token = self._slot(b)
        if not self.graphed:
            return full(self._fns(b)[1](tokens, state)[0])
        graph = self._graphs.get(("decode", b, self.model.cfg))
        if graph is None:
            raise RuntimeError("the model's config changed after prefill: "
                               "no decode step was captured under it")
        token.copy_(tokens)
        return full(graph.replay())

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
