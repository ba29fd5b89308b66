"""Greedy batched serving on one device.

Counterpart of the JAX package's ``serving/engine.py::ServeSession``.
PyTorch runs eagerly, so there is no compiled-function cache: prefill and
decode are the model's own methods.  The sharded paths wait for the
distributed slice (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import Model, resolve_device


@dataclasses.dataclass
class ServeSession:
    """Greedy batched decoding session over ``model`` (either family) on
    ``device``."""
    model: Model
    max_seq: int = 128
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.model.device != self.device:
            raise ValueError(f"model lives on {self.model.device}, session "
                             f"asked for {self.device}")

    @torch.no_grad()
    def generate(self, prompts, steps: int) -> torch.Tensor:
        """prompts: [B, S] int -> generated tokens [B, steps] (int32)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, s = prompts.shape
        if s + steps > self.max_seq:
            raise ValueError(f"prompt {s} + steps {steps} exceeds max_seq "
                             f"{self.max_seq}")
        state = self.model.init_decode_state(b, self.max_seq)
        logits, state = self.model.prefill(prompts, state)
        outs = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(steps):
            outs.append(tok)
            logits, state = self.model.decode_step(tok, state)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(outs, dim=1)
