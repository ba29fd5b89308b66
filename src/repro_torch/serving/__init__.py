"""Serving substrate of the port: greedy batched prefill/decode (sharded
under a mesh context) and sequence-parallel decode, plus the simulated
contention-aware batcher over the RASA chip model
(:mod:`repro_torch.serving.simbatch`)."""

from .engine import ServeSession, decode_state_shardings, jit_decode_step, jit_prefill
from .simbatch import (POLICIES, BatchReport, ServeRequest, model_trace,
                       run_batcher, skewed_trace, synthetic_trace)
from .sp_decode import sp_flash_decode

__all__ = ["ServeSession", "decode_state_shardings", "jit_decode_step", "jit_prefill",
           "sp_flash_decode", "POLICIES", "BatchReport", "ServeRequest", "run_batcher",
           "model_trace", "skewed_trace", "synthetic_trace"]
