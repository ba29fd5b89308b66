"""Serving substrate of the port: greedy batched prefill/decode, plus the
simulated contention-aware batcher over the RASA chip model
(:mod:`repro_torch.serving.simbatch`)."""

from .engine import ServeSession
from .simbatch import (POLICIES, BatchReport, ServeRequest, model_trace,
                       run_batcher, skewed_trace, synthetic_trace)

__all__ = ["ServeSession", "POLICIES", "BatchReport", "ServeRequest",
           "run_batcher", "model_trace", "skewed_trace", "synthetic_trace"]
