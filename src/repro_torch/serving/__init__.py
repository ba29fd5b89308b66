"""Serving substrate of the port: greedy batched prefill/decode."""

from .engine import ServeSession

__all__ = ["ServeSession"]
