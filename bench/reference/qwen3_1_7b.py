"""qwen3-1.7b's plain reference (``bench/configs/qwen3-1.7b.json``): the
dense decoder of ``common.py`` (GQA with RMS-normed queries and keys, RoPE
theta 1e6, SwiGLU, the head tied to the embedding).  Its rows are
independent, so the served tokens are checked by one teacher-forced
forward over each sequence."""

from .common import Reference, served_logits, token_gaps, train_steps  # noqa: F401

STEP_BY_STEP = False
