"""granite-moe-3b-a800m's plain reference
(``bench/configs/granite-moe-3b-a800m.json``): the decoder of ``common.py``
with 40 routed experts, top 8, under the port's capacity-limited grouped
dispatch.  The groups hold tokens of several rows, so a row's answer
depends on the rows beside it: the served tokens are checked step by step
over the whole batch, the prompts first and then one position a call, as
the server ran them.  The file lists where this departs from the published
model (no embedding, attention, residual or logits multipliers; an untied
head; a capacity where the published model drops nothing)."""

from .common import Reference, served_logits, token_gaps  # noqa: F401

STEP_BY_STEP = True
