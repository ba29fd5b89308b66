"""Chip-level load models: the epoch token bucket and its static-share form.

Counterpart of the JAX package's ``multicore/chip.py``, for now only its two
load models, which the simulator's fast lanes describe with
:class:`repro_torch.core.fastsim.StreamModelParams`:

``EpochBandwidthLoadModel``
    A token bucket under a piecewise-constant per-epoch share schedule
    (the ``arbitration="epoch"`` model of a chip's shared memory system).
``SharedBandwidthLoadModel``
    The same bucket with one constant share (``arbitration="static"``).

With them ``StreamModelParams.from_model`` and ``make_model`` are whole, and
:class:`repro_torch.core.timing.PipelineSimulator` serves as the exactness
oracle under a token bucket.  ``ChipConfig``, ``CoreCluster`` and
``simulate_chip`` (the arbiter's closed-batch client) come with the port of
``multicore/jitarb.py`` (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import math
from typing import Sequence

from ..core.timing import LoadStreamModel


class EpochBandwidthLoadModel(LoadStreamModel):
    """Token-bucket arbiter under a piecewise-constant share schedule.

    ``shares[e]`` is this core's bytes/cycle allowance during epoch ``e``
    (the interval ``[e * epoch_cycles, (e+1) * epoch_cycles)``); epochs past
    the end of the schedule run at ``tail_share`` (the cluster passes the
    full chip budget there: by construction every other core has drained by
    then).  Unused allowance accumulates only up to ``burst_bytes`` -- a core
    cannot bank unbounded credit and replay it later -- which is what makes
    the per-epoch conservation property hold:

        bytes granted per epoch  <=  share * epoch_cycles + burst_bytes
                                     + one in-flight tile

    (the tile term covers the single grant that straddles the epoch edge;
    asserted by ``tests/test_multicore.py``).  A request larger than the
    bucket capacity is granted once the bucket is full and leaves the token
    count negative (debt repaid by subsequent refill), so any tile size
    works with any ``burst_bytes`` including 0.
    """

    def __init__(self, load_ports: int, shares: Sequence[float],
                 epoch_cycles: float, tail_share: float,
                 burst_bytes: float = 16384.0,
                 store_ports: int | None = None,
                 charge_store_bytes: bool = False,
                 record_grants: bool = False):
        if epoch_cycles <= 0:
            raise ValueError("epoch_cycles must be > 0")
        self.shares = tuple(shares)
        self.epoch_cycles = epoch_cycles
        self.tail_share = tail_share
        self._schedule_end = len(self.shares) * epoch_cycles if shares else 0.0
        self.burst_bytes = burst_bytes
        self.charge_store_bytes = charge_store_bytes
        self.record_grants = record_grants
        super().__init__(load_ports, store_ports)

    def reset(self) -> None:
        super().reset()
        self._tokens = self.burst_bytes
        self._t = 0.0           # bucket time: refills are settled up to here
        #: (start, n_bytes) of every granted access, when record_grants.
        self.grants: list[tuple[float, int]] = []

    def _share_at(self, t: float) -> float:
        e = int(t // self.epoch_cycles)
        return self.shares[e] if e < len(self.shares) else self.tail_share

    def _advance(self, t: float) -> None:
        """Settle refills from the bucket time up to ``t`` (capped)."""
        while self._t < t:
            rate = self._share_at(self._t)
            if self._t >= self._schedule_end:
                step_end = t        # constant tail rate: one jump
            else:
                e_end = ((int(self._t // self.epoch_cycles) + 1)
                         * self.epoch_cycles)
                step_end = min(t, e_end)
            if math.isinf(rate):
                self._tokens = self.burst_bytes
            else:
                self._tokens = min(self.burst_bytes,
                                   self._tokens + rate * (step_end - self._t))
            self._t = step_end

    def _grant(self, t_earliest: float, n_bytes: int) -> float:
        """Earliest start >= ``t_earliest`` at which ``n_bytes`` is granted,
        consuming the tokens.  Requests behind the bucket time (out-of-order
        stores, whose ready times are not monotone in issue order) are
        served from the current bucket state without rewinding it."""
        self._advance(t_earliest)
        need = min(float(n_bytes), self.burst_bytes)
        if self._tokens >= need:
            start = t_earliest
        else:
            t, tokens = self._t, self._tokens
            schedule_end = self._schedule_end
            while True:
                rate = self._share_at(t)
                if math.isinf(rate):
                    start = t
                    break
                if rate <= 0.0 and t >= schedule_end:
                    raise RuntimeError("tail share must be > 0: request can "
                                       "never be granted")
                e_end = (int(t // self.epoch_cycles) + 1) * self.epoch_cycles
                if rate > 0.0:
                    t_hit = t + (need - tokens) / rate
                    if t_hit <= e_end or t >= schedule_end:
                        start = t_hit
                        break
                    tokens += rate * (e_end - t)
                t = e_end
            start = max(start, t_earliest)
        self._advance(start)
        self._tokens -= n_bytes
        if self.record_grants:
            self.grants.append((start, n_bytes))
        return start

    def acquire(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        port_start = max(t_request, self._next_free)
        start = self._grant(port_start, n_bytes)
        self._next_free = start + 1.0 / self.load_ports
        self.last_grant = max(self.last_grant, start)
        return start, start - port_start

    def acquire_store(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        if self.store_ports is None:
            return t_request, 0.0
        port_start = max(t_request, self._store_next_free)
        if self.charge_store_bytes:
            start = self._grant(port_start, n_bytes)
        else:
            start = port_start
        self._store_next_free = start + 1.0 / self.store_ports
        self.last_grant = max(self.last_grant, start)
        return start, start - port_start


class SharedBandwidthLoadModel(EpochBandwidthLoadModel):
    """Constant-share token bucket: the ``arbitration="static"`` model.

    The frozen-share baseline: one share for the whole run, i.e. an
    :class:`EpochBandwidthLoadModel` with an empty schedule and
    ``tail_share=bytes_per_cycle``.  Sharing the exact bucket semantics with
    the epoch model matters: the dynamic schedule's shares dominate the
    static share pointwise in time, so with identical bucket mechanics the
    dynamic makespan provably never exceeds the static one.  A load of
    ``n_bytes`` requested at ``t`` may start once (i) a load port slot is
    free and (ii) ``n_bytes`` tokens are available (refill ``share`` per
    cycle, capped at ``burst_bytes``).  With ``share == inf`` this reduces
    exactly to the base port model.
    """

    def __init__(self, load_ports: int, bytes_per_cycle: float,
                 burst_bytes: float = 16384.0,
                 store_ports: int | None = None,
                 charge_store_bytes: bool = False):
        self.bytes_per_cycle = bytes_per_cycle
        super().__init__(load_ports, shares=(), epoch_cycles=math.inf,
                         tail_share=bytes_per_cycle, burst_bytes=burst_bytes,
                         store_ports=store_ports,
                         charge_store_bytes=charge_store_bytes)
