"""Fault-tolerant training loop.  Counterpart of the JAX package's
``training/loop.py``:

  * checkpoint/restart -- async CheckpointManager; on any step failure the
    loop restores the latest checkpoint and continues (bounded retries);
  * straggler watch    -- steps slower than ``straggler_factor`` x the
    running median are logged and counted;
  * elastic restart    -- the step-indexed data pipeline and the resharding
    restore let a resumed run continue on a different mesh;
  * preemption         -- SIGTERM triggers checkpoint-and-exit at the next
    step boundary.

The step updates the state in place (``training.step``), so a failure after
its update began cannot be undone by dropping its result, as the reference
does: the loop then restores the newest checkpoint, and with none to go
back to it raises.  A failure before the update (the batch, the forward,
the backward) leaves the state as it was, and the step is retried from it
when no checkpoint exists, as in the reference.
"""

from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Callable

from ..checkpoint import CheckpointManager, latest_step, restore_into
from .step import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 200
    checkpoint_dir: str = "repro_ckpt"
    keep_checkpoints: int = 3
    max_restarts: int = 3
    straggler_factor: float = 2.0
    log_every: int = 10
    handle_sigterm: bool = False


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.0
    window: int = 64
    times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                is_straggler = True
                self.flagged += 1
        self.times.append(dt)
        if len(self.times) > 4 * self.window:
            del self.times[:-self.window]
        return is_straggler


class TrainLoop:
    def __init__(self, step_fn: Callable, state: TrainState,
                 batch_fn: Callable[[int], Any], cfg: LoopConfig,
                 state_shardings: Any = None,
                 fault_hook: Callable[[int], None] | None = None,
                 log_fn: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.state = state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.state_shardings = state_shardings  # the state's layout (training.step)
        self.fault_hook = fault_hook          # tests inject failures here
        self.log = log_fn
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        self.straggler = StragglerMonitor(cfg.straggler_factor)
        self.metrics_history: list[dict] = []
        self.restarts = 0
        self._preempted = False
        if cfg.handle_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, *_):
        self._preempted = True

    def _current_step(self) -> int:
        return int(self.state.step)

    def _restore(self) -> None:
        """Restore the newest checkpoint into the state, in place (elastic:
        onto the state's current shardings, whatever mesh wrote it)."""
        step = restore_into(self.ckpt.directory, self.state, shardings=self.state_shardings)
        self.log(f"[loop] restored checkpoint at step {step}")

    def run(self) -> TrainState:
        cfg = self.cfg
        step = self._current_step()
        if latest_step(cfg.checkpoint_dir) is not None and step == 0:
            self._restore()
            step = self._current_step()

        while step < cfg.total_steps:
            if self._preempted:
                self.log(f"[loop] SIGTERM: checkpointing at step {step} and exiting")
                self.ckpt.save_async(step, self.state)
                self.ckpt.wait()
                break
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                _, metrics = self.step_fn(self.state, batch)
                # on the host inside the try: asynchronous device errors surface here
                loss = float(metrics["loss"])
            except Exception as e:  # noqa: BLE001 -- any step fault
                self.restarts += 1
                self.log(f"[loop] step {step} failed ({type(e).__name__}: {e}); "
                         f"restart {self.restarts}/{cfg.max_restarts}")
                if self.restarts > cfg.max_restarts:
                    raise
                if latest_step(cfg.checkpoint_dir) is not None:
                    self._restore()
                    step = self._current_step()
                elif self._current_step() != step:
                    raise RuntimeError(f"step {step} failed after its in-place update "
                                       "began, and no checkpoint exists to restore") from e
                continue

            dt = time.perf_counter() - t0
            if self.straggler.observe(dt):
                self.log(f"[loop] straggler step {step}: {dt*1e3:.1f} ms "
                         f"(flagged {self.straggler.flagged} so far)")
            self.metrics_history.append({"step": step, "loss": loss, "time_s": dt})
            if step % cfg.log_every == 0:
                self.log(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            step += 1
            if step % cfg.checkpoint_every == 0 or step == cfg.total_steps:
                self.ckpt.save_async(step, self.state)

        self.ckpt.wait()
        return self.state
