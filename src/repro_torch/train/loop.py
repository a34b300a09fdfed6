"""Fault-tolerant training loop: checkpoint/restart and a straggler watchdog.

The loop is model-agnostic: it owns ``(state, step)``, calls a
user-supplied ``train_step(state, batch) -> (state, metrics)`` and a data
iterator factory, and adds:

* **checkpoint/restart**: asynchronous checkpoints every ``ckpt_every``
  steps and at the end; on start, ``try_restore`` resumes from the latest
  complete checkpoint (bit-exact: the state, the step and through it the
  data stream's position are all restored);
* **straggler watchdog**: each step's wall time (after the card has
  finished it) against the rolling median; a step slower than
  ``straggler_factor`` x the median records a ``StragglerEvent`` and, under
  the ``raise`` policy, ends the run;
* **fault injection**: tests crash the loop at a given step to exercise
  the restart path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .checkpoint import AsyncCheckpointer, restore_latest
from .tree import tree_leaves

__all__ = ["LoopConfig", "StragglerEvent", "TrainLoop"]


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 32
    straggler_policy: str = "log"  # log | raise


@dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


def _wait_for(state) -> None:
    """Return once the card has finished the step that produced ``state``
    (the counterpart of ``jax.block_until_ready``)."""
    leaves = tree_leaves(state)
    if leaves and torch.is_tensor(leaves[0]) and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class TrainLoop:
    """Drives ``train_step(state, batch) -> (state, metrics)`` to completion."""

    def __init__(
        self,
        cfg: LoopConfig,
        train_step: Callable[[Any, Any], Tuple[Any, Dict]],
        data_iter_factory: Callable[[int], Iterator],
        init_state: Any,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.data_iter_factory = data_iter_factory
        self.state = init_state
        self.step = 0
        self.metrics_history: List[Dict] = []
        self.straggler_events: List[StragglerEvent] = []
        self._step_times: List[float] = []
        self._ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep_checkpoints) if cfg.ckpt_dir else None
        self._fault_at: Optional[int] = None  # test hook

    # -- fault-tolerance plumbing ------------------------------------------

    def try_restore(self) -> bool:
        """Resume from the latest complete checkpoint if one exists."""
        if not self.cfg.ckpt_dir:
            return False
        out = restore_latest(self.cfg.ckpt_dir, self.state)
        if out is None:
            return False
        self.state, manifest = out
        self.step = int(manifest["step"])
        return True

    def inject_fault_at(self, step: int) -> None:
        self._fault_at = step

    def _watchdog(self, duration: float) -> None:
        self._step_times.append(duration)
        window = self._step_times[-self.cfg.straggler_window:]
        if len(window) < 8:
            return
        median = float(np.median(window[:-1]))
        if duration > self.cfg.straggler_factor * median:
            ev = StragglerEvent(step=self.step, duration=duration, median=median)
            self.straggler_events.append(ev)
            if self.cfg.straggler_policy == "raise":
                raise RuntimeError(f"straggler at step {ev.step}: {ev.duration:.3f}s vs median {ev.median:.3f}s")

    # -- main loop ----------------------------------------------------------

    def run(self) -> Any:
        data = self.data_iter_factory(self.step)
        try:
            while self.step < self.cfg.total_steps:
                if self._fault_at is not None and self.step == self._fault_at:
                    self._fault_at = None
                    raise RuntimeError(f"injected fault at step {self.step}")
                batch = next(data)
                t0 = time.monotonic()
                self.state, metrics = self.train_step(self.state, batch)
                _wait_for(self.state)
                self._watchdog(time.monotonic() - t0)
                self.step += 1
                if self.step % self.cfg.log_every == 0:
                    self.metrics_history.append({"step": self.step, **{k: float(v) for k, v in metrics.items()}})
                if self._ckpt and self.step % self.cfg.ckpt_every == 0:
                    self._ckpt.save(self.step, self.state, extra={"step": self.step})
            if self._ckpt:
                self._ckpt.save(self.step, self.state, extra={"step": self.step, "final": True})
        finally:
            # drain the in-flight write on every exit path, so a restart (or
            # a test's teardown) never races a half-written checkpoint
            if self._ckpt:
                self._ckpt.wait()
        return self.state
