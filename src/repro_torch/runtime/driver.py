"""Fault-tolerant training driver: checkpoint-restart, signal handling,
failure injection, straggler hooks (port of the JAX package's
``runtime/driver.py``, single device).

Contract:
  * every ``ckpt_every`` steps a checkpoint is written (async, atomic);
  * SIGTERM/SIGINT triggers a final checkpoint before exit (preemption);
  * on construction the driver resumes from the latest checkpoint and
    fast-forwards the data pipeline to the right step (deterministic data);
  * ``inject_failure_at`` simulates a node crash for tests (raises after
    the checkpoint barrier, so restart must recover bit-exact state);
  * per-step wall times feed the StragglerDetector.
A step's wall time ends with ``torch.cuda.synchronize()`` when the loss is
on the card (the counterpart of ``jax.block_until_ready``).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.runtime.straggler import StragglerDetector


class SimulatedFailure(RuntimeError):
    pass


def _block_until_ready(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class TrainDriver:
    train_step: Callable                  # (state, batch) -> (state, metrics)
    init_state: Callable[[], object]      # () -> fresh state
    dataset: SyntheticLM
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    put_batch: Optional[Callable] = None  # host batch -> device batch
    inject_failure_at: Optional[int] = None
    n_hosts: int = 1
    _stop: bool = field(default=False, init=False)

    def __post_init__(self):
        self.mgr = CheckpointManager(self.ckpt_dir, keep=self.keep)
        self.detector = StragglerDetector(self.n_hosts)
        self.step_times: list = []

    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True
        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def run(self, total_steps: int, *, log_every: int = 10,
            log_fn=print) -> Dict:
        self._install_signals()
        state = self.init_state()
        start, restored = self.mgr.restore(state)
        step0 = 0
        if restored is not None:
            state = restored
            step0 = start + 1
            log_fn(f"[driver] resumed from checkpoint step {start}")

        metrics = {}
        for step in range(step0, total_steps):
            if self._stop:
                log_fn(f"[driver] signal received; checkpointing at {step - 1}")
                self.mgr.save(step - 1, state)
                self.mgr.wait()
                break
            batch = self.dataset.batch(step)
            if self.put_batch is not None:
                batch = self.put_batch(batch)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            _block_until_ready(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            flagged = self.detector.observe({0: dt})
            if flagged:
                log_fn(f"[driver] stragglers flagged: {sorted(flagged)}")
            if step % log_every == 0:
                log_fn(f"[driver] step {step} loss={float(metrics['loss']):.4f} "
                       f"({dt * 1e3:.0f} ms)")
            if self.ckpt_every and step % self.ckpt_every == 0 and step > step0:
                self.mgr.save(step, state)
            if self.inject_failure_at is not None and step == self.inject_failure_at:
                self.mgr.save(step, state)
                self.mgr.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
        else:
            step = total_steps - 1
            self.mgr.save(step, state)
            self.mgr.wait()
        return {"state": state, "last_step": step, "metrics": metrics,
                "mean_step_s": float(np.mean(self.step_times[1:]))
                if len(self.step_times) > 1 else None}
