"""Fault-tolerant training driver (port of ``repro.runtime.driver``):
checkpoint/restart + watchdog + resume.

The driver owns the outer loop: deterministic data by step number, each
batch moved to the model's device, periodic atomic checkpoints, straggler
accounting, and crash recovery: ``run`` can be killed at any step and
re-invoked; it resumes from the latest checkpoint bit-exactly (tested). A
``fault_injector`` hook lets tests kill the loop at a chosen step. The
step's ``float(metrics["loss"])`` is its sync point: the step time the
watchdog reads ends when the device has finished the step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokenDataset
from repro_torch.models import build_model
from repro_torch.train import init_train_state, move_batch

from .watchdog import StepWatchdog


class InjectedFault(RuntimeError):
    pass


@dataclass
class TrainDriver:
    model: object
    optimizer: object
    train_step: Callable           # (state, batch) -> (state, metrics)
    dataset: SyntheticTokenDataset
    ckpt: CheckpointManager
    total_steps: int
    watchdog: StepWatchdog = field(default_factory=StepWatchdog)
    fault_injector: Callable[[int], None] | None = None
    log_every: int = 10

    def init_or_restore(self, generator=0, shardings=None):
        """Fresh state, or the latest checkpoint if one exists (its
        structure from the same model built on the ``meta`` device)."""
        start = self.ckpt.latest_step()
        if start is None:
            state = init_train_state(self.model, self.optimizer, generator)
            return state, 0
        like = init_train_state(build_model(self.model.cfg, device="meta"),
                                self.optimizer)
        state, manifest = self.ckpt.restore_latest(
            like, shardings, device=self.model.device)
        return state, int(manifest["step"])

    def run(self, generator=0, shardings=None) -> dict:
        state, start = self.init_or_restore(generator, shardings)
        history = []
        for step in range(start, self.total_steps):
            if self.fault_injector is not None:
                self.fault_injector(step)   # may raise InjectedFault
            batch = move_batch(self.dataset.batch(step), self.model.device)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report = self.watchdog.record(step, dt)
            history.append({"step": step, "loss": loss, "s": dt,
                            "straggle": bool(report)})
            if self.ckpt.should_save(step + 1):
                self.ckpt.save(step + 1, state,
                               {"loss": loss})
            if step % self.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"dt={dt*1e3:.0f}ms")
        final = self.ckpt.save(self.total_steps, state, {"final": True})
        return {"state": state, "history": history,
                "final_checkpoint": str(final),
                "stragglers": [r.__dict__ for r in self.watchdog.reports],
                "suspects": self.watchdog.suspects()}
