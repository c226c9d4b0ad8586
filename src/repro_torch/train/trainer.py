"""Fault-tolerant training loop (the reference's ``train/trainer.py``).

  * auto-resume: picks up the latest complete checkpoint in ckpt_dir.
  * async checkpointing every ``ckpt_every`` steps (atomic, keep-N).
  * NaN guard: a non-finite loss rolls the state back to the last
    checkpoint (or to init) and resumes from there; the data stream is a
    pure function of the step, so it replays identically.
  * straggler monitor: a step slower than ``straggler_factor`` x the
    running median of the last 20 is logged as an event.

One host readback a step: the loss, which the NaN guard needs.

With a live ``mesh`` the trainer runs the sharded step
(``launch/steps.make_train_step(..., mesh=)``) over a state of DTensor
blocks, on the data's rows (``SyntheticLMData(..., mesh=)``); every
process runs the same loop, process 0 writes the checkpoints, and the
loss every process reads is the global batch's, so all take the same
branches.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.launch.steps import init_state, make_train_step
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup: int = 10
    straggler_factor: float = 2.0
    seed: int = 0


class Trainer:
    def __init__(self, md, cfg, data, tcfg: TrainerConfig, device="cuda",
                 mesh=None):
        self.md, self.cfg, self.data, self.tcfg = md, cfg, data, tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.step_fn, self.opt = make_train_step(
            md, cfg, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
            total_steps=tcfg.total_steps, mesh=mesh,
            row_axes=getattr(data, "row_axes", None))
        self.ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.metrics_log = []
        self.events = []  # (step, kind, detail): stragglers, rollbacks, ...

    # ------------------------------------------------------------------
    def init_state(self):
        return init_state(self.cfg, self.opt, seed=self.tcfg.seed,
                          device=self.device, mesh=self.mesh)

    def restore_or_init(self):
        state = self.init_state()
        if latest_step(self.tcfg.ckpt_dir) is None:
            return state, 0
        state, step = restore_checkpoint(self.tcfg.ckpt_dir, state)
        self.events.append((step, "resume", f"restored step_{step}"))
        return state, step

    # ------------------------------------------------------------------
    def run(self, until: int | None = None):
        """Train from the latest checkpoint (or init) to step ``until``
        (default ``total_steps``, which also sets the lr schedule)."""
        state, step = self.restore_or_init()
        times = []
        until = self.tcfg.total_steps if until is None else until
        while step < until:
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # blocks
            dt = time.perf_counter() - t0

            # --- straggler detection ---
            if len(times) >= 5:
                med = statistics.median(times[-20:])
                if dt > self.tcfg.straggler_factor * med:
                    self.events.append(
                        (step, "straggler", f"{dt:.3f}s vs median {med:.3f}s"))
            times.append(dt)

            # --- NaN guard with checkpoint rollback ---
            if not math.isfinite(loss):
                self.events.append((step, "rollback", f"loss={loss}"))
                self.ckpt.wait()
                if latest_step(self.tcfg.ckpt_dir) is None:
                    state, step = self.init_state(), 0
                else:
                    state, step = restore_checkpoint(self.tcfg.ckpt_dir,
                                                     state)
                continue

            step += 1
            if step % self.tcfg.log_every == 0 or step == until:
                self.metrics_log.append(
                    {"step": step, "loss": loss,
                     "lr": float(metrics["lr"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "step_time_s": dt})
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(state, step)
        self.ckpt.wait()
        return state
