"""Composable training-loop callbacks (port of ``repro.train.callbacks``):
``Callback``, ``LoggingCallback`` (history records, throughput and model
TFLOP/s under the 3x convention) and ``EvalCallback``. The checkpoint
callback and the anomaly supervisor's rollback wait for checkpointing
(ROADMAP queue 1 item 7).

Hook order per step: ``on_step_end(trainer, step, metrics, dt)`` with the
1-based global step and ``dt`` the host wall time of the step, which ends
in a device-to-host read of the loss.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np


class Callback:
    def on_run_begin(self, trainer) -> None:  # noqa: D102
        pass

    def on_step_end(self, trainer, step: int, metrics, dt: float) -> None:  # noqa: D102
        pass

    def on_run_end(self, trainer) -> None:  # noqa: D102
        pass


class LoggingCallback(Callback):
    """History records + throughput accounting. ``ms_per_step_steady``
    leaves out the run's first step (kernel builds, allocator warm-up);
    ``wall_total_s`` is the whole run. ``model_tflops_per_sec`` counts 3x
    the forward's model FLOPs per token (forward + backward, the paper's and
    Megatron's convention); the recompute of remat and of the backward
    kernels is not counted, so it never inflates the figure."""

    def __init__(self, log: Callable = print, log_every: int = 10):
        self.log, self.log_every = log, log_every
        self.durations: List[float] = []

    def on_run_begin(self, trainer):
        self.durations = []
        tokens_per_step = trainer.tcfg.global_batch * trainer.tcfg.seq_len
        self._flops_per_step = 3 * trainer.cfg.flops_per_token(trainer.tcfg.seq_len) * tokens_per_step

    def _steady(self) -> float:
        d = self.durations
        return float(np.mean(d[1:])) if len(d) > 1 else d[0]

    def on_step_end(self, trainer, step, metrics, dt):
        self.durations.append(dt)
        i = len(self.durations)
        if not (i == 1 or i % self.log_every == 0):
            return
        steady = self._steady()
        rec = {
            "step": step,
            **{k: float(v) for k, v in metrics.items()},
            "sec_per_step": steady,
            "ms_per_step_steady": steady * 1e3,
            "wall_total_s": float(np.sum(self.durations)),
            "model_tflops_per_sec": self._flops_per_step / steady / 1e12,
        }
        trainer.history.append(rec)
        self.log(
            f"step {rec['step']:5d} loss {rec['loss']:.4f} ce {rec['ce']:.4f} "
            f"lr {rec['lr']:.2e} gnorm {rec['grad_norm']:.2f} "
            f"{rec['ms_per_step_steady']:.0f} ms/step (steady)"
        )


class EvalCallback(Callback):
    """Periodic held-out CE on the blend's eval stream (fresh sample seed)."""

    def __init__(self, every: int, batches: int = 4, log: Callable = print):
        self.every, self.batches, self.log = every, batches, log

    def on_step_end(self, trainer, step, metrics, dt):
        if not self.every or step % self.every:
            return
        ce = trainer.eval_loss(batches=self.batches)
        trainer.history.append({"step": step, "eval_ce": ce})
        self.log(f"step {step:5d} eval ce {ce:.4f}")
