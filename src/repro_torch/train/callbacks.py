"""Composable training-loop callbacks (port of ``repro.train.callbacks``):
``Callback``, ``LoggingCallback`` (history records, throughput and model
TFLOP/s under the 3x convention), ``EvalCallback``, ``CheckpointCallback``
(full-state checkpoints through the async manager) and
``AnomalySupervisor`` (skip counting over the in-step guard, and rollback
to the last good checkpoint).

Hook order per step: ``on_step_end(trainer, step, metrics, dt)`` with the
1-based global step and ``dt`` the host wall time of the step, which ends
in a device-to-host read of the loss.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

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


class AnomalySupervisor(Callback):
    """NaN/Inf and loss-spike supervisor over the in-step anomaly guard
    (``make_train_step``), which skips the update, params and optimizer
    state untouched, when the observed loss or grad norm is non-finite or
    the loss exceeds ``trainer.loss_ceiling``. On the host side it:

    * keeps an EMA and variance of the healthy loss and, once
      ``warmup_steps`` healthy steps have seeded them, sets
      ``trainer.loss_ceiling = ema + z_threshold * std + min_spike``;
    * counts consecutive skipped steps as strikes; after ``rollback_after``
      it rolls the TrainState and the data iterator back to the newest
      checkpoint at or before the last healthy step, falling back to older
      ones if that fails verification;
    * records every skip and rollback in ``interventions``, and raises
      :class:`~repro_torch.resilience.TrainingDivergedError` when the
      strike limit hits with no restorable checkpoint.

    Order it AFTER the ``CheckpointCallback`` so that a rollback joins the
    manager's in-flight write first.
    """

    def __init__(
        self,
        ckpt: Optional["CheckpointCallback"] = None,
        rollback_after: int = 3,
        z_threshold: float = 6.0,
        ema_decay: float = 0.9,
        warmup_steps: int = 5,
        min_spike: float = 2.0,
        log: Callable = print,
    ):
        self.ckpt = ckpt
        self.rollback_after = rollback_after
        self.z_threshold = z_threshold
        self.ema_decay = ema_decay
        self.warmup_steps = warmup_steps
        self.min_spike = min_spike
        self.log = log
        self.strikes = 0
        self.skips = 0
        self.rollbacks = 0
        self.interventions: List[Dict] = []
        self._ema = 0.0
        self._var = 0.0
        self._healthy = 0
        self.last_good_step = 0

    def on_run_begin(self, trainer):
        self.strikes = 0
        self.last_good_step = trainer.state.step

    def _ceiling(self) -> float:
        if self._healthy < self.warmup_steps:
            return float("inf")
        return self._ema + self.z_threshold * float(np.sqrt(self._var)) + self.min_spike

    def on_step_end(self, trainer, step, metrics, dt):
        loss = float(metrics["loss"])
        skipped = bool(float(metrics.get("skipped", 0.0)))
        if not skipped:
            self.strikes = 0
            self.last_good_step = step
            d = self.ema_decay if self._healthy else 0.0
            delta = loss - self._ema
            self._ema += (1.0 - d) * delta
            self._var = d * (self._var + (1.0 - d) * delta * delta)
            self._healthy += 1
            trainer.loss_ceiling = self._ceiling()
            return
        self.strikes += 1
        self.skips += 1
        self.interventions.append({"step": step, "kind": "skip", "loss": loss, "strikes": self.strikes})
        self.log(
            f"step {step:5d} ANOMALY loss {loss:.4g} > ceiling {trainer.loss_ceiling:.4g} (or non-finite) — "
            f"update skipped [strike {self.strikes}/{self.rollback_after}]"
        )
        if self.strikes >= self.rollback_after:
            self._rollback(trainer, step)

    def _rollback(self, trainer, step: int):
        from repro_torch.checkpoint.manager import list_steps
        from repro_torch.resilience import CheckpointCorruptionError, TrainingDivergedError
        from repro_torch.train.state import restore_train_state

        if self.ckpt is None:
            raise TrainingDivergedError(
                f"{self.strikes} consecutive anomalous steps at step {step} and no CheckpointCallback to roll "
                "back through"
            )
        mgr = self.ckpt.manager
        mgr.wait()
        candidates = [s for s in list_steps(mgr.directory) if s <= self.last_good_step]
        for s in reversed(candidates):
            try:
                state, manifest = restore_train_state(mgr.directory, trainer.cfg, step=s, device=trainer.device)
            except CheckpointCorruptionError:
                continue
            trainer.state = state
            data_state = (manifest.get("meta") or {}).get("data_state")
            if data_state is not None and hasattr(trainer.data_iter, "restore"):
                trainer.data_iter.restore(data_state)
            self.strikes = 0
            self.rollbacks += 1
            self.interventions.append({"step": step, "kind": "rollback", "to": s})
            self.log(f"step {step:5d} ROLLBACK -> checkpoint step {s}")
            return
        raise TrainingDivergedError(
            f"{self.rollback_after} consecutive anomalous steps at step {step} and no verified checkpoint "
            f"at-or-before last good step {self.last_good_step} under {mgr.directory}"
        )

    def summary(self) -> Dict:
        return {
            "skipped_updates": self.skips,
            "rollbacks": self.rollbacks,
            "interventions": self.interventions,
            "loss_ceiling": self._ceiling(),
        }


class CheckpointCallback(Callback):
    """Full-state periodic checkpoints through the async manager: params,
    optimizer state, the generator and the data iterator's snapshot
    (manifest meta), so a resumed run replays the batch sequence of an
    uninterrupted one. A save blocks the loop for the host copy only; the
    file writes overlap the following steps."""

    def __init__(
        self,
        directory: str,
        every: int,
        keep_last: int = 3,
        async_save: bool = True,
        extra_meta: Optional[Dict] = None,
    ):
        from repro_torch.checkpoint.manager import CheckpointManager

        self.every = every
        self.extra_meta = extra_meta or {}
        self.manager = CheckpointManager(directory, keep_last, async_save)
        self.blocked_s: List[float] = []

    def _meta(self, trainer) -> Dict:
        meta = dict(self.extra_meta)
        it = trainer.data_iter
        if it is not None and hasattr(it, "state"):
            meta["data_state"] = it.state()
        meta["wall_time"] = time.time()
        return meta

    def save_now(self, trainer, step: int, blocking: Optional[bool] = None):
        from repro_torch.train.state import state_to_tree

        self.manager.save(state_to_tree(trainer.state), step, self._meta(trainer), blocking=blocking)
        self.blocked_s.append(self.manager.last_blocked_s)

    def on_step_end(self, trainer, step, metrics, dt):
        if self.every and step % self.every == 0:
            self.save_now(trainer, step)

    def on_run_end(self, trainer):
        self.manager.wait()
