"""Training loop (port of ``repro.train.trainer``): a step function (loss
+ grads + clip + AdamW + schedule, with microbatch accumulation and the
in-step anomaly guard) driven by a small loop with composable callbacks.

PyTorch runs eagerly, so there is no jit: ``make_train_step`` returns a
plain function that computes the gradients with ``torch.autograd.grad``
and updates params and optimizer state in place. A guarded step decides
before the update (one device-to-host read), so a skipped step touches
nothing, as the JAX ``jnp.where`` selection leaves everything bitwise
unchanged. The ``train.step`` fault site injects NaN gradients, a loss
spike or a hang through the guard's knobs; checkpointing and the anomaly
supervisor's rollback are callbacks (``train/callbacks.py``), and
``tcfg.ckpt_every`` adds a :class:`CheckpointCallback` to the defaults.

Noisy gating reads the state's generator as the JAX step reads its key:
each step takes one draw from it (the JAX ``split(state.rng)``), whatever
the microbatch count and whether the guard skips the update, and each
microbatch draws its noise from a child generator seeded from that draw.
So the generator after step n is a function of the state at step 0 and
n, and a rollback that restores the checkpoint's ``rng_state`` replays
the same noise. A model without noisy gating never reads the generator.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import with_dispatcher
from repro_torch.models.model import loss_fn
from repro_torch.optim.adamw import AdamWState, adamw_update, grad_sumsq
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.params import tree_leaves
from repro_torch.resilience import HangError, faults
from repro_torch.train.callbacks import Callback, CheckpointCallback, LoggingCallback
from repro_torch.train.state import TrainState, create_train_state

METRIC_KEYS = ("loss", "ce", "load_balance_loss", "z_loss")
_GOLDEN = 0x9E3779B1  # spreads the child seeds of one step's draw


def microbatch_generators(cfg, gen: Optional[torch.Generator], m: int) -> list:
    """The generators of a step's ``m`` microbatches: with noisy gating, one
    draw from ``gen`` seeds ``m`` children (below 2**32, the CPU
    generator's seed width); otherwise ``gen`` itself, unread."""
    if gen is None or cfg.moe is None or not cfg.moe.noisy_gating:
        return [gen] * m
    seed = int(torch.randint(0, 2 ** 31, (1,), generator=gen, device=gen.device))
    return [torch.Generator(device=gen.device).manual_seed((seed + i * _GOLDEN) % 2 ** 32) for i in range(m)]


def make_train_step(cfg, tcfg, use_kernel: bool = False):
    """Returns ``step(params, opt_state, batch, gen, loss_ceiling=None,
    grad_scale=1.0, loss_shift=0.0) -> (params, opt_state, metrics)``;
    params and opt_state are updated in place.

    With ``cfg.train_microbatches = m > 1`` the batch is split into m
    sequential microbatches whose grads are accumulated in fp32 and averaged
    before one optimizer update. A ``loss_ceiling`` arms the anomaly guard:
    grads are scaled by ``grad_scale`` and the observed loss shifted by
    ``loss_shift`` (identity by default; the ``train.step`` fault site uses
    them to inject NaN grads or a loss spike), and the update is skipped
    (params and ``opt_state.step`` untouched) when the observed loss or the
    grad norm is non-finite or the loss exceeds the ceiling.
    ``metrics["skipped"]`` reports the verdict and ``metrics["loss"]`` the
    observed loss."""
    m = cfg.train_microbatches

    def grads_of(params, leaves, batch, gen):
        loss, metrics = loss_fn(cfg, params, batch, gen, use_kernel)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return grads, {k: metrics[k].detach() for k in METRIC_KEYS}

    def step(params, opt_state: AdamWState, batch: Dict[str, torch.Tensor], gen,
             loss_ceiling: Optional[float] = None, grad_scale: float = 1.0, loss_shift: float = 0.0):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        B = batch["tokens"].shape[0]
        m_eff = max(1, min(m, B))
        while B % m_eff:
            m_eff -= 1
        gens = microbatch_generators(cfg, gen, m_eff)
        if m_eff > 1:
            mb = B // m_eff
            g_acc, met_acc = None, None
            for i in range(m_eff):
                g, met = grads_of(params, leaves, {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, gens[i])
                if g_acc is None:
                    g_acc, met_acc = [x.float() for x in g], met
                else:
                    for a, x in zip(g_acc, g):
                        a.add_(x.float())
                    met_acc = {k: met_acc[k] + met[k] for k in METRIC_KEYS}
                del g
            grads = [a.div_(m_eff) for a in g_acc]
            metrics = {k: v / m_eff for k, v in met_acc.items()}
        else:
            grads, metrics = grads_of(params, leaves, batch, gens[0])
        if loss_ceiling is not None and grad_scale != 1.0:
            grads = [g * grad_scale for g in grads]
        lr = cosine_schedule(opt_state.step, tcfg.lr, tcfg.lr_min, tcfg.warmup_steps, tcfg.total_steps)
        sumsq = grad_sumsq(grads)
        gnorm = torch.sqrt(sumsq)
        metrics = {**metrics, "lr": lr, "grad_norm": gnorm}
        bad = False
        if loss_ceiling is not None:
            loss = metrics["loss"] + loss_shift
            bad = bool(~torch.isfinite(loss) | ~torch.isfinite(gnorm) | (loss > loss_ceiling))
            metrics = {**metrics, "loss": loss, "skipped": torch.tensor(float(bad))}
        if not bad:
            adamw_update(tcfg, grads, opt_state, lr, params, sumsq)
        return params, opt_state, metrics

    return step


def make_state_step(cfg, tcfg, use_kernel: bool = False):
    """TrainState-level step: ``step(state, batch, loss_ceiling=None,
    **guard knobs) -> (state, metrics)``. ``state.step`` counts batches
    consumed and always advances; a guard-skipped step leaves only the
    optimizer clock untouched."""
    inner = make_train_step(cfg, tcfg, use_kernel)

    def state_step(state: TrainState, batch, loss_ceiling: Optional[float] = None, **knobs):
        _, _, metrics = inner(state.params, state.opt_state, batch, state.gen, loss_ceiling, **knobs)
        state.step += 1
        return state, metrics

    return state_step


class Trainer:
    """Owns a TrainState and the step, and runs the loop under callbacks.
    Construct fresh (``params=None`` draws them from ``tcfg.seed`` on
    ``device``, or adopt a params tree) or from ``state=``."""

    def __init__(
        self,
        cfg,
        tcfg,
        params: Optional[Any] = None,
        data_iter: Optional[Iterator[Dict[str, np.ndarray]]] = None,
        use_kernel: bool = False,
        dispatcher: Optional[str] = None,
        state: Optional[TrainState] = None,
        callbacks: Optional[Sequence[Callback]] = None,
        step_timeout_s: Optional[float] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        cfg = with_dispatcher(cfg, dispatcher)
        self.cfg, self.tcfg = cfg, tcfg
        if state is None:
            state = create_train_state(cfg, tcfg, params, device)
        self.state = state
        self.device = tree_leaves(state.params)[0].device
        self.step_fn = make_state_step(cfg, tcfg, use_kernel)
        self.data_iter = data_iter
        self.callbacks = list(callbacks) if callbacks is not None else None
        self.history: list = []
        self.loss_ceiling = float("inf")
        self.step_timeout_s = step_timeout_s

    @property
    def params(self):
        return self.state.params

    @property
    def opt_state(self) -> AdamWState:
        return self.state.opt_state

    def default_callbacks(self, log=print) -> List[Callback]:
        cbs: List[Callback] = [LoggingCallback(log=log, log_every=self.tcfg.log_every)]
        if self.tcfg.ckpt_every:
            cbs.append(CheckpointCallback(self.tcfg.ckpt_dir, every=self.tcfg.ckpt_every))
        return cbs

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in batch.items()}

    def run(self, steps: int, log=print, callbacks: Optional[Sequence[Callback]] = None) -> Dict[str, list]:
        """Run ``steps`` more steps under the anomaly guard. The global step
        is read back from ``state.step`` (resume-aware; a supervisor
        rollback rewinds it). The ``train.step`` fault site can inject NaN
        grads, a loss spike or a hang. Each step's wall time ends with a
        device-to-host read of its loss; with ``step_timeout_s`` a slower
        step raises :class:`HangError`."""
        assert self.data_iter is not None
        cbs = list(callbacks) if callbacks is not None else self.callbacks
        if cbs is None:
            cbs = self.default_callbacks(log)
        for cb in cbs:
            cb.on_run_begin(self)
        for _ in range(steps):
            t0 = time.perf_counter()
            batch = self._to_device(next(self.data_iter))
            knobs = {}
            for spec in faults.fire("train.step"):
                if spec.kind == "nan_grads":
                    knobs["grad_scale"] = float("nan")
                elif spec.kind == "loss_spike":
                    knobs["loss_shift"] = spec.args.get("shift", 1e4)
                elif spec.kind == "hang":
                    time.sleep(spec.args.get("seconds", 2.0 * (self.step_timeout_s or 0.05)))
            self.state, metrics = self.step_fn(self.state, batch, self.loss_ceiling, **knobs)
            float(metrics["loss"])  # device -> host: the step is done
            dt = time.perf_counter() - t0
            if self.step_timeout_s is not None and dt > self.step_timeout_s:
                raise HangError(
                    f"train step exceeded its {self.step_timeout_s:.3f}s wall budget ({dt:.3f}s)"
                )
            for cb in cbs:
                cb.on_step_end(self, self.state.step, metrics, dt)
        for cb in cbs:
            cb.on_run_end(self)
        return {"history": self.history}

    def eval_loss(self, batches: int = 8, seed: int = 999, data_seed: Optional[int] = None) -> float:
        """Held-out CE: the same blend (``data_seed``, default the train
        seed) with a fresh sampling stream (``seed``), through the plain
        path as the JAX package evaluates it."""
        from repro_torch.data.pipeline import make_train_iter, stub_inputs

        it = make_train_iter(
            self.cfg.vocab_size, self.tcfg.seq_len, self.tcfg.global_batch, self.tcfg.blend_ratio,
            data_seed if data_seed is not None else self.tcfg.seed,
            stub_inputs(self.cfg, self.tcfg.global_batch, self.tcfg.seq_len), sample_seed=seed,
        )
        losses = []
        with torch.no_grad():
            for _ in range(batches):
                losses.append(float(loss_fn(self.cfg, self.params, self._to_device(next(it)))[1]["ce"]))
        return float(np.mean(losses))
