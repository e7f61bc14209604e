"""Explicit training state (port of ``repro.train.state``): params, AdamW
state, step counter and the ``torch.Generator`` the step hands to the model
(where the JAX package carries a PRNG key; only noisy gating draws from
it, one draw a step, ``train/trainer.py``). The data iterator's state rides in the checkpoint
manifest's ``meta``, as in the JAX package.

``state_to_tree``/``tree_to_state`` define the checkpoint tree, with the
JAX package's keys and one more leaf::

    {"step": i32[], "rng": u32[2], "rng_state": u8[n],
     "params": {...}, "opt": {"step": i32[], "master": {...}, "m": {...}, "v": {...}}}

``rng`` is the generator's seed as the two words of a JAX key (a fresh
state's is the JAX package's ``PRNGKey(seed + 1)``), so the JAX package's
``tree_to_state`` restores a port checkpoint; ``rng_state`` is the
generator's own state, which the JAX package ignores and the port restores
as it was, so a resume is exact. A tree without ``rng_state`` (a JAX
checkpoint) seeds the generator from the two words
(``params.train_state_from_numpy``). ``restore_train_state`` restores a
full-state checkpoint onto one device and checks it against the model's
declaration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.params import init_from_decls, resolve_device, tree_map


@dataclasses.dataclass
class TrainState:
    step: int  # batches consumed (always advances, also on a guarded step)
    params: Any
    opt_state: AdamWState
    gen: torch.Generator


def create_train_state(cfg, tcfg, params: Optional[Any] = None,
                       device: Union[str, torch.device] = "cuda") -> TrainState:
    """Fresh state: draw the params from ``tcfg.seed`` on ``device`` (the
    numbers differ from ``jax.random``'s), or adopt a copy of ``params``."""
    from repro_torch.models.model import model_decl

    dev = resolve_device(device)
    if params is None:
        params = init_from_decls(model_decl(cfg), tcfg.seed, dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tcfg.seed + 1)
    return TrainState(0, params, adamw_init(params), gen)


def rng_words(gen: torch.Generator) -> np.ndarray:
    """The generator's seed as the two uint32 words of a JAX key."""
    seed = gen.initial_seed()
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """The checkpoint tree of ``state``. Its tensors are the live ones (the
    checkpoint manager copies them when it saves)."""
    o = state.opt_state
    return {
        "step": np.asarray(state.step, np.int32),
        "rng": rng_words(state.gen),
        "rng_state": state.gen.get_state(),
        "params": state.params,
        "opt": {"step": np.asarray(o.step, np.int32), "master": o.master, "m": o.m, "v": o.v},
    }


def tree_to_state(tree: Dict[str, Any], cfg=None, device: Union[str, torch.device] = "cuda") -> TrainState:
    """Inverse of :func:`state_to_tree`, also for the JAX package's tree:
    leaves keep their dtypes, leaves already on ``device`` are taken as they
    are, and with ``cfg`` every tree takes the declaration's key order (see
    ``params.train_state_from_numpy``)."""
    from repro_torch.params import train_state_from_numpy

    return train_state_from_numpy(tree, device, cfg)


def _check_shapes(tree: Dict[str, Any], cfg) -> None:
    from repro_torch.checkpoint.sharded import flatten_tree
    from repro_torch.models.model import model_decl

    want = {k: tuple(d.shape) for k, d in flatten_tree(model_decl(cfg)).items()}
    got_p = {k: tuple(t.shape) for k, t in flatten_tree(tree["params"]).items()}
    assert got_p == want, (
        "checkpoint params do not match the model declaration — resuming a different config? missing/extra: "
        f"{sorted(set(got_p) ^ set(want))[:8]} shape diffs: "
        f"{[k for k in got_p if k in want and got_p[k] != want[k]][:8]}"
    )
    got_m = {k: tuple(t.shape) for k, t in flatten_tree(tree["opt"]["master"]).items()}
    assert got_m == want, "checkpoint optimizer state does not match the model"


def restore_train_state(directory: str, cfg, step: Optional[int] = None,
                        device: Union[str, torch.device] = "cuda") -> Tuple[TrainState, Dict[str, Any]]:
    """Restore the latest (or given) verified full-state checkpoint onto
    ``device``. Returns ``(state, manifest)``; the manifest's ``meta``
    carries the data-iterator snapshot and any provenance the run
    recorded."""
    from repro_torch.checkpoint.manager import restore_tree

    tree, manifest = restore_tree(directory, step=step, device=device)
    _check_shapes(tree, cfg)
    return tree_to_state(tree, cfg, device), manifest
