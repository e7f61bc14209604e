"""Explicit training state (port of ``repro.train.state``): params, AdamW
state, step counter and the ``torch.Generator`` the step hands to the model
(where the JAX package carries a PRNG key; only noisy gating, not ported
yet, draws from it).

``state_to_tree``/``tree_to_state`` carry a state to and from a nested
dict of numpy arrays with the JAX package's structure::

    {"step": i32[], "rng": ..., "params": {...},
     "opt": {"step": i32[], "master": {...}, "m": {...}, "v": {...}}}

so that tests can start both packages from one state
(``params.train_state_from_numpy``). ``restore_train_state`` waits for
checkpointing (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.params import init_from_decls, params_to_numpy, resolve_device, tree_map


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


def state_to_tree(state: TrainState) -> Dict[str, Any]:
    """numpy tree of the state (bf16 leaves as float32, exact); ``rng`` is
    the generator's state bytes."""
    o = state.opt_state
    return {
        "step": np.asarray(state.step, np.int32),
        "rng": state.gen.get_state().numpy(),
        "params": params_to_numpy(state.params),
        "opt": {"step": np.asarray(o.step, np.int32), "master": params_to_numpy(o.master),
                "m": params_to_numpy(o.m), "v": params_to_numpy(o.v)},
    }


def tree_to_state(tree: Dict[str, Any], cfg, device: Union[str, torch.device] = "cuda") -> TrainState:
    """Inverse of :func:`state_to_tree`: params take the dtypes
    ``model_decl(cfg)`` declares (see ``params.train_state_from_numpy``,
    which also takes the JAX package's tree)."""
    from repro_torch.params import train_state_from_numpy

    return train_state_from_numpy(tree, device, cfg)
