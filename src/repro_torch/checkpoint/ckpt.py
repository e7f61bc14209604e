"""Flat (single-directory) params checkpoints and online upcycling on load
(port of ``repro.checkpoint.ckpt``; paper §3.1: "the dense checkpoint is
sharded based on the specified parallel training configuration, and
weights are upcycled independently on each device").

``save_checkpoint``/``load_checkpoint`` are the params-only layout the
launchers write at the end of a run and read with ``--from-ckpt``, through
the per-leaf writer of :mod:`repro_torch.checkpoint.sharded`; format-1
manifests (one whole-array ``.npy`` per leaf) stay loadable. Full
train-state checkpoints live in step directories managed by
:class:`repro_torch.checkpoint.manager.CheckpointManager`.

On one card ``upcycle_on_load`` loads the dense tree onto the device and
calls ``core.upcycle.upcycle_params`` there; it returns ``(params, None)``
as the JAX function does without a parallel plan.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.sharded import (
    flatten_tree,
    read_tree,
    snapshot_leaf,
    to_tensor,
    unflatten_tree,
    write_leaf,
    write_manifest,
)
from repro_torch.params import resolve_device


def save_checkpoint(path: str, params, step: int = 0, meta: Optional[Dict] = None) -> None:
    """Params-only flat checkpoint into ``path`` (manifest written last)."""
    os.makedirs(path, exist_ok=True)
    leaves = {}
    for key, val in flatten_tree(params).items():
        entry, shards = snapshot_leaf(val)
        leaves[key] = write_leaf(path, key, entry, shards)
    write_manifest(path, step, leaves, meta)


def _load_v1(path: str, manifest: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return unflatten_tree({
        key: to_tensor(np.load(os.path.join(path, info["file"])), info["dtype"], device)
        for key, info in manifest["leaves"].items()
    })


def load_checkpoint(path: str, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Load a flat checkpoint of either manifest format onto ``device``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format", 1) < 2:
        return _load_v1(path, manifest, resolve_device(device))
    return read_tree(path, manifest, device)


def upcycle_on_load(path: str, dense_cfg, moe_cfg, plan=None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda"):
    """Load a dense checkpoint onto ``device`` and upcycle it there (routers
    drawn from ``seed``, see ``core.upcycle.upcycle_params``). Returns
    ``(moe_params, None)``; a parallel ``plan`` waits for the multi-GPU
    item (ROADMAP queue 1)."""
    from repro_torch.core.upcycle import upcycle_params

    if plan is not None:
        raise NotImplementedError("upcycle_on_load with a parallel plan is not ported yet (ROADMAP queue 1, "
                                  "'multi-GPU')")
    with torch.no_grad():
        return upcycle_params(dense_cfg, moe_cfg, load_checkpoint(path, device), seed), None
