"""Parameter declarations, device init and interchange with the JAX package.

A model is a nested dict of :class:`ParamDecl` (shape, logical axes, init,
dtype) — the same tree ``repro.sharding.rules.ParamDecl`` builds, with the
same keys and the stacked ``(periods, ...)`` leading dim — and
:func:`init_from_decls` materialises it on a device from a seeded
``torch.Generator``. The numbers differ from ``jax.random``'s; tests that
need equal weights in both packages draw them once (in JAX or numpy) and
carry them across with :func:`params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

Tree = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and absent —
    the port never carries on on the CPU in place of the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain path"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """Declarative parameter: shape + logical axes + init + dtype."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | normal:<std> | zeros | ones
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def stacked(self, n: int, axis: str = "layers") -> "ParamDecl":
        return ParamDecl((n,) + self.shape, (axis,) + self.axes, self.init, self.dtype)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (``rest`` trees share the
    structure of ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _init_leaf(d: ParamDecl, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1)
    if d.init.startswith("normal"):
        std = float(d.init.split(":")[1]) if ":" in d.init else 0.02
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    # draw in fp32 one leading slice at a time: the stacked expert leaf of
    # llama3-e8t2 is periods x 8 x 4096 x 14336 values, and an fp32 copy of
    # the whole leaf would double its footprint
    view = out.reshape((-1,) + d.shape[-2:]) if len(d.shape) > 2 else out[None]
    for i in range(view.shape[0]):
        r = torch.randn(view.shape[1:], generator=gen, device=device, dtype=torch.float32)
        view[i].copy_(r.mul_(std))
    return out


def init_from_decls(decls: Tree, seed: int, device: Union[str, torch.device] = "cuda") -> Tree:
    """Materialise a tree of :class:`ParamDecl` on ``device``, leaf by leaf,
    from one generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda d: _init_leaf(d, gen, dev), decls)


def params_from_numpy(tree, device: Union[str, torch.device] = "cuda") -> Tree:
    """Carry a parameter tree of numpy arrays (``np.asarray`` of JAX leaves)
    to torch tensors on ``device``. A JAX bf16 leaf arrives as numpy dtype
    ``bfloat16`` (from ``ml_dtypes``), which ``torch.from_numpy`` refuses:
    it is recognised by name and carried bit for bit as int16, then viewed
    as ``torch.bfloat16``. Other dtypes keep their type."""
    dev = resolve_device(device)

    def conv(a):
        a = np.array(a)  # a writable contiguous copy (JAX hands out read-only views)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree_map(conv, tree)


def params_to_numpy(tree) -> Tree:
    """Inverse of :func:`params_from_numpy` for tests: bf16 leaves come back
    as float32 arrays (exact: every bf16 value is a float32 value), the
    others in their own dtype."""

    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(conv, tree)
