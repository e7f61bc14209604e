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
    init: str = "fan_in"  # fan_in | normal:<std> | uniform:<lo>:<hi> | zeros | ones
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


def _random_slices(d: ParamDecl, gen: torch.Generator, device: torch.device):
    """Yield each leading slice (the last two dims) of a random leaf, drawn
    in fp32 (normal, scaled by the init's std, or uniform on [lo, hi)), in
    the generator's order: one slice at a time, since the stacked expert
    leaf of llama3-e8t2 is periods x 8 x 4096 x 14336 values and an fp32
    copy of it would not fit."""
    lo = hi = std = None
    if d.init.startswith("normal"):
        std = float(d.init.split(":")[1]) if ":" in d.init else 0.02
    elif d.init == "fan_in":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    elif d.init.startswith("uniform:"):
        _, lo, hi = d.init.split(":")
        lo, hi = float(lo), float(hi)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    n = math.prod(d.shape[:-2]) if len(d.shape) > 2 else 1
    shape = d.shape[-2:] if len(d.shape) >= 2 else d.shape
    for _ in range(n):
        if std is None:
            r = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
            yield r.mul_(hi - lo).add_(lo)
        else:
            r = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            yield r.mul_(std)


def _init_leaf(d: ParamDecl, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1)
    view = out.reshape((-1,) + d.shape[-2:]) if len(d.shape) > 2 else out[None]
    for i, r in enumerate(_random_slices(d, gen, device)):
        view[i].copy_(r)
    return out


def _init_int8_expert(d: ParamDecl, gen: torch.Generator, device: torch.device):
    """An expert weight drawn as :func:`_init_leaf` draws it, each slice
    rounded to the bf16 the bf16 tree would hold and quantised at once:
    (int8 leaf, bf16 per-output-channel scales). The bf16 leaf never exists."""
    from repro_torch.core.quant import quantize_matrix

    q = torch.empty(d.shape, dtype=torch.int8, device=device)
    s = torch.empty(d.shape[:-2] + d.shape[-1:], dtype=torch.bfloat16, device=device)
    qv, sv = q.reshape((-1,) + d.shape[-2:]), s.reshape((-1, d.shape[-1]))
    for i, r in enumerate(_random_slices(d, gen, device)):
        quantize_matrix(r.to(d.dtype), qv[i], sv[i])
    return q, s


def init_from_decls(decls: Tree, seed: int, device: Union[str, torch.device] = "cuda",
                    quant_weights: str = "none") -> Tree:
    """Materialise a tree of :class:`ParamDecl` on ``device``, leaf by leaf,
    from one generator seeded with ``seed``. With ``quant_weights="int8"``
    every ``experts`` dict comes out quantised (int8 weights and bf16
    ``*_scale`` leaves) straight from the draw: the same generator stream,
    and bit for bit ``quantize_params`` of the bf16 tree, which is never
    built. Dense FFNs stay bf16, as ``quantize_params`` leaves them."""
    from repro_torch.core.quant import EXPERT_KEYS, QUANT_MODES

    if quant_weights not in QUANT_MODES:
        raise ValueError(f"quant_weights must be one of {QUANT_MODES}, got {quant_weights!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def init(node, key=None):
        if not isinstance(node, dict):
            return _init_leaf(node, gen, dev)
        if quant_weights == "int8" and key == "experts" and all(isinstance(node.get(k), ParamDecl)
                                                                for k in EXPERT_KEYS):
            out, scales = {}, {}
            for k, d in node.items():
                if k in EXPERT_KEYS:
                    out[k], scales[k + "_scale"] = _init_int8_expert(d, gen, dev)
                else:
                    out[k] = init(d)
            return {**out, **scales}
        return {k: init(v, k) for k, v in node.items()}

    return init(decls)


def params_from_numpy(tree, device: Union[str, torch.device] = "cuda") -> Tree:
    """Carry a parameter tree of numpy arrays (``np.asarray`` of JAX leaves)
    to torch tensors on ``device``. A JAX bf16 leaf arrives as numpy dtype
    ``bfloat16`` (from ``ml_dtypes``), which ``torch.from_numpy`` refuses:
    it is recognised by name and carried bit for bit as int16, then viewed
    as ``torch.bfloat16``. Other dtypes keep their type: int8 expert
    weights arrive as int8, their ``*_scale`` leaves as bf16, the SSM's
    fp32 ``conv_w``/``conv_b``/``dt_bias``/``A_log``/``D_skip`` as fp32.
    The tree's keys are the declarations' (MLA's ``wq_a``/``wq_b``/
    ``wkv_a``/``wkv_b``/``q_norm``/``kv_norm``, the ``encoder`` stack and
    ``encoder_norm``, a decoder slot's ``norm_cross``/``cross``), so every
    family's JAX tree carries across as it is."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(dev)
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


def train_state_from_numpy(tree, device: Union[str, torch.device] = "cuda", cfg=None):
    """Carry a training state as a nested dict (``{"step", "rng",
    "params", "opt": {"step", "master", "m", "v"}}``: the JAX package's
    ``state_to_tree(state)`` through ``np.asarray``, a restored checkpoint
    tree, or the port's own ``train.state.state_to_tree``) into the port's
    ``TrainState`` on ``device``, extending :func:`params_from_numpy`.
    Leaves keep their dtypes (a JAX bf16 leaf arrives as bf16); with
    ``cfg`` the params and the optimizer trees take the key order of
    ``model_decl(cfg)`` (AdamW pairs their leaves in order).
    ``rng_state``, where present and of the generator's size, is restored
    as it is; otherwise the two-word ``rng`` key seeds the generator."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.state import TrainState

    dev = resolve_device(device)
    params = params_from_numpy(tree["params"], dev)
    o = tree["opt"]
    opt = [tree_map(lambda t: t.float(), params_from_numpy(o[k], dev)) for k in ("master", "m", "v")]
    if cfg is not None:
        # the declaration's key order for all four trees: AdamW zips their leaves
        from repro_torch.models.model import model_decl

        decl = model_decl(cfg)
        params, *opt = (tree_map(lambda d, t: t, decl, t) for t in [params] + opt)
    words = torch.as_tensor(tree["rng"]).reshape(-1).tolist()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(words[0]) << 32 | int(words[-1]))
    rng_state = tree.get("rng_state")
    if rng_state is not None and torch.as_tensor(rng_state).numel() == gen.get_state().numel():
        gen.set_state(torch.as_tensor(rng_state).to("cpu", torch.uint8))
    return TrainState(int(tree["step"]), params, AdamWState(int(o["step"]), *opt), gen)
