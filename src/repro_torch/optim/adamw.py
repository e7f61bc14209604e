"""AdamW with compute params in the model dtype and fp32 master weights
(port of ``repro.optim.adamw``).

State per parameter: ``master`` (fp32 copy, authoritative), ``m`` and
``v`` (fp32 moments). The arithmetic is the JAX package's: global-norm
clipping, bias correction, decoupled weight decay on matrices only
(``ndim >= 2``), and new params cast from the fp32 master. Where JAX builds
new trees, the port updates in place, one tensor at a time and in chunks of
``CHUNK`` elements, so the only fp32 temporaries are two chunks (the
clipped gradient and the denominator), never a second fp32 tree. ZeRO-1
sharding waits for the multi-GPU item (ROADMAP queue 1, 'Multi-GPU').
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.params import tree_leaves, tree_map

CHUNK = 1 << 26  # elements per in-place update chunk (256 MB of fp32)


@dataclasses.dataclass
class AdamWState:
    step: int
    master: Any
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    return AdamWState(
        0,
        tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
    )


def _leaves(tree) -> list:
    return list(tree) if isinstance(tree, (list, tuple)) else tree_leaves(tree)


def _chunks(*ts):
    flat = [t.reshape(-1) for t in ts]
    n = flat[0].numel()
    for s in range(0, n, CHUNK):
        yield [f[s:s + CHUNK] for f in flat]


@torch.no_grad()
def grad_sumsq(grads) -> torch.Tensor:
    """Sum of squares of every gradient (a tree or a list), in fp32 (0-dim,
    on the device)."""
    total = None
    for g in _leaves(grads):
        for (c,) in _chunks(g):
            s = c.float().square().sum()
            total = s if total is None else total + s
    return total


@torch.no_grad()
def adamw_update(cfg, grads, state: AdamWState, lr, params, sumsq: Optional[torch.Tensor] = None) -> Tuple[Any, AdamWState]:
    """Apply one AdamW update in place: ``state`` (master, m, v, step) and
    ``params`` (cast from the new master). ``lr`` is a float or 0-dim
    tensor; ``sumsq`` the gradients' :func:`grad_sumsq` if already known.
    Returns (params, state), as the JAX version returns new ones."""
    if sumsq is None:
        sumsq = grad_sumsq(grads)
    clip = torch.clamp(cfg.grad_clip / torch.sqrt(sumsq + 1e-16), max=1.0)
    state.step += 1
    t = torch.tensor(state.step, dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(cfg.adam_b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(cfg.adam_b2, dtype=torch.float32) ** t)
    lr = float(lr)
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    for p, g_full, master, m, v in zip(*(_leaves(t) for t in (params, grads, state.master, state.m, state.v))):
        wd = cfg.weight_decay if master.ndim >= 2 else 0.0
        for p_c, g_c, ms_c, m_c, v_c in _chunks(p, g_full, master, m, v):
            g = g_c.to(torch.float32, copy=True).mul_(clip)
            m_c.mul_(b1).add_(g, alpha=1 - b1)
            v_c.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = torch.div(v_c, bc2).sqrt_().add_(eps)
            delta = torch.div(m_c, bc1, out=g).div_(denom)
            if wd:
                delta.add_(ms_c, alpha=wd)
            ms_c.sub_(delta.mul_(lr))
            p_c.copy_(ms_c)
    return params, state
