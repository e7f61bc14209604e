"""Top-k routing in fp32 (port of ``repro.core.router.route``).

* ``mixtral`` — top-k of the logits, then a softmax over the k survivors
  (gates sum to 1; preserves the dense function at upcycling init).
* ``st``      — top-k of the full softmax.

Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them: a
stable descending sort keeps equal values in index order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.params import ParamDecl


def router_decl(d_model: int, moe) -> Dict[str, ParamDecl]:
    if moe.noisy_gating:
        raise NotImplementedError("noisy gating is ROADMAP queue 1, 'other families and routers'")
    return {"w_g": ParamDecl((d_model, moe.num_experts), ("embed", "expert"), "normal:0.02", torch.float32)}


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(moe, params, x: torch.Tensor, gen: Optional[torch.Generator] = None,
          train: bool = False) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (..., D). Returns (gates (..., k) fp32, expert_idx (..., k) int32,
    aux) with the Switch load-balance loss and the router z-loss (both
    scaled by their coefficients), the router entropy and the largest
    dispatch fraction. ``gen`` and ``train`` take the place of the JAX
    ``rng, train``: only noisy gating reads them, and it is not ported yet
    (``router_decl`` raises for it)."""
    logits = x.float() @ params["w_g"]
    probs_full = torch.softmax(logits, -1)
    if moe.router_type == "mixtral":
        top_logits, idx = _top_k(logits, moe.top_k)
        gates = torch.softmax(top_logits, -1)
    elif moe.router_type == "st":
        gates, idx = _top_k(probs_full, moe.top_k)
    else:
        raise ValueError(f"unknown router_type {moe.router_type}")

    E = moe.num_experts
    onehot = torch.nn.functional.one_hot(idx, E).float()  # (..., k, E)
    f = onehot.sum(-2).reshape(-1, E).mean(0) / moe.top_k
    p = probs_full.reshape(-1, E).mean(0)
    z = torch.logsumexp(logits, -1)
    aux = {
        "load_balance_loss": E * (f * p).sum() * moe.aux_loss_coef,
        "z_loss": z.square().mean() * moe.z_loss_coef,
        "router_entropy": -(probs_full * torch.log(probs_full + 1e-9)).sum(-1).mean(),
        "expert_fraction_max": f.max(),
    }
    return gates, idx.int(), aux
