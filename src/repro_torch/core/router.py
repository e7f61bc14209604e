"""Top-k routing in fp32 (port of ``repro.core.router.route``).

* ``mixtral`` — top-k of the logits, then a softmax over the k survivors
  (gates sum to 1; preserves the dense function at upcycling init).
* ``st``      — top-k of the full softmax.
* ``expert_choice`` — :func:`route_full`: the full (T, E) probabilities,
  from which each expert takes its top-C tokens at dispatch
  (``core.dispatch.expert_choice_tables``).

Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them: a
stable descending sort keeps equal values in index order.

Noisy top-k gating (paper Eq. 3, ``moe.noisy_gating``): in training, ``logits
+= N(0, 1) * softplus(x @ w_noise)``, ``w_noise`` initialised to zeros in
fp32. The port draws N(0, 1) from a ``torch.Generator`` where the JAX package
draws from its key, so the two agree in distribution, not in value.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.params import ParamDecl


def router_decl(d_model: int, moe) -> Dict[str, ParamDecl]:
    decls = {"w_g": ParamDecl((d_model, moe.num_experts), ("embed", "expert"), "normal:0.02", torch.float32)}
    if moe.noisy_gating:
        decls["w_noise"] = ParamDecl((d_model, moe.num_experts), ("embed", "expert"), "zeros", torch.float32)
    return decls


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gating_noise(moe, shape, device, gen: Optional[torch.Generator] = None,
                 train: bool = False) -> Optional[torch.Tensor]:
    """The N(0, 1) draw of noisy gating for logits of ``shape`` (..., E), or
    None where no noise applies (gating not noisy, not training, or no
    generator: the JAX ``moe.noisy_gating and train and rng is not None``)."""
    if not (moe.noisy_gating and train and gen is not None):
        return None
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def route(moe, params, x: torch.Tensor, gen: Optional[torch.Generator] = None,
          train: bool = False, noise: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (..., D). Returns (gates (..., k) fp32, expert_idx (..., k) int32,
    aux) with the Switch load-balance loss and the router z-loss (both
    scaled by their coefficients), the router entropy and the largest
    dispatch fraction. ``gen`` and ``train`` take the place of the JAX
    ``rng, train``: noisy gating draws its N(0, 1) from ``gen`` in training
    (:func:`gating_noise`), unless the caller drew it already and passes it
    as ``noise`` (the stack does, so a recomputed layer sees the noise its
    forward saw)."""
    xf = x.float()
    logits = xf @ params["w_g"]
    if moe.noisy_gating and train:
        if noise is None:
            noise = gating_noise(moe, logits.shape, logits.device, gen, train)
        if noise is not None:
            logits = logits + noise * torch.nn.functional.softplus(xf @ params["w_noise"])
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


def route_full(moe, params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-choice support (``repro.core.router.route_full``): the FULL
    (T, E) probability matrix as the gates (dispatch takes each expert's
    top-C tokens), a dummy top-1 index, and the aux losses: no
    load-balance loss (EC balances by construction), the z-loss, the
    entropy and a max dispatch fraction of 1/E."""
    logits = x.float() @ params["w_g"]
    probs_full = torch.softmax(logits, -1)
    _, idx = _top_k(logits, 1)
    z = torch.logsumexp(logits, -1)
    aux = {
        "load_balance_loss": torch.zeros((), dtype=torch.float32, device=x.device),
        "z_loss": z.square().mean() * moe.z_loss_coef,
        "router_entropy": -(probs_full * torch.log(probs_full + 1e-9)).sum(-1).mean(),
        "expert_fraction_max": torch.tensor(1.0 / moe.num_experts, dtype=torch.float32, device=x.device),
    }
    return probs_full, idx.int(), aux
