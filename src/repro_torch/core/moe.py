"""Mixture-of-Experts layer: router + dispatcher (port of
``repro.core.moe``)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.dispatch import get_dispatcher
from repro_torch.core.router import route, router_decl
from repro_torch.models.layers import mlp_apply, mlp_decl
from repro_torch.params import ParamDecl


def moe_decl(cfg, moe) -> Dict[str, Any]:
    D, F, E = cfg.d_model, moe.experts_ff(cfg.d_ff), moe.num_experts
    dt = torch.bfloat16
    decls: Dict[str, Any] = {
        "router": router_decl(D, moe),
        "experts": {
            "w_gate": ParamDecl((E, D, F), ("expert", "embed", "expert_ff"), "fan_in", dt),
            "w_up": ParamDecl((E, D, F), ("expert", "embed", "expert_ff"), "fan_in", dt),
            "w_down": ParamDecl((E, F, D), ("expert", "expert_ff", "embed"), "fan_in", dt),
        },
    }
    if moe.dense_residual:
        decls["dense_residual"] = mlp_decl(D, cfg.d_ff, dt)
    return decls


def moe_apply(cfg, moe, params, x: torch.Tensor, use_kernel: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D) and the router's aux losses."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    gates, idx, aux = route(moe, params["router"], xf)
    out = get_dispatcher(cfg, moe).apply(params["experts"], xf, gates, idx, use_kernel)
    out = out.reshape(B, S, D).to(x.dtype)
    if moe.dense_residual:
        out = out + mlp_apply(params["dense_residual"], x)
    return out, aux
