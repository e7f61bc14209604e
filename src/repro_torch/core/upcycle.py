"""Sparse upcycling (paper §3.1; port of ``repro.core.upcycle``).

``upcycle_config`` derives the MoE config from a dense one;
``upcycle_params`` turns dense parameters into MoE parameters: every
converted FFN is copied into each of the N experts, the router is drawn
fresh, everything else is carried over as it is. With the Mixtral router
the upcycled model's first forward equals the dense one.
``upcycle_provenance`` is the block an upcycled run records in its
checkpoint manifests.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.params import init_from_decls, tree_map


def upcycle_config(dense, moe, name: Optional[str] = None):
    """Dense config -> N-Expert Top-k MoE config. A ``dense`` family
    becomes ``moe``; every other family keeps its own (a ``vlm`` keeps its
    ``embeds`` prefix, an ``encdec`` its encoder, a ``hybrid`` its
    pattern), as ``repro.core.upcycle.upcycle_config`` keeps it."""
    assert dense.d_ff > 0, "cannot upcycle an FFN-free architecture"
    assert dense.num_layers % moe.moe_layer_freq == 0
    return dense.replace(
        name=name or f"{dense.name}-e{moe.num_experts}t{moe.top_k}",
        family="moe" if dense.family == "dense" else dense.family,
        moe=moe,
    )


def upcycle_provenance(dense_cfg, moe_cfg, source_ckpt: Optional[str] = None) -> Dict[str, Any]:
    """Provenance recorded in the full-state checkpoint manifests of an
    upcycled run. On ``--resume`` the launcher restarts from the latest MoE
    TrainState instead of upcycling the dense source again: the upcycle is
    a one-time init, not part of the resume path."""
    m = moe_cfg.moe
    assert m is not None
    return {
        "upcycled": True,
        "dense_config": dense_cfg.name,
        "moe_config": moe_cfg.name,
        "num_experts": m.num_experts,
        "top_k": m.top_k,
        "capacity_factor": m.capacity_factor,
        "router_type": m.router_type,
        "source_ckpt": source_ckpt,
    }


def upcycle_params(dense_cfg, moe_cfg, dense_params: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Dense parameter tree -> upcycled MoE tree. The dense stack must be
    single-slot; the router of slot i is drawn from ``seed + i`` on the
    parameters' device."""
    from repro_torch.core.router import router_decl
    from repro_torch.models.transformer import build_slots, periods_for

    moe = moe_cfg.moe
    assert len(build_slots(dense_cfg)) == 1, "upcycling expects a homogeneous dense stack"
    new_slots = build_slots(moe_cfg)
    nslots = len(new_slots)
    new_p = periods_for(moe_cfg, new_slots)
    E = moe.num_experts
    dstack = dense_params["stack"]["slot0"]
    device = dstack["norm1"]["scale"].device
    out: Dict[str, Any] = {k: v for k, v in dense_params.items() if k != "stack"}
    new_stack: Dict[str, Any] = {}
    for i, spec in enumerate(new_slots):
        # layer l = p * nslots + i
        slot_params = tree_map(lambda t: t.reshape((new_p, nslots) + t.shape[1:])[:, i], dstack)
        if spec.ffn == "moe":
            mlp = slot_params.pop("ffn")
            assert mlp["w_gate"].shape[-1] == moe.experts_ff(moe_cfg.d_ff), (
                "expert_d_ff must match the dense d_ff for weight copying"
            )
            experts = {
                k: mlp[k][:, None].expand((new_p, E) + mlp[k].shape[1:]).contiguous()
                for k in ("w_gate", "w_up", "w_down")
            }
            router = tree_map(lambda d: d.stacked(new_p), router_decl(moe_cfg.d_model, moe))
            ffn = {"router": init_from_decls(router, seed + i, device), "experts": experts}
            if moe.dense_residual:
                ffn["dense_residual"] = mlp
            slot_params["ffn"] = ffn
        new_stack[f"slot{i}"] = slot_params
    out["stack"] = new_stack
    return out
