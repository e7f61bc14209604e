"""Transformer block stacks for the dense and moe families (port of
``repro.models.transformer``).

Layers are organised as (periods x slots): a slot is one block kind
(attention + dense or MoE FFN); each slot's parameters carry a leading
``(periods,)`` dim, and :func:`stack_apply` loops over periods in Python
where the JAX package scans.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.moe import moe_apply, moe_decl
from repro_torch.models.attention import gqa_apply, gqa_decl
from repro_torch.models.layers import mlp_apply, mlp_decl, norm_apply, norm_decl
from repro_torch.params import ParamDecl, tree_map

AUX_KEYS = ("load_balance_loss", "z_loss")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # 'attn'
    ffn: str  # 'dense' | 'moe'
    causal: bool = True


def build_slots(cfg) -> List[BlockSpec]:
    """Slot list for one period of the decoder stack (MoE every
    ``moe_layer_freq``-th layer)."""
    freq = cfg.moe.moe_layer_freq if cfg.moe is not None else 1
    return [
        BlockSpec("attn", "moe" if (cfg.moe is not None and i == freq - 1) else "dense")
        for i in range(freq)
    ]


def periods_for(cfg, slots: List[BlockSpec]) -> int:
    assert cfg.num_layers % len(slots) == 0, (cfg.num_layers, len(slots))
    return cfg.num_layers // len(slots)


def block_decl(cfg, spec: BlockSpec) -> Dict[str, Any]:
    return {
        "norm1": norm_decl(cfg.d_model, cfg.norm_type),
        "mixer": gqa_decl(cfg),
        "norm2": norm_decl(cfg.d_model, cfg.norm_type),
        "ffn": moe_decl(cfg, cfg.moe) if spec.ffn == "moe" else mlp_decl(cfg.d_model, cfg.d_ff),
    }


def block_apply(
    cfg,
    spec: BlockSpec,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    cache_view: Optional[Dict[str, torch.Tensor]] = None,
    use_kernel: bool = False,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    h = norm_apply(params["norm1"], x, cfg.norm_type, cfg.norm_eps)
    mix, c = gqa_apply(
        cfg, params["mixer"], h, positions, cache["attn"] if cache else None,
        cache_view, causal=spec.causal, return_kv=return_cache, use_kernel=use_kernel,
    )
    x = x + mix
    h = norm_apply(params["norm2"], x, cfg.norm_type, cfg.norm_eps)
    aux: Dict[str, torch.Tensor] = {}
    if spec.ffn == "moe":
        y, aux = moe_apply(cfg, cfg.moe, params["ffn"], h, use_kernel)
    else:
        y = mlp_apply(params["ffn"], h)
    return x + y, ({"attn": c} if c is not None else None), aux


def stack_decl(cfg, slots: List[BlockSpec], periods: int) -> Dict[str, Any]:
    return {
        f"slot{i}": tree_map(lambda d: d.stacked(periods), block_decl(cfg, s))
        for i, s in enumerate(slots)
    }


def stack_apply(
    cfg,
    slots: List[BlockSpec],
    params: Dict[str, Any],
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict[str, Any]] = None,
    cache_view: Optional[Dict[str, torch.Tensor]] = None,
    use_kernel: bool = False,
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Python loop over periods. ``cache`` leaves have the leading
    ``(periods,)`` dim and are updated in place; with ``return_cache`` the
    per-layer k/v are stacked into a new ``(periods, B, S, KV, hd)`` cache.
    Aux losses are summed over layers."""
    periods = params["slot0"]["norm1"]["scale"].shape[0]
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
    per_layer: Dict[str, list] = {}
    for p in range(periods):
        for i, spec in enumerate(slots):
            sk = f"slot{i}"
            layer_params = tree_map(lambda t: t[p], params[sk])
            layer_cache = tree_map(lambda t: t[p], cache[sk]) if cache else None
            x, nc, a = block_apply(
                cfg, spec, layer_params, x, positions, layer_cache, cache_view,
                use_kernel, return_cache,
            )
            for k in AUX_KEYS:
                if k in a:
                    aux[k] = aux[k] + a[k]
            if return_cache:
                per_layer.setdefault(sk, []).append(nc)
    new_cache = None
    if return_cache:
        new_cache = {
            sk: tree_map(lambda *ts: torch.stack(ts), *layers)
            for sk, layers in per_layer.items()
        }
    elif cache:
        new_cache = cache
    return x, new_cache, aux


def block_cache_decl(cfg, spec: BlockSpec, batch: int, cache_len: int) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
    axes = ("batch", "cache_seq", None, None)
    return {"attn": {"k": ParamDecl(shape, axes, "zeros", dt), "v": ParamDecl(shape, axes, "zeros", dt)}}


def stack_cache_decl(cfg, slots: List[BlockSpec], periods: int, batch: int, cache_len: int) -> Dict[str, Any]:
    return {
        f"slot{i}": tree_map(lambda d: d.stacked(periods), block_cache_decl(cfg, s, batch, cache_len))
        for i, s in enumerate(slots)
    }
