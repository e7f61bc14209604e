"""Block stacks: dense, MoE, SSM, hybrid (jamba) and encoder-decoder (port
of ``repro.models.transformer``).

Layers are organised as (periods x slots): a slot is one block kind (mixer
attention or SSM, FFN dense, MoE or none, optionally a cross-attention
sub-block); each slot's parameters carry a leading ``(periods,)`` dim, and
:func:`stack_apply` loops over periods in Python where the JAX package
scans. Jamba's period is 8 slots, "MMMAMMMM", with MoE on the odd ones.
In training with ``cfg.remat != "none"`` each
period's body runs under ``torch.utils.checkpoint`` (the counterpart of
``jax.checkpoint(body)``): only its inputs are kept, and the backward
recomputes it.

Noisy gating draws its N(0, 1) here, from ``gen``, one (B*S, E) tensor per
MoE layer in layer order, before the layer's period runs, and hands it to
the period as an input: ``torch.utils.checkpoint`` restores only the
default generators' states, so a draw inside the checkpointed body would
take other numbers in the recompute (other noise, wrong gradients, no
error). Remat and no remat therefore see the same noise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.moe import moe_apply, moe_decl
from repro_torch.core.router import gating_noise
from repro_torch.models.attention import attention_apply, attention_decl, gqa_apply, gqa_decl
from repro_torch.models.layers import mlp_apply, mlp_decl, norm_apply, norm_decl
from repro_torch.models.ssm import ssm_apply, ssm_cache_decl, ssm_decl
from repro_torch.params import ParamDecl, torch_dtype, tree_map

AUX_KEYS = ("load_balance_loss", "z_loss")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # 'attn' | 'ssm'
    ffn: str  # 'dense' | 'moe' | 'none'
    cross_attn: bool = False
    causal: bool = True


def build_slots(cfg) -> List[BlockSpec]:
    """Slot list for one period of the decoder stack: one SSM slot (ssm);
    the hybrid pattern, stretched to a multiple of the MoE frequency, MoE
    on every ``moe_layer_freq``-th slot (hybrid); else ``moe_layer_freq``
    attention slots, the last one MoE, each with cross-attention in an
    encdec decoder."""
    moe = cfg.moe
    freq = moe.moe_layer_freq if moe is not None else 1
    if cfg.family == "ssm":
        return [BlockSpec("ssm", "dense" if cfg.d_ff else "none")]
    if cfg.family == "hybrid":
        pat = cfg.hybrid_pattern or "M"
        period = len(pat) * (freq if moe is not None and len(pat) % freq else 1)
        return [BlockSpec("ssm" if pat[i % len(pat)] == "M" else "attn",
                          "moe" if (moe is not None and i % freq == freq - 1) else "dense")
                for i in range(period)]
    return [
        BlockSpec("attn", "moe" if (moe is not None and i == freq - 1) else "dense",
                  cross_attn=cfg.family == "encdec")
        for i in range(freq)
    ]


def periods_for(cfg, slots: List[BlockSpec]) -> int:
    assert cfg.num_layers % len(slots) == 0, (cfg.num_layers, len(slots))
    return cfg.num_layers // len(slots)


def block_decl(cfg, spec: BlockSpec) -> Dict[str, Any]:
    decls: Dict[str, Any] = {
        "norm1": norm_decl(cfg.d_model, cfg.norm_type),
        "mixer": ssm_decl(cfg) if spec.mixer == "ssm" else attention_decl(cfg),
    }
    if spec.cross_attn:
        decls["norm_cross"] = norm_decl(cfg.d_model, cfg.norm_type)
        decls["cross"] = gqa_decl(cfg)
    if spec.ffn != "none":
        decls["norm2"] = norm_decl(cfg.d_model, cfg.norm_type)
        decls["ffn"] = moe_decl(cfg, cfg.moe) if spec.ffn == "moe" else mlp_decl(cfg.d_model, cfg.d_ff)
    return decls


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
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    noise: Optional[torch.Tensor] = None,
    cross_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """One block: mixer (SSM, or self-attention: MLA or GQA, causal or
    not), the cross-attention sub-block over ``cross_ctx`` = (encoder
    output, its positions) or the cached cross K/V, then the FFN. Returns
    (x, this block's cache or None, aux losses). ``valid`` (B,) masks the
    SSM state's pad positions (bucketed prefill)."""
    h = norm_apply(params["norm1"], x, cfg.norm_type, cfg.norm_eps)
    new_cache: Dict[str, Any] = {}
    if spec.mixer == "ssm":
        mix, c = ssm_apply(cfg, params["mixer"], h, cache["ssm"] if cache else None, return_cache, valid)
        key = "ssm"
    else:
        mix, c = attention_apply(cfg, params["mixer"], h, positions, cache["attn"] if cache else None,
                                 cache_view, causal=spec.causal, return_kv=return_cache, use_kernel=use_kernel)
        key = "attn"
    if c is not None:
        new_cache[key] = c
    x = x + mix
    if spec.cross_attn:
        h = norm_apply(params["norm_cross"], x, cfg.norm_type, cfg.norm_eps)
        if cache is not None and "cross" in cache:
            ck, cv, cp = cache["cross"]["k"], cache["cross"]["v"], cache_view["enc_pos"]
            new_cache["cross"] = cache["cross"]
        else:
            enc_out, cp = cross_ctx
            ck = torch.einsum("bsd,dhk->bshk", enc_out, params["cross"]["wk"])
            cv = torch.einsum("bsd,dhk->bshk", enc_out, params["cross"]["wv"])
        cx, _ = gqa_apply(cfg, params["cross"], h, positions, cross_kv=(ck, cv, cp))
        x = x + cx
    aux: Dict[str, torch.Tensor] = {}
    if spec.ffn != "none":
        h = norm_apply(params["norm2"], x, cfg.norm_type, cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_apply(cfg, cfg.moe, params["ffn"], h, use_kernel, gen, train, noise)
        else:
            y = mlp_apply(params["ffn"], h)
        x = x + y
    return x, (new_cache or None), aux


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
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    cross_ctx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Python loop over periods. ``cache`` leaves have the leading
    ``(periods,)`` dim and are updated in place; with ``return_cache`` the
    per-layer caches (attention k/v or MLA's ckv/krope over the sequence,
    the SSM's conv tail and state) are stacked into a new ``(periods, B,
    ...)`` cache. Aux losses are summed over layers. With ``train`` and
    ``cfg.remat != "none"`` (and no cache) each period's body is
    checkpointed. ``cross_ctx`` and ``valid`` go to every block."""
    periods = params["slot0"]["norm1"]["scale"].shape[0]
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
    per_layer: Dict[str, list] = {}
    remat = (train and cfg.remat != "none" and cache is None and not return_cache
             and torch.is_grad_enabled())

    B, S = x.shape[:2]

    def draw_noise():
        """Each MoE slot's gating noise of one period (None elsewhere)."""
        return {f"slot{i}": gating_noise(cfg.moe, (B * S, cfg.moe.num_experts), x.device, gen, train)
                for i, spec in enumerate(slots) if spec.ffn == "moe"}

    def body(x, period_params, period_cache, period_noise):
        period_aux, period_kv = [], {}
        for i, spec in enumerate(slots):
            sk = f"slot{i}"
            x, nc, a = block_apply(
                cfg, spec, period_params[sk], x, positions,
                period_cache[sk] if period_cache else None, cache_view,
                use_kernel, return_cache, gen, train, period_noise.get(sk), cross_ctx, valid,
            )
            period_aux.append(a)
            period_kv[sk] = nc
        sums = [sum(a[k] for a in period_aux if k in a) for k in AUX_KEYS]
        return (x, *(torch.as_tensor(v, dtype=torch.float32, device=x.device) for v in sums)), period_kv

    for p in range(periods):
        period_params = {sk: tree_map(lambda t: t[p], params[sk]) for sk in params}
        period_cache = {sk: tree_map(lambda t: t[p], cache[sk]) for sk in cache} if cache else None
        period_noise = draw_noise()
        if remat:
            out = checkpoint(lambda x, pp, pn: body(x, pp, None, pn)[0], x, period_params, period_noise,
                             use_reentrant=False)
            period_kv = {}
        else:
            out, period_kv = body(x, period_params, period_cache, period_noise)
        x = out[0]
        for k, v in zip(AUX_KEYS, out[1:]):
            aux[k] = aux[k] + v
        if return_cache:
            for sk, nc in period_kv.items():
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


def block_cache_decl(cfg, spec: BlockSpec, batch: int, cache_len: int, enc_len: int = 0) -> Dict[str, Any]:
    """One block's decode cache: the SSM's conv tail and state, MLA's
    latent ``ckv`` and RoPE key ``krope`` rings, or GQA's k/v rings; plus
    the cross-attention k/v over ``enc_len`` encoder positions."""
    dt = torch_dtype(cfg.dtype)
    out: Dict[str, Any] = {}
    if spec.mixer == "ssm":
        out["ssm"] = ssm_cache_decl(cfg, batch)
    elif cfg.use_mla:
        m = cfg.mla
        out["attn"] = {
            "ckv": ParamDecl((batch, cache_len, m.kv_lora_rank), ("batch", "cache_seq", None), "zeros", dt),
            "krope": ParamDecl((batch, cache_len, m.qk_rope_head_dim), ("batch", "cache_seq", None), "zeros", dt),
        }
    else:
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)
        axes = ("batch", "cache_seq", None, None)
        out["attn"] = {"k": ParamDecl(shape, axes, "zeros", dt), "v": ParamDecl(shape, axes, "zeros", dt)}
    if spec.cross_attn:
        shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim_)
        axes = ("batch", None, "kv_heads", None)
        out["cross"] = {"k": ParamDecl(shape, axes, "zeros", dt), "v": ParamDecl(shape, axes, "zeros", dt)}
    return out


def stack_cache_decl(cfg, slots: List[BlockSpec], periods: int, batch: int, cache_len: int,
                     enc_len: int = 0) -> Dict[str, Any]:
    return {
        f"slot{i}": tree_map(lambda d: d.stacked(periods), block_cache_decl(cfg, s, batch, cache_len, enc_len))
        for i, s in enumerate(slots)
    }
