"""GQA attention: training/prefill without a cache and single-token decode
against the ring-buffer KV cache (port of the GQA part of
``repro.models.attention``).

``attention_core`` has the JAX package's three routes:

* kernel — ``use_kernel`` and ``Sq == Sk > 8`` and ``dk == dv``: the flash
  forward kernel (``kernels/ops.flash_attention``), which assumes the
  contiguous right-aligned positions every full-sequence caller passes;
* direct — materialises fp32 scores; decode and short sequences;
* blockwise — online softmax over ``_KV_BLOCK`` key blocks (forward only
  here) for long sequences.

Not in this slice: the paged-cache branch, MLA and cross-attention.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import rope_apply
from repro_torch.params import ParamDecl

NEG_INF = -1e30
_BLOCKWISE_MIN_SEQ = 2048
_KV_BLOCK = 1024


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int], causal: bool = True) -> torch.Tensor:
    """(B,Sq,Sk) validity mask: causal, windowed, and slot-valid (k_pos>=0)."""
    q = q_pos[:, :, None].long()
    k = k_pos[:, None, :].long()
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (k > q - window)
    return m


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    causal: bool = True,
    use_kernel: bool = False,
) -> torch.Tensor:
    """q: (B,Sq,H,dk) k: (B,Sk,KV,dk) v: (B,Sk,KV,dv); H % KV == 0.
    q_pos: (B,Sq), k_pos: (B,Sk). Returns (B,Sq,H,dv) in v's dtype."""
    B, Sq, H, dk = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dv = v.shape[-1]
    scale = scale if scale is not None else dk ** -0.5
    if use_kernel and Sq == Sk and Sq > 8 and dk == dv:
        from repro_torch.kernels.ops import flash_attention

        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, scale=float(scale),
        ).to(v.dtype)
    qg = q.reshape(B, Sq, KV, G, dk)
    if Sq <= 8 or Sk <= _BLOCKWISE_MIN_SEQ or Sk % _KV_BLOCK != 0:
        # operands are upcast exactly, so the fp32 products and sums are
        # those of the JAX einsum with preferred_element_type=float32
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
        mask = _mask(q_pos, k_pos, window, causal)[:, None, None]
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, -1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(), v.float())
        return out.reshape(B, Sq, H, dv).to(v.dtype)
    out, _, _ = _bw_forward(qg, k, v, q_pos, k_pos, window, scale, causal)
    return out.reshape(B, Sq, H, dv).to(v.dtype)


def _bw_forward(qg, k, v, q_pos, k_pos, window: Optional[int], scale: float, causal: bool):
    """Online-softmax forward over ``_KV_BLOCK`` key blocks. qg:
    (B,Sq,KV,G,dk). Returns (out fp32 (B,Sq,KV,G,dv), m, l)."""
    B, Sq, KV, G, dk = qg.shape
    Sk, dv = k.shape[1], v.shape[-1]
    qf = qg.float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Sq, KV, G, dv), dtype=torch.float32, device=qg.device)
    for s0 in range(0, Sk, _KV_BLOCK):
        kb, vb = k[:, s0:s0 + _KV_BLOCK], v[:, s0:s0 + _KV_BLOCK]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb.float()) * scale
        msk = _mask(q_pos, k_pos[:, s0:s0 + _KV_BLOCK], window, causal)[:, None, None]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(vb.dtype).float(), vb.float())
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l.permute(0, 3, 1, 2)[..., None], m, l


def gqa_decl(cfg) -> Dict[str, Any]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = torch.bfloat16
    decls: Dict[str, Any] = {
        "wq": ParamDecl((D, H, hd), ("embed", "heads", "head_dim"), "fan_in", dt),
        "wk": ParamDecl((D, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in", dt),
        "wv": ParamDecl((D, KV, hd), ("embed", "kv_heads", "head_dim"), "fan_in", dt),
        "wo": ParamDecl((H, hd, D), ("heads", "head_dim", "embed"), "fan_in", dt),
    }
    if cfg.qkv_bias:
        decls["bq"] = ParamDecl((H, hd), ("heads", "head_dim"), "zeros", dt)
        decls["bk"] = ParamDecl((KV, hd), ("kv_heads", "head_dim"), "zeros", dt)
        decls["bv"] = ParamDecl((KV, hd), ("kv_heads", "head_dim"), "zeros", dt)
    return decls


def gqa_apply(
    cfg,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_view: Optional[Dict[str, torch.Tensor]] = None,
    causal: bool = True,
    return_kv: bool = False,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D). Without ``cache``: full-sequence attention (``return_kv``
    hands back this layer's k/v for the prefill cache). With ``cache`` and
    a ring ``cache_view`` (``slot``/``slot_pos``, S == 1): decode. The ring
    write updates ``cache["k"]``/``cache["v"]`` in place (JAX returns new
    arrays; the port saves the copy). Returns (out, cache layer or None)."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_core(
            q, k, v, positions, positions,
            cfg.sliding_window if causal else None, causal=causal,
            use_kernel=use_kernel,
        )
        new_cache = {"k": k, "v": v} if return_kv else None
    else:
        if cache_view is None or "slot" not in cache_view or S != 1:
            raise NotImplementedError(
                "only the ring-cache decode view is ported (paged cache: "
                "ROADMAP queue 1, 'paged serving')"
            )
        rows = torch.arange(B, device=x.device)
        slot = cache_view["slot"]
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        out = attention_core(
            q, cache["k"], cache["v"], positions, cache_view["slot_pos"],
            cfg.sliding_window,
        )
        new_cache = cache
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), new_cache
