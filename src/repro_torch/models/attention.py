"""Attention (port of ``repro.models.attention``): GQA for training and
prefill without a cache, single-token decode against the ring-buffer KV
cache, decode / chunked prefill against the shared KV page pool, and
cross-attention over precomputed encoder keys; MLA (Multi-head Latent
Attention, minicpm3), which expands its latent to per-head K/V in training
and prefill and decodes absorbed, in the latent space, over its ``ckv`` /
``krope`` ring.

``attention_core`` has the JAX package's three routes:

* kernel — ``use_kernel`` and ``Sq == Sk > 8`` and ``dk == dv``: the flash
  forward kernel (``kernels/ops.flash_attention``), which assumes the
  contiguous right-aligned positions every full-sequence caller passes;
* direct — materialises fp32 scores; decode and short sequences;
* blockwise — online softmax over ``_KV_BLOCK`` key blocks (forward only
  here) for long sequences.

MLA's prefill (dk = nope + rope != dv) and cross-attention take the plain
routes, as in the JAX package: the flash kernel needs dk == dv, and the
JAX cross-attention passes no ``use_kernel``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quant import dequantize_kv, quantize_kv
from repro_torch.models.layers import norm_apply, norm_decl, rope_apply
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
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D). Without ``cache``: full-sequence attention (``return_kv``
    hands back this layer's k/v for the prefill cache). With ``cache`` and
    a ring ``cache_view`` (``slot``/``slot_pos``, S == 1): decode. With a
    paged ``cache_view`` (``page_table``...): decode or a prefill chunk
    against the layer's slice of the page pool. Cache writes update the
    cache tensors in place (JAX returns new arrays; the port saves the
    copy). ``cross_kv`` = (k, v, k_pos), the encoder's keys and values:
    cross-attention, non-causal, no RoPE, the plain route. Returns (out,
    cache layer or None)."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cross_kv is not None:
        if "bq" in params:
            q = q + params["bq"]
        k, v, k_pos = cross_kv
        out = attention_core(q, k, v, positions, k_pos, None, causal=False)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), None
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
    elif cache_view is not None and "page_table" in cache_view:
        out = _paged_attention(cfg, cache, cache_view, q, k, v, positions, use_kernel)
        new_cache = cache
    else:
        if cache_view is None or "slot" not in cache_view or S != 1:
            raise ValueError("a ring-cache decode needs cache_view slot/slot_pos and S == 1")
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


def _paged_attention(cfg, cache, cache_view, q, k, v, positions, use_kernel: bool) -> torch.Tensor:
    """Paged decode / chunked prefill against this layer's pool slice
    ``cache`` (``k``/``v`` (num_pages, ps, KV, hd), and for int8 pages the
    ``k_scale``/``v_scale`` sidecars (num_pages, ps, KV, 1)). ``cache_view``:
    ``page_table`` (B, maxP); ``write_page``/``write_offset`` (B, S), the
    scatter targets (padded and idle positions go to the trash page);
    ``k_pos`` (B, maxP*ps), -1 for masked slots; ``seq_lens`` (B,).

    The new k/v are scattered into the pool first (in place; int8 pages
    are quantised on the scatter, their scales written at the same place),
    then ``use_kernel`` and S == 1 take the paged-attention kernel; any
    other call gathers the pages and runs ``attention_core`` without
    ``use_kernel``, as the JAX branch does. A row's table may hold shared
    prefix pages, but the write targets only pages past its prefilled
    boundary: the scheduler clones a shared page before any chunk can
    write into it."""
    from repro_torch.kernels import ops

    B, S = q.shape[:2]
    wp = cache_view["write_page"].long()
    wo = cache_view["write_offset"].long()
    quant = "k_scale" in cache
    if quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][wp, wo] = kq
        cache["v"][wp, wo] = vq
        cache["k_scale"][wp, wo] = ks
        cache["v_scale"][wp, wo] = vs
    else:
        cache["k"][wp, wo] = k.to(cache["k"].dtype)
        cache["v"][wp, wo] = v.to(cache["v"].dtype)
    if use_kernel and S == 1:
        args = (cache_view["page_table"], cache_view["seq_lens"])
        if quant:
            out = ops.paged_attention_q8(q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                                         cache["v_scale"], *args, window=cfg.sliding_window)
        else:
            out = ops.paged_attention(q[:, 0], cache["k"], cache["v"], *args,
                                      window=cfg.sliding_window)
        return out[:, None]
    KVh, hd = cache["k"].shape[2], cache["k"].shape[3]
    bt = cache_view["page_table"].long().clamp_min(0)
    if quant:
        kg = dequantize_kv(cache["k"][bt], cache["k_scale"][bt], q.dtype)
        vg = dequantize_kv(cache["v"][bt], cache["v_scale"][bt], q.dtype)
    else:
        kg, vg = cache["k"][bt], cache["v"][bt]
    return attention_core(q, kg.reshape(B, -1, KVh, hd), vg.reshape(B, -1, KVh, hd), positions,
                          cache_view["k_pos"], cfg.sliding_window)


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention), MiniCPM3 / DeepSeek-V2 style
# ---------------------------------------------------------------------------


def mla_decl(cfg) -> Dict[str, Any]:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = torch.bfloat16
    return {
        "wq_a": ParamDecl((D, m.q_lora_rank), ("embed", "lora"), "fan_in", dt),
        "q_norm": norm_decl(m.q_lora_rank),
        "wq_b": ParamDecl((m.q_lora_rank, H, qk), ("lora", "heads", "head_dim"), "fan_in", dt),
        "wkv_a": ParamDecl((D, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "lora"), "fan_in", dt),
        "kv_norm": norm_decl(m.kv_lora_rank),
        "wkv_b": ParamDecl((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                           ("lora", "heads", "head_dim"), "fan_in", dt),
        "wo": ParamDecl((H, m.v_head_dim, D), ("heads", "head_dim", "embed"), "fan_in", dt),
    }


def mla_apply(
    cfg,
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_view: Optional[Dict[str, torch.Tensor]] = None,
    return_kv: bool = False,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D). Without ``cache`` (training, prefill): the latent
    ``ckv`` (B,S,kv_lora) is expanded to per-head K/V and attended through
    ``attention_core`` (dk = nope + rope, dv = v_head_dim: the plain
    routes); ``return_kv`` hands back {``ckv``, ``krope``} for the prefill
    cache. With ``cache`` and a ring ``cache_view`` (S == 1): the absorbed
    decode, which writes this token's latent and RoPE key into the ring in
    place and attends in the latent space, queries absorbed through
    ``wkv_b``'s K half and the output through its V half."""
    m = cfg.mla
    B, S, D = x.shape
    nope, rope_d = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = (nope + rope_d) ** -0.5

    q_lat = norm_apply(params["q_norm"], torch.einsum("bsd,dr->bsr", x, params["wq_a"]))
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :nope], rope_apply(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])
    ckv = norm_apply(params["kv_norm"], ckv_full[..., :m.kv_lora_rank])
    k_rope = rope_apply(ckv_full[..., m.kv_lora_rank:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache is None:
        kv = torch.einsum("bsr,rhk->bshk", ckv, params["wkv_b"])
        k_nope, v = kv[..., :nope], kv[..., nope:]
        H = q.shape[2]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)], -1)
        qf = torch.cat([q_nope, q_rope], -1)
        out = attention_core(qf, k, v, positions, positions, cfg.sliding_window, scale, use_kernel=use_kernel)
        out = torch.einsum("bshv,hvd->bsd", out, params["wo"])
        return out, ({"ckv": ckv, "krope": k_rope} if return_kv else None)

    if cache_view is None or "slot" not in cache_view or S != 1:
        raise ValueError("MLA decodes against the ring cache only: cache_view slot/slot_pos and S == 1")
    rows = torch.arange(B, device=x.device)
    slot = cache_view["slot"]
    cache["ckv"][rows, slot] = ckv[:, 0].to(cache["ckv"].dtype)
    cache["krope"][rows, slot] = k_rope[:, 0].to(cache["krope"].dtype)
    ckv_c, kr_c = cache["ckv"], cache["krope"]
    w_uk, w_uv = params["wkv_b"][..., :nope], params["wkv_b"][..., nope:]
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
    # fp32 scores from operands upcast exactly (the JAX einsums' fp32 output)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_abs.float(), ckv_c.float())
              + torch.einsum("bqhp,bsp->bhqs", q_rope.float(), kr_c.float())) * scale
    mask = _mask(positions, cache_view["slot_pos"], cfg.sliding_window)[:, None]
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), -1).to(ckv_c.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv_c)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    return torch.einsum("bshv,hvd->bsd", o, params["wo"]), cache


def attention_decl(cfg) -> Dict[str, Any]:
    return mla_decl(cfg) if cfg.use_mla else gqa_decl(cfg)


def attention_apply(cfg, params, x, positions, cache=None, cache_view=None, causal: bool = True,
                    return_kv: bool = False, use_kernel: bool = False):
    """The config's self-attention mixer: MLA with ``cfg.use_mla`` (which
    is always causal), else GQA."""
    if cfg.use_mla:
        return mla_apply(cfg, params, x, positions, cache, cache_view, return_kv, use_kernel)
    return gqa_apply(cfg, params, x, positions, cache, cache_view, causal=causal, return_kv=return_kv,
                     use_kernel=use_kernel)
