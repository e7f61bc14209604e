"""Plain PyTorch versions of the ported kernels (port of the matching
oracles in ``repro.kernels.ref``). Each wrapper in ``kernels/ops.py`` runs
these on a CPU tensor; ``chip_smoke.py`` holds each CUDA kernel against
them on the card.

Operands are upcast to fp32 before every product, so the fp32 sums see the
exact products of the bf16 inputs (the JAX oracles'
``preferred_element_type=float32``); the SwiGLU ``h`` and the attention
probabilities are rounded to the input dtype where the kernels round them.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.segment import row_gather, sorted_row_table, table_sum

NEG_INF = -1e30


def _regions(group_sizes: torch.Tensor, row_block: int):
    """(expert, first row, rows) of each non-empty expert region; reads the
    group sizes on the host (one sync)."""
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        if g:
            yield e, start, g
        start += -(-g // row_block) * row_block


def grouped_gate_up_ref(xs, w_gate, w_up, group_sizes, row_block: int = 1) -> torch.Tensor:
    """Plain version of the gate/up kernel: ``h = silu(x @ Wg[e]) * (x @
    Wu[e])`` in fp32 over each expert's rows, cast to x's dtype; rows past
    ``group_sizes[e]`` come out zero."""
    h = torch.zeros((xs.shape[0], w_gate.shape[-1]), dtype=xs.dtype, device=xs.device)
    for e, s, g in _regions(group_sizes, row_block):
        x = xs[s:s + g].float()
        h[s:s + g] = (F.silu(x @ w_gate[e].float()) * (x @ w_up[e].float())).to(xs.dtype)
    return h


def grouped_down_ref(h, w_down, group_sizes, row_block: int = 1) -> torch.Tensor:
    """Plain version of the down kernel: ``y = h @ Wd[e]`` in fp32 over each
    expert's rows, cast to h's dtype; other rows zero."""
    y = torch.zeros((h.shape[0], w_down.shape[-1]), dtype=h.dtype, device=h.device)
    for e, s, g in _regions(group_sizes, row_block):
        y[s:s + g] = (h[s:s + g].float() @ w_down[e].float()).to(h.dtype)
    return y


def grouped_gemm_ref(
    xs: torch.Tensor,  # (N, D) expert-sorted rows (may be tile-align padded)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    group_sizes: torch.Tensor,  # (E,) valid rows per expert
    row_block: int = 1,
) -> torch.Tensor:
    """Group-size-aware fused SwiGLU FFN over the flat expert-sorted layout.
    Each expert's region starts at its ``row_block``-aligned offset; rows
    past ``group_sizes[e]`` come out zero."""
    h = grouped_gate_up_ref(xs, w_gate, w_up, group_sizes, row_block)
    return grouped_down_ref(h, w_down, group_sizes, row_block)


def expert_gate_up_ref(xe, w_gate, w_up) -> torch.Tensor:
    """Plain version of the padded gate/up kernel (the TPU
    ``_gate_up_kernel``): ``h[e] = silu(xe[e] @ Wg[e]) * (xe[e] @ Wu[e])``
    in fp32 over every slot of ``xe`` (E, C, D), cast to xe's dtype. One
    expert at a time: an fp32 copy of all weights would not fit beside a
    full-width model."""
    h = torch.empty(xe.shape[:-1] + w_gate.shape[-1:], dtype=xe.dtype, device=xe.device)
    for e in range(xe.shape[0]):
        x = xe[e].float()
        h[e] = (F.silu(x @ w_gate[e].float()) * (x @ w_up[e].float())).to(xe.dtype)
    return h


def expert_down_ref(h, w_down) -> torch.Tensor:
    """Plain version of the padded down kernel (``_down_kernel``): ``y[e] =
    h[e] @ Wd[e]`` in fp32, cast to h's dtype."""
    return torch.stack([(h[e].float() @ w_down[e].float()).to(h.dtype) for e in range(h.shape[0])])


def expert_gemm_ref(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """Fused SwiGLU expert FFN over the dense padded ``(E, C, D)`` layout
    (the JAX ``expert_gemm_ref``): every slot is computed."""
    return expert_down_ref(expert_gate_up_ref(xe, w_gate, w_up), w_down)


def expert_gate_up_q8_ref(xe, w_gate, w_up, s_gate, s_up) -> torch.Tensor:
    """Plain version of the padded int8 gate/up kernel (the TPU
    ``_gate_up_kernel_q8``): int8 weights widened (exact), fp32 sums over
    every slot of ``xe`` (E, C, D), each product times its per-column bf16
    scale (E, F) on the fp32 sum before silu, ``h = silu(g) * u`` cast to
    xe's dtype once. One expert at a time, as :func:`expert_gate_up_ref`."""
    h = torch.empty(xe.shape[:-1] + w_gate.shape[-1:], dtype=xe.dtype, device=xe.device)
    for e in range(xe.shape[0]):
        x = xe[e].float()
        g = (x @ w_gate[e].float()) * s_gate[e].float()
        u = (x @ w_up[e].float()) * s_up[e].float()
        h[e] = (F.silu(g) * u).to(xe.dtype)
    return h


def expert_down_q8_ref(h, w_down, s_down) -> torch.Tensor:
    """Plain version of the padded int8 down kernel (``_down_kernel_q8``):
    ``y[e] = (h[e] @ Wd[e]) * sd[e]`` with the (E, D) scale on the fp32
    sum, cast to h's dtype."""
    return torch.stack([((h[e].float() @ w_down[e].float()) * s_down[e].float()).to(h.dtype)
                        for e in range(h.shape[0])])


def expert_gemm_q8_ref(xe, w_gate, w_up, w_down, s_gate, s_up, s_down) -> torch.Tensor:
    """int8-weight fused SwiGLU expert FFN over the dense padded ``(E, C,
    D)`` layout (the JAX ``expert_gemm_q8_ref``): every slot is computed."""
    return expert_down_q8_ref(expert_gate_up_q8_ref(xe, w_gate, w_up, s_gate, s_up), w_down, s_down)


def grouped_gate_up_q8_ref(xs, w_gate, w_up, s_gate, s_up, group_sizes, row_block: int = 1) -> torch.Tensor:
    """Plain version of the int8 grouped gate/up kernel
    (``_grouped_gate_up_kernel_q8``): int8 weights widened (exact), fp32
    sums, each product times its per-column bf16 scale on the fp32 sum
    before silu, ``h = silu(g) * u`` cast to x's dtype; rows past
    ``group_sizes[e]`` zero."""
    h = torch.zeros((xs.shape[0], w_gate.shape[-1]), dtype=xs.dtype, device=xs.device)
    for e, s, g in _regions(group_sizes, row_block):
        x = xs[s:s + g].float()
        gv = (x @ w_gate[e].float()) * s_gate[e].float()
        uv = (x @ w_up[e].float()) * s_up[e].float()
        h[s:s + g] = (F.silu(gv) * uv).to(xs.dtype)
    return h


def grouped_down_q8_ref(h, w_down, s_down, group_sizes, row_block: int = 1) -> torch.Tensor:
    """Plain version of the int8 grouped down kernel
    (``_grouped_down_kernel_q8``): ``y = (h @ Wd[e]) * sd[e]`` with the
    scale on the fp32 sum, cast to h's dtype; other rows zero."""
    y = torch.zeros((h.shape[0], w_down.shape[-1]), dtype=h.dtype, device=h.device)
    for e, s, g in _regions(group_sizes, row_block):
        y[s:s + g] = ((h[s:s + g].float() @ w_down[e].float()) * s_down[e].float()).to(h.dtype)
    return y


def grouped_gemm_q8_ref(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes,
                        row_block: int = 1) -> torch.Tensor:
    """int8-weight grouped FFN over the sorted layout (the JAX
    ``grouped_gemm_q8_ref``)."""
    h = grouped_gate_up_q8_ref(xs, w_gate, w_up, s_gate, s_up, group_sizes, row_block)
    return grouped_down_q8_ref(h, w_down, s_down, group_sizes, row_block)


def _tile_rows_by_expert(tile_group, tile_rows, bc: int):
    """{expert: (valid buffer rows,)} from the per-tile metadata (one host
    read): the rows r < tile_rows[t] of each tile t of the expert."""
    rows: dict = {}
    for t, (e, n) in enumerate(zip(tile_group.tolist(), tile_rows.tolist())):
        if n:
            rows.setdefault(e, []).append(torch.arange(t * bc, t * bc + n, device=tile_group.device))
    return {e: torch.cat(r) for e, r in rows.items()}


def fused_gate_up_ref(x, w_gate, w_up, tok_pad, tile_group, tile_rows, bc: int = 128,
                      s_gate=None, s_up=None) -> torch.Tensor:
    """Plain version of the fused gate/up kernel (``_fused_gate_up_kernel``,
    with the scales ``_fused_gate_up_kernel_q8``): valid buffer row r of
    expert e is ``silu(x[tok_pad[r]] @ Wg[e]) * (x[tok_pad[r]] @ Wu[e])`` in
    fp32 (int8: each product times its per-column scale before silu), cast
    to x's dtype; padding rows are zero. -> h (N_pad, F)."""
    h = torch.zeros((tok_pad.shape[0], w_gate.shape[-1]), dtype=x.dtype, device=x.device)
    for e, rows in _tile_rows_by_expert(tile_group, tile_rows, bc).items():
        xr = x[tok_pad[rows].long()].float()
        g, u = xr @ w_gate[e].float(), xr @ w_up[e].float()
        if s_gate is not None:
            g, u = g * s_gate[e].float(), u * s_up[e].float()
        h[rows] = (F.silu(g) * u).to(x.dtype)
    return h


def fused_down_ref(h, w_down, row_out, gate_pad, tile_group, tile_rows, k: int, T: int, bc: int = 128,
                   s_down=None) -> torch.Tensor:
    """Plain version of the fused down kernel (``_fused_down_kernel``; with
    ``s_down`` ``_fused_down_kernel_q8``): valid buffer row r of expert e
    goes to row ``row_out[r]`` of the (k*T, D) slot partials as ``(h[r] @
    Wd[e]) * gate_pad[r]`` (int8: ``(h[r] @ Wd[e]) * sd[e] * gate_pad[r]``)
    in fp32, rounded to h's dtype once. -> (k, T, D)."""
    out = torch.zeros((k * T, w_down.shape[-1]), dtype=h.dtype, device=h.device)
    for e, rows in _tile_rows_by_expert(tile_group, tile_rows, bc).items():
        acc = h[rows].float() @ w_down[e].float()
        if s_down is not None:
            acc = acc * s_down[e].float()
        out[row_out[rows].long()] = (acc * gate_pad[rows].float()[:, None]).to(h.dtype)
    return out.reshape(k, T, -1)


def fused_gate_up_q8_ref(x, w_gate, w_up, s_gate, s_up, tok_pad, tile_group, tile_rows,
                         bc: int = 128) -> torch.Tensor:
    """Plain version of ``_fused_gate_up_kernel_q8`` (int8 weights widened
    exactly, bf16 scales on the fp32 sums before silu)."""
    return fused_gate_up_ref(x, w_gate, w_up, tok_pad, tile_group, tile_rows, bc, s_gate, s_up)


def fused_down_q8_ref(h, w_down, s_down, row_out, gate_pad, tile_group, tile_rows, k: int, T: int,
                      bc: int = 128) -> torch.Tensor:
    """Plain version of ``_fused_down_kernel_q8``."""
    return fused_down_ref(h, w_down, row_out, gate_pad, tile_group, tile_rows, k, T, bc, s_down)


def combine_partials(partials: torch.Tensor, dtype) -> torch.Tensor:
    """The k-way per-token combine of the (k, T, D) slot partials: an fp32
    sum over the slot planes, cast once (the JAX package does it outside
    its kernels)."""
    return partials.float().sum(0).to(dtype)


def aligned_rows(N: int, E: int, row_block: int) -> int:
    """Rows of the (never materialised, on the fused path) tile-aligned
    sorted buffer: ``sum_e ceil(g_e/b)*b <= N + E*(b-1)``, rounded up to
    whole row tiles (``_aligned_rows``)."""
    if row_block <= 1:
        return N
    return -(-(N + E * (row_block - 1)) // row_block) * row_block


def grouped_gemm_fused_ref(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                           row_block: int = 128) -> torch.Tensor:
    """The function ``_fused_fwd_impl`` computes, (T, D) -> (T, D): gather +
    gate/up, down + gate into bf16 slot partials, fp32 k-way sum, one cast.
    Rounding points are the fused kernels' (each slot partial rounded
    before the sum), not the unfused path's."""
    from repro_torch.kernels.expert_gemm import fused_tables

    T = x.shape[0]
    tok_pad, row_out, gate_pad, tg, tr, k = fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted,
                                                         T, row_block)
    h = fused_gate_up_ref(x, w_gate, w_up, tok_pad, tg, tr, row_block)
    return combine_partials(fused_down_ref(h, w_down, row_out, gate_pad, tg, tr, k, T, row_block), x.dtype)


def grouped_gemm_fused_q8_ref(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot,
                              gate_sorted, row_block: int = 128) -> torch.Tensor:
    """int8-weight counterpart of :func:`grouped_gemm_fused_ref`
    (``_fused_fwd_q8_impl``)."""
    from repro_torch.kernels.expert_gemm import fused_tables

    T = x.shape[0]
    tok_pad, row_out, gate_pad, tg, tr, k = fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted,
                                                         T, row_block)
    h = fused_gate_up_q8_ref(x, w_gate, w_up, s_gate, s_up, tok_pad, tg, tr, row_block)
    return combine_partials(fused_down_q8_ref(h, w_down, s_down, row_out, gate_pad, tg, tr, k, T, row_block),
                            x.dtype)


def fused_unfused_ref(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                      row_block: int = 128, grouped=None) -> torch.Tensor:
    """The unfused sorted-dispatcher composition the fused path replaces
    (``_fused_unfused_ref``): scatter x into the ``row_block``-aligned
    buffer, the grouped FFN (``grouped``, default the plain
    :func:`grouped_gemm_ref`), gather, fp32 gate weighting and each
    token's k-way sum in sorted order (``core.segment``), one cast.
    Differentiable by autograd; the graph the fused backward
    differentiates."""
    grouped = grouped or grouped_gemm_ref
    T, D = x.shape
    N_pad = aligned_rows(token.shape[0], w_gate.shape[0], row_block)
    table = sorted_row_table(token, T)
    xs = x.new_zeros((N_pad, D)).index_put((dest,), row_gather(x, token, table, sentinel=False))
    ys = grouped(xs, w_gate, w_up, w_down, group_sizes, row_block)
    yv = ys[dest].float() * gate_sorted.float()[:, None]
    return table_sum(yv, table, token, sentinel=False).to(x.dtype)


def grouped_bwd_dh_ref(xs, dy, w_gate, w_up, w_down, group_sizes, row_block: int = 1):
    """Plain version of the grouped backward's first pass (the TPU
    ``_grouped_bwd_dh_kernel``): recompute ``g = x @ Wg[e]`` and ``u = x @
    Wu[e]``, ``dh = dy @ Wd[e]^T``, all in fp32, then the SwiGLU backward ->
    (h, dg, du) in x's dtype; rows past ``group_sizes[e]`` are zero."""
    outs = [torch.zeros((xs.shape[0], w_gate.shape[-1]), dtype=xs.dtype, device=xs.device)
            for _ in range(3)]
    for e, s, g in _regions(group_sizes, row_block):
        x = xs[s:s + g].float()
        gv, uv = x @ w_gate[e].float(), x @ w_up[e].float()
        dh = dy[s:s + g].float() @ w_down[e].float().T
        sig = torch.sigmoid(gv)
        silu = gv * sig
        dsilu = sig * (1.0 + gv * (1.0 - sig))
        for out, val in zip(outs, (silu * uv, dh * uv * dsilu, dh * silu)):
            out[s:s + g] = val.to(xs.dtype)
    return tuple(outs)


def grouped_bwd_dx_ref(dg, du, w_gate, w_up, group_sizes, row_block: int = 1):
    """Plain version of the second pass (``_grouped_bwd_dx_kernel``): ``dx =
    dg @ Wg[e]^T + du @ Wu[e]^T`` in fp32, cast to dg's dtype; other rows
    zero."""
    dx = torch.zeros((dg.shape[0], w_gate.shape[1]), dtype=dg.dtype, device=dg.device)
    for e, s, g in _regions(group_sizes, row_block):
        acc = dg[s:s + g].float() @ w_gate[e].float().T + du[s:s + g].float() @ w_up[e].float().T
        dx[s:s + g] = acc.to(dg.dtype)
    return dx


def grouped_bwd_wgrad_expert_ref(xs, dy, h, dg, du, start: int, rows: int):
    """One expert's (dWg, dWu, dWd) in fp32 over its ``rows`` rows from
    ``start`` (zeros when it has none)."""
    D, F = xs.shape[1], h.shape[1]
    if rows == 0:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=xs.device)
        return z(D, F), z(D, F), z(F, D)
    x = xs[start:start + rows].float()
    return (x.T @ dg[start:start + rows].float(), x.T @ du[start:start + rows].float(),
            h[start:start + rows].float().T @ dy[start:start + rows].float())


def grouped_bwd_wgrad_ref(xs, dy, h, dg, du, group_sizes, row_block: int = 1, dtype=None):
    """Plain version of the third pass (``_grouped_bwd_wgrad_kernel``): per
    expert ``dWg = x^T dg``, ``dWu = x^T du``, ``dWd = h^T dy`` summed in fp32
    over the expert's valid rows, then cast once to ``dtype`` (the weights'
    dtype; default x's). An expert with no rows gets zeros."""
    dtype = dtype or xs.dtype
    E, D, F = group_sizes.shape[0], xs.shape[1], h.shape[1]
    dwg = torch.zeros((E, D, F), dtype=dtype, device=xs.device)
    dwu = torch.zeros((E, D, F), dtype=dtype, device=xs.device)
    dwd = torch.zeros((E, F, D), dtype=dtype, device=xs.device)
    for e, s, g in _regions(group_sizes, row_block):
        for out, val in zip((dwg, dwu, dwd), grouped_bwd_wgrad_expert_ref(xs, dy, h, dg, du, s, g)):
            out[e] = val.to(dtype)
    return dwg, dwu, dwd


def grouped_gemm_bwd_ref(xs, dy, w_gate, w_up, w_down, group_sizes, row_block: int = 1):
    """The three plain passes in order -> (dx, dWg, dWu, dWd), as
    ``_grouped_bwd_impl`` chains its kernels."""
    h, dg, du = grouped_bwd_dh_ref(xs, dy, w_gate, w_up, w_down, group_sizes, row_block)
    dx = grouped_bwd_dx_ref(dg, du, w_gate, w_up, group_sizes, row_block)
    return (dx, *grouped_bwd_wgrad_ref(xs, dy, h, dg, du, group_sizes, row_block, w_gate.dtype))


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, d)
    k: torch.Tensor,  # (B, Sk, KV, d), H % KV == 0
    v: torch.Tensor,  # (B, Sk, KV, d)
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal / sliding-window attention with implicit right-aligned
    positions (query i sits at position ``i + Sk - Sq``). GQA broadcasts
    each KV head to its ``H // KV`` query heads. With ``return_lse`` also
    returns the fp32 logsumexp (B*H, Sq) the flash kernel emits."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kb = k.repeat_interleave(H // KV, dim=2).float()
    vb = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb) * scale
    qp = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kp = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vb.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(s, -1).reshape(B * H, Sq)
    return out


def _flash_bwd_probs(q, k, v, do, lse, delta, causal, window, scale):
    """Shared recompute of the flash backward in fp32, per query head (KV
    heads broadcast): p = exp(s - lse) (0 on masked pairs), ds = p (dp -
    delta) scale. Returns (p, ds) as (B, H, Sq, Sk) and the broadcast k."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kb = k.repeat_interleave(G, dim=2).float()
    vb = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb) * scale
    qp = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kp = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, H, Sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vb)
    ds = p * (dp - delta.reshape(B, H, Sq, 1)) * scale
    return p, ds, kb


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = True, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash dq kernel (``_fa_bwd_dq_kernel``), fp32
    throughout as the TPU kernel computes it: ``dq = ds k``. q, do (B, Sq,
    H, d); k, v (B, Sk, KV, d); lse, delta (B*H, Sq) fp32. Returns dq in q's
    dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, kb = _flash_bwd_probs(q, k, v, do, lse, delta, causal, window, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kb).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash dk/dv kernel (``_fa_bwd_dkv_kernel``):
    ``dv = p^T do`` and ``dk = ds^T q`` in fp32, summed over the G query
    heads of each KV head. Returns (dk, dv) (B, Sk, KV, d) in k's dtype."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    p, ds, _ = _flash_bwd_probs(q, k, v, do, lse, delta, causal, window, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).reshape(B, Sk, KV, H // KV, d).sum(3)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(B, Sk, KV, H // KV, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, laid out (B*H, Sq) like the lse
    (the JAX package computes it in XLA, outside its kernels)."""
    B, Sq, H, _ = out.shape
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(B * H, Sq).contiguous()


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, d) one query token per sequence
    k_pool: torch.Tensor,  # (num_pages, page_size, KV, d) shared page pool
    v_pool: torch.Tensor,  # (num_pages, page_size, KV, d)
    block_table: torch.Tensor,  # (B, max_pages) page ids, -1 = unassigned
    seq_lens: torch.Tensor,  # (B,) tokens valid per sequence (incl. current)
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather oracle of the paged-attention decode kernel. Logical KV slot
    ``j`` of sequence ``b`` lives at ``pool[block_table[b, j // ps], j %
    ps]``; slots at or past ``seq_lens[b]``, under an unassigned page or
    (with a window) at or below ``seq_lens[b] - 1 - window`` are masked. A
    row with no live slot (an idle batch slot) gives zeros. Returns (B, H,
    d) in the pool's dtype; the probabilities are rounded to it before
    P·V."""
    B, H, d = q.shape
    ps, KV = k_pool.shape[1], k_pool.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    bt = block_table.long().clamp_min(0)
    kg = k_pool[bt].reshape(B, -1, KV, d)  # (B, maxP*ps, KV, d)
    vg = v_pool[bt].reshape(B, -1, KV, d)
    kpos = torch.arange(kg.shape[1], device=q.device)
    sl = seq_lens.long()[:, None]
    valid = (kpos[None] < sl) & (block_table >= 0)[:, kpos // ps]
    if window is not None:
        valid = valid & (kpos[None] > sl - 1 - window)
    qg = q.reshape(B, KV, G, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kg.float()) * scale
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(vg.dtype).float(), vg.float())
    out = torch.where(valid.any(-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, H, d).to(v_pool.dtype)


def paged_attention_q8_ref(
    q: torch.Tensor,  # (B, H, d)
    k_pool: torch.Tensor,  # (num_pages, page_size, KV, d) int8
    v_pool: torch.Tensor,  # (num_pages, page_size, KV, d) int8
    k_scale: torch.Tensor,  # (num_pages, page_size, KV, 1) per-token scales
    v_scale: torch.Tensor,  # (num_pages, page_size, KV, 1)
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """int8-KV oracle: dequantise the pools to fp32, run
    :func:`paged_attention_ref` wholly in fp32, cast to q's dtype."""
    kd = k_pool.float() * k_scale.float()
    vd = v_pool.float() * v_scale.float()
    out = paged_attention_ref(q.float(), kd, vd, block_table, seq_lens, window, scale)
    return out.to(q.dtype)
