"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``
for the serving and training slices). A CUDA tensor launches the
hand-written kernel and raises if it cannot; a CPU tensor takes the plain
version. ``grouped_gemm``, ``expert_gemm`` and ``flash_attention`` are
differentiable on both devices (``expert_gemm.GroupedGemm``,
``expert_gemm.ExpertGemm``, ``expert_gemm.FusedMoe`` under
``grouped_gemm_fused``, ``flash_attention.FlashAttention``:
hand-written backward kernels on the card, their plain versions on the
CPU), so a training step runs forward and backward on the kernel path. No
autotuner: the CUDA kernels have fixed tiles.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import expert_gemm as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa


def grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """Group-size-aware grouped GEMM over the flat expert-sorted layout:
    (N_pad, D) rows, each expert's region ``row_block``-aligned,
    ``group_sizes`` (E,) valid rows per expert."""
    return _eg.grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block)


def grouped_gemm_q8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes,
                    row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """int8-weight grouped GEMM over the sorted layout: int8 (E, D, F) /
    (E, F, D) weights with bf16 per-output-channel scales (E, F) / (E, D),
    applied to the fp32 sums. Forward only."""
    return _eg.grouped_gemm_q8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)


def grouped_gemm_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                       row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """Dispatch-in-kernel sorted MoE FFN, token-major (T, D) in and out:
    ``token``/``dest``/``slot`` (N,) place each sorted assignment, whose
    gather runs in the gate/up kernel's prologue and whose gate-weighted
    combine (``gate_sorted``, fp32) runs in the down kernel's epilogue.
    Differentiable; the CUDA kernels take only ``row_block`` 128."""
    return _eg.grouped_gemm_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block)


def grouped_gemm_fused_q8(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot,
                          gate_sorted, row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """int8-weight fused-dispatch sorted MoE FFN (scales as in
    :func:`grouped_gemm_q8`). Forward only."""
    return _eg.grouped_gemm_fused_q8(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest,
                                     slot, gate_sorted, row_block)


def _fold_groups(fn, xe, *weights) -> torch.Tensor:
    """Run the padded FFN ``fn`` on (..., E, C, D): leading group dims fold
    into each expert's slots, as the JAX ``ops.expert_gemm`` does, so the
    kernel sees (E, G*C, D) and reads each expert's weights and scales
    once."""
    lead = xe.shape[:-3]
    E, C, D = xe.shape[-3:]
    if not lead:
        return fn(xe, *weights)
    x3 = xe.reshape(-1, E, C, D).transpose(0, 1).reshape(E, -1, D)
    y = fn(x3.contiguous(), *weights)
    return y.reshape(E, -1, C, D).transpose(0, 1).reshape(*lead, E, C, D)


def expert_gemm(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """Padded expert FFN: (..., E, C, D) -> (..., E, C, D)."""
    return _fold_groups(_eg.expert_gemm, xe, w_gate, w_up, w_down)


def expert_gemm_q8(xe, w_gate, w_up, w_down, s_gate, s_up, s_down) -> torch.Tensor:
    """int8-weight padded expert FFN, (..., E, C, D) -> (..., E, C, D):
    int8 (E, D, F) / (E, F, D) weights with bf16 per-output-channel scales
    (E, F) / (E, D) applied to the fp32 sums (kernels #8/#9). Forward
    only."""
    return _fold_groups(_eg.expert_gemm_q8, xe, w_gate, w_up, w_down, s_gate, s_up, s_down)


def grouped_gemm_ragged(xs, w_gate, w_up, w_down, group_sizes) -> torch.Tensor:
    """Plain path over the compact buffer (``row_block=1``), the
    counterpart of the JAX package's ``grouped_gemm_xla``: each product
    rounds to the input dtype as ``lax.ragged_dot`` does, and ``silu`` runs
    in fp32 on the rounded gate. Rows past the last group are zero."""
    out = torch.zeros((xs.shape[0], w_down.shape[-1]), dtype=xs.dtype, device=xs.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        if g:
            x = xs[start:start + g]
            h = F.silu((x @ w_gate[e]).float()).to(xs.dtype) * (x @ w_up[e])
            out[start:start + g] = h @ w_down[e]
        start += g
    return out


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,d), k/v (B,Sk,KV,d) -> (B,Sq,H,d); right-aligned
    positions, causal and/or sliding window."""
    return _fa.flash_attention(q, k, v, causal, window, scale)


def paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                    window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode against the block-table KV pool: q (B,H,d),
    pools (num_pages, page_size, KV, d), block_table (B, max_pages) int32
    (-1 = unassigned), seq_lens (B,). The kernel resolves the pages
    itself; no gathered copy."""
    return _pa.paged_attention(q, k_pool, v_pool, block_table, seq_lens, window, scale)


def paged_attention_q8(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                       window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """int8-KV decode: int8 pools with per-token / KV-head fp32 scale
    sidecars shaped (num_pages, page_size, KV, 1), dequantised in the
    kernel's tile."""
    return _pa.paged_attention_q8(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                                  window, scale)


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {**_eg.LAUNCHES, **_fa.LAUNCHES, **_pa.LAUNCHES}


def reset_launch_counts() -> None:
    for d in (_eg.LAUNCHES, _fa.LAUNCHES, _pa.LAUNCHES):
        for k in d:
            d[k] = 0
