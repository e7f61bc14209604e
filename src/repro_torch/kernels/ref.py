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
