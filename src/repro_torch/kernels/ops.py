"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``
for the ring-serving slice). A CUDA tensor launches the hand-written
kernel and raises if it cannot; a CPU tensor takes the plain version. No
autotuner: the CUDA kernels have fixed tiles.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import expert_gemm as _eg
from repro_torch.kernels import flash_attention as _fa


def grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """Group-size-aware grouped GEMM over the flat expert-sorted layout:
    (N_pad, D) rows, each expert's region ``row_block``-aligned,
    ``group_sizes`` (E,) valid rows per expert."""
    return _eg.grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block)


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
    return _fa.flash_fwd(q, k, v, causal, window, scale)[0]


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {**_eg.LAUNCHES, **_fa.LAUNCHES}


def reset_launch_counts() -> None:
    for d in (_eg.LAUNCHES, _fa.LAUNCHES):
        for k in d:
            d[k] = 0
