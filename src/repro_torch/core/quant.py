"""int8 KV-page quantisation (port of the KV part of ``repro.core.quant``).

Per-vector (token x KV head) symmetric scales: the granularity an
incremental page write can commit without touching the rest of the page.
The same fp32 division, round-half-to-even (``torch.round``, as
``jnp.round``) and clip to +-127 as the JAX package, so both give the same
int8 values and scales. Expert-weight quantisation comes with the int8
slice (ROADMAP queue 1, 'int8').
"""
from __future__ import annotations

import torch

_EPS = 1e-8
KV_SCALE_DTYPE = torch.float32


def quantize_kv(x: torch.Tensor):
    """``(..., d) -> (int8 (..., d), fp32 (..., 1))``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(KV_SCALE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
