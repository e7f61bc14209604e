"""Symmetric int8 quantisation of expert FFN weights and KV pages (port of
``repro.core.quant``).

Expert weights: per-expert, per-output-channel scales (gate/up over F,
down over D). The scale is constant along the contraction dim, so the
int8 kernels multiply int8 weights (widened to bf16, exact for |q| <= 127)
in fp32 and apply the scale once to the accumulator: an exact rewrite of
dequantise-then-matmul. As in the JAX package, ``q = round(w / scale)`` is
taken with the fp32 scale and the scale is stored rounded to bf16; rounding
is half to even (``torch.round``, as ``jnp.round``), so both packages give
the same int8 values and scales bit for bit. Each ``(K, C)`` matrix of a
stacked leaf is quantised on its own: the JAX version casts the whole leaf
to fp32, which at llama3-e8t2's full depth is 60 GB for one ``w_gate``;
the per-channel scale lies inside one matrix, so the result is the same.

KV pages: per-vector (token x KV head) symmetric scales, the granularity an
incremental page write can commit without touching the rest of the page.

Error budget (``tests/test_torch_quant.py``, ``chip_smoke.py``):
``KERNEL_PARITY_TOL`` for an int8 kernel against its plain version (same
math, other summation order) and ``INT8_LOGIT_BUDGET`` for int8-expert
logits against the bf16 model's on the e8t2 smoke config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

EXPERT_KEYS = ("w_gate", "w_up", "w_down")
QUANT_MODES = ("none", "int8")

KERNEL_PARITY_TOL = 2e-2
INT8_LOGIT_BUDGET = 0.25

_EPS = 1e-8
KV_SCALE_DTYPE = torch.float32


@torch.no_grad()
def quantize_matrix(w: torch.Tensor, q_out: torch.Tensor, s_out: torch.Tensor) -> None:
    """One ``(K, C)`` matrix into int8 ``q_out`` (K, C) and bf16 ``s_out`` (C,)."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=-2), _EPS) / 127.0
    q_out.copy_(torch.clamp(torch.round(wf / scale), -127, 127))
    s_out.copy_(scale)


def quantize_weight(w: torch.Tensor):
    """``(..., K, C) -> (int8 (..., K, C), bf16 (..., C))``: symmetric
    per-output-channel abs-max scales (axis -2 is the contraction dim)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.bfloat16, device=w.device)
    wv, qv, sv = (t.reshape((-1,) + t.shape[-n:]) for t, n in ((w, 2), (q, 2), (s, 1)))
    for i in range(wv.shape[0]):
        quantize_matrix(wv[i], qv[i], sv[i])
    return q, s


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()[..., None, :]).to(dtype)


def is_quantized(experts: Dict[str, torch.Tensor]) -> bool:
    return "w_gate_scale" in experts


def quantize_experts(experts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{w_gate, w_up, w_down}`` (any leading dims) -> int8 values plus
    bf16 ``*_scale`` entries. Idempotent on an already-quantised dict."""
    if is_quantized(experts):
        return experts
    out = dict(experts)
    for k in EXPERT_KEYS:
        out[k], out[k + "_scale"] = quantize_weight(experts[k])
    return out


def dequantize_experts(experts: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_experts` for the paths without an int8
    kernel (functionally identical, no byte savings)."""
    if not is_quantized(experts):
        return experts
    return {k: dequantize_weight(experts[k], experts[k + "_scale"], dtype) for k in EXPERT_KEYS}


def _is_expert_dict(node) -> bool:
    return isinstance(node, dict) and all(k in node for k in EXPERT_KEYS)


def quantize_params(params):
    """A new tree with every expert-FFN dict quantised; other leaves
    (attention, embeddings, router) pass through untouched."""
    if _is_expert_dict(params):
        return quantize_experts(params)
    if isinstance(params, dict):
        return {k: quantize_params(v) for k, v in params.items()}
    return params


def quantize_decls(decls):
    """Mirror of :func:`quantize_params` over a ``ParamDecl`` tree: expert
    weight decls become int8 and gain bf16 ``*_scale`` decls whose axes
    drop the contraction dim (the leading ``(layers, expert)`` axes stay)."""
    from repro_torch.params import ParamDecl

    if _is_expert_dict(decls) and all(isinstance(decls[k], ParamDecl) for k in EXPERT_KEYS):
        out = dict(decls)
        for k in EXPERT_KEYS:
            d = decls[k]
            out[k] = dataclasses.replace(d, dtype=torch.int8, init="zeros")
            out[k + "_scale"] = ParamDecl(d.shape[:-2] + d.shape[-1:], d.axes[:-2] + d.axes[-1:],
                                          "ones", torch.bfloat16)
        return out
    if isinstance(decls, dict):
        return {k: quantize_decls(v) for k, v in decls.items()}
    return decls


def quantize_kv(x: torch.Tensor):
    """``(..., d) -> (int8 (..., d), fp32 (..., 1))``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(KV_SCALE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
