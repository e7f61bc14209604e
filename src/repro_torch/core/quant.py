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

Only the experts are quantised: the ``experts`` dict of an MoE layer. A
dense FFN (jamba's dense slots, arctic's dense residual) has the same three
keys but stays bf16, since ``mlp_apply`` has no scales to apply. The JAX
``quantize_params`` quantises every dict with the three keys, and its
``mlp_apply`` then multiplies by the raw int8 values (``ROADMAP.md``, notes
on the reference).

KV pages: per-vector (token x KV head) symmetric scales, the granularity an
incremental page write can commit without touching the rest of the page.

Error budget (``tests/test_torch_quant.py``, ``chip_smoke.py``):
``KERNEL_PARITY_TOL`` for an int8 kernel against its plain version (same
math, other summation order) and ``INT8_LOGIT_BUDGET`` for int8-expert
logits against the bf16 model's on the e8t2 smoke config.

:func:`sharpen_for_parity` fits the greedy-parity probe: on a random-init
model the top-1 margins are near zero, so greedy-token parity under int8
rounding is a coin flip; after a few SGD steps on a periodic token stream
they are O(1) and exact greedy parity is a meaningful check.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

EXPERT_KEYS = ("w_gate", "w_up", "w_down")
QUANT_MODES = ("none", "int8")

KERNEL_PARITY_TOL = 2e-2
INT8_LOGIT_BUDGET = 0.25
# int8-KV decode logits against bf16 pages, one step (the JAX package's budget)
INT8_KV_LOGIT_BUDGET = 0.25

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
    """A new tree with every ``experts`` dict quantised; other leaves
    (attention, embeddings, router, dense FFNs) pass through untouched."""
    if isinstance(params, dict):
        return {k: quantize_experts(v) if k == "experts" and _is_expert_dict(v) else quantize_params(v)
                for k, v in params.items()}
    return params


def quantize_decls(decls):
    """Mirror of :func:`quantize_params` over a ``ParamDecl`` tree: expert
    weight decls become int8 and gain bf16 ``*_scale`` decls whose axes
    drop the contraction dim (the leading ``(layers, expert)`` axes stay)."""
    from repro_torch.params import ParamDecl

    def q(node):
        out = dict(node)
        for k in EXPERT_KEYS:
            d = node[k]
            out[k] = dataclasses.replace(d, dtype=torch.int8, init="zeros")
            out[k + "_scale"] = ParamDecl(d.shape[:-2] + d.shape[-1:], d.axes[:-2] + d.axes[-1:],
                                          "ones", torch.bfloat16)
        return out

    if isinstance(decls, dict):
        return {k: q(v) if k == "experts" and _is_expert_dict(v) and not is_quantized(v) else quantize_decls(v)
                for k, v in decls.items()}
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


def sharpen_for_parity(cfg, params, steps: int = 80, seed: int = 0, seq_len: int = 64, batch: int = 8,
                       period: int = 32, lr: float = 0.5):
    """Fit a greedy-parity probe (the JAX ``sharpen_for_parity``): ``steps``
    plain SGD steps, with an fp32 update rounded back to each parameter's
    dtype, on a fixed periodic token stream the model memorises, through
    the port's ``loss_fn`` on the parameters' device. The pattern comes from
    ``np.random.RandomState(seed)`` as in the JAX package, so both packages
    train on the same tokens. Returns ``(params, pattern)``: new parameter
    tensors and the (period,) int32 pattern; prompts built from slices of
    it keep decode where the margins are."""
    import numpy as np

    from repro_torch.models.model import loss_fn
    from repro_torch.params import tree_leaves, tree_map

    rng = np.random.RandomState(seed)
    pattern = rng.randint(1, max(2, cfg.vocab_size - 124), size=period)
    seq = np.tile(pattern, seq_len // period + 2)
    dev = tree_leaves(params)[0].device
    toks = torch.from_numpy(np.stack([np.roll(seq, -i)[: seq_len + 1] for i in range(batch)]).astype(np.int32)).to(dev)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = tree_map(lambda t: t.detach().clone(), params)
    for _ in range(steps):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        grads = iter(torch.autograd.grad(loss_fn(cfg, params, data)[0], leaves))
        with torch.no_grad():  # tree_map visits the leaves in tree_leaves' order
            params = tree_map(lambda p: (p.float() - lr * next(grads).float()).to(p.dtype), params)
    return params, pattern.astype(np.int32)
