"""Shared transformer building blocks: norms, RoPE, embeddings, SwiGLU MLP
(port of ``repro.models.layers``).

Numerics follow the JAX package: norms compute in fp32 and cast back, RoPE
angles are fp32 and half-split, the embed casts the fp32 table to the model
dtype before the gather, the unembed returns fp32 logits from operands in
the model dtype, and the SwiGLU applies ``silu`` in fp32 and casts before
the ``* up``. ``cross_entropy`` is the training loss.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.params import ParamDecl


def norm_decl(d_model: int, norm_type: str = "rmsnorm") -> Dict[str, ParamDecl]:
    decls = {"scale": ParamDecl((d_model,), ("embed",), "ones", torch.float32)}
    if norm_type == "layernorm":
        decls["bias"] = ParamDecl((d_model,), ("embed",), "zeros", torch.float32)
    return decls


def norm_apply(params, x: torch.Tensor, norm_type: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if norm_type == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Half-split
    rotation (first half with second half), angles in fp32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def embed_decl(padded_vocab: int, d_model: int, tie: bool) -> Dict[str, ParamDecl]:
    decls = {
        "embedding": ParamDecl(
            (padded_vocab, d_model), ("vocab", "embed"), "normal:0.02", torch.float32
        )
    }
    if not tie:
        decls["unembedding"] = ParamDecl(
            (padded_vocab, d_model), ("vocab", "embed"), "normal:0.02", torch.float32
        )
    return decls


def embed_apply(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    # gather-then-cast rows: the same values as casting the whole table.
    # F.embedding, not indexing: indexing's backward accumulates repeated
    # tokens in a thread-dependent order on the CPU (not bit-reproducible)
    return F.embedding(tokens.long(), params["embedding"]).to(dtype)


def unembed_apply(params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits over the padded vocab from operands rounded to x's dtype
    (the JAX einsum with ``preferred_element_type=float32``): a matmul in
    bf16 would round its output to bf16 and could flip the argmax."""
    table = params.get("unembedding", params["embedding"])
    return F.linear(x.float(), table.to(x.dtype).float())


def mlp_decl(d_model: int, d_ff: int, dtype=torch.bfloat16) -> Dict[str, ParamDecl]:
    return {
        "w_gate": ParamDecl((d_model, d_ff), ("embed", "ff"), "fan_in", dtype),
        "w_up": ParamDecl((d_model, d_ff), ("embed", "ff"), "fan_in", dtype),
        "w_down": ParamDecl((d_ff, d_model), ("ff", "embed"), "fan_in", dtype),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return hidden @ params["w_down"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean CE over tokens; logits fp32 over the padded vocab. Padded vocab
    entries join the partition function (Megatron semantics) but never
    appear as labels; the max is detached, as ``jax.lax.stop_gradient``
    detaches it in the JAX version."""
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m.squeeze(-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - label_logit).mean()
