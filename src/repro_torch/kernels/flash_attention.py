"""Flash-attention forward — the port of
``repro.kernels.flash_attention``'s forward (``_fa_call`` → ``_fa_kernel``).

Causal / sliding-window attention over q ``(B, Sq, H, d)`` and k, v ``(B,
Sk, KV, d)`` with implicit right-aligned positions (``q_offset = Sk -
Sq``). One CUDA kernel (``csrc/flash_fwd.cu``, wgmma and TMA) keeps the
online-softmax statistics m, l and the accumulator in fp32, reads KV head
``h // (H/KV)`` in place (no GQA copy), skips key tiles that causality or
the window mask entirely, masks only the tiles the mask cuts, and emits
the output (bf16) and the logsumexp ``(B*H, Sq)`` fp32 that the backward
needs, into ``out=``/``lse=`` where given. On a CPU tensor the wrapper
runs ``kernels.ref.flash_attention_ref``.

The backward (``_fa_bwd``: ``_fa_bwd_dq_kernel``, ``_fa_bwd_dkv_kernel``)
is two CUDA kernels (``csrc/flash_bwd.cu``) that recompute the
probabilities from the lse: ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the
latter sums over the G query heads of each KV head across a thread-block
cluster, in a fixed order). Both take optional ``out=`` outputs. ``delta =
rowsum(dO * O)`` is computed here in fp32, as the JAX package does it in
XLA. :class:`FlashAttention` ties them together for autograd on both
devices and saves (q, k, v, out, lse), as ``_fa_fwd`` does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref, flash_bwd_delta, flash_bwd_dkv_ref, flash_bwd_dq_ref

HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # q, k, v, out, lse, B, Sq, Sk, H, KV, d, scale, causal, window, stream
    "flash_fwd": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
}
_BWD_SIGS = {
    # q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, KV, d, scale, causal, window, stream
    "flash_bwd_dq": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KV, d, scale, causal, window, stream
    "flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
}


def _check(q, k, v, window, *more):
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bf16 tensor on {q.device}")
    if k.shape != (B, Sk, KV, d) or v.shape != (B, Sk, KV, d) or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")


def flash_fwd_cuda(q, k, v, causal: bool, window: Optional[int], scale: float, out: Optional[torch.Tensor] = None,
                   lse: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd`` -> (out (B, Sq, H, d) bf16, lse (B*H, Sq) fp32),
    into ``out`` and ``lse`` where given. Every check runs before the
    library is loaded: the kernel reads q, k and v by TMA (16-byte bases)."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(q, k, v, window)
    if out is not None and (out.shape != q.shape or out.dtype != torch.bfloat16 or not out.is_contiguous()
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out must be a contiguous bf16 tensor of shape {tuple(q.shape)} on "
                         f"{q.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if lse is not None and (lse.shape != (B * H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError(f"flash_attention: lse must be a contiguous fp32 tensor of shape {(B * H, Sq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary (TMA), got {t.data_ptr():#x}")
    out = torch.empty_like(q) if out is None else out
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device) if lse is None else lse
    lib = _build.load("flash_fwd", _SIGS)
    _build.check(lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, Sq, Sk, H, KV, d, float(scale), int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream), "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_fwd(q, k, v, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B,Sq,H,d) in q's dtype, lse (B*H, Sq) fp32). A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs the plain
    version."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal, window, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal, window, scale, return_lse=True)


def _bwd_args(q, k, v, dout, lse, delta, causal, window, scale, outs):
    """Check the backward's inputs and its ``outs`` ((name, tensor, like)
    triples: None asks for a fresh output shaped like ``like``) before any
    library or stream is touched; returns the outputs and the C arguments."""
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(q, k, v, window, ("dout", dout))
    if dout.shape != q.shape:
        raise ValueError(f"flash_attention backward: dout {tuple(dout.shape)} for q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, Sq) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be contiguous fp32 (B*H, Sq) on {q.device}")
    for name, t, like in outs:
        if t is not None and (t.shape != like.shape or t.dtype != torch.bfloat16 or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"flash_attention backward: out {name} must be a contiguous bf16 tensor of shape "
                             f"{tuple(like.shape)} on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    res = [torch.empty_like(like) if t is None else t for _, t, like in outs]
    return res, (B, Sq, Sk, H, KV, d, float(scale), int(causal), int(window or 0),
                 torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, window: Optional[int], scale: float,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``flash_bwd_dq`` -> dq (B, Sq, H, d) bf16, into ``out`` if
    given (checked like the inputs)."""
    (dq,), args = _bwd_args(q, k, v, dout, lse, delta, causal, window, scale, [("dq", out, q)])
    lib = _build.load("flash_bwd", _BWD_SIGS)
    _build.check(lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dq.data_ptr(), *args), "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool, window: Optional[int], scale: float,
                       out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dkv`` -> (dk, dv) (B, Sk, KV, d) bf16, into
    ``out = (dk, dv)`` if given (checked like the inputs)."""
    dk, dv = out if out is not None else (None, None)
    (dk, dv), args = _bwd_args(q, k, v, dout, lse, delta, causal, window, scale, [("dk", dk, k), ("dv", dv, v)])
    lib = _build.load("flash_bwd", _BWD_SIGS)
    _build.check(lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *args), "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, out, lse, dout, causal: bool, window: Optional[int], scale: float):
    """(dq, dk, dv) for the output cotangent ``dout``: the backward kernels
    on a CUDA tensor (or raises), their plain versions on a CPU tensor."""
    delta = flash_bwd_delta(out, dout)
    if q.is_cuda:
        dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, window, scale)
        return (dq, *flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, window, scale))
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    dq = flash_bwd_dq_ref(q, k, v, dout, lse, delta, causal, window, scale)
    return (dq, *flash_bwd_dkv_ref(q, k, v, dout, lse, delta, causal, window, scale))


class FlashAttention(torch.autograd.Function):
    """Autograd node of flash attention (the JAX ``_fa_p`` ``custom_vjp``):
    saves (q, k, v, out, lse); ``flash_bwd`` is looked up at call time so a
    caller may wrap it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_fwd(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.window, ctx.scale)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, Sq, H, d) attention output, differentiable through
    :class:`FlashAttention` on both devices."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, window, scale)
