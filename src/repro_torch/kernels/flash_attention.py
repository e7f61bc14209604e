"""Flash-attention forward — the port of
``repro.kernels.flash_attention``'s forward (``_fa_call`` → ``_fa_kernel``).

Causal / sliding-window attention over q ``(B, Sq, H, d)`` and k, v ``(B,
Sk, KV, d)`` with implicit right-aligned positions (``q_offset = Sk -
Sq``). One CUDA kernel (``csrc/flash_fwd.cu``) keeps the online-softmax
statistics m, l and the accumulator in fp32, reads KV head ``h // (H/KV)``
in place (no GQA copy), skips key tiles that causality or the window mask
entirely, masks the ragged edge of the last tiles, and emits the output
(bf16) and the logsumexp ``(B*H, Sq)`` fp32 that the backward slice will
need. On a CPU tensor the wrapper runs ``kernels.ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for

LAUNCHES = {"flash_fwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # q, k, v, out, lse, B, Sq, Sk, H, KV, d, scale, causal, window, stream
    "flash_fwd": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _P],
}


def flash_fwd_cuda(q, k, v, causal: bool, window: Optional[int], scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous bf16 tensor on {q.device}")
    if k.shape != (B, Sk, KV, d) or v.shape != (B, Sk, KV, d) or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    lib = _build.load("flash_fwd", _SIGS)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
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
