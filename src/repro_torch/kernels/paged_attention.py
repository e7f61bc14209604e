"""Paged-attention decode — the port of ``repro.kernels.paged_attention``
(``paged_attention`` → ``_pa_kernel`` and ``paged_attention_q8`` →
``_pa_kernel_q8``).

Single-token decode against the block-table KV pool: the pool is
``(num_pages, page_size, KV, d)``, shared by every sequence, and sequence
``b`` reads its keys through ``block_table[b]`` (-1 = no page) up to
``seq_lens[b]``. One CUDA source (``csrc/paged_attention.cu``) gives both
entry points: bf16 pages, and int8 pages with fp32 per-token scale
sidecars ``(num_pages, page_size, KV, 1)`` dequantised in the tile. The
kernel walks the block table on the device and never builds a gathered
copy of the sequence's KV, which is what the plain version
(``kernels.ref.paged_attention_ref``) does and what the kernel exists to
avoid. On a CPU tensor the wrappers run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_q8_ref, paged_attention_ref

HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for
MAX_GROUP = 8  # most query heads per KV head (GMAX in the source)

LAUNCHES = {"paged_attention": 0, "paged_attention_q8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # q, k_pool, v_pool, block_table, seq_lens, out, B, H, KV, d, ps, maxP, scale, window, stream
    "paged_attention_bf16": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens, out, B, H, KV, d, ps, maxP,
    # scale, window, stream
    "paged_attention_q8": [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _P],
}


def _check(q, k_pool, v_pool, block_table, seq_lens, window, pool_dtype):
    """Shapes, types and devices the kernel takes; returns the int32 block
    table and lengths (a cast on the device, no host sync)."""
    B, H, d = q.shape
    num_pages, ps, KV, _ = k_pool.shape
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("paged_attention: q must be a contiguous bf16 (B, H, d) tensor")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or t.dtype != pool_dtype or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a contiguous {pool_dtype} tensor on {q.device}")
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} pools {tuple(k_pool.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {HEAD_DIMS}")
    if block_table.dim() != 2 or block_table.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(f"paged_attention: block_table {tuple(block_table.shape)} seq_lens "
                         f"{tuple(seq_lens.shape)} for B={B}")
    if block_table.device != q.device or seq_lens.device != q.device:
        raise ValueError("paged_attention: block_table and seq_lens must be on the device of q")
    if window is not None and window <= 0:
        raise ValueError(f"paged_attention: window must be positive, got {window}")
    return (block_table.to(torch.int32).contiguous(), seq_lens.to(torch.int32).contiguous())


def paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens, window: Optional[int],
                         scale: float) -> torch.Tensor:
    """Launch the bf16-page kernel on the current stream -> (B, H, d) bf16."""
    bt, sl = _check(q, k_pool, v_pool, block_table, seq_lens, window, torch.bfloat16)
    B, H, d = q.shape
    _, ps, KV, _ = k_pool.shape
    lib = _build.load("paged_attention", _SIGS)
    out = torch.empty_like(q)
    _build.check(lib.paged_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), sl.data_ptr(),
        out.data_ptr(), B, H, KV, d, ps, bt.shape[1], float(scale), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream), "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_q8_cuda(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                            window: Optional[int], scale: float) -> torch.Tensor:
    """Launch the int8-page kernel on the current stream -> (B, H, d) bf16."""
    bt, sl = _check(q, k_pool, v_pool, block_table, seq_lens, window, torch.int8)
    B, H, d = q.shape
    num_pages, ps, KV, _ = k_pool.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.shape != (num_pages, ps, KV, 1) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"paged_attention_q8: {name} must be a contiguous fp32 "
                             f"{(num_pages, ps, KV, 1)} tensor on {q.device}")
    lib = _build.load("paged_attention", _SIGS)
    out = torch.empty_like(q)
    _build.check(lib.paged_attention_q8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), bt.data_ptr(), sl.data_ptr(), out.data_ptr(), B, H, KV, d, ps,
        bt.shape[1], float(scale), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream), "paged_attention_q8")
    LAUNCHES["paged_attention_q8"] += 1
    return out


def _scale(q, scale) -> float:
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def paged_attention(q, k_pool, v_pool, block_table, seq_lens, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, d) decode queries against bf16 pages -> (B, H, d). A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs the plain
    version."""
    if q.is_cuda:
        return paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens, window, _scale(q, scale))
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return paged_attention_ref(q, k_pool, v_pool, block_table, seq_lens, window, scale)


def paged_attention_q8(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                       window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """As :func:`paged_attention` on int8 pages with per-token fp32
    scales; returns q's dtype."""
    if q.is_cuda:
        return paged_attention_q8_cuda(q, k_pool, v_pool, k_scale, v_scale, block_table,
                                       seq_lens, window, _scale(q, scale))
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention_q8: unsupported device {q.device}")
    return paged_attention_q8_ref(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                                  window, scale)
