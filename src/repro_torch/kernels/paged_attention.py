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
avoid. Each (sequence, KV head) is split over a thread-block cluster of
:func:`cluster_size` blocks that take even runs of the row's live keys
and merge their partial softmax sums in rank order.
On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_q8_ref, paged_attention_ref

HEAD_DIMS = (64, 128)  # head dims the CUDA kernel is instantiated for
MAX_GROUP = 8  # most query heads per KV head (GMAX in the source)
UNIT = 16  # keys a warp reduces at once: a page of ps > 16 keys is ceil(ps / 16) units
CLUSTER_MAX = 8  # the portable thread-block cluster size
MAX_RUN_PAGES = 4096  # block_table entries one block copies (PTAB_MAX in the source)

LAUNCHES = {"paged_attention": 0, "paged_attention_q8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # q, k_pool, v_pool, block_table, seq_lens, out, B, H, KV, d, num_pages, ps, maxP, cluster, scale,
    # window, stream
    "paged_attention_bf16": [_P] * 6 + [_I] * 8 + [ctypes.c_float, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens, out, B, H, KV, d, num_pages, ps, maxP,
    # cluster, scale, window, stream
    "paged_attention_q8": [_P] * 8 + [_I] * 8 + [ctypes.c_float, _I, _P],
}


def cluster_size(max_pages: int, page_size: int) -> int:
    """Blocks that share one (sequence, KV head): the smallest power of two
    that is at least the units a full table row holds, at most 8. Read from
    the table's width alone, so the host never waits on ``seq_lens``."""
    units = max_pages * -(-page_size // UNIT)
    cl = 1
    while cl < CLUSTER_MAX and cl < units:
        cl *= 2
    return cl


def _check(q, k_pool, v_pool, block_table, seq_lens, window, pool_dtype, out):
    """Shapes, types, devices and alignment the kernel takes, and ``out``;
    returns the int32 block table and lengths (a cast on the device, no
    host sync). Raises ValueError before any library is loaded."""
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be (B, H, d) and the pools "
                         f"{tuple(k_pool.shape)} (num_pages, ps, KV, d)")
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
    if block_table.dim() != 2 or block_table.shape[0] != B or block_table.shape[1] < 1 or seq_lens.shape != (B,):
        raise ValueError(f"paged_attention: block_table {tuple(block_table.shape)} seq_lens "
                         f"{tuple(seq_lens.shape)} for B={B}")
    if block_table.device != q.device or seq_lens.device != q.device:
        raise ValueError("paged_attention: block_table and seq_lens must be on the device of q")
    if block_table.dtype.is_floating_point or seq_lens.dtype.is_floating_point:
        raise ValueError("paged_attention: block_table and seq_lens must be integer tensors")
    if window is not None and window <= 0:
        raise ValueError(f"paged_attention: window must be positive, got {window}")
    maxP = block_table.shape[1]
    if (num_pages * ps >= 2 ** 31 or maxP * ps >= 2 ** 31
            or -(-maxP // cluster_size(maxP, ps)) + 2 > MAX_RUN_PAGES):
        raise ValueError(f"paged_attention: pool of {num_pages} pages of {ps} or a table of {maxP} pages "
                         "is past the kernel's int32 rows or its block_table copy")
    if out is not None and (tuple(out.shape) != (B, H, d) or out.dtype != q.dtype or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError(f"paged_attention: out must be a contiguous {q.dtype} tensor of shape {(B, H, d)} on "
                         f"{q.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must start on a 16-byte boundary (TMA), "
                             f"got {t.data_ptr():#x}")
    return (block_table.to(torch.int32).contiguous(), seq_lens.to(torch.int32).contiguous())


def paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens, window: Optional[int],
                         scale: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the bf16-page kernel on the current stream -> (B, H, d) bf16,
    into ``out`` if it is given. Every check runs before the library is
    loaded."""
    bt, sl = _check(q, k_pool, v_pool, block_table, seq_lens, window, torch.bfloat16, out)
    B, H, d = q.shape
    num_pages, ps, KV, _ = k_pool.shape
    maxP = bt.shape[1]
    o = torch.empty_like(q) if out is None else out
    lib = _build.load("paged_attention", _SIGS)
    _build.check(lib.paged_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), sl.data_ptr(),
        o.data_ptr(), B, H, KV, d, num_pages, ps, maxP, cluster_size(maxP, ps), float(scale),
        int(window or 0), torch.cuda.current_stream(q.device).cuda_stream), "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return o


def paged_attention_q8_cuda(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                            window: Optional[int], scale: float,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the int8-page kernel on the current stream -> (B, H, d) bf16,
    into ``out`` if it is given. Every check runs before the library is
    loaded."""
    bt, sl = _check(q, k_pool, v_pool, block_table, seq_lens, window, torch.int8, out)
    B, H, d = q.shape
    num_pages, ps, KV, _ = k_pool.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.shape != (num_pages, ps, KV, 1) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"paged_attention_q8: {name} must be a contiguous fp32 "
                             f"{(num_pages, ps, KV, 1)} tensor on {q.device}")
    maxP = bt.shape[1]
    o = torch.empty_like(q) if out is None else out
    lib = _build.load("paged_attention", _SIGS)
    _build.check(lib.paged_attention_q8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), bt.data_ptr(), sl.data_ptr(), o.data_ptr(), B, H, KV, d, num_pages, ps,
        maxP, cluster_size(maxP, ps), float(scale), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream), "paged_attention_q8")
    LAUNCHES["paged_attention_q8"] += 1
    return o


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
