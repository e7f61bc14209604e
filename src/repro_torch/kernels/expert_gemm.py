"""Grouped expert GEMM with fused SwiGLU over the sorted layout — the port
of ``repro.kernels.expert_gemm.grouped_gemm``'s forward
(``_grouped_fwd_impl``: ``_grouped_gate_up_kernel`` and
``_grouped_down_kernel``).

Input: an expert-sorted ``(N_pad, D)`` buffer whose expert regions are
aligned to 128 rows, plus ``group_sizes`` (E,). Two CUDA kernels
(``csrc/grouped_gemm.cu``):

* ``grouped_gate_up``: ``h = silu(x @ Wg[e]) * (x @ Wu[e])`` in fp32, rows
  past the tile's valid count zeroed, stored bf16 ``(N_pad, F)``;
* ``grouped_down``: ``y = h @ Wd[e]``, rows past valid zeroed, bf16
  ``(N_pad, D)``.

Per 128-row tile, the expert id and the valid-row count are computed on
the device from ``group_sizes`` (:func:`group_tiling`, as the JAX package
does; no host sync) and each block reads its own. On a CPU tensor the
wrapper runs the plain version, ``kernels.ref.grouped_gemm_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import grouped_gemm_ref

ROW_TILE = 128  # metadata granularity: the sorted buffer's region alignment
COL_TILE = 128  # output columns per CUDA block (F and D must be multiples)

# launches of each CUDA kernel in this process (chip_smoke.py reads them)
LAUNCHES = {"grouped_gate_up": 0, "grouped_down": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # xs, w_gate, w_up, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up": [_P] * 6 + [_I] * 3 + [_P],
    # h, w_down, tile_group, tile_rows, y, n_pad, f, d, stream
    "grouped_down": [_P] * 5 + [_I] * 3 + [_P],
}


def group_tiling(group_sizes: torch.Tensor, num_tiles: int, bc: int = ROW_TILE):
    """Per-row-tile (expert id, valid rows in [0, bc]) of the tile-aligned
    sorted buffer, on the device. Tiles past the last group get 0 rows."""
    gs = group_sizes.long()
    E = gs.shape[0]
    padded = (gs + bc - 1) // bc * bc
    ends_pad = torch.cumsum(padded, 0)
    starts_pad = ends_pad - padded
    tile_start = torch.arange(num_tiles, device=gs.device) * bc
    tg = torch.searchsorted(ends_pad, tile_start, right=True).clamp(0, E - 1)
    tr = (gs[tg] - (tile_start - starts_pad[tg])).clamp(0, bc)
    return tg.int().contiguous(), tr.int().contiguous()


def _check(xs, w_gate, w_up, w_down, group_sizes, row_block):
    N_pad, D = xs.shape
    E, _, F = w_gate.shape
    for name, t in (("xs", xs), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.device != xs.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"grouped_gemm: {name} must be a contiguous bf16 tensor on {xs.device}")
    if w_gate.shape != (E, D, F) or w_up.shape != (E, D, F) or w_down.shape != (E, F, D):
        raise ValueError(f"grouped_gemm: weight shapes {w_gate.shape} {w_up.shape} {w_down.shape} for D={D}")
    if group_sizes.shape != (E,) or group_sizes.device != xs.device:
        raise ValueError("grouped_gemm: group_sizes must be (E,) on the device of xs")
    if row_block != ROW_TILE or N_pad % ROW_TILE:
        raise ValueError(f"grouped_gemm: the CUDA kernel needs row_block={ROW_TILE} and N_pad % {ROW_TILE} == 0")
    if D % COL_TILE or F % COL_TILE:
        raise ValueError(f"grouped_gemm: D={D} and F={F} must be multiples of {COL_TILE}")


def gate_up_cuda(xs, w_gate, w_up, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_gate_up`` on the current stream -> h (N_pad, F)."""
    N_pad, D = xs.shape
    F = w_gate.shape[2]
    h = torch.empty((N_pad, F), dtype=xs.dtype, device=xs.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_gate_up(
        xs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), tile_group.data_ptr(),
        tile_rows.data_ptr(), h.data_ptr(), N_pad, D, F,
        torch.cuda.current_stream(xs.device).cuda_stream), "grouped_gate_up")
    LAUNCHES["grouped_gate_up"] += 1
    return h


def down_cuda(h, w_down, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_down`` on the current stream -> y (N_pad, D)."""
    N_pad, F = h.shape
    D = w_down.shape[2]
    y = torch.empty((N_pad, D), dtype=h.dtype, device=h.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_down(
        h.data_ptr(), w_down.data_ptr(), tile_group.data_ptr(), tile_rows.data_ptr(),
        y.data_ptr(), N_pad, F, D, torch.cuda.current_stream(h.device).cuda_stream),
        "grouped_down")
    LAUNCHES["grouped_down"] += 1
    return y


def grouped_gemm_cuda(xs, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE) -> torch.Tensor:
    """Both CUDA kernels on the current stream; raises on a refused launch."""
    _check(xs, w_gate, w_up, w_down, group_sizes, row_block)
    tg, tr = group_tiling(group_sizes, xs.shape[0] // ROW_TILE)
    return down_cuda(gate_up_cuda(xs, w_gate, w_up, tg, tr), w_down, tg, tr)


def grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE) -> torch.Tensor:
    """(N_pad, D) expert-sorted rows -> (N_pad, D). A CUDA tensor launches
    the kernels (or raises); a CPU tensor runs the plain version."""
    if xs.is_cuda:
        return grouped_gemm_cuda(xs, w_gate, w_up, w_down, group_sizes, row_block)
    if xs.device.type != "cpu":
        raise ValueError(f"grouped_gemm: unsupported device {xs.device}")
    return grouped_gemm_ref(xs, w_gate, w_up, w_down, group_sizes, row_block)
