"""Expert GEMMs with fused SwiGLU — the port of ``repro.kernels.expert_gemm``
for the sorted layout in bf16 (``grouped_gemm``) and int8
(``grouped_gemm_q8``), the padded layout in bf16 (``expert_gemm``) and int8
(``expert_gemm_q8``) and the fused dispatch-in-kernel path in bf16
(``grouped_gemm_fused``) and int8 (``grouped_gemm_fused_q8``). All twelve
forward kernels live in ``csrc/grouped_gemm.cu``, one templated tile loop.

Sorted, bf16 (``_grouped_fwd_impl``: ``_grouped_gate_up_kernel`` and
``_grouped_down_kernel``):

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

Padded (``_expert_fwd_impl``: ``_gate_up_kernel``, ``_down_kernel``): the
dense ``(E, C, D)`` buffer read in place by ``expert_gate_up`` and
``expert_down``, every slot computed. :class:`ExpertGemm` is its autograd
node: its backward views the buffer as a sorted one with ``group_sizes ==
C`` (``_expert_gemm_bwd``), copied into 128-row-aligned regions because the
backward kernels need that alignment, and runs the three backward kernels.

Sorted, int8 weights (``_grouped_fwd_q8_impl``: ``_grouped_gate_up_kernel_q8``,
``_grouped_down_kernel_q8``): ``grouped_gate_up_q8`` and ``grouped_down_q8``
widen int8 weight slabs to bf16 in shared memory and apply the bf16
per-column scales to the fp32 sums. Forward only, as in the JAX package.
Padded, int8 weights (``_expert_fwd_q8_impl``: ``_gate_up_kernel_q8``,
``_down_kernel_q8``): ``expert_gate_up_q8`` (#8) and ``expert_down_q8``
(#9), the same int8 tile loop over the padded row mapping; forward only.

Fused dispatch (``_fused_fwd_impl``: ``_fused_gate_up_kernel``,
``_fused_down_kernel``; int8 ``_fused_fwd_q8_impl``): the input is the
token-major ``x`` (T, D) and the sorted dispatcher's routing vectors.
:func:`fused_prefetch` turns them into per-buffer-row tables on the device
(source token, slot-partials row, fp32 gate). ``grouped_gate_up_fused``
(#12; ``_q8`` #14) gathers each row of its tile from x in its prologue and
writes h (N_pad, F); ``grouped_down_fused`` (#13; #15) writes each valid
row times its gate to its (slot, token) row of a (k, T, D) partials
buffer, which the wrapper sums over k in fp32. :class:`FusedMoe` is its
autograd node (the JAX ``_fused_moe_p`` ``custom_vjp``): inputs-only
residuals, and a backward that takes the VJP of the unfused composition
through the grouped forward (#3/#4) and backward (#5-#7) kernels.

The backward (``_grouped_bwd_impl``: ``_grouped_bwd_dh_kernel``,
``_grouped_bwd_dx_kernel``, ``_grouped_bwd_wgrad_kernel``) is three more
CUDA kernels (``csrc/grouped_gemm_bwd.cu``): ``grouped_bwd_dh`` recomputes
g and u and emits (h, dg, du) in two launches (dy Wd^T into an fp32
scratch the wrapper allocates, then the gate/up products with the SwiGLU
backward), ``grouped_bwd_dx`` gives dx and ``grouped_bwd_wgrad`` the three
weight gradients, summed in fp32 per expert and cast once.
:class:`GroupedGemm` ties forward and backward together for autograd on
both devices; like the JAX ``custom_vjp`` it saves only its inputs, never
an ``(N_pad, F)`` intermediate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    aligned_rows,
    combine_partials,
    expert_gemm_q8_ref,
    expert_gemm_ref,
    grouped_gemm_bwd_ref,
    grouped_gemm_fused_q8_ref,
    grouped_gemm_fused_ref,
    grouped_gemm_q8_ref,
    grouped_gemm_ref,
)

ROW_TILE = 128  # metadata granularity: the sorted buffer's region alignment
COL_TILE = 128  # output columns per CUDA block (F and D must be multiples)

# launches of each CUDA kernel in this process (chip_smoke.py reads them)
LAUNCHES = {"grouped_gate_up": 0, "grouped_down": 0, "expert_gate_up": 0, "expert_down": 0,
            "expert_gate_up_q8": 0, "expert_down_q8": 0,
            "grouped_gate_up_q8": 0, "grouped_down_q8": 0,
            "grouped_gate_up_fused": 0, "grouped_down_fused": 0,
            "grouped_gate_up_fused_q8": 0, "grouped_down_fused_q8": 0,
            "grouped_bwd_dh": 0, "grouped_bwd_dx": 0, "grouped_bwd_wgrad": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    # xs, w_gate, w_up, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up": [_P] * 6 + [_I] * 3 + [_P],
    # h, w_down, tile_group, tile_rows, y, n_pad, f, d, stream
    "grouped_down": [_P] * 5 + [_I] * 3 + [_P],
    # xe, w_gate, w_up, h, e, c, d, f, stream
    "expert_gate_up": [_P] * 4 + [_I] * 4 + [_P],
    # h, w_down, y, e, c, f, d, stream
    "expert_down": [_P] * 3 + [_I] * 4 + [_P],
    # xe, w_gate, w_up, s_gate, s_up, h, e, c, d, f, stream
    "expert_gate_up_q8": [_P] * 6 + [_I] * 4 + [_P],
    # h, w_down, s_down, y, e, c, f, d, stream
    "expert_down_q8": [_P] * 4 + [_I] * 4 + [_P],
    # xs, w_gate, w_up, s_gate, s_up, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up_q8": [_P] * 8 + [_I] * 3 + [_P],
    # h, w_down, s_down, tile_group, tile_rows, y, n_pad, f, d, stream
    "grouped_down_q8": [_P] * 6 + [_I] * 3 + [_P],
    # x, w_gate, w_up, tok_pad, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up_fused": [_P] * 7 + [_I] * 3 + [_P],
    # h, w_down, row_out, gate_pad, tile_group, tile_rows, partials, n_pad, f, d, stream
    "grouped_down_fused": [_P] * 7 + [_I] * 3 + [_P],
    # x, w_gate, w_up, s_gate, s_up, tok_pad, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up_fused_q8": [_P] * 9 + [_I] * 3 + [_P],
    # h, w_down, s_down, row_out, gate_pad, tile_group, tile_rows, partials, n_pad, f, d, stream
    "grouped_down_fused_q8": [_P] * 8 + [_I] * 3 + [_P],
}
_BWD_SIGS = {
    # xs, dy, w_gate, w_up, w_down, tile_group, tile_rows, h, dg, du, dh32 scratch, n_pad, d, f, stream
    "grouped_bwd_dh": [_P] * 11 + [_I] * 3 + [_P],
    # dg, du, w_gate, w_up, tile_group, tile_rows, dx, n_pad, d, f, stream
    "grouped_bwd_dx": [_P] * 7 + [_I] * 3 + [_P],
    # xs, dy, h, dg, du, row_start, rows, dwg, dwu, dwd, n_pad, e, d, f, stream
    "grouped_bwd_wgrad": [_P] * 10 + [_I] * 4 + [_P],
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


def _check_weights(what, x, w_gate, w_up, w_down, wdtype=torch.bfloat16, scales=None):
    D = x.shape[-1]
    E, _, F = w_gate.shape
    tensors = (("x", x, torch.bfloat16), ("w_gate", w_gate, wdtype), ("w_up", w_up, wdtype),
               ("w_down", w_down, wdtype))
    if scales is not None:
        tensors += tuple((n, t, torch.bfloat16) for n, t in zip(("s_gate", "s_up", "s_down"), scales))
        if tuple(s.shape for s in scales) != ((E, F), (E, F), (E, D)):
            raise ValueError(f"{what}: scale shapes {[tuple(s.shape) for s in scales]} for E={E} F={F} D={D}")
    for name, t, dt in tensors:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor on {x.device}")
    if w_gate.shape != (E, D, F) or w_up.shape != (E, D, F) or w_down.shape != (E, F, D):
        raise ValueError(f"{what}: weight shapes {w_gate.shape} {w_up.shape} {w_down.shape} for D={D}")
    if D % COL_TILE or F % COL_TILE:
        raise ValueError(f"{what}: D={D} and F={F} must be multiples of {COL_TILE}")


def _check(xs, w_gate, w_up, w_down, group_sizes, row_block, wdtype=torch.bfloat16, scales=None):
    N_pad = xs.shape[0]
    E = w_gate.shape[0]
    _check_weights("grouped_gemm", xs, w_gate, w_up, w_down, wdtype, scales)
    if group_sizes.shape != (E,) or group_sizes.device != xs.device:
        raise ValueError("grouped_gemm: group_sizes must be (E,) on the device of xs")
    if row_block != ROW_TILE or N_pad % ROW_TILE:
        raise ValueError(f"grouped_gemm: the CUDA kernel needs row_block={ROW_TILE} and N_pad % {ROW_TILE} == 0")


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


def expert_gate_up_cuda(xe, w_gate, w_up) -> torch.Tensor:
    """Launch ``expert_gate_up`` on the current stream: (E, C, D) -> h (E, C, F)."""
    E, C, D = xe.shape
    F = w_gate.shape[2]
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.expert_gate_up(
        xe.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(), E, C, D, F,
        torch.cuda.current_stream(xe.device).cuda_stream), "expert_gate_up")
    LAUNCHES["expert_gate_up"] += 1
    return h


def _check_out(what, out, shape, like):
    """``out`` must be a contiguous tensor of ``shape`` in ``like``'s dtype
    and on its device."""
    if out is not None and (tuple(out.shape) != tuple(shape) or out.dtype != like.dtype
                            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous {like.dtype} tensor of shape {tuple(shape)} on "
                         f"{like.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")


def _check_bf16(what, device, **tensors):
    for name, t in tensors.items():
        if t.device != device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous bf16 tensor on {device}")


def _check_tma(what, **tensors):
    """The wgmma/TMA kernels read and write through 16-byte aligned bases."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary (TMA), got {t.data_ptr():#x}")


def expert_down_cuda(h, w_down, out=None) -> torch.Tensor:
    """Launch ``expert_down`` on the current stream: (E, C, F) -> y (E, C, D),
    into ``out`` if it is given. Every check runs before the library is
    loaded."""
    E, C, F = h.shape
    D = w_down.shape[2]
    _check_bf16("expert_down", h.device, h=h, w_down=w_down)
    if w_down.shape != (E, F, D) or F % COL_TILE or D % COL_TILE:
        raise ValueError(f"expert_down: w_down {tuple(w_down.shape)} for h {tuple(h.shape)}; F and D must be "
                         f"multiples of {COL_TILE}")
    _check_out("expert_down", out, (E, C, D), h)
    y = torch.empty((E, C, D), dtype=h.dtype, device=h.device) if out is None else out
    _check_tma("expert_down", h=h, w_down=w_down, out=y)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.expert_down(
        h.data_ptr(), w_down.data_ptr(), y.data_ptr(), E, C, F, D,
        torch.cuda.current_stream(h.device).cuda_stream), "expert_down")
    LAUNCHES["expert_down"] += 1
    return y


def _check_padded(xe, w_gate, w_up, w_down, wdtype=torch.bfloat16, scales=None):
    if xe.dim() != 3 or xe.shape[0] != w_gate.shape[0] or xe.shape[1] < 1:
        raise ValueError(f"expert_gemm: xe must be (E, C>=1, D) for {w_gate.shape[0]} experts, got {tuple(xe.shape)}")
    _check_weights("expert_gemm", xe, w_gate, w_up, w_down, wdtype, scales)


def expert_gemm_cuda(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """#1 then #2 on the current stream; raises on a refused launch."""
    _check_padded(xe, w_gate, w_up, w_down)
    return expert_down_cuda(expert_gate_up_cuda(xe, w_gate, w_up), w_down)


def gate_up_q8_cuda(xs, w_gate, w_up, s_gate, s_up, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_gate_up_q8`` on the current stream -> h (N_pad, F)."""
    N_pad, D = xs.shape
    F = w_gate.shape[2]
    h = torch.empty((N_pad, F), dtype=xs.dtype, device=xs.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_gate_up_q8(
        xs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), s_gate.data_ptr(), s_up.data_ptr(),
        tile_group.data_ptr(), tile_rows.data_ptr(), h.data_ptr(), N_pad, D, F,
        torch.cuda.current_stream(xs.device).cuda_stream), "grouped_gate_up_q8")
    LAUNCHES["grouped_gate_up_q8"] += 1
    return h


def down_q8_cuda(h, w_down, s_down, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_down_q8`` on the current stream -> y (N_pad, D)."""
    N_pad, F = h.shape
    D = w_down.shape[2]
    y = torch.empty((N_pad, D), dtype=h.dtype, device=h.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_down_q8(
        h.data_ptr(), w_down.data_ptr(), s_down.data_ptr(), tile_group.data_ptr(), tile_rows.data_ptr(),
        y.data_ptr(), N_pad, F, D, torch.cuda.current_stream(h.device).cuda_stream), "grouped_down_q8")
    LAUNCHES["grouped_down_q8"] += 1
    return y


def grouped_gemm_q8_cuda(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes,
                         row_block: int = ROW_TILE) -> torch.Tensor:
    """#10 then #11 on the current stream; raises on a refused launch."""
    _check(xs, w_gate, w_up, w_down, group_sizes, row_block, torch.int8, (s_gate, s_up, s_down))
    tg, tr = group_tiling(group_sizes, xs.shape[0] // ROW_TILE)
    h = gate_up_q8_cuda(xs, w_gate, w_up, s_gate, s_up, tg, tr)
    return down_q8_cuda(h, w_down, s_down, tg, tr)


def expert_gate_up_q8_cuda(xe, w_gate, w_up, s_gate, s_up) -> torch.Tensor:
    """Launch ``expert_gate_up_q8`` (#8) on the current stream: (E, C, D)
    -> h (E, C, F)."""
    E, C, D = xe.shape
    F = w_gate.shape[2]
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.expert_gate_up_q8(
        xe.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), s_gate.data_ptr(), s_up.data_ptr(), h.data_ptr(),
        E, C, D, F, torch.cuda.current_stream(xe.device).cuda_stream), "expert_gate_up_q8")
    LAUNCHES["expert_gate_up_q8"] += 1
    return h


def expert_down_q8_cuda(h, w_down, s_down) -> torch.Tensor:
    """Launch ``expert_down_q8`` (#9) on the current stream: (E, C, F) ->
    y (E, C, D)."""
    E, C, F = h.shape
    D = w_down.shape[2]
    y = torch.empty((E, C, D), dtype=h.dtype, device=h.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.expert_down_q8(
        h.data_ptr(), w_down.data_ptr(), s_down.data_ptr(), y.data_ptr(), E, C, F, D,
        torch.cuda.current_stream(h.device).cuda_stream), "expert_down_q8")
    LAUNCHES["expert_down_q8"] += 1
    return y


def expert_gemm_q8_cuda(xe, w_gate, w_up, w_down, s_gate, s_up, s_down) -> torch.Tensor:
    """#8 then #9 on the current stream; raises on a refused launch."""
    _check_padded(xe, w_gate, w_up, w_down, torch.int8, (s_gate, s_up, s_down))
    return expert_down_q8_cuda(expert_gate_up_q8_cuda(xe, w_gate, w_up, s_gate, s_up), w_down, s_down)


def _check_outs(what, out, shapes, like):
    """``out``, where given, is one tensor per output, each checked as
    :func:`_check_out` checks it. Returns the outputs to launch into."""
    if out is not None and len(out) != len(shapes):
        raise ValueError(f"{what}: out must hold {len(shapes)} tensors, got {len(out)}")
    for o, shape in zip(out or (), shapes):
        _check_out(what, o, shape, like)
    return tuple(out) if out is not None else tuple(
        torch.empty(shape, dtype=like.dtype, device=like.device) for shape in shapes)


def _check_tiles(what, n_tiles, device, **tensors):
    """Per-row-tile metadata: contiguous int32 (n_tiles,) on the device."""
    for name, t in tensors.items():
        if t.shape != (n_tiles,) or t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 ({n_tiles},) tensor on {device}")


def bwd_dh_cuda(xs, dy, w_gate, w_up, w_down, tile_group, tile_rows, out=None):
    """Launch ``grouped_bwd_dh`` -> (h, dg, du), each (N_pad, F), into the
    three tensors of ``out`` if it is given. Every check runs before the
    library is loaded."""
    N_pad, D = xs.shape
    E, _, F = w_gate.shape
    _check_bf16("grouped_bwd_dh", xs.device, xs=xs, dy=dy, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if (dy.shape != xs.shape or w_gate.shape != (E, D, F) or w_up.shape != (E, D, F)
            or w_down.shape != (E, F, D) or N_pad % ROW_TILE or F % COL_TILE or D % COL_TILE):
        raise ValueError(f"grouped_bwd_dh: shapes xs {tuple(xs.shape)} dy {tuple(dy.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)} w_down {tuple(w_down.shape)}")
    _check_tiles("grouped_bwd_dh", N_pad // ROW_TILE, xs.device, tile_group=tile_group, tile_rows=tile_rows)
    h, dg, du = _check_outs("grouped_bwd_dh", out, [(N_pad, F)] * 3, xs)
    _check_tma("grouped_bwd_dh", xs=xs, dy=dy, w_gate=w_gate, w_up=w_up, w_down=w_down, h=h, dg=dg, du=du)
    dh32 = torch.empty((N_pad, F), dtype=torch.float32, device=xs.device)  # dy Wd^T between the two launches
    lib = _build.load("grouped_gemm_bwd", _BWD_SIGS)
    _build.check(lib.grouped_bwd_dh(
        xs.data_ptr(), dy.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        tile_group.data_ptr(), tile_rows.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(), dh32.data_ptr(),
        N_pad, D, F, torch.cuda.current_stream(xs.device).cuda_stream), "grouped_bwd_dh")
    LAUNCHES["grouped_bwd_dh"] += 1
    return h, dg, du


def bwd_dx_cuda(dg, du, w_gate, w_up, tile_group, tile_rows, out=None) -> torch.Tensor:
    """Launch ``grouped_bwd_dx`` -> dx (N_pad, D), into ``out`` if it is
    given. Every check runs before the library is loaded."""
    N_pad, F = dg.shape
    E, D = w_gate.shape[:2]
    _check_bf16("grouped_bwd_dx", dg.device, dg=dg, du=du, w_gate=w_gate, w_up=w_up)
    if (du.shape != dg.shape or w_gate.shape != (E, D, F) or w_up.shape != (E, D, F) or N_pad % ROW_TILE
            or F % COL_TILE or D % COL_TILE):
        raise ValueError(f"grouped_bwd_dx: shapes dg {tuple(dg.shape)} du {tuple(du.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)}")
    _check_tiles("grouped_bwd_dx", N_pad // ROW_TILE, dg.device, tile_group=tile_group, tile_rows=tile_rows)
    _check_out("grouped_bwd_dx", out, (N_pad, D), dg)
    dx = torch.empty((N_pad, D), dtype=dg.dtype, device=dg.device) if out is None else out
    _check_tma("grouped_bwd_dx", dg=dg, du=du, w_gate=w_gate, w_up=w_up, out=dx)
    lib = _build.load("grouped_gemm_bwd", _BWD_SIGS)
    _build.check(lib.grouped_bwd_dx(
        dg.data_ptr(), du.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), tile_group.data_ptr(),
        tile_rows.data_ptr(), dx.data_ptr(), N_pad, D, F,
        torch.cuda.current_stream(dg.device).cuda_stream), "grouped_bwd_dx")
    LAUNCHES["grouped_bwd_dx"] += 1
    return dx


def expert_rows(group_sizes: torch.Tensor, bc: int = ROW_TILE):
    """(first row of each expert's region in the aligned buffer, its valid
    rows), int32 on the device."""
    gs = group_sizes.int()
    padded = (gs + bc - 1) // bc * bc
    return (torch.cumsum(padded, 0) - padded).int().contiguous(), gs.contiguous()


def bwd_wgrad_cuda(xs, dy, h, dg, du, group_sizes, out=None):
    """Launch ``grouped_bwd_wgrad`` -> (dWg, dWu (E, D, F), dWd (E, F, D))
    in xs's dtype, into the three tensors of ``out`` if it is given. Every
    check runs before the library is loaded."""
    N_pad, D = xs.shape
    F = h.shape[1]
    E = group_sizes.shape[0]
    _check_bf16("grouped_bwd_wgrad", xs.device, xs=xs, dy=dy, h=h, dg=dg, du=du)
    if (dy.shape != xs.shape or h.shape != (N_pad, F) or dg.shape != h.shape or du.shape != h.shape
            or group_sizes.dim() != 1 or E < 1 or N_pad % ROW_TILE or F % COL_TILE or D % COL_TILE):
        raise ValueError(f"grouped_bwd_wgrad: shapes xs {tuple(xs.shape)} dy {tuple(dy.shape)} h "
                         f"{tuple(h.shape)} dg {tuple(dg.shape)} du {tuple(du.shape)} group_sizes "
                         f"{tuple(group_sizes.shape)}")
    if group_sizes.device != xs.device or group_sizes.is_floating_point():
        raise ValueError(f"grouped_bwd_wgrad: group_sizes must be an integer tensor on {xs.device}")
    dwg, dwu, dwd = _check_outs("grouped_bwd_wgrad", out, [(E, D, F), (E, D, F), (E, F, D)], xs)
    _check_tma("grouped_bwd_wgrad", xs=xs, dy=dy, h=h, dg=dg, du=du, dwg=dwg, dwu=dwu, dwd=dwd)
    row_start, rows = expert_rows(group_sizes)
    lib = _build.load("grouped_gemm_bwd", _BWD_SIGS)
    _build.check(lib.grouped_bwd_wgrad(
        xs.data_ptr(), dy.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(),
        row_start.data_ptr(), rows.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(),
        N_pad, E, D, F, torch.cuda.current_stream(xs.device).cuda_stream), "grouped_bwd_wgrad")
    LAUNCHES["grouped_bwd_wgrad"] += 1
    return dwg, dwu, dwd


def grouped_gemm_bwd_cuda(xs, dy, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE):
    """The three backward kernels on the current stream -> (dx, dWg, dWu,
    dWd); raises on a refused launch."""
    _check(xs, w_gate, w_up, w_down, group_sizes, row_block)
    if dy.shape != xs.shape or dy.dtype != xs.dtype or dy.device != xs.device or not dy.is_contiguous():
        raise ValueError(f"grouped_gemm backward: dy must be a contiguous {xs.dtype} {tuple(xs.shape)} tensor")
    tg, tr = group_tiling(group_sizes, xs.shape[0] // ROW_TILE)
    h, dg, du = bwd_dh_cuda(xs, dy, w_gate, w_up, w_down, tg, tr)
    dx = bwd_dx_cuda(dg, du, w_gate, w_up, tg, tr)
    return (dx, *bwd_wgrad_cuda(xs, dy, h, dg, du, group_sizes))


def grouped_gemm_fwd(xs, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE) -> torch.Tensor:
    """Forward without autograd: a CUDA tensor launches the kernels (or
    raises); a CPU tensor runs the plain version."""
    if xs.is_cuda:
        return grouped_gemm_cuda(xs, w_gate, w_up, w_down, group_sizes, row_block)
    if xs.device.type != "cpu":
        raise ValueError(f"grouped_gemm: unsupported device {xs.device}")
    return grouped_gemm_ref(xs, w_gate, w_up, w_down, group_sizes, row_block)


def grouped_gemm_bwd(xs, dy, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE):
    """(dx, dWg, dWu, dWd) for the output cotangent ``dy``: the backward
    kernels on a CUDA tensor, their plain versions on a CPU tensor."""
    if xs.is_cuda:
        return grouped_gemm_bwd_cuda(xs, dy, w_gate, w_up, w_down, group_sizes, row_block)
    if xs.device.type != "cpu":
        raise ValueError(f"grouped_gemm: unsupported device {xs.device}")
    return grouped_gemm_bwd_ref(xs, dy, w_gate, w_up, w_down, group_sizes, row_block)


class GroupedGemm(torch.autograd.Function):
    """Autograd node of the grouped GEMM (the JAX ``_grouped_gemm_p``
    ``custom_vjp``). Saves only its inputs; the backward recomputes the
    gate/up products inside ``grouped_bwd_dh``. ``grouped_gemm_bwd`` is
    looked up at call time, so a caller may wrap it (``chip_smoke.py``
    holds each backward call against its plain version that way)."""

    @staticmethod
    def forward(ctx, xs, w_gate, w_up, w_down, group_sizes, row_block):
        ctx.row_block = row_block
        ctx.save_for_backward(xs, w_gate, w_up, w_down, group_sizes)
        return grouped_gemm_fwd(xs, w_gate, w_up, w_down, group_sizes, row_block)

    @staticmethod
    def backward(ctx, dy):
        xs, w_gate, w_up, w_down, group_sizes = ctx.saved_tensors
        grads = grouped_gemm_bwd(xs, dy.contiguous(), w_gate, w_up, w_down, group_sizes, ctx.row_block)
        return (*grads, None, None)


def grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE) -> torch.Tensor:
    """(N_pad, D) expert-sorted rows -> (N_pad, D), differentiable through
    :class:`GroupedGemm` on both devices. A CUDA tensor launches the kernels
    (or raises); a CPU tensor runs the plain versions."""
    return GroupedGemm.apply(xs, w_gate, w_up, w_down, group_sizes, row_block)


def grouped_gemm_q8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes,
                    row_block: int = ROW_TILE) -> torch.Tensor:
    """int8-weight grouped FFN over the sorted layout, forward only (the
    JAX q8 kernels have no VJP): a weight that requires grad raises. A CUDA
    tensor launches #10 and #11 (or raises); a CPU tensor runs the plain
    version."""
    if any(w.requires_grad for w in (w_gate, w_up, w_down, s_gate, s_up, s_down)):
        raise ValueError("grouped_gemm_q8 is forward only: int8 expert weights have no gradient")
    if xs.is_cuda:
        return grouped_gemm_q8_cuda(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)
    if xs.device.type != "cpu":
        raise ValueError(f"grouped_gemm_q8: unsupported device {xs.device}")
    return grouped_gemm_q8_ref(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)


def _aligned_view(t: torch.Tensor) -> torch.Tensor:
    """(E, C, X) -> (E * Cp, X) with Cp = C rounded up to ROW_TILE: each
    expert's slots copied into its own 128-row region, zero rows after."""
    E, C, X = t.shape
    Cp = -(-C // ROW_TILE) * ROW_TILE
    if Cp == C:
        return t.reshape(E * C, X)
    out = t.new_zeros((E, Cp, X))
    out[:, :C] = t
    return out.reshape(E * Cp, X)


def expert_gemm_fwd(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """Padded forward without autograd: a CUDA tensor launches #1 and #2
    (or raises); a CPU tensor runs the plain version."""
    if xe.is_cuda:
        return expert_gemm_cuda(xe, w_gate, w_up, w_down)
    if xe.device.type != "cpu":
        raise ValueError(f"expert_gemm: unsupported device {xe.device}")
    return expert_gemm_ref(xe, w_gate, w_up, w_down)


class ExpertGemm(torch.autograd.Function):
    """Autograd node of the padded expert GEMM (the JAX ``_expert_gemm_p``
    ``custom_vjp``). Saves only its inputs. The backward is
    ``_expert_gemm_bwd``'s: the (E, C, D) buffer is a sorted buffer with
    ``group_sizes == C``, here copied into 128-row-aligned regions (the
    backward kernels' alignment; the zero rows past C are masked out and add
    nothing), run through ``grouped_gemm_bwd`` (#5-#7, looked up at call
    time) and sliced back to C rows."""

    @staticmethod
    def forward(ctx, xe, w_gate, w_up, w_down):
        ctx.save_for_backward(xe, w_gate, w_up, w_down)
        return expert_gemm_fwd(xe, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        xe, w_gate, w_up, w_down = ctx.saved_tensors
        E, C, D = xe.shape
        gs = torch.full((E,), C, dtype=torch.int32, device=xe.device)
        dxs, dwg, dwu, dwd = grouped_gemm_bwd(_aligned_view(xe), _aligned_view(dy.contiguous()),
                                              w_gate, w_up, w_down, gs, ROW_TILE)
        return dxs.reshape(E, -1, D)[:, :C], dwg, dwu, dwd


def expert_gemm(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """(E, C, D) padded expert buffer -> (E, C, D), differentiable through
    :class:`ExpertGemm` on both devices."""
    return ExpertGemm.apply(xe, w_gate, w_up, w_down)


def expert_gemm_q8(xe, w_gate, w_up, w_down, s_gate, s_up, s_down) -> torch.Tensor:
    """int8-weight padded expert FFN over (E, C, D), forward only (the JAX
    q8 kernels have no VJP): a weight that requires grad raises. A CUDA
    tensor launches #8 and #9 (or raises); a CPU tensor runs the plain
    version."""
    if any(w.requires_grad for w in (w_gate, w_up, w_down, s_gate, s_up, s_down)):
        raise ValueError("expert_gemm_q8 is forward only: int8 expert weights have no gradient")
    if xe.is_cuda:
        return expert_gemm_q8_cuda(xe, w_gate, w_up, w_down, s_gate, s_up, s_down)
    if xe.device.type != "cpu":
        raise ValueError(f"expert_gemm_q8: unsupported device {xe.device}")
    return expert_gemm_q8_ref(xe, w_gate, w_up, w_down, s_gate, s_up, s_down)


def grouped_gemm_residuals(xs, w_gate, w_up, w_down, group_sizes, row_block: int = ROW_TILE):
    """(shape, dtype) of every tensor the forward saves for the backward
    (the recompute contract the tests check: the inputs only, never an
    ``(N_pad, F)`` intermediate)."""
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    leaf = lambda t: t.detach().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        GroupedGemm.apply(leaf(xs), leaf(w_gate), leaf(w_up), leaf(w_down), group_sizes, row_block)
    return saved


# ---------------------------------------------------------------------------
# Fused dispatch: gather in the gate/up prologue, gate-weighted combine in the
# down epilogue (#12-#15)
# ---------------------------------------------------------------------------


def fused_prefetch(token, dest, slot, gate_sorted, T: int, N_pad: int):
    """Per-buffer-row tables of the fused kernels (``_fused_prefetch``),
    made on the device with no host sync: the source token of each row
    (padding rows 0, masked by their tile's valid count), its slot-partials
    row ``slot * T + token`` (padding rows -1: the down kernel stores
    nothing for them, so the port needs no trash row) and its fp32 gate
    (padding rows 0; fp32 whatever the router's dtype)."""
    dev, dest = token.device, dest.long()
    tok_pad = torch.zeros(N_pad, dtype=torch.int32, device=dev).index_put((dest,), token.int())
    row_out = torch.full((N_pad,), -1, dtype=torch.int32, device=dev).index_put(
        (dest,), (slot.long() * T + token.long()).int())
    gate_pad = torch.zeros(N_pad, dtype=torch.float32, device=dev).index_put((dest,), gate_sorted.float())
    return tok_pad, row_out, gate_pad


def fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted, T: int, row_block: int = ROW_TILE):
    """Everything the fused kernels read besides x and the weights:
    (tok_pad, row_out, gate_pad, tile_group, tile_rows, k), on the device."""
    N = token.shape[0]
    if N % T:
        raise ValueError(f"grouped_gemm_fused: {N} sorted rows is not a multiple of {T} tokens")
    N_pad = aligned_rows(N, w_gate.shape[0], row_block)
    tg, tr = group_tiling(group_sizes, N_pad // row_block, row_block)
    return (*fused_prefetch(token, dest, slot, gate_sorted, T, N_pad), tg, tr, N // T)


def _partials(out, k: int, T: int, D: int, h) -> torch.Tensor:
    if out is None:
        return torch.empty((k, T, D), dtype=h.dtype, device=h.device)
    if out.shape != (k, T, D) or out.dtype != h.dtype or out.device != h.device or not out.is_contiguous():
        raise ValueError(f"fused down: out must be a contiguous {h.dtype} ({k}, {T}, {D}) tensor on {h.device}")
    return out


def fused_gate_up_cuda(x, w_gate, w_up, tok_pad, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_gate_up_fused`` (#12): x (T, D) -> h (N_pad, F)."""
    N_pad, D, F = tok_pad.shape[0], x.shape[1], w_gate.shape[2]
    h = torch.empty((N_pad, F), dtype=x.dtype, device=x.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_gate_up_fused(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), tok_pad.data_ptr(), tile_group.data_ptr(),
        tile_rows.data_ptr(), h.data_ptr(), N_pad, D, F, torch.cuda.current_stream(x.device).cuda_stream),
        "grouped_gate_up_fused")
    LAUNCHES["grouped_gate_up_fused"] += 1
    return h


def fused_down_cuda(h, w_down, row_out, gate_pad, tile_group, tile_rows, k: int, T: int,
                    out=None) -> torch.Tensor:
    """Launch ``grouped_down_fused`` (#13): h (N_pad, F) -> slot partials
    (k, T, D), every row written exactly once (so ``torch.empty``; ``out``,
    a contiguous (k, T, D) tensor of h's dtype, is written in its place)."""
    N_pad, F = h.shape
    D = w_down.shape[2]
    partials = _partials(out, k, T, D, h)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_down_fused(
        h.data_ptr(), w_down.data_ptr(), row_out.data_ptr(), gate_pad.data_ptr(), tile_group.data_ptr(),
        tile_rows.data_ptr(), partials.data_ptr(), N_pad, F, D, torch.cuda.current_stream(h.device).cuda_stream),
        "grouped_down_fused")
    LAUNCHES["grouped_down_fused"] += 1
    return partials


def fused_gate_up_q8_cuda(x, w_gate, w_up, s_gate, s_up, tok_pad, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_gate_up_fused_q8`` (#14): x (T, D) -> h (N_pad, F)."""
    N_pad, D, F = tok_pad.shape[0], x.shape[1], w_gate.shape[2]
    h = torch.empty((N_pad, F), dtype=x.dtype, device=x.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_gate_up_fused_q8(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), s_gate.data_ptr(), s_up.data_ptr(), tok_pad.data_ptr(),
        tile_group.data_ptr(), tile_rows.data_ptr(), h.data_ptr(), N_pad, D, F,
        torch.cuda.current_stream(x.device).cuda_stream), "grouped_gate_up_fused_q8")
    LAUNCHES["grouped_gate_up_fused_q8"] += 1
    return h


def fused_down_q8_cuda(h, w_down, s_down, row_out, gate_pad, tile_group, tile_rows, k: int, T: int,
                       out=None) -> torch.Tensor:
    """Launch ``grouped_down_fused_q8`` (#15): h (N_pad, F) -> (k, T, D)."""
    N_pad, F = h.shape
    D = w_down.shape[2]
    partials = _partials(out, k, T, D, h)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.grouped_down_fused_q8(
        h.data_ptr(), w_down.data_ptr(), s_down.data_ptr(), row_out.data_ptr(), gate_pad.data_ptr(),
        tile_group.data_ptr(), tile_rows.data_ptr(), partials.data_ptr(), N_pad, F, D,
        torch.cuda.current_stream(h.device).cuda_stream), "grouped_down_fused_q8")
    LAUNCHES["grouped_down_fused_q8"] += 1
    return partials


def _check_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block,
                 wdtype=torch.bfloat16, scales=None):
    if x.dim() != 2:
        raise ValueError(f"grouped_gemm_fused: x must be (T, D), got {tuple(x.shape)}")
    _check_weights("grouped_gemm_fused", x, w_gate, w_up, w_down, wdtype, scales)
    E, N = w_gate.shape[0], token.shape[0]
    if group_sizes.shape != (E,) or any(t.shape != (N,) for t in (dest, slot, gate_sorted)):
        raise ValueError(f"grouped_gemm_fused: group_sizes must be ({E},) and token/dest/slot/gate_sorted ({N},)")
    if any(t.device != x.device for t in (group_sizes, token, dest, slot, gate_sorted)):
        raise ValueError(f"grouped_gemm_fused: the routing vectors must be on {x.device}")
    if row_block != ROW_TILE:
        raise ValueError(f"grouped_gemm_fused: the CUDA kernels need row_block={ROW_TILE}")


def grouped_gemm_fused_cuda(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                            row_block: int = ROW_TILE) -> torch.Tensor:
    """#12 then #13 on the current stream, then the fp32 k-way sum; raises
    on a refused launch."""
    _check_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block)
    T = x.shape[0]
    tok_pad, row_out, gate_pad, tg, tr, k = fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted, T)
    h = fused_gate_up_cuda(x, w_gate, w_up, tok_pad, tg, tr)
    return combine_partials(fused_down_cuda(h, w_down, row_out, gate_pad, tg, tr, k, T), x.dtype)


def grouped_gemm_fused_q8_cuda(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot,
                               gate_sorted, row_block: int = ROW_TILE) -> torch.Tensor:
    """#14 then #15 on the current stream, then the fp32 k-way sum."""
    _check_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block, torch.int8,
                 (s_gate, s_up, s_down))
    T = x.shape[0]
    tok_pad, row_out, gate_pad, tg, tr, k = fused_tables(w_gate, group_sizes, token, dest, slot, gate_sorted, T)
    h = fused_gate_up_q8_cuda(x, w_gate, w_up, s_gate, s_up, tok_pad, tg, tr)
    return combine_partials(fused_down_q8_cuda(h, w_down, s_down, row_out, gate_pad, tg, tr, k, T), x.dtype)


def grouped_gemm_fused_fwd(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                           row_block: int = ROW_TILE) -> torch.Tensor:
    """Fused forward without autograd: a CUDA tensor launches #12/#13 (or
    raises); a CPU tensor runs the plain version."""
    if x.is_cuda:
        return grouped_gemm_fused_cuda(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                                       row_block)
    if x.device.type != "cpu":
        raise ValueError(f"grouped_gemm_fused: unsupported device {x.device}")
    return grouped_gemm_fused_ref(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block)


class FusedMoe(torch.autograd.Function):
    """Autograd node of the fused-dispatch FFN (the JAX ``_fused_moe_p``
    ``custom_vjp``). The forward is #12/#13 and saves only its inputs,
    never the (N_pad, D) buffer or h. The backward is the VJP of the
    unfused composition (``_fused_moe_bwd``): x scattered into the aligned
    buffer, ys recomputed by the grouped forward (#3/#4), the gate-weighted
    combine's cotangents, and the grouped backward (#5-#7). It returns dx,
    the three weight gradients and the gates' gradient ``dgate[n] =
    <ys[dest[n]], dy[token[n]]>`` in fp32, through which the router learns.
    ``grouped_gemm_fwd``/``grouped_gemm_bwd`` and ``grouped_gemm_fused_fwd``
    are looked up at call time, so a caller may wrap them."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block):
        ctx.row_block = row_block
        ctx.save_for_backward(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted)
        return grouped_gemm_fused_fwd(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                                      row_block)

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted = ctx.saved_tensors
        rb = ctx.row_block
        token, dest = token.long(), dest.long()
        xs = x.new_zeros((aligned_rows(token.shape[0], w_gate.shape[0], rb), x.shape[1]))
        xs[dest] = x[token]
        ys = grouped_gemm_fwd(xs, w_gate, w_up, w_down, group_sizes, rb)
        dyv = dy.float()[token]  # cotangent of the fp32 combine rows, (N, D)
        dgate = (ys[dest].float() * dyv).sum(-1).to(gate_sorted.dtype)
        dys = torch.zeros_like(xs)
        dys[dest] = (dyv * gate_sorted.float()[:, None]).to(xs.dtype)
        dxs, dwg, dwu, dwd = grouped_gemm_bwd(xs, dys, w_gate, w_up, w_down, group_sizes, rb)
        dx = torch.zeros_like(x).index_add_(0, token, dxs[dest])
        return dx, dwg, dwu, dwd, None, None, None, None, dgate, None


def grouped_gemm_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                       row_block: int = ROW_TILE) -> torch.Tensor:
    """(T, D) token-major activations -> (T, D): the sorted MoE FFN with the
    token gather in the gate/up prologue and the gate-weighted combine in
    the down epilogue; differentiable in x, the weights and the gates
    through :class:`FusedMoe` on both devices."""
    return FusedMoe.apply(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block)


def grouped_gemm_fused_q8(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot,
                          gate_sorted, row_block: int = ROW_TILE) -> torch.Tensor:
    """int8-weight fused-dispatch FFN, forward only (as in the JAX package):
    a weight that requires grad raises. A CUDA tensor launches #14/#15 (or
    raises); a CPU tensor runs the plain version."""
    if any(w.requires_grad for w in (w_gate, w_up, w_down, s_gate, s_up, s_down)):
        raise ValueError("grouped_gemm_fused_q8 is forward only: int8 expert weights have no gradient")
    args = (x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot, gate_sorted, row_block)
    if x.is_cuda:
        return grouped_gemm_fused_q8_cuda(*args)
    if x.device.type != "cpu":
        raise ValueError(f"grouped_gemm_fused_q8: unsupported device {x.device}")
    return grouped_gemm_fused_q8_ref(*args)


def grouped_gemm_fused_residuals(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                                 row_block: int = ROW_TILE):
    """(shape, dtype) of every tensor :class:`FusedMoe` saves for the
    backward (``fused_moe_residuals``): the token-major inputs and the O(N)
    routing vectors, never an (N_pad, D) buffer or an (N, F) intermediate."""
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    leaf = lambda t: t.detach().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        FusedMoe.apply(leaf(x), leaf(w_gate), leaf(w_up), leaf(w_down), group_sizes, token, dest, slot,
                       leaf(gate_sorted), row_block)
    return saved
