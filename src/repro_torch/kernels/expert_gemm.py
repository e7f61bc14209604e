"""Expert GEMMs with fused SwiGLU — the port of ``repro.kernels.expert_gemm``
for the sorted layout in bf16 (``grouped_gemm``) and int8
(``grouped_gemm_q8``) and the padded layout in bf16 (``expert_gemm``).
All six forward kernels live in ``csrc/grouped_gemm.cu``, one templated
tile loop.

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

The backward (``_grouped_bwd_impl``: ``_grouped_bwd_dh_kernel``,
``_grouped_bwd_dx_kernel``, ``_grouped_bwd_wgrad_kernel``) is three more
CUDA kernels (``csrc/grouped_gemm_bwd.cu``): ``grouped_bwd_dh`` recomputes
g and u and emits (h, dg, du), ``grouped_bwd_dx`` gives dx and
``grouped_bwd_wgrad`` the three weight gradients, summed in fp32 per
expert and cast once. :class:`GroupedGemm` ties forward and backward
together for autograd on both devices; like the JAX ``custom_vjp`` it saves
only its inputs, never an ``(N_pad, F)`` intermediate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import expert_gemm_ref, grouped_gemm_bwd_ref, grouped_gemm_q8_ref, grouped_gemm_ref

ROW_TILE = 128  # metadata granularity: the sorted buffer's region alignment
COL_TILE = 128  # output columns per CUDA block (F and D must be multiples)

# launches of each CUDA kernel in this process (chip_smoke.py reads them)
LAUNCHES = {"grouped_gate_up": 0, "grouped_down": 0, "expert_gate_up": 0, "expert_down": 0,
            "grouped_gate_up_q8": 0, "grouped_down_q8": 0,
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
    # xs, w_gate, w_up, s_gate, s_up, tile_group, tile_rows, h, n_pad, d, f, stream
    "grouped_gate_up_q8": [_P] * 8 + [_I] * 3 + [_P],
    # h, w_down, s_down, tile_group, tile_rows, y, n_pad, f, d, stream
    "grouped_down_q8": [_P] * 6 + [_I] * 3 + [_P],
}
_BWD_SIGS = {
    # xs, dy, w_gate, w_up, w_down, tile_group, tile_rows, h, dg, du, n_pad, d, f, stream
    "grouped_bwd_dh": [_P] * 10 + [_I] * 3 + [_P],
    # dg, du, w_gate, w_up, tile_group, tile_rows, dx, n_pad, d, f, stream
    "grouped_bwd_dx": [_P] * 7 + [_I] * 3 + [_P],
    # xs, dy, h, dg, du, row_start, rows, dwg, dwu, dwd, e, d, f, stream
    "grouped_bwd_wgrad": [_P] * 10 + [_I] * 3 + [_P],
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


def expert_down_cuda(h, w_down) -> torch.Tensor:
    """Launch ``expert_down`` on the current stream: (E, C, F) -> y (E, C, D)."""
    E, C, F = h.shape
    D = w_down.shape[2]
    y = torch.empty((E, C, D), dtype=h.dtype, device=h.device)
    lib = _build.load("grouped_gemm", _SIGS)
    _build.check(lib.expert_down(
        h.data_ptr(), w_down.data_ptr(), y.data_ptr(), E, C, F, D,
        torch.cuda.current_stream(h.device).cuda_stream), "expert_down")
    LAUNCHES["expert_down"] += 1
    return y


def _check_padded(xe, w_gate, w_up, w_down):
    if xe.dim() != 3 or xe.shape[0] != w_gate.shape[0] or xe.shape[1] < 1:
        raise ValueError(f"expert_gemm: xe must be (E, C>=1, D) for {w_gate.shape[0]} experts, got {tuple(xe.shape)}")
    _check_weights("expert_gemm", xe, w_gate, w_up, w_down)


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


def bwd_dh_cuda(xs, dy, w_gate, w_up, w_down, tile_group, tile_rows):
    """Launch ``grouped_bwd_dh`` -> (h, dg, du), each (N_pad, F)."""
    N_pad, D = xs.shape
    F = w_gate.shape[2]
    h, dg, du = (torch.empty((N_pad, F), dtype=xs.dtype, device=xs.device) for _ in range(3))
    lib = _build.load("grouped_gemm_bwd", _BWD_SIGS)
    _build.check(lib.grouped_bwd_dh(
        xs.data_ptr(), dy.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        tile_group.data_ptr(), tile_rows.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(),
        N_pad, D, F, torch.cuda.current_stream(xs.device).cuda_stream), "grouped_bwd_dh")
    LAUNCHES["grouped_bwd_dh"] += 1
    return h, dg, du


def bwd_dx_cuda(dg, du, w_gate, w_up, tile_group, tile_rows) -> torch.Tensor:
    """Launch ``grouped_bwd_dx`` -> dx (N_pad, D)."""
    N_pad, F = dg.shape
    D = w_gate.shape[1]
    dx = torch.empty((N_pad, D), dtype=dg.dtype, device=dg.device)
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


def bwd_wgrad_cuda(xs, dy, h, dg, du, group_sizes):
    """Launch ``grouped_bwd_wgrad`` -> (dWg, dWu (E, D, F), dWd (E, F, D))
    in xs's dtype. The one entry point runs two grids (dWg/dWu, then dWd);
    its count is of calls, one per call."""
    N_pad, D = xs.shape
    F = h.shape[1]
    E = group_sizes.shape[0]
    row_start, rows = expert_rows(group_sizes)
    dwg, dwu = (torch.empty((E, D, F), dtype=xs.dtype, device=xs.device) for _ in range(2))
    dwd = torch.empty((E, F, D), dtype=xs.dtype, device=xs.device)
    lib = _build.load("grouped_gemm_bwd", _BWD_SIGS)
    _build.check(lib.grouped_bwd_wgrad(
        xs.data_ptr(), dy.data_ptr(), h.data_ptr(), dg.data_ptr(), du.data_ptr(),
        row_start.data_ptr(), rows.data_ptr(), dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(),
        E, D, F, torch.cuda.current_stream(xs.device).cuda_stream), "grouped_bwd_wgrad")
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
