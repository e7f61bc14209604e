"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``
for the serving and training slices). A CUDA tensor launches the
hand-written kernel and raises if it cannot; a CPU tensor takes the plain
version. ``grouped_gemm``, ``expert_gemm`` and ``flash_attention`` are
differentiable on both devices (``expert_gemm.GroupedGemm``,
``expert_gemm.ExpertGemm``, ``expert_gemm.FusedMoe`` under
``grouped_gemm_fused``, ``flash_attention.FlashAttention``:
hand-written backward kernels on the card, their plain versions on the
CPU), so a training step runs forward and backward on the kernel path.

With tuning on, every expert-GEMM call site the JAX package tunes resolves
its tile through ``kernels/autotune.get_blocks`` with the JAX key layout
and the row count's power-of-two bucket: on the card each of its kernels'
compiled tiles (``expert_gemm.TILES``) is timed on the call's own inputs
(device time, by CUDA-graph replay) and the fastest kept; on the CPU,
where a tile changes nothing, the modeled score decides. Off (the
default), each hook returns the entry points' fixed rule at once, so the
default path launches what it launched before the tuner. Flash and paged
attention compile one tile each and have no hook.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune as _at
from repro_torch.kernels import expert_gemm as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa

# ---------------------------------------------------------------------------
# Autotune hooks: analytic per-candidate traffic models of the CUDA tiles and,
# on the card, a timer of the call itself, handed to autotune.get_blocks.
# With REPRO_AUTOTUNE off, get_blocks returns the fixed rule's tile.
# ---------------------------------------------------------------------------

_SMS = 132  # H100 SXM streaming multiprocessors: one block of these tiles per SM (their shared memory)
_GU_BN = 128  # h columns a gate/up block computes (g and u, 128 each)
MEASURE_REPS = 10  # timed graph replays of each candidate, after a warm-up


def _waves(blocks: float) -> int:
    return math.ceil(blocks / _SMS)


def row_bucket(n: int) -> int:
    """``n`` rounded up to a power of two: one tuned tile for every row
    count in the bucket."""
    return 1 << max(n - 1, 0).bit_length()


def _timer(run, x: torch.Tensor):
    """``measure(tile)`` for :func:`autotune.get_blocks` on the card: the
    device time, in seconds, of ``run(tile)`` on the call's own inputs,
    captured once in a CUDA graph and replayed MEASURE_REPS times between
    two events after a warm-up, so that no host work between its launches
    counts. Every compiled tile gives the fixed rule's output bit for bit
    (``chip_smoke.py`` phase 11c), so timing on live inputs changes no
    result. None on the CPU, where a tile changes nothing, and during a
    CUDA-graph capture: the modeled score decides there."""
    if not x.is_cuda or torch.cuda.is_current_stream_capturing():
        return None

    def measure(tile) -> float:
        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(tile)  # warm-up off the capture
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run(tile)
            graph.replay()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MEASURE_REPS):
                graph.replay()
            end.record()
            end.synchronize()
        return start.elapsed_time(end) * 1e-3 / MEASURE_REPS

    return measure


def _ffn_cost(rows: int, row_tiles, D: int, F: int, w_it: int, smem):
    """Traffic model of a gate/up kernel then a down kernel at tile
    (gate/up warpgroups, down warpgroups, down BN) over ``rows`` rows:
    each row tile (``row_tiles(tile)``: the gate/up and down counts) reads
    one expert's weights, with the int8 kernels' bf16 scales; x is read
    once per gate/up column tile and h once per down column tile of BN;
    h and y are written once. A step is a wave of blocks over the SMs;
    shared memory is the larger instantiation's ``T::SMEM`` (``smem``)."""
    sc = 2.0 if w_it == 1 else 0.0

    def cost(tile):
        n_gu, n_dn = row_tiles(tile)
        bn = tile[2]
        return {
            "flops": 6.0 * rows * D * F,
            "bytes": (n_gu * (2.0 * D * F * w_it + 2.0 * F * sc) + F / _GU_BN * rows * D * 2.0 + rows * F * 2.0
                      + n_dn * (F * D * w_it + D * sc) + D / bn * rows * F * 2.0 + rows * D * 2.0),
            "steps": float(_waves(n_gu * F / _GU_BN) + _waves(n_dn * D / bn)),
            "smem_bytes": float(smem(tile)),
        }

    return cost


def expert_cost(site: str, E: int, C: int, D: int, F: int):
    """:func:`_ffn_cost` of the padded pair (``expert_gemm`` #1/#2,
    ``expert_gemm_q8`` #8/#9) at C slots an expert: ceil(C / 64 nwg) row
    tiles an expert, each kernel at its warpgroups."""
    q8 = site == "expert_gemm_q8"
    if q8:  # #8: Q8Tile<256>, #9: Q8Tile<BN>
        smem = lambda t: max(_eg.tile_smem(2, 256, True), _eg.tile_smem(2, t[2], True))  # noqa: E731
    else:  # #1: Tile<nwg, 256>, #2: Tile<nwg, BN>
        smem = lambda t: max(_eg.tile_smem(t[0], 256), _eg.tile_smem(t[1], t[2]))  # noqa: E731
    row_tiles = lambda t: (E * math.ceil(C / (64 * t[0])), E * math.ceil(C / (64 * t[1])))  # noqa: E731
    return _ffn_cost(E * C, row_tiles, D, F, 1 if q8 else 2, smem)


def expert_tile(site: str, E: int, C: int, D: int, F: int, run=None, x=None) -> tuple:
    """The padded pair's tile. The key carries C's bucket (the fixed rule
    changes at C 64, a bucket's edge); ``run(tile)`` on ``x``, where
    given, is timed on the card (:func:`_timer`)."""
    rule = _eg.default_tile(site, C, D)
    if not _at.enabled():  # every call, unlike JAX's trace-time hook: skip building the key and the model
        return rule
    w_it, Cb = (1 if site == "expert_gemm_q8" else 2), row_bucket(C)
    return _at.get_blocks(site, _at.make_key(site, E=E, D=D, F=F, itemsize=w_it, extra=f"C{Cb}"), rule,
                          _eg.TILES[site], expert_cost(site, E, Cb, D, F), legal=lambda t: _eg.tile_legal(t, D),
                          measure=None if run is None else _timer(run, x))


def sorted_cost(site: str, E: int, D: int, F: int, row_block: int, rows: int):
    """:func:`_ffn_cost` of a sorted or fused call site (#3/#4, #10/#11,
    #12/#13, #14/#15) over a ``rows``-row buffer: ``row_block``-row tiles,
    each reading one expert's weights."""
    q8 = site.endswith("_q8")
    nt = max(rows // row_block, 1)
    smem = lambda t: max(_eg.tile_smem(2, 256, q8), _eg.tile_smem(2, t[2], q8))  # noqa: E731
    return _ffn_cost(rows, lambda t: (nt, nt), D, F, 1 if q8 else 2, smem)


def sorted_tile(site: str, E: int, D: int, F: int, row_block: int, rows: int, run=None, x=None) -> tuple:
    """The tile of a sorted or fused call site over an aligned buffer of
    ``rows`` rows: the down kernel's BN is tuned; row_block is the
    buffer's layout, not a tile. The key carries both, the rows as their
    bucket; ``run(tile)`` on ``x``, where given, is timed on the card."""
    rule = _eg.default_tile(site, 0, D)
    if not _at.enabled():
        return rule
    nb = row_bucket(rows)
    return _at.get_blocks(
        site, _at.make_key(site, E=E, D=D, F=F, itemsize=1 if site.endswith("_q8") else 2,
                           extra=f"bc{row_block}|N{nb}"),
        rule, _eg.TILES[site], sorted_cost(site, E, D, F, row_block, nb), legal=lambda t: _eg.tile_legal(t, D),
        measure=None if run is None else _timer(run, x))


def grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """Group-size-aware grouped GEMM over the flat expert-sorted layout:
    (N_pad, D) rows, each expert's region ``row_block``-aligned,
    ``group_sizes`` (E,) valid rows per expert."""
    E, D, F_ = w_gate.shape
    tile = sorted_tile("grouped_gemm", E, D, F_, row_block, xs.shape[0],
                       lambda t: _eg.grouped_gemm_fwd(xs, w_gate, w_up, w_down, group_sizes, row_block, t), xs)
    return _eg.grouped_gemm(xs, w_gate, w_up, w_down, group_sizes, row_block, tile=tile)


def grouped_gemm_q8(xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes,
                    row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """int8-weight grouped GEMM over the sorted layout: int8 (E, D, F) /
    (E, F, D) weights with bf16 per-output-channel scales (E, F) / (E, D),
    applied to the fp32 sums. Forward only."""
    E, D, F_ = w_gate.shape
    args = (xs, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, row_block)
    tile = sorted_tile("grouped_gemm_q8", E, D, F_, row_block, xs.shape[0],
                       lambda t: _eg.grouped_gemm_q8(*args, tile=t), xs)
    return _eg.grouped_gemm_q8(*args, tile=tile)


def grouped_gemm_fused(x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted,
                       row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """Dispatch-in-kernel sorted MoE FFN, token-major (T, D) in and out:
    ``token``/``dest``/``slot`` (N,) place each sorted assignment, whose
    gather runs in the gate/up kernel's prologue and whose gate-weighted
    combine (``gate_sorted``, fp32) runs in the down kernel's epilogue.
    Differentiable; the CUDA kernels take only ``row_block`` 128."""
    E, D, F_ = w_gate.shape
    args = (x, w_gate, w_up, w_down, group_sizes, token, dest, slot, gate_sorted, row_block)
    tile = sorted_tile("grouped_gemm_fused", E, D, F_, row_block, _eg.aligned_rows(token.shape[0], E, row_block),
                       lambda t: _eg.grouped_gemm_fused_fwd(*args, t), x)
    return _eg.grouped_gemm_fused(*args, tile=tile)


def grouped_gemm_fused_q8(x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot,
                          gate_sorted, row_block: int = _eg.ROW_TILE) -> torch.Tensor:
    """int8-weight fused-dispatch sorted MoE FFN (scales as in
    :func:`grouped_gemm_q8`). Forward only."""
    E, D, F_ = w_gate.shape
    args = (x, w_gate, w_up, w_down, s_gate, s_up, s_down, group_sizes, token, dest, slot, gate_sorted, row_block)
    tile = sorted_tile("grouped_gemm_fused_q8", E, D, F_, row_block, _eg.aligned_rows(token.shape[0], E, row_block),
                       lambda t: _eg.grouped_gemm_fused_q8(*args, tile=t), x)
    return _eg.grouped_gemm_fused_q8(*args, tile=tile)


def _fold_groups(site: str, fn, fwd, xe, *weights) -> torch.Tensor:
    """Run the padded FFN ``fn`` on (..., E, C, D) at the tile of
    :func:`expert_tile` (timing ``fwd``, the forward without autograd):
    leading group dims fold into each expert's slots, as the JAX
    ``ops.expert_gemm`` does, so the kernel sees (E, G*C, D) and reads each
    expert's weights and scales once."""
    lead = xe.shape[:-3]
    E, C, D = xe.shape[-3:]
    x3 = xe.reshape(-1, E, C, D).transpose(0, 1).reshape(E, -1, D).contiguous() if lead else xe
    tile = expert_tile(site, E, x3.shape[1], D, weights[0].shape[-1], lambda t: fwd(x3, *weights, tile=t), x3)
    y = fn(x3, *weights, tile=tile)
    return y.reshape(E, -1, C, D).transpose(0, 1).reshape(*lead, E, C, D) if lead else y


def expert_gemm(xe, w_gate, w_up, w_down) -> torch.Tensor:
    """Padded expert FFN: (..., E, C, D) -> (..., E, C, D)."""
    return _fold_groups("expert_gemm", _eg.expert_gemm, _eg.expert_gemm_fwd, xe, w_gate, w_up, w_down)


def expert_gemm_q8(xe, w_gate, w_up, w_down, s_gate, s_up, s_down) -> torch.Tensor:
    """int8-weight padded expert FFN, (..., E, C, D) -> (..., E, C, D):
    int8 (E, D, F) / (E, F, D) weights with bf16 per-output-channel scales
    (E, F) / (E, D) applied to the fp32 sums (kernels #8/#9). Forward
    only."""
    return _fold_groups("expert_gemm_q8", _eg.expert_gemm_q8, _eg.expert_gemm_q8, xe, w_gate, w_up, w_down,
                        s_gate, s_up, s_down)


def grouped_gemm_ragged(xs, w_gate, w_up, w_down, group_sizes) -> torch.Tensor:
    """Plain path over the compact buffer (``row_block=1``), the
    counterpart of the JAX package's ``grouped_gemm_xla``: each product
    rounds to the input dtype as ``lax.ragged_dot`` does, and ``silu`` runs
    in fp32 on the rounded gate. Rows past the last group are zero."""
    out = torch.zeros((xs.shape[0], w_down.shape[-1]), dtype=xs.dtype, device=xs.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        if g:
            x = xs[start:start + g]
            h = F.silu((x @ w_gate[e]).float()).to(xs.dtype) * (x @ w_up[e])
            out[start:start + g] = h @ w_down[e]
        start += g
    return out


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,d), k/v (B,Sk,KV,d) -> (B,Sq,H,d); right-aligned
    positions, causal and/or sliding window."""
    return _fa.flash_attention(q, k, v, causal, window, scale)


def paged_attention(q, k_pool, v_pool, block_table, seq_lens,
                    window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode against the block-table KV pool: q (B,H,d),
    pools (num_pages, page_size, KV, d), block_table (B, max_pages) int32
    (-1 = unassigned), seq_lens (B,). The kernel resolves the pages
    itself; no gathered copy."""
    return _pa.paged_attention(q, k_pool, v_pool, block_table, seq_lens, window, scale)


def paged_attention_q8(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                       window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """int8-KV decode: int8 pools with per-token / KV-head fp32 scale
    sidecars shaped (num_pages, page_size, KV, 1), dequantised in the
    kernel's tile."""
    return _pa.paged_attention_q8(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                                  window, scale)


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {**_eg.LAUNCHES, **_fa.LAUNCHES, **_pa.LAUNCHES}


def reset_launch_counts() -> None:
    for d in (_eg.LAUNCHES, _fa.LAUNCHES, _pa.LAUNCHES):
        for k in d:
            d[k] = 0
