"""TokenDispatcher interface, the shared dispatch bookkeeping (capacity,
the padded layout's tables) and the expert FFN at the kernel boundary
(port of ``repro.core.dispatch.base``).

A dispatcher moves routed tokens from the token-major model layout to an
expert-major buffer (``dispatch``) and back with the gate weighting applied
(``combine``); every per-call value travels in the returned
:class:`DispatchState`, so one instance is re-entrant.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class DispatchLayout:
    """The expert-major buffer a dispatcher produced.

    * ``kind="padded"``: dense ``(..., E, C, D)`` buffer, ``capacity`` slots
      per expert; slots past the routed count hold token 0's row and are
      zeroed by the gate weights at combine.
    * ``kind="sorted"``: a flat ``(N, D)`` expert-sorted buffer with
      ``group_sizes`` (E,) valid rows per expert, each expert's region
      aligned to ``row_block`` rows (1 = compact; the grouped-GEMM kernel
      needs its row-tile size)."""

    kind: str
    num_experts: int
    capacity: Optional[int] = None
    group_sizes: Optional[torch.Tensor] = None
    row_block: int = 1


@dataclasses.dataclass
class DispatchState:
    """Per-invocation dispatch residuals handed from ``dispatch`` to
    ``combine``: the layout for the kernel layer, the tensors that reverse
    the permutation, and static metadata (token counts)."""

    layout: DispatchLayout
    residuals: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    static: Dict[str, Any] = dataclasses.field(default_factory=dict)


def capacity(moe, tokens_per_group: int) -> int:
    """Paper §2: ``C = ceil(k * tokens_per_group / E * CF)``, clipped to
    [1, tokens_per_group] (an expert takes each token at most once).
    ``CF=None`` is dropless under the padded layout: C = tokens_per_group."""
    if moe.capacity_factor is None:
        return tokens_per_group
    c = math.ceil(moe.top_k * tokens_per_group / moe.num_experts * moe.capacity_factor)
    return max(min(int(c), tokens_per_group), 1)


def padded_tables(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`dispatch_tables` plus the combine's row table: (sel, slot_gate,
    table (T, k)), where ``table[t]`` lists the slots ``e * C + c`` that
    token t fills, ascending, with the sentinel ``E * C`` for a dropped
    assignment (``core.segment``)."""
    T, k = idx.shape
    flat_e = idx.reshape(T * k).long()
    onehot = torch.nn.functional.one_hot(flat_e, E)  # (Tk, E)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1  # (Tk,)
    keep = pos < C
    safe_pos = torch.where(keep, pos, C)  # overflow -> dump column C
    token_id = torch.arange(T * k, device=idx.device) // k
    gate_flat = torch.where(keep, gates.reshape(T * k).float(), 0.0)
    sel = torch.zeros((E, C + 1), dtype=torch.long, device=idx.device).index_put((flat_e, safe_pos), token_id)
    slot_gate = torch.zeros((E, C + 1), dtype=torch.float32, device=idx.device).index_put(
        (flat_e, safe_pos), gate_flat)
    table = torch.sort(torch.where(keep, flat_e * C + pos, E * C).reshape(T, k), dim=1).values
    return sel[:, :C], slot_gate[:, :C], table


def dispatch_tables(idx: torch.Tensor, gates: torch.Tensor, E: int, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded layout's tables for one group. idx/gates (T, k) -> (sel
    (E, C) int64 token ids, slot_gate (E, C) fp32 combine weights).
    Priority is token-major (the paper's / Megatron's drop rule): an
    assignment at position >= C in its expert's queue is dropped, with gate
    0. An empty slot holds token id 0 and gate 0, so the buffer's empty
    rows are token 0's row, not zeros. Differentiable in ``gates``."""
    return padded_tables(idx, gates, E, C)[:2]


def expert_choice_tables(probs_full: torch.Tensor, E: int, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-choice routing (Zhou et al.; the alternative to top-k the
    paper cites): each expert takes its top-C tokens by router
    probability, ties to the lower token index (a stable descending sort,
    as ``jax.lax.top_k``). probs_full (T, E) -> (sel (E, C) int64 token
    ids, slot_gate (E, C) fp32). Every slot is filled; a token may get 0 to
    E experts."""
    g, sel = torch.sort(probs_full.t(), dim=-1, descending=True, stable=True)
    return sel[:, :C], g[:, :C].float()


def expert_ffn(experts, xe: torch.Tensor, layout: DispatchLayout, use_kernel: bool = False) -> torch.Tensor:
    """Fused-SwiGLU expert FFN in the layout ``xe`` is in.

    * padded: ``(..., E, C, D) -> (..., E, C, D)``; the expert-GEMM kernel
      wrapper when ``use_kernel``, else the batched einsum path.
    * sorted: ``(N, D) -> (N, D)``; the grouped-GEMM kernel wrapper when
      ``use_kernel``, else the compact ragged path (the counterpart of
      ``grouped_gemm_xla``).

    int8 experts (``core/quant.py`` dicts with ``*_scale`` keys) take the
    int8 kernels on the kernel path (grouped on sorted, expert on padded);
    the plain paths dequantise the weights to ``xe``'s dtype first.
    """
    from repro_torch.core.quant import dequantize_experts, is_quantized
    from repro_torch.kernels import ops

    quant = is_quantized(experts)
    if layout.kind == "sorted":
        if use_kernel and quant:
            return ops.grouped_gemm_q8(
                xe, experts["w_gate"], experts["w_up"], experts["w_down"], experts["w_gate_scale"],
                experts["w_up_scale"], experts["w_down_scale"], layout.group_sizes, row_block=layout.row_block)
        if quant:
            experts = dequantize_experts(experts, xe.dtype)
        args = (xe, experts["w_gate"], experts["w_up"], experts["w_down"], layout.group_sizes)
        if use_kernel:
            return ops.grouped_gemm(*args, row_block=layout.row_block)
        return ops.grouped_gemm_ragged(*args)
    if use_kernel and quant:
        return ops.expert_gemm_q8(xe, experts["w_gate"], experts["w_up"], experts["w_down"],
                                  experts["w_gate_scale"], experts["w_up_scale"], experts["w_down_scale"])
    if quant:
        experts = dequantize_experts(experts, xe.dtype)
    if use_kernel:
        return ops.expert_gemm(xe, experts["w_gate"], experts["w_up"], experts["w_down"])
    g = torch.einsum("...ecd,edf->...ecf", xe, experts["w_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xe, experts["w_up"])
    h = torch.nn.functional.silu(g.float()).to(xe.dtype) * u
    return torch.einsum("...ecf,efd->...ecd", h, experts["w_down"])


class TokenDispatcher:
    """Stateless dispatch/combine pair; ``apply`` runs dispatch -> expert
    FFN -> combine."""

    name = "base"

    def __init__(self, cfg: Any, moe: Any):
        self.cfg, self.moe = cfg, moe

    def dispatch(self, x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor) -> Tuple[torch.Tensor, DispatchState]:
        raise NotImplementedError

    def combine(self, ye: torch.Tensor, state: DispatchState) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, experts, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
        xe, state = self.dispatch(x, idx, gates)
        ye = expert_ffn(experts, xe, state.layout, use_kernel)
        return self.combine(ye, state)
