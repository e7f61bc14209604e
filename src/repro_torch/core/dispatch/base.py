"""TokenDispatcher interface and the expert FFN at the kernel boundary
(port of ``repro.core.dispatch.base``, sorted layout only).

A dispatcher moves routed tokens from the token-major model layout to an
expert-major buffer (``dispatch``) and back with the gate weighting applied
(``combine``); every per-call value travels in the returned
:class:`DispatchState`, so one instance is re-entrant.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class DispatchLayout:
    """The expert-major buffer a dispatcher produced. ``kind="sorted"``: a
    flat ``(N, D)`` expert-sorted buffer with ``group_sizes`` (E,) valid
    rows per expert, each expert's region aligned to ``row_block`` rows
    (1 = compact; the grouped-GEMM kernel needs its row-tile size)."""

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


def expert_ffn(experts, xe: torch.Tensor, layout: DispatchLayout, use_kernel: bool = False) -> torch.Tensor:
    """Fused-SwiGLU expert FFN in the layout ``xe`` is in. Sorted: ``(N, D)
    -> (N, D)``; the grouped-GEMM kernel wrapper when ``use_kernel``, else
    the compact ragged path (the counterpart of ``grouped_gemm_xla``)."""
    from repro_torch.kernels import ops

    if layout.kind != "sorted":
        raise NotImplementedError(
            "the padded (E, C, D) layout is ROADMAP queue 1, 'padded dispatch'"
        )
    args = (xe, experts["w_gate"], experts["w_up"], experts["w_down"], layout.group_sizes)
    if use_kernel:
        return ops.grouped_gemm(*args, row_block=layout.row_block)
    return ops.grouped_gemm_ragged(*args)


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
