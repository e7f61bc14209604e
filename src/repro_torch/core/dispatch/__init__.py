"""Token dispatch subsystem (port of ``repro.core.dispatch``). Only the
sorted dropless dispatcher is ported; asking for another raises
``NotImplementedError`` naming the slice that ports it — the port never
substitutes one dispatcher for another."""
from __future__ import annotations

import warnings
from typing import Any

from repro_torch.core.dispatch.base import DispatchLayout, DispatchState, TokenDispatcher, expert_ffn
from repro_torch.core.dispatch.sorted import KERNEL_ROW_BLOCK, SortedDispatcher, aligned_rows

_LATER = {
    "allgather": "ROADMAP queue 1, 'padded dispatch'",
    "alltoall": "ROADMAP queue 1, 'multi-GPU'",
    "a2a_overlap": "ROADMAP queue 1, 'multi-GPU'",
}


def get_dispatcher(cfg: Any, moe: Any) -> TokenDispatcher:
    name = moe.dispatcher
    if name != "sorted":
        raise NotImplementedError(
            f"dispatcher {name!r} is not ported yet ({_LATER.get(name, 'unknown')}); "
            "pass dispatcher='sorted'"
        )
    if moe.capacity_factor is not None:
        warnings.warn(
            "dispatcher='sorted' is always dropless: capacity_factor="
            f"{moe.capacity_factor} is ignored (no CF-bounded token dropping).",
            stacklevel=2,
        )
    return SortedDispatcher(cfg, moe)


__all__ = [
    "DispatchLayout", "DispatchState", "TokenDispatcher", "SortedDispatcher",
    "KERNEL_ROW_BLOCK", "aligned_rows", "expert_ffn", "get_dispatcher",
]
