"""Token dispatch subsystem (port of ``repro.core.dispatch``): the padded
``allgather`` dispatcher (capacity-factor-bounded) and the sorted
dropless one. ``get_dispatcher`` applies the JAX package's legality rules
for a device with no expert-parallel plan, which is every single-card run
of the port: ``alltoall`` and ``a2a_overlap`` need an EP plan, so they
fall back to ``allgather`` with a warning, or raise ``ValueError`` under
``moe.strict_dispatch`` or a truthy ``REPRO_STRICT_DISPATCH``. Expert-choice
routing emits per-expert tables, so ``sorted`` with it resolves to
``allgather`` (silently, as in the JAX package).
"""
from __future__ import annotations

import os
import warnings
from typing import Any

from repro_torch.core.dispatch.allgather import AllGatherDispatcher
from repro_torch.core.dispatch.base import (
    DispatchLayout,
    DispatchState,
    TokenDispatcher,
    capacity,
    dispatch_tables,
    expert_choice_tables,
    expert_ffn,
    padded_tables,
)
from repro_torch.core.dispatch.sorted import KERNEL_ROW_BLOCK, SortedDispatcher, aligned_rows


def strict_dispatch_env() -> bool:
    """Environment override making every EP-dispatcher fallback an error
    (the test suite exports ``REPRO_STRICT_DISPATCH=1``)."""
    return os.environ.get("REPRO_STRICT_DISPATCH", "").lower() in ("1", "true", "yes", "on")


def get_dispatcher(cfg: Any, moe: Any) -> TokenDispatcher:
    """Resolve ``moe.dispatcher`` to a legal dispatcher on one device (no
    EP plan), as the JAX ``get_dispatcher`` does with ``plan=None``."""
    name = moe.dispatcher
    if name == "sorted" and moe.router_type == "expert_choice":
        # the flat top-k assignment list the sort permutes does not exist
        name = "allgather"
    if name == "sorted" and moe.capacity_factor is not None:
        warnings.warn(
            "dispatcher='sorted' is always dropless: capacity_factor="
            f"{moe.capacity_factor} is ignored (no CF-bounded token dropping). "
            "Use a padded dispatcher for CF semantics.",
            stacklevel=2,
        )
    if name in ("alltoall", "a2a_overlap"):
        reason = ("expert_choice routing needs the full (T, E) gate table"
                  if moe.router_type == "expert_choice" else "no EP plan (plan=None)")
        msg = (
            f"dispatcher {name!r} is illegal here — {reason}; falling back to "
            "'allgather'. In serving mode this fallback silently forfeits the EP win: pad the "
            "batch to the token-shard product or pick a legal dispatcher."
        )
        if getattr(moe, "strict_dispatch", False) or strict_dispatch_env():
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
        name = "allgather"
    if name == "allgather":
        return AllGatherDispatcher(cfg, moe)
    if name == "sorted":
        return SortedDispatcher(cfg, moe)
    raise ValueError(f"unknown dispatcher {name!r}")


__all__ = [
    "DispatchLayout", "DispatchState", "TokenDispatcher", "AllGatherDispatcher", "SortedDispatcher",
    "KERNEL_ROW_BLOCK", "aligned_rows", "capacity", "dispatch_tables", "expert_choice_tables", "expert_ffn",
    "get_dispatcher", "padded_tables", "strict_dispatch_env",
]
