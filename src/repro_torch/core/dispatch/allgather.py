"""AllGather token dispatcher (port of ``repro.core.dispatch.allgather``):
the dense padded ``(G, E, C, D)`` layout with capacity-factor-bounded
token dropping (``capacity``, ``dispatch_tables``). On one card there is
no expert-parallel plan, so G = 1 (``num_groups(None, ...)`` in the JAX
package); more groups come with the multi-GPU slice (ROADMAP queue 1,
'Multi-GPU'). With ``capacity_factor=None`` the padded layout grows to C = T
(the sorted dispatcher is the efficient dropless path).

Under expert-choice routing (``router_type="expert_choice"``) the gates are
the full (T, E) probabilities and each expert takes its top-C tokens
(``expert_choice_tables``). The combine sums each token's slots in (e, c)
order, the JAX scatter-add's update order, through ``core.segment``: no
scatter-add, so a step is bit-reproducible whatever the number of slots a
token fills.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch.base import (
    DispatchLayout, DispatchState, TokenDispatcher, capacity, expert_choice_tables, padded_tables,
)
from repro_torch.core.segment import row_gather, row_owner, slot_row_table, table_sum


class AllGatherDispatcher(TokenDispatcher):
    name = "allgather"

    def __init__(self, cfg, moe, groups: int = 1):
        if groups != 1:
            raise NotImplementedError(
                f"groups={groups}: grouped padded dispatch needs a device mesh (ROADMAP queue 1, "
                "'Multi-GPU')")
        super().__init__(cfg, moe)
        self.groups = groups

    def dispatch(self, x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor):
        T, D = x.shape
        E, k = self.moe.num_experts, self.moe.top_k
        C = capacity(self.moe, T)
        if self.moe.router_type == "expert_choice":
            # gates carries the full (T, E) probability matrix
            sel, slot_gate = expert_choice_tables(gates.reshape(T, E), E, C)
            table = slot_row_table(sel, T)
        else:
            sel, slot_gate, table = padded_tables(idx.reshape(T, k), gates.reshape(T, k), E, C)
        # (G=1, E, C, D): empty slots carry token 0's row
        xe = row_gather(x, sel.reshape(E * C), table).reshape(1, E, C, D)
        state = DispatchState(
            layout=DispatchLayout("padded", E, capacity=C),
            residuals={"sel": sel[None], "slot_gate": slot_gate[None], "table": table,
                       "owner": row_owner(table, E * C)},
            static={"tokens": T, "tg": T},
        )
        return xe, state

    def combine(self, ye: torch.Tensor, state: DispatchState) -> torch.Tensor:
        """Gate-weight each slot and sum each token's slots in (e, c)
        order, in the buffer's dtype as the JAX combine does (the sorted
        combine sums in fp32). Empty and dropped slots add nothing."""
        r = state.residuals
        E, C = state.layout.num_experts, state.layout.capacity
        D = ye.shape[-1]
        ye = ye * r["slot_gate"][..., None].to(ye.dtype)
        out = table_sum(ye[0].reshape(E * C, D), r["table"], r["owner"])
        return out.reshape(state.static["tokens"], D)
