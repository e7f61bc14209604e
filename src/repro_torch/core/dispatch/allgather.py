"""AllGather token dispatcher (port of ``repro.core.dispatch.allgather``):
the dense padded ``(G, E, C, D)`` layout with capacity-factor-bounded
token dropping (``capacity``, ``dispatch_tables``). On one card there is
no expert-parallel plan, so G = 1 (``num_groups(None, ...)`` in the JAX
package); more groups come with the multi-GPU slice (ROADMAP queue 1,
'Multi-GPU'). With ``capacity_factor=None`` the padded layout grows to C = T
(the sorted dispatcher is the efficient dropless path).
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch.base import DispatchLayout, DispatchState, TokenDispatcher, capacity, dispatch_tables


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
        sel, slot_gate = dispatch_tables(idx.reshape(T, k), gates.reshape(T, k), E, C)
        xe = x[sel][None]  # (G=1, E, C, D): empty slots carry token 0's row
        state = DispatchState(
            layout=DispatchLayout("padded", E, capacity=C),
            residuals={"sel": sel[None], "slot_gate": slot_gate[None]},
            static={"tokens": T, "tg": T},
        )
        return xe, state

    def combine(self, ye: torch.Tensor, state: DispatchState) -> torch.Tensor:
        """Gate-weight each slot and scatter-add it back to token order, in
        the buffer's dtype as the JAX combine does (the sorted combine sums
        in fp32)."""
        r = state.residuals
        E, C = state.layout.num_experts, state.layout.capacity
        Tg, D = state.static["tg"], ye.shape[-1]
        ye = ye * r["slot_gate"][..., None].to(ye.dtype)
        out = torch.zeros((Tg, D), dtype=ye.dtype, device=ye.device)
        out = out.index_add(0, r["sel"][0].reshape(E * C), ye[0].reshape(E * C, D))
        return out.reshape(state.static["tokens"], D)
