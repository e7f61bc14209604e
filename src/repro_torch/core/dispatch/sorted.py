"""Sorted dropless dispatcher (port of ``repro.core.dispatch.sorted``):
token assignments are stably argsorted by expert id into one flat
expert-sorted buffer plus per-expert ``group_sizes``; every assignment is
computed, no capacity. On the kernel path each expert's region is aligned
to ``KERNEL_ROW_BLOCK`` rows so every 128-row tile of the buffer belongs to
one expert; the plain path uses the compact buffer (``row_block=1``).

Not in this slice: the fused dispatch-in-kernel path (``_apply_fused``).
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch.base import DispatchLayout, DispatchState, TokenDispatcher, expert_ffn

# Row alignment of the expert-sorted buffer on the kernel path; the CUDA
# grouped GEMM reads its per-tile metadata at this granularity whatever its
# own inner tile is.
KERNEL_ROW_BLOCK = 128


def aligned_rows(N: int, E: int, row_block: int) -> int:
    """Static worst-case buffer rows: sum_e ceil(g_e/b)*b <= N + E*(b-1),
    rounded up to a whole number of row tiles."""
    if row_block <= 1:
        return N
    return -(-(N + E * (row_block - 1)) // row_block) * row_block


class SortedDispatcher(TokenDispatcher):
    name = "sorted"

    def _indices(self, idx: torch.Tensor, gates: torch.Tensor, row_block: int):
        """The stable expert-major sort: (token, slot, dest, gate_sorted,
        group_sizes), all on the device, no host sync."""
        T, k = idx.shape
        E = self.moe.num_experts
        N = T * k
        b = row_block
        flat_e = idx.reshape(N).long()
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        token = order // k
        slot = (order % k).int()
        group_sizes = torch.bincount(flat_e, minlength=E).int()
        padded = (group_sizes + b - 1) // b * b
        starts_pad = torch.cumsum(padded, 0) - padded
        starts = torch.cumsum(group_sizes, 0) - group_sizes
        pos_in_group = torch.arange(N, device=idx.device) - starts[sorted_e]
        dest = starts_pad[sorted_e] + pos_in_group
        gate_sorted = gates.reshape(N)[order]
        return token, slot, dest, gate_sorted, group_sizes

    def dispatch(self, x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, row_block: int = 1):
        T, D = x.shape
        E = self.moe.num_experts
        N = T * idx.shape[-1]
        token, _, dest, gate_sorted, group_sizes = self._indices(idx, gates, row_block)
        xs = x.new_zeros((aligned_rows(N, E, row_block), D))
        xs[dest] = x[token]
        state = DispatchState(
            layout=DispatchLayout("sorted", E, group_sizes=group_sizes, row_block=row_block),
            residuals={"token": token, "dest": dest, "gate_sorted": gate_sorted},
            static={"tokens": T},
        )
        return xs, state

    def combine(self, ye: torch.Tensor, state: DispatchState) -> torch.Tensor:
        r = state.residuals
        # fp32 accumulation of the k-way scatter-add; cast once at the end
        yv = ye[r["dest"]].float() * r["gate_sorted"][:, None].float()
        out = torch.zeros((state.static["tokens"], ye.shape[-1]), dtype=torch.float32, device=ye.device)
        out.index_add_(0, r["token"], yv)
        return out.to(ye.dtype)

    def apply(self, experts, x, gates, idx, use_kernel: bool = False):
        if getattr(self.moe, "fused_dispatch", False):
            raise NotImplementedError("fused dispatch is ROADMAP queue 1, 'fused dispatch'")
        row_block = KERNEL_ROW_BLOCK if use_kernel else 1
        xe, state = self.dispatch(x, idx, gates, row_block=row_block)
        ye = expert_ffn(experts, xe, state.layout, use_kernel)
        return self.combine(ye, state)
