"""Sorted dropless dispatcher (port of ``repro.core.dispatch.sorted``):
token assignments are stably argsorted by expert id into one flat
expert-sorted buffer plus per-expert ``group_sizes``; every assignment is
computed, no capacity. On the kernel path each expert's region is aligned
to ``KERNEL_ROW_BLOCK`` rows so every 128-row tile of the buffer belongs to
one expert; the plain path uses the compact buffer (``row_block=1``).

With ``moe.fused_dispatch`` and ``use_kernel`` the buffer is never built:
``_apply_fused`` hands the token-major x and the routing vectors to
``ops.grouped_gemm_fused(_q8)``, whose kernels gather the rows in their
prologue and apply the gates and the combine in their epilogue. Without
``use_kernel`` the flag is inert, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch.base import DispatchLayout, DispatchState, TokenDispatcher, expert_ffn
from repro_torch.core.segment import row_gather, sorted_row_table, table_sum
from repro_torch.kernels.ref import aligned_rows

# Row alignment of the expert-sorted buffer on the kernel path; the CUDA
# grouped GEMM reads its per-tile metadata at this granularity whatever its
# own inner tile is.
KERNEL_ROW_BLOCK = 128


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
        # each token's k sorted rows, ascending: the combine's and the
        # gather's backward sum over them in this fixed order
        table = sorted_row_table(token, T)
        xs = x.new_zeros((aligned_rows(N, E, row_block), D))
        xs[dest] = row_gather(x, token, table, sentinel=False)
        state = DispatchState(
            layout=DispatchLayout("sorted", E, group_sizes=group_sizes, row_block=row_block),
            residuals={"token": token, "dest": dest, "gate_sorted": gate_sorted, "table": table},
            static={"tokens": T},
        )
        return xs, state

    def combine(self, ye: torch.Tensor, state: DispatchState) -> torch.Tensor:
        """Gate-weight the valid rows in fp32 and sum each token's k rows
        in sorted (expert) order, the JAX scatter-add's update order; cast
        once at the end."""
        r = state.residuals
        yv = ye[r["dest"]].float() * r["gate_sorted"][:, None].float()
        return table_sum(yv, r["table"], r["token"], sentinel=False).to(ye.dtype)

    def _apply_fused(self, experts, x, gates, idx):
        """Dispatch-in-kernel path: neither the (N_pad, D) buffer nor the
        (N, D) gathered output exists in device memory."""
        from repro_torch.core.quant import is_quantized
        from repro_torch.kernels import ops

        token, slot, dest, gate_sorted, group_sizes = self._indices(idx, gates, KERNEL_ROW_BLOCK)
        routing = (group_sizes, token, dest, slot, gate_sorted)
        if is_quantized(experts):
            return ops.grouped_gemm_fused_q8(
                x, experts["w_gate"], experts["w_up"], experts["w_down"], experts["w_gate_scale"],
                experts["w_up_scale"], experts["w_down_scale"], *routing, row_block=KERNEL_ROW_BLOCK)
        return ops.grouped_gemm_fused(x, experts["w_gate"], experts["w_up"], experts["w_down"], *routing,
                                      row_block=KERNEL_ROW_BLOCK)

    def apply(self, experts, x, gates, idx, use_kernel: bool = False):
        if use_kernel and getattr(self.moe, "fused_dispatch", False):
            return self._apply_fused(experts, x, gates, idx)
        row_block = KERNEL_ROW_BLOCK if use_kernel else 1
        xe, state = self.dispatch(x, idx, gates, row_block=row_block)
        ye = expert_ffn(experts, xe, state.layout, use_kernel)
        return self.combine(ye, state)
