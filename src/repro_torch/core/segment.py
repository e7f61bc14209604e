"""Order-fixed per-token sums for the MoE dispatch and combine.

A token's MoE output is the sum of the rows its experts computed for it,
and the backward of the dispatch gather sums, for each token, the
gradients of the rows that copied it. On CUDA ``index_add_`` adds repeated
targets in atomic order, so with three or more addends a step stops being
bit-reproducible (top-8 routing; expert choice, where a token gets up to E
rows). Here each such sum is a gather and a reduction over a fixed axis:

* a *row table* ``(T, W)`` lists, for each token, the rows it sums in the
  order they are added: ascending row of the expert-major buffer, the
  order the JAX package's scatter-add applies its updates in, so the CPU
  parity stays tight. An unused entry holds the sentinel ``R`` (the number
  of rows), which reads a zero row appended to the rows;
* :func:`table_sum` adds, for every token, ``0 + rows[t0] + rows[t1] +
  ...`` column by column in the rows' dtype;
* :func:`row_gather` (``x[owner]``) and :func:`table_sum` are each other's
  adjoints, and each one's backward is the other, so no gradient is ever
  summed by a scatter-add either.
"""
from __future__ import annotations

import torch


def sum_columns(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[t] = ((0 + rows[table[t, 0]]) + rows[table[t, 1]]) + ...`` in
    ``rows``' dtype, one column at a time (the declared order). Every entry
    of ``table`` must index ``rows``."""
    out = torch.zeros((table.shape[0],) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    for j in range(table.shape[1]):
        out = out + rows[table[:, j]]
    return out


def _with_zero_row(rows: torch.Tensor, sentinel: bool) -> torch.Tensor:
    return torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])]) if sentinel else rows


def row_owner(table: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows,) the token whose table lists each row; ``T`` for a row no
    token reads (an empty or dropped slot)."""
    T, W = table.shape
    tok = torch.arange(T, device=table.device).repeat_interleave(W)
    flat = table.reshape(-1)
    owner = torch.full((rows + 1,), T, dtype=torch.long, device=table.device)
    owner[flat] = torch.where(flat < rows, tok, T)  # every write to the sentinel is T
    return owner[:rows]


class _TableSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, table, owner, sentinel):
        ctx.save_for_backward(owner)
        ctx.sentinel = sentinel
        return sum_columns(_with_zero_row(rows, sentinel), table)

    @staticmethod
    def backward(ctx, dout):
        (owner,) = ctx.saved_tensors
        return _with_zero_row(dout, ctx.sentinel)[owner], None, None, None


class _RowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, owner, table, sentinel):
        ctx.save_for_backward(table)
        ctx.sentinel = sentinel
        return x[owner]

    @staticmethod
    def backward(ctx, drows):
        (table,) = ctx.saved_tensors
        return sum_columns(_with_zero_row(drows, ctx.sentinel), table), None, None, None


def table_sum(rows: torch.Tensor, table: torch.Tensor, owner: torch.Tensor,
              sentinel: bool = True) -> torch.Tensor:
    """(R, ...) rows -> (T, ...): each token's rows summed in table order.
    ``owner = row_owner(table, R)``; the backward hands each row its
    token's gradient (a gather). ``sentinel=False`` promises a table with
    no sentinel entry (the sorted layout), which spares the zero row."""
    return _TableSum.apply(rows, table, owner, sentinel)


def row_gather(x: torch.Tensor, owner: torch.Tensor, table: torch.Tensor, sentinel: bool = True) -> torch.Tensor:
    """``x[owner]`` whose backward sums each token's row gradients in
    ``table`` order; rows that ``table`` does not list (the padded layout's
    empty slots, which copy token 0) pass no gradient."""
    return _RowGather.apply(x, owner, table, sentinel)


def sorted_row_table(token: torch.Tensor, T: int) -> torch.Tensor:
    """(T, k) rows of the expert-sorted order that each token owns,
    ascending; ``token`` (N = T k,) is the token of each sorted row."""
    return torch.argsort(token, stable=True).reshape(T, token.shape[0] // T)


def slot_row_table(sel: torch.Tensor, T: int) -> torch.Tensor:
    """(T, E) table of the padded layout under expert choice: column e holds
    the slot ``e * C + c`` where expert e took the token, or the sentinel
    ``E * C``. ``sel`` (E, C) holds distinct tokens per expert."""
    E, C = sel.shape
    table = torch.full((T, E), E * C, dtype=torch.long, device=sel.device)
    experts = torch.arange(E, device=sel.device).repeat_interleave(C)
    table[sel.reshape(-1).long(), experts] = torch.arange(E * C, device=sel.device)
    return table
