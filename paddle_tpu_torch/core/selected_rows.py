"""SelectedRows: the sparse row-slice gradient value, the JAX package's
`core/selected_rows.py` on torch.

Reference: framework/selected_rows.h:32, `{height, rows[], value[N, D]}`,
the form an embedding gradient takes so that the optimizers touch only
the rows a batch used (math/selected_rows_functor.cc merge/add; the
sparse branches of sgd_op, adam_op, adagrad_op). `lookup_table`'s
gradient makes one when `is_sparse`; `sum` concatenates row sets; the
optimizer ops apply row-sparse updates.

The JAX package keeps static shapes for XLA (a merge folds duplicates
into their first slot and zeroes the rest). The port runs eagerly, so
`merged()` returns the unique ids and one summed row each. It sums
repeated ids in a fixed order: a stable sort by id, then a segment sum
that adds each id's rows in the order they came (from 0), so a merge
gives the same bits on the CPU and on CUDA, run after run, and equals a
sequential scatter-add into zeros (the CPU's `index_add_`). `to_dense()`
writes the merged rows into zeros with `index_copy`, so a dense gradient
made through it has those bits too (CUDA's `index_add_` adds repeated
rows with atomics, in no fixed order).
"""

from __future__ import annotations

from typing import Tuple

import torch


def merge_rows(ids: torch.Tensor, rows: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique ids ascending, their rows summed in arrival order)."""
    ids = ids.reshape(-1).to(torch.int64)
    order = torch.argsort(ids, stable=True)
    uids, counts = torch.unique_consecutive(ids[order], return_counts=True)
    summed = torch.segment_reduce(rows[order], "sum", lengths=counts,
                                  unsafe=True)
    return uids, summed.to(rows.dtype)


class SelectedRows:
    """rows [N, D] values at int ids [N] of a [height, D] table."""

    def __init__(self, rows: torch.Tensor, ids: torch.Tensor, height: int):
        self.rows = rows
        self.ids = ids
        self.height = int(height)

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def shape(self):
        """The dense gradient's shape, [height, D]."""
        return torch.Size((self.height,) + tuple(self.rows.shape[1:]))

    def astype(self, dt) -> "SelectedRows":
        return SelectedRows(self.rows.to(dt), self.ids, self.height)

    def merged(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, rows): each id once, ascending, with its rows summed
        (the reference's merge_add)."""
        return merge_rows(self.ids, self.rows)

    def to_dense(self) -> torch.Tensor:
        """The dense [height, D] gradient: the merged rows at their ids,
        zeros elsewhere."""
        ids, rows = self.merged()
        out = torch.zeros(self.shape, dtype=self.rows.dtype,
                          device=self.rows.device)
        return out.index_copy_(0, ids, rows)


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)


def to_dense(v):
    return v.to_dense() if isinstance(v, SelectedRows) else v
