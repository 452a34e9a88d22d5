"""The SelectedRows ops of the JAX package's `ops/misc.py` (:744-790):
`merge_selected_rows`, `get_tensor_from_selected_rows` and
`split_selected_rows` (reference: merge_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc, split_selected_rows_op.cc), and
`log_loss` (:266), the loss of the CTR program that trains a sparse
embedding (tools/ctr_bench.py). The rest of that module is still to
port (ROADMAP item 15).

The JAX package keeps every SelectedRows at its slot count (a merge
zeroes repeated slots, a split masks out-of-section ids); the port runs
eagerly and gives the reference's shapes: a merge has each id once, a
section holds only its own rows. Both densify to the same tensors.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, is_selected_rows


@register_op("merge_selected_rows", grad=None)
def merge_selected_rows(ins, attrs, ctx):
    """Sum the rows of repeated ids (MergeAdd); a dense input passes."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        return {"Out": x}
    ids, rows = x.merged()
    return {"Out": SelectedRows(rows, ids, x.height)}


@register_op("get_tensor_from_selected_rows", grad=None)
def get_tensor_from_selected_rows(ins, attrs, ctx):
    """A SelectedRows' value tensor as a dense tensor."""
    x = ins["X"][0]
    return {"Out": x.rows if is_selected_rows(x) else x}


@register_op("split_selected_rows", grad=None)
def split_selected_rows(ins, attrs, ctx):
    """Split a SelectedRows by height sections (the parameter server's
    shard split): each section takes the rows whose ids fall in it, ids
    made local."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        raise TypeError("split_selected_rows wants a SelectedRows input")
    outs = []
    off = 0
    for h in (int(s) for s in attrs["height_sections"]):
        inside = (x.ids >= off) & (x.ids < off + h)
        outs.append(SelectedRows(x.rows[inside], x.ids[inside] - off, h))
        off += h
    return {"Out": outs}


@register_op("log_loss")
def log_loss(ins, attrs, ctx):
    """reference: log_loss_op.cc: -y log(p + eps) - (1 - y) log(1 - p +
    eps), elementwise."""
    p = ins["Predicted"][0]
    y = ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": -y * torch.log(p + eps) - (1 - y) * torch.log(1 - p + eps)}
