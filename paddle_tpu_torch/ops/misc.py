"""The SelectedRows ops of the JAX package's `ops/misc.py` (:744-790):
`merge_selected_rows`, `get_tensor_from_selected_rows` and
`split_selected_rows` (reference: merge_selected_rows_op.cc,
get_tensor_from_selected_rows_op.cc, split_selected_rows_op.cc), and
`log_loss` (:266), the loss of the CTR program that trains a sparse
embedding (tools/ctr_bench.py), and the three ops the dygraph layers
reach: `spectral_norm` (:94), `row_conv` (:120) and `conv3d_transpose`
(:483). The rest of that module is still to port (ROADMAP item 15).

The JAX package keeps every SelectedRows at its slot count (a merge
zeroes repeated slots, a split masks out-of-section ids); the port runs
eagerly and gives the reference's shapes: a merge has each id once, a
section holds only its own rows. Both densify to the same tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


@register_op("spectral_norm", nondiff_inputs=("U", "V"))
def spectral_norm(ins, attrs, ctx):
    """reference: spectral_norm_op.cc: Weight over its largest singular
    value, estimated by `power_iters` rounds (at least one) from U and
    V. The rounds are part of the forward, so the gradient runs through
    them, as `jax.vjp` of the JAX op's scan does."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1)
    v = ins["V"][0].reshape(-1)
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    perm = (dim,) + tuple(i for i in range(w.ndim) if i != dim)
    wm = w.permute(perm).reshape(w.shape[dim], -1)          # [H, W']
    for _ in range(max(int(attrs.get("power_iters", 1)), 1)):
        v = wm.T @ u
        v = v / (torch.sqrt(torch.sum(v * v)) + eps)
        u = wm @ v
        u = u / (torch.sqrt(torch.sum(u * u)) + eps)
    return {"Out": w / (u @ wm @ v)}


@register_op("row_conv", nondiff_inputs=())
def row_conv(ins, attrs, ctx):
    """reference: row_conv_op.cc: the lookahead convolution (Deep
    Speech 2), out[t] = sum_{k<K} w[k] * x[t+k] per feature, x [N, T, D]
    and Filter [K, D]; frames past T contribute zeros."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    t = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(filt.shape[0]):
        if i >= t:
            break
        shifted = F.pad(x[:, i:], (0, 0, 0, i))
        out = out + shifted * filt[i][None, None, :]
    return {"Out": out}


@register_op("conv3d_transpose")
def conv3d_transpose(ins, attrs, ctx):
    """reference: conv_transpose_op.cc's 3-D branch: Input [N, C_in, D,
    H, W], Filter [C_in, C_out, kd, kh, kw]; each output dim is (in - 1)
    s - 2 p + (k - 1) d + 1, as the JAX op's `conv_transpose` gives."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1, 1]))
    dilations = tuple(int(d) for d in attrs.get("dilations", [1, 1, 1]))
    pads = tuple(int(p) for p in attrs.get("paddings", [0, 0, 0]))
    return {"Output": F.conv_transpose3d(x, w, stride=strides, padding=pads,
                                         dilation=dilations)}
