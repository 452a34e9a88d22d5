"""Tensor creation and manipulation ops of the fluid path: the JAX
package's `ops/tensor.py` (reference: paddle/fluid/operators/
{fill_constant,uniform_random,gaussian_random,cast,concat,split,stack,
reshape,transpose,squeeze,unsqueeze,expand,slice,gather,scatter,assign,
shape,one_hot,lookup_table,...}_op.cc).

Random ops draw from `ctx.rng()`, a generator seeded from the step and
the op's uid, so their numbers are the port's own: a parity run loads
the JAX package's initial scope instead (`convert.scope_from_numpy`).

Ops whose output depends on a value (`range`, `linspace`, `load`, the
sizes of `where_index`) read it on the host, as the JAX package needs
it at trace time. `unique` keeps that package's static-shape
convention: every output has the input's length.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import (GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG,
                             register_op, torch_dtype)
from ..core.selected_rows import SelectedRows, is_selected_rows


def _dt(attrs, key="dtype", default="float32"):
    return torch_dtype(attrs.get(key, default))


def _x(ins, slot="X"):
    return ins[slot][0]


@register_op("fill_constant", grad=None)
def fill_constant(ins, attrs, ctx):
    shape = [int(s) for s in attrs.get("shape", [1])]
    val = attrs.get("value", 0.0)
    return {"Out": torch.full(shape, val, dtype=_dt(attrs), device=ctx.device)}


def _uniform(ctx, shape, lo, hi):
    u = torch.rand(shape, generator=ctx.rng(), dtype=torch.float32,
                   device=ctx.device)
    return u * (hi - lo) + lo


@register_op("uniform_random", grad=None, is_random=True)
def uniform_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": _uniform(ctx, shape, lo, hi).to(_dt(attrs))}


@register_op("gaussian_random", grad=None, is_random=True)
def gaussian_random(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    z = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    return {"Out": (mean + std * z).to(_dt(attrs))}


@register_op("truncated_gaussian_random", grad=None, is_random=True)
def truncated_gaussian_random(ins, attrs, ctx):
    """A normal truncated to [-2, 2] std, by the inverse CDF as
    `jax.random.truncated_normal` draws it."""
    shape = [int(s) for s in attrs["shape"]]
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    a, b = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    z = math.sqrt(2.0) * torch.erfinv(_uniform(ctx, shape, a, b))
    z = torch.clamp(z, -2.0, 2.0)
    return {"Out": (mean + std * z).to(_dt(attrs))}


@register_op("cast")
def cast(ins, attrs, ctx):
    return {"Out": _x(ins).to(_dt(attrs, "out_dtype"))}


@register_op("increment", grad=None)
def increment(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": x + torch.as_tensor(attrs.get("step", 1.0)).to(x.dtype)}


@register_op("assign")
def assign(ins, attrs, ctx):
    return {"Out": _x(ins)}


@register_op("reshape2", intermediate_outputs=("XShape",))
def reshape2(ins, attrs, ctx):
    x = _x(ins)
    if ins.get("Shape") and ins["Shape"][0] is not None:
        shape = [int(s) for s in ins["Shape"][0].tolist()]
    else:
        shape = [int(s) for s in attrs["shape"]]
    # paddle semantics: 0 means copy the input dim at that position
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": torch.reshape(x, shape), "XShape": None}


def stable_top_k(x: torch.Tensor, k: int, dim: int = -1):
    """The k largest entries of `x` along `dim`, largest first, ties to
    the lower index, as `jax.lax.top_k` breaks them: (values, indices).
    `torch.topk` promises no order among ties, so this takes a stable
    descending sort of the whole row and slices it to k. The sort costs
    O(n log n) where topk costs O(n log k), which the ops that call it
    (`top_k`, `top_k_v2`, `sparse_allreduce`, beam search and the
    detection ops' selections) can afford for exact agreement with the
    JAX package."""
    values, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), idx.narrow(dim, 0, k)


@register_op("top_k", nondiff_inputs=(), intermediate_outputs=("Indices",))
def top_k(ins, attrs, ctx):
    x = _x(ins)
    k = int(attrs["k"]) if "k" in attrs else int(ins["K"][0])
    vals, idx = stable_top_k(x, k)
    return {"Out": vals, "Indices": idx.to(torch.int64)}


def _lookup_table_grad(ins, attrs, ctx):
    """The W gradient of `lookup_table` and `lookup_table_v2`: the output
    gradient's rows at their ids (rows at `padding_idx` zeroed; v1's
    trailing [., 1] of Ids leaves the flat ids as they are). With
    `is_sparse` it is a SelectedRows (reference: lookup_table_op.cc
    declares W@GRAD SELECTED_ROWS), so the optimizer touches only those
    rows; else the dense [V, D] gradient, made through the same merge of
    repeated ids (`core/selected_rows.py`), which sums them in a fixed
    order on the card too."""
    w = ins[GRAD_PREFIX_IN + "W"][0]
    ids = ins[GRAD_PREFIX_IN + "Ids"][0]
    og = ins[GRAD_PREFIX_OG + "Out"][0]
    padding_idx = int(attrs.get("padding_idx", -1))
    flat_ids = ids.to(torch.int64).reshape(-1)
    rows = og.reshape(flat_ids.shape[0], -1).to(w.dtype)
    if padding_idx != -1:
        rows = torch.where((flat_ids == padding_idx)[:, None],
                           torch.zeros_like(rows), rows)
    gw = SelectedRows(rows, flat_ids, w.shape[0])
    if not bool(attrs.get("is_sparse", False)):
        gw = gw.to_dense()
    return {GRAD_PREFIX_IG + "W": [gw]}


@register_op("lookup_table_v2", grad=_lookup_table_grad,
             nondiff_inputs=("Ids",))
def lookup_table_v2(ins, attrs, ctx):
    """reference: lookup_table_v2_op.cc: W [V, D] rows at Ids, the id
    tensor's shape kept ([N, 1] -> [N, 1, D])."""
    w, ids = ins["W"][0], ins["Ids"][0]
    padding_idx = int(attrs.get("padding_idx", -1))
    idx = ids.to(torch.int64)
    out = w[idx]
    if padding_idx != -1:
        out = torch.where((idx == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": out}


@register_op("one_hot_v2", grad=None, nondiff_inputs=("X",))
def one_hot_v2(ins, attrs, ctx):
    """reference: one_hot_v2_op.cc: appends depth to the input shape as
    it is (one_hot squeezes a trailing [., 1] dim); an id outside
    [0, depth) gives a row of zeros, as `jax.nn.one_hot`."""
    x = _x(ins)
    depth = int(attrs["depth"])
    iota = torch.arange(depth, device=x.device)
    return {"Out": (x[..., None].to(torch.int64) == iota).to(torch.float32)}


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------


def batch_size_like_shape(ins, attrs):
    """The BatchSizeLikeOp shape rule: shape[output_dim_idx] =
    Input.shape[input_dim_idx]."""
    ref = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        ref.shape[int(attrs.get("input_dim_idx", 0))]
    return shape


@register_op("fill_constant_batch_size_like", grad=None,
             nondiff_inputs=("Input",))
def fill_constant_batch_size_like(ins, attrs, ctx):
    return {"Out": torch.full(batch_size_like_shape(ins, attrs),
                              attrs.get("value", 0.0), dtype=_dt(attrs),
                              device=ins["Input"][0].device)}


@register_op("fill_zeros_like", grad=None, nondiff_inputs=("X",))
def fill_zeros_like(ins, attrs, ctx):
    return {"Out": torch.zeros_like(_x(ins))}


@register_op("randint", grad=None, is_random=True)
def randint(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    out = torch.randint(int(attrs.get("low", 0)), int(attrs.get("high", 100)),
                        shape, generator=ctx.rng(), device=ctx.device)
    return {"Out": out.to(_dt(attrs, default="int64"))}


@register_op("range", grad=None, nondiff_inputs=("Start", "End", "Step"))
def range_op(ins, attrs, ctx):
    """The bounds are read on the host (the JAX package needs them at
    trace time)."""
    start, end, step = ins["Start"][0], ins["End"][0], ins["Step"][0]
    s, e, st = float(start), float(end), float(step)
    return {"Out": torch.arange(s, e, st, dtype=start.dtype,
                                device=start.device)}


@register_op("assign_value", grad=None)
def assign_value(ins, attrs, ctx):
    shape = [int(s) for s in attrs["shape"]]
    vals = attrs.get("fp32_values") or attrs.get("int32_values") or \
        attrs.get("values")
    return {"Out": torch.tensor(vals, dtype=_dt(attrs),
                                device=ctx.device).reshape(shape)}


@register_op("shape", grad=None, nondiff_inputs=("Input",))
def shape_op(ins, attrs, ctx):
    x = ins["Input"][0]
    return {"Out": torch.tensor(list(x.shape), dtype=torch.int32,
                                device=x.device)}


@register_op("fill", grad=None)
def fill_op(ins, attrs, ctx):
    """reference: fill_op.cc: explicit per-element values and a shape."""
    shape = [int(s) for s in attrs["shape"]]
    vals = attrs.get("value", attrs.get("values"))
    return {"Out": torch.tensor(vals, dtype=_dt(attrs),
                                device=ctx.device).reshape(shape)}


def _like_dtype(attrs, x):
    return _dt(attrs) if attrs.get("dtype") else x.dtype


@register_op("fill_any_like", grad=None, nondiff_inputs=("X",))
def fill_any_like(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": torch.full(x.shape, attrs.get("value", 0.0),
                              dtype=_like_dtype(attrs, x), device=x.device)}


@register_op("fill_zeros_like2", grad=None, nondiff_inputs=("X",))
def fill_zeros_like2(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": torch.zeros(x.shape, dtype=_like_dtype(attrs, x),
                               device=x.device)}


@register_op("linspace", grad=None, nondiff_inputs=("Start", "Stop", "Num"))
def linspace(ins, attrs, ctx):
    s, e, n = ins["Start"][0], ins["Stop"][0], ins["Num"][0]
    return {"Out": torch.linspace(float(s), float(e), int(n),
                                  dtype=_dt(attrs), device=s.device)}


@register_op("eye", grad=None)
def eye(ins, attrs, ctx):
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", n))
    return {"Out": torch.eye(n, m, dtype=_dt(attrs), device=ctx.device)}


# ---------------------------------------------------------------------------
# Shape manipulation
# ---------------------------------------------------------------------------


@register_op("reshape")
def reshape(ins, attrs, ctx):
    return {"Out": reshape2(ins, attrs, ctx)["Out"]}


@register_op("transpose2", intermediate_outputs=("XShape",))
def transpose2(ins, attrs, ctx):
    return {"Out": _x(ins).permute(*[int(a) for a in attrs["axis"]]),
            "XShape": None}


@register_op("transpose")
def transpose(ins, attrs, ctx):
    return {"Out": transpose2(ins, attrs, ctx)["Out"]}


@register_op("squeeze2", intermediate_outputs=("XShape",))
def squeeze2(ins, attrs, ctx):
    x = _x(ins)
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": torch.squeeze(x), "XShape": None}
    return {"Out": torch.squeeze(x, dim=tuple(int(a) for a in axes)),
            "XShape": None}


@register_op("unsqueeze2", intermediate_outputs=("XShape",))
def unsqueeze2(ins, attrs, ctx):
    x = _x(ins)
    for a in sorted(int(a) for a in attrs["axes"]):
        x = torch.unsqueeze(x, a)
    return {"Out": x, "XShape": None}


@register_op("squeeze")
def squeeze(ins, attrs, ctx):
    return {"Out": squeeze2(ins, attrs, ctx)["Out"]}


@register_op("unsqueeze")
def unsqueeze(ins, attrs, ctx):
    return {"Out": unsqueeze2(ins, attrs, ctx)["Out"]}


@register_op("flatten2", intermediate_outputs=("XShape",))
def flatten2(ins, attrs, ctx):
    x = _x(ins)
    axis = int(attrs.get("axis", 1))
    lead = math.prod(x.shape[:axis]) if axis > 0 else 1
    return {"Out": torch.reshape(x, (lead, -1)), "XShape": None}


@register_op("flatten")
def flatten(ins, attrs, ctx):
    return {"Out": flatten2(ins, attrs, ctx)["Out"]}


@register_op("concat")
def concat(ins, attrs, ctx):
    xs = [x for x in ins["X"] if x is not None]
    return {"Out": torch.cat(xs, dim=int(attrs.get("axis", 0)))}


@register_op("split")
def split(ins, attrs, ctx):
    x = _x(ins)
    axis = int(attrs.get("axis", 0))
    sections = attrs.get("sections") or []
    if sections:
        idx = np.cumsum(sections[:-1]).tolist()
        outs = torch.tensor_split(x, idx, dim=axis)
    else:
        num = int(attrs.get("num", 0))
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        outs = torch.tensor_split(x, num, dim=axis)
    return {"Out": list(outs)}


@register_op("stack")
def stack(ins, attrs, ctx):
    xs = [x for x in ins["X"] if x is not None]
    return {"Y": torch.stack(xs, dim=int(attrs.get("axis", 0)))}


@register_op("unstack")
def unstack(ins, attrs, ctx):
    return {"Y": list(torch.unbind(_x(ins), dim=int(attrs.get("axis", 0))))}


@register_op("expand")
def expand(ins, attrs, ctx):
    return {"Out": torch.tile(_x(ins), [int(t) for t in attrs["expand_times"]])}


@register_op("expand_as")
def expand_as(ins, attrs, ctx):
    x, target = ins["X"][0], ins["target_tensor"][0]
    return {"Out": torch.tile(x, [t // s for t, s in zip(target.shape,
                                                          x.shape)])}


@register_op("tile")
def tile(ins, attrs, ctx):
    return {"Out": torch.tile(_x(ins), [int(t) for t in attrs["repeat_times"]])}


@register_op("slice")
def slice_op(ins, attrs, ctx):
    x = ins["Input"][0]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        a, s, e = int(a), int(s), int(e)
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    if attrs.get("decrease_axis"):
        out = torch.squeeze(out, dim=tuple(int(a)
                                           for a in attrs["decrease_axis"]))
    return {"Out": out}


@register_op("strided_slice")
def strided_slice(ins, attrs, ctx):
    """Python's slice per axis; a negative stride (which torch's
    indexing lacks) picks its positions with `index_select`."""
    x = ins["Input"][0]
    strides = attrs.get("strides", [1] * len(attrs["axes"]))
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           strides):
        a, sl = int(a), slice(int(s), int(e), int(st))
        if sl.step > 0:
            x = x[(slice(None),) * a + (sl,)]
        else:
            pos = list(range(x.shape[a]))[sl]
            x = torch.index_select(x, a, torch.tensor(
                pos, dtype=torch.int64, device=x.device))
    return {"Out": x}


@register_op("reverse")
def reverse(ins, attrs, ctx):
    return {"Out": torch.flip(_x(ins), dims=[int(a) for a in attrs["axis"]])}


def _pad_pairs(pairs):
    """(before, after) per dim, first dim first -> F.pad's list, last
    dim first."""
    flat = []
    for a, b in reversed(pairs):
        flat += [a, b]
    return flat


@register_op("pad")
def pad(ins, attrs, ctx):
    x = _x(ins)
    p = attrs["paddings"]
    pairs = [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(x.ndim)]
    return {"Out": F.pad(x, _pad_pairs(pairs),
                         value=float(attrs.get("pad_value", 0.0)))}


@register_op("pad2d")
def pad2d(ins, attrs, ctx):
    x = _x(ins)  # NCHW
    t, b, l, r = [int(v) for v in attrs["paddings"]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x, [l, r, t, b],
                             value=float(attrs.get("pad_value", 0.0)))}
    tmode = {"reflect": "reflect", "edge": "replicate"}[mode]
    return {"Out": F.pad(x, [l, r, t, b], mode=tmode)}


# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------


def _take(x, idx, dim):
    """`jnp.take(x, idx, axis=dim)`: the index's shape in place of dim."""
    idx = idx.to(torch.int64)
    out = torch.index_select(x, dim, idx.reshape(-1))
    return out.reshape(x.shape[:dim] + idx.shape + x.shape[dim + 1:])


@register_op("gather", nondiff_inputs=("Index",))
def gather(ins, attrs, ctx):
    return {"Out": _take(ins["X"][0], ins["Index"][0], 0)}


@register_op("gather_nd", nondiff_inputs=("Index",))
def gather_nd(ins, attrs, ctx):
    x, idx = ins["X"][0], ins["Index"][0].to(torch.int64)
    return {"Out": x[tuple(idx[..., i] for i in range(idx.shape[-1]))]}


@register_op("scatter", nondiff_inputs=("Ids",))
def scatter(ins, attrs, ctx):
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.to(torch.int64).reshape(-1)
    return {"Out": x.index_put((ids,), updates.to(x.dtype), accumulate=not
                               attrs.get("overwrite", True))}


@register_op("scatter_nd_add", nondiff_inputs=("Index",))
def scatter_nd_add(ins, attrs, ctx):
    x, idx, upd = ins["X"][0], ins["Index"][0].to(torch.int64), \
        ins["Updates"][0]
    return {"Out": x.index_put(tuple(idx[..., i]
                                     for i in range(idx.shape[-1])),
                               upd.to(x.dtype), accumulate=True)}


@register_op("index_select", nondiff_inputs=("Index",))
def index_select(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": _take(x, ins["Index"][0], int(attrs.get("dim", 0)) % x.ndim)}


def _one_hot(x, depth):
    """An id outside [0, depth) gives a row of zeros, as `jax.nn.one_hot`."""
    iota = torch.arange(depth, device=x.device)
    return (x[..., None].to(torch.int64) == iota).to(torch.float32)


@register_op("one_hot", grad=None, nondiff_inputs=("X",))
def one_hot(ins, attrs, ctx):
    """reference: one_hot_op.cc: a trailing [., 1] dim of the ids is
    squeezed first."""
    x = _x(ins)
    flat = x.reshape(x.shape[:-1]) if x.ndim and x.shape[-1] == 1 else x
    return {"Out": _one_hot(flat, int(attrs["depth"]))}


@register_op("lookup_table", grad=_lookup_table_grad,
             nondiff_inputs=("Ids",))
def lookup_table(ins, attrs, ctx):
    """reference: operators/lookup_table_op.cc: Ids [..., 1] int64, W
    [V, D]; the trailing 1 is squeezed ([N, 1] -> [N, D])."""
    ids = ins["Ids"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return lookup_table_v2({"W": ins["W"], "Ids": [ids]}, attrs, ctx)


@register_op("where", nondiff_inputs=("Condition",))
def where(ins, attrs, ctx):
    c, x, y = ins["Condition"][0], ins["X"][0], ins["Y"][0]
    return {"Out": torch.where(c.to(torch.bool), x, y)}


@register_op("where_index", grad=None, nondiff_inputs=("Condition",))
def where_index(ins, attrs, ctx):
    """The coordinates of the true elements, [k, ndim] int64: k is read
    on the host, as the JAX op runs only outside a trace."""
    return {"Out": torch.nonzero(ins["Condition"][0]).to(torch.int64)}


# ---------------------------------------------------------------------------
# Sorting / search
# ---------------------------------------------------------------------------


@register_op("top_k_v2", intermediate_outputs=("Indices",))
def top_k_v2(ins, attrs, ctx):
    x = _x(ins)
    vals, idx = stable_top_k(x, int(attrs["k"]),
                             dim=int(attrs.get("axis", -1)))
    return {"Out": vals, "Indices": idx.to(torch.int64)}


@register_op("arg_max", grad=None, nondiff_inputs=("X",))
def arg_max(ins, attrs, ctx):
    return {"Out": torch.argmax(_x(ins), dim=int(attrs.get("axis", -1)))}


@register_op("arg_min", grad=None, nondiff_inputs=("X",))
def arg_min(ins, attrs, ctx):
    return {"Out": torch.argmin(_x(ins), dim=int(attrs.get("axis", -1)))}


@register_op("argsort", grad=None, nondiff_inputs=("X",))
def argsort(ins, attrs, ctx):
    """A stable sort, as `jnp.argsort`; descending sorts -x."""
    x = _x(ins)
    axis = int(attrs.get("axis", -1))
    key = -x if attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": torch.take_along_dim(x, idx, dim=axis), "Indices": idx}


def _unique_static(x):
    """The JAX package's jit-safe unique, in first-occurrence order: all
    outputs have length N; slots past the true unique count carry value
    0 and count 0."""
    n = x.shape[0]
    if x.device.type == "meta":
        z = torch.zeros(n, dtype=torch.int64, device=x.device)
        return torch.zeros_like(x), z, z
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    u = vals.shape[0]
    vals = torch.cat([vals, vals.new_zeros(n - u)])
    counts = torch.cat([counts, counts.new_zeros(n - u)])
    # first original position of each sorted-unique slot; padded slots n
    first = torch.full((n,), n, dtype=torch.int64, device=x.device)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=x.device),
                                 "amin")
    order = torch.argsort(first, stable=True)   # occurrence order, pads last
    remap = torch.argsort(order, stable=True)
    return vals[order], remap[inv], counts[order]


@register_op("unique", grad=None, nondiff_inputs=("X",))
def unique(ins, attrs, ctx):
    """reference: unique_op.h: 1-D unique and each element's index into
    the unique list (the static-shape convention of `_unique_static`)."""
    out, index, _ = _unique_static(_x(ins).reshape(-1))
    return {"Out": out, "Index": index}


@register_op("unique_with_counts", grad=None, nondiff_inputs=("X",))
def unique_with_counts(ins, attrs, ctx):
    """reference: unique_with_counts_op.cc: `unique` and each unique
    value's count (0 marks a padding slot)."""
    out, index, counts = _unique_static(_x(ins).reshape(-1))
    return {"Out": out, "Index": index, "Count": counts}


# ---------------------------------------------------------------------------
# Clipping / norms
# ---------------------------------------------------------------------------


@register_op("clip")
def clip(ins, attrs, ctx):
    """A SelectedRows stays sparse: its merged rows are clipped (the
    reference's clip_op SelectedRows kernel clips the merged value)."""
    x = _x(ins)
    if is_selected_rows(x):
        ids, rows = x.merged()
        return {"Out": SelectedRows(
            torch.clamp(rows, attrs.get("min"), attrs.get("max")), ids,
            x.height)}
    return {"Out": torch.clamp(x, attrs.get("min"), attrs.get("max"))}


def _norm_scale(norm, max_norm):
    return torch.where(norm > max_norm,
                       max_norm / torch.clamp(norm, min=1e-12),
                       torch.ones_like(norm))


@register_op("clip_by_norm")
def clip_by_norm(ins, attrs, ctx):
    """A SelectedRows stays sparse: repeated rows merge first (the
    reference's clip_by_norm_op.h merges with merge_add), then scale by
    the merged rows' norm."""
    x = _x(ins)
    max_norm = attrs["max_norm"]
    if is_selected_rows(x):
        ids, rows = x.merged()
        scale = _norm_scale(torch.sqrt(torch.sum(torch.square(rows))),
                            max_norm)
        return {"Out": SelectedRows(rows * scale.to(rows.dtype), ids,
                                    x.height)}
    scale = _norm_scale(torch.sqrt(torch.sum(torch.square(x))), max_norm)
    return {"Out": x * scale.to(x.dtype)}


@register_op("squared_l2_norm")
def squared_l2_norm(ins, attrs, ctx):
    """A SelectedRows: the norm of its merged rows (repeated ids summed
    first, as the reference's merge_add before GlobalNorm)."""
    x = _x(ins)
    if is_selected_rows(x):
        x = x.merged()[1]
    return {"Out": torch.sum(torch.square(x)).reshape(1)}


@register_op("norm", intermediate_outputs=("Norm",))
def norm(ins, attrs, ctx):
    x = _x(ins)
    n = torch.sqrt(torch.sum(torch.square(x), dim=int(attrs.get("axis", -1)),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


@register_op("p_norm")
def p_norm(ins, attrs, ctx):
    x = _x(ins)
    p = attrs.get("porder", 2.0)
    out = torch.sum(torch.abs(x) ** p, dim=int(attrs.get("axis", -1)),
                    keepdim=bool(attrs.get("keepdim", False))) ** (1.0 / p)
    return {"Out": out}


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


@register_op("dlpack/identity", grad=None)
def identity(ins, attrs, ctx):
    return {"Out": _x(ins)}


@register_op("print", grad=None)
def print_op(ins, attrs, ctx):
    """Prints the message and the tensor (a host read, as
    `jax.debug.print` is a host callback)."""
    x = _x(ins)
    if x.device.type != "meta":
        print(attrs.get("message", ""), _host(x))
    return {"Out": x}


@register_op("is_empty", grad=None, nondiff_inputs=("X",))
def is_empty(ins, attrs, ctx):
    x = _x(ins)
    return {"Out": torch.tensor(x.numel() == 0, device=x.device)}


@register_op("cumsum")
def cumsum(ins, attrs, ctx):
    x = _x(ins)
    axis = int(attrs.get("axis", -1))
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                         [axis])
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": out}


@register_op("diag")
def diag(ins, attrs, ctx):
    """reference: operators/diag_op.cc: vector -> diagonal matrix."""
    return {"Out": torch.diag(ins["Diagonal"][0])}


@register_op("size", grad=None, nondiff_inputs=("Input",))
def size_op(ins, attrs, ctx):
    """reference: size_op.cc: the tensor's element count."""
    x = ins["Input"][0]
    return {"Out": torch.tensor([x.numel()], dtype=torch.int64,
                                device=x.device)}


@register_op("diag_part", nondiff_inputs=())
def diag_part(ins, attrs, ctx):
    """The diagonal of a square matrix (MultivariateNormalDiag's)."""
    return {"Out": torch.diagonal(_x(ins))}


@register_op("shard_index", grad=None, nondiff_inputs=("X",))
def shard_index(ins, attrs, ctx):
    """reference: shard_index_op.cc: in // shard_size == shard_id ?
    in % shard_size : ignore_value, with the JAX package's floor
    division and its quirk (an id past index_num // nshards * nshards
    is in no shard) and deviation (an id out of range gives
    ignore_value, with no per-element check)."""
    x = _x(ins)
    index_num, nshards = int(attrs["index_num"]), int(attrs["nshards"])
    shard_size = index_num // nshards
    assert shard_size > 0, (
        f"shard_index: index_num ({index_num}) // nshards ({nshards}) "
        f"== 0; nshards must not exceed index_num")
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == \
        int(attrs["shard_id"])
    ignore = torch.full_like(x, int(attrs.get("ignore_value", -1)))
    return {"Out": torch.where(in_shard, torch.remainder(x, shard_size),
                               ignore)}


# ---------------------------------------------------------------------------
# Run-time persistence, in the JAX ops' formats: one `.npy` a var
# (io.py's save_vars), a `.npz` for the combined ops
# ---------------------------------------------------------------------------


def _resolve_save_path(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


def _declared(ctx, name, op):
    """The declared (shape, torch dtype) of out var `name`."""
    from ..core.ir import normalize_dtype

    if ctx.program is not None:
        for b in ctx.program.blocks:
            if name in b.vars:
                vd = b.vars[name]
                return (tuple(int(s) for s in vd.shape),
                        torch_dtype(normalize_dtype(vd.dtype)))
    raise RuntimeError(
        f"{op}: output var '{name}' has no declared shape; declare the var "
        f"with a concrete shape before layers.load")


def _from_file(arr, shape, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=device, dtype=dtype).reshape(shape)


@register_op("load", grad=None)
def load_op(ins, attrs, ctx):
    """reference: load_op.cc: a persisted var read at run time."""
    path = attrs["file_path"]
    out_names = ctx.op.outputs.get("Out", [])
    if not out_names:
        raise RuntimeError("load: no output var")
    shape, dtype = _declared(ctx, out_names[0], "load")
    if ctx.device.type == "meta":
        return {"Out": torch.empty(shape, dtype=dtype, device=ctx.device)}
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    return {"Out": _from_file(arr, shape, dtype, ctx.device)}


def _host(x):
    return x.detach().cpu().numpy()


@register_op("save", grad=None, nondiff_inputs=("X",))
def save_op(ins, attrs, ctx):
    """reference: save_op.cc: a var persisted at run time."""
    from ..resilience import atomic as _atomic

    x = _x(ins)
    if x.device.type != "meta":
        _atomic.np_save(_resolve_save_path(attrs["file_path"]), _host(x))
    return {}


@register_op("save_combine", grad=None, nondiff_inputs=("X",))
def save_combine(ins, attrs, ctx):
    """reference: save_combine_op.cc: many vars in one `.npz` (io.py's
    save_vars(filename=...) format)."""
    from ..resilience import atomic as _atomic

    pairs = [(n, x) for n, x in zip(ctx.op.inputs.get("X", []), ins["X"])
             if n and x is not None]
    if pairs and pairs[0][1].device.type != "meta":
        _atomic.np_savez(_resolve_save_path(attrs["file_path"]),
                         **{n: _host(x) for n, x in pairs})
    return {}


@register_op("load_combine", grad=None)
def load_combine(ins, attrs, ctx):
    """reference: load_combine_op.cc: the declared vars from a
    save_combine `.npz`."""
    path = attrs["file_path"]
    out_names = ctx.op.outputs.get("Out", [])
    decl = [_declared(ctx, n, "load_combine") for n in out_names]
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(s, dtype=d, device=ctx.device)
                        for s, d in decl]}
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    return {"Out": [_from_file(data[n], s, d, ctx.device)
                    for n, (s, d) in zip(out_names, decl)]}
