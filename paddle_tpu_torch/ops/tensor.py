"""Tensor creation and manipulation ops of the fluid path: the part of
the JAX package's `ops/tensor.py` that the ported programs run
(fill_constant, the random initializers, cast, increment, assign,
reshape2, top_k, and `lookup_table_v2` and `one_hot_v2`, the ops of
`fluid.embedding` and `fluid.one_hot`).
The rest of that file is still to port (ROADMAP item 15).

Random ops draw from `ctx.rng()`, a generator seeded from the step and
the op's uid, so their numbers are the port's own: a parity run loads
the JAX package's initial scope instead (`convert.scope_from_numpy`).
"""

from __future__ import annotations

import math

import torch

from ..core.registry import (GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG,
                             register_op, torch_dtype)


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


@register_op("top_k", nondiff_inputs=(), intermediate_outputs=("Indices",))
def top_k(ins, attrs, ctx):
    x = _x(ins)
    k = int(attrs["k"]) if "k" in attrs else int(ins["K"][0])
    vals, idx = torch.topk(x, k, dim=-1, largest=True, sorted=True)
    return {"Out": vals, "Indices": idx.to(torch.int64)}


def _lookup_table_grad(ins, attrs, ctx):
    """The W gradient of `lookup_table_v2`: the output gradient's rows
    scatter-added at their ids (rows at `padding_idx` dropped). The JAX
    package's `is_sparse` branch returns a SelectedRows, which the port
    does not have yet (ROADMAP item 16)."""
    if bool(attrs.get("is_sparse", False)):
        raise NotImplementedError(
            "lookup_table_v2 with is_sparse=True: SelectedRows gradients "
            "are not ported (ROADMAP item 16)")
    w = ins[GRAD_PREFIX_IN + "W"][0]
    ids = ins[GRAD_PREFIX_IN + "Ids"][0]
    og = ins[GRAD_PREFIX_OG + "Out"][0]
    padding_idx = int(attrs.get("padding_idx", -1))
    flat_ids = ids.to(torch.int64).reshape(-1)
    rows = og.reshape(flat_ids.shape[0], -1).to(w.dtype)
    if padding_idx != -1:
        rows = torch.where((flat_ids == padding_idx)[:, None],
                           torch.zeros_like(rows), rows)
    gw = torch.zeros_like(w).index_add_(0, flat_ids, rows)
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
