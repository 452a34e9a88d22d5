"""Tensor creation and manipulation ops of the fluid path: the part of
the JAX package's `ops/tensor.py` that the ported programs run
(fill_constant, the random initializers, cast, reshape2 and top_k).
The rest of that file is still to port (ROADMAP item 15).

Random ops draw from `ctx.rng()`, a generator seeded from the step and
the op's uid, so their numbers are the port's own: a parity run loads
the JAX package's initial scope instead (`convert.scope_from_numpy`).
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op, torch_dtype


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
