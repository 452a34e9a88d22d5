"""Comparison and logical ops of the fluid path: the JAX package's
`ops/compare.py` (reference: operators/controlflow/compare_op.cc,
logical_op.cc; isfinite: operators/isfinite_op.cc). Forward only, with
boolean outputs and numpy's broadcast."""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _cmp(fn):
    def kernel(ins, attrs, ctx):
        return {"Out": fn(ins["X"][0], ins["Y"][0])}

    return kernel


register_op("equal", grad=None)(_cmp(torch.eq))
register_op("not_equal", grad=None)(_cmp(torch.ne))
register_op("less_than", grad=None)(_cmp(torch.lt))
register_op("less_equal", grad=None)(_cmp(torch.le))
register_op("greater_than", grad=None)(_cmp(torch.gt))
register_op("greater_equal", grad=None)(_cmp(torch.ge))
register_op("logical_and", grad=None)(_cmp(torch.logical_and))
register_op("logical_or", grad=None)(_cmp(torch.logical_or))
register_op("logical_xor", grad=None)(_cmp(torch.logical_xor))


@register_op("logical_not", grad=None)
def logical_not(ins, attrs, ctx):
    return {"Out": torch.logical_not(ins["X"][0])}


@register_op("isinf", grad=None)
def isinf(ins, attrs, ctx):
    return {"Out": torch.any(torch.isinf(ins["X"][0])).reshape(1)}


@register_op("isnan", grad=None)
def isnan(ins, attrs, ctx):
    return {"Out": torch.any(torch.isnan(ins["X"][0])).reshape(1)}


@register_op("isfinite", grad=None)
def isfinite(ins, attrs, ctx):
    return {"Out": torch.all(torch.isfinite(ins["X"][0])).reshape(1)}


@register_op("isinf_v2", grad=None)
def isinf_v2(ins, attrs, ctx):
    return {"Out": torch.isinf(ins["X"][0])}


@register_op("isnan_v2", grad=None)
def isnan_v2(ins, attrs, ctx):
    return {"Out": torch.isnan(ins["X"][0])}


@register_op("allclose", grad=None)
def allclose(ins, attrs, ctx):
    """A 0-d bool tensor on the inputs' device (no host read), as
    `jnp.allclose`: |x - y| <= atol + rtol |y| everywhere."""
    x, y = ins["Input"][0], ins["Other"][0]
    return {"Out": torch.isclose(
        x, y, rtol=float(attrs.get("rtol", 1e-5)),
        atol=float(attrs.get("atol", 1e-8)),
        equal_nan=bool(attrs.get("equal_nan", False))).all()}
