"""Reduction ops of the fluid path: the JAX package's `ops/reduce.py` on
torch (reference: paddle/fluid/operators/reduce_ops/, one reduce_op.h
template over sum/mean/max/min/prod/all/any)."""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _axes(attrs, ndim):
    if attrs.get("reduce_all", False):
        return None
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


def _shape1(out):
    """Framework convention: full reductions yield shape [1], never 0-d
    (reference reduce_op.h; the backward loss seed is built as [1])."""
    return out.reshape(1) if out.ndim == 0 else out


def _prod(x, dim, keepdim):
    # torch.prod takes one dim at a time
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    def kernel(ins, attrs, ctx):
        x = ins["X"][0]
        axes = _axes(attrs, x.ndim)
        if axes is None:
            axes = tuple(range(x.ndim))
        keep = attrs.get("keep_dim", False)
        return {"Out": _shape1(fn(x, axes, keep))}

    return kernel


register_op("reduce_sum")(_reduce(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)))
register_op("reduce_mean")(_reduce(lambda x, d, k: torch.mean(x, dim=d, keepdim=k)))
register_op("reduce_max")(_reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)))
register_op("reduce_min")(_reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)))
register_op("reduce_prod")(_reduce(_prod))
register_op("reduce_all", grad=None)(
    _reduce(lambda x, d, k: torch.all(x, dim=d, keepdim=k)))
register_op("reduce_any", grad=None)(
    _reduce(lambda x, d, k: torch.any(x, dim=d, keepdim=k)))
register_op("logsumexp")(
    _reduce(lambda x, d, k: torch.logsumexp(x, dim=d, keepdim=k)))
register_op("frobenius_norm")(
    _reduce(lambda x, d, k: torch.sqrt(torch.sum(torch.square(x), dim=d,
                                                 keepdim=k))))


@register_op("mean")
def mean(ins, attrs, ctx):
    """reference: operators/mean_op.cc — full mean to scalar [1]."""
    return {"Out": torch.mean(ins["X"][0]).reshape(1)}
