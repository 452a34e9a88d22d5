"""Math ops of the fluid path: the JAX package's `ops/math.py` on torch.
Elementwise ops with the reference's axis broadcast, the matmul
family, sum and scale.

Reference: paddle/fluid/operators/elementwise/ (16 ops), matmul_op.cc,
mul_op.cc, sum_op.cc, scale_op.cc. The SelectedRows branches of `_ew`
and `sum` (sparse embedding gradients) are not ported: the port has no
SelectedRows value (ROADMAP item 15).
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op


def _bcast(x, y, axis: int):
    """Reference broadcast (elementwise_op_function.h): align y's dims to x
    starting at `axis` (axis=-1 → trailing alignment)."""
    if x.shape == y.shape:
        return x, y
    if axis == -1 or y.ndim == 0:
        return x, y
    # pad y's shape with trailing 1s so it aligns at `axis`
    new_shape = [1] * x.ndim
    for i, s in enumerate(y.shape):
        new_shape[axis + i] = s
    return x, y.reshape(new_shape)


def _ew(fn):
    def kernel(ins, attrs, ctx):
        x, y = _bcast(ins["X"][0], ins["Y"][0], int(attrs.get("axis", -1)))
        return {"Out": fn(x, y)}

    return kernel


register_op("elementwise_add")(_ew(torch.add))
register_op("elementwise_sub")(_ew(torch.sub))
register_op("elementwise_mul")(_ew(torch.mul))
register_op("elementwise_div")(_ew(torch.div))
register_op("elementwise_max")(_ew(torch.maximum))
register_op("elementwise_min")(_ew(torch.minimum))
register_op("elementwise_pow")(_ew(torch.pow))
register_op("elementwise_mod", grad=None)(_ew(torch.remainder))
register_op("elementwise_floordiv", grad=None)(_ew(torch.floor_divide))


@register_op("sum")
def sum_op(ins, attrs, ctx):
    """Multi-input add (reference: operators/sum_op.cc): the grad
    accumulator emitted by backward.py."""
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("scale")
def scale(ins, attrs, ctx):
    x = ins["X"][0]
    s = attrs.get("scale", 1.0)
    if ins.get("ScaleTensor") and ins["ScaleTensor"][0] is not None:
        s = ins["ScaleTensor"][0].to(x.dtype)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    return {"Out": out.to(x.dtype)}


@register_op("mul")
def mul(ins, attrs, ctx):
    """reference: operators/mul_op.cc — flatten X to 2D at x_num_col_dims,
    Y at y_num_col_dims, then GEMM (the `fc` workhorse)."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    xm = x.reshape((math.prod(x.shape[:xnc]), -1))
    ym = y.reshape((math.prod(y.shape[:ync]), -1))
    out = xm @ ym
    out_shape = tuple(x.shape[:xnc]) + tuple(y.shape[ync:])
    return {"Out": out.reshape(out_shape)}


@register_op("matmul")
def matmul(ins, attrs, ctx):
    """reference: operators/matmul_op.cc (transpose_X/Y, alpha)."""
    x, y = ins["X"][0], ins["Y"][0]
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    alpha = attrs.get("alpha", 1.0)
    if x.ndim == 1:
        x = x[None, :] if not tx else x[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("matmul_v2")
def matmul_v2(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("bmm")
def bmm(ins, attrs, ctx):
    return {"Out": torch.matmul(ins["X"][0], ins["Y"][0])}


@register_op("dot")
def dot(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.sum(x * y, dim=-1, keepdim=True)}


@register_op("addmm")
def addmm(ins, attrs, ctx):
    inp, x, y = ins["Input"][0], ins["X"][0], ins["Y"][0]
    return {"Out": attrs.get("Beta", 1.0) * inp + attrs.get("Alpha", 1.0) * (x @ y)}


@register_op("kron")
def kron(ins, attrs, ctx):
    return {"Out": torch.kron(ins["X"][0], ins["Y"][0])}


@register_op("trace")
def trace_op(ins, attrs, ctx):
    x = ins["Input"][0]
    return {"Out": torch.diagonal(x, offset=int(attrs.get("offset", 0)),
                                  dim1=int(attrs.get("axis1", 0)),
                                  dim2=int(attrs.get("axis2", 1))).sum(-1)}


@register_op("cholesky")
def cholesky(ins, attrs, ctx):
    c = torch.linalg.cholesky(ins["X"][0])
    return {"Out": c.transpose(-1, -2) if attrs.get("upper", False) else c}


@register_op("inverse")
def inverse(ins, attrs, ctx):
    return {"Out": torch.linalg.inv(ins["Input"][0])}


@register_op("max", grad="generic")
def max_op(ins, attrs, ctx):
    return {"Out": torch.maximum(ins["X"][0], ins["Y"][0])}


@register_op("maximum")
def maximum(ins, attrs, ctx):
    return {"Out": torch.maximum(ins["X"][0], ins["Y"][0])}


@register_op("minimum")
def minimum(ins, attrs, ctx):
    return {"Out": torch.minimum(ins["X"][0], ins["Y"][0])}


@register_op("l1_norm")
def l1_norm(ins, attrs, ctx):
    """reference: l1_norm_op.cc — sum(|x|) to shape [1]."""
    return {"Out": torch.sum(torch.abs(ins["X"][0])).reshape(1)}
