"""Activation ops of the fluid path: the JAX package's
`ops/activation.py` on torch (reference:
paddle/fluid/operators/activation_op.cc, one macro table)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _unary(fn):
    def kernel(ins, attrs, ctx):
        return {"Out": fn(ins["X"][0], attrs)}

    return kernel


def _softplus(x):
    # log(1 + e^x) without F.softplus's linear cut-off (jax.nn.softplus)
    return torch.logaddexp(x, torch.zeros_like(x))


_SIMPLE = {
    "relu": lambda x, a: torch.relu(x),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "exp": lambda x, a: torch.exp(x),
    "log": lambda x, a: torch.log(x),
    "log1p": lambda x, a: torch.log1p(x),
    "log2": lambda x, a: torch.log2(x),
    "log10": lambda x, a: torch.log10(x),
    "abs": lambda x, a: torch.abs(x),
    "square": lambda x, a: torch.square(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: torch.rsqrt(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "softsign": lambda x, a: F.softsign(x),
    "sin": lambda x, a: torch.sin(x),
    "cos": lambda x, a: torch.cos(x),
    "tan": lambda x, a: torch.tan(x),
    "asin": lambda x, a: torch.asin(x),
    "acos": lambda x, a: torch.acos(x),
    "atan": lambda x, a: torch.atan(x),
    "sinh": lambda x, a: torch.sinh(x),
    "cosh": lambda x, a: torch.cosh(x),
    "erf": lambda x, a: torch.erf(x),
    "floor": lambda x, a: torch.floor(x),
    "ceil": lambda x, a: torch.ceil(x),
    "round": lambda x, a: torch.round(x),
    "sign": lambda x, a: torch.sign(x),
    "silu": lambda x, a: F.silu(x),
    "mish": lambda x, a: x * torch.tanh(_softplus(x)),
}

for _name, _fn in _SIMPLE.items():
    grad = None if _name in ("floor", "ceil", "round", "sign") else "generic"
    register_op(_name, grad=grad)(_unary(_fn))


@register_op("gelu")
def gelu(ins, attrs, ctx):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(ins["X"][0], approximate=approximate)}


@register_op("leaky_relu")
def leaky_relu(ins, attrs, ctx):
    x = ins["X"][0]
    alpha = attrs.get("alpha", 0.02)
    return {"Out": torch.where(x >= 0, x, alpha * x)}


@register_op("elu")
def elu(ins, attrs, ctx):
    x = ins["X"][0]
    alpha = attrs.get("alpha", 1.0)
    # the unselected branch sees 0, as in jax.nn.elu, so its gradient
    # stays finite where x is large
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return {"Out": torch.where(x > 0, x, alpha * torch.expm1(safe))}


@register_op("selu")
def selu(ins, attrs, ctx):
    return {"Out": F.selu(ins["X"][0])}


@register_op("relu6")
def relu6(ins, attrs, ctx):
    return {"Out": torch.clamp(ins["X"][0], 0.0, attrs.get("threshold", 6.0))}


@register_op("brelu")
def brelu(ins, attrs, ctx):
    return {"Out": torch.clamp(ins["X"][0], attrs.get("t_min", 0.0),
                               attrs.get("t_max", 24.0))}


@register_op("softplus")
def softplus(ins, attrs, ctx):
    return {"Out": _softplus(ins["X"][0])}


@register_op("softshrink")
def softshrink(ins, attrs, ctx):
    x = ins["X"][0]
    lam = attrs.get("lambda", 0.5)
    zero = torch.zeros_like(x)
    return {"Out": torch.where(x > lam, x - lam,
                               torch.where(x < -lam, x + lam, zero))}


@register_op("hard_shrink")
def hard_shrink(ins, attrs, ctx):
    x = ins["X"][0]
    t = attrs.get("threshold", 0.5)
    return {"Out": torch.where(torch.abs(x) > t, x, torch.zeros_like(x))}


@register_op("thresholded_relu")
def thresholded_relu(ins, attrs, ctx):
    x = ins["X"][0]
    t = attrs.get("threshold", 1.0)
    return {"Out": torch.where(x > t, x, torch.zeros_like(x))}


@register_op("hard_sigmoid")
def hard_sigmoid(ins, attrs, ctx):
    x = ins["X"][0]
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": torch.clamp(slope * x + offset, 0.0, 1.0)}


@register_op("hard_swish")
def hard_swish(ins, attrs, ctx):
    x = ins["X"][0]
    t = attrs.get("threshold", 6.0)
    s = attrs.get("scale", 6.0)
    o = attrs.get("offset", 3.0)
    return {"Out": x * torch.clamp(x + o, 0.0, t) / s}


@register_op("swish")
def swish(ins, attrs, ctx):
    x = ins["X"][0]
    beta = attrs.get("beta", 1.0)
    return {"Out": x * torch.sigmoid(beta * x)}


@register_op("stanh")
def stanh(ins, attrs, ctx):
    x = ins["X"][0]
    a = attrs.get("scale_a", 0.67)
    b = attrs.get("scale_b", 1.7159)
    return {"Out": b * torch.tanh(a * x)}


@register_op("prelu")
def prelu(ins, attrs, ctx):
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "channel" and alpha.ndim == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return {"Out": torch.where(x >= 0, x, alpha * x)}


@register_op("pow")
def pow_op(ins, attrs, ctx):
    x = ins["X"][0]
    f = attrs.get("factor", 1.0)
    if ins.get("FactorTensor") and ins["FactorTensor"][0] is not None:
        f = ins["FactorTensor"][0]
    return {"Out": torch.pow(x, f)}


@register_op("maxout")
def maxout(ins, attrs, ctx):
    x = ins["X"][0]  # NCHW
    groups = int(attrs["groups"])
    n, c, h, w = x.shape
    return {"Out": torch.amax(x.reshape(n, c // groups, groups, h, w), dim=2)}


@register_op("soft_relu")
def soft_relu(ins, attrs, ctx):
    """reference: activation_op.cc SoftRelu — ln(1+exp(clip(x, ±t)))."""
    t = attrs.get("threshold", 40.0)
    return {"Out": torch.log1p(torch.exp(torch.clamp(ins["X"][0], -t, t)))}
