"""Optimizer ops of the fluid path: `sgd`, `momentum` and `adam` from the
JAX package's `ops/optimizer_ops.py`, dense gradients only (reference:
paddle/fluid/operators/optimizers/). The SelectedRows branches (sparse
embedding gradients) and the other optimizers' ops are still to port
(ROADMAP item 15).

All are grad=None and functional: they return the updated state, which
the executor writes back to the scope in place of the old.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(ins):
    lr = ins["LearningRate"][0]
    return lr.reshape(()) if lr.ndim else lr


@register_op("sgd", grad=None)
def sgd(ins, attrs, ctx):
    """reference: optimizers/sgd_op.cc, the dense branch."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins).to(p.dtype)
    return {"ParamOut": p - lr * g.to(p.dtype)}


@register_op("momentum", grad=None)
def momentum(ins, attrs, ctx):
    """reference: optimizers/momentum_op.cc."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins).to(p.dtype)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("adam", grad=None)
def adam(ins, attrs, ctx):
    """reference: optimizers/adam_op.cc (Beta1Pow/Beta2Pow threaded as
    1-element tensors exactly like the reference)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins).to(torch.float32)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p_new.to(p.dtype), "Moment1Out": m1n,
            "Moment2Out": m2n, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}
