"""NN ops of the fluid path: the part of the JAX package's `ops/nn.py`
that the ported programs run (conv2d, pool2d, dropout, softmax,
softmax_with_cross_entropy, square_error_cost). The rest of that file
is still to port (ROADMAP item 15).

NCHW as the reference takes it; convolutions and pooling run on
PyTorch's own (cuDNN on the card), since the JAX package runs XLA's
there and no Pallas kernel. Explicit, asymmetric and "SAME" paddings
are applied with `F.pad` where the library call takes only a symmetric
one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _same_pads(size, k, stride, dilation):
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _conv_padding(attrs, nd, x_spatial, k_spatial, strides, dilations):
    """Per spatial dim (before, after), from the op's padding attrs."""
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        return [_same_pads(x_spatial[i], k_spatial[i], strides[i], dilations[i])
                for i in range(nd)]
    if algo == "VALID":
        return [(0, 0)] * nd
    pads = [int(p) for p in attrs.get("paddings", [0] * nd)]
    if len(pads) == nd:
        return [(p, p) for p in pads]
    # [before0, after0, before1, after1, ...]
    return [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]


def _pad_spatial(x, pairs, value=0.0):
    """x padded by (before, after) pairs over its trailing spatial dims,
    or None when every pair is symmetric (the caller passes those to
    the library call)."""
    if all(a == b for a, b in pairs):
        return None
    flat = []
    for a, b in reversed(pairs):  # F.pad lists the last dim first
        flat += [a, b]
    return F.pad(x, flat, value=value)


def _conv2d(x, w, attrs):
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1]))
    dilations = tuple(int(d) for d in attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    pairs = _conv_padding(attrs, 2, x.shape[2:], w.shape[2:], strides,
                          dilations)
    xp = _pad_spatial(x, pairs)
    if xp is None:
        padding = tuple(a for a, _ in pairs)
    else:
        x, padding = xp, (0, 0)
    return F.conv2d(x, w, stride=strides, padding=padding,
                    dilation=dilations, groups=groups)


@register_op("conv2d", nondiff_inputs=())
def conv2d(ins, attrs, ctx):
    x, w = ins["Input"][0], ins["Filter"][0]
    out = _conv2d(x, w, attrs)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Output": out}


def _pool2d(x, attrs):
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) and all(
            k == 1 for k in ksize):
        if ptype == "max":
            return torch.amax(x, dim=(2, 3), keepdim=True)
        return torch.mean(x, dim=(2, 3), keepdim=True)
    if attrs.get("adaptive", False):
        n, c, h, w = x.shape
        oh, ow = ksize
        assert h % oh == 0 and w % ow == 0, "adaptive pool needs divisible dims"
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        return torch.amax(xr, dim=(3, 5)) if ptype == "max" \
            else torch.mean(xr, dim=(3, 5))

    if len(pads) == 2:
        pairs = [(pads[0], pads[0]), (pads[1], pads[1])]
    else:
        pairs = [(pads[0], pads[1]), (pads[2], pads[3])]
    padded = any(p != (0, 0) for p in pairs)
    area = ksize[0] * ksize[1]
    if ptype == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        if padded:
            x = F.pad(x, [pairs[1][0], pairs[1][1], pairs[0][0], pairs[0][1]],
                      value=fill)
        return F.max_pool2d(x, ksize, strides)

    def window_sum(t):
        if padded:
            t = F.pad(t, [pairs[1][0], pairs[1][1], pairs[0][0], pairs[0][1]])
        return F.avg_pool2d(t, ksize, strides) * area

    s = window_sum(x)
    if attrs.get("exclusive", True) and padded:
        return s / window_sum(torch.ones_like(x))
    return s / area


@register_op("pool2d")
def pool2d(ins, attrs, ctx):
    return {"Out": _pool2d(ins["X"][0], attrs)}


@register_op("dropout", is_random=True, intermediate_outputs=("Mask",))
def dropout(ins, attrs, ctx):
    """reference: operators/dropout_op.cc (upscale_in_train vs
    downgrade_in_infer implementations). The mask comes from
    `ctx.rng()`, so `dropout_grad`'s replay draws the same one."""
    return _dropout(ins["X"][0], attrs, ctx)


def dropout_rows(n: int, lo: int):
    """dropout's kernel for an input that is rows `lo`.. of an `n`-row
    batch: the draw is the whole batch's and the mask its rows of it,
    so the ranks of a data-parallel step (`core/lockstep.py`) drop what
    one step over the whole batch drops."""
    return lambda ins, attrs, ctx: _dropout(ins["X"][0], attrs, ctx, (n, lo))


def _dropout(x, attrs, ctx, rows=None):
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    is_test = bool(attrs.get("is_test", False)) or ctx.is_test
    if is_test or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x, dtype=torch.uint8)}
    shape = x.shape if rows is None else (rows[0],) + tuple(x.shape[1:])
    draw = torch.rand(shape, generator=ctx.rng(), device=x.device)
    if rows is not None:
        draw = draw[rows[1]:rows[1] + x.shape[0]]
    keep = draw < (1.0 - p)
    zero = torch.zeros_like(x)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), zero)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": out, "Mask": keep.to(torch.uint8)}


@register_op("softmax")
def softmax(ins, attrs, ctx):
    return {"Out": torch.softmax(ins["X"][0], dim=int(attrs.get("axis", -1)))}


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",),
             intermediate_outputs=("Softmax",))
def softmax_with_cross_entropy(ins, attrs, ctx):
    """reference: operators/softmax_with_cross_entropy_op.cc — numerically
    stable fused version (the BERT/Transformer loss)."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = int(attrs.get("axis", -1))
    lse = torch.logsumexp(logits, dim=axis, keepdim=True)
    log_probs = logits - lse
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_probs, dim=axis, keepdim=True)
    else:
        idx = label.to(torch.int64)
        if idx.ndim == logits.ndim and idx.shape[axis] == 1:
            idx = idx.squeeze(axis)
        idx = idx.unsqueeze(axis)
        loss = -torch.take_along_dim(log_probs, idx, dim=axis)
        ignore_index = int(attrs.get("ignore_index", -100))
        if ignore_index >= 0:
            loss = torch.where(idx == ignore_index, torch.zeros_like(loss), loss)
    return {"Loss": loss, "Softmax": torch.exp(log_probs)}


@register_op("square_error_cost", nondiff_inputs=())
def square_error_cost(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.square(x - y)}
