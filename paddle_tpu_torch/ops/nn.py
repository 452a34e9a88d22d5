"""NN ops of the fluid path: the JAX package's `ops/nn.py` (reference:
paddle/fluid/operators/{conv_op.cc,pool_op.cc,batch_norm_op.cc,
layer_norm_op.cc,dropout_op.cc,softmax_op.cc,cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc,...}).

NCHW as the reference takes it; convolutions and pooling run on
PyTorch's own (cuDNN on the card), since the JAX package runs XLA's
there and no Pallas kernel. Explicit, asymmetric and "SAME" paddings
are applied with `F.pad` where the library call takes only a symmetric
one. The norms compute their statistics explicitly, as the JAX ops do:
`batch_norm`'s one-pass biased variance, its running-stat update and
its `SavedVariance` (1 / sqrt(var + eps)) are none of `F.batch_norm`'s.
"""

from __future__ import annotations

import math

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


def _conv_nd(x, w, attrs, nd=2, groups=None):
    strides = tuple(int(s) for s in attrs.get("strides", [1] * nd))
    dilations = tuple(int(d) for d in attrs.get("dilations", [1] * nd))
    groups = int(attrs.get("groups", 1)) if groups is None else groups
    pairs = _conv_padding(attrs, nd, x.shape[2:], w.shape[2:], strides,
                          dilations)
    xp = _pad_spatial(x, pairs)
    if xp is None:
        padding = tuple(a for a, _ in pairs)
    else:
        x, padding = xp, (0,) * nd
    conv = F.conv2d if nd == 2 else F.conv3d
    return conv(x, w, stride=strides, padding=padding, dilation=dilations,
                groups=groups)


@register_op("conv2d", nondiff_inputs=())
def conv2d(ins, attrs, ctx):
    x, w = ins["Input"][0], ins["Filter"][0]
    out = _conv_nd(x, w, attrs)
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


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


@register_op("depthwise_conv2d")
def depthwise_conv2d(ins, attrs, ctx):
    """One group a channel, whatever the `groups` attr says (as the JAX
    op takes it)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": _conv_nd(x, w, attrs, groups=x.shape[1])}


@register_op("conv3d")
def conv3d(ins, attrs, ctx):
    return {"Output": _conv_nd(ins["Input"][0], ins["Filter"][0], attrs, 3)}


def _transpose_pairs(attrs):
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    if len(pads) == 2:
        return [(pads[0], pads[0]), (pads[1], pads[1])]
    return [(pads[0], pads[1]), (pads[2], pads[3])]   # [t, b, l, r]


def _conv_transpose(x, w, attrs, groups):
    """The gradient of a convolution padded by `paddings`: the whole
    transposed convolution, cropped by each side's padding, so its
    output is (in - 1) s - before - after + (k - 1) d + 1 as the JAX
    op's (conv_transpose_op.cc's shape). `groups` and `output_size` are
    the JAX op's: one group, no output size."""
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1]))
    dilations = tuple(int(d) for d in attrs.get("dilations", [1, 1]))
    out = F.conv_transpose2d(x, w, stride=strides, dilation=dilations,
                             groups=groups)
    (t, b), (l, r) = _transpose_pairs(attrs)
    return out[:, :, t:out.shape[2] - b, l:out.shape[3] - r]


@register_op("conv2d_transpose")
def conv2d_transpose(ins, attrs, ctx):
    # w: [C_in, C_out, kh, kw]
    return {"Output": _conv_transpose(ins["Input"][0], ins["Filter"][0],
                                      attrs, 1)}


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ins, attrs, ctx):
    """reference: conv_transpose_op.cc's depthwise registration: a
    transposed convolution a channel (w: [C, 1, kh, kw])."""
    x = ins["Input"][0]
    return {"Output": _conv_transpose(x, ins["Filter"][0], attrs,
                                      x.shape[1])}


def _deformable_conv(ins, attrs, modulated):
    """reference: deformable_conv_op.h (v2, modulated) /
    deformable_conv_v1_op.h: y(p) = sum_k w_k x(p + p_k + dp_k) dm_k.
    The K sampled taps are gathered bilinearly into a column tensor (a
    corner outside the image adds 0), then one grouped einsum, as the
    JAX op does."""
    x = ins["Input"][0]                       # [N, C, H, W]
    off = ins["Offset"][0]                    # [N, dg*K*2, OH, OW]
    w = ins["Filter"][0]                      # [Cout, C/groups, kh, kw]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    dils = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1))
    dg = int(attrs.get("deformable_groups", 1))
    n, c, h_in, w_in = x.shape
    cout, cg, kh, kw = w.shape
    K = kh * kw
    oh, ow = off.shape[2], off.shape[3]
    cpg = c // dg
    dev, dt = x.device, x.dtype

    # the sampling grid: h = oh * stride - pad + ki * dilation (+ offset)
    k = torch.arange(K, device=dev)
    ki = torch.div(k, kw, rounding_mode="floor").to(dt)
    kj = (k % kw).to(dt)
    base_y = torch.arange(oh, dtype=dt, device=dev) * strides[0] - pads[0]
    base_x = torch.arange(ow, dtype=dt, device=dev) * strides[1] - pads[1]
    grid_y = base_y[None, :, None] + ki[:, None, None] * dils[0]  # [K,OH,1]
    grid_x = base_x[None, None, :] + kj[:, None, None] * dils[1]  # [K,1,OW]
    off = off.reshape(n, dg, K, 2, oh, ow)
    ys = grid_y + off[:, :, :, 0]                 # [N, dg, K, OH, OW]
    xs = grid_x + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0).to(dt), (xs - x0).to(dt)
    flat_x = x.reshape(n, dg, cpg, h_in * w_in)
    L = K * oh * ow

    def corner(yy, xx):
        inb = ((yy >= 0) & (yy <= h_in - 1) & (xx >= 0) &
               (xx <= w_in - 1)).to(dt)
        yc = torch.clamp(yy, 0, h_in - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w_in - 1).to(torch.int64)
        idx = (yc * w_in + xc).reshape(n, dg, 1, L).expand(n, dg, cpg, L)
        return torch.gather(flat_x, 3, idx) * inb.reshape(n, dg, 1, L)

    def wt(t):
        return t.reshape(n, dg, 1, L)

    cols = (corner(y0, x0) * wt((1 - wy) * (1 - wx))
            + corner(y0, x0 + 1) * wt((1 - wy) * wx)
            + corner(y0 + 1, x0) * wt(wy * (1 - wx))
            + corner(y0 + 1, x0 + 1) * wt(wy * wx))
    if modulated:
        cols = cols * ins["Mask"][0].reshape(n, dg, 1, L).to(cols.dtype)
    cols_g = cols.reshape(n, groups, cg, K, oh, ow)
    w_g = w.reshape(groups, cout // groups, cg, K).to(cols.dtype)
    out = torch.einsum("ngckhw,gock->ngohw", cols_g, w_g)
    return {"Output": out.reshape(n, cout, oh, ow)}


@register_op("deformable_conv")
def deformable_conv(ins, attrs, ctx):
    return _deformable_conv(ins, attrs, modulated=True)


@register_op("deformable_conv_v1")
def deformable_conv_v1(ins, attrs, ctx):
    return _deformable_conv(ins, attrs, modulated=False)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


@register_op("pool3d")
def pool3d(ins, attrs, ctx):
    """Max (padding never wins) or average over the whole window, the
    padding counted (as the JAX op divides by prod(ksize))."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return {"Out": torch.amax(x, dim=(2, 3, 4), keepdim=True)}
        return {"Out": torch.mean(x, dim=(2, 3, 4), keepdim=True)}
    ksize = [int(k) for k in attrs.get("ksize", [2, 2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    pads = [int(p) for p in attrs.get("paddings", [0, 0, 0])]
    if ptype == "max":
        xp = F.pad(x, _both_sides(pads), value=float("-inf")) \
            if any(pads) else x
        return {"Out": F.max_pool3d(xp, ksize, strides)}
    xp = F.pad(x, _both_sides(pads)) if any(pads) else x
    return {"Out": F.avg_pool3d(xp, ksize, strides)}


def _both_sides(pads):
    """F.pad's list (last dim first) for `pads[d]` on both sides of
    each spatial dim d."""
    return [p for q in reversed(pads) for p in (q, q)]


def _max_pool_with_index(x, attrs, nd):
    """max_pool{2,3}d_with_index (reference: pool_with_index_op.cc): Mask
    is the row-major flat index of the window's maximum within its
    channel's input volume, the first maximum in scan order winning; the
    padding (the dtype's least value) never wins."""
    spatial = x.shape[2:]
    ksize = [int(k) for k in attrs.get("ksize", [2] * nd)]
    if attrs.get("global_pooling", False):
        ksize = list(spatial)
    strides = [int(s) for s in attrs.get("strides", ksize)]
    pads = [int(p) for p in attrs.get("paddings", [0] * nd)]
    if attrs.get("global_pooling", False):
        pads = [0] * nd
    if attrs.get("adaptive", False):
        out_sz = ksize
        assert all(s % o == 0 for s, o in zip(spatial, out_sz)), \
            "adaptive pool needs divisible dims"
        ksize = [s // o for s, o in zip(spatial, out_sz)]
        strides = ksize
        pads = [0] * nd
    neg = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    patches = F.pad(x, _both_sides(pads), value=neg)
    for d in range(nd):   # [N, C, *out, *k]
        patches = patches.unfold(2 + d, ksize[d], strides[d])
    out_sp = patches.shape[2:2 + nd]
    patches = patches.reshape(tuple(patches.shape[:2 + nd]) + (-1,))
    k_local = torch.argmax(patches, dim=-1)               # [N, C, *out]
    out = torch.take_along_dim(patches, k_local[..., None], dim=-1)[..., 0]
    idx = torch.zeros_like(k_local)
    rem = k_local
    for d in range(nd):
        tail = math.prod(ksize[d + 1:])
        kd = torch.div(rem, tail, rounding_mode="floor")
        rem = rem % tail
        coord = torch.arange(out_sp[d], device=x.device) * strides[d] - pads[d]
        shape = [1] * (2 + nd)
        shape[2 + d] = out_sp[d]
        idx = idx * spatial[d] + coord.reshape(shape) + kd
    return out, idx.to(torch.int32)


@register_op("max_pool2d_with_index", intermediate_outputs=())
def max_pool2d_with_index(ins, attrs, ctx):
    out, mask = _max_pool_with_index(ins["X"][0], attrs, 2)
    return {"Out": out, "Mask": mask}


@register_op("max_pool3d_with_index")
def max_pool3d_with_index(ins, attrs, ctx):
    out, mask = _max_pool_with_index(ins["X"][0], attrs, 3)
    return {"Out": out, "Mask": mask}


@register_op("unpool", nondiff_inputs=("Indices",))
def unpool(ins, attrs, ctx):
    """reference: unpool_op.cc ('max' unpooling): X scattered into a zero
    output at the positions max_pool2d_with_index recorded; out_size =
    (in - 1) stride - 2 pad + ksize."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, h, w = x.shape
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    oh = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    out = torch.zeros((n * c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter(1, idx.reshape(n * c, h * w).to(torch.int64),
                      x.reshape(n * c, h * w))
    return {"Out": out.reshape(n, c, oh, ow)}


@register_op("spp")
def spp(ins, attrs, ctx):
    """reference: spp_op.h: spatial pyramid pooling, level p pooled into
    2^p x 2^p bins (kernel ceil(dim / bins), pad (k bins - dim + 1) / 2),
    flattened and joined along channels."""
    x = ins["X"][0]
    n, c, h, w = x.shape
    ptype = attrs.get("pooling_type", "max")
    outs = []
    for p in range(int(attrs.get("pyramid_height", 1))):
        bins = 2 ** p
        kh, kw = -(-h // bins), -(-w // bins)
        lvl = _pool2d(x, {"pooling_type": ptype, "ksize": [kh, kw],
                          "strides": [kh, kw],
                          "paddings": [(kh * bins - h + 1) // 2,
                                       (kw * bins - w + 1) // 2],
                          "exclusive": True})
        outs.append(lvl.reshape(n, c * bins * bins))
    return {"Out": torch.cat(outs, dim=1)}


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def channel_layout(attrs, x):
    """(the dims batch_norm reduces over, the shape a per-channel vector
    broadcasts to): channels on dim 1 under NCHW (a 2-D input's too),
    last under NHWC."""
    ch = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    return tuple(i for i in range(x.ndim) if i != ch), shape


def batch_norm_kernel(ins, attrs, ctx, stats=None):
    """batch_norm's forward; `stats`, when given, maps (x in f32, the
    reduced dims) to the batch's (mean, mean of squares) in place of
    this input's own (the data-parallel rule's global ones,
    `core/lockstep.py`)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = bool(attrs.get("is_test", False)) or ctx.is_test
    axes, ch = channel_layout(attrs, x)
    if bool(attrs.get("use_global_stats", False)) or is_test:
        y = (x - mean.reshape(ch)) * (scale.reshape(ch) * torch.rsqrt(
            var.reshape(ch) + eps)) + bias.reshape(ch)
        return {"Y": y, "MeanOut": mean, "VarianceOut": var,
                "SavedMean": mean, "SavedVariance": var}
    xf = x.to(torch.float32)
    if stats is None:
        m, sq = torch.mean(xf, dim=axes), torch.mean(torch.square(xf),
                                                     dim=axes)
    else:
        m, sq = stats(xf, axes)
    v = sq - torch.square(m)
    y = (xf - m.reshape(ch)) * torch.rsqrt(v.reshape(ch) + eps)
    y = y.to(x.dtype) * scale.reshape(ch) + bias.reshape(ch)
    return {"Y": y, "MeanOut": mean * momentum + m * (1.0 - momentum),
            "VarianceOut": var * momentum + v * (1.0 - momentum),
            "SavedMean": m, "SavedVariance": torch.rsqrt(v + eps)}


_BN_OUTS = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


@register_op("batch_norm", nondiff_inputs=("Mean", "Variance"),
             intermediate_outputs=_BN_OUTS)
def batch_norm(ins, attrs, ctx):
    """reference: operators/batch_norm_op.cc. The batch variance is
    one-pass and biased in f32, the running stats move by `momentum`
    from it, and SavedVariance is 1 / sqrt(var + eps); under `is_test`
    or `use_global_stats` the running stats normalize and pass through
    (SavedVariance then the running variance itself), as in the JAX op."""
    return batch_norm_kernel(ins, attrs, ctx)


@register_op("sync_batch_norm", nondiff_inputs=("Mean", "Variance"),
             intermediate_outputs=_BN_OUTS)
def sync_batch_norm(ins, attrs, ctx):
    """batch_norm's kernel: on one device the batch is the whole batch;
    a data-parallel run takes its statistics over the ranks
    (`core/lockstep.py`), as the JAX package's GSPMD step does."""
    return batch_norm_kernel(ins, attrs, ctx)


def _moments(x, axes):
    """`jnp.mean` and `jnp.var` (two-pass, biased) over `axes`, kept."""
    m = torch.mean(x, dim=axes, keepdim=True)
    return m, torch.mean(torch.square(x - m), dim=axes, keepdim=True)


def _affine(y, ins, ch):
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0].reshape(ch)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0].reshape(ch)
    return y


@register_op("layer_norm", intermediate_outputs=("Mean", "Variance"))
def layer_norm(ins, attrs, ctx):
    """reference: operators/layer_norm_op.cc (begin_norm_axis flattening);
    statistics in f32, two-pass."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = int(attrs.get("begin_norm_axis", 1))
    axes = tuple(range(bna, x.ndim))
    xf = x.to(torch.float32)
    m = torch.mean(xf, dim=axes, keepdim=True)
    v = torch.mean(torch.square(xf - m), dim=axes, keepdim=True)
    y = _affine(((xf - m) * torch.rsqrt(v + eps)).to(x.dtype), ins,
                x.shape[bna:])
    return {"Y": y, "Mean": m.reshape(x.shape[:bna]),
            "Variance": v.reshape(x.shape[:bna])}


@register_op("group_norm", intermediate_outputs=("Mean", "Variance"))
def group_norm(ins, attrs, ctx):
    x = ins["X"][0]  # NCHW
    groups = int(attrs["groups"])
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    m, v = _moments(xg, tuple(range(2, xg.ndim)))
    y = ((xg - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))).reshape(
        x.shape)
    y = _affine(y, ins, [1, c] + [1] * (x.ndim - 2))
    return {"Y": y, "Mean": m.reshape(n, groups),
            "Variance": v.reshape(n, groups)}


@register_op("instance_norm", intermediate_outputs=("SavedMean",
                                                    "SavedVariance"))
def instance_norm(ins, attrs, ctx):
    x = ins["X"][0]
    m, v = _moments(x, tuple(range(2, x.ndim)))
    y = (x - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))
    y = _affine(y, ins, [1, x.shape[1]] + [1] * (x.ndim - 2))
    # every size-1 dim squeezed, as jnp.squeeze does
    return {"Y": y, "SavedMean": torch.squeeze(m),
            "SavedVariance": torch.squeeze(v)}


@register_op("l2_normalize")
def l2_normalize(ins, attrs, ctx):
    x = ins["X"][0]
    return {"Out": x * torch.rsqrt(torch.sum(
        torch.square(x), dim=int(attrs.get("axis", -1)), keepdim=True)
        + attrs.get("epsilon", 1e-10))}


@register_op("log_softmax")
def log_softmax(ins, attrs, ctx):
    return {"Out": torch.log_softmax(ins["X"][0],
                                     dim=int(attrs.get("axis", -1)))}


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@register_op("cross_entropy", nondiff_inputs=("Label",))
def cross_entropy(ins, attrs, ctx):
    """reference: operators/cross_entropy_op.cc: X holds probabilities,
    -log(max(p, 1e-20)) of the label's (hard) or summed against the
    label distribution (soft); a hard label at `ignore_index` (other
    than -100) gives 0."""
    x, label = ins["X"][0], ins["Label"][0]
    if attrs.get("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(torch.clamp(x, min=1e-20)),
                                dim=-1, keepdim=True)}
    idx = label.to(torch.int64)
    if idx.ndim == x.ndim and idx.shape[-1] == 1:
        idx = idx[..., 0]
    picked = torch.take_along_dim(x, idx[..., None], dim=-1)
    loss = -torch.log(torch.clamp(picked, min=1e-20))
    ignore_index = int(attrs.get("ignore_index", -100))
    if ignore_index != -100:
        loss = torch.where(idx[..., None] == ignore_index,
                           torch.zeros_like(loss), loss)
    return {"Y": loss}


@register_op("sigmoid_cross_entropy_with_logits", nondiff_inputs=("Label",))
def sigmoid_cross_entropy_with_logits(ins, attrs, ctx):
    x, label = ins["X"][0], ins["Label"][0]
    loss = torch.clamp(x, min=0.0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    ignore_index = int(attrs.get("ignore_index", -100))
    if ignore_index != -100:
        loss = torch.where(label == ignore_index, torch.zeros_like(loss),
                           loss)
    if attrs.get("normalize", False):
        n = torch.clamp(torch.sum(label != ignore_index).to(loss.dtype),
                        min=1.0)
        loss = loss / n
    return {"Out": loss}


@register_op("smooth_l1_loss", nondiff_inputs=("InsideWeight",
                                               "OutsideWeight"),
             intermediate_outputs=("Diff",))
def smooth_l1_loss(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    sigma2 = attrs.get("sigma", 1.0) ** 2
    diff = x - y
    if ins.get("InsideWeight") and ins["InsideWeight"][0] is not None:
        diff = diff * ins["InsideWeight"][0]
    abs_diff = torch.abs(diff)
    loss = torch.where(abs_diff < 1.0 / sigma2,
                       0.5 * sigma2 * torch.square(diff),
                       abs_diff - 0.5 / sigma2)
    if ins.get("OutsideWeight") and ins["OutsideWeight"][0] is not None:
        loss = loss * ins["OutsideWeight"][0]
    return {"Out": torch.sum(loss, dim=tuple(range(1, loss.ndim)))[..., None],
            "Diff": diff}


@register_op("huber_loss", intermediate_outputs=("Residual",))
def huber_loss(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    return {"Out": torch.where(ar <= delta, 0.5 * torch.square(r),
                               delta * (ar - 0.5 * delta)),
            "Residual": r}


@register_op("kldiv_loss", nondiff_inputs=("Target",))
def kldiv_loss(ins, attrs, ctx):
    x, t = ins["X"][0], ins["Target"][0]
    loss = t * (torch.log(torch.clamp(t, min=1e-20)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        return {"Loss": torch.mean(loss)}
    if red == "sum":
        return {"Loss": torch.sum(loss)}
    if red == "batchmean":
        return {"Loss": torch.sum(loss) / x.shape[0]}
    return {"Loss": loss}


@register_op("bce_loss", nondiff_inputs=("Label",))
def bce_loss(ins, attrs, ctx):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": -(label * torch.log(torch.clamp(x, min=1e-12))
                     + (1 - label) * torch.log(torch.clamp(1 - x,
                                                           min=1e-12)))}


@register_op("margin_rank_loss", nondiff_inputs=("Label",),
             intermediate_outputs=("Activated",))
def margin_rank_loss(ins, attrs, ctx):
    x1, x2, label = ins["X1"][0], ins["X2"][0], ins["Label"][0]
    out = torch.clamp(-label * (x1 - x2) + attrs.get("margin", 0.0), min=0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("hinge_loss", nondiff_inputs=("Labels",))
def hinge_loss(ins, attrs, ctx):
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": torch.clamp(1.0 - (2.0 * labels - 1.0) * logits,
                                min=0.0)}


# ---------------------------------------------------------------------------
# Interpolation / resampling
# ---------------------------------------------------------------------------


def _linear_resize_weights(s, o, align_corners, align_mode, dtype, device):
    """[o, s] interpolation weights of one axis (two taps a row), source
    positions as interpolate_op.h places them: align_corners i (s - 1) /
    (o - 1); align_mode 0 (i + 0.5) s / o - 0.5; align_mode 1 i s / o."""
    i = torch.arange(o, dtype=dtype, device=device)
    if o == 1 or s == 1:
        pos = torch.zeros((o,), dtype=dtype, device=device)
    elif align_corners:
        pos = i * (s - 1) / (o - 1)
    elif int(align_mode) == 0:
        pos = (i + 0.5) * s / o - 0.5
    else:
        pos = i * s / o
    pos = torch.clamp(pos, 0.0, s - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=s - 1)
    frac = (pos - lo).to(dtype)
    rows = torch.arange(o, device=device)
    wm = torch.zeros((o, s), dtype=dtype, device=device)
    wm = wm.index_put((rows, lo), 1.0 - frac, accumulate=True)
    return wm.index_put((rows, hi), frac, accumulate=True)


def _interp(ins, attrs, method):
    """reference: interpolate_op.h: a separable linear resize honouring
    align_corners and align_mode (one [O, S] weight product an axis);
    nearest takes jax.image.resize's source index floor((i + 0.5) S /
    O) in f32."""
    x = ins["X"][0]  # NC + spatial
    spatial = tuple(x.shape[2:])
    nd = len(spatial)
    keys = ("out_d", "out_h", "out_w")[-nd:]
    given = [k for k in keys if attrs.get(k, -1) > 0]
    if given:
        assert len(given) == nd, (
            f"interp on {nd}-D spatial input needs all of {keys}, "
            f"got only {given}")
        out_sp = tuple(int(attrs[k]) for k in keys)
    else:
        scale = attrs.get("scale", 1.0)
        out_sp = tuple(int(s * scale) for s in spatial)
    if method == "nearest":
        out = x
        for d, (m, n) in enumerate(zip(spatial, out_sp)):
            if m == n:
                continue
            off = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * m / n
            out = torch.index_select(out, 2 + d,
                                     torch.floor(off).to(torch.int64))
        return {"Out": out}
    ac = bool(attrs.get("align_corners", True))
    am = int(attrs.get("align_mode", 1))
    wdt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    out = x.to(wdt)
    for d in range(nd):
        wm = _linear_resize_weights(spatial[d], out_sp[d], ac, am, wdt,
                                    x.device)
        out = torch.movedim(torch.tensordot(
            wm, torch.movedim(out, 2 + d, 0), dims=([1], [0])), 0, 2 + d)
    return {"Out": out.to(x.dtype)}


@register_op("bilinear_interp")
def bilinear_interp(ins, attrs, ctx):
    return _interp(ins, attrs, "bilinear")


@register_op("nearest_interp")
def nearest_interp(ins, attrs, ctx):
    return _interp(ins, attrs, "nearest")


@register_op("trilinear_interp")
def trilinear_interp(ins, attrs, ctx):
    """reference: interpolate_op.cc's trilinear branch (NCDHW)."""
    return _interp(ins, attrs, "trilinear")


@register_op("grid_sampler")
def grid_sampler(ins, attrs, ctx):
    """reference: operators/grid_sampler_op.cc: bilinear sampling at
    normalized [-1, 1] grid coordinates, corner indices clamped into
    the image (the JAX op's edge rule)."""
    x, grid = ins["X"][0], ins["Grid"][0]  # x: NCHW, grid: NHW2
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    nhwc = x.permute(0, 2, 3, 1)
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(yy, xx):
        return nhwc[bidx, torch.clamp(yy, 0, h - 1), torch.clamp(xx, 0, w - 1)]

    out = (sample(y0, x0) * (wy0 * wx0)[..., None]
           + sample(y0, x0 + 1) * (wy0 * wx1)[..., None]
           + sample(y0 + 1, x0) * (wy1 * wx0)[..., None]
           + sample(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])
    return {"Output": out.permute(0, 3, 1, 2).to(x.dtype)}


# ---------------------------------------------------------------------------
# Misc NN
# ---------------------------------------------------------------------------


@register_op("pixel_shuffle")
def pixel_shuffle(ins, attrs, ctx):
    x = ins["X"][0]
    r = int(attrs.get("upscale_factor", 1))
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": out.reshape(n, c // (r * r), h * r, w * r)}


@register_op("temporal_shift")
def temporal_shift(ins, attrs, ctx):
    x = ins["X"][0]
    seg = int(attrs["seg_num"])
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg, seg, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    fwd = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])], dim=1)
    back = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]), xr[:, :-1, c1:c2]],
                     dim=1)
    return {"Out": torch.cat([fwd, back, xr[:, :, c2:]], dim=2).reshape(
        nt, c, h, w)}


@register_op("label_smooth", nondiff_inputs=("PriorDist",))
def label_smooth(ins, attrs, ctx):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist") and ins["PriorDist"][0] is not None:
        return {"Out": (1 - eps) * x + eps * ins["PriorDist"][0]}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("embedding_with_scaled_gradient", nondiff_inputs=("Ids",))
def embedding_with_scaled_gradient(ins, attrs, ctx):
    from .tensor import lookup_table_v2

    return lookup_table_v2(ins, attrs, ctx)


@register_op("fc")
def fc_op(ins, attrs, ctx):
    """reference: fc_op.cc (the fused inference fc): Out =
    act(flatten(X) @ W + b) with in_num_col_dims."""
    x, w = ins["Input"][0], ins["W"][0]
    b = (ins.get("Bias") or [None])[0]
    lead = tuple(x.shape[:int(attrs.get("in_num_col_dims", 1))])
    out = x.reshape(math.prod(lead), -1) @ w.to(x.dtype)
    if b is not None:
        out = out + b.reshape(1, -1).to(out.dtype)
    act = attrs.get("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act:
        raise ValueError(f"fc: unsupported activation {act}")
    return {"Out": out.reshape(lead + (w.shape[1],))}
