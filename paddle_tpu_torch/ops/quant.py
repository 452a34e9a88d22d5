"""The quantization ops of the fluid path: all thirteen of the JAX
package's `ops/quant.py` (reference: fake_quantize_op.cc,
fake_dequantize_op.cc and the int8 runtime of a calibrated model).

The ten `fake_*` ops of quantization-aware training (`slim/qat.py`
inserts them) simulate the int8 grid in the activation's float dtype.
The quantize-dequantize ones pass the gradient straight through: their
Out is `x + (q - x).detach()`, the JAX package's `x + stop_gradient(q -
x)` term for term, so the forward rounds the same bits and the generic
gradient is the identity. Every constant of the grid (the bound
`2**(bits-1) - 1`, the 1e-9 floor of a scale) is an f32 tensor on the
activation's device, so each division is a true f32 division, as XLA
does it with a weakly typed Python float (a division by a Python scalar
may run as a product by its reciprocal in torch). The moving-average
ops carry their state (scale, state, accum) in vars that are both input
and output, so the executor writes it back once a step; a `_grad` op
that replays the forward writes nothing.

The three int8 runtime ops (`slim.quantization.calibrate_and_quantize`
rewrites mul, matmul and conv2d into them) quantize their activation
per tensor with the calibrated `x_scale` attr, multiply int8 by int8
into int32 (`ops/int8.py`), and dequantize by x_scale * the weight's
per-output-channel scale, in the JAX package's order, returning the
activation's dtype. `x_scale` is made an f32 tensor on the activation's
device once, for the same reason.
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .int8 import conv2d_int8, conv_operands, int8_matmul, matrix_operand

# the input slot that holds each op's int8 weight
WEIGHT_SLOTS = {"quantized_mul": "Y", "quantized_matmul": "Y",
                "quantized_conv2d": "Filter"}


def _groups(attrs) -> int:
    return int(attrs.get("groups", 1) or 1)


def lay_out_weight(op_type: str, attrs, w: torch.Tensor):
    """Lay out `w`, the int8 weight of a `op_type` op, as its product's
    operand, kept on `w` (`ops/int8.py`). The Predictor calls this once
    for each such weight when it loads its state, so no request lays
    out a weight."""
    if op_type == "quantized_conv2d":
        conv_operands(w.permute(2, 3, 1, 0), _groups(attrs), owner=w)
    else:
        matrix_operand(w)


def _scale(x: torch.Tensor, x_scale) -> torch.Tensor:
    return torch.tensor(float(x_scale), dtype=torch.float32, device=x.device)


def _quantize_activation(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantization of the activation by the
    f32 scale tensor `xs`."""
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127)
    return xq.to(torch.int8)


@register_op("quantized_mul", grad=None, nondiff_inputs=("Y", "Scale"))
def quantized_mul(ins, attrs, ctx):
    """mul with an int8 weight [K, N] and an int8-quantized activation:
    int32 accumulation, dequantized by x_scale * w_scale (per output
    column)."""
    x, wq = ins["X"][0], ins["Y"][0]
    w_scale = ins["Scale"][0]                  # [1, N]
    xs = _scale(x, attrs["x_scale"])
    xnc = int(attrs.get("x_num_col_dims", 1))
    xm = x.reshape(math.prod(x.shape[:xnc]), -1)
    acc = int8_matmul(_quantize_activation(xm, xs), wq)
    out = acc.float() * (xs * w_scale.reshape(1, -1))
    return {"Out": out.reshape(tuple(x.shape[:xnc]) + tuple(wq.shape[1:]))
            .to(x.dtype)}


@register_op("quantized_matmul", grad=None, nondiff_inputs=("Y", "Scale"))
def quantized_matmul(ins, attrs, ctx):
    """X @ W over X's last axis (no transposes: the rewriter only
    targets plain X @ W)."""
    x, wq = ins["X"][0], ins["Y"][0]
    w_scale = ins["Scale"][0]
    xs = _scale(x, attrs["x_scale"])
    xq = _quantize_activation(x, xs)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.reshape(tuple(x.shape[:-1]) + (wq.shape[1],))
    out = acc.float() * (xs * w_scale.reshape(1, -1))
    return {"Out": out.to(x.dtype)}


@register_op("quantized_conv2d", grad=None, nondiff_inputs=("Filter", "Scale"))
def quantized_conv2d(ins, attrs, ctx):
    """conv2d (NCHW, the reference's layout) with an int8 filter
    [O, I, H, W] and an int8-quantized activation; int32 accumulation,
    per-output-channel dequantization, then the optional Bias."""
    x, wq = ins["Input"][0], ins["Filter"][0]
    w_scale = ins["Scale"][0]                  # [O, 1, 1, 1]
    xs = _scale(x, attrs["x_scale"])
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1]))
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    if len(pads) == 2:
        pads = [pads[0], pads[0], pads[1], pads[1]]
    dil = tuple(int(d) for d in attrs.get("dilations", [1, 1]))
    xq = _quantize_activation(x, xs).permute(0, 2, 3, 1)      # NHWC
    acc = conv2d_int8(xq, wq.permute(2, 3, 1, 0), strides,
                      ((pads[0], pads[1]), (pads[2], pads[3])), dil,
                      _groups(attrs), owner=wq)
    scale = (xs * w_scale.reshape(-1)).reshape(1, -1, 1, 1)
    out = acc.permute(0, 3, 1, 2).float() * scale
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Output": out.to(x.dtype)}


# -- the fake-quant ops of quantization-aware training (the JAX
# package's ops/quant.py:24-266)


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(float(v), dtype=x.dtype, device=x.device)


def _ste(x, quantized):
    """Straight-through estimator: forward = quantized, grad = identity."""
    return x + (quantized - x).detach()


def _bound(x, bits):
    return _const(x, 2 ** (int(bits) - 1) - 1)


def _quant_only(x, scale, bits):
    bnt = _bound(x, bits)
    s = torch.maximum(scale, _const(scale, 1e-9))
    return torch.clamp(torch.round(x / s * bnt), -bnt, bnt)


def _quant_dequant(x, scale, bits):
    s = torch.maximum(scale, _const(scale, 1e-9))
    return _quant_only(x, scale, bits) * s / _bound(x, bits)


def _channel_scale(x, axis):
    red = tuple(i for i in range(x.ndim) if i != axis)
    return torch.amax(torch.abs(x), dim=red, keepdim=True)


def _is_test(attrs, ctx) -> bool:
    return bool(attrs.get("is_test", False)) or ctx.is_test


def _scalar_in(ins, slot, default):
    """The optional one-element state input `slot` as a 0-d tensor, else
    `default()`."""
    if ins.get(slot) and ins[slot][0] is not None:
        return ins[slot][0].reshape(())
    return default()


def _moving_average(x, attrs, ctx, in_scale, state, accum):
    """(scale, state, accum) after this step: in training accum = accum *
    rate + absmax and state = state * rate + 1, scale = accum / state; in
    a test program the stored values."""
    if _is_test(attrs, ctx):
        return in_scale, state, accum
    rate = float(attrs.get("moving_rate", 0.9))
    new_state = rate * state + 1.0
    new_accum = rate * accum + torch.amax(torch.abs(x))
    return new_accum / new_state, new_state, new_accum


def _ma_inputs(ins, x):
    in_scale = ins["InScale"][0].reshape(())
    state = _scalar_in(ins, "InState", lambda: _const(x, 1.0))
    accum = _scalar_in(ins, "InAccum", lambda: in_scale)
    return in_scale, state, accum


@register_op("fake_quantize_dequantize_abs_max",
             intermediate_outputs=("OutScale",))
def fake_quantize_dequantize_abs_max(ins, attrs, ctx):
    """Per-tensor abs-max quant-dequant (weights)."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = torch.amax(torch.abs(x))
    return {"Out": _ste(x, _quant_dequant(x, scale, bits)),
            "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_dequantize_abs_max",
             intermediate_outputs=("OutScale",))
def fake_channel_wise_quantize_dequantize_abs_max(ins, attrs, ctx):
    """Per-output-channel abs-max quant-dequant (conv weights along axis
    0, fc weights [In, Out] along the `quant_axis` the pass gives)."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale = _channel_scale(x, int(attrs.get("quant_axis", 0)))
    return {"Out": _ste(x, _quant_dequant(x, scale, bits)),
            "OutScale": scale.reshape(-1)}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             nondiff_inputs=("InScale", "InState", "InAccum"),
             intermediate_outputs=("OutScale", "OutState", "OutAccum"))
def fake_quantize_dequantize_moving_average_abs_max(ins, attrs, ctx):
    """Activation quant-dequant by a moving-average abs-max scale."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale, state, accum = _moving_average(x, attrs, ctx, *_ma_inputs(ins, x))
    return {"Out": _ste(x, _quant_dequant(x, scale, bits)),
            "OutScale": scale.reshape(1), "OutState": state.reshape(1),
            "OutAccum": accum.reshape(1)}


@register_op("fake_quantize_abs_max", grad=None,
             intermediate_outputs=("OutScale",))
def fake_quantize_abs_max(ins, attrs, ctx):
    x = ins["X"][0]
    scale = torch.amax(torch.abs(x))
    return {"Out": _quant_only(x, scale, int(attrs.get("bit_length", 8))),
            "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_abs_max", grad=None,
             intermediate_outputs=("OutScale",))
def fake_channel_wise_quantize_abs_max(ins, attrs, ctx):
    x = ins["X"][0]
    scale = _channel_scale(x, int(attrs.get("quant_axis", 0)))
    return {"Out": _quant_only(x, scale, int(attrs.get("bit_length", 8))),
            "OutScale": scale.reshape(-1)}


@register_op("fake_quantize_range_abs_max", grad=None,
             nondiff_inputs=("InScale", "Iter", "InScales"),
             intermediate_outputs=("OutScale", "OutScales"))
def fake_quantize_range_abs_max(ins, attrs, ctx):
    """reference: fake_quantize_op.cc FindRangeAbsMaxFunctor: in training
    the abs-max of this step goes into slot Iter % window_size of the
    window buffer `InScales` (returned as OutScales), and the scale is
    the max over the slots filled so far, recomputed every step as the
    JAX package does (its documented deviation from the reference's lazy
    rescan), so it can shrink once an old maximum slides out. Without
    InScales the scale is max(InScale, abs-max); in a test program,
    InScale."""
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    in_scale = ins["InScale"][0].reshape(())
    window = (ins.get("InScales") or [None])[0]
    if _is_test(attrs, ctx):
        scale = in_scale
        out_scales = scale.reshape(1) if window is None else window
    elif window is None:
        scale = torch.maximum(in_scale, torch.amax(torch.abs(x)))
        out_scales = scale.reshape(1)
    else:
        wsize = window.shape[0]
        assert wsize == int(attrs.get("window_size", wsize)), (
            f"fake_quantize_range_abs_max: InScales buffer length {wsize} "
            f"!= window_size attr {attrs.get('window_size')}")
        it = ins["Iter"][0].reshape(()).to(torch.int64)
        slot = torch.arange(wsize, device=window.device)
        cur = torch.amax(torch.abs(x)).to(window.dtype)
        window = torch.where(slot == torch.remainder(it, wsize), cur, window)
        filled = slot < torch.clamp(it + 1, max=wsize)
        scale = torch.amax(torch.where(filled, window,
                                       torch.zeros((), dtype=window.dtype,
                                                   device=window.device))
                           ).to(x.dtype)
        out_scales = window
    return {"Out": _quant_only(x, scale, bits),
            "OutScale": scale.reshape(1), "OutScales": out_scales}


@register_op("fake_quantize_moving_average_abs_max", grad=None,
             nondiff_inputs=("InScale", "InState", "InAccum"),
             intermediate_outputs=("OutScale", "OutState", "OutAccum"))
def fake_quantize_moving_average_abs_max(ins, attrs, ctx):
    x = ins["X"][0]
    bits = int(attrs.get("bit_length", 8))
    scale, state, accum = _moving_average(x, attrs, ctx, *_ma_inputs(ins, x))
    return {"Out": _quant_only(x, scale, bits),
            "OutScale": scale.reshape(1), "OutState": state.reshape(1),
            "OutAccum": accum.reshape(1)}


@register_op("fake_dequantize_max_abs", grad=None,
             nondiff_inputs=("Scale",))
def fake_dequantize_max_abs(ins, attrs, ctx):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(())
    return {"Out": x * scale / _const(x, attrs.get("max_range", 127.0))}


@register_op("fake_channel_wise_dequantize_max_abs", grad=None,
             nondiff_inputs=("Scales",))
def fake_channel_wise_dequantize_max_abs(ins, attrs, ctx):
    """reference: fake_dequantize_op.cc's channel-wise form: Scales holds
    the weight's channel scales and, optionally, the activation's scale;
    quant_bits gives their ranges."""
    x = ins["X"][0]
    scales = [s for s in ins["Scales"] if s is not None]
    bits = [int(b) for b in attrs.get("quant_bits", [8])]
    axis = int(attrs.get("quant_axis", 0))
    shape = [1] * x.ndim
    shape[axis] = -1
    out = x * scales[0].reshape(shape) / _bound(x, bits[0])
    if len(scales) > 1:
        out = out * scales[1].reshape(()) / _bound(x, bits[1])
    return {"Out": out}


@register_op("moving_average_abs_max_scale", grad=None,
             nondiff_inputs=("InState", "InAccum"),
             intermediate_outputs=("OutScale", "OutState", "OutAccum"))
def moving_average_abs_max_scale(ins, attrs, ctx):
    """Scale observer: Out = X, and the scale state moves as the
    moving-average quantizer's does (records activation ranges)."""
    x = ins["X"][0]
    state = _scalar_in(ins, "InState", lambda: _const(x, 1.0))
    accum = _scalar_in(ins, "InAccum", lambda: _const(x, 0.0))
    if _is_test(attrs, ctx):
        scale = accum / torch.maximum(state, _const(state, 1e-9))
    else:
        scale, state, accum = _moving_average(x, attrs, ctx, None, state,
                                              accum)
    return {"Out": x, "OutScale": scale.reshape(1),
            "OutState": state.reshape(1), "OutAccum": accum.reshape(1)}
