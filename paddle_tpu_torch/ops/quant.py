"""The int8 runtime ops of the fluid path: the three of the JAX
package's `ops/quant.py` that a calibrated inference model runs
(`slim.quantization.calibrate_and_quantize` rewrites mul, matmul and
conv2d into them). The ten `fake_*` quantize-dequantize ops of
quantization-aware training are still to port (ROADMAP item 15).

Each quantizes its activation per tensor with the calibrated `x_scale`
attr, multiplies int8 by int8 into int32 (`ops/int8.py`), and
dequantizes by x_scale * the weight's per-output-channel scale, in the
JAX package's order, returning the activation's dtype. `x_scale` is
made an f32 tensor on the activation's device once, so every division
and product by it runs in f32 as XLA's does with the weakly typed
Python float (a division by a Python scalar may run as a product by
its reciprocal in torch).
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
