# Copied from the JAX package: paddle_tpu/layers/sequence.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Sequence layers over *padded* batches.

Reference: python/paddle/fluid/layers (sequence_pool/softmax/reverse/... over
LoD tensors, backed by operators/sequence_ops/). The TPU equivalents take
dense [N, T, ...] padded batches plus an optional per-row `length` tensor —
the LoD offset table becomes explicit lengths/masking (SURVEY.md §5
long-context note).
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand", "sequence_concat", "sequence_slice", "im2sequence",
    "sequence_first_step", "sequence_last_step", "sequence_pad",
    "sequence_unpad", "sequence_conv", "sequence_enumerate",
    "sequence_erase", "sequence_expand_as", "sequence_reshape",
    "sequence_scatter", "sequence_topk_avg_pooling",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        raise ValueError(
            "sequence_mask requires an explicit maxlen on TPU: XLA needs a "
            "static output shape, so the reference's data-dependent "
            "max(lengths) default cannot be traced. Pass maxlen=<padded T>.")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_mask", inputs={"X": x},
                     outputs={"Y": out},
                     attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type="sum", length=None, is_test=False, name=None):
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_pool", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_softmax", inputs=inputs,
                     outputs={"Out": out}, attrs={})
    return out


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Y": out}, attrs={})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"ref_level": ref_level})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": out}, attrs={})
    return out


def sequence_slice(input, offset, length, name=None):
    """`length` must be a static int (XLA shapes are static); `offset` may be
    an int or a traced Variable (lowered to lax.dynamic_slice)."""
    if not isinstance(length, int):
        raise ValueError(
            "sequence_slice requires a static int length on TPU (the output "
            "shape must be known at compile time); got a Variable")
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    attrs = {"length": int(length)}
    if isinstance(offset, int):
        attrs["offset"] = offset
    else:
        inputs["Offset"] = offset
    helper.append_op(type="sequence_slice", inputs=inputs,
                     outputs={"Out": out}, attrs=attrs)
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ks = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    helper.append_op(type="im2sequence", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"kernels": list(ks), "strides": list(st),
                            "paddings": list(pd)})
    return out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ln = helper.create_variable_for_type_inference("int64")
    inputs = {"X": x, "PadValue": pad_value}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_pad", inputs=inputs,
                     outputs={"Out": out, "Length": ln},
                     attrs={"padded_length": -1 if maxlen is None
                            else int(maxlen)})
    return out, ln


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ln = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="sequence_unpad",
                     inputs={"X": x, "Length": length},
                     outputs={"Out": out, "Length": ln})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, length=None, name=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr,
                                   shape=[filter_size * d, num_filters],
                                   dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "Filter": filt}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_conv", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"contextLength": filter_size,
                            "contextStart": padding_start
                            if padding_start is not None
                            else -(filter_size - 1) // 2,
                            "contextStride": filter_stride})
    pre_act = helper.append_bias_op(out, dim_start=2, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_enumerate", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_erase(input, tokens, length=None, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ln = helper.create_variable_for_type_inference("int64")
    inputs = {"X": input}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_erase", inputs=inputs,
                     outputs={"Out": out, "Length": ln},
                     attrs={"tokens": list(tokens)})
    return out, ln


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def sequence_reshape(input, new_dim, name=None):
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": input},
                     outputs={"Out": out}, attrs={"new_dim": new_dim})
    return out


def sequence_scatter(input, index, updates, length=None, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "Ids": index, "Updates": updates}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="sequence_scatter", inputs=inputs,
                     outputs={"Out": out})
    return out


def sequence_topk_avg_pooling(input, topks, channel_num=None, row=None,
                              col=None, name=None):
    helper = LayerHelper("sequence_topk_avg_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input}
    if row is not None:
        inputs["ROW"] = row
    if col is not None:
        inputs["COLUMN"] = col
    helper.append_op(type="sequence_topk_avg_pooling", inputs=inputs,
                     outputs={"Out": out}, attrs={"topks": list(topks)})
    return out
