# Copied from the JAX package: paddle_tpu/layers/extras.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Layer wrappers for the misc op batch (reference: scattered through
python/paddle/fluid/layers/nn.py — affine_channel, lrn, spectral_norm,
row_conv, shuffle_channel, space_to_depth, unfold, crop/crop_tensor,
sampling_id, add_position_encoding, rank_loss, log_loss, bpr_loss,
npair_loss, center_loss, teacher_student_sigmoid_loss, edit_distance,
ctc_greedy_decoder, warpctc, multiplex, conv3d_transpose, data_norm,
affine_grid, random_crop)."""

from __future__ import annotations

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "affine_channel", "affine_grid", "lrn", "data_norm", "spectral_norm",
    "row_conv", "shuffle_channel", "space_to_depth", "unfold", "crop",
    "crop_tensor", "random_crop", "sampling_id", "add_position_encoding",
    "rank_loss", "log_loss", "bpr_loss", "npair_loss", "center_loss",
    "teacher_student_sigmoid_loss", "edit_distance", "ctc_greedy_decoder",
    "warpctc", "multiplex", "conv3d_transpose", "modified_huber_loss",
    "py_func", "bilinear_tensor_product", "continuous_value_model",
    "filter_by_instag", "fsp_matrix", "hash", "pad_constant_like",
    "similarity_focus", "unique_with_counts",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "dice_loss", "soft_relu", "image_resize_short",
    "autoincreased_step_counter", "Print",
]


def _simple(op_type, inputs, attrs=None, outs=("Out",), dtype=None,
            name=None):
    helper = LayerHelper(op_type, name=name)
    first = next(v for v in inputs.values() if v is not None)
    if isinstance(first, (list, tuple)):
        first = first[0]
    dtype = dtype or first.dtype
    out_vars = {o: helper.create_variable_for_type_inference(
        dtype if not o.lower().endswith(("length", "num", "index"))
        else "int64") for o in outs}
    helper.append_op(type=op_type,
                     inputs={k: v for k, v in inputs.items()
                             if v is not None},
                     outputs=out_vars, attrs=attrs or {})
    vals = tuple(out_vars[o] for o in outs)
    return vals[0] if len(vals) == 1 else vals


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", name=name, act=act)
    out = _simple("affine_channel", {"X": x, "Scale": scale, "Bias": bias},
                  {"data_layout": data_layout})
    return helper.append_activation(out, act)


def affine_grid(theta, out_shape, name=None):
    if isinstance(out_shape, (list, tuple)):
        return _simple("affine_grid", {"Theta": theta},
                       {"output_shape": [int(v) for v in out_shape]},
                       outs=("Output",))
    return _simple("affine_grid", {"Theta": theta, "OutputShape": out_shape},
                   outs=("Output",))


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _simple("lrn", {"X": input},
                   {"n": n, "k": k, "alpha": alpha, "beta": beta})


def data_norm(input, param_attr=None, name=None, epsilon=1e-5):
    """reference: layers/nn.py data_norm — accumulator parameters are
    created here (batch_size/batch_sum/batch_square_sum)."""
    helper = LayerHelper("data_norm", param_attr=param_attr, name=name)
    d = int(input.shape[-1])
    bsize = helper.create_parameter(
        param_attr, shape=[d], dtype=input.dtype,
        default_initializer=ConstantInitializer(1e4))
    bsum = helper.create_parameter(
        param_attr, shape=[d], dtype=input.dtype,
        default_initializer=ConstantInitializer(0.0))
    bsqs = helper.create_parameter(
        param_attr, shape=[d], dtype=input.dtype,
        default_initializer=ConstantInitializer(1e4))
    out = helper.create_variable_for_type_inference(input.dtype)
    means = helper.create_variable_for_type_inference(input.dtype)
    scales = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="data_norm",
                     inputs={"X": input, "BatchSize": bsize,
                             "BatchSum": bsum, "BatchSquareSum": bsqs},
                     outputs={"Y": out, "Means": means, "Scales": scales},
                     attrs={"epsilon": epsilon})
    return out


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    import numpy as np

    w_total = 1
    for s in weight.shape:
        w_total *= int(s)
    u = helper.create_parameter(
        None, shape=[h], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    v = helper.create_parameter(
        None, shape=[w_total // h], dtype=weight.dtype,
        default_initializer=NormalInitializer(0.0, 1.0))
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op(type="spectral_norm",
                     inputs={"Weight": weight, "U": u, "V": v},
                     outputs={"Out": out},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act,
                         name=name)
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr,
                                   shape=[future_context_size + 1, d],
                                   dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": input, "Filter": filt},
                     outputs={"Out": out})
    return helper.append_activation(out, act)


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", {"X": x}, {"group": group})


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": x}, {"blocksize": blocksize})


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    def _pair(v, n=2):
        return [v] * n if isinstance(v, int) else list(v)

    pads = _pair(paddings, 4) if isinstance(paddings, int) else \
        (list(paddings) * 2 if len(paddings) == 2 else list(paddings))
    return _simple("unfold", {"X": x},
                   {"kernel_sizes": _pair(kernel_sizes),
                    "strides": _pair(strides), "paddings": pads,
                    "dilations": _pair(dilations)}, outs=("Y",))


def crop(x, shape=None, offsets=None, name=None):
    ref = None
    if shape is not None and not isinstance(shape, (list, tuple)):
        ref, shape = shape, None
    attrs = {}
    if shape is not None:
        attrs["shape"] = [int(v) for v in shape]
    if offsets is not None:
        attrs["offsets"] = [int(v) for v in offsets]
    return _simple("crop", {"X": x, "Y": ref}, attrs)


def crop_tensor(x, shape=None, offsets=None, name=None):
    inputs = {"X": x}
    attrs = {"shape": [int(v) for v in shape]}
    if offsets is not None and not isinstance(offsets, (list, tuple)):
        inputs["Offsets"] = offsets
    elif offsets is not None:
        attrs["offsets"] = [int(v) for v in offsets]
    return _simple("crop_tensor", inputs, attrs)


def random_crop(x, shape, seed=None):
    return _simple("random_crop", {"X": x}, {"shape": [int(v) for v in
                                                       shape]})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):
    return _simple("sampling_id", {"X": x}, dtype="int64")


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple("add_position_encoding", {"X": input},
                   {"alpha": alpha, "beta": beta})


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss", {"Label": label, "Left": left,
                                 "Right": right})


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss", {"Predicted": input, "Labels": label},
                   {"epsilon": epsilon}, outs=("Loss",))


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": input, "Label": label}, outs=("Y",))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _simple("npair_loss", {"Anchor": anchor, "Positive": positive,
                                  "Labels": labels}, {"l2_reg": l2_reg})


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    helper = LayerHelper("center_loss", param_attr=param_attr)
    d = int(input.shape[-1])
    centers = helper.create_parameter(
        param_attr, shape=[num_classes, d], dtype=input.dtype,
        default_initializer=ConstantInitializer(0.0))
    from .tensor import fill_constant

    rate = fill_constant(shape=[1], dtype=input.dtype, value=float(alpha))
    loss = helper.create_variable_for_type_inference(input.dtype)
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="center_loss",
                     inputs={"X": input, "Label": label,
                             "Centers": centers,
                             "CenterUpdateRate": rate},
                     # CentersOut writes back into the centers parameter —
                     # a fresh temp would discard the update every step
                     outputs={"Loss": loss, "SampleCenterDiff": diff,
                              "CentersOut": centers},
                     attrs={"update_center": update_center})
    return loss


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _simple("teacher_student_sigmoid_loss",
                   {"X": input, "Label": label}, outs=("Y",))


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference("float32")
    num = helper.create_variable_for_type_inference("int64")
    inputs = {"Hyps": input, "Refs": label}
    if input_length is not None:
        inputs["HypsLength"] = input_length
    if label_length is not None:
        inputs["RefsLength"] = label_length
    helper.append_op(type="edit_distance", inputs=inputs,
                     outputs={"Out": out, "SequenceNum": num},
                     attrs={"normalized": normalized,
                            "ignored_tokens": list(ignored_tokens or [])})
    return out, num


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """reference: layers/nn.py ctc_greedy_decoder — argmax per frame then
    ctc_align (merge repeats, drop blanks)."""
    from .tensor import argmax

    ids = argmax(input, axis=-1)
    helper = LayerHelper("ctc_align", name=name)
    out = helper.create_variable_for_type_inference("int64")
    ln = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": ids}
    if input_length is not None:
        inputs["InputLength"] = input_length
    helper.append_op(type="ctc_align", inputs=inputs,
                     outputs={"Output": out, "OutputLength": ln},
                     attrs={"blank": blank, "merge_repeated": True})
    return out, ln


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": input, "Label": label}
    if input_length is not None:
        inputs["LogitsLength"] = input_length
    if label_length is not None:
        inputs["LabelLength"] = label_length
    helper.append_op(type="warpctc", inputs=inputs,
                     outputs={"Loss": loss, "WarpCTCGrad": grad},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def multiplex(inputs, index):
    return _simple("multiplex", {"X": list(inputs), "Ids": index})


def modified_huber_loss(input, label):
    return _simple("modified_huber_loss", {"X": input, "Y": label})


def conv3d_transpose(input, num_filters, filter_size, padding=0, stride=1,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c_in = int(input.shape[1])

    def _triple(v):
        return [v] * 3 if isinstance(v, int) else list(v)

    ks = _triple(filter_size)
    w = helper.create_parameter(param_attr,
                                shape=[c_in, num_filters] + ks,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation)})
    pre_act = helper.append_bias_op(out, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """reference: layers/nn.py:14986 `py_func` → py_func op
    (py_func_op.cc). `out` vars must be pre-created with correct shapes
    and dtypes (create_variable + shape, as in the reference); `func`
    receives numpy arrays and returns numpy arrays. backward_func
    receives (forward inputs, forward outputs, output grads) minus
    skip_vars_in_backward_input, and returns per-input grads."""
    from ..ops.misc import register_py_func

    helper = LayerHelper("py_func")
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else ([out] if out is not None else [])
    fid = register_py_func(func)
    bid = register_py_func(backward_func) if backward_func is not None else -1
    skip = [v.name if hasattr(v, "name") else str(v)
            for v in (skip_vars_in_backward_input or [])]
    helper.append_op(
        type="py_func", inputs={"X": xs}, outputs={"Out": outs},
        attrs={"forward_callable_id": fid, "backward_callable_id": bid,
               "backward_skip_vars": skip,
               "out_shapes": [list(o.shape) for o in outs],
               "out_dtypes": [str(o.dtype) for o in outs]})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """reference: layers/nn.py `bilinear_tensor_product` →
    bilinear_tensor_product op (weight [size, Dx, Dy])."""
    helper = LayerHelper("bilinear_tensor_product", name=name,
                         param_attr=param_attr, bias_attr=bias_attr)
    w = helper.create_parameter(
        param_attr, shape=[size, x.shape[-1], y.shape[-1]], dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[1, size],
                                    dtype=x.dtype, is_bias=True)
        inputs["Bias"] = b
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": out})
    return helper.append_activation(out, act)


def continuous_value_model(input, cvm, use_cvm=True):
    """reference: layers/nn.py `continuous_value_model` → cvm op."""
    helper = LayerHelper("cvm")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cvm", inputs={"X": input, "CVM": cvm},
                     outputs={"Y": out}, attrs={"use_cvm": use_cvm})
    return out


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True):
    """reference: layers/nn.py `filter_by_instag` → filter_by_instag op
    (static shapes: kept rows compact to the top; LossWeight marks
    validity)."""
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference(ins.dtype)
    lw = helper.create_variable_for_type_inference(ins.dtype)
    imap = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="filter_by_instag",
                     inputs={"Ins": ins, "Ins_tag": ins_tag,
                             "Filter_tag": filter_tag},
                     outputs={"Out": out, "LossWeight": lw,
                              "IndexMap": imap},
                     attrs={"is_lod": is_lod})
    return out, lw, imap


def fsp_matrix(x, y):
    """reference: layers/nn.py `fsp_matrix` → fsp op (distillation)."""
    return _simple("fsp", {"X": x, "Y": y})


def hash(input, hash_size, num_hash=1, name=None):
    """reference: layers/nn.py `hash` → hash op."""
    return _simple("hash", {"X": input},
                     {"mod_by": int(hash_size), "num_hash": int(num_hash)},
                     dtype="int64")


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """reference: layers/nn.py `pad_constant_like` op."""
    return _simple("pad_constant_like", {"X": x, "Y": y},
                     {"pad_value": float(pad_value)}, dtype=y.dtype)


def similarity_focus(input, axis, indexes, name=None):
    """reference: layers/nn.py `similarity_focus` op."""
    return _simple("similarity_focus", {"X": input},
                     {"axis": int(axis),
                      "indexes": [int(i) for i in indexes]})


def unique_with_counts(x, dtype="int32"):
    """reference: layers/nn.py `unique_with_counts` op (static shapes:
    Count==0 marks padding slots)."""
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference("int64")
    count = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="unique_with_counts", inputs={"X": x},
                     outputs={"Out": out, "Index": index, "Count": count},
                     attrs={"dtype": dtype})
    return out, index, count


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """reference: layers/ops.py `uniform_random_batch_size_like` op."""
    return _simple("uniform_random_batch_size_like", {"Input": input},
                     {"shape": list(shape), "min": float(min),
                      "max": float(max), "seed": int(seed),
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx, "dtype": dtype},
                     dtype=dtype)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """reference: layers/ops.py `gaussian_random_batch_size_like` op."""
    return _simple("gaussian_random_batch_size_like", {"Input": input},
                     {"shape": list(shape), "mean": float(mean),
                      "std": float(std), "seed": int(seed),
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx, "dtype": dtype},
                     dtype=dtype)


def dice_loss(input, label, epsilon=1e-5):
    """reference: layers/nn.py `dice_loss` — EXACT reference composite:
    label one-hots to input's last dim, inse = Σ x·l over non-batch
    dims, dice = 1 - 2·inse / (Σx + Σl + ε), then mean."""
    from .nn import mean, one_hot, reduce_sum

    label_oh = one_hot(label, depth=int(input.shape[-1]))
    label_f = _simple("cast", {"X": label_oh},
                      {"out_dtype": str(input.dtype)},
                      dtype=input.dtype)
    dims = list(range(1, len(input.shape)))
    inse = reduce_sum(input * label_f, dim=dims)
    denom = reduce_sum(input, dim=dims) + reduce_sum(label_f, dim=dims)
    dice = 1.0 - inse * 2.0 / (denom + epsilon)
    return mean(dice)


def soft_relu(x, threshold=40.0, name=None):
    """reference: layers/ops.py `soft_relu` activation op."""
    return _simple("soft_relu", {"X": x},
                     {"threshold": float(threshold)})


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """reference: layers/nn.py `image_resize_short` — resize so the
    SHORT side equals out_short_len, keeping aspect ratio (static
    shapes: computed from the declared H/W)."""
    from .nn import image_resize

    h, w = int(input.shape[2]), int(input.shape[3])
    short, long_ = (h, w) if h < w else (w, h)
    scale = out_short_len / float(short)
    out_h, out_w = int(round(h * scale)), int(round(w * scale))
    return image_resize(input, out_shape=[out_h, out_w],
                        resample=resample)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference: layers/nn.py `autoincreased_step_counter` — a
    persistable int64 counter incremented by `step` each run."""
    from .tensor import create_global_var

    helper = LayerHelper("global_step_counter")
    counter = create_global_var(
        shape=[1], value=float(begin - step), dtype="int64",
        persistable=True,
        name=counter_name or "@STEP_COUNTER@")
    helper.append_op(type="increment", inputs={"X": counter},
                     outputs={"Out": counter},
                     attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """reference: layers/control_flow.py `Print` → print op (host-side
    debug dump at the op's program point)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"first_n": first_n,
                            "message": message or "",
                            "summarize": summarize,
                            "print_tensor_name": print_tensor_name,
                            "print_phase": print_phase.upper()})
    return out
