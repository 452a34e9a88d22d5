# Copied from the JAX package: paddle_tpu/layers/loss.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Loss layers (reference: python/paddle/fluid/layers/nn.py loss section)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "smooth_l1",
    "huber_loss", "kldiv_loss", "margin_rank_loss", "hinge_loss", "bce_loss",
    "mse_loss", "nce", "hsigmoid", "sampled_softmax_with_cross_entropy",
    "cos_sim",
]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy", inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": logits, "Label": label},
                     outputs={"Loss": loss, "Softmax": softmax},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index,
                            "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": x, "Label": label}, outputs={"Out": out},
                     attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost", inputs={"X": input, "Y": label},
                     outputs={"Out": out})
    return out


def mse_loss(input, label):
    from .nn import mean

    return mean(square_error_cost(input, label))


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": loss, "Diff": diff},
                     attrs={"sigma": sigma or 1.0})
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    loss = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": loss, "Residual": residual},
                     attrs={"delta": float(delta)})
    return loss


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="kldiv_loss", inputs={"X": x, "Target": target},
                     outputs={"Loss": loss}, attrs={"reduction": reduction})
    return loss


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": label, "X1": left, "X2": right},
                     outputs={"Out": out, "Activated": act},
                     attrs={"margin": float(margin)})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hinge_loss", inputs={"Logits": input, "Labels": label},
                     outputs={"Loss": out})
    return out


def bce_loss(input, label, name=None):
    helper = LayerHelper("bce_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="bce_loss", inputs={"X": input, "Label": label},
                     outputs={"Out": out})
    return out


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """NCE loss over a private [C, D] weight table (reference:
    layers/nn.py:7106 → nce_op). `custom_dist` is a per-class probability
    list for sampler='custom'."""
    import numpy as np

    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr, shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_total_classes],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    slogits = helper.create_variable_for_type_inference(input.dtype)
    slabels = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": input, "Label": label, "Weight": w}
    if b is not None:
        inputs["Bias"] = b
    if sample_weight is not None:
        inputs["SampleWeight"] = sample_weight
    if custom_dist is not None:
        from .tensor import assign

        inputs["CustomDistProbs"] = assign(
            np.asarray(custom_dist, dtype="float32"))
        sampler = "custom"
    helper.append_op(type="nce", inputs=inputs,
                     outputs={"Cost": cost, "SampleLogits": slogits,
                              "SampleLabels": slabels},
                     attrs={"num_total_classes": int(num_total_classes),
                            "num_neg_samples":
                                10 if num_neg_samples is None
                                else int(num_neg_samples),
                            "sampler": sampler, "seed": seed,
                            "is_sparse": is_sparse})
    return cost


def hsigmoid(input, label, num_classes=None, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid cost (reference: layers/nn.py:7335 →
    hierarchical_sigmoid_op). Default: complete binary tree over
    num_classes; custom trees pass path_table/path_code."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[-1])
    if not is_custom:
        if num_classes is None or num_classes < 2:
            raise ValueError("num_classes >= 2 required for default tree")
        num_nodes = num_classes - 1
    else:
        if path_table is None or path_code is None:
            raise ValueError("is_custom requires path_table and path_code")
        if num_classes is None:
            raise ValueError("is_custom requires num_classes (number of "
                             "non-leaf nodes, sizes the W table)")
        num_nodes = num_classes
    w = helper.create_parameter(param_attr, shape=[num_nodes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_nodes],
                                dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "W": w, "Label": label}
    if b is not None:
        inputs["Bias"] = b
    if path_table is not None:
        inputs["PathTable"] = path_table
        inputs["PathCode"] = path_code
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": out, "PreOut": pre},
                     attrs={"num_classes": int(num_classes),
                            "is_sparse": is_sparse})
    return out


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1,
                                       remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """reference: layers/nn.py:7916 → sample_logits + softmax CE."""
    helper = LayerHelper("sampled_softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    samples = helper.create_variable_for_type_inference("int64")
    slogits = helper.create_variable_for_type_inference(logits.dtype)
    inputs = {"Logits": logits, "Label": label}
    if use_customized_samples:
        inputs["CustomizedSamples"] = customized_samples
        inputs["CustomizedProbabilities"] = customized_probabilities
    helper.append_op(type="sampled_softmax_with_cross_entropy",
                     inputs=inputs,
                     outputs={"Loss": loss, "Samples": samples,
                              "SampledLogits": slogits},
                     attrs={"num_samples": int(num_samples),
                            "num_true": int(num_true),
                            "remove_accidental_hits": remove_accidental_hits,
                            "use_customized_samples": use_customized_samples,
                            "seed": seed})
    return loss


def cos_sim(X, Y):
    """Row-wise cosine similarity (reference: layers/nn.py:1681 →
    cos_sim_op)."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out, "XNorm": xn, "YNorm": yn})
    return out
