# Copied from the JAX package: paddle_tpu/layers/metric_op.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Metric layers (reference: python/paddle/fluid/layers/metric_op.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer
from ..param_attr import ParamAttr

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """reference: metric_op.py `accuracy` → top_k + accuracy ops."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_indices},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": topk_out, "Indices": topk_indices,
                             "Label": label},
                     outputs={"Accuracy": acc_out, "Correct": correct,
                              "Total": total})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """reference: metric_op.py `auc` — streaming AUC with persistable
    stat buffers."""
    helper = LayerHelper("auc")
    n = num_thresholds + 1
    stat_pos = helper.create_parameter(
        ParamAttr(trainable=False), shape=[n], dtype="float32",
        default_initializer=ConstantInitializer(0.0))
    stat_neg = helper.create_parameter(
        ParamAttr(trainable=False), shape=[n], dtype="float32",
        default_initializer=ConstantInitializer(0.0))
    stat_pos.stop_gradient = True
    stat_neg.stop_gradient = True
    auc_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="auc",
                     inputs={"Predict": input, "Label": label,
                             "StatPos": stat_pos, "StatNeg": stat_neg},
                     outputs={"AUC": auc_out, "StatPosOut": stat_pos,
                              "StatNegOut": stat_neg},
                     attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, auc_out, [stat_pos, stat_neg]
