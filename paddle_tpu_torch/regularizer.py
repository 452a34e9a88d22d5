# Copied from the JAX package: paddle_tpu/regularizer.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Regularizers (reference: python/paddle/fluid/regularizer.py) — append
penalty-gradient ops onto each param's grad."""

from __future__ import annotations

from .core.framework import OpRole, default_main_program, op_role_guard, unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(name=unique_name.generate("l2_decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": param}, outputs={"Out": decay},
                        attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(name=unique_name.generate("l1_sign"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": param}, outputs={"Out": sign})
        decay = block.create_var(name=unique_name.generate("l1_decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": sign}, outputs={"Out": decay},
                        attrs={"scale": self._coeff})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    """reference: regularizer.py append_regularization_ops — per-param
    regularizer overrides the global one."""
    out = []
    block = default_main_program().global_block()
    with op_role_guard(OpRole.Backward):
        for param, grad in params_grads:
            reg = getattr(param, "regularizer", None) or regularization
            if reg is None or grad is None:
                out.append((param, grad))
                continue
            decay = reg(param, grad, block)
            new_grad = block.create_var(
                name=unique_name.generate(grad.name + "_reg"),
                shape=grad.shape, dtype=grad.dtype)
            block.append_op(type="elementwise_add", inputs={"X": grad, "Y": decay},
                            outputs={"Out": new_grad})
            out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
