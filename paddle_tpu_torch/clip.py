# Copied from the JAX package: paddle_tpu/clip.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Gradient clipping (reference: python/paddle/fluid/clip.py —
GradientClipByValue / ByNorm / ByGlobalNorm, set_gradient_clip)."""

from __future__ import annotations

from typing import List, Tuple

from .core.framework import OpRole, default_main_program, op_role_guard, unique_name

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops", "ErrorClipByValue"]

_clip_attr_name = "gradient_clip_attr"


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._process(params_grads)


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process(self, params_grads):
        return params_grads


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            ng = block.create_var(name=unique_name.generate(g.name + "_clip"),
                                  shape=g.shape, dtype=g.dtype)
            block.append_op(type="clip", inputs={"X": g}, outputs={"Out": ng},
                            attrs={"min": self.min, "max": self.max})
            out.append((p, ng))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            ng = block.create_var(name=unique_name.generate(g.name + "_clip"),
                                  shape=g.shape, dtype=g.dtype)
            block.append_op(type="clip_by_norm", inputs={"X": g},
                            outputs={"Out": ng},
                            attrs={"max_norm": self.clip_norm})
            out.append((p, ng))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """reference: clip.py GradientClipByGlobalNorm — scale all grads by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        from .layers import ops as _lops
        from .layers import tensor as _lt
        from .layers.nn import squared_l2_norm

        block = default_main_program().global_block()
        sq_norms = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                continue
            sq_norms.append(squared_l2_norm(g))
        if not sq_norms:
            return params_grads
        total = sq_norms[0]
        for s in sq_norms[1:]:
            total = _lops.elementwise_add(total, s)
        global_norm = _lops.sqrt(total)
        clip_var = _lt.fill_constant([1], "float32", self.clip_norm)
        scale = _lops.elementwise_div(
            clip_var, _lops.elementwise_max(global_norm, clip_var))
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            ng = block.create_var(name=unique_name.generate(g.name + "_gclip"),
                                  shape=g.shape, dtype=g.dtype)
            block.append_op(type="elementwise_mul", inputs={"X": g, "Y": scale},
                            outputs={"Out": ng})
            out.append((p, ng))
        return out


class ErrorClipByValue:
    """reference: clip.py ErrorClipByValue (clips activations' grads)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    for p in param_list:
        if isinstance(p, str):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    clips = set()
    for p, g in params_grads:
        c = getattr(p, "gradient_clip_attr", None)
        if c is not None:
            clips.add(c)
    if not clips:
        return params_grads
    if len(clips) > 1:
        # apply each clip only to its own params
        out = []
        for p, g in params_grads:
            c = getattr(p, "gradient_clip_attr", None)
            if c is None:
                out.append((p, g))
            else:
                out.extend(c([(p, g)]))
        return out
    with op_role_guard(OpRole.Backward):
        return next(iter(clips))(params_grads)
