# Copied from the JAX package: paddle_tpu/layers/learning_rate_scheduler.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""LR schedulers (reference: python/paddle/fluid/layers/
learning_rate_scheduler.py) — build scheduler math as graph ops over a
global-step counter variable, exactly like the reference."""

from __future__ import annotations

import math

from ..core.framework import default_main_program, default_startup_program, unique_name
from ..layer_helper import LayerHelper
from . import ops as _ops
from . import tensor as _tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
           "linear_lr_warmup"]

_STEP_VAR = "@LR_DECAY_COUNTER@"


def _global_step():
    """Persistable step counter incremented once per program run (reference:
    layers/learning_rate_scheduler.py _decay_step_counter)."""
    main = default_main_program()
    gb = main.global_block()
    if gb.has_var(_STEP_VAR):
        return gb.var(_STEP_VAR)
    # init to -1 so the prepended increment makes the first run observe 0
    # (reference: _decay_step_counter(begin=0)).
    var = _tensor.create_global_var([1], -1.0, "float32", persistable=True,
                                    name=_STEP_VAR)
    gb.prepend_op(type="increment", inputs={"X": var}, outputs={"Out": var},
                  attrs={"step": 1.0})
    return var


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = _ops.elementwise_div(step, _tensor.fill_constant([1], "float32", decay_steps))
    if staircase:
        div = _ops.floor(div)
    return _ops.elementwise_mul(
        _tensor.fill_constant([1], "float32", learning_rate),
        _ops.elementwise_pow(_tensor.fill_constant([1], "float32", decay_rate), div))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = _ops.elementwise_div(step, _tensor.fill_constant([1], "float32", decay_steps))
    if staircase:
        div = _ops.floor(div)
    return _ops.elementwise_mul(
        _tensor.fill_constant([1], "float32", learning_rate),
        _ops.exp(_ops.elementwise_mul(div, _tensor.fill_constant([1], "float32", -decay_rate))))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    div = _ops.elementwise_div(step, _tensor.fill_constant([1], "float32", decay_steps))
    if staircase:
        div = _ops.floor(div)
    denom = _ops.elementwise_add(
        _tensor.fill_constant([1], "float32", 1.0),
        _ops.elementwise_mul(_tensor.fill_constant([1], "float32", decay_rate), div))
    return _ops.elementwise_div(_tensor.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from .nn import clip

    step = _global_step()
    step_c = clip(step, 0.0, float(decay_steps))
    frac = _ops.elementwise_div(step_c, _tensor.fill_constant([1], "float32", decay_steps))
    one_minus = _ops.elementwise_sub(_tensor.fill_constant([1], "float32", 1.0), frac)
    poly = _ops.elementwise_pow(one_minus, _tensor.fill_constant([1], "float32", power))
    rng = learning_rate - end_learning_rate
    return _ops.elementwise_add(
        _ops.elementwise_mul(poly, _tensor.fill_constant([1], "float32", rng)),
        _tensor.fill_constant([1], "float32", end_learning_rate))


def piecewise_decay(boundaries, values):
    """Piecewise-constant LR via arithmetic on step comparisons (avoids
    control flow: sum_i values[i] * 1[b_{i-1} <= step < b_i])."""
    assert len(values) == len(boundaries) + 1
    step = _global_step()
    from .tensor import cast

    lr = _tensor.fill_constant([1], "float32", values[-1])
    prev_bound = None
    pieces = []
    for i, b in enumerate(boundaries):
        ge = cast(_ops.greater_equal(step, _tensor.fill_constant([1], "float32", float(b))), "float32")
        # lr = v_last + sum_i (v_i - v_{i+1}) * 1[step < b_i]
        lt = _ops.elementwise_sub(_tensor.fill_constant([1], "float32", 1.0), ge)
        diff = values[i] - values[i + 1]
        pieces.append(_ops.elementwise_mul(lt, _tensor.fill_constant([1], "float32", diff)))
    for p in pieces:
        lr = _ops.elementwise_add(lr, p)
    return lr


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """reference: noam_decay — the Transformer LR schedule. The reference
    counts from begin=1 here (learning_rate_scheduler.py:95) while the other
    schedules count from 0, so shift the shared counter by +1 (0**-0.5 = inf
    would zero the first step otherwise)."""
    step = _ops.elementwise_add(
        _global_step(), _tensor.fill_constant([1], "float32", 1.0))
    a = _ops.elementwise_pow(step, _tensor.fill_constant([1], "float32", -0.5))
    b = _ops.elementwise_mul(step, _tensor.fill_constant(
        [1], "float32", warmup_steps ** -1.5))
    m = _ops.elementwise_min(a, b)
    return _ops.elementwise_mul(
        m, _tensor.fill_constant([1], "float32", learning_rate * d_model ** -0.5))


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    epoch = _ops.floor(_ops.elementwise_div(
        step, _tensor.fill_constant([1], "float32", step_each_epoch)))
    frac = _ops.elementwise_div(epoch, _tensor.fill_constant([1], "float32", epochs))
    cosv = _ops.cos(_ops.elementwise_mul(frac, _tensor.fill_constant([1], "float32", math.pi)))
    return _ops.elementwise_mul(
        _ops.elementwise_add(cosv, _tensor.fill_constant([1], "float32", 1.0)),
        _tensor.fill_constant([1], "float32", 0.5 * learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    from .tensor import cast

    in_warmup = cast(_ops.less_than(step, _tensor.fill_constant(
        [1], "float32", float(warmup_steps))), "float32")
    frac = _ops.elementwise_div(step, _tensor.fill_constant([1], "float32", warmup_steps))
    warm = _ops.elementwise_add(
        _tensor.fill_constant([1], "float32", start_lr),
        _ops.elementwise_mul(frac, _tensor.fill_constant([1], "float32", end_lr - start_lr)))
    if not hasattr(learning_rate, "name"):
        learning_rate = _tensor.fill_constant([1], "float32", learning_rate)
    one_minus = _ops.elementwise_sub(_tensor.fill_constant([1], "float32", 1.0), in_warmup)
    return _ops.elementwise_add(_ops.elementwise_mul(in_warmup, warm),
                                _ops.elementwise_mul(one_minus, learning_rate))
