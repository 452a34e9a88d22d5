# Copied from the JAX package: paddle_tpu/amp/decorator.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""AMP decorator (reference: contrib/mixed_precision/decorator.py:208
`decorate` → OptimizerWithMixedPrecision:27 — cast insertion per white/black
lists + loss scaling).

Rebuilt on the PRECISION POLICY (core/precision.py): instead of
rewriting the protobuf with cast ops, `decorate` pins the program to
the `mixed_bf16` (or `mixed_f16`) policy and the executor inserts the
white/black-list casts jnp-natively at LOWERING time — XLA sees and
fuses them, the program desc stays clean, and the same policy is part
of the executor cache key / compile-cache fingerprint so flipping it
recompiles. The legacy protobuf pass survives as `rewrite_program`
(and `decorate(..., rewrite=True)`) for parity with the reference.
The jax-native trainer's dynamic loss scaling lives in
parallel/train.py make_train_step(precision=...), with its state
inside TrainState; this fluid-path decorator keeps the reference's
static scale-var + unscale + zero-nonfinite-grad machinery for f16."""

from __future__ import annotations

from typing import Dict, Optional

from ..core import precision as _precision
from ..core.framework import (OpRole, Program, Variable, default_main_program,
                              op_role_guard, unique_name)
from ..core.ir import OpDesc
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision", "rewrite_program"]


def _cast_desc(src: str, dst: str, in_dtype: str, out_dtype: str) -> OpDesc:
    return OpDesc(type="cast", inputs={"X": [src]}, outputs={"Out": [dst]},
                  attrs={"in_dtype": in_dtype, "out_dtype": out_dtype,
                         OpRole.AttrName: OpRole.Forward})


def rewrite_program(program: Program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype: str = "bfloat16"):
    """Insert casts so white-list ops compute in `dest_dtype` and black-list
    ops in fp32 (reference: decorator.py rewrite via insert_cast_op)."""
    block = program.global_block()
    new_ops = []
    low_version: Dict[str, str] = {}   # fp32 var -> its low-precision cast
    high_version: Dict[str, str] = {}  # low var -> fp32 cast back

    def var_dtype(name):
        v = block._find_var_recursive(name)
        return v.desc.dtype if v is not None else "float32"

    def ensure_cast(name, want, cache, tag):
        have = var_dtype(name)
        if have == want or have not in ("float32", "float16", "bfloat16"):
            return name
        if name in cache:
            return cache[name]
        base = block._find_var_recursive(name)
        new_name = unique_name.generate(f"{name}.cast_{tag}")
        nv = block.create_var(name=new_name, shape=base.shape, dtype=want)
        nv.desc.stop_gradient = base.desc.stop_gradient
        new_ops.append(_cast_desc(name, new_name, have, want))
        cache[name] = new_name
        return new_name

    for op in block.desc.ops:
        if op.type in amp_lists.white_list:
            # cast inputs low
            for slot, names in op.inputs.items():
                op.inputs[slot] = [
                    ensure_cast(n, dest_dtype, low_version, "low") if n else n
                    for n in names]
            for n in op.output_names():
                v = block._find_var_recursive(n)
                if v is not None and v.desc.dtype == "float32":
                    v.desc.dtype = dest_dtype
            new_ops.append(op)
        elif op.type in amp_lists.black_list:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [
                    ensure_cast(n, "float32", high_version, "fp32") if n else n
                    for n in names]
            new_ops.append(op)
        else:
            new_ops.append(op)
    block.desc.ops = new_ops
    program._rebuild_from_desc()


class OptimizerWithMixedPrecision:
    """reference: decorator.py:27."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8,
                 use_bf16=True, rewrite=False):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._use_bf16 = use_bf16
        self._dest_dtype = "bfloat16" if use_bf16 else "float16"
        self._policy_name = "mixed_bf16" if use_bf16 else "mixed_f16"
        # rewrite=True restores the legacy protobuf cast-op pass; the
        # default pins the program's precision policy instead and the
        # executor autocasts at lowering time. Custom amp_lists force
        # the rewrite path too — the policy autocast uses the module
        # white/black lists, not per-optimizer customizations.
        self._rewrite = bool(rewrite) or amp_lists is not None
        # bf16 has fp32's exponent range — no loss scaling needed
        self._loss_scaling = 1.0 if use_bf16 else init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling and not use_bf16
        self._scale_var: Optional[Variable] = None

    def get_loss_scaling(self):
        return self._scale_var

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        if self._rewrite:
            rewrite_program(program, self._amp_lists, self._dest_dtype)
        else:
            _precision.set_program_precision(program, self._policy_name)
        loss = program.global_block().var(loss.name)
        from ..layers import ops as _lops
        from ..layers import tensor as _lt

        if self._loss_scaling != 1.0:
            from ..layers.tensor import create_global_var

            self._scale_var = create_global_var(
                [1], self._loss_scaling, "float32", persistable=True,
                name=unique_name.generate("loss_scaling"))
            scaled_loss = _lops.elementwise_mul(loss, self._scale_var)
        else:
            scaled_loss = loss
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set, callbacks)
        if self._loss_scaling != 1.0:
            # unscale grads (+ zero non-finite grads: the reference's
            # check_finite_and_unscale / update_loss_scaling ops)
            from ..layers.tensor import cast as _cast

            block = program.global_block()
            new_pg = []
            for p, g in params_grads:
                unscaled = _lops.elementwise_div(g, self._scale_var)
                finite = _cast(
                    __import__("paddle_tpu_torch.layers", fromlist=["isfinite"]).isfinite(unscaled),
                    "float32")
                safe = _lops.elementwise_mul(unscaled, finite)
                new_pg.append((p, safe))
            params_grads = new_pg
        return params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        ops = self.apply_gradients(params_grads)
        return ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8, use_dynamic_loss_scaling=True,
             use_bf16=True, rewrite=False):
    """reference: decorator.py:208. Pins the loss's program to the
    mixed_bf16/mixed_f16 precision policy (lowering-time jnp autocast);
    pass rewrite=True (or custom amp_lists) for the legacy protobuf
    cast-insertion pass."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_bf16=use_bf16, rewrite=rewrite)
