"""Optimizers of the fluid path: the static-graph part of the JAX
package's `optimizer.py` (reference: python/paddle/fluid/optimizer.py —
base :54, SGD :690, Momentum :760, Adam :1340).

Each optimizer appends per-parameter update ops into the program, as in
the JAX package: `minimize` -> `append_backward` -> clip and
regularization -> `_append_optimize_op`. The classes' static-graph
methods are that file's, line for line, with two differences:
`_create_global_learning_rate` has no dygraph `LearningRateDecay` check
(the port has no dygraph scheduler to meet), and the dygraph path
(`_minimize_dygraph` and the `_eager_*` methods, the file's only jax)
is replaced by a `_minimize_dygraph` that raises until dygraph is ported
(ROADMAP item 16). The other optimizers (Adagrad, Adamax, RMSProp, Lamb,
Lars, DGC, Recompute, Pipeline, GradientMerge, ModelAverage, EMA,
Lookahead, ...) are still to port (ROADMAP item 16).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from .core import framework
from .core.backward import append_backward
from .core.framework import (OpRole, Variable, default_main_program,
                             default_startup_program, op_role_guard,
                             unique_name)
from .layer_helper import LayerHelper

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adam", "AdamOptimizer",
]


class Optimizer:
    """reference: optimizer.py:54."""

    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self._learning_rate_var: Optional[Variable] = None
        self.helper: Optional[LayerHelper] = None
        self.type = getattr(self, "type", "optimizer")

    # -- learning rate -------------------------------------------------------

    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return
        if self._learning_rate_var is None:
            from .layers.tensor import create_global_var

            self._learning_rate_var = create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate("learning_rate"))

    def _global_learning_rate(self):
        return self._learning_rate_var

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        plr = getattr(param, "optimize_attr", {"learning_rate": 1.0}).get("learning_rate", 1.0)
        if plr == 1.0:
            return self._global_learning_rate()
        from .layers.nn import scale as _scale

        return _scale(self._global_learning_rate(), scale=float(plr))

    # -- accumulators --------------------------------------------------------

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(f"{param.name}_{name}")
        main = default_main_program()
        var = main.global_block().create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        sb = default_startup_program().global_block()
        svar = sb.create_var(name=var_name, shape=shape, dtype=dtype, persistable=True)
        sb.append_op(type="fill_constant", outputs={"Out": svar},
                     attrs={"shape": shape, "dtype": dtype,
                            "value": float(fill_value)})
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks subclasses implement -----------------------------------------

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    # -- main API ------------------------------------------------------------

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads) -> List:
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        # grad clip + regularization (reference: optimizer.py apply_gradients
        # → clip.append_gradient_clip_ops / regularizer.append_regularization_ops)
        from .clip import append_gradient_clip_ops
        from .regularizer import append_regularization_ops

        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        else:
            params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)

        # current_block (not global): lets the optimize ops be collected
        # into a conditional sub-block (GradientMergeOptimizer's every-k gate)
        block = default_main_program().current_block()
        with op_role_guard(OpRole.Optimize):
            self._create_global_learning_rate()
            self._create_accumulators(block, [pg[0] for pg in params_grads])
            ops = []
            for pg in params_grads:
                ops.append(self._append_optimize_op(block, pg))
            self._finish_update(block, params_grads)
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        if framework.in_dygraph_mode():
            return self._minimize_dygraph(loss, parameter_list, no_grad_set)
        self.helper = LayerHelper(self.__class__.__name__)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    def _minimize_dygraph(self, loss, parameter_list=None, no_grad_set=None):
        raise NotImplementedError(
            "dygraph (imperative) mode is not ported to paddle_tpu_torch "
            "yet (ROADMAP item 16); build a Program and run it with "
            "Executor")


class SGDOptimizer(Optimizer):
    """reference: optimizer.py:690."""

    type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p})


class MomentumOptimizer(Optimizer):
    """reference: optimizer.py:760."""

    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    """reference: optimizer.py:1340."""

    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        # reference optimizer.py:1340 — lazy_mode selects the
        # touched-rows-only sparse adam path (SelectedRows grads)
        self._lazy_mode = bool(lazy_mode)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "lazy_mode": self._lazy_mode})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
