"""Optimizers of the fluid path: the static-graph part of the JAX
package's `optimizer.py` (reference: python/paddle/fluid/optimizer.py —
base :54, SGD :690, Momentum :760, DGCMomentum :868, LarsMomentum :1130,
Adagrad :1230, Adam :1340, Adamax :1530, Dpsgd :1690, DecayedAdagrad
:1769, Adadelta :1864, RMSProp :1970, Ftrl :2143, Lamb :2287,
ModelAverage :2442, EMA :2744, PipelineOptimizer :2974,
RecomputeOptimizer :3267, Lookahead :3560).

Each optimizer appends per-parameter update ops into the program, as in
the JAX package: `minimize` -> `append_backward` -> clip and
regularization -> `_append_optimize_op`, which builds the same ops,
slots, attrs and accumulator names. The classes are that file's, line
for line, with two differences: `ModelAverage.apply` and
`ExponentialMovingAverage.apply` compute the averaged params from the
scope's torch tensors; and the eager (dygraph) updates run on torch.
SGD, Momentum and Adam update each parameter in place under
`torch.no_grad()` on its device; every other optimizer replays its
`_append_optimize_op` plan, built once per parameter in a scratch
program, through `core/lowering.py::run_op`, with its state on the
parameter's device (one op registry serves both modes, as there).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .core import framework
from .core.backward import append_backward
from .core.framework import (OpRole, Variable, default_main_program,
                             default_startup_program, op_role_guard,
                             unique_name)
from .layer_helper import LayerHelper

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer", "Adamax",
    "AdamaxOptimizer", "Dpsgd", "DpsgdOptimizer", "DecayedAdagrad",
    "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "DGCMomentumOptimizer",
    "ModelAverage", "ExponentialMovingAverage", "LookaheadOptimizer",
    "RecomputeOptimizer", "PipelineOptimizer", "GradientMerge", "GradientMergeOptimizer",
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
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        if isinstance(self._learning_rate, LearningRateDecay):
            raise TypeError(
                "a dygraph LearningRateDecay scheduler only works in "
                "imperative mode (inside dygraph.guard()); static-graph "
                "programs use layers.learning_rate_scheduler decays "
                "(exponential_decay, piecewise_decay, ...)")
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

    # -- eager (dygraph) updates --------------------------------------------

    def _eager_lr(self) -> float:
        # per-step cache: _eager_update calls this once PER PARAMETER,
        # but a scheduler must advance once per minimize()
        cached = getattr(self, "_eager_lr_step_cache", None)
        if cached is not None:
            return cached
        from .dygraph.learning_rate_scheduler import LearningRateDecay

        if isinstance(self._learning_rate, LearningRateDecay):
            # advances the schedule by one step (reference: dygraph
            # LearningRateDecay.__call__)
            return float(self._learning_rate())
        if isinstance(self._learning_rate, Variable):
            raise NotImplementedError(
                "dygraph mode uses python-number learning rates or "
                "dygraph.LearningRateDecay schedulers")
        return float(self._learning_rate)

    def _eager_update(self, pid, value, grad):
        # Generic imperative update (reference design: imperative/
        # tracer.cc:45 — ONE op registry serves both static and dygraph
        # modes). SGD, Momentum and Adam override it with a direct
        # in-place update; everyone else reuses their
        # _append_optimize_op via a per-parameter scratch program whose
        # ops are replayed eagerly through the kernel registry.
        return self._eager_update_via_registry(pid, value, grad)

    def _eager_update_via_registry(self, p, value, grad):
        from .core.lowering import run_op
        from .core.registry import mix_seed

        device = value.device
        st = self._eager_state.setdefault(p, {})
        plan = st.get("plan")
        if plan is None:
            plan = self._build_eager_plan(p, value)
            st["plan"] = plan
            # run the scratch startup ops once: accumulator fills + the
            # lr var (overridden per step below)
            env0: dict = {}
            for op in plan["startup_ops"]:
                run_op(op, env0, None, 0, None, None, True, device)
            st["acc"] = {n: env0[n] for n in plan["state_vars"]
                         if n in env0}
        env = dict(st["acc"])
        env[plan["param"]] = value
        env[plan["grad"]] = grad
        env[plan["lr"]] = torch.tensor([self._eager_lr()], dtype=torch.float32,
                                       device=device)
        # a fresh seed a step: stochastic kernels (dpsgd's noise) must
        # not draw the same numbers every step
        step = st.get("step", 0)
        st["step"] = step + 1
        for op in plan["main_ops"]:
            run_op(op, env, None, 0, None, mix_seed(0, step), True, device)
        st["acc"] = {n: env[n] for n in plan["state_vars"] if n in env}
        return env[plan["param"]]

    def _build_eager_plan(self, p, value):
        """Author the single-parameter optimize block in a scratch static
        program (tracer suspended) and capture its op descs."""
        import contextlib

        from .core import framework as fw
        from .core.framework import Program, program_guard
        from .core.registry import dtype_name

        @contextlib.contextmanager
        def static_mode():
            t = fw._get_dygraph_tracer()
            fw._set_dygraph_tracer(None)
            try:
                yield
            finally:
                fw._set_dygraph_tracer(t)

        saved_lr = self._learning_rate
        saved_lr_var = self._learning_rate_var
        saved_acc = self._accumulators
        main, startup = Program(), Program()
        try:
            # a scheduler cannot be materialized as a static global var;
            # the plan's lr var is overridden with _eager_lr() per step.
            # Accumulators build into a FRESH registry: the scratch
            # program's vars must not leak into (or be short-circuited
            # by) a static-mode use of the same optimizer instance.
            self._learning_rate = float(self._eager_lr())
            self._learning_rate_var = None
            self._accumulators = defaultdict(dict)
            with static_mode(), unique_name.guard(), \
                    program_guard(main, startup):
                blk = main.global_block()
                pv = blk.create_var(name=p.name, shape=list(value.shape),
                                    dtype=dtype_name(value.dtype),
                                    persistable=True)
                # attribute passthrough: optimize hooks may consult these
                # (Lamb's exclude_from_weight_decay_fn, regularizers)
                pv.optimize_attr = getattr(p, "optimize_attr",
                                           {"learning_rate": 1.0})
                pv.trainable = getattr(p, "trainable", True)
                pv.regularizer = getattr(p, "regularizer", None)
                pv.do_model_average = getattr(p, "do_model_average", None)
                gv = blk.create_var(name=p.name + "@GRAD",
                                    shape=list(value.shape),
                                    dtype=dtype_name(value.dtype))
                self._create_global_learning_rate()
                self._create_accumulators(blk, [pv])
                self._append_optimize_op(blk, (pv, gv))
                self._finish_update(blk, [(pv, gv)])
            state_vars = sorted(
                {v.name for accs in self._accumulators.values()
                 for pname, v in accs.items() if pname == p.name})
            return {
                "param": pv.name,
                "grad": gv.name,
                "lr": self._learning_rate_var.name,
                "startup_ops": list(startup.desc.blocks[0].ops),
                "main_ops": list(main.desc.blocks[0].ops),
                "state_vars": state_vars,
            }
        finally:
            self._learning_rate = saved_lr
            self._learning_rate_var = saved_lr_var
            self._accumulators = saved_acc

    def _eager_regularize(self, p, grad):
        reg = getattr(p, "regularizer", None) or self.regularization
        if reg is None:
            return grad
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer

        if isinstance(reg, L2DecayRegularizer):
            return grad + reg._coeff * p.value
        if isinstance(reg, L1DecayRegularizer):
            return grad + reg._coeff * torch.sign(p.value)
        raise NotImplementedError(
            f"dygraph regularizer {type(reg).__name__}")

    def _eager_clip(self, pairs):
        from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                           GradientClipByValue)

        clip = self._grad_clip
        if clip is None:
            return pairs
        if isinstance(clip, GradientClipByValue):
            return [(p, torch.clamp(g, clip.min, clip.max)) for p, g in pairs]
        if isinstance(clip, GradientClipByNorm):
            out = []
            for p, g in pairs:
                n = torch.sqrt(torch.sum(g * g))
                out.append((p, g * torch.clamp(
                    clip.clip_norm / torch.clamp(n, min=1e-12), max=1.0)))
            return out
        if isinstance(clip, GradientClipByGlobalNorm):
            total = sum(torch.sum(g.float() ** 2) for _, g in pairs)
            gn = torch.sqrt(total)
            scale = clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)
            return [(p, g * scale) for p, g in pairs]
        raise NotImplementedError(f"dygraph clip {type(clip).__name__}")

    def _minimize_dygraph(self, loss, parameter_list=None, no_grad_set=None):
        import weakref

        from .observability import health as _obs_health

        if parameter_list is None:
            raise ValueError(
                "dygraph minimize requires parameter_list (e.g. "
                "opt.minimize(loss, parameter_list=model.parameters())): a "
                "global fallback would update every live model's parameters")
        if not hasattr(self, "_eager_state"):
            # weak keys: state dies with its parameter (no id() reuse)
            self._eager_state = weakref.WeakKeyDictionary()
        skip = {n if isinstance(n, str) else n.name
                for n in (no_grad_set or ())}
        with torch.no_grad():
            pairs = [(p, p.grad) for p in parameter_list
                     if not p.stop_gradient and getattr(p, "trainable", True)
                     and p.grad is not None and p.name not in skip]
            pairs = [(p, self._eager_regularize(p, g)) for p, g in pairs]
            if pairs and _obs_health.check_level():
                # PRE-clip on purpose: clipping rescales a diverging norm
                # down to clip_norm (and maps Inf grads to NaN), masking
                # exactly what this check watches for. One scalar covers
                # every gradient — a single NaN/Inf element poisons the
                # global norm. Summed on the device, so the check costs
                # ONE host sync, not one per parameter.
                total = sum(torch.sum(torch.square(g.float()))
                            for _, g in pairs)
                _obs_health.record_grad_global_norm(float(total) ** 0.5,
                                                    n_params=len(pairs))
            pairs = self._eager_clip(pairs)
            # resolve the lr ONCE for this step (a LearningRateDecay
            # scheduler advances on resolution) and pin it for the
            # per-param update loop
            self._eager_lr_step_cache = None
            self._eager_lr_step_cache = self._eager_lr()
            try:
                for p, g in pairs:
                    new = self._eager_update(p, p.value, g)
                    if new is not p.value:
                        p.set_value(new)
            finally:
                self._eager_lr_step_cache = None
        return [], [(p, None) for p, _ in pairs]


class SGDOptimizer(Optimizer):
    """reference: optimizer.py:690."""

    type = "sgd"

    def _eager_update(self, pid, value, grad):
        return value.sub_(self._eager_lr() * grad)

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

    def _eager_update(self, pid, value, grad):
        if pid not in self._eager_state:
            self._eager_state[pid] = {"v": torch.zeros_like(value)}
        st = self._eager_state[pid]
        v = st["v"].mul_(self._momentum).add_(grad)
        lr = self._eager_lr()
        if self._use_nesterov:
            return value.sub_(lr * (grad + self._momentum * v))
        return value.sub_(lr * v)

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


class LarsMomentumOptimizer(Optimizer):
    """reference: optimizer.py:1130."""

    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    """reference: optimizer.py:1230."""

    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    """reference: optimizer.py:1340."""

    type = "adam"

    def _eager_update(self, pid, value, grad):
        if pid not in self._eager_state:
            self._eager_state[pid] = {"m": torch.zeros_like(value),
                                      "v": torch.zeros_like(value), "t": 0}
        st = self._eager_state[pid]
        st["t"] += 1
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        st["m"] = b1 * st["m"] + (1 - b1) * grad
        st["v"] = b2 * st["v"] + (1 - b2) * grad * grad
        lr_t = self._eager_lr() * (1 - b2 ** st["t"]) ** 0.5 / (1 - b1 ** st["t"])
        return value.sub_(lr_t * st["m"] / (torch.sqrt(st["v"]) + eps))

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


class AdamaxOptimizer(Optimizer):
    """reference: optimizer.py:1530."""

    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={"Param": p, "Grad": g,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(type="scale", inputs={"X": b1p},
                            outputs={"Out": b1p},
                            attrs={"scale": self._beta1})


class DpsgdOptimizer(Optimizer):
    """reference: optimizer.py:1690 (differentially private SGD)."""

    type = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class DecayedAdagradOptimizer(Optimizer):
    """reference: optimizer.py:1769."""

    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """reference: optimizer.py:1864."""

    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adadelta",
            inputs={"Param": p, "Grad": g,
                    "AvgSquaredGrad": self._get_accumulator("__avg_squared_grad", p),
                    "AvgSquaredUpdate": self._get_accumulator("__avg_squared_update", p)},
            outputs={"ParamOut": p,
                     "AvgSquaredGradOut": self._get_accumulator("__avg_squared_grad", p),
                     "AvgSquaredUpdateOut": self._get_accumulator("__avg_squared_update", p)},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """reference: optimizer.py:1970."""

    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        outs = {"ParamOut": p,
                "MomentOut": self._get_accumulator("momentum", p),
                "MeanSquareOut": self._get_accumulator("mean_square", p)}
        ins = {"Param": p, "Grad": g,
               "Moment": self._get_accumulator("momentum", p),
               "MeanSquare": self._get_accumulator("mean_square", p),
               "LearningRate": self._create_param_lr(param_and_grad)}
        if self._centered:
            ins["MeanGrad"] = self._get_accumulator("mean_grad", p)
            outs["MeanGradOut"] = self._get_accumulator("mean_grad", p)
        return block.append_op(
            type="rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    """reference: optimizer.py:2143."""

    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="ftrl",
            inputs={"Param": p, "Grad": g,
                    "SquaredAccumulator": self._get_accumulator("squared", p),
                    "LinearAccumulator": self._get_accumulator("linear", p),
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p,
                     "SquaredAccumOut": self._get_accumulator("squared", p),
                     "LinearAccumOut": self._get_accumulator("linear", p)},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """reference: optimizer.py:2287."""

    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _eager_update(self, pid, value, grad):
        # do NOT inherit Adam's fast path: LAMB layerwise-normalizes the
        # update and applies decoupled weight decay — replay the lamb op
        return self._eager_update_via_registry(pid, value, grad)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            type="lamb",
            inputs={"Param": p, "Grad": g,
                    "Moment1": self._get_accumulator("moment1", p),
                    "Moment2": self._get_accumulator("moment2", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
                    "Beta2Pow": self._get_accumulator("beta2_pow_acc", p),
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p,
                     "Moment1Out": self._get_accumulator("moment1", p),
                     "Moment2Out": self._get_accumulator("moment2", p),
                     "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p),
                     "Beta2PowOut": self._get_accumulator("beta2_pow_acc", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class DGCMomentumOptimizer(MomentumOptimizer):
    """reference: optimizer.py:868 — Deep Gradient Compression
    (arxiv 1712.01887): momentum correction + top-k sparsification with
    local accumulation. Sparse allreduce semantics in ops/optimizer_ops.py
    dgc_momentum."""

    type = "dgc_momentum"

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 axis_name=None, **kw):
        super().__init__(learning_rate, momentum, use_nesterov, **kw)
        self._sparsity = list(sparsity)
        self._rampup_begin_step = rampup_begin_step
        # mesh axis for the sparse allreduce when the program runs under
        # SPMDRunner (None = single-device/GSPMD: compression only)
        self._axis_name = axis_name

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator("dgc_u", p)
        v = self._get_accumulator("dgc_v", p)
        sparse_out = block.create_var(
            name=unique_name.generate(p.name + "_dgc_grad"),
            shape=p.shape, dtype=p.dtype)
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": p, "Grad": g, "U": u, "V": v,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "UOut": u, "VOut": v, "GradOut": sparse_out},
            attrs={"mu": self._momentum,
                   "sparsity_ratio": 1.0 - self._sparsity[-1],
                   "axis_name": self._axis_name})


# ---------------------------------------------------------------------------
# Meta-optimizers
# ---------------------------------------------------------------------------


class ModelAverage(Optimizer):
    """reference: optimizer.py:2442 — maintains sum accumulators of params;
    apply()/restore() swap averaged params in and out."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads: List = []
        self._sum_vars: Dict[str, Variable] = {}
        self._cnt_var = None
        main = default_main_program()
        block = main.global_block()
        with op_role_guard(OpRole.Optimize):
            from .layers.tensor import create_global_var

            self._cnt_var = create_global_var([1], 0.0, "float32", persistable=True,
                                              name=unique_name.generate("ma_cnt"))
            block.append_op(type="increment", inputs={"X": self._cnt_var},
                            outputs={"Out": self._cnt_var}, attrs={"step": 1.0})
            for p in main.all_parameters():
                s = self._add_accumulator("ma_sum", p)
                self._sum_vars[p.name] = s
                block.append_op(type="elementwise_add", inputs={"X": s, "Y": p},
                                outputs={"Out": s})

    def _backup_and_set(self, executor, restore=False):
        from .core.executor import global_scope

        scope = global_scope()
        main = default_main_program()
        for p in main.all_parameters():
            if p.name not in self._sum_vars:
                continue
            if restore:
                bak = scope.find_var(p.name + "@BACKUP")
                if bak is not None:
                    scope.set_var(p.name, bak)
            else:
                scope.set_var(p.name + "@BACKUP", scope.find_var(p.name))
                s = scope.find_var(self._sum_vars[p.name].name)
                cnt = scope.find_var(self._cnt_var.name)
                scope.set_var(p.name, s / torch.clamp(cnt.reshape(()), min=1.0))

    def apply(self, executor=None, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._backup_and_set(executor)
            try:
                yield
            finally:
                if need_restore:
                    self._backup_and_set(executor, restore=True)

        return guard()

    def restore(self, executor=None):
        self._backup_and_set(executor, restore=True)


class ExponentialMovingAverage:
    """reference: optimizer.py:2744 — EMA shadow params with bias-corrected
    apply/restore guards."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars: Dict[str, Variable] = {}
        self._step_var = None

    def update(self):
        main = default_main_program()
        block = main.global_block()
        with op_role_guard(OpRole.Optimize):
            from .layers.tensor import create_global_var

            if self._step_var is None:
                self._step_var = create_global_var(
                    [1], 0.0, "float32", persistable=True,
                    name=unique_name.generate("ema_step"))
                block.append_op(type="increment", inputs={"X": self._step_var},
                                outputs={"Out": self._step_var}, attrs={"step": 1.0})
            for p in main.all_parameters():
                if not getattr(p, "trainable", True):
                    continue
                name = unique_name.generate(p.name + ".ema")
                ema = block.create_var(name=name, shape=p.shape, dtype=p.dtype,
                                       persistable=True)
                sb = default_startup_program().global_block()
                sv = sb.create_var(name=name, shape=p.shape, dtype=p.dtype,
                                   persistable=True)
                sb.append_op(type="fill_constant", outputs={"Out": sv},
                             attrs={"shape": list(p.shape), "dtype": p.dtype,
                                    "value": 0.0})
                self._ema_vars[p.name] = ema
                # ema = decay*ema + (1-decay)*p
                block.append_op(type="scale", inputs={"X": ema}, outputs={"Out": ema},
                                attrs={"scale": self._decay})
                tmp = block.create_var(name=unique_name.generate("ema_tmp"),
                                       shape=p.shape, dtype=p.dtype)
                block.append_op(type="scale", inputs={"X": p}, outputs={"Out": tmp},
                                attrs={"scale": 1.0 - self._decay})
                block.append_op(type="elementwise_add", inputs={"X": ema, "Y": tmp},
                                outputs={"Out": ema})

    def apply(self, executor=None, need_restore=True):
        import contextlib

        from .core.executor import global_scope

        @contextlib.contextmanager
        def guard():
            scope = global_scope()
            decay = self._decay
            step = scope.find_var(self._step_var.name) if self._step_var else None
            for pname, ema in self._ema_vars.items():
                scope.set_var(pname + "@BACKUP", scope.find_var(pname))
                e = scope.find_var(ema.name)
                if step is not None:
                    # bias correction
                    k = step.reshape(())
                    e = e / (1.0 - torch.pow(decay, k))
                scope.set_var(pname, e)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return guard()

    def restore(self, executor=None):
        from .core.executor import global_scope

        scope = global_scope()
        for pname in self._ema_vars:
            bak = scope.find_var(pname + "@BACKUP")
            if bak is not None:
                scope.set_var(pname, bak)


class LookaheadOptimizer:
    """reference: optimizer.py:3560 — slow/fast weights: every k steps
    slow += alpha*(fast - slow); fast = slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        ops, params_grads = self.inner_optimizer.minimize(loss, startup_program)
        main = default_main_program()
        block = main.global_block()
        with op_role_guard(OpRole.Optimize):
            from .layers.tensor import create_global_var
            from .layers import ops as _lops
            from .layers import tensor as _lt

            step = create_global_var([1], 0.0, "float32", persistable=True,
                                     name=unique_name.generate("lookahead_step"))
            block.append_op(type="increment", inputs={"X": step},
                            outputs={"Out": step}, attrs={"step": 1.0})
            # mod(step, k) == 0 → sync (arithmetic mask, no control flow)
            kconst = _lt.fill_constant([1], "float32", float(self.k))
            rem = _lops.elementwise_mod(step, kconst)
            from .layers.tensor import cast

            is_sync = cast(_lops.equal(rem, _lt.fill_constant([1], "float32", 0.0)),
                           "float32")
            for p, _ in params_grads:
                slow_name = p.name + "@SLOW"
                slow = block.create_var(name=slow_name, shape=p.shape,
                                        dtype=p.dtype, persistable=True)
                sb = default_startup_program().global_block()
                if not sb.has_var(slow_name):
                    sv = sb.create_var(name=slow_name, shape=p.shape,
                                       dtype=p.dtype, persistable=True)
                    sb.append_op(type="assign", inputs={"X": sb.var(p.name)},
                                 outputs={"Out": sv})
                # new_slow = slow + alpha*(fast-slow) when sync else slow
                diff = _lops.elementwise_sub(p, slow)
                stepv = _lops.elementwise_mul(
                    diff, _lt.fill_constant([1], p.dtype, self.alpha))
                cand = _lops.elementwise_add(slow, stepv)
                mask = is_sync if p.dtype == "float32" else cast(is_sync, p.dtype)
                one_minus = _lops.elementwise_sub(
                    _lt.fill_constant([1], p.dtype, 1.0), mask)
                new_slow = _lops.elementwise_add(
                    _lops.elementwise_mul(cand, mask),
                    _lops.elementwise_mul(slow, one_minus))
                new_fast = _lops.elementwise_add(
                    _lops.elementwise_mul(new_slow, mask),
                    _lops.elementwise_mul(p, one_minus))
                block.append_op(type="assign", inputs={"X": new_slow},
                                outputs={"Out": slow})
                block.append_op(type="assign", inputs={"X": new_fast},
                                outputs={"Out": p})
        return ops, params_grads


class RecomputeOptimizer(Optimizer):
    """reference: optimizer.py:3267 + backward.py:576 — gradient
    checkpointing. The checkpoints go to `append_backward`, as in the JAX
    package; each `_grad` op replays its forward from its inputs
    (core/registry.py), so the forward's activations are recomputed in
    the backward by construction."""

    def __init__(self, optimizer):
        super().__init__(optimizer._learning_rate)
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class GradientMergeOptimizer:
    """Gradient merge / accumulation over k steps (reference:
    ir/multi_devices_graph_pass/multi_batch_merge_pass.cc + fleet's
    gradient_merge): gradients accumulate into persistable buffers every
    step; the inner optimizer runs only on every k-th step inside a
    state-writing conditional (layers.cond_state), then the buffers reset.
    Inner optimizer state (moments, beta pows) advances only on apply steps
    — exact large-batch semantics."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_opt = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self.inner_opt.backward(loss, startup_program, parameter_list,
                                       no_grad_set, callbacks)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import layers as L
        from .layers import control_flow, tensor as ltensor

        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        if self.k_steps <= 1:
            return self.inner_opt.apply_gradients(params_grads), params_grads

        main = default_main_program()
        block = main.global_block()
        with op_role_guard(OpRole.Optimize):
            # step counter
            step = ltensor.create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate("@GRAD_MERGE_STEP@"))
            block.append_op(type="increment", inputs={"X": step},
                            outputs={"Out": step}, attrs={"step": 1.0})
            # accumulate grads
            accs = []
            for p, g in params_grads:
                acc = block.create_var(
                    name=unique_name.generate(f"{p.name}@GRAD_MERGE"),
                    shape=p.shape, dtype=g.dtype, persistable=True)
                sb = default_startup_program().global_block()
                sv = sb.create_var(name=acc.name, shape=p.shape,
                                   dtype=g.dtype, persistable=True)
                sb.append_op(type="fill_constant", outputs={"Out": sv},
                             attrs={"shape": list(p.shape), "dtype": g.dtype,
                                    "value": 0.0})
                block.append_op(type="elementwise_add",
                                inputs={"X": acc, "Y": g},
                                outputs={"Out": acc})
                accs.append(acc)

            k = ltensor.fill_constant([1], "float32", float(self.k_steps))
            rem = block.create_var(
                name=unique_name.generate("gm_rem"), shape=[1], dtype="float32")
            block.append_op(type="elementwise_mod", inputs={"X": step, "Y": k},
                            outputs={"Out": rem})
            pred = L.equal(rem, ltensor.fill_constant([1], "float32", 0.0))

            def apply_fn():
                scaled = []
                for (p, _), acc in zip(params_grads, accs):
                    eff = acc
                    if self.avg:
                        eff = L.scale(acc, scale=1.0 / self.k_steps)
                    scaled.append((p, eff))
                self.inner_opt.apply_gradients(scaled)
                blk = main.current_block()
                for acc in accs:
                    blk.append_op(type="scale", inputs={"X": acc},
                                  outputs={"Out": acc}, attrs={"scale": 0.0})

            control_flow.cond_state(pred, apply_fn)
        return [], params_grads


class PipelineOptimizer:
    """reference: optimizer.py:2974 + framework/pipeline_trainer.cc +
    section_worker.cc — split the program into sections at cut points, run
    as a pipeline. The JAX package's pipeline is parallel.pipeline (a
    GPipe schedule over a 'pp' mesh axis); this class records the cut
    configuration on the program and delegates, as there."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None):
        self._optimizer = optimizer
        self._cut_list = cut_list or []
        self._num_microbatches = num_microbatches or max(1, len(self._cut_list))

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        program._attrs["pipeline_cut_vars"] = [
            [v.name for v in seg] for seg in self._cut_list]
        program._attrs["pipeline_num_microbatches"] = self._num_microbatches
        return ops, params_grads


# short aliases (reference: optimizer.py bottom)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
GradientMerge = GradientMergeOptimizer
