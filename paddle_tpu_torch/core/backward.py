# Copied from the JAX package: paddle_tpu/core/backward.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Symbolic autodiff over the Program IR.

Reference: python/paddle/fluid/backward.py — `append_backward` :933 walks the
op path to the loss (`_find_op_path_` :1159), asks each op's GradOpMaker for
grad OpDescs, dedups repeated grads (`_addup_repetitive_outputs_` :324) and
prunes no-grad vars (:406).

Here each forward op gets ONE generically-generated grad op `<type>_grad`
whose kernel is jax.vjp of the forward kernel (core/registry.py), so this
module only does the graph walk + grad accumulation bookkeeping. Grad ops use
slots fwd_in::/fwd_out::/out_grad::/in_grad:: instead of the reference's
X / Out / Out@GRAD / X@GRAD convention.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import registry
from .framework import Block, OpRole, Parameter, Program, Variable, unique_name
from .ir import GRAD_SUFFIX, OpDesc, VarDesc, grad_var_name
from .registry import GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG, GRAD_PREFIX_OUT

_FLOAT_DTYPES = {"float16", "bfloat16", "float32", "float64"}


def _is_float_var(desc: VarDesc) -> bool:
    return desc.dtype in _FLOAT_DTYPES


def _base_var_of_grad(gname: str) -> str:
    name = gname.split("@RENAME@")[0]
    if name.endswith(GRAD_SUFFIX):
        name = name[: -len(GRAD_SUFFIX)]
    return name


class _GradEmitter:
    def __init__(self, block: Block, no_grad_set: Set[str],
                 force_grad: Optional[Set[str]] = None):
        self.block = block
        self.no_grad = no_grad_set
        self.force_grad = force_grad or set()
        # var -> list of pending (unsummed) grad names
        self.pending: Dict[str, List[str]] = defaultdict(list)
        self.finalized: Dict[str, str] = {}
        # var -> this invocation's canonical grad name. A prior
        # append_backward/gradients call may already own `var@GRAD` (the
        # double-backward case: the second pass differentiates THROUGH the
        # first pass's grad ops); writing it again would alias the
        # first-order gradient, so each emitter claims fresh names
        # (var@GRAD@2, @3, ...) when the plain name is taken.
        self._canonical: Dict[str, str] = {}

    # -- var/desc helpers ----------------------------------------------------

    def canonical_grad_name(self, var: str) -> str:
        if var in self._canonical:
            return self._canonical[var]
        name = grad_var_name(var)
        k = 1
        while self.block._find_var_recursive(name) is not None:
            k += 1
            name = f"{grad_var_name(var)}@{k}"
        self._canonical[var] = name
        return name

    def _ensure_grad_var(self, gname: str, base: Optional[str] = None):
        base = base if base is not None else _base_var_of_grad(gname)
        bvar = self.block._find_var_recursive(base)
        if self.block._find_var_recursive(gname) is None:
            self.block.create_var(
                name=gname,
                shape=bvar.shape if bvar is not None else None,
                dtype=bvar.dtype if bvar is not None else "float32",
            )

    def _append_raw(self, desc: OpDesc):
        """Append a grad OpDesc without eval_shape inference (grad shapes are
        the forward shapes by construction)."""
        from .framework import Operator

        desc.attrs.setdefault(OpRole.AttrName, OpRole.Backward)
        self.block.desc.ops.append(desc)
        self.block.ops.append(Operator(self.block, desc))
        self.block.program._bump_version()

    # -- accumulation --------------------------------------------------------

    def new_grad_name(self, var: str) -> str:
        canonical = self.canonical_grad_name(var)
        if not self.pending[var]:
            g = canonical
        else:
            g = f"{canonical}@RENAME@{len(self.pending[var])}"
        self.pending[var].append(g)
        self._ensure_grad_var(g, base=var)
        return g

    def finalize(self, var: str) -> Optional[str]:
        """Sum pending grad contributions into this invocation's canonical
        grad var (var@GRAD, or var@GRAD@k under double backward)."""
        if var in self.finalized:
            return self.finalized[var]
        names = self.pending.get(var)
        if not names:
            return None
        if len(names) == 1:
            # single contribution keeps its name (for emitter-made names
            # this IS the canonical; for seeds it is the caller's var)
            self.finalized[var] = names[0]
            return names[0]
        canonical = self.canonical_grad_name(var)
        # Out may alias X[0] (the canonical usually holds the first
        # contribution): the functional executor reads all inputs before
        # binding the output, so the in-place sum is well-defined.
        self._ensure_grad_var(canonical, base=var)
        self._append_raw(OpDesc(
            type="sum",
            inputs={"X": list(names)},
            outputs={"Out": [canonical]},
            attrs={OpRole.AttrName: OpRole.Backward},
        ))
        self.finalized[var] = canonical
        return canonical


def _find_op_path(
    block: Block,
    target_names: Set[str],
    source_names: Optional[Set[str]],
    no_grad_set: Set[str],
    force_grad: Optional[Set[str]] = None,
) -> Tuple[List[bool], Set[str]]:
    """Reverse pass marking ops on the grad path and vars needing grads
    (reference: backward.py:1159 _find_op_path_)."""
    ops = block.desc.ops
    needed = set(target_names)
    on_path = [False] * len(ops)
    for i in reversed(range(len(ops))):
        op = ops[i]
        try:
            opdef = registry.get_op_def(op.type)
        except KeyError:
            continue
        if not opdef.has_grad():
            continue
        if not any(o in needed for o in op.output_names()):
            continue
        on_path[i] = True
        for slot, names in op.inputs.items():
            if slot in opdef.nondiff_inputs:
                continue
            for n in names:
                if not n or n in no_grad_set:
                    continue
                v = block._find_var_recursive(n)
                if v is None or not _is_float_var(v.desc):
                    continue
                # explicitly-requested gradient inputs override
                # stop_gradient (reference calc_gradient semantics:
                # fluid.gradients(y, x) works for feed/data x)
                if v.desc.stop_gradient and n not in (force_grad or ()):
                    continue
                needed.add(n)
    if source_names is not None:
        # forward-reachability pruning for gradients(targets, inputs)
        reach = set(source_names)
        fwd_reachable = [False] * len(ops)
        for i, op in enumerate(ops):
            if any(n in reach for n in op.input_names()):
                fwd_reachable[i] = True
                reach.update(op.output_names())
        on_path = [a and b for a, b in zip(on_path, fwd_reachable)]
    return on_path, needed


def _emit_backward(
    block: Block,
    on_path: List[bool],
    needed: Set[str],
    no_grad_set: Set[str],
    seed_grads: Dict[str, str],
    force_grad: Optional[Set[str]] = None,
) -> _GradEmitter:
    """Emit grad ops in reverse program order. seed_grads maps target var ->
    the name of an already-materialized output gradient."""
    em = _GradEmitter(block, no_grad_set, force_grad)
    for var, gname in seed_grads.items():
        em.pending[var].append(gname)

    # snapshot of the forward ops only (ops appended after on_path was
    # computed — e.g. the loss-grad fill — are not part of the walk)
    fwd_ops = list(block.desc.ops)[: len(on_path)]
    for i in reversed(range(len(fwd_ops))):
        if not on_path[i]:
            continue
        op = fwd_ops[i]
        opdef = registry.get_op_def(op.type)

        out_grad_slots: Dict[str, List[str]] = {}
        any_out_grad = False
        for slot, names in op.outputs.items():
            gl = []
            for n in names:
                g = em.finalize(n) if n else None
                gl.append(g or "")
                any_out_grad = any_out_grad or bool(g)
            out_grad_slots[slot] = gl
        if not any_out_grad:
            continue

        in_grad_slots: Dict[str, List[str]] = {}
        any_in_grad = False
        for slot, names in op.inputs.items():
            if slot in opdef.nondiff_inputs:
                continue
            gl = []
            for n in names:
                want = bool(n) and n in needed and n not in no_grad_set
                if want:
                    v = block._find_var_recursive(n)
                    want = v is not None and _is_float_var(v.desc) and (
                        not v.desc.stop_gradient or n in em.force_grad)
                gl.append(em.new_grad_name(n) if want else "")
                any_in_grad = any_in_grad or want
            if any(gl):
                in_grad_slots[GRAD_PREFIX_IG + slot] = gl
        if not any_in_grad:
            continue

        grad_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            grad_inputs[GRAD_PREFIX_IN + slot] = list(names)
        for slot, names in op.outputs.items():
            grad_inputs[GRAD_PREFIX_OUT + slot] = list(names)
            grad_inputs[GRAD_PREFIX_OG + slot] = out_grad_slots[slot]

        gdesc = OpDesc(
            type=op.type + "_grad",
            inputs=grad_inputs,
            outputs=in_grad_slots,
            attrs={**{k: v for k, v in op.attrs.items() if k != OpRole.AttrName},
                   OpRole.AttrName: OpRole.Backward},
        )
        em._append_raw(gdesc)
    return em


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
    checkpoints: Optional[Sequence] = None,
) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for `loss` and return [(param, grad_var)]
    (reference: backward.py:933). `checkpoints` enables recompute segments
    (reference: backward.py:576) — handled by marking remat scopes, see
    optimizer.RecomputeOptimizer."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    on_path, needed = _find_op_path(block, {loss.name}, None, no_grad)

    # Seed: d loss / d loss = 1 (reference: backward.py _append_loss_ops_).
    loss_grad = grad_var_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)
    from .framework import Operator

    fill = OpDesc(
        type="fill_constant",
        inputs={},
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or (1,)), "value": 1.0,
               "dtype": loss.dtype, OpRole.AttrName: OpRole.Backward | OpRole.Loss},
    )
    block.desc.ops.append(fill)
    block.ops.append(Operator(block, fill))
    program._bump_version()

    em = _emit_backward(block, on_path, needed, no_grad, {loss.name: loss_grad})

    # Collect (param, grad) pairs.
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(str(p)) for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if getattr(p, "trainable", True)]
    result = []
    for p in params:
        g = em.finalize(p.name)
        if g is None:
            continue
        gvar = block._find_var_recursive(g)
        result.append((p, gvar))
    # op_role_var annotation for transpilers/DGC (reference: backward.py).
    for p, g in result:
        for opdesc in block.desc.ops:
            if g.name in opdesc.output_names() and opdesc.attrs.get(OpRole.AttrName) == OpRole.Backward:
                opdesc.attrs.setdefault(OpRole.OpRoleVarAttrName, []).extend([p.name, g.name])
    return result


def gradients(
    targets: Sequence[Variable] | Variable,
    inputs: Sequence[Variable] | Variable,
    target_gradients: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Optional[Variable]]:
    """Compute grads of targets w.r.t. inputs (reference: backward.py:1317)."""
    targets = [targets] if isinstance(targets, Variable) else list(targets)
    inputs = [inputs] if isinstance(inputs, Variable) else list(inputs)
    block = targets[0].block
    program = block.program
    no_grad = set(no_grad_set or ())

    force = {i.name for i in inputs}
    on_path, needed = _find_op_path(
        block, {t.name for t in targets}, force, no_grad, force_grad=force)
    needed.update(force)

    from .framework import Operator

    seed = {}
    for i, t in enumerate(targets):
        tg = None if target_gradients is None else target_gradients[i]
        gname = grad_var_name(t.name)
        k = 1
        while block._find_var_recursive(gname) is not None:
            k += 1
            gname = f"{grad_var_name(t.name)}@{k}"
        block.create_var(name=gname, shape=t.shape, dtype=t.dtype)
        if tg is None:
            fill = OpDesc(
                type="fill_constant", inputs={}, outputs={"Out": [gname]},
                attrs={"shape": list(t.shape or (1,)), "value": 1.0,
                       "dtype": t.dtype, OpRole.AttrName: OpRole.Backward},
            )
            block.desc.ops.append(fill)
            block.ops.append(Operator(block, fill))
            program._bump_version()
        else:
            gname = tg.name if isinstance(tg, Variable) else str(tg)
        seed[t.name] = gname

    em = _emit_backward(block, on_path, needed, no_grad, seed,
                        force_grad=force)
    out = []
    for i in inputs:
        g = em.finalize(i.name)
        out.append(block._find_var_recursive(g) if g else None)
    return out
