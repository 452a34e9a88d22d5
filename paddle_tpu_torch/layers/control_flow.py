# Copied from the JAX package: paddle_tpu/layers/control_flow.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Control-flow layers.

Reference: python/paddle/fluid/layers/control_flow.py — `cond`, `While`,
`StaticRNN`, switch/case, increments. Sub-blocks are built with
program._create_block() and lowered to lax.cond/while_loop/scan
(ops/control_flow.py). The LoD machinery (lod_rank_table, DynamicRNN,
array_to_lod_tensor) has no TPU equivalent — padded batches + `scan` with
masks replace it (SURVEY §5).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core import framework
from ..core.framework import Variable
from ..core.ir import OpDesc
from ..layer_helper import LayerHelper

__all__ = ["cond", "cond_state", "While", "while_loop", "StaticRNN",
           "increment", "array_write", "array_read", "array_length",
           "create_array", "less_than", "Switch", "case", "switch_case",
           "DynamicRNN", "IfElse"]


def _outer_reads(program, blocks, bound_names=()):
    """Names read by ops in `blocks` that are defined in an enclosing block
    (captured vars — passed explicitly so shape inference and grads work)."""
    reads: List[str] = []
    bound = set(bound_names)
    for blk in blocks:
        defined = set(bound)
        for op in blk.desc.ops:
            for n in op.input_names():
                if (n and n not in defined and n not in reads
                        and n not in blk.desc.vars
                        and program.global_block().has_var(n)):
                    reads.append(n)
            defined.update(op.output_names())
    return reads


def _collect_block(program, build_fn):
    """Run build_fn inside a fresh sub-block; return (block, returned vars)."""
    block = program._create_block()
    try:
        ret = build_fn()
    finally:
        program._rollback()
    if ret is None:
        rets = []
    elif isinstance(ret, (list, tuple)):
        rets = list(ret)
    else:
        rets = [ret]
    return block, rets


def cond(pred: Variable, true_fn: Callable, false_fn: Callable, name=None):
    """reference: layers/control_flow.py `cond` (pair of conditional_block
    ops + select_input) → one `cond` op lowered to lax.cond."""
    helper = LayerHelper("cond", name=name)
    program = helper.main_program

    true_block, true_outs = _collect_block(program, true_fn)
    false_block, false_outs = _collect_block(program, false_fn)
    if len(true_outs) != len(false_outs):
        raise ValueError("true_fn and false_fn must return the same number of outputs")

    out_names = []
    outs = []
    for tv, fv in zip(true_outs, false_outs):
        out = helper.create_variable_for_type_inference(tv.dtype)
        out.desc.shape = tv.desc.shape
        out_names.append(out.name)
        outs.append(out)

    # The op's out_names refer to in-branch var names; emit per-branch assigns
    # so both branches define the same output names.
    for blk, branch_outs in ((true_block, true_outs), (false_block, false_outs)):
        for out, bv in zip(outs, branch_outs):
            blk.desc.ops.append(
                OpDesc(type="assign", inputs={"X": [bv.name]},
                       outputs={"Out": [out.name]}))

    # Vars read by either branch that exist outside — passed as Input so
    # shape inference sees them and grads flow (ops/control_flow.py docstring).
    outer_reads = _outer_reads(program, (true_block, false_block))

    helper.append_op(
        type="cond",
        inputs={"Cond": pred,
                "Input": [program.global_block().var(n) for n in outer_reads]},
        outputs={"Out": outs},
        attrs={"true_block": {"__block__": true_block.idx},
               "false_block": {"__block__": false_block.idx},
               "input_names": outer_reads,
               "out_names": out_names})
    if len(outs) == 1:
        return outs[0]
    return outs


class While:
    """reference: layers/control_flow.py `While` — usage:
        w = While(cond_var)
        with w.block():
            ... ops writing loop vars and recomputing cond_var ...
    Forward-only (lax.while_loop); use StaticRNN/scan for differentiable
    recurrences."""

    def __init__(self, cond: Variable, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    class _BlockGuard:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            program = self.w.helper.main_program
            self.w._block = program._create_block()
            return self.w._block

        def __exit__(self, exc_type, *a):
            program = self.w.helper.main_program
            program._rollback()
            if exc_type is not None:
                return False
            blk = self.w._block
            carry = []
            for op in blk.desc.ops:
                for n in op.output_names():
                    if n and n not in carry and program.global_block().has_var(n):
                        carry.append(n)
            if self.w.cond_var.name not in carry:
                raise ValueError("While block must update the condition variable")
            outs = [program.global_block().var(n) for n in carry]
            self.w.helper.append_op(
                type="while",
                inputs={"Condition": self.w.cond_var, "X": outs},
                outputs={"Out": outs},
                attrs={"sub_block": {"__block__": blk.idx},
                       "carry_names": carry,
                       "cond_name": self.w.cond_var.name})
            return False

    def block(self):
        return While._BlockGuard(self)


def cond_state(pred: Variable, build_fn: Callable, name=None):
    """Run `build_fn`'s ops only when `pred` is true, with writes to
    enclosing-block variables PERSISTING (the reference's
    conditional_block_op writes into the outer scope,
    controlflow/conditional_block_op.cc). The gate behind periodic behaviors:
    gradient merge, LocalSGD's every-k sync, EMA/ModelAverage windows.
    """
    helper = LayerHelper("cond_state", name=name)
    program = helper.main_program

    true_block, _ = _collect_block(program, build_fn)

    # every enclosing-block var the branch writes must round-trip through
    # cond outputs (branch env is isolated, ops/control_flow.py)
    written: List[str] = []
    for op in true_block.desc.ops:
        for n in op.output_names():
            if n and n not in written and program.global_block().has_var(n):
                written.append(n)
    if not written:
        return

    outs = []
    out_names = []
    for n in written:
        v = program.global_block().var(n)
        out = helper.create_variable_for_type_inference(v.dtype)
        out.desc.shape = v.desc.shape
        outs.append(out)
        out_names.append(out.name)

    # true branch: forward the written values; false branch: originals
    false_block = program._create_block()
    program._rollback()
    for blk in (true_block, false_block):
        for n, out in zip(written, outs):
            blk.desc.ops.append(OpDesc(type="assign", inputs={"X": [n]},
                                       outputs={"Out": [out.name]}))

    outer_reads = _outer_reads(program, (true_block, false_block))
    helper.append_op(
        type="cond",
        inputs={"Cond": pred,
                "Input": [program.global_block().var(n) for n in outer_reads]},
        outputs={"Out": outs},
        attrs={"true_block": {"__block__": true_block.idx},
               "false_block": {"__block__": false_block.idx},
               "input_names": outer_reads,
               "out_names": out_names})
    # write results back onto the original names
    from .tensor import assign

    for n, out in zip(written, outs):
        assign(out, program.global_block().var(n))


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while (reference: layers/control_flow.py while_loop) —
    `cond(*loop_vars) -> bool Variable`, `body(*loop_vars) -> new loop vars`.
    Lowered to lax.while_loop via the `while_v2` op (forward-only, like the
    reference's while without grad)."""
    helper = LayerHelper("while_loop", name=name)
    program = helper.main_program
    if not loop_vars:
        raise ValueError("loop_vars must be non-empty")

    cond_block, cond_outs = _collect_block(program, lambda: cond(*loop_vars))
    if len(cond_outs) != 1:
        raise ValueError("cond must return a single boolean Variable")
    body_block, body_outs = _collect_block(program, lambda: body(*loop_vars))
    if len(body_outs) != len(loop_vars):
        raise ValueError("body must return as many vars as loop_vars")

    carry_names = [v.name for v in loop_vars]
    extra_names = _outer_reads(program, (cond_block, body_block),
                               bound_names=carry_names)
    extra_vars = [program.global_block().var(n) for n in extra_names]

    outs = []
    for v in loop_vars:
        out = helper.create_variable_for_type_inference(v.dtype)
        out.desc.shape = v.desc.shape
        outs.append(out)

    helper.append_op(
        type="while_v2",
        inputs={"X": list(loop_vars), "Extra": extra_vars},
        outputs={"Out": outs},
        attrs={"cond_block": {"__block__": cond_block.idx},
               "body_block": {"__block__": body_block.idx},
               "carry_names": carry_names,
               "extra_names": extra_names,
               "pred_name": cond_outs[0].name,
               "body_out_names": [v.name for v in body_outs]})
    return outs


class StaticRNN:
    """reference: layers/control_flow.py `StaticRNN` (recurrent_op) — lowered
    to one differentiable `scan` op (lax.scan).

    Usage:
        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x_TND)          # slice along time (axis 0)
            h_prev = rnn.memory(init=h0)          # loop-carried state
            h = some_layers(x_t, h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        outs = rnn()                              # [T, N, D] stacked
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._seq_inputs = []      # (outer var, in-block var)
        self._memories = []        # (in-block prev var, init var, updated name)
        self._outputs = []         # in-block vars
        self._extras = []          # (outer var, in-block name)
        self._block = None
        self._result_vars = None

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            self.rnn._block = self.rnn.helper.main_program._create_block()
            return self.rnn

        def __exit__(self, exc_type, *a):
            self.rnn.helper.main_program._rollback()
            if exc_type is None:
                self.rnn._complete()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    def step_input(self, x: Variable) -> Variable:
        blk = self.rnn_block()
        v = blk.create_var(shape=x.shape[1:], dtype=x.dtype)
        self._seq_inputs.append((x, v))
        return Variable(blk, v.desc) if not isinstance(v, Variable) else v

    def rnn_block(self):
        return self._block

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref=None, init_value=0.0, dtype="float32") -> Variable:
        if init is None:
            from .tensor import fill_constant

            # build init in the *outer* block
            program = self.helper.main_program
            cur = program._current_block_idx
            program._current_block_idx = self._block.parent_idx
            try:
                init = fill_constant(shape, dtype, init_value)
            finally:
                program._current_block_idx = cur
        blk = self._block
        prev = blk.create_var(shape=init.shape, dtype=init.dtype)
        self._memories.append([prev, init, None])
        return prev

    def update_memory(self, mem: Variable, var: Variable):
        for m in self._memories:
            if m[0].name == mem.name:
                m[2] = var.name
                return
        raise ValueError(f"unknown memory {mem.name}")

    def step_output(self, o: Variable):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        program = self.helper.main_program
        for m in self._memories:
            if m[2] is None:
                raise ValueError("memory never updated — call update_memory")
        seq_outer = [x for x, _ in self._seq_inputs]
        seq_names = [v.name for _, v in self._seq_inputs]
        init_vars = [m[1] for m in self._memories]
        state_names = [m[0].name for m in self._memories]
        state_out_names = [m[2] for m in self._memories]
        out_names = [o.name for o in self._outputs]

        # params read inside the block get grads via Extra
        extra_names = _outer_reads(program, (self._block,),
                                   bound_names=seq_names + state_names)
        extra_vars = [program.global_block().var(n) for n in extra_names]

        results = []
        finals = []
        for o in self._outputs:
            v = self.helper.create_variable_for_type_inference(o.dtype)
            results.append(v)
        for m in self._memories:
            v = self.helper.create_variable_for_type_inference(m[1].dtype)
            finals.append(v)
        self.helper.append_op(
            type="scan",
            inputs={"SeqIn": seq_outer, "InitState": init_vars, "Extra": extra_vars},
            outputs={"Out": results, "FinalState": finals},
            attrs={"sub_block": {"__block__": self._block.idx},
                   "seq_names": seq_names, "state_names": state_names,
                   "state_out_names": state_out_names,
                   "extra_names": extra_names, "out_names": out_names})
        self._result_vars = results

    def __call__(self):
        if len(self._result_vars) == 1:
            return self._result_vars[0]
        return self._result_vars


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    from .ops import less_than as _lt

    return _lt(x, y, cond)


# -- tensor arrays: static-shape stand-ins ---------------------------------

def create_array(dtype):
    raise NotImplementedError(
        "LoDTensorArray has no static-shape TPU equivalent; use StaticRNN "
        "(lax.scan) whose outputs are stacked [T, ...] tensors")


array_write = array_read = array_length = create_array


class Switch:
    """reference: layers/control_flow.py `Switch` — built on nested cond."""

    def __init__(self, name=None):
        raise NotImplementedError("use layers.case / layers.cond")


def case(pred_fn_pairs, default=None):
    """Nested lax.cond chain."""
    if not pred_fn_pairs:
        raise ValueError("empty pred_fn_pairs")
    (pred, fn), rest = pred_fn_pairs[0], pred_fn_pairs[1:]
    if rest or default:
        return cond(pred, fn, (lambda: case(rest, default)) if rest else default)
    return cond(pred, fn, default)


def switch_case(branch_index, branch_fns, default=None):
    from .ops import equal as _eq
    from .tensor import fill_constant

    pairs = []
    for idx, fn in (branch_fns.items() if isinstance(branch_fns, dict) else enumerate(branch_fns)):
        c = _eq(branch_index, fill_constant([1], branch_index.dtype, idx))
        pairs.append((c, fn))
    return case(pairs, default)


class DynamicRNN:
    """reference: layers/control_flow.py `DynamicRNN` — RNN over
    variable-length sequences. The reference batches LoD sequences by
    sorted length (LoDRankTable + shrink-memory); TPU-native this is the
    padded-batch + lengths design (SURVEY §5): step over [N, T, D] padded
    input, HOLD each row's memory once t >= length, and zero padded
    output steps. Built on StaticRNN's scan, so it stays one
    differentiable lax.scan.

    Usage:
        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, lengths)   # x [N, T, D]
            h = drnn.memory(shape=[H], value=0.0)
            h2 = some_layers(x_t, h)
            drnn.update_memory(h, h2)
            drnn.output(h2)
        out = drnn()                            # [N, T, H], padded zeros
    """

    def __init__(self, name=None):
        self._rnn = StaticRNN(name=name)
        self._lengths = None
        self._t = None          # in-block step index [1]
        self._batch_ref = None

    def block(self):
        return self._rnn.step()

    def _outer_block(self):
        """Context manager: emit ops into the block ENCLOSING the rnn
        step block (outer vars are built there)."""
        import contextlib

        program = self._rnn.helper.main_program
        parent = self._rnn._block.parent_idx

        @contextlib.contextmanager
        def guard():
            cur = program._current_block_idx
            program._current_block_idx = parent
            try:
                yield
            finally:
                program._current_block_idx = cur

        return guard()

    def _ensure_time_index(self, T):
        if self._t is not None:
            return
        with self._outer_block():
            helper = LayerHelper("drnn_time")
            trange = helper.create_variable_for_type_inference("int64")
            helper.append_op(
                type="assign_value", inputs={}, outputs={"Out": trange},
                attrs={"shape": [int(T), 1],
                       "values": list(range(int(T))),
                       "dtype": "int64"})
        self._t = self._rnn.step_input(trange)  # [1] per step

    def step_input(self, x, lengths=None):
        """x [N, T, D...] batch-major padded; lengths [N] optional."""
        from .nn import transpose

        # the transpose consumes an OUTER var — emit it in the outer block
        with self._outer_block():
            perm = [1, 0] + list(range(2, len(x.shape)))
            xt = transpose(x, perm=perm)        # [T, N, ...]
        self._ensure_time_index(x.shape[1])
        if lengths is not None and self._lengths is None:
            self._lengths = lengths
        self._batch_ref = x
        return self._rnn.step_input(xt)

    def static_input(self, x):
        return self._rnn.static_input(x) if hasattr(
            self._rnn, "static_input") else x

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        if init is not None:
            return self._rnn.memory(init=init)
        if self._batch_ref is None:
            raise ValueError(
                "DynamicRNN.memory(shape=...) needs the batch size from a "
                "prior step_input — call drnn.step_input(x) first "
                "(the reference raises the same way)")
        # batch dim is dynamic: build the init in the OUTER block with
        # fill_constant_batch_size_like against the step input
        with self._outer_block():
            from .tensor import fill_constant_batch_size_like

            init = fill_constant_batch_size_like(
                self._batch_ref, [-1] + [int(s) for s in shape], dtype,
                float(value))
        return self._rnn.memory(init=init)

    def update_memory(self, ex_mem, new_mem):
        """Hold the memory for rows whose sequence already ended."""
        if self._lengths is None:
            self._rnn.update_memory(ex_mem, new_mem)
            return
        from .nn import reshape, where

        helper = self._rnn.helper
        active = helper.create_variable_for_type_inference("bool")
        helper.append_op(
            type="less_than",
            inputs={"X": self._t, "Y": self._lengths},
            outputs={"Out": active})
        active2d = reshape(active, shape=[-1] + [1] * (
            len(new_mem.shape) - 1))
        # broadcast the row mask over the feature dims
        held = where(_broadcast_like(active2d, new_mem), new_mem, ex_mem)
        self._rnn.update_memory(ex_mem, held)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self):
        from .nn import transpose

        res = self._rnn()
        outs = res if isinstance(res, (list, tuple)) else [res]
        fixed = []
        for o in outs:
            perm = [1, 0] + list(range(2, len(o.shape)))
            ob = transpose(o, perm=perm)        # [N, T, ...]
            if self._lengths is not None:
                ob = _mask_after_length(ob, self._lengths)
            fixed.append(ob)
        return fixed[0] if len(fixed) == 1 else fixed


def _broadcast_like(cond, ref):
    """Expand a [N,1,..] bool mask to ref's shape with expand."""
    from .nn import expand

    times = [1] + [int(s) for s in ref.shape[1:]]
    return expand(cond, expand_times=times)


def _mask_after_length(x, lengths):
    """Zero x [N, T, ...] rows past each row's length."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("drnn_mask")
    mask = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_mask",
                     inputs={"X": lengths}, outputs={"Y": mask},
                     attrs={"maxlen": int(x.shape[1]),
                            "out_dtype": str(x.dtype)})
    m = mask
    from .nn import reshape

    m = reshape(m, shape=[int(x.shape[0] or -1), int(x.shape[1])] +
                [1] * (len(x.shape) - 2))
    helper2 = LayerHelper("drnn_apply_mask")
    out = helper2.create_variable_for_type_inference(x.dtype)
    helper2.append_op(type="elementwise_mul", inputs={"X": x, "Y": m},
                      outputs={"Out": out}, attrs={"axis": -1})
    return out


class IfElse:
    """reference: layers/control_flow.py `IfElse` — row-wise conditional:
    rows where cond holds flow through the true branch, the rest through
    the false branch, outputs merged back in order. The reference
    physically splits/merges LoD rows (split_lod_tensor/merge_lod_tensor
    ops); TPU-native both branches run DENSE over the full batch and the
    merge is a row-select — identical semantics for side-effect-free
    branches and no dynamic shapes.

    Usage:
        ie = IfElse(cond)                  # cond [N, 1] bool
        with ie.true_block():
            ie.output(f(ie.input(x)))
        with ie.false_block():
            ie.output(g(ie.input(x)))
        merged, = ie()
    """

    def __init__(self, cond, name=None):
        self._cond = cond
        self._outs = {True: [], False: []}
        self._branch = None

    class _Branch:
        def __init__(self, ie, val):
            self.ie, self.val = ie, val

        def __enter__(self):
            self.ie._branch = self.val
            return self.ie

        def __exit__(self, *a):
            self.ie._branch = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        assert self._branch is not None, "input() outside a branch block"
        return x

    def output(self, *outs):
        assert self._branch is not None, "output() outside a branch block"
        self._outs[self._branch].extend(outs)

    def __call__(self):
        from .nn import expand, reshape, where

        t, f = self._outs[True], self._outs[False]
        assert len(t) == len(f), (
            f"IfElse branches produced {len(t)} vs {len(f)} outputs")
        merged = []
        for tv, fv in zip(t, f):
            cond = reshape(self._cond,
                           shape=[-1] + [1] * (len(tv.shape) - 1))
            times = [1] + [int(s) for s in tv.shape[1:]]
            merged.append(where(expand(cond, expand_times=times), tv, fv))
        return merged
