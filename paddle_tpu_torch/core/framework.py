# Copied from the JAX package: paddle_tpu/core/framework.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Python program-construction layer.

Mirrors the reference's python/paddle/fluid/framework.py (Variable :451,
Operator :1517, Block :1966, Program :3349) — the user-facing define-then-run
graph builder. Unlike the reference there is no C++ desc mirror: the dataclass
IR in core/ir.py *is* the single source of truth, and shape inference runs via
jax.eval_shape at append_op time (reference runs InferShape per op at build
and again at run time).
"""

from __future__ import annotations

import contextlib
import itertools
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from . import ir, registry
from .ir import BlockDesc, OpDesc, ProgramDesc, VarDesc, VarType, normalize_dtype


# ---------------------------------------------------------------------------
# Op roles (reference: framework.py OpRole / op_role attr, used by transpilers)
# ---------------------------------------------------------------------------


class OpRole:
    Forward = 0x0000
    Backward = 0x0001
    Optimize = 0x0002
    RPC = 0x0003
    Dist = 0x0004
    LRSched = 0x0010
    Loss = 0x0100
    OpRoleVarAttrName = "op_role_var"
    AttrName = "op_role"


_global_seed = 0


def set_global_seed(seed: int):
    global _global_seed
    _global_seed = seed


def global_seed() -> int:
    return _global_seed


# ---------------------------------------------------------------------------
# unique_name (reference: python/paddle/fluid/unique_name.py)
# ---------------------------------------------------------------------------


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: Dict[str, itertools.count] = defaultdict(lambda: itertools.count(0))

    def __call__(self, key: str) -> str:
        return f"{self.prefix}{key}_{next(self.ids[key])}"


class _UniqueNameModule:
    """Exposed as `paddle_tpu_torch.unique_name` with generate()/guard() parity."""

    def __init__(self):
        self.generator = UniqueNameGenerator()

    def generate(self, key: str) -> str:
        return self.generator(key)

    @contextlib.contextmanager
    def guard(self, new_generator: Optional[str] = None):
        old = self.generator
        self.generator = UniqueNameGenerator(new_generator or "")
        try:
            yield
        finally:
            self.generator = old


unique_name = _UniqueNameModule()


# ---------------------------------------------------------------------------
# Dygraph mode hook (tracer installed by paddle_tpu_torch.dygraph)
# ---------------------------------------------------------------------------

_dygraph_tracer = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer is not None


def _set_dygraph_tracer(tracer):
    global _dygraph_tracer
    _dygraph_tracer = tracer


def _get_dygraph_tracer():
    return _dygraph_tracer


# ---------------------------------------------------------------------------
# Variable / Parameter
# ---------------------------------------------------------------------------


class Variable:
    """Graph variable handle (reference: framework.py:451)."""

    def __init__(self, block: "Block", desc: VarDesc):
        self.block = block
        self.desc = desc

    # -- desc accessors ------------------------------------------------------
    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape) if self.desc.shape is not None else None

    @property
    def dtype(self) -> str:
        return self.desc.dtype

    @property
    def type(self) -> str:
        return self.desc.type

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v: bool):
        self.desc.persistable = v

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    def __repr__(self):
        return (
            f"Variable(name={self.name}, shape={self.shape}, dtype={self.dtype}, "
            f"persistable={self.persistable})"
        )

    __str__ = __repr__

    # -- sugar (operator overloads appended by layers.math_op_patch) ---------
    def astype(self, dtype):
        from .. import layers

        return layers.cast(self, dtype)


class Parameter(Variable):
    """Trainable persistable variable (reference: framework.py:4293)."""

    def __init__(self, block, desc, trainable=True, optimize_attr=None,
                 regularizer=None, do_model_average=False, need_clip=True):
        super().__init__(block, desc)
        desc.persistable = True
        desc.is_parameter = True
        self.trainable = trainable
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.regularizer = regularizer
        self.do_model_average = do_model_average
        self.need_clip = need_clip


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


def _names(v) -> List[str]:
    if v is None:
        return [""]
    if isinstance(v, (list, tuple)):
        return [_name1(x) for x in v]
    return [_name1(v)]


def _name1(v) -> str:
    if v is None:
        return ""
    if isinstance(v, Variable):
        return v.name
    if isinstance(v, str):
        return v
    raise TypeError(f"expected Variable or str, got {type(v)}")


class Operator:
    """Graph op handle (reference: framework.py:1517). Appending an op infers
    output shapes/dtypes immediately and fills in the output VarDescs."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type

    @property
    def attrs(self):
        return self.desc.attrs

    def attr(self, name):
        return self.desc.attrs.get(name)

    def set_attr(self, name, val):
        self.desc.attrs[name] = val
        # attr mutation changes compiled behavior — invalidate the
        # executor's compiled-step cache like every other mutation
        prog = getattr(self.block, "program", None)
        if prog is not None:
            prog._bump_version()

    _set_attr = set_attr  # reference-compat alias (framework.py Operator)

    def input(self, slot):
        return self.desc.inputs.get(slot, [])

    def output(self, slot):
        return self.desc.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return self.desc.input_names()

    @property
    def output_arg_names(self):
        return self.desc.output_names()

    def __repr__(self):
        return f"Operator(type={self.type}, inputs={self.desc.inputs}, outputs={self.desc.outputs})"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    """reference: framework.py:1966."""

    def __init__(self, program: "Program", desc: BlockDesc):
        self.program = program
        self.desc = desc
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def idx(self) -> int:
        return self.desc.idx

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.desc.parent_idx < 0:
            return None
        return self.program.block(self.desc.parent_idx)

    # -- vars ----------------------------------------------------------------

    def create_var(self, name: Optional[str] = None, shape=None, dtype="float32",
                   type: str = VarType.DENSE_TENSOR, persistable: bool = False,
                   stop_gradient: bool = False, **kw) -> Variable:
        if in_dygraph_mode():
            # eager mode: layers get a VarBase placeholder the tracer fills
            from ..dygraph.varbase import VarBase

            return VarBase(None, name=name, stop_gradient=stop_gradient)
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        desc = VarDesc(
            name=name,
            shape=tuple(shape) if shape is not None else None,
            dtype=normalize_dtype(dtype),
            type=type,
            persistable=persistable,
            stop_gradient=stop_gradient,
        )
        self.desc.vars[name] = desc
        v = Variable(self, desc)
        self.vars[name] = v
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         trainable=True, optimize_attr=None, regularizer=None,
                         do_model_average=False, need_clip=True, **kw) -> Parameter:
        # Parameters live in the *global* block (reference: Block.create_parameter
        # delegates to global block).
        gb = self.program.global_block()
        if name is None:
            name = unique_name.generate("_param")
        desc = VarDesc(name=name, shape=tuple(shape), dtype=normalize_dtype(dtype),
                       persistable=True, is_parameter=True, stop_gradient=False)
        gb.desc.vars[name] = desc
        p = Parameter(gb, desc, trainable=trainable, optimize_attr=optimize_attr,
                      regularizer=regularizer, do_model_average=do_model_average,
                      need_clip=need_clip)
        gb.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops -----------------------------------------------------------------

    def append_op(self, type: str, inputs: Optional[Dict] = None,
                  outputs: Optional[Dict] = None, attrs: Optional[Dict] = None,
                  stop_gradient: bool = False) -> Operator:
        if in_dygraph_mode():
            return _dygraph_tracer.trace_op(type, inputs or {}, outputs or {}, attrs or {})
        desc = self._make_op_desc(type, inputs, outputs, attrs)
        self._infer_and_fill(desc)
        op = Operator(self, desc)
        self.desc.ops.append(desc)
        self.ops.append(op)
        self.program._bump_version()
        if stop_gradient:
            for n in desc.output_names():
                v = self._find_var_recursive(n)
                if v is not None:
                    v.desc.stop_gradient = True
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        desc = self._make_op_desc(type, inputs, outputs, attrs)
        self._infer_and_fill(desc)
        op = Operator(self, desc)
        self.desc.ops.insert(0, desc)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def _make_op_desc(self, type, inputs, outputs, attrs) -> OpDesc:
        ins = {k: _names(v) for k, v in (inputs or {}).items()}
        outs = {k: _names(v) for k, v in (outputs or {}).items()}
        attrs = dict(attrs or {})
        if OpRole.AttrName not in attrs:
            attrs[OpRole.AttrName] = _current_op_role()
        try:
            opdef = registry.get_op_def(type)
            if opdef.is_random and "__rng_uid__" not in attrs:
                # per-Program counter: two identically-built programs with the
                # same random_seed replay identical random streams
                attrs["__rng_uid__"] = self.program._next_rng_uid()
        except KeyError:
            pass  # allow structural ops unknown to the registry (feed/fetch)
        return OpDesc(type=type, inputs=ins, outputs=outs, attrs=attrs)

    def _infer_and_fill(self, desc: OpDesc):
        """Run generic shape inference and fill output var descs."""
        if not registry.has_op(desc.type):
            return
        if desc.sub_block_ids():
            # control-flow op whose outputs were shaped by the layer: skip —
            # eval_shape would trace the sub-block, which may contain
            # collectives that only lower under shard_map
            outs = [n for n in desc.output_names() if n]
            if all((v := self._find_var_recursive(n)) is not None
                   and v.desc.shape is not None for n in outs):
                return
        input_descs: Dict[str, VarDesc] = {}
        for n in desc.input_names():
            v = self._find_var_recursive(n)
            if v is None:
                raise ValueError(f"op {desc.type}: input var '{n}' not found")
            input_descs[n] = v.desc
        from .lowering import make_infer_lower_block_fn

        inferred = registry.infer_op_outputs(
            desc, input_descs,
            lower_block_fn=make_infer_lower_block_fn(self.program),
            program=self.program,
        )
        for n, sds in inferred.items():
            v = self._find_var_recursive(n)
            if v is None:
                v = self.create_var(name=n)
            v.desc.shape = tuple(int(s) for s in sds.shape)
            v.desc.dtype = normalize_dtype(sds.dtype)

    def __repr__(self):
        lines = [f"Block(idx={self.idx}, parent={self.parent_idx})"]
        for v in self.vars.values():
            lines.append(f"  var {v.name}: {v.shape} {v.dtype}"
                         + (" persistable" if v.persistable else ""))
        for op in self.ops:
            lines.append(f"  op {op.type}: {op.desc.inputs} -> {op.desc.outputs}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    """reference: framework.py:3349."""

    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, self.desc.block(0))]
        self._current_block_idx = 0
        self.random_seed = 0
        self._is_test = False
        # arbitrary metadata bag (distributed strategies annotate here)
        self._attrs: Dict[str, Any] = {}
        self._version = 0  # bumped on every mutation → executor cache key
        self._rng_uid = itertools.count(1)

    def _next_rng_uid(self) -> int:
        return next(self._rng_uid)

    # -- blocks --------------------------------------------------------------

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        bdesc = self.desc.append_block(parent)
        b = Block(self, bdesc)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    # -- iteration helpers ---------------------------------------------------

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    # -- clone / prune / serialization ---------------------------------------

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.desc = self.desc.clone()
        p.random_seed = self.random_seed
        p._attrs = dict(self._attrs)
        p._rebuild_from_desc()
        if for_test:
            p._is_test = True
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs or op.type in _IS_TEST_OPS:
                        op.set_attr("is_test", True)
                    if op.type == "dropout":
                        op.set_attr("is_test", True)
        return p

    def _rebuild_from_desc(self):
        self.blocks = []
        for bdesc in self.desc.blocks:
            b = Block(self, bdesc)
            self.blocks.append(b)
        for b in self.blocks:
            for name, vdesc in b.desc.vars.items():
                if vdesc.is_parameter:
                    b.vars[name] = Parameter(b, vdesc)
                else:
                    b.vars[name] = Variable(b, vdesc)
            b.ops = [Operator(b, od) for od in b.desc.ops]
        self._current_block_idx = 0
        # resume uid allocation past any uid carried in the descs so random
        # ops appended after clone/deserialize don't replay existing streams
        max_uid = max((int(op.attrs.get("__rng_uid__", 0))
                       for b in self.desc.blocks for op in b.ops), default=0)
        self._rng_uid = itertools.count(max_uid + 1)
        self._version += 1

    def to_bytes(self) -> bytes:
        return self.desc.to_bytes()

    @staticmethod
    def parse_from_bytes(data: bytes) -> "Program":
        p = Program()
        p.desc = ProgramDesc.from_bytes(data)
        p._rebuild_from_desc()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    # mutation marker used by executor program cache
    def _bump_version(self):
        self._version += 1


_IS_TEST_OPS = {"dropout", "batch_norm", "layer_norm_stats"}


# ---------------------------------------------------------------------------
# Default programs + guards (reference: framework.py:4427, program_guard :4507)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()
_op_role_stack: List[int] = []


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_start = switch_startup_program(startup_program) if startup_program is not None else None
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)


def _current_op_role() -> int:
    return _op_role_stack[-1] if _op_role_stack else OpRole.Forward


@contextlib.contextmanager
def op_role_guard(role: int):
    _op_role_stack.append(role)
    try:
        yield
    finally:
        _op_role_stack.pop()


def grad_var_name(name: str) -> str:
    return ir.grad_var_name(name)
