"""Program -> torch: the JAX package's `core/lowering.py`, run eagerly.

The JAX package traces a block into one jitted function; the port runs
the same block op by op on torch tensors (the reference's
framework/executor.cc:437 `for (op : ops) op->Run(scope, place)`).
Scope reads arrive in `env`, each op binds its outputs in `env`, and the
executor writes the state back: no kernel writes into a tensor it was
given, so a `_grad` op replaying a forward from `env` sees the forward's
own inputs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from . import precision as _precision
from . import registry
from .ir import OpDesc, ProgramDesc
from .registry import KernelCtx

# Ops handled by the executor itself, not run as kernels.
STRUCTURAL_OPS = {"feed", "fetch"}


class LoweringError(RuntimeError):
    pass


def lower_block(
    program_desc: ProgramDesc,
    block_idx: int,
    env: Dict[str, Any],
    rng_key: Optional[int] = None,
    is_test: bool = False,
    device: Optional[torch.device] = None,
) -> Dict[str, Any]:
    """Run every op of a block against `env` (name -> tensor) on
    `device`, with `rng_key` the step's seed.

    Mutates and returns env. Kernels for ops with sub-block attrs receive a
    ctx whose lower_block recursively invokes this.
    """
    block = program_desc.block(block_idx)

    def _lower_sub(sub_idx: int, sub_env: Dict[str, Any], ctx: KernelCtx):
        return lower_block(program_desc, sub_idx, sub_env, rng_key=rng_key,
                           is_test=is_test, device=ctx.device)

    for op in block.ops:
        if op.type in STRUCTURAL_OPS:
            continue
        run_op(op, env, program_desc, block_idx, _lower_sub, rng_key,
               is_test, device)
    return env


def run_op(
    op: OpDesc,
    env: Dict[str, Any],
    program_desc: Optional[ProgramDesc],
    block_idx: int,
    lower_sub: Optional[Callable],
    rng_key: Optional[int],
    is_test: bool,
    device: Optional[torch.device] = None,
    opdef: Optional[registry.OpDef] = None,
):
    """Run one op against `env` and bind its outputs there; `opdef`, when
    given, stands in for the registry's (a data-parallel run's
    per-rank form of a gradient, `core/lockstep.py`)."""
    opdef = opdef if opdef is not None else registry.get_op_def(op.type)
    ins: Dict[str, List] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            else:
                raise LoweringError(
                    f"op '{op.type}': input var '{n}' has no value (not fed, "
                    f"not in scope, and not produced by an earlier op)"
                )
        ins[slot] = vals
    # mixed-precision policies insert their casts here (white-list ops
    # take compute-dtype floats, black-list ops take f32); grad ops
    # inherit their forward op's class (core/precision.py)
    pol = _precision.active_autocast()
    if pol is not None:
        ins = _precision.autocast_op_inputs(op.type, ins, pol)
    ctx = KernelCtx(
        op,
        lower_block_fn=lower_sub,
        rng_key=rng_key,
        is_test=is_test or bool(op.attrs.get("is_test", False)),
        program=program_desc,
        block_idx=block_idx,
        env=env,
        device=device,
    )
    outs = opdef.call(ins, op.attrs, ctx)
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, n in enumerate(names):
            if not n:
                continue
            if i < len(vals) and vals[i] is not None:
                env[n] = vals[i]
    return env


def make_infer_lower_block_fn(program) -> Callable:
    """Sub-block callback used during meta-tensor shape inference."""

    def fn(sub_idx: int, sub_env: Dict[str, Any], ctx: KernelCtx):
        return lower_block(program.desc, sub_idx, sub_env, device=ctx.device)

    return fn


# ---------------------------------------------------------------------------
# Static analysis: which scope vars does a program read / write?
# ---------------------------------------------------------------------------


def analyze_state_vars(
    program_desc: ProgramDesc,
    feed_names: Set[str],
) -> Tuple[List[str], List[str]]:
    """Return (reads, writes): persistable/state vars the program reads from
    the scope before writing, and those it writes back.

    This is what turns scope mutation (reference: framework/scope.h) into
    explicit state threading.
    """
    persistable: Set[str] = set()
    for b in program_desc.blocks:
        for name, v in b.vars.items():
            if v.persistable:
                persistable.add(name)

    reads: List[str] = []
    writes: List[str] = []
    seen_read: Set[str] = set()
    seen_write: Set[str] = set()
    defined: Set[str] = set(feed_names)

    def visit(block_idx: int):
        block = program_desc.block(block_idx)
        for op in block.ops:
            if op.type in STRUCTURAL_OPS:
                continue
            for n in op.input_names():
                if n in persistable and n not in seen_write and n not in seen_read:
                    seen_read.add(n)
                    reads.append(n)
            for sub in op.sub_block_ids():
                visit(sub)
            for n in op.output_names():
                defined.add(n)
                if n in persistable and n not in seen_write:
                    seen_write.add(n)
                    writes.append(n)

    visit(0)
    return reads, writes


def collect_feed_fetch(program_desc: ProgramDesc) -> Tuple[List[str], List[str]]:
    """Names used by feed/fetch ops if the program carries them (reference
    injects feed/fetch ops into block 0; we also accept executor-side
    binding)."""
    feeds, fetches = [], []
    for op in program_desc.block(0).ops:
        if op.type == "feed":
            feeds.extend(op.output_names())
        elif op.type == "fetch":
            fetches.extend(op.input_names())
    return feeds, fetches
