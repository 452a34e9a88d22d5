# Copied from the JAX package: paddle_tpu/analysis/passes.py, with two
# wording changes that drop a change-number from the text; it runs over
# the port's op registry and shape inference.
"""The built-in analysis pass suite.

Each pass mirrors one class of late failure the executor/lowering stack
produces today and moves it to before-the-trace with an op/var-level
message (module docstring in __init__.py; per-defect examples in
ANALYSIS.md):

  def_use        — LoweringError("input var has no value") → error at
                   the op that reads it; dangling fetches → error.
  unsupported_op — registry KeyError mid-lowering → error naming the op
                   (with close-name suggestions).
  shape_dtype    — jax trace-time shape/dtype blowups → per-op re-run
                   of the generic eval_shape inference, checked against
                   the DECLARED output VarDescs (the reference's
                   InferShape analogue).
  dead_op        — ops whose outputs can never be observed (not
                   fetched, not persistable, never read downstream) and
                   vars nothing consumes.
  alias          — in-place/aliasing hazards: one op writing a var
                   twice, overwrites of fed vars, write-after-write
                   with no read between.
  precision      — programs whose declared dtypes contradict the
                   autocast white/black lists under bf16/mixed
                   policies (the silent-upcast audit).
"""

from __future__ import annotations

import difflib
from typing import Dict, List, Set, Tuple

from ..core import registry
from ..core.ir import OpDesc, VarDesc, normalize_dtype
from ..core.lowering import STRUCTURAL_OPS
from . import (ERROR, INFO, WARNING, AnalysisPass, Finding, PassContext,
               register_pass)

# Ops the executor interprets host-side or that exist for their side
# effects (RPC sends, barriers, prints): never "dead", never lowered by
# eval_shape.
SIDE_EFFECT_OPS = frozenset({
    "print", "listen_and_serv", "save", "save_combine",
})


def _is_side_effect(op_type: str) -> bool:
    return op_type in SIDE_EFFECT_OPS or op_type.startswith("ps_") \
        or op_type.startswith("c_")  # collectives mutate mesh state


def _attr_declared_names(op: OpDesc) -> Set[str]:
    """Var names a sub-block op binds into its inner env via attrs
    (carry_names / input_names / out_names ... — control_flow.py
    kernels build the sub-env from these string-list attrs)."""
    names: Set[str] = set()
    for v in op.attrs.values():
        if isinstance(v, str):
            names.add(v)
        elif isinstance(v, (list, tuple)) and all(
                isinstance(e, str) for e in v):
            names.update(v)
    return names


# ---------------------------------------------------------------------------
# def-before-use / dangling fetch
# ---------------------------------------------------------------------------


@register_pass
class DefBeforeUsePass(AnalysisPass):
    """Every op input must have a value when the op traces: a feed, a
    persistable scope var, or the output of an earlier op. The lowering
    equivalent failure is LoweringError deep inside the jit trace; here
    it is an error finding naming the op AND the var. Sub-block ops
    (control flow) bind extra names from their attrs and their kernels
    own the inner env, so inner-block violations report at warning
    severity — the outer walk cannot prove them fatal."""

    name = "def_use"

    def run(self, ctx: PassContext) -> List[Finding]:
        findings: List[Finding] = []
        persistable = ctx.persistable_names()
        feeds = ctx.all_feed_names()
        defined: Set[str] = set(feeds) | set(persistable)

        def visit(block_idx: int, defined: Set[str], strict: bool):
            block = ctx.program_desc.block(block_idx)
            for op_idx, op in enumerate(block.ops):
                if op.type == "feed":
                    defined.update(op.output_names())
                    continue
                for n in op.input_names():
                    if n not in defined:
                        findings.append(Finding(
                            severity=ERROR if strict else WARNING,
                            pass_name=self.name,
                            message=(
                                f"input var '{n}' has no value at this "
                                f"op: not fed, not persistable, and not "
                                f"produced by an earlier op"),
                            block_idx=block_idx, op_idx=op_idx,
                            op_type=op.type, var=n))
                subs = op.sub_block_ids()
                if subs:
                    inner = defined | _attr_declared_names(op)
                    for sub in subs:
                        visit(sub, set(inner), strict=False)
                defined.update(op.output_names())

        visit(0, defined, strict=True)
        # dangling fetches: executor raises "fetch var was not produced"
        # only after tracing the whole program; flag it statically
        for n in ctx.all_fetch_names():
            if n not in defined:
                findings.append(Finding(
                    severity=ERROR, pass_name=self.name,
                    message=(f"fetch var '{n}' is never produced: no op "
                             f"writes it and it is neither fed nor "
                             f"persistable"),
                    var=n))
        return findings


# ---------------------------------------------------------------------------
# unsupported op (fail fast with the NAME, not a lowering KeyError)
# ---------------------------------------------------------------------------


@register_pass
class UnsupportedOpPass(AnalysisPass):
    name = "unsupported_op"

    def run(self, ctx: PassContext) -> List[Finding]:
        findings: List[Finding] = []
        for bi, block in enumerate(ctx.program_desc.blocks):
            for oi, op in enumerate(block.ops):
                if op.type in STRUCTURAL_OPS:
                    continue
                if registry.has_op(op.type):
                    continue
                close = difflib.get_close_matches(
                    op.type, registry.registered_ops(), n=3)
                hint = f" (did you mean: {', '.join(close)}?)" \
                    if close else ""
                findings.append(Finding(
                    severity=ERROR, pass_name=self.name,
                    message=(f"op type '{op.type}' is not registered — "
                             f"lowering would fail{hint}"),
                    block_idx=bi, op_idx=oi, op_type=op.type))
        return findings


# ---------------------------------------------------------------------------
# shape/dtype inference walker (reference InferShape analogue)
# ---------------------------------------------------------------------------


@register_pass
class ShapeDtypePass(AnalysisPass):
    """Re-run the generic eval_shape inference per op, feeding each op
    the *inferred* descs of its upstream ops, and check the result
    against the DECLARED output VarDescs. Catches programs whose descs
    were mutated/hand-built/deserialized into inconsistency — exactly
    the mismatch that today dies mid-trace with a jax shape error.

    Skipped (documented limits): structural ops, sub-block (control
    flow) ops whose kernels own their env, grad ops (grad var shapes
    are the forward shapes by construction — core/backward.py), ops
    whose input shapes are undeclared, and unregistered ops (the
    unsupported_op pass already flagged those)."""

    name = "shape_dtype"

    def run(self, ctx: PassContext) -> List[Finding]:
        findings: List[Finding] = []
        inferred_descs: Dict[str, VarDesc] = {}
        block = ctx.program_desc.block(0)
        for oi, op in enumerate(block.ops):
            if op.type in STRUCTURAL_OPS or op.sub_block_ids() \
                    or op.type.endswith("_grad") \
                    or not registry.has_op(op.type):
                continue
            input_descs: Dict[str, VarDesc] = {}
            ok = True
            for n in op.input_names():
                d = inferred_descs.get(n) or ctx.find_var_desc(0, n)
                if d is None or d.shape is None:
                    ok = False  # def_use/undeclared: nothing to check
                    break
                input_descs[n] = d
            if not ok:
                continue
            try:
                out = registry.infer_op_outputs(
                    op, input_descs, program=ctx.program_desc)
            except (TypeError, ValueError) as e:
                findings.append(Finding(
                    severity=ERROR, pass_name=self.name,
                    message=(f"shape/dtype inference failed: "
                             f"{type(e).__name__}: {e}"),
                    block_idx=0, op_idx=oi, op_type=op.type))
                continue
            except Exception as e:
                findings.append(Finding(
                    severity=INFO, pass_name=self.name,
                    message=(f"could not statically infer "
                             f"({type(e).__name__}: {e}); skipped"),
                    block_idx=0, op_idx=oi, op_type=op.type))
                continue
            for name, sds in out.items():
                shape = tuple(int(s) for s in sds.shape)
                dtype = normalize_dtype(sds.dtype)
                declared = ctx.find_var_desc(0, name)
                if declared is not None and declared.shape is not None:
                    want = tuple(int(s) for s in declared.shape)
                    if want != shape:
                        findings.append(Finding(
                            severity=ERROR, pass_name=self.name,
                            message=(f"declared shape {list(want)} but "
                                     f"the op infers {list(shape)}"),
                            block_idx=0, op_idx=oi, op_type=op.type,
                            var=name))
                    if normalize_dtype(declared.dtype) != dtype:
                        findings.append(Finding(
                            severity=ERROR, pass_name=self.name,
                            message=(f"declared dtype "
                                     f"{normalize_dtype(declared.dtype)}"
                                     f" but the op infers {dtype}"),
                            block_idx=0, op_idx=oi, op_type=op.type,
                            var=name))
                inferred_descs[name] = VarDesc(
                    name=name, shape=shape, dtype=dtype)
        return findings


# ---------------------------------------------------------------------------
# dead ops / unused vars
# ---------------------------------------------------------------------------


@register_pass
class DeadOpPass(AnalysisPass):
    """Backward liveness over block 0: an op is live iff some output is
    observable (fetched or persistable) or feeds a live op; everything
    else is wasted trace/compile work (XLA DCEs it, but silently —
    usually it means a mis-specified fetch list). Warning severity:
    dead code is waste, not a wrong answer."""

    name = "dead_op"

    def run(self, ctx: PassContext) -> List[Finding]:
        findings: List[Finding] = []
        persistable = ctx.persistable_names()
        block = ctx.program_desc.block(0)
        live: Set[str] = set(ctx.all_fetch_names())
        consumed: Set[str] = set()
        for op in block.ops:
            consumed.update(op.input_names())
            if op.sub_block_ids():
                consumed.update(_attr_declared_names(op))
        for oi in reversed(range(len(block.ops))):
            op = block.ops[oi]
            if op.type in STRUCTURAL_OPS or _is_side_effect(op.type) \
                    or op.sub_block_ids():
                live.update(op.input_names())
                if op.sub_block_ids():
                    # sub-block kernels bind outer vars through string
                    # attrs (carry_names/input_names/...), not input
                    # slots — those reads keep their producers live
                    live.update(_attr_declared_names(op))
                continue
            outs = op.output_names()
            if not outs:
                live.update(op.input_names())  # side effect by shape
                continue
            if any(o in live or o in persistable for o in outs):
                live.update(op.input_names())
            else:
                findings.append(Finding(
                    severity=WARNING, pass_name=self.name,
                    message=(f"dead op: outputs "
                             f"{sorted(set(outs))} are never fetched, "
                             f"never persisted, and never read by a "
                             f"live op"),
                    block_idx=0, op_idx=oi, op_type=op.type))
        produced: Set[str] = set()
        for op in block.ops:
            produced.update(op.output_names())
        for name in block.vars:
            if name in consumed or name in persistable \
                    or name in ctx.all_feed_names() \
                    or name in ctx.all_fetch_names():
                continue
            if name not in produced:
                findings.append(Finding(
                    severity=INFO, pass_name=self.name,
                    message=("unused var: declared but never produced, "
                             "consumed, fed, or fetched"),
                    var=name))
        return findings


# ---------------------------------------------------------------------------
# in-place / aliasing hazards
# ---------------------------------------------------------------------------


@register_pass
class AliasPass(AnalysisPass):
    """The functional env makes sequential overwrites well-defined, but
    three aliasing shapes are still hazards: one op writing the same
    var from two output slots (one result silently lost — error), an op
    overwriting a FED var (the caller's input is shadowed mid-program —
    warning), and write-after-write with no read between (the first
    write is unobservable — warning; frequently a renamed-var bug)."""

    name = "alias"

    def run(self, ctx: PassContext) -> List[Finding]:
        findings: List[Finding] = []
        persistable = ctx.persistable_names()
        feeds = ctx.all_feed_names()
        fetches = set(ctx.all_fetch_names())
        block = ctx.program_desc.block(0)
        last_write: Dict[str, Tuple[int, str]] = {}
        read_since: Set[str] = set()
        for oi, op in enumerate(block.ops):
            if op.type in STRUCTURAL_OPS:
                continue
            for n in op.input_names():
                read_since.add(n)
            if op.sub_block_ids():
                # attr-declared bindings are reads the outer slots
                # don't show (same modeling as def_use/dead_op)
                read_since.update(_attr_declared_names(op))
            outs = op.output_names()
            seen: Set[str] = set()
            for n in outs:
                if n in seen:
                    findings.append(Finding(
                        severity=ERROR, pass_name=self.name,
                        message=(f"var '{n}' is written by two output "
                                 f"slots of the same op — one result "
                                 f"is silently lost"),
                        block_idx=0, op_idx=oi, op_type=op.type, var=n))
                seen.add(n)
                if n in feeds:
                    findings.append(Finding(
                        severity=WARNING, pass_name=self.name,
                        message=(f"op overwrites fed var '{n}' — later "
                                 f"ops read the rewritten value, not "
                                 f"the caller's feed"),
                        block_idx=0, op_idx=oi, op_type=op.type, var=n))
                prev = last_write.get(n)
                if prev is not None and n not in read_since \
                        and n not in persistable and n not in fetches:
                    findings.append(Finding(
                        severity=WARNING, pass_name=self.name,
                        message=(f"write-after-write: op "
                                 f"#{prev[0]} ({prev[1]}) wrote '{n}' "
                                 f"and nothing read it before this "
                                 f"rewrite — the first write is "
                                 f"unobservable"),
                        block_idx=0, op_idx=oi, op_type=op.type, var=n))
                last_write[n] = (oi, op.type)
                read_since.discard(n)
        return findings


# ---------------------------------------------------------------------------
# precision-policy audit (autocast white/black lists)
# ---------------------------------------------------------------------------


@register_pass
class PrecisionAuditPass(AnalysisPass):
    """Under a non-f32 policy, audit the program's declared dtypes
    against the autocast op classes (amp/fp16_lists):

    - mixed policies force black-list ops (reductions/norms/softmax) to
      f32 at trace time; a black-list op DECLARING a sub-f32 float
      output contradicts the program's own IR — downstream shape/dtype
      reasoning (and checkpoint manifests) would be wrong → error.
    - white-list ops fed declared float64 inputs silently downcast to
      the compute dtype → warning.
    - the pure bf16 policy has NO autocast: black-list ops run their
      reductions in bf16 → warning (use mixed_bf16 for f32 stats).

    A no-op under f32 (every in-repo model validates clean by
    default)."""

    name = "precision"

    _NARROW = ("bfloat16", "float16")

    def run(self, ctx: PassContext) -> List[Finding]:
        pol = ctx.policy
        if pol is None or pol.compute_dtype is None:
            return []
        from ..amp import fp16_lists

        white = fp16_lists.white_list
        black = fp16_lists.black_list
        findings: List[Finding] = []
        for bi, block in enumerate(ctx.program_desc.blocks):
            for oi, op in enumerate(block.ops):
                base = op.type
                while base.endswith("_grad"):
                    base = base[:-len("_grad")]
                if pol.op_autocast and base in black:
                    for n in op.output_names():
                        d = ctx.find_var_desc(bi, n)
                        if d is not None and \
                                normalize_dtype(d.dtype) in self._NARROW:
                            findings.append(Finding(
                                severity=ERROR, pass_name=self.name,
                                message=(
                                    f"black-list op declares "
                                    f"{normalize_dtype(d.dtype)} output "
                                    f"'{n}' but policy "
                                    f"'{pol.name}' computes it in "
                                    f"float32 — the declared IR dtype "
                                    f"contradicts the trace"),
                                block_idx=bi, op_idx=oi,
                                op_type=op.type, var=n))
                if pol.op_autocast and base in white:
                    for n in op.input_names():
                        d = ctx.find_var_desc(bi, n)
                        if d is not None and \
                                normalize_dtype(d.dtype) == "float64":
                            findings.append(Finding(
                                severity=WARNING, pass_name=self.name,
                                message=(
                                    f"white-list op input '{n}' is "
                                    f"declared float64; policy "
                                    f"'{pol.name}' downcasts it to "
                                    f"{pol.compute_dtype} — precision "
                                    f"silently lost"),
                                block_idx=bi, op_idx=oi,
                                op_type=op.type, var=n))
                if pol.cast_state and not pol.op_autocast \
                        and base in black:
                    findings.append(Finding(
                        severity=WARNING, pass_name=self.name,
                        message=(
                            f"reduction/norm op runs in "
                            f"{pol.compute_dtype} under the pure "
                            f"'{pol.name}' policy — its statistics "
                            f"lose precision; mixed_bf16 keeps "
                            f"black-list ops in f32"),
                        block_idx=bi, op_idx=oi, op_type=op.type))
        return findings
