"""Dygraph-to-static tracing: the JAX package's `dygraph/jit.py`
(reference: dygraph/jit.py TracedLayer — run a dygraph Layer once under
instrumentation, record every executed op into a static Program, then
run, serve or save that program without Python's eager overhead).

Every dygraph op flows through `Tracer.trace_op`, so `TracedLayer.trace`
wraps it, lets each op run eagerly as usual, and records (op type, input
VarBases, output VarBases, attrs). The record is then replayed into a
fresh Program: the traced inputs become feed vars, the leaf VarBases
that are not inputs (parameters, captured constants) become persistable
vars whose values at trace time are copied into the traced layer's
scope, and the op descs are appended with shape inference.

The traced program runs on the place the trace ran on (`Executor` of
the dygraph place: the card unless the trace ran under a CPU guard),
where the JAX package runs it on `CPUPlace()`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import framework
from ..core.async_exec import to_numpy
from ..core.framework import Program, program_guard, unique_name
from ..core.registry import dtype_name
from .base import get_tracer
from .varbase import VarBase

__all__ = ["TracedLayer"]


class TracedLayer:
    def __init__(self, program: Program, feed_names: List[str],
                 fetch_names: List[str], captured: Dict[str, object],
                 place=None):
        from ..core.executor import Executor, Scope
        from ..core.places import default_place

        self._program = program
        self._feed_names = feed_names
        self._fetch_names = fetch_names
        self._scope = Scope()
        for name, value in captured.items():
            self._scope.set_var(name, value)
        self._place = place if place is not None else default_place()
        self._exe = Executor(self._place)

    @property
    def program(self) -> Program:
        return self._program

    @staticmethod
    def trace(layer, inputs: Sequence):
        """Run `layer(*inputs)` once, recording the executed ops.
        Returns (outputs, traced_layer) — the reference's signature."""
        inputs = [x if isinstance(x, VarBase) else VarBase(np.asarray(x))
                  for x in inputs]
        tracer = get_tracer()
        place = tracer.place
        records = []
        original = tracer.trace_op

        def recording(op_type, ins, outs, attrs):
            out_vbs = original(op_type, ins, outs, attrs)
            norm_ins = {s: (list(v) if isinstance(v, (list, tuple)) else [v])
                        for s, v in ins.items()}
            records.append((op_type, norm_ins, out_vbs, dict(attrs)))
            return out_vbs

        tracer.trace_op = recording
        try:
            outputs = layer(*inputs)
        finally:
            tracer.trace_op = original
        out_list = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]

        traced = TracedLayer._build(records, inputs, out_list, place)
        return outputs, traced

    @staticmethod
    def _build(records, inputs, out_list, place=None) -> "TracedLayer":
        # name every VarBase that participates; inputs feed, other leaves
        # (params/captured constants) persist with their snapshot values
        produced = set()
        for _, _, outs, _ in records:
            for vals in outs.values():
                for v in vals:
                    if v is not None:
                        produced.add(id(v))
        names: Dict[int, str] = {}
        captured: Dict[str, object] = {}
        program, startup = Program(), Program()

        saved_tracer = framework._get_dygraph_tracer()
        framework._set_dygraph_tracer(None)
        try:
            with unique_name.guard(), program_guard(program, startup):
                block = program.global_block()

                def var_of(v):
                    """The static Variable standing for VarBase/constant."""
                    if not isinstance(v, VarBase):
                        # raw (non-VarBase) op input: snapshot as a
                        # persistable constant
                        arr = to_numpy(v)
                        name = unique_name.generate("tl_const")
                        captured[name] = arr
                        return block.create_var(
                            name=name, shape=list(arr.shape),
                            dtype=str(arr.dtype), persistable=True)
                    vid = id(v)
                    if vid in names:
                        return block.var(names[vid])
                    name = getattr(v, "name", None) or \
                        unique_name.generate("tl_var")
                    if block.has_var(name):
                        name = unique_name.generate("tl_var")
                    names[vid] = name
                    t = v.value
                    leaf = vid not in produced
                    is_input = any(v is x for x in inputs)
                    if leaf and not is_input:
                        # parameter / closure value, as it is now
                        captured[name] = t.detach().clone()
                    return block.create_var(
                        name=name, shape=list(t.shape),
                        dtype=dtype_name(t.dtype),
                        persistable=bool(leaf and not is_input))

                feed_names = [var_of(x).name for x in inputs]
                for op_type, ins, outs, attrs in records:
                    in_vars = {s: [var_of(v) for v in vals if v is not None]
                               for s, vals in ins.items()}
                    out_vars = {s: [var_of(v) for v in vals
                                    if v is not None]
                                for s, vals in outs.items()}
                    block.append_op(type=op_type, inputs=in_vars,
                                    outputs=out_vars, attrs=attrs)
                fetch_names = []
                for o in out_list:
                    if id(o) not in names:
                        raise ValueError(
                            "traced output was not produced by any "
                            "recorded op — is it an input passed through "
                            "untouched?")
                    fetch_names.append(names[id(o)])
        finally:
            framework._set_dygraph_tracer(saved_tracer)
        return TracedLayer(program, feed_names, fetch_names, captured, place)

    def __call__(self, inputs: Sequence):
        from ..core.executor import scope_guard

        inputs = [x.value.detach() if isinstance(x, VarBase)
                  else np.asarray(x) for x in inputs]
        feed = dict(zip(self._feed_names, inputs))
        with scope_guard(self._scope), torch.no_grad():
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_names,
                                 return_numpy=False)
        return [VarBase(o) for o in outs]

    def save_inference_model(self, dirname: str,
                             feed: Optional[List[int]] = None,
                             fetch: Optional[List[int]] = None):
        """Persist the traced program + captured params as a standard
        inference model dir (loadable by both packages). `feed`/`fetch`
        are INDEX lists into the traced inputs/outputs (reference
        TracedLayer.save_inference_model signature)."""
        from .. import io as pt_io
        from ..core.executor import scope_guard

        feed_names = [self._feed_names[i] for i in (
            feed if feed is not None else range(len(self._feed_names)))]
        fetch_vars = [self._program.global_block().var(self._fetch_names[i])
                      for i in (fetch if fetch is not None
                                else range(len(self._fetch_names)))]
        with scope_guard(self._scope):
            pt_io.save_inference_model(dirname, feed_names, fetch_vars,
                                       self._exe,
                                       main_program=self._program)
