"""The eager tracer: the JAX package's `dygraph/tracer.py` on torch
autograd (reference: imperative/tracer.cc:45 Tracer::TraceOp runs the
kernel at once and records the grad graph; engine.cc's BasicEngine does
the reverse sweep).

Every dygraph op passes through `Tracer.trace_op`, which runs the op's
registry kernel once. When an input takes a gradient the kernel runs
under `torch.enable_grad()`, so autograd records the op as it runs, and
`run_backward` is `torch.autograd.backward`: one forward and no replay,
where the JAX package keeps a tape and replays each op's vjp. An op that
registers its own grad kernel (`lookup_table_v2`) runs inside a
`torch.autograd.Function` whose backward calls that `<op>_grad`.

The JAX tape's semantics are kept: `no_grad`, `stop_gradient` (an input
that stops the gradient enters the op detached; the flag is read when
the VarBase enters an op, where the JAX tape reads it at the sweep, so
set it before the VarBase is used), `retain_graph`, and a
gradient on every VarBase the sweep reaches (`retain_grad()` on every
recorded output), summed over backward calls until it is cleared. A
random op draws from a `torch.Generator` on its device seeded from
(`Tracer.seed`, the op's count); its gradient is autograd's of that one
forward, so it uses the forward's draw, where the JAX package's replay
draws anew (ROADMAP F18).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import registry
from ..core.ir import OpDesc
from ..core.registry import (GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG,
                             GRAD_PREFIX_OUT, KernelCtx, mix_seed)
from ..core.selected_rows import is_selected_rows
from .varbase import VarBase


def _own_grad_call(opdef, op_type, ins, attrs, ctx):
    """Run `opdef`, an op with its own grad kernel, as an autograd
    Function whose backward is that kernel (`<op>_grad`, called with the
    registry's fwd_in:: / fwd_out:: / out_grad:: slots)."""
    slots = list(ins)
    flat = [x for s in slots for x in ins[s]]
    spans, i = {}, 0
    for s in slots:
        spans[s] = (i, i + len(ins[s]))
        i += len(ins[s])
    layout = {}

    class OwnGrad(torch.autograd.Function):
        @staticmethod
        def forward(fctx, *xs):
            fins = {s: list(xs[a:b]) for s, (a, b) in spans.items()}
            outs = opdef.call(fins, attrs, ctx)
            res = []
            for s, vals in outs.items():
                idx = []
                for v in vals:
                    if isinstance(v, torch.Tensor):
                        idx.append(len(res))
                        res.append(v)
                    else:
                        idx.append(v)
                layout[s] = idx
            fctx.fins = {s: [x.detach() if isinstance(x, torch.Tensor)
                             else x for x in vals]
                         for s, vals in fins.items()}
            fctx.fouts = [r.detach() for r in res]
            return tuple(res)

        @staticmethod
        def backward(fctx, *gouts):
            gins: Dict[str, List] = {}
            for s, vals in fctx.fins.items():
                gins[GRAD_PREFIX_IN + s] = vals
            for s, idx in layout.items():
                gins[GRAD_PREFIX_OUT + s] = [
                    fctx.fouts[j] if isinstance(j, int) else None
                    for j in idx]
                gins[GRAD_PREFIX_OG + s] = [
                    gouts[j] if isinstance(j, int) else None for j in idx]
            want = {}
            for s, (a, b) in spans.items():
                names = ["g" if fctx.needs_input_grad[k] else ""
                         for k in range(a, b)]
                if any(names):
                    want[GRAD_PREFIX_IG + s] = names
            gdesc = OpDesc(type=op_type + "_grad", inputs={}, outputs=want,
                           attrs=dict(attrs))
            gctx = KernelCtx(gdesc, rng_key=ctx._rng_key,
                             is_test=ctx.is_test, device=ctx.device)
            gouts_ = registry.get_op_def(op_type + "_grad").call(
                gins, attrs, gctx)
            res = [None] * len(flat)
            for s, (a, b) in spans.items():
                got = gouts_.get(GRAD_PREFIX_IG + s)
                if got is None:
                    continue
                for k, g in zip(range(a, b), got):
                    if fctx.needs_input_grad[k] and g is not None:
                        res[k] = g.to_dense() if is_selected_rows(g) else g
            return tuple(res)

    res = OwnGrad.apply(*flat)
    return {s: [res[j] if isinstance(j, int) else j for j in idx]
            for s, idx in layout.items()}


class Tracer:
    def __init__(self):
        self._seed = 0
        self._draws = 0
        self._no_grad = False
        self.train_mode = True
        self._place = None

    def seed(self, s: int):
        self._seed = int(s)
        self._draws = 0

    def _next_key(self) -> int:
        key = mix_seed(self._seed, self._draws)
        self._draws += 1
        return key

    # -- place ---------------------------------------------------------------

    def set_place(self, place):
        self._place = place

    @property
    def place(self):
        return self._place

    @property
    def device(self) -> torch.device:
        """The dygraph place's device: CUDAPlace(0) when none was given,
        which raises on a machine without CUDA."""
        from ..core.places import default_place

        place = self._place if self._place is not None else default_place()
        return place.torch_device()

    # -- forward -------------------------------------------------------------

    def _input(self, v, slot, opdef, record, device):
        if isinstance(v, VarBase):
            t = v._value
            if not record or not t.is_floating_point():
                return t
            if v.stop_gradient or slot in opdef.nondiff_inputs:
                return t.detach() if t.requires_grad else t
            if not t.requires_grad:
                t.requires_grad_(True)      # a leaf: a parameter or input
            return t
        if v is None or isinstance(v, torch.Tensor):
            return v
        return torch.tensor(np.asarray(v), device=device)

    def trace_op(self, op_type: str, ins: Dict[str, List], outs: Dict[str, List],
                 attrs: Dict[str, Any]) -> Dict[str, List[VarBase]]:
        opdef = registry.get_op_def(op_type)
        # a bare VarBase is a one-element slot
        ins = {slot: (list(v) if isinstance(v, (list, tuple)) else [v])
               for slot, v in ins.items()}
        record = (not self._no_grad) and opdef.has_grad() and any(
            isinstance(v, VarBase) and not v.stop_gradient
            for vals in ins.values() for v in vals)
        # the op runs where its tensor inputs are, else on the place
        device = next((v._value.device for vals in ins.values() for v in vals
                       if isinstance(v, VarBase)), None) or self.device
        raw_ins = {slot: [self._input(v, slot, opdef, record, device)
                          for v in vals]
                   for slot, vals in ins.items()}
        desc = OpDesc(type=op_type, inputs={}, outputs={}, attrs=dict(attrs))
        ctx = KernelCtx(desc, rng_key=self._next_key(),
                        is_test=not self.train_mode, device=device)
        if record:
            with torch.enable_grad():
                if callable(opdef.grad):
                    raw_outs = _own_grad_call(opdef, op_type, raw_ins, attrs,
                                              ctx)
                else:
                    raw_outs = opdef.call(raw_ins, attrs, ctx)
        else:
            with torch.no_grad():
                raw_outs = opdef.call(raw_ins, attrs, ctx)
        outs = {slot: (list(v) if isinstance(v, (list, tuple)) else [v])
                for slot, v in (outs or {}).items()}
        out_vbs: Dict[str, List[VarBase]] = {}
        for slot, vals in raw_outs.items():
            placeholders = outs.get(slot, [])
            row: List[Optional[VarBase]] = []
            for i, v in enumerate(vals):
                if v is None:
                    row.append(None)
                    continue
                if isinstance(v, torch.Tensor) and v.grad_fn is not None:
                    v.retain_grad()
                if i < len(placeholders) and isinstance(placeholders[i], VarBase):
                    placeholders[i]._bind(v)
                    row.append(placeholders[i])
                else:
                    row.append(VarBase(v))
            out_vbs[slot] = row
        if not record:
            for vals in out_vbs.values():
                for v in vals:
                    if v is not None:
                        v.stop_gradient = True
        return out_vbs

    # -- backward ------------------------------------------------------------

    def run_backward(self, loss: VarBase, retain_graph=False):
        t = loss._value
        torch.autograd.backward(t, torch.ones_like(t),
                                retain_graph=retain_graph)


_TRACER: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER
