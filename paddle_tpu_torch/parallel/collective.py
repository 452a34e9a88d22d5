# Copied from the JAX package's paddle_tpu/parallel/collective.py; nothing else differs.

"""Program-IR collective transpilers.

Reference: python/paddle/fluid/transpiler/collective.py — `GradAllReduce`
(:178) appends c_allreduce_sum after each computed gradient; `LocalSGD`
(:269) snapshots params and periodically allreduces deltas. Here the
transpile inserts the same ops into the Program; they lower to lax.psum over
the 'dp' mesh axis when the program runs under shard_map
(core/compiler.py spmd mode), and are no-ops worth of GSPMD under plain
pjit (which inserts the reduction itself from shardings).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.framework import OpRole, Program


def _grad_outputs(program: Program) -> List[str]:
    """Gradient vars produced by backward-role ops, in production order."""
    grads = []
    seen = set()
    for op in program.global_block().ops:
        role = int(op.attrs.get(OpRole.AttrName, 0))
        if role & OpRole.Backward:
            for n in op.desc.output_names():
                if n.endswith("@GRAD") and n not in seen:
                    pv = n[: -len("@GRAD")]
                    v = program.global_block().vars.get(pv)
                    if v is not None and v.desc.is_parameter:
                        seen.add(n)
                        grads.append(n)
    return grads


class GradAllReduce:
    """Insert `scale(1/nranks)` + `c_allreduce_sum` after each param grad
    (reference: transpiler/collective.py:178-238)."""

    def __init__(self, nranks: Optional[int] = None, axis_name: str = "dp"):
        self.nranks = nranks
        self.axis_name = axis_name

    def transpile(self, program: Program, startup_program: Optional[Program] = None):
        block = program.global_block()
        grads = _grad_outputs(program)
        if not grads:
            return program
        # insertion point: before the first optimizer-role op
        ops = block.desc.ops
        insert_at = len(ops)
        for i, op in enumerate(ops):
            if int(op.attrs.get(OpRole.AttrName, 0)) & OpRole.Optimize:
                insert_at = i
                break
        from ..core.ir import OpDesc

        new_ops = []
        for g in grads:
            if self.nranks and self.nranks > 1:
                new_ops.append(OpDesc(
                    type="scale", inputs={"X": [g]}, outputs={"Out": [g]},
                    attrs={"scale": 1.0 / self.nranks,
                           OpRole.AttrName: OpRole.Backward}))
            new_ops.append(OpDesc(
                type="c_allreduce_sum", inputs={"X": [g]}, outputs={"Out": [g]},
                attrs={"axis_name": self.axis_name,
                       OpRole.AttrName: OpRole.Backward}))
        block.desc.ops[insert_at:insert_at] = new_ops
        program._rebuild_from_desc()
        return program


class LocalSGD:
    """Periodic parameter averaging (reference: transpiler/collective.py:269):
    every k steps params are allreduce-averaged instead of per-step grad
    sync, gated by a step counter inside a state-writing conditional
    (layers.cond_state)."""

    def __init__(self, nranks: Optional[int] = None, axis_name: str = "dp",
                 k_steps: int = 1):
        self.nranks = nranks
        self.axis_name = axis_name
        self.k_steps = max(1, int(k_steps))

    def transpile(self, program: Program, startup_program: Optional[Program] = None):
        from ..core.framework import program_guard, unique_name
        from ..core.ir import OpDesc
        from .. import layers as L
        from ..layers import control_flow, tensor as ltensor

        params = [p.name for p in program.all_parameters()]
        if not params:
            return program

        def _emit_averaging():
            block = program.current_block()
            for p in params:
                block.append_op(
                    type="c_allreduce_sum", inputs={"X": block.program.global_block().var(p)},
                    outputs={"Out": block.program.global_block().var(p)},
                    attrs={"axis_name": self.axis_name,
                           OpRole.AttrName: OpRole.Optimize})
                block.append_op(
                    type="scale", inputs={"X": block.program.global_block().var(p)},
                    outputs={"Out": block.program.global_block().var(p)},
                    attrs={"scale": 1.0 / (self.nranks or 1),
                           OpRole.AttrName: OpRole.Optimize})

        sp = startup_program
        from ..core import framework as fw

        guard_sp = sp if sp is not None else fw.default_startup_program()
        with program_guard(program, guard_sp):
            if self.k_steps == 1:
                _emit_averaging()
            else:
                step = ltensor.create_global_var(
                    [1], 0.0, "float32", persistable=True,
                    name=unique_name.generate("@LOCAL_SGD_STEP@"))
                program.global_block().append_op(
                    type="increment", inputs={"X": step},
                    outputs={"Out": step}, attrs={"step": 1.0})
                k = ltensor.fill_constant([1], "float32", float(self.k_steps))
                rem = program.global_block().create_var(
                    name=unique_name.generate("lsgd_rem"), shape=[1],
                    dtype="float32")
                program.global_block().append_op(
                    type="elementwise_mod", inputs={"X": step, "Y": k},
                    outputs={"Out": rem})
                pred = L.equal(rem, ltensor.fill_constant([1], "float32", 0.0))
                control_flow.cond_state(pred, _emit_averaging)
        return program
