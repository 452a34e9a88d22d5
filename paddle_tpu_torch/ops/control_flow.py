"""Control-flow ops of the fluid path: `cond` from the JAX package's
`ops/control_flow.py` (reference: operators/controlflow/
conditional_block_op.cc), which `layers.cond_state` emits, LocalSGD's
every-k gate among them. The JAX package traces both branches into
`lax.cond`; the port reads the predicate on the host and runs the one
branch. `while`, `while_v2` and `scan` are still to port (ROADMAP item
15).

Grad note, as there: outer vars a branch reads receive gradients only
through the op's "Input" slot (`input_names`).
"""

from __future__ import annotations

from ..core.registry import register_op


def block_idx(attrs, key):
    v = attrs[key]
    if isinstance(v, dict):
        return v["__block__"]
    return int(v)


def branch_env(ctx_env, attrs, operands):
    """The branch's environment: the enclosing one, with the op's
    "Input" operands bound to their in-block names."""
    env = dict(ctx_env or {})
    env.update(zip(list(attrs.get("input_names", [])), operands))
    return env


@register_op("cond", nondiff_inputs=("Cond",))
def cond_op(ins, attrs, ctx):
    """Two-branch conditional (replaces the reference's pair of
    conditional_block ops + select_input used by layers.cond). Under
    shape inference (meta tensors, no value to read) it runs the true
    branch: both branches produce the same shapes."""
    pred = ins["Cond"][0].reshape(())
    take_true = ctx.in_shape_inference or bool(pred)
    env = branch_env(ctx.env, attrs, list(ins.get("Input", [])))
    ctx.lower_block(block_idx(attrs, "true_block" if take_true
                              else "false_block"), env)
    return {"Out": [env[n] for n in attrs["out_names"]]}
