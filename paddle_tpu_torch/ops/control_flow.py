"""Control-flow ops of the fluid path: the JAX package's
`ops/control_flow.py` (reference: operators/controlflow/
conditional_block_op.cc, while_op.cc, recurrent_op.cc), sub-blocks
run through `core/lowering.py`'s `_lower_sub`.

The JAX package traces sub-blocks into `lax.cond`, `lax.while_loop`
and `lax.scan`; the port runs them eagerly. `cond` and `select_input`
read their predicate or index on the host and run the one branch.
`while` and `while_v2` read the loop's predicate, a device tensor, on
the host once per iteration (a device sync each time round; shape
inference, which has no values, returns the carry as it came). They
are forward only, as the JAX ops are. `scan` runs its block once per
step and stacks the step outputs; its gradient is the generic one,
replaying the steps under autograd.

Grad note, as there: outer vars a sub-block reads receive gradients
only through the op's "Input" (`cond`) or "Extra" (`scan`) slot.
"""

from __future__ import annotations

import torch

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


@register_op("while", grad=None, nondiff_inputs=("Condition", "X"))
def while_op(ins, attrs, ctx):
    """reference: controlflow/while_op.cc. The loop carries every var the
    sub-block writes (attr carry_names), the condition var among them."""
    bidx = block_idx(attrs, "sub_block")
    carry_names = list(attrs["carry_names"])
    cond_name = attrs["cond_name"]
    env0 = dict(ctx.env or {})
    carry = [env0[n] for n in carry_names]
    if ctx.in_shape_inference:
        return {"Out": carry}
    pred = ins["Condition"][0]
    while bool(pred.reshape(())):          # a host read each time round
        env = dict(env0)
        env.update(zip(carry_names, carry))
        ctx.lower_block(bidx, env)
        carry = [env[n] for n in carry_names]
        pred = env[cond_name]
    return {"Out": carry}


@register_op("while_v2", grad=None, nondiff_inputs=("X", "Extra"))
def while_v2_op(ins, attrs, ctx):
    """The functional while of `layers.while_loop`: a cond and a body
    sub-block over an explicit carry."""
    cb = block_idx(attrs, "cond_block")
    bb = block_idx(attrs, "body_block")
    carry_names = list(attrs["carry_names"])
    pred_name = attrs["pred_name"]
    body_out_names = list(attrs["body_out_names"])
    env0 = dict(ctx.env or {})
    env0.update(zip(list(attrs.get("extra_names", [])),
                    list(ins.get("Extra", []))))

    def run_block(bidx, carry, out_names):
        env = dict(env0)
        env.update(zip(carry_names, carry))
        ctx.lower_block(bidx, env)
        return [env[n] for n in out_names]

    carry = list(ins["X"])
    if ctx.in_shape_inference:
        return {"Out": carry}
    while bool(run_block(cb, carry, [pred_name])[0].reshape(())):
        carry = run_block(bb, carry, body_out_names)
    return {"Out": carry}


@register_op("scan")
def scan_op(ins, attrs, ctx):
    """The sequence recurrence (reference: recurrent_op.cc, StaticRNN).
      SeqIn    : tensors [T, ...] sliced a step (in-block seq_names)
      InitState: the initial states (in-block state_names; the block
                 writes state_out_names each step)
      Extra    : captured tensors that take gradients (extra_names)
    Outputs: the steps' outs stacked [T, ...] (out_names), FinalState.
    With is_reverse the steps run from T - 1 down, and step t's outs
    still land at t."""
    bidx = block_idx(attrs, "sub_block")
    seq_names = list(attrs.get("seq_names", []))
    state_names = list(attrs.get("state_names", []))
    state_out_names = list(attrs.get("state_out_names", []))
    extra_names = list(attrs.get("extra_names", []))
    out_names = list(attrs.get("out_names", []))
    seqs = list(ins.get("SeqIn", []))
    carry = list(ins.get("InitState", []))
    env0 = dict(ctx.env or {})
    env0.update(zip(extra_names, list(ins.get("Extra", []))))
    steps = range(seqs[0].shape[0]) if seqs else range(0)
    if attrs.get("is_reverse", False):
        steps = reversed(steps)
    ys = {}
    for t in steps:
        env = dict(env0)
        env.update(zip(state_names, carry))
        env.update(zip(seq_names, [x[t] for x in seqs]))
        ctx.lower_block(bidx, env)
        carry = [env[n] for n in state_out_names]
        ys[t] = [env[n] for n in out_names]
    order = sorted(ys)
    return {"Out": [torch.stack([ys[t][i] for t in order])
                    for i in range(len(out_names))],
            "FinalState": carry}


@register_op("select_input", nondiff_inputs=("Mask",))
def select_input(ins, attrs, ctx):
    """X[Mask], the index read on the host and clamped into range as
    `lax.switch` clamps it (the first under shape inference)."""
    xs = ins["X"]
    if ctx.in_shape_inference:
        return {"Out": xs[0]}
    i = int(ins["Mask"][0].reshape(()))
    return {"Out": xs[min(max(i, 0), len(xs) - 1)]}


@register_op("assign_skip", grad=None)
def assign_skip(ins, attrs, ctx):
    return {"Out": ins["X"][0]}
