"""Operator registry of the port: the JAX package's `core/registry.py`
with the same API, on torch.

* **Generic gradients.** The grad op of `foo` is `foo_grad`, whose kernel
  replays foo's forward kernel under `torch.enable_grad()` and takes
  `torch.autograd.grad` of it (the JAX package takes `jax.vjp`). It keeps
  that package's rules: only floating outputs take cotangents,
  `intermediate_outputs` are left out unless given a gradient, a
  cotangent is cast to its primal's dtype, a missing cotangent is zeros,
  and a requested gradient of a non-differentiable input is zeros. Under
  an outer replay (a `_grad_grad` op) it builds its graph
  (`create_graph`), so `gradients(gradients(y, x), x)` works.
* **Generic shape and dtype inference.** The kernel runs on
  `device="meta"` tensors (the JAX package's `jax.eval_shape`), with -1
  dims stood in by `_DYN_SENTINEL`.

Kernel signature: ``kernel(ins, attrs, ctx) -> outs``, ins and outs
mapping slot name -> list of tensors (a single tensor or None is
normalized). Kernels are functional: they return new tensors and never
write into an input, because a later `_grad` op replays the forward from
the same inputs.

An op the port has not registered still builds (the copied
`framework.py` lets unknown ops through, as it does structural ones) and
raises at `Executor.run`, naming itself and the ROADMAP item that ports
it: the parameter-server ops of the JAX package's `ops/distributed.py`
(`UNPORTED`), item 21.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import torch

from .ir import OpDesc, VarDesc, normalize_dtype

# The op types still to port, each with the ROADMAP item that ports it:
# the parameter-server ops of the JAX package's ops/distributed.py.
UNPORTED = {t: 21 for t in (
    "ps_send", "ps_send_aux", "ps_send_barrier", "ps_send_many",
    "ps_recv_many", "ps_recv", "distributed_lookup_table",
    "pull_box_sparse", "push_box_sparse", "listen_and_serv",
    "checkpoint_notify")}

# Sentinel used to stand in for -1 dims during meta-tensor inference.
# A distinctive prime so it never collides with a real computed dim.
_DYN_SENTINEL = 97

GRAD_PREFIX_IN = "fwd_in::"
GRAD_PREFIX_OUT = "fwd_out::"
GRAD_PREFIX_OG = "out_grad::"
GRAD_PREFIX_IG = "in_grad::"

_MASK64 = (1 << 64) - 1


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit seed from (seed, salt): splitmix64 of their sum, the
    port's `jax.random.fold_in`. Pure, so a replay draws the same
    stream."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(salt) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an IR dtype name ('float32', 'int64', ...)."""
    dt = getattr(torch, normalize_dtype(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype for {name!r}")
    return dt


def dtype_name(dtype: torch.dtype) -> str:
    """The IR dtype name of a torch dtype (torch.float32 -> 'float32')."""
    return str(dtype).rsplit(".", 1)[-1]


class KernelCtx:
    """Execution context handed to kernels (reference: ExecutionContext,
    framework/operator.h:231). `device` is where creation kernels put
    their outputs: the executor's place, or "meta" under inference."""

    def __init__(
        self,
        op: OpDesc,
        lower_block_fn: Optional[Callable] = None,
        rng_key: Optional[int] = None,
        is_test: bool = False,
        program=None,
        block_idx: int = 0,
        env: Optional[dict] = None,
        in_shape_inference: bool = False,
        device: Optional[torch.device] = None,
    ):
        self.op = op
        self._lower_block_fn = lower_block_fn
        self._rng_key = rng_key
        self.is_test = is_test
        self.program = program
        self.block_idx = block_idx
        self.env = env  # live name->value environment (control-flow ops)
        # True only under infer_op_outputs, where -1 dims are stood in by
        # _DYN_SENTINEL; kernels use this to relax static batch-size
        # checks that would trip on the sentinel.
        self.in_shape_inference = in_shape_inference
        if device is None:
            from .. import resolve_device

            device = resolve_device(None)
        self.device = torch.device(device)

    def rng(self) -> torch.Generator:
        """A fresh generator for this op, seeded from (step seed, the
        op's build-time `__rng_uid__`): a `_grad` op replaying the
        forward draws the same numbers. On the CPU when there is no step
        seed or the device is meta (shape inference)."""
        if self._rng_key is None or self.device.type == "meta":
            g = torch.Generator()
            g.manual_seed(0)
            return g
        uid = int(self.op.attrs.get("__rng_uid__", 0))
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(self._rng_key, uid))
        return g

    def lower_block(self, block_idx: int, env: Dict[str, Any]) -> Dict[str, Any]:
        """Run a sub-block (control flow) against `env`."""
        assert self._lower_block_fn is not None, "no sub-block lowering available"
        return self._lower_block_fn(block_idx, env, self)

    def requested_outputs(self) -> Set[str]:
        return {k for k, v in self.op.outputs.items() if any(v)}

    def child(self, op: OpDesc) -> "KernelCtx":
        return KernelCtx(
            op,
            lower_block_fn=self._lower_block_fn,
            rng_key=self._rng_key,
            is_test=self.is_test,
            program=self.program,
            block_idx=self.block_idx,
            env=self.env,
            in_shape_inference=self.in_shape_inference,
            device=self.device,
        )


class OpDef:
    def __init__(
        self,
        type: str,
        kernel: Callable,
        grad: Optional[str | Callable] = "generic",
        nondiff_inputs: Sequence[str] = (),
        infer_shape: Optional[Callable] = None,
        is_random: bool = False,
        default_attrs: Optional[Dict[str, Any]] = None,
        intermediate_outputs: Sequence[str] = (),
    ):
        self.type = type
        self.kernel = kernel
        self.grad = grad  # 'generic' | None | callable custom grad kernel
        self.nondiff_inputs = set(nondiff_inputs)
        self.custom_infer_shape = infer_shape
        self.is_random = is_random
        self.default_attrs = dict(default_attrs or {})
        self.intermediate_outputs = set(intermediate_outputs)

    def call(self, ins: Dict[str, List], attrs: Dict[str, Any], ctx: KernelCtx):
        merged = {**self.default_attrs, **attrs}
        outs = self.kernel(ins, merged, ctx)
        return normalize_outs(outs)

    def has_grad(self) -> bool:
        return self.grad is not None


def normalize_outs(outs) -> Dict[str, List]:
    if outs is None:
        return {}
    norm = {}
    for k, v in outs.items():
        if v is None:
            norm[k] = []
        elif isinstance(v, (list, tuple)):
            norm[k] = list(v)
        else:
            norm[k] = [v]
    return norm


_REGISTRY: Dict[str, OpDef] = {}
# the `*_grad` defs `get_op_def` synthesizes at their first lookup (not
# registered at import, so the live registry grows as programs are
# differentiated)
_MADE_AT_LOOKUP: set = set()


def register_op(
    type: str,
    grad: Optional[str | Callable] = "generic",
    nondiff_inputs: Sequence[str] = (),
    infer_shape: Optional[Callable] = None,
    is_random: bool = False,
    default_attrs: Optional[Dict[str, Any]] = None,
    intermediate_outputs: Sequence[str] = (),
):
    """Decorator registering a kernel (reference: REGISTER_OPERATOR,
    op_registry.h:199)."""

    def deco(fn):
        _REGISTRY[type] = OpDef(
            type,
            fn,
            grad=grad,
            nondiff_inputs=nondiff_inputs,
            infer_shape=infer_shape,
            is_random=is_random,
            default_attrs=default_attrs,
            intermediate_outputs=intermediate_outputs,
        )
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    if type in _REGISTRY:
        return _REGISTRY[type]
    if type.endswith("_grad"):
        base = type[: -len("_grad")]
        fwd = _REGISTRY.get(base)
        if fwd is None and base.endswith("_grad"):
            # second (or higher) order: `conv2d_grad_grad` is the
            # gradient of `conv2d_grad`, itself the gradient of `conv2d`
            try:
                fwd = get_op_def(base)
            except KeyError:
                fwd = None
        if fwd is not None and fwd.grad == "generic":
            # grad="generic" (not None) keeps the synthesized op itself
            # differentiable, enabling gradients(gradients(...)).
            gd = OpDef(type, make_generic_grad_kernel(fwd), grad="generic")
            _REGISTRY[type] = gd
            _MADE_AT_LOOKUP.add(type)
            return gd
        if fwd is not None and callable(fwd.grad):
            gd = OpDef(type, fwd.grad, grad="generic")
            _REGISTRY[type] = gd
            _MADE_AT_LOOKUP.add(type)
            return gd
    if type in UNPORTED:
        raise KeyError(
            f"operator '{type}' is not registered in paddle_tpu_torch: its "
            f"kernel is not ported yet (ROADMAP item {UNPORTED[type]})")
    raise KeyError(f"operator '{type}' is not registered in "
                   f"paddle_tpu_torch")


def has_op(type: str) -> bool:
    try:
        get_op_def(type)
        return True
    except KeyError:
        return False


def registered_ops(made_at_lookup: bool = True) -> List[str]:
    """The registered op types; with made_at_lookup=False only those
    registered at import, without the `*_grad` defs lookups made."""
    if made_at_lookup:
        return sorted(_REGISTRY)
    return sorted(t for t in _REGISTRY if t not in _MADE_AT_LOOKUP)


# ---------------------------------------------------------------------------
# Generic autograd-based gradient
# ---------------------------------------------------------------------------


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def make_generic_grad_kernel(fwd: OpDef) -> Callable:
    """Build the kernel for `<type>_grad` from the forward kernel.

    Grad-op slot convention (replaces the reference's GradOpDescMaker naming
    X / Out / Out@GRAD / X@GRAD, grad_op_desc_maker.h):
      inputs : fwd_in::<slot>, fwd_out::<slot>, out_grad::<slot>
      outputs: in_grad::<slot>
    """

    def grad_kernel(ins, attrs, ctx: KernelCtx):
        # under an outer replay (this op is itself being differentiated)
        # grad mode is on: build the graph so the outer pass sees it
        create_graph = torch.is_grad_enabled()
        fwd_ins: Dict[str, List] = {}
        out_grads: Dict[str, List] = {}
        inner_outs: Dict[str, List[str]] = {}
        for k, v in ins.items():
            if k.startswith(GRAD_PREFIX_IN):
                fwd_ins[k[len(GRAD_PREFIX_IN):]] = v
            elif k.startswith(GRAD_PREFIX_OG):
                out_grads[k[len(GRAD_PREFIX_OG):]] = v
            elif k.startswith(GRAD_PREFIX_OUT):
                # fwd_out:: values are not needed (the forward is
                # replayed) but their slot structure rebuilds the forward
                # op's outputs for the replay ctx below
                inner_outs[k[len(GRAD_PREFIX_OUT):]] = [
                    "_" if x is not None else "" for x in v]

        # Replay the forward under a ctx whose op LOOKS like the forward
        # op (type/attrs/outputs): kernels consult ctx.requested_outputs()
        # and ctx.rng(); with the grad op's ctx they would see in_grad::
        # slot names. This matters doubly for grad-of-grad, where fwd is
        # itself a generic grad kernel.
        inner_op = OpDesc(
            type=fwd.type,
            inputs={k: ["_" if x is not None else "" for x in v]
                    for k, v in fwd_ins.items()},
            outputs=inner_outs,
            attrs=dict(attrs),
        )
        replay_ctx = ctx.child(inner_op)

        requested = {
            k[len(GRAD_PREFIX_IG):]
            for k in ctx.requested_outputs()
            if k.startswith(GRAD_PREFIX_IG)
        }

        # Split differentiable vs. static inputs.
        diff_ins: Dict[str, List] = {}
        rest_ins: Dict[str, List] = {}
        for slot, vals in fwd_ins.items():
            if slot in fwd.nondiff_inputs or slot not in requested:
                rest_ins[slot] = vals
            else:
                d, r = [], []
                for x in vals:
                    (d if x is not None and _is_float(x) else r).append(x)
                if d and not r:
                    diff_ins[slot] = vals
                else:
                    rest_ins[slot] = vals

        with torch.enable_grad():
            # one graph input per slot entry: a tensor already in an outer
            # graph gets a view (so its gradient stays per slot), any
            # other a fresh leaf
            leaves = {slot: [x.view_as(x) if x.requires_grad
                             else x.detach().requires_grad_()
                             for x in vals]
                      for slot, vals in diff_ins.items()}
            outs = fwd.call({**rest_ins, **leaves}, attrs, replay_ctx)
            primal_out = {
                k: [o for o in v if o is not None and _is_float(o)]
                for k, v in outs.items()
                if k not in fwd.intermediate_outputs or k in out_grads
            }
            ys, cots = [], []
            for slot, vals in primal_out.items():
                given = out_grads.get(slot)
                for i, v in enumerate(vals):
                    g = (given[i] if given is not None and i < len(given)
                         else None)
                    if not v.requires_grad:
                        continue  # no path from a differentiable input
                    if g is None:
                        g = torch.zeros_like(v)
                    elif g.dtype != v.dtype:
                        # under a mixed policy the upstream grad may
                        # arrive at another float width than this op's
                        # forward computed in: the transpose of the cast
                        g = g.to(v.dtype)
                    ys.append(v)
                    cots.append(g)
            xs = [x for vals in leaves.values() for x in vals]
            if ys and xs:
                grads = list(torch.autograd.grad(
                    ys, xs, cots, allow_unused=True,
                    create_graph=create_graph))
            else:
                grads = [None] * len(xs)

        outs = {}
        it = iter(zip(xs, grads))
        for slot, vals in leaves.items():
            outs[GRAD_PREFIX_IG + slot] = [
                torch.zeros_like(x) if g is None else g
                for x, g in (next(it) for _ in vals)]
        # Requested grads for non-differentiable inputs come back as zeros.
        for slot in requested:
            if slot not in leaves and slot in fwd_ins:
                outs[GRAD_PREFIX_IG + slot] = [
                    torch.zeros_like(x) if x is not None else None
                    for x in fwd_ins[slot]
                ]
        return outs

    return grad_kernel


# ---------------------------------------------------------------------------
# Generic shape/dtype inference on meta tensors
# ---------------------------------------------------------------------------


class ShapeDtype(NamedTuple):
    """An inferred output: shape (-1 for a dynamic dim) and the IR dtype
    name, which `ir.normalize_dtype` returns unchanged."""

    shape: Tuple[int, ...]
    dtype: str


def infer_op_outputs(
    op: OpDesc,
    input_descs: Dict[str, VarDesc],
    lower_block_fn: Optional[Callable] = None,
    program=None,
) -> Dict[str, ShapeDtype]:
    """Infer output shapes/dtypes for `op` given input VarDescs.

    Returns {var_name: ShapeDtype}; -1 dims round-trip via a sentinel.
    """
    opdef = get_op_def(op.type)
    if opdef.custom_infer_shape is not None:
        return opdef.custom_infer_shape(op, input_descs)

    meta = torch.device("meta")
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                vals.append(None)
                continue
            d = input_descs[n]
            shape = tuple(_DYN_SENTINEL if s == -1 else s for s in (d.shape or ()))
            vals.append(torch.empty(shape, dtype=torch_dtype(d.dtype), device=meta))
        ins[slot] = vals

    ctx = KernelCtx(op, lower_block_fn=lower_block_fn, program=program,
                    in_shape_inference=True, device=meta)
    with torch.no_grad():
        outs = opdef.call(ins, op.attrs, ctx)

    result: Dict[str, ShapeDtype] = {}
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, n in enumerate(names):
            if not n:
                continue
            if i < len(vals) and vals[i] is not None:
                v = vals[i]
                shape = tuple(-1 if s == _DYN_SENTINEL else int(s) for s in v.shape)
                result[n] = ShapeDtype(shape, dtype_name(v.dtype))
    return result
