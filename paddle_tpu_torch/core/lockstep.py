"""Run a fluid Program on every rank of an in-process dp ring, op by op
in lockstep: the runtime under `CompiledProgram.with_data_parallel`
(`core/compiler.py`) and `SPMDRunner` (`parallel/spmd_executor.py`).

The JAX package runs either as one XLA computation over a device mesh.
The port holds one environment (name -> tensor) a rank, all on one
device, and runs each op for every rank before the next op, so a
collective sees every rank's input at once, in a `cond` branch too. An
op whose inputs are the same tensors on every rank runs once and hands
its outputs to all of them (a random op in SPMD mode runs per rank:
each draws its own stream).

Two modes:

- **SPMD** (`SPMDRunner`, the JAX package's `shard_map` with the dp
  axis manual): each rank runs the program on its shard as if alone,
  and the ranks meet only at the `c_*` ops (`ops/collective.py`,
  `COLLECTIVES`) over the axis the runner is on.
- **GSPMD** (`CompiledProgram`, the JAX package's one jit over the
  whole batch sharded on dim 0): a step must give the numbers of one
  step over the whole batch while each rank computes on its own rows.
  "Split on dim 0" propagates from the feeds, and three rules hold:
  (a) an op that reduces a split input over the batch dim (`mean`,
  `reduce_*` over dim 0 or all, `accuracy`'s counts) takes the global
  sum and count through the ring; (b) its gradient uses the global
  count: it replays a per-rank partial of the op whose gradient is the
  global one's (the local mean times n_r / N, say); (c) the gradient of
  a replicated input computed from split ones (`mul`'s and `conv2d`'s
  weights, a bias) is a partial sum, all-reduced as soon as it is made.
  `dropout` takes each rank's rows of the whole batch's mask, so it
  drops what the one step over the whole batch drops. `batch_norm` (and
  `sync_batch_norm`) in training takes the whole batch's mean and mean
  of squares from the ranks' all-reduced sums, and its gradient the
  whole batch's sums of the cotangent's terms through them (the JAX
  package's batch norm is sync-BN under GSPMD, `ops/nn.py:379`). A
  shape op is a row op only while dim 0 stays the batch. (d) Any other
  op with a split input (a shape op that moves or mixes dim 0, a
  softmax or top_k over it, `kron`, `bmm`, `instance_norm` on a batch
  of 1 a rank, a normalizing or reducing loss, a control-flow op, ...)
  gathers: each split input is joined over the ranks in rank order,
  the op runs once over the whole batch, and every rank gets its
  outputs, an output whose dim 0 is a split input's whole batch split
  again by the ranks' rows, any other whole. Its gradient op gathers
  too: the gradient of a split input is split by rows, that of a
  replicated input is whole already (no all-reduce, unlike (c)). A
  split tensor's ranks' rows joined are the whole tensor under every
  rule, so a re-split output is exact for whatever reads it: a row
  rule acts on each row, (a) and (b) sum over all of them, any other
  op gathers again. The cheaper rules keep precedence. A random op
  other than `dropout` with a split input raises: its draws over the
  whole batch are not split by rank. A `c_*` op raises in this mode:
  the JAX package's GSPMD step has no manual axis to reduce over.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.collective import COLLECTIVES
from ..ops.control_flow import block_idx, branch_env
from ..ops import nn as _nn
from . import lowering, registry
from . import precision as _precision
from .executor import _Step
from .registry import GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG, OpDef
from .ring import InProcessRing

SPMD, GSPMD = "spmd", "gspmd"

# GSPMD rule set. An op acting on each row of a batch-split input by
# itself: op type -> (the slots that may hold a split input, the slots
# that may hold a replicated one). Its outputs are split.
_EACH = ({"X"}, set())
ROW_OPS: Dict[str, tuple] = {t: _EACH for t in (
    "relu", "sigmoid", "logsigmoid", "tanh", "tanh_shrink", "exp", "log",
    "log1p", "log2", "log10", "abs", "square", "sqrt", "rsqrt",
    "reciprocal", "softsign", "sin", "cos", "tan", "asin", "acos", "atan",
    "sinh", "cosh", "erf", "floor", "ceil", "round", "sign", "silu",
    "mish", "gelu", "leaky_relu", "elu", "selu", "relu6", "brelu",
    "softplus", "softshrink", "hard_shrink", "thresholded_relu",
    "hard_sigmoid", "hard_swish", "swish", "stanh", "pow", "maxout",
    "soft_relu", "cast", "scale", "assign", "increment", "one_hot_v2",
    "pool2d", "softmax", "reshape2", "top_k", "sum", "one_hot",
    "log_softmax", "logical_not", "isinf_v2", "isnan_v2", "pool3d",
    # shape ops, while dim 0 stays the batch (`_row_problem`)
    "concat", "split", "stack", "transpose2", "flatten2", "squeeze2",
    "unsqueeze2", "expand")}
COMPARISONS = ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal", "logical_and",
               "logical_or", "logical_xor")
ROW_OPS.update({t: ({"X", "Y"}, {"Y"}) for t in (
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv")
    + COMPARISONS})
ROW_OPS.update({
    "prelu": ({"X"}, {"Alpha"}),
    "mul": ({"X"}, {"Y"}),
    "matmul": ({"X"}, {"Y"}),
    "matmul_v2": ({"X"}, {"Y"}),
    "conv2d": ({"Input"}, {"Filter", "Bias"}),
    "softmax_with_cross_entropy": ({"Logits", "Label"}, set()),
    "square_error_cost": ({"X", "Y"}, set()),
    "lookup_table_v2": ({"Ids"}, {"W"}),
    "lookup_table": ({"Ids"}, {"W"}),
    "gather": ({"Index"}, {"X"}),
    "slice": ({"Input"}, set()),
    "layer_norm": ({"X"}, {"Scale", "Bias"}),
    "group_norm": ({"X"}, {"Scale", "Bias"}),
    "instance_norm": ({"X"}, {"Scale", "Bias"}),
    "depthwise_conv2d": ({"Input"}, {"Filter"}),
    "conv3d": ({"Input"}, {"Filter"}),
    "conv2d_transpose": ({"Input"}, {"Filter"}),
    "cross_entropy": ({"X", "Label"}, set()),
    "cross_entropy2": ({"X", "Label"}, set()),
    "sigmoid_cross_entropy_with_logits": ({"X", "Label"}, set()),
    "bce_loss": ({"X", "Label"}, set()),
    "huber_loss": ({"X", "Y"}, set()),
    "smooth_l1_loss": ({"X", "Y", "InsideWeight", "OutsideWeight"}, set()),
    "margin_rank_loss": ({"X1", "X2", "Label"}, set()),
    "hinge_loss": ({"Logits", "Labels"}, set()),
    "kldiv_loss": ({"X", "Target"}, set()),
    "label_smooth": ({"X"}, {"PriorDist"}),
    "cos_sim": ({"X", "Y"}, {"Y"}),
})
# sync BN in training, rows under is_test or use_global_stats
# (`Lockstep._batch_norm`)
BATCH_NORMS = ("batch_norm", "sync_batch_norm")

# reductions: over the batch dim they are rule (a)'s (logsumexp's and
# frobenius_norm's raise); over other dims they act on each row
BATCH_REDUCE = {"mean", "reduce_sum", "reduce_mean", "reduce_max",
                "reduce_min", "reduce_prod", "reduce_all", "reduce_any"}
_ROW_REDUCE = BATCH_REDUCE | {"logsumexp", "frobenius_norm"}
ROW_OPS.update({t: _EACH for t in _ROW_REDUCE - {"mean"}})


def _reduce_dims(attrs, ndim) -> Optional[tuple]:
    """The dims a reduce op folds (None: all), as `ops/reduce.py` reads
    its attrs."""
    if attrs.get("reduce_all", False):
        return None
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


def _over_batch(op_type, attrs, x) -> bool:
    if op_type == "mean" or x.ndim == 0:
        return True
    dims = _reduce_dims(attrs, x.ndim)
    return dims is None or 0 in dims


def _axis_is_batch(attrs, x, key="axis", default=-1) -> bool:
    return x.ndim > 0 and int(attrs.get(key, default)) % x.ndim == 0


def _row_problem(op_type, attrs, vals, split) -> Optional[str]:
    """Why `op_type` cannot run on each rank's rows (None when it can).
    `vals`: slot -> rank 0's first value; `split`: the split slots."""
    x = vals.get("X")
    if op_type.startswith("elementwise_") or op_type in COMPARISONS:
        y = vals["Y"]
        axis = int(attrs.get("axis", -1))
        start = axis if axis != -1 else x.ndim - y.ndim
        if "Y" not in split and y.ndim:
            if start == 0 and y.shape[0] != 1:
                return "its replicated Y spans the batch dim"
        elif "Y" in split and start != 0:
            return "its split Y meets X past X's rows"
    elif op_type in ("softmax", "log_softmax") and _axis_is_batch(attrs, x):
        return "it normalizes over the batch dim"
    elif op_type in ("concat", "split", "stack") and \
            int(attrs.get("axis", 0)) % (x.ndim + (op_type == "stack")) == 0:
        return "it joins or cuts along the batch dim"
    elif op_type == "transpose2" and int(attrs["axis"][0]) % x.ndim != 0:
        return "it moves the batch dim"
    elif op_type == "flatten2" and int(attrs.get("axis", 1)) != 1:
        return "it folds the batch dim into another"
    elif op_type == "squeeze2":
        axes = [int(a) for a in attrs.get("axes", [])]
        if not axes or any(a % x.ndim == 0 for a in axes):
            return "it may squeeze the batch dim"
    elif op_type == "unsqueeze2" and any(int(a) <= 0
                                         for a in attrs["axes"]):
        return "it may insert a dim before the batch dim"
    elif op_type == "slice" and any(
            int(a) % vals["Input"].ndim == 0
            for a in list(attrs["axes"]) + list(attrs.get("decrease_axis",
                                                          []))):
        return "it slices the batch dim"
    elif op_type == "expand" and int(attrs["expand_times"][0]) != 1:
        return "it tiles the batch dim"
    elif op_type == "layer_norm" and int(attrs.get("begin_norm_axis", 1)) \
            % x.ndim == 0:
        return "it normalizes over the batch dim"
    elif op_type == "instance_norm" and 1 in tuple(x.shape[:2]):
        return "its saved stats squeeze a size-1 batch or channel dim"
    elif op_type == "sigmoid_cross_entropy_with_logits" and \
            attrs.get("normalize", False):
        return "it divides by the batch's count of labels"
    elif op_type == "kldiv_loss" and attrs.get("reduction",
                                                "mean") != "none":
        return "it reduces over the batch dim"
    elif op_type == "cos_sim" and "Y" not in split and \
            vals["Y"].shape[0] != 1:
        return "its replicated Y spans the batch dim"
    elif op_type == "softmax_with_cross_entropy" and \
            _axis_is_batch(attrs, vals["Logits"]):
        return "it normalizes over the batch dim"
    elif op_type in ("matmul", "matmul_v2") and x.ndim == 2 and \
            attrs.get("transpose_X", attrs.get("trans_x", False)):
        return "it transposes the batch dim away"
    elif op_type == "reshape2":
        shape = list(attrs.get("shape", []))
        if vals.get("Shape") is not None or not shape or \
                shape[0] not in (-1, 0):
            return "its new shape does not keep the batch dim first"
    elif op_type == "top_k" and x.ndim < 2:
        return "it ranks along the batch dim"
    elif op_type in _ROW_REDUCE and _over_batch(op_type, attrs, x):
        return "it reduces over the batch dim"
    return None


def _base_type(op_type: str) -> str:
    while op_type.endswith("_grad"):
        op_type = op_type[:-len("_grad")]
    return op_type


def _is_random(op_type: str) -> bool:
    try:
        return registry.get_op_def(_base_type(op_type)).is_random
    except KeyError:
        return False   # run_op raises for it, naming it


def _ranked_dgc(op) -> bool:
    """A `dgc_momentum` that reduces over the ranks (it has an axis)."""
    return op.type == "dgc_momentum" and bool(op.attrs.get("axis_name"))


def _call(op_type, x, attrs):
    """A reduce kernel's output on `x` (reduce kernels read no ctx)."""
    return registry.get_op_def(op_type).call({"X": [x]}, attrs, None)["Out"][0]


class Lockstep:
    """One step's run over the ranks of `ring`: `seeds[r]` is rank r's
    rng key, `split` (GSPMD) the names split on dim 0 at the start."""

    def __init__(self, desc, ring: InProcessRing, mode: str, *,
                 seeds: Sequence[int], is_test: bool,
                 device: torch.device, axis: Optional[str] = None,
                 split: Sequence[str] = ()):
        self.desc, self.ring, self.mode, self.axis = desc, ring, mode, axis
        self.seeds = list(seeds)
        self.is_test, self.device = is_test, device
        self.split = set(split)
        # the c_* ops run in this step, by type
        self.launches: collections.Counter = collections.Counter()

    # -- driving -------------------------------------------------------

    def run(self, block: int, envs: List[Dict]) -> List[Dict]:
        for op in self.desc.block(block).ops:
            if op.type in lowering.STRUCTURAL_OPS:
                continue
            if op.type in COLLECTIVES:
                self._collective(op, envs)
            elif _ranked_dgc(op):
                self._dgc_momentum(op, envs)
            elif op.type == "cond":
                self._cond(op, envs, block)
            elif self.mode == SPMD:
                self._spmd(op, envs, block)
            else:
                self._gspmd(op, envs, block)
        return envs

    def _lower_sub(self, sub, env, ctx):
        return lowering.lower_block(self.desc, sub, env, rng_key=ctx._rng_key,
                                    is_test=self.is_test, device=ctx.device)

    def _run(self, op, env, rank, block, opdef=None):
        lowering.run_op(op, env, self.desc, block, self._lower_sub,
                        self.seeds[rank], self.is_test, self.device,
                        opdef=opdef)

    def _per_rank(self, op, envs, block, opdef=None):
        for r, env in enumerate(envs):
            self._run(op, env, r, block, opdef)

    def _once(self, op, envs, block):
        """Run `op` on rank 0 and hand what it made to every rank."""
        outs = [n for n in op.output_names() if n]
        before = {n: envs[0].get(n) for n in outs}
        self._run(op, envs[0], 0, block)
        for n in outs:
            v = envs[0].get(n)
            if v is not before[n]:
                for env in envs[1:]:
                    env[n] = v

    def _bind(self, envs, name, value):
        for env in envs:
            env[name] = value
        self.split.discard(name)

    @staticmethod
    def _values(envs, name, op):
        try:
            return [env[name] for env in envs]
        except KeyError:
            raise lowering.LoweringError(
                f"op '{op.type}': input var '{name}' has no value (not fed, "
                f"not in scope, and not produced by an earlier op)") from None

    # -- collectives and control flow (both modes) ---------------------

    def _collective(self, op, envs):
        self._check_axis(op)
        grad = op.type.endswith("_grad")
        ins = op.inputs.get("out_grad::Out" if grad else "X", [])
        outs = op.outputs.get(GRAD_PREFIX_IG + "X" if grad else "Out", [])
        fn = COLLECTIVES[op.type]
        for src, dst in zip(ins, outs):
            if src and dst:
                for env, y in zip(envs, fn(self._values(envs, src, op),
                                           op.attrs, self.ring)):
                    env[dst] = y
        self.launches[op.type] += 1

    def _dgc_momentum(self, op, envs):
        """`dgc_momentum` with an axis: every rank compresses its own
        gradient and applies the ring's sparse all-reduce of them all
        (`optimizer_ops.dgc_momentum_ranks`)."""
        from ..ops.optimizer_ops import dgc_momentum_ranks

        self._check_axis(op)
        rank_ins = [{slot: [env[n] if n else None for n in names]
                     for slot, names in op.inputs.items()} for env in envs]
        for env, outs in zip(envs, dgc_momentum_ranks(rank_ins, op.attrs)):
            for slot, names in op.outputs.items():
                for n in names:
                    if n and slot in outs:
                        env[n] = outs[slot]
        self.launches[op.type] += 1

    def _check_axis(self, op):
        if self.mode != SPMD:
            raise RuntimeError(
                f"{op.type}: CompiledProgram splits the batch and reduces "
                f"the gradients itself, with no axis for an explicit "
                f"collective; a program with c_* ops runs under "
                f"parallel.SPMDRunner")
        axis = op.attrs.get("axis_name", "data")
        if axis != self.axis:
            raise ValueError(
                f"{op.type} reduces over mesh axis '{axis}', but the ranks "
                f"of this run are on axis '{self.axis}'")

    def _has_collective(self, block: int) -> bool:
        for op in self.desc.block(block).ops:
            if op.type in COLLECTIVES or _ranked_dgc(op) or any(
                    self._has_collective(b) for b in op.sub_block_ids()):
                return True
        return False

    def _cond(self, op, envs, block):
        pname = op.inputs["Cond"][0]
        if pname in self.split:
            self._refuse(op, [pname], "its predicate is split over the "
                         "batch")
        preds = self._values(envs, pname, op)
        same = all(p is preds[0] for p in preds)
        takes = [bool(p.reshape(()))
                 for p in (preds[:1] if same else preds)]
        tb = block_idx(op.attrs, "true_block")
        fb = block_idx(op.attrs, "false_block")
        if len(set(takes)) > 1:
            # the ranks branch apart: each runs its own branch alone,
            # which no collective may join
            if self._has_collective(tb) or self._has_collective(fb):
                raise RuntimeError(
                    f"cond: the ranks disagree on the predicate "
                    f"'{pname}' and a branch holds a collective; the "
                    f"ranks would never meet there")
            return self._per_rank(op, envs, block)
        operands = op.inputs.get("Input", [])
        subs = [branch_env(env, op.attrs,
                           [env[n] for n in operands]) for env in envs]
        self.run(tb if takes[0] else fb, subs)
        for dst, src in zip(op.outputs["Out"], op.attrs["out_names"]):
            for env, sub in zip(envs, subs):
                env[dst] = sub[src]
            if src in self.split:
                self.split.add(dst)
            else:
                self.split.discard(dst)

    # -- SPMD ------------------------------------------------------------

    def _spmd(self, op, envs, block):
        names = [n for n in op.input_names() if n]
        same = all(env.get(n) is envs[0].get(n)
                   for n in names for env in envs[1:])
        if same and not _is_random(op.type) and not op.sub_block_ids():
            self._once(op, envs, block)
        else:
            self._per_rank(op, envs, block)

    # -- GSPMD -----------------------------------------------------------

    def _refuse(self, op, names, why):
        raise NotImplementedError(
            f"{op.type}: no data-parallel rule for this op with the "
            f"batch-split input(s) {sorted(set(names))} ({why}). Running "
            f"it on each rank's rows would give another result than the "
            f"whole batch does")

    def _row_ok(self, op_type, op, env, prefix=""):
        """None when `op_type`'s row rule takes this op's inputs (those
        whose slot starts with `prefix`, read without it), else why
        not. `env`: rank 0's."""
        if op_type not in ROW_OPS:
            return "it has no row rule"
        vals, split, repl = {}, set(), set()
        for slot, names in op.inputs.items():
            if not slot.startswith(prefix):
                continue
            s = slot[len(prefix):]
            for n in names:
                if n:
                    (split if n in self.split else repl).add(s)
                    vals.setdefault(s, env.get(n))
        rows, bcast = ROW_OPS[op_type]
        if split - rows:
            return f"its slots {sorted(split - rows)} cannot hold a split"
        if repl - bcast:
            return (f"its slots {sorted(repl - bcast)} are replicated "
                    f"beside a split input")
        return _row_problem(op_type, op.attrs, vals, split)

    def _gspmd(self, op, envs, block):
        split_in = [n for n in op.input_names() if n and n in self.split]
        outs = [n for n in op.output_names() if n]
        if not split_in:
            self._once(op, envs, block)
            self.split.difference_update(outs)
            return
        t = op.type
        first_grad = t.endswith("_grad") and not t[:-5].endswith("_grad")
        base = t[:-5] if first_grad else t
        x_slot = (GRAD_PREFIX_IN + "X") if first_grad else "X"
        if base in BATCH_REDUCE and op.inputs.get(x_slot) and \
                _over_batch(base, op.attrs,
                            self._values(envs, op.inputs[x_slot][0], op)[0]):
            if first_grad:
                return self._batch_reduce_grad(op, envs, block, base)
            return self._batch_reduce(op, envs)
        if t == "accuracy" and all(
                n in self.split for s in ("Indices", "Label")
                for n in op.inputs.get(s, [])):
            return self._accuracy(op, envs, block)
        if base in BATCH_NORMS and self._bn_takes(op, first_grad):
            return self._batch_norm(op, envs, block, first_grad)
        if base == "dropout":
            return self._dropout(op, envs, block, first_grad)
        if _is_random(t):
            self._refuse(op, split_in, "a random op's draws over the whole "
                         "batch are not split by rank; only dropout's are")
        if self._row_ok(base, op, envs[0],
                        GRAD_PREFIX_IN if first_grad else "") is not None:
            return self._gather(op, envs, block, first_grad)
        self._per_rank(op, envs, block)
        if not first_grad:
            self.split.update(outs)
            return
        self._grad_outputs(op, envs)

    def _gather(self, op, envs, block, first_grad):
        """Rule (d): `op` once over the whole batch. Its split inputs
        joined over the ranks in rank order, it runs on rank 0's env
        (and rng key); each output it wrote goes to every rank, split
        by the ranks' rows where it is the gradient of a split input
        (a gradient op) or where its dim 0 is a split input's whole
        batch (any other op), else whole."""
        env, sizes, rows = dict(envs[0]), set(), set()
        for n in dict.fromkeys(n for n in op.input_names()
                               if n and n in self.split):
            parts = self._values(envs, n, op)
            if not all(isinstance(p, torch.Tensor) for p in parts):
                self._refuse(op, [n], "its split input is no tensor")
            env[n] = self.ring.join(parts, 0)
            sizes.add(env[n].shape[0])
        if first_grad:
            rows = {dst for slot, dsts in op.outputs.items()
                    if slot.startswith(GRAD_PREFIX_IG)
                    for src, dst in zip(op.inputs.get(
                        GRAD_PREFIX_IN + slot[len(GRAD_PREFIX_IG):], []),
                        dsts) if dst and src in self.split}
        outs = [n for n in op.output_names() if n]
        before = {n: env.get(n) for n in outs}
        self._run(op, env, 0, block)
        n_ranks = self.ring.size
        for n in dict.fromkeys(outs):
            v = env.get(n)
            if v is before[n]:
                continue
            tensor = isinstance(v, torch.Tensor) and v.ndim > 0 and \
                v.shape[0] % n_ranks == 0
            if tensor and (n in rows if first_grad else v.shape[0] in sizes):
                for e, part in zip(envs, self.ring.split(v, 0)):
                    e[n] = part
                self.split.add(n)
            else:
                self._bind(envs, n, v)

    def _grad_outputs(self, op, envs):
        """After a gradient op ran on every rank: the gradient of a split
        input is split; that of a replicated input is this rank's partial
        sum (rule (c)), all-reduced before anything reads it."""
        for slot, dsts in op.outputs.items():
            if not slot.startswith(GRAD_PREFIX_IG):
                continue
            srcs = op.inputs.get(GRAD_PREFIX_IN + slot[len(GRAD_PREFIX_IG):],
                                 [])
            for src, dst in zip(srcs, dsts):
                if not dst or dst not in envs[0]:
                    continue
                if src in self.split:
                    self.split.add(dst)
                else:
                    self._bind(envs, dst, self.ring.all_reduce(
                        [env[dst] for env in envs])[0])

    def _batch_reduce(self, op, envs):
        """Rule (a): the op over the whole batch from each rank's rows."""
        t, attrs = op.type, op.attrs
        xs = self._values(envs, op.inputs["X"][0], op)
        ring = self.ring
        if t == "mean":
            total = ring.all_reduce([x.sum() for x in xs])[0]
            out = (total / sum(x.numel() for x in xs)).reshape(1)
        elif t in ("reduce_sum", "reduce_mean"):
            total = ring.all_reduce([_call("reduce_sum", x, attrs)
                                     for x in xs])[0]
            out = total if t == "reduce_sum" else \
                total / (sum(x.numel() for x in xs) // total.numel())
        else:
            parts = torch.stack([_call(t, x, attrs) for x in xs])
            out = {"reduce_max": lambda p: p.amax(0),
                   "reduce_min": lambda p: p.amin(0),
                   "reduce_prod": lambda p: p.prod(0),
                   "reduce_all": lambda p: p.all(0),
                   "reduce_any": lambda p: p.any(0)}[t](parts)
        self._bind(envs, op.outputs["Out"][0], out)

    def _partials(self, base, attrs, xs) -> List:
        """Rule (b): per rank, what its local reduction is multiplied by
        so that the product's gradient is the global reduction's."""
        if base in ("mean", "reduce_mean"):
            n = sum(x.numel() for x in xs)
            return [x.numel() / n for x in xs]
        if base == "reduce_sum":
            return [1.0] * len(xs)
        if base == "reduce_prod":
            parts = [_call(base, x, attrs) for x in xs]
            return [torch.stack(parts[:r] + parts[r + 1:]).prod(0)
                    if len(parts) > 1 else torch.ones_like(parts[r])
                    for r in range(len(parts))]
        # reduce_max / reduce_min: the gradient goes evenly to every
        # rank's ties with the global extremum
        dims = _reduce_dims(attrs, xs[0].ndim) or tuple(range(xs[0].ndim))
        f = torch.amax if base == "reduce_max" else torch.amin
        local = [f(x, dim=dims, keepdim=True) for x in xs]
        whole = f(torch.stack(local), dim=0)
        ties = [(x == whole).sum(dims, keepdim=True).to(x.dtype) for x in xs]
        total = sum(ties)
        return [torch.where(lo == whole, t / total, torch.zeros_like(t))
                for lo, t in zip(local, ties)]

    def _batch_reduce_grad(self, op, envs, block, base):
        fwd = registry.get_op_def(base)
        xs = self._values(envs, op.inputs[GRAD_PREFIX_IN + "X"][0], op)
        for r, c in enumerate(self._partials(base, op.attrs, xs)):
            def partial(ins, attrs, ctx, c=c):
                out = registry.normalize_outs(
                    fwd.kernel(ins, attrs, ctx))["Out"][0]
                if isinstance(c, torch.Tensor):
                    c = c.reshape(out.shape)
                return {"Out": out * c}

            pdef = OpDef(base, partial, nondiff_inputs=fwd.nondiff_inputs,
                         default_attrs=fwd.default_attrs,
                         intermediate_outputs=fwd.intermediate_outputs)
            gdef = OpDef(op.type, registry.make_generic_grad_kernel(pdef),
                         grad=None)
            self._run(op, envs[r], r, block, opdef=gdef)
        self.split.update(n for n in op.output_names() if n)

    def _dropout(self, op, envs, block, grad):
        """The whole batch's mask, each rank its rows of it (`dropout_rows`),
        in the forward and in the gradient's replay."""
        x = op.inputs[GRAD_PREFIX_IN + "X" if grad else "X"][0]
        fwd = registry.get_op_def("dropout")
        rows, lo = sum(v.shape[0] for v in self._values(envs, x, op)), 0
        for r, env in enumerate(envs):
            pdef = OpDef("dropout", _nn.dropout_rows(rows, lo),
                         default_attrs=fwd.default_attrs, is_random=True,
                         intermediate_outputs=fwd.intermediate_outputs)
            if grad:
                pdef = OpDef(op.type, registry.make_generic_grad_kernel(pdef),
                             grad=None)
            self._run(op, env, r, block, opdef=pdef)
            lo += env[x].shape[0]
        self.split.update(n for n in op.output_names() if n)

    def _accuracy(self, op, envs, block):
        """Rule (a) for `accuracy` (its indices and labels split): the
        counts summed over the ranks."""
        self._per_rank(op, envs, block)
        sums = {}
        for slot in ("Correct", "Total"):
            name = op.outputs[slot][0]
            sums[slot] = self.ring.all_reduce([env[name] for env in envs])[0]
            self._bind(envs, name, sums[slot])
        self._bind(envs, op.outputs["Accuracy"][0],
                   (sums["Correct"].to(torch.float32) /
                    sums["Total"].to(torch.float32)).reshape(1))

    # -- batch norm ----------------------------------------------------

    def _bn_uses_batch(self, op) -> bool:
        attrs = op.attrs
        return not (self.is_test or bool(attrs.get("is_test", False)) or
                    bool(attrs.get("use_global_stats", False)))

    def _bn_stats(self, xs, attrs):
        """The whole batch's (mean, mean of squares) of each channel, in
        f32, from the ranks' all-reduced sums; and the batch's count."""
        axes, _ = _nn.channel_layout(attrs, xs[0])
        xfs = [x.to(torch.float32) for x in xs]
        count = sum(math.prod(x.shape[a] for a in axes) for x in xs)
        s1 = self.ring.all_reduce([x.sum(dim=axes) for x in xfs])[0]
        s2 = self.ring.all_reduce([torch.square(x).sum(dim=axes)
                                   for x in xfs])[0]
        return s1 / count, s2 / count, count

    @staticmethod
    def _cast(op_type, ins):
        """`ins` as `lowering.run_op` hands them to a kernel under the
        active precision policy."""
        pol = _precision.active_autocast()
        return ins if pol is None else _precision.autocast_op_inputs(
            op_type, ins, pol)

    def _bn_ctx(self, op):
        return registry.KernelCtx(op, is_test=self.is_test,
                                  device=self.device)

    def _bn_takes(self, op, grad) -> bool:
        """The batch norms' rule takes a split X beside replicated
        per-channel inputs; rule (d) anything else."""
        prefix = GRAD_PREFIX_IN if grad else ""
        return op.inputs[prefix + "X"][0] in self.split and not any(
            n in self.split for slot in ("Scale", "Bias", "Mean", "Variance")
            for n in op.inputs.get(prefix + slot, []))

    def _batch_norm(self, op, envs, block, grad):
        """Rule for `batch_norm`: under is_test or use_global_stats a row
        op (the running stats normalize each row); in training the
        forward normalizes by the whole batch's statistics
        (`_bn_stats`), and MeanOut, VarianceOut and the saved stats are
        one tensor on every rank."""
        prefix = GRAD_PREFIX_IN if grad else ""
        x_name = op.inputs[prefix + "X"][0]
        if not self._bn_uses_batch(op):
            return self._bn_rows(op, envs, block, grad)
        if grad:
            return self._batch_norm_grad(op, envs)
        xs = self._values(envs, x_name, op)
        m, sq, _ = self._bn_stats(xs, op.attrs)
        fwd = registry.get_op_def(_base_type(op.type))
        attrs = {**fwd.default_attrs, **op.attrs}
        ins = {slot: self._values(envs, names[0], op)[:1]
               for slot, names in op.inputs.items() if slot != "X"}
        outs = [_nn.batch_norm_kernel(
            self._cast(op.type, {"X": [x], **ins}), attrs,
            self._bn_ctx(op), stats=lambda xf, axes: (m, sq)) for x in xs]
        for slot, names in op.outputs.items():
            if not names or not names[0]:
                continue
            if slot == "Y":
                for env, o in zip(envs, outs):
                    env[names[0]] = o["Y"]
                self.split.add(names[0])
            else:
                self._bind(envs, names[0], outs[0][slot])

    def _bn_rows(self, op, envs, block, grad):
        self._per_rank(op, envs, block)
        if not grad:
            for slot, names in op.outputs.items():
                for n in names:
                    if n and slot == "Y":
                        self.split.add(n)
                    elif n:
                        self._bind(envs, n, envs[0][n])
            return
        self._grad_outputs(op, envs)

    def _batch_norm_grad(self, op, envs):
        """The gradient of the training forward over the whole batch: each
        rank replays its rows with the global (mean, mean of squares) as
        leaves; their gradients (the cotangent's sums through the
        statistics) and Scale's and Bias's are all-reduced, and each
        rank's X gradient gains the terms through the statistics, d/dx
        of mean(x) and of mean(x^2)."""
        fwd = registry.get_op_def(_base_type(op.type))
        attrs = {**fwd.default_attrs, **op.attrs}
        x_name = op.inputs[GRAD_PREFIX_IN + "X"][0]
        xs = self._values(envs, x_name, op)
        m, sq, count = self._bn_stats(xs, attrs)
        ins = {slot: self._values(envs, op.inputs[GRAD_PREFIX_IN + slot][0],
                                  op)[0]
               for slot in ("Scale", "Bias", "Mean", "Variance")}
        og = op.inputs.get(GRAD_PREFIX_OG + "Y", [""])[0]
        _, ch = _nn.channel_layout(attrs, xs[0])
        parts = []
        with torch.enable_grad():
            for env, x in zip(envs, xs):
                leaves = [t.detach().requires_grad_() for t in
                          (x, ins["Scale"], ins["Bias"], m, sq)]
                y = _nn.batch_norm_kernel(self._cast(op.type[:-5], {
                    "X": [leaves[0]], "Scale": [leaves[1]],
                    "Bias": [leaves[2]], "Mean": [ins["Mean"]],
                    "Variance": [ins["Variance"]]}), attrs,
                    self._bn_ctx(op),
                    stats=lambda xf, axes, l=leaves: (l[3], l[4]))["Y"]
                cot = env[og].to(y.dtype) if og and og in env \
                    else torch.zeros_like(y)
                parts.append([torch.zeros_like(t) if g is None else g
                              for t, g in zip(leaves, torch.autograd.grad(
                                  y, leaves, cot, allow_unused=True))])
        total = [self.ring.all_reduce([p[i] for p in parts])[0]
                 for i in range(1, 5)]
        d_mean = (total[2] / count).reshape(ch)
        d_sq = (total[3] * (2.0 / count)).reshape(ch)
        grads = {"X": [(p[0] + d_mean + d_sq * x.to(torch.float32)).to(
                     x.dtype) for p, x in zip(parts, xs)],
                 "Scale": total[0], "Bias": total[1]}
        for slot, names in op.outputs.items():
            key = slot[len(GRAD_PREFIX_IG):]
            if not names or not names[0] or key not in grads:
                continue
            if key == "X":
                for env, g in zip(envs, grads["X"]):
                    env[names[0]] = g
                self.split.add(names[0])
            else:
                self._bind(envs, names[0], grads[key])


class RankStep(_Step):
    """One prepared program specialization run over the ranks of an
    in-process ring: `_Step`'s state analysis (const and updated reads,
    writes, fetches) with the split of the feeds and the lockstep run.
    `rank_feed_shapes` holds each feed's per-rank shape at the last run,
    `launches` the c_* ops run over all runs."""

    def __init__(self, program, feed_names, fetch_names, policy, ring,
                 mode, axis=None):
        super().__init__(program, feed_names, fetch_names,
                         program._is_test, policy)
        self.ring, self.mode, self.axis = ring, mode, axis
        self.rank_feed_shapes: Dict[str, tuple] = {}
        self.launches: collections.Counter = collections.Counter()

    def split_feeds(self, feed, what: str) -> List[Dict[str, torch.Tensor]]:
        """Each rank's dim-0 shard of every feed; a batch the ring size
        does not divide raises ValueError, saying `what` the ranks are."""
        n = self.ring.size
        for name, v in feed.items():
            if v.ndim and v.shape[0] % n:
                raise ValueError(f"feed '{name}' batch {v.shape[0]} not "
                                 f"divisible by {n} {what}")
        shards = {k: self.ring.split(v, 0) if v.ndim else [v] * n
                  for k, v in feed.items()}
        self.rank_feed_shapes = {k: tuple(s[0].shape)
                                 for k, s in shards.items()}
        return [{k: s[r] for k, s in shards.items()} for r in range(n)]

    def run_ranks(self, envs, seeds, device):
        """Run the program over the ranks' `envs` (state and feed shards)
        with rank r's rng key `seeds[r]`: (the ranks' envs after the
        step, the names split over the ranks)."""
        policy = self.policy
        if policy.cast_state:
            cast: Dict[int, torch.Tensor] = {}
            envs = [{k: cast.setdefault(id(v), _precision.cast_floating(
                v, policy.compute_dtype)) for k, v in env.items()}
                for env in envs]
        split = self.feed_names if self.mode == GSPMD else ()
        step = Lockstep(self.desc, self.ring, self.mode, seeds=seeds,
                        is_test=self.is_test, device=device, axis=self.axis,
                        split=split)
        with torch.no_grad(), _precision.autocast(policy):
            step.run(0, envs)
        self.launches.update(step.launches)
        return envs, step.split
