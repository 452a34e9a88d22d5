"""Train step and fault-tolerant training loop.

Counterpart of the JAX package's `parallel/train.py`: `make_train_step`
(`init_state(params)` then `step(state, batch, rng) -> (state, loss)`),
`train_loop` (checkpoints, preemption, fault injection, recovery
policies) and `sync_loss_scale_metrics`. What differs, and why:

- One device, named by `device` (cuda unless "cpu"), or by `mesh`: a
  mesh of in-process rings (`parallel/mesh.py`), whose virtual ranks
  all run on that one device. The step runs the loss under
  `mesh_guard(mesh)` and `with_rules(rules)`. `param_axes`, `rules`
  and `batch_spec` mean what they mean in the JAX package:
  `shard_params_spec(param_axes, rules)` is checked against every
  param at `make_train_step` (a spec that maps one mesh axis onto two
  dims raises, as the JAX package's `NamedSharding` does:
  `sharding.check_param_spec`) and at `init_state` (each split dim
  divides its mesh axis), and chooses the ZeRO-1 slices. `batch_spec` (default
  `rules.spec(("batch", "seq"))`) is the layout of the step's inputs
  in the JAX package; here every rank holds the whole batch and the
  rules decide each op's split (the batch ring of `dp_sum`, `mha`'s
  per-rank blocks, `pipeline_apply`), a dim its ring does not divide
  staying whole, as the JAX step's `leaf_sharding` leaves it
  replicated. So `batch_spec` is checked once (each axis it names is
  the mesh's) and decides nothing else.
- On an in-process ring the model holds whole tensors, as it does
  under sp and ep. The ops that carry dp or tp split and join inside
  themselves: attention's per-rank launches, BatchNorm's partial sums,
  the row-parallel sums and the losses' global means
  (`models/common.py`), the pipeline's stage calls. So the gradient of
  a replicated param is autograd's sum over the ranks' shards, and no
  separate gradient all-reduce runs on one card: ROADMAP item 20a adds
  that all-reduce when the ring spans processes. The loss is the
  global batch's, as GSPMD gives the JAX package.
- `TrainStrategy(shard_optimizer_states=True)` (ZeRO-1, the JAX
  default) holds each trainable param's optimizer state as dp slices
  along the first dim its spec leaves unsharded that dp divides, as
  the JAX package's `opt_state_sharding_like` chooses it
  (`Zero1Optimizer`); a param with no such dim keeps whole state. The
  optimizer is elementwise, so a ZeRO-1 update equals the replicated
  one bit for bit.
- `optimizer` is a factory `params -> torch.optim.Optimizer` over the
  trainable params (`models.common.is_trainable`). The counterpart of
  `optax.adamw(lr)` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
  every param) is
  `lambda ps: torch.optim.AdamW(ps, lr=lr, weight_decay=1e-4)`:
  torch's default decay is 1e-2.
- The state is updated in place and returned (the JAX step donates its
  input state the same way); `TrainState.opt_state` is the optimizer.
- `rng` is an int seed or None (the counterpart of a jax key): each
  microbatch's loss_fn gets a `torch.Generator` on the device seeded
  from it, so a recomputed forward draws the same dropout bits.
- Recompute (`TrainStrategy(recompute=True)`) checkpoints the whole
  loss with `torch.utils.checkpoint` (non-reentrant), as the JAX step
  wraps loss_fn in `jax.checkpoint`. Policy None and "nothing" save
  nothing; "dots" and "dots_no_batch" are a selective checkpoint that
  saves the outputs of dot ops and recomputes everything else, the
  counterparts of `jax.checkpoint_policies.dots_saveable` and
  `dots_with_no_batch_dims_saveable`: "dots" saves `aten.mm`, `addmm`,
  `bmm` and `baddbmm`, "dots_no_batch" only the two with no batch
  dimension (the denses, `[B*T, D] @ [D, F]`, not attention's
  per-head products). The attention kernels are autograd Functions
  that launch through ctypes, which the dispatcher never sees, so
  under every policy their forward runs again in the recompute (in the
  JAX package a `pallas_call` is no dot either).
- Mixed policies read `finite` on the host once a step (one device
  sync) and skip the optimizer when it is False; the JAX step selects
  on the device. Params and optimizer state keep their pre-step values
  either way.
- `train_loop` draws step N's seed as a fixed function of (rng, N)
  where the JAX loop folds N into its key (see `step_seed`), and its
  loss fetches are `core.async_exec.FetchHandle`s on CUDA events.
  Elastic resizing (`resize_check`) is kept as a hook; the elastic
  loop that re-forms a mesh is not ported (ROADMAP item 20e).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..core import precision as _precision
from ..models.common import Params, ParamAxes, is_trainable
from ..observability import memwatch as _memwatch
from .mesh import mesh_guard
from .sharding import (LogicalRules, PartitionSpec, check_param_spec,
                       current_rules, shard, shard_params_spec, with_rules)

__all__ = ["TrainStrategy", "TrainState", "make_train_step",
           "RECOMPUTE_POLICIES", "sync_loss_scale_metrics", "train_loop",
           "step_seed", "Zero1Optimizer", "zero1_dim"]

# None and "nothing" save nothing and recompute everything; the "dots"
# policies save the dot ops' outputs below (the module docstring)
RECOMPUTE_POLICIES = (None, "nothing", "dots", "dots_no_batch")

_aten = torch.ops.aten
SAVED_DOTS = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def _save_dots(ops, ctx, op, *args, **kwargs):
    """A selective-checkpoint policy: save the outputs of `ops`,
    recompute everything else. Nothing else is ever MUST_SAVE: a cached
    allocation (`aten.empty`) handed back during the recompute to a
    kernel that writes it in place would be overwritten."""
    return CheckpointPolicy.MUST_SAVE if op in ops \
        else CheckpointPolicy.PREFER_RECOMPUTE


@dataclasses.dataclass
class TrainStrategy:
    """The JAX package's TrainStrategy."""

    shard_optimizer_states: bool = True   # ZeRO-1 over dp vs replicated
    accum_steps: int = 1                  # gradient merge over microbatches
    recompute: bool = False               # activation checkpointing
    recompute_policy: Optional[str] = None
    clip_global_norm: Optional[float] = None


class TrainState:
    """params (a flat dict of leaf tensors), the optimizer, the step
    count and the loss-scale state of a mixed policy (None otherwise)."""

    def __init__(self, params: Params, opt_state: torch.optim.Optimizer,
                 step: int, loss_scale: Optional[Dict[str, Any]] = None):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.loss_scale = loss_scale
        _live_states.add(self)


# Device-memory owner attribution (memwatch), as the JAX package's:
# every live TrainState volunteers its params and its optimizer's state
# tensors, through providers registered once at import that read the
# CURRENT tensors at each sweep.
_live_states: "weakref.WeakSet[TrainState]" = weakref.WeakSet()


def _live_param_tensors():
    for st in list(_live_states):
        yield from st.params.values()


def _live_opt_tensors():
    for st in list(_live_states):
        opt = st.opt_state
        for o in getattr(opt, "optimizers", None) or [opt]:
            for per_param in getattr(o, "state", {}).values():
                for v in per_param.values():
                    if isinstance(v, torch.Tensor):
                        yield v


_memwatch.register_provider("params", _live_param_tensors)
_memwatch.register_provider("optimizer", _live_opt_tensors)


def zero1_dim(shape, spec: PartitionSpec, dp: int) -> Optional[int]:
    """The dim a ZeRO-1 moment of a param of `shape` and `spec` is
    sliced along over dp: the first one the spec leaves unsharded whose
    size dp divides (and is at least dp), as the JAX package's
    `opt_state_sharding_like` chooses it; None for a scalar or a param
    with no such dim (its state stays whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, (n, ax) in enumerate(zip(shape, spec)):
        if ax is None and n % dp == 0 and n >= dp:
            return i
    return None


class Zero1Optimizer:
    """ZeRO-1 on an in-process dp ring: the optimizer state of each
    param with a `zero1_dim` is held as dp slices, rank r's optimizer
    (`factory` over rank r's slices) stepping slice r of the param and
    holding slice r of its moments. Params with none share one
    optimizer over their whole tensors. The slices are views of the
    params, so a step writes the params in place and a restore into
    the params is seen at once; each step hands each slice its slice of
    the param's gradient. `state_dict` keys rank r's state
    "r/<index>" ("whole/<index>" for the whole ones). `param_groups`
    lists every optimizer's groups, so setting a group's "lr" (the
    recovery policy's backoff) reaches every slice. It is no
    `torch.optim.Optimizer`: an LR scheduler takes each of
    `optimizers` on its own."""

    def __init__(self, factory: Callable, params: List[torch.Tensor],
                 dims: List[Optional[int]], dp: int):
        self.params, self.dims, self.dp = params, dims, int(dp)
        self.slices = [[p.detach().narrow(d, r * (p.shape[d] // dp),
                                          p.shape[d] // dp)
                        for p, d in zip(params, dims) if d is not None]
                       for r in range(self.dp)]
        self.whole = [p for p, d in zip(params, dims) if d is None]
        self.ranks = [factory(sl) for sl in self.slices if sl]
        self.rest = factory(self.whole) if self.whole else None

    def _groups(self):
        return [(str(r), o) for r, o in enumerate(self.ranks)] + \
            ([("whole", self.rest)] if self.rest is not None else [])

    @property
    def optimizers(self) -> List[torch.optim.Optimizer]:
        """Each rank's optimizer, then the whole params' (if any)."""
        return [o for _, o in self._groups()]

    @property
    def param_groups(self) -> List[Dict[str, Any]]:
        """The param groups of every optimizer (the same dicts: read
        anew after a `load_state_dict`, which replaces them)."""
        return [g for o in self.optimizers for g in o.param_groups]

    def step(self):
        sliced = [(p, d) for p, d in zip(self.params, self.dims)
                  if d is not None]
        for r, views in enumerate(self.slices):
            for view, (p, d) in zip(views, sliced):
                view.grad = None if p.grad is None else \
                    p.grad.narrow(d, r * view.shape[d], view.shape[d])
        for o in self.optimizers:
            o.step()

    def zero_grad(self, set_to_none: bool = True):
        """Drops every gradient (the params' and the slices')."""
        for t in self.params + [v for views in self.slices for v in views]:
            t.grad = None

    def state_dict(self):
        state, groups = {}, {}
        for tag, o in self._groups():
            sd = o.state_dict()
            groups[tag] = sd["param_groups"]
            for i, st in sd["state"].items():
                state[f"{tag}/{i}"] = st
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, sd):
        for tag, o in self._groups():
            o.load_state_dict({
                "state": {int(k.split("/")[1]): v
                          for k, v in sd["state"].items()
                          if k.split("/")[0] == tag},
                "param_groups": sd["param_groups"][tag]})


def _clip_by_global_norm(grads: List[torch.Tensor],
                         max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below `max_norm`, else
    g / norm * max_norm (no epsilon, unlike clip_grad_norm_)."""
    norm = torch.stack([(g * g).sum().float() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


def _microbatch_seeds(rng: Optional[int], n: int) -> List[Optional[int]]:
    if rng is None:
        return [None] * n
    if n == 1:
        return [int(rng)]
    return [int(s) for s in np.random.SeedSequence(int(rng))
            .generate_state(n)]


def make_train_step(loss_fn: Callable, optimizer: Callable, device=None,
                    strategy: Optional[TrainStrategy] = None,
                    has_aux: bool = False, precision=None, *,
                    mesh=None, param_axes: Optional[ParamAxes] = None,
                    rules: Optional[LogicalRules] = None,
                    batch_spec: Optional[PartitionSpec] = None):
    """Returns (init_state, step).

    With `mesh` (in-process rings; its device is the step's, and
    `device`, when given, must be it) the loss runs under the mesh and
    `rules` (default: the current rules), `param_axes` ({name: logical
    axes}, from the model's `init`) gives each param's spec, and
    `batch_spec` the batch's (checked, not read: the rules split the
    batch on in-process rings); see the module docstring.

    loss_fn(params, batch, generator) -> scalar loss (or (loss, aux)
    with `has_aux`, aux = {name: new value} of non-trainable state such
    as BN statistics). step(state, batch, rng) -> (state, loss).

    `precision` (a name or PrecisionPolicy; default: env
    PADDLE_TPU_PRECISION, else f32):
      f32         params, grads and optimizer as given.
      bf16        params (and so the optimizer state) cast to bfloat16.
      mixed_bf16 / mixed_f16
                  f32 master params and optimizer state; loss_fn sees
                  the params cast to the compute dtype (a
                  differentiable cast, so grads come back f32); the
                  loss is scaled by loss_scale["scale"] and the grads
                  unscaled; a nonfinite loss or grad skips the update
                  and shrinks the scale, growth_interval clean steps
                  grow it, within the policy's bounds.
    """
    strategy = strategy or TrainStrategy()
    policy = _precision.resolve(explicit=precision)
    if mesh is not None:
        dev = mesh.devices[0]
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device} is not the mesh's {dev}")
        if len(mesh.devices) != math.prod(mesh.shape.values()):
            raise NotImplementedError(
                "make_train_step runs on a mesh of in-process rings; over "
                "processes it waits for ROADMAP item 20a")
    dev = resolve_device(dev if mesh is not None else device)
    rules = rules or current_rules()
    p_specs = shard_params_spec(param_axes or {}, rules)
    if mesh is not None:
        for k, axes in (param_axes or {}).items():
            check_param_spec(k, axes, rules)
    if mesh is not None and batch_spec is not None:
        for ax in batch_spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None and a not in mesh.shape:
                    raise ValueError(f"batch_spec {batch_spec} names "
                                     f"{a!r}, no axis of the mesh "
                                     f"{tuple(mesh.shape)}")
    dp = mesh.shape["dp"] if mesh is not None else 1
    if strategy.recompute_policy not in RECOMPUTE_POLICIES:
        raise ValueError(
            f"unknown recompute_policy {strategy.recompute_policy!r}; "
            f"choose from {[p for p in RECOMPUTE_POLICIES if p]} or None")
    if strategy.recompute_policy is not None and not strategy.recompute:
        raise ValueError("recompute_policy is set but recompute=False — "
                         "enable recompute=True for the policy to take "
                         "effect")
    ckpt_kw = {}
    if strategy.recompute_policy in SAVED_DOTS:
        ckpt_kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_dots,
                              SAVED_DOTS[strategy.recompute_policy]))
    n_acc = int(strategy.accum_steps)
    use_amp = policy.dynamic_loss_scale and policy.compute_dtype is not None

    def run_loss(fn, params, batch, seed):
        def call(p, b, s):
            gen = None if s is None else \
                torch.Generator(device=dev).manual_seed(s)
            if mesh is None:
                return fn(p, b, gen)
            with mesh_guard(mesh), with_rules(rules):
                return fn(p, b, gen)

        if strategy.recompute:
            return checkpoint(call, params, batch, seed,
                              use_reentrant=False, **ckpt_kw)
        return call(params, batch, seed)

    def microbatch_grads(fn, params: Params, names: List[str], batch, rng):
        """(mean loss, mean grads in `names` order, aux of the last
        microbatch), as the JAX step's scan over accum_steps."""
        leaves = [params[k] for k in names]
        if n_acc > 1:
            micro = [{k: v.reshape((n_acc, v.shape[0] // n_acc) +
                                   tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(n_acc)]
        else:
            micro = [batch]
        loss_sum, acc, aux = None, None, {}
        for mb, seed in zip(micro, _microbatch_seeds(rng, n_acc)):
            out = run_loss(fn, params, mb, seed)
            loss, aux = out if has_aux else (out, {})
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            loss = loss.detach()
            if acc is None:
                loss_sum, acc = loss, grads
            else:
                loss_sum = loss_sum + loss
                acc = [a + g for a, g in zip(acc, grads)]
        if n_acc == 1:
            return loss_sum, acc, aux
        inv = 1.0 / n_acc
        return loss_sum * inv, [g * inv for g in acc], aux

    def init_state(params: Params) -> TrainState:
        """Copies `params` onto the device (cast to the compute dtype
        under a cast_state policy) as leaf tensors and builds the
        optimizer over the trainable ones."""
        out = {}
        for k, v in params.items():
            t = torch.as_tensor(v).detach().to(dev)
            if policy.cast_state:
                t = _precision.cast_floating(t, policy.compute_dtype)
            out[k] = t.clone().requires_grad_(t.is_floating_point())
        trainable = [(k, v) for k, v in out.items() if is_trainable(k)]
        if mesh is not None:
            with mesh_guard(mesh), with_rules(rules):
                for k, v in out.items():
                    shard(v, (param_axes or {}).get(k, ()), rules)
        if dp > 1 and strategy.shard_optimizer_states:
            opt = Zero1Optimizer(
                optimizer, [v for _, v in trainable],
                [zero1_dim(v.shape, p_specs.get(k, PartitionSpec()), dp)
                 for k, v in trainable], dp)
        else:
            opt = optimizer([v for _, v in trainable])
        return TrainState(out, opt, 0,
                          _precision.init_loss_scale_state(policy))

    @torch.no_grad()
    def apply_update(state: TrainState, names: List[str],
                     grads: List[torch.Tensor], aux: Dict[str, Any]):
        params = state.params
        train = [i for i, k in enumerate(names) if is_trainable(k)]
        tg = [grads[i] for i in train]
        if strategy.clip_global_norm:
            tg = _clip_by_global_norm(tg, strategy.clip_global_norm)
        for i, g in zip(train, tg):
            params[names[i]].grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        # optax.masked passes a masked-out leaf's update through: the
        # non-trainable leaf moves by its raw gradient, then aux
        # overwrites it
        for i, k in enumerate(names):
            if not is_trainable(k):
                params[k].add_(grads[i].to(params[k].dtype))
        for k, v in aux.items():
            params[k].copy_(v.detach().to(params[k].dtype))

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Optional[int] = None):
        if rng is not None and not isinstance(rng, (int, np.integer)):
            raise TypeError("rng is an int seed or None")
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        if policy.compute_dtype is not None:
            batch = _precision.cast_tree(batch, policy.compute_dtype)
        names = [k for k, v in state.params.items() if v.requires_grad]
        if not use_amp:
            loss, grads, aux = microbatch_grads(loss_fn, state.params,
                                                names, batch, rng)
            apply_update(state, names, grads, aux)
            state.step += 1
            return state, loss

        ls = state.loss_scale
        scale = ls["scale"]

        def scaled_loss(p, b, gen):
            pc = _precision.cast_tree(p, policy.compute_dtype)
            if has_aux:
                loss, aux = loss_fn(pc, b, gen)
                return loss.float() * scale, aux
            return loss_fn(pc, b, gen).float() * scale

        loss_s, grads_s, aux = microbatch_grads(scaled_loss, state.params,
                                                names, batch, rng)
        inv = float(np.float32(1.0) / np.float32(scale))
        grads = [g.float() * inv for g in grads_s]
        loss = loss_s * inv
        # the one host sync of a mixed step
        finite = bool(torch.stack([torch.isfinite(loss)] +
                                  [torch.isfinite(g).all() for g in grads])
                      .all())
        if finite:
            apply_update(state, names, grads, aux)
        good = ls["good_steps"] + 1
        grow = finite and good >= policy.growth_interval
        if not finite:
            new_scale = max(scale * policy.decr_ratio, policy.min_loss_scale)
        elif grow:
            new_scale = min(scale * policy.incr_ratio, policy.max_loss_scale)
        else:
            new_scale = scale
        state.loss_scale = {
            "scale": float(np.float32(new_scale)),
            "good_steps": good if finite and not grow else 0,
            "overflows": ls["overflows"] + int(not finite),
            "growths": ls["growths"] + int(grow),
        }
        state.step += 1
        return state, loss

    return init_state, step


def step_seed(rng: int, step: int) -> int:
    """Step `step`'s seed under the run seed `rng`: the first 32-bit
    word of numpy's `SeedSequence([rng, step])`, the counterpart of the
    JAX loop's `jax.random.fold_in(rng, step)`. A fixed function of the
    pair, so a resumed run draws the same dropout bits at each global
    step as the run it resumes."""
    return int(np.random.SeedSequence([int(rng), int(step)])
               .generate_state(1)[0])


def sync_loss_scale_metrics(state: TrainState,
                            last: Optional[Dict[str, Any]] = None
                            ) -> Optional[Dict[str, Any]]:
    """Diff TrainState.loss_scale's cumulative counters against `last`
    (the previous return value) and tick
    paddle_tpu_amp_total{event=overflow|growth|skip} + the loss-scale
    gauge; overflows also land as `amp_overflow` events. The port keeps
    the loss-scale state on the host, so this reads no device value.
    Returns the new cumulative snapshot (None loss_scale → `last`
    unchanged). `last=None` BASELINES without recording — a restored
    checkpoint's lifetime counters must not replay as fresh events."""
    from ..observability import telemetry as _telemetry

    ls = getattr(state, "loss_scale", None)
    if ls is None:
        return last
    cur = {"overflows": int(ls["overflows"]),
           "growths": int(ls["growths"]),
           "scale": float(ls["scale"])}
    _telemetry.AMP_LOSS_SCALE.set(cur["scale"])
    if last is None:
        return cur
    prev = last
    d_over = cur["overflows"] - int(prev.get("overflows", 0))
    d_grow = cur["growths"] - int(prev.get("growths", 0))
    _telemetry.record_amp("overflow", d_over, step=int(state.step),
                          scale=cur["scale"])
    _telemetry.record_amp("skip", d_over)
    _telemetry.record_amp("growth", d_grow, scale=cur["scale"])
    return cur


def train_loop(step_fn, state: TrainState, batches, *, rng=None,
               manager=None, save_every: Optional[int] = None,
               controller=None, max_steps: Optional[int] = None,
               fetch_window: Optional[int] = None,
               resize_check: Optional[Callable[[], bool]] = None):
    """Fault-tolerance-aware loop over a `make_train_step` step_fn, with
    the JAX package's contract.

    The step boundary is the only safe interruption point, so everything
    the resilience layer does hangs off this loop:

      - fault injection: `faults.check("step", step=N)` fires before
        each step — `PADDLE_TPU_FAULT_SPEC="step=N:crash"` kills the
        process exactly there (exit CRASH_EXIT_CODE);
      - preemption: when a graceful stop was requested (SIGTERM with
        PADDLE_TPU_PREEMPT_SIGNALS set, or programmatically), the loop
        writes a final checkpoint via `manager` and returns
        stop="preempted" — the caller exits with PREEMPT_EXIT_CODE;
      - periodic checkpoints: every `save_every` completed steps,
        `manager.save(state)` (commit marker + retention inside);
      - recovery: a NumericsError from the post-step loss check (or a
        blown warn-anomaly budget) or a PSUnavailableError is routed to
        `controller.handle`, which skips the batch, rolls the state back
        to the last committed checkpoint, or aborts per its
        RecoveryPolicy.

    `batches` is either an iterable of batches or a callable
    `batch_fn(step) -> batch | None` (None stops the loop). The callable
    form keys data on the GLOBAL step number, which is what makes a
    resumed run replay the exact uninterrupted trajectory — and what a
    rollback needs to re-feed the steps it rewound over. `rng` is an
    int run seed (default 0); step N runs under `step_seed(rng, N)` for
    the same reason. Returns (state, losses, stop) where `losses` maps
    executed step number -> float loss and `stop` is
    "completed" | "preempted" | "exhausted" | "resize".

    `resize_check` is the elastic-membership hook: it is consulted
    immediately AFTER each periodic checkpoint commits, and a True
    return stops the loop with stop="resize". It requires `manager` +
    `save_every`.

    Loss fetching is ASYNC by default: losses are parked as
    `FetchHandle`s and resolved only when `fetch_window` (default
    `DEFAULT_IN_FLIGHT`, 2) of them are outstanding, so the host
    enqueues the next step while the device computes. The losses are
    the same as with synchronous fetching. A per-step loss CONSUMER
    forces fetch_window=1: health numerics checks and recovery
    controllers must see step N's loss before step N+1 runs.
    """
    import time as _time

    from collections import deque as _deque

    from ..core import async_exec as _async
    from ..observability import events as _events
    from ..observability import health as _health
    from ..ps import errors as _ps_errors
    from ..resilience import faults as _faults
    from ..resilience import preemption as _preempt

    _preempt.maybe_install_from_env()
    if resize_check is not None and (manager is None or not save_every):
        raise ValueError(
            "resize_check requires manager + save_every — without "
            "periodic checkpoints there is no boundary at which it is "
            "ever consulted")
    if controller is not None:
        controller.attach()
    rng = 0 if rng is None else int(rng)
    get_batch = batches if callable(batches) else None
    batch_iter = iter(batches) if get_batch is None else None
    losses: Dict[int, float] = {}
    steps_done = 0
    stop = "completed"
    window = max(1, int(fetch_window or _async.DEFAULT_IN_FLIGHT))
    if controller is not None or _health.check_level():
        window = 1  # per-step loss consumers need the value NOW
    pending: "_deque[Tuple[int, Any]]" = _deque()

    def _resolve_oldest():
        step_i, h = pending.popleft()
        # backpressure keeping run-ahead bounded, not a pipeline stall
        losses[step_i] = float(h.result(stall=False)[0])

    amp_seen = sync_loss_scale_metrics(state) \
        if getattr(state, "loss_scale", None) is not None else None
    t0 = _time.perf_counter()
    try:
        while True:
            if max_steps is not None and steps_done >= max_steps:
                stop = "exhausted"
                break
            step_no = int(state.step)
            _faults.check("step", step=step_no)
            if _preempt.stop_requested():
                stop = "preempted"
                if manager is not None and not manager.is_committed(
                        manager.step_dir(step_no)):
                    manager.save(state)
                break
            if controller is not None and controller.should_act():
                action, state = controller.handle(None, state,
                                                  step=step_no)
                if action == "rollback":
                    continue  # step_no re-derives from the rewound state
            if get_batch is not None:
                batch = get_batch(step_no)
                if batch is None:
                    break
            else:
                batch = next(batch_iter, None)
                if batch is None:
                    break
            try:
                state, loss = step_fn(state, batch, step_seed(rng, step_no))
                if window > 1:
                    # resolve-first: never more than `window` handles
                    # (and their device buffers) outstanding at once
                    while len(pending) >= window:
                        _resolve_oldest()
                    pending.append((step_no, _async.FetchHandle([loss])))
                else:
                    loss_val = float(loss)
                    if _health.check_level():
                        _health.check_numerics(
                            "trainer_loss", [("loss", loss_val)],
                            step=step_no)
                    losses[step_no] = loss_val
                    if amp_seen is not None:
                        # overflow events carry exact step attribution
                        amp_seen = sync_loss_scale_metrics(state,
                                                           amp_seen)
            except (_health.NumericsError, _ps_errors.PSUnavailableError) \
                    as e:
                # PSUnavailableError: a PS pull/push exhausted its retry
                # budget mid-step; routed through the same
                # RecoveryPolicy as a numerics anomaly
                if controller is None:
                    raise
                action, state = controller.handle(e, state, step=step_no)
                if action == "skip_batch":
                    steps_done += 1
                continue
            steps_done += 1
            if (manager is not None and save_every
                    and int(state.step) % save_every == 0):
                manager.save(state)
                if resize_check is not None and resize_check():
                    stop = "resize"
                    break
    finally:
        while pending:  # drain: every executed step's loss lands
            _resolve_oldest()
        if amp_seen is not None:
            # async mode: aggregate outcome counts land at drain time
            amp_seen = sync_loss_scale_metrics(state, amp_seen)
        if controller is not None:
            controller.detach()
    seconds = _time.perf_counter() - t0
    _events.emit("step_summary", site="train_loop", steps=steps_done,
                 stop=stop, final_step=int(state.step),
                 seconds=round(seconds, 6))
    return state, losses, stop
