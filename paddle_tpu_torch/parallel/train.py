"""Train-step builder on one device.

Counterpart of the JAX package's `parallel/train.py::make_train_step`
with the semantics of its one-device case: `init_state(params)` then
`step(state, batch, rng) -> (state, loss)`. What differs, and why:

- No mesh, shardings or ZeRO-1: one device, named by `device` (cuda
  unless "cpu"). Multi-device training is a later slice.
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
- Mixed policies read `finite` on the host once a step (one device
  sync) and skip the optimizer when it is False; the JAX step selects
  on the device. Params and optimizer state keep their pre-step values
  either way.
- `train_loop` (checkpoints, elastic resizing, preemption) is not
  ported yet, and the "dots" recompute policies raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import precision as _precision
from ..models.common import Params, is_trainable

__all__ = ["TrainStrategy", "TrainState", "make_train_step",
           "RECOMPUTE_POLICIES"]

# None and "nothing" save nothing and recompute everything; the "dots"
# policies of jax.checkpoint (keep matmul outputs) are not ported yet
RECOMPUTE_POLICIES = (None, "nothing", "dots", "dots_no_batch")


@dataclasses.dataclass
class TrainStrategy:
    """The knobs of the JAX package's TrainStrategy that mean something
    on one device."""

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
                    has_aux: bool = False, precision=None):
    """Returns (init_state, step).

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
    policy = _precision.resolve(precision)
    dev = resolve_device(device)
    if strategy.recompute_policy not in RECOMPUTE_POLICIES:
        raise ValueError(
            f"unknown recompute_policy {strategy.recompute_policy!r}; "
            f"choose from {[p for p in RECOMPUTE_POLICIES if p]} or None")
    if strategy.recompute_policy is not None and not strategy.recompute:
        raise ValueError("recompute_policy is set but recompute=False — "
                         "enable recompute=True for the policy to take "
                         "effect")
    if strategy.recompute and strategy.recompute_policy in (
            "dots", "dots_no_batch"):
        raise NotImplementedError(
            f"recompute_policy {strategy.recompute_policy!r} (save matmul "
            f"outputs) is not ported; use None or 'nothing'")
    n_acc = int(strategy.accum_steps)
    use_amp = policy.dynamic_loss_scale and policy.compute_dtype is not None

    def run_loss(fn, params, batch, seed):
        def call(p, b, s):
            gen = None if s is None else \
                torch.Generator(device=dev).manual_seed(s)
            return fn(p, b, gen)

        if strategy.recompute:
            return checkpoint(call, params, batch, seed, use_reentrant=False)
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
        opt = optimizer([v for k, v in out.items() if is_trainable(k)])
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
