"""Optimizer ops of the fluid path: the JAX package's
`ops/optimizer_ops.py` on torch, all 17 of its op types (reference:
paddle/fluid/operators/optimizers/: sgd_op.cc, momentum_op.cc,
adam_op.cc, lamb_op.cc, lars_momentum_op.cc, ...).

Each is plain torch, the same arithmetic as the XLA ops of the
reference, in the same dtypes: the learning rate, Adam's and Lamb's
moments and Lamb's trust ratio in f32, and `ParamOut` cast back to the
param's dtype where the JAX package casts it. All are grad=None and
functional: they return the updated state, which the executor writes
back to the scope in place of the old.

SelectedRows gradients (`core/selected_rows.py`, a sparse embedding's)
take the JAX package's branches: `sgd`, `adagrad` and `adam` with
`lazy_mode` update only the touched rows, after merging repeated ids;
`adam` without `lazy_mode` and the ops with no sparse branch densify
(`_dense_grad`), as the reference does where no SelectedRows kernel is
registered.

`dpsgd` draws its noise from the op's generator (`KernelCtx.rng`, seeded
by the step seed and the op's `__rng_uid__`), so a streamed run and a
run step by step draw the same bits; torch cannot reproduce the JAX
package's `jax.random` stream, so only its law is shared. `dgc_momentum`
with an `axis_name` reduces its compressed gradients over the ranks of
an SPMD run: `core/lockstep.py` runs it through `dgc_momentum_ranks`
with the ring's `sparse_allreduce` (`ops/collective.py`).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core.registry import ShapeDtype, register_op
from ..core.selected_rows import is_selected_rows, to_dense


def _lr(ins):
    lr = ins["LearningRate"][0]
    return lr.reshape(()) if lr.ndim else lr


def _dense_grad(ins):
    """The gradient, a SelectedRows densified, for the kernels without a
    sparse branch (the reference falls back the same way where no
    SelectedRows kernel is registered)."""
    return to_dense(ins["Grad"][0])


def _scalar(t):
    return t.reshape(())


@register_op("sgd", grad=None)
def sgd(ins, attrs, ctx):
    """reference: optimizers/sgd_op.cc, the dense branch and the
    SelectedRows one (sgd_op.h): only the touched rows move; repeated
    ids are merged first, so the update equals the dense one."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins).to(p.dtype)
    if is_selected_rows(g):
        ids, rows = g.merged()
        return {"ParamOut": torch.index_copy(
            p, 0, ids, p.index_select(0, ids) - lr * rows.to(p.dtype))}
    return {"ParamOut": p - lr * g.to(p.dtype)}


@register_op("momentum", grad=None)
def momentum(ins, attrs, ctx):
    """reference: optimizers/momentum_op.cc. Its SparseMomentumFunctor
    walks the whole parameter with g=0 where a row is absent, which is
    the dense update, so a sparse gradient densifies."""
    p, g, v = ins["Param"][0], _dense_grad(ins), ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins).to(p.dtype)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("lars_momentum", grad=None)
def lars_momentum(ins, attrs, ctx):
    """reference: optimizers/lars_momentum_op.cc: layer-wise adaptive
    rate scaling for large-batch training."""
    p, g, v = ins["Param"][0], _dense_grad(ins), ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    lr = _lr(ins).to(p.dtype)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
        lr)
    v_new = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": p - v_new, "VelocityOut": v_new}


@register_op("adam", grad=None)
def adam(ins, attrs, ctx):
    """reference: optimizers/adam_op.cc (Beta1Pow/Beta2Pow threaded as
    1-element tensors). A SelectedRows gradient follows `lazy_mode`
    (adam_op.h SparseAdamFunctor): off (the default) is the dense
    update, every row's moments decaying, so it densifies; on merges the
    repeated ids and updates only the touched rows, whose moments alone
    decay."""
    p, g = ins["Param"][0], ins["Grad"][0]
    if is_selected_rows(g) and not bool(attrs.get("lazy_mode", False)):
        g = g.to_dense()
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins).to(torch.float32)
    lr_t = lr * torch.sqrt(1 - _scalar(b2p)) / (1 - _scalar(b1p))
    if is_selected_rows(g):
        ids, rows = g.merged()
        rows = rows.to(torch.float32)
        m1i = b1 * m1.index_select(0, ids) + (1 - b1) * rows
        m2i = b2 * m2.index_select(0, ids) + (1 - b2) * torch.square(rows)
        step = lr_t * m1i / (torch.sqrt(m2i) + eps)
        p_i = p.index_select(0, ids) - step.to(p.dtype)
        return {"ParamOut": torch.index_copy(p, 0, ids, p_i),
                "Moment1Out": torch.index_copy(m1, 0, ids, m1i.to(m1.dtype)),
                "Moment2Out": torch.index_copy(m2, 0, ids, m2i.to(m2.dtype)),
                "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {"ParamOut": p_new.to(p.dtype), "Moment1Out": m1n,
            "Moment2Out": m2n, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}


@register_op("adamw", grad=None)
def adamw(ins, attrs, ctx):
    """Adam, then the decoupled decay `lr * coeff * param`."""
    outs = adam(ins, attrs, ctx)
    wd = attrs.get("coeff", attrs.get("weight_decay", 0.01))
    p = ins["Param"][0]
    lr = _lr(ins).to(p.dtype)
    outs["ParamOut"] = outs["ParamOut"] - lr * wd * p
    return outs


@register_op("adamax", grad=None)
def adamax(ins, attrs, ctx):
    """reference: optimizers/adamax_op.cc (Beta1Pow advanced by the
    optimizer's own `scale` op)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m, u = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins).to(p.dtype)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p - (lr / (1 - _scalar(b1p))) * m_new / (u_new + eps)
    return {"ParamOut": p_new, "MomentOut": m_new, "InfNormOut": u_new}


@register_op("adagrad", grad=None)
def adagrad(ins, attrs, ctx):
    """reference: optimizers/adagrad_op.cc with its SelectedRows branch
    (repeated ids merged, the touched rows updated)."""
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins).to(p.dtype)
    if is_selected_rows(g):
        ids, rows = g.merged()
        rows = rows.to(p.dtype)
        mom_i = mom.index_select(0, ids) + torch.square(rows)
        step = lr * rows / (torch.sqrt(mom_i) + eps)
        return {"ParamOut": torch.index_copy(
                    p, 0, ids, p.index_select(0, ids) - step),
                "MomentOut": torch.index_copy(mom, 0, ids, mom_i)}
    mom_new = mom + torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_new) + eps),
            "MomentOut": mom_new}


@register_op("decayed_adagrad", grad=None)
def decayed_adagrad(ins, attrs, ctx):
    """reference: optimizers/decayed_adagrad_op.cc."""
    p, g, mom = ins["Param"][0], _dense_grad(ins), ins["Moment"][0]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins).to(p.dtype)
    mom_new = decay * mom + (1 - decay) * torch.square(g)
    return {"ParamOut": p - lr * g / (torch.sqrt(mom_new) + eps),
            "MomentOut": mom_new}


@register_op("adadelta", grad=None)
def adadelta(ins, attrs, ctx):
    """reference: optimizers/adadelta_op.cc (no learning rate)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    avg_sq, avg_upd = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    avg_sq_new = rho * avg_sq + (1 - rho) * torch.square(g)
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(avg_sq_new + eps) * g
    avg_upd_new = rho * avg_upd + (1 - rho) * torch.square(upd)
    return {"ParamOut": p - upd, "AvgSquaredGradOut": avg_sq_new,
            "AvgSquaredUpdateOut": avg_upd_new}


@register_op("rmsprop", grad=None)
def rmsprop(ins, attrs, ctx):
    """reference: optimizers/rmsprop_op.cc, plain and centered."""
    p, g = ins["Param"][0], _dense_grad(ins)
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    lr = _lr(ins).to(p.dtype)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg_new = rho * mg + (1 - rho) * g
        mom_new = mu * mom + lr * g / torch.sqrt(
            ms_new - torch.square(mg_new) + eps)
        return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
                "MomentOut": mom_new, "MeanGradOut": mg_new}
    mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new,
            "MomentOut": mom_new}


@register_op("ftrl", grad=None)
def ftrl(ins, attrs, ctx):
    """reference: optimizers/ftrl_op.cc."""
    p, g = ins["Param"][0], _dense_grad(ins)
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins).to(p.dtype)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    quad = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    return {"ParamOut": pre / quad, "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


@register_op("lamb", grad=None)
def lamb(ins, attrs, ctx):
    """reference: optimizers/lamb_op.cc: layer-adaptive large-batch Adam
    (moments, update and trust ratio in f32)."""
    p, g = ins["Param"][0], _dense_grad(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    lr = _lr(ins).to(torch.float32)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    m1h = m1n / (1 - _scalar(b1p))
    m2h = m2n / (1 - _scalar(b2p))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm)).to(torch.float32)
    p_new = p - lr * trust * r
    return {"ParamOut": p_new.to(p.dtype), "Moment1Out": m1n,
            "Moment2Out": m2n, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}


@register_op("dpsgd", grad=None, is_random=True)
def dpsgd(ins, attrs, ctx):
    """reference: optimizers/dpsgd_op.cc: differentially private SGD,
    the gradient clipped to norm `clip`, then gaussian noise of std
    sigma * clip added, divided by the batch size."""
    p, g = ins["Param"][0], _dense_grad(ins)
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    lr = _lr(ins).to(p.dtype)
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    g = g / torch.clamp(g_norm / clip, min=1.0)
    noise = sigma * clip * torch.randn(g.shape, generator=ctx.rng(),
                                       dtype=torch.float32, device=g.device)
    return {"ParamOut": p - lr * (g + noise.to(p.dtype)) / batch_size}


# -- DGC: deep gradient compression (reference: optimizers/dgc_momentum_op
# and details/sparse_all_reduce_op_handle.cc:44; arxiv 1712.01887) --------


def _dgc_infer(op, input_descs):
    """Every output mirrors Param's shape and dtype (the generic
    inference would run the kernel, whose axis form has no ranks)."""
    p = input_descs[op.inputs["Param"][0]]
    sd = ShapeDtype(tuple(p.shape or ()), p.dtype)
    return {n: sd for slot in ("ParamOut", "UOut", "VOut", "GradOut")
            for n in op.outputs.get(slot, []) if n}


def _dgc_k(numel: int, attrs) -> int:
    return max(1, int(numel * attrs.get("sparsity_ratio", 0.001)))


def _dgc_compress(ins, attrs):
    """(u_out, v_out, the compressed gradient, k): momentum correction,
    then the top k = max(1, int(size * ratio)) of |v| by threshold (the
    k-th largest |v|, kept where |v| >= it), the rest kept locally."""
    g = _dense_grad(ins)
    u, v = ins["U"][0], ins["V"][0]
    mu = attrs.get("mu", 0.9)
    u_new = mu * u + g
    v_new = v + u_new
    flat = torch.abs(v_new).reshape(-1)
    k = _dgc_k(flat.numel(), attrs)
    thresh = torch.topk(flat, k).values[-1]
    mask = torch.abs(v_new) >= thresh
    zero = torch.zeros((), dtype=v_new.dtype, device=v_new.device)
    sparse = torch.where(mask, v_new, zero)
    return (torch.where(mask, zero, u_new), torch.where(mask, zero, v_new),
            sparse, k)


def _dgc_apply(ins, u_out, v_out, sparse):
    p = ins["Param"][0]
    lr = _lr(ins).to(p.dtype)
    return {"ParamOut": p - lr * sparse, "UOut": u_out, "VOut": v_out,
            "GradOut": sparse}


@register_op("dgc_momentum", grad=None, infer_shape=_dgc_infer)
def dgc_momentum(ins, attrs, ctx):
    """Top-k sparsified momentum step. The compression (only the top-k
    of the accumulated gradient applied, the rest accumulated in U and
    V) is the reference's. With an `axis_name` the ranks' compressed
    gradients are reduced before the update, which needs every rank:
    SPMDRunner's lockstep calls `dgc_momentum_ranks` for that, and a
    run outside it raises."""
    if attrs.get("axis_name"):
        raise RuntimeError(
            f"dgc_momentum with axis_name={attrs['axis_name']!r} reduces "
            f"over the ranks of an SPMD run; run the program under "
            f"parallel.SPMDRunner")
    u_out, v_out, sparse, _ = _dgc_compress(ins, attrs)
    return _dgc_apply(ins, u_out, v_out, sparse)


def dgc_momentum_ranks(rank_ins: List[Dict], attrs) -> List[Dict]:
    """`dgc_momentum` over the ranks of an SPMD run: each rank
    compresses its own gradient, the ring's `sparse_allreduce` sums
    every rank's top-k entries (the JAX package's sparse allgather), and
    every rank applies the sum."""
    from .collective import sparse_allreduce

    parts = [_dgc_compress(ins, attrs) for ins in rank_ins]
    shape = parts[0][2].shape
    reduced = sparse_allreduce([s.reshape(-1) for _, _, s, _ in parts],
                               parts[0][3]).reshape(shape)
    return [_dgc_apply(ins, u, v, reduced)
            for ins, (u, v, _, _) in zip(rank_ins, parts)]


@register_op("proximal_gd", grad=None)
def proximal_gd(ins, attrs, ctx):
    """reference: optimizers/proximal_gd_op.cc: prox = p - lr * g, then
    soft-threshold by l1 and shrink by l2."""
    p, g = ins["Param"][0], _dense_grad(ins)
    lr = _lr(ins).to(p.dtype)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    prox = p - lr * g.to(p.dtype)
    if l1 > 0:
        new_p = (torch.sign(prox)
                 * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
                 / (1.0 + lr * l2))
    else:
        new_p = prox / (1.0 + lr * l2)
    return {"ParamOut": new_p}


@register_op("proximal_adagrad", grad=None)
def proximal_adagrad(ins, attrs, ctx):
    """reference: optimizers/proximal_adagrad_op.cc."""
    p, g, m = ins["Param"][0], _dense_grad(ins), ins["Moment"][0]
    lr = _lr(ins).to(p.dtype)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    g = g.to(p.dtype)
    m_new = m + g * g
    eff_lr = lr / torch.sqrt(m_new)
    prox = p - eff_lr * g
    if l1 > 0:
        new_p = (torch.sign(prox)
                 * torch.clamp(torch.abs(prox) - eff_lr * l1, min=0.0)
                 / (1.0 + eff_lr * l2))
    else:
        new_p = prox / (1.0 + eff_lr * l2)
    return {"ParamOut": new_p, "MomentOut": m_new}


@register_op("average_accumulates", grad=None,
             nondiff_inputs=("param", "in_sum_1", "in_sum_2", "in_sum_3",
                             "in_num_accumulates", "in_old_num_accumulates",
                             "in_num_updates"))
def average_accumulates(ins, attrs, ctx):
    """reference: average_accumulates_op.h, ModelAverage's accumulator
    update: sum_1 += param each step; every 16384 updates sum_1 rolls
    into sum_2; when num_accumulates reaches max(avg_window *
    num_updates, min_window) (capped by max_window), sum_3 <- sum_1 +
    sum_2 and the window restarts. Counters are int32, and the window
    is the int32 of an f32 product, as there."""
    k_max = 16384
    i32 = torch.int32
    p = ins["param"][0]
    s1, s2, s3 = ins["in_sum_1"][0], ins["in_sum_2"][0], ins["in_sum_3"][0]
    na = ins["in_num_accumulates"][0].reshape(()).to(i32)
    ona = ins["in_old_num_accumulates"][0].reshape(()).to(i32)
    nu = ins["in_num_updates"][0].reshape(()).to(i32)
    avg_win = float(attrs.get("average_window", 0.0))
    max_win = int(attrs.get("max_average_window", 2 ** 31 - 1))
    min_win = int(attrs.get("min_average_window", 10000))

    nu = nu + 1
    na = na + 1
    s1 = s1 + p
    roll16k = (nu % k_max) == 0
    s2 = torch.where(roll16k, s2 + s1, s2)
    s1 = torch.where(roll16k, torch.zeros_like(s1), s1)
    prod = (torch.tensor(avg_win, dtype=torch.float32, device=nu.device)
            * nu.to(torch.float32)).to(i32)
    window = torch.clamp(torch.clamp(prod, min=min_win), max=max_win)
    restart = na >= window
    s3 = torch.where(restart, s1 + s2, s3)
    s1 = torch.where(restart, torch.zeros_like(s1), s1)
    s2 = torch.where(restart, torch.zeros_like(s2), s2)
    ona = torch.where(restart, na, ona)
    na = torch.where(restart, torch.zeros_like(na), na)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": na.reshape(1),
            "out_old_num_accumulates": ona.reshape(1),
            "out_num_updates": nu.reshape(1)}
