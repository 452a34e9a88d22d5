"""Collective ops of the fluid path: the JAX package's
`ops/collective.py` on the in-process dp ring (`core/ring.py`).

Reference: paddle/fluid/operators/collective/ — c_allreduce_{sum,max,
min,prod}, c_broadcast, c_allgather, c_reducescatter, the comm-bootstrap
ops (c_comm_init, c_gen_nccl_id) and the stream-sync ops.

The JAX package lowers them to `jax.lax` collectives over the mesh axis
that `axis_name` names (default "data"), inside `shard_map`. The port
runs a data-parallel program in lockstep over the ranks of a ring
(`core/lockstep.py`): every rank's op runs before the next op, so a
collective sees every rank's input at once. `COLLECTIVES` holds each
op's rank-wise form, `fn(xs, attrs, ring) -> outs` with one tensor per
rank in and out, and the rank-wise form of the gradient of the five
that have one (`c_allreduce_sum`, `c_broadcast`, `c_allgather`,
`c_reducescatter`, `c_ppermute`), each the transpose of the JAX
collective: psum's is psum, all_gather's the summing scatter and back,
ppermute's the inverse permutation.

Outside such a run (a plain `Executor.run`) each of them raises, naming
itself: there are no ranks to reduce over, and acting as the identity
would pass for a reduction. The seven bootstrap and stream ops are
no-ops there as in the JAX package (no NCCL ring to build, one stream
in order), and raise outside as well. `c_embedding` holds no collective
(the vocab shard's lookup; a later `c_allreduce_sum` combines the
shards), so it runs anywhere, as it does in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..core.ir import normalize_dtype
from ..core.registry import ShapeDtype, register_op
from .tensor import stable_top_k


def _same_shape_infer(op, input_descs):
    """Collectives keep (or statically transform) shapes. Inference never
    runs their kernels, which raise outside a data-parallel run."""
    out = {}
    in_names = op.inputs.get("X", [])
    out_names = op.outputs.get("Out", [])
    for i, n in enumerate(out_names):
        if not n:
            continue
        src = input_descs[in_names[min(i, len(in_names) - 1)]]
        shape = list(src.shape or ())
        nranks = int(op.attrs.get("nranks", 0))
        if op.type == "c_allgather" and nranks and shape:
            shape[0] = shape[0] * nranks if shape[0] != -1 else -1
        elif op.type == "c_reducescatter" and nranks and shape:
            shape[0] = shape[0] // nranks if shape[0] != -1 else -1
        out[n] = ShapeDtype(tuple(shape), normalize_dtype(src.dtype))
    return out


def _outside(ins, attrs, ctx):
    raise RuntimeError(
        f"{ctx.op.type} runs over the ranks of a data-parallel run "
        f"(parallel.SPMDRunner), at the top level of the program or in a "
        f"cond branch; here there are no ranks to reduce over")


def _register(name, grad="generic"):
    register_op(name, grad=grad, infer_shape=_same_shape_infer)(_outside)


def _one(out, ring) -> List[torch.Tensor]:
    """One tensor handed to every rank."""
    return [out] * ring.size


def _chunks(x, ring) -> List[torch.Tensor]:
    if x.shape[0] % ring.size:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split over "
                         f"the {ring.size} ranks")
    return list(x.chunk(ring.size, 0))


def _allreduce_sum(xs, attrs, ring):
    return ring.all_reduce(xs, "sum")


def _allreduce_max(xs, attrs, ring):
    return ring.all_reduce(xs, "max")


def _allreduce_min(xs, attrs, ring):
    return _one(-ring.all_reduce([-x for x in xs], "max")[0], ring)


def _allreduce_prod(xs, attrs, ring):
    # exp(psum(log x)), as the JAX package computes it: a negative entry
    # gives NaN, a zero gives 0
    return _one(torch.exp(ring.all_reduce([torch.log(x) for x in xs])[0]),
                ring)


def _broadcast(xs, attrs, ring):
    return _one(xs[int(attrs.get("root", 0))], ring)


def _broadcast_grad(gs, attrs, ring):
    # transpose of psum(where(rank == root, x, 0)): the root takes the
    # summed gradient, every other rank zeros
    root = int(attrs.get("root", 0))
    total = ring.all_reduce(gs)[0]
    return [total if r == root else torch.zeros_like(g)
            for r, g in enumerate(gs)]


def _allgather(xs, attrs, ring):
    return ring.all_gather(xs, 0)


def _reducescatter(xs, attrs, ring):
    return _chunks(ring.all_reduce(xs)[0], ring)


def _shift(attrs):
    return int(attrs.get("shift", 1))


def _ppermute(xs, attrs, ring):
    # rank i's tensor goes to rank (i + shift) % n
    n, s = ring.size, _shift(attrs)
    return [xs[(r - s) % n] for r in range(n)]


def _ppermute_grad(gs, attrs, ring):
    n, s = ring.size, _shift(attrs)
    return [gs[(r + s) % n] for r in range(n)]


def sparse_allreduce(flats: List[torch.Tensor], k: int) -> torch.Tensor:
    """The JAX package's `sparse_allreduce` over the ranks' flat tensors:
    each rank's top-k entries by magnitude (values in f32, indices),
    gathered from every rank and scatter-added into zeros, in rank
    order: 2k numbers a rank on the wire instead of the dense size."""
    k = min(int(k), flats[0].numel())
    vals, idxs = [], []
    for flat in flats:
        _, idx = stable_top_k(flat.abs(), k)
        vals.append(flat[idx].to(torch.float32))
        idxs.append(idx)
    flat = flats[0]
    return torch.zeros_like(flat).index_add_(
        0, torch.cat(idxs), torch.cat(vals).to(flat.dtype))


def _dgc_allreduce(xs, attrs, ring):
    k = int(attrs.get("k", max(1, xs[0].numel() // 1000)))
    out = sparse_allreduce([x.reshape(-1) for x in xs], k)
    return _one(out.reshape(xs[0].shape), ring)


def _noop(xs, attrs, ring):
    return list(xs)


RankFn = Callable[[List[torch.Tensor], Dict, object], List[torch.Tensor]]

# op type -> its rank-wise form over the X (forward) or out_grad::Out
# (gradient) inputs, one tensor a rank
COLLECTIVES: Dict[str, RankFn] = {
    "c_allreduce_sum": _allreduce_sum,
    "c_allreduce_sum_grad": _allreduce_sum,
    "c_allreduce_max": _allreduce_max,
    "c_allreduce_min": _allreduce_min,
    "c_allreduce_prod": _allreduce_prod,
    "c_broadcast": _broadcast,
    "c_broadcast_grad": _broadcast_grad,
    "c_allgather": _allgather,
    "c_allgather_grad": _reducescatter,
    "c_reducescatter": _reducescatter,
    "c_reducescatter_grad": _allgather,
    "c_ppermute": _ppermute,
    "c_ppermute_grad": _ppermute_grad,
    "c_dgc_allreduce": _dgc_allreduce,
}

# Bootstrap / stream ops: no-ops over the ranks (module docstring).
NOOPS = ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id",
         "c_sync_calc_stream", "c_sync_comm_stream", "c_wait_compute",
         "c_wait_comm")
for _name in NOOPS:
    COLLECTIVES[_name] = _noop
    _register(_name, grad=None)

for _name in ("c_allreduce_sum", "c_broadcast", "c_allgather",
              "c_reducescatter", "c_ppermute"):
    _register(_name)
for _name in ("c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
              "c_dgc_allreduce"):
    _register(_name, grad=None)


@register_op("c_embedding", nondiff_inputs=("Ids",))
def c_embedding(ins, attrs, ctx):
    """Sharded embedding lookup (vocab-parallel): this shard holds rows
    [start, start + per_part); an id outside it gives zeros, which a
    later all-reduce over the shards fills in (reference:
    collective/c_embedding_op.cc)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    start = int(attrs.get("start_index", 0))
    idx = ids.to(torch.int64) - start
    valid = (idx >= 0) & (idx < w.shape[0])
    out = w[idx.clamp(0, w.shape[0] - 1)]
    return {"Out": torch.where(valid[..., None], out, torch.zeros_like(out))}
