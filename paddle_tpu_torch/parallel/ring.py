"""The ring of one mesh axis: the counterpart of `jax.lax.ppermute` over
that axis with `perm = [(i, (i + 1) % S)]`, as the JAX package's ring
attention calls it.

A ring holds the ranks this process runs, as lists with one entry per
local rank: `split` cuts a tensor into them, `join` puts them back,
`hop` moves every rank's tensors one rank on (rank r's to r + 1),
`all_reduce` gives every rank the sum (or max) of the ranks' tensors
(`jax.lax.psum`, `pmax`) and `all_gather` gives every rank all of them
joined along a dim (`jax.lax.all_gather(..., tiled=True)`).

- `InProcessRing`: S virtual ranks in one process on one device. It
  holds all S shards; a hop rotates each list, an all-reduce adds the
  list up once and hands every rank that one tensor. Autograd sees a
  hop as the identity on each tensor and an all-reduce as the sum it
  is (its backward is the sum of the ranks' incoming gradients, handed
  to every rank), so gradients need nothing extra.
- `ProcessRing`: one rank per process over `torch.distributed`. A hop
  sends to (r + 1) % S and receives from (r - 1) % S in one
  `batch_isend_irecv`, NCCL for cuda tensors and gloo for cpu tensors;
  a backend that cannot carry the tensor's device raises. Under
  autograd a hop is `_Hop`, whose backward is the reverse hop, as the
  transpose of `ppermute` is the inverse permutation; a summing
  all-reduce is `_AllReduce`, whose backward all-reduces the gradient,
  and an all-gather `_AllGather`, whose backward keeps this rank's
  slice of the all-reduced gradient. Nothing on the card calls these
  two yet: the models' dp and tp run on the in-process ring (ROADMAP
  item 20a lifts them to processes).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

__all__ = ["Ring", "InProcessRing", "ProcessRing", "check_backend"]

Streams = Tuple[List[torch.Tensor], ...]


class InProcessRing:
    """S virtual ranks, run in turn by one process on one device."""

    def __init__(self, size: int):
        self.size = int(size)
        self.ranks = list(range(self.size))

    def split(self, x: torch.Tensor, dim: int,
              even: bool = True) -> List[torch.Tensor]:
        """Rank r's shard is the r-th of S equal, contiguous chunks. With
        `even=False` a size n that S does not divide is cut as
        `torch.tensor_split` cuts it: the first n % S ranks hold one
        more (with n < S the last ranks hold none)."""
        if not even:
            return list(torch.tensor_split(x, self.size, dim))
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over a ring of {self.size}")
        return [c.contiguous() for c in x.chunk(self.size, dim)]

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return torch.cat(list(xs), dim)

    def hop(self, *streams: List[torch.Tensor]) -> Streams:
        """Rank r + 1 receives rank r's entry of every stream."""
        S = self.size
        return tuple([s[(r - 1) % S] for r in range(S)] for s in streams)

    def all_reduce(self, xs: Sequence[torch.Tensor],
                   op: str = "sum") -> List[torch.Tensor]:
        """Every rank's entry of `xs` reduced by `op` ("sum" or "max"),
        one tensor handed to every rank. The sum is taken in rank order."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} tensors for a ring of {self.size}")
        if op == "sum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
        elif op == "max":
            out = torch.stack(list(xs)).amax(0)
        else:
            raise ValueError(f"all_reduce op must be sum or max, got {op!r}")
        return [out] * self.size

    def all_gather(self, xs: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """Every rank's entry joined along `dim`, handed to every rank."""
        return [self.join(xs, dim)] * self.size


def check_backend(backend: str, device: torch.device) -> None:
    """Raise unless a process group of `backend` carries tensors on
    `device` point to point: NCCL carries cuda, gloo cpu."""
    carries = {"nccl": "cuda", "gloo": "cpu"}.get(str(backend))
    if carries != torch.device(device).type:
        raise ValueError(f"a {backend} process group cannot carry "
                         f"{torch.device(device).type} tensors around the "
                         f"ring (NCCL carries cuda, gloo cpu)")


class ProcessRing:
    """This process's rank of a ring of `size` processes. `group` is the
    process group along the axis (None for the world)."""

    def __init__(self, group, size: int, rank: int):
        import torch.distributed as dist

        self.group, self.size, self.rank = group, int(size), int(rank)
        self.ranks = [self.rank]
        self.backend = dist.get_backend(group)
        # global rank of each ring position, for the P2P peers
        self._peers = dist.get_process_group_ranks(
            group or dist.group.WORLD)
        if len(self._peers) != self.size:
            raise ValueError(f"process group of {len(self._peers)} ranks "
                             f"for a ring of {self.size}")

    def split(self, x: torch.Tensor, dim: int,
              even: bool = True) -> List[torch.Tensor]:
        return [x]

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def send_recv(self, tensors: Sequence[torch.Tensor],
                  shift: int) -> List[torch.Tensor]:
        """Send each tensor to ring position r + shift and receive its
        counterpart from r - shift, all in one batch."""
        import torch.distributed as dist

        S, r = self.size, self.rank
        dst, src = self._peers[(r + shift) % S], self._peers[(r - shift) % S]
        ops, outs = [], []
        for t in tensors:
            check_backend(self.backend, t.device)
            t = t.contiguous()
            out = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, out, src, self.group))
            outs.append(out)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def hop(self, *streams: List[torch.Tensor]) -> Streams:
        moved = _Hop.apply(self, *(s[0] for s in streams))
        return tuple([t] for t in moved)

    def all_reduce(self, xs: Sequence[torch.Tensor],
                   op: str = "sum") -> List[torch.Tensor]:
        """This rank's tensor reduced over the ring by `op` ("sum" or
        "max"; max carries no gradient)."""
        import torch.distributed as dist

        check_backend(self.backend, xs[0].device)
        if op == "sum":
            return [_AllReduce.apply(self.group, xs[0])]
        if op != "max":
            raise ValueError(f"all_reduce op must be sum or max, got {op!r}")
        out = xs[0].detach().clone()
        dist.all_reduce(out, dist.ReduceOp.MAX, group=self.group)
        return [out]

    def all_gather(self, xs: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
        """Every rank's tensor (of one shape) joined along `dim`."""
        check_backend(self.backend, xs[0].device)
        return [_AllGather.apply(self, dim, xs[0])]


class _Hop(torch.autograd.Function):
    """One forward hop on a process ring; its gradient is the reverse
    hop (a cotangent that is None travels as zeros, so every rank sends
    and receives the same tensors)."""

    @staticmethod
    def forward(ctx, ring: ProcessRing, *xs):
        ctx.ring = ring
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(ring.send_recv(xs, 1))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=d, device=dev) if g is None else g
              for g, (s, d, dev) in zip(gs, ctx.shapes)]
        return (None, *ctx.ring.send_recv(gs, -1))


class _AllReduce(torch.autograd.Function):
    """A summing all-reduce; its gradient is the all-reduced gradient."""

    @staticmethod
    def forward(ctx, group, x):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


class _AllGather(torch.autograd.Function):
    """All ranks' tensors joined along a dim; the gradient of this
    rank's tensor is its slice of the all-reduced gradient."""

    @staticmethod
    def forward(ctx, ring, dim, x):
        import torch.distributed as dist

        ctx.ring, ctx.dim, ctx.n = ring, dim, x.shape[dim]
        parts = [torch.empty_like(x.contiguous()) for _ in range(ring.size)]
        dist.all_gather(parts, x.contiguous(), group=ring.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ring.group)
        return None, None, g.narrow(ctx.dim, ctx.ring.rank * ctx.n, ctx.n)


Ring = Union[InProcessRing, ProcessRing]
