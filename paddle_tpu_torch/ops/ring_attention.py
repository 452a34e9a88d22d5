"""Ring attention: exact attention with the sequence split over the `sp`
ring of a mesh.

Counterpart of the JAX package's `ops/pallas/ring_attention.py`. Each
rank holds a `[B, T/S, N, H]` shard of q, k and v; the k/v blocks go
round the ring (`core/ring.py`, the counterpart of `ppermute`)
while each rank merges its partial results, so no rank holds the whole
sequence's scores.

- `ring_attention`: causal or full, blocks in plain torch (the JAX
  package computes them with XLA einsums, no kernel), merged by an
  online softmax; differentiated by autograd through the hops.
- `ring_splash`: full mask only, each block on K3 (`kernels/
  flash_attention.py::splash_block_with_lse`, CUDA) and merged by
  logsumexp; the `RingSplash` autograd Function, whose backward is the
  JAX package's blockwise ring backward in f32 einsums against the
  merged LSE, with the dk/dv accumulators riding round the ring with
  their block. `ring_splash_ref` is the same ring with K3's plain
  version in every block.

Both take the mesh's ring: on an in-process ring (one device, S virtual
ranks) the full `[B, T, N, H]` tensors, split along T, with the ranks
run in turn at every step and the outputs concatenated; on a process
ring this rank's shard. Each rank does exactly the work it would do
alone, so the two rings give the same numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..kernels.flash_attention import (splash_block_with_lse,
                                       splash_block_with_lse_ref)

__all__ = ["ring_attention", "ring_splash", "ring_splash_ref", "RingSplash",
           "NEG_INF"]

NEG_INF = -1e30


def _t(x: torch.Tensor) -> torch.Tensor:
    """[B, N, Tl] -> [B, Tl, N, 1], to scale [B, Tl, N, H] rows."""
    return x.transpose(1, 2)[..., None]


def _ring(mesh, axis: str):
    if mesh.shape.get(axis, 1) == 1:
        return None
    return mesh.rings[axis]


def _block_attn(q, k, v, scale, q_off, k_off, causal):
    """Partial (unnormalised) attention of q against one k/v block, as
    the JAX package's `_block_attn`: the product in q's dtype (f32 sums,
    rounded), then f32 logits; p rounded to v's dtype for the second
    product. Returns (acc, m, l)."""
    Tq, Tk = q.shape[1], k.shape[1]
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) \
        .to(q.dtype).float() * scale
    if causal:
        qpos = q_off + torch.arange(Tq, device=q.device)
        kpos = k_off + torch.arange(Tk, device=q.device)
        keep = qpos[:, None] >= kpos[None, :]
        logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(dim=-1)                                # [B, N, Tq]
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bnts,bsnh->btnh", p.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return acc, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the `axis` ring of `mesh`; [B, T, N, H] in
    and out, in q's dtype (T is this rank's shard on a process ring)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ring = _ring(mesh, axis)
    if ring is None:
        from .attention import mha

        return mha(q, k, v, scale=scale, causal=causal)
    S = ring.size
    qs, ks, vs = (ring.split(x, 1) for x in (q, k, v))
    B, Tl, N, H = qs[0].shape
    acc = [torch.zeros(B, Tl, N, H, dtype=torch.float32, device=q.device)
           for _ in qs]
    m = [torch.full((B, N, Tl), NEG_INF, device=q.device) for _ in qs]
    l = [torch.zeros(B, N, Tl, device=q.device) for _ in qs]
    for i in range(S):
        for j, s in enumerate(ring.ranks):
            src = (s - i) % S       # the block this rank holds at step i
            a, bm, bl = _block_attn(qs[j], ks[j], vs[j], scale, s * Tl,
                                    src * Tl, causal)
            m_new = torch.maximum(m[j], bm)
            c_old = torch.exp(m[j] - m_new)
            c_blk = torch.exp(bm - m_new)
            acc[j] = acc[j] * _t(c_old) + a.float() * _t(c_blk)
            l[j] = l[j] * c_old + bl * c_blk
            m[j] = m_new
        if i < S - 1:               # the last hop would only bring k/v home
            ks, vs = ring.hop(ks, vs)
    outs = [(a / _t(torch.clamp(w, min=1e-30))).to(q.dtype)
            for a, w in zip(acc, l)]
    return ring.join(outs, 1)


class RingSplash(torch.autograd.Function):
    """Full-mask ring attention with K3 blocks: the JAX package's
    `_ring_splash_local` (forward `_ring_splash_fwd_impl`, backward
    `_ring_splash_bwd`). Inputs: q, k, v as the ring takes them, the
    ring, the scale and the block function (K3 or its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, scale: float, block: Callable):
        S = ring.size
        scaled = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
        qs, ks, vs = (ring.split(x, 1) for x in (scaled, k, v))
        B, Tl, N, H = qs[0].shape
        acc = [torch.zeros(B, Tl, N, H, dtype=torch.float32,
                           device=q.device) for _ in qs]
        m = [torch.full((B, N, Tl), NEG_INF, device=q.device) for _ in qs]
        w = [torch.zeros(B, N, Tl, device=q.device) for _ in qs]
        for i in range(S):
            for j in range(len(qs)):
                out_b, lse_b = block(qs[j], ks[j], vs[j])
                # merge normalised block outputs by logsumexp weight
                m_new = torch.maximum(m[j], lse_b)
                c_old = torch.exp(m[j] - m_new)
                c_blk = torch.exp(lse_b - m_new)
                acc[j] = acc[j] * _t(c_old) + out_b.float() * _t(c_blk)
                w[j] = w[j] * c_old + c_blk
                m[j] = m_new
            if i < S - 1:
                ks, vs = ring.hop(ks, vs)
        den = [torch.clamp(x, min=1e-30) for x in w]
        out = ring.join([(a / _t(d)).to(q.dtype)
                         for a, d in zip(acc, den)], 1)
        lse = ring.join([mx + torch.log(d) for mx, d in zip(m, den)], 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.scale = ring, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        qf = ring.split(q.float(), 1)
        doutf = ring.split(dout.float(), 1)
        outs = ring.split(out, 1)
        lses = ring.split(lse, 2)
        ks, vs = ring.split(k, 1), ring.split(v, 1)
        # delta_i = sum_h dout_ih * out_ih (the rowwise correction term)
        delta = [torch.einsum("btnh,btnh->bnt", d, o.float())
                 for d, o in zip(doutf, outs)]
        dq = [torch.zeros_like(x) for x in qf]
        dks = [torch.zeros_like(x) for x in qf]
        dvs = [torch.zeros_like(x) for x in qf]
        for _ in range(ring.size):
            for j in range(len(qf)):
                kbf, vbf = ks[j].float(), vs[j].float()
                logits = torch.einsum("btnh,bsnh->bnts", qf[j], kbf) * scale
                p = torch.exp(logits - lses[j][..., None])  # global softmax
                dvs[j] = dvs[j] + torch.einsum("bnts,btnh->bsnh", p,
                                               doutf[j])
                dp = torch.einsum("btnh,bsnh->bnts", doutf[j], vbf)
                ds = p * (dp - delta[j][..., None])
                dq[j] = dq[j] + torch.einsum("bnts,bsnh->btnh", ds,
                                             kbf) * scale
                dks[j] = dks[j] + torch.einsum("bnts,btnh->bsnh", ds,
                                               qf[j]) * scale
            # the dk/dv accumulators travel with their block: home after S
            ks, vs, dks, dvs = ring.hop(ks, vs, dks, dvs)
        return (ring.join(dq, 1).to(q.dtype), ring.join(dks, 1).to(k.dtype),
                ring.join(dvs, 1).to(v.dtype), None, None, None)


def _ring_splash(q, k, v, mesh, axis, scale, block):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ring = _ring(mesh, axis)
    if ring is None:
        from .attention import mha

        return mha(q, k, v, scale=scale, causal=False)
    return RingSplash.apply(q, k, v, ring, float(scale), block)


def ring_splash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                s_axis: str = "sp", scale: Optional[float] = None
                ) -> torch.Tensor:
    """Full-mask ring attention over the `s_axis` ring of `mesh` with K3
    blocks (the plain version of K3 on CPU tensors); [B, T, N, H] in and
    out, in q's dtype. The JAX package's `b_axis`/`h_axis` (dp/tp
    manual axes) wait for ROADMAP item 20."""
    return _ring_splash(q, k, v, mesh, s_axis, scale, splash_block_with_lse)


def ring_splash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                    s_axis: str = "sp", scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Plain version of `ring_splash`: the same ring with K3's plain
    version in every block, on any device."""
    return _ring_splash(q, k, v, mesh, s_axis, scale,
                        splash_block_with_lse_ref)
