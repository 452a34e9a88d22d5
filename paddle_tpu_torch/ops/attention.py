"""Fused multi-head attention over [B, T, N, H] tensors.

Counterpart of the JAX package's `ops/pallas/attention.py::mha`, with
the same contract: optional additive mask `[B, 1, 1, T]` or
`[B, N, T, T]`, `causal` merged as a -1e9 lower-triangular mask,
default scale 1/sqrt(H).

Dispatch is by the device of the tensors, never by a fallback:

- CUDA, mask None: the K1 flash-attention kernels
  (`kernels/flash_attention.py`) at every T. Under grad the call goes
  through their autograd Function (K1-fwd with its LSE, K1-bwd in
  backward), so the output is never cut off from autograd; without
  grad (serving) K1-fwd runs alone and nothing is saved. A call the
  kernels cannot take (a head dim of 192 or 256, another dtype) raises.
- CUDA with a head dim that is not a multiple of 64 (the tiny configs'
  16): the plain path below, counted as "xla", with or without a mask.
  This is the JAX package's own dispatch by shape (`_use_splash` sends
  `hd % 64 != 0` to `_xla_mha`), decided before any launch
  (`single_device_route`); it is not a fallback after a failure.
- CUDA with an additive mask: the K2 flash-attention kernels
  (`kernels/flash_attention_bias.py`), the counterpart of the JAX
  package's `_pallas_mha`: the mask goes in as the kernel's f32 bias,
  read through stride-0 views (never broadcast to [B, N, T, Tk]), and
  `causal` is the kernel's own causal mask on top of it. Under grad
  through their autograd Function (K2-fwd, then K1's delta launch and
  K2's dkv and dq); the mask gets a gradient when it requires one.
- CPU: the plain path, a mirror of the JAX package's `_xla_mha`
  including its bf16 branch (bf16 logits, f32 softmax), so the port
  matches the JAX package as that runs on the CPU.

Under a mesh (`parallel/mesh.py::current_mesh()`) whose sequence axis
(`current_rules().mesh_axis("seq")`, `sp` by default) is larger than 1,
a call with no mask takes the sequence-parallel part of the JAX
package's `_multichip_splash_route`:

- "ring": `ring_splash` (`ops/ring_attention.py`), each block on K3,
  when the call is not causal, Tk == T, T/sp is a multiple of 128 and
  the head dim is one K1 takes (`HEAD_DIMS`);
- "ring_xla": `ring_attention` (plain-torch blocks, as the JAX
  package's XLA ones) for the other shapes, causal ones included.

Under dp or tp (the rules' "batch" and "heads" axes) the ring routes
run once per (dp, tp) rank on its block of the batch and heads, as the
JAX package's `ring_splash(b_axis=, h_axis=)` manualizes them; a call
whose B or N those axes do not divide takes "ring_xla", as there.

T is the whole sequence: the in-process ring's full tensor, or a
process ring's shard times sp. There is no `T >= 1024` gate as in the
JAX package's auto mode: on CUDA `mha` takes the K1 kernels at every T.
A call whose T (or Tk) does not split over sp raises rather than
gather the sequence. A masked call under an in-process ring takes the
single-device route (K2 on CUDA), as the JAX package leaves it to
GSPMD: the ring holds whole tensors. Under a process ring each rank
holds only its shard, so the single-device route would attend within
the shard; a masked call there raises until the models shard by hand
(ROADMAP item 20b).

With no sp ring, a mesh whose dp or tp is larger than 1 takes the
counterpart of the JAX package's `_shardmap_splash_mha` ("shardmap",
counted as "splash_shardmap") under its gate: no mask, B divisible by
dp, N by tp, T and Tk multiples of 128, the head dim a multiple of 64.
It runs the single-device route once per (dp, tp) rank on its
[B/dp, T, N/tp, H] block and joins the blocks, with no collective
(attention is independent across batch and heads). A masked call under
dp or tp runs the single-device route (K2 on CUDA) once per (dp, tp)
rank on its rows (where dp divides B) and heads (where tp divides N),
the mask split with them, as GSPMD splits the JAX package's `_xla_mha`
by batch and heads.

Inside the `pp` pipeline's manual region
(`parallel/sharding.py::in_manual_region`) no call takes the sp or the
shardmap route, as the JAX package's `_multichip_splash_route` returns
None there.

`GATE_COUNTS` counts calls per path ("flash_cuda", "flash_bias_cuda",
"xla", "plain", and the JAX package's keys "ring_splash", "ring_xla"
and "splash_shardmap") so a run can show which one served it.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from ..kernels.flash_attention import HEAD_DIMS, flash_attention
from ..kernels.flash_attention_bias import flash_attention_bias
from ..parallel.mesh import current_mesh
from ..core.ring import ProcessRing
from ..parallel.sharding import axis_ring, current_rules, in_manual_region
from . import ring_attention as ra

__all__ = ["mha", "single_device_route", "GATE_COUNTS"]

GATE_COUNTS: collections.Counter = collections.Counter()


def _plain_mha(q, k, v, mask, scale):
    """Mirror of `_xla_mha`: bf16 inputs keep the T x T logits in bf16
    (f32-accumulated product, f32 softmax); wider dtypes stay f32."""
    if q.dtype == torch.bfloat16:
        logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) \
            .to(torch.bfloat16) * torch.tensor(scale, dtype=torch.bfloat16)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return torch.einsum("bnts,bsnh->btnh", probs.float(),
                            v.float()).to(v.dtype)
    logits = torch.einsum("btnh,bsnh->bnts", q, k).float() * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs, v)


def _merge_causal(mask: Optional[torch.Tensor], T: int,
                  device=None) -> torch.Tensor:
    keep = torch.ones(T, T, dtype=torch.bool, device=device).tril()
    cm = torch.where(keep, 0.0, -1e9)[None, None]
    return cm if mask is None else mask + cm


def _size(logical):
    ring = axis_ring(logical)
    return ring.size if ring is not None else 1


def _sp_route(q, k, mask, causal):
    """(route, mesh, axis): "ring", "ring_xla" or None (no sp ring;
    also inside the pipeline's manual region, as the JAX package)."""
    m = current_mesh()
    axis = current_rules().mesh_axis("seq")
    sp = _size("seq")
    if sp == 1 or q.ndim != 4 or in_manual_region():
        return None, m, axis
    ring = m.rings[axis]
    if mask is not None:
        if isinstance(ring, ProcessRing):
            raise NotImplementedError(
                f"a masked mha under a process ring ({axis}={sp}) would "
                f"attend within this rank's shard only; the sharded masked "
                f"route waits for ROADMAP item 20b")
        return None, m, axis
    shards = sp // len(ring.ranks)   # 1 in-process, sp on a process ring
    T, Tk = q.shape[1] * shards, k.shape[1] * shards
    if T % sp or Tk != T:
        raise ValueError(
            f"mha under a mesh with {axis}={sp} needs q and k of one "
            f"length T divisible by {sp}, got T={T}, Tk={Tk}; the port does "
            f"not gather the sequence")
    if causal or (T // sp) % 128 or q.shape[-1] not in HEAD_DIMS \
            or q.shape[0] % _size("batch") \
            or q.shape[2] % _size("heads"):
        return "ring_xla", m, axis
    return "ring", m, axis


def _shardmap_route(q, k, mask) -> bool:
    """The gate of the JAX package's "shardmap" route, off the sp ring:
    a mesh with dp or tp larger than 1 outside a manual region, no
    mask, B divisible by dp, N by tp, T and Tk by 128, H by 64."""
    m = current_mesh()
    if m is None or q.ndim != 4 or mask is not None or in_manual_region():
        return False
    dp, tp = _size("batch"), _size("heads")
    B, T, N, H = q.shape
    return dp * tp > 1 and not (B % dp or N % tp or T % 128
                                or k.shape[1] % 128 or H % 64)


def _rank_rings(q):
    """(batch ring, heads ring) of a call on `q`: the dp and tp rings
    where they divide B and N, else None."""
    b_ring, h_ring = axis_ring("batch"), axis_ring("heads")
    return (b_ring if b_ring is not None and q.shape[0] % b_ring.size == 0
            else None,
            h_ring if h_ring is not None and q.shape[2] % h_ring.size == 0
            else None)


def _per_rank(fn, q, k, v, mask=None):
    """`fn(q, k, v, mask)` once per (dp, tp) rank on its block of the
    batch and the heads (each where its ring divides it), the blocks
    joined. A mask splits with them, or goes whole to every rank along
    a dim of 1."""
    def cut(t, dim, r):
        if r is None:
            return [t]
        if t is None or t.shape[dim] == 1:
            return [t] * r.size
        return r.split(t, dim)

    b_ring, h_ring = _rank_rings(q)
    rows = []
    for qb, kb, vb, mb in zip(*(cut(t, 0, b_ring) for t in (q, k, v, mask))):
        rows.append(torch.cat([fn(*blk) for blk in zip(
            *(cut(t, 2, h_ring) for t in (qb, kb, vb)),
            cut(mb, 1, h_ring))], 2))
    return torch.cat(rows, 0)


def single_device_route(device_type: str, head_dim: int,
                        masked: bool) -> str:
    """The path of a call off the sp ring, by device and shape alone:
    "plain" on the CPU; on CUDA "xla" for a head dim that is not a
    multiple of 64 (the JAX package's `_use_splash` gate, whose other
    side is `_xla_mha`), else "flash_bias_cuda" with a mask (K2) and
    "flash_cuda" without (K1). A multiple of 64 that the kernels do not
    take (192, 256) goes to the kernels' wrappers, which raise."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"mha runs on cuda or cpu, not {device_type}")
    if head_dim % 64:
        return "xla"
    return "flash_bias_cuda" if masked else "flash_cuda"


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
        causal: bool = False) -> torch.Tensor:
    """Multi-head attention over [B, T, N, H] tensors; returns
    [B, T, N, H] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    route, mesh, axis = _sp_route(q, k, mask, causal)
    if route == "ring":
        out = _per_rank(lambda a, b, c, _: ra.ring_splash(
            a, b, c, mesh, s_axis=axis, scale=scale), q, k, v)
        GATE_COUNTS["ring_splash"] += 1
        return out
    if route == "ring_xla":
        out = ra.ring_attention(q, k, v, mesh, axis=axis, causal=causal,
                                scale=scale)
        GATE_COUNTS["ring_xla"] += 1
        return out
    route = single_device_route(q.device.type, q.shape[-1],
                                mask is not None)

    def one(q, k, v, mask):
        if route == "flash_bias_cuda":
            return flash_attention_bias(q, k, v, mask, scale, causal)
        if route == "flash_cuda":
            return flash_attention(q, k, v, scale, causal)
        if causal:
            mask = _merge_causal(mask, q.shape[1], q.device)
        return _plain_mha(q, k, v, mask, scale).to(q.dtype)

    if _shardmap_route(q, k, mask):
        out = _per_rank(one, q, k, v)
        GATE_COUNTS["splash_shardmap"] += 1
        return out
    if mask is not None and not in_manual_region() and q.ndim == 4 \
            and _rank_rings(q) != (None, None):
        out = _per_rank(one, q, k, v, mask)
    else:
        out = one(q, k, v, mask)
    GATE_COUNTS[route] += 1
    return out
