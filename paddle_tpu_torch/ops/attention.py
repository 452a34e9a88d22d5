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
  kernels cannot take (another head dim or dtype) raises.
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

`GATE_COUNTS` counts calls per path ("flash_cuda", "flash_bias_cuda",
"plain") so a run can show which one served it.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_bias import flash_attention_bias

__all__ = ["mha", "GATE_COUNTS"]

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


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
        causal: bool = False) -> torch.Tensor:
    """Multi-head attention over [B, T, N, H] tensors; returns
    [B, T, N, H] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        if mask is not None:
            out = flash_attention_bias(q, k, v, mask, scale, causal)
            GATE_COUNTS["flash_bias_cuda"] += 1
            return out
        out = flash_attention(q, k, v, scale, causal)
        GATE_COUNTS["flash_cuda"] += 1
        return out
    if q.device.type != "cpu":
        raise ValueError(f"mha runs on cuda or cpu, not {q.device.type}")
    if causal:
        mask = _merge_causal(mask, q.shape[1], q.device)
    out = _plain_mha(q, k, v, mask, scale)
    GATE_COUNTS["plain"] += 1
    return out.to(q.dtype)
