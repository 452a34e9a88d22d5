"""Sequence ops of the fluid path: the JAX package's `ops/sequence.py`
(reference: paddle/fluid/operators/sequence_ops/), so far the op the
dygraph `SequenceConv` layer reaches, `sequence_conv` (:198). The rest
of that module is still to port (ROADMAP item 15).

As there, a variable-length batch is a padded [N, T, ...] tensor with
an optional [N] `Length` input in place of the reference's LoD.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _mask(lengths, maxlen, dtype):
    """[N, maxlen]: 1 where the position is inside its row's length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths.reshape(-1, 1)).to(dtype)


@register_op("sequence_conv", nondiff_inputs=("Length",))
def sequence_conv(ins, attrs, ctx):
    """reference: sequence_conv_op.cc: a 1-D convolution over time with
    a [contextLength * D, out] filter, the context window starting at
    `contextStart`; frames outside [0, length) contribute zeros (the
    reference's context padding). X [N, T, D] -> Out [N, T, out]."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len - 1) // 2))
    n, t, d = x.shape
    if ins.get("Length") and ins["Length"][0] is not None:
        x = x * _mask(ins["Length"][0].to(torch.int64), t, x.dtype)[..., None]
    pos = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(x, -off, dims=1)
        ok = ((pos + off >= 0) & (pos + off < t))[None, :, None]
        cols.append(torch.where(ok, shifted, torch.zeros_like(shifted)))
    im2col = torch.cat(cols, dim=-1)                 # [N, T, ctx_len * D]
    return {"Out": torch.einsum("ntc,co->nto", im2col, filt)}
