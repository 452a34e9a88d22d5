"""Comparison ops of the fluid path: `equal` from the JAX package's
`ops/compare.py` (reference: operators/controlflow/compare_op.cc),
which LocalSGD's every-k gate emits. The rest of that file is still to
port (ROADMAP item 15)."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("equal", grad=None)
def equal(ins, attrs, ctx):
    return {"Out": torch.eq(ins["X"][0], ins["Y"][0])}
