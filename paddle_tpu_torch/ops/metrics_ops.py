"""Metric ops of the fluid path: `accuracy` from the JAX package's
`ops/metrics_ops.py` (reference: paddle/fluid/operators/metrics/
accuracy_op.cc). `auc` and `precision_recall` are still to port
(ROADMAP item 15)."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", grad=None)
def accuracy(ins, attrs, ctx):
    """Indices: top-k indices [N, k]; Label: [N, 1] int64."""
    indices, label = ins["Indices"][0], ins["Label"][0]
    lbl = label if label.ndim == indices.ndim else label[:, None]
    correct = torch.any(indices == lbl.to(indices.dtype), dim=-1)
    num_correct = torch.sum(correct.to(torch.float32))
    total = torch.tensor(float(indices.shape[0]), dtype=torch.float32,
                         device=indices.device)
    return {
        "Accuracy": (num_correct / total).reshape(1),
        "Correct": num_correct.to(torch.int32).reshape(1),
        "Total": total.to(torch.int32).reshape(1),
    }
