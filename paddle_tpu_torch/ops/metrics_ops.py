"""Metric ops of the fluid path: the JAX package's `ops/metrics_ops.py`
(reference: paddle/fluid/operators/metrics/: accuracy_op.cc, auc_op.cc,
precision_recall_op.cc; positive_negative_pair_op.h). `chunk_eval` is
with the CRF ops, in `crf.py`."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .sequence import scatter_add_rows


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


@register_op("auc", grad=None)
def auc(ins, attrs, ctx):
    """reference: metrics/auc_op.cc: a streaming AUC over bucketed
    positive and negative histograms carried as state (StatPos /
    StatNeg [num_thresholds + 1], in and out), integrated by trapezoids
    from the highest threshold down. Predict [N, 2] (column 1 is the
    positive score) or [N]; Label [N] or [N, 1]."""
    predict, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = int(attrs.get("num_thresholds", 4095))
    pos_score = predict[:, 1] if predict.ndim == 2 and \
        predict.shape[1] == 2 else predict.reshape(-1)
    lbl = label.reshape(-1).to(torch.float32)
    bucket = torch.clamp((pos_score * nt).to(torch.int64), 0, nt)
    pos_new = stat_pos.index_add(0, bucket, lbl.to(stat_pos.dtype))
    neg_new = stat_neg.index_add(0, bucket, (1.0 - lbl).to(stat_neg.dtype))
    tp = torch.cumsum(torch.flip(pos_new, [0]), 0)
    fp = torch.cumsum(torch.flip(neg_new, [0]), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp0 = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp0 = torch.cat([fp.new_zeros(1), fp[:-1]])
    area = torch.sum((fp - fp0) * (tp + tp0) / 2.0)
    both = tot_pos * tot_neg
    auc_val = torch.where(both > 0, area / (both + 1e-12),
                          torch.zeros_like(area))
    return {"AUC": auc_val.reshape(1), "StatPosOut": pos_new,
            "StatNegOut": neg_new}


@register_op("precision_recall", grad=None)
def precision_recall(ins, attrs, ctx):
    """reference: metrics/precision_recall_op.cc, as the JAX op computes
    it: per-class true positives, false positives and false negatives of
    this batch (Indices [N] predicted, Labels [N]), and the macro
    precision, recall and F1 over `class_number` classes. An id outside
    [0, class_number) is dropped and a negative one wraps, as JAX's
    `.at[].add` does (`sequence.scatter_add_rows`)."""
    idx = ins["Indices"][0].reshape(-1)
    lbl = ins["Labels"][0].reshape(-1).to(idx.dtype)
    cls = int(attrs.get("class_number", 2))
    hit = (idx == lbl).to(torch.float32)
    zeros = torch.zeros((1, cls), dtype=torch.float32, device=idx.device)

    def count(ids, what):
        return scatter_add_rows(zeros, ids[None], what[None])[0]

    tp = count(idx, hit)
    fp = count(idx, 1.0 - hit)
    fn = count(lbl, 1.0 - hit)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-6)
    macro = torch.stack([precision.mean(), recall.mean(), f1.mean()])
    return {"BatchMetrics": macro, "AccumMetrics": macro,
            "AccumStatesInfo": torch.stack([tp, fp, fn], dim=1)}


@register_op("positive_negative_pair", grad=None)
def positive_negative_pair(ins, attrs, ctx):
    """reference: positive_negative_pair_op.h: the per-query pair
    ranking statistic. Every same-query pair with different labels
    counts with weight (w_i + w_j) / 2: to PositivePair when its scores
    are ordered as its labels, else to NegativePair; equal scores add to
    NeutralPair and to NegativePair (the reference's branches). The
    optional Accumulate* inputs chain batches."""
    score = ins["Score"][0]
    label = ins["Label"][0].reshape(-1)
    query = ins["QueryID"][0].reshape(-1)
    w_in = (ins.get("Weight") or [None])[0]
    col = int(attrs.get("column", -1))
    if score.ndim == 1:
        score = score[:, None]
    s = score[:, col]
    n = s.shape[0]
    w = torch.ones((n,), dtype=s.dtype, device=s.device) if w_in is None \
        else w_in.reshape(-1).to(s.dtype)
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool, device=s.device),
                       diagonal=1)
    same_q = query[:, None] == query[None, :]
    diff_l = label[:, None] != label[None, :]
    mask = (upper & same_q & diff_l).to(s.dtype)
    pw = (w[:, None] + w[None, :]) * 0.5
    ds = s[:, None] - s[None, :]
    dl = (label[:, None] - label[None, :]).to(s.dtype)
    pos_m = (ds * dl > 0).to(s.dtype)
    sums = {"PositivePair": torch.sum(mask * pw * pos_m),
            "NegativePair": torch.sum(mask * pw * (1.0 - pos_m)),
            "NeutralPair": torch.sum(mask * pw * (ds == 0).to(s.dtype))}
    for key in list(sums):
        acc = (ins.get("Accumulate" + key) or [None])[0]
        if acc is not None:
            sums[key] = sums[key] + acc.reshape(())
    return {k: v.reshape(1) for k, v in sums.items()}
