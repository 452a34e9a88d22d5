"""Large-vocabulary classification ops of the fluid path: the JAX
package's `ops/classify.py` (NCE, hierarchical sigmoid, sampled
softmax, cosine similarity, cross_entropy2).

Reference behaviour: operators/nce_op.h (per-sample cost -log(o / (o +
b)) for the true classes and -log(b / (o + b)) for the negatives, o =
sigmoid(logit), b = P(class) * num_neg_samples),
hierarchical_sigmoid_op.h with math/matrix_bit_code.h (SimpleCode over
label + num_classes: node (c >> (d + 1)) - 1, bit (c >> d) & 1; cost =
sum_d softplus(pre_d) - bit_d pre_d, pre clipped to [-40, 40]),
sample_logits_op.cc, cos_sim_op.h.

Negative classes are drawn from `ctx.rng()`: the numbers are the
port's own and their law is the JAX op's. Weight gradients are dense
(no SelectedRows, as in the JAX package).
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op


def _log_uniform_prob(classes, range_max):
    """P(c) of the log-uniform sampler (reference: math/sampler.cc
    LogUniformSampler): log((c + 2) / (c + 1)) / log(range_max + 1)."""
    c = classes.to(torch.float32)
    return torch.log((c + 2.0) / (c + 1.0)) / math.log(range_max + 1.0)


def _sample_classes(gen, shape, num_classes, sampler, device,
                    custom_probs=None):
    if sampler == "custom":
        if custom_probs is None:
            raise ValueError("sampler='custom' requires CustomDistProbs")
        w = torch.clamp(custom_probs.to(torch.float32), min=1e-30)
        flat = torch.multinomial(w.expand(shape[0], -1), shape[1],
                                 replacement=True, generator=gen)
        return flat.to(torch.int64)
    if sampler == "log_uniform":
        # the inverse CDF of the log-uniform law
        u = torch.rand(shape, generator=gen, device=device)
        s = torch.exp(u * math.log(num_classes + 1.0)) - 1.0
        return torch.clamp(s.to(torch.int64), 0, num_classes - 1)
    return torch.randint(0, num_classes, shape, generator=gen, device=device)


def _sampler(attrs):
    s = attrs.get("sampler", 0)
    if isinstance(s, int):
        return {0: "uniform", 1: "log_uniform", 2: "custom"}.get(s, "uniform")
    return s


def _present(ins, slot):
    return bool(ins.get(slot)) and ins[slot][0] is not None


@register_op("nce", is_random=True,
             nondiff_inputs=("Label", "SampleWeight", "CustomDistProbs",
                             "CustomDistAlias", "CustomDistAliasProbs"),
             intermediate_outputs=("SampleLogits", "SampleLabels"))
def nce(ins, attrs, ctx):
    """Noise-contrastive estimation loss (reference: nce_op.h:241-266)."""
    x = ins["Input"][0]                      # [N, D]
    label = ins["Label"][0]                  # [N, num_true]
    w = ins["Weight"][0]                     # [C, D]
    bias = ins["Bias"][0] if _present(ins, "Bias") else None
    if label.ndim == 1:
        label = label[:, None]
    n, num_true = label.shape
    num_neg = int(attrs.get("num_neg_samples", 10))
    num_classes = int(attrs["num_total_classes"])
    sampler = _sampler(attrs)
    custom_probs = ins["CustomDistProbs"][0].reshape(-1) \
        if _present(ins, "CustomDistProbs") else None

    neg = _sample_classes(ctx.rng(), (n, num_neg), num_classes, sampler,
                          x.device, custom_probs)
    samples = torch.cat([label.to(torch.int64), neg], dim=1)   # [N, S]
    logits = torch.einsum("nsd,nd->ns", w[samples], x)
    if bias is not None:
        logits = logits + bias[samples]
    o = torch.sigmoid(logits)
    if sampler == "custom":
        p = custom_probs[samples].to(logits.dtype)
    elif sampler == "log_uniform":
        p = _log_uniform_prob(samples, num_classes).to(logits.dtype)
    else:
        p = torch.full(samples.shape, 1.0 / num_classes, dtype=logits.dtype,
                       device=x.device)
    b = p * num_neg

    eps = 1e-12
    ot, bt = o[:, :num_true], b[:, :num_true]
    on, bn = o[:, num_true:], b[:, num_true:]
    cost_true = -torch.log(ot / (ot + bt + eps) + eps)
    cost_neg = -torch.log(bn / (on + bn + eps) + eps)
    if _present(ins, "SampleWeight"):
        sw = ins["SampleWeight"][0].reshape(-1, 1)
        cost_true = cost_true * sw
        cost_neg = cost_neg * sw
    cost = cost_true.sum(1, keepdim=True) + cost_neg.sum(1, keepdim=True)
    return {"Cost": cost, "SampleLogits": logits, "SampleLabels": samples}


def _simple_code(label, num_classes):
    """The default complete-binary-tree path of class `label` (reference:
    matrix_bit_code.h SimpleCode): (indices [N, L], bits [N, L], valid
    [N, L]), L the longest code; position d is valid iff c >> (d + 1) >
    0."""
    c = label.to(torch.int64) + num_classes
    max_len = int(2 * num_classes - 1).bit_length() - 1
    d = torch.arange(max_len, device=label.device)
    up = c[:, None] >> (d[None, :] + 1)
    return torch.clamp(up - 1, min=0), (c[:, None] >> d[None, :]) & 1, up > 0


@register_op("hierarchical_sigmoid", nondiff_inputs=("Label", "PathTable",
                                                     "PathCode"),
             intermediate_outputs=("PreOut",))
def hierarchical_sigmoid(ins, attrs, ctx):
    """Hierarchical sigmoid cost (reference: hierarchical_sigmoid_op.h:
    pre = clip(W_path x + b_path, +-40); cost = sum softplus(pre) -
    bit pre)."""
    x = ins["X"][0]                        # [N, D]
    w = ins["W"][0]                        # [num_nodes, D]
    label = ins["Label"][0].reshape(-1)    # [N]
    bias = ins["Bias"][0] if _present(ins, "Bias") else None
    if _present(ins, "PathTable"):
        idx = ins["PathTable"][0].to(torch.int64)          # [N, L]
        bits = ins["PathCode"][0]
        valid = idx >= 0
        idx = torch.clamp(idx, min=0)
    else:
        idx, bits, valid = _simple_code(label, int(attrs.get("num_classes",
                                                             2)))
    pre = torch.einsum("nld,nd->nl", w[idx], x)
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    pre = torch.clamp(pre, -40.0, 40.0)
    softplus = torch.logaddexp(pre, torch.zeros_like(pre))
    cost = torch.sum((softplus - bits.to(pre.dtype) * pre) *
                     valid.to(pre.dtype), dim=1, keepdim=True)
    return {"Out": cost, "PreOut": pre}


def _hits(samples, label, nt):
    """A negative equal to any true class of its row."""
    return (samples[:, None, nt:] ==
            label.to(torch.int64)[:, :, None]).any(dim=1)


def _push_hits(sub, hit, nt):
    """Negatives that hit a true class moved to -1e20."""
    pushed = sub[:, nt:] + torch.where(hit, -1e20, 0.0).to(sub.dtype)
    return torch.cat([sub[:, :nt], pushed], dim=1)


def _log_uniform_samples(ctx, label, n, s, c, device):
    neg = _sample_classes(ctx.rng(), (n, s), c, "log_uniform", device)
    return torch.cat([label.to(torch.int64), neg], dim=1)


@register_op("sampled_softmax_with_cross_entropy", is_random=True,
             nondiff_inputs=("Label", "CustomizedSamples",
                             "CustomizedProbabilities"),
             intermediate_outputs=("Samples", "SampledLogits"))
def sampled_softmax_with_cross_entropy(ins, attrs, ctx):
    """Softmax cross entropy over {the true classes} and S log-uniform
    negatives, logits corrected by their expected counts (reference:
    sample_logits_op.cc with layers/nn.py:7916), or over the caller's
    CustomizedSamples / CustomizedProbabilities [N, nt + S]."""
    logits = ins["Logits"][0]              # [N, C]
    label = ins["Label"][0]
    if label.ndim == 1:
        label = label[:, None]
    n, c = logits.shape
    s = int(attrs.get("num_samples", 5))
    nt = label.shape[1]
    if bool(attrs.get("use_customized_samples", False)):
        samples = ins["CustomizedSamples"][0].to(torch.int64)
        probs = ins["CustomizedProbabilities"][0]
        sub = torch.take_along_dim(logits, samples, dim=1)
        sub = sub - torch.log(probs.to(sub.dtype) + 1e-12)
    else:
        samples = _log_uniform_samples(ctx, label, n, s, c, logits.device)
        sub = torch.take_along_dim(logits, samples, dim=1)   # [N, nt + S]
        sub = sub - torch.log(_log_uniform_prob(samples, c).to(sub.dtype)
                              * s + 1e-12)
    if bool(attrs.get("remove_accidental_hits", True)):
        sub = _push_hits(sub, _hits(samples, label, nt), nt)
    logp = torch.log_softmax(sub, dim=-1)
    # a uniform target over the nt true columns
    loss = -torch.mean(logp[:, :nt], dim=1, keepdim=True)
    return {"Loss": loss, "Samples": samples, "SampledLogits": sub}


@register_op("sample_logits", is_random=True,
             nondiff_inputs=("Labels", "CustomizedSamples",
                             "CustomizedProbabilities"),
             intermediate_outputs=("Samples", "Probabilities",
                                   "SampledLabels", "LogitsDim",
                                   "LabelsDim"))
def sample_logits(ins, attrs, ctx):
    """reference: sample_logits_op.h, the block under sampled softmax:
    Samples = [labels | S log-uniform negatives]; SampledLogits[i, j] =
    logits[i, samples[i, j]] - log(q(samples[i, j])), a negative equal
    to a true label of its row at -1e20 first; SampledLabels[i, j] = j.
    `uniq` is taken and the draws are i.i.d., as in the JAX op."""
    logits = ins["Logits"][0]              # [N, C]
    label = ins["Labels"][0]
    if label.ndim == 1:
        label = label[:, None]
    n, c = logits.shape
    s = int(attrs.get("num_samples", 5))
    nt = label.shape[1]
    if bool(attrs.get("use_customized_samples", False)):
        samples = ins["CustomizedSamples"][0].to(torch.int64)
        probs = ins["CustomizedProbabilities"][0].to(logits.dtype)
    else:
        samples = _log_uniform_samples(ctx, label, n, s, c, logits.device)
        probs = (_log_uniform_prob(samples, c) * s).to(logits.dtype)
    sub = torch.take_along_dim(logits, samples, dim=1)       # [N, nt + S]
    if bool(attrs.get("remove_accidental_hits", True)):
        sub = _push_hits(sub, _hits(samples, label, nt), nt)
    sub = sub - torch.log(probs + 1e-12).to(sub.dtype)
    dev = logits.device
    return {"Samples": samples, "Probabilities": probs,
            "SampledLogits": sub,
            "SampledLabels": torch.arange(nt, dtype=torch.int64,
                                          device=dev)[None].repeat(n, 1),
            "LogitsDim": torch.tensor(list(logits.shape), dtype=torch.int64,
                                      device=dev),
            "LabelsDim": torch.tensor(list(label.shape), dtype=torch.int64,
                                      device=dev)}


@register_op("cos_sim", intermediate_outputs=("XNorm", "YNorm"))
def cos_sim(ins, attrs, ctx):
    """Row-wise cosine similarity; Y broadcasts when it has one row
    (reference: cos_sim_op.h)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    return {"Out": dot / torch.clamp(xn * yn, min=1e-12), "XNorm": xn,
            "YNorm": yn}


@register_op("cross_entropy2", nondiff_inputs=("Label",),
             intermediate_outputs=("XShape", "MatchX"))
def cross_entropy2(ins, attrs, ctx):
    """reference: cross_entropy2_op.cc: hard-label cross entropy on
    probabilities that also emits MatchX, the label's probability."""
    x, label = ins["X"][0], ins["Label"][0]
    if label.ndim == x.ndim:
        label = label[..., 0]
    lab = torch.clamp(label, min=0).to(torch.int64)
    match = torch.take_along_dim(x, lab[..., None], dim=-1)[..., 0]
    y = torch.where(label != int(attrs.get("ignore_index", -100)),
                    -torch.log(torch.clamp(match, min=1e-20)),
                    torch.zeros_like(match))
    return {"Y": y[..., None], "MatchX": match[..., None], "XShape": None}
