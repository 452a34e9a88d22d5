"""Linear-chain CRF ops of the fluid path: the JAX package's
`ops/crf.py` (reference: operators/linear_chain_crf_op.{cc,h},
crf_decoding_op.h, chunk_eval_op.h), for sequence labelling (SRL, NER).

Transition is [D + 2, D]: row 0 the start weights, row 1 the end
weights, rows 2.. the tag-to-tag transitions. Sequences are a padded
[N, T, D] batch with a [N] Length; the forward and Viterbi recursions
are loops over T in log space, each row held in place past its length.
The gradient is the registry's generic `_grad` (autograd through the
loop), where the reference hand-writes the backward recursion.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .sequence import row_lengths


def _crf_batch(emission, transition, lengths):
    """Log-partition and log-alpha of a padded batch: emission
    [N, T, D], transition [D + 2, D], lengths [N] -> (logZ [N],
    alpha [N, T, D])."""
    w_start, w_end, w_trans = transition[0], transition[1], transition[2:]
    alpha = w_start[None, :] + emission[:, 0, :]
    alphas = [alpha]
    for k in range(1, emission.shape[1]):
        # logsumexp_j(alpha[j] + trans[j, i]) + x[i]
        new = torch.logsumexp(alpha[:, :, None] + w_trans[None], dim=1) + \
            emission[:, k, :]
        alpha = torch.where((k < lengths)[:, None], new, alpha)
        alphas.append(alpha)
    logz = torch.logsumexp(alpha + w_end[None, :], dim=-1)
    return logz, torch.stack(alphas, 1)


def _crf_score(emission, transition, label, lengths):
    """The gold path's score, masked past each length -> [N]."""
    t = emission.shape[1]
    w_start, w_end, w_trans = transition[0], transition[1], transition[2:]
    pos = torch.arange(t, device=emission.device)[None, :]
    valid = pos < lengths[:, None]
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    emit = torch.gather(emission, 2, label[:, :, None])[:, :, 0]
    emit_score = torch.sum(torch.where(valid, emit, zero), dim=1)
    trans = w_trans[label[:, :-1], label[:, 1:]]                  # [N, T-1]
    trans_score = torch.sum(torch.where(valid[:, 1:], trans, zero), dim=1)
    last = torch.clamp(lengths - 1, min=0)
    last_lbl = torch.gather(label, 1, last[:, None])[:, 0]
    return w_start[label[:, 0]] + emit_score + trans_score + w_end[last_lbl]


@register_op("linear_chain_crf", nondiff_inputs=("Label", "Length"),
             intermediate_outputs=("Alpha", "EmissionExps", "TransitionExps"))
def linear_chain_crf(ins, attrs, ctx):
    """The negative log-likelihood of gold tag paths under a
    linear-chain CRF. Emission [N, T, D] (or [T, D], one sequence),
    Transition [D + 2, D], Label [N, T] (or [N, T, 1]) int, Length [N]
    (optional, default full T) -> LogLikelihood [N, 1] = logZ - score
    (a cost, as in the reference)."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    label = ins["Label"][0]
    squeeze = emission.ndim == 2
    if squeeze:
        emission, label = emission[None], label.reshape(1, -1)
    if label.ndim == 3:
        label = label[:, :, 0]
    label = label.to(torch.int64)
    n, t, _ = emission.shape
    lengths = row_lengths(ins, n, t, emission.device).to(torch.int64)
    logz, alpha = _crf_batch(emission, transition, lengths)
    nll = (logz - _crf_score(emission, transition, label, lengths))[:, None]
    return {"LogLikelihood": nll[0] if squeeze else nll,
            "Alpha": alpha,
            "EmissionExps": torch.exp(emission),
            "TransitionExps": torch.exp(transition)}


@register_op("crf_decoding", grad=None,
             nondiff_inputs=("Emission", "Transition", "Label", "Length"))
def crf_decoding(ins, attrs, ctx):
    """Viterbi decode -> ViterbiPath [N, T] int64, 0 past each length;
    ties go to the first tag (torch.argmax and jnp.argmax both take the
    first maximum). With a Label, the output is 1 where the decoded tag
    equals the label and 0 elsewhere (crf_decoding_op.h:69)."""
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    squeeze = emission.ndim == 2
    if squeeze:
        emission = emission[None]
    n, t, _ = emission.shape
    dev = emission.device
    lengths = row_lengths(ins, n, t, dev).to(torch.int64)
    w_start, w_end, w_trans = transition[0], transition[1], transition[2:]
    alpha = w_start[None, :] + emission[:, 0, :]
    back, keeps = [], []
    for k in range(1, t):
        scores = alpha[:, :, None] + w_trans[None]                # [N, D, D]
        best, best_prev = torch.max(scores, dim=1)
        keep = k < lengths
        alpha = torch.where(keep[:, None], best + emission[:, k, :], alpha)
        back.append(best_prev)
        keeps.append(keep)
    tag = torch.argmax(alpha + w_end[None, :], dim=-1)            # [N]
    path = [None] * t
    for k in range(t - 1, 0, -1):
        # the tag at position k; a position past the length repeats the
        # last valid tag (zeroed below)
        path[k] = tag
        prev = torch.gather(back[k - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(keeps[k - 1], prev, tag)
    path[0] = tag
    path = torch.stack(path, 1)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    path = torch.where(valid, path, torch.zeros_like(path))
    label = (ins.get("Label") or [None])[0]
    if label is not None:
        if label.ndim == 3:
            label = label[:, :, 0]
        if squeeze:
            label = label.reshape(1, -1)
        path = ((path == label.to(path.dtype)) & valid).to(torch.int64)
    return {"ViterbiPath": path[0] if squeeze else path}


_SCHEMES = {
    # scheme -> (num_tag_types, begin, inside, end, single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_flags(labels, lengths, num_chunk_types, scheme):
    """The reference's per-position chunk state machine (ChunkBegin /
    ChunkEnd), vectorised as the JAX package does it: chunks are runs of
    non-Other positions split at begin flags. Returns (begin [N, T]
    bool, ends [N, T] = the index of the end of the chunk that starts
    here, typ [N, T])."""
    ntag, t_beg, t_in, t_end, t_sng = _SCHEMES[scheme]
    other = num_chunk_types
    lab = labels.to(torch.int64)
    n, t = lab.shape
    dev = lab.device
    tag = lab % ntag
    typ = lab // ntag
    pos = torch.arange(t, device=dev)
    valid = pos[None, :] < lengths.to(torch.int64)[:, None]
    typ = torch.where(valid, typ, torch.full_like(typ, other))
    ptag = torch.cat([torch.full((n, 1), -1, dtype=tag.dtype, device=dev),
                      tag[:, :-1]], dim=1)
    ptyp = torch.cat([torch.full((n, 1), other, dtype=typ.dtype, device=dev),
                      typ[:, :-1]], dim=1)
    is_other = typ == other
    p_other = ptyp == other
    same_type = typ == ptyp
    tag_cond = ((tag == t_beg) | (tag == t_sng) |
                (((tag == t_in) | (tag == t_end)) &
                 ((ptag == t_end) | (ptag == t_sng))))
    begin = torch.where(p_other, ~is_other,
                        ~is_other & (~same_type | tag_cond))
    next_begin = torch.cat([begin[:, 1:],
                            torch.zeros((n, 1), dtype=torch.bool,
                                        device=dev)], dim=1)
    next_other = torch.cat([is_other[:, 1:],
                            torch.ones((n, 1), dtype=torch.bool,
                                       device=dev)], dim=1)
    end = ~is_other & (next_other | next_begin)
    # for each position, the index of the next end at or after it: a
    # reverse cummin (lax.cummin(reverse=True)) as flip, cummin, flip
    end_idx = torch.where(end, pos[None, :], torch.full_like(pos, t + 1))
    ends = torch.flip(torch.cummin(torch.flip(end_idx, [1]), dim=1).values,
                      [1])
    return begin, ends, typ


@register_op("chunk_eval", grad=None,
             nondiff_inputs=("Inference", "Label", "SeqLength"))
def chunk_eval(ins, attrs, ctx):
    """Chunk precision, recall and F1 (reference: chunk_eval_op.h) over
    the IOB, IOE, IOBES or plain scheme, the state machine vectorised
    over the padded batch so the metric runs on the device. The counts
    are int64; the rates float32, each divided in float64 first, as the
    JAX op under x64 divides its int64 counts."""
    inference = ins["Inference"][0]
    label = ins["Label"][0]
    if inference.ndim == 1:
        inference, label = inference[None], label[None]
    if inference.ndim == 3:
        inference, label = inference[:, :, 0], label[:, :, 0]
    n, t = inference.shape
    seqlen = row_lengths(ins, n, t, inference.device, "SeqLength")
    num_chunk_types = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = [int(e) for e in (attrs.get("excluded_chunk_types", []) or [])]

    bi, ei, ti = _chunk_flags(inference, seqlen, num_chunk_types, scheme)
    bl, el, tl = _chunk_flags(label, seqlen, num_chunk_types, scheme)

    def keep(typ):
        m = torch.ones(typ.shape, dtype=torch.bool, device=typ.device)
        for e in excluded:
            m = m & (typ != e)
        return m

    ni = torch.sum(bi & keep(ti))
    nl = torch.sum(bl & keep(tl))
    nc = torch.sum(bi & bl & (ti == tl) & (ei == el) & keep(ti))

    def rate(num, den):
        r = num.to(torch.float64) / torch.clamp(den, min=1).to(torch.float64)
        return torch.where(den > 0, r, torch.zeros_like(r)).to(torch.float32)

    p, r = rate(nc, ni), rate(nc, nl)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-12)
    f1 = torch.where(nc > 0, f1, torch.zeros_like(f1))
    return {"Precision": p.reshape(1), "Recall": r.reshape(1),
            "F1-Score": f1.reshape(1), "NumInferChunks": ni.reshape(1),
            "NumLabelChunks": nl.reshape(1),
            "NumCorrectChunks": nc.reshape(1)}
