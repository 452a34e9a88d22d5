"""The JAX package's `ops/misc.py` (reference: the operators of
paddle/fluid/operators/ that its docstring names), all forty op types:
the NN, loss and metric ops that round out the zoo, the CTC ladder
(`warpctc`, `ctc_align`, `edit_distance`), `py_func`, and the
SelectedRows and distributed utility ops.

Where the JAX op's shape is static by design the port keeps it: a CTC
compaction is the sequence module's stable-sort `_compact_left`, a
runtime crop offset is clamped as `jax.lax.dynamic_slice` clamps it. The
JAX package keeps every SelectedRows at its slot count (a merge zeroes
repeated slots, a split masks out-of-section ids); the port runs eagerly
and gives the reference's shapes: a merge has each id once, a section
holds only its own rows. Both densify to the same tensors.

The dynamic programs run on the device, vectorised over the batch:
`edit_distance`'s Levenshtein table fills one anti-diagonal a step (T1 +
T2 - 1 steps, where the JAX op scans T1 x T2 cells), `similarity_focus`
picks its maxima for every sample at once, and `warpctc` is optax's
`ctc_loss` (the log-space forward algorithm of warp-ctc, with log(0)
stood in by -1e5, so a label that cannot fit its frames costs a large
finite loss) step for step over the frames, its `WarpCTCGrad` the
autograd gradient of the summed per-sample loss, and its gradient that
tensor scaled row by row by the loss's cotangent (the reference's
warpctc_grad), so a training step runs the frames' loop once. The
random ops draw
from the op's generator (`ctx.rng()`), so they follow the law of the
JAX op, not its numbers. Kernels that must read a value on the host
(`py_func`, `ref_by_trainer_id`) or run a data-dependent loop return
shaped outputs without running under shape inference on meta tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import (GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG,
                             GRAD_PREFIX_OUT, register_op, torch_dtype)
from ..core.async_exec import to_numpy
from ..core.selected_rows import SelectedRows, is_selected_rows
from .quant import _const
from .sequence import _compact_left, _given, row_lengths


@register_op("merge_selected_rows", grad=None)
def merge_selected_rows(ins, attrs, ctx):
    """Sum the rows of repeated ids (MergeAdd); a dense input passes."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        return {"Out": x}
    ids, rows = x.merged()
    return {"Out": SelectedRows(rows, ids, x.height)}


@register_op("get_tensor_from_selected_rows", grad=None)
def get_tensor_from_selected_rows(ins, attrs, ctx):
    """A SelectedRows' value tensor as a dense tensor."""
    x = ins["X"][0]
    return {"Out": x.rows if is_selected_rows(x) else x}


@register_op("split_selected_rows", grad=None)
def split_selected_rows(ins, attrs, ctx):
    """Split a SelectedRows by height sections (the parameter server's
    shard split): each section takes the rows whose ids fall in it, ids
    made local."""
    x = ins["X"][0]
    if not is_selected_rows(x):
        raise TypeError("split_selected_rows wants a SelectedRows input")
    outs = []
    off = 0
    for h in (int(s) for s in attrs["height_sections"]):
        inside = (x.ids >= off) & (x.ids < off + h)
        outs.append(SelectedRows(x.rows[inside], x.ids[inside] - off, h))
        off += h
    return {"Out": outs}


@register_op("log_loss")
def log_loss(ins, attrs, ctx):
    """reference: log_loss_op.cc: -y log(p + eps) - (1 - y) log(1 - p +
    eps), elementwise."""
    p = ins["Predicted"][0]
    y = ins["Labels"][0]
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": -y * torch.log(p + eps) - (1 - y) * torch.log(1 - p + eps)}


@register_op("spectral_norm", nondiff_inputs=("U", "V"))
def spectral_norm(ins, attrs, ctx):
    """reference: spectral_norm_op.cc: Weight over its largest singular
    value, estimated by `power_iters` rounds (at least one) from U and
    V. The rounds are part of the forward, so the gradient runs through
    them, as `jax.vjp` of the JAX op's scan does."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1)
    v = ins["V"][0].reshape(-1)
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    perm = (dim,) + tuple(i for i in range(w.ndim) if i != dim)
    wm = w.permute(perm).reshape(w.shape[dim], -1)          # [H, W']
    for _ in range(max(int(attrs.get("power_iters", 1)), 1)):
        v = wm.T @ u
        v = v / (torch.sqrt(torch.sum(v * v)) + eps)
        u = wm @ v
        u = u / (torch.sqrt(torch.sum(u * u)) + eps)
    return {"Out": w / (u @ wm @ v)}


@register_op("row_conv", nondiff_inputs=())
def row_conv(ins, attrs, ctx):
    """reference: row_conv_op.cc: the lookahead convolution (Deep
    Speech 2), out[t] = sum_{k<K} w[k] * x[t+k] per feature, x [N, T, D]
    and Filter [K, D]; frames past T contribute zeros."""
    x = ins["X"][0]
    filt = ins["Filter"][0]
    t = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(filt.shape[0]):
        if i >= t:
            break
        shifted = F.pad(x[:, i:], (0, 0, 0, i))
        out = out + shifted * filt[i][None, None, :]
    return {"Out": out}


@register_op("conv3d_transpose")
def conv3d_transpose(ins, attrs, ctx):
    """reference: conv_transpose_op.cc's 3-D branch: Input [N, C_in, D,
    H, W], Filter [C_in, C_out, kd, kh, kw]; each output dim is (in - 1)
    s - 2 p + (k - 1) d + 1, as the JAX op's `conv_transpose` gives."""
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1, 1]))
    dilations = tuple(int(d) for d in attrs.get("dilations", [1, 1, 1]))
    pads = tuple(int(p) for p in attrs.get("paddings", [0, 0, 0]))
    return {"Output": F.conv_transpose3d(x, w, stride=strides, padding=pads,
                                         dilation=dilations)}


@register_op("affine_channel")
def affine_channel(ins, attrs, ctx):
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    bias = ins["Bias"][0].reshape(-1)
    if attrs.get("data_layout", "NCHW") == "NCHW":
        shp = (1, -1) + (1,) * (x.ndim - 2)
    else:
        shp = (1,) * (x.ndim - 1) + (-1,)
    return {"Out": x * scale.reshape(shp) + bias.reshape(shp)}


@register_op("affine_grid", nondiff_inputs=("OutputShape",))
def affine_grid(ins, attrs, ctx):
    """theta [N, 2, 3] -> the normalized sampling grid [N, H, W, 2]
    (align_corners: the corners sit at -1 and 1)."""
    theta = ins["Theta"][0]
    if _given(ins, "OutputShape"):
        shape = [int(v) for v in ins["OutputShape"][0].tolist()]
    else:
        shape = [int(v) for v in attrs["output_shape"]]
    _, _, h, w = shape
    kw = {"dtype": theta.dtype, "device": theta.device}
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, **kw),
                            torch.linspace(-1.0, 1.0, w, **kw),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H, W, 3]
    return {"Output": torch.einsum("hwk,nck->nhwc", base, theta)}


@register_op("lrn", intermediate_outputs=("MidOut",))
def lrn(ins, attrs, ctx):
    """reference: lrn_op.cc: mid = k + alpha * (the sum of x^2 over n
    neighbouring channels), out = x * mid^-beta."""
    x = ins["X"][0]                                   # [N, C, H, W]
    n_size = int(attrs.get("n", 5))
    k = float(attrs.get("k", 2.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = n_size // 2
    pad = (0, 0) * (x.ndim - 2) + (half, half)
    sq = F.pad(x * x, pad)
    acc = sum(sq[:, i:i + x.shape[1]] for i in range(n_size))
    mid = k + alpha * acc
    return {"Out": x * mid ** (-beta), "MidOut": mid}


@register_op("data_norm", nondiff_inputs=("BatchSize", "BatchSum",
                                          "BatchSquareSum"),
             intermediate_outputs=("Means", "Scales"))
def data_norm(ins, attrs, ctx):
    """reference: data_norm_op.cc: normalize by the running accumulators
    of the CTR models, mean = sum / n, scale = sqrt(n / square sum)."""
    x = ins["X"][0]
    bsize = ins["BatchSize"][0].reshape(-1)
    bsum = ins["BatchSum"][0].reshape(-1)
    bsqs = ins["BatchSquareSum"][0].reshape(-1)
    means = bsum / bsize
    scales = torch.sqrt(bsize / bsqs)
    return {"Y": (x - means[None, :]) * scales[None, :],
            "Means": means, "Scales": scales}


@register_op("shuffle_channel")
def shuffle_channel(ins, attrs, ctx):
    x = ins["X"][0]
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).permute(0, 2, 1, 3, 4)
            .reshape(n, c, h, w)}


@register_op("space_to_depth")
def space_to_depth(ins, attrs, ctx):
    x = ins["X"][0]
    bs = int(attrs["blocksize"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs)
    return {"Out": x.permute(0, 3, 5, 1, 2, 4)
            .reshape(n, c * bs * bs, h // bs, w // bs)}


@register_op("unfold")
def unfold(ins, attrs, ctx):
    """reference: unfold_op.cc (im2col): [N, C, H, W] -> [N, C kh kw, L],
    paddings [top, left, bottom, right]."""
    x = ins["X"][0]
    kh, kw = [int(v) for v in attrs["kernel_sizes"]]
    sh, sw = [int(v) for v in attrs.get("strides", [1, 1])]
    pads = [int(v) for v in attrs.get("paddings", [0, 0, 0, 0])]
    dh, dw = [int(v) for v in attrs.get("dilations", [1, 1])]
    x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    return {"Y": F.unfold(x, (kh, kw), dilation=(dh, dw), stride=(sh, sw))}


def _dynamic_slice(x, starts, sizes):
    """`jax.lax.dynamic_slice`: the window of `sizes` at `starts` (ints
    or 0-d tensors, read on the device), a negative start counted from
    the end, then each clamped so that the window fits."""
    idx = []
    for d, (s, n) in enumerate(zip(starts, sizes)):
        s = torch.as_tensor(s, device=x.device).reshape(()).to(torch.int64)
        s = torch.where(s < 0, s + x.shape[d], s)
        s = torch.clamp(s, 0, x.shape[d] - n)
        r = s + torch.arange(n, device=x.device)
        idx.append(r.reshape([-1 if i == d else 1 for i in range(x.ndim)]))
    return x[tuple(idx)]


def _crop(ins, attrs, x, shape):
    if _given(ins, "Offsets"):
        off = ins["Offsets"][0].reshape(-1)
        return _dynamic_slice(x, [off[i] for i in range(x.ndim)], shape)
    offsets = [int(v) for v in attrs.get("offsets", [0] * x.ndim)]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@register_op("crop", nondiff_inputs=("Y", "Offsets"))
def crop(ins, attrs, ctx):
    """reference: crop_op.cc: crop X to Y's shape (or the attr's)."""
    x = ins["X"][0]
    if _given(ins, "Y"):
        shape = list(ins["Y"][0].shape)
    else:
        shape = [int(v) for v in attrs["shape"]]
    return {"Out": _crop(ins, attrs, x, shape)}


@register_op("crop_tensor", nondiff_inputs=("Shape", "Offsets"))
def crop_tensor(ins, attrs, ctx):
    x = ins["X"][0]
    if _given(ins, "Shape"):
        shape = [int(v) for v in ins["Shape"][0].tolist()]
    else:
        shape = [int(v) for v in attrs["shape"]]
    shape = [x.shape[i] if s == -1 else s for i, s in enumerate(shape)]
    return {"Out": _crop(ins, attrs, x, shape)}


@register_op("random_crop", is_random=True, grad=None)
def random_crop(ins, attrs, ctx):
    """reference: random_crop_op.cc: crop the trailing dims to `shape` at
    a uniform offset."""
    x = ins["X"][0]
    shape = [int(v) for v in attrs["shape"]]
    lead = x.ndim - len(shape)
    g = ctx.rng()
    starts = [torch.randint(0, x.shape[lead + i] - s + 1, (), generator=g,
                            device=ctx.device)
              for i, s in enumerate(shape)]
    return {"Out": _dynamic_slice(x, [0] * lead + starts,
                                  list(x.shape[:lead]) + shape)}


@register_op("sampling_id", is_random=True, grad=None)
def sampling_id(ins, attrs, ctx):
    """reference: sampling_id_op.cc: a class index per row, drawn with
    the row's probabilities (floored at 1e-20, as the JAX op's logits)."""
    x = ins["X"][0]
    lead = tuple(x.shape[:-1])
    if ctx.in_shape_inference:
        return {"Out": torch.zeros(lead, dtype=torch.int64, device=x.device)}
    p = torch.clamp(x.reshape(-1, x.shape[-1]).float(), min=1e-20)
    out = torch.multinomial(p, 1, generator=ctx.rng())
    return {"Out": out.reshape(lead).to(torch.int64)}


@register_op("add_position_encoding")
def add_position_encoding(ins, attrs, ctx):
    """reference: add_position_encoding_op.cc: out = alpha x + beta PE."""
    x = ins["X"][0]                        # [N, T, D]
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    kw = {"dtype": x.dtype, "device": x.device}
    pos = torch.arange(t, **kw)[:, None]
    half = d // 2
    div = torch.exp(torch.arange(half, **kw) *
                    _const(x, -math.log(10000.0) / max(half - 1, 1)))
    pe = torch.cat([torch.sin(pos * div), torch.cos(pos * div)], dim=1)
    if pe.shape[1] < d:
        pe = F.pad(pe, (0, d - pe.shape[1]))
    return {"Out": alpha * x + beta * pe[None, :, :]}


@register_op("rank_loss")
def rank_loss(ins, attrs, ctx):
    """reference: rank_loss_op.cc: o = left - right, C = log(1 + e^o) - o
    label."""
    o = ins["Left"][0] - ins["Right"][0]
    return {"Out": torch.logaddexp(o, torch.zeros_like(o)) -
            o * ins["Label"][0]}


@register_op("bpr_loss", nondiff_inputs=("Label",))
def bpr_loss(ins, attrs, ctx):
    """reference: bpr_loss_op.cc:127: Y[i] = -mean over j != y_i of log
    sigmoid(x[i, y_i] - x[i, j])."""
    x = ins["X"][0]                        # [N, C]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    c = x.shape[1]
    diff = torch.gather(x, 1, label[:, None]) - x
    notself = torch.arange(c, device=x.device)[None, :] != label[:, None]
    kept = torch.where(notself, F.logsigmoid(diff), torch.zeros_like(diff))
    return {"Y": -kept.sum(dim=1, keepdim=True) / _const(x, max(c - 1, 1))}


@register_op("npair_loss", nondiff_inputs=("Labels",))
def npair_loss(ins, attrs, ctx):
    """reference: layers/nn.py npair_loss: softmax cross entropy over the
    anchor-positive similarities with same-label soft targets, plus an
    l2 term on the embeddings."""
    anchor = ins["Anchor"][0]              # [N, D]
    positive = ins["Positive"][0]
    labels = ins["Labels"][0].reshape(-1)
    l2_reg = float(attrs.get("l2_reg", 0.002))
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    targets = same / same.sum(dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(targets * torch.log_softmax(sim, dim=1),
                               dim=1))
    l2 = torch.mean(torch.sum(anchor * anchor + positive * positive, dim=1)) \
        * l2_reg * 0.25
    return {"Out": ce + l2}


@register_op("center_loss", nondiff_inputs=("Label", "Centers",
                                            "CenterUpdateRate"),
             intermediate_outputs=("SampleCenterDiff", "CentersOut"))
def center_loss(ins, attrs, ctx):
    """reference: center_loss_op.cc: 0.5 |x - c_y|^2; with update_center
    each center moves toward its class's samples."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    centers = ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0].reshape(()) if \
        _given(ins, "CenterUpdateRate") else _const(x, 0.5)
    diff = x - centers[label]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if attrs.get("update_center", True):
        counts = torch.zeros(centers.shape[0], dtype=x.dtype,
                             device=x.device).index_add(
            0, label, torch.ones_like(label, dtype=x.dtype))
        upd = torch.zeros_like(centers).index_add(0, label, diff)
        centers_out = centers + alpha * upd / (counts[:, None] + 1.0)
    else:
        centers_out = centers
    return {"Loss": loss, "SampleCenterDiff": diff,
            "CentersOut": centers_out}


@register_op("teacher_student_sigmoid_loss", nondiff_inputs=("Label",))
def teacher_student_sigmoid_loss(ins, attrs, ctx):
    """reference: teacher_student_sigmoid_loss_op.h:43-63: piecewise on
    the encoded label: < -1 bce(x, 0); < 0 bce(x, 1); < 1 bce(x, 0) +
    bce(x, z'); else bce(x, 1) + bce(x, z' - 1)."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(x.dtype)

    def bce_with(z):
        return torch.clamp(x, min=0.0) - x * z + \
            torch.log1p(torch.exp(-torch.abs(x)))

    y = torch.where(
        label < -1.0, bce_with(0.0),
        torch.where(label < 0.0, bce_with(1.0),
                    torch.where(label < 1.0, bce_with(0.0) + bce_with(label),
                                bce_with(1.0) + bce_with(label - 1.0))))
    return {"Y": y[:, None]}


@register_op("modified_huber_loss", nondiff_inputs=("Y",),
             intermediate_outputs=("IntermediateVal",))
def modified_huber_loss(ins, attrs, ctx):
    """reference: modified_huber_loss_op.h:40-49: on z = x (2y - 1):
    -4z below -1, (1 - z)^2 below 1, else 0."""
    x = ins["X"][0]
    z = x * (2.0 * ins["Y"][0] - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z) ** 2,
                                   torch.zeros_like(z)))
    return {"Out": loss, "IntermediateVal": z}


def _diagonals(t1, t2, device):
    """The cells (i, j), 1 <= i <= t1, 1 <= j <= t2, one anti-diagonal
    i + j = k after another: (i, j, the offsets of each diagonal)."""
    ii, offs = [], [0]
    for k in range(2, t1 + t2 + 1):
        ii.extend(range(max(1, k - t2), min(t1, k - 1) + 1))
        offs.append(len(ii))
    i = np.asarray(ii, np.int64)
    j = np.repeat(np.arange(2, t1 + t2 + 1), np.diff(offs)) - i
    both = torch.as_tensor(np.stack([i, j]), device=device)
    return both[0], both[1], offs


def _levenshtein(h, r, hl, rl):
    """Levenshtein distances of the rows of h [N, T1] against those of r
    [N, T2] within their lengths: the table [N, T1 + 1, T2 + 1] filled one
    anti-diagonal at a time (every cell of a diagonal depends only on
    the two before it), f32, then each row's cell (hl, rl)."""
    n, t1 = h.shape
    t2 = r.shape[1]
    dev = h.device
    f32 = {"dtype": torch.float32, "device": dev}
    table = (torch.arange(t1 + 1, **f32)[:, None] +
             torch.arange(t2 + 1, **f32)[None, :]).repeat(n, 1, 1)
    table[:, 1:, 1:] = 0
    if t1 and t2:
        ci, cj, offs = _diagonals(t1, t2, dev)
        for a, b in zip(offs[:-1], offs[1:]):
            i, j = ci[a:b], cj[a:b]
            sub = table[:, i - 1, j - 1] + (h[:, i - 1] != r[:, j - 1]).float()
            up = table[:, i - 1, j] + 1.0
            left = table[:, i, j - 1] + 1.0
            table[:, i, j] = torch.minimum(torch.minimum(left, up), sub)
    return table[torch.arange(n, device=dev), hl.long(), rl.long()]


@register_op("edit_distance", grad=None,
             nondiff_inputs=("Hyps", "Refs", "HypsLength", "RefsLength"))
def edit_distance(ins, attrs, ctx):
    """reference: edit_distance_op.cc: the Levenshtein distance of each
    pair, over the ref's length when `normalized`; `ignored_tokens` are
    taken out of both first."""
    hyps = ins["Hyps"][0]
    refs = ins["Refs"][0]
    if hyps.ndim == 1:
        hyps, refs = hyps[None], refs[None]
    n, t1 = hyps.shape
    t2 = refs.shape[1]
    seq_num = torch.tensor([n], dtype=torch.int64, device=hyps.device)
    if ctx.in_shape_inference:
        return {"Out": torch.zeros((n, 1), dtype=torch.float32,
                                   device=hyps.device),
                "SequenceNum": seq_num}
    hlen = row_lengths(ins, n, t1, hyps.device, slot="HypsLength")
    rlen = row_lengths(ins, n, t2, hyps.device, slot="RefsLength")
    ignored = [int(v) for v in attrs.get("ignored_tokens", []) or []]
    if ignored:
        vh = torch.arange(t1, device=hyps.device)[None, :] < hlen[:, None]
        vr = torch.arange(t2, device=hyps.device)[None, :] < rlen[:, None]
        eh = torch.zeros_like(vh)
        er = torch.zeros_like(vr)
        for tok in ignored:
            eh |= hyps == tok
            er |= refs == tok
        hyps, hlen = _compact_left(hyps, vh & ~eh)
        refs, rlen = _compact_left(refs, vr & ~er)
    dist = _levenshtein(hyps, refs, hlen, rlen)
    if bool(attrs.get("normalized", True)):
        dist = dist / torch.clamp(rlen, min=1).to(torch.float32)
    return {"Out": dist[:, None], "SequenceNum": seq_num}


@register_op("ctc_align", grad=None, nondiff_inputs=("Input", "InputLength"))
def ctc_align(ins, attrs, ctx):
    """reference: ctc_align_op.cc: merge repeated tokens, drop blanks,
    compact each row to the left (the freed tail holds 0) and report
    OutputLength."""
    x = ins["Input"][0]                    # [N, T] int
    blank = int(attrs.get("blank", 0))
    n, t = x.shape
    ilen = row_lengths(ins, n, t, x.device, slot="InputLength")
    valid = torch.arange(t, device=x.device)[None, :] < ilen[:, None]
    keep = valid & (x != blank)
    if bool(attrs.get("merge_repeated", True)):
        prev = torch.cat([torch.full((n, 1), -1, dtype=x.dtype,
                                     device=x.device), x[:, :-1]], dim=1)
        keep &= x != prev
    out, new_len = _compact_left(x, keep)
    return {"Output": out, "OutputLength": new_len[:, None].to(torch.int64)}


CTC_LOG_EPSILON = -1e5     # optax.ctc_loss's stand-in for log(0)


def ctc_loss(logits, logit_pad, labels, label_pad, blank=0):
    """Per-sample CTC loss [B]: `optax.ctc_loss` (logits [B, T, K],
    padding indicators [B, T] and [B, N] in logits' dtype, labels [B, N]
    right-padded) operation for operation, its scan over the frames a
    Python loop on the device. The emission log-probs are taken with a
    one-hot product, as there, so an out-of-range (padded) label emits
    log-prob 0 and the backward is a matrix product, deterministic on
    the card."""
    b, t, k = logits.shape
    n = labels.shape[1]
    eps = CTC_LOG_EPSILON
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = n - label_pad.sum(dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    phi_lp = logprobs[:, :, blank:blank + 1].transpose(0, 1)     # [T, B, 1]
    one_hot = (labels[..., None] == torch.arange(k, device=logits.device)
               ).to(logits.dtype)                                # [B, N, K]
    emit_lp = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1)
    pads = logit_pad.transpose(0, 1)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=-1)

    kw = {"dtype": logits.dtype, "device": logits.device}
    phi = torch.cat([torch.zeros((b, 1), **kw),
                     torch.full((b, n), eps, **kw)], dim=1)
    emit = torch.full((b, n), eps, **kw)
    for s in range(t):
        phi_orig = phi
        phi = update_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(phi[:, :-1] + emit_lp[s],
                                    emit + emit_lp[s])
        next_phi = update_phi(phi + phi_lp[s],
                              emit + phi_lp[s] + eps * (1.0 - repeat))
        pad = pads[s].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None]).reshape(b)


def _warpctc_grad(ins, attrs, ctx):
    """warpctc's gradient from its forward's WarpCTCGrad, as the
    reference's warpctc_grad takes it: each sample's loss reads only its
    own logits, so the gradient of sum_b cot_b loss_b is cot_b (over the
    frame count under norm_by_times) times row b of WarpCTCGrad, the
    generic gradient without replaying the frames' loop. A cotangent on
    WarpCTCGrad itself (a second-order term) takes the generic
    gradient."""
    from ..core.registry import get_op_def, make_generic_grad_kernel

    og = ins.get(GRAD_PREFIX_OG + "WarpCTCGrad") or [None]
    if og[0] is not None:
        return make_generic_grad_kernel(get_op_def("warpctc"))(ins, attrs,
                                                                ctx)
    logits = ins[GRAD_PREFIX_IN + "Logits"][0]
    cot = (ins.get(GRAD_PREFIX_OG + "Loss") or [None])[0]
    if cot is None:
        grad = torch.zeros_like(logits)
    else:
        scale = cot.reshape(-1).to(logits.dtype)
        if attrs.get("norm_by_times", False):
            n, t = logits.shape[:2]
            llen = row_lengths({k[len(GRAD_PREFIX_IN):]: v
                                for k, v in ins.items()
                                if k.startswith(GRAD_PREFIX_IN)},
                               n, t, logits.device, slot="LogitsLength")
            scale = scale / torch.clamp(llen, min=1).to(scale.dtype)
        grad = scale[:, None, None] * \
            ins[GRAD_PREFIX_OUT + "WarpCTCGrad"][0].to(logits.dtype)
    outs = {}
    for k in ctx.requested_outputs():
        if not k.startswith(GRAD_PREFIX_IG):
            continue
        slot = k[len(GRAD_PREFIX_IG):]
        outs[k] = [grad] if slot == "Logits" else [
            None if x is None else torch.zeros_like(x)
            for x in ins.get(GRAD_PREFIX_IN + slot, [])]
    return outs


@register_op("warpctc", grad=_warpctc_grad,
             nondiff_inputs=("Label", "LogitsLength", "LabelLength"),
             intermediate_outputs=("WarpCTCGrad",))
def warpctc(ins, attrs, ctx):
    """reference: warpctc_op.cc: the CTC loss of each sample ([N, 1]),
    `ctc_loss` above, divided by its frame count under norm_by_times;
    WarpCTCGrad is the gradient of the summed unnormalized losses with
    respect to the logits, as warp-ctc caches it, from which its
    gradient is taken (`_warpctc_grad`)."""
    logits = ins["Logits"][0]              # [N, T, C]
    label = ins["Label"][0]                # [N, L]
    n, t, _ = logits.shape
    if ctx.in_shape_inference:
        return {"Loss": torch.zeros((n, 1), dtype=logits.dtype,
                                    device=logits.device),
                "WarpCTCGrad": torch.zeros_like(logits)}
    llen = row_lengths(ins, n, t, logits.device, slot="LogitsLength")
    yl = row_lengths(ins, n, label.shape[1], logits.device,
                     slot="LabelLength")
    logit_pad = (torch.arange(t, device=logits.device)[None, :] >=
                 llen[:, None]).to(logits.dtype)
    label_pad = (torch.arange(label.shape[1], device=logits.device)[None, :]
                 >= yl[:, None]).to(logits.dtype)
    with torch.enable_grad():
        # a replay under the generic gradient hands in a leaf of its
        # graph: keep that graph for its own backward
        lg = logits if logits.requires_grad else \
            logits.detach().requires_grad_()
        loss = ctc_loss(lg, logit_pad, label, label_pad,
                        blank=int(attrs.get("blank", 0)))
        (grad,) = torch.autograd.grad(loss.sum(), lg,
                                      retain_graph=lg is logits)
    if lg is not logits:
        loss = loss.detach()
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(llen, min=1).to(loss.dtype)
    return {"Loss": loss[:, None], "WarpCTCGrad": grad}


@register_op("multiplex", nondiff_inputs=("Ids",))
def multiplex(ins, attrs, ctx):
    """reference: multiplex_op.cc: out[i] = X[ids[i]][i]."""
    xs = torch.stack([x for x in ins["X"] if x is not None])   # [K, N, D]
    ids = ins["Ids"][0].reshape(-1).to(torch.int64)
    return {"Out": xs[ids, torch.arange(xs.shape[1], device=xs.device)]}


@register_op("minus")
def minus(ins, attrs, ctx):
    """reference: minus_op.cc: Out = X - Y."""
    return {"Out": ins["X"][0] - ins["Y"][0]}


@register_op("fsp", nondiff_inputs=())
def fsp(ins, attrs, ctx):
    """reference: fsp_op.cc: the flow-of-solution-procedure matrix,
    [N, Cx, H, W] x [N, Cy, H, W] -> [N, Cx, Cy] / (H W)."""
    x, y = ins["X"][0], ins["Y"][0]
    out = torch.einsum("nchw,ndhw->ncd", x, y)
    return {"Out": out / _const(x, x.shape[2] * x.shape[3])}


@register_op("mean_iou", grad=None, nondiff_inputs=("Predictions", "Labels"))
def mean_iou(ins, attrs, ctx):
    """reference: mean_iou_op.cc: the mean IoU over the classes present;
    OutWrong counts each mismatch at both its predicted and its true
    class, as mean_iou_op.h does, and the optional In* inputs are added
    (streaming)."""
    pred = ins["Predictions"][0].reshape(-1).to(torch.int32)
    label = ins["Labels"][0].reshape(-1).to(torch.int32)
    classes = torch.arange(int(attrs["num_classes"]), device=pred.device)
    onehot_p = pred[:, None] == classes[None, :]
    onehot_l = label[:, None] == classes[None, :]
    wrong = ((onehot_p & ~onehot_l).sum(0) +
             (~onehot_p & onehot_l).sum(0)).to(torch.int32)
    correct = (onehot_p & onehot_l).sum(0).to(torch.int32)
    for w_in in ins.get("InWrongs", []) or []:
        if w_in is not None:
            wrong = wrong + w_in.to(torch.int32)
    for c_in in ins.get("InCorrects", []) or []:
        if c_in is not None:
            correct = correct + c_in.to(torch.int32)
    union = (wrong + correct).to(torch.float32)
    present = union > 0
    iou = torch.where(present, correct.to(torch.float32) /
                      torch.clamp(union, min=1.0), torch.zeros_like(union))
    miou = iou.sum() / torch.clamp(present.sum(), min=1).to(torch.float32)
    for m_in in ins.get("InMeanIou", []) or []:
        if m_in is not None:
            miou = miou + m_in.reshape(())
    return {"OutMeanIou": miou.reshape(1), "OutWrong": wrong,
            "OutCorrect": correct}


@register_op("similarity_focus", grad=None, nondiff_inputs=("X",))
def similarity_focus(ins, attrs, ctx):
    """reference: similarity_focus_op.cc: for each index of `axis`, pick
    the maxima of its [B, C] slice greedily, each row and column at most
    once, and mark the picked cells (in every channel) with 1. The picks
    of all samples run together, min(B, C) steps."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", 1))
    indexes = [int(i) for i in attrs["indexes"]]
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    n, _, b, c = x.shape
    rows = torch.arange(n, device=x.device)
    ninf = torch.full((), -math.inf, dtype=x.dtype, device=x.device)
    out = torch.zeros_like(x)
    for idx in indexes:
        scores = x[:, idx].clone()                  # [N, B, C]
        mask = torch.zeros_like(scores)
        for _ in range(min(b, c)):
            flat = scores.reshape(n, -1).argmax(dim=1)
            i, j = flat // c, flat % c
            ok = scores[rows, i, j] > ninf
            mask[rows, i, j] = torch.where(ok, torch.ones_like(ninf),
                                           mask[rows, i, j])
            scores[rows, i, :] = torch.where(ok[:, None], ninf,
                                             scores[rows, i, :])
            scores[rows, :, j] = torch.where(ok[:, None], ninf,
                                             scores[rows, :, j])
        out = torch.maximum(out, mask[:, None, :, :])
    if axis != 1:
        out = torch.movedim(out, 1, axis)
    return {"Out": out}


@register_op("uniform_random_batch_size_like", is_random=True, grad=None,
             nondiff_inputs=("Input",))
def uniform_random_batch_size_like(ins, attrs, ctx):
    from .tensor import _dt, _uniform, batch_size_like_shape

    shape = batch_size_like_shape(ins, attrs)
    return {"Out": _uniform(ctx, shape, float(attrs.get("min", -1.0)),
                            float(attrs.get("max", 1.0))).to(_dt(attrs))}


@register_op("gaussian_random_batch_size_like", is_random=True, grad=None,
             nondiff_inputs=("Input",))
def gaussian_random_batch_size_like(ins, attrs, ctx):
    from .tensor import _dt, batch_size_like_shape

    shape = batch_size_like_shape(ins, attrs)
    z = torch.randn(shape, generator=ctx.rng(), dtype=torch.float32,
                    device=ctx.device)
    return {"Out": (z * float(attrs.get("std", 1.0)) +
                    float(attrs.get("mean", 0.0))).to(_dt(attrs))}


# -- py_func: the user's Python callable as an op

# the callables layers.py_func registers (reference: py_func_op.cc keeps
# a global vector of them, indexed by the callable-id attrs)
PY_FUNC_REGISTRY: list = []


def register_py_func(fn) -> int:
    PY_FUNC_REGISTRY.append(fn)
    return len(PY_FUNC_REGISTRY) - 1


def _from_host(r, like_shape, dtype, device):
    """The callable's result `r` as a tensor of `like_shape` and `dtype`
    (a torch dtype) on `device`."""
    a = np.asarray(r)
    if dtype == torch.bfloat16:
        t = torch.from_numpy(a.astype(np.float32)).to(dtype)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            a.astype(str(dtype).rsplit(".", 1)[-1])))
    return t.reshape(like_shape).to(device)


def _py_func_grad(ins, attrs, ctx):
    """reference: py_func_op.cc's backward: the registered backward
    callable gets (forward inputs, forward outputs, output gradients),
    less the names in backward_skip_vars, on the host, and returns the
    inputs' gradients in order (None: zeros)."""
    xs = ins.get(GRAD_PREFIX_IN + "X", [])
    outs = ins.get(GRAD_PREFIX_OUT + "Out", [])
    ogs = ins.get(GRAD_PREFIX_OG + "Out", [])
    bid = int(attrs.get("backward_callable_id", -1))
    zeros = [None if x is None else torch.zeros_like(x) for x in xs]
    if bid < 0 or ctx.in_shape_inference:
        return {GRAD_PREFIX_IG + "X": zeros}
    fn = PY_FUNC_REGISTRY[bid]
    skip = set(attrs.get("backward_skip_vars", []) or [])
    x_names = ctx.op.inputs.get(GRAD_PREFIX_IN + "X", [])
    out_names = ctx.op.inputs.get(GRAD_PREFIX_OUT + "Out", [])
    args = [v for name, v in list(zip(x_names, xs)) +
            list(zip(out_names, outs)) if name not in skip and v is not None]
    for i, o in enumerate(outs):
        g = ogs[i] if i < len(ogs) and ogs[i] is not None else \
            torch.zeros_like(o)
        args.append(g)
    res = fn(*[to_numpy(a) for a in args])
    if res is None:
        res = ()
    if not isinstance(res, (tuple, list)):
        res = (res,)
    grads = []
    for i, x in enumerate(xs):
        r = res[i] if i < len(res) else None
        grads.append(zeros[i] if r is None or x is None else
                     _from_host(r, x.shape, x.dtype, x.device))
    return {GRAD_PREFIX_IG + "X": grads}


@register_op("py_func", grad=_py_func_grad)
def py_func(ins, attrs, ctx):
    """reference: py_func_op.cc: run a registered Python callable on the
    host arrays of the inputs (as the JAX op's `jax.pure_callback`
    does); its results come back on the op's device at the shapes and
    dtypes of the declared out vars (out_shapes, out_dtypes; a -1
    leading dim is the first input's). With no outputs it is a hook run
    for its side effect."""
    fn = PY_FUNC_REGISTRY[int(attrs["forward_callable_id"])]
    xs = [x for x in ins.get("X", []) if x is not None]
    shapes = attrs.get("out_shapes", []) or []
    dtypes = attrs.get("out_dtypes", []) or []
    if not shapes:
        if not ctx.in_shape_inference:
            fn(*[to_numpy(x) for x in xs])
        return {}

    def resolve(s):
        s = [int(v) for v in s]
        for i, v in enumerate(s):
            if v < 0:
                assert i == 0 and xs, (
                    "py_func: only a -1 batch dim is resolvable; declare "
                    "concrete trailing dims on the out var")
                s[i] = xs[0].shape[0]
        return tuple(s)

    specs = [(resolve(s), torch_dtype(d)) for s, d in zip(shapes, dtypes)]
    if ctx.in_shape_inference:
        return {"Out": [torch.empty(s, dtype=d, device=ctx.device)
                        for s, d in specs]}
    res = fn(*[to_numpy(x) for x in xs])
    if not isinstance(res, (tuple, list)):
        res = (res,)
    return {"Out": [_from_host(r, s, d, ctx.device)
                    for r, (s, d) in zip(res, specs)]}


# -- the distributed utility ops (reference: coalesce_tensor_op.cc,
# fake_init_op.cc, the controlflow delete ops,
# distributed_ops/ref_by_trainer_id_op.cc)


@register_op("coalesce_tensor", grad=None)
def coalesce_tensor(ins, attrs, ctx):
    """Pack the inputs into one flat buffer (FusedOutput) and give each
    back as a view of its slice (Output); with set_constant the buffer
    holds `constant`. Inputs of mixed dtypes raise, as the reference's
    dtype attr check does: a silent cast would round f32 gradients
    through the first input's dtype."""
    xs = ins["Input"]
    dtype = xs[0].dtype
    if any(x.dtype != dtype for x in xs):
        raise TypeError(
            f"coalesce_tensor: mixed input dtypes "
            f"{[str(x.dtype) for x in xs]} — all inputs must match")
    sizes = [x.numel() for x in xs]
    if bool(attrs.get("set_constant", False)):
        flat = torch.full((sum(sizes),), float(attrs.get("constant", 0.0)),
                          dtype=dtype, device=xs[0].device)
    else:
        flat = torch.cat([x.reshape(-1) for x in xs])
    outs = [part.reshape(x.shape)
            for part, x in zip(torch.split(flat, sizes), xs)]
    return {"Output": outs, "FusedOutput": flat}


@register_op("fake_init", grad=None)
def fake_init(ins, attrs, ctx):
    """Zeros of the declared shape for a var whose storage lives
    remotely (the trainer side of a distributed lookup table)."""
    from ..core.ir import normalize_dtype

    shape = [int(s) for s in attrs.get("shape", [1])]
    return {"Out": torch.zeros(
        shape, dtype=torch_dtype(normalize_dtype(attrs.get("dtype", 5))),
        device=ctx.device)}


@register_op("delete_var", grad=None, nondiff_inputs=("X",))
def delete_var(ins, attrs, ctx):
    """A scope GC marker: a step's dead values are freed when nothing
    holds them, so this is a no-op kept for program compatibility."""
    return {}


@register_op("ref_by_trainer_id", grad=None,
             nondiff_inputs=("X", "TrainerId"))
def ref_by_trainer_id(ins, attrs, ctx):
    """This trainer's slice of the X list, by TrainerId (DC-ASGD
    plumbing). An id outside the list is a misconfigured cluster and
    raises, as the reference's check does."""
    xs = torch.stack(list(ins["X"]))
    if ctx.in_shape_inference:
        return {"Out": xs[0]}
    tid = int(ins["TrainerId"][0].reshape(()))
    if not 0 <= tid < xs.shape[0]:
        raise ValueError(f"ref_by_trainer_id: TrainerId {tid} out of range "
                         f"for {xs.shape[0]} inputs")
    return {"Out": xs[tid]}
