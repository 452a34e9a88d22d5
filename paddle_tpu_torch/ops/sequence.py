"""Sequence ops of the fluid path: the JAX package's `ops/sequence.py`
(reference: paddle/fluid/operators/sequence_ops/), all seventeen.

As there, a variable-length batch is a padded [N, T, ...] tensor with
an optional [N] `Length` input in place of the reference's LoD. Where a
JAX primitive clamps or drops what torch would refuse (a runtime slice
offset, an out-of-range scatter id), the op does what the JAX one does.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op, torch_dtype


def _mask(lengths, maxlen, dtype):
    """[N, maxlen]: 1 where the position is inside its row's length."""
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths.reshape(-1, 1)).to(dtype)


def _given(ins, slot):
    return ins.get(slot) and ins[slot][0] is not None


def row_lengths(ins, n, t, device, slot="Length"):
    """Row lengths (int32) from the optional `slot` input, defaulting to
    full T."""
    if _given(ins, slot):
        return ins[slot][0].reshape(-1).to(torch.int32)
    return torch.full((n,), t, dtype=torch.int32, device=device)


def _compact_left(x, keep):
    """Stable-compact the kept positions of each row to the left along
    axis 1; the freed tail holds 0. Returns (compacted, new_lengths)."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.gather(x, 1, order)
    new_len = keep.sum(dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    out = torch.where(pos[None, :] < new_len[:, None], compacted,
                      torch.zeros_like(compacted))
    return out, new_len


def scatter_add_rows(x, ids, upd):
    """Per row i: x[i, ids[i, j]] += upd[i, j], as JAX's `.at[].add`
    does it: a negative id counts from the end, an id still outside
    [0, D) is dropped (`index_add_` and `scatter_add` raise)."""
    d = x.shape[-1]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + d, ids)
    ok = (ids >= 0) & (ids < d)
    upd = torch.where(ok, upd.to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
    return x.scatter_add(-1, ids.clamp(0, max(d - 1, 0)), upd)


@register_op("sequence_mask", grad=None, nondiff_inputs=("X",))
def sequence_mask(ins, attrs, ctx):
    """reference: sequence_ops/sequence_mask_op.cc. X: lengths of any
    shape -> Y [X.numel(), maxlen] of `out_dtype` (default int64);
    maxlen < 0 reads max(X) (a host read)."""
    x = ins["X"][0]
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0:
        maxlen = int(torch.max(x))
    return {"Y": _mask(x, maxlen, torch_dtype(attrs.get("out_dtype",
                                                         "int64")))}


@register_op("sequence_pool", nondiff_inputs=("Length",))
def sequence_pool(ins, attrs, ctx):
    """Masked pooling over the time axis of a padded [N, T, D] batch
    (reference: sequence_ops/sequence_pool_op.cc over LoD). MAX fills
    the masked positions with the dtype's finfo.min, so a length-0 row
    pools to it; LAST of a length-0 row reads position 0."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "SUM").upper()
    if _given(ins, "Length"):
        m = _mask(ins["Length"][0], x.shape[1], x.dtype)[..., None]
    else:
        m = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)[..., None]
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                    min=1.0)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(
            torch.clamp(torch.sum(m, dim=1), min=1.0))
    elif ptype == "MAX":
        neg = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype,
                           device=x.device)
        # amax, not max(dim): a tie shares the gradient, as jnp.max's
        out = torch.amax(torch.where(m > 0, x, neg), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(torch.sum(m[:, :, 0], dim=1).to(torch.int64) - 1,
                          min=0)
        out = x[torch.arange(x.shape[0], device=x.device), idx]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unsupported pooltype {ptype}")
    return {"Out": out, "MaxIndex": None}


@register_op("sequence_softmax", nondiff_inputs=("Length",))
def sequence_softmax(ins, attrs, ctx):
    """Softmax over the last axis of X [N, T]; positions past Length
    take -1e9 (finite: a length-0 row comes out uniform)."""
    x = ins["X"][0]
    if _given(ins, "Length"):
        m = _mask(ins["Length"][0], x.shape[-1], x.dtype)
        x = torch.where(m > 0, x, torch.tensor(-1e9, dtype=x.dtype,
                                               device=x.device))
    return {"Out": torch.softmax(x, dim=-1)}


@register_op("sequence_reverse", nondiff_inputs=("Length",))
def sequence_reverse(ins, attrs, ctx):
    """Each row's first Length positions reversed, its padding left in
    place; with no Length the whole T flips."""
    x = ins["X"][0]
    if not _given(ins, "Length"):
        return {"Y": torch.flip(x, dims=[1])}
    lengths = ins["Length"][0].reshape(-1, 1).to(torch.int64)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    gather_idx = torch.where(idx < lengths, lengths - 1 - idx, idx)
    gather_idx = gather_idx.reshape(gather_idx.shape + (1,) * (x.ndim - 2))
    return {"Y": torch.gather(x, 1, gather_idx.expand(x.shape))}


@register_op("sequence_expand", nondiff_inputs=("Y",))
def sequence_expand(ins, attrs, ctx):
    """The padded-batch form: each time step of X repeated
    Y.T // X.T times along axis 1 (X of rank 1 passes through)."""
    x = ins["X"][0]
    y = ins["Y"][0]
    if x.ndim <= 1:
        return {"Out": x}
    return {"Out": torch.repeat_interleave(
        x, y.shape[1] // max(x.shape[1], 1), dim=1)}


@register_op("sequence_concat")
def sequence_concat(ins, attrs, ctx):
    return {"Out": torch.cat([x for x in ins["X"] if x is not None], dim=1)}


@register_op("sequence_slice")
def sequence_slice(ins, attrs, ctx):
    """X[:, offset:offset + length]: `length` is an attr; the offset an
    attr or a runtime Offset tensor, which is read as
    `lax.dynamic_slice_in_dim` reads it (where torch.narrow would
    raise): a negative offset counts from the end, and the result is
    clamped into [0, T - length]; on the device, without a host read."""
    x = ins["X"][0]
    length = int(attrs["length"])
    off = ins["Offset"][0] if ins.get("Offset") else None
    if off is None:
        o = int(attrs.get("offset", 0))
        return {"Out": x[:, o:o + length]}
    t = x.shape[1]
    o = off.reshape(-1)[0].to(torch.int64)
    o = torch.clamp(torch.where(o < 0, o + t, o), 0, max(t - length, 0))
    idx = o + torch.arange(length, device=x.device)
    return {"Out": torch.index_select(x, 1, idx)}


@register_op("im2sequence")
def im2sequence(ins, attrs, ctx):
    """reference: im2sequence_op.cc: sliding-window patches as a
    sequence (OCR models). [N, C, H, W] -> [N, H' * W', C * kh * kw],
    the features in (C, kh, kw) order, as
    `conv_general_dilated_patches` and `F.unfold` both give them;
    paddings are [top, left, bottom, right]."""
    x = ins["X"][0]
    kh, kw = [int(k) for k in attrs["kernels"]]
    sh, sw = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0, 0, 0])]
    x = torch.nn.functional.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    patches = torch.nn.functional.unfold(x, (kh, kw), stride=(sh, sw))
    return {"Out": patches.transpose(1, 2)}


@register_op("sequence_pad", nondiff_inputs=("PadValue", "Length"))
def sequence_pad(ins, attrs, ctx):
    """reference: sequence_ops/sequence_pad_op.cc: the batch is already
    [N, T, ...]; re-pad it to `padded_length` (truncating or extending
    T) with PadValue (a scalar or one time step's shape) past each
    row's Length. Length out is int64."""
    x = ins["X"][0]
    if _given(ins, "PadValue"):
        pv = ins["PadValue"][0]
        pad_value = pv.reshape(()) if pv.numel() == 1 else \
            pv.reshape(x.shape[2:])
    else:
        pad_value = torch.zeros((), dtype=x.dtype, device=x.device)
    n, t = x.shape[0], x.shape[1]
    plen = int(attrs.get("padded_length", -1))
    if plen < 0:
        plen = t
    if plen > t:
        x = torch.cat([x, x.new_zeros((n, plen - t) + tuple(x.shape[2:]))],
                      dim=1)
    elif plen < t:
        x = x[:, :plen]
    lengths = torch.clamp(row_lengths(ins, n, min(t, plen), x.device),
                          max=plen)
    m = _mask(lengths, plen, torch.bool)
    m = m.reshape(m.shape + (1,) * (x.ndim - 2))
    out = torch.where(m, x, pad_value.to(x.dtype))
    return {"Out": out, "Length": lengths.to(torch.int64)}


@register_op("sequence_unpad", nondiff_inputs=("Length",))
def sequence_unpad(ins, attrs, ctx):
    """reference: sequence_ops/sequence_unpad_op.cc: strips padding back
    to LoD; statically, zeroes the positions past Length (the consumers
    read Length)."""
    x = ins["X"][0]
    lengths = ins["Length"][0].reshape(-1)
    m = _mask(lengths, x.shape[1], torch.bool)
    m = m.reshape(m.shape + (1,) * (x.ndim - 2))
    return {"Out": torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device)),
            "Length": lengths.to(torch.int64)}


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
    if _given(ins, "Length"):
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


@register_op("sequence_enumerate", grad=None, nondiff_inputs=("X", "Length"))
def sequence_enumerate(ins, attrs, ctx):
    """reference: sequence_ops/sequence_enumerate_op.cc: the win_size
    window of ids starting at each position; the window's positions
    past the row's end hold pad_value. X [N, T] -> Out [N, T, win]."""
    x = ins["X"][0]
    win = int(attrs["win_size"])
    pad = int(attrs.get("pad_value", 0))
    n, t = x.shape[0], x.shape[1]
    lengths = row_lengths(ins, n, t, x.device)
    pos = torch.arange(t, device=x.device)[:, None] + \
        torch.arange(win, device=x.device)[None, :]          # [T, win]
    gathered = x[:, torch.clamp(pos, max=t - 1)]
    ok = pos[None] < lengths[:, None, None]
    return {"Out": torch.where(ok, gathered, torch.full(
        (), pad, dtype=x.dtype, device=x.device))}


@register_op("sequence_erase", grad=None, nondiff_inputs=("X", "Length"))
def sequence_erase(ins, attrs, ctx):
    """reference: sequence_ops/sequence_erase_op.cc: drop the listed
    tokens and compact each row left (a stable sort on the erase flag);
    the freed tail holds 0 and Length shrinks."""
    x = ins["X"][0]
    tokens = [int(v) for v in attrs.get("tokens", [])]
    n, t = x.shape
    keep = _mask(row_lengths(ins, n, t, x.device), t, torch.bool)
    for tok in tokens:
        keep = keep & (x != tok)
    out, new_len = _compact_left(x, keep)
    return {"Out": out, "Length": new_len.to(torch.int64)}


@register_op("sequence_expand_as", nondiff_inputs=("Y",))
def sequence_expand_as(ins, attrs, ctx):
    """reference: sequence_ops/sequence_expand_as_op.cc: each row of X
    along Y's time axis ([N, D] -> [N, T, D])."""
    x = ins["X"][0]
    t = ins["Y"][0].shape[1]
    if x.ndim == 2:
        x = x[:, None, :]
    return {"Out": x.expand((x.shape[0], t) + tuple(x.shape[2:])).clone()}


@register_op("sequence_reshape")
def sequence_reshape(ins, attrs, ctx):
    """reference: sequence_ops/sequence_reshape_op.cc: time steps traded
    for feature width, [N, T, D] -> [N, T * D / new_dim, new_dim]."""
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    n, t, d = x.shape
    return {"Out": x.reshape(n, t * d // new_dim, new_dim)}


@register_op("sequence_scatter", nondiff_inputs=("Ids", "Length"))
def sequence_scatter(ins, attrs, ctx):
    """reference: sequence_ops/sequence_scatter_op.cc: per row i, add
    Updates[i, j] into X[i, Ids[i, j]] for j < Length[i]; ids out of
    range are dropped and negative ones wrap (`scatter_add_rows`)."""
    x = ins["X"][0]                        # [N, D]
    ids = ins["Ids"][0]                    # [N, T]
    upd = ins["Updates"][0]                # [N, T]
    if _given(ins, "Length"):
        upd = upd * _mask(ins["Length"][0].reshape(-1), ids.shape[1],
                          upd.dtype)
    return {"Out": scatter_add_rows(x, ids, upd)}


@register_op("sequence_topk_avg_pooling", nondiff_inputs=("ROW", "COLUMN"))
def sequence_topk_avg_pooling(ins, attrs, ctx):
    """reference: sequence_ops/sequence_topk_avg_pooling_op.cc: for each
    (row position, channel), the mean of the top k values across the
    column axis, for every k in `topks` (a k beyond the valid columns
    still divides by k). X [N, C, H, W] (+ optional ROW / COLUMN
    lengths) -> Out [N, H, C * len(topks)]."""
    x = ins["X"][0]
    topks = [int(k) for k in attrs["topks"]]
    n, c, h, w = x.shape
    if _given(ins, "COLUMN"):
        cm = _mask(ins["COLUMN"][0].reshape(-1), w, x.dtype)     # [N, W]
        x = torch.where(cm[:, None, None, :] > 0, x,
                        torch.tensor(float("-inf"), dtype=x.dtype,
                                     device=x.device))
    kmax = min(max(topks), w)
    top = torch.topk(x, kmax, dim=-1).values                      # sorted
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    out = torch.stack([torch.sum(top[..., :min(k, kmax)], dim=-1) / float(k)
                       for k in topks], dim=-1)                   # [N,C,H,K]
    out = out.permute(0, 2, 1, 3).reshape(n, h, c * len(topks))
    if _given(ins, "ROW"):
        out = out * _mask(ins["ROW"][0].reshape(-1), h, out.dtype)[:, :, None]
    return {"Out": out, "pos": None}
