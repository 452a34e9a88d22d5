"""Detection ops of the fluid path: the JAX package's `ops/detection.py`,
all 32 op types (reference: paddle/fluid/operators/detection/).

Coverage: geometry (iou_similarity, box_coder, prior_box,
density_prior_box, anchor_generator, box_clip, polygon_box_transform,
box_decoder_and_assign, yolo_box), RoI pooling (roi_align, roi_pool,
psroi_pool, prroi_pool, deformable_psroi_pooling,
roi_perspective_transform), matching and targets (bipartite_match,
target_assign, mine_hard_examples, rpn_target_assign,
retinanet_target_assign, generate_proposal_labels,
generate_mask_labels), losses (sigmoid_focal_loss, yolov3_loss,
ssd_loss), the NMS family (multiclass_nms and multiclass_nms2,
generate_proposals, collect_fpn_proposals, distribute_fpn_proposals,
retinanet_detection_output) and the streaming metric detection_map.

The JAX package's static-shape contracts hold here: NMS and proposal
outputs are fixed-capacity, padded with -1 labels or zero rows, with an
explicit count; the roi ops pool image 0 and refuse N > 1.

* **NMS.** `_nms_rows` is the JAX op's `_nms_static` (a fixed-length
  greedy scan: per step an argmax, then a suppress; -1 padding) run as
  one loop of `max_out` steps over every row at once (images x classes),
  with no host sync inside: on the card each step is a fixed handful of
  launches whatever the batch.
* **Tie order.** Every `lax.top_k` of the source is `stable_top_k`
  (ties to the lower index); every `jnp.argsort` is a stable argsort;
  `torch.argmax` returns the first maximum, as `jnp.argmax` does.
* **Repeated scatter indices.** Two gts may share a best prior or
  anchor. ssd_loss's forced positive then takes what XLA's CPU scatter
  keeps, the last writer in index order, as an `amax` over the writer's
  index, so the card agrees; rpn_target_assign's and
  retinanet_target_assign's writers all write True.
* **Random ops.** rpn_target_assign and generate_proposal_labels draw
  from `ctx.rng()`; with `use_random=False` they pick the lowest
  indices, as the JAX ops do. retinanet_target_assign is registered
  random, as the JAX op is, and draws nothing.
* **detection_map** runs its matching and AP on the host, as the JAX op
  does through `jax.pure_callback` and Paddle's on the CPU: this is the
  reference's design, not a fallback. Its inputs reach the host in one
  device-to-host copy a call.

Float constants are float32 (the JAX package without x64); the JAX
package's tests run it under x64, where some of its ops compute in
float64.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import _DYN_SENTINEL, register_op
from .tensor import stable_top_k

_NEG_INF = float("-inf")


def _opt(ins, slot):
    """The first tensor of an optional input slot, or None."""
    v = ins.get(slot)
    return v[0] if v and v[0] is not None else None


def _f32(x, like):
    """A constant array as a tensor of `like`'s float dtype and device."""
    return torch.as_tensor(np.asarray(x, np.float64), dtype=like.dtype,
                           device=like.device)


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _div(x, n):
    """x / n for a Python number n, divided on every device: CUDA takes
    `x / n` as x times n's reciprocal, which can land an ulp off the
    quotient and move the floor or the cast that follows it."""
    dt = x.dtype if x.is_floating_point() else torch.float32
    return x / torch.full((), n, dtype=dt, device=x.device)


@register_op("iou_similarity", grad=None)
def iou_similarity(ins, attrs, ctx):
    x, y = ins["X"][0], ins["Y"][0]  # [N,4],[M,4] xyxy
    area_x = (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    area_y = (y[:, 2] - y[:, 0]) * (y[:, 3] - y[:, 1])
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return {"Out": inter / (area_x[:, None] + area_y[None, :] - inter + 1e-10)}


@register_op("box_coder", grad=None)
def box_coder(ins, attrs, ctx):
    """reference: detection/box_coder_op.cc."""
    prior, tb = ins["PriorBox"][0], ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    norm = attrs.get("box_normalized", True)
    pv = _opt(ins, "PriorBoxVar")
    one = 0.0 if norm else 1.0
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, None, 2] - tb[:, None, 0] + one
        th = tb[:, None, 3] - tb[:, None, 1] + one
        tcx = tb[:, None, 0] + tw * 0.5
        tcy = tb[:, None, 1] + th * 0.5
        ox = (tcx - pcx) / pw
        oy = (tcy - pcy) / ph
        ow = torch.log(torch.abs(tw / pw))
        oh = torch.log(torch.abs(th / ph))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if pv is not None:
            out = out / pv[None, :, :]
        return {"OutputBox": out}
    # decode_center_size
    if tb.dim() == 2:
        tb = tb[:, None, :]
    t = tb * pv[None, :, :] if pv is not None else tb
    ocx = t[..., 0] * pw + pcx
    ocy = t[..., 1] * ph + pcy
    ow = torch.exp(t[..., 2]) * pw
    oh = torch.exp(t[..., 3]) * ph
    out = torch.stack([ocx - ow / 2, ocy - oh / 2,
                       ocx + ow / 2 - one, ocy + oh / 2 - one], dim=-1)
    return {"OutputBox": out}


def _grid_boxes(cx, cy, wh, img_w, img_h):
    """[fh, fw, P, 4] corners (normalized by the image) of boxes of sizes
    wh [P, 2] at the centers cx [fw] x cy [fh]."""
    cxg = cx[None, :, None]
    cyg = cy[:, None, None]
    w2, h2 = wh[None, None, :, 0] / 2, wh[None, None, :, 1] / 2
    return torch.stack(torch.broadcast_tensors(
        (cxg - w2) / img_w, (cyg - h2) / img_h,
        (cxg + w2) / img_w, (cyg + h2) / img_h), dim=-1)


@register_op("prior_box", grad=None)
def prior_box(ins, attrs, ctx):
    """reference: detection/prior_box_op.cc (SSD anchors)."""
    inp, image = ins["Input"][0], ins["Image"][0]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    flip = attrs.get("flip", False)
    clip = attrs.get("clip", False)
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = attrs.get("offset", 0.5)
    ih, iw = image.shape[2], image.shape[3]
    fh, fw = inp.shape[2], inp.shape[3]
    sw = attrs.get("step_w", 0.0) or iw / fw
    sh = attrs.get("step_h", 0.0) or ih / fh

    full_ars = []
    for a in ars:
        full_ars.append(a)
        if flip and a != 1.0:
            full_ars.append(1.0 / a)
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        for a in full_ars:
            boxes.append((ms * np.sqrt(a), ms / np.sqrt(a)))
            if a == 1.0 and ms_i < len(max_sizes):
                s = np.sqrt(ms * max_sizes[ms_i])
                boxes.append((s, s))
    like = torch.empty((), dtype=torch.float32, device=inp.device)
    cx = (torch.arange(fw, dtype=torch.float32, device=inp.device)
          + offset) * sw
    cy = (torch.arange(fh, dtype=torch.float32, device=inp.device)
          + offset) * sh
    out = _grid_boxes(cx, cy, _f32(boxes, like), iw, ih)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.broadcast_to(_f32(variances, like), out.shape)
    return {"Boxes": out, "Variances": var}


@register_op("yolo_box", grad=None)
def yolo_box(ins, attrs, ctx):
    """reference: detection/yolo_box_op.cc."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    anchors = [int(a) for a in attrs["anchors"]]
    class_num = int(attrs["class_num"])
    conf_thresh = attrs.get("conf_thresh", 0.01)
    downsample = int(attrs.get("downsample_ratio", 32))
    n, c, h, w = x.shape
    an_num = len(anchors) // 2
    x = x.reshape(n, an_num, 5 + class_num, h, w)
    dev = x.device
    grid_x = torch.arange(w, device=dev).reshape(1, 1, 1, w)
    grid_y = torch.arange(h, device=dev).reshape(1, 1, h, 1)
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / h
    aw = torch.tensor(anchors[0::2], device=dev).reshape(1, an_num, 1, 1)
    ah = torch.tensor(anchors[1::2], device=dev).reshape(1, an_num, 1, 1)
    input_size = downsample * h
    bw = torch.exp(x[:, :, 2]) * aw / input_size
    bh = torch.exp(x[:, :, 3]) * ah / input_size
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img_h = img_size[:, 0].reshape(n, 1, 1, 1).to(x.dtype)
    img_w = img_size[:, 1].reshape(n, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([
        (bx - bw / 2) * img_w, (by - bh / 2) * img_h,
        (bx + bw / 2) * img_w, (by + bh / 2) * img_h], dim=-1)
    keep = (conf > conf_thresh)[..., None]
    boxes = _where0(keep, boxes).reshape(n, -1, 4)
    scores = _where0(conf[..., None] > conf_thresh,
                     probs.permute(0, 1, 3, 4, 2)).reshape(n, -1, class_num)
    return {"Boxes": boxes, "Scores": scores}


def _require_single_image(op_name, x, ctx):
    """The roi ops pool image 0 (ROIs carry no batch-index column), so N
    must be 1; under shape inference a -1 batch (the registry's
    _DYN_SENTINEL) is let through."""
    if ctx.in_shape_inference and x.shape[0] == _DYN_SENTINEL:
        return
    assert x.shape[0] == 1, (
        f"{op_name}: ROIs carry no batch index (the repo-wide roi-op "
        f"convention pools image 0), so N must be 1; got N={x.shape[0]}")


# RoIs a chunk of the roi ops' broadcast work (bounds their temporaries)
_ROI_CHUNK = 64


def _by_roi_chunks(fn, rois, *rest):
    """fn(rois[i:j], *rest[i:j]) over chunks of _ROI_CHUNK RoIs,
    concatenated along dim 0 (each output of a tuple)."""
    r = rois.shape[0]
    if r <= _ROI_CHUNK:
        return fn(rois, *rest)
    parts = [fn(rois[i:i + _ROI_CHUNK],
                *[t[i:i + _ROI_CHUNK] for t in rest])
             for i in range(0, r, _ROI_CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, 0) for p in zip(*parts))
    return torch.cat(parts, 0)


def _bilinear_weights(coords, size):
    """[R, S, size] interpolation weights of the sample coordinates
    coords [R, S]: (1 - frac) on floor(c) and frac on floor(c) + 1, both
    clipped into [0, size) (roi_align's corners: a clipped pair lands on
    one cell and sums there)."""
    lo = torch.floor(coords)
    frac = coords - lo
    i0 = torch.clamp(lo.to(torch.int64), 0, size - 1)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    pos = torch.arange(size, device=coords.device)
    return ((pos == i0[..., None]).to(coords.dtype) * (1 - frac)[..., None]
            + (pos == i1[..., None]).to(coords.dtype) * frac[..., None])


@register_op("roi_align")
def roi_align(ins, attrs, ctx):
    """reference: detection/roi_align_op.cc: bilinear-sampled RoI pooling,
    `sampling_ratio` samples a bin side (2 when not positive), averaged.
    The JAX op gathers the four corners of every sample; here the
    sampling and the average are two separable weight matrices [R, ph,
    H] and [R, pw, W] contracted with the map (the same sum)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    _require_single_image("roi_align", x, ctx)
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    n, c, h, w = x.shape
    xc = x[0]

    def chunk(rs):
        r = rs.shape[0]
        b = rs * scale
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        rh = torch.clamp(y2 - y1, min=1.0)
        rw = torch.clamp(x2 - x1, min=1.0)
        bin_h, bin_w = rh / ph, rw / pw
        sy = torch.arange(ph * ratio, dtype=x.dtype, device=x.device) + 0.5
        sx = torch.arange(pw * ratio, dtype=x.dtype, device=x.device) + 0.5
        ys = y1[:, None] + sy[None] * bin_h[:, None] / ratio
        xs = x1[:, None] + sx[None] * bin_w[:, None] / ratio
        ay = _bilinear_weights(ys, h).reshape(r, ph, ratio, h).mean(2)
        ax = _bilinear_weights(xs, w).reshape(r, pw, ratio, w).mean(2)
        t = torch.einsum("rih,chw->rciw", ay, xc)
        return torch.einsum("rciw,rjw->rcij", t, ax)

    return {"Out": _by_roi_chunks(chunk, rois)}


def _tent_integral(lo, hi, centers):
    """The integral of max(0, 1 - |y - c|) over [lo, hi] for each pixel
    center c (PrRoI pooling's closed form)."""
    def g(u):
        return torch.where(
            u <= -1.0, torch.zeros_like(u),
            torch.where(u < 0.0, (u + 1.0) ** 2 / 2.0,
                        torch.where(u < 1.0, 1.0 - (1.0 - u) ** 2 / 2.0,
                                    torch.ones_like(u))))
    return g(hi[..., None] - centers) - g(lo[..., None] - centers)


@register_op("prroi_pool", nondiff_inputs=("ROIs",))
def prroi_pool(ins, attrs, ctx):
    """reference: prroi_pool_op.cc: precise (integral) position-sensitive
    RoI pooling, out[r, c, i, j] = the integral of channel (c*ph+i)*pw+j
    over the bin of the bilinearly interpolated map, over the bin's
    area, as two separable tent-integral weight matrices."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    oc = int(attrs.get("output_channels", x.shape[1] // (ph * pw)))
    n, c, h, w = x.shape
    _require_single_image("prroi_pool", x, ctx)
    assert c == oc * ph * pw, (
        f"prroi_pool input channels {c} != output_channels*ph*pw "
        f"{oc * ph * pw}")
    xr = x[0].reshape(oc, ph, pw, h, w)
    hs = torch.arange(h, dtype=x.dtype, device=x.device)
    ws = torch.arange(w, dtype=x.dtype, device=x.device)

    def chunk(rs):
        b = rs * scale
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        rh = torch.clamp(y2 - y1, min=0.0)
        rw = torch.clamp(x2 - x1, min=0.0)
        bin_h, bin_w = rh / ph, rw / pw
        ylo = y1[:, None] + torch.arange(ph, dtype=x.dtype,
                                         device=x.device) * bin_h[:, None]
        xlo = x1[:, None] + torch.arange(pw, dtype=x.dtype,
                                         device=x.device) * bin_w[:, None]
        wh = _tent_integral(ylo, ylo + bin_h[:, None], hs)   # [R, ph, H]
        ww = _tent_integral(xlo, xlo + bin_w[:, None], ws)   # [R, pw, W]
        win = (bin_h * bin_w)[:, None, None, None]
        out = torch.einsum("cijhw,rih,rjw->rcij", xr, wh, ww)
        return torch.where(win > 0.0, out / torch.clamp(win, min=1e-12),
                           torch.zeros_like(out))

    return {"Out": _by_roi_chunks(chunk, rois)}


def _bilinear_gather(maps, ys, xs):
    """Bilinear samples of maps [M, H, W] at float coords ys, xs [R, M,
    ...] (map m sampled at [:, m]); out-of-range corners contribute 0
    (the JAX package's `_bilinear_sample_chw`). Returns [R, M, ...]."""
    m, h, w = maps.shape
    flat = maps.reshape(m, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    mi = torch.arange(m, device=maps.device).reshape(
        (1, m) + (1,) * (ys.dim() - 2))

    def gather(yy, xx):
        inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w - 1).to(torch.int64)
        return flat[mi, yc * w + xc] * inb.to(maps.dtype)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


@register_op("deformable_psroi_pooling", nondiff_inputs=("ROIs",))
def deformable_psroi_pooling(ins, attrs, ctx):
    """reference: deformable_psroi_pooling_op.h: position-sensitive RoI
    pooling whose bin starts shift by learned per-part offsets (Trans),
    averaged over a sample_per_part^2 grid of bilinear taps; samples
    outside [-0.5, size - 0.5] are left out of the mean."""
    x, rois = ins["Input"][0], ins["ROIs"][0]
    trans = _opt(ins, "Trans")
    no_trans = bool(attrs.get("no_trans", trans is None)) or trans is None
    scale = float(attrs.get("spatial_scale", 1.0))
    out_dim = int(attrs["output_dim"])
    gh_, gw_ = [int(v) for v in attrs.get("group_size", [1, 1])]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    part = attrs.get("part_size", [ph, pw]) or [ph, pw]
    part_h, part_w = int(part[0]), int(part[1])
    spp = int(attrs.get("sample_per_part", 4))
    tstd = float(attrs.get("trans_std", 0.1))
    n, c, H, W = x.shape
    _require_single_image("deformable_psroi_pooling", x, ctx)
    n_classes = 1 if no_trans else trans.shape[1] // 2
    ceach = out_dim // n_classes
    fdt, dev = x.dtype, x.device
    iy = torch.arange(ph, device=dev)
    jx = torch.arange(pw, device=dev)
    part_hi = torch.floor(_div(iy.to(fdt), ph) * part_h).to(torch.int64)
    part_wi = torch.floor(_div(jx.to(fdt), pw) * part_w).to(torch.int64)
    ghi = torch.clamp(torch.floor(_div(iy.to(fdt) * gh_, ph)).to(
        torch.int64), 0, gh_ - 1)
    gwi = torch.clamp(torch.floor(_div(jx.to(fdt) * gw_, pw)).to(
        torch.int64), 0, gw_ - 1)
    ctop = torch.arange(out_dim, device=dev)
    class_id = ctop // ceach
    cidx = ((ctop[:, None, None] * gh_ + ghi[None, :, None]) * gw_
            + gwi[None, None, :])                        # [od, ph, pw]
    maps = x[0][cidx.reshape(-1)]                        # [M, H, W]
    steps = torch.arange(spp, dtype=fdt, device=dev)

    def chunk(rs, *tr):
        r = rs.shape[0]
        rsw = torch.round(rs[:, 0]) * scale - 0.5
        rsh = torch.round(rs[:, 1]) * scale - 0.5
        rew = (torch.round(rs[:, 2]) + 1.0) * scale - 0.5
        reh = (torch.round(rs[:, 3]) + 1.0) * scale - 0.5
        rw = torch.clamp(rew - rsw, min=0.1)
        rh = torch.clamp(reh - rsh, min=0.1)
        bh, bw = _div(rh, ph), _div(rw, pw)
        col = (slice(None), None, None, None)
        if no_trans:
            tx = ty = torch.zeros((r, out_dim, ph, pw), dtype=fdt, device=dev)
        else:
            t = tr[0]
            tx = t[:, class_id * 2][:, :, part_hi][:, :, :, part_wi] * tstd
            ty = t[:, class_id * 2 + 1][:, :, part_hi][:, :, :, part_wi] \
                * tstd
        hstart = iy.to(fdt)[None, None, :, None] * bh[col] + rsh[col] \
            + ty * rh[col]
        wstart = jx.to(fdt)[None, None, None, :] * bw[col] + rsw[col] \
            + tx * rw[col]
        sh = hstart[..., None, None] + \
            steps[:, None] * (bh / spp).reshape(r, 1, 1, 1, 1, 1)
        sw = wstart[..., None, None] + \
            steps[None, :] * (bw / spp).reshape(r, 1, 1, 1, 1, 1)
        shape = sh.shape[:4] + (spp, spp)
        sh, sw = torch.broadcast_to(sh, shape), torch.broadcast_to(sw, shape)
        valid = (sw >= -0.5) & (sw <= W - 0.5) & (sh >= -0.5) & \
            (sh <= H - 0.5)
        shc = torch.clamp(sh, 0.0, H - 1.0)
        swc = torch.clamp(sw, 0.0, W - 1.0)
        vals = _bilinear_gather(maps, shc.reshape(r, -1, spp, spp),
                                swc.reshape(r, -1, spp, spp))
        vals = vals.reshape(shape)
        cnt = valid.sum((-1, -2))
        s = (vals * valid.to(fdt)).sum((-1, -2))
        out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1).to(fdt),
                          torch.zeros_like(s))
        return out, cnt.to(fdt)

    if no_trans:
        out, count = _by_roi_chunks(chunk, rois)
    else:
        out, count = _by_roi_chunks(chunk, rois, trans)
    return {"Output": out, "TopCount": count}


@register_op("box_clip", grad=None)
def box_clip(ins, attrs, ctx):
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    h = im_info[0, 0] - 1
    w = im_info[0, 1] - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return {"Output": torch.stack(
        [torch.clamp(boxes[..., i], zero, w if i % 2 == 0 else h)
         for i in range(4)], dim=-1)}


# ---------------------------------------------------------------------------
# Shared geometry helpers
# ---------------------------------------------------------------------------


def _box_area(b, normalized=True):
    one = 0.0 if normalized else 1.0
    return (b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one)


def _pairwise_iou(a, b, normalized=True):
    """IoU matrix [.., M, N] of boxes a [.., M, 4] and b [.., N, 4]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    one = 0.0 if normalized else 1.0
    wh = torch.clamp(rb - lt + one, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (_box_area(a, normalized)[..., :, None] +
             _box_area(b, normalized)[..., None, :] - inter)
    return inter / torch.clamp(union, min=1e-10)


def _nms_rows(boxes, scores, iou_threshold, max_out, normalized=True,
              score_threshold=None):
    """The JAX package's `_nms_static` on every row at once: boxes [R, M,
    4], scores [R, M] -> (indices [R, max_out] int32, -1 padding; the
    selected scores [R, max_out], -inf padding). One loop of `max_out`
    steps, each an argmax over every row and a suppress of the boxes
    whose IoU with the pick exceeds the threshold; no host sync. Under
    shape inference (meta tensors) only the shapes are made."""
    r, m = scores.shape
    if scores.device.type == "meta":
        return (torch.empty((r, max_out), dtype=torch.int32, device="meta"),
                torch.empty((r, max_out), dtype=scores.dtype, device="meta"))
    if score_threshold is not None:
        scores = torch.where(scores > score_threshold, scores, _NEG_INF)
    one = 0.0 if normalized else 1.0
    area = _box_area(boxes, normalized)                   # [R, M]
    lo, hi = boxes[..., :2], boxes[..., 2:]
    col = torch.arange(m, device=scores.device)
    picks, vals = [], []
    for _ in range(max_out):
        i = torch.argmax(scores, dim=1, keepdim=True)     # [R, 1]
        s = torch.gather(scores, 1, i)
        b = torch.gather(boxes, 1, i[..., None].expand(r, 1, 4))
        wh = torch.clamp(torch.minimum(b[..., 2:], hi)
                         - torch.maximum(b[..., :2], lo) + one, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / torch.clamp(torch.gather(area, 1, i) + area - inter,
                                  min=1e-10)
        scores = torch.where((iou > iou_threshold) | (col == i), _NEG_INF,
                             scores)
        picks.append(torch.where(s > _NEG_INF, i, -1))
        vals.append(s)
    if not picks:
        return (torch.empty((r, 0), dtype=torch.int32, device=scores.device),
                torch.empty((r, 0), dtype=scores.dtype, device=scores.device))
    return torch.cat(picks, 1).to(torch.int32), torch.cat(vals, 1)


def _take_rows(x, idx):
    """x [R, M, ...] at idx [R, K] (clipped at 0) -> [R, K, ...]."""
    idx = torch.clamp(idx, min=0).to(torch.int64)
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(shape))


# ---------------------------------------------------------------------------
# Losses / assignment / anchors
# ---------------------------------------------------------------------------


@register_op("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def sigmoid_focal_loss(ins, attrs, ctx):
    """reference: detection/sigmoid_focal_loss_op.cc: per-element focal
    loss; Label holds the 1-based foreground class (0 = background),
    class j of X is label j + 1; normalized by FgNum."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1)
    fg = ins["FgNum"][0].reshape(()).to(x.dtype)
    gamma = float(attrs.get("gamma", 2.0))
    alpha = float(attrs.get("alpha", 0.25))
    n, c = x.shape
    t = (label[:, None] == torch.arange(1, c + 1, device=x.device)[None, :]
         ).to(x.dtype)
    p = torch.sigmoid(x)
    logp = F.logsigmoid(x)
    log1mp = F.logsigmoid(-x)
    loss = -(t * alpha * (1 - p) ** gamma * logp +
             (1 - t) * (1 - alpha) * p ** gamma * log1mp)
    return {"Out": loss / torch.clamp(fg, min=1.0)}


@register_op("anchor_generator", grad=None)
def anchor_generator(ins, attrs, ctx):
    """reference: detection/anchor_generator_op.h:55-85 (base_w and
    base_h rounded as there)."""
    x = ins["Input"][0]
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(r) for r in attrs["aspect_ratios"]]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    stride = [float(s) for s in attrs["stride"]]
    offset = float(attrs.get("offset", 0.5))
    h, w = x.shape[2], x.shape[3]
    sw, sh = stride[0], stride[1]
    anchors = []
    for ar in ratios:
        for size in sizes:
            base_w = np.round(np.sqrt(sw * sh / ar))
            base_h = np.round(base_w * ar)
            anchors.append(((size / sw) * base_w, (size / sh) * base_h))
    like = torch.empty((), dtype=torch.float32, device=x.device)
    aw = _f32([a[0] for a in anchors], like)
    ah = _f32([a[1] for a in anchors], like)
    x_ctr = torch.arange(w, dtype=torch.float32, device=x.device) * sw \
        + offset * (sw - 1)
    y_ctr = torch.arange(h, dtype=torch.float32, device=x.device) * sh \
        + offset * (sh - 1)
    xc = x_ctr[None, :, None]
    yc = y_ctr[:, None, None]
    out = torch.stack(torch.broadcast_tensors(
        xc - 0.5 * (aw - 1), yc - 0.5 * (ah - 1),
        xc + 0.5 * (aw - 1), yc + 0.5 * (ah - 1)), dim=-1)   # [H, W, A, 4]
    var = torch.broadcast_to(_f32(variances, like), out.shape)
    return {"Anchors": out, "Variances": var}


@register_op("density_prior_box", grad=None)
def density_prior_box(ins, attrs, ctx):
    """reference: detection/density_prior_box_op.cc: a dense anchor grid
    a (fixed_size, density), with uniform sub-cell shifts."""
    x = ins["Input"][0]
    image = ins["Image"][0]
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [1])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = float(attrs.get("offset", 0.5))
    clip = bool(attrs.get("clip", False))
    h, w = x.shape[2], x.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = attrs.get("step_w", 0.0) or img_w / w
    step_h = attrs.get("step_h", 0.0) or img_h / h
    boxes = []
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw = size * np.sqrt(ratio)
            bh = size / np.sqrt(ratio)
            shift = size / density
            for di in range(density):
                for dj in range(density):
                    boxes.append((-size / 2.0 + shift / 2.0 + dj * shift,
                                  -size / 2.0 + shift / 2.0 + di * shift,
                                  bw, bh))
    like = torch.empty((), dtype=torch.float32, device=x.device)
    cx = (torch.arange(w, dtype=torch.float32, device=x.device)
          + offset) * step_w
    cy = (torch.arange(h, dtype=torch.float32, device=x.device)
          + offset) * step_h
    offs = _f32(boxes, like).reshape(-1, 4)
    ax = cx[None, :, None] + offs[:, 0]
    ay = cy[:, None, None] + offs[:, 1]
    bw, bh = offs[:, 2], offs[:, 3]
    out = torch.stack(torch.broadcast_tensors(
        (ax - bw / 2.0) / img_w, (ay - bh / 2.0) / img_h,
        (ax + bw / 2.0) / img_w, (ay + bh / 2.0) / img_h), dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.broadcast_to(_f32(variances, like), out.shape)
    return {"Boxes": out, "Variances": var}


@register_op("bipartite_match", grad=None)
def bipartite_match(ins, attrs, ctx):
    """reference: detection/bipartite_match_op.cc: greedy global-max
    matching (columns to rows), then with match_type "per_prediction"
    each unmatched column's best row above dist_threshold. DistMat [N,
    R, C] batched, every image's step in one."""
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    b, r, c = dist.shape
    match_type = attrs.get("match_type", "bipartite")
    thresh = float(attrs.get("dist_threshold", 0.5))
    dev = dist.device
    rows = torch.arange(r, device=dev)[None, :, None]
    cols = torch.arange(c, device=dev)
    dm = dist
    midx = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((b, c), dtype=dist.dtype, device=dev)
    for _ in range(min(r, c)):
        flat = dm.reshape(b, -1)
        k = torch.argmax(flat, dim=1)
        i, j = k // c, k % c
        val = torch.gather(flat, 1, k[:, None])[:, 0]
        ok = val > 0
        at = ok[:, None] & (cols[None, :] == j[:, None])
        midx = torch.where(at, i[:, None].to(torch.int32), midx)
        mdist = torch.where(at, val[:, None], mdist)
        kill = ok[:, None, None] & ((rows == i[:, None, None]) |
                                    (cols[None, None, :] == j[:, None, None]))
        dm = torch.where(kill, torch.full_like(dm, -1.0), dm)
    if match_type == "per_prediction":
        best, best_row = torch.max(dist, dim=1)
        fill = (midx < 0) & (best > thresh)
        midx = torch.where(fill, best_row.to(torch.int32), midx)
        mdist = torch.where(fill, best, mdist)
    return {"ColToRowMatchIndices": midx, "ColToRowMatchDist": mdist}


@register_op("target_assign", grad=None)
def target_assign(ins, attrs, ctx):
    """reference: detection/target_assign_op.cc: out[i, j] = X[i,
    match[i, j]] where matched, else mismatch_value; weight 1 on matched
    (and negative-flagged) columns. X [N, M, K]; NegFlag [N, P] stands
    for the reference's LoD NegIndices."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0]
    mismatch = attrs.get("mismatch_value", 0)
    if x.dim() == 2:
        x = x[None]
    out = _take_rows(x, match)
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, out,
                      torch.tensor(mismatch, dtype=x.dtype, device=x.device))
    wt = matched.to(x.dtype)
    neg = _opt(ins, "NegFlag")
    if neg is not None:
        wt = torch.maximum(wt, neg[:, :, None].to(x.dtype))
    return {"Out": out, "OutWeight": wt}


def _rank_desc(score, dim=-1):
    """Each entry's place when `score` is sorted descending, ties in
    index order (the JAX ops' argsort of an argsort, both stable)."""
    order = torch.argsort(-score, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


@register_op("mine_hard_examples", grad=None)
def mine_hard_examples(ins, attrs, ctx):
    """reference: detection/mine_hard_examples_op.cc: online hard
    negative mining: among the unmatched priors, flag the neg_pos_ratio
    * num_pos with the highest loss. NegFlag [N, P] stands for the LoD
    NegIndices; UpdatedMatchIndices is MatchIndices."""
    cls_loss = ins["ClsLoss"][0]
    match = ins["MatchIndices"][0]
    loss = cls_loss.reshape(match.shape)
    loc = _opt(ins, "LocLoss")
    if loc is not None and \
            attrs.get("mining_type", "max_negative") == "hard_example":
        loss = loss + loc.reshape(match.shape)
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    is_neg_cand = match < 0
    num_pos = torch.sum(match >= 0, dim=1)
    num_neg = torch.minimum((num_pos * neg_pos_ratio).to(torch.int32),
                            torch.sum(is_neg_cand, dim=1).to(torch.int32))
    cand_loss = torch.where(is_neg_cand, loss, _NEG_INF)
    neg_flag = (_rank_desc(cand_loss, 1) < num_neg[:, None]) & is_neg_cand
    return {"NegFlag": neg_flag.to(torch.int32),
            "UpdatedMatchIndices": match}


# ---------------------------------------------------------------------------
# Pooling / geometry transforms
# ---------------------------------------------------------------------------


def _bin_mask(start, end, size, clip_bounds):
    """[R, P, size] membership of positions in [start, end) per bin
    (start, end [R, P] ints), optionally clipped to [0, size]."""
    pos = torch.arange(size, device=start.device)
    if clip_bounds:
        start, end = torch.clamp(start, 0, size), torch.clamp(end, 0, size)
    return (pos >= start[..., None]) & (pos < end[..., None])


@register_op("roi_pool")
def roi_pool(ins, attrs, ctx):
    """reference: roi_pool_op.cc: max pooling over quantized RoI bins (an
    empty bin is 0)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    _require_single_image("roi_pool", x, ctx)
    i32 = torch.int32
    py = torch.arange(ph, device=x.device)
    px = torch.arange(pw, device=x.device)
    xc = x[0]

    def chunk(rs):
        x1 = torch.round(rs[:, 0] * scale).to(i32)[:, None]
        y1 = torch.round(rs[:, 1] * scale).to(i32)[:, None]
        x2 = torch.round(rs[:, 2] * scale).to(i32)[:, None]
        y2 = torch.round(rs[:, 3] * scale).to(i32)[:, None]
        rh = torch.clamp(y2 - y1 + 1, min=1)
        rw = torch.clamp(x2 - x1 + 1, min=1)
        hs = y1 + torch.floor(_div(py * rh, ph)).to(i32)
        he = y1 + torch.ceil(_div((py + 1) * rh, ph)).to(i32)
        ws = x1 + torch.floor(_div(px * rw, pw)).to(i32)
        we = x1 + torch.ceil(_div((px + 1) * rw, pw)).to(i32)
        ym = _bin_mask(hs, he, h, False)                  # [R, ph, H]
        xm = _bin_mask(ws, we, w, False)                  # [R, pw, W]
        # the max over each bin's columns, then over its rows
        colmax = torch.where(xm[:, None, None, :, :], xc[None, :, :, None, :],
                             _NEG_INF).amax(-1)          # [R, C, H, pw]
        out = torch.where(ym[:, None, :, :, None], colmax[:, :, None],
                          _NEG_INF).amax(3)              # [R, C, ph, pw]
        empty = ~(ym.any(-1)[:, :, None] & xm.any(-1)[:, None, :])
        return torch.where(empty[:, None], torch.zeros_like(out), out)

    return {"Out": _by_roi_chunks(chunk, rois)}


@register_op("psroi_pool")
def psroi_pool(ins, attrs, ctx):
    """reference: detection/psroi_pool_op.cc: position-sensitive average
    RoI pooling: output channel d at bin (i, j) averages input channel
    d*ph*pw + i*pw + j over that bin."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    out_c = int(attrs["output_channels"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    _require_single_image("psroi_pool", x, ctx)
    i32 = torch.int32
    py = torch.arange(ph, device=x.device)
    px = torch.arange(pw, device=x.device)
    grid = x[0].reshape(out_c, ph, pw, h, w)

    def chunk(rs):
        x1 = (torch.round(rs[:, 0]) * scale)[:, None]
        y1 = (torch.round(rs[:, 1]) * scale)[:, None]
        x2 = (torch.round(rs[:, 2] + 1.0) * scale)[:, None]
        y2 = (torch.round(rs[:, 3] + 1.0) * scale)[:, None]
        rh = torch.clamp(y2 - y1, min=0.1)
        rw = torch.clamp(x2 - x1, min=0.1)
        bh, bw = _div(rh, ph), _div(rw, pw)
        hs = torch.floor(y1 + py * bh).to(i32)
        he = torch.ceil(y1 + (py + 1) * bh).to(i32)
        ws = torch.floor(x1 + px * bw).to(i32)
        we = torch.ceil(x1 + (px + 1) * bw).to(i32)
        ym = _bin_mask(hs, he, h, True).to(x.dtype)       # [R, ph, H]
        xm = _bin_mask(ws, we, w, True).to(x.dtype)       # [R, pw, W]
        s = torch.einsum("dijhw,rih,rjw->rdij", grid, ym, xm)
        cnt = ym.sum(-1)[:, :, None] * xm.sum(-1)[:, None, :]
        return s / torch.clamp(cnt, min=1.0)[:, None]

    return {"Out": _by_roi_chunks(chunk, rois)}


@register_op("polygon_box_transform", grad=None)
def polygon_box_transform(ins, attrs, ctx):
    """reference: detection/polygon_box_transform_op.cc (OCR EAST): even
    planes are x offsets (4 w - in), odd ones y (4 h - in)."""
    x = ins["Input"][0]
    n, c, h, w = x.shape
    wg = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
    hg = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    even = torch.arange(c, device=x.device) % 2 == 0
    base = torch.where(even[:, None, None], 4 * wg[None], 4 * hg[None])
    return {"Output": base[None] - x}


@register_op("box_decoder_and_assign", grad=None)
def box_decoder_and_assign(ins, attrs, ctx):
    """reference: detection/box_decoder_and_assign_op.cc: decode the
    per-class deltas against the prior boxes, then take each RoI's
    best-scoring class box."""
    prior = ins["PriorBox"][0]
    pv = ins["PriorBoxVar"][0]
    deltas = ins["TargetBox"][0]
    scores = ins["BoxScore"][0]
    box_clip = float(attrs.get("box_clip", 4.135))
    r, c4 = deltas.shape
    ncls = c4 // 4
    d = deltas.reshape(r, ncls, 4) * pv[:, None, :]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    ocx = d[..., 0] * pw[:, None] + pcx[:, None]
    ocy = d[..., 1] * ph[:, None] + pcy[:, None]
    ow = torch.exp(torch.clamp(d[..., 2], max=box_clip)) * pw[:, None]
    oh = torch.exp(torch.clamp(d[..., 3], max=box_clip)) * ph[:, None]
    decoded = torch.stack([ocx - ow / 2, ocy - oh / 2,
                           ocx + ow / 2 - 1.0, ocy + oh / 2 - 1.0], dim=-1)
    best = torch.argmax(scores, dim=1)
    assigned = _take_rows(decoded, best[:, None])[:, 0]
    return {"DecodeBox": decoded.reshape(r, c4),
            "OutputAssignBox": assigned}


# ---------------------------------------------------------------------------
# NMS family / proposals
# ---------------------------------------------------------------------------


def _top_rows(boxes, scores, k):
    """Each row's k best scores (stable_top_k) and their boxes: boxes [R,
    M, 4], scores [R, M] -> (scores [R, k], indices [R, k], boxes [R, k,
    4])."""
    top_s, top_i = stable_top_k(scores, k)
    return top_s, top_i, _take_rows(boxes, top_i)


def _keep_best(sel_s, sel_i, labels, keep):
    """The JAX ops' final merge: the `keep` best of each image's [B, K']
    flat (class-major) candidates -> (scores, indices, labels, valid)."""
    top_s, order = stable_top_k(sel_s, keep)
    idx = torch.gather(sel_i, 1, order)
    lab = torch.gather(labels, 1, order)
    valid = (top_s > _NEG_INF) & (idx >= 0)
    return top_s, idx, lab, valid


def _detections(boxes, top_s, idx, lab, valid):
    """[B, K, 6] rows [label, score, x1, y1, x2, y2], padding label -1
    and zeros."""
    sel_boxes = _take_rows(boxes, idx)
    return torch.cat([
        torch.where(valid, lab, -1).to(boxes.dtype)[..., None],
        _where0(valid, top_s)[..., None],
        _where0(valid[..., None], sel_boxes)], dim=-1)


@register_op("multiclass_nms", grad=None)
def multiclass_nms(ins, attrs, ctx):
    """reference: detection/multiclass_nms_op.cc. Static shapes: Out is
    [N, keep_top_k, 6] ([label, score, x1, y1, x2, y2], padding label
    -1), NmsRoisNum [N], and Index [N, keep_top_k, 1], the selected box's
    row in the batch-flattened [N*M, 4] boxes (-1 padding). Every image
    and class is one row of one NMS loop."""
    bboxes = ins["BBoxes"][0]             # [N, M, 4]
    scores = ins["Scores"][0]             # [N, C, M]
    bg = int(attrs.get("background_label", 0))
    score_thr = float(attrs.get("score_threshold", 0.0))
    nms_top_k = int(attrs.get("nms_top_k", -1))
    nms_thr = float(attrs.get("nms_threshold", 0.3))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    normalized = bool(attrs.get("normalized", True))
    n, c, m = scores.shape
    per_class = min(m, nms_top_k) if nms_top_k > 0 else m
    n_fg_cls = c - (1 if 0 <= bg < c else 0)
    pool = n_fg_cls * per_class
    keep_top_k = pool if keep_top_k <= 0 else min(keep_top_k, pool)
    dev = scores.device
    cls_ids = torch.tensor([cc for cc in range(c) if cc != bg],
                           dtype=torch.int64, device=dev)
    sc = scores[:, cls_ids].reshape(n * n_fg_cls, m)
    bx = bboxes[:, None].expand(n, n_fg_cls, m, 4).reshape(
        n * n_fg_cls, m, 4)
    if 0 < nms_top_k < m:
        top_s, top_i, cb = _top_rows(bx, sc, nms_top_k)
        idx, ss = _nms_rows(cb, top_s, nms_thr, per_class, normalized,
                            score_thr)
        idx = torch.where(idx >= 0, torch.gather(
            top_i, 1, torch.clamp(idx, min=0).to(torch.int64)), -1)
    else:
        idx, ss = _nms_rows(bx, sc, nms_thr, per_class, normalized,
                            score_thr)
    labels = cls_ids[None, :, None].expand(n, n_fg_cls, per_class)
    top_s, sel, lab, valid = _keep_best(
        ss.reshape(n, -1), idx.reshape(n, -1).to(torch.int64),
        labels.reshape(n, -1), keep_top_k)
    out = _detections(bboxes, top_s, sel, lab, valid)
    sel = torch.where(valid, sel, -1)
    gidx = torch.where(sel >= 0,
                       sel + torch.arange(n, device=dev)[:, None] * m, -1)
    return {"Out": out, "NmsRoisNum": valid.to(torch.int32).sum(1),
            "Index": gidx[..., None].to(torch.int32)}


def _decode_deltas(anc, dd):
    """RPN-style decode of deltas dd [..., 4] against anchors anc [..., 4]
    (the +1 pixel convention, dw and dh clipped at 10)."""
    pw = anc[..., 2] - anc[..., 0] + 1.0
    ph = anc[..., 3] - anc[..., 1] + 1.0
    pcx = anc[..., 0] + pw * 0.5
    pcy = anc[..., 1] + ph * 0.5
    ocx = dd[..., 0] * pw + pcx
    ocy = dd[..., 1] * ph + pcy
    ow = torch.exp(torch.clamp(dd[..., 2], max=10.0)) * pw
    oh = torch.exp(torch.clamp(dd[..., 3], max=10.0)) * ph
    return torch.stack([ocx - ow / 2, ocy - oh / 2,
                        ocx + ow / 2 - 1.0, ocy + oh / 2 - 1.0], dim=-1)


def _clip_to_image(boxes, ih, iw):
    """boxes [B, K, 4] clipped to each image's [0, iw - 1] x [0, ih - 1]
    (ih, iw [B])."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    iw1, ih1 = (iw - 1)[:, None], (ih - 1)[:, None]
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), iw1),
        torch.minimum(torch.maximum(boxes[..., 1], zero), ih1),
        torch.minimum(torch.maximum(boxes[..., 2], zero), iw1),
        torch.minimum(torch.maximum(boxes[..., 3], zero), ih1)], dim=-1)


@register_op("generate_proposals", grad=None)
def generate_proposals(ins, attrs, ctx):
    """reference: detection/generate_proposals_op.cc: the RPN's
    proposals: the pre_nms_topN best anchors' deltas decoded, clipped to
    the image, small boxes dropped, NMS. Static shapes: RpnRois [N,
    post_nms_topN, 4], RpnRoiProbs [N, post_nms_topN, 1], RpnRoisNum [N]
    (rows past the count zeroed)."""
    scores = ins["Scores"][0]             # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]         # [N, 4A, H, W]
    im_info = ins["ImInfo"][0]            # [N, 3] (h, w, scale)
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thr = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))
    n, a, h, w = scores.shape
    pre_n = min(pre_n, a * h * w)
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    top_s, top_i = stable_top_k(sc, pre_n)
    anc = anchors[top_i]
    dd = _take_rows(dl, top_i) * variances[top_i]
    boxes = _clip_to_image(_decode_deltas(anc, dd), im_info[:, 0],
                           im_info[:, 1])
    ms = (min_size * im_info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= ms) & \
           ((boxes[..., 3] - boxes[..., 1] + 1.0) >= ms)
    s_kept = torch.where(keep, top_s, _NEG_INF)
    idx, ss = _nms_rows(boxes, s_kept, nms_thr, post_n, normalized=False)
    valid = idx >= 0
    rois = _where0(valid[..., None], _take_rows(boxes, idx))
    probs = _where0(valid, ss)[..., None]
    return {"RpnRois": rois, "RpnRoiProbs": probs,
            "RpnRoisNum": valid.to(torch.int32).sum(1)}


@register_op("collect_fpn_proposals", grad=None)
def collect_fpn_proposals(ins, attrs, ctx):
    """reference: detection/collect_fpn_proposals_op.cc: the per-level
    RoIs concatenated, the global post_nms_topN best by score kept.
    Padded per-level rows are masked by the optional MultiLevelRoisNum
    ([N] valid counts a level), and RoisNum counts the valid collected
    proposals."""
    rois_in = [r for r in ins["MultiLevelRois"] if r is not None]
    scores_in = [s for s in ins["MultiLevelScores"] if s is not None]
    counts_in = [c for c in (ins.get("MultiLevelRoisNum") or [])
                 if c is not None]
    squeeze = rois_in[0].dim() == 2
    if squeeze:
        rois_in = [r[None] for r in rois_in]
        scores_in = [s.reshape(1, -1) for s in scores_in]
    rois = torch.cat([r.reshape(r.shape[0], -1, 4) for r in rois_in], dim=1)
    scores = torch.cat([s.reshape(s.shape[0], -1) for s in scores_in], dim=1)
    if counts_in:
        assert len(counts_in) == len(scores_in), (
            f"MultiLevelRoisNum must supply one count per level: got "
            f"{len(counts_in)} counts for {len(scores_in)} score levels")
        masks = []
        for c, s in zip(counts_in, scores_in):
            r = s.reshape(s.shape[0], -1).shape[1]
            c = c.reshape(-1).to(torch.int64)
            masks.append(torch.arange(r, device=s.device)[None, :] <
                         c[:, None])
        scores = torch.where(torch.cat(masks, dim=1), scores, _NEG_INF)
    post_n = min(int(attrs.get("post_nms_topN", 100)), scores.shape[1])
    top_s, _, sel = _top_rows(rois, scores, post_n)
    ok = top_s > _NEG_INF
    out = _where0(ok[..., None], sel)
    return {"FpnRois": out[0] if squeeze else out,
            "RoisNum": ok.to(torch.int32).sum(1)}


@register_op("distribute_fpn_proposals", grad=None)
def distribute_fpn_proposals(ins, attrs, ctx):
    """reference: detection/distribute_fpn_proposals_op.cc: each RoI goes
    to FPN level floor(log2(sqrt(area) / refer_scale)) + refer_level,
    clipped to [min_level, max_level]. Static shapes: each level's output
    is [R, 4] with a LevelMask; RestoreIndex maps the by-level order
    back."""
    rois = ins["FpnRois"][0].reshape(-1, 4)
    min_l = int(attrs.get("min_level", 2))
    max_l = int(attrs.get("max_level", 5))
    refer_l = int(attrs.get("refer_level", 4))
    refer_s = float(attrs.get("refer_scale", 224.0))
    scale = torch.sqrt(_box_area(rois, normalized=False))
    lvl = torch.floor(torch.log2(_div(scale, refer_s) + 1e-6)) + refer_l
    lvl = torch.clamp(lvl, min_l, max_l).to(torch.int32)
    outs = {"MultiFpnRois": [], "MultiLevelMask": []}
    for level in range(min_l, max_l + 1):
        m = lvl == level
        outs["MultiFpnRois"].append(_where0(m[:, None], rois))
        outs["MultiLevelMask"].append(m.to(torch.int32))
    order = torch.argsort(lvl, stable=True)
    restore = torch.argsort(order, stable=True).to(torch.int32)
    outs["RestoreIndex"] = restore[:, None]
    return outs


def _set_at(mask, idx):
    """mask with True written at idx (indices may repeat: every writer
    writes True, so the result is the same in any order; indices past
    the end are dropped, as XLA's mode="drop")."""
    n = mask.shape[0]
    hit = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    hit = hit.index_fill(0, torch.clamp(idx.to(torch.int64), max=n), True)
    return mask | hit[:n]


def _sample(mask, n_out, gen):
    """The JAX ops' subsampling: n_out indices of `mask`'s True entries,
    -1 padded: uniform noise from `gen` ranks them, or, with no
    generator, the lowest indices first."""
    a = mask.shape[-1]
    if gen is not None:
        noise = torch.rand(mask.shape, generator=gen, dtype=torch.float32,
                           device=gen.device).to(mask.device)
    else:
        noise = -torch.arange(a, dtype=torch.float32, device=mask.device)
        noise = noise.expand(mask.shape)
    score = torch.where(mask, noise, _NEG_INF)
    top_s, top_i = stable_top_k(score, n_out)
    return torch.where(top_s > _NEG_INF, top_i, -1)


def _encode(anc, g, weights=None):
    """Center-size encode of boxes g against anc (+1 pixel convention),
    divided by `weights` when given."""
    pw = anc[..., 2] - anc[..., 0] + 1.0
    ph = anc[..., 3] - anc[..., 1] + 1.0
    pcx = anc[..., 0] + pw * 0.5
    pcy = anc[..., 1] + ph * 0.5
    gw = g[..., 2] - g[..., 0] + 1.0
    gh = g[..., 3] - g[..., 1] + 1.0
    gcx = g[..., 0] + gw * 0.5
    gcy = g[..., 1] + gh * 0.5
    out = torch.stack([(gcx - pcx) / pw, (gcy - pcy) / ph,
                       torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return out if weights is None else out / weights


@register_op("rpn_target_assign", is_random=True, grad=None)
def rpn_target_assign(ins, attrs, ctx):
    """reference: detection/rpn_target_assign_op.cc: anchors labelled fg
    (IoU >= the positive overlap, plus each gt's best anchor) or bg (IoU
    below the negative overlap), a fixed batch subsampled. Static shapes:
    LocationIndex and ScoreIndex are fixed-capacity with -1 padding;
    TargetLabel follows ScoreIndex (1 fg, 0 bg)."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0].reshape(-1, 4)
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_thr = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thr = float(attrs.get("rpn_negative_overlap", 0.3))
    use_random = bool(attrs.get("use_random", True))
    a = anchors.shape[0]
    iou = _pairwise_iou(anchors, gt, normalized=False)    # [A, G]
    best_iou, best_gt = torch.max(iou, dim=1)
    fg_mask = _set_at(best_iou >= pos_thr, torch.argmax(iou, dim=0))
    bg_mask = (best_iou < neg_thr) & ~fg_mask
    n_fg = min(int(batch * fg_frac), a)
    n_bg = min(batch - n_fg, a)
    gen = ctx.rng() if use_random else None
    fg_idx = _sample(fg_mask, n_fg, gen)
    bg_idx = _sample(bg_mask, n_bg, gen)
    score_idx = torch.cat([fg_idx, bg_idx]).to(torch.int32)
    labels = torch.cat([(fg_idx >= 0).to(torch.int32),
                        torch.zeros(n_bg, dtype=torch.int32,
                                    device=anchors.device)])
    at = torch.clamp(fg_idx, min=0)
    tgt = _where0((fg_idx >= 0)[:, None],
                  _encode(anchors[at], gt[best_gt[at]]))
    inside = (fg_idx >= 0)[:, None].to(anchors.dtype) * \
        torch.ones((1, 4), dtype=anchors.dtype, device=anchors.device)
    return {"LocationIndex": fg_idx.to(torch.int32), "ScoreIndex": score_idx,
            "TargetBBox": tgt, "TargetLabel": labels[:, None],
            "BBoxInsideWeight": inside}


@register_op("retinanet_detection_output", grad=None)
def retinanet_detection_output(ins, attrs, ctx):
    """reference: detection/retinanet_detection_output_op.cc: each FPN
    level's deltas decoded against its anchors, the levels merged, then
    class-wise NMS (one loop over every image and class) and the
    keep_top_k best."""
    im_info = ins["ImInfo"][0]
    score_thr = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    nms_thr = float(attrs.get("nms_threshold", 0.3))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    all_boxes, all_scores = [], []
    for delta, sc, anc in zip(ins["BBoxes"], ins["Scores"], ins["Anchors"]):
        if delta is None:
            continue
        all_boxes.append(_decode_deltas(anc.reshape(-1, 4), delta))
        all_scores.append(sc)
    boxes = torch.cat(all_boxes, dim=1)                  # [N, A, 4]
    sc = torch.cat(all_scores, dim=1)                    # [N, A, C]
    n, a, c = sc.shape
    cap = min(nms_top_k, a)
    sel_k = min(cap, keep_top_k)
    keep_k = min(keep_top_k, c * sel_k)
    boxes = _clip_to_image(boxes, im_info[:, 0], im_info[:, 1])
    rows = sc.permute(0, 2, 1).reshape(n * c, a)
    bx = boxes[:, None].expand(n, c, a, 4).reshape(n * c, a, 4)
    top_s, top_i, cb = _top_rows(bx, rows, cap)
    idx, ss = _nms_rows(cb, top_s, nms_thr, sel_k, normalized=False,
                        score_threshold=score_thr)
    idx = torch.where(idx >= 0, torch.gather(
        top_i, 1, torch.clamp(idx, min=0).to(torch.int64)), -1)
    labels = torch.arange(c, device=sc.device)[None, :, None].expand(
        n, c, sel_k)
    top_s, sel, lab, valid = _keep_best(
        ss.reshape(n, -1), idx.reshape(n, -1), labels.reshape(n, -1), keep_k)
    return {"Out": _detections(boxes, top_s, sel, lab, valid),
            "NmsRoisNum": valid.to(torch.int32).sum(1)}


def _bce(p, t):
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _scatter_max(base, flat_idx, vals):
    """base with base.view(-1)[flat_idx] = max(base, vals), repeats
    taking their max (the JAX op's `.at[...].max`)."""
    return base.reshape(-1).scatter_reduce(
        0, flat_idx.reshape(-1), vals.reshape(-1).to(base.dtype),
        reduce="amax").reshape(base.shape)


@register_op("yolov3_loss", nondiff_inputs=("GTBox", "GTLabel", "GTScore"))
def yolov3_loss(ins, attrs, ctx):
    """reference: detection/yolov3_loss_op.cc: the per-cell YOLOv3
    training loss: sigmoid x/y and L1 w/h regression at each gt's
    responsible anchor, objectness BCE with an ignore band, and per-class
    BCE (label smoothing as yolov3_loss_op.h:282-287)."""
    x = ins["X"][0]
    gtbox = ins["GTBox"][0]
    gtlabel = ins["GTLabel"][0]
    anchors = [float(v) for v in attrs["anchors"]]
    mask = [int(v) for v in attrs.get("anchor_mask",
                                      list(range(len(anchors) // 2)))]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    use_label_smooth = bool(attrs.get("use_label_smooth", True))
    n, _, h, w = x.shape
    am = len(mask)
    dev, dt = x.device, x.dtype
    x = x.reshape(n, am, 5 + class_num, h, w)
    input_size = downsample * h
    aw_all = torch.tensor(anchors[0::2], dtype=dt, device=dev)
    ah_all = torch.tensor(anchors[1::2], dtype=dt, device=dev)
    mask_arr = torch.tensor(mask, device=dev)
    aw, ah = aw_all[mask_arr], ah_all[mask_arr]

    tx = torch.sigmoid(x[:, :, 0])         # [N, A, H, W]
    ty = torch.sigmoid(x[:, :, 1])
    tw = x[:, :, 2]
    th = x[:, :, 3]
    tobj = x[:, :, 4]
    tcls = x[:, :, 5:]                     # [N, A, C, H, W]

    gx, gy = gtbox[..., 0], gtbox[..., 1]
    gw, gh = gtbox[..., 2], gtbox[..., 3]
    valid_gt = (gw > 0) & (gh > 0)
    gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1).to(torch.int64)
    gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).to(torch.int64)

    # the responsible anchor: the best wh-IoU among all anchors; a loss
    # only where it is in the mask
    gwp = gw * input_size
    ghp = gh * input_size
    inter = torch.minimum(gwp[..., None], aw_all) * \
        torch.minimum(ghp[..., None], ah_all)
    union = gwp[..., None] * ghp[..., None] + aw_all * ah_all - inter
    best_anchor = torch.argmax(inter / torch.clamp(union, min=1e-10), -1)
    hit = best_anchor[..., None] == mask_arr
    slot = torch.argmax(hit.to(torch.int32), -1)           # [N, B]
    resp = valid_gt & hit.any(-1)
    nb = torch.arange(n, device=dev)[:, None]

    def at(v):                             # [N, A, H, W] -> [N, B]
        return v[nb, slot, gj, gi]

    gs = _opt(ins, "GTScore")
    gscore = gs.reshape(gw.shape).to(dt) if gs is not None \
        else torch.ones_like(gw)
    scale = (2.0 - gw * gh) * gscore
    loss_x = scale * _bce(at(tx), gx * w - gi.to(gx.dtype))
    loss_y = scale * _bce(at(ty), gy * h - gj.to(gy.dtype))
    loss_w = scale * torch.abs(at(tw) - torch.log(torch.clamp(
        gwp / aw[slot], min=1e-9)))
    loss_h = scale * torch.abs(at(th) - torch.log(torch.clamp(
        ghp / ah[slot], min=1e-9)))
    loc = torch.sum(_where0(resp, loss_x + loss_y + loss_w + loss_h), dim=1)

    # objectness: 1 at responsible cells; a prediction whose box has IoU
    # above ignore_thresh with any gt is ignored; 0 elsewhere
    pbx = (tx + torch.arange(w, device=dev)) / w
    pby = (ty + torch.arange(h, device=dev)[:, None]) / h
    pbw = torch.exp(torch.clamp(tw, -10, 10)) * aw[None, :, None, None] / \
        input_size
    pbh = torch.exp(torch.clamp(th, -10, 10)) * ah[None, :, None, None] / \
        input_size
    px1, py1 = pbx - pbw / 2, pby - pbh / 2
    px2, py2 = pbx + pbw / 2, pby + pbh / 2
    gx1, gy1 = gx - gw / 2, gy - gh / 2
    gx2, gy2 = gx + gw / 2, gy + gh / 2
    g5 = (slice(None), None, None, None, slice(None))
    ix1 = torch.maximum(px1[..., None], gx1[g5])
    iy1 = torch.maximum(py1[..., None], gy1[g5])
    ix2 = torch.minimum(px2[..., None], gx2[g5])
    iy2 = torch.minimum(py2[..., None], gy2[g5])
    inter_o = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1,
                                                            min=0.0)
    area_p = pbw * pbh
    area_g = (gw * gh)[g5]
    iou_o = inter_o / torch.clamp(area_p[..., None] + area_g - inter_o,
                                  min=1e-10)
    iou_o = _where0(valid_gt[g5], iou_o)
    ignore = torch.amax(iou_o, dim=-1) > ignore_thresh
    cell = ((nb * am + slot) * h + gj) * w + gi            # [N, B]
    obj_target = _scatter_max(torch.zeros_like(tobj), cell,
                              resp.to(dt))
    # positive cells carry their gt's mixup score as the BCE weight
    pos_score = _scatter_max(torch.zeros_like(tobj), cell,
                             _where0(resp, gscore))
    obj_w = ((obj_target > 0) | ~ignore).to(dt) * \
        torch.where(obj_target > 0, pos_score, torch.ones_like(pos_score))
    obj = torch.sum(_bce(torch.sigmoid(tobj), obj_target) * obj_w,
                    dim=(1, 2, 3))

    delta = min(1.0 / class_num, 1.0 / 40.0) if use_label_smooth else 0.0
    cls_t = (gtlabel[..., None] == torch.arange(class_num, device=dev)
             ).to(dt)
    cls_t = cls_t * (1.0 - 2.0 * delta) + delta
    pcls = torch.sigmoid(tcls[nb, slot, :, gj, gi])         # [N, B, C]
    cls = torch.sum(_where0(resp[..., None],
                            _bce(pcls, cls_t) * gscore[..., None]),
                    dim=(1, 2))
    return {"Loss": loc + obj + cls, "ObjectnessMask": obj_w,
            "GTMatchMask": resp.to(torch.int32)}


@register_op("generate_proposal_labels", is_random=True, grad=None)
def generate_proposal_labels(ins, attrs, ctx):
    """reference: detection/generate_proposal_labels_op.cc: the RoIs of
    the RCNN head sampled: fg at IoU >= fg_thresh (at most fg_fraction of
    the batch), bg in [bg_thresh_lo, bg_thresh_hi), per-class box
    targets. Static shapes: batch_size_per_im rows an image, label -1
    padding. Batched dense inputs ([N, R, 4] rois, [N, G, 4] gt, [N, G]
    classes, a class 0 row absent)."""
    rois = ins["RpnRois"][0]
    gt_boxes = ins["GtBoxes"][0]
    gt_classes = ins["GtClasses"][0]
    crowd = _opt(ins, "IsCrowd")
    is_crowd = crowd.to(torch.bool) if crowd is not None else \
        torch.zeros(gt_classes.shape, dtype=torch.bool,
                    device=gt_classes.device)
    if rois.dim() == 2:
        rois, gt_boxes, gt_classes = rois[None], gt_boxes[None], \
            gt_classes[None]
        is_crowd = is_crowd.reshape(gt_classes.shape)
    batch = int(attrs.get("batch_size_per_im", 256))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thr = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    num_classes = int(attrs.get("class_nums", 81))
    weights = [float(v) for v in attrs.get("bbox_reg_weights",
                                           [0.1, 0.1, 0.2, 0.2])]
    use_random = bool(attrs.get("use_random", True))
    n, r, _ = rois.shape
    batch = min(batch, r)
    n_fg_max = int(batch * fg_frac)
    dt, dev = rois.dtype, rois.device
    gen = ctx.rng() if use_random else None
    # crowd gt regions take no part in the matching
    valid_gt = (gt_classes > 0) & ~is_crowd
    iou = _where0(valid_gt[:, None, :],
                  _pairwise_iou(rois, gt_boxes, normalized=False))
    best, best_gt = torch.max(iou, dim=2)                  # [N, R]
    fg_mask = best >= fg_thr
    bg_mask = (best < bg_hi) & (best >= bg_lo) & ~fg_mask
    fg_idx = _sample(fg_mask, n_fg_max, gen)
    bg_idx = _sample(bg_mask, batch - n_fg_max, gen)
    idx = torch.cat([fg_idx, bg_idx], dim=1)               # [N, batch]
    ok = idx >= 0
    at = torch.clamp(idx, min=0)
    anc = _take_rows(rois, at)
    out_rois = _where0(ok[..., None], anc)
    is_fg = torch.cat([fg_idx >= 0, torch.zeros(
        (n, batch - n_fg_max), dtype=torch.bool, device=dev)], dim=1)
    matched = torch.gather(best_gt, 1, at)
    labels = torch.where(
        ok, torch.where(is_fg, torch.gather(gt_classes, 1, matched)
                        .to(torch.int32), 0), -1).to(torch.int32)
    g = _take_rows(gt_boxes, matched)
    tgt = _where0(is_fg[..., None],
                  _encode(anc, g, torch.tensor(weights, dtype=dt, device=dev)))
    onehot = (torch.arange(num_classes, device=dev) ==
              torch.clamp(labels, min=0)[..., None]).to(dt)   # [N, B, C]
    bbox_targets = (onehot[..., None] * tgt[:, :, None, :]).reshape(
        n, batch, 4 * num_classes)
    inside_w = torch.repeat_interleave(onehot, 4, dim=2) * \
        is_fg[..., None].to(dt)
    return {"Rois": out_rois, "LabelsInt32": labels,
            "BboxTargets": bbox_targets, "BboxInsideWeights": inside_w,
            "BboxOutsideWeights": inside_w}


@register_op("generate_mask_labels", grad=None)
def generate_mask_labels(ins, attrs, ctx):
    """reference: detection/generate_mask_labels_op.cc: each fg RoI's
    matched instance mask cropped and resized to resolution^2. The gt
    masks are dense bitmaps GtSegms [G, H, W] on the device (the
    reference rasterizes polygons on the host), RoIs [R, 4] with
    LabelsInt32 [R] (-1 and 0 rows skipped) and MatchedGts [R]."""
    masks = ins["GtSegms"][0]
    rois = ins["Rois"][0]
    labels = ins["LabelsInt32"][0].reshape(-1)
    matched = ins["MatchedGts"][0].reshape(-1).to(torch.int64)
    res = int(attrs.get("resolution", 14))
    g, h, w = masks.shape
    m = masks[torch.clamp(matched, min=0)].to(torch.float32)   # [R, H, W]
    steps = _div(torch.arange(res, dtype=torch.float32, device=rois.device)
                 + 0.5, res)
    x1, y1, x2, y2 = rois[:, 0:1], rois[:, 1:2], rois[:, 2:3], rois[:, 3:4]
    ys = y1 + steps * torch.clamp(y2 - y1, min=1.0)
    xs = x1 + steps * torch.clamp(x2 - x1, min=1.0)
    yi = torch.clamp(ys.to(torch.int32), 0, h - 1).to(torch.int64)
    xi = torch.clamp(xs.to(torch.int32), 0, w - 1).to(torch.int64)
    ri = torch.arange(rois.shape[0], device=rois.device)[:, None, None]
    crop = m[ri, yi[:, :, None], xi[:, None, :]]
    out = torch.where((labels > 0)[:, None, None],
                      (crop > 0.5).to(torch.int32), -1)
    return {"MaskInt32": out.to(torch.int32)}


@register_op("roi_perspective_transform", grad=None)
def roi_perspective_transform(ins, attrs, ctx):
    """reference: detection/roi_perspective_transform_op.cc: each
    quadrilateral RoI (4 corners clockwise, 8 coordinates) warped to a
    fixed [H_out, W_out] patch by bilinear sampling along the bilinear
    interpolation of its edges."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    oh = int(attrs.get("transformed_height", 8))
    ow = int(attrs.get("transformed_width", 8))
    scale = float(attrs.get("spatial_scale", 1.0))
    n, c, h, w = x.shape
    _require_single_image("roi_perspective_transform", x, ctx)
    dt, dev = x.dtype, x.device
    q = rois.reshape(-1, 4, 2) * scale                   # tl, tr, br, bl
    u = (torch.arange(ow, dtype=dt, device=dev) + 0.5) / ow
    v = (torch.arange(oh, dtype=dt, device=dev) + 0.5) / oh
    vv, uu = torch.meshgrid(v, u, indexing="ij")         # [oh, ow]
    uu, vv = uu[None, ..., None], vv[None, ..., None]
    top = q[:, None, None, 0] * (1 - uu) + q[:, None, None, 1] * uu
    bot = q[:, None, None, 3] * (1 - uu) + q[:, None, None, 2] * uu
    pts = top * (1 - vv) + bot * vv                      # [R, oh, ow, 2]
    px, py = pts[..., 0], pts[..., 1]
    x0 = torch.clamp(torch.floor(px).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(py).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = px - torch.floor(px)
    wy = py - torch.floor(py)
    img = x[0]
    f = (img[:, y0, x0] * ((1 - wy) * (1 - wx))[None] +
         img[:, y1, x0] * (wy * (1 - wx))[None] +
         img[:, y0, x1] * ((1 - wy) * wx)[None] +
         img[:, y1, x1] * (wy * wx)[None])                # [C, R, oh, ow]
    inside = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    out = _where0(inside[None], f).permute(1, 0, 2, 3)
    return {"Out": out, "Out2InIdx": None, "Out2InWeights": None,
            "Mask": None, "TransformMatrix": None}


# ---------------------------------------------------------------------------
# detection_map: streaming mAP (reference: detection_map_op.cc)
# ---------------------------------------------------------------------------


# Copied from the JAX package: paddle_tpu/ops/detection.py's
# `_np_detection_map_update` (tests/test_torch_imports.py checks it).
def _np_detection_map_update(dets, gts, pos_count, tps, fps,
                             overlap_threshold, evaluate_difficult,
                             ap_type, class_num, cap):
    """Host kernel: reference detection_map_op.h semantics on padded
    numpy buffers. dets [B,M,6] (label<0 = pad), gts [B,G,6]
    (label,x1,y1,x2,y2,difficult; label<0 = pad). State buffers:
    pos_count [C,1], tps/fps [C,cap,2] with score<0 marking free slots."""
    import numpy as np

    def iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    pos_count = pos_count.copy()
    lists = {c: ([list(p) for p in tps[c] if p[0] >= 0],
                 [list(p) for p in fps[c] if p[0] >= 0])
             for c in range(class_num)}

    for b in range(dets.shape[0]):
        # rows with label < 0 are padding; labels >= class_num are invalid
        # and dropped (a crash inside pure_callback would surface as an
        # opaque XlaRuntimeError)
        img_gts = [g for g in gts[b] if 0 <= g[0] < class_num]
        img_dets = [d for d in dets[b] if 0 <= d[0] < class_num]
        # per-class gt count (difficult excluded unless evaluate_difficult)
        for g in img_gts:
            c = int(g[0])
            difficult = bool(g[5]) if g.shape[0] > 5 else False
            if evaluate_difficult or not difficult:
                pos_count[c, 0] += 1
        by_class = {}
        for d in img_dets:
            by_class.setdefault(int(d[0]), []).append(d)
        for c, ds in by_class.items():
            cgts = [[tuple(g[1:5]),
                     bool(g[5]) if g.shape[0] > 5 else False, False]
                    for g in img_gts if int(g[0]) == c]
            tp_l, fp_l = lists.setdefault(c, ([], []))
            for d in sorted(ds, key=lambda r: -r[1]):
                score, box = float(d[1]), tuple(d[2:6])
                best, best_g = 0.0, None
                for g in cgts:
                    i = iou(box, g[0])
                    if i > best:
                        best, best_g = i, g
                if best >= overlap_threshold and best_g is not None:
                    if not evaluate_difficult and best_g[1]:
                        continue           # difficult gt: ignored
                    if not best_g[2]:
                        best_g[2] = True
                        tp_l.append([score, 1.0])
                        fp_l.append([score, 0.0])
                    else:
                        tp_l.append([score, 0.0])
                        fp_l.append([score, 1.0])
                else:
                    tp_l.append([score, 0.0])
                    fp_l.append([score, 1.0])

    # mAP over classes with positives
    aps = []
    for c in range(class_num):
        npos = pos_count[c, 0]
        tp_l, fp_l = lists.get(c, ([], []))
        if npos == 0:
            continue
        if not tp_l:
            aps.append(0.0)
            continue
        order = np.argsort([-p[0] for p in tp_l], kind="stable")
        tp = np.cumsum([tp_l[i][1] for i in order])
        fp = np.cumsum([fp_l[i][1] for i in order])
        rec = tp / npos
        prec = tp / np.maximum(tp + fp, 1e-9)
        if ap_type == "11point":
            ap = sum((prec[rec >= t].max() if (rec >= t).any() else 0.0)
                     for t in np.linspace(0, 1, 11)) / 11.0
        else:
            ap, prev_rec = 0.0, 0.0
            for i in range(len(rec)):
                ap += prec[i] * (rec[i] - prev_rec)
                prev_rec = rec[i]
        aps.append(ap)
    m_ap = float(np.mean(aps)) if aps else 0.0

    def pack(ls):
        out = np.full((class_num, cap, 2), -1.0, np.float32)
        over = []
        for c in range(class_num):
            rows = lists.get(c, ([], []))[ls]
            if len(rows) > cap:
                over.append((c, len(rows)))
                rows = rows[:cap]
            for i, r in enumerate(rows):
                out[c, i] = r
        if over:
            import warnings

            warnings.warn(
                f"detection_map: {len(over)} classes exceeded "
                f"max_dets={cap} (worst: class {max(over, key=lambda t: t[1])[0]} "
                f"with {max(o[1] for o in over)} detections); streaming "
                f"state is truncated and mAP will drift — raise max_dets",
                RuntimeWarning)
        return out

    return (np.array([m_ap], np.float32), pos_count.astype(np.int32),
            pack(0), pack(1))


@register_op("detection_map", grad=None,
             nondiff_inputs=("DetectRes", "Label", "HasState", "PosCount",
                             "TruePos", "FalsePos"))
def detection_map(ins, attrs, ctx):
    """reference: detection_map_op.cc: streaming mAP. DetectRes [B, M,
    6] or [M, 6] and Label [B, G, 6] or [G, 6] are padded with label -1
    rows; the accumulators are fixed-capacity (attr `max_dets`, score < 0
    a free slot). The matching and the AP run on the host, as the
    reference computes them on the CPU and the JAX op through
    `jax.pure_callback`: that is the design, not a fallback. One
    device-to-host copy a call carries the detections, the labels and
    the state in; the results go back to the inputs' device."""
    dets = ins["DetectRes"][0]
    gts = ins["Label"][0]
    if dets.dim() == 2:
        dets = dets[None]
    if gts.dim() == 2:
        gts = gts[None]
    class_num = int(attrs["class_num"])
    cap = int(attrs.get("max_dets", 256))
    thr = float(attrs.get("overlap_threshold", 0.5))
    ed = bool(attrs.get("evaluate_difficult", True))
    ap_type = str(attrs.get("ap_type", "integral"))
    dev = dets.device
    if dev.type == "meta":
        return {"MAP": torch.empty((1,), dtype=torch.float32, device=dev),
                "AccumPosCount": torch.empty((class_num, 1),
                                             dtype=torch.int32, device=dev),
                "AccumTruePos": torch.empty((class_num, cap, 2),
                                            dtype=torch.float32, device=dev),
                "AccumFalsePos": torch.empty((class_num, cap, 2),
                                             dtype=torch.float32,
                                             device=dev)}
    pc_in, tp_in, fp_in = (_opt(ins, s) for s in ("PosCount", "TruePos",
                                                   "FalsePos"))
    has_state = _opt(ins, "HasState")
    if pc_in is None:
        pc_in = torch.zeros((class_num, 1), dtype=torch.int32, device=dev)
    if tp_in is None:
        tp_in = torch.full((class_num, cap, 2), -1.0, device=dev)
    if fp_in is None:
        fp_in = torch.full((class_num, cap, 2), -1.0, device=dev)
    if has_state is not None:
        # HasState == 0 resets the accumulators
        keep = has_state.reshape(()) != 0
        pc_in = torch.where(keep, pc_in, torch.zeros_like(pc_in))
        tp_in = torch.where(keep, tp_in, torch.full_like(tp_in, -1.0))
        fp_in = torch.where(keep, fp_in, torch.full_like(fp_in, -1.0))
    parts = [dets, gts, pc_in, tp_in, fp_in]
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    host = flat.cpu().numpy()
    vals, at = [], 0
    for p in parts:
        vals.append(host[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    with warnings.catch_warnings():
        warnings.simplefilter("default")
        m_ap, pc, tp, fp = _np_detection_map_update(
            vals[0], vals[1], vals[2].astype(np.int64),
            vals[3].astype(np.float32), vals[4].astype(np.float32),
            thr, ed, ap_type, class_num, cap)
    return {"MAP": torch.from_numpy(m_ap).to(dev),
            "AccumPosCount": torch.from_numpy(pc).to(dev),
            "AccumTruePos": torch.from_numpy(tp).to(dev),
            "AccumFalsePos": torch.from_numpy(fp).to(dev)}


@register_op("ssd_loss", nondiff_inputs=("GtBox", "GtLabel", "PriorBox",
                                         "PriorBoxVar"))
def ssd_loss(ins, attrs, ctx):
    """reference: layers/detection.py `ssd_loss` (:1389), one op as in
    the JAX package (iou_similarity, bipartite_match, target_assign,
    mine_hard_examples, softmax CE and smooth L1 in one dataflow),
    every image at once. GtBox [N, G, 4] zero-padded, GtLabel [N, G]
    with -1 padding rows. Loss [N, P] = conf_w * conf + loc_w * loc a
    prior, over the total positives when `normalize`. Two gts whose best
    prior is the same force it to the later gt, as XLA's CPU scatter
    leaves it."""
    loc = ins["Location"][0]               # [N, P, 4]
    conf = ins["Confidence"][0]            # [N, P, C]
    gb = ins["GtBox"][0]                   # [N, G, 4]
    gl = ins["GtLabel"][0]                 # [N, G]
    prior = ins["PriorBox"][0]             # [P, 4]
    pvar = _opt(ins, "PriorBoxVar")
    bg = int(attrs.get("background_label", 0))
    ovt = float(attrs.get("overlap_threshold", 0.5))
    npr = float(attrs.get("neg_pos_ratio", 3.0))
    neg_ov = float(attrs.get("neg_overlap", 0.5))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    normalize = bool(attrs.get("normalize", True))
    match_type = str(attrs.get("match_type", "per_prediction"))
    n, p, c = conf.shape
    if gl.dim() == 3:
        gl = gl[..., 0]
    gv = gl >= 0                                          # [N, G]
    g = gb.shape[1]
    dev = conf.device

    # iou [N, G, P]; an invalid gt never wins a prior
    area_g = (gb[..., 2] - gb[..., 0]) * (gb[..., 3] - gb[..., 1])
    area_p = (prior[:, 2] - prior[:, 0]) * (prior[:, 3] - prior[:, 1])
    lt = torch.maximum(gb[:, :, None, :2], prior[None, None, :, :2])
    rb = torch.minimum(gb[:, :, None, 2:], prior[None, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area_g[..., None] + area_p - inter + 1e-10)
    iou = torch.where(gv[..., None], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = torch.max(iou, dim=1)             # [N, P]
    if match_type == "per_prediction":
        match = torch.where(best_iou >= ovt, best_gt, -1)
    else:
        match = torch.full((n, p), -1, dtype=torch.int64, device=dev)
    # each valid gt forces its best prior positive; of two gts with one
    # best prior the later one writes last
    best_prior = torch.argmax(iou, dim=2)                 # [N, G]
    writer = torch.where(gv, torch.arange(1, g + 1, device=dev), 0)
    forced = torch.zeros((n, p + 1), dtype=torch.int64, device=dev)
    forced = forced.scatter_reduce(
        1, torch.where(gv, best_prior, p), writer, reduce="amax")[:, :p] - 1
    match = torch.where(forced >= 0, forced, match)
    pos = match >= 0

    tgt_label = torch.where(pos, torch.gather(gl, 1, torch.clamp(
        match, min=0)), bg)
    logp = torch.log_softmax(conf.to(torch.float32), dim=-1)
    ce = -torch.gather(logp, 2, tgt_label[..., None].to(torch.int64))[..., 0]

    # max_negative mining: the highest ce among negatives with iou <
    # neg_overlap
    n_pos = pos.sum(1)
    n_neg_want = (npr * n_pos).to(torch.int32)
    neg_cand = ~pos & (best_iou < neg_ov)
    neg_score = torch.where(neg_cand, ce, _NEG_INF)
    neg_sel = neg_cand & (_rank_desc(neg_score, 1) < n_neg_want[:, None])
    conf_loss = ce * (pos | neg_sel).to(ce.dtype)

    # smooth L1 on the encoded offsets, positives only
    gbm = _take_rows(gb, match)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    tw = gbm[..., 2] - gbm[..., 0]
    th = gbm[..., 3] - gbm[..., 1]
    tcx = gbm[..., 0] + tw * 0.5
    tcy = gbm[..., 1] + th * 0.5
    enc = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                       torch.log(torch.clamp(tw / pw, min=1e-10)),
                       torch.log(torch.clamp(th / ph, min=1e-10))], dim=-1)
    if pvar is not None:
        enc = enc / pvar
    d = loc.to(torch.float32) - enc
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
    loss = conf_w * conf_loss + loc_w * sl1 * pos.to(sl1.dtype)
    if normalize:
        loss = loss / torch.clamp(n_pos.sum(), min=1).to(loss.dtype)
    return {"Loss": loss}


@register_op("retinanet_target_assign", is_random=True, grad=None)
def retinanet_target_assign(ins, attrs, ctx):
    """reference: detection/rpn_target_assign_op.cc:1030: RetinaNet's
    anchor assignment: positives at IoU >= positive_overlap plus each
    gt's best anchor, negatives below negative_overlap, no subsampling;
    labels are 1-based class ids; ForegroundNumber normalizes the focal
    loss. Static shapes: fixed-capacity index outputs, -1 padded."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0].reshape(-1, 4)
    gt_labels = ins["GtLabels"][0].reshape(-1)
    pos_thr = float(attrs.get("positive_overlap", 0.5))
    neg_thr = float(attrs.get("negative_overlap", 0.4))
    a = anchors.shape[0]
    dev = anchors.device
    valid_gt = gt_labels > 0
    iou = _pairwise_iou(anchors, gt, normalized=False)
    iou = torch.where(valid_gt[None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = torch.max(iou, dim=1)
    fg = _set_at(best_iou >= pos_thr,
                 torch.where(valid_gt, torch.argmax(iou, dim=0), a))
    bg = (best_iou < neg_thr) & ~fg
    ar = torch.arange(a, device=dev)

    def ascending(sel):
        idx = torch.sort(torch.where(sel, ar, a)).values
        return torch.where(idx < a, idx, -1).to(torch.int32)

    loc_index = ascending(fg)
    score_index = ascending(fg | bg)
    labels = torch.where(fg, gt_labels[best_gt], 0)
    target_label = torch.where(score_index >= 0,
                               labels[torch.clamp(score_index, min=0)
                                      .to(torch.int64)], -1).to(torch.int32)
    g = gt[best_gt]
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    gw = g[:, 2] - g[:, 0] + 1.0
    gh = g[:, 3] - g[:, 1] + 1.0
    gcx = g[:, 0] + gw * 0.5
    gcy = g[:, 1] + gh * 0.5
    tb = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                      torch.log(torch.clamp(gw / aw, min=1e-10)),
                      torch.log(torch.clamp(gh / ah, min=1e-10))], dim=-1)
    has = loc_index >= 0
    target_bbox = _where0(has[:, None],
                          tb[torch.clamp(loc_index, min=0).to(torch.int64)])
    inside = has.to(anchors.dtype)[:, None] * torch.ones(
        (1, 4), dtype=anchors.dtype, device=dev)
    return {"LocationIndex": loc_index, "ScoreIndex": score_index,
            "TargetLabel": target_label[:, None], "TargetBBox": target_bbox,
            "BBoxInsideWeight": inside,
            "ForegroundNumber": fg.to(torch.int32).sum().reshape(1)}


# the reference registers multiclass_nms2 as an op type of its own (the
# same kernel with the Index output, multiclass_nms_op.cc)
register_op("multiclass_nms2", grad=None)(multiclass_nms)
