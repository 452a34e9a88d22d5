"""The JAX package's `ops/detection.py` op types in the port
(`paddle_tpu_torch/ops/detection.py`, all 32) against the JAX kernels on
the same numpy inputs from a seed: forward, and the generic
`<op>_grad` of the eight differentiable ones (roi_align, roi_pool,
psroi_pool, prroi_pool, deformable_psroi_pooling, sigmoid_focal_loss,
yolov3_loss, ssd_loss; every floating input's gradient under a random
cotangent on every floating output).

Tolerances, on float32 (`test_torch_fluid_ops.TOL`): geometry, losses
and pooling rtol 1e-5 with an atol of 1e-6 of the largest reference
value ("ew"); the pooling ops that contract a map with weight matrices
(roi_align, psroi_pool, prroi_pool) 1e-4 ("mm"); every selection
(indices, counts, labels, masks) exactly. Under the suite's x64 the
JAX ops whose code builds float constants with `jnp.asarray` or
`jnp.arange` (prior_box, density_prior_box, anchor_generator,
yolov3_loss, generate_mask_labels' grid) compute in float64; the port
computes in float32, as the JAX package does without x64, and is held
to the float64 reference at the same limits (`F64`).

Also: the repeated-index scatters (two gts sharing a best prior or
anchor), NMS tie order on tied scores, the random ops at
use_random=False exactly and at use_random=True by their laws,
detection_map's streaming state over two calls with HasState, every
case's forward on meta inputs (shape inference), and three small
programs held to the JAX package for one step: an SSD of two feature
maps at 64 x 64, batch 2; the proposal chain of
tests/test_detection_ops.py:367; and the Faster R-CNN proposal path of
`chip_smoke.proposal_path` at a small size.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc
from test_torch_fluid_ops import _run
from test_torch_sequence_ops import outputs_stay_on_meta
from test_torch_text_match import check_op, held, run_jax

torch.set_num_threads(2)

F64 = {"prior_box", "density_prior_box", "anchor_generator", "yolov3_loss",
       "generate_mask_labels"}


_boxes = chip_smoke._boxes_np


def _quads(rng, n, size):
    c = rng.uniform(0.3, 0.7, (n, 1, 2)) * size
    off = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], "float32")
    jitter = rng.uniform(0.5, 1.5, (n, 4, 2)) * size * 0.2
    return (c + off * jitter).reshape(n, 8).astype("float32")


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype("float32")


def _pvar(n):
    return np.tile(np.array([[0.1, 0.1, 0.2, 0.2]], "float32"), (n, 1))


def _anchors(h, w, sizes=(16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             stride=(16.0, 16.0)):
    """anchor_generator's anchors ([H, W, A, 4]) and variances, from the
    port's op."""
    out = _run("torch", "anchor_generator",
               {"Input": [np.zeros((1, 1, h, w), "float32")]},
               {"anchor_sizes": list(sizes), "aspect_ratios": list(ratios),
                "stride": list(stride)}, {})
    return out["Anchors"][0], out["Variances"][0]


def _yolo_gt(rng, n, b, c):
    box = np.concatenate([rng.uniform(0.1, 0.9, (n, b, 2)),
                          rng.uniform(0.05, 0.6, (n, b, 2))], 2)
    box[:, -1] = 0.0                          # a padded gt
    return box.astype("float32"), rng.randint(0, c, (n, b)).astype("int32")


def _ssd_inputs(rng, n=2, p=24, c=4, g=3):
    """ssd_loss inputs: priors, and gts of which gt 1 repeats gt 0's box
    with another label (both have the same best prior: the forced
    positive is the later gt's, as XLA's scatter leaves it)."""
    prior = _boxes(rng, p, 1.0, 0.1, 0.5)
    gt = np.stack([_boxes(rng, g, 1.0, 0.1, 0.5) for _ in range(n)])
    gt[:, 1] = gt[:, 0]
    label = rng.randint(1, c, (n, g)).astype("int64")
    label[:, 1] = (label[:, 0] % (c - 1)) + 1
    label[-1, -1] = -1                         # a padded gt
    return {"Location": [_f(rng, n, p, 4, scale=0.5)],
            "Confidence": [_f(rng, n, p, c)],
            "GtBox": [gt], "GtLabel": [label], "PriorBox": [prior],
            "PriorBoxVar": [_pvar(p)]}


def _nms_inputs(rng, n=2, m=14, c=4, tied=False, size=1.0):
    boxes = np.stack([_boxes(rng, m, size, 0.1, 0.5) for _ in range(n)])
    scores = rng.uniform(0.0, 1.0, (n, c, m))
    if tied:                                   # ties broken by index
        scores = np.round(scores * 4) / 4
    return {"BBoxes": [boxes], "Scores": [scores.astype("float32")]}


def _cases():
    """(op type, inputs, attrs, class, name): every op type at the shapes
    of tests/test_detection_ops.py."""
    rng = np.random.RandomState(26)
    anc, var = _anchors(4, 4)
    nms = {"background_label": 0, "score_threshold": 0.2, "nms_top_k": -1,
           "nms_threshold": 0.4, "keep_top_k": 10, "normalized": True}
    nms_in = _nms_inputs(rng)
    tied_in = _nms_inputs(rng, tied=True)
    roi_x = _f(rng, 1, 3, 8, 10)
    rois = _boxes(rng, 5, 16.0, 0.2, 0.7)
    dps_x = _f(rng, 1, 8, 8, 8)
    dps_rois = _boxes(rng, 3, 16.0, 0.3, 0.7)
    dps = {"spatial_scale": 0.5, "output_dim": 2, "group_size": [2, 2],
           "pooled_height": 2, "pooled_width": 2, "part_size": [2, 2],
           "sample_per_part": 2, "trans_std": 0.1}
    yolo_anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    ygt, ylab = _yolo_gt(rng, 2, 4, 4)
    rpn_anchor = _boxes(rng, 40, 64.0, 0.1, 0.5)
    rpn_gt = _boxes(rng, 3, 64.0, 0.2, 0.5)
    rpn_gt[2] = rpn_gt[1]                      # a repeated best anchor
    ret_gt = np.concatenate([rpn_gt, _boxes(rng, 1, 64.0, 0.2, 0.5)])
    gpl_rois = np.stack([_boxes(rng, 20, 64.0, 0.1, 0.6) for _ in range(2)])
    gpl_gt = np.stack([_boxes(rng, 3, 64.0, 0.2, 0.6) for _ in range(2)])
    gpl_rois[:, :6] = np.repeat(gpl_gt, 2, 1) + rng.uniform(
        -2, 2, (2, 6, 4)).astype("float32")
    segs = (rng.uniform(0, 1, (3, 16, 16)) > 0.5).astype("int32")
    det = np.concatenate([rng.randint(-1, 3, (2, 6, 1)),
                          rng.uniform(0.1, 1.0, (2, 6, 1)),
                          np.stack([_boxes(rng, 6) for _ in range(2)])],
                         2).astype("float32")
    lab = np.concatenate([rng.randint(-1, 3, (2, 4, 1)),
                          np.stack([_boxes(rng, 4) for _ in range(2)]),
                          rng.randint(0, 2, (2, 4, 1))], 2).astype("float32")
    det[:, :4, 2:] = lab[:, :4, 1:5] + 0.01    # some detections hit
    det[:, :4, 0] = np.maximum(lab[:, :4, 0], 0)
    fpn_rois = np.concatenate([_boxes(rng, 5, 400.0, 0.02, 0.1),
                               _boxes(rng, 5, 400.0, 0.3, 0.9)])
    ret_anc = [np.tile(np.array([[0, 0, 31, 31]], "float32"), (8, 1)) +
               np.arange(8, dtype="float32")[:, None] * 8,
               np.tile(np.array([[0, 0, 63, 63]], "float32"), (4, 1)) +
               np.arange(4, dtype="float32")[:, None] * 16]
    c = [
        ("iou_similarity", {"X": [_boxes(rng, 5)], "Y": [_boxes(rng, 6)]},
         {}, "ew", "iou_similarity"),
        ("box_coder", {"PriorBox": [_boxes(rng, 6)], "PriorBoxVar": [_pvar(6)],
                       "TargetBox": [_boxes(rng, 5)]},
         {"code_type": "encode_center_size"}, "ew", "box_coder_encode"),
        ("box_coder", {"PriorBox": [_boxes(rng, 6, 40.0)],
                       "TargetBox": [_boxes(rng, 5, 40.0)]},
         {"code_type": "encode_center_size", "box_normalized": False},
         "ew", "box_coder_encode_pixels_no_var"),
        ("box_coder", {"PriorBox": [_boxes(rng, 6)], "PriorBoxVar": [_pvar(6)],
                       "TargetBox": [_f(rng, 5, 6, 4, scale=0.5)]},
         {"code_type": "decode_center_size"}, "ew", "box_coder_decode"),
        ("prior_box", {"Input": [_f(rng, 1, 8, 4, 5)],
                       "Image": [_f(rng, 1, 3, 32, 40)]},
         {"min_sizes": [4.0, 10.0], "max_sizes": [8.0, 16.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
         "ew", "prior_box"),
        ("prior_box", {"Input": [_f(rng, 1, 8, 3, 3)],
                       "Image": [_f(rng, 1, 3, 300, 300)]},
         {"min_sizes": [60.0], "max_sizes": [], "aspect_ratios": [2.0],
          "flip": True, "offset": 0.5}, "ew", "prior_box_no_max"),
        ("density_prior_box", {"Input": [_f(rng, 1, 8, 3, 3)],
                               "Image": [_f(rng, 1, 3, 24, 24)]},
         {"fixed_sizes": [4.0, 8.0], "fixed_ratios": [1.0, 2.0],
          "densities": [2, 1], "clip": True}, "ew", "density_prior_box"),
        ("anchor_generator", {"Input": [_f(rng, 1, 8, 3, 4)]},
         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
          "stride": [16.0, 16.0]}, "ew", "anchor_generator"),
        ("box_clip", {"Input": [_f(rng, 2, 5, 4, scale=40.0)],
                      "ImInfo": [np.array([[40, 30, 1], [20, 20, 1]],
                                          "float32")]},
         {}, "ew", "box_clip"),
        ("polygon_box_transform", {"Input": [_f(rng, 1, 8, 3, 4)]}, {},
         "ew", "polygon_box_transform"),
        ("box_decoder_and_assign",
         {"PriorBox": [_boxes(rng, 5, 40.0)], "PriorBoxVar": [_pvar(5)],
          "TargetBox": [_f(rng, 5, 12, scale=0.5)],
          "BoxScore": [_f(rng, 5, 3)]}, {"box_clip": 4.135}, "ew",
         "box_decoder_and_assign"),
        ("yolo_box", {"X": [_f(rng, 2, 27, 4, 4)],
                      "ImgSize": [np.array([[128, 128], [96, 128]],
                                           "int32")]},
         {"anchors": yolo_anchors[:6], "class_num": 4, "conf_thresh": 0.3,
          "downsample_ratio": 32}, "ew", "yolo_box"),
        ("roi_align", {"X": [roi_x], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
          "sampling_ratio": 2}, "mm", "roi_align"),
        ("roi_align", {"X": [roi_x], "ROIs": [rois]},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
          "sampling_ratio": -1}, "mm", "roi_align_default_ratio"),
        ("roi_pool", {"X": [roi_x], "ROIs": [rois]},
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5},
         "ew", "roi_pool"),
        ("psroi_pool", {"X": [_f(rng, 1, 8, 8, 8)],
                        "ROIs": [_boxes(rng, 4, 16.0, 0.2, 0.7)]},
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 0.5}, "mm", "psroi_pool"),
        ("prroi_pool", {"X": [_f(rng, 1, 12, 8, 8)],
                        "ROIs": [_boxes(rng, 4, 16.0, 0.2, 0.7)]},
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 3,
          "spatial_scale": 0.5}, "mm", "prroi_pool"),
        ("deformable_psroi_pooling",
         {"Input": [dps_x], "ROIs": [dps_rois],
          "Trans": [_f(rng, 3, 2, 2, 2)]}, dict(dps, no_trans=False), "ew",
         "deformable_psroi_pooling"),
        ("deformable_psroi_pooling", {"Input": [dps_x], "ROIs": [dps_rois]},
         dict(dps, no_trans=True), "ew", "deformable_psroi_pooling_no_trans"),
        ("roi_perspective_transform",
         {"X": [_f(rng, 1, 2, 8, 8)], "ROIs": [_quads(rng, 3, 8.0)]},
         {"transformed_height": 4, "transformed_width": 5}, "ew",
         "roi_perspective_transform"),
        ("bipartite_match", {"DistMat": [rng.uniform(
            0, 1, (2, 4, 6)).astype("float32")]}, {}, "ew",
         "bipartite_match"),
        ("bipartite_match", {"DistMat": [rng.uniform(
            0, 1, (2, 4, 6)).astype("float32")]},
         {"match_type": "per_prediction", "dist_threshold": 0.5}, "ew",
         "bipartite_match_per_prediction"),
        ("target_assign", {"X": [_f(rng, 2, 3, 4)],
                           "MatchIndices": [rng.randint(
                               -1, 3, (2, 5)).astype("int32")],
                           "NegFlag": [rng.randint(0, 2, (2, 5)).astype(
                               "int32")]},
         {"mismatch_value": 7.0}, "ew", "target_assign"),
        ("mine_hard_examples",
         {"ClsLoss": [np.round(rng.uniform(0, 1, (2, 8)) * 4).astype(
             "float32") / 4],
          "MatchIndices": [rng.randint(-3, 2, (2, 8)).astype("int32")],
          "LocLoss": [rng.uniform(0, 1, (2, 8)).astype("float32")]},
         {"neg_pos_ratio": 1.5}, "ew", "mine_hard_examples_tied"),
        ("mine_hard_examples",
         {"ClsLoss": [rng.uniform(0, 1, (2, 8)).astype("float32")],
          "MatchIndices": [rng.randint(-3, 2, (2, 8)).astype("int32")],
          "LocLoss": [rng.uniform(0, 1, (2, 8)).astype("float32")]},
         {"neg_pos_ratio": 1.0, "mining_type": "hard_example"}, "ew",
         "mine_hard_examples_hard_example"),
        ("rpn_target_assign", {"Anchor": [rpn_anchor], "GtBoxes": [rpn_gt]},
         {"rpn_batch_size_per_im": 16, "rpn_fg_fraction": 0.25,
          "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
          "use_random": False}, "ew", "rpn_target_assign"),
        ("retinanet_target_assign",
         {"Anchor": [rpn_anchor], "GtBoxes": [ret_gt],
          "GtLabels": [np.array([2, 1, 3, 0], "int32")]},
         {"positive_overlap": 0.5, "negative_overlap": 0.4}, "ew",
         "retinanet_target_assign"),
        ("generate_proposal_labels",
         {"RpnRois": [gpl_rois], "GtBoxes": [gpl_gt],
          "GtClasses": [np.array([[1, 4, 0], [2, 2, 3]], "int32")],
          "IsCrowd": [np.array([[0, 0, 0], [0, 1, 0]], "int32")]},
         {"batch_size_per_im": 8, "fg_fraction": 0.25, "fg_thresh": 0.5,
          "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0, "class_nums": 5,
          "use_random": False}, "ew", "generate_proposal_labels"),
        ("generate_mask_labels",
         {"GtSegms": [segs], "Rois": [_boxes(rng, 5, 16.0, 0.2, 0.8)],
          "LabelsInt32": [np.array([1, 0, 2, -1, 3], "int32")],
          "MatchedGts": [np.array([0, 1, 2, 0, 1], "int32")]},
         {"resolution": 4}, "ew", "generate_mask_labels"),
        ("sigmoid_focal_loss",
         {"X": [_f(rng, 8, 5)], "Label": [rng.randint(0, 6, (8, 1)).astype(
             "int32")], "FgNum": [np.array([5], "int32")]},
         {"gamma": 2.0, "alpha": 0.25}, "ew", "sigmoid_focal_loss"),
        ("yolov3_loss", {"X": [_f(rng, 2, 27, 4, 4)], "GTBox": [ygt],
                         "GTLabel": [ylab]},
         {"anchors": yolo_anchors, "anchor_mask": [3, 4, 5], "class_num": 4,
          "ignore_thresh": 0.5, "downsample_ratio": 32}, "ew",
         "yolov3_loss"),
        ("yolov3_loss", {"X": [_f(rng, 2, 27, 4, 4)], "GTBox": [ygt],
                         "GTLabel": [ylab],
                         "GTScore": [rng.uniform(0.2, 1.0, (2, 4)).astype(
                             "float32")]},
         {"anchors": yolo_anchors, "anchor_mask": [0, 1, 2], "class_num": 4,
          "ignore_thresh": 0.5, "downsample_ratio": 32,
          "use_label_smooth": False}, "ew", "yolov3_loss_gt_score"),
        ("ssd_loss", _ssd_inputs(rng), {}, "ew", "ssd_loss"),
        ("ssd_loss", _ssd_inputs(rng),
         {"match_type": "bipartite", "normalize": False, "neg_pos_ratio": 2.0,
          "loc_loss_weight": 0.5}, "ew", "ssd_loss_bipartite"),
        ("multiclass_nms", nms_in, nms, "ew", "multiclass_nms"),
        ("multiclass_nms", nms_in, dict(nms, nms_top_k=6, keep_top_k=-1),
         "ew", "multiclass_nms_top_k"),
        ("multiclass_nms", tied_in, dict(nms, score_threshold=0.0,
                                         nms_threshold=0.6),
         "ew", "multiclass_nms_tied"),
        ("multiclass_nms", _nms_inputs(rng, size=40.0),
         dict(nms, normalized=False, background_label=-1), "ew",
         "multiclass_nms_pixels_no_background"),
        ("multiclass_nms2", tied_in, dict(nms, nms_top_k=5), "ew",
         "multiclass_nms2"),
        ("generate_proposals",
         {"Scores": [rng.uniform(0, 1, (2, 6, 4, 4)).astype("float32")],
          "BboxDeltas": [_f(rng, 2, 24, 4, 4, scale=0.2)],
          "ImInfo": [np.array([[64, 64, 1], [48, 60, 1.5]], "float32")],
          "Anchors": [anc], "Variances": [var]},
         {"pre_nms_topN": 30, "post_nms_topN": 8, "nms_thresh": 0.5,
          "min_size": 4.0}, "ew", "generate_proposals"),
        ("generate_proposals",
         {"Scores": [np.round(rng.uniform(0, 1, (1, 6, 4, 4)) * 3).astype(
             "float32")],
          "BboxDeltas": [_f(rng, 1, 24, 4, 4, scale=0.2)],
          "ImInfo": [np.array([[64, 64, 1]], "float32")],
          "Anchors": [anc], "Variances": [var]},
         {"pre_nms_topN": 40, "post_nms_topN": 12, "nms_thresh": 0.7},
         "ew", "generate_proposals_tied"),
        ("collect_fpn_proposals",
         {"MultiLevelRois": [np.stack([_boxes(rng, 5, 64.0)] * 2),
                             np.stack([_boxes(rng, 4, 64.0)] * 2)],
          "MultiLevelScores": [rng.uniform(0, 1, (2, 5)).astype("float32"),
                               rng.uniform(0, 1, (2, 4)).astype("float32")],
          "MultiLevelRoisNum": [np.array([3, 5], "int32"),
                                np.array([4, 1], "int32")]},
         {"post_nms_topN": 6}, "ew", "collect_fpn_proposals"),
        ("collect_fpn_proposals",
         {"MultiLevelRois": [_boxes(rng, 5, 64.0), _boxes(rng, 3, 64.0)],
          "MultiLevelScores": [np.full((5, 1), 0.5, "float32"),
                               np.full((3, 1), 0.5, "float32")]},
         {"post_nms_topN": 4}, "ew", "collect_fpn_proposals_tied_2d"),
        ("distribute_fpn_proposals", {"FpnRois": [fpn_rois]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224.0}, "ew", "distribute_fpn_proposals"),
        ("retinanet_detection_output",
         {"BBoxes": [_f(rng, 2, 8, 4, scale=0.1), _f(rng, 2, 4, 4, scale=0.1)],
          "Scores": [rng.uniform(0, 0.5, (2, 8, 3)).astype("float32"),
                     rng.uniform(0, 0.5, (2, 4, 3)).astype("float32")],
          "Anchors": ret_anc,
          "ImInfo": [np.array([[128, 128, 1], [60, 100, 1]], "float32")]},
         {"score_threshold": 0.05, "nms_top_k": 6, "nms_threshold": 0.3,
          "keep_top_k": 5}, "ew", "retinanet_detection_output"),
        ("detection_map", {"DetectRes": [det], "Label": [lab]},
         {"class_num": 3, "overlap_threshold": 0.5, "ap_type": "11point",
          "evaluate_difficult": False, "max_dets": 16}, "ew",
         "detection_map"),
    ]
    # a variant whose gradient takes no other path than its first case's
    # is held forward only
    forward_only = {"roi_align_default_ratio", "ssd_loss_bipartite",
                    "deformable_psroi_pooling_no_trans"}
    return [pytest.param(*x[:4], x[4] not in forward_only, id=x[4])
            for x in c]


CASES = _cases()


def test_every_detection_op_type_has_a_case():
    """The cases cover the JAX module's 32 op types, and the port
    registers each with the JAX op's gradient kind."""
    import inspect

    from paddle_tpu.core import registry as jreg

    jax_types = {t for t, d in jreg._REGISTRY.items()
                 if not t.endswith("_grad") and inspect.getmodule(
                     d.kernel).__name__.endswith("ops.detection")}
    assert len(jax_types) == 32
    assert {p.values[0] for p in CASES} == jax_types
    for t in jax_types:
        assert treg.get_op_def(t).has_grad() == \
            jreg.get_op_def(t).has_grad(), t
        assert treg.get_op_def(t).is_random == jreg.get_op_def(t).is_random


@pytest.mark.parametrize("op_type, ins, attrs, cls, grad", CASES)
def test_op_forward_and_gradient(op_type, ins, attrs, cls, grad):
    check_op(op_type, ins, attrs, cls, f64=op_type in F64, grad=grad)


@pytest.mark.parametrize("op_type, ins, attrs, cls, grad", CASES)
def test_op_stays_on_meta(op_type, ins, attrs, cls, grad):
    """Each forward on meta inputs comes back on meta (shape
    inference)."""
    outputs_stay_on_meta(op_type, ins, attrs)


def _ctx_call(op_type, ins, attrs, key):
    desc = TOpDesc(type=op_type, attrs=attrs)
    vals = {k: [torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}
    outs = treg.get_op_def(op_type).call(
        vals, attrs, treg.KernelCtx(desc, rng_key=key, device="cpu"))
    return {k: [o.numpy() for o in v if o is not None]
            for k, v in outs.items()}


def test_ssd_loss_forced_positive_takes_the_later_gt():
    """Two gts with one best prior: the prior's target is the later gt
    (XLA's CPU scatter keeps the last writer), and the loss equals the
    JAX op's, which `test_op_forward_and_gradient` checks; here the
    port's CE at that prior is the later gt's label's."""
    rng = np.random.RandomState(5)
    ins = _ssd_inputs(rng, n=1, p=12, c=4, g=2)
    iou = _run("torch", "iou_similarity", {"X": [ins["GtBox"][0][0]],
                                           "Y": ins["PriorBox"]}, {},
               {})["Out"][0]
    best = iou.argmax(1)
    assert best[0] == best[1]
    out = _run("torch", "ssd_loss", ins, {"normalize": False,
                                          "loc_loss_weight": 0.0,
                                          "neg_pos_ratio": 0.0}, {})
    conf = ins["Confidence"][0][0, best[0]].astype(np.float64)
    logp = conf - np.log(np.exp(conf).sum())
    want = -logp[ins["GtLabel"][0][0, 1]]
    np.testing.assert_allclose(out["Loss"][0][0, best[0]], want, rtol=1e-5)


def test_random_samplers_hold_their_laws():
    """rpn_target_assign and generate_proposal_labels at use_random=True:
    at most the quota of foreground, every index inside its mask (the
    use_random=False call's masks, read back from its indices and
    counts), no repeats, the same draws for the same step seed and
    other draws for another."""
    rng = np.random.RandomState(7)
    anchor = _boxes(rng, 300, 64.0, 0.1, 0.5)
    gt = _boxes(rng, 4, 64.0, 0.2, 0.5)
    attrs = {"rpn_batch_size_per_im": 64, "rpn_fg_fraction": 0.25,
             "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
             "__rng_uid__": 3}
    ins = {"Anchor": [anchor], "GtBoxes": [gt]}
    full = _ctx_call("rpn_target_assign", dict(ins),
                     dict(attrs, rpn_batch_size_per_im=600,
                          rpn_fg_fraction=0.5, use_random=False), None)
    fg_all = set(full["LocationIndex"][0][full["LocationIndex"][0] >= 0])
    bg_all = set(full["ScoreIndex"][0][300:][full["ScoreIndex"][0][300:]
                                            >= 0])
    draws = []
    for key in (11, 11, 12):
        out = _ctx_call("rpn_target_assign", ins,
                        dict(attrs, use_random=True), key)
        fg = out["LocationIndex"][0]
        bg = out["ScoreIndex"][0][16:]
        fg, bg = fg[fg >= 0], bg[bg >= 0]
        assert len(fg) <= 16 and len(fg) == min(16, len(fg_all))
        assert len(bg) == min(48, len(bg_all))
        assert set(fg) <= fg_all and set(bg) <= bg_all
        assert len(set(fg)) == len(fg) and len(set(bg)) == len(bg)
        draws.append(np.concatenate([fg, bg]))
    assert np.array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[0], draws[2])

    rois = np.stack([_boxes(rng, 60, 64.0, 0.1, 0.6) for _ in range(2)])
    gtb = np.stack([_boxes(rng, 3, 64.0, 0.2, 0.6) for _ in range(2)])
    rois[:, :12] = np.repeat(gtb, 4, 1) + rng.uniform(
        -2, 2, (2, 12, 4)).astype("float32")
    gins = {"RpnRois": [rois], "GtBoxes": [gtb],
            "GtClasses": [np.array([[1, 2, 3], [3, 1, 0]], "int32")]}
    gattrs = {"batch_size_per_im": 16, "fg_fraction": 0.25, "class_nums": 4,
              "__rng_uid__": 4}
    ref = _ctx_call("generate_proposal_labels", gins,
                    dict(gattrs, batch_size_per_im=60, fg_fraction=1.0,
                         use_random=False), None)
    outs = [_ctx_call("generate_proposal_labels", gins,
                      dict(gattrs, use_random=True), key)
            for key in (21, 21, 22)]
    for out in outs:
        lab = out["LabelsInt32"][0]
        for i in range(2):
            fg_rows = {tuple(r) for r, l in zip(ref["Rois"][0][i],
                                                ref["LabelsInt32"][0][i])
                       if l > 0}
            got_fg = [tuple(r) for r, l in zip(out["Rois"][0][i][:4],
                                               lab[i][:4]) if l >= 0]
            assert len(got_fg) <= 4 and set(got_fg) <= fg_rows
            assert len(set(got_fg)) == len(got_fg)
            assert (lab[i][:4] != 0).all()       # fg slots: fg or padding
            assert (lab[i][4:] <= 0).all()       # bg slots: bg or padding
    assert all(np.array_equal(outs[0][k][0], outs[1][k][0]) for k in outs[0])
    assert not np.array_equal(outs[0]["Rois"][0], outs[2]["Rois"][0])


def test_detection_map_streams_over_two_calls():
    """Two detection_map calls, the second carrying the first's state
    with HasState 1, equal the JAX op's call for call; with HasState 0
    the state resets."""
    cases = {p.id: p.values for p in CASES}
    _, ins, attrs, _, _ = cases["detection_map"]
    rng = np.random.RandomState(9)
    det2 = ins["DetectRes"][0][::-1].copy()
    det2[..., 1] = rng.uniform(0.1, 1.0, det2.shape[:2])
    first, _ = check_op("detection_map", ins, attrs)
    for has in (1, 0):
        ins2 = {"DetectRes": [det2], "Label": [ins["Label"][0][::-1].copy()],
                "HasState": [np.array([has], "int32")],
                "PosCount": first["AccumPosCount"],
                "TruePos": first["AccumTruePos"],
                "FalsePos": first["AccumFalsePos"]}
        second, _ = check_op("detection_map", ins2, attrs)
        if has:
            assert second["AccumPosCount"][0].sum() > \
                first["AccumPosCount"][0].sum()
        else:
            alone, _ = check_op("detection_map", {
                "DetectRes": ins2["DetectRes"], "Label": ins2["Label"]},
                attrs)
            for k in alone:
                np.testing.assert_array_equal(second[k][0], alone[k][0])


def _step_pair(build, size, feed):
    """`build(pkg, **size)` in both packages, one step of each from the
    port's startup state: (port fetches, JAX fetches, the port's
    programs). The
    JAX package builds and runs without x64, as it deploys: under the
    suite's x64 its shape inference types the detection ops' float64
    constants into the program (a float64 loss), where the port's is
    float32."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as pt

    import paddle_tpu_torch as ptt

    t = build(ptt, **size)
    sct = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(t["startup"], scope=sct)
    pers = [v.name for v in t["startup"].list_vars() if v.persistable]
    with jax.enable_x64(False):
        j = build(pt, **size)
        assert t["main"].desc.to_dict() == j["main"].desc.to_dict()
        scj = pt.Scope()
        for n in pers:
            scj.set_var(n, jnp.asarray(np.asarray(sct.get(n))))
        fetch = j["fetch"]
        want = pt.Executor(pt.CPUPlace()).run(j["main"], feed=feed,
                                              fetch_list=fetch, scope=scj)
    got = ptt.Executor(ptt.CPUPlace()).run(t["main"], feed=feed,
                                           fetch_list=fetch, scope=sct)
    return ([np.asarray(g) for g in got], [np.asarray(w) for w in want],
            t)


def test_ssd_program_step_matches_jax():
    """`chip_smoke.ssd_program` with two feature maps at 64 x 64, batch
    2, one 512-wide block of five: the loss at rtol 1e-5, and every trainable parameter's gradient
    in `chip_smoke.vgg_grad_errors`' classes at `VGG_TOL`: the network
    is a batch norm after every conv, whose one-pass variance moves the
    gradients under it with the reductions' order (ROADMAP F13;
    measured 8.5e-7 above the last batch norm, 2.8e-4 under one)."""
    size = dict(hw=64, classes=5, width=0.125, maps=2, max_gt=4, repeats=1)
    feed = chip_smoke.ssd_feed(np.random.RandomState(1), batch=2, hw=64,
                               classes=5, max_gt=4)
    feed = {k: feed[k] for k in ("img", "gt_box", "gt_label")}
    got, want, prog = _step_pair(chip_smoke.ssd_program, size, feed)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    err = chip_smoke.vgg_grad_errors(prog["main"], prog["params"], got[1:],
                                     want[1:])
    assert err["grad"] <= chip_smoke.VGG_TOL["grad"], err
    assert err["grad_under_bn"] <= chip_smoke.VGG_TOL["grad_under_bn"], err


def test_detection_layers_in_program_match_jax():
    """tests/test_detection_ops.py:367's chain (anchor_generator,
    generate_proposals, roi_align through layers and an Executor) in
    both packages on one feed: the pooled features at rtol 1e-4 and the
    count exactly."""
    import paddle_tpu as pt

    import paddle_tpu_torch as ptt

    rng = np.random.RandomState(7)
    n, a, h, w = 1, 2, 4, 4
    feed = {"feat": rng.rand(n, 8, h, w).astype("float32"),
            "sc": rng.rand(n, a, h, w).astype("float32"),
            "dl": (rng.randn(n, 4 * a, h, w) * 0.1).astype("float32"),
            "ii": np.array([[64.0, 64.0, 1.0]], "float32")}
    outs = []
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.framework.unique_name.guard(), \
                pkg.program_guard(main, startup):
            feat = pkg.layers.data(name="feat", shape=[8, h, w],
                                   dtype="float32")
            scores = pkg.layers.data(name="sc", shape=[a, h, w],
                                     dtype="float32")
            deltas = pkg.layers.data(name="dl", shape=[4 * a, h, w],
                                     dtype="float32")
            im_info = pkg.layers.data(name="ii", shape=[3], dtype="float32")
            anchors, variances = pkg.layers.anchor_generator(
                feat, anchor_sizes=[16.0, 32.0], aspect_ratios=[1.0],
                stride=[16.0, 16.0])
            rois, probs, num = pkg.layers.generate_proposals(
                scores, deltas, im_info, anchors, variances,
                pre_nms_top_n=16, post_nms_top_n=4, nms_thresh=0.7,
                min_size=2.0)
            pooled = pkg.layers.roi_align(
                feat, pkg.layers.reshape(rois, [-1, 4]), pooled_height=2,
                pooled_width=2, spatial_scale=1.0 / 16.0)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        outs.append([np.asarray(o) for o in exe.run(
            main, feed=feed, fetch_list=[pooled, num, probs])])
    (got, gnum, gp), (want, wnum, wp) = outs[1], outs[0]
    assert got.shape == (4, 8, 2, 2)
    np.testing.assert_array_equal(gnum, wnum)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gp, wp, rtol=1e-6)


def test_proposal_path_matches_jax():
    """`chip_smoke.proposal_path` (anchor_generator, rpn_target_assign,
    generate_proposals, generate_proposal_labels, roi_align, as phase
    34 (b) runs it) at a small size on the port's CPU, each op held
    against the JAX op fed the same inputs: every selection exactly,
    the floats at rtol 1e-4 (roi_align's contraction, "mm")."""
    records = chip_smoke.proposal_path(
        lambda t, i, a: _run("torch", t, i, a, {}), seed=0, hw=(96, 160),
        feat=(8, 6, 10), pre_nms=300, post_nms=60, rois=32, classes=5,
        pooled=2, gts=3)
    assert [r[0] for r in records] == [
        "anchor_generator", "rpn_target_assign", "generate_proposals",
        "generate_proposal_labels", "roi_align"]
    for op_type, ins, attrs, got in records:
        want = run_jax(op_type, ins, attrs, {})
        cls = "mm" if op_type == "roi_align" else "ew"
        for k, vs in want.items():
            for i, w in enumerate(vs):
                if w is not None:
                    held(got[k][i], w, cls, f"{op_type} {k}[{i}]",
                         op_type in F64)
    assert int(records[2][3]["RpnRoisNum"][0][0]) == 60
    assert (records[3][3]["LabelsInt32"][0] > 0).sum() > 0


def test_phase34_parts_run_on_the_cpu():
    """chip_smoke's phase 34 parts with the CPU on both sides, at small
    sizes: (a) the SSD's parity, training and eval, (b) the proposal
    path, (c) the text-matching program, (d) the sweep (43 op types):
    the quickest check of an edit to them."""
    import paddle_tpu_torch as ptt

    cpu = ptt.CPUPlace()
    a = chip_smoke.det_ssd(ptt, cpu, batch=2, hw=64, classes=5, width=0.125,
                           maps=2, max_gt=4, repeats=1)
    assert a["priors"] == 4 * 4 * 3 + 2 * 2 * 6
    assert a["parity"]["loss_rel"] <= chip_smoke.DET_TOL["loss"]
    assert a["eval"]["nms_near_ties"] == 0
    b = chip_smoke.det_proposals(ptt, cpu, seed=0, hw=(96, 160),
                                 feat=(8, 6, 10), pre_nms=300, post_nms=60,
                                 rois=32, classes=5, pooled=2, gts=3)
    assert b["ops"]["generate_proposals"]["proposals"] == 60
    c = chip_smoke.det_text_match(ptt, cpu, B=4, Tq=5, Tt=7, vocab=50,
                                  emb=8, dim_t=2, ch=3, hid=8, ctr_dim=6)
    assert c["parity"]["grad_rel"] == 0.0
    d = chip_smoke.det_sweep("cpu")
    assert d["op_types"] == 43


@pytest.mark.parametrize("ratios, per_cell", [([2.0], 2), ([1.0, 2.0], 3),
                                              ([2.0, 3.0], 4)])
def test_prior_box_adds_no_implicit_unit_ratio(ratios, per_cell):
    """ROADMAP F27: the JAX package's prior_box takes the aspect ratios
    as given (with flip, each r and 1 / r), where Paddle's prior_box
    adds 1.0 first (ExpandAspectRatios): mobilenet_ssd.py's [2.] gives 2
    priors a cell there, not 3. The port copies it; phase 34 writes the
    1.0 out to build the published 1917 priors."""
    ins = {"Input": [np.zeros((1, 8, 3, 3), "float32")],
           "Image": [np.zeros((1, 3, 30, 30), "float32")]}
    attrs = {"min_sizes": [6.0], "max_sizes": [], "aspect_ratios": ratios,
             "flip": True}
    got, want = check_op("prior_box", ins, attrs, f64=True)
    assert got["Boxes"][0].shape == (3, 3, per_cell, 4)
