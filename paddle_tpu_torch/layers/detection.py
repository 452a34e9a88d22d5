# Copied from the JAX package: paddle_tpu/layers/detection.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Detection layers (reference: python/paddle/fluid/layers/detection.py)."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["iou_similarity", "box_coder", "prior_box", "yolo_box", "roi_align",
           "box_clip", "anchor_generator", "density_prior_box",
           "bipartite_match", "target_assign", "mine_hard_examples",
           "sigmoid_focal_loss", "multiclass_nms", "generate_proposals",
           "roi_pool", "psroi_pool", "polygon_box_transform",
           "box_decoder_and_assign", "collect_fpn_proposals",
           "distribute_fpn_proposals", "rpn_target_assign",
           "retinanet_detection_output", "yolov3_loss",
           "generate_proposal_labels", "generate_mask_labels",
           "roi_perspective_transform",
           "multiclass_nms2", "detection_output", "prroi_pool",
           "deformable_roi_pooling", "ssd_loss", "multi_box_head",
           "retinanet_target_assign"]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    attrs = {"code_type": code_type, "box_normalized": box_normalized, "axis": axis}
    if hasattr(prior_box_var, "name"):
        inputs["PriorBoxVar"] = prior_box_var
    elif isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": out}, attrs=attrs)
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="prior_box", inputs={"Input": input, "Image": image},
                     outputs={"Boxes": boxes, "Variances": var},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios),
                            "variances": list(variance), "flip": flip,
                            "clip": clip, "step_w": steps[0], "step_h": steps[1],
                            "offset": offset})
    return boxes, var


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="yolo_box", inputs={"X": x, "ImgSize": img_size},
                     outputs={"Boxes": boxes, "Scores": scores},
                     attrs={"anchors": list(anchors), "class_num": class_num,
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    return boxes, scores


def roi_align(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
              sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="roi_align", inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="box_clip", inputs={"Input": input, "ImInfo": im_info},
                     outputs={"Output": out})
    return out


def anchor_generator(input, anchor_sizes, aspect_ratios, variance=(0.1, 0.1, 0.2, 0.2),
                     stride=None, offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="anchor_generator", inputs={"Input": input},
                     outputs={"Anchors": anchors, "Variances": var},
                     attrs={"anchor_sizes": list(anchor_sizes),
                            "aspect_ratios": list(aspect_ratios),
                            "variances": list(variance),
                            "stride": list(stride or [16.0, 16.0]),
                            "offset": offset})
    return anchors, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="density_prior_box",
                     inputs={"Input": input, "Image": image},
                     outputs={"Boxes": boxes, "Variances": var},
                     attrs={"densities": list(densities),
                            "fixed_sizes": list(fixed_sizes),
                            "fixed_ratios": list(fixed_ratios),
                            "variances": list(variance), "clip": clip,
                            "step_w": steps[0], "step_h": steps[1],
                            "offset": offset})
    return boxes, var


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int32")
    dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(type="bipartite_match", inputs={"DistMat": dist_matrix},
                     outputs={"ColToRowMatchIndices": idx,
                              "ColToRowMatchDist": dist},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold})
    return idx, dist


def target_assign(input, matched_indices, negative_flag=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    wt = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": input, "MatchIndices": matched_indices}
    if negative_flag is not None:
        inputs["NegFlag"] = negative_flag
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": out, "OutWeight": wt},
                     attrs={"mismatch_value": mismatch_value})
    return out, wt


def mine_hard_examples(cls_loss, match_indices, loc_loss=None,
                       neg_pos_ratio=3.0, neg_overlap=0.5,
                       mining_type="max_negative", name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    neg = helper.create_variable_for_type_inference("int32")
    upd = helper.create_variable_for_type_inference("int32")
    inputs = {"ClsLoss": cls_loss, "MatchIndices": match_indices}
    if loc_loss is not None:
        inputs["LocLoss"] = loc_loss
    helper.append_op(type="mine_hard_examples", inputs=inputs,
                     outputs={"NegFlag": neg, "UpdatedMatchIndices": upd},
                     attrs={"neg_pos_ratio": neg_pos_ratio,
                            "neg_dist_threshold": neg_overlap,
                            "mining_type": mining_type})
    return neg, upd


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25, name=None):
    helper = LayerHelper("sigmoid_focal_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_focal_loss",
                     inputs={"X": x, "Label": label, "FgNum": fg_num},
                     outputs={"Out": out},
                     attrs={"gamma": gamma, "alpha": alpha})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, background_label=0,
                   name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    num = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": bboxes, "Scores": scores},
                     outputs={"Out": out, "NmsRoisNum": num},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": background_label})
    return out, num


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    num = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="generate_proposals",
                     inputs={"Scores": scores, "BboxDeltas": bbox_deltas,
                             "ImInfo": im_info, "Anchors": anchors,
                             "Variances": variances},
                     outputs={"RpnRois": rois, "RpnRoiProbs": probs,
                              "RpnRoisNum": num},
                     attrs={"pre_nms_topN": pre_nms_top_n,
                            "post_nms_topN": post_nms_top_n,
                            "nms_thresh": nms_thresh, "min_size": min_size})
    return rois, probs, num


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="roi_pool", inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="psroi_pool", inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out},
                     attrs={"output_channels": output_channels,
                            "spatial_scale": spatial_scale,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="polygon_box_transform", inputs={"Input": input},
                     outputs={"Output": out})
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=None, name=None):
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decode = helper.create_variable_for_type_inference(target_box.dtype)
    assign = helper.create_variable_for_type_inference(target_box.dtype)
    helper.append_op(type="box_decoder_and_assign",
                     inputs={"PriorBox": prior_box,
                             "PriorBoxVar": prior_box_var,
                             "TargetBox": target_box, "BoxScore": box_score},
                     outputs={"DecodeBox": decode,
                              "OutputAssignBox": assign})
    return decode, assign


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None,
                          rois_num_per_level=None):
    """When per-level inputs are zero-padded (the static-shape
    generate_proposals convention), pass rois_num_per_level (each [N]
    int32) so padded rows are excluded; returns (fpn_rois, rois_num)
    in that case, else fpn_rois alone (reference 1.6 signature)."""
    helper = LayerHelper("collect_fpn_proposals", name=name)
    out = helper.create_variable_for_type_inference(multi_rois[0].dtype)
    num = helper.create_variable_for_type_inference("int32")
    inputs = {"MultiLevelRois": multi_rois,
              "MultiLevelScores": multi_scores}
    if rois_num_per_level:
        inputs["MultiLevelRoisNum"] = rois_num_per_level
    helper.append_op(type="collect_fpn_proposals",
                     inputs=inputs,
                     outputs={"FpnRois": out, "RoisNum": num},
                     attrs={"post_nms_topN": post_nms_top_n})
    return (out, num) if rois_num_per_level else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    n_lvl = max_level - min_level + 1
    rois = [helper.create_variable_for_type_inference(fpn_rois.dtype)
            for _ in range(n_lvl)]
    masks = [helper.create_variable_for_type_inference("int32")
             for _ in range(n_lvl)]
    restore = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="distribute_fpn_proposals",
                     inputs={"FpnRois": fpn_rois},
                     outputs={"MultiFpnRois": rois,
                              "MultiLevelMask": masks,
                              "RestoreIndex": restore},
                     attrs={"min_level": min_level, "max_level": max_level,
                            "refer_level": refer_level,
                            "refer_scale": refer_scale})
    return rois, restore


def rpn_target_assign(anchor, gt_boxes, rpn_batch_size_per_im=256,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True, name=None):
    helper = LayerHelper("rpn_target_assign", name=name)
    loc = helper.create_variable_for_type_inference("int32")
    score = helper.create_variable_for_type_inference("int32")
    tbox = helper.create_variable_for_type_inference(anchor.dtype)
    tlabel = helper.create_variable_for_type_inference("int32")
    bw = helper.create_variable_for_type_inference(anchor.dtype)
    helper.append_op(type="rpn_target_assign",
                     inputs={"Anchor": anchor, "GtBoxes": gt_boxes},
                     outputs={"LocationIndex": loc, "ScoreIndex": score,
                              "TargetBBox": tbox, "TargetLabel": tlabel,
                              "BBoxInsideWeight": bw},
                     attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
                            "rpn_fg_fraction": rpn_fg_fraction,
                            "rpn_positive_overlap": rpn_positive_overlap,
                            "rpn_negative_overlap": rpn_negative_overlap,
                            "use_random": use_random})
    return loc, score, tbox, tlabel, bw


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0, name=None):
    helper = LayerHelper("retinanet_detection_output", name=name)
    out = helper.create_variable_for_type_inference(bboxes[0].dtype)
    num = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="retinanet_detection_output",
                     inputs={"BBoxes": bboxes, "Scores": scores,
                             "Anchors": anchors, "ImInfo": im_info},
                     outputs={"Out": out, "NmsRoisNum": num},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold})
    return out, num


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    objm = helper.create_variable_for_type_inference(x.dtype)
    gtm = helper.create_variable_for_type_inference("int32")
    inputs = {"X": x, "GTBox": gt_box, "GTLabel": gt_label}
    if gt_score is not None:
        inputs["GTScore"] = gt_score
    helper.append_op(type="yolov3_loss", inputs=inputs,
                     outputs={"Loss": loss, "ObjectnessMask": objm,
                              "GTMatchMask": gtm},
                     attrs={"anchors": list(anchors),
                            "anchor_mask": list(anchor_mask),
                            "class_num": class_num,
                            "ignore_thresh": ignore_thresh,
                            "downsample_ratio": downsample_ratio,
                            "use_label_smooth": use_label_smooth})
    return loss


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True, name=None):
    helper = LayerHelper("generate_proposal_labels", name=name)
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    tgts = helper.create_variable_for_type_inference(rpn_rois.dtype)
    inw = helper.create_variable_for_type_inference(rpn_rois.dtype)
    outw = helper.create_variable_for_type_inference(rpn_rois.dtype)
    inputs = {"RpnRois": rpn_rois, "GtBoxes": gt_boxes,
              "GtClasses": gt_classes}
    if is_crowd is not None:
        inputs["IsCrowd"] = is_crowd
    helper.append_op(type="generate_proposal_labels",
                     inputs=inputs,
                     outputs={"Rois": rois, "LabelsInt32": labels,
                              "BboxTargets": tgts,
                              "BboxInsideWeights": inw,
                              "BboxOutsideWeights": outw},
                     attrs={"batch_size_per_im": batch_size_per_im,
                            "fg_fraction": fg_fraction,
                            "fg_thresh": fg_thresh,
                            "bg_thresh_hi": bg_thresh_hi,
                            "bg_thresh_lo": bg_thresh_lo,
                            "bbox_reg_weights": list(bbox_reg_weights),
                            "class_nums": class_nums,
                            "use_random": use_random})
    return rois, labels, tgts, inw, outw


def generate_mask_labels(gt_segms, rois, labels_int32, matched_gts,
                         resolution=14, name=None):
    """TPU-native contract: gt_segms are dense [G,H,W] bitmaps (the
    reference rasterizes COCO polygons on the host first)."""
    helper = LayerHelper("generate_mask_labels", name=name)
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="generate_mask_labels",
                     inputs={"GtSegms": gt_segms, "Rois": rois,
                             "LabelsInt32": labels_int32,
                             "MatchedGts": matched_gts},
                     outputs={"MaskInt32": mask},
                     attrs={"resolution": resolution})
    return mask


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              name=None):
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="roi_perspective_transform",
                     inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out},
                     attrs={"transformed_height": transformed_height,
                            "transformed_width": transformed_width,
                            "spatial_scale": spatial_scale})
    return out


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, background_label=0,
                    return_index=False, name=None):
    """reference: detection.py `multiclass_nms2` — multiclass_nms that
    can also return the selected-box Index ([N, keep, 1], row into the
    batch-flattened boxes, -1 padding)."""
    helper = LayerHelper("multiclass_nms2", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    num = helper.create_variable_for_type_inference("int32")
    index = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": bboxes, "Scores": scores},
                     outputs={"Out": out, "NmsRoisNum": num,
                              "Index": index},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": background_label})
    if return_index:
        return out, index
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """reference: detection.py:516 `detection_output` — decode SSD loc
    predictions against the priors (decode_center_size) then
    multiclass NMS. loc [N,P,4], scores [N,P,C] (post-softmax),
    priors [P,4]."""
    helper = LayerHelper("detection_output")
    decoded = helper.create_variable_for_type_inference(loc.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": prior_box,
                             "PriorBoxVar": prior_box_var,
                             "TargetBox": loc},
                     outputs={"OutputBox": decoded},
                     attrs={"code_type": "decode_center_size",
                            "axis": 0, "box_normalized": True})
    from .nn import transpose

    scores_t = transpose(scores, perm=[0, 2, 1])   # [N, C, P]
    return multiclass_nms2(decoded, scores_t,
                           score_threshold=score_threshold,
                           nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                           nms_threshold=nms_threshold,
                           background_label=background_label,
                           return_index=return_index)


def prroi_pool(input, rois, output_channels=None, spatial_scale=1.0,
               pooled_height=1, pooled_width=1, name=None):
    """reference: detection.py `prroi_pool` → prroi_pool op (precise
    integral RoI pooling)."""
    helper = LayerHelper("prroi_pool", name=name)
    oc = output_channels or (
        input.shape[1] // (pooled_height * pooled_width))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="prroi_pool",
                     inputs={"X": input, "ROIs": rois},
                     outputs={"Out": out},
                     attrs={"spatial_scale": float(spatial_scale),
                            "output_channels": int(oc),
                            "pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width)})
    return out


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1,
                           part_size=None, sample_per_part=1,
                           trans_std=0.1, position_sensitive=False,
                           name=None):
    """reference: detection.py `deformable_roi_pooling` →
    deformable_psroi_pooling op."""
    helper = LayerHelper("deformable_roi_pooling", name=name)
    part = part_size or (pooled_height, pooled_width)
    out_dim = input.shape[1] if not position_sensitive else \
        input.shape[1] // (group_size[0] * group_size[1])
    out = helper.create_variable_for_type_inference(input.dtype)
    cnt = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": input, "ROIs": rois}
    if not no_trans:
        inputs["Trans"] = trans
    helper.append_op(type="deformable_psroi_pooling", inputs=inputs,
                     outputs={"Output": out, "TopCount": cnt},
                     attrs={"no_trans": no_trans,
                            "spatial_scale": float(spatial_scale),
                            "output_dim": int(out_dim),
                            "group_size": [int(g) for g in group_size],
                            "pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width),
                            "part_size": [int(v) for v in part],
                            "sample_per_part": int(sample_per_part),
                            "trans_std": float(trans_std)})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None):
    """reference: detection.py:1389 `ssd_loss` → fused ssd_loss op
    (static shapes: gt_box [N,G,4] zero-padded, gt_label [N,G] with -1
    pads). Returns the [N, P] per-prior weighted loss."""
    if mining_type != "max_negative":
        raise ValueError(
            "ssd_loss: only mining_type='max_negative' is supported "
            "(the reference raises for anything else too)")
    helper = LayerHelper("ssd_loss")
    loss = helper.create_variable_for_type_inference(location.dtype)
    inputs = {"Location": location, "Confidence": confidence,
              "GtBox": gt_box, "GtLabel": gt_label,
              "PriorBox": prior_box}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = prior_box_var
    helper.append_op(type="ssd_loss", inputs=inputs,
                     outputs={"Loss": loss},
                     attrs={"background_label": background_label,
                            "overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio,
                            "neg_overlap": neg_overlap,
                            "loc_loss_weight": loc_loss_weight,
                            "conf_loss_weight": conf_loss_weight,
                            "match_type": match_type,
                            "normalize": normalize})
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """reference: detection.py:1880 `multi_box_head` — the SSD head: per
    feature map, conv out loc [N,P_i,4] + conf [N,P_i,C] and prior boxes;
    concatenated over maps. Returns (mbox_locs, mbox_confs, boxes, vars).
    """
    from .nn import conv2d, reshape, transpose
    from .tensor import concat

    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio schedule (detection.py:2006)
        min_sizes, max_sizes = [], []
        # reference divides by (n_layer - 2) — SSD uses >=3 maps;
        # guard the 2-map case to an even split
        step = int((max_ratio - min_ratio) / max(n_layer - 2, 1))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i]
        if steps:
            steps_i = (steps[i], steps[i])
        else:
            steps_i = ((step_w[i] if step_w else 0.0),
                       (step_h[i] if step_h else 0.0))
        box, var = prior_box(
            feat, image,
            min_sizes=mins if isinstance(mins, (list, tuple)) else [mins],
            max_sizes=(maxs if isinstance(maxs, (list, tuple))
                       else ([maxs] if maxs else None)),
            aspect_ratios=(ar if isinstance(ar, (list, tuple)) else [ar]),
            variance=list(variance), flip=flip, clip=clip,
            steps=steps_i, offset=offset)
        # priors per feature-map cell drive the conv head widths
        n_per_cell = int(np.prod(box.shape[:-1])) // (
            int(feat.shape[2]) * int(feat.shape[3]))
        loc = conv2d(feat, n_per_cell * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(feat, n_per_cell * num_classes, kernel_size,
                      stride=stride, padding=pad)
        loc = reshape(transpose(loc, perm=[0, 2, 3, 1]),
                      shape=[0, -1, 4])
        conf = reshape(transpose(conf, perm=[0, 2, 3, 1]),
                       shape=[0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_l.append(reshape(box, shape=[-1, 4]))
        vars_l.append(reshape(var, shape=[-1, 4]))
    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    boxes = concat(boxes_l, axis=0)
    variances = concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """reference: detection.py:64 `retinanet_target_assign` →
    retinanet_target_assign op; returns the gathered
    (score_pred, loc_pred, score_tgt, loc_tgt, bbox_weight, fg_num)
    sextuple like the reference."""
    from .nn import gather, reshape

    helper = LayerHelper("retinanet_target_assign")
    outs = {k: helper.create_variable_for_type_inference(dt)
            for k, dt in [("LocationIndex", "int32"),
                          ("ScoreIndex", "int32"),
                          ("TargetLabel", "int32"),
                          ("TargetBBox", anchor_box.dtype),
                          ("BBoxInsideWeight", anchor_box.dtype),
                          ("ForegroundNumber", "int32")]}
    helper.append_op(type="retinanet_target_assign",
                     inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes,
                             "GtLabels": gt_labels, "IsCrowd": is_crowd,
                             "ImInfo": im_info},
                     outputs=outs,
                     attrs={"positive_overlap": positive_overlap,
                            "negative_overlap": negative_overlap})
    loc_idx = outs["LocationIndex"]
    score_idx = outs["ScoreIndex"]
    pred_loc = gather(reshape(bbox_pred, shape=[-1, 4]), loc_idx)
    pred_score = gather(reshape(cls_logits, shape=[-1, num_classes]),
                        score_idx)
    return (pred_score, pred_loc, outs["TargetLabel"],
            outs["TargetBBox"], outs["BBoxInsideWeight"],
            outs["ForegroundNumber"])
