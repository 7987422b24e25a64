"""Detection layers of the YOLOv3 and Mask R-CNN slices (counterpart of
paddle_tpu/layers/detection.py; reference fluid/layers/detection.py) over
ops/detection.py and ops/detection_ext.py."""

from __future__ import annotations

from .tensor import _simple


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, name=None):
    return _simple(
        "yolo_box",
        {"X": [x], "ImgSize": [img_size]},
        {"anchors": list(anchors), "class_num": class_num,
         "conf_thresh": conf_thresh, "downsample_ratio": downsample_ratio},
        out_slots=("Boxes", "Scores"),
        stop_gradient=True,
    )


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=16, nms_threshold=0.3, normalized=True,
                   background_label=-1, name=None):
    """background_label: the class column NMS skips (the reference's
    default 0 takes the first column as background; -1, the default
    here, skips none: YOLO heads have no background column)."""
    return _simple(
        "multiclass_nms",
        {"BBoxes": [bboxes], "Scores": [scores]},
        {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
         "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
         "background_label": background_label},
        out_slots=("Out", "NmsRoisNum"),
        stop_gradient=True,
    )


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh=0.7, downsample_ratio=32, gt_score=None,
                use_label_smooth=True, scale_x_y=1.0, name=None):
    """YOLOv3 head loss (detection/yolov3_loss_op.h): per-image loss
    [N]."""
    inputs = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score]
    return _simple(
        "yolov3_loss",
        inputs,
        {
            "anchors": list(anchors),
            "anchor_mask": list(anchor_mask),
            "class_num": class_num,
            "ignore_thresh": ignore_thresh,
            "downsample_ratio": downsample_ratio,
            "use_label_smooth": use_label_smooth,
            "scale_x_y": scale_x_y,
        },
        out_slots=("Loss", "ObjectnessMask", "GTMatchMask"),
    )[0]


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    """RoIAlign: rois [R, 4] in image coordinates (rois_num [N], the
    per-image counts, over a batch of maps) or [B, R, 4]."""
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num]
    return _simple(
        "roi_align", inputs,
        {"pooled_height": pooled_height, "pooled_width": pooled_width,
         "spatial_scale": spatial_scale, "sampling_ratio": sampling_ratio},
    )


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=None, stride=None, offset=0.5, name=None):
    return _simple(
        "anchor_generator",
        {"Input": [input]},
        {"anchor_sizes": list(anchor_sizes or [64.0]),
         "aspect_ratios": list(aspect_ratios or [1.0]),
         "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
         "stride": list(stride or [16.0, 16.0]),
         "offset": offset},
        out_slots=("Anchors", "Variances"),
        stop_gradient=True,
    )


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, name=None):
    """RPN proposals: [N, post_nms_top_n, 4] zero-padded, their probs and
    the live counts [N] (the reference emits LoD rois)."""
    return _simple(
        "generate_proposals",
        {"Scores": [scores], "BboxDeltas": [bbox_deltas],
         "ImInfo": [im_info], "Anchors": [anchors],
         "Variances": [variances]},
        {"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
         "nms_thresh": nms_thresh, "min_size": min_size},
        out_slots=("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
        stop_gradient=True,
    )


def rpn_target_assign(anchor, gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """RPN anchor sampling; fixed-size -1-padded outputs."""
    return _simple(
        "rpn_target_assign",
        {"Anchor": [anchor], "GtBoxes": [gt_boxes],
         "IsCrowd": [is_crowd], "ImInfo": [im_info]},
        {"rpn_batch_size_per_im": rpn_batch_size_per_im,
         "rpn_straddle_thresh": rpn_straddle_thresh,
         "rpn_fg_fraction": rpn_fg_fraction,
         "rpn_positive_overlap": rpn_positive_overlap,
         "rpn_negative_overlap": rpn_negative_overlap},
        out_slots=("LocationIndex", "ScoreIndex", "TargetLabel",
                   "TargetBBox", "BBoxInsideWeight"),
        stop_gradient=True,
    )


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=512,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True,
                             rois_num=None):
    return _simple(
        "generate_proposal_labels",
        {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
         "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
         "ImInfo": [im_info], "RpnRoisNum": [rois_num]},
        {"batch_size_per_im": batch_size_per_im,
         "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
         "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
         "bbox_reg_weights": list(bbox_reg_weights),
         "class_nums": class_nums},
        out_slots=("Rois", "LabelsInt32", "BboxTargets",
                   "BboxInsideWeights", "BboxOutsideWeights", "RoisNum",
                   "MaxOverlapWithGT"),
        stop_gradient=True,
    )


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes=81, resolution=14):
    """Mask targets; gt_segms are dense 0/1 bitmaps [G, H, W] (or [B, G,
    H, W])."""
    return _simple(
        "generate_mask_labels",
        {"ImInfo": [im_info], "GtClasses": [gt_classes],
         "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
         "Rois": [rois], "LabelsInt32": [labels_int32]},
        {"num_classes": num_classes, "resolution": resolution},
        out_slots=("MaskRois", "RoiHasMaskInt32", "MaskInt32"),
        stop_gradient=True,
    )


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None):
    return _simple(
        "distribute_fpn_proposals",
        {"FpnRois": [fpn_rois], "RoisNum": [rois_num]},
        {"min_level": min_level, "max_level": max_level,
         "refer_level": refer_level, "refer_scale": refer_scale},
        out_slots=("MultiFpnRois", "RestoreIndex", "MultiLevelRoIsNum"),
        stop_gradient=True,
    )


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_nums=None):
    return _simple(
        "collect_fpn_proposals",
        {"MultiLevelRois": list(multi_rois),
         "MultiLevelScores": list(multi_scores),
         "MultiLevelRoIsNum": list(rois_nums or [])},
        {"post_nms_topN": post_nms_top_n},
        out_slots=("FpnRois", "RoisNum"),
        stop_gradient=True,
    )


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=4.135):
    return _simple(
        "box_decoder_and_assign",
        {"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
         "TargetBox": [target_box], "BoxScore": [box_score]},
        {"box_clip": box_clip},
        out_slots=("DecodeBox", "OutputAssignBox"),
    )
