"""Detection layers of the YOLOv3 slice (counterpart of
paddle_tpu/layers/detection.py; reference fluid/layers/detection.py) over
ops/detection.py."""

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
