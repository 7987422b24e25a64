"""YOLOv3: the DarkNet-53 backbone and three-scale FPN heads, the
detection flagship (counterpart of paddle_tpu/models/yolov3.py; ops from
operators/detection/yolov3_loss_op.h and yolo_box_op.cc, topology from
the YOLOv3 paper). Built on the public layers API only, with the JAX
package's parameter names, so a state carries across by name. NCHW at the
API; the convolutions run through F.conv2d and batch norm through the JAX
package's formula (ops/nn.py).

`yolov3_train` returns the summed three-scale loss; `yolov3_infer` decodes
every head with yolo_box and merges them through multiclass_nms. `scale`
shrinks every channel count (scale=1 is the paper's model: 53
convolutions in the backbone, 255-channel heads for COCO's 80 classes).
"""

from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

# the paper's anchors (COCO, 416 input); mask [6, 7, 8] is the coarsest,
# stride-32 head
DEFAULT_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                   59, 119, 116, 90, 156, 198, 373, 326]
DEFAULT_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class YoloConfig:
    def __init__(self, class_num=80, anchors=None, anchor_masks=None,
                 scale=1.0, ignore_thresh=0.7, use_label_smooth=True):
        self.class_num = class_num
        self.anchors = list(anchors or DEFAULT_ANCHORS)
        self.anchor_masks = [list(m) for m in
                             (anchor_masks or DEFAULT_ANCHOR_MASKS)]
        if not 1 <= len(self.anchor_masks) <= 3:
            raise ValueError("anchor_masks: 1-3 scales supported "
                             "(heads start at stride 32 and halve)")
        self.scale = float(scale)
        self.ignore_thresh = ignore_thresh
        self.use_label_smooth = use_label_smooth

    def ch(self, n):
        return max(4, int(n * self.scale))

    @classmethod
    def tiny(cls, class_num=4):
        """The 1/8-width model for CPU tests and dry runs."""
        return cls(class_num=class_num, scale=0.125)


def _cbl(x, ch, k, stride, prefix):
    """conv, batch norm, leaky_relu: the DarkNet unit."""
    x = layers.conv2d(
        x, ch, k, stride=stride, padding=(k - 1) // 2, bias_attr=False,
        param_attr=ParamAttr(name=f"{prefix}_w"),
    )
    return layers.batch_norm(
        x, act="leaky_relu",
        param_attr=ParamAttr(name=f"{prefix}_bn_s"),
        bias_attr=ParamAttr(name=f"{prefix}_bn_b"),
        moving_mean_name=f"{prefix}_bn_m",
        moving_variance_name=f"{prefix}_bn_v",
    )


def _res_block(x, ch, prefix):
    """A 1x1 bottleneck and a 3x3, added to the input (DarkNet-53's
    block)."""
    s = _cbl(x, ch // 2, 1, 1, f"{prefix}_a")
    s = _cbl(s, ch, 3, 1, f"{prefix}_b")
    return x + s


def darknet53(img, cfg, prefix="dark"):
    """The backbone; returns the C3, C4, C5 maps (strides 8, 16, 32)."""
    depths = (1, 2, 8, 8, 4)
    x = _cbl(img, cfg.ch(32), 3, 1, f"{prefix}_stem")
    feats = []
    ch = 32
    for stage, blocks in enumerate(depths):
        ch *= 2
        x = _cbl(x, cfg.ch(ch), 3, 2, f"{prefix}_down{stage}")
        for b in range(blocks):
            x = _res_block(x, cfg.ch(ch), f"{prefix}_s{stage}b{b}")
        if stage >= 2:
            feats.append(x)
    return feats


def _detection_block(x, ch, prefix):
    """The 5-convolution block; returns (the route to the next scale, the
    head's input)."""
    for i in range(2):
        x = _cbl(x, ch, 1, 1, f"{prefix}_r{i}a")
        x = _cbl(x, ch * 2, 3, 1, f"{prefix}_r{i}b")
    route = _cbl(x, ch, 1, 1, f"{prefix}_route")
    tip = _cbl(route, ch * 2, 3, 1, f"{prefix}_tip")
    return route, tip


def yolov3_heads(img, cfg, prefix="yolo"):
    """Backbone and FPN neck; returns the raw heads [stride 32, 16, 8],
    each [N, M*(5+C), H, W]."""
    c3, c4, c5 = darknet53(img, cfg, prefix=f"{prefix}_dark")
    outputs = []
    route = None
    scales = [c5, c4, c3][: len(cfg.anchor_masks)]
    for i, feat in enumerate(scales):
        if route is not None:
            route = _cbl(route, cfg.ch(256 // (2 ** (i - 1))), 1, 1,
                         f"{prefix}_lat{i}")
            route = layers.resize_nearest(route, scale=2.0)
            feat = layers.concat([route, feat], axis=1)
        route, tip = _detection_block(
            feat, cfg.ch(512 // (2 ** i)), f"{prefix}_det{i}"
        )
        n_out = len(cfg.anchor_masks[i]) * (5 + cfg.class_num)
        outputs.append(
            layers.conv2d(
                tip, n_out, 1,
                param_attr=ParamAttr(name=f"{prefix}_head{i}_w"),
                bias_attr=ParamAttr(name=f"{prefix}_head{i}_b"),
            )
        )
    return outputs


def yolov3_train(img, gt_box, gt_label, cfg, gt_score=None, prefix="yolo"):
    """The batch mean of each scale's yolov3_loss, summed over scales."""
    heads = yolov3_heads(img, cfg, prefix=prefix)
    losses = []
    for i, head in enumerate(heads):
        per_image = layers.yolov3_loss(
            head, gt_box, gt_label,
            anchors=cfg.anchors,
            anchor_mask=cfg.anchor_masks[i],
            class_num=cfg.class_num,
            ignore_thresh=cfg.ignore_thresh,
            downsample_ratio=32 // (2 ** i),
            gt_score=gt_score,
            use_label_smooth=cfg.use_label_smooth,
        )
        losses.append(layers.reduce_mean(per_image))
    total = losses[0]
    for extra in losses[1:]:
        total = total + extra
    return total


def yolov3_infer(img, img_size, cfg, prefix="yolo",
                 conf_thresh=0.01, nms_thresh=0.45, keep_top_k=100):
    """Decode and NMS: returns ([N, keep_top_k, 6] rows (label, score, x0,
    y0, x1, y1), the valid counts [N])."""
    heads = yolov3_heads(img, cfg, prefix=prefix)
    boxes, scores = [], []
    for i, head in enumerate(heads):
        masked_anchors = []
        for a in cfg.anchor_masks[i]:
            masked_anchors += cfg.anchors[2 * a:2 * a + 2]
        b, s = layers.yolo_box(
            head, img_size, anchors=masked_anchors,
            class_num=cfg.class_num, conf_thresh=conf_thresh,
            downsample_ratio=32 // (2 ** i),
        )
        boxes.append(b)
        scores.append(layers.transpose(s, [0, 2, 1]))
    return layers.multiclass_nms(
        layers.concat(boxes, axis=1),
        layers.concat(scores, axis=2),
        score_threshold=conf_thresh,
        nms_threshold=nms_thresh,
        keep_top_k=keep_top_k,
    )
