"""Mask R-CNN: ResNet-FPN backbone, RPN, Fast R-CNN box head, mask head
(counterpart of paddle_tpu/models/mask_rcnn.py; the PaddleCV Mask R-CNN
config named in BASELINE.json, on the reference ops rpn_target_assign,
generate_proposals, generate_proposal_labels, generate_mask_labels,
distribute_fpn_proposals, collect_fpn_proposals and roi_align).

Every stage emits fixed-size tensors with -1 or 0 padding and live
counts, so the step is one static-shape program that reads nothing back
on the host: the RPN losses gather the sampled anchors, the head losses
mask by label validity. GtSegms are dense bitmaps a gt (rasterising is
the data pipeline's job).

Two training graphs, as in the JAX package:

* ``mask_rcnn_train``: the legacy one-image graph (the reference's LoD
  image walk); B images take B unrolled copies of every detection op.
* ``mask_rcnn_train_batched``: images [B, 3, H, W] go through the conv
  tower, the heads and the detection ops' [B, ...] forms as one wide op
  each, with a fixed RoI cap an image. Losses are normalised per image
  and then averaged, so at B=1 it gives the legacy graph's losses.

``batched_detection_enabled()`` reads PADDLE_TPU_BATCHED_DETECTION
(default on), by which bench.py picks its leg.
"""

from __future__ import annotations

import os

from .. import layers
from ..initializer import Normal
from ..layers import detection as det
from ..param_attr import ParamAttr


def batched_detection_enabled():
    """Env/config knob for the batched vs legacy per-image detection path
    (PADDLE_TPU_BATCHED_DETECTION, default on). The ops themselves
    dispatch on input rank; this only selects which graph builders and
    bench legs construct."""
    return os.environ.get(
        "PADDLE_TPU_BATCHED_DETECTION", "1"
    ).lower() not in ("0", "false", "off")


def _head_attr(std=0.01):
    """Detectron-style head init: small normal keeps initial RPN deltas and
    class logits near zero (Xavier on unnormalized FPN features otherwise
    emits O(30) deltas and the reg loss explodes)."""
    return ParamAttr(initializer=Normal(0.0, std))


class MaskRCNNConfig:
    def __init__(self, class_num=81, fpn_ch=256, resolution=14,
                 anchor_sizes=(32, 64, 128, 256), scale=1.0,
                 rpn_pre_nms=2000, rpn_post_nms=256,
                 batch_size_per_im=64, depth=50):
        self.class_num = class_num
        self.fpn_ch = max(8, int(fpn_ch * scale))
        self.resolution = resolution
        self.anchor_sizes = list(anchor_sizes)
        self.aspect_ratios = [0.5, 1.0, 2.0]
        self.scale = scale
        self.rpn_pre_nms = rpn_pre_nms
        self.rpn_post_nms = rpn_post_nms
        self.batch_size_per_im = batch_size_per_im
        self.depth = depth
        self.min_level, self.max_level = 2, 5

    def ch(self, n):
        return max(4, int(n * self.scale))

    @classmethod
    def tiny(cls, class_num=4):
        """1/8-width model on a shallow backbone for CPU tests/dry-runs."""
        return cls(class_num=class_num, scale=0.125, rpn_pre_nms=64,
                   rpn_post_nms=16, batch_size_per_im=16, resolution=7,
                   depth=18)


def _conv_bn(x, ch, k, stride, act, is_test, name):
    y = layers.conv2d(x, ch, k, stride=stride, padding=(k - 1) // 2,
                      bias_attr=False)
    return layers.batch_norm(y, act=act, is_test=is_test)


def resnet_fpn_backbone(image, cfg, is_test=False):
    """C2..C5 from a ResNet trunk, laterals + top-down into P2..P5."""
    blocks = {18: [2, 2, 2, 2], 50: [3, 4, 6, 3]}[cfg.depth]
    x = _conv_bn(image, cfg.ch(64), 7, 2, "relu", is_test, "stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    cs = []
    widths = [cfg.ch(64), cfg.ch(128), cfg.ch(256), cfg.ch(512)]
    for stage, n in enumerate(blocks):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            y = _conv_bn(x, widths[stage], 3, stride, "relu", is_test,
                         f"s{stage}b{i}a")
            y = _conv_bn(y, widths[stage], 3, 1, None, is_test,
                         f"s{stage}b{i}b")
            if x.shape[1] != widths[stage] or stride != 1:
                x = _conv_bn(x, widths[stage], 1, stride, None, is_test,
                             f"s{stage}b{i}s")
            x = layers.relu(y + x)
        cs.append(x)
    # FPN top-down (fpn in the reference's PaddleCV config)
    laterals = [layers.conv2d(c, cfg.fpn_ch, 1) for c in cs]  # C2..C5
    ps = [None] * 4
    ps[3] = laterals[3]
    for i in (2, 1, 0):
        up = layers.resize_nearest(ps[i + 1], scale=2.0)
        ps[i] = laterals[i] + up
    ps = [layers.conv2d(p, cfg.fpn_ch, 3, padding=1) for p in ps]
    return ps  # [P2, P3, P4, P5], strides 4, 8, 16, 32


def rpn_heads(ps, cfg):
    """Shared RPN head over FPN levels: per level (scores, deltas,
    anchors, variances)."""
    outs = []
    A = len(cfg.aspect_ratios)
    for lvl, p in enumerate(ps):
        h = layers.conv2d(p, cfg.fpn_ch, 3, padding=1, act="relu",
                          param_attr=_head_attr())
        scores = layers.conv2d(h, A, 1, act="sigmoid",
                               param_attr=_head_attr())
        deltas = layers.conv2d(h, 4 * A, 1, param_attr=_head_attr(0.001))
        anchors, variances = det.anchor_generator(
            p,
            anchor_sizes=[cfg.anchor_sizes[lvl]],
            aspect_ratios=cfg.aspect_ratios,
            stride=[2 ** (lvl + 2), 2 ** (lvl + 2)],
        )
        outs.append((scores, deltas, anchors, variances))
    return outs


def _rpn_losses(rpn_outs, gt_boxes, is_crowd, im_info, cfg):
    """Concat all levels' anchors/scores/deltas, one target assignment."""
    all_scores, all_deltas, all_anchors = [], [], []
    for scores, deltas, anchors, _ in rpn_outs:
        A = len(cfg.aspect_ratios)
        s = layers.reshape(layers.transpose(scores, [0, 2, 3, 1]), [-1, 1])
        d = layers.reshape(layers.transpose(deltas, [0, 2, 3, 1]), [-1, 4])
        a = layers.reshape(anchors, [-1, 4])
        all_scores.append(s)
        all_deltas.append(d)
        all_anchors.append(a)
    scores = layers.concat(all_scores, axis=0)  # [A_tot, 1]
    deltas = layers.concat(all_deltas, axis=0)  # [A_tot, 4]
    anchors = layers.concat(all_anchors, axis=0)  # [A_tot, 4]

    loc_idx, score_idx, tgt_label, tgt_bbox, bbox_w = det.rpn_target_assign(
        anchors, gt_boxes, is_crowd=is_crowd, im_info=im_info,
        rpn_batch_size_per_im=cfg.batch_size_per_im,
    )
    # sampled-score CE: gather(scores, score_idx), -1 rows masked
    samp_score = layers.gather(scores, layers.relu(score_idx))
    label_f = layers.cast(tgt_label, "float32")
    valid = layers.cast(
        layers.greater_equal(
            layers.cast(tgt_label, "float32"),
            layers.fill_constant([1], "float32", 0.0),
        ),
        "float32",
    )
    eps = 1e-6
    p = layers.clip(samp_score, eps, 1.0 - eps)
    ce = (0.0 - (label_f * layers.log(p)
                 + (1.0 - label_f) * layers.log(1.0 - p))) * valid
    cls_loss = layers.reduce_sum(ce) / (layers.reduce_sum(valid) + 1.0)

    samp_delta = layers.gather(deltas, layers.relu(loc_idx))
    reg_valid = layers.reshape(
        layers.cast(
            layers.greater_equal(
                layers.cast(loc_idx, "float32"),
                layers.fill_constant([1], "float32", 0.0),
            ),
            "float32",
        ),
        [-1, 1],
    )
    diff = (samp_delta - tgt_bbox) * bbox_w
    reg = layers.reduce_sum(layers.abs(diff), dim=1, keep_dim=True)
    reg_loss = layers.reduce_sum(reg * reg_valid) / (
        layers.reduce_sum(reg_valid) + 1.0
    )
    return cls_loss, reg_loss


def _fpn_roi_extract(ps, rois, cfg, resolution):
    """distribute rois over levels, roi_align each, restore order."""
    multi_rois, restore, _nums = det.distribute_fpn_proposals(
        rois, cfg.min_level, cfg.max_level, 4, 224,
    )
    feats = []
    for lvl, (p, r) in enumerate(zip(ps, multi_rois)):
        f = det.roi_align(
            p, r, pooled_height=resolution, pooled_width=resolution,
            spatial_scale=1.0 / (2 ** (lvl + 2)), sampling_ratio=2,
        )
        feats.append(f)
    stacked = layers.concat(feats, axis=0)  # level-major order
    # restore[i] = packed position of input roi i (-1 for dead rois ->
    # gather clamps to row 0; dead rows are masked by the losses)
    return layers.gather(stacked, layers.relu(restore))


def box_head(feat, cfg):
    flat = layers.reshape(feat, [feat.shape[0], -1])
    h = layers.fc(flat, cfg.ch(1024), act="relu", param_attr=_head_attr())
    h = layers.fc(h, cfg.ch(1024), act="relu", param_attr=_head_attr())
    cls_score = layers.fc(h, cfg.class_num, param_attr=_head_attr())
    bbox_pred = layers.fc(h, 4 * cfg.class_num, param_attr=_head_attr(0.001))
    return cls_score, bbox_pred


def mask_head(feat, cfg):
    h = feat
    for _ in range(4):
        h = layers.conv2d(h, cfg.fpn_ch, 3, padding=1, act="relu")
    h = layers.conv2d_transpose(h, cfg.fpn_ch, 2, stride=2, act="relu")
    return layers.conv2d(h, cfg.class_num, 1)  # [R, C, 2M, 2M] logits


def mask_rcnn_train(image, gt_boxes, gt_classes, is_crowd, gt_segms,
                    im_info, cfg=None):
    """One-image train graph; returns (total, rpn_cls, rpn_reg, head_cls,
    head_reg, mask) losses."""
    cfg = cfg or MaskRCNNConfig()
    ps = resnet_fpn_backbone(image, cfg, is_test=False)
    rpn_outs = rpn_heads(ps, cfg)
    rpn_cls_loss, rpn_reg_loss = _rpn_losses(
        rpn_outs, gt_boxes, is_crowd, im_info, cfg
    )

    # proposals per level -> collect
    lvl_rois, lvl_scores, lvl_nums = [], [], []
    for scores, deltas, anchors, variances in rpn_outs:
        rois, probs, nums = det.generate_proposals(
            scores, deltas, im_info, anchors, variances,
            pre_nms_top_n=cfg.rpn_pre_nms, post_nms_top_n=cfg.rpn_post_nms,
            nms_thresh=0.7, min_size=0.0,
        )
        lvl_rois.append(layers.reshape(rois, [-1, 4]))
        lvl_scores.append(layers.reshape(probs, [-1, 1]))
        lvl_nums.append(nums)
    rois, rois_num = det.collect_fpn_proposals(
        lvl_rois, lvl_scores, cfg.min_level, cfg.max_level,
        post_nms_top_n=cfg.rpn_post_nms, rois_nums=lvl_nums,
    )

    (rois, labels, bbox_targets, bbox_iw, bbox_ow, _num,
     _ov) = det.generate_proposal_labels(
        rois, gt_classes, is_crowd, gt_boxes, im_info,
        batch_size_per_im=cfg.batch_size_per_im,
        class_nums=cfg.class_num,
    )

    feat = _fpn_roi_extract(ps, rois, cfg, cfg.resolution)
    cls_score, bbox_pred = box_head(feat, cfg)

    valid = layers.cast(
        layers.greater_equal(
            layers.cast(labels, "float32"),
            layers.fill_constant([1], "float32", 0.0),
        ),
        "float32",
    )
    cls_loss_all = layers.softmax_with_cross_entropy(
        cls_score, layers.relu(labels)
    )
    head_cls_loss = layers.reduce_sum(cls_loss_all * valid) / (
        layers.reduce_sum(valid) + 1.0
    )
    diff = (bbox_pred - bbox_targets) * bbox_iw
    head_reg_loss = layers.reduce_sum(
        layers.reduce_sum(layers.abs(diff), dim=1, keep_dim=True) * valid
    ) / (layers.reduce_sum(valid) + 1.0)

    # mask branch on the sampled roi set
    mask_rois, has_mask, mask_targets = det.generate_mask_labels(
        im_info, gt_classes, is_crowd, gt_segms, rois, labels,
        num_classes=cfg.class_num, resolution=cfg.resolution,
    )
    mfeat = _fpn_roi_extract(ps, mask_rois, cfg, cfg.resolution)
    mlogits = mask_head(mfeat, cfg)  # [R, C, 2M, 2M]
    mlogits = layers.pool2d(mlogits, pool_size=2, pool_stride=2,
                            pool_type="avg")  # back to [R, C, M, M]
    mlogits = layers.reshape(
        mlogits, [mlogits.shape[0], cfg.class_num * cfg.resolution ** 2]
    )
    mtgt = layers.cast(mask_targets, "float32")
    mvalid = layers.cast(
        layers.greater_equal(mtgt, layers.fill_constant([1], "float32", 0.0)),
        "float32",
    )
    mce = layers.sigmoid_cross_entropy_with_logits(mlogits, layers.relu(mtgt))
    mask_loss = layers.reduce_sum(mce * mvalid) / (
        layers.reduce_sum(mvalid) + 1.0
    )

    total = (rpn_cls_loss + rpn_reg_loss + head_cls_loss + head_reg_loss
             + mask_loss)
    return total, rpn_cls_loss, rpn_reg_loss, head_cls_loss, head_reg_loss, \
        mask_loss


# ---------------------------------------------------------------------------
# cross-image batched train path
# ---------------------------------------------------------------------------


def _per_image_mean(num, den):
    """mean_b(num_b / (den_b + 1)): the per-image-normalized loss
    reduction. num/den are [B]; matches the legacy single-image
    sum/(count+1) exactly at B=1."""
    return layers.reduce_mean(
        layers.elementwise_div(num, layers.scale(den, bias=1.0))
    )


def _rpn_losses_batched(rpn_outs, gt_boxes, is_crowd, im_info, cfg, B):
    """Batched RPN losses: anchors stay [A_tot, 4] (shared across images),
    scores/deltas carry [B, A_tot, ...], one batched target assignment
    emits per-image sampled indices gathered with take_along_axis."""
    all_scores, all_deltas, all_anchors = [], [], []
    for scores, deltas, anchors, _ in rpn_outs:
        s = layers.reshape(layers.transpose(scores, [0, 2, 3, 1]),
                           [B, -1, 1])
        d = layers.reshape(layers.transpose(deltas, [0, 2, 3, 1]),
                           [B, -1, 4])
        a = layers.reshape(anchors, [-1, 4])
        all_scores.append(s)
        all_deltas.append(d)
        all_anchors.append(a)
    scores = layers.concat(all_scores, axis=1)  # [B, A_tot, 1]
    deltas = layers.concat(all_deltas, axis=1)  # [B, A_tot, 4]
    anchors = layers.concat(all_anchors, axis=0)  # [A_tot, 4]

    loc_idx, score_idx, tgt_label, tgt_bbox, bbox_w = det.rpn_target_assign(
        anchors, gt_boxes, is_crowd=is_crowd, im_info=im_info,
        rpn_batch_size_per_im=cfg.batch_size_per_im,
    )  # [B, fg_cap] / [B, S] / [B, S, 1] / [B, fg_cap, 4] / [B, fg_cap, 4]
    S = score_idx.shape[1]
    samp_score = layers.take_along_axis(
        scores, layers.reshape(layers.relu(score_idx), [B, S, 1]), axis=1
    )  # [B, S, 1]
    label_f = layers.cast(tgt_label, "float32")
    valid = layers.cast(
        layers.greater_equal(
            label_f, layers.fill_constant([1], "float32", 0.0)
        ),
        "float32",
    )
    eps = 1e-6
    p = layers.clip(samp_score, eps, 1.0 - eps)
    ce = (0.0 - (label_f * layers.log(p)
                 + (1.0 - label_f) * layers.log(1.0 - p))) * valid
    cls_loss = _per_image_mean(
        layers.reduce_sum(ce, dim=[1, 2]),
        layers.reduce_sum(valid, dim=[1, 2]),
    )

    F = loc_idx.shape[1]
    samp_delta = layers.take_along_axis(
        deltas, layers.reshape(layers.relu(loc_idx), [B, F, 1]), axis=1
    )  # [B, F, 4]
    reg_valid = layers.cast(
        layers.greater_equal(
            layers.cast(loc_idx, "float32"),
            layers.fill_constant([1], "float32", 0.0),
        ),
        "float32",
    )  # [B, F]
    diff = (samp_delta - tgt_bbox) * bbox_w
    reg = layers.reduce_sum(layers.abs(diff), dim=[2])  # [B, F]
    reg_loss = _per_image_mean(
        layers.reduce_sum(reg * reg_valid, dim=[1]),
        layers.reduce_sum(reg_valid, dim=[1]),
    )
    return cls_loss, reg_loss


def _fpn_roi_extract_batched(ps, rois, cfg, resolution, B):
    """Batched FPN roi feature extraction: rois [B, R, 4] -> features
    [B*R, C, res, res] (B folded into the roi dim so the conv/fc heads
    run one wide op over every image's rois)."""
    multi_rois, restore, _nums = det.distribute_fpn_proposals(
        rois, cfg.min_level, cfg.max_level, 4, 224,
    )  # L x [B, R, 4], [B, R, 1]
    feats = []
    for lvl, (p, r) in enumerate(zip(ps, multi_rois)):
        f = det.roi_align(
            p, r, pooled_height=resolution, pooled_width=resolution,
            spatial_scale=1.0 / (2 ** (lvl + 2)), sampling_ratio=2,
        )  # [B, R, C, res, res]
        feats.append(f)
    stacked = layers.concat(feats, axis=1)  # [B, L*R, C, res, res]
    R = rois.shape[1]
    # restore[b, i] = row of roi i in image b's level-major concat (-1 for
    # dead rois -> clamps to row 0, masked by the losses downstream)
    idx = layers.reshape(layers.relu(restore), [B, R, 1, 1, 1])
    picked = layers.take_along_axis(stacked, idx, axis=1)
    C = stacked.shape[2]
    return layers.reshape(picked, [B * R, C, resolution, resolution])


def mask_rcnn_train_batched(images, gt_boxes, gt_classes, is_crowd,
                            gt_segms, im_info, cfg=None):
    """Cross-image batched train graph: ONE [B, ...] program for B images
    (no per-image unroll).

    images [B, 3, H, W]; gt_boxes [B, G, 4]; gt_classes/is_crowd [B, G];
    gt_segms [B, G, H, W]; im_info [B, 3]. Returns ``(losses, aux)``:
    losses = (total, rpn_cls, rpn_reg, head_cls, head_reg, mask) scalars
    (each per-image normalized then averaged over B) and aux =
    {"rois_num": [B] live-roi counts} for padding-waste observability
    (ops/detection_stats.record_roi_stats)."""
    cfg = cfg or MaskRCNNConfig()
    B = images.shape[0]
    cap = cfg.batch_size_per_im  # per-image RoI cap
    ps = resnet_fpn_backbone(images, cfg, is_test=False)
    rpn_outs = rpn_heads(ps, cfg)
    rpn_cls_loss, rpn_reg_loss = _rpn_losses_batched(
        rpn_outs, gt_boxes, is_crowd, im_info, cfg, B
    )

    # proposals per level -> collect (generate_proposals is natively
    # rank-lifted over the image batch)
    lvl_rois, lvl_scores, lvl_nums = [], [], []
    for scores, deltas, anchors, variances in rpn_outs:
        rois, probs, nums = det.generate_proposals(
            scores, deltas, im_info, anchors, variances,
            pre_nms_top_n=cfg.rpn_pre_nms, post_nms_top_n=cfg.rpn_post_nms,
            nms_thresh=0.7, min_size=0.0,
        )  # [B, post, 4] / [B, post, 1] / [B]
        lvl_rois.append(rois)
        lvl_scores.append(probs)
        lvl_nums.append(nums)
    rois, _collect_num = det.collect_fpn_proposals(
        lvl_rois, lvl_scores, cfg.min_level, cfg.max_level,
        post_nms_top_n=cfg.rpn_post_nms, rois_nums=lvl_nums,
    )  # [B, post, 4]

    (rois, labels, bbox_targets, bbox_iw, _bbox_ow, rois_num,
     _ov) = det.generate_proposal_labels(
        rois, gt_classes, is_crowd, gt_boxes, im_info,
        batch_size_per_im=cap, class_nums=cfg.class_num,
        rois_num=_collect_num,
    )  # [B, cap, 4] / [B, cap, 1] / [B, cap, 4C] / ... / [B]

    feat = _fpn_roi_extract_batched(ps, rois, cfg, cfg.resolution, B)
    cls_score, bbox_pred = box_head(feat, cfg)  # [B*cap, C] / [B*cap, 4C]

    labels_flat = layers.reshape(labels, [B * cap, 1])
    valid = layers.cast(
        layers.greater_equal(
            layers.cast(labels_flat, "float32"),
            layers.fill_constant([1], "float32", 0.0),
        ),
        "float32",
    )  # [B*cap, 1]
    valid_im = layers.reshape(valid, [B, cap])
    cls_loss_all = layers.softmax_with_cross_entropy(
        cls_score, layers.relu(labels_flat)
    )  # [B*cap, 1]
    head_cls_loss = _per_image_mean(
        layers.reduce_sum(
            layers.reshape(cls_loss_all, [B, cap]) * valid_im, dim=[1]
        ),
        layers.reduce_sum(valid_im, dim=[1]),
    )
    diff = (bbox_pred - layers.reshape(bbox_targets, [B * cap, -1])) \
        * layers.reshape(bbox_iw, [B * cap, -1])
    reg_rows = layers.reduce_sum(layers.abs(diff), dim=[1], keep_dim=True)
    head_reg_loss = _per_image_mean(
        layers.reduce_sum(
            layers.reshape(reg_rows, [B, cap]) * valid_im, dim=[1]
        ),
        layers.reduce_sum(valid_im, dim=[1]),
    )

    # mask branch on the sampled roi set
    mask_rois, _has_mask, mask_targets = det.generate_mask_labels(
        im_info, gt_classes, is_crowd, gt_segms, rois, labels,
        num_classes=cfg.class_num, resolution=cfg.resolution,
    )  # [B, cap, 4] / [B, cap, 1] / [B, cap, C*M^2]
    mfeat = _fpn_roi_extract_batched(ps, mask_rois, cfg, cfg.resolution, B)
    mlogits = mask_head(mfeat, cfg)  # [B*cap, C, 2M, 2M]
    mlogits = layers.pool2d(mlogits, pool_size=2, pool_stride=2,
                            pool_type="avg")  # back to [B*cap, C, M, M]
    mlogits = layers.reshape(
        mlogits, [B * cap, cfg.class_num * cfg.resolution ** 2]
    )
    mtgt = layers.cast(
        layers.reshape(mask_targets, [B * cap, -1]), "float32"
    )
    mvalid = layers.cast(
        layers.greater_equal(mtgt, layers.fill_constant([1], "float32", 0.0)),
        "float32",
    )
    mce = layers.sigmoid_cross_entropy_with_logits(mlogits, layers.relu(mtgt))
    K = cfg.class_num * cfg.resolution ** 2
    mask_loss = _per_image_mean(
        layers.reduce_sum(
            layers.reshape(mce * mvalid, [B, cap * K]), dim=[1]
        ),
        layers.reduce_sum(
            layers.reshape(mvalid, [B, cap * K]), dim=[1]
        ),
    )

    total = (rpn_cls_loss + rpn_reg_loss + head_cls_loss + head_reg_loss
             + mask_loss)
    losses = (total, rpn_cls_loss, rpn_reg_loss, head_cls_loss,
              head_reg_loss, mask_loss)
    return losses, {"rois_num": rois_num}


def mask_rcnn_infer(image, im_info, cfg=None):
    """Proposal -> box head -> NMS; returns detections [K, 6] and the
    per-detection mask logits."""
    cfg = cfg or MaskRCNNConfig()
    ps = resnet_fpn_backbone(image, cfg, is_test=True)
    rpn_outs = rpn_heads(ps, cfg)
    lvl_rois, lvl_scores, lvl_nums = [], [], []
    for scores, deltas, anchors, variances in rpn_outs:
        rois, probs, nums = det.generate_proposals(
            scores, deltas, im_info, anchors, variances,
            pre_nms_top_n=cfg.rpn_pre_nms, post_nms_top_n=cfg.rpn_post_nms,
            nms_thresh=0.7, min_size=0.0,
        )
        lvl_rois.append(layers.reshape(rois, [-1, 4]))
        lvl_scores.append(layers.reshape(probs, [-1, 1]))
        lvl_nums.append(nums)
    rois, _ = det.collect_fpn_proposals(
        lvl_rois, lvl_scores, cfg.min_level, cfg.max_level,
        post_nms_top_n=cfg.rpn_post_nms, rois_nums=lvl_nums,
    )
    feat = _fpn_roi_extract(ps, rois, cfg, cfg.resolution)
    cls_score, bbox_pred = box_head(feat, cfg)
    probs = layers.softmax(cls_score)  # [R, C]
    # decode per-class boxes against the rois (reference inference path:
    # box_coder decode with the training bbox_reg_weights as variance,
    # inverting generate_proposal_labels' encoding) + NMS
    var4 = layers.assign_value([0.1, 0.1, 0.2, 0.2])
    decoded, assign = det.box_decoder_and_assign(
        rois, var4, bbox_pred, probs,
    )
    R = rois.shape[0]
    # each roi contributes its best-class box (OutputAssignBox); NMS over
    # the class-score matrix picks labels
    shared = layers.reshape(assign, [1, R, 4])
    scores_t = layers.transpose(layers.reshape(probs, [1, R, -1]), [0, 2, 1])
    out, _nums = det.multiclass_nms(shared, scores_t, score_threshold=0.05,
                                    nms_top_k=cfg.rpn_post_nms,
                                    keep_top_k=100, nms_threshold=0.5,
                                    background_label=0)
    # mask head runs on the KEPT detections (reference order: NMS first,
    # then the mask branch on the final boxes), so mask row i IS detection i
    det_boxes = layers.reshape(
        layers.slice(out, axes=[2], starts=[2], ends=[6]), [-1, 4]
    )
    mfeat = _fpn_roi_extract(ps, det_boxes, cfg, cfg.resolution)
    mlogits = mask_head(mfeat, cfg)
    return out, mlogits
