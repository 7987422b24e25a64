"""Detection ops of the YOLOv3 slice (counterpart of
paddle_tpu/ops/detection.py; reference operators/detection/:
yolo_box_op.cc, multiclass_nms_op.cc, yolov3_loss_op.h).

The JAX package's static-shape design is kept: NMS returns a fixed
keep_top_k set padded with label -1 plus a count, and every emitter is
free of host reads of a tensor's values (shape inference runs it on meta
tensors; a step with no host-device sync could be a CUDA graph). What the
JAX emitters do for the TPU's sake is done the card's way: yolov3_loss
gathers each box's cell by index (its gradient a scatter-add), where the
JAX package multiplies by a one-hot matrix; the greedy suppression is one
loop over the ranked boxes, batched over images and classes, where the
JAX package unrolls it in blocks of 64. Small constant tables (anchors,
the anchor mask) are made on a device once and kept.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from ._helpers import stable_sigmoid_ce as _sce  # yolov3_loss_op.h:35
from .nn import _opt

_CONSTS = {}


def _const(values, device, dtype=torch.float32):
    """A 1-D tensor of `values` on `device`, copied there once."""
    key = (tuple(values), str(device), dtype)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTS[key]


def _iou_matrix(a, b):
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU (xmin, ymin, xmax,
    ymax)."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (
        a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (
        b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


@register_op("yolo_box", inputs=["X", "ImgSize"], outputs=["Boxes", "Scores"],
             differentiable=False)
def _yolo_box(ctx, op, ins):
    """Decode a YOLOv3 head (yolo_box_op.cc): X [B, A*(5+C), H, W] ->
    boxes [B, A*H*W, 4] (x0, y0, x1, y1 in pixels of ImgSize [B, 2] (h,
    w)) and scores [B, A*H*W, C], zero where the objectness is at most
    conf_thresh."""
    x = ins["X"][0]
    img_size = ins["ImgSize"][0]
    anchors = [int(a) for a in op.attr("anchors")]
    class_num = op.attr("class_num")
    conf_thresh = op.attr("conf_thresh", 0.01)
    downsample = op.attr("downsample_ratio", 32)
    B, _, H, W = x.shape
    A = len(anchors) // 2
    an = _const(anchors, x.device).reshape(A, 2)

    x = x.reshape(B, A, 5 + class_num, H, W)
    tx, ty = torch.sigmoid(x[:, :, 0]), torch.sigmoid(x[:, :, 1])
    tw, th = x[:, :, 2], x[:, :, 3]
    conf = torch.sigmoid(x[:, :, 4])  # [B, A, H, W]
    cls = torch.sigmoid(x[:, :, 5:])  # [B, A, C, H, W]

    gx = torch.arange(W, dtype=torch.float32, device=x.device)
    gy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
    cx = (tx + gx) / W
    cy = (ty + gy) / H
    bw = torch.exp(tw) * an[:, 0, None, None] / float(downsample * W)
    bh = torch.exp(th) * an[:, 1, None, None] / float(downsample * H)

    imw = img_size[:, 1].float()[:, None, None, None]
    imh = img_size[:, 0].float()[:, None, None, None]
    x0 = (cx - bw / 2) * imw
    y0 = (cy - bh / 2) * imh
    x1 = (cx + bw / 2) * imw
    y1 = (cy + bh / 2) * imh
    boxes = torch.stack([x0, y0, x1, y1], -1).reshape(B, A * H * W, 4)
    score = conf[:, :, None] * cls
    keep = (conf > conf_thresh).to(score.dtype)[:, :, None]
    score = (score * keep).permute(0, 1, 3, 4, 2).reshape(
        B, A * H * W, class_num)
    return {"Boxes": [boxes], "Scores": [score]}


def _greedy_nms(boxes_k, keep_pred, nms_thresh):
    """Alive mask over rank-ordered boxes [..., k, 4]: box i survives iff
    keep_pred[..., i] and it overlaps no surviving higher-ranked box by
    more than nms_thresh, the sequential suppression of
    multiclass_nms_op.cc, one step a box over every leading index."""
    k = boxes_k.shape[-2]
    sup_mat = _iou_matrix(boxes_k, boxes_k) > nms_thresh  # [..., k, k]
    alive = torch.zeros(keep_pred.shape, dtype=torch.bool,
                        device=keep_pred.device)
    for i in range(k):
        # alive is False from i on, so no j < i mask is needed
        sup = (alive & sup_mat[..., i, :]).any(-1)
        alive[..., i] = ~sup & keep_pred[..., i]
    return alive


def _sorted_desc(x):
    """Values and indices along the last axis, largest first; of equal
    values the lower index first, as lax.top_k orders them."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def multiclass_nms_core(boxes, scores, attrs):
    """Per class, greedy suppression by IoU among its nms_top_k best boxes,
    then the keep_top_k best over every class. boxes [B, N, 4], scores [B,
    C, N]. Returns (out [B, kk, 6] rows (label, score, x0, y0, x1, y1),
    label -1 on invalid rows; num [B]; in_idx [B, kk], the kept row's
    index into the input boxes, -1 on invalid rows)."""
    score_thresh = attrs.get("score_threshold", 0.0)
    nms_thresh = attrs.get("nms_threshold", 0.3)
    nms_top_k = attrs.get("nms_top_k", 64)
    keep_top_k = attrs.get("keep_top_k", 16)
    background = attrs.get("background_label", 0)
    B, C, N = scores.shape
    k = min(nms_top_k, N)
    if background is not None and 0 <= background < C:
        # multiclass_nms_op.cc skips c == background_label
        scores = scores.clone()
        scores[:, background, :] = -torch.inf

    sc, idx = _sorted_desc(scores)
    sc, idx = sc[..., :k], idx[..., :k]  # [B, C, k]
    bx = torch.gather(boxes[:, None].expand(B, C, N, 4), 2,
                      idx[..., None].expand(B, C, k, 4))
    alive = _greedy_nms(bx, sc > score_thresh, nms_thresh)
    # a suppressed box scores 0 (the JAX package's sc * alive, which XLA
    # computes as a select: 0, not -inf * 0, for the background's -inf)
    flat_scores = torch.where(alive, sc, 0.0).reshape(B, C * k)
    flat_idx = idx.reshape(B, C * k)
    kk = min(keep_top_k, C * k)
    top_sc, top_i = _sorted_desc(flat_scores)
    top_sc, top_i = top_sc[:, :kk], top_i[:, :kk]
    valid = top_sc > max(score_thresh, 0.0)
    lab = torch.where(valid, top_i // k, -1).to(torch.float32)
    src = torch.gather(flat_idx, 1, top_i)
    kept = torch.gather(boxes, 1, src[..., None].expand(B, kk, 4))
    out = torch.cat([lab[..., None], top_sc[..., None], kept], -1)
    in_idx = torch.where(valid, src, -1).to(torch.int32)
    return out, valid.sum(-1).to(torch.int32), in_idx


@register_op(
    "multiclass_nms", inputs=["BBoxes", "Scores"],
    outputs=["Out", "NmsRoisNum"], differentiable=False,
)
def _multiclass_nms(ctx, op, ins):
    """Fixed-size NMS: Out [B, keep_top_k, 6], NmsRoisNum [B]."""
    out, num, _ = multiclass_nms_core(
        ins["BBoxes"][0], ins["Scores"][0], op.attrs)
    return {"Out": [out], "NmsRoisNum": [num]}


@register_op(
    "yolov3_loss",
    inputs=["X", "GTBox", "GTLabel", "GTScore"],
    outputs=["Loss", "ObjectnessMask", "GTMatchMask"],
)
def _yolov3_loss(ctx, op, ins):
    """YOLOv3 training loss (detection/yolov3_loss_op.h), per image [N].

    X [N, M*(5+C), H, W] raw head output; GTBox [N, B, 4] normalised (cx,
    cy, w, h); GTLabel [N, B] int; optional GTScore [N, B]. Predicted
    boxes whose IoU with some box exceeds ignore_thresh owe no negative
    objectness (mask -1). Each valid box takes its best anchor by shape
    IoU over all anchors (the first of tied maxima); where that anchor is
    one of this head's, its cell owes the location loss (sigmoid-CE on tx,
    ty, L1 on tw, th, times (2 - w h) score), the class loss and a
    positive objectness of its score. Of two boxes in one cell the later
    sets the mask, as the reference's loop leaves it; both owe their
    location and class losses. The grid is taken as square (H
    everywhere), as in the reference. Computed in fp32 whatever X's
    dtype; the index work carries no gradient."""
    x4 = ins["X"][0]
    dev = x4.device
    gt_box = ins["GTBox"][0].float()
    gt_label = ins["GTLabel"][0]
    gts = _opt(ins, "GTScore")
    gt_score = (gts.float() if gts is not None
                else torch.ones(gt_label.shape, device=dev))
    anchors = [int(a) for a in op.attr("anchors")]
    anchor_mask = [int(a) for a in op.attr("anchor_mask")]
    class_num = int(op.attr("class_num"))
    ignore_thresh = float(op.attr("ignore_thresh", 0.7))
    downsample = int(op.attr("downsample_ratio", 32))
    use_label_smooth = bool(op.attr("use_label_smooth", True))
    scale_xy = float(op.attr("scale_x_y", 1.0))
    bias_xy = -0.5 * (scale_xy - 1.0)

    N, _, H, W = x4.shape
    A = len(anchors) // 2
    M = len(anchor_mask)
    B = gt_box.shape[1]
    input_size = downsample * H
    an = _const(anchors, dev).reshape(A, 2)
    am = _const([anchors[2 * a + i] for a in anchor_mask for i in (0, 1)],
                dev).reshape(M, 2)

    x = x4.float().reshape(N, M, 5 + class_num, H, W)
    gx, gy, gw, gh = gt_box.unbind(-1)  # [N, B]
    valid = (gw > 1e-6) & (gh > 1e-6)
    if use_label_smooth:
        smooth = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - smooth, smooth
    else:
        label_pos, label_neg = 1.0, 0.0

    # ---- predicted boxes of every cell and the ignore mask ----
    col = torch.arange(W, dtype=torch.float32, device=dev)
    row = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    px = (col + torch.sigmoid(x[:, :, 0]) * scale_xy + bias_xy) / H
    py = (row + torch.sigmoid(x[:, :, 1]) * scale_xy + bias_xy) / H
    pw = torch.exp(x[:, :, 2]) * am[:, 0, None, None] / input_size
    ph = torch.exp(x[:, :, 3]) * am[:, 1, None, None] / input_size

    def overlap(c1, w1, c2, w2):
        return torch.minimum(c1 + w1 / 2, c2 + w2 / 2) - torch.maximum(
            c1 - w1 / 2, c2 - w2 / 2)

    # [N, M, H, W, B]: every predicted box against every ground-truth box
    def gt(v):
        return v[:, None, None, None, :]

    ow = overlap(px[..., None], pw[..., None], gt(gx), gt(gw))
    oh = overlap(py[..., None], ph[..., None], gt(gy), gt(gh))
    inter = torch.where((ow < 0) | (oh < 0), 0.0, ow * oh)
    union = (pw * ph)[..., None] + gt(gw * gh) - inter
    iou = torch.where(gt(valid), inter / union, 0.0)
    best_iou = iou.amax(-1)  # [N, M, H, W]
    # -1 where ignored, else 0 (torch.where of two Python scalars copies
    # a host scalar to the card)
    obj_mask = 0.0 - (best_iou > ignore_thresh).float()

    # ---- each box's best anchor (shape IoU over all anchors) ----
    aw = an[:, 0] / input_size  # [A]
    ah = an[:, 1] / input_size
    inter_a = torch.minimum(gw[..., None], aw) * torch.minimum(
        gh[..., None], ah)
    union_a = (gw * gh)[..., None] + aw * ah - inter_a
    best_n = torch.argmax(inter_a / union_a, -1)  # [N, B]
    mask_table = [-1] * A
    for i, a in enumerate(anchor_mask):
        mask_table[a] = i
    gt_match = torch.where(valid, _const(mask_table, dev, torch.int64)
                           [best_n], -1)

    pos = valid & (gt_match >= 0)  # [N, B]
    midx = gt_match.clamp(min=0)
    gi = (gx * W).to(torch.int32).clamp(0, W - 1)
    gj = (gy * H).to(torch.int32).clamp(0, H - 1)

    # each box's cell of the flattened [M*H*W] grid, read by index (the
    # JAX package's one-hot product would go through a TF32 matmul here)
    K = M * H * W
    cell_idx = (midx * H + gj) * W + gi  # [N, B]
    x_flat = x.permute(0, 1, 3, 4, 2).reshape(N, K, 5 + class_num)
    cell = torch.gather(x_flat, 1, cell_idx[..., None].expand(
        N, B, 5 + class_num))  # [N, B, 5+C]

    # ---- location loss ----
    tx = gx * H - gi.float()
    ty = gy * H - gj.float()
    best_a = an[best_n]  # [N, B, 2]
    tw = torch.log(torch.where(pos, gw * input_size / best_a[..., 0], 1.0))
    th = torch.log(torch.where(pos, gh * input_size / best_a[..., 1], 1.0))
    loc_scale = (2.0 - gw * gh) * gt_score
    loc = (
        _sce(cell[..., 0], tx) + _sce(cell[..., 1], ty)
        + (cell[..., 2] - tw).abs() + (cell[..., 3] - th).abs()
    ) * loc_scale
    loc_loss = torch.where(pos, loc, 0.0).sum(1)

    # ---- class loss ----
    onehot = (gt_label[..., None] == torch.arange(
        class_num, device=dev)).float()
    target = onehot * label_pos + (1.0 - onehot) * label_neg
    cls = _sce(cell[..., 5:], target).sum(-1) * gt_score
    cls_loss = torch.where(pos, cls, 0.0).sum(1)

    # ---- objectness mask write and loss ----
    # the last positive box of a cell writes its score: the largest box
    # index that lands there, by an order-free max (a scatter of the
    # scores with repeated cells leaves the winner open on the card)
    slot = torch.where(pos, cell_idx, K)  # non-positives to a spare slot
    order = torch.arange(B, device=dev).expand(N, B)
    win = torch.full((N, K + 1), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(1, slot, order, "amax")  # in place: no clone
    win = win[:, :K]
    hit_score = torch.gather(gt_score, 1, win.clamp(min=0))
    obj_mask = torch.where(win >= 0, hit_score,
                           obj_mask.reshape(N, K)).reshape(N, M, H, W)
    conf = x[:, :, 4]
    obj_l = torch.where(
        obj_mask > 1e-5,
        _sce(conf, 1.0) * obj_mask,
        torch.where(obj_mask > -0.5, _sce(conf, 0.0), 0.0),
    )
    obj_loss = obj_l.sum((1, 2, 3))

    loss = loc_loss + cls_loss + obj_loss
    return {
        "Loss": [loss],
        "ObjectnessMask": [obj_mask],
        "GTMatchMask": [gt_match.to(torch.int32)],
    }
