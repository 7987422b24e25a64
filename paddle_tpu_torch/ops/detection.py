"""Detection ops of the YOLOv3 and Mask R-CNN slices (counterpart of
paddle_tpu/ops/detection.py; reference operators/detection/:
yolo_box_op.cc, multiclass_nms_op.cc, yolov3_loss_op.h,
anchor_generator_op.h, generate_proposals_op.cc, roi_align_op.h).

The JAX package's static-shape design is kept: NMS returns a fixed
keep_top_k set padded with label -1 plus a count, and every emitter is
free of host reads of a tensor's values (shape inference runs it on meta
tensors; a step with no host-device sync could be a CUDA graph). What the
JAX emitters do for the TPU's sake is done the card's way: yolov3_loss
gathers each box's cell by index (its gradient a scatter-add), where the
JAX package multiplies by a one-hot matrix; the greedy suppression is one
loop over the ranked boxes, batched over images and classes, where the
JAX package unrolls it in blocks of 64; roi_align gathers its bilinear
corners from a channels-last copy of the map by one flat index (its
gradient one index_add), where the JAX package vmaps a 4-D gather over
images. Small constant tables (YOLO anchors, the anchor mask, the RPN
anchors of a map size) are made on a device once and kept.

The roi family takes a leading batch dim, as the JAX package's does:
ROIs [B, R, 4] against X [B, C, H, W], a fixed RoI cap R an image whose
padded rows are degenerate boxes the consumers mask.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op
from ..observability import metrics as _metrics
from ._helpers import stable_sigmoid_ce as _sce  # yolov3_loss_op.h:35
from .nn import _opt

_CONSTS = {}


def _tally(ctx, name, batched):
    """detection.<name>.instantiations (and .batched_instantiations): one
    bump on an executor's first run of a program (EmitContext.first_run),
    where the JAX package traces it; none in shape inference or in the
    __vjp__ replay (nor without a context)."""
    if not getattr(ctx, "first_run", False):
        return
    _metrics.add(f"detection.{name}.instantiations")
    if batched:
        _metrics.add(f"detection.{name}.batched_instantiations")


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
    _tally(ctx, "multiclass_nms", batched=ins["BBoxes"][0].shape[0] > 1)
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


def _roi_batch_idx(rois_num, R, N, abstract=False):
    """Each roi's image from RoisNum [N], the per-image roi counts (the
    reference's ROIs LoD): roi r belongs to image sum(r >= cumsum)."""
    if rois_num is None:
        if N != 1 and not abstract:
            # every roi on image 0 would be silently wrong
            raise ValueError("roi op over a multi-image batch needs RoisNum "
                             "(per-image roi counts)")
        return None
    bounds = rois_num.to(torch.int32).cumsum(0)
    r = torch.arange(R, dtype=torch.int32, device=rois_num.device)
    return (r[:, None] >= bounds).sum(1)


def _axis_weights(coord, size):
    """(low index, high index, weight low, weight high, in bounds) of
    bilinear sampling along one axis of `size` pixels."""
    inb = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    low = c.to(torch.int32).clamp(max=size - 1)
    high = (low + 1).clamp(max=size - 1)
    frac = torch.where(low >= size - 1, 0.0, c - low)
    return low, high, 1.0 - frac, frac, inb


def _roi_align_compute(x, rois, bidx, ph, pw, scale, s):
    """RoIAlign body: x [N, C, H, W], rois [..., R, 4] (fp32), bidx [...,
    R] each roi's image (None: image 0) -> [..., R, C, ph, pw] fp32, the
    mean of s x s bilinear samples a bin. The four corners of every sample
    are one index_select from x laid out [N*H*W, C], so the gradient is
    one index_add into the map."""
    N, C, H, W = x.shape
    dev = rois.device
    xmin, ymin, xmax, ymax = (rois[..., i] * scale for i in range(4))
    bw = (xmax - xmin).clamp(min=1.0) / pw
    bh = (ymax - ymin).clamp(min=1.0) / ph
    iy = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    # sample coordinates [..., R, ph (pw), s], in the JAX package's order
    bh3, bw3 = bh[..., None, None], bw[..., None, None]
    ys = ymin[..., None, None] + py[:, None] * bh3 + iy * bh3 / s
    xs = xmin[..., None, None] + px[:, None] * bw3 + iy * bw3 / s
    yl, yh, wyl, wyh, yin = _axis_weights(ys, H)
    xl, xh, wxl, wxh, xin = _axis_weights(xs, W)

    def rows(v):  # [..., R, ph, s] -> [..., R, ph, 1, s, 1]
        return v[..., :, None, :, None]

    def cols(v):  # [..., R, pw, s] -> [..., R, 1, pw, 1, s]
        return v[..., None, :, None, :]

    base = 0 if bidx is None else bidx[..., None, None, None, None] * H
    corners = [(base + rows(yi)) * W + cols(xi)
               for yi in (yl, yh) for xi in (xl, xh)]
    weights = [rows(wy) * cols(wx) for wy in (wyl, wyh) for wx in (wxl, wxh)]
    idx = torch.stack(torch.broadcast_tensors(*corners))  # [4, ..., s, s]
    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    g = torch.index_select(flat, 0, idx.reshape(-1).long()).reshape(
        idx.shape + (C,))
    val = (g[0] * weights[0][..., None] + g[1] * weights[1][..., None]
           + g[2] * weights[2][..., None] + g[3] * weights[3][..., None])
    inb = (rows(yin) & cols(xin))[..., None]
    val = torch.where(inb, val, 0.0).mean(dim=(-3, -2))  # [..., ph, pw, C]
    return val.movedim(-1, -3)


@register_op("roi_align", inputs=["X", "ROIs", "RoisNum"], outputs=["Out"])
def _roi_align(ctx, op, ins):
    """RoIAlign (roi_align_op.h) on a fixed sampling grid (sampling_ratio,
    2 where it is <= 0): ROIs [R, 4] (with RoisNum [N] over a batch of N
    maps) -> Out [R, C, ph, pw]; ROIs [B, R, 4] against X [B, C, H, W],
    image b's rois on map b alone -> Out [B, R, C, ph, pw]. Computed in
    fp32, given in X's dtype."""
    x = ins["X"][0]
    rois = ins["ROIs"][0].float()
    rois_num = _opt(ins, "RoisNum")
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    scale = float(op.attr("spatial_scale", 1.0))
    sr = int(op.attr("sampling_ratio", -1))
    s = sr if sr > 0 else 2
    if rois.dim() == 3:  # [B, R, 4] cross-image batched form
        _tally(ctx, "roi_align", batched=True)
        bidx = torch.arange(rois.shape[0], device=rois.device)[:, None]
    else:
        _tally(ctx, "roi_align", batched=False)
        bidx = _roi_batch_idx(rois_num, rois.shape[0], x.shape[0],
                              ctx.abstract)
    out = _roi_align_compute(x, rois, bidx, ph, pw, scale, s)
    return {"Out": [out.to(x.dtype)]}


@register_op("anchor_generator", inputs=["Input"],
             outputs=["Anchors", "Variances"], differentiable=False)
def _anchor_generator(ctx, op, ins):
    """RPN anchors of every cell of a map (anchor_generator_op.h:38-85):
    Anchors [H, W, A, 4] with A = len(aspect_ratios) * len(anchor_sizes),
    Variances the same shape. Made on a device once a (map size, attrs)."""
    feat = ins["Input"][0]
    H, W = feat.shape[2], feat.shape[3]
    sizes = [float(v) for v in op.attr("anchor_sizes")]
    ars = [float(v) for v in op.attr("aspect_ratios", [1.0])]
    variances = [float(v) for v in op.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    sw, sh = (float(v) for v in op.attr("stride"))
    offset = float(op.attr("offset", 0.5))
    key = ("anchors", H, W, tuple(sizes), tuple(ars), tuple(variances), sw,
           sh, offset, str(feat.device))
    if key not in _CONSTS:
        whs = []
        for ar in ars:
            base_w = np.round(np.sqrt(sw * sh / ar))
            base_h = np.round(base_w * ar)
            for size in sizes:
                whs += [size / sw * base_w, size / sh * base_h]
        dev = feat.device
        whs = torch.tensor(whs, dtype=torch.float32, device=dev).reshape(
            -1, 2)
        xc = torch.arange(W, dtype=torch.float32, device=dev) * sw \
            + offset * (sw - 1)
        yc = torch.arange(H, dtype=torch.float32, device=dev) * sh \
            + offset * (sh - 1)
        xg, yg = torch.meshgrid(xc, yc, indexing="xy")  # [H, W]
        ctr = torch.stack([xg, yg], -1)[:, :, None, :]  # [H, W, 1, 2]
        half = (whs - 1.0) / 2.0
        anchors = torch.cat([ctr - half, ctr + half], -1)  # [H, W, A, 4]
        var = torch.tensor(variances, dtype=torch.float32,
                           device=dev).expand(anchors.shape)
        _CONSTS[key] = (anchors, var)
    anchors, var = _CONSTS[key]
    return {"Anchors": [anchors], "Variances": [var]}


@register_op(
    "generate_proposals",
    inputs=["Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances"],
    outputs=["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
    differentiable=False,
)
def _generate_proposals(ctx, op, ins):
    """RPN proposals (generate_proposals_op.cc) in static shapes, for
    every image at once: decode all anchors, clip them to the image, drop
    boxes under min_size, take the pre_nms_topN best scores (ties: the
    lower index first), suppress greedily, and emit exactly post_nms_topN
    rois an image, left-packed in score order and zero-padded, with
    RpnRoisNum [N] counting the live ones."""
    scores = ins["Scores"][0]  # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]  # [N, A*4, H, W]
    _tally(ctx, "generate_proposals", batched=scores.shape[0] > 1)
    im_info = ins["ImInfo"][0].float()  # [N, 3]
    anchors = ins["Anchors"][0].reshape(-1, 4).float()
    variances = ins["Variances"][0].reshape(-1, 4).float()
    pre_n = int(op.attr("pre_nms_topN", 6000))
    post_n = int(op.attr("post_nms_topN", 1000))
    nms_thresh = float(op.attr("nms_thresh", 0.7))
    min_size = float(op.attr("min_size", 0.1))

    N, A, H, W = scores.shape
    M = A * H * W
    sc = scores.permute(0, 2, 3, 1).reshape(N, M)
    dl = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(
        N, M, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    cx = variances[:, 0] * dl[..., 0] * aw + acx
    cy = variances[:, 1] * dl[..., 1] * ah + acy
    w = torch.exp((variances[:, 2] * dl[..., 2]).clamp(max=10.0)) * aw
    h = torch.exp((variances[:, 3] * dl[..., 3]).clamp(max=10.0)) * ah
    imh, imw = im_info[:, 0:1], im_info[:, 1:2]
    x0 = (cx - 0.5 * w).clamp(min=0.0).minimum(imw - 1.0)
    y0 = (cy - 0.5 * h).clamp(min=0.0).minimum(imh - 1.0)
    x1 = (cx + 0.5 * w - 1.0).clamp(min=0.0).minimum(imw - 1.0)
    y1 = (cy + 0.5 * h - 1.0).clamp(min=0.0).minimum(imh - 1.0)
    boxes = torch.stack([x0, y0, x1, y1], -1)  # [N, M, 4]

    # FilterBoxes (generate_proposals_op.cc:168): the box's size in the
    # original image's units, w / im_scale + 1, reaches max(min_size, 1)
    ms = max(min_size, 1.0)
    im_scale = im_info[:, 2:3]
    keep = ((x1 - x0) / im_scale + 1.0 >= ms) & (
        (y1 - y0) / im_scale + 1.0 >= ms)
    sc = torch.where(keep, sc, -torch.inf)

    k = min(pre_n, M)
    top_sc, top_i = _sorted_desc(sc)
    top_sc, top_i = top_sc[:, :k], top_i[:, :k]
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(N, k, 4))
    alive = _greedy_nms(top_boxes, torch.isfinite(top_sc), nms_thresh)
    # the first post_n survivors in score order; the suppressed and the
    # overflow land on a dump row post_n
    rank = alive.to(torch.int32).cumsum(1) - 1
    slot = torch.where(alive & (rank < post_n), rank, post_n)
    out_boxes = boxes.new_zeros(N, post_n + 1, 4).scatter_(
        1, slot[..., None].expand(N, k, 4), top_boxes)[:, :post_n]
    out_probs = sc.new_zeros(N, post_n + 1).scatter_(
        1, slot, top_sc)[:, :post_n]
    num = alive.sum(1).clamp(max=post_n).to(torch.int32)
    return {"RpnRois": [out_boxes], "RpnRoiProbs": [out_probs[..., None]],
            "RpnRoisNum": [num]}
