"""Detection training and assignment ops of the Mask R-CNN slice
(counterpart of paddle_tpu/ops/detection_ext.py; reference
paddle/fluid/operators/detection/: rpn_target_assign_op.cc,
generate_proposal_labels_op.cc, generate_mask_labels_op.cc,
distribute_fpn_proposals_op.cc, collect_fpn_proposals_op.cc,
box_decoder_and_assign_op.cc).

The JAX package's static-shape design is kept: the reference's per-image
LoD walks become fixed-size tensors with -1 or 0 padding and live
counts, left-packed by the cumsum rank onto a dump row (_pack_left); a
uniform jitter added to the selection priority stands in for the
reference's std::random_shuffle. No emitter reads a tensor's value on
the host. Where the JAX package vmaps a one-image core over the images,
the cores here take the leading image dim [N, ...] and run every image
in each torch call; the one-image op form runs them at N = 1.

Sorts are stable (ties: the lower index first, as jnp.argsort and
lax.top_k order them). The sampling cores take their jitter as an
argument; the ops draw it with _helpers.sampling_jitter.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from . import _helpers
from .detection import _iou_matrix, _sorted_desc, _tally
from .nn import _opt


def _pack_left(values, mask, fill, cap=None):
    """Rows of values [N, K, ...] where mask [N, K] holds, left-packed
    into cap rows an image (default K), padded with `fill`."""
    n, k = mask.shape
    cap = cap or k
    rank = mask.to(torch.int32).cumsum(1) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)  # dump row cap
    rest = values.shape[2:]
    buf = torch.full((n, cap + 1) + rest, fill, dtype=values.dtype,
                     device=values.device)
    slot = slot.reshape((n, k) + (1,) * len(rest)).expand(values.shape)
    return buf.scatter_(1, slot, values)[:, :cap]


def _encode_boxes(anchors, gts, weights=(1.0, 1.0, 1.0, 1.0)):
    """Box deltas (bbox_util.h BoxToDelta) of gts against anchors, [...,
    4] each, divided by the weights (the decoder multiplies them back)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = gts[..., 2] - gts[..., 0] + 1.0
    gh = gts[..., 3] - gts[..., 1] + 1.0
    gcx = gts[..., 0] + 0.5 * gw
    gcy = gts[..., 1] + 0.5 * gh
    wx, wy, ww, wh = weights
    return torch.stack([
        (gcx - acx) / aw / wx,
        (gcy - acy) / ah / wy,
        torch.log((gw / aw).clamp(min=1e-6)) / ww,
        torch.log((gh / ah).clamp(min=1e-6)) / wh,
    ], -1)


def _order(key):
    """Indices sorting key [N, K] largest first, ties in index order."""
    return _sorted_desc(key)[1]


def _take_first(flags, order, n_take):
    """flags [N, K] kept at the first n_take [N] of their holders in the
    ranking `order` [N, K]."""
    ranked = torch.gather(flags, 1, order)
    pos = ranked.to(torch.int32).cumsum(1) - 1
    return torch.zeros_like(flags).scatter_(
        1, order, ranked & (pos < n_take[:, None]))


def _in_top(order, cap):
    """[N, K] mask of the first cap indices of `order`."""
    return torch.zeros(order.shape, dtype=torch.bool,
                       device=order.device).scatter_(1, order[:, :cap], True)


def _valid_gt(gt, is_crowd):
    valid = gt[..., 2] > gt[..., 0]
    if is_crowd is not None:
        valid = valid & (is_crowd.reshape(gt.shape[0], -1)
                         [:, :gt.shape[1]] == 0)
    return valid


# ---------------------------------------------------------------------------
# RPN anchor target assignment
# ---------------------------------------------------------------------------


def anchor_assign(anchors, gt, is_crowd, im_info, jitter, *, pos_thresh,
                  neg_thresh, sample_frac, batch_size, straddle):
    """Every image's anchor -> gt assignment and fg/bg sampling.

    anchors [A, 4] shared; gt [N, G, 4] with padded rows where x1 <= x0;
    is_crowd [N, G] or None; im_info [N, 3] or None; jitter [N, A].
    Returns (loc_index [N, fg_cap], score_index [N, batch_size],
    tgt_label [N, batch_size], tgt_bbox [N, fg_cap, 4], bbox_w [N, fg_cap,
    4]), -1 or 0 padded, fg_cap = batch_size * sample_frac."""
    N, A = gt.shape[0], anchors.shape[0]
    valid_gt = _valid_gt(gt, is_crowd)
    inside = torch.ones((1, A), dtype=torch.bool, device=anchors.device)
    if im_info is not None and straddle >= 0.0:
        # rpn_target_assign_op.cc:99-110: anchors outside the image by
        # more than the threshold are neither fg nor bg
        info = im_info.reshape(N, -1).float()
        h_im, w_im = info[:, 0:1], info[:, 1:2]
        inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < w_im + straddle)
                  & (anchors[:, 3] < h_im + straddle))
    iou = torch.where(valid_gt[:, None, :], _iou_matrix(anchors, gt), -1.0)
    iou = torch.where(inside[..., None], iou, -1.0)  # [N, A, G]
    a_max = iou.amax(2)
    a_arg = iou.argmax(2)
    g_max = iou.amax(1)[:, None, :]
    fg = a_max >= pos_thresh
    # every gt's best anchor is fg (rpn_target_assign_op.cc per-gt argmax)
    is_best = ((iou == g_max) & (g_max > 0) & valid_gt[:, None, :]).any(2)
    fg = (fg | is_best) & inside
    bg = (a_max < neg_thresh) & ~fg & inside

    n_fg_cap = int(batch_size * sample_frac)
    fg_sel = fg & _in_top(_order(fg.float() + jitter), n_fg_cap)
    n_fg = fg_sel.sum(1)
    n_bg = torch.minimum(bg.sum(1), batch_size - n_fg)
    bg_take = _take_first(bg, _order(bg.float() + jitter), n_bg)

    idx = torch.arange(A, dtype=torch.int32,
                       device=anchors.device).expand(N, A)
    loc_index = _pack_left(idx, fg_sel, -1, n_fg_cap)
    matched = torch.gather(gt, 1, a_arg[..., None].expand(N, A, 4))
    tgt_bbox = _pack_left(_encode_boxes(anchors, matched), fg_sel, 0.0,
                          n_fg_cap)
    bbox_w = _pack_left(fg_sel.float()[..., None].expand(N, A, 4), fg_sel,
                        0.0, n_fg_cap)
    both = fg_sel | bg_take
    score_index = _pack_left(idx, both, -1, batch_size)
    tgt_label = _pack_left(fg_sel.to(torch.int32), both, -1, batch_size)
    return loc_index, score_index, tgt_label, tgt_bbox, bbox_w


@register_op(
    "rpn_target_assign",
    inputs=["Anchor", "GtBoxes", "IsCrowd", "ImInfo"],
    outputs=["LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
             "BBoxInsideWeight"],
    differentiable=False,
)
def _rpn_target_assign(ctx, op, ins):
    """rpn_target_assign_op.cc: sample rpn_batch_size_per_im anchors an
    image (fg: IoU >= rpn_positive_overlap or a gt's best anchor; bg: IoU
    < rpn_negative_overlap) and emit the fg regression targets and the
    sampled indices. GtBoxes [G, 4] (LocationIndex [fg_cap], ScoreIndex
    [S], TargetLabel [S, 1], ...) or [B, G, 4] (every output with a
    leading [B])."""
    anchors = ins["Anchor"][0].reshape(-1, 4).float()
    gt = ins["GtBoxes"][0].float()
    batched = gt.dim() == 3
    _tally(ctx, "rpn_target_assign", batched=batched)
    gt = gt if batched else gt[None]
    n = gt.shape[0]
    jitter = _helpers.sampling_jitter(ctx, op, n, anchors.shape[0],
                                      anchors.device)
    loc, score, lbl, tbb, bw = anchor_assign(
        anchors, gt, _opt(ins, "IsCrowd"), _opt(ins, "ImInfo"), jitter,
        pos_thresh=op.attr("rpn_positive_overlap", 0.7),
        neg_thresh=op.attr("rpn_negative_overlap", 0.3),
        sample_frac=op.attr("rpn_fg_fraction", 0.5),
        batch_size=int(op.attr("rpn_batch_size_per_im", 256)),
        straddle=op.attr("rpn_straddle_thresh", -1.0))
    if not batched:
        loc, score, lbl, tbb, bw = (t[0] for t in (loc, score, lbl, tbb, bw))
    return {"LocationIndex": [loc], "ScoreIndex": [score],
            "TargetLabel": [lbl[..., None]], "TargetBBox": [tbb],
            "BBoxInsideWeight": [bw]}


# ---------------------------------------------------------------------------
# proposal -> training-target sampling (the Fast R-CNN head's inputs)
# ---------------------------------------------------------------------------


def proposal_labels(rois, gt_cls, is_crowd, gt, jitter, *, cap, fg_frac,
                    fg_thresh, bg_hi, bg_lo, num_classes, bbox_w):
    """Every image's proposal -> label sampling. rois [N, R, 4] (padded
    rows are degenerate boxes, never sampled), gt_cls [N, G], is_crowd
    [N, G] or None, gt [N, G, 4], jitter [N, R + G] (the gt boxes join the
    candidates, so every gt can be fg). Returns (rois [N, cap, 4], labels
    [N, cap] -1 padded, fg first, box targets and their weights [N, cap,
    4 * num_classes], live counts [N], max overlaps [N, cap])."""
    N = rois.shape[0]
    valid_gt = _valid_gt(gt, is_crowd)
    all_rois = torch.cat([rois, gt], 1)
    roi_valid = torch.cat([rois[..., 2] > rois[..., 0], valid_gt], 1)
    K = all_rois.shape[1]
    iou = torch.where(valid_gt[:, None, :], _iou_matrix(all_rois, gt), -1.0)
    max_iou = torch.where(roi_valid, iou.amax(2), -1.0)
    argmax = iou.argmax(2)
    fg = max_iou >= fg_thresh
    bg = (max_iou < bg_hi) & (max_iou >= bg_lo) & roi_valid

    fg_sel = fg & _in_top(_order(fg.float() + jitter), int(cap * fg_frac))
    n_bg = cap - fg_sel.sum(1)
    bg_sel = _take_first(bg, _order(bg.float() + jitter), n_bg)
    both = fg_sel | bg_sel
    # fg first (the mask head reads the fg prefix)
    order = _order((fg_sel.float() * 2.0 + bg_sel.float()) + jitter * 0.5)
    sel = torch.gather(both, 1, order)

    def packed(v, fill):
        src = order.reshape(order.shape + (1,) * (v.dim() - 2))
        return _pack_left(torch.gather(v, 1, src.expand(v.shape)), sel,
                          fill, cap)

    out_rois = packed(all_rois, 0.0)
    labels = torch.where(fg_sel, torch.gather(gt_cls, 1, argmax), 0).to(
        torch.int32)
    out_labels = packed(labels, -1)
    max_ov = packed(max_iou, 0.0)
    matched = torch.gather(gt, 1, argmax[..., None].expand(N, K, 4))
    tgt = _encode_boxes(all_rois, matched, tuple(bbox_w))
    tgt_packed = packed(torch.where(fg_sel[..., None], tgt, 0.0), 0.0)
    # per-class expansion: slots 4c..4c+3 of the matched class
    classes = torch.arange(num_classes, device=rois.device)
    one_hot = (out_labels.clamp(min=0)[..., None] == classes).float()
    fg_row = (out_labels > 0).float()[..., None, None]
    targets = one_hot[..., None] * tgt_packed[..., None, :] * fg_row
    inside_w = (one_hot[..., None] * fg_row).expand(targets.shape)
    return (out_rois, out_labels, targets.reshape(N, cap, -1),
            inside_w.reshape(N, cap, -1), both.sum(1).to(torch.int32),
            max_ov)


@register_op(
    "generate_proposal_labels",
    inputs=["RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo",
            "RpnRoisNum"],
    outputs=["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights", "RoisNum", "MaxOverlapWithGT"],
    differentiable=False,
)
def _generate_proposal_labels(ctx, op, ins):
    """generate_proposal_labels_op.cc: append the gt boxes to the
    proposals, sample batch_size_per_im rois an image (fg_fraction of
    them at IoU >= fg_thresh, the rest bg in [bg_thresh_lo,
    bg_thresh_hi)), emit their class labels and per-class box targets.
    RpnRois [R, 4] or [B, R, 4] (every output with a leading [B], RoisNum
    [B]); RpnRoisNum is read by neither form: padded proposals are
    degenerate boxes that never sample."""
    rois = ins["RpnRois"][0].float()
    gt = ins["GtBoxes"][0].float()
    batched = gt.dim() == 3
    _tally(ctx, "generate_proposal_labels", batched=batched)
    if not batched:
        rois, gt = rois.reshape(1, -1, 4), gt[None]
    n = gt.shape[0]
    gt_cls = ins["GtClasses"][0].reshape(n, -1).to(torch.int32)
    cap = int(op.attr("batch_size_per_im", 512))
    jitter = _helpers.sampling_jitter(ctx, op, n, rois.shape[1] + gt.shape[1],
                                      rois.device)
    outs = proposal_labels(
        rois, gt_cls, _opt(ins, "IsCrowd"), gt, jitter, cap=cap,
        fg_frac=op.attr("fg_fraction", 0.25),
        fg_thresh=op.attr("fg_thresh", 0.5),
        bg_hi=op.attr("bg_thresh_hi", 0.5),
        bg_lo=op.attr("bg_thresh_lo", 0.0),
        num_classes=int(op.attr("class_nums", 81)),
        bbox_w=op.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2]))
    out_rois, labels, targets, inside_w, n_live, max_ov = (
        outs if batched else (t[0] for t in outs))
    return {"Rois": [out_rois], "LabelsInt32": [labels[..., None]],
            "BboxTargets": [targets], "BboxInsideWeights": [inside_w],
            "BboxOutsideWeights": [inside_w],
            "RoisNum": [n_live if batched else n_live.reshape(1)],
            "MaxOverlapWithGT": [max_ov[..., None]]}


def mask_labels(gt_cls, segms, rois, labels, M, num_classes):
    """Every image's mask targets. gt_cls [N, G], segms [N, G, Hs, Ws]
    dense 0/1 bitmaps, rois [N, R, 4], labels [N, R]. Each fg roi takes
    the gt whose bitmap's bounding box it overlaps most and samples an M x
    M grid of that bitmap inside the roi; the target lands in the roi's
    class slot, every other slot -1. Returns (mask rois [N, R, 4], has
    mask [N, R], targets [N, R, num_classes * M * M] int32)."""
    N, G, Hs, Ws = segms.shape
    R = rois.shape[1]
    dev = rois.device
    ys = torch.arange(Hs, dtype=torch.float32, device=dev)
    xs = torch.arange(Ws, dtype=torch.float32, device=dev)
    any_row = segms.amax(3) > 0  # [N, G, Hs]
    any_col = segms.amax(2) > 0  # [N, G, Ws]
    big = 1e9
    y0 = torch.where(any_row, ys, big).amin(2)
    y1 = torch.where(any_row, ys, -big).amax(2)
    x0 = torch.where(any_col, xs, big).amin(2)
    x1 = torch.where(any_col, xs, -big).amax(2)
    gt_boxes = torch.stack([x0, y0, x1, y1], -1)
    valid_gt = (x1 > x0) & (y1 > y0)
    iou = torch.where(valid_gt[:, None, :], _iou_matrix(rois, gt_boxes),
                      -1.0)
    match = iou.argmax(2)  # [N, R]
    fg = labels > 0

    grid = torch.arange(M, dtype=torch.float32, device=dev) + 0.5
    gy = rois[..., 1:2] + (rois[..., 3:4] - rois[..., 1:2]) * grid / M
    gx = rois[..., 0:1] + (rois[..., 2:3] - rois[..., 0:1]) * grid / M
    yi = torch.round(gy).clamp(0, Hs - 1).long()  # [N, R, M]
    xi = torch.round(gx).clamp(0, Ws - 1).long()
    img = torch.arange(N, device=dev)[:, None] * G + match  # [N, R]
    flat = ((img[..., None, None] * Hs + yi[..., :, None]) * Ws
            + xi[..., None, :])  # [N, R, M, M]
    crops = segms.reshape(-1)[flat].reshape(N, R, 1, M * M)
    classes = torch.arange(num_classes, device=dev)
    hit = (labels.clamp(min=0)[..., None] == classes)[..., None]
    tgt = torch.where(hit & fg[..., None, None], crops, -1.0)
    mask_rois = torch.where(fg[..., None], rois, 0.0)
    return (mask_rois, fg.to(torch.int32),
            tgt.reshape(N, R, num_classes * M * M).to(torch.int32))


@register_op(
    "generate_mask_labels",
    inputs=["ImInfo", "GtClasses", "IsCrowd", "GtSegms", "Rois",
            "LabelsInt32"],
    outputs=["MaskRois", "RoiHasMaskInt32", "MaskInt32"],
    differentiable=False,
)
def _generate_mask_labels(ctx, op, ins):
    """generate_mask_labels_op.cc with dense masks: GtSegms [G, Hs, Ws]
    (or [B, G, Hs, Ws], every output with a leading [B]) 0/1 bitmaps in
    image coordinates (the reference rasterises LoD polygons on the host,
    mask_util.cc; here that is the data pipeline's)."""
    M = int(op.attr("resolution", 14))
    num_classes = int(op.attr("num_classes", 81))
    segms = ins["GtSegms"][0].float()
    batched = segms.dim() == 4
    _tally(ctx, "generate_mask_labels", batched=batched)
    segms = segms if batched else segms[None]
    n = segms.shape[0]
    mask_rois, has_mask, tgt = mask_labels(
        ins["GtClasses"][0].reshape(n, -1).to(torch.int32), segms,
        ins["Rois"][0].reshape(n, -1, 4).float(),
        ins["LabelsInt32"][0].reshape(n, -1).to(torch.int32), M,
        num_classes)
    if not batched:
        mask_rois, has_mask, tgt = mask_rois[0], has_mask[0], tgt[0]
    return {"MaskRois": [mask_rois], "RoiHasMaskInt32": [has_mask[..., None]],
            "MaskInt32": [tgt]}


# ---------------------------------------------------------------------------
# FPN roi routing
# ---------------------------------------------------------------------------


def distribute(rois, min_level, max_level, refer_level, refer_scale):
    """Every image's FPN roi routing: rois [N, R, 4] -> (per level the
    rois left-packed, L x [N, R, 4]; per level the live counts, L x [N];
    restore [N, R], each roi's row in the image's level-major concat of
    the packed levels, -1 for a dead roi)."""
    N, R = rois.shape[:2]
    w = (rois[..., 2] - rois[..., 0]).clamp(min=0.0)
    h = (rois[..., 3] - rois[..., 1]).clamp(min=0.0)
    live = (w > 0) & (h > 0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(refer_level + torch.log2(scale / refer_scale + 1e-6))
    lvl = lvl.to(torch.int32).clamp(min_level, max_level)
    idx = torch.arange(R, dtype=torch.int32, device=rois.device).expand(N, R)
    multi, nums, orders = [], [], []
    for lev in range(min_level, max_level + 1):
        m = live & (lvl == lev)
        multi.append(_pack_left(rois, m, 0.0, R))
        nums.append(m.sum(1).to(torch.int32))
        orders.append(_pack_left(idx, m, -1, R))
    src = torch.cat(orders, 1)  # [N, L*R] source roi of each packed row
    live_slot = src >= 0
    rows = torch.arange(src.shape[1], dtype=torch.int32, device=rois.device)
    restore = torch.full((N, R + 1), -1, dtype=torch.int32,
                         device=rois.device).scatter_(
        1, torch.where(live_slot, src, R).long(),
        torch.where(live_slot, rows, -1).to(torch.int32))[:, :R]
    return multi, nums, restore


@register_op(
    "distribute_fpn_proposals",
    inputs=["FpnRois", "RoisNum"],
    outputs=["MultiFpnRois", "RestoreIndex", "MultiLevelRoIsNum"],
    differentiable=False,
)
def _distribute_fpn_proposals(ctx, op, ins):
    """distribute_fpn_proposals_op.cc: level(roi) = floor(refer_level +
    log2(sqrt(area) / refer_scale + 1e-6)) clamped to [min, max]. FpnRois
    [R, 4] (MultiFpnRois L x [R, 4], RestoreIndex [R, 1], counts L x [1])
    or [B, R, 4] (per image: L x [B, R, 4], [B, R, 1], L x [B])."""
    rois = ins["FpnRois"][0].float()
    batched = rois.dim() == 3
    _tally(ctx, "distribute_fpn_proposals", batched=batched)
    multi, nums, restore = distribute(
        rois if batched else rois.reshape(1, -1, 4),
        int(op.attr("min_level", 2)), int(op.attr("max_level", 5)),
        int(op.attr("refer_level", 4)), float(op.attr("refer_scale", 224)))
    if not batched:
        multi, restore = [m[0] for m in multi], restore[0]
    return {"MultiFpnRois": multi, "RestoreIndex": [restore[..., None]],
            "MultiLevelRoIsNum": nums}


def collect(rois_list, scores_list, nums_list, topn):
    """Every image's FPN roi collection: per level rois [N, k, 4], scores
    [N, k] and live counts [N] (or None: live where x1 > x0) -> (the topn
    best live rois [N, topn, 4] zero-padded, their count [N])."""
    rois = torch.cat(rois_list, 1)
    scores = torch.cat(scores_list, 1)
    if nums_list is not None:
        livem = torch.cat([
            torch.arange(r.shape[1], device=r.device) < n[:, None]
            for r, n in zip(rois_list, nums_list)], 1)
    else:
        livem = rois[..., 2] > rois[..., 0]
    scores = torch.where(livem, scores, -torch.inf)
    topn = min(topn, rois.shape[1])
    top_s, top_i = _sorted_desc(scores)
    top_s, top_i = top_s[:, :topn], top_i[:, :topn]
    live = top_s > -torch.inf
    picked = torch.gather(rois, 1, top_i[..., None].expand(-1, -1, 4))
    return torch.where(live[..., None], picked, 0.0), live.sum(1).to(
        torch.int32)


@register_op(
    "collect_fpn_proposals",
    inputs=["MultiLevelRois", "MultiLevelScores", "MultiLevelRoIsNum"],
    outputs=["FpnRois", "RoisNum"],
    differentiable=False,
)
def _collect_fpn_proposals(ctx, op, ins):
    """collect_fpn_proposals_op.cc: concat the levels' (roi, score) sets
    and keep the post_nms_topN best an image (ties: the lower index
    first). Per level rois [k, 4] or [B, k, 4] (FpnRois [topn, 4] or [B,
    topn, 4], RoisNum [1] or [B])."""
    topn = int(op.attr("post_nms_topN", 1000))
    rois_list = ins["MultiLevelRois"]
    nums = [n for n in ins.get("MultiLevelRoIsNum", []) if n is not None]
    batched = rois_list[0].dim() == 3
    _tally(ctx, "collect_fpn_proposals", batched=batched)
    n = rois_list[0].shape[0] if batched else 1
    out, num = collect(
        [r.reshape(n, -1, 4) for r in rois_list],
        [s.reshape(n, -1) for s in ins["MultiLevelScores"]],
        [c.reshape(n) for c in nums] if nums else None, topn)
    return {"FpnRois": [out if batched else out[0]], "RoisNum": [num]}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@register_op(
    "box_decoder_and_assign",
    inputs=["PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"],
    outputs=["DecodeBox", "OutputAssignBox"],
)
def _box_decoder_and_assign(ctx, op, ins):
    """box_decoder_and_assign_op.cc: decode every class's deltas [R, 4C]
    against the shared prior [R, 4] (PriorBoxVar [4] scales them; the
    log-size deltas clipped at box_clip), then give each roi the box of
    its best class but the background column 0."""
    prior = ins["PriorBox"][0].float()
    var = ins["PriorBoxVar"][0].float().reshape(-1)
    deltas = ins["TargetBox"][0]
    score = ins["BoxScore"][0]
    clip = op.attr("box_clip", 4.135)
    R = prior.shape[0]
    d = deltas.reshape(R, -1, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    cx = var[0] * d[..., 0] * pw[:, None] + pcx[:, None]
    cy = var[1] * d[..., 1] * ph[:, None] + pcy[:, None]
    w = torch.exp((var[2] * d[..., 2]).clamp(max=clip)) * pw[:, None]
    h = torch.exp((var[3] * d[..., 3]).clamp(max=clip)) * ph[:, None]
    decoded = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], -1)
    best = score[:, 1:].argmax(1) + 1
    assign = torch.gather(decoded, 1, best[:, None, None].expand(R, 1, 4))
    return {"DecodeBox": [decoded.reshape(R, -1)],
            "OutputAssignBox": [assign[:, 0]]}
