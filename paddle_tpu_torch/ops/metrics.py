"""Metric ops (counterpart of paddle_tpu/ops/metrics.py; reference
operators/metrics/accuracy_op.cc, auc_op.cc)."""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op(
    "accuracy",
    inputs=["Out", "Indices", "Label"],
    outputs=["Accuracy", "Correct", "Total"],
    differentiable=False,
)
def _accuracy(ctx, op, ins):
    idx, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() == 1:
        label = label[:, None]
    hit = (idx == label.to(idx.dtype)).any(dim=-1)
    n = idx.shape[0]
    correct = hit.sum(dtype=torch.int32)
    return {
        "Accuracy": [(correct.float() / n).reshape(1)],
        "Correct": [correct.reshape(1)],
        "Total": [torch.full((1,), n, dtype=torch.int32, device=idx.device)],
    }


def _suffix_sum(x):
    """x[i:].sum() for every i."""
    return torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])


@register_op(
    "auc",
    inputs=["Predict", "Label", "StatPos", "StatNeg"],
    outputs=["AUC", "StatPosOut", "StatNegOut"],
    differentiable=False,
)
def _auc(ctx, op, ins):
    """Streaming ROC AUC: each prediction's positive probability adds
    its label to bucket floor(p * num_thresholds) of StatPos or StatNeg,
    and the AUC is the trapezoid rule over the curve of the buckets'
    suffix sums, 0 while either class is empty. On the device, no host
    read."""
    pred, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = op.attr("num_thresholds", 4095)
    if label.dim() == 2:
        label = label[:, 0]
    pos_prob = pred[:, -1] if pred.dim() == 2 else pred
    bucket = torch.clamp((pos_prob * num_thresholds).to(torch.int64), 0,
                         num_thresholds)
    is_pos = (label > 0).to(stat_pos.dtype)
    pos_out = stat_pos.index_add(0, bucket, is_pos)
    neg_out = stat_neg.index_add(0, bucket, 1 - is_pos)
    tp, fp = _suffix_sum(pos_out), _suffix_sum(neg_out)
    tot_pos, tot_neg = tp[0], fp[0]
    zero = tp.new_zeros(1)
    tp_next = torch.cat([tp[1:], zero])
    fp_next = torch.cat([fp[1:], zero])
    area = torch.sum((fp - fp_next) * (tp + tp_next) / 2.0)
    denom = tot_pos * tot_neg
    auc = torch.where(denom > 0, area / denom, torch.zeros_like(area))
    return {
        "AUC": [auc.reshape(1).to(torch.float64)],
        "StatPosOut": [pos_out],
        "StatNegOut": [neg_out],
    }
