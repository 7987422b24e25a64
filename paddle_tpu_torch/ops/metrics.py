"""Metric ops of the port's slices (counterpart of
paddle_tpu/ops/metrics.py; reference operators/metrics/accuracy_op.cc):
accuracy only."""

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
