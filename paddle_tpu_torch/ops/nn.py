"""NN ops of the serving and training slices (counterpart of
paddle_tpu/ops/nn.py; reference layer_norm_op.cc, lookup_table_op.cc,
lookup_table_v2_op.cc, dropout_op.cc, softmax_with_cross_entropy_op.cc)."""

from __future__ import annotations

import torch

from ..errors import UnimplementedError
from ..framework.registry import register_op


@register_op("layer_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "Mean", "Variance"])
def _layer_norm(ctx, op, ins):
    # the plain path: the JAX package's Pallas LayerNorm kernel is off by
    # default (paddle_tpu/flags.py:57) and off this slice's path
    x = ins["X"][0]
    scale = ins["Scale"][0] if ins.get("Scale") else None
    bias = ins["Bias"][0] if ins.get("Bias") else None
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    norm_shape = tuple(x.shape[begin:])
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.reshape(norm_shape).to(x.dtype)
    if bias is not None:
        y = y + bias.reshape(norm_shape).to(x.dtype)
    lead = tuple(x.shape[:begin])
    return {
        "Y": [y],
        "Mean": [mean.reshape(lead)],
        "Variance": [var.reshape(lead)],
    }


@register_op("lookup_table_v2", inputs=["W", "Ids"], outputs=["Out"])
def _lookup_table_v2(ctx, op, ins):
    w, ids = ins["W"][0], ins["Ids"][0]
    out = w[ids]
    padding_idx = op.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("lookup_table", inputs=["W", "Ids"], outputs=["Out"])
def _lookup_table(ctx, op, ins):
    # v1 keeps a trailing [.., 1] ids dim (lookup_table_op.cc)
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return _lookup_table_v2(ctx, op, {"W": [w], "Ids": [ids]})


@register_op("dropout", inputs=["X"], outputs=["Out", "Mask"])
def _dropout(ctx, op, ins):
    x = ins["X"][0]
    p = op.attr("dropout_prob", 0.5)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if op.attr("is_test", False) or ctx.is_test or p == 0.0:
        # fluid downgrade_in_infer: test mode scales by 1-p
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": []}
    gen = ctx.key_for(op.uid, op.type)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    kept = x / (1.0 - p) if impl == "upscale_in_train" else x
    out = torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return {"Out": [out.to(x.dtype)], "Mask": [keep.to(torch.uint8)]}


@register_op("softmax_with_cross_entropy", inputs=["Logits", "Label"],
             outputs=["Softmax", "Loss"])
def _softmax_with_cross_entropy(ctx, op, ins):
    """Hard labels, in the JAX package's logsumexp-minus-picked form with
    fp32 statistics: loss = lse(logits) - logits[label], 0 where the
    label is ignore_index."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = op.attr("axis", -1)
    if op.attr("soft_label", False):
        raise UnimplementedError(
            "softmax_with_cross_entropy: soft labels are not in this slice"
        )
    lbl = label if label.dim() == logits.dim() else label.unsqueeze(axis)
    valid = lbl != op.attr("ignore_index", -100)
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
    lf = logits.float()
    m = lf.amax(dim=axis, keepdim=True)
    lse = m + torch.log(torch.exp(lf - m).sum(dim=axis, keepdim=True))
    picked = torch.gather(lf, axis, safe)
    loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    softmax = torch.exp(lf - lse).to(logits.dtype)
    return {"Softmax": [softmax], "Loss": [loss]}
