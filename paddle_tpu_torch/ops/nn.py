"""NN ops of the port's slices (counterpart of paddle_tpu/ops/nn.py;
reference conv_op.cc, conv_transpose_op.cc, pool_op.cc, batch_norm_op.cc,
layer_norm_op.cc, lookup_table_op.cc, lookup_table_v2_op.cc, dropout_op.cc,
softmax_with_cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, square_error_cost (the
squared-error loss of fluid's fit-a-line), pad2d_op.cc,
interpolate_op.cc).

conv2d runs through F.conv2d (cuDNN on the card), as the JAX package
leaves its convolutions to XLA. batch_norm is the JAX package's formula,
not F.batch_norm's: one-pass fp32 statistics, the biased variance in the
running update, and the normalisation as one per-channel affine in the
input's dtype."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..errors import UnimplementedError
from ..flags import flag
from ..framework import unique_name
from ..framework.backward import _ensure_var
from ..framework.program import grad_var_name
from ..framework.registry import get_op_def, register_op
from ..kernels import layer_norm as lnk
from ._helpers import stable_sigmoid_ce


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def _conv_pads(paddings, algorithm, ksize, strides, dilations, in_hw):
    """[(top, bottom), (left, right)] of a convolution: fluid's 2- or
    4-element paddings, or lax's SAME (the output is ceil(in / stride),
    the odd pixel of padding at the end) and VALID."""
    if algorithm == "VALID":
        return [(0, 0), (0, 0)]
    if algorithm == "SAME":
        pads = []
        for n, k, s, d in zip(in_hw, ksize, strides, dilations):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    p = _pair(paddings)
    if len(p) == 2:
        return [(p[0], p[0]), (p[1], p[1])]
    # [top, bottom, left, right]
    return [(p[0], p[1]), (p[2], p[3])]


@register_op("conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def _conv2d(ctx, op, ins):
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = _pair(op.attr("strides", [1, 1]))
    dilations = _pair(op.attr("dilations", [1, 1]))
    (top, bottom), (left, right) = _conv_pads(
        op.attr("paddings", [0, 0]),
        op.attr("padding_algorithm", "EXPLICIT"),
        w.shape[2:], strides, dilations, x.shape[2:],
    )
    if top == bottom and left == right:
        padding = (top, left)
    else:
        # F.conv2d pads symmetrically only
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    out = F.conv2d(x, w, stride=strides, padding=padding,
                   dilation=dilations, groups=op.attr("groups", 1) or 1)
    return {"Output": [out]}


@register_op("conv2d_transpose", inputs=["Input", "Filter"],
             outputs=["Output"])
def _conv2d_transpose(ctx, op, ins):
    """The gradient of a convolution with respect to its input: fluid's
    filter [in_c, out_c / groups, kh, kw] is F.conv_transpose2d's layout,
    and the output side is (in - 1) * stride - 2 * padding + k, the JAX
    package's lhs-dilated form with kh - 1 - padding a side."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv_transpose2d(
        x, w, stride=_pair(op.attr("strides", [1, 1])),
        padding=_pair(op.attr("paddings", [0, 0]))[:2],
        groups=op.attr("groups", 1) or 1)
    return {"Output": [out]}


@register_op("pool2d", inputs=["X"], outputs=["Out"])
def _pool2d(ctx, op, ins):
    x = ins["X"][0]
    ptype = op.attr("pooling_type", "max")
    if op.attr("global_pooling", False) or op.attr("adaptive", False) \
            and op.attr("ksize") == [1, 1]:
        out = (x.amax(dim=(2, 3), keepdim=True) if ptype == "max"
               else x.mean(dim=(2, 3), keepdim=True))
        return {"Out": [out]}
    if op.attr("adaptive", False):
        oh, ow = _pair(op.attr("ksize"))
        n, c, h, wd = x.shape
        xr = x.reshape(n, c, oh, h // oh, ow, wd // ow)
        out = (xr.amax(dim=(3, 5)) if ptype == "max"
               else xr.mean(dim=(3, 5)))
        return {"Out": [out]}
    ksize = _pair(op.attr("ksize"))
    strides = _pair(op.attr("strides", [1, 1]))
    p = _pair(op.attr("paddings", [0, 0]))
    pads = (p[1], p[1], p[0], p[0])
    if ptype == "max":
        # padded with -inf (the JAX package's reduce_window init) before
        # the pooling: F.max_pool2d refuses a pad above half the window
        low = (-math.inf if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        out = F.max_pool2d(F.pad(x, pads, value=low), ksize, strides)
    else:
        # window sums over zero padding, divided by the window's size or,
        # exclusive, by its count of real pixels
        summed = F.avg_pool2d(F.pad(x, pads), ksize, strides,
                              divisor_override=1)
        if op.attr("exclusive", True) and (p[0] or p[1]):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            counts = F.avg_pool2d(F.pad(ones, pads), ksize, strides,
                                  divisor_override=1)
            out = summed / counts
        else:
            out = summed / (ksize[0] * ksize[1])
    return {"Out": [out]}


@register_op(
    "batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    mutates=(("MeanOut", "Mean"), ("VarianceOut", "Variance")),
)
def _batch_norm(ctx, op, ins):
    x, scale, bias, mean, var = (ins[k][0] for k in
                                 ("X", "Scale", "Bias", "Mean", "Variance"))
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    channel = 1 if op.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != channel)
    bshape = [1] * x.dim()
    bshape[channel] = x.shape[channel]
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        # one pass, E[x^2] - E[x]^2 accumulated in fp32 and clamped at 0;
        # the running statistics take the biased batch variance. The
        # squares are products: torch.square's backward (pow's) copies
        # its exponent to the card, a synchronisation each
        use_mean = torch.mean(x, dim=axes, dtype=torch.float32)
        xf = x.float()
        m2 = torch.mean(xf * xf, dim=axes)
        use_var = torch.clamp(m2 - use_mean * use_mean, min=0.0)
        mean_out = mean * momentum + use_mean.to(mean.dtype) * (1 - momentum)
        var_out = var * momentum + use_var.to(var.dtype) * (1 - momentum)
    # y = x * a + b with a, b per channel from fp32, applied in x's dtype
    inv = torch.rsqrt(use_var.float() + eps)
    a = scale.float() * inv
    b = bias.float() - use_mean.float() * a
    y = x * a.to(x.dtype).reshape(bshape) + b.to(x.dtype).reshape(bshape)
    return {
        "Y": [y],
        "MeanOut": [mean_out],
        "VarianceOut": [var_out],
        "SavedMean": [use_mean],
        "SavedVariance": [use_var],
    }


def _ln_use_kernel(x, begin):
    """(take the standalone LayerNorm kernels?, rows, n): the flag and the
    kernels' shape and dtype predicate, as the JAX package's
    `_ln_use_pallas` (paddle_tpu/ops/nn.py:206). Its TPU-backend clause is
    the JAX package's way of saying that the kernel exists there; in the
    port the wrapper decides kernel or plain version by the tensor's
    device, so the CPU's plain versions take the same branch as the card's
    kernels and one program runs anywhere."""
    rows = math.prod(x.shape[:begin])
    n = math.prod(x.shape[begin:])
    return (bool(flag("paddle_tpu_pallas_layer_norm"))
            and lnk.supports(rows, n, x.dtype)), rows, n


def _opt(ins, slot):
    return ins[slot][0] if ins.get(slot) and ins[slot][0] is not None \
        else None


@register_op("layer_norm", inputs=["X", "Scale", "Bias"],
             outputs=["Y", "Mean", "Variance"])
def _layer_norm(ctx, op, ins):
    x = ins["X"][0]
    scale, bias = _opt(ins, "Scale"), _opt(ins, "Bias")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    use_kernel, rows, n = _ln_use_kernel(x, begin)
    if use_kernel:
        # the standalone kernels (#10): fp32 statistics in registers, one
        # read and one write of the row. The autograd-aware entry lets the
        # generic __vjp__ replay differentiate through the kernel when the
        # dedicated grad op declines (a loss reading Mean or Variance)
        y2, mean, var = lnk.layer_norm_fwd_diff(
            x.reshape(rows, n),
            None if scale is None else scale.reshape(n),
            None if bias is None else bias.reshape(n),
            eps,
        )
        return {"Y": [y2.reshape(x.shape)], "Mean": [mean.reshape(lead)],
                "Variance": [var.reshape(lead)]}
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
    return {
        "Y": [y],
        "Mean": [mean.reshape(lead)],
        "Variance": [var.reshape(lead)],
    }


def _layer_norm_grad_maker(op, block, contribs, finalize, needs_grad=None):
    """The dedicated grad op, emitted only when the flag is on as the
    program is built (the JAX package's rule: with the plain formulation
    the generic __vjp__ replay serves). Declines, for the generic
    __vjp__, when the Mean or Variance outputs carry gradients."""
    if not flag("paddle_tpu_pallas_layer_norm"):
        return False
    for aux in ("Mean", "Variance"):
        names = op.outputs.get(aux) or []
        if names and names[0] in contribs:
            return False
    g_out = finalize(op.outputs["Y"][0])
    if g_out is None:
        return
    inputs = {"X": op.inputs["X"], "YGrad": [g_out]}
    for slot in ("Scale", "Bias"):
        if op.inputs.get(slot):
            inputs[slot] = op.inputs[slot]
    outs = {}
    for slot in ("X", "Scale", "Bias"):
        names = op.inputs.get(slot) or []
        if not names or not names[0]:
            continue
        n = names[0]
        if needs_grad is not None and n not in needs_grad:
            continue
        gname = unique_name.generate(grad_var_name(n) + "@RENAME")
        _ensure_var(block, gname, n)
        outs[slot + "Grad"] = [gname]
        contribs.setdefault(n, []).append(gname)
    if not outs:
        return
    attrs = {k: v for k, v in op.attrs.items()
             if k not in ("__uid__", "__loc__")}
    block.append_op("layer_norm_grad", inputs, outs, attrs)


get_op_def("layer_norm").grad_maker = _layer_norm_grad_maker


@register_op("layer_norm_grad", inputs=["X", "Scale", "Bias", "YGrad"],
             outputs=["XGrad", "ScaleGrad", "BiasGrad"], differentiable=False)
def _layer_norm_grad(ctx, op, ins):
    """Backward of layer_norm: the kernel (#11) where the forward takes
    the kernel (the flag read as the op runs, as the JAX package reads it
    as the step is traced), else the two-pass formulas of the JAX
    package's jnp branch. ScaleGrad and BiasGrad come back in the scale's
    and bias's dtypes."""
    x, dy = ins["X"][0], ins["YGrad"][0]
    scale = _opt(ins, "Scale")
    eps = op.attr("epsilon", 1e-5)
    begin = op.attr("begin_norm_axis", 1)
    use_kernel, rows, n = _ln_use_kernel(x, begin)
    if use_kernel:
        dx2, ds, db = lnk.layer_norm_bwd(
            x.reshape(rows, n),
            None if scale is None else scale.reshape(n),
            dy.reshape(rows, n).contiguous(), eps,
        )
        dx = dx2.reshape(x.shape)
    else:
        axes = tuple(range(begin, x.dim()))
        xf, dyf = x.float(), dy.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, unbiased=False, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        xhat = (xf - mean) * rstd
        sf = (scale.reshape(x.shape[begin:]).float() if scale is not None
              else 1.0)
        dyw = dyf * sf
        m1 = dyw.mean(dim=axes, keepdim=True)
        m2 = (dyw * xhat).mean(dim=axes, keepdim=True)
        dx = (rstd * (dyw - m1 - xhat * m2)).to(x.dtype)
        lead_axes = tuple(range(begin))
        ds = (dyf * xhat).sum(dim=lead_axes).reshape(-1)
        db = dyf.sum(dim=lead_axes).reshape(-1)
    outs = {}
    if op.outputs.get("XGrad"):
        outs["XGrad"] = [dx]
    if op.outputs.get("ScaleGrad"):
        outs["ScaleGrad"] = [ds.reshape(scale.shape).to(scale.dtype)]
    if op.outputs.get("BiasGrad"):
        b = ins["Bias"][0]
        outs["BiasGrad"] = [db.reshape(b.shape).to(b.dtype)]
    return outs


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


@register_op("sigmoid_cross_entropy_with_logits", inputs=["X", "Label"],
             outputs=["Out"])
def _sigmoid_cross_entropy_with_logits(ctx, op, ins):
    """Elementwise stable sigmoid cross-entropy (_helpers.stable_sigmoid_ce),
    0 where the label is ignore_index; with normalize, divided by the
    count of labels that are not (at least 1)."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore = op.attr("ignore_index", -100)
    keep = label != ignore
    loss = torch.where(keep, stable_sigmoid_ce(x, label), x.new_zeros(()))
    if op.attr("normalize", False):
        loss = loss / keep.to(x.dtype).sum().clamp(min=1.0)
    return {"Out": [loss]}


@register_op("square_error_cost", inputs=["X", "Y"], outputs=["Out"])
def _square_error_cost(ctx, op, ins):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": [d * d]}


@register_op("pad2d", inputs=["X"], outputs=["Out"])
def _pad2d(ctx, op, ins):
    p = op.attr("paddings")  # [top, bottom, left, right]
    mode = op.attr("mode", "constant")
    pads = (p[2], p[3], p[0], p[1])
    if mode == "constant":
        out = F.pad(ins["X"][0], pads, value=op.attr("pad_value", 0.0))
    else:
        out = F.pad(ins["X"][0], pads,
                    mode={"reflect": "reflect", "edge": "replicate"}[mode])
    return {"Out": [out]}


@register_op("nearest_interp", inputs=["X"], outputs=["Out"])
def _nearest_interp(ctx, op, ins):
    x = ins["X"][0]
    n, c, h, w = x.shape
    oh = op.attr("out_h", 0) or int(h * op.attr("scale", 1.0))
    ow = op.attr("out_w", 0) or int(w * op.attr("scale", 1.0))
    if oh % h == 0 and ow % w == 0 and not op.attr("align_corners", False):
        # an integer upscale (the FPN neck's x2): a broadcast, whose
        # gradient is a block sum, as the JAX package's
        fh, fw = oh // h, ow // w
        out = x[:, :, :, None, :, None].expand(n, c, h, fh, w, fw)
        return {"Out": [out.reshape(n, c, oh, ow)]}
    # jax.image.resize's nearest: half-pixel centres, floor((o + 0.5) *
    # in / out), which is nearest-exact (mode="nearest" drops the 0.5)
    return {"Out": [F.interpolate(x, size=(oh, ow), mode="nearest-exact")]}
