"""Fused ops backed by hand-written kernels, with their grad ops
(counterpart of paddle_tpu/ops/fused.py; reference
paddle/fluid/operators/fused/).

Each forward op registers a grad maker that appends a dedicated grad op
calling the backward kernel, instead of the generic `__vjp__` replay
(framework/backward.py): the backward kernels need only the primal
inputs and the output gradient, and a replay would run the forward
kernel a second time. The grad op takes the forward op's uid as
`__fwd_uid__` and draws its seed words from it, so the backward
regenerates the forward's dropout mask. On the KV-tiled path the
forward's saved Out and Lse go to the grad op as well."""

from __future__ import annotations

from ..framework.backward import dedicated_grad_maker
from ..framework.registry import register_op
from ..kernels.flash_attention import (
    attention_grads,
    fused_attention,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
    uses_tiled_path,
)
from ..kernels.fused_residual import (
    fused_dropout_add_ln_bwd,
    fused_dropout_add_ln_fwd,
)


def _is_test(ctx, op):
    return bool(op.attr("is_test", False)) or ctx.is_test


def _seed(ctx, op, uid, op_type):
    """The seed words of op `uid` when it trains with dropout, else None."""
    if float(op.attr("dropout_prob", 0.0)) > 0.0 and not _is_test(ctx, op):
        return ctx.seed_words(uid, op_type)
    return None


def _saved_tiled_outs(op, block):
    """On the tiled path the forward saves (Out, Lse): the tiled backward
    kernels read both and never re-run the forward."""
    if op.outputs.get("Lse") and _qkv_tiled_at_build(op, block):
        return {"Out": op.outputs["Out"], "Lse": op.outputs["Lse"]}
    return {}


def _qkv_tiled_at_build(op, block):
    """Build-time mirror of fused_attention_qkv's tiled-path dispatch,
    from the declared shape and dtype of QKV (uses_tiled_path reads no
    device, so the rule holds wherever the program runs)."""
    v = block._find_var_recursive(op.inputs["QKV"][0])
    if v is None or not v.shape or len(v.shape) != 3:
        return False
    H = int(op.attr("num_heads"))
    S, D = int(v.shape[1]), int(v.shape[2]) // 3 // H
    return uses_tiled_path(S, H, D, v.dtype)


def _attention_kw(ctx, op):
    return dict(
        scale=op.attr("scale", None),
        dropout_rate=float(op.attr("dropout_prob", 0.0)),
        is_test=_is_test(ctx, op),
        dropout_implementation=op.attr(
            "dropout_implementation", "downgrade_in_infer"
        ),
        causal=bool(op.attr("causal", False)),
    )


@register_op("fused_multihead_attention", inputs=["Q", "K", "V", "KeyBias"],
             outputs=["Out"],
             grad_maker=dedicated_grad_maker(
                 "fused_multihead_attention_grad", ("Q", "K", "V"),
                 optional=("KeyBias",)))
def _fused_multihead_attention(ctx, op, ins):
    """softmax(Q K^T * scale + KeyBias) V with fused attention-prob
    dropout, Q/K/V [B, H, S, D] and KeyBias an optional additive [B, S]
    (the kernels #5/#6). Out is [B, H, S, D] in Q's dtype."""
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    out = fused_attention(
        ins["Q"][0], ins["K"][0], ins["V"][0], bias,
        seed=_seed(ctx, op, op.uid, op.type), **_attention_kw(ctx, op),
    )
    return {"Out": [out]}


@register_op("fused_multihead_attention_grad",
             inputs=["Q", "K", "V", "KeyBias", "OutGrad"],
             outputs=["QGrad", "KGrad", "VGrad", "KeyBiasGrad"],
             differentiable=False)
def _fused_multihead_attention_grad(ctx, op, ins):
    """Backward of fused_multihead_attention through the backward kernels
    (no forward replay); the mask regenerates from the forward op's seed
    words. KeyBiasGrad is computed only when the op has that output."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    want_dbias = bool(op.outputs.get("KeyBiasGrad")) and bias is not None
    dq, dk, dv, dbias = attention_grads(
        q, k, v, bias, ins["OutGrad"][0],
        seed=_seed(ctx, op, op.attr("__fwd_uid__"),
                   "fused_multihead_attention"),
        want_dbias=want_dbias, **_attention_kw(ctx, op),
    )
    outs = {slot: [g] for slot, g in (("QGrad", dq), ("KGrad", dk),
                                      ("VGrad", dv))
            if op.outputs.get(slot)}
    if want_dbias:
        outs["KeyBiasGrad"] = [dbias.to(bias.dtype)]
    return outs


@register_op("fused_qkv_attention", inputs=["QKV", "KeyBias"],
             outputs=["Out", "Lse"],
             grad_maker=dedicated_grad_maker(
                 "fused_qkv_attention_grad", ("QKV",), optional=("KeyBias",),
                 saved=_saved_tiled_outs))
def _fused_qkv_attention(ctx, op, ins):
    """Attention over the packed qkv projection [B, S, 3*H*D] -> [B, S,
    H*D] (attr num_heads). The kernel reads the projection in place
    through its strides: no head-split copies. On the KV-tiled path (S >
    1024) the op also emits the row logsumexp as `Lse` (fp32 [B, H, S]),
    so the grad op runs the backward without re-running the forward;
    elsewhere `Lse` stays empty."""
    qkv = ins["QKV"][0]
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    out, lse = fused_attention_qkv(
        qkv, int(op.attr("num_heads")), key_bias=bias,
        seed=_seed(ctx, op, op.uid, op.type), return_lse=True,
        **_attention_kw(ctx, op),
    )
    return {"Out": [out], "Lse": [] if lse is None else [lse]}


@register_op("fused_qkv_attention_grad",
             inputs=["QKV", "KeyBias", "OutGrad", "Out", "Lse"],
             outputs=["QKVGrad", "KeyBiasGrad"], differentiable=False)
def _fused_qkv_attention_grad(ctx, op, ins):
    """Backward of fused_qkv_attention through the backward kernels; the
    mask regenerates from the forward op's seed words, and the tiled
    kernels read the forward's saved Out and Lse. KeyBiasGrad is computed
    only when the op has that output."""
    qkv = ins["QKV"][0]
    bias = ins["KeyBias"][0] if ins.get("KeyBias") else None
    want_dbias = bool(op.outputs.get("KeyBiasGrad")) and bias is not None
    d_out = ins["OutGrad"][0].contiguous()
    dqkv, dbias = fused_attention_qkv_bwd(
        qkv, int(op.attr("num_heads")), bias, d_out,
        seed=_seed(ctx, op, op.attr("__fwd_uid__"), "fused_qkv_attention"),
        want_dbias=want_dbias,
        saved_out=ins["Out"][0] if ins.get("Out") else None,
        saved_lse=ins["Lse"][0] if ins.get("Lse") else None,
        **_attention_kw(ctx, op),
    )
    outs = {}
    if op.outputs.get("QKVGrad"):
        outs["QKVGrad"] = [dqkv]
    if want_dbias:
        outs["KeyBiasGrad"] = [dbias.to(bias.dtype)]
    return outs


def _residual_kw(ctx, op):
    return dict(
        rate=float(op.attr("dropout_prob", 0.0)),
        is_test=_is_test(ctx, op),
        upscale=op.attr("dropout_implementation", "downgrade_in_infer")
        == "upscale_in_train",
        eps=float(op.attr("epsilon", 1e-5)),
    )


@register_op("fused_dropout_add_ln", inputs=["X", "Y", "Scale", "LnBias"],
             outputs=["Out"],
             grad_maker=dedicated_grad_maker(
                 "fused_dropout_add_ln_grad", ("X", "Y"),
                 optional=("Scale", "LnBias")))
def _fused_dropout_add_ln(ctx, op, ins):
    """Out = LayerNorm(X + dropout(Y)) over the last axis as one kernel —
    the transformer residual tail. X is the residual, Y the branch output,
    Scale/LnBias the LN affine parameters."""
    x, y = ins["X"][0], ins["Y"][0]
    g = ins["Scale"][0] if ins.get("Scale") else None
    c = ins["LnBias"][0] if ins.get("LnBias") else None
    n = x.shape[-1]
    out2 = fused_dropout_add_ln_fwd(
        x.reshape(-1, n), y.reshape(-1, n), g, c,
        seed=_seed(ctx, op, op.uid, op.type), **_residual_kw(ctx, op),
    )
    return {"Out": [out2.reshape(x.shape)]}


@register_op("fused_dropout_add_ln_grad",
             inputs=["X", "Y", "Scale", "LnBias", "OutGrad"],
             outputs=["XGrad", "YGrad", "ScaleGrad", "LnBiasGrad"],
             differentiable=False)
def _fused_dropout_add_ln_grad(ctx, op, ins):
    """Backward of fused_dropout_add_ln through the backward kernel; the
    mask regenerates from the forward op's seed words."""
    x, y, dout = ins["X"][0], ins["Y"][0], ins["OutGrad"][0]
    g = ins["Scale"][0] if ins.get("Scale") else None
    c = ins["LnBias"][0] if ins.get("LnBias") else None
    n = x.shape[-1]
    dx, dy, dg, dc = fused_dropout_add_ln_bwd(
        x.reshape(-1, n), y.reshape(-1, n), g,
        dout.contiguous().reshape(-1, n),
        seed=_seed(ctx, op, op.attr("__fwd_uid__"), "fused_dropout_add_ln"),
        **_residual_kw(ctx, op),
    )
    outs = {}
    if op.outputs.get("XGrad"):
        outs["XGrad"] = [dx.reshape(x.shape)]
    if op.outputs.get("YGrad"):
        outs["YGrad"] = [dy.reshape(y.shape)]
    if op.outputs.get("ScaleGrad") and g is not None:
        outs["ScaleGrad"] = [dg.to(g.dtype)]
    if op.outputs.get("LnBiasGrad") and c is not None:
        outs["LnBiasGrad"] = [dc.to(c.dtype)]
    return outs
