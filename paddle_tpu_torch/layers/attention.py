"""Fused transformer layers (counterpart of paddle_tpu/layers/attention.py):
attention on [B, H, S, D] heads and on a packed QKV projection, and the
dropout + residual + LayerNorm tail, each one op backed by a hand-written
kernel (paddle_tpu_torch/kernels); and the sequence-parallel attention
ops (parallel/ring_attention.py)."""

from __future__ import annotations

import numpy as np

from ..initializer import Constant
from .helper import LayerHelper


def _attn(op_type, q, k, v, axis_name, causal, scale, name):
    helper = LayerHelper(op_type, name=name)
    return helper.create_and_append(
        {"Q": [q], "K": [k], "V": [v]},
        {"axis_name": axis_name, "causal": causal, "scale": scale},
    )


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                   name=None):
    """q, k, v: [B, H, S, D] with S sharded over `axis_name` under SPMD
    (dense attention when the program has no such mesh axis)."""
    return _attn("ring_attention", q, k, v, axis_name, causal, scale, name)


def ulysses_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                      name=None):
    return _attn("ulysses_attention", q, k, v, axis_name, causal, scale, name)


def fused_multihead_attention(
    q,
    k,
    v,
    key_bias=None,
    scale=None,
    dropout_prob=0.0,
    is_test=False,
    dropout_implementation="downgrade_in_infer",
    causal=False,
    name=None,
):
    """softmax(q k^T * scale + key_bias) v in one op, q/k/v [B, H, S, D]
    (the head-split layout of ERNIE's multi_head_attention); key_bias an
    optional additive [B, S] (0 keep / -1e4 pad); fluid dropout on the
    probabilities. Reference: the fused CUDA attention of
    operators/fused/multihead_matmul_op.cu, with mask and dropout."""
    helper = LayerHelper("fused_multihead_attention", name=name)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    attrs = {
        "dropout_prob": dropout_prob,
        "is_test": is_test,
        "dropout_implementation": dropout_implementation,
        "causal": causal,
    }
    if scale is not None:
        attrs["scale"] = float(scale)
    return helper.create_and_append(inputs, attrs)


def fused_qkv_attention(
    qkv,
    num_heads,
    key_bias=None,
    scale=None,
    dropout_prob=0.0,
    is_test=False,
    dropout_implementation="downgrade_in_infer",
    causal=False,
    name=None,
):
    """Attention over a packed qkv projection [B, S, 3*H*D] -> [B, S, H*D]:
    softmax(q k^T * scale + key_bias) v per head, key_bias an additive
    [B, S] (0 keep / -1e4 pad), fluid dropout semantics."""
    helper = LayerHelper("fused_qkv_attention", name=name)
    inputs = {"QKV": [qkv]}
    if key_bias is not None:
        inputs["KeyBias"] = [key_bias]
    attrs = {
        "num_heads": int(num_heads),
        "dropout_prob": dropout_prob,
        "is_test": is_test,
        "dropout_implementation": dropout_implementation,
        "causal": causal,
    }
    if scale is not None:
        attrs["scale"] = float(scale)
    out, _lse = helper.create_and_append(
        inputs, attrs, out_slots=("Out", "Lse")
    )
    return out


def fused_dropout_add_ln(
    x,
    y,
    dropout_prob=0.0,
    is_test=False,
    dropout_implementation="downgrade_in_infer",
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    name=None,
):
    """LayerNorm(x + dropout(y)) over the last axis as one op. x is the
    residual stream, y the branch output; the LN affine parameters are
    created here, with the names an equivalent layer_norm would use."""
    helper = LayerHelper("fused_dropout_add_ln", name=name)
    norm_shape = [int(np.prod(x.shape[-1:]))]
    s = helper.create_parameter(
        param_attr, norm_shape, x.dtype, default_initializer=Constant(1.0)
    )
    b = helper.create_parameter(bias_attr, norm_shape, x.dtype, is_bias=True)
    return helper.create_and_append(
        {"X": [x], "Y": [y], "Scale": [s], "LnBias": [b]},
        {
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "dropout_implementation": dropout_implementation,
            "epsilon": epsilon,
        },
    )
