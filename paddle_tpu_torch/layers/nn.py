"""Functional layers of the port's slices (counterpart of
paddle_tpu/layers/nn.py; reference python/paddle/fluid/layers/nn.py):
data, fc, embedding, conv2d, conv2d_transpose, pool2d, adaptive_pool2d,
batch_norm, layer_norm, dropout, softmax_with_cross_entropy,
sigmoid_cross_entropy_with_logits, sparse_embedding, mean, accuracy,
resize_nearest."""

from __future__ import annotations

import numpy as np

from ..framework import unique_name
from ..framework.program import default_main_program
from ..initializer import Constant, Normal, Xavier
from ..param_attr import ParamAttr
from .helper import LayerHelper, main_block


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False):
    """fluid.data: declare a feed variable (-1 marks the batch dim)."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().global_block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        is_data=True,
        stop_gradient=True,
        lod_level=lod_level,
    )


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    helper = LayerHelper("fc", name=name)
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_dim, size], input.dtype)
    out = helper.create_and_append(
        {"X": [input], "Y": [w]},
        {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        op_type="mul",
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype, is_bias=True)
        out = helper.create_and_append(
            {"X": [out], "Y": [b]},
            {"axis": num_flatten_dims},
            op_type="elementwise_add",
        )
    return _apply_act(out, act)


def _apply_act(out, act):
    if act is None:
        return out
    return LayerHelper(act).create_and_append({"X": [out]}, {}, op_type=act)


def embedding(input, size, is_sparse=False, padding_idx=None, param_attr=None,
              dtype="float32", name=None):
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(
        param_attr, list(size), dtype, default_initializer=Xavier()
    )
    return helper.create_and_append(
        {"W": [w], "Ids": [input]},
        {"padding_idx": -1 if padding_idx is None else padding_idx},
        op_type=(
            "lookup_table_v2"
            if (input.shape and input.shape[-1] != 1) else "lookup_table"
        ),
    )


def _two(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           data_format="NCHW"):
    """NCHW convolution; the filter defaults to Normal(0, sqrt(2 /
    fan_in)), fan_in = kh * kw * input channels."""
    helper = LayerHelper("conv2d", name=name)
    k = _two(filter_size)
    groups = groups or 1
    num_channels = input.shape[1]
    w_shape = [num_filters, num_channels // groups, k[0], k[1]]
    std = (2.0 / (k[0] * k[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        param_attr, w_shape, input.dtype, default_initializer=Normal(0.0, std)
    )
    attrs = {
        "strides": _two(stride),
        "paddings": _two(padding),
        "dilations": _two(dilation),
        "groups": groups,
        "padding_algorithm": "EXPLICIT",
    }
    out = helper.create_and_append(
        {"Input": [input], "Filter": [w]}, attrs, out_slots=("Output",)
    )
    if bias_attr is not False:
        b = helper.create_parameter(
            bias_attr, [num_filters], input.dtype, is_bias=True
        )
        out = helper.create_and_append(
            {"X": [out], "Y": [b]}, {"axis": 1}, op_type="elementwise_add"
        )
    return _apply_act(out, act)


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     groups=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    """Transposed NCHW convolution; the filter [in_c, num_filters /
    groups, kh, kw] defaults to Xavier."""
    helper = LayerHelper("conv2d_transpose", name=name)
    k = _two(filter_size)
    w_shape = [input.shape[1], num_filters // (groups or 1), k[0], k[1]]
    w = helper.create_parameter(param_attr, w_shape, input.dtype)
    attrs = {
        "strides": _two(stride),
        "paddings": _two(padding),
        "groups": groups or 1,
    }
    out = helper.create_and_append(
        {"Input": [input], "Filter": [w]}, attrs, out_slots=("Output",)
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.create_and_append(
            {"X": [out], "Y": [b]}, {"axis": 1}, op_type="elementwise_add"
        )
    return _apply_act(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    helper = LayerHelper("pool2d", name=name)
    attrs = {
        "ksize": _two(pool_size),
        "pooling_type": pool_type,
        "strides": _two(pool_stride),
        "paddings": _two(pool_padding),
        "global_pooling": global_pooling,
        "exclusive": exclusive,
    }
    return helper.create_and_append({"X": [input]}, attrs)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    # pool_type defaults to max, as fluid's adaptive_pool2d
    helper = LayerHelper("pool2d", name=name)
    attrs = {
        "ksize": _two(pool_size),
        "pooling_type": pool_type,
        "adaptive": True,
    }
    return helper.create_and_append({"X": [input]}, attrs)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW", name=None,
               use_global_stats=False, moving_mean_name=None,
               moving_variance_name=None):
    """Scale and bias are trainable parameters; the running mean and
    variance are untrainable ones (`bn_mean_N`, `bn_variance_N`, or the
    given names, so a separately built inference program shares them),
    which the op's MeanOut and VarianceOut overwrite each training run."""
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype if input.dtype != "float16" else "float32"
    scale = helper.create_parameter(
        param_attr, [c], dtype, default_initializer=Constant(1.0)
    )
    bias = helper.create_parameter(bias_attr, [c], dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name or unique_name.generate("bn_mean"),
                  trainable=False, initializer=Constant(0.0)),
        [c], dtype,
    )
    var = helper.create_parameter(
        ParamAttr(
            name=moving_variance_name or unique_name.generate("bn_variance"),
            trainable=False, initializer=Constant(1.0)),
        [c], dtype,
    )
    mean.stop_gradient = True
    var.stop_gradient = True

    blk = main_block()
    y = blk.create_var(name=unique_name.generate("batch_norm.y"),
                       shape=input.shape, dtype=input.dtype)
    saved_mean = blk.create_var(name=unique_name.generate("batch_norm.sm"),
                                shape=[c], dtype=dtype, stop_gradient=True)
    saved_var = blk.create_var(name=unique_name.generate("batch_norm.sv"),
                               shape=[c], dtype=dtype, stop_gradient=True)
    blk.append_op(
        "batch_norm",
        {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
         "Mean": [mean.name], "Variance": [var.name]},
        {"Y": [y.name], "MeanOut": [mean.name], "VarianceOut": [var.name],
         "SavedMean": [saved_mean.name], "SavedVariance": [saved_var.name]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout, "use_global_stats": use_global_stats},
    )
    return _apply_act(y, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    s = (
        helper.create_parameter(
            param_attr, norm_shape, input.dtype,
            default_initializer=Constant(1.0),
        )
        if scale else None
    )
    b = (
        helper.create_parameter(bias_attr, norm_shape, input.dtype, is_bias=True)
        if shift else None
    )
    ins = {"X": [input]}
    if s is not None:
        ins["Scale"] = [s]
    if b is not None:
        ins["Bias"] = [b]
    y, _, _ = helper.create_and_append(
        ins,
        {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
        out_slots=("Y", "Mean", "Variance"),
    )
    return y


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out, _ = helper.create_and_append(
        {"X": [x]},
        {
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "dropout_implementation": dropout_implementation,
            "seed": seed or 0,
        },
        out_slots=("Out", "Mask"),
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax, loss = helper.create_and_append(
        {"Logits": [logits], "Label": [label]},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
        out_slots=("Softmax", "Loss"),
    )
    return (loss, softmax) if return_softmax else loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    return LayerHelper("sigmoid_cross_entropy_with_logits").create_and_append(
        {"X": [x], "Label": [label]},
        {"ignore_index": ignore_index, "normalize": normalize},
    )


def sparse_embedding(input, size, param_attr=None, dtype="float32", axis="ps",
                     pad_to_multiple=8, is_sparse=True, dedup=True):
    """The huge-embedding lookup (reference distributed_lookup_table_op.cc).
    `size=[vocab, dim]`; vocab is padded up to a multiple of
    `pad_to_multiple`. `dedup` (default on) batch-uniques the ids before
    the gather, so repeated ids read their row once and the backward is
    one segment-sum scatter. Same-width lookups coalesce into one
    ``fused_lookup_table`` under ``embedding.fuse_lookups``."""
    vocab, dim = size
    padded = (vocab + pad_to_multiple - 1) // pad_to_multiple * pad_to_multiple
    helper = LayerHelper("sparse_embedding")
    w = helper.create_parameter(
        param_attr, [padded, dim], dtype, default_initializer=Xavier()
    )
    return helper.create_and_append(
        {"Ids": [input], "W": [w]},
        {"axis_name": axis, "dedup": bool(dedup)},
        op_type="distributed_lookup_table",
    )


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost")
    return helper.create_and_append({"X": [input], "Y": [label]}, {})


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    return helper.create_and_append({"X": [x]}, {})


def accuracy(input, label, k=1):
    """Top-k accuracy of `input` (scores) against `label`: a top_k op and
    an accuracy op, neither differentiable."""
    helper = LayerHelper("accuracy")
    topk_out, topk_idx = helper.create_and_append(
        {"X": [input]}, {"k": k}, op_type="top_k", out_slots=("Out", "Indices"),
        stop_gradient=True,
    )
    acc, _, _ = helper.create_and_append(
        {"Out": [topk_out], "Indices": [topk_idx], "Label": [label]},
        {},
        op_type="accuracy",
        out_slots=("Accuracy", "Correct", "Total"),
        stop_gradient=True,
    )
    return acc


def resize_nearest(input, out_shape=None, scale=None, name=None):
    """Nearest-neighbour resize (reference layers/nn.py resize_nearest ->
    nearest_interp_op.cc); out_shape [H, W] or a scale factor."""
    helper = LayerHelper("nearest_interp", name=name)
    attrs = _resize_attrs(out_shape, scale)
    return helper.create_and_append({"X": [input]}, attrs,
                                    op_type="nearest_interp")


def _resize_attrs(out_shape, scale):
    if out_shape is None and scale is None:
        raise ValueError("one of out_shape and scale must be set")
    attrs = {}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    return attrs
