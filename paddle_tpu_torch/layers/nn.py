"""Functional layers of the serving and training slices (counterpart of
paddle_tpu/layers/nn.py; reference python/paddle/fluid/layers/nn.py):
data, fc, embedding, layer_norm, dropout, softmax_with_cross_entropy,
mean."""

from __future__ import annotations

import numpy as np

from ..framework.program import default_main_program
from ..initializer import Constant, Xavier
from .helper import LayerHelper


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


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    return helper.create_and_append({"X": [x]}, {})
