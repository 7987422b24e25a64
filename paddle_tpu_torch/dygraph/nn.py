"""Eager module zoo (counterpart of paddle_tpu/dygraph/nn.py; reference
dygraph/nn.py: Conv2D :42, Linear :888, BatchNorm :1125, Embedding :1472,
LayerNorm :1632, Pool2D, Dropout, GRUUnit :1806). Each module owns
ParamBase weights and calls the shared op emitters through the tracer:
one op set for both execution modes."""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..initializer import Constant, Normal, Xavier
from .base import current_device
from .layers import Layer
from .tracer import trace_op, trace_op_multi
from .varbase import VarBase


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [input_dim, output_dim], dtype, attr=param_attr, initializer=Xavier()
        )
        self.bias = (
            self.create_parameter([output_dim], dtype, attr=bias_attr,
                                  is_bias=True)
            if bias_attr is not False
            else None
        )
        self._act = act

    def forward(self, x):
        out = trace_op(
            "mul", {"X": [x], "Y": [self.weight]},
            {"x_num_col_dims": len(x.shape) - 1, "y_num_col_dims": 1},
        )
        if self.bias is not None:
            out = trace_op(
                "elementwise_add", {"X": [out], "Y": [self.bias]},
                {"axis": len(x.shape) - 1},
            )
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})
        return out


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        k = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
        groups = groups or 1
        std = (2.0 / (k[0] * k[1] * num_channels)) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, k[0], k[1]], dtype,
            attr=param_attr, initializer=Normal(0.0, std),
        )
        self.bias = (
            self.create_parameter([num_filters], dtype, attr=bias_attr,
                                  is_bias=True)
            if bias_attr is not False
            else None
        )
        self._attrs = {
            "strides": list(stride) if isinstance(stride, (list, tuple)) else [stride] * 2,
            "paddings": list(padding) if isinstance(padding, (list, tuple)) else [padding] * 2,
            "dilations": list(dilation) if isinstance(dilation, (list, tuple)) else [dilation] * 2,
            "groups": groups,
            "padding_algorithm": "EXPLICIT",
        }
        self._act = act

    def forward(self, x):
        out = trace_op_multi(
            "conv2d", {"Input": [x], "Filter": [self.weight]}, self._attrs
        )["Output"][0]
        if self.bias is not None:
            out = trace_op(
                "elementwise_add", {"X": [out], "Y": [self.bias]}, {"axis": 1}
            )
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, exclusive=True):
        super().__init__()
        self._attrs = {
            "ksize": list(pool_size) if isinstance(pool_size, (list, tuple)) else [pool_size] * 2,
            "pooling_type": pool_type,
            "strides": list(pool_stride) if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 2,
            "paddings": list(pool_padding) if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 2,
            "global_pooling": global_pooling,
            "exclusive": exclusive,
        }

    def forward(self, x):
        return trace_op("pool2d", {"X": [x]}, self._attrs)


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", use_global_stats=False):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [num_channels], dtype, attr=param_attr, initializer=Constant(1.0)
        )
        self.bias = self.create_parameter(
            [num_channels], dtype, attr=bias_attr, is_bias=True
        )
        like = dict(dtype=to_torch_dtype(dtype), device=current_device())
        self._mean = self.register_buffer(
            "_mean_buf", torch.zeros([num_channels], **like)
        )
        self._variance = self.register_buffer(
            "_var_buf", torch.ones([num_channels], **like)
        )
        self._attrs = {
            "momentum": momentum,
            "epsilon": epsilon,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        }
        self._act = act

    def forward(self, x):
        attrs = dict(self._attrs)
        attrs["is_test"] = not self.training
        outs = trace_op_multi(
            "batch_norm",
            {
                "X": [x],
                "Scale": [self.weight],
                "Bias": [self.bias],
                "Mean": [self._mean],
                "Variance": [self._variance],
            },
            attrs,
        )
        y = outs["Y"][0]
        if self.training:
            # running-stat update: the op's functional outputs written back
            # into the buffers in place, outside autograd
            self._mean.set_value(outs["MeanOut"][0])
            self._variance.set_value(outs["VarianceOut"][0])
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            list(size), dtype, attr=param_attr, initializer=Xavier()
        )
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return trace_op(
            "lookup_table_v2",
            {"W": [self.weight], "Ids": [ids]},
            {"padding_idx": self._padding_idx},
        )


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self._norm_rank = len(normalized_shape)
        self.weight = (
            self.create_parameter([n], dtype, attr=param_attr,
                                  initializer=Constant(1.0))
            if scale
            else None
        )
        self.bias = (
            self.create_parameter([n], dtype, attr=bias_attr, is_bias=True)
            if shift
            else None
        )
        self._epsilon = epsilon
        self._act = act

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        y = trace_op_multi(
            "layer_norm",
            ins,
            {
                "begin_norm_axis": len(x.shape) - self._norm_rank,
                "epsilon": self._epsilon,
            },
        )["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})
        return y


class Dropout(Layer):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        return trace_op(
            "dropout", {"X": [x]},
            {"dropout_prob": self._p, "is_test": not self.training,
             "dropout_implementation": "upscale_in_train"},
        )


class GRUUnit(Layer):
    """Single GRU step (reference dygraph/nn.py:1806): gate/candidate weights
    packed fluid-style: weight [D, 3D] (update|reset|cand)."""

    def __init__(self, size, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        d = size // 3
        self._d = d
        self.weight = self.create_parameter([d, d * 3], dtype, attr=param_attr)
        self.bias = (
            self.create_parameter([1, d * 3], dtype, attr=bias_attr, is_bias=True)
            if bias_attr is not False
            else None
        )

    def forward(self, inputs, hidden):
        # inputs [B, 3D] (x projections), hidden [B, D]
        d = self._d
        gates_x = inputs
        if self.bias is not None:
            gates_x = trace_op(
                "elementwise_add", {"X": [gates_x], "Y": [self.bias]},
                {"axis": -1},
            )
        hw = trace_op("matmul", {"X": [hidden], "Y": [self.weight]}, {})
        xu, xr, xc = (gates_x[:, :d], gates_x[:, d:2 * d], gates_x[:, 2 * d:])
        hu, hr, hc = (hw[:, :d], hw[:, d:2 * d], hw[:, 2 * d:])
        u = trace_op("sigmoid", {"X": [xu + hu]}, {})
        r = trace_op("sigmoid", {"X": [xr + hr]}, {})
        c = trace_op("tanh", {"X": [xc + r * hc]}, {})
        one = VarBase(torch.ones_like(u.value))
        h = u * hidden + (one - u) * c
        return h, h, c
