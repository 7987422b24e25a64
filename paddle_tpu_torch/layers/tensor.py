"""Tensor layers of the port's slices (counterpart of
paddle_tpu/layers/tensor.py; reference python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

import numpy as np

from .helper import LayerHelper


def _simple(op_type, ins, attrs, out_slots=("Out",), **kw):
    return LayerHelper(op_type).create_and_append(
        ins, attrs, out_slots=out_slots, **kw
    )


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    return helper.create_and_append(
        {}, {"shape": list(shape), "dtype": dtype, "value": float(value)},
        stop_gradient=True,
    )


def reshape(x, shape, inplace=False, name=None):
    out, _ = _simple(
        "reshape2", {"X": [x]}, {"shape": list(shape)},
        out_slots=("Out", "XShape"),
    )
    return out


def transpose(x, perm, name=None):
    out, _ = _simple(
        "transpose2", {"X": [x]}, {"axis": list(perm)},
        out_slots=("Out", "XShape"),
    )
    return out


def slice(input, axes, starts, ends):
    return _simple(
        "slice",
        {"Input": [input]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return _simple(
        "matmul",
        {"X": [x], "Y": [y]},
        {"transpose_X": transpose_x, "transpose_Y": transpose_y,
         "alpha": alpha},
    )


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    return _simple(
        "scale",
        {"X": [x]},
        {"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale},
    )


def range(start, end, step, dtype):
    return _simple(
        "range", {}, {"start": start, "end": end, "step": step, "dtype": dtype},
        stop_gradient=True,
    )


def softmax(input, axis=-1, use_cudnn=False, name=None):
    return _simple("softmax", {"X": [input]}, {"axis": axis})


def cast(x, dtype):
    return _simple("cast", {"X": [x]}, {"out_dtype": dtype})


def concat(input, axis=0, name=None):
    return _simple("concat", {"X": list(input)}, {"axis": axis})


def gather(input, index, overwrite=True):
    return _simple("gather", {"X": [input], "Index": [index]}, {})


def _reduce(op_type, input, dim, keep_dim):
    attrs = {
        "dim": [dim] if isinstance(dim, int) else (list(dim) if dim else [0]),
        "keep_dim": keep_dim,
        "reduce_all": dim is None,
    }
    return _simple(op_type, {"X": [input]}, attrs)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim)


def square(x, name=None):
    return _simple("square", {"X": [x]}, {})


def pow(x, factor=1.0, name=None):
    return _simple("pow", {"X": [x]}, {"factor": factor})


def _binary(op_type):
    def fn(x, y, axis=-1, name=None):
        return _simple(op_type, {"X": [x], "Y": [y]}, {"axis": axis})

    fn.__name__ = op_type
    return fn


elementwise_add = _binary("elementwise_add")
elementwise_sub = _binary("elementwise_sub")
elementwise_mul = _binary("elementwise_mul")
elementwise_div = _binary("elementwise_div")
elementwise_max = _binary("elementwise_max")
elementwise_min = _binary("elementwise_min")
elementwise_pow = _binary("elementwise_pow")
elementwise_mod = _binary("elementwise_mod")
equal = _binary("equal")
not_equal = _binary("not_equal")
less_than = _binary("less_than")
greater_equal = _binary("greater_equal")


def _unary(op_type):
    def fn(x, name=None):
        return _simple(op_type, {"X": [x]}, {})

    fn.__name__ = op_type
    return fn


exp = _unary("exp")
floor = _unary("floor")
ceil = _unary("ceil")
cos = _unary("cos")


def where(condition, x, y):
    return _simple("where", {"Condition": [condition], "X": [x], "Y": [y]},
                   {})


def abs(x, name=None):
    return _simple("abs", {"X": [x]}, {})


def log(x, name=None):
    return _simple("log", {"X": [x]}, {})


def clip(x, min, max, name=None):
    return _simple("clip", {"X": [x]}, {"min": float(min), "max": float(max)})


def take_along_axis(x, index, axis=-1):
    return _simple(
        "take_along_axis", {"Input": [x], "Index": [index]}, {"Axis": axis},
        out_slots=("Result",),
    )


def assign_value(values, dtype="float32"):
    """A constant tensor from a Python or numpy literal."""
    arr = np.asarray(values)
    return _simple(
        "assign_value", {},
        {"values": arr.reshape(-1).tolist(), "shape": list(arr.shape),
         "dtype": dtype},
        stop_gradient=True,
    )


def gelu(x, name=None, **attrs):
    return _simple("gelu", {"X": [x]}, attrs)


def relu(x, name=None, **attrs):
    return _simple("relu", {"X": [x]}, attrs)


def sigmoid(x, name=None, **attrs):
    return _simple("sigmoid", {"X": [x]}, attrs)


def leaky_relu(x, name=None, **attrs):
    """alpha defaults to 0.02 in the op, as in the JAX package."""
    return _simple("leaky_relu", {"X": [x]}, attrs)


def tril(x, diagonal=0, name=None):
    return _simple("tril_triu", {"X": [x]},
                   {"diagonal": diagonal, "lower": True})


def triu(x, diagonal=0, name=None):
    return _simple("tril_triu", {"X": [x]},
                   {"diagonal": diagonal, "lower": False})
