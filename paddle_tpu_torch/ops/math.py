"""Dense math ops of the port's slices (counterpart of
paddle_tpu/ops/math.py; reference elementwise ops, square_op, scale_op.cc,
mul_op.cc, matmul_op.cc, mean_op.cc, reduce_sum_op.cc, reduce_mean_op.cc,
sum_op.cc, compare_op.cc, activation_op.cc's unary ops, clip_op.cc,
clip_by_norm_op.cc).

Where jnp's gradient differs from torch's at a kink, the emitter is
written so that torch autograd (the `__vjp__` replay) gives the JAX
package's: abs has gradient 1 at 0, clip 0.5 at either bound."""

from __future__ import annotations

import math

import torch

from ..framework.registry import register_op
from ._helpers import fluid_broadcast


def _register_elementwise(op_type, fn, differentiable=True):
    @register_op(op_type, inputs=["X", "Y"], outputs=["Out"],
                 differentiable=differentiable)
    def emit(ctx, op, ins):
        x, y = fluid_broadcast(ins["X"][0], ins["Y"][0], op.attr("axis", -1))
        return {"Out": [fn(x, y)]}

    return emit


_register_elementwise("elementwise_add", torch.add)
_register_elementwise("elementwise_sub", torch.sub)
_register_elementwise("elementwise_mul", torch.mul)
_register_elementwise("elementwise_div", torch.div)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_pow", torch.pow)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("not_equal", torch.ne, differentiable=False)
_register_elementwise("less_than", torch.lt, differentiable=False)
_register_elementwise("greater_equal", torch.ge, differentiable=False)
# the rest of the VarBase operators' ops (dygraph/varbase.py): Python's
# floor division and modulo, as jnp.floor_divide and jnp.mod
_register_elementwise("elementwise_floordiv", torch.floor_divide)
_register_elementwise("elementwise_mod", torch.remainder)
_register_elementwise("equal", torch.eq, differentiable=False)
_register_elementwise("less_equal", torch.le, differentiable=False)
_register_elementwise("greater_than", torch.gt, differentiable=False)


@register_op("square", inputs=["X"], outputs=["Out"])
def _square(ctx, op, ins):
    return {"Out": [torch.square(ins["X"][0])]}


def _register_unary(op_type, fn):
    @register_op(op_type, inputs=["X"], outputs=["Out"])
    def emit(ctx, op, ins):
        return {"Out": [fn(ins["X"][0])]}

    return emit


# the clip, regularizer and LR-schedule ops (torch.sign, floor and ceil
# have gradient 0, as jnp's)
_register_unary("sqrt", torch.sqrt)
_register_unary("reciprocal", torch.reciprocal)
_register_unary("sign", torch.sign)
_register_unary("exp", torch.exp)
_register_unary("floor", torch.floor)
_register_unary("ceil", torch.ceil)
_register_unary("cos", torch.cos)


@register_op("abs", inputs=["X"], outputs=["Out"])
def _abs(ctx, op, ins):
    # where(x >= 0, x, -x): gradient 1 at 0, as jnp.abs's (torch.abs's
    # is 0)
    x = ins["X"][0]
    return {"Out": [torch.where(x >= 0, x, -x)]}


@register_op("log", inputs=["X"], outputs=["Out"])
def _log(ctx, op, ins):
    return {"Out": [torch.log(ins["X"][0])]}


@register_op("clip", inputs=["X"], outputs=["Out"])
def _clip(ctx, op, ins):
    """min(max(x, lo), hi), as jnp.clip: torch.maximum and torch.minimum
    split the gradient evenly at a tie, so it is 0.5 at either bound
    (torch.clamp's is 1)."""
    x = ins["X"][0]
    lo = torch.full((), float(op.attr("min")), dtype=x.dtype, device=x.device)
    hi = torch.full((), float(op.attr("max")), dtype=x.dtype, device=x.device)
    return {"Out": [torch.minimum(torch.maximum(x, lo), hi)]}


@register_op("clip_by_norm", inputs=["X"], outputs=["Out"])
def _clip_by_norm(ctx, op, ins):
    """x * max_norm / max(||x||, max_norm), the norm in x's dtype."""
    x = ins["X"][0]
    max_norm = op.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [x * (max_norm / torch.clamp(norm, min=max_norm))]}


@register_op("pow", inputs=["X"], outputs=["Out"])
def _pow(ctx, op, ins):
    return {"Out": [torch.pow(ins["X"][0], op.attr("factor", 1.0))]}


def _register_reduce(op_type, fn):
    @register_op(op_type, inputs=["X"], outputs=["Out"])
    def emit(ctx, op, ins):
        x = ins["X"][0]
        keep = op.attr("keep_dim", False)
        dim = op.attr("dim", [0])
        # reduce_all, or dim None, reduces every axis; an int dim is one
        # axis (the JAX package's reduce_axes)
        if op.attr("reduce_all", False) or dim is None:
            out = fn(x)
            if keep:
                out = out.reshape((1,) * x.dim())
        else:
            dim = [dim] if isinstance(dim, int) else dim
            out = fn(x, dim=tuple(d % x.dim() for d in dim), keepdim=keep)
        return {"Out": [out.reshape(1) if out.dim() == 0 else out]}

    return emit


_register_reduce("reduce_sum", torch.sum)
_register_reduce("reduce_mean", torch.mean)


@register_op("mean", inputs=["X"], outputs=["Out"])
def _mean(ctx, op, ins):
    return {"Out": [ins["X"][0].mean().reshape(1)]}


@register_op("sum", inputs=["X"], outputs=["Out"])
def _sum(ctx, op, ins):
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("scale", inputs=["X"], outputs=["Out"])
def _scale(ctx, op, ins):
    x = ins["X"][0]
    scale = op.attr("scale", 1.0)
    bias = op.attr("bias", 0.0)
    if op.attr("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    return {"Out": [out.to(x.dtype)]}


@register_op("mul", inputs=["X", "Y"], outputs=["Out"])
def _mul(ctx, op, ins):
    # fluid mul op (mul_op.cc): flatten x to 2-D at x_num_col_dims, y
    # likewise. A plain matrix product: torch.matmul, as the JAX package
    # leaves it to XLA.
    x, y = ins["X"][0], ins["Y"][0]
    xnc = op.attr("x_num_col_dims", 1)
    ync = op.attr("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), -1)
    y2 = y.reshape(math.prod(ys[:ync]), -1)
    return {"Out": [torch.matmul(x2, y2).reshape(xs[:xnc] + ys[ync:])]}


@register_op("matmul", inputs=["X", "Y"], outputs=["Out"])
def _matmul(ctx, op, ins):
    x, y = ins["X"][0], ins["Y"][0]
    if op.attr("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if op.attr("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = op.attr("alpha", 1.0)
    return {"Out": [out * alpha if alpha != 1.0 else out]}
