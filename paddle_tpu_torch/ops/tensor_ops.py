"""Tensor ops of the serving and training slices (counterpart of
paddle_tpu/ops/tensor_ops.py; reference reshape_op.cc, transpose_op.cc,
slice_op.cc, concat_op.cc, fill_constant_op.cc, range_op.cc, cast_op.cc,
assign_op.cc, assign_value_op.cc, gather_op.cc, take_along_axis_op.cc,
increment_op.cc, tril_triu_op.cc, top_k_op.cc, where_op.cc)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import to_numpy_dtype, to_torch_dtype
from ..framework.registry import register_op
from ._helpers import shape_attr


def _resolve_shape(shape, x_shape):
    """fluid reshape semantics: 0 copies the input dim; a single -1 infers."""
    return [x_shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]


@register_op("reshape2", inputs=["X"], outputs=["Out", "XShape"])
def _reshape2(ctx, op, ins):
    x = ins["X"][0]
    return {
        "Out": [x.reshape(_resolve_shape(op.attr("shape"), x.shape))],
        "XShape": [],
    }


@register_op("transpose2", inputs=["X"], outputs=["Out", "XShape"])
def _transpose2(ctx, op, ins):
    return {"Out": [ins["X"][0].permute(*op.attr("axis"))], "XShape": []}


@register_op("slice", inputs=["Input"], outputs=["Out"])
def _slice(ctx, op, ins):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(op.attr("axes"), op.attr("starts"), op.attr("ends")):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    for a in sorted(op.attr("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": [out]}


@register_op("concat", inputs=["X"], outputs=["Out"])
def _concat(ctx, op, ins):
    xs = [x for x in ins["X"] if x is not None]
    return {"Out": [torch.cat(xs, dim=op.attr("axis", 0))]}


@register_op("fill_constant", inputs=[], outputs=["Out"])
def _fill_constant(ctx, op, ins):
    return {
        "Out": [
            torch.full(
                shape_attr(ctx, op), op.attr("value", 0.0),
                dtype=to_torch_dtype(op.attr("dtype", "float32")),
                device=ctx.device,
            )
        ]
    }


@register_op("range", inputs=[], outputs=["Out"])
def _range(ctx, op, ins):
    return {
        "Out": [
            torch.arange(
                op.attr("start", 0), op.attr("end"), op.attr("step", 1),
                dtype=to_torch_dtype(op.attr("dtype", "int64")),
                device=ctx.device,
            )
        ]
    }


@register_op("cast", inputs=["X"], outputs=["Out"])
def _cast(ctx, op, ins):
    return {"Out": [ins["X"][0].to(to_torch_dtype(op.attr("out_dtype")))]}


@register_op("assign", inputs=["X"], outputs=["Out"])
def _assign(ctx, op, ins):
    # no copy: the only emitter that writes in place is kv_cache_write,
    # into a persistable cache no program assigns, so the two names may
    # share one tensor
    return {"Out": [ins["X"][0]]}


@register_op("where", inputs=["Condition", "X", "Y"], outputs=["Out"])
def _where(ctx, op, ins):
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register_op("gather", inputs=["X", "Index"], outputs=["Out"])
def _gather(ctx, op, ins):
    x, idx = ins["X"][0], ins["Index"][0]
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    return {"Out": [torch.index_select(x, op.attr("axis", 0), idx.long())]}


@register_op("assign_value", inputs=[], outputs=["Out"])
def _assign_value(ctx, op, ins):
    """A constant from the op's `values`, `shape` and `dtype` attrs."""
    dtype = op.attr("dtype", "float32")
    vals = np.array(op.attr("values"), dtype=to_numpy_dtype(dtype))
    return {"Out": [torch.as_tensor(vals.reshape(op.attr("shape")),
                                    device=ctx.device)]}


@register_op("take_along_axis", inputs=["Input", "Index"],
             outputs=["Result"])
def _take_along_axis(ctx, op, ins):
    """jnp.take_along_axis: the index broadcasts against the input on
    every axis but `Axis` (torch.gather does not broadcast, so it is
    expanded first). Its gradient is a scatter-add."""
    x, idx = ins["Input"][0], ins["Index"][0]
    axis = op.attr("Axis", 0) % x.dim()
    shape = [n if d == axis else max(n, m)
             for d, (n, m) in enumerate(zip(idx.shape, x.shape))]
    return {"Result": [torch.gather(x, axis, idx.long().expand(shape))]}


@register_op("increment", inputs=["X"], outputs=["Out"], differentiable=False)
def _increment(ctx, op, ins):
    """Counter bump (reference increment_op.cc). Out has X's name, so the
    executor writes the new value back to the scope."""
    x = ins["X"][0]
    return {"Out": [x + torch.tensor(op.attr("step", 1.0)).to(x.dtype)]}


@register_op("tril_triu", inputs=["X"], outputs=["Out"])
def _tril_triu(ctx, op, ins):
    """Lower/upper triangle (reference operators/tril_triu_op.cc)."""
    fn = torch.tril if op.attr("lower", True) else torch.triu
    return {"Out": [fn(ins["X"][0], int(op.attr("diagonal", 0)))]}


@register_op("top_k", inputs=["X"], outputs=["Out", "Indices"],
             differentiable=False)
def _top_k(ctx, op, ins):
    """The k largest along the last axis, largest first; of equal values
    the lower index first, as lax.top_k orders them (a stable sort, where
    torch.topk leaves the order of ties open)."""
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True, stable=True)
    k = op.attr("k", 1)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}
