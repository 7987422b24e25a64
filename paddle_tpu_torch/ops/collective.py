"""Collective communication ops (counterpart of paddle_tpu/ops/collective.py;
reference operators/collective/c_allreduce_op.h).

Under SPMD (a program with a mesh, parallel/spmd.py) every rank runs the
block, and a collective runs over the process group of the mesh axis its
`axis_name` attr names (EmitContext.axis_group): NCCL on the card, gloo
on the CPU. Outside a mesh, or over an axis the mesh lacks, every
collective is the identity, the reference's nranks == 1 behaviour.

This slice carries the two the sequence-parallel program uses:
c_allreduce_sum, which the transpilers append after the backward, and
mp_allreduce_sum, the forward-graph allreduce of tensor and sequence
parallelism, whose gradient op reduces the output gradient again.
"""

from __future__ import annotations

import torch.distributed as dist

from ..framework.backward import append_grad_op
from ..framework.registry import register_op


def _axis(ctx, op):
    """The mesh axis this collective runs over, or None (identity)."""
    name = op.attr("axis_name", "dp")
    return name if name in ctx.mesh_axes else None


def _all_reduce(ctx, x, ax):
    out = x.clone()
    dist.all_reduce(out, group=ctx.axis_group(ax))
    return out


@register_op("c_allreduce_sum", inputs=["X"], outputs=["Out"],
             differentiable=False)
def _c_allreduce_sum(ctx, op, ins):
    x = ins["X"][0]
    ax = _axis(ctx, op)
    return {"Out": [x if ax is None else _all_reduce(ctx, x, ax)]}


def _mp_grad_maker(op, block, contribs, finalize, needs_grad=None):
    g_out = finalize(op.outputs["Out"][0])
    if g_out is None:
        return
    append_grad_op(op, block, contribs, needs_grad, "mp_allreduce_sum_grad",
                   {"OutGrad": [g_out]}, ("X",))


@register_op("mp_allreduce_sum", inputs=["X"], outputs=["Out"],
             grad_maker=_mp_grad_maker)
def _mp_allreduce_sum(ctx, op, ins):
    """DIFFERENTIABLE in-graph allreduce: Out is the sum of X over the
    axis. Its gradient is the dedicated mp_allreduce_sum_grad op, never a
    `__vjp__` replay, which would run the collective again inside
    torch.func.vjp."""
    x = ins["X"][0]
    ax = _axis(ctx, op)
    return {"Out": [x if ax is None else _all_reduce(ctx, x, ax)]}


@register_op("mp_allreduce_sum_grad", inputs=["OutGrad"], outputs=["XGrad"],
             differentiable=False)
def _mp_allreduce_sum_grad(ctx, op, ins):
    """XGrad = all_reduce(OutGrad) / n: the gradient the JAX package's
    `total / n + stop_gradient(total * (n - 1) / n)` passes to X (its
    psum transposes to a psum, scaled by 1/n); the identity meshless."""
    g = ins["OutGrad"][0]
    ax = _axis(ctx, op)
    if ax is None:
        return {"XGrad": [g]}
    return {"XGrad": [_all_reduce(ctx, g, ax) / ctx.axis_sizes[ax]]}
