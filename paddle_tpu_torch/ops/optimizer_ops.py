"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py;
reference operators/optimizers/adam_op.cc, sgd_op.cc, momentum_op.cc).

ParamOut and the moment outputs reuse their inputs' variable names, so
the executor writes the new values back to the scope. Every update op is
differentiable=False: it sits after append_backward's grad ops.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


@register_op(
    "adam",
    inputs=[
        "Param", "Grad", "LearningRate", "Moment1", "Moment2", "Beta1Pow",
        "Beta2Pow",
    ],
    outputs=[
        "ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut",
    ],
    differentiable=False,
)
def _adam(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr = ins["LearningRate"][0].reshape(())
    g = g.to(m1.dtype)
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {
        "ParamOut": [p_out.to(p.dtype)],
        "Moment1Out": [m1_out],
        "Moment2Out": [m2_out],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }


@register_op(
    "sgd",
    inputs=["Param", "Grad", "LearningRate"],
    outputs=["ParamOut"],
    differentiable=False,
)
def _sgd(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": [(p - lr * g.to(p.dtype)).to(p.dtype)]}


@register_op(
    "momentum",
    inputs=["Param", "Grad", "Velocity", "LearningRate"],
    outputs=["ParamOut", "VelocityOut"],
    differentiable=False,
)
def _momentum(ctx, op, ins):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = op.attr("mu", 0.9)
    lr = ins["LearningRate"][0].reshape(())
    v_out = mu * v + g
    if op.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out.to(p.dtype)], "VelocityOut": [v_out]}
