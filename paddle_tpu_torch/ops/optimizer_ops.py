"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py;
reference operators/optimizers/: sgd_op, momentum_op, adam_op, lamb_op,
lars_momentum_op, adagrad_op, decayed_adagrad_op, rmsprop_op,
adadelta_op, adamax_op, ftrl_op, dpsgd_op, proximal_gd_op,
proximal_adagrad_op; average_accumulates_op).

ParamOut and the moment outputs reuse their inputs' variable names, so
the executor writes the new values back to the scope. Every update op is
differentiable=False: it sits after append_backward's grad ops. Each is
the JAX package's formula in torch, in its order of operations; the
norms of lamb, lars_momentum and dpsgd and the trust-ratio branches stay
on the device (torch.where), so no op reads a value back to the host.
`dgc_momentum_step` is not here: its sparse exchange over the dp axis
comes with ROADMAP Queue 1, item 1.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from ._helpers import gaussian_noise

_ADAM_INS = ["Param", "Grad", "LearningRate", "Moment1", "Moment2",
             "Beta1Pow", "Beta2Pow"]
_ADAM_OUTS = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"]


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x)))


def _soft_threshold(prox, thresh, shrink):
    """proximal_gd_op.cc's step: sign(prox) max(|prox| - thresh, 0) /
    (1 + shrink)."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - thresh, min=0.0)
            / (1.0 + shrink))


@register_op("adam", inputs=_ADAM_INS, outputs=_ADAM_OUTS,
             differentiable=False)
def _adam(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    lr = _lr(ins)
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


@register_op("adamw", inputs=_ADAM_INS, outputs=_ADAM_OUTS,
             differentiable=False)
def _adamw(ctx, op, ins):
    """Adam's step, then the decoupled decay lr * weight_decay * p."""
    wd = op.attr("weight_decay", 0.01)
    out = _adam(ctx, op, ins)
    p = ins["Param"][0]
    out["ParamOut"] = [(out["ParamOut"][0] - _lr(ins) * wd * p).to(p.dtype)]
    return out


@register_op("lamb", inputs=_ADAM_INS, outputs=_ADAM_OUTS,
             differentiable=False)
def _lamb(ctx, op, ins):
    """LAMB (You et al.): the bias-corrected Adam direction plus the
    decay, scaled by the trust ratio ||p|| / ||update|| (1 where either
    norm is 0), both norms fp32 on the device."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-6)
    wd = op.attr("weight_decay", 0.01)
    lr = _lr(ins)
    g = g.to(m1.dtype)
    m1_out = beta1 * m1 + (1 - beta1) * g
    m2_out = beta2 * m2 + (1 - beta2) * g * g
    m1_hat = m1_out / (1 - b1p.reshape(()))
    m2_hat = m2_out / (1 - b2p.reshape(()))
    update = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    w_norm = _norm(p.float())
    u_norm = _norm(update.float())
    ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    p_out = p - (lr * ratio) * update
    return {
        "ParamOut": [p_out.to(p.dtype)],
        "Moment1Out": [m1_out],
        "Moment2Out": [m2_out],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }


@register_op("sgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], differentiable=False)
def _sgd(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    return {"ParamOut": [(p - _lr(ins) * g.to(p.dtype)).to(p.dtype)]}


@register_op("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"], differentiable=False)
def _momentum(ctx, op, ins):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = op.attr("mu", 0.9)
    lr = _lr(ins)
    v_out = mu * v + g
    if op.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out.to(p.dtype)], "VelocityOut": [v_out]}


@register_op("lars_momentum",
             inputs=["Param", "Grad", "Velocity", "LearningRate"],
             outputs=["ParamOut", "VelocityOut"], differentiable=False)
def _lars_momentum(ctx, op, ins):
    """Momentum at the layer-wise rate lr * coeff * ||p|| / (||g|| +
    wd ||p||) (lr where either norm is 0), on the decayed gradient."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = op.attr("mu", 0.9)
    coeff = op.attr("lars_coeff", 0.001)
    wd = op.attr("lars_weight_decay", 0.0005)
    lr = _lr(ins)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lr * coeff * p_norm / (g_norm + wd * p_norm), lr)
    v_out = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [(p - v_out).to(p.dtype)], "VelocityOut": [v_out]}


@register_op("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], differentiable=False)
def _adagrad(ctx, op, ins):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    eps = op.attr("epsilon", 1e-6)
    m_out = m + g * g
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [m_out]}


@register_op("decayed_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], differentiable=False)
def _decayed_adagrad(ctx, op, ins):
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    decay = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * g * g
    p_out = p - _lr(ins) * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [m_out]}


@register_op(
    "rmsprop",
    inputs=["Param", "Grad", "Moment", "MeanSquare", "MeanGrad",
            "LearningRate"],
    outputs=["ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"],
    differentiable=False,
)
def _rmsprop(ctx, op, ins):
    """RMSProp with momentum; centered subtracts the running mean
    gradient's square under the root."""
    p, g = ins["Param"][0], ins["Grad"][0]
    mom, ms = ins["Moment"][0], ins["MeanSquare"][0]
    mg = ins["MeanGrad"][0] if ins.get("MeanGrad") else None
    rho = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    momentum = op.attr("momentum", 0.0)
    lr = _lr(ins)
    ms_out = rho * ms + (1 - rho) * g * g
    if op.attr("centered", False) and mg is not None:
        mg_out = rho * mg + (1 - rho) * g
        denom = torch.sqrt(ms_out - mg_out * mg_out + eps)
    else:
        mg_out = mg if mg is not None else torch.zeros_like(g)
        denom = torch.sqrt(ms_out + eps)
    mom_out = momentum * mom + lr * g / denom
    return {
        "ParamOut": [(p - mom_out).to(p.dtype)],
        "MomentOut": [mom_out],
        "MeanSquareOut": [ms_out],
        "MeanGradOut": [mg_out],
    }


@register_op(
    "adadelta",
    inputs=["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
    outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
    differentiable=False,
)
def _adadelta(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    asg, asu = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    asg_out = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * update * update
    return {
        "ParamOut": [(p + update).to(p.dtype)],
        "AvgSquaredGradOut": [asg_out],
        "AvgSquaredUpdateOut": [asu_out],
    }


@register_op(
    "adamax",
    inputs=["Param", "Grad", "LearningRate", "Moment", "InfNorm", "Beta1Pow"],
    outputs=["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"],
    differentiable=False,
)
def _adamax(ctx, op, ins):
    """Adamax; beta1_pow advances in this op, as in the JAX package (the
    reference's separate scale op, fluid/optimizer.py:2094)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    beta1 = op.attr("beta1", 0.9)
    beta2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m_out = beta1 * m + (1 - beta1) * g
    inf_out = torch.maximum(beta2 * inf, torch.abs(g))
    lr_t = _lr(ins) / (1 - b1p.reshape(()))
    p_out = p - lr_t * m_out / (inf_out + eps)
    return {
        "ParamOut": [p_out.to(p.dtype)],
        "MomentOut": [m_out],
        "InfNormOut": [inf_out],
        "Beta1PowOut": [b1p * beta1],
    }


@register_op(
    "ftrl",
    inputs=["Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
            "LearningRate"],
    outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
    differentiable=False,
)
def _ftrl(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = op.attr("l1", 0.0) + 1e-10
    l2 = op.attr("l2", 0.0) + 1e-10
    power = op.attr("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    lin_out = lin + g - sigma * p
    if power == -0.5:
        x = l2 + torch.sqrt(new_sq) / lr
    else:
        x = l2 + torch.pow(new_sq, -power) / lr
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {
        "ParamOut": [(pre / x).to(p.dtype)],
        "SquaredAccumOut": [new_sq],
        "LinearAccumOut": [lin_out],
    }


@register_op("dpsgd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], differentiable=False)
def _dpsgd(ctx, op, ins):
    """Differentially private SGD (dpsgd_op.cc): the gradient clipped to
    norm `clip`, Gaussian noise of std sigma * clip added, the sum over
    batch_size. The noise is `gaussian_noise` of the op's seed words, a
    pure function of the key and the element (not jax.random's draw)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    clip = op.attr("clip", 10.0)
    sigma = op.attr("sigma", 1.0)
    batch_size = op.attr("batch_size", 16.0)
    norm = _norm(g)
    g = g * torch.clamp(clip / torch.clamp(norm, min=1e-10), max=1.0)
    noise = sigma * clip * gaussian_noise(ctx, op, g.shape, g.device
                                          ).to(g.dtype)
    update = (g + noise) / batch_size
    return {"ParamOut": [(p - _lr(ins) * update).to(p.dtype)]}


@register_op("proximal_gd", inputs=["Param", "Grad", "LearningRate"],
             outputs=["ParamOut"], differentiable=False)
def _proximal_gd(ctx, op, ins):
    """prox = p - lr g, soft-thresholded by lr l1, shrunk by 1 / (1 +
    lr l2)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _lr(ins)
    out = _soft_threshold(p - lr * g, lr * op.attr("l1", 0.0),
                          lr * op.attr("l2", 0.0))
    return {"ParamOut": [out.to(p.dtype)]}


@register_op("proximal_adagrad",
             inputs=["Param", "Grad", "Moment", "LearningRate"],
             outputs=["ParamOut", "MomentOut"], differentiable=False)
def _proximal_adagrad(ctx, op, ins):
    """proximal_gd's step at Adagrad's rate lr / sqrt(m + 1e-10)."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    m_out = m + g * g
    lr_eff = _lr(ins) / torch.sqrt(m_out + 1e-10)
    out = _soft_threshold(p - lr_eff * g, lr_eff * op.attr("l1", 0.0),
                          lr_eff * op.attr("l2", 0.0))
    return {"ParamOut": [out.to(p.dtype)], "MomentOut": [m_out]}


@register_op(
    "average_accumulates",
    inputs=["param", "in_sum_1", "in_sum_2", "in_sum_3",
            "in_num_accumulates", "in_old_num_accumulates",
            "in_num_updates"],
    outputs=["out_sum_1", "out_sum_2", "out_sum_3", "out_num_accumulates",
             "out_old_num_accumulates", "out_num_updates"],
    differentiable=False,
    mutates=(("out_sum_1", "in_sum_1"), ("out_sum_2", "in_sum_2"),
             ("out_sum_3", "in_sum_3"),
             ("out_num_accumulates", "in_num_accumulates"),
             ("out_old_num_accumulates", "in_old_num_accumulates"),
             ("out_num_updates", "in_num_updates")),
)
def _average_accumulates(ctx, op, ins):
    """average_accumulates_op.h, ModelAverage's state machine: sum_1
    accumulates the parameter; every 16384 updates it spills into sum_2;
    when the window outgrows min(max_window, num_updates * ratio) (and
    at least min_window accumulated) the sums retire into sum_3. Each
    branch is a torch.where; the counters are int64 [1]."""
    kmax = 16384
    p = ins["param"][0]
    s1, s2, s3 = (ins[f"in_sum_{i}"][0] for i in (1, 2, 3))
    num_acc, old_acc, num_upd = (
        ins[k][0].reshape(()).to(torch.int64)
        for k in ("in_num_accumulates", "in_old_num_accumulates",
                  "in_num_updates"))
    ratio = op.attr("average_window", 0.0)
    max_w = op.attr("max_average_window", kmax)
    min_w = op.attr("min_average_window", 10000)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p
    spill = (num_upd % kmax) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)
    window = torch.clamp(num_upd.to(torch.float32) * ratio,
                         max=float(max_w))
    retire = (num_acc >= min_w) & (num_acc.to(torch.float32) >= window)
    s3 = torch.where(retire, s1 + s2, s3)
    s1 = torch.where(retire, torch.zeros_like(s1), s1)
    s2 = torch.where(retire, torch.zeros_like(s2), s2)
    old_acc = torch.where(retire, num_acc, old_acc)
    num_acc = torch.where(retire, torch.zeros_like(num_acc), num_acc)
    return {
        "out_sum_1": [s1],
        "out_sum_2": [s2],
        "out_sum_3": [s3],
        "out_num_accumulates": [num_acc.reshape(1)],
        "out_old_num_accumulates": [old_acc.reshape(1)],
        "out_num_updates": [num_upd.reshape(1)],
    }
