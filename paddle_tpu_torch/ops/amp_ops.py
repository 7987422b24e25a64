"""AMP support ops (counterpart of paddle_tpu/ops/amp_ops.py; reference
operators/amp/amp_check_finite_and_scale_op.cc,
check_finite_and_unscale_op.cc and the update_loss_scaling logic used by
contrib/mixed_precision/decorator.py).

All stay on the device: the found-infinite flag is a bool [1] tensor,
and every branch of the loss-scale automaton is a torch.where, so no op
waits for the card.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op


def _lifted(x, s):
    """x in the dtype jnp gives x / s: torch keeps a bf16 tensor bf16
    against a 0-dim fp32 one, jnp lifts it to fp32."""
    return x.to(torch.promote_types(x.dtype, s.dtype))


@register_op(
    "amp_check_finite_and_scale",
    inputs=["X", "Scale"],
    outputs=["Out", "FoundInfinite"],
    differentiable=False,
)
def _amp_check_finite_and_scale(ctx, op, ins):
    """Each X times Scale (in the dtype jnp gives it), and whether any
    X holds an inf or a NaN."""
    scale = ins["Scale"][0].reshape(())
    xs = [x for x in ins["X"] if x is not None]
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    return {"Out": [_lifted(x, scale) * scale for x in xs],
            "FoundInfinite": [found.reshape(1)]}


@register_op(
    "update_loss_scaling",
    inputs=["X", "FoundInfinite", "PrevLossScaling", "InGoodSteps",
            "InBadSteps"],
    outputs=["Out", "LossScaling", "OutGoodSteps", "OutBadSteps"],
    differentiable=False,
)
def _update_loss_scaling(ctx, op, ins):
    found = ins["FoundInfinite"][0].reshape(())
    prev = ins["PrevLossScaling"][0].reshape(())
    good = ins["InGoodSteps"][0].reshape(())
    bad = ins["InBadSteps"][0].reshape(())
    incr_every = op.attr("incr_every_n_steps", 1000)
    decr_every = op.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = op.attr("incr_ratio", 2.0)
    decr_ratio = op.attr("decr_ratio", 0.5)

    zero_i = torch.zeros_like(good)
    new_bad = torch.where(found, bad + 1, zero_i)
    new_good = torch.where(found, zero_i, good + 1)
    shrink = new_bad >= decr_every
    grow = new_good >= incr_every
    # shrink floor: never *raise* the scale through the shrink branch — a
    # plain max(.., 1.0) would silently bump a sub-1.0 (static) scale up
    floor = torch.minimum(prev, torch.ones_like(prev))
    # grow guard: keep the previous scale if growing overflows to inf
    # (reference update_loss_scaling_op.h keeps prev when the incremented
    # scale is non-finite) — otherwise a long always-finite run saturates
    # the scale at inf and silently zeroes every gradient from then on
    grown = prev * incr_ratio
    grown = torch.where(torch.isfinite(grown), grown, prev)
    scale = torch.where(
        shrink,
        torch.maximum(prev * decr_ratio, floor),
        torch.where(grow, grown, prev),
    )
    new_bad = torch.where(shrink, zero_i, new_bad)
    new_good = torch.where(grow, zero_i, new_good)

    # zero the grads on overflow steps so the optimizer update is a no-op
    xs = [x for x in ins["X"] if x is not None]
    outs = []
    for x in xs:
        x = _lifted(x, prev)
        outs.append(torch.where(found, torch.zeros_like(x), x / prev))
    return {
        "Out": outs,
        "LossScaling": [scale.reshape(1)],
        "OutGoodSteps": [new_good.reshape(1).to(torch.int32)],
        "OutBadSteps": [new_bad.reshape(1).to(torch.int32)],
    }


@register_op(
    "check_finite_and_unscale",
    inputs=["X", "Scale"],
    outputs=["Out", "FoundInfinite"],
    differentiable=False,
)
def _check_finite_and_unscale(ctx, op, ins):
    scale = ins["Scale"][0].reshape(())
    xs = [x for x in ins["X"] if x is not None]
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    return {"Out": [_lifted(x, scale) / scale for x in xs],
            "FoundInfinite": [found.reshape(1)]}
