"""Gradient allreduce insertion (counterpart of the part of
paddle_tpu/parallel/transpiler.py this slice uses: `_insert_pos_after`
and `insert_grad_allreduce`). The data-parallel transpilers
(GradAllReduce, LocalSGD) are in ROADMAP Queue 1."""

from __future__ import annotations

# AMP bookkeeping ops rewrite grads in place *after* they are produced; an
# allreduce must land before them so every rank's FoundInfinite and
# loss-scale state is computed from the same (globally reduced) gradients
_AMP_CHECK_OPS = frozenset({"check_finite_and_unscale", "update_loss_scaling"})


def _insert_pos_after(block, names):
    """Index just after the last non-AMP op producing any of `names`."""
    pos = 0
    names = set(names)
    for i, op in enumerate(block.ops):
        if op.type in _AMP_CHECK_OPS:
            continue
        if names & set(op.output_names()):
            pos = i + 1
    return pos


def insert_grad_allreduce(block, grad, axis_name, scale=None):
    """Insert (an optional scale and) c_allreduce_sum on a gradient, right
    after its producer and before any AMP bookkeeping op."""
    gname = grad.name if hasattr(grad, "name") else str(grad)
    pos = _insert_pos_after(block, [gname])
    if scale is not None:
        block.append_op(
            "scale",
            inputs={"X": [gname]},
            outputs={"Out": [gname]},
            attrs={"scale": scale, "bias": 0.0},
            index=pos,
        )
        pos += 1
    block.append_op(
        "c_allreduce_sum",
        inputs={"X": [gname]},
        outputs={"Out": [gname]},
        attrs={"axis_name": axis_name},
        index=pos,
    )
