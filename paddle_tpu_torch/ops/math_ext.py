"""Extended math ops of the port's slices (counterpart of
paddle_tpu/ops/math_ext.py; reference space_to_depth_op.cc):
space_to_depth only."""

from __future__ import annotations

from ..framework.registry import register_op


@register_op("space_to_depth", inputs=["X"], outputs=["Out"])
def _space_to_depth(ctx, op, ins):
    """[N, C, H, W] -> [N, bs*bs*C, H/bs, W/bs] with the channels in (bh,
    bw, c) order, the JAX package's; F.pixel_unshuffle orders them (c,
    bh, bw)."""
    x = ins["X"][0]
    bs = int(op.attr("blocksize"))
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * bs * bs, h // bs, w // bs)]}
