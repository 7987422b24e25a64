"""Gradient clipping (counterpart of paddle_tpu/clip.py; reference
python/paddle/fluid/clip.py: GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm).

Optimizer.apply_gradients hands its (param, grad) pairs to `apply`, which
appends the clip's ops and returns the pairs with the clipped gradients.
Every value stays on the device: the global norm's scale is a [1] tensor
that multiplies each gradient, with no read-back and no branch on it."""

from __future__ import annotations

from .framework import unique_name


class GradientClipBase:
    def apply(self, params_grads, block):
        raise NotImplementedError


def _tmp(block, key, shape, dtype="float32"):
    return block.create_var(name=unique_name.generate(key), shape=shape,
                            dtype=dtype)


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def apply(self, params_grads, block):
        out = []
        for p, g in params_grads:
            c = _tmp(block, g.name + "@CLIP", g.shape, g.dtype)
            block.append_op("clip", {"X": [g.name]}, {"Out": [c.name]},
                            {"min": self.min, "max": self.max})
            out.append((p, c))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads, block):
        out = []
        for p, g in params_grads:
            c = _tmp(block, g.name + "@CLIP", g.shape, g.dtype)
            block.append_op("clip_by_norm", {"X": [g.name]},
                            {"Out": [c.name]}, {"max_norm": self.clip_norm})
            out.append((p, c))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """scale = clip_norm / max(||(g_1, ..., g_n)||, clip_norm), and each
    g_i * scale: `square` and `reduce_sum` a gradient, `sum` of the [1]
    squares, `sqrt`, `clip` from below at clip_norm, `reciprocal`,
    `scale`, then `elementwise_mul` of each gradient by the [1] scale."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, params_grads, block):
        sq_names = []
        for _, g in params_grads:
            full = _tmp(block, g.name + "@SQFULL", g.shape, g.dtype)
            block.append_op("square", {"X": [g.name]}, {"Out": [full.name]})
            sq = _tmp(block, g.name + "@SQ", [1])
            block.append_op("reduce_sum", {"X": [full.name]},
                            {"Out": [sq.name]}, {"reduce_all": True})
            sq_names.append(sq.name)
        total = _tmp(block, "global_norm_sq", [1])
        block.append_op("sum", {"X": sq_names}, {"Out": [total.name]}, {})
        gnorm = _tmp(block, "global_norm", [1])
        block.append_op("sqrt", {"X": [total.name]}, {"Out": [gnorm.name]})
        max_norm = _tmp(block, "max_norm", [1])
        block.append_op("clip", {"X": [gnorm.name]}, {"Out": [max_norm.name]},
                        {"min": self.clip_norm, "max": 3.4e38})
        inv = _tmp(block, "inv_max_norm", [1])
        block.append_op("reciprocal", {"X": [max_norm.name]},
                        {"Out": [inv.name]})
        scale_v = _tmp(block, "clip_scale", [1])
        block.append_op("scale", {"X": [inv.name]}, {"Out": [scale_v.name]},
                        {"scale": self.clip_norm})
        out = []
        for p, g in params_grads:
            c = _tmp(block, g.name + "@CLIP", g.shape, g.dtype)
            block.append_op("elementwise_mul",
                            {"X": [g.name], "Y": [scale_v.name]},
                            {"Out": [c.name]}, {})
            out.append((p, c))
        return out


ErrorClipByValue = GradientClipByValue
