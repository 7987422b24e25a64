"""Extended functional layers of the port's slices (counterpart of
paddle_tpu/layers/functional_ext.py): space_to_depth and pad2d only."""

from __future__ import annotations

from .tensor import _simple


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": [x]}, {"blocksize": blocksize})


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _simple(
        "pad2d", {"X": [input]},
        {"paddings": list(paddings), "mode": mode, "pad_value": pad_value},
    )
