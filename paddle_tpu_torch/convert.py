"""Carry state between the JAX package and the port by name, as numpy
arrays (io.py's checkpoint files carry the same arrays on disk).

Names match when both programs are built from a fresh `unique_name`
state. The JAX package runs without 64-bit mode, so its int64 arrays
arrive as int32. Given the program that declares the state, each array
takes the dtype its variable declares (the LR step counter stays int32,
as both packages store it); without one, integer arrays are widened to
int64, the dtype the fluid API declares for ids.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.dtypes import to_numpy_dtype
from .core.place import as_device


def state_from_numpy(arrays, scope, place, program=None, exclude=()):
    """Load {name: np.ndarray} into `scope` as tensors on `place`; with
    `program`, in the dtypes its variables declare. Names in `exclude`
    are not carried (a generator's KV caches: runtime state, reset before
    every generation)."""
    device = as_device(place)
    declared = {}
    if program is not None:
        declared = {v.name: v.dtype for v in program.list_vars()}
    skip = set(exclude)
    for name, arr in arrays.items():
        if name in skip:
            continue
        arr = np.asarray(arr)
        if name in declared and declared[name] == "bfloat16":
            # numpy has no bfloat16: the array arrives widened
            scope.set_var(name, torch.tensor(
                arr, dtype=torch.float32, device=device).to(torch.bfloat16))
            continue
        if name in declared:
            arr = arr.astype(to_numpy_dtype(declared[name]))
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        scope.set_var(name, torch.tensor(arr, device=device))


def state_to_numpy(scope):
    """{name: np.ndarray} of every tensor held directly in `scope`
    (bfloat16, which numpy lacks, comes out as float32)."""
    out = {}
    for name in scope.local_var_names():
        t = scope.find_var(name).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.cpu().numpy()
    return out


def layer_state_from_numpy(layer, arrays):
    """Load {structured name: np.ndarray} (a dygraph `Layer.state_dict()`
    of either package) into the port's dygraph `layer`, each array in the
    dtype and on the device of the parameter or buffer it fills (the
    dygraph twin of state_from_numpy). Names the layer lacks are not
    carried; returns the names loaded."""
    loaded = []
    for name, var in layer.named_state():
        if name in arrays:
            var.set_value(arrays[name])
            loaded.append(name)
    return loaded
