"""save_dygraph / load_dygraph (counterpart of
paddle_tpu/dygraph/checkpoint.py; reference dygraph/checkpoint.py:33,98).

The JAX package's file format: one pickled dict of numpy arrays
(protocol 4) at `<path>.pdparams`; load_dygraph also returns the dict at
`<path>.pdopt` where that file exists. Each package reads the other's
files. A tensor is saved as its numpy array (bfloat16, which numpy lacks,
as float32)."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .varbase import VarBase


def _array(v):
    if isinstance(v, VarBase):
        return v.numpy()
    if isinstance(v, torch.Tensor):
        return VarBase(v).numpy()
    return np.asarray(v) if hasattr(v, "shape") else v


def save_dygraph(state_dict, model_path):
    """state_dict: Layer.state_dict() or another {name: array}. Writes
    one file, `<model_path>.pdparams`."""
    payload = {k: _array(v) for k, v in state_dict.items()}
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(payload, f, protocol=4)


def load_dygraph(model_path):
    """(params, optimizer state or None): the dicts of numpy arrays at
    `<model_path>.pdparams` and `.pdopt`."""
    with open(model_path + ".pdparams", "rb") as f:
        params = pickle.load(f)
    opt_path = model_path + ".pdopt"
    opt = None
    if os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            opt = pickle.load(f)
    return params, opt
