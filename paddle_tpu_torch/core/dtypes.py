"""Dtype names of the fluid API mapped to torch dtypes (counterpart of
paddle_tpu/core/dtypes.py). Programs keep the string names ("float32",
"int64", ...); tensors carry the torch dtype."""

from __future__ import annotations

import numpy as np
import torch

_NAME_TO_TORCH = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_TORCH_TO_NAME = {v: k for k, v in _NAME_TO_TORCH.items()}


def convert_dtype(dtype) -> str:
    """Normalize a dtype spec (name, numpy dtype, torch dtype) to its name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = _TORCH_TO_NAME.get(dtype)
    elif isinstance(dtype, str):
        name = dtype if dtype in _NAME_TO_TORCH else None
    else:
        name = np.dtype(dtype).name
    if name not in _NAME_TO_TORCH:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return name


def is_float(dtype) -> bool:
    return convert_dtype(dtype) in ("float16", "bfloat16", "float32",
                                    "float64")


def to_torch_dtype(dtype) -> torch.dtype:
    return _NAME_TO_TORCH[convert_dtype(dtype)]


def to_numpy_dtype(dtype):
    """numpy dtype for a host-side buffer of this dtype (bfloat16, which
    numpy lacks, is staged as float32)."""
    name = convert_dtype(dtype)
    return np.dtype(np.float32 if name == "bfloat16" else name)
