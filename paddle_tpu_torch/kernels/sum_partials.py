"""Deterministic sum of per-block partials: a hand-written CUDA kernel and
its plain PyTorch version.

Replaces: the cross-grid accumulation inside the TPU backward kernels,
paddle_tpu/kernels/fused_residual.py:_bwd_kernel (dg, dc carried along
its sequential grid) and paddle_tpu/kernels/flash_attention.py:
_bwd_kernel_qkv (dbias over head groups). On Hopper those kernels write
one partial per block or head, and this sums them:
out[b, n] = sum_g part[b, g, n], g in ascending order.

What bounds it on the H100: device-memory bytes (one add per element
read). The design (csrc/sum_partials.cu) gives each output element one
thread that walks its partials in a fixed order: the same result on
every run, with no float atomics.

Dispatch: a CUDA tensor goes to the kernel, or raises if the kernel does
not take it; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidArgumentError
from . import _build


def reference(part):
    """The plain version: the sum over the partials' middle dim."""
    return part.sum(dim=1)


def sum_partials(part):
    """fp32 [B, G, N] -> [B, N], summing over G."""
    if part.dim() != 3:
        raise InvalidArgumentError(
            f"sum_partials: part must be [B, G, N], got {tuple(part.shape)}"
        )
    if part.device.type == "cpu":
        return reference(part)
    if part.device.type != "cuda" or part.dtype != torch.float32 \
            or not part.is_contiguous():
        raise InvalidArgumentError(
            f"sum_partials: the kernel takes a contiguous fp32 CUDA tensor, "
            f"got {part.dtype} on {part.device}, strides {part.stride()}"
        )
    B, G, N = part.shape
    out = torch.empty((B, N), dtype=torch.float32, device=part.device)
    err = _bind().sum_partials(
        part.data_ptr(), out.data_ptr(), B, G, N,
        torch.cuda.current_stream(part.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"sum_partials launch failed: CUDA error {err}")
    sum_partials.launches += 1
    return out


sum_partials.launches = 0


def _bind():
    lib = _build.load("sum_partials")
    fn = lib.sum_partials
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
