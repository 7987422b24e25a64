"""Deterministic sum of per-block partials: a hand-written CUDA kernel and
its plain PyTorch version.

Replaces: the cross-grid accumulation inside the TPU backward kernels,
paddle_tpu/kernels/fused_residual.py:_bwd_kernel (dg, dc carried along
its sequential grid) and paddle_tpu/kernels/flash_attention.py:
_bwd_kernel_qkv (dbias over head groups). On Hopper those kernels write
one partial per block or head, and this sums them:
out[b, n] = sum_g part[b, g, n], g in ascending order.

What bounds it on the H100: device-memory bytes (one add per element
read). The design (csrc/sum_partials.cu), by G: up to 16 partials (the
attention's dbias over heads), one thread a column walks them in order;
more (the row kernels' groups), up to 32 threads a column each sum a
contiguous slice of at most 16 in order, and the slices' sums are added
in order. The order depends on G alone: the same result on every run,
with no float atomics. `bwd_groups` sets G for the row kernels' backwards
(#4 and #11), one rule for both, a function of R alone.

Dispatch: a CUDA tensor goes to the kernel, or raises if the kernel does
not take it; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidArgumentError
from . import _build

# the row kernels' backward groups (one block and one partial row each):
# at most BWD_GROUPS groups of at least BWD_MIN_ROWS consecutive rows
BWD_GROUPS = 512
BWD_MIN_ROWS = 16


def bwd_groups(R):
    """(groups, rows per group) of a row kernel's backward over R rows,
    the last group ragged: a function of R alone, never of the device, so
    the column sums are taken in one order on every card. #4
    (fused_residual) and #11 (layer_norm) both use it."""
    rows = max(BWD_MIN_ROWS, -(-R // BWD_GROUPS))
    return -(-R // rows), rows


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
