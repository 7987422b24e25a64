"""Standalone LayerNorm over rows, forward and backward: hand-written CUDA
kernels and their plain PyTorch versions (counterpart of
paddle_tpu/kernels/layer_norm.py).

Replaces: paddle_tpu/kernels/layer_norm.py:_fwd_kernel (behind
`layer_norm_fwd`) and _bwd_kernel (behind `layer_norm_bwd`).

Computes, over rows of x [R, N], in fp32: mean = E[x], var = max(E[x^2]
- mean^2, 0) (one pass, as the TPU kernel computes it), y = (x - mean) *
rsqrt(var + eps) * scale + bias, stored in x's dtype, with fp32 mean and
var [R]. The backward recomputes the statistics from x and gives dx in
x's dtype and dscale = sum_rows dy * xhat, dbias = sum_rows dy in fp32
[N]. scale and bias may be fp32 or bf16, or None (ones, zeros).

What bounds it on the H100: ~10 flops forward (~20 backward) per element
against 4 (6) bytes of bf16 traffic: device-memory bytes. The designs
(csrc/layer_norm.cu) hold a row in registers between its sums and its
normalisation, so x (and dy) are read once and y (dx) written once. The
backward takes #4's row layout (csrc/row_chunks.cuh): 16-byte chunks a
lane, all of a row's loads in flight together, dscale and dbias
accumulated in shared memory; they go through one partial row per group
of rows (sum_partials.bwd_groups, #4's rule) and the fixed-order second
pass of sum_partials.py instead of the TPU's accumulation along a
sequential grid.

Dispatch: a CUDA tensor goes to the kernels, or raises if they do not
take it; a CPU tensor goes to the plain version; a meta tensor (shape
inference) gets empty outputs of the right shapes and dtypes. Which
shapes the layer_norm op sends here at all is `supports`, the JAX
package's predicate.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.dtypes import to_torch_dtype
from ..errors import InvalidArgumentError
from . import _build
from .sum_partials import bwd_groups, sum_partials

MAX_N = 8192
DTYPES = (torch.float32, torch.bfloat16)


def supports(rows: int, n: int, dtype) -> bool:
    """The JAX package's predicate (paddle_tpu/kernels/layer_norm.py:33):
    the shapes and dtypes the layer_norm op routes to the kernels."""
    if not isinstance(dtype, torch.dtype):
        dtype = to_torch_dtype(dtype)
    return n % 128 == 0 and n <= MAX_N and rows % 8 == 0 and dtype in DTYPES


def _stats(xf):
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=1, keepdim=True) - mean.square(),
                      min=0.0)
    return mean, var


def reference_fwd(x2d, scale=None, bias=None, eps=1e-5):
    """The plain version, the JAX package's `reference_fwd`: fp32
    statistics, E[x^2] - E[x]^2; (y in x's dtype, mean, var fp32 [R])."""
    xf = x2d.float()
    mean, var = _stats(xf)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2d.dtype), mean[:, 0], var[:, 0]


def reference_bwd(x2d, scale, d_y, eps=1e-5):
    """The plain backward, in the formulas of the JAX package's
    `_bwd_kernel`: (dx in x's dtype, dscale, dbias fp32 [N])."""
    xf, dyf = x2d.float(), d_y.float()
    mean, var = _stats(xf)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    dyw = dyf * (scale.float() if scale is not None else 1.0)
    m1 = dyw.mean(dim=1, keepdim=True)
    m2 = (dyw * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (dyw - m1 - xhat * m2)
    return dx.to(x2d.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def _check_x(x2d, who):
    if x2d.dim() != 2:
        raise InvalidArgumentError(
            f"{who}: x must be [R, N], got {tuple(x2d.shape)}"
        )
    R, N = x2d.shape
    if x2d.device.type not in ("cpu", "meta", "cuda"):
        raise InvalidArgumentError(f"{who}: unsupported device {x2d.device}")
    if x2d.device.type == "cuda" and (
            x2d.dtype not in DTYPES or not 0 < N <= MAX_N or R == 0
            or x2d.stride(1) != 1):
        raise InvalidArgumentError(
            f"{who}: the kernels take fp32 or bf16 x with contiguous rows, "
            f"0 < N <= {MAX_N}, R > 0; got {x2d.dtype} {tuple(x2d.shape)}, "
            f"strides {x2d.stride()}"
        )
    return R, N


def _vec(v, N, dev, who):
    """(tensor, kind) of a scale or bias for the kernels: kind 0 fp32, 1
    bf16, -1 absent (the kernels read ones or zeros)."""
    if v is None:
        return None, -1
    if (tuple(v.shape) != (N,) or v.device != dev
            or v.dtype not in DTYPES):
        raise InvalidArgumentError(
            f"{who}: scale and bias must be fp32 or bf16 [{N}] on {dev}, got "
            f"{v.dtype} {tuple(v.shape)} on {v.device}"
        )
    return v.contiguous(), DTYPES.index(v.dtype)


def layer_norm_fwd(x2d, scale=None, bias=None, eps=1e-5):
    """(y, mean, var) over rows of x2d [R, N]; scale/bias [N] or None.
    The kernel takes fp32 or bf16 x on a CUDA device with contiguous rows
    and N <= MAX_N, and scale/bias of either dtype."""
    who = "layer_norm_fwd"
    R, N = _check_x(x2d, who)
    if x2d.device.type == "meta":
        stat = torch.empty((R,), dtype=torch.float32, device=x2d.device)
        return torch.empty((R, N), dtype=x2d.dtype, device=x2d.device), \
            stat, stat.clone()
    if x2d.device.type == "cpu":
        return reference_fwd(x2d, scale, bias, eps)
    dev = x2d.device
    s, s_kind = _vec(scale, N, dev, who)
    b, b_kind = _vec(bias, N, dev, who)
    y = torch.empty((R, N), dtype=x2d.dtype, device=dev)
    mean = torch.empty((R,), dtype=torch.float32, device=dev)
    var = torch.empty((R,), dtype=torch.float32, device=dev)
    err = _bind().layer_norm_fwd(
        x2d.data_ptr(), 0 if s is None else s.data_ptr(),
        0 if b is None else b.data_ptr(), y.data_ptr(), mean.data_ptr(),
        var.data_ptr(), R, N, x2d.stride(0), s_kind, b_kind, float(eps),
        DTYPES.index(x2d.dtype), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"layer_norm_fwd launch failed: CUDA error {err}")
    layer_norm_fwd.launches += 1
    return y, mean, var


layer_norm_fwd.launches = 0


def layer_norm_bwd(x2d, scale, d_y, eps=1e-5):
    """(dx [R, N] in x's dtype, dscale, dbias fp32 [N]); the statistics
    are recomputed from x2d. The kernel takes what the forward kernel
    takes, and d_y of x's shape and dtype with contiguous rows."""
    who = "layer_norm_bwd"
    R, N = _check_x(x2d, who)
    if x2d.device.type == "meta":
        vec = torch.empty((N,), dtype=torch.float32, device=x2d.device)
        return torch.empty_like(x2d), vec, vec.clone()
    if x2d.device.type == "cpu":
        return reference_bwd(x2d, scale, d_y, eps)
    dev = x2d.device
    if (tuple(d_y.shape) != (R, N) or d_y.dtype != x2d.dtype
            or d_y.device != dev or d_y.stride(1) != 1):
        raise InvalidArgumentError(
            f"{who}: d_y must be [R, N] = {(R, N)} of {x2d.dtype} on {dev} "
            f"with contiguous rows; got {tuple(d_y.shape)} {d_y.dtype} on "
            f"{d_y.device}"
        )
    s, s_kind = _vec(scale, N, dev, who)
    dx = torch.empty((R, N), dtype=x2d.dtype, device=dev)
    groups, rows = bwd_groups(R)
    part = torch.empty((2, groups, N), dtype=torch.float32, device=dev)
    err = _bind().layer_norm_bwd(
        x2d.data_ptr(), 0 if s is None else s.data_ptr(), d_y.data_ptr(),
        dx.data_ptr(), part.data_ptr(), R, N, rows, x2d.stride(0),
        d_y.stride(0), s_kind, float(eps), DTYPES.index(x2d.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"layer_norm_bwd launch failed: CUDA error {err}")
    layer_norm_bwd.launches += 1
    ds, db = sum_partials(part)
    return dx, ds, db


layer_norm_bwd.launches = 0


class LayerNormFn(torch.autograd.Function):
    """Differentiable layer_norm_fwd (counterpart of the JAX package's
    `layer_norm_fwd_diff` custom_vjp): the backward runs layer_norm_bwd
    and adds the rare cotangents of the statistics outputs (a loss that
    reads Mean or Variance): mean = sum(x) / N and var = E[x^2] - mean^2
    give dx += dmean / N + dvar * 2 (x - mean) / N. The static graph's
    layer_norm_grad op is the usual path; this one serves the generic
    `__vjp__` replay under torch.func.vjp."""

    @staticmethod
    def forward(x2d, scale, bias, eps):
        return layer_norm_fwd(x2d, scale, bias, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2d, scale, bias, eps = inputs
        ctx.save_for_backward(x2d, scale)
        ctx.eps = eps
        ctx.bias_dtype = None if bias is None else bias.dtype

    @staticmethod
    def backward(ctx, d_y, d_mean, d_var):
        x2d, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_bwd(x2d, scale, d_y.contiguous(), ctx.eps)
        n = x2d.shape[1]
        xf = x2d.float()
        mean = xf.mean(dim=1, keepdim=True)
        extra = 0.0
        if d_mean is not None:
            extra = extra + d_mean.float()[:, None] / n
        if d_var is not None:
            extra = extra + d_var.float()[:, None] * 2.0 * (xf - mean) / n
        dx = (dx.float() + extra).to(dx.dtype)
        return (
            dx,
            None if scale is None else ds.to(scale.dtype),
            None if ctx.bias_dtype is None else db.to(ctx.bias_dtype),
            None,
        )


def layer_norm_fwd_diff(x2d, scale, bias, eps):
    """layer_norm_fwd through LayerNormFn (autograd- and torch.func-aware)."""
    return LayerNormFn.apply(x2d, scale, bias, eps)


def _bind():
    lib = _build.load("layer_norm")
    if lib.layer_norm_fwd.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.layer_norm_fwd.argtypes = [p, p, p, p, p, p, i, i, ll, i, i, f,
                                       i, p]
        lib.layer_norm_bwd.argtypes = [p, p, p, p, p, i, i, i, ll, ll, i, f,
                                       i, p]
        for fn in (lib.layer_norm_fwd, lib.layer_norm_bwd):
            fn.restype = ctypes.c_int
    return lib
