"""Fused dropout + residual add + LayerNorm, forward and backward:
hand-written CUDA kernels and their plain PyTorch versions (counterpart
of paddle_tpu/kernels/fused_residual.py).

Replaces: paddle_tpu/kernels/fused_residual.py:_fwd_kernel (behind
`fused_dropout_add_ln_fwd`) and _bwd_kernel (behind
`fused_dropout_add_ln_bwd`).

Computes, over rows of x, y [R, N]: z = x + dropout(y) in fp32, then
mean = E[z], var = max(E[z^2] - mean^2, 0) (one pass, as the TPU kernel
computes it) and out = (z - mean) * rsqrt(var + eps) * g + c. Dropout
follows fluid: in training the Philox keep mask of prng_mask.py (keyed
by the op's two seed words), kept values scaled by 1/(1-p) under
`upscale_in_train`; in test mode `downgrade_in_infer` scales y by 1-p.
The backward gives dx, dy (masked and scaled as y was) and
dg = sum_rows dO * zhat, dc = sum_rows dO in fp32.

What bounds it on the H100: ~10 flops forward (~30 backward) per
element against 12 (20) bytes of fp32 traffic, so device-memory bytes.
The designs (csrc/fused_dropout_add_ln.cu) give each row to one warp,
which holds it in registers between the row sums and the normalisation:
x, y (and dO) are read once and each output written once. The backward
reads and writes its rows as 16-byte vectors (fp32 4 columns, bf16 8 a
lane's chunk), recomputes z and the statistics and regenerates the mask
rather than reading them back, and accumulates dg and dc in shared
memory; they go through one partial row per group of rows (bwd_groups)
and a fixed-order second pass (sum_partials.py) instead of the TPU's
accumulation along a sequential grid.

Dispatch: a CUDA tensor goes to the kernels, or raises if they do not
take it; a CPU tensor goes to the plain version; a meta tensor (shape
inference) gets an empty output of the right shape.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidArgumentError
from . import _build
from .prng_mask import drop_scale, keep_mask, mask_args
from .sum_partials import sum_partials

# the kernels keep a row in registers: 32 lanes x at most 32 values
MAX_N = 1024
# the backward's row groups (one block and one partial row each): at most
# BWD_GROUPS groups of at least BWD_MIN_ROWS consecutive rows
BWD_GROUPS = 512
BWD_MIN_ROWS = 16
DTYPES = (torch.float32, torch.bfloat16)


def bwd_groups(R):
    """(groups, rows per group) of the backward kernel over R rows, the
    last group ragged: a function of R alone, never of the device, so dg
    and dc are summed in one order on every card."""
    rows = max(BWD_MIN_ROWS, -(-R // BWD_GROUPS))
    return -(-R // rows), rows


def _z(x2d, y2d, rate, is_test, upscale, seed):
    """fp32 z = x + dropout(y) and the keep mask (None outside training)."""
    R, N = x2d.shape
    y = y2d.float() * drop_scale(rate, is_test, upscale)
    keep = None
    if rate > 0.0 and not is_test:
        keep = keep_mask(seed, rate, R, N, device=x2d.device)
        y = y * keep
    return x2d.float() + y, keep


def _stats(z, eps):
    mean = z.mean(dim=1, keepdim=True)
    var = torch.clamp(z.square().mean(dim=1, keepdim=True) - mean.square(),
                      min=0.0)
    return mean, torch.rsqrt(var + eps)


def reference_fwd(x2d, y2d, g=None, c=None, *, rate=0.0, is_test=True,
                  upscale=False, eps=1e-5, seed=None):
    """The plain version: the same function in PyTorch ops, in fp32, cast
    back to x's dtype (as the JAX package's `reference_fwd`), with the
    kernels' Philox mask in training."""
    mask_args(rate, is_test, seed, "reference_fwd")
    z, _ = _z(x2d, y2d, rate, is_test, upscale, seed)
    mean, rstd = _stats(z, eps)
    out = (z - mean) * rstd
    if g is not None:
        out = out * g.float()
    if c is not None:
        out = out + c.float()
    return out.to(x2d.dtype)


def reference_bwd(x2d, y2d, g, d_out, *, rate=0.0, is_test=True,
                  upscale=False, eps=1e-5, seed=None):
    """The plain backward, in the formulas of the JAX package's
    `_bwd_kernel`: (dx, dy in x's and y's dtypes, dg, dc fp32 [N])."""
    mask_args(rate, is_test, seed, "reference_bwd")
    z, keep = _z(x2d, y2d, rate, is_test, upscale, seed)
    mean, rstd = _stats(z, eps)
    zhat = (z - mean) * rstd
    do = d_out.float()
    dyw = do * (g.float() if g is not None else 1.0)
    dz = rstd * (dyw - dyw.mean(dim=1, keepdim=True)
                 - zhat * (dyw * zhat).mean(dim=1, keepdim=True))
    dy = dz * drop_scale(rate, is_test, upscale)
    if keep is not None:
        dy = dy * keep
    return (dz.to(x2d.dtype), dy.to(y2d.dtype), (do * zhat).sum(0),
            do.sum(0))


def _check(x2d, y2d, who):
    R, N = x2d.shape
    if x2d.device.type != "cuda":
        raise InvalidArgumentError(f"{who}: unsupported device {x2d.device}")
    if (x2d.dtype not in DTYPES or y2d.dtype != x2d.dtype or N > MAX_N
            or x2d.stride(1) != 1 or y2d.stride(1) != 1
            or y2d.device != x2d.device):
        raise InvalidArgumentError(
            f"{who}: the kernels take fp32/bf16 x and y of one dtype on one "
            f"device, contiguous rows, N <= {MAX_N}; got {x2d.dtype}/"
            f"{y2d.dtype}, N={N}, strides {x2d.stride()}/{y2d.stride()}"
        )


def _vec(v, N, fill, dev, who):
    v = (torch.full((N,), fill, device=dev) if v is None
         else v.float()).contiguous()
    if v.shape != (N,) or v.device != dev:
        raise InvalidArgumentError(
            f"{who}: scale and bias must be [{N}] on {dev}"
        )
    return v


def fused_dropout_add_ln_fwd(x2d, y2d, g=None, c=None, *, rate=0.0,
                             is_test=True, upscale=False, eps=1e-5,
                             seed=None):
    """LN(x + dropout(y)) * g + c over rows of [R, N].

    The kernel takes: fp32 or bf16 x and y of one dtype on a CUDA device,
    rows with a contiguous last dim, and N <= MAX_N. Training dropout
    (rate > 0, not is_test) needs `seed`, the op's two seed words, on
    every device."""
    if x2d.dim() != 2 or tuple(y2d.shape) != tuple(x2d.shape):
        raise InvalidArgumentError(
            f"fused_dropout_add_ln_fwd: x and y must be one [R, N] shape, "
            f"got {tuple(x2d.shape)} and {tuple(y2d.shape)}"
        )
    R, N = x2d.shape
    if x2d.device.type == "meta":
        return torch.empty((R, N), dtype=x2d.dtype, device=x2d.device)
    use_mask, s0, s1, thr = mask_args(rate, is_test, seed,
                                      "fused_dropout_add_ln_fwd")
    if x2d.device.type == "cpu":
        return reference_fwd(x2d, y2d, g, c, rate=rate, is_test=is_test,
                             upscale=upscale, eps=eps, seed=seed)
    who = "fused_dropout_add_ln_fwd"
    _check(x2d, y2d, who)
    dev = x2d.device
    g = _vec(g, N, 1.0, dev, who)
    c = _vec(c, N, 0.0, dev, who)
    out = torch.empty((R, N), dtype=x2d.dtype, device=dev)
    err = _bind().fused_dropout_add_ln_fwd(
        x2d.data_ptr(), y2d.data_ptr(), g.data_ptr(), c.data_ptr(),
        out.data_ptr(), R, N, x2d.stride(0), y2d.stride(0), out.stride(0),
        float(drop_scale(rate, is_test, upscale)), float(eps), use_mask, s0,
        s1, thr, DTYPES.index(x2d.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"fused_dropout_add_ln_fwd launch failed: CUDA error {err}"
        )
    fused_dropout_add_ln_fwd.launches += 1
    return out


fused_dropout_add_ln_fwd.launches = 0


def fused_dropout_add_ln_bwd(x2d, y2d, g, d_out, *, rate=0.0, is_test=True,
                             upscale=False, eps=1e-5, seed=None):
    """(dx, dy [R, N], dg, dc fp32 [N]) of fused_dropout_add_ln_fwd for
    the output gradient d_out [R, N], with the forward's mask regenerated
    from the same seed words. The kernel takes what the forward kernel
    takes, and d_out of x's dtype with contiguous rows."""
    who = "fused_dropout_add_ln_bwd"
    use_mask, s0, s1, thr = mask_args(rate, is_test, seed, who)
    if x2d.device.type == "cpu":
        return reference_bwd(x2d, y2d, g, d_out, rate=rate, is_test=is_test,
                             upscale=upscale, eps=eps, seed=seed)
    _check(x2d, y2d, who)
    R, N = x2d.shape
    dev = x2d.device
    if (tuple(d_out.shape) != (R, N) or d_out.dtype != x2d.dtype
            or d_out.device != dev or d_out.stride(1) != 1):
        raise InvalidArgumentError(
            f"{who}: d_out must be [R, N] = {(R, N)} of {x2d.dtype} on {dev} "
            f"with contiguous rows; got {tuple(d_out.shape)} {d_out.dtype} "
            f"on {d_out.device}"
        )
    g = _vec(g, N, 1.0, dev, who)
    dx = torch.empty((R, N), dtype=x2d.dtype, device=dev)
    dy = torch.empty((R, N), dtype=y2d.dtype, device=dev)
    groups, rows = bwd_groups(R)
    part = torch.empty((2, groups, N), dtype=torch.float32, device=dev)
    err = _bind().fused_dropout_add_ln_bwd(
        x2d.data_ptr(), y2d.data_ptr(), g.data_ptr(), d_out.data_ptr(),
        dx.data_ptr(), dy.data_ptr(), part.data_ptr(), R, N, rows,
        x2d.stride(0),
        y2d.stride(0), d_out.stride(0), dx.stride(0), dy.stride(0),
        float(drop_scale(rate, is_test, upscale)), float(eps), use_mask, s0,
        s1, thr, DTYPES.index(x2d.dtype),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"fused_dropout_add_ln_bwd launch failed: CUDA error {err}"
        )
    fused_dropout_add_ln_bwd.launches += 1
    dg, dc = sum_partials(part)
    return dx, dy, dg, dc


fused_dropout_add_ln_bwd.launches = 0


class FusedDropoutAddLn(torch.autograd.Function):
    """Differentiable fused_dropout_add_ln_fwd (counterpart of the JAX
    package's `fused_dropout_add_ln` custom_vjp): the backward calls the
    backward kernel with the forward's seed words. The static graph uses
    the dedicated fused_dropout_add_ln_grad op instead (ops/fused.py)."""

    @staticmethod
    def forward(ctx, x2d, y2d, g, c, kw):
        ctx.save_for_backward(x2d, y2d, g)
        ctx.kw = kw
        return fused_dropout_add_ln_fwd(x2d, y2d, g, c, **kw)

    @staticmethod
    def backward(ctx, d_out):
        x2d, y2d, g = ctx.saved_tensors
        dx, dy, dg, dc = fused_dropout_add_ln_bwd(
            x2d, y2d, g, d_out.contiguous(), **ctx.kw)
        return dx, dy, dg.to(g.dtype), dc.to(g.dtype), None


def fused_dropout_add_ln(x2d, y2d, g, c, **kw):
    """fused_dropout_add_ln_fwd through FusedDropoutAddLn (autograd-aware;
    g and c are required tensors here)."""
    return FusedDropoutAddLn.apply(x2d, y2d, g, c, kw)


def _bind():
    lib = _build.load("fused_dropout_add_ln")
    if lib.fused_dropout_add_ln_fwd.argtypes is None:
        p, i, ll, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        tail = [f, f, i, u, u, u, i, p]
        lib.fused_dropout_add_ln_fwd.argtypes = (
            [p, p, p, p, p, i, i, ll, ll, ll] + tail)
        lib.fused_dropout_add_ln_bwd.argtypes = (
            [p, p, p, p, p, p, p, i, i, i, ll, ll, ll, ll, ll] + tail)
        for fn in (lib.fused_dropout_add_ln_fwd, lib.fused_dropout_add_ln_bwd):
            fn.restype = ctypes.c_int
    return lib
