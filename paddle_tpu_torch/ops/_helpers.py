"""Shared emitter helpers (counterpart of paddle_tpu/ops/_helpers.py):
fluid's elementwise `axis` broadcast rule, per-op random streams, the
detection ops' sampling jitter, dpsgd's Gaussian noise and the stable
sigmoid cross-entropy."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..framework.registry import BATCH_SENTINEL
from ..kernels.prng_mask import MASK32, philox4x32_10


def fluid_broadcast(x, y, axis):
    """fluid elementwise broadcasting: y's shape aligns to x starting at
    `axis` (elementwise_op_function.h in the reference); axis=-1 means
    trailing alignment."""
    if x.dim() == y.dim() or y.dim() == 0:
        return x, y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.dim() - axis - y.dim())
    return x, y.reshape(new_shape)


def op_generator(ctx, op):
    """Per-op torch.Generator: an explicit `seed` attr wins (fluid per-op
    seed semantics), else the context's (seed, step, uid) stream."""
    seed = op.attr("seed", 0)
    if seed and not ctx.abstract:
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(int(seed) + int(op.uid))
        return gen
    return ctx.key_for(op.uid, op.type)


def sampling_jitter(ctx, op, n, size, device):
    """[n, size] fp32 uniform draws in [0, 1) on the 2^-23 grid, the
    random priority the detection ops' fg/bg subsampling adds (the JAX
    package draws jax.random.uniform, one key an image, which the port
    cannot reproduce): element i of image b is the top 23 bits of word 0
    of Philox-4x32-10 at counter (i, b, 0, 0), keyed on the op's seed
    words, or on seed + uid where the op has a `seed` attr. A pure
    function of the key and the coordinates, so the CPU and the card draw
    the same values and nothing is read from the host. Zeros while
    inferring shapes."""
    if ctx.abstract:
        return torch.zeros((n, size), dtype=torch.float32, device=device)
    words = _op_words(ctx, op)
    i = torch.arange(size, dtype=torch.int64, device=device)
    b = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0 = philox4x32_10(i, b, zero, zero, words)[0].expand(n, size)
    return (w0 >> 9).to(torch.float32) * 2.0 ** -23


def _op_words(ctx, op):
    """The op's two Philox key words: seed + uid where it has a `seed`
    attr, else its seed words."""
    seed = op.attr("seed", 0)
    if seed:
        s = int(seed) + int(op.uid)
        return s & MASK32, (s >> 32) & MASK32
    return ctx.seed_words(op.uid, op.type)


def gaussian_noise(ctx, op, shape, device):
    """Standard normal fp32 draws of `shape`, by Box-Muller from Philox:
    flat element i takes words 0 and 1 of Philox-4x32-10 at counter (i,
    0, 0, 0) under the op's key words, u1 = (w0 >> 9 + 1) 2^-23 in (0,
    1] and u2 = (w1 >> 9) 2^-23, and sqrt(-2 ln u1) cos(2 pi u2). A pure
    function of the key and the element, as sampling_jitter, so the CPU
    and the card draw the same noise (the JAX package's is jax.random's,
    which the port does not reproduce). Zeros while inferring shapes."""
    if ctx.abstract:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    words = _op_words(ctx, op)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0, w1, _, _ = philox4x32_10(i, zero, zero, zero, words)
    u1 = ((w0 >> 9) + 1).to(torch.float32) * 2.0 ** -23
    u2 = (w1 >> 9).to(torch.float32) * 2.0 ** -23
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(shape)


def shape_attr(ctx, op):
    """The op's `shape` attr; -1 dims are allowed only while inferring
    shapes (they become the batch sentinel)."""
    shape = [int(s) for s in op.attr("shape")]
    if any(s == -1 for s in shape):
        if ctx.abstract:
            return [BATCH_SENTINEL if s == -1 else s for s in shape]
        raise ValueError(
            f"{op.type} with -1 (batch) dims cannot execute; pass a "
            "concrete shape"
        )
    return shape


def stable_sigmoid_ce(x, z):
    """Numerically stable sigmoid cross-entropy from logits:
    max(x, 0) - x z + log(1 + exp(-|x|)) (yolov3_loss,
    sigmoid_cross_entropy_with_logits). torch.maximum, as jnp.maximum,
    splits the gradient at x = 0 evenly; |x| is where(x >= 0, x, -x), so
    its gradient at 0 is 1, as jnp.abs's is (torch.abs's is 0): at x = 0
    the gradient is -z, the JAX package's, not sigmoid(0) - z."""
    mag = torch.where(x >= 0, x, -x)
    return torch.maximum(x, x.new_zeros(())) - x * z + F.softplus(-mag)
