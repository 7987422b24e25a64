"""The training-dropout keep mask: Philox-4x32-10 keyed on element
coordinates (counterpart of paddle_tpu/kernels/prng_mask.py).

Replaces: paddle_tpu/kernels/prng_mask.py:keep_mask, the device function
that draws the TPU's hardware PRNG inside the attention and residual
kernels. Those bits follow the TPU's grid and cannot be reproduced, so the
port defines the mask as a pure function of two seed words and the
element's coordinates, the same in every CUDA kernel (csrc/philox.cuh)
and in this plain version, whatever the tiling. That is what lets the
backward kernels regenerate the forward's mask instead of storing it, and
lets the card hold each kernel against its plain version with training
dropout on.

Layout: the element at (..., lead1, lead0, row, col) reads 16-bit lane
col & 7 of one Philox block with counter (col >> 3, row, lead0, lead1)
and key (seed0, seed1); lane 2w is the low half of output word w, lane
2w + 1 the high half. It keeps when that u16 >= threshold(rate) =
min(int(rate * 65536), 0xFFFF), the TPU kernels' 16-bit quantisation.
Attention [B, H, Sq, Sk] uses lead = (B, H); the residual [R, N] none.

The plain version computes the bit-identical mask with int64 torch ops.
A 32x32-bit product does not fit int64, so each multiplier is split into
16-bit halves and the high and low words are put together exactly.
"""

from __future__ import annotations

import torch

from ..errors import InvalidArgumentError

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def threshold(rate):
    """16-bit drop threshold: an element keeps when its u16 >= this."""
    return min(int(float(rate) * 65536.0), 0xFFFF)


def drop_scale(rate, is_test, upscale):
    """fluid's dropout factor on a kept value: in training 1/(1-p) under
    upscale_in_train and 1 under downgrade_in_infer; in test mode 1 and
    1-p (dropout_op.cc)."""
    if rate == 0.0:
        return 1.0
    if is_test:
        return 1.0 if upscale else 1.0 - rate
    return 1.0 / (1.0 - rate) if upscale else 1.0


def mask_args(rate, is_test, seed, who):
    """(use_mask, seed0, seed1, threshold) for a kernel launch. Training
    dropout needs the two seed words: a mask unrelated to the one the
    forward drew would give silently wrong gradients."""
    use = rate > 0.0 and not is_test
    if use and seed is None:
        raise InvalidArgumentError(
            f"{who}: training dropout needs the op's two seed words"
        )
    s0, s1 = seed if use else (0, 0)
    return int(use), int(s0) & MASK32, int(s1) & MASK32, threshold(rate)


def _mulhilo(a, m):
    """(high, low) 32-bit words of a * m, a an int64 tensor of uint32
    values, m a 32-bit constant, without overflowing int64."""
    x = a * (m & 0xFFFF)  # < 2^48
    t = a * (m >> 16) + (x >> 16)  # < 2^48 + 2^32
    return t >> 16, ((t & 0xFFFF) << 16) | (x & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, seed):
    """Philox-4x32-10 over int64 tensors of uint32 counter words
    (broadcastable); seed is two uint32 key words. Returns four words."""
    k0, k1 = int(seed[0]) & MASK32, int(seed[1]) & MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
    return c0, c1, c2, c3


def keep_mask(seed, rate, rows, cols, lead=(), row0=0, col0=0,
              device="cpu"):
    """bool keep mask [*lead, rows, cols] of the elements at rows
    row0 + r and columns col0 + c (a tile of a larger mask is the same
    slice of the whole). lead has at most two dims."""
    if len(lead) > 2:
        raise ValueError(f"keep_mask: at most two lead dims, got {lead}")
    dev = torch.device(device)

    def ar(n, start=0):
        return torch.arange(start, start + n, dtype=torch.int64, device=dev)

    g0 = col0 >> 3
    groups = ((col0 + cols + 7) >> 3) - g0
    lead_ix = [ar(n) for n in lead]
    # counter words, broadcast to [*lead, rows, groups]
    nd = len(lead) + 2
    c0 = ar(groups, g0).reshape((1,) * (nd - 1) + (groups,))
    c1 = ar(rows, row0).reshape((1,) * (nd - 2) + (rows, 1))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    c2 = c3 = zero
    if len(lead) >= 1:
        c2 = lead_ix[-1].reshape((1,) * (len(lead) - 1) + (lead[-1], 1, 1))
    if len(lead) == 2:
        c3 = lead_ix[0].reshape((lead[0], 1, 1, 1))
    words = philox4x32_10(c0, c1, c2, c3, seed)
    shape = tuple(lead) + (rows, groups)
    lanes = []
    for w in words:
        w = w.expand(shape)
        lanes += [w & 0xFFFF, w >> 16]
    u16 = torch.stack(lanes, dim=-1).reshape(tuple(lead) + (rows, groups * 8))
    off = col0 - 8 * g0
    return u16[..., off:off + cols] >= threshold(rate)
