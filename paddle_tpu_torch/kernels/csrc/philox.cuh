// Philox-4x32-10 keep mask shared by the training-dropout kernels.
//
// Replaces the TPU kernels' hardware-PRNG draw, paddle_tpu/kernels/
// prng_mask.py:keep_mask, whose bits depend on the grid and cannot be
// reproduced off the TPU. Here the mask is a pure function of two seed
// words and an element's coordinates, the same in every kernel and in the
// plain PyTorch version (paddle_tpu_torch/kernels/prng_mask.py), whatever
// the tiling:
//
//   one Philox-4x32-10 block (Random123's constants) of counter
//   (c0, c1, c2, c3) and key (seed0, seed1) gives four 32-bit words, read
//   as eight 16-bit lanes: lane 2w is the low half of word w, lane 2w + 1
//   the high half. An element keeps when its lane's u16 >= threshold,
//   with threshold = min(int(rate * 65536), 0xFFFF), the TPU kernels'
//   own 16-bit quantisation of the drop rate.
//
// Attention element (b, h, i, j) reads lane j & 7 of counter
// (j >> 3, i, h, b); residual element (r, n) reads lane n & 7 of counter
// (n >> 3, r, 0, 0). keep_byte returns the eight keep bits of one block,
// bit l for lane l, so a kernel draws one block per eight elements.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

constexpr uint32_t M0 = 0xD2511F53u;
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;
constexpr uint32_t W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, c.x);
    const uint32_t lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z);
    const uint32_t lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// The eight keep bits of counter (c0, c1, c2, c3): bit l is lane l.
__device__ __forceinline__ uint32_t keep_byte(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t seed0, uint32_t seed1,
                                              uint32_t threshold) {
  const uint4 r = philox4x32_10(make_uint4(c0, c1, c2, c3), seed0, seed1);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  uint32_t bits = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const uint32_t u16 = (l & 1) ? (w[l >> 1] >> 16) : (w[l >> 1] & 0xFFFFu);
    bits |= (u16 >= threshold ? 1u : 0u) << l;
  }
  return bits;
}

}  // namespace philox
