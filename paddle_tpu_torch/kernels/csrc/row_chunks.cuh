// Row helpers of the LayerNorm kernels (fused_dropout_add_ln.cu,
// layer_norm.cu), for Hopper (sm_90a).
//
// The backward row kernels #4 (ln_bwd_kernel) and #11 (ln_row_bwd_kernel)
// share one row layout: lane L of a warp holds its row in chunks of
// V = 16 / sizeof(T) consecutive columns (fp32 4, bf16 8), chunk i at
// column V (L + 32 i) (#11 with several warps a row: V (t + 32 WPR i),
// t the thread's place in its row), read and written as one 16-byte
// vector where every row is 16-byte aligned and N is a whole number of
// chunks, else the same chunks element by element. The C entry decides
// with aligned16; one layout and one arithmetic give the same bits on
// both paths.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// V consecutive columns of a row, widened to fp32 (zeros past N): one
// 16-byte load on the vector path, else element by element
template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_chunk(float (&o)[V], const T* p, int c0,
                                           int N) {
  if constexpr (VEC) {
    static_assert(V * sizeof(T) == 16, "a chunk is one 16-byte vector");
    if (c0 >= N) {  // N % V == 0 on this path: a chunk is in or out
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = 0.f;
      return;
    }
    const uint4 u = *reinterpret_cast<const uint4*>(p + c0);
    if constexpr (sizeof(T) == 4) {
      o[0] = __uint_as_float(u.x);
      o[1] = __uint_as_float(u.y);
      o[2] = __uint_as_float(u.z);
      o[3] = __uint_as_float(u.w);
    } else {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // element 2j in the low half, 2j + 1 in the high half
        o[2 * j] = __uint_as_float(w[j] << 16);
        o[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = c0 + e < N ? to_f(p[c0 + e]) : 0.f;
  }
}

template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_chunk(T* p, const float (&v)[V], int c0,
                                            int N) {
  if constexpr (VEC) {
    if (c0 >= N) return;
    uint4 u;
    if constexpr (sizeof(T) == 4) {
      u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(p + c0) = u;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c0 + e < N) p[c0 + e] = from_f<T>(v[e]);
  }
}

// fp32 [V] at column c0 of an fp32 vector (zeros past N), as load_chunk
template <int V, bool VEC>
__device__ __forceinline__ void load_f32(float (&o)[V], const float* p,
                                         int c0, int N) {
#pragma unroll
  for (int j = 0; j < V; j += 4)
    load_chunk<float, 4, VEC>(*reinterpret_cast<float(*)[4]>(o + j), p,
                              c0 + j, N);
}

bool aligned16(const void* p, long long row_stride, size_t es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (row_stride * (long long)es) % 16 == 0;
}

// f(integral_constant NC) for the fewest chunks of V = 16 / sizeof(T)
// columns that hold N columns in 32 lanes (8, 16, 24 or 32 columns a
// lane); N is the columns of one warp (a row's over its warps)
template <typename T, typename F>
cudaError_t with_chunks(int N, F f) {
  constexpr int V = 16 / sizeof(T);
  if (N <= 32 * 8) return f(std::integral_constant<int, 8 / V>{});
  if (N <= 32 * 16) return f(std::integral_constant<int, 16 / V>{});
  if (N <= 32 * 24) return f(std::integral_constant<int, 24 / V>{});
  if (N <= 32 * 32) return f(std::integral_constant<int, 32 / V>{});
  return cudaErrorInvalidValue;
}

}  // namespace
