// Fused dropout + residual add + LayerNorm, forward and backward, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/fused_residual.py:
// _fwd_kernel (launched by fused_dropout_add_ln_fwd) and _bwd_kernel
// (launched by fused_dropout_add_ln_bwd). For each row of x, y [R, N]:
//
//   z    = x + keep . y * y_scale             (fp32; keep: the Philox mask
//                                              of philox.cuh in training,
//                                              else all ones)
//   mean = E[z],  var = max(E[z^2] - mean^2, 0)   (one pass, as the TPU
//                                                   kernel computes it)
//   out  = (z - mean) * rsqrt(var + eps) * g + c
//
// y_scale carries fluid's dropout: in training 1/(1-p) under
// upscale_in_train and 1 under downgrade_in_infer; in test mode 1-p or 1.
//
// Forward design: one warp per row, eight rows per 256-thread block. Lane
// i holds columns i, i+32, ... in registers (NPL of them), so x and y are
// read once, coalesced, and out is written once; the two row sums are
// reduced with warp shuffles. In training each lane draws the Philox
// blocks of a few groups of eight columns and hands the keep bits to the
// lanes that hold those columns with a shuffle: one draw per eight
// elements.
//
// Backward design: the same warp-per-row layout recomputes z, mean and
// rstd in registers and regenerates the mask from the same coordinates,
// so no mask, z or statistic reaches device memory; it writes dx and dy.
// The TPU kernel summed dg = sum_rows dO * zhat and dc = sum_rows dO in
// one output block carried along its sequential grid; Hopper's blocks run
// in no order, so each block of BWD_ROWS rows sums its rows in registers
// and shared memory and writes one row of a [2, blocks, N] fp32 partial,
// which a second small kernel (sum_partials.cu) reduces over the blocks in
// a fixed order: deterministic, with no float atomics.
//
// Both kernels do ~10-30 flops per 12-20 bytes of fp32 traffic: they are
// bounded by device-memory bytes, and reading each input once and
// writing each output once is the whole of that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = WARPS;  // forward: one row per warp
constexpr int BWD_ROWS = 64;           // backward: rows per block
constexpr int MAX_N = 1024;

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

struct Dropout {
  int use_mask;
  uint32_t seed0, seed1, threshold;
};

// Keep flags of this lane's NPL columns (lane + 32 i) of row `row`: lane L
// draws the Philox blocks of column groups L, L + 32, ... and the lane
// holding a column reads its group's byte with a shuffle. The whole warp
// must call this together.
template <int NPL>
__device__ __forceinline__ void row_keep(bool (&keep)[NPL], const Dropout& dr,
                                         int row, int lane) {
  if (!dr.use_mask) {  // uniform across the grid: no draws, no shuffles
#pragma unroll
    for (int i = 0; i < NPL; ++i) keep[i] = true;
    return;
  }
  constexpr int SLOTS = (NPL + 7) / 8;  // groups a lane draws
  uint32_t kb[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    kb[s] = philox::keep_byte((uint32_t)(lane + 32 * s), (uint32_t)row, 0u,
                              0u, dr.seed0, dr.seed1, dr.threshold);
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    // column lane + 32 i is in group (lane >> 3) + 4 i: slot (4 i) >> 5
    const int g = (lane >> 3) + 4 * i;
    const uint32_t byte = __shfl_sync(0xffffffffu, kb[(4 * i) >> 5], g & 31);
    keep[i] = (byte >> (lane & 7)) & 1u;
  }
}

// z = x + keep . y * y_scale for this lane's columns; returns the row's
// mean and rstd (one-pass statistics, as the TPU kernel computes them)
template <typename T, int NPL>
__device__ __forceinline__ void row_z(float (&z)[NPL], const bool (&keep)[NPL],
                                      const T* xr, const T* yr, int N,
                                      int lane, float y_scale, float eps,
                                      float& mean, float& rstd) {
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = lane + 32 * i;
    float v = 0.f;
    if (col < N) {
      // y is loaded whatever the keep flag: a load behind the flag keeps
      // the row's loads from being in flight together
      const float yv = to_f(yr[col]) * y_scale;
      v = to_f(xr[col]) + (keep[i] ? yv : 0.f);
    }
    z[i] = v;
    sum += v;
    sq = fmaf(v, v, sq);
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  mean = sum / N;
  const float var = fmaxf(sq / N - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

template <typename T, int NPL>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const float* __restrict__ g, const float* __restrict__ c,
              T* __restrict__ out, int R, int N, long long x_rs, long long y_rs,
              long long o_rs, float y_scale, float eps, Dropout dr) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp leaves together
  bool keep[NPL];
  row_keep<NPL>(keep, dr, row, lane);
  float z[NPL], mean, rstd;
  row_z<T, NPL>(z, keep, x + (long long)row * x_rs, y + (long long)row * y_rs,
                N, lane, y_scale, eps, mean, rstd);
  T* orow = out + (long long)row * o_rs;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = lane + 32 * i;
    if (col < N) orow[col] = from_f<T>((z[i] - mean) * rstd * g[col] + c[col]);
  }
}

template <typename T, int NPL>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const float* __restrict__ g, const T* __restrict__ dout,
              T* __restrict__ dx, T* __restrict__ dy, float* __restrict__ part,
              int R, int N, long long x_rs, long long y_rs, long long do_rs,
              long long dx_rs, long long dy_rs, float y_scale, float eps,
              Dropout dr) {
  __shared__ float red[WARPS][MAX_N];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float dg[NPL], dc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) dg[i] = dc[i] = 0.f;

  for (int rr = warp; rr < BWD_ROWS; rr += WARPS) {
    const int row = blockIdx.x * BWD_ROWS + rr;
    if (row >= R) break;  // uniform across the warp
    bool keep[NPL];
    row_keep<NPL>(keep, dr, row, lane);
    float z[NPL], mean, rstd;
    row_z<T, NPL>(z, keep, x + (long long)row * x_rs,
                  y + (long long)row * y_rs, N, lane, y_scale, eps, mean,
                  rstd);
    const T* dor = dout + (long long)row * do_rs;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int col = lane + 32 * i;
      float d = 0.f, zh = 0.f;
      if (col < N) {
        d = to_f(dor[col]);
        zh = (z[i] - mean) * rstd;
      }
      z[i] = zh;  // z now holds zhat
      dg[i] = fmaf(d, zh, dg[i]);
      dc[i] += d;
      const float dyw = col < N ? d * g[col] : 0.f;
      m1 += dyw;
      m2 = fmaf(dyw, zh, m2);
    }
    m1 = warp_sum(m1) / N;
    m2 = warp_sum(m2) / N;
    T* dxr = dx + (long long)row * dx_rs;
    T* dyr = dy + (long long)row * dy_rs;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int col = lane + 32 * i;
      if (col < N) {
        const float dyw = to_f(dor[col]) * g[col];
        const float dz = rstd * (dyw - m1 - z[i] * m2);
        dxr[col] = from_f<T>(dz);
        dyr[col] = from_f<T>(keep[i] ? dz * y_scale : 0.f);
      }
    }
  }

  // this block's column sums of dg and dc, summed over its warps in order
  float* prow_g = part + (long long)blockIdx.x * N;
  float* prow_c = part + ((long long)gridDim.x + blockIdx.x) * N;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = lane + 32 * i;
    if (col < N) red[warp][col] = dg[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < N; col += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][col];
    prow_g[col] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = lane + 32 * i;
    if (col < N) red[warp][col] = dc[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < N; col += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][col];
    prow_c[col] = s;
  }
}

struct Args {
  const void *x, *y, *dout;
  const float *g, *c;
  void *out, *dx, *dy;
  float* part;
  int R, N;
  long long x_rs, y_rs, do_rs, o_rs, dx_rs, dy_rs;
  float y_scale, eps;
  Dropout dr;
};

template <typename T, int NPL>
cudaError_t launch(bool backward, const Args& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  const T* y = static_cast<const T*>(a.y);
  if (!backward) {
    const int blocks = (a.R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    ln_fwd_kernel<T, NPL><<<blocks, THREADS, 0, stream>>>(
        x, y, a.g, a.c, static_cast<T*>(a.out), a.R, a.N, a.x_rs, a.y_rs,
        a.o_rs, a.y_scale, a.eps, a.dr);
  } else {
    const int blocks = (a.R + BWD_ROWS - 1) / BWD_ROWS;
    ln_bwd_kernel<T, NPL><<<blocks, THREADS, 0, stream>>>(
        x, y, a.g, static_cast<const T*>(a.dout), static_cast<T*>(a.dx),
        static_cast<T*>(a.dy), a.part, a.R, a.N, a.x_rs, a.y_rs, a.do_rs,
        a.dx_rs, a.dy_rs, a.y_scale, a.eps, a.dr);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(bool backward, const Args& a, cudaStream_t stream) {
  // the smallest register row that holds N columns
  if (a.N <= 32 * 4) return launch<T, 4>(backward, a, stream);
  if (a.N <= 32 * 8) return launch<T, 8>(backward, a, stream);
  if (a.N <= 32 * 16) return launch<T, 16>(backward, a, stream);
  if (a.N <= 32 * 24) return launch<T, 24>(backward, a, stream);
  if (a.N <= 32 * 32) return launch<T, 32>(backward, a, stream);
  return cudaErrorInvalidValue;
}

int dispatch(bool backward, int dtype, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_n<float>(backward, a, st);
  if (dtype == 1) return (int)dispatch_n<__nv_bfloat16>(backward, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dout, out, dx, dy); g and c are
// fp32 [N]. Row strides are in elements; each row is contiguous;
// N <= 1024. part is fp32 [2, ceil(R / 64), N] (dg partials, then dc).
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int fused_dropout_add_ln_fwd(
    const void* x, const void* y, const float* g, const float* c, void* out,
    int R, int N, long long x_rs, long long y_rs, long long o_rs,
    float y_scale, float eps, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  Args a{x, y, nullptr, g, c, out, nullptr, nullptr, nullptr, R, N,
         x_rs, y_rs, 0, o_rs, 0, 0, y_scale, eps,
         Dropout{use_mask, seed0, seed1, threshold}};
  return dispatch(false, dtype, a, stream);
}

extern "C" int fused_dropout_add_ln_bwd(
    const void* x, const void* y, const float* g, const void* dout, void* dx,
    void* dy, float* part, int R, int N, long long x_rs, long long y_rs,
    long long do_rs, long long dx_rs, long long dy_rs, float y_scale,
    float eps, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  Args a{x, y, dout, g, nullptr, nullptr, dx, dy, part, R, N,
         x_rs, y_rs, do_rs, 0, dx_rs, dy_rs, y_scale, eps,
         Dropout{use_mask, seed0, seed1, threshold}};
  return dispatch(true, dtype, a, stream);
}
