// Standalone LayerNorm over rows, forward and backward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/layer_norm.py: _fwd_kernel
// (launched by layer_norm_fwd) and _bwd_kernel (launched by
// layer_norm_bwd). For each row of x [R, N], in fp32:
//
//   mean = E[x],  var = max(E[x^2] - mean^2, 0)     (one pass, as the TPU
//                                                     kernel computes it)
//   rstd = rsqrt(var + eps),  xhat = (x - mean) * rstd
//   y    = xhat * scale + bias                        (stored in x's dtype)
//
// and the backward, which recomputes the statistics from x as the TPU
// kernel does:
//
//   dx     = rstd * (dy*s - mean(dy*s) - xhat * mean(dy*s * xhat))
//   dscale = sum_rows dy * xhat,   dbias = sum_rows dy        (fp32 [N])
//
// scale and bias are fp32 or bf16 [N], or absent (ones and zeros); mean
// and var are written as fp32 [R].
//
// Design: a row belongs to WPR warps (one warp up to N = 1024, the whole
// 256-thread block at N = 8192); thread t of a row holds columns
// t, t + 32 WPR, ... in registers (NPL of them), so x (and dy) are read
// once, coalesced, and y (dx) written once. The row's sums come from warp
// shuffles and, across a row's warps, one step through shared memory in a
// fixed order. The TPU kernel carried dscale and dbias in one output block
// along its sequential grid; Hopper's blocks run in no order, so each
// block of BWD_ROWS rows sums its rows in registers and shared memory and
// writes one row of a [2, blocks, N] fp32 partial, which sum_partials.cu
// reduces over the blocks in a fixed order: deterministic, with no float
// atomics. The TPU's 256-row blocks are a TPU tiling, not part of the
// function.
//
// Both kernels do ~10 (forward) and ~20 (backward) flops per element
// against 4-8 (8-12) bytes of traffic in bf16 (fp32): they are bounded by
// device-memory bytes, and reading each input once and writing each output
// once is the whole of that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BWD_ROWS = 32;   // backward: rows per block
constexpr int MAX_N = 8192;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// element `col` of an [N] vector of kind 0 (fp32) or 1 (bf16); any other
// kind is an absent vector, which reads as `absent`
__device__ __forceinline__ float vec_at(const void* p, int kind, int col,
                                        float absent) {
  if (kind == 0) return static_cast<const float*>(p)[col];
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[col]);
  return absent;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sums of a and b over the WPR warps of this thread's row, the same
// in every thread of the row. With WPR > 1 every thread of the block must
// call it together (two __syncthreads).
template <int WPR>
__device__ __forceinline__ void row_sum2(float& a, float& b,
                                         float (*red)[2]) {
  a = warp_sum(a);
  b = warp_sum(b);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[warp][0] = a;
      red[warp][1] = b;
    }
    __syncthreads();
    const int first = warp / WPR * WPR;
    a = b = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) {
      a += red[first + w][0];
      b += red[first + w][1];
    }
    __syncthreads();  // red is free for the next call
  }
}

template <typename T, int NPL, int WPR>
__global__ void __launch_bounds__(THREADS)
ln_row_fwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                  const void* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ var_out,
                  int R, int N, long long x_rs, int s_kind, int b_kind,
                  float eps) {
  __shared__ float red[WARPS][2];
  constexpr int ROWS = WARPS / WPR;  // rows per block
  constexpr int STRIDE = 32 * WPR;   // columns between a thread's values
  const int t = threadIdx.x % STRIDE;
  const int row = blockIdx.x * ROWS + threadIdx.x / STRIDE;
  // a block's last rows may lie past R: they load nothing and store
  // nothing, but join the block-wide reduction steps
  const bool valid = row < R;
  const T* xr = x + (long long)(valid ? row : 0) * x_rs;
  float v[NPL], sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = t + STRIDE * i;
    v[i] = (valid && col < N) ? to_f(xr[col]) : 0.f;
    sum += v[i];
    sq = fmaf(v[i], v[i], sq);
  }
  row_sum2<WPR>(sum, sq, red);
  const float mean = sum / N;
  const float var = fmaxf(sq / N - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (!valid) return;
  T* yr = y + (long long)row * N;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int col = t + STRIDE * i;
    if (col < N) {
      yr[col] = from_f<T>((v[i] - mean) * rstd * vec_at(scale, s_kind, col, 1.f)
                          + vec_at(bias, b_kind, col, 0.f));
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <typename T, int NPL, int WPR>
__global__ void __launch_bounds__(THREADS)
ln_row_bwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int R, int N, long long x_rs,
                  long long dy_rs, int s_kind, float eps) {
  __shared__ float red[WARPS][2];
  constexpr int ROWS = WARPS / WPR;  // rows in flight per block
  constexpr int STRIDE = 32 * WPR;
  // each row group's column sums, then summed over the groups in order:
  // ROWS * N <= ROWS * 32 WPR NPL = 8192 floats
  __shared__ float cols[MAX_N];
  const int t = threadIdx.x % STRIDE;
  const int group = threadIdx.x / STRIDE;
  float ds[NPL], db[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) ds[i] = db[i] = 0.f;

  // BWD_ROWS is a multiple of ROWS: every thread runs the same iterations,
  // as row_sum2 needs
  for (int rr = group; rr < BWD_ROWS; rr += ROWS) {
    const int row = blockIdx.x * BWD_ROWS + rr;
    const bool valid = row < R;
    const T* xr = x + (long long)(valid ? row : 0) * x_rs;
    const T* dyr = dy + (long long)(valid ? row : 0) * dy_rs;
    float v[NPL], g[NPL], sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int col = t + STRIDE * i;
      const bool in = valid && col < N;
      v[i] = in ? to_f(xr[col]) : 0.f;
      g[i] = in ? to_f(dyr[col]) : 0.f;
      sum += v[i];
      sq = fmaf(v[i], v[i], sq);
    }
    row_sum2<WPR>(sum, sq, red);
    const float mean = sum / N;
    const float rstd = rsqrtf(fmaxf(sq / N - mean * mean, 0.f) + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int col = t + STRIDE * i;
      const bool in = valid && col < N;
      const float xh = in ? (v[i] - mean) * rstd : 0.f;
      v[i] = xh;  // v now holds xhat
      ds[i] = fmaf(g[i], xh, ds[i]);
      db[i] += g[i];
      g[i] *= in ? vec_at(scale, s_kind, col, 1.f) : 0.f;  // g now dy * s
      m1 += g[i];
      m2 = fmaf(g[i], xh, m2);
    }
    row_sum2<WPR>(m1, m2, red);
    m1 /= N;
    m2 /= N;
    if (valid) {
      T* dxr = dx + (long long)row * N;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int col = t + STRIDE * i;
        if (col < N) dxr[col] = from_f<T>(rstd * (g[i] - m1 - v[i] * m2));
      }
    }
  }

  // this block's column sums of dscale and dbias, over its groups in order
  float* prow_s = part + (long long)blockIdx.x * N;
  float* prow_b = part + ((long long)gridDim.x + blockIdx.x) * N;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int col = t + STRIDE * i;
      if (col < N) cols[group * N + col] = pass == 0 ? ds[i] : db[i];
    }
    __syncthreads();
    float* prow = pass == 0 ? prow_s : prow_b;
    for (int col = threadIdx.x; col < N; col += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s += cols[r * N + col];
      prow[col] = s;
    }
    __syncthreads();
  }
}

struct Args {
  const void *x, *scale, *bias, *dy;
  void *y, *dx;
  float *mean, *var, *part;
  int R, N;
  long long x_rs, dy_rs;
  int s_kind, b_kind;
  float eps;
};

template <typename T, int NPL, int WPR>
cudaError_t launch(bool backward, const Args& a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a.x);
  if (!backward) {
    constexpr int ROWS = WARPS / WPR;
    const int blocks = (a.R + ROWS - 1) / ROWS;
    ln_row_fwd_kernel<T, NPL, WPR><<<blocks, THREADS, 0, stream>>>(
        x, a.scale, a.bias, static_cast<T*>(a.y), a.mean, a.var, a.R, a.N,
        a.x_rs, a.s_kind, a.b_kind, a.eps);
  } else {
    const int blocks = (a.R + BWD_ROWS - 1) / BWD_ROWS;
    ln_row_bwd_kernel<T, NPL, WPR><<<blocks, THREADS, 0, stream>>>(
        x, a.scale, static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
        a.part, a.R, a.N, a.x_rs, a.dy_rs, a.s_kind, a.eps);
  }
  return cudaGetLastError();
}

// the least warps per row, then the least values per thread, that hold N
template <typename T, int WPR>
cudaError_t pick_npl(bool backward, const Args& a, cudaStream_t stream) {
  const int per = (a.N + 32 * WPR - 1) / (32 * WPR);  // values per thread
  if constexpr (WPR == 1) {  // more warps per row start above 16 values
    if (per <= 4) return launch<T, 4, WPR>(backward, a, stream);
    if (per <= 8) return launch<T, 8, WPR>(backward, a, stream);
    if (per <= 16) return launch<T, 16, WPR>(backward, a, stream);
  }
  if (per <= 24) return launch<T, 24, WPR>(backward, a, stream);
  if (per <= 32) return launch<T, 32, WPR>(backward, a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_n(bool backward, const Args& a, cudaStream_t stream) {
  if (a.N <= 1024) return pick_npl<T, 1>(backward, a, stream);
  if (a.N <= 2048) return pick_npl<T, 2>(backward, a, stream);
  if (a.N <= 4096) return pick_npl<T, 4>(backward, a, stream);
  if (a.N <= MAX_N) return pick_npl<T, 8>(backward, a, stream);
  return cudaErrorInvalidValue;
}

int dispatch(bool backward, int dtype, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.R <= 0 || a.N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_n<float>(backward, a, st);
  if (dtype == 1) return (int)dispatch_n<__nv_bfloat16>(backward, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, y, dx). s_kind, b_kind: 0 =
// fp32 [N], 1 = bf16 [N], -1 = absent (ones, zeros). x and dy have
// contiguous rows of the given strides (in elements); y and dx are
// contiguous [R, N]; mean and var fp32 [R]; part fp32
// [2, ceil(R / 32), N] (dscale partials, then dbias). N <= 8192. Each
// returns the cudaError_t of its launch (0 on success).
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, float* mean,
                              float* var, int R, int N, long long x_rs,
                              int s_kind, int b_kind, float eps, int dtype,
                              void* stream) {
  Args a{x, scale, bias, nullptr, y, nullptr, mean, var, nullptr, R, N,
         x_rs, 0, s_kind, b_kind, eps};
  return dispatch(false, dtype, a, stream);
}

extern "C" int layer_norm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, float* part, int R,
                              int N, long long x_rs, long long dy_rs,
                              int s_kind, float eps, int dtype,
                              void* stream) {
  Args a{x, scale, nullptr, dy, nullptr, dx, nullptr, nullptr, part, R, N,
         x_rs, dy_rs, s_kind, -1, eps};
  return dispatch(true, dtype, a, stream);
}
