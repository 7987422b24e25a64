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
// Forward design: a row belongs to WPR warps (one warp up to N = 1024, the
// whole 256-thread block at N = 8192); thread t of a row holds columns
// t, t + 32 WPR, ... in registers (NPL of them), so x is read once,
// coalesced, and y written once. The row's sums come from warp shuffles
// and, across a row's warps, one step through shared memory in a fixed
// order.
//
// Backward design, the row layout of #4's backward (fused_dropout_add_ln.cu
// ln_bwd_kernel, with row_chunks.cuh's helpers):
//   - a row belongs to WPR warps, chosen from N alone as the forward's
//     (one warp up to N = 1024); a block holds 4 warps (8 for WPR = 8),
//     so SLOTS = warps / WPR rows are in flight a block. Thread t of a row
//     holds it in chunks of V = 16 / sizeof(T) consecutive columns (fp32
//     4, bf16 8), columns V (t + 32 WPR i) .. + V - 1, at most 32 values
//     of a tensor a thread; x and dy are read as 16-byte vectors, all of
//     a row's loads issued before its first reduction, and dx is stored
//     as 16-byte vectors. Where a row is not 16-byte aligned (a pointer,
//     a row stride, or N % V != 0) the same kernel loads and stores the
//     same chunks element by element (the C entry decides): one layout,
//     one arithmetic, the same bits. A thread reads its chunks of scale
//     once, before its block's rows;
//   - the row's two pairs of sums ((x, x^2), then (dy s, dy s xhat)) come
//     from warp shuffles and, across a row's warps, one step through
//     shared memory in a fixed order;
//   - dscale and dbias accumulate in dynamic shared memory, a [2, N] row
//     a slot (each column owned by one thread of the slot; bf16 chunks
//     placed so that a quarter-warp's float4s meet no bank twice), so
//     the registers hold only the row in flight and 16 warps fit on an SM
//     at GPT's N = 768;
//   - the TPU kernel carried dscale and dbias in one output block along
//     its sequential grid. Hopper's blocks run in no order, so each block
//     takes one group of consecutive rows (the groups' count a function of
//     R alone, set by the wrapper, never of the device), sums its slots'
//     rows in a fixed order and writes one row of a [2, groups, N] fp32
//     partial, which sum_partials.cu reduces over the groups in a fixed
//     order: deterministic, with no float atomics. The TPU's 256-row
//     blocks are a TPU tiling, not part of the function.
//
// Both kernels do ~10 (forward) and ~20 (backward) flops per element
// against 4-8 (6-12) bytes of traffic in bf16 (fp32): they are bounded by
// device-memory bytes, and reading each input once and writing each output
// once is the whole of that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "row_chunks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BWD_WARPS = 4;   // backward: warps a block, or WPR if more
constexpr int MAX_N = 8192;

// element `col` of an [N] vector of kind 0 (fp32) or 1 (bf16); any other
// kind is an absent vector, which reads as `absent`
__device__ __forceinline__ float vec_at(const void* p, int kind, int col,
                                        float absent) {
  if (kind == 0) return static_cast<const float*>(p)[col];
  if (kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[col]);
  return absent;
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

// scale's V columns at c0 of kind 0 (fp32), 1 (bf16) or absent (ones),
// zeros past N, in the chunk layout of load_chunk
template <int V, bool VEC>
__device__ __forceinline__ void load_scale(float (&o)[V], const void* p,
                                           int kind, int c0, int N) {
  if (kind == 0) {
    load_f32<V, VEC>(o, static_cast<const float*>(p), c0, N);
  } else if (kind == 1) {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p);
    if constexpr (V == 8) {
      load_chunk<__nv_bfloat16, 8, VEC>(o, b, c0, N);
    } else if constexpr (VEC) {  // four bf16: one 8-byte load
      static_assert(V == 4, "fp32 rows: chunks of four");
      if (c0 >= N) {
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = 0.f;
        return;
      }
      const uint2 u = *reinterpret_cast<const uint2*>(b + c0);
      o[0] = __uint_as_float(u.x << 16);
      o[1] = __uint_as_float(u.x & 0xFFFF0000u);
      o[2] = __uint_as_float(u.y << 16);
      o[3] = __uint_as_float(u.y & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = c0 + e < N ? to_f(b[c0 + e]) : 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = 1.f;
  }
}

// warps of a backward block whose rows take WPR warps each
template <int WPR>
constexpr int BwdWarps = WPR > BWD_WARPS ? WPR : BWD_WARPS;

// floats of a slot's dscale (and dbias) row: N in whole chunks
template <int V>
__host__ __device__ __forceinline__ int acc_cols(int N) {
  return (N + V - 1) / V * V;
}

// The place of column col in a slot's accumulator row. A bf16 chunk is
// two float4s, 32 bytes a lane, so the 8 lanes of a quarter-warp would
// hit each bank twice; every fourth chunk swaps its two halves, which
// spreads them over all 32 banks. fp32 chunks (one float4) stay in place.
template <int V>
__device__ __forceinline__ int acc_at(int col) {
  if constexpr (V == 8) {
    const int c = col >> 3;
    return ((2 * c + (((col >> 2) & 1) ^ ((c >> 2) & 1))) << 2) | (col & 3);
  }
  return col;
}

// One block per group of rows_per_group consecutive rows; the block's
// SLOTS rows in flight (WPR warps each) take rows s, s + SLOTS, ... of the
// group in order. Each thread holds NC chunks of V columns of its row
// (VEC: 16-byte vectors). A slot's dscale and dbias rows live in dynamic
// shared memory (SLOTS x [2, acc_cols(N)] floats), which the block sums
// over its slots in order into row blockIdx.x of the [2, gridDim.x, N]
// partial.
template <typename T, bool VEC, int NC, int WPR>
__global__ void __launch_bounds__(32 * BwdWarps<WPR>)
ln_row_bwd_kernel(const T* __restrict__ x, const void* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ part, int R, int N, int rows_per_group,
                  long long x_rs, long long dy_rs, int s_kind, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int BLOCK = 32 * BwdWarps<WPR>;
  constexpr int SLOTS = BwdWarps<WPR> / WPR;
  constexpr int STRIDE = 32 * WPR;  // chunks between a thread's chunks
  __shared__ float red[WARPS][2];
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x % STRIDE;
  const int slot = threadIdx.x / STRIDE;
  const int NA = acc_cols<V>(N);
  float* ss = acc + slot * 2 * NA;  // this slot's dscale row, then dbias
  float* sb = ss + NA;
  // a thread zeroes and updates only its own columns until the final sum;
  // it holds its columns of scale, the same for every row, in registers
  float sv[NC][V];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c0 = V * (t + STRIDE * i);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (c0 + e < N) ss[acc_at<V>(c0 + e)] = sb[acc_at<V>(c0 + e)] = 0.f;
    }
    load_scale<V, VEC>(sv[i], scale, s_kind, c0, N);
  }

  const int r0 = blockIdx.x * rows_per_group;
  const int r1 = min(r0 + rows_per_group, R);
  // with WPR > 1 a row's sums meet in shared memory behind __syncthreads,
  // so every slot runs the same steps: a row past r1 loads, adds and
  // stores nothing
  const int steps = (rows_per_group + SLOTS - 1) / SLOTS;
  for (int k = 0; k < steps; ++k) {
    const int row = r0 + slot + SLOTS * k;
    const bool valid = row < r1;
    if constexpr (WPR == 1) {
      if (!valid) break;  // the whole warp leaves together
    }
    const int n_in = valid ? N : 0;  // columns this row loads
    const T* xr = x + (long long)(valid ? row : 0) * x_rs;
    const T* dyr = dy + (long long)(valid ? row : 0) * dy_rs;
    float v[NC][V], g[NC][V];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c0 = V * (t + STRIDE * i);
      load_chunk<T, V, VEC>(v[i], xr, c0, n_in);
      load_chunk<T, V, VEC>(g[i], dyr, c0, n_in);
    }
    float sum = 0.f, sq = 0.f;  // zeros past N add nothing
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum += v[i][e];
        sq = fmaf(v[i][e], v[i][e], sq);
      }
    row_sum2<WPR>(sum, sq, red);
    const float mean = sum / N;
    const float rstd = rsqrtf(fmaxf(sq / N - mean * mean, 0.f) + eps);

    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c0 = V * (t + STRIDE * i);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // v now holds xhat, 0 past N and on a row past r1
        v[i][e] = c0 + e < n_in ? (v[i][e] - mean) * rstd : 0.f;
        if constexpr (!VEC) {
          if (c0 + e < n_in) {
            const int at = acc_at<V>(c0 + e);
            ss[at] = fmaf(g[i][e], v[i][e], ss[at]);
            sb[at] += g[i][e];
          }
        }
      }
      if constexpr (VEC) {
        if (c0 < n_in) {
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            const int at = acc_at<V>(c0 + j);
            float4 a = *reinterpret_cast<float4*>(ss + at);
            float4 c = *reinterpret_cast<float4*>(sb + at);
            a.x = fmaf(g[i][j], v[i][j], a.x);
            a.y = fmaf(g[i][j + 1], v[i][j + 1], a.y);
            a.z = fmaf(g[i][j + 2], v[i][j + 2], a.z);
            a.w = fmaf(g[i][j + 3], v[i][j + 3], a.w);
            c.x += g[i][j];
            c.y += g[i][j + 1];
            c.z += g[i][j + 2];
            c.w += g[i][j + 3];
            *reinterpret_cast<float4*>(ss + at) = a;
            *reinterpret_cast<float4*>(sb + at) = c;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        g[i][e] *= sv[i][e];  // g now holds dy * s
        m1 += g[i][e];
        m2 = fmaf(g[i][e], v[i][e], m2);
      }
    }
    row_sum2<WPR>(m1, m2, red);
    m1 /= N;
    m2 /= N;
    if (valid) {
      T* dxr = dx + (long long)row * N;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c0 = V * (t + STRIDE * i);
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          o[e] = rstd * (g[i][e] - m1 - v[i][e] * m2);
        store_chunk<T, V, VEC>(dxr, o, c0, N);
      }
    }
  }

  // the group's column sums of dscale and dbias, over its slots in order
  __syncthreads();
  float* prow_s = part + (long long)blockIdx.x * N;
  float* prow_b = part + ((long long)gridDim.x + blockIdx.x) * N;
  for (int col = threadIdx.x; col < N; col += BLOCK) {
    const int at = acc_at<V>(col);
    float s = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < SLOTS; ++w) {
      s += acc[w * 2 * NA + at];
      b += acc[w * 2 * NA + NA + at];
    }
    prow_s[col] = s;
    prow_b[col] = b;
  }
}

struct Args {
  const void *x, *scale, *bias, *dy;
  void *y, *dx;
  float *mean, *var, *part;
  int R, N, rows_per_group;
  long long x_rs, dy_rs;
  int s_kind, b_kind;
  float eps;
};

template <typename T, int NPL, int WPR>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  constexpr int ROWS = WARPS / WPR;
  const int blocks = (a.R + ROWS - 1) / ROWS;
  ln_row_fwd_kernel<T, NPL, WPR><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a.x), a.scale, a.bias, static_cast<T*>(a.y),
      a.mean, a.var, a.R, a.N, a.x_rs, a.s_kind, a.b_kind, a.eps);
  return cudaGetLastError();
}

// the least warps per row, then the least values per thread, that hold N
template <typename T, int WPR>
cudaError_t pick_npl(const Args& a, cudaStream_t stream) {
  const int per = (a.N + 32 * WPR - 1) / (32 * WPR);  // values per thread
  if constexpr (WPR == 1) {  // more warps per row start above 16 values
    if (per <= 4) return launch_fwd<T, 4, WPR>(a, stream);
    if (per <= 8) return launch_fwd<T, 8, WPR>(a, stream);
    if (per <= 16) return launch_fwd<T, 16, WPR>(a, stream);
  }
  if (per <= 24) return launch_fwd<T, 24, WPR>(a, stream);
  if (per <= 32) return launch_fwd<T, 32, WPR>(a, stream);
  return cudaErrorInvalidValue;
}

// f(integral_constant WPR), the warps of a row for N: the fewest that
// hold it at 32 values a thread (1 up to N = 1024)
template <typename F>
cudaError_t with_wpr(int N, F f) {
  if (N <= 1024) return f(std::integral_constant<int, 1>{});
  if (N <= 2048) return f(std::integral_constant<int, 2>{});
  if (N <= 4096) return f(std::integral_constant<int, 4>{});
  if (N <= MAX_N) return f(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

template <typename T, bool VEC_, int NC_, int WPR_>
struct BwdShape {
  static constexpr bool VEC = VEC_;
  static constexpr int NC = NC_, WPR = WPR_;
  static constexpr int BLOCK = 32 * BwdWarps<WPR_>;
  static size_t smem(int N) {
    return sizeof(float) * (BwdWarps<WPR_> / WPR_) * 2 *
           (size_t)acc_cols<16 / sizeof(T)>(N);
  }
};

// f(BwdShape) of the backward kernel for N and a copy path: WPR from N,
// then the fewest chunks that hold a warp's share of the row
template <typename T, typename F>
cudaError_t with_bwd_shape(int N, bool vec, F f) {
  return with_wpr(N, [&](auto wpr) {
    constexpr int WPR = decltype(wpr)::value;
    const int cols = (N + WPR - 1) / WPR;  // a warp's columns
    return vec ? with_chunks<T>(cols, [&](auto nc) {
      return f(BwdShape<T, true, decltype(nc)::value, WPR>{});
    }) : with_chunks<T>(cols, [&](auto nc) {
      return f(BwdShape<T, false, decltype(nc)::value, WPR>{});
    });
  });
}

// dynamic shared memory past the 48 KB default (N > 6144) needs the
// kernel's attribute raised first
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The backward's copy path: 16-byte vectors where N is a whole number of
// chunks and every row of x, dy and dx, and scale, is 16-byte aligned;
// else the same chunks element by element
template <typename T>
bool bwd_vec(const Args& a) {
  constexpr int V = 16 / sizeof(T);
  const size_t es = sizeof(T);
  return a.N % V == 0 && aligned16(a.x, a.x_rs, es) &&
         aligned16(a.dy, a.dy_rs, es) && aligned16(a.dx, a.N, es) &&
         (a.s_kind < 0 || aligned16(a.scale, 0, 1));
}

template <typename T>
cudaError_t dispatch_bwd(const Args& a, cudaStream_t stream) {
  return with_bwd_shape<T>(a.N, bwd_vec<T>(a), [&](auto shape) {
    using S = decltype(shape);
    auto kernel = ln_row_bwd_kernel<T, S::VEC, S::NC, S::WPR>;
    const size_t smem = S::smem(a.N);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int blocks = (a.R + a.rows_per_group - 1) / a.rows_per_group;
    kernel<<<blocks, S::BLOCK, smem, stream>>>(
        static_cast<const T*>(a.x), a.scale, static_cast<const T*>(a.dy),
        static_cast<T*>(a.dx), a.part, a.R, a.N, a.rows_per_group, a.x_rs,
        a.dy_rs, a.s_kind, a.eps);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dispatch_fwd(const Args& a, cudaStream_t stream) {
  return with_wpr(a.N, [&](auto wpr) {
    return pick_npl<T, decltype(wpr)::value>(a, stream);
  });
}

// blocks of the backward kernel on one SM, and its shared memory
template <typename T>
cudaError_t bwd_occupancy(int N, bool vec, int* blocks, int* smem_bytes) {
  return with_bwd_shape<T>(N, vec, [&](auto shape) {
    using S = decltype(shape);
    auto kernel = ln_row_bwd_kernel<T, S::VEC, S::NC, S::WPR>;
    const size_t smem = S::smem(N);
    *smem_bytes = (int)smem;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         S::BLOCK, smem);
  });
}

int dispatch(bool backward, int dtype, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.R <= 0 || a.N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)(backward ? dispatch_bwd<float>(a, st)
                          : dispatch_fwd<float>(a, st));
  if (dtype == 1)
    return (int)(backward ? dispatch_bwd<__nv_bfloat16>(a, st)
                          : dispatch_fwd<__nv_bfloat16>(a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, y, dx). s_kind, b_kind: 0 =
// fp32 [N], 1 = bf16 [N], -1 = absent (ones, zeros). x and dy have
// contiguous rows of the given strides (in elements); y and dx are
// contiguous [R, N]; mean and var fp32 [R]. N <= 8192. The backward takes
// the rows in groups of rows_per_group (the last one ragged) and writes
// part, fp32 [2, groups, N] with groups = ceil(R / rows_per_group)
// (dscale partials, then dbias). Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, float* mean,
                              float* var, int R, int N, long long x_rs,
                              int s_kind, int b_kind, float eps, int dtype,
                              void* stream) {
  Args a{x, scale, bias, nullptr, y, nullptr, mean, var, nullptr, R, N, 0,
         x_rs, 0, s_kind, b_kind, eps};
  return dispatch(false, dtype, a, stream);
}

extern "C" int layer_norm_bwd(const void* x, const void* scale,
                              const void* dy, void* dx, float* part, int R,
                              int N, int rows_per_group, long long x_rs,
                              long long dy_rs, int s_kind, float eps,
                              int dtype, void* stream) {
  if (rows_per_group < 1) return (int)cudaErrorInvalidValue;
  Args a{x, scale, nullptr, dy, nullptr, dx, nullptr, nullptr, part, R, N,
         rows_per_group, x_rs, dy_rs, s_kind, -1, eps};
  return dispatch(true, dtype, a, stream);
}

// The blocks of the backward kernel that fit on one SM of the current
// device for a dtype code (0 = float32, 1 = bfloat16), N and copy path
// (vec = 1: 16-byte vectors), and the dynamic shared memory each block
// takes: a report of the build, which no launch reads.
extern "C" int layer_norm_bwd_occupancy(int dtype, int N, int vec,
                                        int* blocks, int* smem_bytes) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_occupancy<float>(N, vec != 0, blocks, smem_bytes);
  if (dtype == 1)
    return (int)bwd_occupancy<__nv_bfloat16>(N, vec != 0, blocks,
                                             smem_bytes);
  return (int)cudaErrorInvalidValue;
}
