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
// Backward design. The same function over rows (z, mean and rstd
// recomputed, the mask regenerated from the same coordinates, so no mask,
// z or statistic reaches device memory), laid out for the H100's memory
// system:
//   - one warp a row, 4 warps a block; lane L holds the row in chunks of
//     V = 16 / sizeof(T) consecutive columns (fp32 4, bf16 8), columns
//     V (L + 32 i) .. + V - 1, so x, y and dO are read as 16-byte vectors,
//     all three issued together before the row's first reduction, and dx
//     and dy are stored as 16-byte vectors. Where a row is not 16-byte
//     aligned (a pointer, a row stride, or N % V != 0) the same kernel
//     loads and stores the same chunks element by element (the C entry
//     decides, as the attention entries choose their copy path): one
//     layout, one arithmetic, the same bits;
//   - the keep bits of a chunk are one Philox block's byte (eight columns
//     a block): lane L draws blocks L, L + 32, ... of the row and hands
//     each chunk its bits with a shuffle;
//   - the row's two pairs of sums ((z, z^2), then (dO g, dO g zhat)) are
//     reduced together with warp shuffles;
//   - dg = sum_rows dO * zhat and dc = sum_rows dO accumulate in shared
//     memory, a [2, N] row per warp (dynamic, 8 N floats a block), so the
//     registers hold only the row in flight and many warps fit on an SM;
//   - the TPU kernel carried dg and dc in one output block along its
//     sequential grid. Hopper's blocks run in no order, so each block
//     takes one group of consecutive rows (the groups' count a function of
//     R alone, set by the wrapper, never of the device), sums its warps'
//     rows in a fixed order and writes one row of a [2, groups, N] fp32
//     partial, which sum_partials.cu reduces over the groups in a fixed
//     order: deterministic, with no float atomics.
//
// Both kernels do ~10-30 flops per 12-20 bytes of fp32 traffic: they are
// bounded by device-memory bytes, and reading each input once and
// writing each output once is the whole of that bound (at R=16384,
// N=768 fp32 the backward moves 252 MB, 0.0751 ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;  // forward: one row per warp
constexpr int BWD_WARPS = 4;                  // backward: warps per block
constexpr int BWD_THREADS = 32 * BWD_WARPS;

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

// The keep bits of this lane's NC chunks of V columns (chunk i at column
// c0 = V (lane + 32 i)) of row `row`: bit e of keep[i] keeps column
// c0 + e. A chunk lies in one Philox block of eight columns, c0 >> 3;
// lane L draws blocks L, L + 32, ... and the lane holding a chunk reads
// its block's byte with a shuffle (block c0 >> 3 is in slot (V i) >> 3
// of every lane alike). The whole warp must call this together.
template <int V, int NC>
__device__ __forceinline__ void chunk_keep(uint32_t (&keep)[NC],
                                           const Dropout& dr, int row,
                                           int lane, int N) {
  if (!dr.use_mask) {  // uniform across the grid: no draws, no shuffles
#pragma unroll
    for (int i = 0; i < NC; ++i) keep[i] = 0xFFu;
    return;
  }
  constexpr int SLOTS = (V * NC + 7) / 8;  // blocks a lane draws
  const int blocks = (N + 7) >> 3;
  uint32_t kb[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int blk = lane + 32 * s;
    kb[s] = blk < blocks
                ? philox::keep_byte((uint32_t)blk, (uint32_t)row, 0u, 0u,
                                    dr.seed0, dr.seed1, dr.threshold)
                : 0u;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c0 = V * (lane + 32 * i);
    const uint32_t byte =
        __shfl_sync(0xffffffffu, kb[(V * i) >> 3], (c0 >> 3) & 31);
    keep[i] = byte >> (c0 & 7);
  }
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
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

// One block per group of rows_per_group consecutive rows; warp w takes
// rows w, w + BWD_WARPS, ... of the group in order. Each lane holds NC
// chunks of V columns of the row in flight (VEC: 16-byte vectors). The
// warp's dg and dc rows live in dynamic shared memory (BWD_WARPS x
// [2, N] floats), which the block sums over its warps in order into row
// blockIdx.x of the [2, gridDim.x, N] partial.
template <typename T, bool VEC, int NC>
__global__ void __launch_bounds__(BWD_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
              const float* __restrict__ g, const T* __restrict__ dout,
              T* __restrict__ dx, T* __restrict__ dy, float* __restrict__ part,
              int R, int N, int rows_per_group, long long x_rs,
              long long y_rs, long long do_rs, long long dx_rs,
              long long dy_rs, float y_scale, float eps, Dropout dr) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* sg = acc + warp * 2 * N;  // this warp's dg row, then its dc row
  float* sc = sg + N;
  for (int col = lane; col < 2 * N; col += 32) sg[col] = 0.f;
  __syncwarp();

  const int r0 = blockIdx.x * rows_per_group;
  const int r1 = min(r0 + rows_per_group, R);
  for (int row = r0 + warp; row < r1; row += BWD_WARPS) {
    uint32_t keep[NC];
    chunk_keep<V, NC>(keep, dr, row, lane, N);
    const T* xr = x + (long long)row * x_rs;
    const T* yr = y + (long long)row * y_rs;
    const T* dor = dout + (long long)row * do_rs;
    float z[NC][V], d[NC][V];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c0 = V * (lane + 32 * i);
      float yv[V];
      load_chunk<T, V, VEC>(z[i], xr, c0, N);
      load_chunk<T, V, VEC>(yv, yr, c0, N);
      load_chunk<T, V, VEC>(d[i], dor, c0, N);
#pragma unroll
      for (int e = 0; e < V; ++e)  // y is loaded whatever its keep bit
        z[i][e] += ((keep[i] >> e) & 1u) ? yv[e] * y_scale : 0.f;
    }
    float sum = 0.f, sq = 0.f;  // zeros past N add nothing
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum += z[i][e];
        sq = fmaf(z[i][e], z[i][e], sq);
      }
    warp_sum2(sum, sq);
    const float mean = sum / N;
    const float rstd = rsqrtf(fmaxf(sq / N - mean * mean, 0.f) + eps);

    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c0 = V * (lane + 32 * i);
      float gv[V];
      load_f32<V, VEC>(gv, g, c0, N);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // z now holds zhat, d dO g; both 0 past N
        z[i][e] = c0 + e < N ? (z[i][e] - mean) * rstd : 0.f;
        if constexpr (!VEC) {
          if (c0 + e < N) {
            sg[c0 + e] = fmaf(d[i][e], z[i][e], sg[c0 + e]);
            sc[c0 + e] += d[i][e];
          }
        }
      }
      if constexpr (VEC) {
        if (c0 < N) {
#pragma unroll
          for (int j = 0; j < V; j += 4) {
            float4 a = *reinterpret_cast<float4*>(sg + c0 + j);
            float4 c = *reinterpret_cast<float4*>(sc + c0 + j);
            a.x = fmaf(d[i][j], z[i][j], a.x);
            a.y = fmaf(d[i][j + 1], z[i][j + 1], a.y);
            a.z = fmaf(d[i][j + 2], z[i][j + 2], a.z);
            a.w = fmaf(d[i][j + 3], z[i][j + 3], a.w);
            c.x += d[i][j];
            c.y += d[i][j + 1];
            c.z += d[i][j + 2];
            c.w += d[i][j + 3];
            *reinterpret_cast<float4*>(sg + c0 + j) = a;
            *reinterpret_cast<float4*>(sc + c0 + j) = c;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        d[i][e] *= gv[e];
        m1 += d[i][e];
        m2 = fmaf(d[i][e], z[i][e], m2);
      }
    }
    warp_sum2(m1, m2);
    m1 /= N;
    m2 /= N;

    T* dxr = dx + (long long)row * dx_rs;
    T* dyr = dy + (long long)row * dy_rs;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c0 = V * (lane + 32 * i);
      float dz[V], dyv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        dz[e] = rstd * (d[i][e] - m1 - z[i][e] * m2);
        dyv[e] = ((keep[i] >> e) & 1u) ? dz[e] * y_scale : 0.f;
      }
      store_chunk<T, V, VEC>(dxr, dz, c0, N);
      store_chunk<T, V, VEC>(dyr, dyv, c0, N);
    }
  }

  // the group's column sums of dg and dc, over its warps in order
  __syncthreads();
  float* prow_g = part + (long long)blockIdx.x * N;
  float* prow_c = part + ((long long)gridDim.x + blockIdx.x) * N;
  for (int col = threadIdx.x; col < N; col += BWD_THREADS) {
    float sgv = 0.f, scv = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) {
      sgv += acc[w * 2 * N + col];
      scv += acc[w * 2 * N + N + col];
    }
    prow_g[col] = sgv;
    prow_c[col] = scv;
  }
}

struct Args {
  const void *x, *y, *dout;
  const float *g, *c;
  void *out, *dx, *dy;
  float* part;
  int R, N, rows_per_group;
  long long x_rs, y_rs, do_rs, o_rs, dx_rs, dy_rs;
  float y_scale, eps;
  Dropout dr;
};

template <typename T, int NPL>
cudaError_t launch_fwd(const Args& a, cudaStream_t stream) {
  const int blocks = (a.R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ln_fwd_kernel<T, NPL><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), a.g, a.c,
      static_cast<T*>(a.out), a.R, a.N, a.x_rs, a.y_rs, a.o_rs, a.y_scale,
      a.eps, a.dr);
  return cudaGetLastError();
}

size_t bwd_smem(int N) { return sizeof(float) * BWD_WARPS * 2 * (size_t)N; }

template <typename T, bool VEC, int NC>
cudaError_t launch_bwd(const Args& a, cudaStream_t stream) {
  const int blocks = (a.R + a.rows_per_group - 1) / a.rows_per_group;
  ln_bwd_kernel<T, VEC, NC><<<blocks, BWD_THREADS, bwd_smem(a.N), stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), a.g,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dx),
      static_cast<T*>(a.dy), a.part, a.R, a.N, a.rows_per_group, a.x_rs,
      a.y_rs, a.do_rs, a.dx_rs, a.dy_rs, a.y_scale, a.eps, a.dr);
  return cudaGetLastError();
}

// f(integral_constant NC) for the fewest chunks of V = 16 / sizeof(T)
// columns that hold N columns in 32 lanes (8, 16, 24 or 32 columns a lane)
template <typename T, typename F>
cudaError_t with_chunks(int N, F f) {
  constexpr int V = 16 / sizeof(T);
  if (N <= 32 * 8) return f(std::integral_constant<int, 8 / V>{});
  if (N <= 32 * 16) return f(std::integral_constant<int, 16 / V>{});
  if (N <= 32 * 24) return f(std::integral_constant<int, 24 / V>{});
  if (N <= 32 * 32) return f(std::integral_constant<int, 32 / V>{});
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_fwd(const Args& a, cudaStream_t stream) {
  // the smallest register row that holds N columns
  if (a.N <= 32 * 4) return launch_fwd<T, 4>(a, stream);
  if (a.N <= 32 * 8) return launch_fwd<T, 8>(a, stream);
  if (a.N <= 32 * 16) return launch_fwd<T, 16>(a, stream);
  if (a.N <= 32 * 24) return launch_fwd<T, 24>(a, stream);
  if (a.N <= 32 * 32) return launch_fwd<T, 32>(a, stream);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, long long row_stride, size_t es) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (row_stride * (long long)es) % 16 == 0;
}

// The backward's copy path: 16-byte vectors where N is a whole number of
// chunks and every row of x, y, dout, dx and dy, and g, is 16-byte
// aligned; else the same chunks element by element
template <typename T>
cudaError_t dispatch_bwd(const Args& a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const size_t es = sizeof(T);
  const bool vec = a.N % V == 0 && aligned16(a.x, a.x_rs, es) &&
                   aligned16(a.y, a.y_rs, es) &&
                   aligned16(a.dout, a.do_rs, es) &&
                   aligned16(a.dx, a.dx_rs, es) &&
                   aligned16(a.dy, a.dy_rs, es) && aligned16(a.g, 0, 4);
  return vec ? with_chunks<T>(a.N, [&](auto nc) {
    return launch_bwd<T, true, decltype(nc)::value>(a, stream);
  }) : with_chunks<T>(a.N, [&](auto nc) {
    return launch_bwd<T, false, decltype(nc)::value>(a, stream);
  });
}

// blocks of the backward kernel on one SM, and its shared memory
template <typename T>
cudaError_t bwd_occupancy(int N, bool vec, int* blocks, int* smem_bytes) {
  const size_t smem = bwd_smem(N);
  *smem_bytes = (int)smem;
  auto query = [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         BWD_THREADS, smem);
  };
  return vec ? with_chunks<T>(N, [&](auto nc) {
    return query(ln_bwd_kernel<T, true, decltype(nc)::value>);
  }) : with_chunks<T>(N, [&](auto nc) {
    return query(ln_bwd_kernel<T, false, decltype(nc)::value>);
  });
}

int dispatch(bool backward, int dtype, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(backward ? dispatch_bwd<float>(a, st)
                          : dispatch_fwd<float>(a, st));
  if (dtype == 1)
    return (int)(backward ? dispatch_bwd<__nv_bfloat16>(a, st)
                          : dispatch_fwd<__nv_bfloat16>(a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, dout, out, dx, dy); g and c are
// fp32 [N]. Row strides are in elements; each row is contiguous;
// N <= 1024. The backward takes the rows in groups of rows_per_group
// (the last one ragged) and writes part, fp32 [2, groups, N] with
// groups = ceil(R / rows_per_group) (dg partials, then dc). Each returns
// the cudaError_t of its launch (0 on success).
extern "C" int fused_dropout_add_ln_fwd(
    const void* x, const void* y, const float* g, const float* c, void* out,
    int R, int N, long long x_rs, long long y_rs, long long o_rs,
    float y_scale, float eps, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  Args a{x, y, nullptr, g, c, out, nullptr, nullptr, nullptr, R, N, 0,
         x_rs, y_rs, 0, o_rs, 0, 0, y_scale, eps,
         Dropout{use_mask, seed0, seed1, threshold}};
  return dispatch(false, dtype, a, stream);
}

extern "C" int fused_dropout_add_ln_bwd(
    const void* x, const void* y, const float* g, const void* dout, void* dx,
    void* dy, float* part, int R, int N, int rows_per_group, long long x_rs,
    long long y_rs, long long do_rs, long long dx_rs, long long dy_rs,
    float y_scale, float eps, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  if (rows_per_group < 1) return (int)cudaErrorInvalidValue;
  Args a{x, y, dout, g, nullptr, nullptr, dx, dy, part, R, N,
         rows_per_group, x_rs, y_rs, do_rs, 0, dx_rs, dy_rs, y_scale, eps,
         Dropout{use_mask, seed0, seed1, threshold}};
  return dispatch(true, dtype, a, stream);
}

// The blocks of the backward kernel that fit on one SM of the current
// device for a dtype code (0 = float32, 1 = bfloat16), N and copy path
// (vec = 1: 16-byte vectors), and the dynamic shared memory each block
// takes: a report of the build, which no launch reads.
extern "C" int fused_dropout_add_ln_bwd_occupancy(int dtype, int N, int vec,
                                                  int* blocks,
                                                  int* smem_bytes) {
  if (dtype == 0)
    return (int)bwd_occupancy<float>(N, vec != 0, blocks, smem_bytes);
  if (dtype == 1)
    return (int)bwd_occupancy<__nv_bfloat16>(N, vec != 0, blocks,
                                             smem_bytes);
  return (int)cudaErrorInvalidValue;
}
