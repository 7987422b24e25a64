// Device code shared by the attention kernels of flash_attention.cu (the
// whole-row kernels: #1/#5 forward, #3/#6 backward), flash_tiled.cu (#7
// forward, #8 dkv, #9 dq) and ring_block.cu (#12-#14): the helpers (the
// keep mask, scores, row reductions, launch dispatch) and the CUDA-core
// forward body (#1, #5, #7). The backward bodies on the tensor cores are
// attn_mma.cuh's. The forward body takes each head's rows through base
// pointers and a row stride, so one body serves the packed projection
// qkv[B, S, 3*H*D] (section i in {q, k, v}, head h at column i*H*D + h*D)
// and the 4-D [B, H, S, D] layout alike.
//
// Per batch b and head h:
//
//   s    = q k^T * scale + bias[b]     (bias: additive fp32 key bias [B, S];
//                                       causal entries j > i at -1e30)
//   p    = softmax(s)                  (fp32 statistics)
//   out  = drop_scale * (keep . p) v   (keep: the Philox mask of
//                                       philox.cuh, or all ones)
//
// The forward body runs one block of THREADS threads over one tile of BM
// query rows. Four threads own one row: each scores BN/4 keys of a tile
// and accumulates D/4 output columns; the row's max and sum are combined
// with two warp shuffles. Key tiles stream through shared memory as fp32;
// all arithmetic is fp32 on the CUDA cores. Tiles wholly above the causal
// diagonal are never visited.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <mutex>

#include "philox.cuh"

namespace attn {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per shared-memory tile
constexpr int TPR = 4;          // threads per (query or key) row
constexpr int THREADS = BM * TPR;
constexpr int GROUPS = BN / 8;  // Philox blocks per tile row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Dropout {
  int use_mask;        // training dropout: apply the Philox keep mask
  uint32_t seed0, seed1, threshold;
  float scale;         // multiplier of a kept probability
};

inline Dropout make_dropout(int use_mask, unsigned seed0, unsigned seed1,
                            unsigned threshold, float drop_scale) {
  Dropout dr;
  dr.use_mask = use_mask;
  dr.seed0 = seed0;
  dr.seed1 = seed1;
  dr.threshold = threshold;
  dr.scale = drop_scale;
  return dr;
}

template <int D>
struct Layout {
  // row strides in floats: +4 keeps rows 16-byte aligned for float4 and
  // staggers consecutive rows by four banks (conflict-free float4 reads)
  static constexpr int LD = D + 4;
  static constexpr int PLD = BN + 4;
  static constexpr size_t mask_bytes = BM * GROUPS;
  static constexpr size_t fwd =
      sizeof(float) * (size_t)(BM * LD + 2 * BN * LD + BM * PLD) + mask_bytes;
};

// Load rows [r0, r0 + ROWS) of one head's D columns into shared memory as
// fp32 (zeros past the sequence end).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int S, int tid) {
  constexpr int LD = Layout<D>::LD;
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int rr = i / D, c = i % D, s = r0 + rr;
    dst[rr * LD + c] = s < S ? to_f(src[(long long)s * row_stride + c]) : 0.f;
  }
}

// Keep bytes of the (NR query rows q0.., 8 NG keys k0..) tile, drawn by
// NT threads: byte rr * NG + g holds the keep bits of keys k0 + 8g ..
// k0 + 8g + 7 for query q0 + rr.
template <int NR = BM, int NG = GROUPS, int NT = THREADS>
__device__ __forceinline__ void fill_mask(unsigned char* sM, const Dropout& dr,
                                          int q0, int k0, int h, int b,
                                          int tid) {
  if (!dr.use_mask) return;
  for (int i = tid; i < NR * NG; i += NT) {
    const int rr = i / NG, g = i % NG;
    sM[i] = (unsigned char)philox::keep_byte(
        (uint32_t)((k0 >> 3) + g), (uint32_t)(q0 + rr), (uint32_t)h,
        (uint32_t)b, dr.seed0, dr.seed1, dr.threshold);
  }
}

__device__ __forceinline__ bool kept(const unsigned char* sM, int use_mask,
                                     int rr, int jl) {
  return !use_mask || ((sM[rr * GROUPS + (jl >> 3)] >> (jl & 7)) & 1);
}

// dot products of one shared-memory row `a` with JPT rows of `bmat`
// (rows t, t + TPR, ...), accumulated in ascending d with fmaf
template <int D, int JPT>
__device__ __forceinline__ void row_dots(float (&acc)[JPT], const float* a,
                                         const float* bmat, int t) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) acc[jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const float4 bv =
          *reinterpret_cast<const float4*>(bmat + (t + TPR * jj) * LD + d);
      float x = acc[jj];
      x = fmaf(av.x, bv.x, x);
      x = fmaf(av.y, bv.y, x);
      x = fmaf(av.z, bv.z, x);
      x = fmaf(av.w, bv.w, x);
      acc[jj] = x;
    }
  }
}

// acc[D/4 columns of this thread] += sum_j w[j] * mat[j, :] over BN rows
template <int D>
__device__ __forceinline__ void accumulate_rows(float* acc, const float* w,
                                                const float* mat, int t) {
  constexpr int LD = Layout<D>::LD;
  constexpr int CHUNKS = D / (4 * TPR);
#pragma unroll 2
  for (int j = 0; j < BN; j += 4) {
    const float4 wv = *reinterpret_cast<const float4*>(w + j);
    const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* mrow = mat + (j + u) * LD;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const float4 mv =
            *reinterpret_cast<const float4*>(mrow + (k * TPR + t) * 4);
        acc[4 * k + 0] = fmaf(wj[u], mv.x, acc[4 * k + 0]);
        acc[4 * k + 1] = fmaf(wj[u], mv.y, acc[4 * k + 1]);
        acc[4 * k + 2] = fmaf(wj[u], mv.z, acc[4 * k + 2]);
        acc[4 * k + 3] = fmaf(wj[u], mv.w, acc[4 * k + 3]);
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_cols(T* row, const float* acc,
                                           float mul, int t) {
  constexpr int CHUNKS = D / (4 * TPR);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      row[(k * TPR + t) * 4 + u] = from_f<T>(acc[4 * k + u] * mul);
    }
  }
}

// the score of query `row` and key `j` from its dot product
__device__ __forceinline__ float score(float dot, float scale,
                                       const float* brow, int row, int j,
                                       int S, int causal) {
  if (j >= S) return -INFINITY;  // past the sequence end: no weight at all
  const float s = dot * scale + (brow ? brow[j] : 0.f);
  return (causal && j > row) ? NEG_INF : s;
}

// number of key tiles a block of query rows [q0, q0 + BM) needs: tiles
// wholly above the diagonal for every row add exp(NEG_INF - m) == 0
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  int n = (S + BN - 1) / BN;
  if (causal) n = min(n, (min(q0 + BM, S) - 1) / BN + 1);
  return n;
}

__device__ __forceinline__ float row_max4(float v) {
  // the TPR threads of a row are consecutive lanes of one warp
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pointers, shapes and strides of one launch of the tiled kernels
// (strides in elements; every last dim is contiguous). q, k and v are
// [B, H, S, D] views sharing their (batch, head, row) strides in_*; out
// (the forward's output, or dq), dk and dv share out_*. The packed
// projection qkv[B, S, 3*H*D] is the view with k = q + H*D,
// v = q + 2*H*D, in_sh = D, in_ss = 3*H*D. The forward body takes the
// pointers again as __restrict__ parameters: the tensors never overlap.
// The backward bodies (attn_mma.cuh) read the fields by name.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // may be null: every key kept
  const void* dout;
  const void* fwd_out; // the forward's saved output (#9's delta)
  void* out;           // forward: out; backward: dq
  void* dk;
  void* dv;
  float* lse;          // fp32 [B, H, S]
  float* delta;        // fp32 [B, H, S]
  float* dbias_part;   // fp32 [B, H, S], may be null
  int B, S, H;
  long long in_sb, in_sh, in_ss, do_sb, do_sh, do_ss, out_sb, out_sh,
      out_ss, fo_sb, fo_sh, fo_ss;
  float scale;
  int causal;
  Dropout dr;
  int async_copy;  // backward: every row it copies is 16-byte aligned
};

// ---------------------------------------------------------------------------
// forward: one block per (query tile, head, batch); the keys stream through
// shared memory in tiles of BN with an online softmax. The caller resolves
// the layout: qb, kb and vb point at row 0 of this block's (b, h) head in q,
// k and v (rows in_ss elements apart), ob at row 0 of its output head (rows
// out_ss apart), brow at the key bias of batch b (or null). With lse_row
// (this head's [S] row of an fp32 [B, H, S]), the row logsumexp of the
// softmax before dropout, m + log(l), is written too.
// ---------------------------------------------------------------------------

template <typename T, int D, typename A>
__device__ __forceinline__ void fwd_block(float* smem,
                                          const T* __restrict__ qb,
                                          const T* __restrict__ kb,
                                          const T* __restrict__ vb,
                                          long long in_ss,
                                          const float* __restrict__ brow,
                                          T* __restrict__ ob, long long out_ss,
                                          float* __restrict__ lse_row,
                                          const A& a) {
  static_assert(D % (4 * TPR) == 0, "head dim must split into float4 chunks");
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int JPT = BN / TPR;          // scores per thread per key tile
  constexpr int CHUNKS = D / (4 * TPR);  // float4 output chunks per thread

  float* sQ = smem;
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  unsigned char* sM = reinterpret_cast<unsigned char*>(sP + BM * PLD);

  const int S = a.S;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;  // query row within the tile
  const int t = tid % TPR;  // this thread's share of the row
  const int row = q0 + r;
  const Dropout& dr = a.dr;

  load_rows<T, D, BM>(sQ, qb, in_ss, q0, S, tid);

  float acc[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const int n_tiles = key_tiles(q0, S, a.causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every read of the previous tile is done
    load_rows<T, D, BN>(sK, kb, in_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, vb, in_ss, k0, S, tid);
    fill_mask(sM, dr, q0, k0, h, b, tid);
    __syncthreads();

    float sc[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      sc[jj] = score(sc[jj], a.scale, brow, row, k0 + t + TPR * jj, S,
                     a.causal);
      tile_max = fmaxf(tile_max, sc[jj]);
    }
    // key k0 < S is in every tile, so tile_max and m_new are finite
    const float m_new = fmaxf(m, row_max4(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      const float p = expf(sc[jj] - m_new);
      psum += p;  // the row sum counts every probability, dropped or not
      sP[r * PLD + jl] = kept(sM, dr.use_mask, r, jl) ? p : 0.f;
    }
    l = l * alpha + row_sum4(psum);
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's P values, written by its own warp
    accumulate_rows<D>(acc, sP + r * PLD, sV, t);
  }

  if (row < S) {
    store_cols<T, D>(ob + (long long)row * out_ss, acc, dr.scale / l, t);
    if (lse_row && t == 0) lse_row[row] = m + logf(l);
  }
}

// The tiled forward's (#7) caller of the body, on the [B, H, S, D] views
// of Args: head h of batch b at b*sb + h*sh.
template <typename T, int D>
__device__ __forceinline__ void view_fwd(float* smem, const Args& a,
                                         float* lse) {
  const int h = blockIdx.y, b = blockIdx.z;
  const long long in = (long long)b * a.in_sb + (long long)h * a.in_sh;
  T* ob = static_cast<T*>(a.out) + (long long)b * a.out_sb +
          (long long)h * a.out_sh;
  fwd_block<T, D>(smem, static_cast<const T*>(a.q) + in,
                  static_cast<const T*>(a.k) + in,
                  static_cast<const T*>(a.v) + in, a.in_ss,
                  a.bias ? a.bias + (long long)b * a.S : nullptr, ob,
                  a.out_ss,
                  lse ? lse + ((long long)b * a.H + h) * a.S : nullptr, a);
}

// Above 48 KB a block's shared memory must be opted into, per kernel and
// device. K names the kernel (K::fn()) and its bytes (K::smem); done once
// for each (K, device), not on every launch.
template <typename K>
cudaError_t opt_in_smem() {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    result[dev] = cudaFuncSetAttribute(
        K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::smem);
  });
  return result[dev];
}

// Launch K<T, D> (K::launch(grid, stream, args)) for the dtype code (0 =
// float32, 1 = bfloat16) and head dim of one call.
template <template <typename, int> class K, typename A>
int dispatch(int dtype, int D, const A& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  auto run = [&](auto launch, cudaError_t opt) -> int {
    if (opt != cudaSuccess) return (int)opt;
    launch(grid, st, a);
    return (int)cudaGetLastError();
  };
  if (dtype == 0) {
    switch (D) {
      case 32: return run(K<float, 32>::launch, opt_in_smem<K<float, 32>>());
      case 64: return run(K<float, 64>::launch, opt_in_smem<K<float, 64>>());
      case 128: return run(K<float, 128>::launch, opt_in_smem<K<float, 128>>());
    }
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    switch (D) {
      case 32: return run(K<bf, 32>::launch, opt_in_smem<K<bf, 32>>());
      case 64: return run(K<bf, 64>::launch, opt_in_smem<K<bf, 64>>());
      case 128: return run(K<bf, 128>::launch, opt_in_smem<K<bf, 128>>());
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The blocks of kernel K (K::threads threads a block) that fit on one SM
// of the current device, and the dynamic shared memory each takes
// (K::smem): a report of the build, which no launch reads.
template <typename K>
int occupancy_of(int* blocks, int* smem_bytes) {
  const cudaError_t opt = opt_in_smem<K>();
  if (opt != cudaSuccess) return (int)opt;
  *smem_bytes = (int)K::smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, K::fn(), K::threads, K::smem);
}

// occupancy_of K<T, D> for a dtype code (0 = float32, 1 = bfloat16) and
// head dim
template <template <typename, int> class K>
int occupancy(int dtype, int D, int* blocks, int* smem_bytes) {
  using bf = __nv_bfloat16;
  switch (dtype * 1000 + D) {
    case 32: return occupancy_of<K<float, 32>>(blocks, smem_bytes);
    case 64: return occupancy_of<K<float, 64>>(blocks, smem_bytes);
    case 128: return occupancy_of<K<float, 128>>(blocks, smem_bytes);
    case 1032: return occupancy_of<K<bf, 32>>(blocks, smem_bytes);
    case 1064: return occupancy_of<K<bf, 64>>(blocks, smem_bytes);
    case 1128: return occupancy_of<K<bf, 128>>(blocks, smem_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
