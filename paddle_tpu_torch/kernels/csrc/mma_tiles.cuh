// Tensor-core tile code for Hopper (sm_90a): fp32-accurate products on
// mma.sync TF32 (3xTF32), shared-memory tiles fed by cp.async, and the
// fragment loads of the m16n8k8 product. The three backward pairs are
// built on it: the ring-block pair (#13, #14, ring_block.cu), and the
// whole-row (#3/#6, flash_attention.cu) and KV-tiled (#9/#8,
// flash_tiled.cu) pairs through the bodies they share (attn_mma.cuh); the
// forward kernels (#1/#5, #7, #12) still run on the CUDA cores.
//
// The product. A block's warps each own 16 rows of an m16n8k8 TF32 product
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, fp32 accumulators).
// TF32 keeps 10 mantissa bits, so an fp32 operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x = hi + lo within
// 2^-22 |x|), and a product is lo.hi + hi.lo + hi.hi, the small terms first:
// each term within about 2^-21 of fp32's, where one TF32 product (2^-11)
// would not hold an fp32 tolerance. A bf16 value widens to TF32 exactly,
// so a tile loaded from bf16 has lo = 0 and its terms drop out at compile
// time (Frag<N, true>).
//
// Fragments (PTX ISA, m16n8k8 .tf32; lane = 4 g + t): A (16 x 8, row)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// col) b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8) c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1). An accumulator
// becomes the A operand of the next product with no data movement
// (c_to_a): the product sums over its 8 k-indices in any order, so A's k
// index t stands for column 2t and t + 4 for 2t + 1, and the B operand is
// read in the same order (load_b_kn: rows k0 + 2t and k0 + 2t + 1).
//
// Tiles. Shared-memory tiles keep the input dtype, a row of D elements
// padded by 16 bytes (LDT): rows stay 16-byte aligned for cp.async, and a
// row is 4 banks (mod 32) from the next, so every fragment read below
// (8 rows x 4 columns, or 4 row pairs x 8 columns) is free of bank
// conflicts in fp32 and bf16. load_tile copies 16 bytes a thread with
// cp.async (zero-filled past the sequence end) when the caller's rows are
// 16-byte aligned (rows_aligned), else element by element; a caller
// waits with wait_async<N>() and __syncthreads() in either case.
//
// The backward pairs. BwdTiles, load_stage, load_floats and tile_products
// are the parts the pairs share: the tiles, the stream's loads and the S
// and dP products of a tile; the ring pair and attn_mma.cuh's bodies each
// keep their own elementwise step (liveness at offsets, or bias, causal
// cut and dropout) and store.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace mma {

constexpr int WARP_ROWS = 16;  // rows of the m16n8k8 product a warp owns
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = WARP_ROWS * WARPS;  // rows of a block's resident tile

// true where every value of T is a TF32 value (its lo is 0)
template <typename T>
__host__ __device__ constexpr bool exact_tf32() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// elements a shared-memory row of D values of T takes (16 bytes of pad)
template <typename T, int D>
__host__ __device__ constexpr int ldt() {
  return D + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round to nearest, ties away from zero, onto TF32's 10 mantissa bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// N operand values of one thread, as TF32 hi (and lo unless EXACT)
template <int N, bool EXACT>
struct Frag {
  uint32_t hi[N];
  uint32_t lo[N];  // never read when EXACT: the compiler drops it
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (EXACT) {
      hi[i] = __float_as_uint(x);
    } else {
      hi[i] = tf32_rna(x);
      lo[i] = tf32_rna(x - __uint_as_float(hi[i]));
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 (the terms of an exact operand dropped)
template <bool EA, bool EB>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4, EA>& a,
                                     const Frag<2, EB>& b) {
  if constexpr (!EA) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!EB) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// A of rows r0.. and columns c0.. of a row-major shared tile
template <int LDT, typename T, bool EXACT>
__device__ __forceinline__ void load_a(Frag<4, EXACT>& f, const T* tile,
                                       int r0, int c0, int lane) {
  const T* p = tile + (r0 + (lane >> 2)) * LDT + c0 + (lane & 3);
  f.set(0, widen(p[0]));
  f.set(1, widen(p[8 * LDT]));
  f.set(2, widen(p[4]));
  f.set(3, widen(p[8 * LDT + 4]));
}

// B = tile^T: b (k, n) is tile[n0 + n][k0 + k] (the keys of q k^T)
template <int LDT, typename T, bool EXACT>
__device__ __forceinline__ void load_b_nk(Frag<2, EXACT>& f, const T* tile,
                                          int n0, int k0, int lane) {
  const T* p = tile + (n0 + (lane >> 2)) * LDT + k0 + (lane & 3);
  f.set(0, widen(p[0]));
  f.set(1, widen(p[4]));
}

// B = tile in c_to_a's k order: b0 = tile[k0 + 2t][n0 + g],
// b1 = tile[k0 + 2t + 1][n0 + g]
template <int LDT, typename T, bool EXACT>
__device__ __forceinline__ void load_b_kn(Frag<2, EXACT>& f, const T* tile,
                                          int k0, int n0, int lane) {
  const T* p = tile + (k0 + 2 * (lane & 3)) * LDT + n0 + (lane >> 2);
  f.set(0, widen(p[0]));
  f.set(1, widen(p[LDT]));
}

// the accumulator of 8 columns as the A operand of a product over them
__device__ __forceinline__ void c_to_a(Frag<4, false>& f,
                                       const float (&c)[4]) {
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
}

// acc += a b for one warp: a the warp's 16 x NB*8 accumulator tile (NB
// blocks of 8 columns, as an earlier product left them), b NB*8 rows of
// D columns of a shared tile. Each chunk of up to 64 output columns is
// summed from zero by the tensor cores over the NB*8 k-indices (at most
// 3 NB products a chain), and acc takes the chunk with fp32 adds: an
// mma's own sum drops the bits below its result's last place instead of
// rounding, so a chain of thousands (one accumulator over a whole
// sequence) drifts by more than fp32's rounding would.
template <int D, int NB, int LDT, bool EXACT, typename T>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4],
                                            const float (&a)[NB][4],
                                            const T* b, int lane) {
  constexpr int ND = D / 8;
  constexpr int CH = ND < 8 ? ND : 8;  // 8-column blocks a chunk
#pragma unroll
  for (int c0 = 0; c0 < ND; c0 += CH) {
    float part[CH][4];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
      Frag<4, false> fa;
      c_to_a(fa, a[kb]);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        Frag<2, EXACT> fb;
        load_b_kn<LDT>(fb, b, kb * 8, (c0 + j) * 8, lane);
        mma3(part[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + j][e] += part[j][e];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest N has landed (this thread's)
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + NROWS) of one head (D values of T, rows row_stride
// elements apart) into a shared tile of row stride ldt<T, D>(); rows past
// S read as zeros. async: 16-byte cp.async copies (the head's base and
// row stride 16-byte aligned); else synchronous element copies.
template <typename T, int D, int NROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int r0,
                                          int S, int tid, bool async) {
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                         uint16_t>::type;
  constexpr int LDT = ldt<T, D>();
  constexpr int PER = 16 / (int)sizeof(T);  // elements a 16-byte chunk
  constexpr int CHUNKS = D / PER;           // chunks a row
  static_assert(D % PER == 0, "rows split into 16-byte chunks");
  for (int i = tid; i < NROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * PER;
    const bool ok = r0 + r < S;
    const T* s = src + (ok ? (long long)(r0 + r) * row_stride + c : 0);
    T* d = dst + r * LDT + c;
    if (async) {
      cp_async16(d, s, ok);
    } else {
      const Bits* sb = reinterpret_cast<const Bits*>(s);
      Bits* db = reinterpret_cast<Bits*>(d);
#pragma unroll
      for (int e = 0; e < PER; ++e) db[e] = ok ? sb[e] : Bits(0);
    }
  }
}

// The shared-memory tiles of a backward block on these products: a
// resident tile of ROWS rows of two operands (dq: Q and dO; dkv: K and V)
// and STAGES stages of two streamed tiles of BS rows (dq: K and V; dkv: Q
// and dO), rows LDT elements apart; a kernel's fp32 stage rows (a key
// bias, lse and delta) and keep masks follow them (smem).
template <typename T, int D>
struct BwdTiles {
  static constexpr int LDT = ldt<T, D>();
  // rows of a streamed tile: D=128 halves it, so that the S and dP tiles
  // (BS/2 registers each) fit beside the D/2 (dq) or D (dk and dv) of the
  // accumulators
  static constexpr int BS = D > 64 ? 32 : 64;
  static constexpr int NB = BS / 8;  // 8-column blocks of S and dP
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * BS * LDT;  // elements of a stage
  // bytes with `floats` fp32 values a stage and `extra` bytes after them
  static constexpr size_t smem(int floats, size_t extra = 0) {
    return (2 * ROWS * LDT + STAGES * STAGE) * sizeof(T) +
           STAGES * floats * sizeof(float) + extra;
  }
};

// One stage of the stream: rows [r0, r0 + BS) of a (rows a_ss apart) and
// of b (rows b_ss apart) into stage and stage + BS * LDT (load_tile)
template <typename T, int D, int BS>
__device__ __forceinline__ void load_stage(T* stage, const T* a,
                                           long long a_ss, const T* b,
                                           long long b_ss, int r0, int S,
                                           int tid, bool async) {
  load_tile<T, D, BS>(stage, a, a_ss, r0, S, tid, async);
  load_tile<T, D, BS>(stage + BS * ldt<T, D>(), b, b_ss, r0, S, tid, async);
}

// Values [r0, r0 + N) of the fp32 row a, and of b unless it is null, into
// dst (b's at dst + N) by 4-byte cp.async (any alignment; zeros past S),
// thread tid copying value tid of the two
template <int N>
__device__ __forceinline__ void load_floats(float* dst, const float* a,
                                            const float* b, int r0, int S,
                                            int tid) {
  if (tid >= (b ? 2 : 1) * N) return;
  const int i = r0 + tid % N;
  const bool ok = i < S;
  cp_async4(dst + tid, (tid < N ? a : b) + (ok ? i : 0), ok);
}

// The two products of one streamed tile for warp w: s = A1 B1^T and
// dp = A2 B2^T, A1 and A2 the warp's 16 rows (from row 16 w) of the
// resident tiles, B1 and B2 the NB*8 rows of the stage (dq: S = Q K^T,
// dP = dO V^T; dkv: S^T = K Q^T, dP^T = V dO^T). By default each is one
// chain of mma's over the D columns, summed from zero: an mma truncates
// into its accumulator (it drops the bits below the last place of its
// result), so the chain's 3 D / 8 steps (fp32 operands) bias s and dp
// toward zero by up to a unit in the last place each. Where delta is
// dp's own row sum (the whole-row pair's pass 1) the bias cancels in
// dp - delta; where delta comes from the saved output (the tiled pair),
// dS keeps it and dbias, a sum of dS over the rows, adds it up (7e-5 at
// D = 128, S = 1100). STEPWISE sums each 8-column step from zero on the
// tensor cores and adds it in fp32 (round to nearest) instead: about a
// tenth of the error, for 4 more adds a step and block of 8 columns and
// more live registers (the tiled dkv kernel, PERF.md).
template <int D, int NB, int LDT, bool EXACT, bool STEPWISE = false,
          typename T>
__device__ __forceinline__ void tile_products(float (&s)[NB][4],
                                              float (&dp)[NB][4],
                                              const T* a1, const T* b1,
                                              const T* a2, const T* b2,
                                              int w, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    Frag<4, EXACT> f1, f2;
    load_a<LDT>(f1, a1, w * 16, kk * 8, lane);
    load_a<LDT>(f2, a2, w * 16, kk * 8, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      Frag<2, EXACT> g1, g2;
      if constexpr (STEPWISE) {
        float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
        load_b_nk<LDT>(g1, b1, nb * 8, kk * 8, lane);
        mma3(t1, f1, g1);
        load_b_nk<LDT>(g2, b2, nb * 8, kk * 8, lane);
        mma3(t2, f2, g2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] += t1[e];
          dp[nb][e] += t2[e];
        }
      } else {
        load_b_nk<LDT>(g1, b1, nb * 8, kk * 8, lane);
        mma3(s[nb], f1, g1);
        load_b_nk<LDT>(g2, b2, nb * 8, kk * 8, lane);
        mma3(dp[nb], f2, g2);
      }
    }
  }
}

// load_tile's async path for a launch: 1 where q, k, v and dout start
// on a 16-byte boundary and each of the first n_strides element strides
// (of elem_bytes each) spans a multiple of 16 bytes, so that every head
// row is aligned; else 0 (a view one element off, an odd row stride).
inline int rows_aligned(const void* q, const void* k, const void* v,
                        const void* dout, const long long* strides,
                        int n_strides, int elem_bytes) {
  const void* ptrs[] = {q, k, v, dout};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] * elem_bytes % 16) return 0;
  return 1;
}

}  // namespace mma
