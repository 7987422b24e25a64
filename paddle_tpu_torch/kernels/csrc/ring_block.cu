// Per-shard attention blocks of sequence parallelism (ring and Ulysses),
// forward and backward, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/ring_block.py: _fwd_kernel
// (#12, launched by shard_fwd), _dq_kernel (#13, shard_dq) and _dkv_kernel
// (#14, shard_dkv). One call attends the resident query shard q [B, H, Sq, D]
// to one visiting key/value shard k, v [B, H, Sk, D], each read through its
// (batch, head, row) element strides with the last dim contiguous. The
// shards' global causal offsets row0 and col0 are kernel arguments: under a
// causal mask query i of the shard (global row row0 + i) sees key j (global
// column col0 + j) when col0 + j <= row0 + i. No bias, no dropout.
//
//   ring_fwd: one block per (query tile, head, batch) streams the live key
//     tiles through shared memory with an online softmax and writes the
//     shard's normalised output o (fp32 [B, H, Sq, D]) and row logsumexp
//     lse (fp32 [B, H, Sq]). A row with no live key gets o = 0 and
//     lse = -1e30, a finite stand-in for -inf that the caller's logsumexp
//     merge weighs as nothing (with -inf the merge of two such rows is NaN).
//   ring_dq: one block per (query tile, head, batch); given the GLOBAL lse
//     and delta = rowsum(dO . out) of the whole ring, p = exp(s - lse),
//     dS = p (dO v^T - delta), and scale * dS k is ADDED into the caller's
//     fp32 dq accumulator.
//   ring_dkv: one block per (key tile, head, batch) over the live query
//     tiles: dS^T q * scale and p^T dO are ADDED into the fp32 dk and dv
//     accumulators that travel the ring with the visiting shard.
//
// The backward pair adds into the caller's accumulators (each element is
// owned by one thread of one block: no atomics, a fixed order of sums, the
// same bits from two launches) instead of writing a contribution the
// caller would add in another pass over device memory. Tile liveness is
// decided in global coordinates: tiles wholly above the causal diagonal
// are never visited; inside a live tile each entry is masked by its own
// coordinates, so a row may be wholly masked (and adds exactly 0).
//
// All three kernels run their products on the tensor cores, on
// mma_tiles.cuh; the forward is attn_mma.cuh's fwd_mma_block, the body it
// shares with the whole-row forward #1/#5, with the ring's policy
// (RingFwd: liveness at the offsets). All share attn_tiles.cuh's
// shared-memory opt-in and dtype/head-dim dispatch. bf16 inputs widen to
// TF32 exactly; every output is fp32.
//
// What bounds it on the H100: at B=1, H=12, S=8192, D=64, causal, offsets
// (0, 0), each kernel does 4*D flops for each of the 4.03e8 live pairs
// (the backward's 8*D split between #13 and #14), 1.03e11 operations
// against ~8 MB of bytes: operations (1.54 ms each at 67 TFLOP/s fp32 on
// the CUDA cores). The first design of all three, fp32 on the CUDA cores
// with one float4 read from shared memory for every 4 FMAs, was bound by
// shared-memory traffic at 16-17% of that peak; they now run their
// products on the tensor cores: mma.sync m16n8k8 TF32 in the 3xTF32 split
// (mma_tiles.cuh), three TF32 products for each fp32 one, so the bound of
// the arithmetic each does is 0.625 ms at 495 TFLOP/s dense TF32. What
// the design does:
//   - 4 warps a block (mma::THREADS = 128), each owning 16 rows of the
//     block's resident 64-row tile (fwd: Q; dq: Q and dO; dkv: K and V),
//     held in shared memory in the input dtype; the other side streams
//     through two cp.async stages of BS rows (64, or 32 at D=128 to keep
//     the S and dP register tiles beside the accumulators), so the next
//     tile's copy overlaps this tile's products;
//   - S and dP (dkv: S^T = K Q^T and dP^T = V dO^T, key-major) stay in
//     registers; P and dS are formed there and become the A operand of
//     the next product without leaving them (mma::c_to_a), so neither #12
//     nor #14 round-trips P through shared memory; #12 keeps the row max
//     and sum in registers, over the row's four lanes;
//   - each tile's P V (dS K, P^T dO, dS^T Q) is summed from zero on the
//     tensor cores and added to the accumulators in fp32
//     (mma::add_product): an mma's own sum truncates, and one chain over a
//     whole sequence (8192 rows) drifted past the fp32 tolerance; summed
//     by tiles, the kernels stay as close to an fp64 reference as the fp32
//     plain versions;
//   - the fragment reads are free of bank conflicts (rows padded by 16
//     bytes), and a bf16 tile widens exactly, so its lo terms are not
//     computed (2 products of 3 remain for P V, dS K and P^T dO, 1 for S,
//     dP);
//   - under the causal mask #12 and #13 start their heaviest query tiles
//     first;
//   - a view whose rows are not 16-byte aligned (a base one element off,
//     an odd row stride) takes the same kernels' synchronous copy path,
//     chosen by the entry points from the pointers and strides.
// As built for the H100 (ptxas -v; ring_block_fwd_occupancy and
// ring_block_bwd_occupancy), fp32 / bf16:
//   ring_fwd_kernel D=64: 203 / 194 registers, no spills, 86 / 46 KB of
//     shared memory, 2 / 2 blocks an SM; D=32: 207 / 168, 2 / 3 blocks;
//     D=128 (BS = 32): 233 / 225, 2 / 2 blocks;
//   ring_dq_kernel  D=64: 181 / 151 registers, no spills, 102 / 54 KB of
//     shared memory, 2 / 3 blocks an SM; D=32: 155 / 133, 3 / 3 blocks;
//     D=128 (BS = 32): 209 / 206, 1 / 2 blocks;
//   ring_dkv_kernel D=64: 218 / 228 registers, no spills, 103 / 55 KB,
//     2 / 2 blocks an SM; D=32: 176 / 162, 2 / 3 blocks; D=128: 255 with
//     a few bytes of spills, 1 / 2 blocks.
// At [1, 12, 8192, 64] fp32 causal the forward takes about 5x its
// 0.625 ms bound (3.16 ms, a third of its first design's, 0.88x SDPA's
// causal forward) and the pair about a third of its first design's time
// (PERF.md), 8-10x the 0.625 ms bound; which of
// latency (8 warps an SM), issue slots or the tensor pipe holds it there
// is not measured.
// wgmma with TMA, and one fused kernel (5 products instead of 7, but
// atomic adds into dq), are later work.

#include <stdint.h>

#include "attn_mma.cuh"

namespace {

using namespace attn;

// Pointers, shapes and strides of one launch (strides in elements; every
// last dim is contiguous). o, dq, dk and dv are contiguous fp32
// [B, H, rows, D]; lse and delta contiguous fp32 [B, H, Sq].
struct RingArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  float* o;        // forward: o; backward: dq (accumulated)
  float* dk;       // accumulated
  float* dv;       // accumulated
  float* lse;      // forward: written; backward: read
  const float* delta;
  int B, S, H;     // S: the rows of the launch's tiled axis (Sq or Sk)
  int Sq, Sk;
  int row0, col0;  // global offsets of the query and key shards
  long long q_sb, q_sh, q_ss;
  long long kv_sb, kv_sh, kv_ss;
  long long do_sb, do_sh, do_ss;
  float scale;
  int causal;
  int async_copy;  // q, k, v (and dO) rows 16-byte aligned
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, long long sb,
                                             long long sh) {
  return static_cast<const T*>(p) + (long long)blockIdx.z * sb +
         (long long)blockIdx.y * sh;
}

// key tiles of COLS a block of query rows [q0, q0 + ROWS) needs: under
// the causal mask, those whose first key is at or below the block's last
// row
template <int ROWS, int COLS>
__device__ __forceinline__ int live_key_tiles(const RingArgs& a, int q0) {
  int n = (a.Sk + COLS - 1) / COLS;
  if (a.causal) {
    const int last = a.row0 + min(q0 + ROWS, a.Sq) - 1 - a.col0;
    n = last < 0 ? 0 : min(n, last / COLS + 1);
  }
  return n;
}

__device__ __forceinline__ bool live(const RingArgs& a, int i, int j) {
  return i < a.Sq && j < a.Sk && (!a.causal || a.col0 + j <= a.row0 + i);
}

// #12's elementwise step for attn_mma.cuh's fwd_mma_block: liveness in
// global coordinates (live), a dead entry weighing exactly 0; no bias, no
// dropout. A row with no live key keeps m = NEG_INF and l = 0 and writes
// o = 0 and lse = NEG_INF.
struct RingFwd {
  const RingArgs& a;
  __device__ int rows() const { return a.Sq; }
  __device__ int keys() const { return a.Sk; }
  __device__ const float* key_bias() const { return nullptr; }
  __device__ bool masked() const { return false; }
  template <int BS>
  __device__ int key_tiles(int q0) const {
    return live_key_tiles<mma::ROWS, BS>(a, q0);
  }
  template <int NB>
  __device__ void fill(unsigned char*, int, int, int) const {}
  // m starts finite: a row whose keys are all masked keeps m = NEG_INF
  // and alpha = exp(0) = 1 instead of exp(-inf - -inf) = NaN
  __device__ float m0() const { return NEG_INF; }
  __device__ float score(float dot, int i, int j, float) const {
    return live(a, i, j) ? dot * a.scale : NEG_INF;
  }
  // a masked entry weighs 0 even where the whole row is masked
  // (m_new == NEG_INF, where exp(s - m_new) would be 1)
  __device__ float weigh(float e, int i, int j) const {
    return live(a, i, j) ? e : 0.f;
  }
  __device__ float out_mul(float l) const { return l > 0.f ? 1.f / l : 0.f; }
  __device__ float lse(float m, float l) const {
    return l > 0.f ? m + logf(l) : NEG_INF;
  }
};

// #12: the forward body with the ring policy into the contiguous fp32 o
// and lse
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2)
ring_fwd_kernel(RingArgs a) {
  extern __shared__ float4 smem4[];
  const BlockTile bt = block_tile<true, FWD_GLOBAL>(a.causal);
  const long long head = (long long)bt.b * a.H + bt.h;
  fwd_mma_block<T, D, float>(
      smem4, head_of<T>(a.q, a.q_sb, a.q_sh, bt.b, bt.h),
      head_of<T>(a.k, a.kv_sb, a.kv_sh, bt.b, bt.h),
      head_of<T>(a.v, a.kv_sb, a.kv_sh, bt.b, bt.h), a.q_ss, a.kv_ss,
      a.o + head * a.Sq * D, D, a.lse + head * a.Sq,
      (int)bt.tile * mma::ROWS, a.async_copy != 0, RingFwd{a});
}

// ---------------------------------------------------------------------------
// backward pair (#13, #14) on the tensor cores: mma_tiles.cuh's 3xTF32
// products, 4 warps of 16 rows over a resident tile of mma::ROWS rows, the
// other operand streamed through two cp.async stages of BS rows.
// ---------------------------------------------------------------------------

// the two rows' accumulators of one thread (columns 8 nd + 2t, + 1 of rows
// g and g + 8) times mul, added into the fp32 rows lo and hi
template <int D>
__device__ __forceinline__ void add_frags(float* lo, float* hi,
                                          const float (&acc)[D / 8][4],
                                          float mul, int t) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (lo) {
      float2 x = *reinterpret_cast<float2*>(lo + c);
      x.x = fmaf(acc[nd][0], mul, x.x);
      x.y = fmaf(acc[nd][1], mul, x.y);
      *reinterpret_cast<float2*>(lo + c) = x;
    }
    if (hi) {
      float2 x = *reinterpret_cast<float2*>(hi + c);
      x.x = fmaf(acc[nd][2], mul, x.x);
      x.y = fmaf(acc[nd][3], mul, x.y);
      *reinterpret_cast<float2*>(hi + c) = x;
    }
  }
}

// dq: one block per (query tile, head, batch); warp w owns query rows
// q0 + 16w .. + 15. Q and dO stay in shared memory; the live K and V tiles
// stream through two cp.async stages. Per key tile: S = Q K^T and
// dP = dO V^T in registers, P = exp(S scale - lse) masked in global
// coordinates, dS = P (dP - delta), and dQ += dS K with dS taken from the
// accumulators as the A operand (mma::add_product: the tile's product
// summed from zero, then added to dQ in fp32). Under the causal mask the
// heaviest query tiles (the last) start first.
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2) ring_dq_kernel(RingArgs a) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr bool EX = mma::exact_tf32<T>();

  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sDO = sQ + mma::ROWS * LDT;
  T* sKV = sDO + mma::ROWS * LDT;  // stage s: K, then V, at s STAGE

  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * mma::ROWS;
  const int n_tiles = live_key_tiles<mma::ROWS, BS>(a, q0);
  if (n_tiles == 0) return;  // adds nothing
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = lane & 3;
  const bool async = a.async_copy;
  const T* kb = head_ptr<T>(a.k, a.kv_sb, a.kv_sh);
  const T* vb = head_ptr<T>(a.v, a.kv_sb, a.kv_sh);
  auto load_kv = [&](int kt) {
    mma::load_stage<T, D, BS>(sKV + (kt & 1) * Tl::STAGE, kb, a.kv_ss, vb,
                              a.kv_ss, kt * BS, a.Sk, tid, async);
  };
  mma::load_tile<T, D, mma::ROWS>(sQ, head_ptr<T>(a.q, a.q_sb, a.q_sh),
                                  a.q_ss, q0, a.Sq, tid, async);
  mma::load_tile<T, D, mma::ROWS>(sDO, head_ptr<T>(a.dout, a.do_sb, a.do_sh),
                                  a.do_ss, q0, a.Sq, tid, async);
  load_kv(0);
  mma::commit_async();

  const long long head = (long long)blockIdx.z * a.H + blockIdx.y;
  const int rows[2] = {q0 + w * 16 + (lane >> 2),
                       q0 + w * 16 + (lane >> 2) + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < a.Sq;
    lse[h] = ok ? a.lse[head * a.Sq + rows[h]] : 0.f;
    delta[h] = ok ? a.delta[head * a.Sq + rows[h]] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) load_kv(kt + 1);
    mma::commit_async();  // possibly empty: one group an iteration
    mma::wait_async<1>();
    __syncthreads();
    const T* sK = sKV + (kt & 1) * Tl::STAGE;
    const T* sV = sK + BS * LDT;

    float s[NB][4], dp[NB][4];  // S = Q K^T, dP = dO V^T
    mma::tile_products<D, NB, LDT, EX>(s, dp, sQ, sK, sDO, sV, w, lane);
    const int k0 = kt * BS;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = live(a, rows[h], k0 + nb * 8 + 2 * t + (e & 1))
                            ? expf(s[nb][e] * a.scale - lse[h])
                            : 0.f;
        s[nb][e] = p * (dp[nb][e] - delta[h]);  // dS
      }
    mma::add_product<D, NB, LDT, EX>(acc, s, sK, lane);  // dQ += dS K
    __syncthreads();  // every warp is done with the stage loaded next
  }
  float* dq = a.o + head * a.Sq * D;
  add_frags<D>(rows[0] < a.Sq ? dq + (long long)rows[0] * D : nullptr,
               rows[1] < a.Sq ? dq + (long long)rows[1] * D : nullptr, acc,
               a.scale, t);
}

// dk, dv: one block per (key tile, head, batch); warp w owns keys
// k0 + 16w .. + 15. K and V stay in shared memory; the live Q and dO tiles,
// with their rows' lse and delta, stream through two cp.async stages. Per
// query tile: S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out
// key-major, as the A operands of dV += P^T dO and dK += dS^T Q.
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2) ring_dkv_kernel(RingArgs a) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr bool EX = mma::exact_tf32<T>();

  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);
  T* sV = sK + mma::ROWS * LDT;
  T* sQD = sV + mma::ROWS * LDT;  // stage s: Q, then dO, at s STAGE
  float* sStat = reinterpret_cast<float*>(sQD + Tl::STAGES * Tl::STAGE);

  const int k0 = blockIdx.x * mma::ROWS;
  const int n_qt = (a.Sq + BS - 1) / BS;
  // causal: query tiles whose last global row lies before this tile's
  // first global column see none of its keys
  const int first = a.col0 + k0 - a.row0;
  const int qt0 = (a.causal && first > 0) ? first / BS : 0;
  if (qt0 >= n_qt) return;  // adds nothing
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = lane & 3;
  const bool async = a.async_copy;
  const long long head = (long long)blockIdx.z * a.H + blockIdx.y;
  const T* qb = head_ptr<T>(a.q, a.q_sb, a.q_sh);
  const T* dob = head_ptr<T>(a.dout, a.do_sb, a.do_sh);
  const float* lse_row = a.lse + head * a.Sq;
  const float* delta_row = a.delta + head * a.Sq;
  auto load_q = [&](int qt) {
    const int st = (qt - qt0) & 1;
    mma::load_stage<T, D, BS>(sQD + st * Tl::STAGE, qb, a.q_ss, dob, a.do_ss,
                              qt * BS, a.Sq, tid, async);
    mma::load_floats<BS>(sStat + st * 2 * BS, lse_row, delta_row, qt * BS,
                         a.Sq, tid);  // lse, then delta
  };
  mma::load_tile<T, D, mma::ROWS>(sK, head_ptr<T>(a.k, a.kv_sb, a.kv_sh),
                                  a.kv_ss, k0, a.Sk, tid, async);
  mma::load_tile<T, D, mma::ROWS>(sV, head_ptr<T>(a.v, a.kv_sb, a.kv_sh),
                                  a.kv_ss, k0, a.Sk, tid, async);
  load_q(qt0);
  mma::commit_async();

  const int keys[2] = {k0 + w * 16 + (lane >> 2),
                       k0 + w * 16 + (lane >> 2) + 8};
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_q(qt + 1);
    mma::commit_async();
    mma::wait_async<1>();
    __syncthreads();
    const int st = (qt - qt0) & 1;
    const T* sQ = sQD + st * Tl::STAGE;
    const T* sDO = sQ + BS * LDT;
    const float* sLse = sStat + st * 2 * BS;
    const float* sDelta = sLse + BS;

    float s[NB][4], dp[NB][4];  // S^T = K Q^T, dP^T = V dO^T
    mma::tile_products<D, NB, LDT, EX>(s, dp, sK, sQ, sV, sDO, w, lane);
    const int q0 = qt * BS;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = nb * 8 + 2 * t + (e & 1);
        const float p = live(a, q0 + il, keys[e >> 1])
                            ? expf(s[nb][e] * a.scale - sLse[il])
                            : 0.f;
        s[nb][e] = p;                             // P^T
        dp[nb][e] = p * (dp[nb][e] - sDelta[il]);  // dS^T
      }
    mma::add_product<D, NB, LDT, EX>(dv, s, sDO, lane);  // dV += P^T dO
    mma::add_product<D, NB, LDT, EX>(dk, dp, sQ, lane);  // dK += dS^T Q
    __syncthreads();
  }
  float* dkh = a.dk + head * a.Sk * D;
  float* dvh = a.dv + head * a.Sk * D;
  const bool ok0 = keys[0] < a.Sk, ok1 = keys[1] < a.Sk;
  add_frags<D>(ok0 ? dkh + (long long)keys[0] * D : nullptr,
               ok1 ? dkh + (long long)keys[1] * D : nullptr, dk, a.scale, t);
  add_frags<D>(ok0 ? dvh + (long long)keys[0] * D : nullptr,
               ok1 ? dvh + (long long)keys[1] * D : nullptr, dv, 1.f, t);
}

#define RING_KERNEL(NAME, KERNEL, NTHREADS, SMEM)                            \
  template <typename T, int D>                                               \
  struct NAME {                                                              \
    static constexpr int threads = NTHREADS;                                 \
    static constexpr size_t smem = SMEM;                                     \
    static const void* fn() { return (const void*)KERNEL<T, D>; }            \
    static void launch(dim3 grid, cudaStream_t st, const RingArgs& a) {      \
      KERNEL<T, D><<<grid, threads, smem, st>>>(a);                          \
    }                                                                        \
  };

// Q resident, K and V streamed (attn_mma.cuh)
RING_KERNEL(Fwd, ring_fwd_kernel, mma::THREADS, (FwdSmem<T, D>::bytes))
// dq: Q and dO resident, K and V streamed; dkv: K and V resident, Q and
// dO streamed with their lse and delta
RING_KERNEL(Dq, ring_dq_kernel, mma::THREADS,
            (mma::BwdTiles<T, D>::smem(0)))
RING_KERNEL(Dkv, ring_dkv_kernel, mma::THREADS,
            (mma::BwdTiles<T, D>::smem(2 * mma::BwdTiles<T, D>::BS)))

RingArgs make_args(const void* q, const void* k, const void* v,
                   const void* dout, float* o, float* dk, float* dv,
                   float* lse, const float* delta, int B, int H, int Sq,
                   int Sk, int row0, int col0, const long long* s,
                   float scale, int causal) {
  return RingArgs{q, k, v, dout, o, dk, dv, lse, delta, B, Sq, H, Sq, Sk,
                  row0, col0, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                  s[7], s[8], scale, causal, 0};
}

// The copy path: 16-byte cp.async where q, k, v and dO (the forward
// passes q again) and their nine strides keep every head row 16-byte
// aligned, else synchronous element copies.
int rows_aligned(const void* q, const void* k, const void* v,
                 const void* dout, const long long* s, int dtype) {
  return mma::rows_aligned(q, k, v, dout, s, 9, dtype == 1 ? 2 : 4);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and dout alike). strides: a
// host array of nine element strides (batch, head, row) of q, of k and v
// (shared), and of dout, in that order. o, dq, dk and dv are contiguous
// fp32 [B, H, rows, D]; lse and delta contiguous fp32 [B, H, Sq]. The
// backward entries add into dq and into dk, dv. Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int ring_block_fwd(const void* q, const void* k, const void* v,
                              float* o, float* lse, int B, int H, int Sq,
                              int Sk, int D, int row0, int col0,
                              const long long* strides, float scale,
                              int causal, int dtype, void* stream) {
  RingArgs a = make_args(q, k, v, nullptr, o, nullptr, nullptr, lse,
                         nullptr, B, H, Sq, Sk, row0, col0, strides, scale,
                         causal);
  a.async_copy = rows_aligned(q, k, v, q, strides, dtype);
  return dispatch<Fwd>(dtype, D, a, stream);
}

extern "C" int ring_block_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, float* dq, int B, int H,
                                 int Sq, int Sk, int D, int row0, int col0,
                                 const long long* strides, float scale,
                                 int causal, int dtype, void* stream) {
  RingArgs a = make_args(q, k, v, dout, dq, nullptr, nullptr,
                         const_cast<float*>(lse), delta, B, H, Sq, Sk, row0,
                         col0, strides, scale, causal);
  a.async_copy = rows_aligned(q, k, v, dout, strides, dtype);
  return dispatch<Dq>(dtype, D, a, stream);
}

extern "C" int ring_block_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dk, float* dv,
                                  int B, int H, int Sq, int Sk, int D,
                                  int row0, int col0,
                                  const long long* strides, float scale,
                                  int causal, int dtype, void* stream) {
  RingArgs a = make_args(q, k, v, dout, nullptr, dk, dv,
                         const_cast<float*>(lse), delta, B, H, Sq, Sk, row0,
                         col0, strides, scale, causal);
  a.S = Sk;  // one block per key tile
  a.async_copy = rows_aligned(q, k, v, dout, strides, dtype);
  return dispatch<Dkv>(dtype, D, a, stream);
}

// The blocks of a backward kernel (which: 0 = dq, 1 = dkv) that fit on
// one SM of the current device, and the dynamic shared memory each block
// takes, for a dtype code and head dim: a report of the build, which no
// launch reads.
extern "C" int ring_block_bwd_occupancy(int which, int dtype, int D,
                                        int* blocks, int* smem_bytes) {
  return which == 0 ? occupancy<Dq>(dtype, D, blocks, smem_bytes)
                    : occupancy<Dkv>(dtype, D, blocks, smem_bytes);
}

// The same report for the forward kernel (#12)
extern "C" int ring_block_fwd_occupancy(int dtype, int D, int* blocks,
                                        int* smem_bytes) {
  return occupancy<Fwd>(dtype, D, blocks, smem_bytes);
}
