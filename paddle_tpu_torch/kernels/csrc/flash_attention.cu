// Whole-row attention, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/flash_attention.py:
// _fwd_kernel_qkv (#1, launched by _pallas_fwd_qkv) and _bwd_kernel_qkv
// (#3, launched by _pallas_bwd_qkv), the kernels behind
// fused_attention_qkv / attention_grads_qkv and the fused_qkv_attention
// op; and _fwd_kernel (#5, launched by _pallas_fwd) and _bwd_kernel (#6,
// launched by _pallas_bwd), the kernels behind fused_attention /
// attention_grads and the fused_multihead_attention op. Per batch b and
// head h:
//
//   out = drop_scale * (keep . softmax(q k^T * scale + bias[b])) v
//
// with bias an additive fp32 key bias [B, S] (or none), causal entries
// j > i at -1e30, keep the Philox mask of philox.cuh keyed by (seed words,
// b, h, i, j) (use_mask = 1, training). drop_scale carries fluid's
// dropout: 1/(1-p) under upscale_in_train and 1 under downgrade_in_infer
// in training; 1-p or 1 in test mode (use_mask = 0). The mask is applied
// to the unnormalised exponentials and 1/rowsum to the output rows, as
// the TPU kernels do.
//
// One set of kernels serves both layouts: each takes q, k and v as
// [B, H, S, D] views given by element strides (batch, head, row; the last
// dim contiguous), row s of head (b, h) of q at q + b*sb + h*sh + s*ss. q,
// k and v share their strides, and so do out, dq, dk and dv:
//   - 4-D tensors (#5, #6): a contiguous [B, H, S, D] has sb = H*S*D,
//     sh = S*D, ss = D; the head-split views of a projection (reshape +
//     transpose) have ss = H*D and are read in place;
//   - the packed projection qkv[B, S, 3*H*D] (#1, #3): k = q + H*D,
//     v = q + 2*H*D, sh = D, ss = 3*H*D; out [B, S, H*D] has sh = D,
//     ss = H*D; dq, dk and dv are the three sections of one packed dqkv.
//
//   attn_fwd_kernel: attn_tiles.cuh's fwd_block, one block per (query
//     tile, head, batch); the keys stream through shared memory in tiles
//     with an online softmax, so every [S, S] tile stays on chip.
//   attn_bwd_dq_kernel: one block per (query tile, head, batch); pass 1
//     recomputes the row max and sum online with delta_i = sum_j p_ij dp_ij
//     (dp = dO v^T, masked and scaled as the forward scaled p), pass 2
//     forms dS = p (dp - delta) and dq = scale * dS k, and it writes each
//     row's lse and delta to an fp32 [B, H, S] scratch.
//   attn_bwd_dkv_kernel: one block per (key tile, head, batch), its own
//     body (dkv_mma_block): dv = (keep . p)^T dO * drop_scale,
//     dk = scale * dS^T q and, when asked, the per-head column sums of dS,
//     a [B, H, S] partial that sum_partials.cu adds over heads in a fixed
//     order (the TPU kernels accumulated dbias across the sequential head
//     axis; here blocks run in no order and no float atomics are used).
//
// What bounds it on the H100: at B=32, H=12, S=512, D=64 the forward does
// 4*S*D flops per query row and head against 16*D bytes of q, k, v and out,
// ~S/4 flop a byte: above the fp32 CUDA-core balance point (67 TFLOP/s over
// 3.35 TB/s = 20), so bounded by operations (0.385 ms). The forward is
// fp32 on the CUDA cores in either dtype.
//
// The backward pair runs its products on the tensor cores, on
// mma_tiles.cuh: mma.sync m16n8k8 TF32 in the 3xTF32 split (an fp32
// operand x = hi + lo, a product lo.hi + hi.lo + hi.hi), as the ring-block
// pair #13/#14 does. The function needs 4 products of 2*B*H*S^2*D flops
// (dP, dQ, dV, dK; S is the forward's): at BERT's shape, three TF32 terms
// each in fp32, 0.312 ms at 495 TFLOP/s dense TF32, and in bf16 0.052 ms
// at 989 TFLOP/s. The op saves neither the forward's output nor its lse,
// so dq recomputes them (pass 1), and the pair does 9 products (dq: S and
// dP twice, dS K; dkv: S^T, dP^T, P^T dO, dS^T Q), 27 TF32 products in
// fp32 (0.703 ms at 495 TFLOP/s). In bf16 Q, K, V and dO widen to TF32
// exactly, so their lo terms drop (12 TF32 products); P and dS stay fp32
// and are split, as the plain version keeps them fp32.
// What the design does:
//   - 4 warps a block (mma::THREADS = 128), each owning 16 rows of the
//     block's resident 64-row tile (dq: Q and dO; dkv: K and V), held in
//     shared memory in the input dtype; the other side streams through
//     two cp.async stages of BS rows (64, or 32 at D = 128), with its key
//     bias (dq) or its rows' lse and delta (dkv), so the next tile's copy
//     overlaps this tile's products; dq's two passes are one stream of
//     2 n tiles, pass 2's first tile copied during pass 1's last;
//   - S and dP (dkv: S^T = K Q^T and dP^T = V dO^T, key-major) stay in
//     registers; the scale, key bias, causal mask, sequence end and the
//     Philox keep mask are applied at the accumulators' fragment
//     coordinates; P and dS become the A operand of the next product
//     without leaving the registers (mma::c_to_a); each tile's dS K
//     (P^T dO, dS^T Q) is summed from zero on the tensor cores and added
//     in fp32 (mma::add_product);
//   - the keep mask of each tile is drawn by the block into shared memory
//     (attn_tiles.cuh's fill_mask: one Philox block per 8 keys of a query
//     row, four per thread at a 64 x 64 tile) while the next tile's copy
//     is in flight;
//   - dkv keeps keys as the M rows, so a key's dbias partial is a row sum
//     of the warp's dS^T tile: summed by each thread over its columns,
//     tile after tile, then over the row's four lanes, in a fixed order;
//   - under the causal mask dq starts its heaviest query tiles first, and
//     tiles wholly above the diagonal are never visited;
//   - a view whose rows are not 16-byte aligned (a base one element off,
//     an odd row stride) takes the same kernels' synchronous copy path,
//     chosen by the C entries from the pointers and strides
//     (mma::rows_aligned); the outputs are stored element by element from
//     the accumulators, so they take any view.
// As built for the H100 (ptxas -v; flash_attention_bwd_occupancy), fp32 /
// bf16, D = 32, 64, 128:
//   attn_bwd_dq_kernel: 163 / 168, 191 / 193, 211 / 214 registers, no
//     spills; 3 / 3, 2 / 2, 1 / 2 blocks an SM (55, 103, 132.5 KB of
//     shared memory in fp32; 31, 55, 68.5 KB in bf16);
//   attn_bwd_dkv_kernel: 197 / 183, 238 / 237, 255 / 255 registers, D=128
//     spilling 44-52 / 44-48 bytes; 2 / 2, 2 / 2, 1 / 2 blocks an SM.
// At [32, 12, 512, 64] fp32 with training dropout the pair takes about 12x
// the function's 3xTF32 bound and 5.4x the time of the 27 TF32 products it
// does (PERF.md); the Philox mask is drawn three times a pair.
// Pre-split hi/lo tiles, wgmma with TMA, and bf16 products on rounded P
// and dS (which the plain version does not round) are later work.

#include "attn_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace attn;

// Pointers, shapes and strides of one launch
struct HeadArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // may be null: every key kept
  const void* dout;
  void* out;           // forward: out; backward: dq
  void* dk;
  void* dv;
  float* lse;          // fp32 [B, H, S]
  float* delta;        // fp32 [B, H, S]
  float* dbias_part;   // fp32 [B, H, S], may be null
  int B, S, H;
  long long in_sb, in_sh, in_ss;     // q, k and v
  long long do_sb, do_sh, do_ss;     // dout
  long long out_sb, out_sh, out_ss;  // out, dq, dk and dv
  float scale;
  int causal;
  Dropout dr;
  int async_copy;  // backward: q, k, v and dout rows 16-byte aligned
};

template <typename T>
__device__ __forceinline__ const T* head_of(const void* p, long long sb,
                                            long long sh) {
  return static_cast<const T*>(p) + (long long)blockIdx.z * sb +
         (long long)blockIdx.y * sh;
}

template <typename T>
__device__ __forceinline__ T* head_of(void* p, long long sb, long long sh) {
  return static_cast<T*>(p) + (long long)blockIdx.z * sb +
         (long long)blockIdx.y * sh;
}

__device__ __forceinline__ long long stats_row(const HeadArgs& a) {
  return ((long long)blockIdx.z * a.H + blockIdx.y) * a.S;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  fwd_block<T, D>(reinterpret_cast<float*>(smem4),
                  head_of<T>(a.q, a.in_sb, a.in_sh),
                  head_of<T>(a.k, a.in_sb, a.in_sh),
                  head_of<T>(a.v, a.in_sb, a.in_sh), a.in_ss,
                  a.bias ? a.bias + (long long)blockIdx.z * a.S : nullptr,
                  head_of<T>(a.out, a.out_sb, a.out_sh), a.out_ss, nullptr,
                  a);
}

// ---------------------------------------------------------------------------
// backward pair (#3/#6) on the tensor cores: mma_tiles.cuh's 3xTF32
// products, 4 warps of 16 rows over a resident tile of mma::ROWS rows, the
// other side streamed through two cp.async stages of BS rows.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct BwdSmem {
  using Tl = mma::BwdTiles<T, D>;
  // the keep bytes of one (64 query rows x BS keys) or (BS query rows x 64
  // keys) tile: one byte for each 8 keys of a query row
  static constexpr size_t mask = mma::ROWS * Tl::BS / 8;
  // dq: Q and dO resident, K and V streamed with their key bias
  static constexpr size_t dq = Tl::smem(Tl::BS, mask);
  // dkv: K and V resident, Q and dO streamed with their lse and delta
  static constexpr size_t dkv = Tl::smem(2 * Tl::BS, mask);
};

// backward, kernel 1: row statistics, delta and dq. Warp w owns query rows
// q0 + 16w .. + 15; a thread holds rows g and g + 8 of them (lane = 4g + t)
// at the accumulator columns 8 nb + 2t, + 1 of each key tile. The key
// tiles stream twice: pass 1, S = Q K^T and dP = dO V^T, the online max m,
// sum l and sum_j e_ij dp_ij of each row, combined over the row's four
// lanes; pass 2, p = exp(s - lse), dS = p (dp - delta), dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2)
attn_bwd_dq_kernel(HeadArgs a) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr bool EX = mma::exact_tf32<T>();

  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sDO = sQ + mma::ROWS * LDT;
  T* sKV = sDO + mma::ROWS * LDT;  // stage s: K, then V, at s STAGE
  float* sBias = reinterpret_cast<float*>(sKV + Tl::STAGES * Tl::STAGE);
  unsigned char* sM = reinterpret_cast<unsigned char*>(
      sBias + Tl::STAGES * BS);  // [mma::ROWS][NB]

  const int S = a.S;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * mma::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  // key tiles of this query tile: under the causal mask, those whose first
  // key is at or below its last row (the others add exp(-1e30 - m) = 0)
  int n_tiles = (S + BS - 1) / BS;
  if (a.causal)
    n_tiles = min(n_tiles, (min(q0 + mma::ROWS, S) - 1) / BS + 1);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool async = a.async_copy;
  const Dropout& dr = a.dr;
  const T* kb = head_of<T>(a.k, a.in_sb, a.in_sh);
  const T* vb = head_of<T>(a.v, a.in_sb, a.in_sh);
  const float* brow = a.bias ? a.bias + (long long)b * S : nullptr;
  // stream position i: key tile i of pass 1, then tile i - n of pass 2
  auto load_kv = [&](int i) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * BS;
    mma::load_stage<T, D, BS>(sKV + (i & 1) * Tl::STAGE, kb, a.in_ss, vb,
                              a.in_ss, k0, S, tid, async);
    if (brow)
      mma::load_floats<BS>(sBias + (i & 1) * BS, brow, nullptr, k0, S, tid);
  };
  mma::load_tile<T, D, mma::ROWS>(sQ, head_of<T>(a.q, a.in_sb, a.in_sh),
                                  a.in_ss, q0, S, tid, async);
  mma::load_tile<T, D, mma::ROWS>(sDO, head_of<T>(a.dout, a.do_sb, a.do_sh),
                                  a.do_ss, q0, S, tid, async);
  load_kv(0);
  mma::commit_async();

  const int rows[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  const int local[2] = {w * 16 + g, w * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};  // sum_j e_ij dp_ij, rescaled as l is
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int i = 0; i < 2 * n_tiles; ++i) {
    const bool pass2 = i >= n_tiles;
    const int k0 = (pass2 ? i - n_tiles : i) * BS;
    if (i + 1 < 2 * n_tiles) load_kv(i + 1);
    mma::commit_async();  // possibly empty: one group an iteration
    fill_mask<mma::ROWS, NB, mma::THREADS>(sM, dr, q0, k0, h, b, tid);
    if (i == n_tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse[r] = m[r] + logf(l[r]);
        delta[r] = dsum[r] / l[r];
      }
    }
    mma::wait_async<1>();
    __syncthreads();
    const T* sK = sKV + (i & 1) * Tl::STAGE;
    const T* sV = sK + BS * LDT;
    const float* sB = sBias + (i & 1) * BS;

    float s[NB][4], dp[NB][4];  // S = Q K^T, dP = dO V^T
    mma::tile_products<D, NB, LDT, EX>(s, dp, sQ, sK, sDO, sV, w, lane);
    // the scores and the kept, scaled dp at the fragment's coordinates:
    // key j = k0 + 8 nb + 2t + (e & 1) of row rows[e >> 1]
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const unsigned keep[2] = {
          dr.use_mask ? (unsigned)sM[local[0] * NB + nb] : 0xFFu,
          dr.use_mask ? (unsigned)sM[local[1] * NB + nb] : 0xFFu};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, jl = nb * 8 + 2 * t + (e & 1), j = k0 + jl;
        float sc = -INFINITY;  // past the sequence end: no weight at all
        if (j < S) {
          sc = s[nb][e] * a.scale + (brow ? sB[jl] : 0.f);
          if (a.causal && j > rows[r]) sc = NEG_INF;
        }
        s[nb][e] = sc;
        dp[nb][e] = ((keep[r] >> (jl & 7)) & 1) ? dp[nb][e] * dr.scale : 0.f;
      }
    }
    if (!pass2) {
      // key k0 < S is in every tile, so the tile max and m are finite
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      float m_new[2], ps[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], row_max4(mx[r]));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = expf(s[nb][e] - m_new[e >> 1]);
          ps[e >> 1] += ex;  // the row sum counts every p, dropped or not
          pd[e >> 1] = fmaf(ex, dp[nb][e], pd[e >> 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = expf(m[r] - m_new[r]);
        l[r] = l[r] * alpha + row_sum4(ps[r]);
        dsum[r] = dsum[r] * alpha + row_sum4(pd[r]);
        m[r] = m_new[r];
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = expf(s[nb][e] - lse[r]);
          s[nb][e] = p * (dp[nb][e] - delta[r]);  // dS
        }
      mma::add_product<D, NB, LDT, EX>(acc, s, sK, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with the stage loaded next
  }

  T* dq = head_of<T>(a.out, a.out_sb, a.out_sh);
  const long long stats = stats_row(a);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    T* drow = dq + (long long)rows[r] * a.out_ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        drow[nd * 8 + 2 * t + c] = from_f<T>(acc[nd][2 * r + c] * a.scale);
    if (t == 0) {
      a.lse[stats + rows[r]] = lse[r];
      a.delta[stats + rows[r]] = delta[r];
    }
  }
}

// The dkv body on the tensor cores: one block per (key tile, head, batch)
// loops over the query tiles with the rows' lse and delta. Warp w owns keys
// k0 + 16w .. + 15; per query tile S^T = K Q^T and dP^T = V dO^T, so that
// P^T and dS^T come out key-major, as the A operands of
// dV += (keep . P)^T dO * drop_scale and dK += dS^T Q; a key's dbias
// partial is the row sum of its dS^T. The caller resolves the layout, as
// for attn_tiles.cuh's dkv_block, whose arguments it takes (and the copy
// path): qb, kb, vb (rows in_ss apart), dob (rows do_ss apart), dkb and
// dvb (rows d_ss apart) point at row 0 of this block's head; stats,
// dstats and part_row at its [S] rows of the fp32 [B, H, S] lse, delta
// and dbias partial (part_row may be null).
template <typename T, int D, typename A>
__device__ __forceinline__ void dkv_mma_block(
    void* smem, const T* __restrict__ qb, const T* __restrict__ kb,
    const T* __restrict__ vb, long long in_ss, const T* __restrict__ dob,
    long long do_ss, const float* __restrict__ brow, T* __restrict__ dkb,
    T* __restrict__ dvb, long long d_ss, const float* __restrict__ stats,
    const float* __restrict__ dstats, float* __restrict__ part_row,
    const A& a, bool async) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr int KG = mma::ROWS / 8;  // keep bytes of a query row
  constexpr bool EX = mma::exact_tf32<T>();

  T* sK = static_cast<T*>(smem);
  T* sV = sK + mma::ROWS * LDT;
  T* sQD = sV + mma::ROWS * LDT;  // stage s: Q, then dO, at s STAGE
  float* sStat = reinterpret_cast<float*>(sQD + Tl::STAGES * Tl::STAGE);
  unsigned char* sM = reinterpret_cast<unsigned char*>(
      sStat + Tl::STAGES * 2 * BS);  // [BS][KG]

  const int S = a.S;
  const int k0 = blockIdx.x * mma::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_qt = (S + BS - 1) / BS;
  // causal: query tiles wholly above key k0 see none of this tile's keys
  const int qt0 = a.causal ? k0 / BS : 0;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Dropout& dr = a.dr;
  auto load_q = [&](int qt) {
    const int st = (qt - qt0) & 1;
    mma::load_stage<T, D, BS>(sQD + st * Tl::STAGE, qb, in_ss, dob, do_ss,
                              qt * BS, S, tid, async);
    mma::load_floats<BS>(sStat + st * 2 * BS, stats, dstats, qt * BS, S,
                         tid);  // lse, then delta
  };
  mma::load_tile<T, D, mma::ROWS>(sK, kb, in_ss, k0, S, tid, async);
  mma::load_tile<T, D, mma::ROWS>(sV, vb, in_ss, k0, S, tid, async);
  load_q(qt0);
  mma::commit_async();

  const int keys[2] = {k0 + w * 16 + g, k0 + w * 16 + g + 8};
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kbias[r] = (brow && keys[r] < S) ? brow[keys[r]] : 0.f;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + 1 < n_qt) load_q(qt + 1);
    mma::commit_async();
    fill_mask<BS, KG, mma::THREADS>(sM, dr, qt * BS, k0, h, b, tid);
    mma::wait_async<1>();
    __syncthreads();
    const int st = (qt - qt0) & 1;
    const T* sQ = sQD + st * Tl::STAGE;
    const T* sDO = sQ + BS * LDT;
    const float* sLse = sStat + st * 2 * BS;
    const float* sDelta = sLse + BS;

    float s[NB][4], dp[NB][4];  // S^T = K Q^T, dP^T = V dO^T
    mma::tile_products<D, NB, LDT, EX>(s, dp, sK, sQ, sV, sDO, w, lane);
    // query i = qt BS + 8 nb + 2t + (e & 1) of key keys[e >> 1]; its keep
    // bit is bit g of byte (i - qt BS) KG + 2w + (e >> 1)
    const int q0 = qt * BS;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, il = nb * 8 + 2 * t + (e & 1), i = q0 + il;
        float p = 0.f;  // rows past the end and keys past it add nothing
        if (i < S && keys[r] < S) {
          float sc = s[nb][e] * a.scale + kbias[r];
          if (a.causal && keys[r] > i) sc = NEG_INF;
          p = expf(sc - sLse[il]);
        }
        const bool keep =
            !dr.use_mask || ((sM[il * KG + 2 * w + r] >> g) & 1);
        const float ds =
            p * ((keep ? dp[nb][e] * dr.scale : 0.f) - sDelta[il]);
        s[nb][e] = keep ? p * dr.scale : 0.f;  // (keep . P)^T, scaled
        dp[nb][e] = ds;                        // dS^T
        db[r] += ds;
      }
    mma::add_product<D, NB, LDT, EX>(dv, s, sDO, lane);  // dV += P^T dO
    mma::add_product<D, NB, LDT, EX>(dk, dp, sQ, lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with the stage loaded next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dbr = row_sum4(db[r]);  // the key's four lanes
    if (keys[r] >= S) continue;
    T* krow = dkb + (long long)keys[r] * d_ss;
    T* vrow = dvb + (long long)keys[r] * d_ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        krow[nd * 8 + 2 * t + c] = from_f<T>(dk[nd][2 * r + c] * a.scale);
        vrow[nd * 8 + 2 * t + c] = from_f<T>(dv[nd][2 * r + c]);
      }
    if (part_row && t == 0) part_row[keys[r]] = dbr;
  }
}

// backward, kernel 2: dk, dv and the per-head dbias partial
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2)
attn_bwd_dkv_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  const long long head = stats_row(a);
  dkv_mma_block<T, D>(smem4, head_of<T>(a.q, a.in_sb, a.in_sh),
                      head_of<T>(a.k, a.in_sb, a.in_sh),
                      head_of<T>(a.v, a.in_sb, a.in_sh), a.in_ss,
                      head_of<T>(a.dout, a.do_sb, a.do_sh), a.do_ss,
                      a.bias ? a.bias + (long long)blockIdx.z * a.S : nullptr,
                      head_of<T>(a.dk, a.out_sb, a.out_sh),
                      head_of<T>(a.dv, a.out_sb, a.out_sh), a.out_ss,
                      a.lse + head, a.delta + head,
                      a.dbias_part ? a.dbias_part + head : nullptr, a,
                      a.async_copy != 0);
}

template <typename T, int D>
struct Fwd {
  static constexpr size_t smem = Layout<D>::fwd;
  static const void* fn() { return (const void*)attn_fwd_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_fwd_kernel<T, D><<<grid, THREADS, smem, st>>>(a);
  }
};

// dispatch's grid tiles the sequence by attn::BM rows
static_assert(mma::ROWS == BM, "the backward's resident tiles are BM rows");

template <typename T, int D>
struct BwdDq {
  static constexpr int threads = mma::THREADS;
  static constexpr size_t smem = BwdSmem<T, D>::dq;
  static const void* fn() { return (const void*)attn_bwd_dq_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_bwd_dq_kernel<T, D><<<grid, threads, smem, st>>>(a);
  }
};

template <typename T, int D>
struct BwdDkv {
  static constexpr int threads = mma::THREADS;
  static constexpr size_t smem = BwdSmem<T, D>::dkv;
  static const void* fn() { return (const void*)attn_bwd_dkv_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_bwd_dkv_kernel<T, D><<<grid, threads, smem, st>>>(a);
  }
};

HeadArgs make_args(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, void* out, void* dk,
                   void* dv, float* lse, float* delta, float* dbias_part,
                   int B, int S, int H, const long long* strides, float scale,
                   float drop_scale, int causal, int use_mask, unsigned seed0,
                   unsigned seed1, unsigned threshold) {
  const long long* s = strides;
  return HeadArgs{q, k, v, bias, dout, out, dk, dv, lse, delta, dbias_part,
                  B, S, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                  s[8], scale, causal,
                  make_dropout(use_mask, seed0, seed1, threshold, drop_scale),
                  0};
}

// The backward's copy path: 16-byte cp.async where q, k, v and dout and
// their six strides keep every head row 16-byte aligned, else synchronous
// element copies (the outputs are stored element by element either way).
int rows_aligned(const HeadArgs& a, const long long* strides, int dtype) {
  return mma::rows_aligned(a.q, a.k, a.v, a.dout, strides, 6,
                           dtype == 1 ? 2 : 4);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, out, dq, dk and dv
// alike). bias may be null (all keys kept). strides: a host array of nine
// element strides (batch, head, row) of q/k/v, of dout and of out/dq/dk/dv
// in that order; every last dim is contiguous. lse and delta are fp32
// [B, H, S] scratch written by bwd_dq and read by bwd_dkv, which must run
// after it on the same stream; dbias_part, fp32 [B, H, S], may be null.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* bias, void* out,
    int B, int S, int H, int D, const long long* strides, float scale,
    float drop_scale, int causal, int use_mask, unsigned seed0,
    unsigned seed1, unsigned threshold, int dtype, void* stream) {
  const HeadArgs a = make_args(q, k, v, bias, nullptr, out, nullptr, nullptr,
                               nullptr, nullptr, nullptr, B, S, H, strides,
                               scale, drop_scale, causal, use_mask, seed0,
                               seed1, threshold);
  return dispatch<Fwd>(dtype, D, a, stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, void* dq, float* lse, float* delta, int B, int S, int H,
    int D, const long long* strides, float scale, float drop_scale,
    int causal, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  HeadArgs a = make_args(q, k, v, bias, dout, dq, nullptr, nullptr, lse,
                         delta, nullptr, B, S, H, strides, scale, drop_scale,
                         causal, use_mask, seed0, seed1, threshold);
  a.async_copy = rows_aligned(a, strides, dtype);
  return dispatch<BwdDq>(dtype, D, a, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, void* dk, void* dv, float* lse, float* delta,
    float* dbias_part, int B, int S, int H, int D, const long long* strides,
    float scale, float drop_scale, int causal, int use_mask, unsigned seed0,
    unsigned seed1, unsigned threshold, int dtype, void* stream) {
  HeadArgs a = make_args(q, k, v, bias, dout, nullptr, dk, dv, lse, delta,
                         dbias_part, B, S, H, strides, scale, drop_scale,
                         causal, use_mask, seed0, seed1, threshold);
  a.async_copy = rows_aligned(a, strides, dtype);
  return dispatch<BwdDkv>(dtype, D, a, stream);
}

// The blocks of a backward kernel (which: 0 = dq, 1 = dkv) that fit on
// one SM of the current device, and the dynamic shared memory each block
// takes, for a dtype code and head dim: a report of the build, which no
// launch reads.
extern "C" int flash_attention_bwd_occupancy(int which, int dtype, int D,
                                             int* blocks, int* smem_bytes) {
  return which == 0 ? occupancy<BwdDq>(dtype, D, blocks, smem_bytes)
                    : occupancy<BwdDkv>(dtype, D, blocks, smem_bytes);
}
