// The attention bodies on the tensor cores: the backward bodies, shared
// by the whole-row pair (#3/#6, flash_attention.cu: attn_bwd_dq_kernel,
// attn_bwd_dkv_kernel) and the KV-tiled pair (#9/#8, flash_tiled.cu:
// tiled_dq_kernel, tiled_dkv_kernel), and the forward body fwd_mma_block,
// shared by the whole-row forward (#1/#5, flash_attention.cu:
// attn_fwd_kernel), the KV-tiled forward (#7, flash_tiled.cu:
// tiled_fwd_kernel; both policy WholeRow, through fwd_view) and the
// ring-block forward (#12, ring_block.cu: ring_fwd_kernel, policy
// RingFwd): mma_tiles.cuh's
// 3xTF32 products, 4 warps of 16 rows over a resident tile of mma::ROWS
// rows, the other side streamed through two cp.async stages of BS rows;
// attn_tiles.cuh's keep mask and row reductions.
//
// dq_mma_block and dkv_view take a launch's [B, H, S, D] views by the
// fields HeadArgs (flash_attention.cu) and Args (attn_tiles.cuh) share:
// q, k, v (strides in_*), dout (do_*), the outputs (out_*: dq in out, or
// dk and dv), an fp32 key bias [B, S] or null, the fp32 [B, H, S] lse,
// delta and dbias partial (null when not asked), S, H, scale, causal, the
// Dropout and async_copy (load_tile's copy path).
//
//   dq_mma_block<SAVED = false> (whole-row): the key tiles stream twice,
//     pass 1 recomputing each row's max, sum and delta online, and the
//     block writes lse and delta for the dkv kernel;
//   dq_mma_block<SAVED = true> (tiled): the rows' lse comes from the
//     forward and delta = rowsum(dO . out) from its saved output (A's
//     fwd_out, fo_*), staged before the stream; one pass, and the block
//     writes delta for the dkv kernel;
//   dkv_mma_block: one block per key tile loops over the query tiles with
//     the rows' lse and delta, SAVED as the dq kernel that wrote delta.
//
// Both dq flavours run one per-tile step: S = Q K^T and dP = dO V^T
// (mma::tile_products), the scale, key bias, causal cut, sequence end and
// keep bits at the accumulators' fragment coordinates, then
// p = exp(s - lse), dS = p (dp - delta) and dQ += dS K (mma::add_product).
// With SAVED, delta is no longer dp's own row sum, so the truncation of
// the S^T and dP^T chains stays in dS^T; dkv then sums them a step of 8
// columns at a time (tile_products<STEPWISE>), as dbias adds dS up over
// the rows. dq's sum weights dS by the keys, whose signs vary, so its
// chain's bias does not add up there.
//
// fwd_mma_block streams the key tiles once with an online softmax: S =
// Q K^T (mma::tile_product), the policy's score (scale, key bias, causal
// cut, sequence end; or liveness at the ring's offsets), the row max and
// sum in registers, O rescaled and O += P V (mma::add_product). A bf16 P
// would change the plain version's arithmetic, so P stays fp32 and is
// split; bf16 K and V are TF32 already (1 product for S, 2 for P V).

#pragma once

#include "attn_tiles.cuh"
#include "mma_tiles.cuh"

namespace attn {

// dispatch's grid tiles the sequence by BM rows: one resident tile a block
static_assert(mma::ROWS == BM, "the backward's resident tiles are BM rows");

// row 0 of head h of batch b in a [B, H, S, D] view (strides sb, sh);
// b and h unsigned, as blockIdx's are (a signed index gave the forward
// kernel other, slower code)
template <typename T>
__device__ __forceinline__ const T* head_of(const void* p, long long sb,
                                            long long sh, unsigned b,
                                            unsigned h) {
  return static_cast<const T*>(p) + (long long)b * sb + (long long)h * sh;
}

template <typename T>
__device__ __forceinline__ T* head_of(void* p, long long sb, long long sh,
                                      unsigned b, unsigned h) {
  return static_cast<T*>(p) + (long long)b * sb + (long long)h * sh;
}

// The tile of the sequence (dq: query tile; dkv: key tile), head and
// batch of this block, on dispatch's grid (tiles, H, B). Under the causal
// mask tiles carry unequal work, and the card hands out blocks in order
// of their linear index (x fastest): the heaviest tile of each head
// first (for dq the last query tile, LAST_HEAVIEST; for dkv the first
// key tile), and with GLOBAL rank r = index / (B H) takes tile r of every
// head before any head's tile r + 1: heaviest first within each head
// alone leaves the last heads' heaviest tiles to run on after the rest
// of a deep grid is done. The tiled pair (causal GPT) and the forwards
// (FWD_GLOBAL) take GLOBAL; the whole-row pair keeps the order within
// each head, as the global branch made its non-causal kernels (BERT,
// ERNIE) slower (PERF.md).
struct BlockTile {
  unsigned tile, h, b;
};

template <bool LAST_HEAVIEST, bool GLOBAL>
__device__ __forceinline__ BlockTile block_tile(bool causal) {
  if (GLOBAL && causal) {
    const unsigned heads = gridDim.y * gridDim.z;
    const unsigned lin =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    const unsigned rank = lin / heads, bh = lin % heads;
    return {LAST_HEAVIEST ? gridDim.x - 1 - rank : rank, bh % gridDim.y,
            bh / gridDim.y};
  }
  return {LAST_HEAVIEST && causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x,
          blockIdx.y, blockIdx.z};
}

// this block's head in the fp32 [B, H, S] statistics
template <typename A>
__device__ __forceinline__ long long stats_row(const A& a,
                                               const BlockTile& bt) {
  return ((long long)bt.b * a.H + bt.h) * a.S;
}

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

// dq (and delta) of one query tile. Warp w owns query rows q0 + 16w ..
// + 15; a thread holds rows g and g + 8 of them (lane = 4g + t) at the
// accumulator columns 8 nb + 2t, + 1 of each key tile. Under the causal
// mask the heaviest query tiles start first (block_tile), and key tiles
// wholly above the diagonal are never visited.
template <typename T, int D, bool SAVED, typename A>
__device__ __forceinline__ void dq_mma_block(void* smem, const A& a) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr bool EX = mma::exact_tf32<T>();
  static_assert(Tl::STAGE >= mma::ROWS * LDT,
                "a stage holds the saved output's tile");

  T* sQ = static_cast<T*>(smem);
  T* sDO = sQ + mma::ROWS * LDT;
  T* sKV = sDO + mma::ROWS * LDT;  // stage s: K, then V, at s STAGE
  float* sBias = reinterpret_cast<float*>(sKV + Tl::STAGES * Tl::STAGE);
  unsigned char* sM = reinterpret_cast<unsigned char*>(
      sBias + Tl::STAGES * BS);  // [mma::ROWS][NB]

  const int S = a.S;
  const BlockTile bt = block_tile<true, SAVED>(a.causal);
  const int q0 = bt.tile * mma::ROWS;
  const int h = bt.h, b = bt.b;
  const int n_tiles = key_tiles<BS>(q0, S, a.causal);
  // the stream: the key tiles once (SAVED), else twice (pass 1, pass 2)
  const int n_stream = SAVED ? n_tiles : 2 * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool async = a.async_copy;
  const Dropout& dr = a.dr;
  const T* kb = head_of<T>(a.k, a.in_sb, a.in_sh, bt.b, bt.h);
  const T* vb = head_of<T>(a.v, a.in_sb, a.in_sh, bt.b, bt.h);
  const float* brow = a.bias ? a.bias + (long long)b * S : nullptr;
  const long long stats = stats_row(a, bt);
  // stream position i: key tile i of pass 1, then tile i - n of pass 2
  auto load_kv = [&](int i) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * BS;
    mma::load_stage<T, D, BS>(sKV + (i & 1) * Tl::STAGE, kb, a.in_ss, vb,
                              a.in_ss, k0, S, tid, async);
    if (brow)
      mma::load_floats<BS>(sBias + (i & 1) * BS, brow, nullptr, k0, S, tid);
  };
  mma::load_tile<T, D, mma::ROWS>(
      sQ, head_of<T>(a.q, a.in_sb, a.in_sh, bt.b, bt.h), a.in_ss, q0, S,
      tid, async);
  mma::load_tile<T, D, mma::ROWS>(
      sDO, head_of<T>(a.dout, a.do_sb, a.do_sh, bt.b, bt.h), a.do_ss, q0,
      S, tid, async);

  const int rows[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  const int local[2] = {w * 16 + g, w * 16 + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};  // sum_j e_ij dp_ij, rescaled as l is
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if constexpr (SAVED) {
    // the saved output's rows into stage 1, which the stream first fills
    // at its second tile; delta over the row's four lanes
    T* sO = sKV + Tl::STAGE;
    mma::load_tile<T, D, mma::ROWS>(
        sO, head_of<T>(a.fwd_out, a.fo_sb, a.fo_sh, bt.b, bt.h), a.fo_ss,
        q0, S, tid, async);
    mma::commit_async();
    load_kv(0);
    mma::commit_async();
    mma::wait_async<1>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        const int c = 4 * j + t;
        part = fmaf(mma::widen(sDO[local[r] * LDT + c]),
                    mma::widen(sO[local[r] * LDT + c]), part);
      }
      delta[r] = row_sum4(part);
      // rows past the end: p = exp(s - inf) = 0
      lse[r] = rows[r] < S ? a.lse[stats + rows[r]] : INFINITY;
    }
    __syncthreads();  // every warp is done with stage 1
  } else {
    load_kv(0);
    mma::commit_async();
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int i = 0; i < n_stream; ++i) {
    const bool pass2 = SAVED || i >= n_tiles;
    const int k0 = (i < n_tiles ? i : i - n_tiles) * BS;
    if (i + 1 < n_stream) load_kv(i + 1);
    mma::commit_async();  // possibly empty: one group an iteration
    fill_mask<mma::ROWS, NB, mma::THREADS>(sM, dr, q0, k0, h, b, tid);
    if (!SAVED && i == n_tiles) {
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

  T* dq = head_of<T>(a.out, a.out_sb, a.out_sh, bt.b, bt.h);
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
      if constexpr (!SAVED) a.lse[stats + rows[r]] = lse[r];
      a.delta[stats + rows[r]] = delta[r];
    }
  }
}

// dk, dv and the per-head dbias partial of one key tile: one block per
// (key tile, head, batch) loops over the query tiles with the rows' lse
// and delta. Warp w owns keys k0 + 16w .. + 15; per query tile
// S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come out
// key-major, as the A operands of dV += (keep . P)^T dO * drop_scale and
// dK += dS^T Q; a key's dbias partial is the row sum of its dS^T, summed
// by each thread over its columns tile after tile, then over the row's
// four lanes, in a fixed order (no float atomics). The caller (dkv_view)
// resolves the layout: qb, kb, vb (rows in_ss apart), dob (rows do_ss
// apart), dkb and dvb (rows d_ss apart) point at row 0 of the head of bt;
// stats, dstats and part_row at its [S] rows of the fp32 [B, H, S] lse,
// delta and dbias partial (part_row may be null).
template <typename T, int D, bool SAVED, typename A>
__device__ __forceinline__ void dkv_mma_block(
    void* smem, const T* __restrict__ qb, const T* __restrict__ kb,
    const T* __restrict__ vb, long long in_ss, const T* __restrict__ dob,
    long long do_ss, const float* __restrict__ brow, T* __restrict__ dkb,
    T* __restrict__ dvb, long long d_ss, const float* __restrict__ stats,
    const float* __restrict__ dstats, float* __restrict__ part_row,
    const A& a, bool async, const BlockTile& bt) {
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
  const int k0 = bt.tile * mma::ROWS;
  const int h = bt.h, b = bt.b;
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
    mma::tile_products<D, NB, LDT, EX, SAVED>(s, dp, sK, sQ, sV, sDO, w,
                                              lane);
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

// dkv_mma_block on a launch's [B, H, S, D] views (HeadArgs or Args)
template <typename T, int D, bool SAVED, typename A>
__device__ __forceinline__ void dkv_view(void* smem, const A& a) {
  const BlockTile bt = block_tile<false, SAVED>(a.causal);
  const long long head = stats_row(a, bt);
  dkv_mma_block<T, D, SAVED>(
      smem, head_of<T>(a.q, a.in_sb, a.in_sh, bt.b, bt.h),
      head_of<T>(a.k, a.in_sb, a.in_sh, bt.b, bt.h),
      head_of<T>(a.v, a.in_sb, a.in_sh, bt.b, bt.h), a.in_ss,
      head_of<T>(a.dout, a.do_sb, a.do_sh, bt.b, bt.h), a.do_ss,
      a.bias ? a.bias + (long long)bt.b * a.S : nullptr,
      head_of<T>(a.dk, a.out_sb, a.out_sh, bt.b, bt.h),
      head_of<T>(a.dv, a.out_sb, a.out_sh, bt.b, bt.h), a.out_ss,
      a.lse + head, a.delta + head,
      a.dbias_part ? a.dbias_part + head : nullptr, a, a.async_copy != 0,
      bt);
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, head, batch), Q resident, the key
// tiles streamed with an online softmax in registers
// ---------------------------------------------------------------------------

// The forwards' order of query tiles under the causal mask (block_tile):
// the heaviest first, tile rank r of every head before any head's rank
// r + 1, which on the H100 took #12 at [1, 12, 8192, 64] from 3.77 to
// 3.16 ms and #1 at GPT's recompute [8, 12, 256, 64] from 0.055 to 0.039
// ms against the order within each head (PERF.md)
constexpr bool FWD_GLOBAL = true;

// The forward's shared memory: the resident Q tile, two stages of K and V
// (BwdTiles' stream), a stage's fp32 key bias, and the keep bytes of one
// (64 query rows x BS keys) tile
template <typename T, int D>
struct FwdSmem {
  using Tl = mma::BwdTiles<T, D>;
  static constexpr size_t bytes =
      (mma::ROWS * Tl::LDT + Tl::STAGES * Tl::STAGE) * sizeof(T) +
      Tl::STAGES * Tl::BS * sizeof(float) + mma::ROWS * Tl::NB;
};

// The whole-row forward's elementwise step (#1/#5, #7): the scale, the key
// bias of the batch, the causal cut (j > i at NEG_INF) and the sequence
// end (j >= S at -inf: no weight at all); training dropout's Philox keep
// mask; out = drop_scale * (keep . e) v / l. Every row sees key 0, so its
// max is finite from the first tile on.
struct WholeRow {
  const float* bias;  // the batch's fp32 key bias [S], or null
  int S, causal;
  float scale;
  Dropout dr;
  int h, b;
  __device__ int rows() const { return S; }
  __device__ int keys() const { return S; }
  __device__ const float* key_bias() const { return bias; }
  __device__ bool masked() const { return dr.use_mask != 0; }
  template <int BS>
  __device__ int key_tiles(int q0) const {
    return attn::key_tiles<BS>(q0, S, causal);
  }
  template <int NB>
  __device__ void fill(unsigned char* sM, int q0, int k0, int tid) const {
    fill_mask<mma::ROWS, NB, mma::THREADS>(sM, dr, q0, k0, h, b, tid);
  }
  __device__ float m0() const { return -INFINITY; }
  __device__ float score(float dot, int i, int j, float bias_j) const {
    if (j >= S) return -INFINITY;
    const float s = dot * scale + bias_j;
    return (causal && j > i) ? NEG_INF : s;
  }
  __device__ float weigh(float e, int, int) const { return e; }
  __device__ float out_mul(float l) const { return dr.scale / l; }
  __device__ float lse(float m, float l) const { return m + logf(l); }
};

// The forward of one query tile on the tensor cores, shared by the
// whole-row and KV-tiled forwards (#1/#5 and #7, policy WholeRow) and the
// ring-block forward (#12, ring_block.cu's RingFwd). Warp w owns query rows q0 + 16w .. + 15;
// a thread holds rows g and g + 8 of them (lane = 4g + t) at the
// accumulator columns 8 nb + 2t, + 1 of each key tile. Per key tile:
// S = Q K^T in registers (mma::tile_product), the policy's score and
// weight at the fragment's coordinates, the row max and sum over the
// row's four lanes, O rescaled by exp(m - m_new) and O += P V with P the A
// operand as it lies (mma::add_product: the tile's product summed from
// zero, added in fp32). The row sum counts every e, kept or dropped; a
// dropped one is zeroed before P V. The caller resolves the layout: qb,
// kb, vb point at row 0 of the block's head (Q rows q_ss apart, K and V
// rows kv_ss apart), ob at row 0 of its output head (rows out_ss apart,
// stored element by element from the accumulators, so any view), lse_row
// at its [rows] fp32 logsumexp row or null. P supplies the rows and keys,
// the key bias (or null), the key tiles a query tile needs, the keep
// mask, the score, the weight, the output's multiplier and the lse.
template <typename T, int D, typename TO, typename P>
__device__ __forceinline__ void fwd_mma_block(
    void* smem, const T* __restrict__ qb, const T* __restrict__ kb,
    const T* __restrict__ vb, long long q_ss, long long kv_ss,
    TO* __restrict__ ob, long long out_ss, float* __restrict__ lse_row,
    int q0, bool async, const P& pol) {
  using Tl = mma::BwdTiles<T, D>;
  constexpr int LDT = Tl::LDT, BS = Tl::BS, NB = Tl::NB, ND = D / 8;
  constexpr bool EX = mma::exact_tf32<T>();

  T* sQ = static_cast<T*>(smem);
  T* sKV = sQ + mma::ROWS * LDT;  // stage s: K, then V, at s STAGE
  float* sBias = reinterpret_cast<float*>(sKV + Tl::STAGES * Tl::STAGE);
  unsigned char* sM = reinterpret_cast<unsigned char*>(
      sBias + Tl::STAGES * BS);  // [mma::ROWS][NB]

  const int Sq = pol.rows(), Sk = pol.keys();
  const float* brow = pol.key_bias();
  const int n_tiles = pol.template key_tiles<BS>(q0);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  auto load_kv = [&](int i) {
    mma::load_stage<T, D, BS>(sKV + (i & 1) * Tl::STAGE, kb, kv_ss, vb,
                              kv_ss, i * BS, Sk, tid, async);
    if (brow)
      mma::load_floats<BS>(sBias + (i & 1) * BS, brow, nullptr, i * BS, Sk,
                           tid);
  };
  if (n_tiles > 0) {
    mma::load_tile<T, D, mma::ROWS>(sQ, qb, q_ss, q0, Sq, tid, async);
    load_kv(0);
    mma::commit_async();
  }

  const int rows[2] = {q0 + w * 16 + g, q0 + w * 16 + g + 8};
  const int local[2] = {w * 16 + g, w * 16 + g + 8};
  float m[2] = {pol.m0(), pol.m0()}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * BS;
    if (i + 1 < n_tiles) load_kv(i + 1);
    mma::commit_async();  // possibly empty: one group an iteration
    if (pol.masked()) pol.template fill<NB>(sM, q0, k0, tid);
    mma::wait_async<1>();
    __syncthreads();
    const T* sK = sKV + (i & 1) * Tl::STAGE;
    const T* sV = sK + BS * LDT;
    const float* sB = sBias + (i & 1) * BS;

    float s[NB][4];  // S = Q K^T, then the tile's weights
    mma::tile_product<D, NB, LDT, EX>(s, sQ, sK, w, lane);
    // key j = k0 + 8 nb + 2t + (e & 1) of row rows[e >> 1]
    float mx[2] = {pol.m0(), pol.m0()};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, jl = nb * 8 + 2 * t + (e & 1);
        s[nb][e] = pol.score(s[nb][e], rows[r], k0 + jl,
                             brow ? sB[jl] : 0.f);
        mx[r] = fmaxf(mx[r], s[nb][e]);
      }
    float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], row_max4(mx[r]));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const unsigned keep[2] = {
          pol.masked() ? (unsigned)sM[local[0] * NB + nb] : 0xFFu,
          pol.masked() ? (unsigned)sM[local[1] * NB + nb] : 0xFFu};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, jl = nb * 8 + 2 * t + (e & 1);
        const float ex =
            pol.weigh(expf(s[nb][e] - m_new[r]), rows[r], k0 + jl);
        ps[r] += ex;  // the row sum counts every e, dropped or not
        s[nb][e] = ((keep[r] >> (jl & 7)) & 1) ? ex : 0.f;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - m_new[r]);
      l[r] = l[r] * alpha[r] + row_sum4(ps[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];
    mma::add_product<D, NB, LDT, EX>(acc, s, sV, lane);  // O += P V
    __syncthreads();  // every warp is done with the stage loaded next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    const float mul = pol.out_mul(l[r]);
    TO* orow = ob + (long long)rows[r] * out_ss;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        orow[nd * 8 + 2 * t + c] = from_f<TO>(acc[nd][2 * r + c] * mul);
    if (lse_row && t == 0) lse_row[rows[r]] = pol.lse(m[r], l[r]);
  }
}

// fwd_mma_block with the whole-row policy on a launch's [B, H, S, D] views
// (HeadArgs or Args): the whole-row forward (#1/#5, LSE = false) and the
// KV-tiled forward (#7, LSE: its lse row from a.lse), one block per
// (query tile, head, batch), the heaviest causal tiles first in the
// global order
template <typename T, int D, bool LSE, typename A>
__device__ __forceinline__ void fwd_view(void* smem, const A& a) {
  const BlockTile bt = block_tile<true, FWD_GLOBAL>(a.causal);
  const WholeRow pol{a.bias ? a.bias + (long long)bt.b * a.S : nullptr, a.S,
                     a.causal, a.scale, a.dr, (int)bt.h, (int)bt.b};
  fwd_mma_block<T, D, T>(
      smem, head_of<T>(a.q, a.in_sb, a.in_sh, bt.b, bt.h),
      head_of<T>(a.k, a.in_sb, a.in_sh, bt.b, bt.h),
      head_of<T>(a.v, a.in_sb, a.in_sh, bt.b, bt.h), a.in_ss, a.in_ss,
      head_of<T>(a.out, a.out_sb, a.out_sh, bt.b, bt.h), a.out_ss,
      LSE ? a.lse + stats_row(a, bt) : nullptr, (int)bt.tile * mma::ROWS,
      a.async_copy != 0, pol);
}

}  // namespace attn
