// Packed-QKV attention, forward and backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/flash_attention.py:
// _fwd_kernel_qkv (launched by _pallas_fwd_qkv) and _bwd_kernel_qkv
// (launched by _pallas_bwd_qkv): attention over a packed projection
// qkv[B, S, 3*H*D], as set out in attn_tiles.cuh, whose device code these
// kernels share with the KV-tiled ones (flash_tiled.cu).
//
// drop_scale carries fluid's dropout: 1/(1-p) under upscale_in_train and 1
// under downgrade_in_infer in training (use_mask = 1); 1-p or 1 in test
// mode (use_mask = 0). The mask is applied to the unnormalised
// exponentials and 1/rowsum to the [S, D] output rows, as the TPU kernel
// does.
//
// Forward design: one block per (query tile of BM rows, head, batch);
// the keys stream through shared memory in tiles of BN with an online
// softmax, so any S runs (the TPU kernel's whole-row [S, S] tile capped S
// at 1024). Four threads own one query row: each scores BN/4 keys of the
// tile and accumulates D/4 output columns; the row's max and sum are
// combined with two warp shuffles.
//
// Backward design (the TPU kernel holds a whole [S, S] tile per head; on
// Hopper the work splits as flash attention's backward does, with no
// float atomics):
//   bwd_dq: one block per (query tile, head, batch). Pass 1 over the key
//     tiles recomputes the row max and sum online together with
//     delta_i = sum_j p_ij dp_ij (dp = dO v^T, masked and scaled as the
//     forward scaled p). Pass 2 recomputes p, forms
//     dS = p (dp - delta) and accumulates dq = scale * dS k. It writes
//     the row lse and delta to a [B, H, S] fp32 scratch.
//   bwd_dkv: one block per (key tile, head, batch) loops over the query
//     tiles with that scratch: dv = (keep . p)^T dO * drop_scale,
//     dk = scale * dS^T q, and, when asked, the per-head column sums of
//     dS, a [B, H, S] partial that a second deterministic pass sums over
//     heads into dbias.
// Both read the packed qkv in place through its strides and write dq, dk
// and dv straight into the three sections of one packed dqkv.
//
// All arithmetic is fp32 on the CUDA cores; tensor cores (wgmma), TMA and
// warp specialisation are later work. At BERT-base shapes the work is
// about S/3 flops per input byte per row and head, above the fp32
// CUDA-core balance point: these kernels are bounded by operations, and
// the design keeps every [S, S] tile out of device memory so bytes never
// become the bound.

#include "attn_tiles.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  fwd_block<T, D>(reinterpret_cast<float*>(smem4),
                  static_cast<const T*>(a.qkv), a.bias,
                  static_cast<T*>(a.out), nullptr, a);
}

// backward, kernel 1: row statistics, delta and dq. Its own body, with the
// launch's values as separate parameters: written so, ptxas fits it in 128
// registers, two blocks to an SM; built from the shared bodies it took
// more registers, one block to an SM, and ran slower.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                   const T* __restrict__ dout, T* __restrict__ dqkv,
                   float* __restrict__ lse_out, float* __restrict__ delta_out,
                   int S, int H, long long qkv_sb, long long qkv_ss,
                   long long do_sb, long long do_ss, long long dqkv_sb,
                   long long dqkv_ss, float scale, int causal, Dropout dr) {
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int JPT = BN / TPR;
  constexpr int CHUNKS = D / (4 * TPR);

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + BM * LD;
  float* sK = sDO + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  unsigned char* sM = reinterpret_cast<unsigned char*>(sP + BM * PLD);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int row = q0 + r;
  const int HD = H * D;

  const T* base = qkv + (long long)b * qkv_sb + (long long)h * D;
  const float* brow = bias ? bias + (long long)b * S : nullptr;
  load_rows<T, D, BM>(sQ, base, qkv_ss, q0, S, tid);
  load_rows<T, D, BM>(sDO, dout + (long long)b * do_sb + (long long)h * D,
                      do_ss, q0, S, tid);

  const int n_tiles = key_tiles(q0, S, causal);

  // pass 1: online max m, sum l and sum_j e_ij dp_ij
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, base + HD, qkv_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, base + 2 * HD, qkv_ss, k0, S, tid);
    fill_mask(sM, dr, q0, k0, h, b, tid);
    __syncthreads();

    float sc[JPT], dpv[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    row_dots<D, JPT>(dpv, sDO + r * LD, sV, t);
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      sc[jj] = score(sc[jj], scale, brow, row, k0 + t + TPR * jj, S, causal);
      tile_max = fmaxf(tile_max, sc[jj]);
    }
    const float m_new = fmaxf(m, row_max4(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.f, asum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      const float e = expf(sc[jj] - m_new);
      const float dp = kept(sM, dr.use_mask, r, jl) ? dpv[jj] * dr.scale : 0.f;
      psum += e;
      asum = fmaf(e, dp, asum);
    }
    l = l * alpha + row_sum4(psum);
    a = a * alpha + row_sum4(asum);
    m = m_new;
  }
  const float lse = m + logf(l);
  const float delta = a / l;

  // pass 2: dS = p (dp - delta), dq = scale * dS k
  float acc[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, base + HD, qkv_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, base + 2 * HD, qkv_ss, k0, S, tid);
    fill_mask(sM, dr, q0, k0, h, b, tid);
    __syncthreads();

    float sc[JPT], dpv[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    row_dots<D, JPT>(dpv, sDO + r * LD, sV, t);
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      const float p =
          expf(score(sc[jj], scale, brow, row, k0 + jl, S, causal) - lse);
      const float dp = kept(sM, dr.use_mask, r, jl) ? dpv[jj] * dr.scale : 0.f;
      sP[r * PLD + jl] = p * (dp - delta);
    }
    __syncwarp();
    accumulate_rows<D>(acc, sP + r * PLD, sK, t);
  }

  if (row < S) {
    T* drow = dqkv + (long long)b * dqkv_sb + (long long)row * dqkv_ss +
              (long long)h * D;
    store_cols<T, D>(drow, acc, scale, t);
    if (t == 0) {
      const long long o = ((long long)b * H + h) * S + row;
      lse_out[o] = lse;
      delta_out[o] = delta;
    }
  }
}

// backward, kernel 2: dk, dv and the per-head dbias partial
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  dkv_block<T, D>(reinterpret_cast<float*>(smem4),
                  static_cast<const T*>(a.qkv), a.bias,
                  static_cast<const T*>(a.dout), static_cast<T*>(a.out),
                  a.lse, a.delta, a.dbias_part, a);
}

#define ATTN_KERNEL(NAME, KERNEL, SMEM)                                      \
  template <typename T, int D>                                               \
  struct NAME {                                                              \
    static constexpr size_t smem = Layout<D>::SMEM;                          \
    static const void* fn() { return (const void*)KERNEL<T, D>; }            \
    static void launch(dim3 grid, cudaStream_t st, const Args& a) {          \
      KERNEL<T, D><<<grid, THREADS, smem, st>>>(a);                          \
    }                                                                        \
  };

ATTN_KERNEL(Fwd, attn_fwd_kernel, fwd)
ATTN_KERNEL(BwdDkv, attn_bwd_dkv_kernel, dkv)

template <typename T, int D>
struct BwdDq {
  static constexpr size_t smem = Layout<D>::dq;
  static const void* fn() { return (const void*)attn_bwd_dq_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const Args& a) {
    attn_bwd_dq_kernel<T, D><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(a.qkv), a.bias, static_cast<const T*>(a.dout),
        static_cast<T*>(a.out), a.lse, a.delta, a.S, a.H, a.qkv_sb, a.qkv_ss,
        a.do_sb, a.do_ss, a.out_sb, a.out_ss, a.scale, a.causal, a.dr);
  }
};

Args make_args(const void* qkv, const float* bias, const void* dout,
               void* out, float* lse, float* delta, float* dbias_part, int B,
               int S, int H, long long qkv_sb, long long qkv_ss,
               long long do_sb, long long do_ss, long long out_sb,
               long long out_ss, float scale, float drop_scale, int causal,
               int use_mask, unsigned seed0, unsigned seed1,
               unsigned threshold) {
  return Args{qkv, bias, dout, nullptr, out, lse, delta, dbias_part,
              B, S, H, qkv_sb, qkv_ss, do_sb, do_ss, out_sb, out_ss, 0, 0,
              scale, causal,
              make_dropout(use_mask, seed0, seed1, threshold, drop_scale)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (qkv, dout, out and dqkv alike). bias may
// be null (all keys kept). Strides are in elements; every last dim is
// contiguous. lse and delta are fp32 [B, H, S] scratch written by bwd_dq
// and read by bwd_dkv; dbias_part, fp32 [B, H, S], may be null. Each
// returns the cudaError_t of its launch (0 on success).
extern "C" int flash_attention_qkv_fwd(
    const void* qkv, const float* bias, void* out, int B, int S, int H,
    int D, long long qkv_sb, long long qkv_ss, long long out_sb,
    long long out_ss, float scale, float drop_scale, int causal,
    int use_mask, unsigned seed0, unsigned seed1, unsigned threshold,
    int dtype, void* stream) {
  const Args a = make_args(qkv, bias, nullptr, out, nullptr, nullptr, nullptr,
                           B, S, H, qkv_sb, qkv_ss, 0, 0, out_sb, out_ss,
                           scale, drop_scale, causal, use_mask, seed0, seed1,
                           threshold);
  return dispatch<Fwd>(dtype, D, a, stream);
}

extern "C" int flash_attention_qkv_bwd_dq(
    const void* qkv, const float* bias, const void* dout, void* dqkv,
    float* lse, float* delta, int B, int S, int H, int D, long long qkv_sb,
    long long qkv_ss, long long do_sb, long long do_ss, long long dqkv_sb,
    long long dqkv_ss, float scale, float drop_scale, int causal,
    int use_mask, unsigned seed0, unsigned seed1, unsigned threshold,
    int dtype, void* stream) {
  const Args a = make_args(qkv, bias, dout, dqkv, lse, delta, nullptr, B, S,
                           H, qkv_sb, qkv_ss, do_sb, do_ss, dqkv_sb, dqkv_ss,
                           scale, drop_scale, causal, use_mask, seed0, seed1,
                           threshold);
  return dispatch<BwdDq>(dtype, D, a, stream);
}

extern "C" int flash_attention_qkv_bwd_dkv(
    const void* qkv, const float* bias, const void* dout, void* dqkv,
    float* lse, float* delta, float* dbias_part, int B, int S, int H, int D,
    long long qkv_sb, long long qkv_ss, long long do_sb, long long do_ss,
    long long dqkv_sb, long long dqkv_ss, float scale, float drop_scale,
    int causal, int use_mask, unsigned seed0, unsigned seed1,
    unsigned threshold, int dtype, void* stream) {
  const Args a = make_args(qkv, bias, dout, dqkv, lse, delta, dbias_part, B,
                           S, H, qkv_sb, qkv_ss, do_sb, do_ss, dqkv_sb,
                           dqkv_ss, scale, drop_scale, causal, use_mask,
                           seed0, seed1, threshold);
  return dispatch<BwdDkv>(dtype, D, a, stream);
}
