// KV-tiled attention with a saved row logsumexp, forward and backward, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels paddle_tpu/kernels/flash_tiled.py: _fwd_kernel
// (launched by flash_tiled_fwd), _dkv_kernel and _dq_kernel (both
// launched by flash_tiled_bwd), which carry every attention longer than
// the whole-row kernel's cap of 1024 (causal GPT at S = 2048). The math is
// attn_tiles.cuh's, as for flash_attention.cu, and so is the addressing:
// q, k and v are [B, H, S, D] views given by their strides, the packed
// projection qkv[B, S, 3*H*D] (fused_qkv_attention) and separate 4-D
// tensors (fused_multihead_attention past S = 1024) alike. What the tiled
// trio adds is the saved statistics:
//
//   tiled_fwd: one block per (query tile, head, batch) streams the key
//     tiles through shared memory with an online softmax and writes, beside
//     the output, the row logsumexp L = m + log(l) of the softmax before
//     dropout to an fp32 [B, H, S] tensor.
//   tiled_dq: one block per (query tile, head, batch). It never re-runs the
//     forward: delta_i = rowsum(dO_i . out_i) comes from the saved output
//     (written to a [B, H, S] scratch for tiled_dkv), p = exp(s - L) from
//     the saved L, and one pass over the key tiles forms
//     dS = p (dp - delta) and dq = scale * dS k.
//   tiled_dkv: one block per (key tile, head, batch) loops over the query
//     tiles with L and delta: dk, dv, and, when asked, per-head column sums
//     of dS that sum_partials.cu adds over heads in a fixed order.
//
// Tiles wholly above the causal diagonal are skipped in all three. The
// dropout mask is philox.cuh's, keyed by (b, h, row, col), so the three
// kernels, the whole-row kernels and the plain versions all draw one mask
// whatever their tiling. bf16 inputs are widened to fp32 in shared memory,
// so the exp tail runs in fp32 for both dtypes.
//
// What bounds it on the H100: at B=4, S=2048, H=12, D=64, causal, each
// kernel owns 25.8 GFLOP of products against ~0.1 GB of bytes, 250 flops
// a byte: bounded by operations (0.385 ms at 67 TFLOP/s fp32). This first
// version runs fp32 on the CUDA cores; tensor cores (wgmma), TMA and warp
// specialisation are later work.

#include "attn_tiles.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) tiled_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  view_fwd<T, D>(reinterpret_cast<float*>(smem4), a, a.lse);
}

// ---------------------------------------------------------------------------
// dq: given each row's lse and delta, one pass over the key tiles
// recomputes p = exp(s - lse), forms dS = p (dp - delta) (dp = dO v^T,
// masked and scaled as the forward scaled p) and accumulates
// dq = scale * dS k into acc. sQ and sDO hold the block's query rows; kb
// and vb point at row 0 of the block's head in k and v.
// ---------------------------------------------------------------------------

template <typename T, int D>
__device__ __forceinline__ void dq_pass(float* acc, float* smem,
                                        const T* __restrict__ kb,
                                        const T* __restrict__ vb,
                                        const float* __restrict__ bias,
                                        const Args& a, float lse,
                                        float delta) {
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int JPT = BN / TPR;
  constexpr int CHUNKS = D / (4 * TPR);

  float* sQ = smem;
  float* sDO = sQ + BM * LD;
  float* sK = sDO + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;
  unsigned char* sM = reinterpret_cast<unsigned char*>(sP + BM * PLD);

  const int S = a.S;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int row = q0 + r;
  const Dropout& dr = a.dr;
  const float* brow = bias ? bias + (long long)b * S : nullptr;

#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] = 0.f;
  const int n_tiles = key_tiles(q0, S, a.causal);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, kb, a.in_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, vb, a.in_ss, k0, S, tid);
    fill_mask(sM, dr, q0, k0, h, b, tid);
    __syncthreads();

    float sc[JPT], dpv[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    row_dots<D, JPT>(dpv, sDO + r * LD, sV, t);
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      const float p = expf(
          score(sc[jj], a.scale, brow, row, k0 + jl, S, a.causal) - lse);
      const float dp = kept(sM, dr.use_mask, r, jl) ? dpv[jj] * dr.scale : 0.f;
      sP[r * PLD + jl] = p * (dp - delta);
    }
    __syncwarp();
    accumulate_rows<D>(acc, sP + r * PLD, sK, t);
  }
}

template <typename T, int D>
__device__ __forceinline__ void dq_block(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const T* __restrict__ dout, const T* __restrict__ fwd_out,
    const float* __restrict__ lse_in, T* __restrict__ dq,
    float* __restrict__ delta_out, const Args& a) {
  constexpr int LD = Layout<D>::LD;
  constexpr int CHUNKS = D / (4 * TPR);

  float* sQ = smem;
  float* sDO = sQ + BM * LD;

  const int S = a.S, H = a.H;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int row = q0 + r;

  const long long in = (long long)b * a.in_sb + (long long)h * a.in_sh;
  load_rows<T, D, BM>(sQ, q + in, a.in_ss, q0, S, tid);
  load_rows<T, D, BM>(sDO, dout + (long long)b * a.do_sb +
                               (long long)h * a.do_sh,
                      a.do_ss, q0, S, tid);
  __syncthreads();

  // delta = rowsum(dO . out) from the saved output; rows past the end get
  // lse = inf, so p = 0 there
  float lse = INFINITY, part = 0.f;
  if (row < S) {
    const T* orow = fwd_out + (long long)b * a.fo_sb +
                    (long long)row * a.fo_ss + (long long)h * a.fo_sh;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (k * TPR + t) * 4 + u;
        part = fmaf(sDO[r * LD + c], to_f(orow[c]), part);
      }
    }
    lse = lse_in[((long long)b * H + h) * S + row];
  }
  const float delta = row_sum4(part);

  float acc[4 * CHUNKS];
  dq_pass<T, D>(acc, smem, k + in, v + in, bias, a, lse, delta);

  if (row < S) {
    T* drow = dq + (long long)b * a.out_sb + (long long)row * a.out_ss +
              (long long)h * a.out_sh;
    store_cols<T, D>(drow, acc, a.scale, t);
    if (t == 0) delta_out[((long long)b * H + h) * S + row] = delta;
  }
}

// two blocks to an SM: capped at 128 registers (a few spill), the dq kernel
// runs faster than uncapped, one block to an SM
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) tiled_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  dq_block<T, D>(reinterpret_cast<float*>(smem4),
                 static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                 static_cast<const T*>(a.v), a.bias,
                 static_cast<const T*>(a.dout),
                 static_cast<const T*>(a.fwd_out), a.lse,
                 static_cast<T*>(a.out), a.delta, a);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) tiled_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  view_dkv<T, D>(reinterpret_cast<float*>(smem4), a);
}

#define TILED_KERNEL(NAME, KERNEL, SMEM)                                     \
  template <typename T, int D>                                               \
  struct NAME {                                                              \
    static constexpr size_t smem = Layout<D>::SMEM;                          \
    static const void* fn() { return (const void*)KERNEL<T, D>; }            \
    static void launch(dim3 grid, cudaStream_t st, const Args& a) {          \
      KERNEL<T, D><<<grid, THREADS, smem, st>>>(a);                          \
    }                                                                        \
  };

TILED_KERNEL(Fwd, tiled_fwd_kernel, fwd)
TILED_KERNEL(Dq, tiled_dq_kernel, dq)
TILED_KERNEL(Dkv, tiled_dkv_kernel, dkv)

Args make_args(const void* q, const void* k, const void* v,
               const float* bias, const void* dout, const void* fwd_out,
               void* out, void* dk, void* dv, float* lse, float* delta,
               float* dbias_part, int B, int S, int H,
               const long long* s, float scale, float drop_scale,
               int causal, int use_mask, unsigned seed0, unsigned seed1,
               unsigned threshold) {
  return Args{q, k, v, bias, dout, fwd_out, out, dk, dv, lse, delta,
              dbias_part, B, S, H, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
              s[7], s[8], s[9], s[10], s[11], scale, causal,
              make_dropout(use_mask, seed0, seed1, threshold, drop_scale)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, out, dq, dk and dv
// alike). q, k and v are [B, H, S, D] views sharing their strides (the
// packed projection's sections or separate 4-D tensors), as are out, dq,
// dk and dv. strides: a host array of twelve element strides (batch,
// head, row) of q/k/v, of dout, of out/dq/dk/dv and of the forward's saved
// output, in that order; every last dim is contiguous. bias may be null
// (all keys kept). lse is fp32 [B, H, S], written by the forward and read
// by both backward kernels; delta, fp32 [B, H, S], is written by bwd_dq
// and read by bwd_dkv, which must run after it on the same stream;
// dbias_part, fp32 [B, H, S], may be null. Each returns the cudaError_t of
// its launch (0 on success).
extern "C" int flash_tiled_fwd(
    const void* q, const void* k, const void* v, const float* bias,
    void* out, float* lse, int B, int S, int H, int D,
    const long long* strides, float scale, float drop_scale, int causal,
    int use_mask, unsigned seed0, unsigned seed1, unsigned threshold,
    int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, nullptr, nullptr, out, nullptr,
                           nullptr, lse, nullptr, nullptr, B, S, H, strides,
                           scale, drop_scale, causal, use_mask, seed0, seed1,
                           threshold);
  return dispatch<Fwd>(dtype, D, a, stream);
}

extern "C" int flash_tiled_bwd_dq(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const void* fwd_out, const float* lse, void* dq,
    float* delta, int B, int S, int H, int D, const long long* strides,
    float scale, float drop_scale, int causal, int use_mask, unsigned seed0,
    unsigned seed1, unsigned threshold, int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, fwd_out, dq, nullptr,
                           nullptr, const_cast<float*>(lse), delta, nullptr,
                           B, S, H, strides, scale, drop_scale, causal,
                           use_mask, seed0, seed1, threshold);
  return dispatch<Dq>(dtype, D, a, stream);
}

extern "C" int flash_tiled_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, float* dbias_part, int B, int S, int H, int D,
    const long long* strides, float scale, float drop_scale, int causal,
    int use_mask, unsigned seed0, unsigned seed1, unsigned threshold,
    int dtype, void* stream) {
  const Args a = make_args(q, k, v, bias, dout, nullptr, nullptr, dk, dv,
                           const_cast<float*>(lse), const_cast<float*>(delta),
                           dbias_part, B, S, H, strides, scale, drop_scale,
                           causal, use_mask, seed0, seed1, threshold);
  return dispatch<Dkv>(dtype, D, a, stream);
}
