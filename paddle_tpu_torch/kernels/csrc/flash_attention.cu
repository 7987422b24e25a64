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
//     row's lse and delta to an fp32 [B, H, S] scratch. Its own body with
//     the launch's values as separate parameters, capped at 128 registers
//     so two blocks fit on an SM.
//   attn_bwd_dkv_kernel: dkv_block, one block per (key tile, head, batch):
//     dv = (keep . p)^T dO * drop_scale, dk = scale * dS^T q and, when
//     asked, the per-head column sums of dS, a [B, H, S] partial that
//     sum_partials.cu adds over heads in a fixed order (the TPU kernels
//     accumulated dbias across the sequential head axis; here blocks run
//     in no order and no float atomics are used).
//
// What bounds it on the H100: at B=32, H=12, S=512, D=64 the forward does
// 4*S*D flops per query row and head against 16*D bytes of q, k, v and out,
// ~S/4 flop a byte: above the fp32 CUDA-core balance point (67 TFLOP/s over
// 3.35 TB/s = 20), so bounded by operations (0.385 ms). All arithmetic is
// fp32 on the CUDA cores in either dtype. Tensor cores (wgmma), TMA and
// warp specialisation are later work.

#include "attn_tiles.cuh"

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

// backward, kernel 1: row statistics, delta and dq. Its own body: built
// from the shared bodies it took more registers and ran slower. With its
// three base pointers and three sets of strides, uncapped, ptxas gave it
// 170 registers (D=64), one block to an SM; capped at 128, two blocks
// fit, as for #9.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   float* __restrict__ lse_out, float* __restrict__ delta_out,
                   int S, int H, long long in_sb, long long in_sh,
                   long long in_ss, long long do_sb, long long do_sh,
                   long long do_ss, long long out_sb, long long out_sh,
                   long long out_ss, float scale, int causal, Dropout dr) {
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

  const long long in_head = (long long)b * in_sb + (long long)h * in_sh;
  const T* kb = k + in_head;
  const T* vb = v + in_head;
  const float* brow = bias ? bias + (long long)b * S : nullptr;
  load_rows<T, D, BM>(sQ, q + in_head, in_ss, q0, S, tid);
  load_rows<T, D, BM>(sDO, dout + (long long)b * do_sb + (long long)h * do_sh,
                      do_ss, q0, S, tid);

  const int n_tiles = key_tiles(q0, S, causal);

  // pass 1: online max m, sum l and sum_j e_ij dp_ij
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, kb, in_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, vb, in_ss, k0, S, tid);
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
    load_rows<T, D, BN>(sK, kb, in_ss, k0, S, tid);
    load_rows<T, D, BN>(sV, vb, in_ss, k0, S, tid);
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
    T* drow = dq + (long long)b * out_sb + (long long)h * out_sh +
              (long long)row * out_ss;
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
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  const long long head = stats_row(a);
  dkv_block<T, D>(reinterpret_cast<float*>(smem4),
                  head_of<T>(a.q, a.in_sb, a.in_sh),
                  head_of<T>(a.k, a.in_sb, a.in_sh),
                  head_of<T>(a.v, a.in_sb, a.in_sh), a.in_ss,
                  head_of<T>(a.dout, a.do_sb, a.do_sh), a.do_ss,
                  a.bias ? a.bias + (long long)blockIdx.z * a.S : nullptr,
                  head_of<T>(a.dk, a.out_sb, a.out_sh),
                  head_of<T>(a.dv, a.out_sb, a.out_sh), a.out_ss,
                  a.lse + head, a.delta + head,
                  a.dbias_part ? a.dbias_part + head : nullptr, a);
}

template <typename T, int D>
struct Fwd {
  static constexpr size_t smem = Layout<D>::fwd;
  static const void* fn() { return (const void*)attn_fwd_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_fwd_kernel<T, D><<<grid, THREADS, smem, st>>>(a);
  }
};

template <typename T, int D>
struct BwdDq {
  static constexpr size_t smem = Layout<D>::dq;
  static const void* fn() { return (const void*)attn_bwd_dq_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_bwd_dq_kernel<T, D><<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
        static_cast<T*>(a.out), a.lse, a.delta, a.S, a.H, a.in_sb, a.in_sh,
        a.in_ss, a.do_sb, a.do_sh, a.do_ss, a.out_sb, a.out_sh, a.out_ss,
        a.scale, a.causal, a.dr);
  }
};

template <typename T, int D>
struct BwdDkv {
  static constexpr size_t smem = Layout<D>::dkv;
  static const void* fn() { return (const void*)attn_bwd_dkv_kernel<T, D>; }
  static void launch(dim3 grid, cudaStream_t st, const HeadArgs& a) {
    attn_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, st>>>(a);
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
                  make_dropout(use_mask, seed0, seed1, threshold, drop_scale)};
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
  const HeadArgs a = make_args(q, k, v, bias, dout, dq, nullptr, nullptr, lse,
                               delta, nullptr, B, S, H, strides, scale,
                               drop_scale, causal, use_mask, seed0, seed1,
                               threshold);
  return dispatch<BwdDq>(dtype, D, a, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, void* dk, void* dv, float* lse, float* delta,
    float* dbias_part, int B, int S, int H, int D, const long long* strides,
    float scale, float drop_scale, int causal, int use_mask, unsigned seed0,
    unsigned seed1, unsigned threshold, int dtype, void* stream) {
  const HeadArgs a = make_args(q, k, v, bias, dout, nullptr, dk, dv, lse,
                               delta, dbias_part, B, S, H, strides, scale,
                               drop_scale, causal, use_mask, seed0, seed1,
                               threshold);
  return dispatch<BwdDkv>(dtype, D, a, stream);
}
