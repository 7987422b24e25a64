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
// whatever their tiling. The forward widens bf16 inputs to fp32 in shared
// memory; the backward keeps its tiles in the input dtype and widens each
// fragment as it loads it; the exp tail runs in fp32 for both dtypes.
//
// What bounds it on the H100: at B=4, S=2048, H=12, D=64, causal
// (1.007e8 live pairs), the forward owns 2 products of 2*D*pairs flops
// (25.8 GFLOP) against ~0.1 GB of bytes, 250 flops a byte: bounded by
// operations (0.385 ms at 67 TFLOP/s fp32 on the CUDA cores, where it
// runs: fwd_block, fp32 in either dtype). The backward as a function does
// 4 products (dP, dQ to dq; dV, dK to dkv), each kernel 2: on the tensor
// cores in the 3xTF32 split, 3 x 25.8 GFLOP at 495 TFLOP/s = 0.156 ms a
// kernel in fp32; in bf16 about 0.026 ms of operations at 989 TFLOP/s.
//
// The backward pair runs on the tensor cores, on the bodies it shares
// with the whole-row pair #3/#6 (attn_mma.cuh, over mma_tiles.cuh's
// mma.sync m16n8k8 TF32, 3xTF32 for fp32 operands, cp.async tiles):
// tiled_dq_kernel is dq_mma_block<SAVED = true>, one pass over the key
// tiles (S, dP, dS K: 3 products, 9 TF32 terms in fp32, 4 in bf16 where
// Q, K, V and dO are TF32 already), with lse from the forward and delta
// from the saved output staged before the stream; tiled_dkv_kernel is
// dkv_mma_block<SAVED = true> (S^T, dP^T, P^T dO, dS^T Q: 4 products, 12
// TF32 terms in fp32, 6 in bf16). P and dS stay fp32 and are split, as
// the plain version keeps them. delta comes from the saved output, not
// from dp's own row sum, so dkv sums S^T and dP^T from zero 8 columns at
// a time and adds them in fp32 (mma::tile_products<STEPWISE>): a chain of
// mma's over D truncates toward zero, and dbias would add that bias up.
// Under the causal mask both kernels hand out their heaviest tiles of
// every head first (block_tile). Both take 128 threads, two cp.async
// stages and, where a view's rows are not 16-byte aligned, the
// synchronous copy path (the C entries decide with mma::rows_aligned).
// Wgmma with TMA and pre-split hi/lo tiles are later work.

#include "attn_mma.cuh"

namespace {

using namespace attn;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) tiled_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  view_fwd<T, D>(reinterpret_cast<float*>(smem4), a, a.lse);
}

// #9: dq and delta from the saved output and lse, one pass
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2) tiled_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  dq_mma_block<T, D, true>(smem4, a);
}

// #8: dk, dv and the per-head dbias partial from lse and delta
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2) tiled_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  dkv_view<T, D, true>(smem4, a);
}

#define TILED_KERNEL(NAME, KERNEL, THREADS_, SMEM)                          \
  template <typename T, int D>                                               \
  struct NAME {                                                              \
    static constexpr int threads = THREADS_;                                 \
    static constexpr size_t smem = SMEM;                                     \
    static const void* fn() { return (const void*)KERNEL<T, D>; }            \
    static void launch(dim3 grid, cudaStream_t st, const Args& a) {          \
      KERNEL<T, D><<<grid, threads, smem, st>>>(a);                          \
    }                                                                        \
  };

TILED_KERNEL(Fwd, tiled_fwd_kernel, THREADS, Layout<D>::fwd)
TILED_KERNEL(Dq, tiled_dq_kernel, mma::THREADS, (BwdSmem<T, D>::dq))
TILED_KERNEL(Dkv, tiled_dkv_kernel, mma::THREADS, (BwdSmem<T, D>::dkv))

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
              make_dropout(use_mask, seed0, seed1, threshold, drop_scale),
              0};
}

// The backward's copy path: 16-byte cp.async where q, k, v and dout and
// their six strides, and the saved output (dq) and its three, keep every
// head row 16-byte aligned, else synchronous element copies (the outputs
// are stored element by element either way).
int rows_aligned(const Args& a, const long long* strides, int dtype) {
  const int es = dtype == 1 ? 2 : 4;
  const void* o = a.fwd_out;
  return mma::rows_aligned(a.q, a.k, a.v, a.dout, strides, 6, es) &&
         (!o || mma::rows_aligned(o, o, o, o, strides + 9, 3, es));
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
  Args a = make_args(q, k, v, bias, dout, fwd_out, dq, nullptr, nullptr,
                     const_cast<float*>(lse), delta, nullptr, B, S, H,
                     strides, scale, drop_scale, causal, use_mask, seed0,
                     seed1, threshold);
  a.async_copy = rows_aligned(a, strides, dtype);
  return dispatch<Dq>(dtype, D, a, stream);
}

extern "C" int flash_tiled_bwd_dkv(
    const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, float* dbias_part, int B, int S, int H, int D,
    const long long* strides, float scale, float drop_scale, int causal,
    int use_mask, unsigned seed0, unsigned seed1, unsigned threshold,
    int dtype, void* stream) {
  Args a = make_args(q, k, v, bias, dout, nullptr, nullptr, dk, dv,
                     const_cast<float*>(lse), const_cast<float*>(delta),
                     dbias_part, B, S, H, strides, scale, drop_scale, causal,
                     use_mask, seed0, seed1, threshold);
  a.async_copy = rows_aligned(a, strides, dtype);
  return dispatch<Dkv>(dtype, D, a, stream);
}

// The blocks of a backward kernel (which: 0 = dq, 1 = dkv) that fit on
// one SM of the current device, and the dynamic shared memory each block
// takes, for a dtype code and head dim: a report of the build, which no
// launch reads.
extern "C" int flash_tiled_bwd_occupancy(int which, int dtype, int D,
                                         int* blocks, int* smem_bytes) {
  return which == 0 ? occupancy<Dq>(dtype, D, blocks, smem_bytes)
                    : occupancy<Dkv>(dtype, D, blocks, smem_bytes);
}
