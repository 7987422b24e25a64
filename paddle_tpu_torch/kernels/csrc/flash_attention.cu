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
//   attn_bwd_dq_kernel: one block per (query tile, head, batch), on
//     attn_mma.cuh's dq_mma_block<SAVED = false>; pass 1 recomputes the
//     row max and sum online with delta_i = sum_j p_ij dp_ij (dp = dO v^T,
//     masked and scaled as the forward scaled p), pass 2 forms
//     dS = p (dp - delta) and dq = scale * dS k, and it writes each row's
//     lse and delta to an fp32 [B, H, S] scratch.
//   attn_bwd_dkv_kernel: one block per (key tile, head, batch), on
//     attn_mma.cuh's dkv_mma_block (through dkv_view):
//     dv = (keep . p)^T dO * drop_scale,
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
// mma_tiles.cuh, with bodies it shares with the KV-tiled pair #8/#9
// (flash_tiled.cu; attn_mma.cuh): mma.sync m16n8k8 TF32 in the 3xTF32
// split (an fp32 operand x = hi + lo, a product lo.hi + hi.lo + hi.hi),
// as the ring-block pair #13/#14 does. The function needs 4 products of
// 2*B*H*S^2*D flops (dP, dQ, dV, dK; S is the forward's): at BERT's
// shape, three TF32 terms each in fp32, 0.312 ms at 495 TFLOP/s dense
// TF32, and in bf16 0.052 ms at 989 TFLOP/s. The op saves neither the
// forward's output nor its lse, so dq recomputes them (pass 1), and the
// pair does 9 products (dq: S and dP twice, dS K; dkv: S^T, dP^T, P^T dO,
// dS^T Q), 27 TF32 products in fp32 (0.703 ms at 495 TFLOP/s). In bf16
// Q, K, V and dO widen to TF32 exactly, so their lo terms drop (12 TF32
// products); P and dS stay fp32 and are split, as the plain version keeps
// them fp32.
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

#include "attn_mma.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  const unsigned h = blockIdx.y, b = blockIdx.z;
  fwd_block<T, D>(reinterpret_cast<float*>(smem4),
                  head_of<T>(a.q, a.in_sb, a.in_sh, b, h),
                  head_of<T>(a.k, a.in_sb, a.in_sh, b, h),
                  head_of<T>(a.v, a.in_sb, a.in_sh, b, h), a.in_ss,
                  a.bias ? a.bias + (long long)b * a.S : nullptr,
                  head_of<T>(a.out, a.out_sb, a.out_sh, b, h), a.out_ss,
                  nullptr, a);
}

// backward pair (#3/#6) on the tensor cores: attn_mma.cuh's bodies, the
// dq kernel with its first pass (the op saves neither out nor lse)
template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2)
attn_bwd_dq_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  dq_mma_block<T, D, false>(smem4, a);
}

template <typename T, int D>
__global__ void __launch_bounds__(mma::THREADS, 2)
attn_bwd_dkv_kernel(HeadArgs a) {
  extern __shared__ float4 smem4[];
  dkv_view<T, D, false>(smem4, a);
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
