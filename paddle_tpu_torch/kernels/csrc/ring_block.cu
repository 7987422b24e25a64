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
// owned by one thread of one block: no atomics) instead of writing a
// contribution the caller would add in another pass over device memory.
// Tile liveness is decided in global coordinates: tiles wholly above the
// causal diagonal are never visited; inside a live tile each entry is
// masked by its own coordinates, so a row may be wholly masked.
//
// The helpers (tile loads, row dot products, the float4 accumulation, the
// shuffles, the shared-memory opt-in and the dtype/head-dim dispatch) are
// attn_tiles.cuh's, shared with #1-#11's attention kernels; the bodies are
// this file's own, so those kernels compile as before. bf16 inputs are
// widened to fp32 in shared memory; every output is fp32.
//
// What bounds it on the H100: at B=1, H=12, S=8192, D=64, causal, offsets
// (0, 0), the forward does 4*D flops for each of the 4.03e8 live pairs,
// 1.03e11 operations against ~8 MB of bytes: operations (1.54 ms at 67
// TFLOP/s fp32). This first version runs fp32 on the CUDA cores; tensor
// cores (wgmma) and TMA are later work.

#include "attn_tiles.cuh"

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
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, long long sb,
                                             long long sh) {
  return static_cast<const T*>(p) + (long long)blockIdx.z * sb +
         (long long)blockIdx.y * sh;
}

// key tiles a block of query rows [q0, q0 + BM) needs: under the causal
// mask, those whose first key is at or below the block's last row
__device__ __forceinline__ int live_key_tiles(const RingArgs& a, int q0) {
  int n = (a.Sk + BN - 1) / BN;
  if (a.causal) {
    const int last = a.row0 + min(q0 + BM, a.Sq) - 1 - a.col0;
    n = last < 0 ? 0 : min(n, last / BN + 1);
  }
  return n;
}

__device__ __forceinline__ bool live(const RingArgs& a, int i, int j) {
  return i < a.Sq && j < a.Sk && (!a.causal || a.col0 + j <= a.row0 + i);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ring_fwd_kernel(RingArgs a) {
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int JPT = BN / TPR;
  constexpr int CHUNKS = D / (4 * TPR);

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;
  float* sP = sV + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int row = q0 + r;
  const T* kb = head_ptr<T>(a.k, a.kv_sb, a.kv_sh);
  const T* vb = head_ptr<T>(a.v, a.kv_sb, a.kv_sh);
  load_rows<T, D, BM>(sQ, head_ptr<T>(a.q, a.q_sb, a.q_sh), a.q_ss, q0, a.Sq,
                      tid);

  float acc[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] = 0.f;
  // m starts finite: a row whose keys are all masked keeps m = NEG_INF
  // and alpha = exp(0) = 1 instead of exp(-inf - -inf) = NaN
  float m = NEG_INF, l = 0.f;

  const int n_tiles = live_key_tiles(a, q0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, kb, a.kv_ss, k0, a.Sk, tid);
    load_rows<T, D, BN>(sV, vb, a.kv_ss, k0, a.Sk, tid);
    __syncthreads();

    float sc[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    float tile_max = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      sc[jj] = live(a, row, k0 + t + TPR * jj) ? sc[jj] * a.scale : NEG_INF;
      tile_max = fmaxf(tile_max, sc[jj]);
    }
    const float m_new = fmaxf(m, row_max4(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      // a masked entry weighs 0 even where the whole row is masked
      // (m_new == NEG_INF, where exp(s - m_new) would be 1)
      const float p = live(a, row, k0 + jl) ? expf(sc[jj] - m_new) : 0.f;
      psum += p;
      sP[r * PLD + jl] = p;
    }
    l = l * alpha + row_sum4(psum);
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's P values, written by its own warp
    accumulate_rows<D>(acc, sP + r * PLD, sV, t);
  }

  if (row < a.Sq) {
    const long long head = (long long)blockIdx.z * a.H + blockIdx.y;
    const bool any = l > 0.f;
    store_cols<float, D>(a.o + (head * a.Sq + row) * D, acc,
                         any ? 1.f / l : 0.f, t);
    if (t == 0) a.lse[head * a.Sq + row] = any ? m + logf(l) : NEG_INF;
  }
}

// acc[D/4 columns of this thread] * mul added into row[] (fp32)
template <int D>
__device__ __forceinline__ void add_cols(float* row, const float* acc,
                                         float mul, int t) {
  constexpr int CHUNKS = D / (4 * TPR);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    float4* p = reinterpret_cast<float4*>(row + (k * TPR + t) * 4);
    float4 x = *p;
    x.x = fmaf(acc[4 * k + 0], mul, x.x);
    x.y = fmaf(acc[4 * k + 1], mul, x.y);
    x.z = fmaf(acc[4 * k + 2], mul, x.z);
    x.w = fmaf(acc[4 * k + 3], mul, x.w);
    *p = x;
  }
}

// two blocks to an SM, as #9's dq kernel
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) ring_dq_kernel(RingArgs a) {
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

  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int row = q0 + r;
  const int n_tiles = live_key_tiles(a, q0);
  if (n_tiles == 0) return;  // adds nothing
  const T* kb = head_ptr<T>(a.k, a.kv_sb, a.kv_sh);
  const T* vb = head_ptr<T>(a.v, a.kv_sb, a.kv_sh);
  load_rows<T, D, BM>(sQ, head_ptr<T>(a.q, a.q_sb, a.q_sh), a.q_ss, q0, a.Sq,
                      tid);
  load_rows<T, D, BM>(sDO, head_ptr<T>(a.dout, a.do_sb, a.do_sh), a.do_ss,
                      q0, a.Sq, tid);
  const long long head = (long long)blockIdx.z * a.H + blockIdx.y;
  const float lse = row < a.Sq ? a.lse[head * a.Sq + row] : 0.f;
  const float delta = row < a.Sq ? a.delta[head * a.Sq + row] : 0.f;

  float acc[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows<T, D, BN>(sK, kb, a.kv_ss, k0, a.Sk, tid);
    load_rows<T, D, BN>(sV, vb, a.kv_ss, k0, a.Sk, tid);
    __syncthreads();

    float sc[JPT], dpv[JPT];
    row_dots<D, JPT>(sc, sQ + r * LD, sK, t);
    row_dots<D, JPT>(dpv, sDO + r * LD, sV, t);
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) {
      const int jl = t + TPR * jj;
      const float p =
          live(a, row, k0 + jl) ? expf(sc[jj] * a.scale - lse) : 0.f;
      sP[r * PLD + jl] = p * (dpv[jj] - delta);
    }
    __syncwarp();
    accumulate_rows<D>(acc, sP + r * PLD, sK, t);
  }
  if (row < a.Sq) add_cols<D>(a.o + (head * a.Sq + row) * D, acc, a.scale, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ring_dkv_kernel(RingArgs a) {
  constexpr int LD = Layout<D>::LD;
  constexpr int PLD = Layout<D>::PLD;
  constexpr int IPT = BM / TPR;
  constexpr int CHUNKS = D / (4 * TPR);

  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sDO = sQ + BM * LD;
  float* sP = sDO + BM * LD;  // [key][query]: p
  float* sS = sP + BN * PLD;  // [key][query]: dS
  float* sLse = sS + BN * PLD;
  float* sDelta = sLse + BM;

  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int r = tid / TPR;  // key row within the tile
  const int t = tid % TPR;
  const int j = k0 + r;
  const int n_qt = (a.Sq + BM - 1) / BM;
  // causal: query tiles whose last global row lies before this tile's
  // first global column see none of its keys
  const int first = a.col0 + k0 - a.row0;
  const int qt0 = (a.causal && first > 0) ? first / BM : 0;
  if (qt0 >= n_qt) return;  // adds nothing
  const long long head = (long long)blockIdx.z * a.H + blockIdx.y;
  const T* qb = head_ptr<T>(a.q, a.q_sb, a.q_sh);
  const T* dob = head_ptr<T>(a.dout, a.do_sb, a.do_sh);
  load_rows<T, D, BN>(sK, head_ptr<T>(a.k, a.kv_sb, a.kv_sh), a.kv_ss, k0,
                      a.Sk, tid);
  load_rows<T, D, BN>(sV, head_ptr<T>(a.v, a.kv_sb, a.kv_sh), a.kv_ss, k0,
                      a.Sk, tid);

  float dk[4 * CHUNKS], dv[4 * CHUNKS];
#pragma unroll
  for (int i = 0; i < 4 * CHUNKS; ++i) dk[i] = dv[i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_rows<T, D, BM>(sQ, qb, a.q_ss, q0, a.Sq, tid);
    load_rows<T, D, BM>(sDO, dob, a.do_ss, q0, a.Sq, tid);
    for (int i = tid; i < BM; i += THREADS) {
      const bool ok = q0 + i < a.Sq;
      sLse[i] = ok ? a.lse[head * a.Sq + q0 + i] : 0.f;
      sDelta[i] = ok ? a.delta[head * a.Sq + q0 + i] : 0.f;
    }
    __syncthreads();

    float sc[IPT], dpv[IPT];
    row_dots<D, IPT>(sc, sK + r * LD, sQ, t);
    row_dots<D, IPT>(dpv, sV + r * LD, sDO, t);
#pragma unroll
    for (int ii = 0; ii < IPT; ++ii) {
      const int il = t + TPR * ii;
      const float p =
          live(a, q0 + il, j) ? expf(sc[ii] * a.scale - sLse[il]) : 0.f;
      sP[r * PLD + il] = p;
      sS[r * PLD + il] = p * (dpv[ii] - sDelta[il]);
    }
    __syncwarp();
    accumulate_rows<D>(dv, sP + r * PLD, sDO, t);
    accumulate_rows<D>(dk, sS + r * PLD, sQ, t);
  }
  if (j < a.Sk) {
    add_cols<D>(a.dk + (head * a.Sk + j) * D, dk, a.scale, t);
    add_cols<D>(a.dv + (head * a.Sk + j) * D, dv, 1.f, t);
  }
}

#define RING_KERNEL(NAME, KERNEL, SMEM)                                      \
  template <typename T, int D>                                               \
  struct NAME {                                                              \
    static constexpr size_t smem = Layout<D>::SMEM;                          \
    static const void* fn() { return (const void*)KERNEL<T, D>; }            \
    static void launch(dim3 grid, cudaStream_t st, const RingArgs& a) {      \
      KERNEL<T, D><<<grid, THREADS, smem, st>>>(a);                          \
    }                                                                        \
  };

RING_KERNEL(Fwd, ring_fwd_kernel, fwd)
RING_KERNEL(Dq, ring_dq_kernel, dq)
RING_KERNEL(Dkv, ring_dkv_kernel, dkv)

RingArgs make_args(const void* q, const void* k, const void* v,
                   const void* dout, float* o, float* dk, float* dv,
                   float* lse, const float* delta, int B, int H, int Sq,
                   int Sk, int row0, int col0, const long long* s,
                   float scale, int causal) {
  return RingArgs{q, k, v, dout, o, dk, dv, lse, delta, B, Sq, H, Sq, Sk,
                  row0, col0, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                  s[7], s[8], scale, causal};
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
  const RingArgs a = make_args(q, k, v, nullptr, o, nullptr, nullptr, lse,
                               nullptr, B, H, Sq, Sk, row0, col0, strides,
                               scale, causal);
  return dispatch<Fwd>(dtype, D, a, stream);
}

extern "C" int ring_block_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, float* dq, int B, int H,
                                 int Sq, int Sk, int D, int row0, int col0,
                                 const long long* strides, float scale,
                                 int causal, int dtype, void* stream) {
  const RingArgs a = make_args(q, k, v, dout, dq, nullptr, nullptr,
                               const_cast<float*>(lse), delta, B, H, Sq, Sk,
                               row0, col0, strides, scale, causal);
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
  return dispatch<Dkv>(dtype, D, a, stream);
}
