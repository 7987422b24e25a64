// Device code shared by the attention kernels of flash_attention.cu (the
// whole-row kernels: #1/#5 forward, #3/#6 backward), flash_tiled.cu (#7
// forward, #8 dkv, #9 dq) and ring_block.cu (#12-#14): the Dropout and
// the keep mask drawn into shared memory, the causal key-tile count, the
// row reductions over a fragment row's four lanes, the launch Args of the
// tiled kernels, launch dispatch and occupancy reports. Every kernel runs
// its products on the tensor cores, on attn_mma.cuh's bodies (the
// forwards #1/#5, #7 and #12 share fwd_mma_block; the pairs #3/#6 and
// #9/#8 share dq_mma_block and dkv_mma_block) or the ring pair's own
// (#13/#14).
//
// Per batch b and head h:
//
//   s    = q k^T * scale + bias[b]     (bias: additive fp32 key bias [B, S];
//                                       causal entries j > i at -1e30)
//   p    = softmax(s)                  (fp32 statistics)
//   out  = drop_scale * (keep . p) v   (keep: the Philox mask of
//                                       philox.cuh, or all ones)

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include <mutex>

#include "philox.cuh"

namespace attn {

constexpr int BM = 64;  // rows of the sequence per block (dispatch's grid)
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Dropout {
  int use_mask;        // training dropout: apply the Philox keep mask
  uint32_t seed0, seed1, threshold;
  float scale;         // multiplier of a kept probability
};

inline Dropout make_dropout(int use_mask, unsigned seed0, unsigned seed1,
                            unsigned threshold, float drop_scale) {
  Dropout dr;
  dr.use_mask = use_mask;
  dr.seed0 = seed0;
  dr.seed1 = seed1;
  dr.threshold = threshold;
  dr.scale = drop_scale;
  return dr;
}

// Keep bytes of the (NR query rows q0.., 8 NG keys k0..) tile, drawn by
// NT threads: byte rr * NG + g holds the keep bits of keys k0 + 8g ..
// k0 + 8g + 7 for query q0 + rr.
template <int NR, int NG, int NT>
__device__ __forceinline__ void fill_mask(unsigned char* sM, const Dropout& dr,
                                          int q0, int k0, int h, int b,
                                          int tid) {
  if (!dr.use_mask) return;
  for (int i = tid; i < NR * NG; i += NT) {
    const int rr = i / NG, g = i % NG;
    sM[i] = (unsigned char)philox::keep_byte(
        (uint32_t)((k0 >> 3) + g), (uint32_t)(q0 + rr), (uint32_t)h,
        (uint32_t)b, dr.seed0, dr.seed1, dr.threshold);
  }
}

// number of key tiles of COLS keys a block of query rows [q0, q0 + BM)
// needs: tiles wholly above the diagonal for every row add
// exp(NEG_INF - m) == 0
template <int COLS>
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  int n = (S + COLS - 1) / COLS;
  if (causal) n = min(n, (min(q0 + BM, S) - 1) / COLS + 1);
  return n;
}

// the max and sum of a row over its four lanes (lane = 4g + t of an mma
// fragment: the row's lanes are consecutive)
__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pointers, shapes and strides of one launch of the tiled kernels
// (strides in elements; every last dim is contiguous). q, k and v are
// [B, H, S, D] views sharing their (batch, head, row) strides in_*; out
// (the forward's output, or dq), dk and dv share out_*. The packed
// projection qkv[B, S, 3*H*D] is the view with k = q + H*D,
// v = q + 2*H*D, in_sh = D, in_ss = 3*H*D. The bodies (attn_mma.cuh)
// read the fields by name.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;   // may be null: every key kept
  const void* dout;
  const void* fwd_out; // the forward's saved output (#9's delta)
  void* out;           // forward: out; backward: dq
  void* dk;
  void* dv;
  float* lse;          // fp32 [B, H, S]
  float* delta;        // fp32 [B, H, S]
  float* dbias_part;   // fp32 [B, H, S], may be null
  int B, S, H;
  long long in_sb, in_sh, in_ss, do_sb, do_sh, do_ss, out_sb, out_sh,
      out_ss, fo_sb, fo_sh, fo_ss;
  float scale;
  int causal;
  Dropout dr;
  int async_copy;  // every row the kernel copies is 16-byte aligned
};

// Above 48 KB a block's shared memory must be opted into, per kernel and
// device. K names the kernel (K::fn()) and its bytes (K::smem); done once
// for each (K, device), not on every launch.
template <typename K>
cudaError_t opt_in_smem() {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    result[dev] = cudaFuncSetAttribute(
        K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::smem);
  });
  return result[dev];
}

// Launch K<T, D> (K::launch(grid, stream, args)) for the dtype code (0 =
// float32, 1 = bfloat16) and head dim of one call.
template <template <typename, int> class K, typename A>
int dispatch(int dtype, int D, const A& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  auto run = [&](auto launch, cudaError_t opt) -> int {
    if (opt != cudaSuccess) return (int)opt;
    launch(grid, st, a);
    return (int)cudaGetLastError();
  };
  if (dtype == 0) {
    switch (D) {
      case 32: return run(K<float, 32>::launch, opt_in_smem<K<float, 32>>());
      case 64: return run(K<float, 64>::launch, opt_in_smem<K<float, 64>>());
      case 128: return run(K<float, 128>::launch, opt_in_smem<K<float, 128>>());
    }
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    switch (D) {
      case 32: return run(K<bf, 32>::launch, opt_in_smem<K<bf, 32>>());
      case 64: return run(K<bf, 64>::launch, opt_in_smem<K<bf, 64>>());
      case 128: return run(K<bf, 128>::launch, opt_in_smem<K<bf, 128>>());
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The blocks of kernel K (K::threads threads a block) that fit on one SM
// of the current device, and the dynamic shared memory each takes
// (K::smem): a report of the build, which no launch reads.
template <typename K>
int occupancy_of(int* blocks, int* smem_bytes) {
  const cudaError_t opt = opt_in_smem<K>();
  if (opt != cudaSuccess) return (int)opt;
  *smem_bytes = (int)K::smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, K::fn(), K::threads, K::smem);
}

// occupancy_of K<T, D> for a dtype code (0 = float32, 1 = bfloat16) and
// head dim
template <template <typename, int> class K>
int occupancy(int dtype, int D, int* blocks, int* smem_bytes) {
  using bf = __nv_bfloat16;
  switch (dtype * 1000 + D) {
    case 32: return occupancy_of<K<float, 32>>(blocks, smem_bytes);
    case 64: return occupancy_of<K<float, 64>>(blocks, smem_bytes);
    case 128: return occupancy_of<K<float, 128>>(blocks, smem_bytes);
    case 1032: return occupancy_of<K<bf, 32>>(blocks, smem_bytes);
    case 1064: return occupancy_of<K<bf, 64>>(blocks, smem_bytes);
    case 1128: return occupancy_of<K<bf, 128>>(blocks, smem_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
