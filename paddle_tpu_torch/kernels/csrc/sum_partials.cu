// Deterministic sum of per-block partials for Hopper (sm_90a), plain C
// interface.
//
// Replaces the cross-grid accumulation inside the TPU backward kernels:
// paddle_tpu/kernels/fused_residual.py:_bwd_kernel adds each row block's
// dg and dc into one output block carried along its sequential grid, and
// paddle_tpu/kernels/flash_attention.py:_bwd_kernel_qkv adds each head
// group's dbias the same way. Hopper's blocks run in parallel and in no
// order, so those kernels write one partial row per block (or head)
// instead, and this kernel sums them:
//
//   out[b, n] = sum_{g = 0 .. G-1} part[b, g, n]      (fp32, g ascending)
//
// One thread per output element walks the G partials in a fixed order, so
// the result is the same on every run, with no float atomics. It reads
// each partial once and writes each output once: bounded by bytes, and
// the partials are small (G is the number of blocks or heads).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int G, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const float* p = part + (long long)b * G * N + n;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += p[(long long)g * N];
  out[(long long)b * N + n] = s;
}

}  // namespace

// part: contiguous fp32 [B, G, N]; out: contiguous fp32 [B, N]. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sum_partials(const float* part, float* out, int B, int G,
                            int N, void* stream) {
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  sum_partials_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(part, out, G, N);
  return (int)cudaGetLastError();
}
