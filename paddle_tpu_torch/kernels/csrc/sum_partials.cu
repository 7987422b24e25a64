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
//   out[b, n] = sum_{g = 0 .. G-1} part[b, g, n]      (fp32)
//
// What bounds it: device-memory bytes, one add per element read, each
// partial read once and each output written once. Two designs, chosen by
// G, each in an order that depends on G alone, so the result is the same
// on every run, with no float atomics:
//   - up to MAX_SLICE partials (the attention's dbias over H = 12 heads),
//     one thread a column walks them in ascending g;
//   - more (#4's 512 row groups, #11's 256), YS thread rows a column, YS
//     the fewest powers of two up to 32 that leave each a contiguous
//     slice of at most MAX_SLICE partials (ceil(G / YS), summed in
//     ascending g, the loads in flight together); thread row 0 adds the
//     YS slice sums in ascending order. A block takes 256 / YS columns
//     of one b, at least 32 (a warp reads 128 contiguous bytes of a
//     partial row).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // threads of a block walking columns
constexpr int MAX_YS = 32;     // thread rows of a sliced block
constexpr int MAX_SLICE = 16;  // partials a thread (row) sums
constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
sum_partials_columns_kernel(const float* __restrict__ part,
                            float* __restrict__ out, int G, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const float* p = part + (long long)b * G * N + n;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += p[(long long)g * N];
  out[(long long)b * N + n] = s;
}

__global__ void __launch_bounds__(MAX_THREADS)
sum_partials_slices_kernel(const float* __restrict__ part,
                           float* __restrict__ out, int G, int N,
                           int slice) {
  __shared__ float red[MAX_THREADS];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  float s = 0.f;
  if (n < N) {
    const int g0 = threadIdx.y * slice;
    const int g1 = min(g0 + slice, G);
    const float* p = part + ((long long)b * G + g0) * N + n;
#pragma unroll 8
    for (int g = g0; g < g1; ++g, p += N) s += *p;
  }
  red[threadIdx.y * blockDim.x + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && n < N) {
    float t = 0.f;
    for (int j = 0; j < (int)blockDim.y; ++j)
      t += red[j * blockDim.x + threadIdx.x];
    out[(long long)b * N + n] = t;
  }
}

}  // namespace

// part: contiguous fp32 [B, G, N], G >= 1; out: contiguous fp32 [B, N].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sum_partials(const float* part, float* out, int B, int G,
                            int N, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= MAX_SLICE) {
    const dim3 grid((N + THREADS - 1) / THREADS, B);
    sum_partials_columns_kernel<<<grid, THREADS, 0, st>>>(part, out, G,
                                                          N);
    return (int)cudaGetLastError();
  }
  int ys = 2;
  while (ys < MAX_YS && ys * MAX_SLICE < G) ys *= 2;
  const int cols = THREADS / ys < 32 ? 32 : THREADS / ys;
  const int slice = (G + ys - 1) / ys;
  const dim3 grid((N + cols - 1) / cols, B), block(cols, ys);
  sum_partials_slices_kernel<<<grid, block, 0, st>>>(part, out, G, N, slice);
  return (int)cudaGetLastError();
}
