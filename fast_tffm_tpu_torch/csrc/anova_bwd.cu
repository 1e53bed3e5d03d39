// ANOVA interaction sum, backward: zbar[b, j, f] = d out[b] / d z[b, j, f] * g[b],
// out[b] = sum_{m=2..order} sum_f ANOVA_m(z[b, :, f]).
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_anova.py::_bwd_kernel
// (reached through anova_inter's custom VJP -> _anova_inter_bwd -> _bwd_impl).
// The plain PyTorch version is
// fast_tffm_tpu_torch/ops/anova.py::anova_inter_bwd_plain.
//
// What bounds it on an H100: memory.  It reads z (B*N*k*4 bytes) and g (B*4)
// once and writes zbar (B*N*k*4) once, with about 4*order flops per element
// of z -- far below the card's float32 balance point.  At the baseline5
// training batch (B = 16384, N = 11, k = 8) that is 11.6 MB, about 3.5 us at
// 3.35 TB/s.
//
// Design.  The TPU kernel transposed z to [k, N, B] so the batch filled the
// 128 lanes, and recomputed the forward carries into a VMEM scratch of
// [N, 8*ceil((order+1)/8), 128].  Here the factors of one example never
// interact, so the backward needs no reduction at all:
//   * one thread per (example b, factor f), reading z [B, N, k] as given;
//     neighbouring threads take neighbouring f, so each feature step is a
//     coalesced load, and every zbar element is written exactly once;
//   * pass 1 recomputes the forward carries a_prev_j (the DP state before
//     feature j) and stashes degrees 1..order-1 of each in shared memory --
//     N*(order-1) floats per thread, laid out [j][m][thread] so a warp's
//     accesses fall in distinct banks.  Degree 0 is always 1 and degree
//     `order` is never read, so neither is stored.  The carries never touch
//     device memory;
//   * pass 2 runs the reverse DP from the last feature down:
//       zbar_j = sum_{m=1..order} abar[m] * a_prev_j[m-1]
//       abar[m] += abar[m+1] * z_j   (ascending m, so abar[m+1] is the old value)
//     seeded with abar[2..order] = g[b], abar[0..1] = 0;
//   * `order` is a template parameter (3..8) so abar lives in registers.
// The block size is the largest multiple of 32 (at most 256) whose stash
// fits in 48 KB; a wider stash takes a 32-thread block with the dynamic
// shared-memory limit raised (up to 227 KB).  The wrapper refuses shapes
// beyond that before launching.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

template <int ORDER>
__global__ void __launch_bounds__(kMaxThreads)
anova_bwd_kernel(const float* __restrict__ z, const float* __restrict__ g,
                 float* __restrict__ zbar, int B, int N, int K) {
  extern __shared__ float stash[];  // [N][ORDER-1][blockDim.x]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long t = (long long)blockIdx.x * nt + tid;
  if (t >= (long long)B * K) return;  // no barrier follows: early exit is safe
  const long long b = t / K;
  const int f = (int)(t - b * K);
  const float* zb = z + b * (long long)N * K + f;
  float* out = zbar + b * (long long)N * K + f;

  // Pass 1: forward carries, degrees 1..ORDER-1 before each feature.
  float a[ORDER + 1];
  a[0] = 1.f;
#pragma unroll
  for (int m = 1; m <= ORDER; ++m) a[m] = 0.f;
  for (int j = 0; j < N; ++j) {
    float* s = stash + (long long)j * (ORDER - 1) * nt + tid;
#pragma unroll
    for (int m = 1; m < ORDER; ++m) s[(m - 1) * nt] = a[m];
    const float zj = __ldg(zb + (long long)j * K);
#pragma unroll
    for (int m = ORDER; m >= 1; --m) a[m] = fmaf(zj, a[m - 1], a[m]);
  }

  // Pass 2: reverse DP.
  const float gb = __ldg(g + b);
  float abar[ORDER + 1];
  abar[0] = 0.f;
  abar[1] = 0.f;
#pragma unroll
  for (int m = 2; m <= ORDER; ++m) abar[m] = gb;
  for (int j = N - 1; j >= 0; --j) {
    const float* s = stash + (long long)j * (ORDER - 1) * nt + tid;
    float acc = abar[1];  // a_prev_j[0] == 1
#pragma unroll
    for (int m = 2; m <= ORDER; ++m) acc = fmaf(abar[m], s[(m - 2) * nt], acc);
    out[(long long)j * K] = acc;
    const float zj = __ldg(zb + (long long)j * K);
#pragma unroll
    for (int m = 1; m < ORDER; ++m) abar[m] = fmaf(abar[m + 1], zj, abar[m]);
  }
}

template <int ORDER>
cudaError_t launch(const float* z, const float* g, float* zbar, int B, int N, int K,
                   cudaStream_t s) {
  const long long per_thread = (long long)N * (ORDER - 1) * (long long)sizeof(float);
  int threads = kMaxThreads;
  while (threads > 32 && per_thread * threads > kDefaultSmem) threads -= 32;
  const long long smem = per_thread * threads;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(anova_bwd_kernel<ORDER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long total = (long long)B * K;
  const int blocks = (int)((total + threads - 1) / threads);
  anova_bwd_kernel<ORDER><<<blocks, threads, (size_t)smem, s>>>(z, g, zbar, B, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int anova_bwd(const float* z, const float* g, float* zbar, int B, int N, int K,
                         int order, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (B < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (order) {
    case 3: return (int)launch<3>(z, g, zbar, B, N, K, s);
    case 4: return (int)launch<4>(z, g, zbar, B, N, K, s);
    case 5: return (int)launch<5>(z, g, zbar, B, N, K, s);
    case 6: return (int)launch<6>(z, g, zbar, B, N, K, s);
    case 7: return (int)launch<7>(z, g, zbar, B, N, K, s);
    case 8: return (int)launch<8>(z, g, zbar, B, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
