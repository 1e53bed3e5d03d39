// ANOVA interaction sum, forward: out[b] = sum_{m=2..order} sum_f ANOVA_m(z[b, :, f]).
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_anova.py::_fwd_kernel
// (reached through anova_inter -> _fwd_impl).  The plain PyTorch version is
// fast_tffm_tpu_torch/ops/anova.py::anova_inter_plain.
//
// What bounds it on an H100: memory.  It reads z once (B*N*k*4 bytes) and
// writes out once (B*4 bytes) and does about 2*order flops per element of z,
// far below the card's ~20 flops/byte float32 balance point.  At the serving
// bucket B = 512 with N = 11, k = 8 that is 180 KB, about 0.05 us at
// 3.35 TB/s, so launch latency dominates at serving sizes.
//
// Design.  The TPU kernel transposed z to [k, N, B] so the batch filled the
// 128 vector lanes, and it carried the sum over factors from one grid step to
// the next in its output block.  Hopper has no ordered grid, so instead:
//   * one thread per (example b, factor f) keeps the whole DP state
//     a[0..order] in registers (order is a template parameter, 3..8) and
//     walks the N features of z [B, N, k] in the given layout; neighbouring
//     threads take neighbouring f, so each feature step is a coalesced load;
//   * degrees are raised from the top down, a[m] += z * a[m-1], so no shift
//     buffer is needed;
//   * a thread sums its degrees 2..order; the k threads of one example reduce
//     with warp shuffles when k divides 32, else through shared memory, and
//     one thread writes out[b].  For k > 256 a thread walks several factors.
// N is a runtime loop; B and k are any size, the ragged edge masked.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockThreads = 256;

template <int ORDER, bool SHFL>
__global__ void __launch_bounds__(kBlockThreads)
anova_fwd_kernel(const float* __restrict__ z, float* __restrict__ out,
                 int B, int N, int K, int T) {
  // T threads per example, E = blockDim.x / T examples per block.
  extern __shared__ float partial[];  // blockDim.x floats, !SHFL only
  const int tid = threadIdx.x;
  const int e_local = tid / T;
  const int fi = tid - e_local * T;
  const long long b = (long long)blockIdx.x * (blockDim.x / T) + e_local;

  float s = 0.f;
  if (b < B) {
    const float* zb = z + b * (long long)N * K;
    for (int f = fi; f < K; f += T) {
      float a[ORDER + 1];
      a[0] = 1.f;
#pragma unroll
      for (int m = 1; m <= ORDER; ++m) a[m] = 0.f;
      for (int j = 0; j < N; ++j) {
        const float zj = __ldg(zb + (long long)j * K + f);
#pragma unroll
        for (int m = ORDER; m >= 1; --m) a[m] = fmaf(zj, a[m - 1], a[m]);
      }
#pragma unroll
      for (int m = 2; m <= ORDER; ++m) s += a[m];
    }
  }

  if (SHFL) {
    // T divides 32 and the block is whole warps: every lane takes part,
    // those past B with s = 0.
    for (int off = T / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off, T);
    if (fi == 0 && b < B) out[b] = s;
  } else {
    partial[tid] = s;
    __syncthreads();
    if (fi == 0 && b < B) {
      float t = 0.f;
      const float* p = partial + e_local * T;
      for (int i = 0; i < T; ++i) t += p[i];
      out[b] = t;
    }
  }
}

template <int ORDER>
cudaError_t launch(const float* z, float* out, int B, int N, int K, cudaStream_t s) {
  const bool shfl = K <= 32 && 32 % K == 0;
  const int T = shfl ? K : (K < kBlockThreads ? K : kBlockThreads);
  const int E = kBlockThreads / T;
  const int threads = E * T;
  const int blocks = (int)(((long long)B + E - 1) / E);
  if (shfl) {
    anova_fwd_kernel<ORDER, true><<<blocks, threads, 0, s>>>(z, out, B, N, K, T);
  } else {
    anova_fwd_kernel<ORDER, false><<<blocks, threads, threads * sizeof(float), s>>>(
        z, out, B, N, K, T);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int anova_fwd(const float* z, float* out, int B, int N, int K, int order,
                         cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (B < 1 || K < 1 || N < 0) return (int)cudaErrorInvalidValue;
  switch (order) {
    case 3: return (int)launch<3>(z, out, B, N, K, s);
    case 4: return (int)launch<4>(z, out, B, N, K, s);
    case 5: return (int)launch<5>(z, out, B, N, K, s);
    case 6: return (int)launch<6>(z, out, B, N, K, s);
    case 7: return (int)launch<7>(z, out, B, N, K, s);
    case 8: return (int)launch<8>(z, out, B, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
