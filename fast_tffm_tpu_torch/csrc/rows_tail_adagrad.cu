// Sparse Adagrad over deduped rows, in place:
//   acc <- decay*acc + g*g   (row accumulator: + sum_d g_d^2)
//   w   <- w - (lr*g) / sqrt(acc)
// for the K unique rows uids[0..K) of a [V, D] table with a [V, A]
// accumulator, A in {1 (row), D (element)}.
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_tail.py::_rows_kernel
// (reached through rows_tail_adagrad_update).  The plain PyTorch version is
// fast_tffm_tpu_torch/optim.py::adagrad_rows_plain, the update half of
// optim.sparse_adagrad_update; the dedup before it (optim.dedup_rows) stays
// torch ops, as it stays XLA outside the pallas_call in the JAX package.
//
// What bounds it on an H100: memory, and on random rows at that.  Per
// unique row it reads and writes D table floats and A accumulator floats
// and reads D gradient floats and one id, with ~5 flops per element.  At the
// first baseline5 batch (K = 143,865 unique rows, D = 9) that is ~184 B/row
// (26.5 MB, ~7.9 us at 3.35 TB/s) in element mode and ~120 B/row (17.3 MB,
// ~5.2 us) in row mode.  The rows are scattered over a 2^20-row table, so
// each touches its own 36-byte run of sectors.
//
// Design.  The TPU kernel moved rows through a double-buffered DMA schedule
// (two VMEM slots of DEFAULT_BLOCK_ROWS rows, per-row semaphores) with a
// sentinel-padded id list and an nrows guard.  All of that is TPU plumbing:
// on Hopper, enough warps in flight hide the latency of the random row
// reads, and the wrapper passes exactly K ids.
//   * element mode: one thread per (row, d).  Neighbouring threads take
//     neighbouring d of one row, so the row's table and accumulator
//     elements are read and written as one contiguous run;
//   * row mode: one thread per row, summing g_d^2 over d in order, then
//     updating the row's D elements with its one accumulator;
//   * the arithmetic is the twin's expressions in the twin's order,
//     written with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn so nvcc
//     contracts nothing into an fma: element mode at decay == 1 is bitwise
//     equal to the twin on the same (uids, gsum);
//   * ids are unique (the dedup guarantees it), so no two threads write one
//     element; an id outside [0, V) is skipped, never written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float decayed(float acc, float decay) {
  return decay == 1.f ? acc : __fmul_rn(decay, acc);
}

__device__ __forceinline__ float step(float w, float g, float acc2, float lr) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(acc2)));
}

__global__ void __launch_bounds__(kThreads)
rows_element_kernel(float* __restrict__ table, float* __restrict__ accum,
                    const int* __restrict__ uids, const float* __restrict__ gsum,
                    int K, int D, long long V, float lr, float decay) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)K * D) return;
  const long long k = t / D;
  const int d = (int)(t - k * D);
  const long long row = __ldg(uids + k);
  if (row < 0 || row >= V) return;
  const float g = __ldg(gsum + t);
  const long long e = row * D + d;
  const float acc2 = __fadd_rn(decayed(accum[e], decay), __fmul_rn(g, g));
  table[e] = step(table[e], g, acc2, lr);
  accum[e] = acc2;
}

__global__ void __launch_bounds__(kThreads)
rows_row_kernel(float* __restrict__ table, float* __restrict__ accum,
                const int* __restrict__ uids, const float* __restrict__ gsum,
                int K, int D, long long V, float lr, float decay) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long row = __ldg(uids + k);
  if (row < 0 || row >= V) return;
  const float* gk = gsum + k * D;
  float sq = 0.f;
  for (int d = 0; d < D; ++d) {
    const float g = __ldg(gk + d);
    sq = __fadd_rn(sq, __fmul_rn(g, g));
  }
  const float acc2 = __fadd_rn(decayed(accum[row], decay), sq);
  float* w = table + row * D;
  for (int d = 0; d < D; ++d) w[d] = step(w[d], __ldg(gk + d), acc2, lr);
  accum[row] = acc2;
}

}  // namespace

extern "C" int rows_tail_adagrad(float* table, float* accum, const int* uids,
                                 const float* gsum, int K, int D, int A, long long V,
                                 float lr, float decay, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (K < 1 || D < 1 || V < 1 || (A != 1 && A != D)) return (int)cudaErrorInvalidValue;
  if (A == D) {
    const long long total = (long long)K * D;
    const int blocks = (int)((total + kThreads - 1) / kThreads);
    rows_element_kernel<<<blocks, kThreads, 0, s>>>(table, accum, uids, gsum, K, D, V, lr,
                                                   decay);
  } else {
    const int blocks = (int)(((long long)K + kThreads - 1) / kThreads);
    rows_row_kernel<<<blocks, kThreads, 0, s>>>(table, accum, uids, gsum, K, D, V, lr, decay);
  }
  return cudaGetLastError();
}
