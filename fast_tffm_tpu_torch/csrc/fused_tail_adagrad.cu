// Sparse row-Adagrad over deduped logical rows of the FUSED layout, in place:
//   acc <- decay*acc + sum_d g_d^2      (summed left to right in d)
//   w_d <- w_d - (lr*g_d) / sqrt(acc)
// on a [VPf, 128] float32 array holding P = 128 / (D+1) slots per 128-lane
// row: logical row u lives in tile row u / P, its D parameters at lanes
// [(u % P)*(D+1), (u % P)*(D+1) + D) and its accumulator at the lane after.
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_tail.py::_fused_kernel
// (reached through fused_tail_adagrad_update -> _fused_rmw).  The plain
// PyTorch version is fast_tffm_tpu_torch/ops/tail.py::fused_adagrad_plain;
// the dedup before it (optim.dedup_rows) stays torch ops, as it stays XLA
// outside the pallas_call in the JAX package.
//
// What bounds it on an H100: memory, on random slots.  Per unique row it
// reads one id and D gradient floats and reads and writes the slot's D+1
// floats.  At the first baseline5 batch (K = 143,865 unique rows, D = 9)
// that is 120 B/row, 17.3 MB, ~5.2 us at 3.35 TB/s.  The slots are
// scattered over a 44.7 MB array, so each touches its own 40-byte run.
//
// Design.  The TPU kernel DMAs only the touched slot's D+1 lanes in and out
// through a double-buffered VMEM schedule (sentinel-padded ids, an nrows
// guard).  Here:
//   * one thread per (row, lane in [0, D]): the D+1 threads of a row read
//     and write the slot's D+1 contiguous floats together.  Each redoes the
//     row's sum of g_d^2 in the twin's order from L1, so all of them hold
//     the same acc2; lane D writes acc2, lane d < D writes w_d;
//   * a block holds whole rows only (floor(256 / (D+1)) of them), and a
//     __syncthreads() separates every read of the slot's accumulator from
//     lane D's write of it;
//   * no thread writes outside its own lane of its own slot: neighbouring
//     slots of one tile row belong to other rows, updated by other threads
//     at the same time (the GPU form of the TPU kernel's touched-lanes-only
//     DMA).  Ids are unique (the dedup guarantees it), so no two threads
//     write one lane; an id outside [0, VPf*P) is skipped;
//   * the arithmetic is the twin's expressions in the twin's order, written
//     with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn so nvcc contracts
//     nothing into an fma: the kernel is bitwise equal to the twin on the
//     same (uids, gsum);
//   * 64-bit offsets: (u / P) * 128 passes int32 above ~2^28 logical rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

__device__ __forceinline__ float decayed(float acc, float decay) {
  return decay == 1.f ? acc : __fmul_rn(decay, acc);
}

__device__ __forceinline__ float step(float w, float g, float acc2, float lr) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(acc2)));
}

__global__ void __launch_bounds__(kThreads)
fused_slot_kernel(float* __restrict__ fused, const int* __restrict__ uids,
                  const float* __restrict__ gsum, int K, int D, int P, long long slots,
                  float lr, float decay) {
  const int d1 = D + 1;
  const int rows = blockDim.x / d1;
  const int r = threadIdx.x / d1;
  const int lane = threadIdx.x - r * d1;
  const long long k = (long long)blockIdx.x * rows + r;
  bool live = r < rows && k < K;
  const long long u = live ? (long long)__ldg(uids + k) : -1;
  live = live && u >= 0 && u < slots;
  float* slot = nullptr;
  float out = 0.f;
  if (live) {
    slot = fused + (u / P) * kLanes + (u % P) * d1;
    const float* gk = gsum + k * D;
    float sq = 0.f;
    for (int d = 0; d < D; ++d) {
      const float g = __ldg(gk + d);
      sq = __fadd_rn(sq, __fmul_rn(g, g));
    }
    const float acc2 = __fadd_rn(decayed(slot[D], decay), sq);
    out = lane < D ? step(slot[lane], __ldg(gk + lane), acc2, lr) : acc2;
  }
  __syncthreads();  // every lane of the row has read the accumulator
  if (live) slot[lane] = out;
}

}  // namespace

extern "C" int fused_tail_adagrad(float* fused, const int* uids, const float* gsum, int K,
                                  int D, long long VPf, float lr, float decay, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (K < 1 || D < 1 || D + 1 > kLanes || VPf < 1) return (int)cudaErrorInvalidValue;
  const int d1 = D + 1;
  const int P = kLanes / d1;
  const int rows = kThreads / d1;  // >= 2: D + 1 <= 128
  const long long blocks = ((long long)K + rows - 1) / rows;
  fused_slot_kernel<<<(unsigned)blocks, rows * d1, 0, s>>>(fused, uids, gsum, K, D, P,
                                                            VPf * P, lr, decay);
  return cudaGetLastError();
}
