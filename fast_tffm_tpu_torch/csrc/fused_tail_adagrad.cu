// Sparse row-Adagrad on the FUSED layout, in place, straight from the
// step's sorted ids:
//   g   = sum of row_grads[order[j]] over the id's occurrences (in order)
//   acc <- decay*acc + sum_d g_d^2      (summed left to right in d)
//   w_d <- w_d - (lr*g_d) / sqrt(acc)
// on a [VPf, 128] float32 array holding P = 128 / (D+1) slots per 128-lane
// row: logical row u lives in tile row u / P, its D parameters at lanes
// [(u % P)*(D+1), (u % P)*(D+1) + D) and its accumulator at the lane after.
// tail_segment.cuh holds the pass over the sorted occurrences.
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_tail.py::_fused_kernel
// (reached through fused_tail_adagrad_update -> _fused_rmw) AND the dedup
// before it (optim.dedup_rows): the wrapper runs only torch.sort, as the
// JAX package leaves its sort to XLA outside the pallas_call.  The plain
// PyTorch version is fast_tffm_tpu_torch/ops/tail.py::fused_tail_sorted_plain.
//
// What bounds it on an H100: memory, on random slots.  Per occurrence it
// reads the sorted id (4 B), the sort's index (8 B) and the gradient row
// (4D B); per unique row it reads and writes the slot's D+1 floats.  At the
// first baseline5 batch (M = 180,224, K = 143,865, D = 9): 8.65 MB +
// 80 B/row = 20.16 MB, 6.02 us at 3.35 TB/s; counted in the 32-byte sectors
// the card moves (a 40-byte slot and a 36-byte gradient row span two each),
// 9.6 us.
//
// Design:
//   * the dedup is folded in: each occurrence is read once, straight from
//     the sort's output, and no host sync waits on the count of unique ids;
//   * a row's slot lanes are a group within one warp: sum_d g_d^2 comes by
//     __shfl_sync in d order, and the lane that holds the accumulator --
//     the only one that reads or writes it -- broadcasts it; no block
//     barrier couples unrelated rows, and no lane re-reads the gradients;
//   * where D+1 is even every slot starts 8-byte aligned, and a lane moves
//     two lanes of the slot as one float2 (VPL = 2): half the lanes per
//     row, twice the groups per warp (6 at D = 9);
//   * the slot loads depend only on the id and are issued with the
//     gradient loads, so the two random streams overlap;
//   * no thread writes outside the slot of its own row: the other slots of
//     a tile row belong to other rows, updated at the same time (the GPU
//     form of the TPU kernel's touched-lanes-only DMA).  An id outside
//     [0, VPf*P) is skipped;
//   * the arithmetic is the twin's expressions in the twin's order, written
//     with __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn so nvcc contracts
//     nothing into an fma: the kernel is bitwise equal to the twin, and,
//     unpacked, to the rows kernel in row mode;
//   * 64-bit offsets: (u / P) * 128 passes int32 above ~2^24 tile rows.

#include "tail_segment.cuh"

namespace {

using tail::decayed;
using tail::step;

constexpr int kLanes = 128;

template <int VPL>
struct FusedSlot {
  static constexpr int kVpl = VPL;
  float* fused;
  int D, W, P;
  long long bound;
  float lr, decay;

  struct Row {
    float x[VPL];
  };

  __device__ __forceinline__ float* slot(int s) const {
    return fused + (long long)(s / P) * kLanes + (s % P) * (D + 1);
  }

  __device__ __forceinline__ Row load(int s, int e0) const {
    Row r;
#pragma unroll
    for (int v = 0; v < VPL; ++v) r.x[v] = 0.f;
    if (e0 <= D) {
      const float* p = slot(s) + e0;
      if constexpr (VPL == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(p);
        r.x[0] = v2.x;
        r.x[VPL - 1] = v2.y;
      } else {
        r.x[0] = *p;
      }
    }
    return r;
  }

  // Element D, the accumulator, is component VPL-1 of lane D / VPL (VPL = 2
  // only where D is odd).
  template <class Comm>
  __device__ __forceinline__ void update(const Row& r, int s, int e0, const float (&gs)[VPL],
                                         const Comm& comm, bool write) const {
    const float sq = comm.norm(gs, D);
    const float acc2 = __fadd_rn(decayed(comm.bcast(r.x[VPL - 1], D / VPL), decay), sq);
    if (!write || e0 > D) return;
    float y[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) y[v] = e0 + v < D ? step(r.x[v], gs[v], acc2, lr) : acc2;
    float* p = slot(s) + e0;
    if constexpr (VPL == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(y[0], y[VPL - 1]);
    } else {
      *p = y[0];
    }
  }
};

// Named for the profiler: chip_smoke.py finds the kernel by this name.
template <int VPL>
__global__ void __launch_bounds__(tail::kThreads, tail::kMinBlocks)
fused_slot_kernel(const FusedSlot<VPL> mode, const int* __restrict__ sid,
                  const long long* __restrict__ order, const float* __restrict__ g, int M) {
  tail::run(mode, sid, order, g, M);
}

template <int VPL>
int launch(float* fused, const int* sid, const long long* order, const float* g, int M, int D,
           long long VPf, float lr, float decay, cudaStream_t s) {
  const int P = kLanes / (D + 1);
  const int W = (D + 1 + VPL - 1) / VPL;
  const FusedSlot<VPL> mode{fused, D, W, P, VPf * P, lr, decay};
  fused_slot_kernel<VPL><<<tail::blocks(M, W), tail::kThreads, 0, s>>>(mode, sid, order, g, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_tail_adagrad(float* fused, const int* sid, const long long* order,
                                  const float* row_grads, int M, int D, long long VPf, float lr,
                                  float decay, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (M < 1 || D < 1 || D + 1 > kLanes || VPf < 1 || (long long)M * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((D + 1) % 2 == 0)
    return launch<2>(fused, sid, order, row_grads, M, D, VPf, lr, decay, s);
  return launch<1>(fused, sid, order, row_grads, M, D, VPf, lr, decay, s);
}
