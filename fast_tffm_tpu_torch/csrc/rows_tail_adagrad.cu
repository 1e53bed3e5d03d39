// Sparse Adagrad on a [V, D] table with a [V, A] accumulator, A in
// {1 (row), D (element)}, in place, straight from the step's sorted ids:
//   g   = sum of row_grads[order[j]] over the id's occurrences (in order)
//   acc <- decay*acc + g*g   (row accumulator: + sum_d g_d^2)
//   w   <- w - (lr*g) / sqrt(acc)
// for every unique id in [0, V) of sid (the stable sort of the M flat ids,
// with its int64 permutation order).  tail_segment.cuh holds the pass over
// the sorted occurrences: heads, segment sums, the warp and block paths.
//
// Replaces the TPU kernel fast_tffm_tpu/ops/pallas_tail.py::_rows_kernel
// (reached through rows_tail_adagrad_update) AND the dedup before it
// (optim.dedup_rows' permuted copy, unique_consecutive, segment_reduce):
// the wrapper runs only torch.sort, as the JAX package leaves its sort to
// XLA outside the pallas_call.  The plain PyTorch version is
// fast_tffm_tpu_torch/ops/tail.py::rows_tail_sorted_plain (the same sorted
// input through optim.sorted_segment_sum and optim.adagrad_rows_plain).
//
// What bounds it on an H100: memory, on random rows.  Per occurrence it
// reads the sorted id (4 B), the sort's index (8 B) and the gradient row
// (4D B); per unique row it reads and writes the D table floats and the A
// accumulator floats.  At the first baseline5 batch (M = 180,224
// occurrences, K = 143,865 unique rows, D = 9): 8.65 MB + 144 B/row in
// element mode = 29.37 MB, 8.77 us at 3.35 TB/s; 8.65 MB + 80 B/row in row
// mode = 20.16 MB, 6.02 us.  The card moves whole 32-byte sectors, and a
// random 36-byte row spans two of them: counted in sectors the same work
// is 15.1 us (element) and 12.3 us (row), the floor random rows set.
//
// Design:
//   * the dedup is folded in: each occurrence is read once, straight from
//     the sort's output, and no host sync waits on the count of unique ids;
//   * a group of D lanes per row (element mode: lane d owns element d, no
//     cross-lane exchange; row mode: sum_d g_d^2 by __shfl_sync in d order,
//     and lane 0, the only lane that reads or writes accum[id], broadcasts
//     it), no 64-bit division per thread;
//   * the table/accumulator loads depend only on the id, and are issued
//     with the gradient loads, so the two random streams overlap;
//   * the arithmetic is the twin's expressions in the twin's order, written
//     with __fadd_rn/__fmul_rn/__fdiv_rn/__fsqrt_rn so nvcc contracts
//     nothing into an fma: the kernel is bitwise equal to the twin on the
//     same (sid, order, row_grads), in both modes and at any decay.

#include "tail_segment.cuh"

namespace {

using tail::decayed;
using tail::step;

// A = D: each lane its own table and accumulator element.
struct Element {
  static constexpr int kVpl = 1;
  float* table;
  float* accum;
  int D, W;
  long long bound;
  float lr, decay;

  struct Row {
    float w, a;
  };

  __device__ __forceinline__ Row load(int s, int e0) const {
    Row r{0.f, 0.f};
    if (e0 < D) {
      const long long o = (long long)s * D + e0;
      r.w = table[o];
      r.a = accum[o];
    }
    return r;
  }

  template <class Comm>
  __device__ __forceinline__ void update(const Row& r, int s, int e0, const float (&gs)[1],
                                         const Comm&, bool write) const {
    if (!write || e0 >= D) return;
    const long long o = (long long)s * D + e0;
    const float acc2 = __fadd_rn(decayed(r.a, decay), __fmul_rn(gs[0], gs[0]));
    table[o] = step(r.w, gs[0], acc2, lr);
    accum[o] = acc2;
  }
};

// A = 1: the row's one accumulator, read and written by lane 0 alone.
struct RowAcc {
  static constexpr int kVpl = 1;
  float* table;
  float* accum;
  int D, W;
  long long bound;
  float lr, decay;

  struct Row {
    float w, a;
  };

  __device__ __forceinline__ Row load(int s, int e0) const {
    Row r{0.f, 0.f};
    if (e0 < D) r.w = table[(long long)s * D + e0];
    if (e0 == 0) r.a = accum[s];
    return r;
  }

  template <class Comm>
  __device__ __forceinline__ void update(const Row& r, int s, int e0, const float (&gs)[1],
                                         const Comm& comm, bool write) const {
    const float sq = comm.norm(gs, D);
    const float acc2 = __fadd_rn(decayed(comm.bcast(r.a, 0), decay), sq);
    if (!write || e0 >= D) return;
    table[(long long)s * D + e0] = step(r.w, gs[0], acc2, lr);
    if (e0 == 0) accum[s] = acc2;
  }
};

// Named for the profiler: chip_smoke.py finds the kernels by these names.
__global__ void __launch_bounds__(tail::kThreads, tail::kMinBlocks)
rows_element_kernel(const Element mode, const int* __restrict__ sid,
                    const long long* __restrict__ order, const float* __restrict__ g, int M) {
  tail::run(mode, sid, order, g, M);
}

__global__ void __launch_bounds__(tail::kThreads, tail::kMinBlocks)
rows_row_kernel(const RowAcc mode, const int* __restrict__ sid,
                const long long* __restrict__ order, const float* __restrict__ g, int M) {
  tail::run(mode, sid, order, g, M);
}

}  // namespace

extern "C" int rows_tail_adagrad(float* table, float* accum, const int* sid,
                                 const long long* order, const float* row_grads, int M, int D,
                                 int A, long long V, float lr, float decay, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (M < 1 || D < 1 || D > tail::kThreads || V < 1 || (A != 1 && A != D) ||
      (long long)M * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int blocks = tail::blocks(M, D);
  if (A == D) {
    const Element mode{table, accum, D, D, V, lr, decay};
    rows_element_kernel<<<blocks, tail::kThreads, 0, s>>>(mode, sid, order, row_grads, M);
  } else {
    const RowAcc mode{table, accum, D, D, V, lr, decay};
    rows_row_kernel<<<blocks, tail::kThreads, 0, s>>>(mode, sid, order, row_grads, M);
  }
  return cudaGetLastError();
}
