// The device side of fast_tffm_tpu_torch/utils/tracing.py's spans: a
// one-thread kernel that does nothing, launched at a span's entry
// (span_mark<ID, 1>) and at its exit (span_mark<ID, 0>) on the current
// stream.  A CUDA-graph capture records it like any other launch, so every
// replay of a graph captured with spans on carries its span boundaries on
// the device timeline, on the trace's own clock, and a profiler trace
// names each boundary by the kernel's name.  ID indexes tracing.py's
// DEVICE_SPANS table.
//
// Replaces no TPU kernel: the JAX package's spans are host annotations
// around whole jitted programs.  What bounds it on an H100: launch latency
// alone (one thread, no memory traffic), about a microsecond a node in a
// graph replay.  Its design: no arguments and no body, so a marker moves no
// byte and cannot perturb the kernels around it; one instantiation per
// (ID, boundary), so the name alone says which span it opens or closes.

#include <cuda_runtime.h>

namespace {

constexpr int kSpanIds = 16;

template <int ID, int BEGIN>
__global__ void span_mark() {}

#define SPAN_MARK_PAIR(i) {span_mark<i, 0>, span_mark<i, 1>}

void (*const kMarks[kSpanIds][2])() = {
    SPAN_MARK_PAIR(0),  SPAN_MARK_PAIR(1),  SPAN_MARK_PAIR(2),  SPAN_MARK_PAIR(3),
    SPAN_MARK_PAIR(4),  SPAN_MARK_PAIR(5),  SPAN_MARK_PAIR(6),  SPAN_MARK_PAIR(7),
    SPAN_MARK_PAIR(8),  SPAN_MARK_PAIR(9),  SPAN_MARK_PAIR(10), SPAN_MARK_PAIR(11),
    SPAN_MARK_PAIR(12), SPAN_MARK_PAIR(13), SPAN_MARK_PAIR(14), SPAN_MARK_PAIR(15),
};

}  // namespace

extern "C" int span_mark_launch(int id, int begin, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (id < 0 || id >= kSpanIds || (begin != 0 && begin != 1))
    return (int)cudaErrorInvalidValue;
  cudaLaunchKernel((const void*)kMarks[id][begin], dim3(1), dim3(1), nullptr, 0, s);
  return cudaGetLastError();
}
