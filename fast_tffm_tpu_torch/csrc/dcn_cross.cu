// The DCN-V2 cross layer's combine and its backward, over [B, d] float32
// rows (d = N k, an example's value-weighted embeddings end to end):
//
//   forward   y    = x0 * (h + c) + xl
//   backward  d_h  = g * x0
//             d_x0 = g * (h + c)      written, or added into d_x0 in place
//             part[p, j] = sum of d_h[r, j] over the rows r of chunk p
//
// with h = U (V^T x_l) the layer's low-rank product (cuBLAS, outside), c the
// layer's bias [d] and g = d loss / d y.  d loss / d xl is g itself (the
// wrapper hands it on with no copy) and d loss / d c is the column sum of the
// partials, one fixed-order torch.sum in the wrapper.
//
// Replaces no TPU kernel: DCN-V2 is the port's own model, with no JAX twin.
// Under eager PyTorch the combine and its backward are about nine
// elementwise and reduction kernels a layer (add, multiply, add; and
// autograd's products, sum and the x0 gradients' adds across layers); these
// two do it in one pass each.  The plain PyTorch version is
// fast_tffm_tpu_torch/ops/dcn.py's twin, which the wrapper runs on a CPU
// tensor.
//
// What bounds it on an H100: memory.  About a flop for each 4 bytes moved.
// The forward reads x0, h and xl once and writes y once: 16 B an element.
// The backward reads g, x0 and h once and writes d_h and d_x0 once: 20 B an
// element (24 when it adds into d_x0, which the algorithm does not need:
// the sum over the layers could be kept in registers only by a kernel that
// runs every layer's backward at once).  At DCN-V2's cell, B 8,192 and d
// 4,992, that is 0.654 GB forward and 0.818 GB backward a layer, 0.195 and
// 0.244 ms at 3.35 TB/s.
//
// Design:
//   * a thread owns 4 neighbouring columns (one 16-byte load a tensor a row;
//     1 column when d is not a multiple of 4 or a pointer is not 16-byte
//     aligned) and walks kRows rows, kUnroll rows of loads in flight, so a
//     warp reads 512 contiguous bytes of each tensor a row;
//   * every element is written by one thread once, and the bias partials are
//     summed by each thread over its chunk's rows in row order: no atomics,
//     so the bits do not depend on the run, the launch or a CUDA graph;
//   * the rounding is the twin's, each product and sum rounded on its own
//     (__fmul_rn, __fadd_rn: no fused multiply-add), so y, d_h and d_x0 are
//     bitwise the twin's on the card; the bias sum runs in another order.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // column groups a block
constexpr int kRows = 32;      // rows a block walks: one chunk of the bias partials
constexpr int kUnroll = 4;     // rows of loads in flight a thread

template <int V>
__device__ inline void load_nc(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// A load of memory this kernel writes (d_x0 in place): no read-only path.
template <int V>
__device__ inline void load_rw(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ inline void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
dcn_cross_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ xl,
                     float* __restrict__ y, int B, int d) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= d) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(B, r0 + kRows);
  float cv[V];
  load_nc<V>(c + col, cv);
  for (int r = r0; r < r1; r += kUnroll) {
    float a[kUnroll][V], b[kUnroll][V], x[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u >= r1) continue;
      const long long o = (long long)(r + u) * d + col;
      load_nc<V>(x0 + o, a[u]);
      load_nc<V>(h + o, b[u]);
      load_nc<V>(xl + o, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u >= r1) continue;
      float out[V];
#pragma unroll
      for (int t = 0; t < V; ++t)
        out[t] = __fadd_rn(__fmul_rn(a[u][t], __fadd_rn(b[u][t], cv[t])), x[u][t]);
      store<V>(y + (long long)(r + u) * d + col, out);
    }
  }
}

// mode 0: no d_x0; 1: d_x0 written; 2: added into d_x0 in place.
template <int V>
__global__ void __launch_bounds__(kThreads)
dcn_cross_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                     const float* __restrict__ h, const float* __restrict__ c,
                     float* __restrict__ d_h, float* __restrict__ d_x0,
                     float* __restrict__ partial, int B, int d, int mode) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= d) return;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(B, r0 + kRows);
  float cv[V], s[V];
  load_nc<V>(c + col, cv);
#pragma unroll
  for (int t = 0; t < V; ++t) s[t] = 0.f;
  for (int r = r0; r < r1; r += kUnroll) {
    float gv[kUnroll][V], a[kUnroll][V], b[kUnroll][V], acc[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u >= r1) continue;
      const long long o = (long long)(r + u) * d + col;
      load_nc<V>(g + o, gv[u]);
      load_nc<V>(x0 + o, a[u]);
      if (mode != 0) load_nc<V>(h + o, b[u]);
      if (mode == 2) load_rw<V>(d_x0 + o, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u >= r1) continue;
      const long long o = (long long)(r + u) * d + col;
      float dh[V];
#pragma unroll
      for (int t = 0; t < V; ++t) {
        dh[t] = __fmul_rn(gv[u][t], a[u][t]);
        s[t] = __fadd_rn(s[t], dh[t]);
      }
      store<V>(d_h + o, dh);
      if (mode == 0) continue;
      float dx[V];
#pragma unroll
      for (int t = 0; t < V; ++t) {
        dx[t] = __fmul_rn(gv[u][t], __fadd_rn(b[u][t], cv[t]));
        if (mode == 2) dx[t] = __fadd_rn(acc[u][t], dx[t]);
      }
      store<V>(d_x0 + o, dx);
    }
  }
  store<V>(partial + (long long)blockIdx.y * d + col, s);
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_shape(int B, int d) {
  return B < 1 || d < 1 || (B + kRows - 1) / kRows > 65535;
}

dim3 grid(int B, int d, int v) {
  const int groups = (d + v - 1) / v;
  return dim3((groups + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
}

}  // namespace

// The rows of one chunk of the bias partials: the backward writes
// ceil(B / rows) partial rows of d floats.
extern "C" int dcn_cross_chunk_rows() { return kRows; }

// y [B, d] is written.
extern "C" int dcn_cross_fwd(const float* x0, const float* h, const float* c, const float* xl,
                             float* y, int B, int d, cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (bad_shape(B, d)) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(x0) && aligned16(h) && aligned16(c) &&
                   aligned16(xl) && aligned16(y);
  if (vec) {
    dcn_cross_fwd_kernel<4><<<grid(B, d, 4), kThreads, 0, s>>>(x0, h, c, xl, y, B, d);
  } else {
    dcn_cross_fwd_kernel<1><<<grid(B, d, 1), kThreads, 0, s>>>(x0, h, c, xl, y, B, d);
  }
  return (int)cudaGetLastError();
}

// d_h [B, d] and partial [ceil(B / rows), d] are written; d_x0 [B, d] per
// mode (0: untouched, may be null; 1: written; 2: added into).
extern "C" int dcn_cross_bwd(const float* g, const float* x0, const float* h, const float* c,
                             float* d_h, float* d_x0, float* partial, int B, int d, int mode,
                             cudaStream_t s) {
  cudaGetLastError();
  if (bad_shape(B, d) || mode < 0 || mode > 2 || (mode != 0 && d_x0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && aligned16(g) && aligned16(x0) && aligned16(h) &&
                   aligned16(c) && aligned16(d_h) && aligned16(d_x0) && aligned16(partial);
  if (vec) {
    dcn_cross_bwd_kernel<4><<<grid(B, d, 4), kThreads, 0, s>>>(g, x0, h, c, d_h, d_x0, partial,
                                                                B, d, mode);
  } else {
    dcn_cross_bwd_kernel<1><<<grid(B, d, 1), kThreads, 0, s>>>(g, x0, h, c, d_h, d_x0, partial,
                                                                B, d, mode);
  }
  return (int)cudaGetLastError();
}
