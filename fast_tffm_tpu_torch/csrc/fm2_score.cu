// The order-2 FM score and its masked L2 term, forward and backward, over the
// step's gathered rows [B, N, D] (D = 1 + k: column 0 the bias w, columns 1..k
// the factors v) and the feature values vals [B, N] (0 marks padding):
//
//   forward   score[b]   = sum_i w_i x_i + 1/2 sum_f (s1_f^2 - s2_f),
//                          s1_f = sum_i v_if x_i,  s2_f = sum_i (v_if x_i)^2
//             s1[b, f]   = s1_f (saved for the backward; optional)
//             partial[b] = lam_b sum_i (m_i w_i)^2 + lam_f sum_i,f (m_i v_if)^2,
//                          m_i = (x_i != 0) (optional)
//   backward  d_w = g x + 2 lam_b g_reg m w
//             d_v = g x (s1 - v x) + 2 lam_f g_reg m v
//
// with g = d loss / d score[b] and g_reg = d loss / d (sum_b partial[b]).
// The wrapper sums partial[] with one torch.sum to the step's L2 term.
//
// Replaces no TPU kernel: the JAX package leaves order 2 to XLA, which fuses
// the score, its hand-derived backward and the L2 term into a few passes over
// the rows.  Under eager PyTorch the same composition
// (fast_tffm_tpu_torch/ops/fm.py: _FmScoreOrder2 + masked_l2, autograd
// around both) runs ~30 elementwise, reduction and copy kernels over the
// [B, N, D] rows and their gradient, most of an order-2 step's device time.
// The plain PyTorch version is that composition (ops/fm.py::fm2_score_l2 on a
// CPU tensor).
//
// What bounds it on an H100: memory.  The forward reads the rows once
// (4 B N D bytes) and vals once, and writes B (k + 2) floats; the backward
// reads rows, vals and s1 once and writes d_rows once.  About 6 flops a byte,
// far under the card's balance point.  At B 16,384, N 39, D 17: 46 MB
// forward and 89.5 MB backward, 40 us for the pair at 3.35 TB/s.
//
// Design:
//   * one warp per example (8 a block): an example's N*D floats are one
//     contiguous run (2,652 bytes at D 17), read with 16-byte loads, 8 in
//     flight a lane, into the warp's slice of shared memory (the forward),
//     or straight into registers (the backward, which is elementwise);
//   * the forward's reductions run in registers: lane c owns column c (and
//     c + 32, ...), sums over the N features in order, and the warp then
//     folds its lanes by an xor butterfly.  No atomics anywhere, so an
//     example's score and gradient depend on its own rows alone: bitwise the
//     same alone or in any batch, in any run, eager or in a CUDA graph;
//   * an example whose values and rows do not fit a warp's 6 KB share of a
//     block's 48 KB (N*D above ~1,500 floats) is read from device memory
//     directly, by the same arithmetic in the same order (no shape is
//     refused);
//   * the backward writes d_rows once, 16 bytes a lane, with the L2 term's
//     gradient folded in, and computes no d_vals (training never asks for
//     it; the wrapper refuses a CUDA tensor that does).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // examples a block: one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;  // 16-byte loads in flight a lane
// Shared memory a block may take without opting in (48 KB), in floats: each
// warp's slice holds one example's vals and rows.
constexpr int kBlockFloats = 48 * 1024 / 4;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The forward's arithmetic for example b, from `tile` (its N*D rows) and `xs`
// (its N values), each in shared or device memory: the same code, so the
// same bits, on either path.
__device__ inline void fm2_example(const float* tile, const float* xs, int N, int D, int lane,
                                   long long b, float lam_b, float lam_f, float* __restrict__ scores,
                                   float* __restrict__ s1, float* __restrict__ partial) {
  float lin = 0.f, inter = 0.f, pb = 0.f, pf = 0.f;
  for (int c = lane; c < D; c += 32) {
    float a = 0.f, q = 0.f, p = 0.f;
    for (int i = 0; i < N; ++i) {
      const float x = xs[i];
      const float r = tile[i * D + c];
      const float t = __fmul_rn(r, x);
      const float mr = x != 0.f ? r : 0.f;
      a = __fadd_rn(a, t);
      q = fmaf(t, t, q);
      p = fmaf(mr, mr, p);
    }
    if (c == 0) {
      lin = a;
      pb = p;
    } else {
      inter = __fadd_rn(inter, fmaf(a, a, -q));
      pf = __fadd_rn(pf, p);
      if (s1 != nullptr) s1[b * (D - 1) + (c - 1)] = a;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lin = __fadd_rn(lin, __shfl_xor_sync(0xffffffffu, lin, off));
    inter = __fadd_rn(inter, __shfl_xor_sync(0xffffffffu, inter, off));
    pb = __fadd_rn(pb, __shfl_xor_sync(0xffffffffu, pb, off));
    pf = __fadd_rn(pf, __shfl_xor_sync(0xffffffffu, pf, off));
  }
  if (lane == 0) {
    scores[b] = fmaf(0.5f, inter, lin);
    if (partial != nullptr) partial[b] = fmaf(lam_b, pb, __fmul_rn(lam_f, pf));
  }
}

// Copies the `len` floats at src[g0, g0 + len) into dst[o, o + len) with
// o = g0 % 4, so 16-byte loads from a 16-byte aligned src land on 16-byte
// aligned shared memory.  A warp's lanes share the work.
__device__ inline void warp_stage(const float* __restrict__ src, long long g0, int len,
                                  float* dst, int lane, bool aligned) {
  if (!aligned) {
    for (int j = lane; j < len; j += 32) dst[j] = __ldg(src + g0 + j);
    return;
  }
  const int o = (int)(g0 & 3);
  const int head = min(len, (4 - o) & 3);
  const int nb = (len - head) >> 2;
  const int tail0 = head + 4 * nb;
  if (lane < head) dst[o + lane] = __ldg(src + g0 + lane);
  if (lane < len - tail0) dst[o + tail0 + lane] = __ldg(src + g0 + tail0 + lane);
  const float4* s4 = reinterpret_cast<const float4*>(src + g0 + head);
  float4* d4 = reinterpret_cast<float4*>(dst + o + head);
  for (int q0 = lane; q0 < nb; q0 += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q0 + 32 * u < nb) v[u] = __ldg(s4 + q0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q0 + 32 * u < nb) d4[q0 + 32 * u] = v[u];
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
fm2_fwd_kernel(const float* __restrict__ rows, const float* __restrict__ vals,
               float* __restrict__ scores, float* __restrict__ s1, float* __restrict__ partial,
               int B, int N, int D, float lam_b, float lam_f, bool aligned, int slice) {
  extern __shared__ __align__(16) float slices[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // a whole warp leaves: the butterfly needs every lane
  const int len = N * D;
  const long long g0 = b * len;
  if (STAGED) {
    float* xs = slices + warp * slice;
    float* tile = xs + round4(N);
    for (int i = lane; i < N; i += 32) xs[i] = __ldg(vals + b * N + i);
    warp_stage(rows, g0, len, tile, lane, aligned);
    __syncwarp();
    fm2_example(tile + (aligned ? (int)(g0 & 3) : 0), xs, N, D, lane, b, lam_b, lam_f, scores,
                s1, partial);
  } else {
    fm2_example(rows + g0, vals + b * N, N, D, lane, b, lam_b, lam_f, scores, s1, partial);
  }
}

// d_rows at flat element j of example b (column c, feature i).
__device__ inline float fm2_grad(float r, int i, int c, const float* __restrict__ xb,
                                 const float* __restrict__ s1b, float g, float cb, float cf) {
  const float x = __ldg(xb + i);
  const float mr = x != 0.f ? r : 0.f;
  const float gx = __fmul_rn(g, x);
  if (c == 0) return fmaf(cb, mr, gx);
  const float resid = __fsub_rn(__ldg(s1b + (c - 1)), __fmul_rn(r, x));
  return fmaf(cf, mr, __fmul_rn(gx, resid));
}

__global__ void __launch_bounds__(kThreads)
fm2_bwd_kernel(const float* __restrict__ rows, const float* __restrict__ vals,
               const float* __restrict__ s1, const float* __restrict__ g_score,
               const float* __restrict__ g_reg, float* __restrict__ d_rows, int B, int N, int D,
               float lam_b, float lam_f, bool aligned) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;
  const int len = N * D;
  const long long g0 = b * len;
  const float* xb = vals + b * N;
  const float* s1b = s1 + b * (D - 1);
  const float g = __ldg(g_score + b);
  const float gr = g_reg != nullptr ? __ldg(g_reg) : 0.f;
  const float cb = __fmul_rn(__fmul_rn(2.f, lam_b), gr);
  const float cf = __fmul_rn(__fmul_rn(2.f, lam_f), gr);
  const float* src = rows + g0;
  float* dst = d_rows + g0;
  // Scalar head and tail around the 16-byte aligned body (the whole run
  // when a pointer is not 16-byte aligned).
  const int o = (int)(g0 & 3);
  const int head = aligned ? min(len, (4 - o) & 3) : len;
  const int nb = aligned ? (len - head) >> 2 : 0;
  const int tail0 = head + 4 * nb;
  for (int j = lane; j < head; j += 32)
    dst[j] = fm2_grad(__ldg(src + j), j / D, j % D, xb, s1b, g, cb, cf);
  for (int j = tail0 + lane; j < len; j += 32)
    dst[j] = fm2_grad(__ldg(src + j), j / D, j % D, xb, s1b, g, cb, cf);
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int q0 = lane; q0 < nb; q0 += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q0 + 32 * u < nb) v[u] = __ldg(s4 + q0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + 32 * u;
      if (q >= nb) continue;
      const int j = head + 4 * q;
      int i = j / D, c = j - i * D;
      float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        e[t] = fm2_grad(e[t], i, c, xb, s1b, g, cb, cf);
        if (++c == D) {
          c = 0;
          ++i;
        }
      }
      d4[q] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A warp's slice: the values, then the rows at offset g0 % 4 (<= 3), each
// from a 16-byte boundary.
int slice_floats(int N, int D) { return round4(N) + round4(N * D) + 4; }

}  // namespace

// scores [B] is written; s1 [B, D - 1] and partial [B] only when not null.
extern "C" int fm2_score_fwd(const float* rows, const float* vals, float* scores, float* s1,
                             float* partial, int B, int N, int D, float lam_b, float lam_f,
                             cudaStream_t s) {
  cudaGetLastError();  // clear a stale error of this runtime before launching
  if (B < 1 || N < 0 || D < 1 || (long long)N * D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B + kWarps - 1) / kWarps);
  const bool al = aligned16(rows);
  const long long slice = slice_floats(N, D);
  if (kWarps * slice <= kBlockFloats) {
    fm2_fwd_kernel<true><<<blocks, kThreads, kWarps * slice * sizeof(float), s>>>(
        rows, vals, scores, s1, partial, B, N, D, lam_b, lam_f, al, (int)slice);
  } else {
    fm2_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(rows, vals, scores, s1, partial, B, N, D,
                                                      lam_b, lam_f, al, 0);
  }
  return (int)cudaGetLastError();
}

// d_rows [B, N, D] is written whole; g_reg (one float) may be null: no L2 term.
extern "C" int fm2_score_bwd(const float* rows, const float* vals, const float* s1,
                             const float* g_score, const float* g_reg, float* d_rows, int B,
                             int N, int D, float lam_b, float lam_f, cudaStream_t s) {
  cudaGetLastError();
  if (B < 1 || N < 0 || D < 1 || (long long)N * D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)B + kWarps - 1) / kWarps);
  fm2_bwd_kernel<<<blocks, kThreads, 0, s>>>(rows, vals, s1, g_score, g_reg, d_rows, B, N, D,
                                             lam_b, lam_f, aligned16(rows) && aligned16(d_rows));
  return (int)cudaGetLastError();
}
