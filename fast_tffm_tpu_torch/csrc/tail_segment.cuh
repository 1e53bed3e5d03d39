// The sparse Adagrad tails' common pass over SORTED occurrences:
// rows_tail_adagrad.cu (kernel B4) and fused_tail_adagrad.cu (kernel B3).
//
// Input: the stable sort of the step's M flat ids, sid[M] (int32) and
// order[M] (the sort's int64 permutation), and row_grads[M, D] in
// occurrence order.  Position p is a row head when p == 0 or
// sid[p] != sid[p-1].  For a head whose id lies in [0, bound), the pass sums
// row_grads[order[j], d] over the head's segment (j from p while
// sid[j] == sid[p]) left to right from 0.0f with __fadd_rn -- the order of
// torch.segment_reduce over the stable sort, i.e. of optim.dedup_rows --
// then hands the sum to the layout's read-modify-write ("Mode", defined
// in each .cu).  Positions that are not heads do no work; an id outside
// [0, bound) is skipped and never written.  Heads are unique per launch,
// so no two rows' writes overlap.  The dedup's permuted copy, its
// unique_consecutive (a host sync) and its segment_reduce are gone: the
// kernel reads each occurrence once, straight from the sort's output.
//
// Mapping:
//   * warp path (a row's W lanes fit in a warp): a group of W lanes owns
//     kRun contiguous positions; lane l owns elements e = l*VPL ..
//     l*VPL + VPL - 1 of a row.  A warp holds 32 / W groups, a block 8
//     warps.  Round 1 loads the positions' ids (and one neighbour each
//     side: heads, and whether a segment goes on), their sort indices and
//     the ids kLong further on; round 2 issues every head's table/
//     accumulator (or slot) loads and every position's gradient row at
//     once, so a segment within the group's positions is summed from
//     registers; one that runs past them is summed on, kUnroll
//     occurrences' loads at a time.  The adds stay in order.  A row's sum of g_d^2 is gathered with
//     __shfl_sync in d order, and the accumulator, read by the one lane
//     that writes it, is broadcast with __shfl_sync: no lane reads global
//     memory another lane writes, and no barrier couples unrelated rows.
//   * block path: a segment longer than kLong occurrences (sid[p + kLong]
//     == sid[p]), and every row when W > 32, is summed by the whole block
//     after its warps' rows are done, in chunks of C occurrences through a
//     two-buffer pipeline in shared memory (block_sum): the producer warps
//     stage one chunk while thread d of the first warp adds column d of
//     the previous one, in order.  One id with 169K occurrences (a padded last batch: pad_batch
//     fills it with id 0) is one serial chain of 169K adds, the floor of
//     any left-to-right sum.
//   * 32-bit index arithmetic for positions and gradient offsets (the
//     wrapper checks M * D < 2^31); 64-bit offsets into the table.

#pragma once

#include <cuda_runtime.h>

namespace tail {

constexpr int kThreads = 256;       // threads per block
constexpr int kMinBlocks = 4;       // blocks an SM holds: at most 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 4;             // contiguous positions per warp group
constexpr int kUnroll = 4;          // a short segment's occurrences loaded at once
constexpr int kLong = 32;           // longer segments take the block path
constexpr int kWidePositions = 64;  // positions per block when W > 32
// Long heads are > kLong positions apart, and a block spans at most
// kWarps * 32 * kRun positions (W = 1): at most 33 long heads, or
// kWidePositions heads on the wide path.
constexpr int kListMax = 64;
constexpr int kSmemWords = 6144;    // the block path's two chunks (24 KB)
constexpr int kStage = 8;          // a chunk's gradient loads per staging thread
constexpr int kScan = 2;            // a chunk's positions per staging thread
constexpr int kAddBatch = 8;        // shared-memory loads ahead of a column's adds

__device__ __forceinline__ float decayed(float acc, float decay) {
  return decay == 1.f ? acc : __fmul_rn(decay, acc);
}

// w - (lr*g)/sqrt(acc2), with no contraction into an fma: the twins'
// expressions, in their order.
__device__ __forceinline__ float step(float w, float g, float acc2, float lr) {
  return __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(acc2)));
}

// A row's exchange within its warp group, whose first lane is `base`.
// Every lane of the warp takes part in each shuffle.
struct GroupComm {
  int base;

  // sum over d = 0..D-1 of g_d^2, left to right from 0 (optim.accum_sq's order).
  template <int VPL>
  __device__ __forceinline__ float norm(const float (&gs)[VPL], int D) const {
    float sq = 0.f;
    for (int q = 0; q * VPL < D; ++q) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const float x = __shfl_sync(0xffffffffu, gs[v], base + q);
        if (q * VPL + v < D) sq = __fadd_rn(sq, __fmul_rn(x, x));
      }
    }
    return sq;
  }

  __device__ __forceinline__ float bcast(float x, int src) const {
    return __shfl_sync(0xffffffffu, x, base + src);
  }
};

// The same exchange for a row the whole block handles: the summed row is in
// shared memory.
struct BlockComm {
  const float* gsh;
  float* bsh;

  template <int VPL>
  __device__ __forceinline__ float norm(const float (&)[VPL], int D) const {
    float sq = 0.f;
    for (int d = 0; d < D; ++d) sq = __fadd_rn(sq, __fmul_rn(gsh[d], gsh[d]));
    return sq;
  }

  __device__ __forceinline__ float bcast(float x, int src) const {
    if ((int)threadIdx.x == src) *bsh = x;
    __syncthreads();
    return *bsh;
  }
};

// Adds to gs the rest of a short segment, from position j0 on: elements
// e0 .. e0+VPL-1, kUnroll occurrences' loads at once, the adds in order.
template <int VPL>
__device__ __forceinline__ void group_sum_rest(const int* sid, const long long* order,
                                               const float* g, int M, int D, int j0, int s,
                                               int e0, float (&gs)[VPL]) {
  for (;; j0 += kUnroll) {
    bool in[kUnroll];
    float x[kUnroll][VPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      in[u] = j < M && __ldg(sid + j) == s;  // sorted: the segment is a prefix
      const int o = j < M ? (int)__ldg(order + j) : 0;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int e = e0 + v;
        x[u][v] = in[u] && e < D ? __ldg(g + o * D + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (in[u]) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) gs[v] = __fadd_rn(gs[v], x[u][v]);
      }
    }
    if (!in[kUnroll - 1]) return;
  }
}

// One chunk's positions [j0, j0 + C), scanned by producer q of NP: which
// lie in the segment (a prefix), and their gradient rows.
struct Scan {
  bool in[kScan];
  int row[kScan];

  __device__ __forceinline__ void load(const int* sid, const long long* order, int M, int C,
                                       int j0, int s, int q, int NP) {
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int r = q + k * NP, j = j0 + r;
      const bool ok = r < C && j < M;
      in[k] = ok && __ldg(sid + j) == s;
      row[k] = ok ? (int)__ldg(order + j) : 0;
    }
  }

  // rows[r] for the positions in the segment; *n ends at its length in
  // this chunk (*n starts at C).
  __device__ __forceinline__ void store(int C, int q, int NP, int* rows, int* n) const {
#pragma unroll
    for (int k = 0; k < kScan; ++k) {
      const int r = q + k * NP;
      if (r < C) {
        if (in[k]) rows[r] = row[k];
        else atomicMin(n, r);
      }
    }
  }
};

// The whole block sums the segment of head h (id s) into gsh[0..D), in
// order.  Every thread calls it; D <= kThreads.  Threads d < D add column d
// (the adders); the threads of the warps after them (all threads when
// D > 128) scan and stage (the producers).  Chunks of C occurrences go
// through a software pipeline over two shared buffers: in one step the
// producers issue the scan of chunk c+1 and the gradient loads of chunk c
// (its rows found by the step before) while the adders add chunk c-1, and
// then the loads land in shared memory.  A producer owns one column qd of
// rows qr, qr + R, ...: no division in the loop, and a chunk's loads are
// one round trip.
__device__ __forceinline__ void block_sum(const int* sid, const long long* order, const float* g,
                                          int M, int D, int h, int s, float* smem, int* nsh,
                                          float* gsh) {
  const int t = threadIdx.x;
  const int P0 = D <= 128 ? 32 * ((D + 31) / 32) : 0;  // the first producer
  const int NP = kThreads - P0, R = NP / D, q = t - P0;
  const bool producer = q >= 0, stager = producer && q < R * D;
  const int qd = stager ? q % D : 0, qr = stager ? q / D : 0;
  const int C = min(min((kSmemWords / 2 - D) / (D + 1), kStage * R), kScan * NP);
  // buffer b: D columns of C + 1 floats (the pad spreads a column's reads
  // over the banks) at smem + b * D * (C + 1); its rows at rows0 + b * C
  int* rows0 = reinterpret_cast<int*>(smem + 2 * D * (C + 1));
  float acc = 0.f;

  auto add_chunk = [&](const float* b, int n) {
    if (t >= D) return;
    const float* col = b + t * (C + 1);
    int r = 0;
    for (; r + kAddBatch <= n; r += kAddBatch) {
      float x[kAddBatch];
#pragma unroll
      for (int u = 0; u < kAddBatch; ++u) x[u] = col[r + u];
#pragma unroll
      for (int u = 0; u < kAddBatch; ++u) acc = __fadd_rn(acc, x[u]);
    }
    for (; r < n; ++r) acc = __fadd_rn(acc, col[r]);
  };

  if (t == 0) nsh[0] = nsh[1] = C;
  __syncthreads();
  if (producer) {
    Scan sc;
    sc.load(sid, order, M, C, h, s, q, NP);
    sc.store(C, q, NP, rows0, &nsh[0]);
  }
  __syncthreads();
  int n_prev = 0;
  for (int c = 0;; ++c) {
    const int b = c & 1, n = nsh[c % 3];
    const bool more = n == C;
    float* buf = smem + b * D * (C + 1);
    if (t == 0) nsh[(c + 2) % 3] = C;
    if (producer) {
      Scan sc;
      if (more) sc.load(sid, order, M, C, h + (c + 1) * C, s, q, NP);
      float x[kStage];
      const int* rows = rows0 + b * C;
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int r = qr + k * R;
        if (stager && r < n) x[k] = __ldg(g + rows[r] * D + qd);
      }
      if (c > 0 && t < D) add_chunk(smem + (b ^ 1) * D * (C + 1), n_prev);  // D > 128
      if (more) sc.store(C, q, NP, rows0 + (b ^ 1) * C, &nsh[(c + 1) % 3]);
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int r = qr + k * R;
        if (stager && r < n) buf[qd * (C + 1) + r] = x[k];
      }
    } else if (c > 0) {
      add_chunk(smem + (b ^ 1) * D * (C + 1), n_prev);
    }
    __syncthreads();
    n_prev = n;
    if (!more) {
      add_chunk(buf, n);
      break;
    }
  }
  if (t < D) gsh[t] = acc;
  __syncthreads();
}

// Blocks of the pass over M positions, for rows of W lanes.
inline int blocks(int M, int W) {
  const int per_block = W <= 32 ? kWarps * (32 / W) * kRun : kWidePositions;
  return (int)(((long long)M + per_block - 1) / per_block);
}

// The pass.  Mode supplies kVpl, D, the row's lanes W, the id bound, and
//   Row load(int s, int e0)     the row's elements e0.. (before the sum)
//   void update(const Row&, int s, int e0, const float (&gs)[kVpl], const Comm&, bool write)
// Every lane of the warp (warp path) or thread of the block (block path)
// calls update, so its shuffles and barriers see every lane; a lane
// writes only with `write` (its group's position is a head) and only its
// own elements.
template <class Mode>
__device__ __forceinline__ void run(const Mode& mode, const int* sid, const long long* order,
                                    const float* g, int M) {
  constexpr int VPL = Mode::kVpl;
  __shared__ int nlist, nsh[3];
  __shared__ int list[kListMax];
  __shared__ float bsh;
  __shared__ float gsh[kThreads];
  __shared__ float smem[kSmemWords];
  if (threadIdx.x == 0) nlist = 0;
  __syncthreads();

  const int D = mode.D, W = mode.W;
  const int G = W <= 32 ? 32 / W : 0;  // groups per warp; 0: the block path only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (G > 0) {
    // Warp path: group gi owns positions p0 .. p0 + kRun - 1.  Round 1:
    // their ids (with one neighbour each side), sort indices and the ids
    // kLong further on; round 2: each head's row and every position's
    // gradient row.
    const int gi = lane / W, l = lane - gi * W, e0 = l * VPL;
    const int p0 = ((int)blockIdx.x * (kWarps * G) + warp * G + gi) * kRun;
    const bool live = gi < G && p0 < M;
    int sq[kRun + 2] = {}, o[kRun] = {}, far[kRun] = {};
    bool head[kRun];
    if (live) {
#pragma unroll
      for (int i = 0; i < kRun + 2; ++i) {
        const int j = p0 - 1 + i;
        if (j >= 0 && j < M) sq[i] = __ldg(sid + j);
      }
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (p0 + r < M) o[r] = (int)__ldg(order + p0 + r);
        if (p0 + r + kLong < M) far[r] = __ldg(sid + p0 + r + kLong);
      }
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int p = p0 + r, s = sq[r + 1];
      head[r] = live && p < M && (p == 0 || sq[r] != s) && s >= 0 && (long long)s < mode.bound;
      if (head[r] && p + kLong < M && far[r] == s) {
        head[r] = false;  // long: the block path's
        if (l == 0) list[atomicAdd(&nlist, 1)] = p;
      }
    }
    // Round 2: every head's row, and the gradient row of every position
    // but those deep in a long segment (the block path reads those).
    typename Mode::Row row[kRun] = {};
    float x[kRun][VPL];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int p = p0 + r;
      const bool need = live && p < M && !(p + kLong < M && far[r] == sq[r + 1]);
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        x[r][v] = need && e0 + v < D ? __ldg(g + o[r] * D + e0 + v) : 0.f;
      if (head[r]) row[r] = mode.load(sq[r + 1], e0);
    }
    // Every lane runs every update (the groups of a warp stay converged,
    // and a shuffle spans the warp); only heads write.
    const GroupComm comm{gi * W};
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      // The segment's occurrences among the group's positions are loaded
      // already; one that runs past them is summed on from p0 + kRun.
      const int s = sq[r + 1];
      float gs[VPL];
#pragma unroll
      for (int v = 0; v < VPL; ++v) gs[v] = __fadd_rn(0.f, x[r][v]);
      bool on = true;
#pragma unroll
      for (int j = r + 1; j < kRun; ++j) {
        on = on && p0 + j < M && sq[j + 1] == s;
        if (on) {
#pragma unroll
          for (int v = 0; v < VPL; ++v) gs[v] = __fadd_rn(gs[v], x[j][v]);
        }
      }
      if (head[r] && on && p0 + kRun < M && sq[kRun + 1] == s)
        group_sum_rest<VPL>(sid, order, g, M, D, p0 + kRun, s, e0, gs);
      mode.update(row[r], s, e0, gs, comm, head[r]);
    }
  } else if (threadIdx.x < kWidePositions) {
    // Wide path: every head of the block's positions takes the block path.
    const int p = (int)blockIdx.x * kWidePositions + threadIdx.x;
    if (p < M) {
      const int s = __ldg(sid + p);
      if ((p == 0 || __ldg(sid + p - 1) != s) && s >= 0 && (long long)s < mode.bound)
        list[atomicAdd(&nlist, 1)] = p;
    }
  }
  __syncthreads();

  const int n = nlist;
  for (int i = 0; i < n; ++i) {
    const int h = list[i];
    const int hs = __ldg(sid + h);
    const int e0 = threadIdx.x * VPL;
    const auto row = mode.load(hs, e0);
    block_sum(sid, order, g, M, D, h, hs, smem, nsh, gsh);
    float gs[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) gs[v] = e0 + v < D ? gsh[e0 + v] : 0.f;
    mode.update(row, hs, e0, gs, BlockComm{gsh, &bsh}, true);
    __syncthreads();  // gsh and bsh are the next row's
  }
}

}  // namespace tail
