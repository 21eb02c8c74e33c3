// The strongly-see compare-count on Hopper (sm_90a): gathered, batched
// and thresholded.
//
//   c[m, w] = #{ i : x_tab[xs[m], i] >= f_tab[w_tab[wrow[m], w], i] }
//
// for every row m of a batch and every witness slot w of the row's
// witness row wrow[m]; a slot holding -1 names no witness. Three
// epilogues (template parameter kMode):
//   COUNTS  out int32 [M, W] = c             xs, w_tab and wrow are null:
//                                            row m is x_tab[m], slot w is
//                                            f_tab[w] (R = 1)
//   MATRIX  out uint8 [M, W] = c >= sm and the witness exists
//   TALLY   out int32 [M]    = #{ w : the witness exists and c >= sm }
//
// Replaces babble_tpu/ops/pallas_kernels.py::strongly_see_counts, the
// JAX package's one Pallas kernel, which is COUNTS here. It is a
// "comparison matmul": a contraction over the participant axis with >=
// in place of multiply. The gathered forms serve every strongly-see
// site of the port's pipeline (ops/kernels.py decide_fame and
// compute_rounds, ops/frontier.py's probe and skip correction) in one
// launch where the plain code built a broadcast >= cube per site.
//
// What bounds it: M*W*n compare-adds against (distinct rows)*n*4 bytes
// read, so at every shape the pipeline uses it is bound by integer
// issue (one compare and one add per pair), not by memory. There is no
// tensor-core form of >=, so this is SIMT integer work.
//
// Design, right and simple first:
// - one block of 16x16 threads per [64 rows x 64 witness slots] output
//   tile, the grid covering the whole batch (x: row tiles, y: witness
//   tiles); each thread keeps a 4x4 int32 micro-tile of counts in
//   registers, so every operand read from shared memory feeds four
//   compare-adds;
// - gathers happen while staging: a block loads its rows' x ids and
//   witness rows once, then per participant chunk of 32 lanes stages the
//   gathered x rows and witness rows into shared memory, issuing all of a
//   thread's loads before its stores (interleaved, the loads wait on one
//   another and the kernel ran ~30 % slower). No gathered copy exists in
//   device memory;
// - rows of one tile may name different witness rows (compute_rounds:
//   the events of one DAG level can have different parent rounds). The
//   block walks the distinct witness rows of its tile in increasing
//   order (each warp finds the next one by a min-reduction) and, for
//   each, stages that witness tile and runs the participant loop over
//   all 64 rows, keeping the result of the rows that name it. A uniform
//   tile (fame, the frontier) pays one pass; a tile naming d witness
//   rows pays d;
// - counts never leave the chip: the epilogue thresholds and masks them
//   in registers (a 16-bit hit mask per thread, so a pass keeps no second
//   micro-tile) and, in TALLY mode, sums a row's hits across the 16
//   threads that own it (warp shuffles), then stores the row's tally or,
//   when the grid has several witness tiles, adds it with an integer
//   atomic (exact and order-free) into an output the wrapper zeroed;
// - a thread owns rows ty + 16*i and slots tx + 16*j, and the staged
//   rows are padded to 33 words, so the compute loop reads shared memory
//   without bank conflicts and the staging writes are conflict-free too;
// - ragged edges are masked while staging: a participant lane past n is
//   staged as INT_MIN against INT_MAX (never >=), rows past M are not
//   stored, slots past W or holding -1 are masked in the epilogue.
//
// Plain C entry points for ctypes; they launch on the caller's stream,
// allocate nothing and return cudaGetLastError(). Indices are trusted:
// xs in [0, Ex), wrow in [0, R), w_tab entries in [-1, Ef).

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;               // output tile edge
constexpr int kChunk = 32;              // participant lanes per staged chunk
constexpr int kThreads = 16;            // threads per tile edge
constexpr int kMicro = kTile / kThreads;  // 4x4 counts per thread
constexpr int kStage = kTile * kChunk / (kThreads * kThreads);  // loads per thread
static_assert(kChunk == 32, "a warp stages 32 lanes of one row");

constexpr int kCounts = 0;
constexpr int kMatrix = 1;
constexpr int kTally = 2;

// At most 85 registers a thread, so three blocks share an SM.
template <int kMode>
__global__ void __launch_bounds__(kThreads * kThreads, 3)
strongly_see_kernel(const int* __restrict__ x_tab, const int* __restrict__ xs,
                    const int* __restrict__ f_tab, const int* __restrict__ w_tab,
                    const int* __restrict__ wrow, void* __restrict__ out,
                    int m, int w, int n, int sm) {
  __shared__ int sa[kTile][kChunk + 1];
  __shared__ int sb[kTile][kChunk + 1];
  __shared__ int s_x[kTile];  // x row of each tile row (-1 past M)
  __shared__ int s_r[kTile];  // witness row of each tile row (INT_MAX past M)
  __shared__ int s_w[kTile];  // witness of each tile slot in the current pass (-1 none)

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * kTile;
  const int w0 = blockIdx.y * kTile;

  if (tid < kTile) {
    const int gm = m0 + tid;
    s_x[tid] = gm < m ? (xs ? xs[gm] : gm) : -1;
    s_r[tid] = gm < m ? (wrow ? wrow[gm] : 0) : INT_MAX;
  }

  // MATRIX, TALLY: bit i * kMicro + j is the thread's hit at (i, j)
  unsigned hits = 0;
  int prev = -1;  // witness rows are >= 0
  for (;;) {
    // Every thread of the block waits here, so the previous pass is done
    // with s_w and the first pass sees s_x and s_r.
    __syncthreads();
    // the next distinct witness row of the tile: every warp reduces the
    // 64 rows itself, two per lane
    const int q0 = s_r[lane];
    const int q1 = s_r[lane + 32];
    const int v = __reduce_min_sync(
        0xffffffffu, min(q0 > prev ? q0 : INT_MAX, q1 > prev ? q1 : INT_MAX));
    if (v == INT_MAX) break;  // the same on every thread: the loop stays uniform
    prev = v;
    if (tid < kTile) {
      const int gw = w0 + tid;
      s_w[tid] = gw < w ? (w_tab ? w_tab[static_cast<size_t>(v) * w + gw] : gw) : -1;
    }
    __syncthreads();

    int acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;
    }

    for (int k0 = 0; k0 < n; k0 += kChunk) {
      // a warp stages rows warp + 8 * s, 32 consecutive lanes of each; all
      // loads are issued before any store, so their latencies overlap
      const int k = k0 + lane;
      int xv[kStage];
      int fv[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int row = tid / kChunk + s * (kThreads * kThreads / kChunk);
        const int xr = s_x[row];
        const int wr = s_w[row];
        xv[s] = (k < n && xr >= 0) ? x_tab[static_cast<size_t>(xr) * n + k] : INT_MIN;
        fv[s] = (k < n && wr >= 0) ? f_tab[static_cast<size_t>(wr) * n + k] : INT_MAX;
      }
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int row = tid / kChunk + s * (kThreads * kThreads / kChunk);
        sa[row][lane] = xv[s];
        sb[row][lane] = fv[s];
      }
      __syncthreads();

#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        int a[kMicro];
        int b[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) a[i] = sa[ty + kThreads * i][c];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) b[j] = sb[tx + kThreads * j][c];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
#pragma unroll
          for (int j = 0; j < kMicro; ++j) acc[i][j] += (a[i] >= b[j]) ? 1 : 0;
        }
      }
      __syncthreads();
    }

    // keep the rows that name witness row v; COUNTS has one pass and
    // stores its counts here
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      if (s_r[ty + kThreads * i] != v) continue;
      const int gm = m0 + ty + kThreads * i;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        if constexpr (kMode == kCounts) {
          const int gw = w0 + tx + kThreads * j;
          if (gw < w) static_cast<int*>(out)[static_cast<size_t>(gm) * w + gw] = acc[i][j];
        } else if (s_w[tx + kThreads * j] >= 0 && acc[i][j] >= sm) {
          hits |= 1u << (i * kMicro + j);
        }
      }
    }
  }

  // MATRIX, TALLY: the epilogue from the hit mask
  if constexpr (kMode != kCounts) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int gm = m0 + ty + kThreads * i;
      if constexpr (kMode == kTally) {
        int t = __popc((hits >> (i * kMicro)) & ((1u << kMicro) - 1));
        // the 16 threads of a row are one half-warp: xor offsets < 16 stay in it
#pragma unroll
        for (int off = kThreads / 2; off > 0; off /= 2) t += __shfl_xor_sync(0xffffffffu, t, off);
        if (tx == 0 && gm < m) {
          int* tally = static_cast<int*>(out);
          if (gridDim.y == 1) {
            tally[gm] = t;
          } else {
            atomicAdd(tally + gm, t);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int gw = w0 + tx + kThreads * j;
          if (gm < m && gw < w) {
            static_cast<uint8_t*>(out)[static_cast<size_t>(gm) * w + gw] =
                static_cast<uint8_t>((hits >> (i * kMicro + j)) & 1u);
          }
        }
      }
    }
  }
}

}  // namespace

// mode: 0 COUNTS (xs, w_tab and wrow null), 1 MATRIX, 2 TALLY. In TALLY
// mode with more than one witness tile (w > 64) `out` must hold zeros.
extern "C" int babble_strongly_see_gathered(const void* x_tab, const void* xs,
                                            const void* f_tab, const void* w_tab,
                                            const void* wrow, void* out, int m, int w,
                                            int n, int sm, int mode, void* stream) {
  const dim3 block(kThreads, kThreads);
  const dim3 grid((m + kTile - 1) / kTile, (w + kTile - 1) / kTile);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int*>(x_tab);
  const auto* xi = static_cast<const int*>(xs);
  const auto* f = static_cast<const int*>(f_tab);
  const auto* wt = static_cast<const int*>(w_tab);
  const auto* wr = static_cast<const int*>(wrow);
  switch (mode) {
    case kCounts:
      strongly_see_kernel<kCounts><<<grid, block, 0, s>>>(x, xi, f, wt, wr, out, m, w, n, sm);
      break;
    case kMatrix:
      strongly_see_kernel<kMatrix><<<grid, block, 0, s>>>(x, xi, f, wt, wr, out, m, w, n, sm);
      break;
    case kTally:
      strongly_see_kernel<kTally><<<grid, block, 0, s>>>(x, xi, f, wt, wr, out, m, w, n, sm);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
