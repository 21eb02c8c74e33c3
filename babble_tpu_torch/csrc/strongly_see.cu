// The strongly-see compare-count on Hopper (sm_90a).
//
//   counts[x, w] = #{ i : la_x[x, i] >= fd_w[w, i] }        int32
//
// Replaces babble_tpu/ops/pallas_kernels.py::strongly_see_counts, the
// JAX package's one Pallas kernel. It is a "comparison matmul": a
// contraction over the participant axis with >= in place of multiply.
// In fame (ops/kernels.py decide_fame) it runs once per voting round
// with M = W = n.
//
// What bounds it: n^3 compare-adds per call against 2*n^2*4 bytes read
// and n^2*4 written, so at every n the pipeline uses it is bound by
// integer issue (one compare and one add per pair), not by memory.
// There is no tensor-core form of >=, so this is SIMT integer work.
//
// Design, right and simple first:
// - one block of 16x16 threads per [64 x 64] output tile; each thread
//   keeps a 4x4 int32 micro-tile of counts in registers, so every
//   operand read from shared memory feeds four compare-adds;
// - the participant axis is walked inside the block in chunks of 32,
//   staged through shared memory (the TPU kernel's sequential K grid
//   dimension becomes this loop: blocks run in no order and carry
//   nothing between them);
// - a thread owns rows ty + 16*i and columns tx + 16*j, and the
//   staged rows are padded to 33 words, so the compute loop reads
//   shared memory without bank conflicts and the staging writes are
//   conflict-free too;
// - ragged edges are masked while staging: a participant lane past n
//   is staged as INT_MIN against INT_MAX (never >=), rows past M or W
//   are computed and not stored. No padded copy of the inputs exists.
//
// Plain C entry point for ctypes; launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;               // output tile edge
constexpr int kChunk = 32;              // participant lanes per staged chunk
constexpr int kThreads = 16;            // threads per tile edge
constexpr int kMicro = kTile / kThreads;  // 4x4 counts per thread
constexpr int kStage = kTile * kChunk / (kThreads * kThreads);  // loads per thread

__global__ void __launch_bounds__(kThreads * kThreads)
strongly_see_kernel(const int* __restrict__ la, const int* __restrict__ fd,
                    int* __restrict__ out, int m, int w, int n) {
  __shared__ int sa[kTile][kChunk + 1];
  __shared__ int sb[kTile][kChunk + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreads + tx;
  const int m0 = blockIdx.y * kTile;
  const int w0 = blockIdx.x * kTile;

  int acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < n; k0 += kChunk) {
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int idx = tid + s * kThreads * kThreads;
      const int row = idx / kChunk;  // a warp stages one row,
      const int col = idx % kChunk;  // 32 consecutive lanes of it
      const int k = k0 + col;
      const int gm = m0 + row;
      const int gw = w0 + row;
      sa[row][col] = (k < n && gm < m) ? la[static_cast<size_t>(gm) * n + k] : INT_MIN;
      sb[row][col] = (k < n && gw < w) ? fd[static_cast<size_t>(gw) * n + k] : INT_MAX;
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

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gm = m0 + ty + kThreads * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gw = w0 + tx + kThreads * j;
      if (gm < m && gw < w) out[static_cast<size_t>(gm) * w + gw] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int babble_strongly_see_counts(const void* la, const void* fd, void* out,
                                          int m, int w, int n, void* stream) {
  const dim3 block(kThreads, kThreads);
  const dim3 grid((w + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  strongly_see_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(la), static_cast<const int*>(fd), static_cast<int*>(out),
      m, w, n);
  return static_cast<int>(cudaGetLastError());
}
