// Blocked SpMM  B = A_G @ M  over the compact dst-sorted edge list (sm_90a).
//
// Replaces: src/repro/kernels/spmm_blocked/kernel.py  spmm_blocked_kernel
// (launched by spmm_blocked_call), the TPU kernel that walks padded
// blocked-ELL (dst-block, src-block) pairs and gathers with one-hot MXU
// matmuls (_mxu_chunk).  Neither the padded operand nor the one-hot trick is
// carried over: the padded operand of an R-MAT graph with 2^20 vertices
// would not fit on one card, and Hopper gathers directly.
//
// Layout: M is (n, C) row-major fp32, the engine's (n, B, c) state with the
// chunk's colorings folded into the columns.  The operand is CSR over
// destinations: row_ptr (n + 1) int32 and src (|E|) int32, so the in-edges
// of vertex v are src[row_ptr[v] .. row_ptr[v + 1]).
//
// Bound: the gathers.  Each edge reads one C-wide row of M, so the kernel
// moves about |E| * C * 4 bytes from L2/HBM against n * C * 4 bytes of
// output; the adds are one per gathered float, far below the fp32 rate.
//
// Design: each CTA owns ROWS destination vertices and one tile of TILE_COLS
// columns (grid.y), so no two CTAs write the same output and no atomics or
// second pass exist.  A warp owns one destination row at a time and walks
// its edges in order; lane l accumulates columns l and l + 32 of the tile in
// registers, so every gather of a row is one or two coalesced 128-byte
// segments.  Four edges are in flight per warp to hide gather latency.
// Sums run in edge order, so the result does not depend on launch order.
// Rows with no edges write zeros.  Hub rows make some CTAs much longer than
// others; splitting heavy rows is left to a later kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;       // destination rows per CTA
constexpr int kTileCols = 64;   // columns per CTA (two per lane)

__global__ void __launch_bounds__(kWarps * 32)
spmm_blocked_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ src,
                    int n,
                    const float* __restrict__ m,
                    int c,
                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kTileCols;
  const int col0 = c0 + lane;
  const int col1 = c0 + lane + 32;
  const bool ok0 = col0 < c;
  const bool ok1 = col1 < c;
  for (int r = warp; r < kRows; r += kWarps) {
    const int v = blockIdx.x * kRows + r;
    if (v >= n) break;
    const int beg = row_ptr[v];
    const int end = row_ptr[v + 1];
    float acc0 = 0.f, acc1 = 0.f;
    int e = beg;
    for (; e + 4 <= end; e += 4) {
      const int64_t s0 = src[e], s1 = src[e + 1], s2 = src[e + 2], s3 = src[e + 3];
      const float* r0 = m + s0 * c;
      const float* r1 = m + s1 * c;
      const float* r2 = m + s2 * c;
      const float* r3 = m + s3 * c;
      if (ok0) {
        const float x0 = __ldg(r0 + col0), x1 = __ldg(r1 + col0);
        const float x2 = __ldg(r2 + col0), x3 = __ldg(r3 + col0);
        acc0 += x0; acc0 += x1; acc0 += x2; acc0 += x3;
      }
      if (ok1) {
        const float x0 = __ldg(r0 + col1), x1 = __ldg(r1 + col1);
        const float x2 = __ldg(r2 + col1), x3 = __ldg(r3 + col1);
        acc1 += x0; acc1 += x1; acc1 += x2; acc1 += x3;
      }
    }
    for (; e < end; ++e) {
      const float* row = m + static_cast<int64_t>(src[e]) * c;
      if (ok0) acc0 += __ldg(row + col0);
      if (ok1) acc1 += __ldg(row + col1);
    }
    float* o = out + static_cast<int64_t>(v) * c;
    if (ok0) o[col0] = acc0;
    if (ok1) o[col1] = acc1;
  }
}

}  // namespace

extern "C" int spmm_blocked_launch(const int* row_ptr, const int* src, int n,
                                   const float* m, int c, float* out,
                                   void* stream) {
  if (n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid((n + kRows - 1) / kRows, (c + kTileCols - 1) / kTileCols);
  spmm_blocked_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(row_ptr, src, n,
                                                             m, c, out);
  return static_cast<int>(cudaGetLastError());
}
