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
// moves up to |E| * C * 4 bytes from L2/HBM (less where L2 keeps a hub's
// sources) against n * C * 4 bytes of output; the adds are one per gathered
// float, far below the fp32 rate.  What keeps a kernel from that bound on
// R-MAT graphs is their skew: split by rows, one warp walks a whole hub row
// (degree 39,733 on the smoke graph) while the rest of the card idles.
//
// Design: the edge-balanced partition (../ops.py, EdgePartition; shared
// edge walks in ../../csrc/edge_walk.cuh).
// * Launch 1, heavy blocks first: each warp takes one (segment, column tile)
//   of a heavy row and writes its partial sums to a scratch row of
//   `partials` (n_segments x C, allocated by the wrapper).  Then one block
//   per light range: its warps take (row, column tile) items round-robin,
//   walk the row's edges and write the output row tile directly.  Heavy rows
//   are skipped there; rows with no edges write zeros.
// * Launch 2: each heavy row's output is the sum of its segments' partials
//   in segment order.
// No float atomics and no order that depends on timing: two launches on the
// same inputs give the same bits.  A warp walks at most max(segment,
// range edges) x tiles edges, whatever the degree of the hub.  The entry
// point reports in *launched how many kernels it issued (1, or 2 with heavy
// rows).

#include "../../csrc/edge_walk.cuh"

namespace {

using namespace edge_walk;

template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads)
spmm_blocked_kernel(int heavy_blocks, int n_heavy_items, const int* __restrict__ seg_beg,
                    const int* __restrict__ seg_end, float* __restrict__ partials,
                    const int* __restrict__ range_ptr, const int* __restrict__ row_ptr,
                    const int* __restrict__ heavy_slot, const int* __restrict__ src,
                    const float* __restrict__ m, int c, int n_tiles,
                    float* __restrict__ out) {
  using W = Walk<V, K, L>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < heavy_blocks) {
    const int item = blockIdx.x * kWarps + warp;
    if (item < n_heavy_items)
      heavy_item<V, K, L>(item, n_tiles, seg_beg, seg_end, src, m, c, partials, lane);
    return;
  }
  const int range = blockIdx.x - heavy_blocks;
  const int r0 = range_ptr[range];
  const int items = (range_ptr[range + 1] - r0) * n_tiles;
  for (int item = warp; item < items; item += kWarps) {
    const int rr = item / n_tiles;
    const int t = item - rr * n_tiles;
    const int v = r0 + rr;
    if (heavy_slot[v] >= 0) continue;  // written by the reduction
    W w(lane, t * W::kWidth, c);
    w.run(src, row_ptr[v], row_ptr[v + 1], m, c, lane);
    w.store(out + static_cast<int64_t>(v) * c, lane);
  }
}

struct Launch {
  const int* row_ptr;
  const int* src;
  const float* m;
  int c;
  float* out;
  int n_ranges;
  const int* range_ptr;
  const int* heavy_slot;
  int n_heavy;
  const int* heavy_rows;
  const int* seg_ptr;
  int n_segments;
  const int* seg_beg;
  const int* seg_end;
  float* partials;
  cudaStream_t stream;
  int* launched;

  template <int V, int K, int L>
  cudaError_t run() const {
    const int n_tiles = (c + Walk<V, K, L>::kWidth - 1) / Walk<V, K, L>::kWidth;
    const int n_heavy_items = n_segments * n_tiles;
    const int heavy_blocks = (n_heavy_items + kWarps - 1) / kWarps;
    spmm_blocked_kernel<V, K, L><<<heavy_blocks + n_ranges, kThreads, 0, stream>>>(
        heavy_blocks, n_heavy_items, seg_beg, seg_end, partials, range_ptr, row_ptr,
        heavy_slot, src, m, c, n_tiles, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    if (n_heavy == 0) return err;
    err = launch_heavy_reduce(seg_ptr, heavy_rows, n_heavy, partials, c, out, stream);
    if (err == cudaSuccess) ++*launched;
    return err;
  }
};

}  // namespace

extern "C" int spmm_blocked_launch(const int* row_ptr, const int* src, int n,
                                   const float* m, int c, float* out, int n_ranges,
                                   const int* range_ptr, const int* heavy_slot,
                                   int n_heavy, const int* heavy_rows,
                                   const int* seg_ptr, int n_segments,
                                   const int* seg_beg, const int* seg_end,
                                   float* partials, void* stream, int* launched) {
  *launched = 0;
  if (n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[] = {m, out, partials};
  const Launch launch{row_ptr, src, m, c, out, n_ranges, range_ptr, heavy_slot,
                      n_heavy, heavy_rows, seg_ptr, n_segments, seg_beg, seg_end,
                      partials, static_cast<cudaStream_t>(stream), launched};
  return static_cast<int>(dispatch(c, vector_width(c, ptrs, n_segments ? 3 : 2), launch));
}
