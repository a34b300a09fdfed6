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
// moves |E| * C * 4 bytes from L2 or HBM against 2 * n * C * 4 bytes of
// input and output; the adds are one per gathered float, far below the
// fp32 rate.  Two things stand between a launch and that floor:
// * The tail.  A bag extend's state flattened to (n, n^(r-1) * B * C) is
//   hundreds of thousands of columns wide (491,520 for the paw's and the
//   4-cycle's extends at n = 8192 and a chunk of 10), while a graph of
//   8192 vertices has only some 600 light ranges: one CTA per range, each
//   walking every 128-column tile in turn, is less than one wave, so the
//   range of most edges (3,258 of a median 186) sets the launch's time,
//   8.4x the even share of the card's warps.
// * The gathers themselves.  Balanced, they still read |E| * 512 bytes per
//   tile, ~400 GB for one 491,520-column product: ~120 ms from HBM.  Only an
//   order in which the CTAs resident at one moment gather from a band of M
//   that L2 holds (one tile at n = 8192 is 4 MB of the 50 MB) takes them
//   below that.
//
// Design: the edge-balanced partition (../ops.py, EdgePartition; shared
// edge walks in ../../csrc/edge_walk.cuh), walked in column slabs.
// * The columns are cut into slabs of slab_tiles(...) tiles, one per
//   blockIdx.y, so a wide product is many waves of short CTAs (the tail
//   goes: no CTA walks more than a range or a segment per slab tile), and
//   the CTAs of one slab run together: the hardware hands out blocks
//   x-fastest, so the order is slab-major and the band of M being gathered
//   from stays in L2.  A narrow product (at most kOneSlabTiles tiles, 1024
//   columns) is one slab: every tile in turn, as kernel A walks them.
// * Launch 1, per slab, heavy blocks first: each warp takes one (segment,
//   column tile) of a heavy row and writes its partial sums to a scratch
//   row of `partials` (n_segments x C, allocated by the wrapper).  Then one
//   block per light range: its warps take the slab's (row, column tile)
//   items round-robin, rows outer, walk the row's edges and write the
//   output row tile directly.  Heavy rows are skipped there; rows with no
//   edges write zeros.
// * Launch 2: each heavy row's output is the sum of its segments' partials
//   in segment order.
// Kernel A (../../spmm_ema/csrc/spmm_ema.cu) keeps one CTA per range over
// every tile: its eMA reads the range's aggregate from shared memory, so
// the range's rows must stay in one CTA.  Kernel B writes its sums straight
// to device memory and has no such need.
// No float atomics and no order that depends on timing: each output (row,
// tile) is summed by one warp in edge order, whatever the slab width, so
// two launches on the same inputs give the same bits.  A warp walks at most
// max(segment, range edges) x slab tiles edges.  The entry point reports in
// *launched how many kernels it issued (1, or 2 with heavy rows) and in
// *slabs how many slabs launch 1 walked.

#include "../../csrc/edge_walk.cuh"

namespace {

using namespace edge_walk;

// The slab: the band of M the CTAs resident at one moment gather from
// (about two slabs: a slab is ~600 CTAs at n = 8192, the card holds ~1000)
// has to stay in L2.  4 MiB is one tile at n = 8192; 1, 2, 4, 8, 16 and 32
// tiles there took 49, 55, 63, 83, 106 and 128 ms for a 491,520-column
// product (H100 80GB HBM3, 700 W).
constexpr int64_t kSlabBytes = 4 << 20;
// A product of at most this many tiles (1024 columns) stays one slab.
constexpr int kOneSlabTiles = kWarps;
// gridDim.y
constexpr int kMaxSlabs = 65535;

// Tiles per slab of an (n, C) operand walked in `width`-column tiles.
inline int slab_tiles(int n_tiles, int width, int n) {
  if (n_tiles <= kOneSlabTiles) return n_tiles;
  const int64_t tile_bytes = static_cast<int64_t>(n > 0 ? n : 1) * width * 4;
  int64_t s = kSlabBytes / tile_bytes;
  if (s < 1) s = 1;
  const int64_t fit = (n_tiles + kMaxSlabs - 1) / kMaxSlabs;
  if (s < fit) s = fit;
  return s < n_tiles ? static_cast<int>(s) : n_tiles;
}

template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads)
spmm_blocked_kernel(int heavy_blocks, int n_segments, const int* __restrict__ seg_beg,
                    const int* __restrict__ seg_end, float* __restrict__ partials,
                    const int* __restrict__ range_ptr, const int* __restrict__ row_ptr,
                    const int* __restrict__ heavy_slot, const int* __restrict__ src,
                    const float* __restrict__ m, int c, int n_tiles, int slab,
                    float* __restrict__ out) {
  using W = Walk<V, K, L>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.y * slab;
  const int tiles = min(slab, n_tiles - t0);
  if (static_cast<int>(blockIdx.x) < heavy_blocks) {
    const int item = blockIdx.x * kWarps + warp;
    if (item >= n_segments * tiles) return;  // whole warps
    const int seg = item / tiles;
    W w(lane, (t0 + item - seg * tiles) * W::kWidth, c);
    w.run(src, seg_beg[seg], seg_end[seg], m, c, lane);
    w.store(partials + static_cast<int64_t>(seg) * c, lane);
    return;
  }
  const int range = blockIdx.x - heavy_blocks;
  const int r0 = range_ptr[range];
  const int items = (range_ptr[range + 1] - r0) * tiles;
  for (int item = warp; item < items; item += kWarps) {
    const int rr = item / tiles;
    const int v = r0 + rr;
    if (heavy_slot[v] >= 0) continue;  // written by the reduction
    W w(lane, (t0 + item - rr * tiles) * W::kWidth, c);
    w.run(src, row_ptr[v], row_ptr[v + 1], m, c, lane);
    w.store(out + static_cast<int64_t>(v) * c, lane);
  }
}

struct Launch {
  const int* row_ptr;
  const int* src;
  int n;
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
  int* slabs;

  template <int V, int K, int L>
  cudaError_t run() const {
    constexpr int width = Walk<V, K, L>::kWidth;
    const int n_tiles = (c + width - 1) / width;
    const int slab = slab_tiles(n_tiles, width, n);
    const int n_slabs = (n_tiles + slab - 1) / slab;
    const int heavy_blocks = (n_segments * slab + kWarps - 1) / kWarps;
    const dim3 grid(heavy_blocks + n_ranges, n_slabs);
    spmm_blocked_kernel<V, K, L><<<grid, kThreads, 0, stream>>>(
        heavy_blocks, n_segments, seg_beg, seg_end, partials, range_ptr, row_ptr,
        heavy_slot, src, m, c, n_tiles, slab, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
    *slabs = n_slabs;
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
                                   float* partials, void* stream, int* launched,
                                   int* slabs) {
  *launched = 0;
  *slabs = 0;
  if (n <= 0 || c <= 0) return static_cast<int>(cudaSuccess);
  const void* ptrs[] = {m, out, partials};
  const Launch launch{row_ptr, src, n, m, c, out, n_ranges, range_ptr, heavy_slot,
                      n_heavy, heavy_rows, seg_ptr, n_segments, seg_beg, seg_end,
                      partials, static_cast<cudaStream_t>(stream), launched, slabs};
  return static_cast<int>(dispatch(c, vector_width(c, ptrs, n_segments ? 3 : 2), launch));
}

// The slab width launch 1 walks an (n, c) operand in, exported so that the
// host's model of it (../ops.py, slab_tiles) can be checked against the
// built library.
extern "C" int spmm_blocked_slab_tiles(int c, int vec, int n) {
  const int width = dispatch(c, vec, TileWidth{});
  return slab_tiles((c + width - 1) / width, width, n);
}
