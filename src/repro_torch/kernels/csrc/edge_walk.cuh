// Edge walks shared by the two counting kernels (sm_90a):
// spmm_blocked/csrc/spmm_blocked.cu and spmm_ema/csrc/spmm_ema.cu.
//
// Both read the compact dst-sorted CSR operand (row_ptr, src) and its
// edge-balanced partition (repro_torch/kernels/spmm_blocked/ops.py,
// EdgePartition): rows above a degree threshold ("heavy") are cut into
// segments of a bounded number of edges, the other rows are packed into
// ranges of at most RANGE_ROWS rows and RANGE_EDGES edges.  A warp's unit of
// work is one segment, or one light row, for one column tile, so no warp
// walks more than a segment's or a range's edges per tile.
//
// The column layout of one warp walk (Walk<V, K, L>): a group of L lanes
// covers a tile of L * V * K columns, each lane loading K vectors of V floats
// (float4 where the width allows it) per edge; the 32 / L groups of a warp
// take consecutive edges, so a narrow tile (the leaf stage's 12 columns)
// still keeps every lane loading.  Four load steps are in flight per lane.
// The groups' partial sums are folded with a fixed xor butterfly of
// shuffles, so a result depends only on the inputs and the partition, never
// on timing: there are no atomics anywhere.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_walk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // load steps in flight per lane

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// One warp's sum over the source rows of edges [beg, end) for one tile of
// columns [c0, c0 + kWidth) of a C-column operand.  Element (s, col) of the
// operand is base[s * stride + col].  Must be called by all 32 lanes.
template <int V, int K, int L>
struct Walk {
  static constexpr int kGroups = 32 / L;   // edges per load step
  static constexpr int kWidth = L * V * K;
  static constexpr int kAcc = V * K;

  float acc[kAcc];
  int col[K];
  bool ok[K];

  __device__ __forceinline__ Walk(int lane, int c0, int c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      col[k] = c0 + (k * L + lane % L) * V;
      ok[k] = col[k] < c;   // c is a multiple of V
    }
  }

  __device__ __forceinline__ void run(const int* __restrict__ src, int beg, int end,
                                      const float* __restrict__ base, int64_t stride,
                                      int lane) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    int e = beg + lane / L;
    for (; e + (kUnroll - 1) * kGroups < end; e += kUnroll * kGroups) {
      const float* row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        row[u] = base + static_cast<int64_t>(__ldg(src + e + u * kGroups)) * stride;
      float x[kUnroll][kAcc];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (ok[k]) {
            load_vec<V>(row[u] + col[k], &x[u][k * V]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[u][k * V + v] = 0.f;
          }
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += x[u][i];
    }
    for (; e < end; e += kGroups) {
      const float* row = base + static_cast<int64_t>(__ldg(src + e)) * stride;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (ok[k]) {
          float x[V];
          load_vec<V>(row + col[k], x);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k * V + v] += x[v];
        }
      }
    }
    // fold the groups' partial sums: every lane ends with its columns' sum
#pragma unroll
    for (int off = 16; off >= L; off >>= 1)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }

  // the tile's sums into a device-memory row (16-byte aligned where V = 4)
  __device__ __forceinline__ void store(float* row, int lane) const {
    if (lane >= L) return;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) store_vec<V>(row + col[k], &acc[k * V]);
  }

  // the tile's sums into a shared-memory row (any alignment) that holds
  // the columns from c0 on
  __device__ __forceinline__ void store_shared(float* row, int lane, int c0 = 0) const {
    if (lane >= L) return;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) {
#pragma unroll
        for (int v = 0; v < V; ++v) row[col[k] - c0 + v] = acc[k * V + v];
      }
  }
};

// Heavy-row segments: work item `item` is (segment item / n_tiles, tile
// item % n_tiles); its partial sums go to row `segment` of `partials`
// (n_segments x c).  The operand is (n, c) row-major.
template <int V, int K, int L>
__device__ __forceinline__ void heavy_item(int item, int n_tiles,
                                           const int* __restrict__ seg_beg,
                                           const int* __restrict__ seg_end,
                                           const int* __restrict__ src,
                                           const float* __restrict__ m, int c,
                                           float* __restrict__ partials, int lane) {
  using W = Walk<V, K, L>;
  const int seg = item / n_tiles;
  const int t = item - seg * n_tiles;
  W w(lane, t * W::kWidth, c);
  w.run(src, seg_beg[seg], seg_end[seg], m, c, lane);
  w.store(partials + static_cast<int64_t>(seg) * c, lane);
}

template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads)
heavy_segments_kernel(int n_items, int n_tiles, const int* __restrict__ seg_beg,
                      const int* __restrict__ seg_end, const int* __restrict__ src,
                      const float* __restrict__ m, int c, float* __restrict__ partials) {
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // whole warps
  heavy_item<V, K, L>(item, n_tiles, seg_beg, seg_end, src, m, c, partials,
                      threadIdx.x & 31);
}

// out[row(h), col] = sum of the partials of heavy row h's segments, in
// segment order; row(h) = heavy_rows[h], or h when heavy_rows is null.
__global__ void __launch_bounds__(kThreads)
heavy_reduce_kernel(const int* __restrict__ seg_ptr, const int* __restrict__ heavy_rows,
                    int n_heavy, const float* __restrict__ partials, int c,
                    float* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(n_heavy) * c;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(i / c);
    const int col = static_cast<int>(i - static_cast<int64_t>(h) * c);
    float sum = 0.f;
    for (int s = seg_ptr[h]; s < seg_ptr[h + 1]; ++s)
      sum += partials[static_cast<int64_t>(s) * c + col];
    const int64_t row = heavy_rows ? heavy_rows[h] : h;
    out[row * c + col] = sum;
  }
}

inline cudaError_t launch_heavy_reduce(const int* seg_ptr, const int* heavy_rows, int n_heavy,
                                       const float* partials, int c, float* out,
                                       cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n_heavy) * c;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  heavy_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                        stream>>>(seg_ptr, heavy_rows, n_heavy, partials, c, out);
  return cudaGetLastError();
}

// The widest vector (4, 2 or 1 floats) that divides c and keeps every
// pointer aligned.
inline int vector_width(int c, const void* const* ptrs, int n_ptrs) {
  for (int v = 4; v > 1; v >>= 1) {
    bool ok = c % v == 0;
    for (int i = 0; i < n_ptrs; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (4 * v) == 0;
    if (ok) return v;
  }
  return 1;
}

// Calls f.run<V, K, L>() for the walk shape of a c-column operand with
// vectors of `vec` floats: all 32 lanes on 128-column tiles once c needs
// more than 16 lanes, else the fewest lanes (a power of two) that cover c.
// repro_torch/kernels/spmm_blocked/ops.py::tile_width mirrors this choice
// and is checked against edge_walk_tile_width below whenever a library loads.
template <class F>
auto dispatch(int c, int vec, const F& f) -> decltype(f.template run<1, 1, 1>()) {
  if (c > 16 * vec) {
    if (vec == 4) return f.template run<4, 1, 32>();
    if (vec == 2) return f.template run<2, 2, 32>();
    return f.template run<1, 4, 32>();
  }
  int lanes = 1;
  while (lanes * vec < c) lanes <<= 1;
#define EDGE_WALK_NARROW(V)                            \
  switch (lanes) {                                     \
    case 1: return f.template run<V, 1, 1>();          \
    case 2: return f.template run<V, 1, 2>();          \
    case 4: return f.template run<V, 1, 4>();          \
    case 8: return f.template run<V, 1, 8>();          \
    default: return f.template run<V, 1, 16>();        \
  }
  if (vec == 4) EDGE_WALK_NARROW(4)
  if (vec == 2) EDGE_WALK_NARROW(2)
  EDGE_WALK_NARROW(1)
#undef EDGE_WALK_NARROW
}

struct TileWidth {
  template <int V, int K, int L>
  int run() const { return Walk<V, K, L>::kWidth; }
};

}  // namespace edge_walk

// The schedule the host's model of it reads (spmm_blocked/ops.py: tile_width
// and KERNEL_WARPS, which edge_visits uses), exported so that the host can
// check its copy against the built library.  Each library includes this
// header once.
extern "C" int edge_walk_tile_width(int c, int vec) {
  return edge_walk::dispatch(c, vec, edge_walk::TileWidth{});
}
extern "C" int edge_walk_warps() { return edge_walk::kWarps; }
