// Fused SpMM+eMA: one tree DP stage (sm_90a).
//
// Replaces: src/repro/kernels/spmm_ema/kernel.py  spmm_ema_kernel (launched
// by spmm_ema_call), the TPU kernel that walks padded blocked-ELL pairs,
// keeps each destination block's aggregate in VMEM scratch and consumes it
// in the eMA when the block's last pair lands.  This kernel computes the
// same function,
//
//   M_s[v, b, o] = sum_t M_a[v, b, idx_a[o, t]] * (A_G @ M_p)[v, b, idx_p[o, t]],
//
// from the compact dst-sorted CSR operand (row_ptr, src) instead of the
// padded pairs, in the engine's row-major (n, B, C) layout.
//
// Bound: the gathers of the SpMM half.  Every edge reads the C_p passive
// columns of its source row, so one stage moves up to |E| * B * C_p * 4 bytes
// of gathers (R-MAT, n = 2^20, u12's widest stage: ~120 GB without L2
// reuse), against n * B * (C_a + C_p + n_out) * 4 bytes of compulsory
// traffic.  The eMA does n * B * n_out * n_splits FMAs out of shared memory,
// two shared-memory reads per FMA; on stages with narrow passives and wide
// outputs it, not the gathers, sets the time.
// Split by rows, R-MAT's skew would leave one warp with a hub row, walked
// once per passive tile (over a million edge visits on u12's widest stages
// of the smoke graph), and a 12-column passive would idle 20 of 32 lanes.
//
// Design: the edge-balanced partition (../../spmm_blocked/ops.py,
// EdgePartition; shared edge walks in ../../csrc/edge_walk.cuh).
// * Heavy rows (launches 1 and 2, only when the graph has any): their
//   aggregate (A_G @ M_p)[v] is computed over the whole grid, one warp per
//   (segment, 128-column tile of the B * C_p row), into `partials`, then
//   summed in segment order into `heavy_agg` (n_heavy x B x C_p), both
//   allocated by the wrapper.
// * Light ranges (launch 3): one CTA per (range, coloring b) owns its
//   rows' outputs, so every output is written once by one owner.  Per pass
//   of `rows_pass` rows (the whole range when its aggregate fits the shared
//   memory budget) it stages the rows' active state M_a in shared memory,
//   then fills the rows' whole passive aggregate (all C_p columns) in shared
//   memory: its warps take (row, column tile) items round-robin, walk a
//   light row's edges, or copy a heavy row's aggregate from heavy_agg.  The
//   aggregate of a light row never reaches device memory, and each edge is
//   walked once per tile, not once per tile per output tile.  The eMA then
//   runs once over the pass.
// * eMA: per output o, acc += M_a[v, b, idx_a[o, t]] * agg[v, idx_p[o, t]]
//   over the split entries t in split order, out of shared memory.  Each
//   thread takes four rows of one output, so one table load serves four
//   FMAs; consecutive lanes take consecutive outputs, so the table (stored
//   split-major: entry t of every output contiguous) is read and the
//   outputs are written in whole 128-byte lines.  Where the pass has too few
//   (row, output) pairs for the CTA (u12's 1-output root stage), g lanes
//   share one pair instead, lane j taking entries j, j + g, ... in split
//   order, and fold with a fixed xor butterfly.  Taking consecutive rows of
//   one output per warp instead (banks spread by an odd row stride) ran
//   slower on the card (PERF.md): its stores scatter over 16 rows.  Each
//   split entry is one int32, active column | passive column << 16.
// * Narrow passives (C_p <= 16 vector lanes, the leaf's 12 columns): a warp
//   takes 32 / L edges per load step and folds the lanes with shuffles.
// * Wide stages (launch 3 instead, spmm_ema_wide_kernel): where one row's
//   C_p + C_a floats exceed the shared-memory budget (two stages of the
//   repo's u18, four of u20, whose passives reach 184,756 columns), a CTA holds `tile_p` passive columns of
//   its pass's rows at a time and reads M_a from device memory.  It zeroes
//   its rows' outputs, then per passive tile fills the aggregate tile as
//   above and applies only that tile's non-empty (output, entries) buckets,
//   each in split order, adding into its own outputs in device memory.  The
//   split entries are two int32 arrays there (no 16-bit packing), so any
//   width works; the sum runs tile by tile, each tile in split order.
// No float atomics and no order that depends on timing: two launches on the
// same inputs give the same bits.  No warp walks more than a segment (heavy)
// or a range's edges (light) per passive tile.  The entry point reports in
// *launched how many kernels it issued (1, or 3 with heavy rows).

#include "../../csrc/edge_walk.cuh"

namespace {

using namespace edge_walk;

template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads, 2)
spmm_ema_kernel(const int* __restrict__ range_ptr, const int* __restrict__ row_ptr,
                const int* __restrict__ heavy_slot, const int* __restrict__ src,
                const float* __restrict__ mp, int cp, const float* __restrict__ ma, int ca,
                int bsz, const float* __restrict__ heavy_agg, const int* __restrict__ ent,
                int n_splits, int n_out, int rows_pass, float* __restrict__ out) {
  using W = Walk<V, K, L>;
  extern __shared__ float smem[];
  float* agg = smem;                   // rows_pass x cp
  float* act = smem + rows_pass * cp;  // rows_pass x ca

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = range_ptr[blockIdx.x];
  const int r1 = range_ptr[blockIdx.x + 1];
  const int n_tiles = (cp + W::kWidth - 1) / W::kWidth;
  const int64_t stride = static_cast<int64_t>(bsz) * cp;
  const float* base = mp + static_cast<int64_t>(b) * cp;

  for (int p0 = r0; p0 < r1; p0 += rows_pass) {
    const int np = min(rows_pass, r1 - p0);

    for (int i = tid; i < np * ca; i += kThreads) {
      const int rr = i / ca;
      const int cc = i - rr * ca;
      act[rr * ca + cc] = __ldg(ma + (static_cast<int64_t>(p0 + rr) * bsz + b) * ca + cc);
    }

    // SpMM half: the pass's whole aggregate, one (row, tile) per warp item
    for (int item = warp; item < np * n_tiles; item += kWarps) {
      const int rr = item / n_tiles;
      const int t = item - rr * n_tiles;
      const int v = p0 + rr;
      const int slot = heavy_slot[v];
      float* arow = agg + rr * cp;
      if (slot >= 0) {
        const float* h = heavy_agg + (static_cast<int64_t>(slot) * bsz + b) * cp;
        const int hi = min(cp, (t + 1) * W::kWidth);
        for (int cc = t * W::kWidth + lane; cc < hi; cc += 32) arow[cc] = h[cc];
      } else {
        W w(lane, t * W::kWidth, cp);
        w.run(src, row_ptr[v], row_ptr[v + 1], base, stride, lane);
        w.store_shared(arow, lane);
      }
    }
    __syncthreads();

    // eMA half
    int g = 1;
    while (g < 32 && g < n_splits && np * n_out * g * 2 <= kThreads) g <<= 1;
    if (g == 1) {
      // four rows of one output per thread, outputs fastest
      for (int item = tid; item < (np + 3) / 4 * n_out; item += kThreads) {
        const int rg = item / n_out;
        const int o = item - rg * n_out;
        const int q0 = rg * 4;
        const int nr = min(4, np - q0);
        const int* e = ent + o;  // entry t of output o at e[t * n_out]
        const float* a = act + q0 * ca;
        const float* p = agg + q0 * cp;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int t = 0; t < n_splits; ++t) {
          const int x = __ldg(e + t * n_out);
          const int ia = x & 0xffff, ip = x >> 16;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < nr) acc[q] += a[q * ca + ia] * p[q * cp + ip];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nr) out[(static_cast<int64_t>(p0 + q0 + q) * bsz + b) * n_out + o] = acc[q];
      }
    } else {
      // g lanes per (row, output), outputs fastest
      const int per = kThreads / g;
      const int j = tid & (g - 1);
      const int items = np * n_out;
      for (int first = 0; first < items; first += per) {
        const int item = first + tid / g;
        const bool valid = item < items;
        const int rr = valid ? item / n_out : 0;
        const int o = valid ? item - rr * n_out : 0;
        float acc = 0.f;
        if (valid) {
          const int* e = ent + o;
          const float* a = act + rr * ca;
          const float* p = agg + rr * cp;
          int t = j;
          for (; t + 3 * g < n_splits; t += 4 * g) {  // four loads ahead
            const int x0 = __ldg(e + t * n_out), x1 = __ldg(e + (t + g) * n_out);
            const int x2 = __ldg(e + (t + 2 * g) * n_out), x3 = __ldg(e + (t + 3 * g) * n_out);
            const float a0 = a[x0 & 0xffff], u0 = p[x0 >> 16];
            const float a1 = a[x1 & 0xffff], u1 = p[x1 >> 16];
            const float a2 = a[x2 & 0xffff], u2 = p[x2 >> 16];
            const float a3 = a[x3 & 0xffff], u3 = p[x3 >> 16];
            acc += a0 * u0; acc += a1 * u1; acc += a2 * u2; acc += a3 * u3;
          }
          for (; t < n_splits; t += g) {
            const int x = __ldg(e + t * n_out);
            acc += a[x & 0xffff] * p[x >> 16];
          }
        }
        for (int off = g >> 1; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (valid && j == 0)
          out[(static_cast<int64_t>(p0 + rr) * bsz + b) * n_out + o] = acc;
      }
    }
    __syncthreads();
  }
}

// A wide stage: passive tiles of tile_p columns (a multiple of the walk's
// width, or all of C_p); tile pt's buckets are tile_ptr[pt] .. tile_ptr[pt+1],
// bucket j adds entries bucket_ptr[j] .. bucket_ptr[j + 1] of
// (bucket_a, bucket_p) to output bucket_out[j].
template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads)
spmm_ema_wide_kernel(const int* __restrict__ range_ptr, const int* __restrict__ row_ptr,
                     const int* __restrict__ heavy_slot, const int* __restrict__ src,
                     const float* __restrict__ mp, int cp, const float* __restrict__ ma,
                     int ca, int bsz, const float* __restrict__ heavy_agg,
                     const int* __restrict__ tile_ptr, const int* __restrict__ bucket_out,
                     const int* __restrict__ bucket_ptr, const int* __restrict__ bucket_a,
                     const int* __restrict__ bucket_p, int n_out, int tile_p, int rows_pass,
                     float* __restrict__ out) {
  using W = Walk<V, K, L>;
  extern __shared__ float agg[];  // rows_pass x tile_p

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = range_ptr[blockIdx.x];
  const int r1 = range_ptr[blockIdx.x + 1];
  const int walk_tiles = (tile_p + W::kWidth - 1) / W::kWidth;
  const int64_t stride = static_cast<int64_t>(bsz) * cp;
  const float* base = mp + static_cast<int64_t>(b) * cp;

  for (int p0 = r0; p0 < r1; p0 += rows_pass) {
    const int np = min(rows_pass, r1 - p0);
    for (int i = tid; i < np * n_out; i += kThreads) {
      const int rr = i / n_out;
      out[(static_cast<int64_t>(p0 + rr) * bsz + b) * n_out + (i - rr * n_out)] = 0.f;
    }

    for (int pt = 0, c0 = 0; c0 < cp; ++pt, c0 += tile_p) {
      const int hi = min(cp, c0 + tile_p);
      // SpMM half: the pass's aggregate over columns [c0, hi)
      for (int item = warp; item < np * walk_tiles; item += kWarps) {
        const int rr = item / walk_tiles;
        const int lo = c0 + (item - rr * walk_tiles) * W::kWidth;
        if (lo >= hi) continue;
        const int v = p0 + rr;
        const int slot = heavy_slot[v];
        float* arow = agg + rr * tile_p;
        if (slot >= 0) {
          const float* h = heavy_agg + (static_cast<int64_t>(slot) * bsz + b) * cp;
          const int end = min(hi, lo + W::kWidth);
          for (int cc = lo + lane; cc < end; cc += 32) arow[cc - c0] = h[cc];
        } else {
          W w(lane, lo, hi);
          w.run(src, row_ptr[v], row_ptr[v + 1], base, stride, lane);
          w.store_shared(arow, lane, c0);
        }
      }
      __syncthreads();  // also orders the zeroing or the last tile's adds

      // eMA half: this tile's buckets; four rows of one bucket per thread,
      // buckets fastest, so one entry load serves four FMAs
      const int j0 = tile_ptr[pt];
      const int nb = tile_ptr[pt + 1] - j0;
      for (int item = tid; item < (np + 3) / 4 * nb; item += kThreads) {
        const int rg = item / nb;
        const int j = j0 + item - rg * nb;
        const int q0 = rg * 4;
        const int nr = min(4, np - q0);
        const int64_t row0 = static_cast<int64_t>(p0 + q0) * bsz + b;
        const float* a = ma + row0 * ca;
        const float* p = agg + q0 * tile_p;
        float* o = out + row0 * n_out + bucket_out[j];
        const int64_t a_row = static_cast<int64_t>(bsz) * ca;  // next row of M_a
        const int64_t o_row = static_cast<int64_t>(bsz) * n_out;
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = q < nr ? o[q * o_row] : 0.f;
        for (int e = bucket_ptr[j]; e < bucket_ptr[j + 1]; ++e) {
          const int ia = __ldg(bucket_a + e), ip = __ldg(bucket_p + e) - c0;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < nr) acc[q] += __ldg(a + q * a_row + ia) * p[q * tile_p + ip];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nr) o[q * o_row] = acc[q];
      }
      __syncthreads();
    }
  }
}

struct HeavyLaunch {
  const int* src;
  const float* mp;
  int c;  // B * C_p
  int n_segments;
  const int* seg_beg;
  const int* seg_end;
  float* partials;
  cudaStream_t stream;

  template <int V, int K, int L>
  cudaError_t run() const {
    const int n_tiles = (c + Walk<V, K, L>::kWidth - 1) / Walk<V, K, L>::kWidth;
    const int n_items = n_segments * n_tiles;
    heavy_segments_kernel<V, K, L><<<(n_items + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        n_items, n_tiles, seg_beg, seg_end, src, mp, c, partials);
    return cudaGetLastError();
  }
};

struct LightLaunch {
  const int* range_ptr;
  const int* row_ptr;
  const int* heavy_slot;
  const int* src;
  const float* mp;
  int cp;
  const float* ma;
  int ca;
  int bsz;
  const float* heavy_agg;
  const int* ent;
  int n_splits;
  int n_out;
  int rows_pass;
  int n_ranges;
  float* out;
  cudaStream_t stream;

  template <int V, int K, int L>
  cudaError_t run() const {
    const size_t smem = static_cast<size_t>(rows_pass) * (cp + ca) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(spmm_ema_kernel<V, K, L>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    dim3 grid(n_ranges, bsz);
    spmm_ema_kernel<V, K, L><<<grid, kThreads, smem, stream>>>(
        range_ptr, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz, heavy_agg, ent, n_splits,
        n_out, rows_pass, out);
    return cudaGetLastError();
  }
};

struct WideLaunch {
  const int* range_ptr;
  const int* row_ptr;
  const int* heavy_slot;
  const int* src;
  const float* mp;
  int cp;
  const float* ma;
  int ca;
  int bsz;
  const float* heavy_agg;
  const int* tile_ptr;
  const int* bucket_out;
  const int* bucket_ptr;
  const int* bucket_a;
  const int* bucket_p;
  int n_out;
  int tile_p;
  int rows_pass;
  int n_ranges;
  float* out;
  cudaStream_t stream;

  template <int V, int K, int L>
  cudaError_t run() const {
    const size_t smem = static_cast<size_t>(rows_pass) * tile_p * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(spmm_ema_wide_kernel<V, K, L>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    dim3 grid(n_ranges, bsz);
    spmm_ema_wide_kernel<V, K, L><<<grid, kThreads, smem, stream>>>(
        range_ptr, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz, heavy_agg, tile_ptr,
        bucket_out, bucket_ptr, bucket_a, bucket_p, n_out, tile_p, rows_pass, out);
    return cudaGetLastError();
  }
};

}  // namespace

// `ent` (packed, split-major) drives the shared-memory kernel; where it is
// null the stage is wide and (tile_ptr, bucket_out, bucket_ptr, bucket_a,
// bucket_p) with `tile_p` drive spmm_ema_wide_kernel.
extern "C" int spmm_ema_launch(const int* row_ptr, const int* src, int n, const float* mp,
                               int cp, const float* ma, int ca, int bsz, const int* ent,
                               int n_splits, int n_out, int rows_pass, int n_ranges,
                               const int* range_ptr, const int* heavy_slot, int n_heavy,
                               const int* seg_ptr, int n_segments, const int* seg_beg,
                               const int* seg_end, float* partials, float* heavy_agg,
                               const int* tile_ptr, const int* bucket_out,
                               const int* bucket_ptr, const int* bucket_a,
                               const int* bucket_p, int tile_p, float* out, void* stream,
                               int* launched) {
  *launched = 0;
  if (n <= 0 || bsz <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_heavy > 0) {
    const int c = bsz * cp;
    const void* ptrs[] = {mp, partials};
    const HeavyLaunch heavy{src, mp, c, n_segments, seg_beg, seg_end, partials, s};
    cudaError_t err = dispatch(c, vector_width(c, ptrs, 2), heavy);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    err = launch_heavy_reduce(seg_ptr, nullptr, n_heavy, partials, c, heavy_agg, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  const void* ptrs[] = {mp};
  const int vec = vector_width(cp, ptrs, 1);
  cudaError_t err;
  if (ent != nullptr) {
    const LightLaunch light{range_ptr, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz,
                            heavy_agg, ent, n_splits, n_out, rows_pass, n_ranges, out, s};
    err = dispatch(cp, vec, light);
  } else {
    const WideLaunch wide{range_ptr, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz,
                          heavy_agg, tile_ptr, bucket_out, bucket_ptr, bucket_a, bucket_p,
                          n_out, tile_p, rows_pass, n_ranges, out, s};
    err = dispatch(cp, vec, wide);
  }
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}
