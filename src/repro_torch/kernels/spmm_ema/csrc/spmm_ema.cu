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
// * Wide stages: where one row's C_p + C_a floats exceed the 112 KiB budget
//   of the path above (two stages of the repo's u18, four of u20, passives
//   up to 184,756 columns).  The old wide kernel walked 1024-column passive
//   tiles and added each tile's buckets into the outputs in device memory
//   (up to 14.5 round trips per output, 0.7 TB at u20's (20, 10, 3)), read
//   M_a from device memory once per FMA (0.07-2.9 TB of 4-byte loads) and
//   sized itself to 112 KiB; it ran at 19-284x its bound.  Now, per block
//   of state rows (the 1 GiB scratch's size, cut to whole waves of the
//   card's SMs), wide_aggregate_kernel writes the rows' aggregate
//   (A_G @ M_p) and active state M_a into a device scratch, vertex axis
//   fastest within 4-row sub-blocks (a float4 per column), each passive
//   column of each edge gathered once; then wide_ema_kernel, one block of
//   32 warps per SM on up to 227 KB of shared memory, runs over (output
//   group, sub-block): per piece of the group (a run of splits whose active
//   and passive supports fit shared memory; ops.py plans them) it stages
//   both supports from the scratch as float4 rows and applies the piece's
//   entries (local 16-bit support positions, unsigned) to register
//   accumulators, four FMAs per entry, summing an output's entries in split
//   order (g lanes per output where the outputs are few: entries j, j + g,
//   ... then a fixed butterfly).  Each output is written once, after its
//   group's last piece; M_a is read from the scratch in staged float4
//   rows, never per FMA.  Bound: the gathers (e * C_p * 4 bytes; (20, 11,
//   1)) or the eMA at two shared float4 reads per four FMAs.  Summing the
//   passive supports straight from the edges instead of the scratch ran
//   3.8-14x slower; holding a row of both states whole in shared memory
//   where it fits 232,448 bytes (u18's stages, u20's (20, 7, 1)) ran
//   1.1-2.0x slower, its table read once per FMA (PERF.md).
// No float atomics and no order that depends on timing: two launches on the
// same inputs give the same bits.  No warp walks more than a segment (heavy)
// or a range's edges (light) per passive tile.  The entry point reports in
// *launched how many kernels it issued (1, or 2 per block of rows on a
// wide stage; 2 more with heavy rows).

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

constexpr int kWideThreads = 1024;  // threads of a wide eMA block, one block per SM
constexpr int kWideRows = 4;        // rows of a wide eMA block: a float4 per column
constexpr int kWideSlots = 4;       // (output, lane) items per thread of the wide eMA

// The streamed route's fill of a block of state rows [s0, s0 + 4 *
// sub_blocks) (state row s = vertex s / B, coloring s % B) into the
// scratch, a float4 of a sub-block's four rows per column, rows past
// n_state zeros: warp items (sub-block, passive column tile) first, each
// walking the sub-block's four rows (or copying a heavy row's aggregate)
// into scratch[(sb * cp + c) * 4 + q]; then items (sub-block, 128-column
// tile of M_a), each copying the four rows' active state into
// scratch[(sub_blocks * cp + sb * ca + c) * 4 + q].
template <int V, int K, int L>
__global__ void __launch_bounds__(kThreads)
wide_aggregate_kernel(int s0, int n_state, int sub_blocks, const int* __restrict__ row_ptr,
                      const int* __restrict__ heavy_slot, const int* __restrict__ src,
                      const float* __restrict__ mp, int cp, const float* __restrict__ ma,
                      int ca, int bsz, const float* __restrict__ heavy_agg,
                      float* __restrict__ scratch) {
  using W = Walk<V, K, L>;
  const int lane = threadIdx.x & 31;
  const int n_tiles = (cp + W::kWidth - 1) / W::kWidth;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= sub_blocks * n_tiles) {  // whole warps
    const int a_tiles = (ca + 127) / 128;
    const int a_item = item - sub_blocks * n_tiles;
    if (a_item >= sub_blocks * a_tiles) return;
    const int sb = a_item / a_tiles;
    const int c0 = (a_item - sb * a_tiles) * 128;
    float4* dst = reinterpret_cast<float4*>(scratch) + static_cast<int64_t>(sub_blocks) * cp +
                  static_cast<int64_t>(sb) * ca;
    for (int c = c0 + lane; c < min(ca, c0 + 128); c += 32) {
      float x[kWideRows];
#pragma unroll
      for (int q = 0; q < kWideRows; ++q) {
        const int s = s0 + sb * kWideRows + q;
        x[q] = s < n_state ? __ldg(ma + static_cast<int64_t>(s) * ca + c) : 0.f;
      }
      dst[c] = make_float4(x[0], x[1], x[2], x[3]);
    }
    return;
  }
  const int sb = item / n_tiles;
  W w(lane, (item - sb * n_tiles) * W::kWidth, cp);
  const int64_t stride = static_cast<int64_t>(bsz) * cp;
  float r[kWideRows][W::kAcc];
#pragma unroll
  for (int q = 0; q < kWideRows; ++q) {
    const int s = s0 + sb * kWideRows + q;
    const int v = s / bsz;
    const int b = s - v * bsz;
    const int slot = s < n_state ? heavy_slot[v] : -1;
    if (s >= n_state) {
#pragma unroll
      for (int i = 0; i < W::kAcc; ++i) r[q][i] = 0.f;
    } else if (slot >= 0) {
      const float* h = heavy_agg + (static_cast<int64_t>(slot) * bsz + b) * cp;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int x = 0; x < V; ++x) r[q][k * V + x] = w.ok[k] ? h[w.col[k] + x] : 0.f;
    } else {
      w.run(src, row_ptr[v], row_ptr[v + 1], mp + static_cast<int64_t>(b) * cp, stride, lane);
#pragma unroll
      for (int i = 0; i < W::kAcc; ++i) r[q][i] = w.acc[i];
    }
  }
  if (lane >= L) return;
  float4* dst = reinterpret_cast<float4*>(scratch) + static_cast<int64_t>(sb) * cp;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (w.ok[k]) {
#pragma unroll
      for (int x = 0; x < V; ++x)
        dst[w.col[k] + x] = make_float4(r[0][k * V + x], r[1][k * V + x], r[2][k * V + x],
                                        r[3][k * V + x]);
    }
}

// The streamed route's eMA: block (group, sub-block) over state rows
// row0 = s0 + 4 * sub-block on, from a 1-D grid in tiles of sub_tile
// sub-blocks by all groups, sub-blocks fastest: at sub_tile 1 a wave takes
// many groups of one sub-block (its scratch read once; the table, if it
// fits L2, stays there), at 16 a few groups of 16 sub-blocks (a table past
// L2 read once per tile instead of once per sub-block).  Per piece it
// stages the active and passive supports from the scratch as float4 rows,
// then each (output, lane) item applies its entries; each output is
// written once.
__global__ void __launch_bounds__(kWideThreads, 1)
wide_ema_kernel(int s0, int n_state, int sub_blocks, int sub_tile,
                const float* __restrict__ scratch, int ca, int cp,
                const int* __restrict__ group_out, const int* __restrict__ group_piece,
                const int* __restrict__ piece_ent, const int* __restrict__ piece_sa,
                const int* __restrict__ piece_sp, const int* __restrict__ sup_a,
                const int* __restrict__ sup_p, const unsigned* __restrict__ ent, int n_out,
                float* __restrict__ out) {
  extern __shared__ float4 sup[];
  const int tid = threadIdx.x;
  const int n_groups = gridDim.x / sub_blocks;
  const int tile = blockIdx.x / (n_groups * sub_tile);
  const int span = min(sub_tile, sub_blocks - tile * sub_tile);
  const int rest = blockIdx.x - tile * n_groups * sub_tile;
  const int grp = rest / span;
  const int sb = tile * sub_tile + (rest - grp * span);
  const int row0 = s0 + sb * kWideRows;
  const int o0 = group_out[grp];
  const int G = group_out[grp + 1] - o0;
  int g = 1;
  while (g < 32 && G * g * 2 <= kWideThreads) g <<= 1;
  const int items = G * g;
  const int j = tid & (g - 1);
  // this sub-block's aggregate and active state in the scratch
  const float4* bp = reinterpret_cast<const float4*>(scratch) + static_cast<int64_t>(sb) * cp;
  const float4* ba = reinterpret_cast<const float4*>(scratch) +
                     static_cast<int64_t>(sub_blocks) * cp + static_cast<int64_t>(sb) * ca;
  float4 acc[kWideSlots];
#pragma unroll
  for (int i = 0; i < kWideSlots; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int pc = group_piece[grp]; pc < group_piece[grp + 1]; ++pc) {
    const int a0 = piece_sa[pc], na = piece_sa[pc + 1] - a0;
    const int p0 = piece_sp[pc], np = piece_sp[pc + 1] - p0;
    float4* sa = sup;
    float4* sp = sup + na;
    for (int i = tid; i < na; i += kWideThreads) sa[i] = __ldg(ba + sup_a[a0 + i]);
    for (int i = tid; i < np; i += kWideThreads) sp[i] = __ldg(bp + sup_p[p0 + i]);
    __syncthreads();

    const int cnt = (piece_ent[pc + 1] - piece_ent[pc]) / G;
    const unsigned* e0 = ent + piece_ent[pc];
#pragma unroll
    for (int s = 0; s < kWideSlots; ++s) {
      const int item = tid + s * kWideThreads;
      if (item < items) {
        const unsigned* e = e0 + item / g;  // entry t of the output at e[t * G]
        float4 r = acc[s];
        int t = j;
        for (; t + g < cnt; t += 2 * g) {  // two loads ahead (32 warps hide the rest)
          const unsigned x0 = __ldg(e + t * G), x1 = __ldg(e + (t + g) * G);
          const float4 a0 = sa[x0 & 0xffffu], u0 = sp[x0 >> 16];
          const float4 a1 = sa[x1 & 0xffffu], u1 = sp[x1 >> 16];
          r.x += a0.x * u0.x; r.y += a0.y * u0.y; r.z += a0.z * u0.z; r.w += a0.w * u0.w;
          r.x += a1.x * u1.x; r.y += a1.y * u1.y; r.z += a1.z * u1.z; r.w += a1.w * u1.w;
        }
        for (; t < cnt; t += g) {
          const unsigned x = __ldg(e + t * G);
          const float4 a = sa[x & 0xffffu], u = sp[x >> 16];
          r.x += a.x * u.x; r.y += a.y * u.y; r.z += a.z * u.z; r.w += a.w * u.w;
        }
        acc[s] = r;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kWideSlots; ++s) {
    float4 r = acc[s];
    for (int off = g >> 1; off > 0; off >>= 1) {  // every lane: whole warps shuffle
      r.x += __shfl_xor_sync(0xffffffffu, r.x, off);
      r.y += __shfl_xor_sync(0xffffffffu, r.y, off);
      r.z += __shfl_xor_sync(0xffffffffu, r.z, off);
      r.w += __shfl_xor_sync(0xffffffffu, r.w, off);
    }
    const int item = tid + s * kWideThreads;
    if (item < items && j == 0) {
      const int o = o0 + item / g;
      const float v[kWideRows] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < kWideRows; ++q)
        if (row0 + q < n_state) out[static_cast<int64_t>(row0 + q) * n_out + o] = v[q];
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

// The streamed route: per block of block_rows state rows, the rows'
// aggregate and active state into the scratch, then the eMA over (group,
// sub-block).
struct StreamLaunch {
  const int* row_ptr;
  const int* heavy_slot;
  const int* src;
  const float* mp;
  int cp;
  const float* ma;
  int ca;
  int bsz;
  int n_state;
  const float* heavy_agg;
  int n_groups;
  const int* group_out;
  const int* group_piece;
  const int* piece_ent;
  const int* piece_sa;
  const int* piece_sp;
  const int* sup_a;
  const int* sup_p;
  const unsigned* ent;
  int n_out;
  int smem;
  int block_rows;
  int sub_tile;
  float* scratch;
  float* out;
  cudaStream_t stream;
  int* launched;

  template <int V, int K, int L>
  cudaError_t run() const {
    cudaError_t err = cudaFuncSetAttribute(wide_ema_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (cp + Walk<V, K, L>::kWidth - 1) / Walk<V, K, L>::kWidth;
    for (int s0 = 0; s0 < n_state; s0 += block_rows) {
      const int sub_blocks = (min(block_rows, n_state - s0) + kWideRows - 1) / kWideRows;
      const int items = sub_blocks * (n_tiles + (ca + 127) / 128);
      wide_aggregate_kernel<V, K, L><<<(items + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          s0, n_state, sub_blocks, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz, heavy_agg,
          scratch);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launched;
      wide_ema_kernel<<<n_groups * sub_blocks, kWideThreads, smem, stream>>>(
          s0, n_state, sub_blocks, sub_tile, scratch, ca, cp, group_out, group_piece, piece_ent,
          piece_sa, piece_sp, sup_a, sup_p, ent, n_out, out);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launched;
    }
    return cudaSuccess;
  }
};

}  // namespace

// route 0: the shared-memory kernel (ent packed, split-major); 1: the wide
// stage's fill and eMA over the plan (ent its local entries; rows_pass the
// state rows per block, sub_tile the eMA grid's tile height, scratch a
// block's aggregate and active state).
extern "C" int spmm_ema_launch(const int* row_ptr, const int* src, int n, const float* mp,
                               int cp, const float* ma, int ca, int bsz, const int* ent,
                               int n_splits, int n_out, int rows_pass, int n_ranges,
                               const int* range_ptr, const int* heavy_slot, int n_heavy,
                               const int* seg_ptr, int n_segments, const int* seg_beg,
                               const int* seg_end, float* partials, float* heavy_agg,
                               int route, int n_groups, const int* group_out,
                               const int* group_piece, const int* piece_ent,
                               const int* piece_sa, const int* piece_sp, const int* sup_a,
                               const int* sup_p, int smem, int sub_tile, float* scratch,
                               float* out, void* stream, int* launched) {
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
  if (route != 0) {
    const StreamLaunch streamed{row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz, n * bsz,
                                heavy_agg, n_groups, group_out, group_piece, piece_ent,
                                piece_sa, piece_sp, sup_a, sup_p,
                                reinterpret_cast<const unsigned*>(ent), n_out, smem,
                                rows_pass, sub_tile, scratch, out, s, launched};
    return static_cast<int>(dispatch(cp, vec, streamed));
  }
  const LightLaunch light{range_ptr, row_ptr, heavy_slot, src, mp, cp, ma, ca, bsz,
                          heavy_agg, ent, n_splits, n_out, rows_pass, n_ranges, out, s};
  const cudaError_t err = dispatch(cp, vec, light);
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

// The wide eMA block's shape, which ops.py plans for (checked when it loads).
extern "C" int spmm_ema_wide_threads() { return kWideThreads; }
extern "C" int spmm_ema_wide_rows() { return kWideRows; }

// ---------------------------------------------------------------------------
// The bag eMA: one bag extend's or join's colorset update, with no SpMM.
//
// Replaces no TPU kernel: the reference runs a bag op's update as XLA
// gathers and multiply-adds (src/repro/exec/local.py _bag_extend /
// _bag_join), as the port's loop in exec/local.py does off the card.  It is
// kernel A's eMA without the aggregate: for every output (vertex tuple
// i = (i_0, ..., i_{r-1}), coloring b, column o)
//
//   out[i, b, o] = (prod_x adj[i_0, i_x]) * sum_t A[i, b, ia[t][o]] * P[i, b, ip[t][o]],
//
// the terms summed in table order from zero, one FMA each (the loop's
// addcmul_), the product of the 0/1 masks (axes x of the op's mask
// vertices; i_0 is the new vertex) applied after the sum.  A is the new
// vertex's one-hot leaf broadcast over the other axes (extend) or the first
// state (join); P the SpMM'd or broadcast state (extend) or the second state
// (join).  Both are read through their strides on the vertex axes (stride 0
// where broadcast, permuted where a forget left them so); their (B, C) tail
// is contiguous.
//
// Bound: device memory.  The loop moved each output 4 + 2 * n_terms times
// (zero fill, each term's gathers of both operands, addcmul_'s read and
// write) and a masked state twice more.  Here each output is written once
// and each operand row read once: a row's B * C floats lie in the few lines
// one warp touches, so its other terms hit L1.  An output whose mask is 0
// reads nothing but its mask (0 times a finite sum is 0), so a masked
// extend reads P only at the graph's edges.  A block takes whole vertex
// tuples, about kBagOutputs outputs: its first threads decode one tuple
// each (offsets and mask, into shared memory), then all threads walk the
// block's outputs in memory order, so each warp stores 128 contiguous bytes.
// The term table (int32 ia | ip << 16, term-major) sits in shared memory; a
// warp's lanes read one term of consecutive columns.  Divisions by the
// launch's constants are multiply-shifts.  No atomics: two launches on the
// same inputs give the same bits.

namespace {

constexpr int kBagMaxAxes = 6;     // vertex axes of a bag state (k = 6 graphlets: 5)
constexpr int kBagThreads = 256;
constexpr int kBagOutputs = 4096;  // outputs one block aims at (whole tuples)

// x / d for x < 2^31 by one multiply-high (PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
  FastDiv() = default;
  explicit FastDiv(unsigned div) : d(div) {
    for (s = 0; s < 31 && (1u << s) < d; ++s) {
    }
    const uint64_t one = 1;
    m = static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned x) const { return (__umulhi(x, m) + x) >> s; }
};

struct BagShape {
  int rank;              // vertex axes of the output
  int mask_bits;         // bit x: multiply by adj[i_0, i_x]
  int n_terms, n_out;
  int width;             // B * n_out: the outputs of one vertex tuple
  int tuples_per_block;
  unsigned n_tuples;     // n ** rank
  int64_t adj_n;         // the adjacency's row stride
  int64_t a_stride[kBagMaxAxes], p_stride[kBagMaxAxes];  // vertex axes
  int64_t a_bstride, p_bstride;                          // the coloring axis
  FastDiv by_n, by_width, by_out;
};

__global__ void __launch_bounds__(kBagThreads)
bag_ema_kernel(const BagShape sh, const float* __restrict__ a, const float* __restrict__ p,
               const float* __restrict__ adj, const int* __restrict__ ent,
               float* __restrict__ out) {
  extern __shared__ unsigned bag_ent[];  // n_terms x n_out
  __shared__ int64_t tup_a[kBagThreads], tup_p[kBagThreads];
  __shared__ float tup_m[kBagThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < sh.n_terms * sh.n_out; i += kBagThreads) bag_ent[i] = ent[i];
  const unsigned t0 = blockIdx.x * static_cast<unsigned>(sh.tuples_per_block);
  const int n_t = min(sh.tuples_per_block, static_cast<int>(sh.n_tuples - t0));
  if (tid < n_t) {
    unsigned idx[kBagMaxAxes];
    unsigned rest = t0 + tid;
#pragma unroll
    for (int x = kBagMaxAxes - 1; x > 0; --x) {
      idx[x] = 0;
      if (x < sh.rank) {
        const unsigned q = sh.by_n.div(rest);
        idx[x] = rest - q * sh.by_n.d;
        rest = q;
      }
    }
    idx[0] = rest;
    int64_t oa = 0, op = 0;
    float m = 1.f;
#pragma unroll
    for (int x = 0; x < kBagMaxAxes; ++x) {
      if (x < sh.rank) {
        oa += idx[x] * sh.a_stride[x];
        op += idx[x] * sh.p_stride[x];
        if (sh.mask_bits >> x & 1) m *= __ldg(adj + idx[0] * sh.adj_n + idx[x]);
      }
    }
    tup_a[tid] = oa;
    tup_p[tid] = op;
    tup_m[tid] = m;
  }
  __syncthreads();
  const int count = n_t * sh.width;
  float* dst = out + static_cast<int64_t>(t0) * sh.width;
  for (int l = tid; l < count; l += kBagThreads) {
    const unsigned tl = sh.by_width.div(l);
    const unsigned j = l - tl * sh.width;
    const unsigned b = sh.by_out.div(j);
    const unsigned o = j - b * sh.n_out;
    const float m = tup_m[tl];
    float v = 0.f;
    if (m != 0.f) {
      const float* pa = a + tup_a[tl] + b * sh.a_bstride;
      const float* pp = p + tup_p[tl] + b * sh.p_bstride;
      float acc = 0.f;
      for (int t = 0; t < sh.n_terms; ++t) {
        const unsigned e = bag_ent[t * sh.n_out + o];
        acc = fmaf(__ldg(pa + (e & 0xffffu)), __ldg(pp + (e >> 16)), acc);
      }
      v = acc * m;
    }
    dst[l] = v;
  }
}

}  // namespace

// One bag op's update into the contiguous (n,) * rank + (bsz, n_out) `out`.
// a_strides / p_strides (host arrays): the rank vertex axes' strides, then
// the coloring axis's; mask_axes: the vertex axes x of adj[i_0, i_x].
// Returns cudaErrorInvalidValue for a shape the kernel does not take (the
// wrapper checks first).
extern "C" int bag_ema_launch(const float* a, const int64_t* a_strides, const float* p,
                              const int64_t* p_strides, int rank, int n, int bsz,
                              const int* ent, int n_terms, int n_out, int n_masks,
                              const int* mask_axes, const float* adj, float* out,
                              void* stream) {
  if (rank < 0 || rank > kBagMaxAxes || n_masks < 0 || n_masks >= kBagMaxAxes)
    return static_cast<int>(cudaErrorInvalidValue);
  uint64_t tuples = 1;
  for (int x = 0; x < rank; ++x) tuples *= static_cast<uint64_t>(n);
  const int64_t width = static_cast<int64_t>(bsz) * n_out;
  if (tuples >= (1ull << 31) || width >= (1ll << 30) || n_terms * n_out > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tuples == 0 || width == 0) return static_cast<int>(cudaSuccess);
  BagShape sh{};
  sh.rank = rank;
  for (int j = 0; j < n_masks; ++j) {
    if (mask_axes[j] <= 0 || mask_axes[j] >= rank) return static_cast<int>(cudaErrorInvalidValue);
    sh.mask_bits |= 1 << mask_axes[j];
  }
  sh.n_terms = n_terms;
  sh.n_out = n_out;
  sh.width = static_cast<int>(width);
  const int64_t per_block = kBagOutputs / width;
  sh.tuples_per_block = per_block < 1 ? 1 : per_block > kBagThreads ? kBagThreads
                                                                     : static_cast<int>(per_block);
  sh.n_tuples = static_cast<unsigned>(tuples);
  sh.adj_n = n;
  for (int x = 0; x < rank; ++x) {
    sh.a_stride[x] = a_strides[x];
    sh.p_stride[x] = p_strides[x];
  }
  sh.a_bstride = a_strides[rank];
  sh.p_bstride = p_strides[rank];
  sh.by_n = FastDiv(static_cast<unsigned>(n > 1 ? n : 1));
  sh.by_width = FastDiv(static_cast<unsigned>(width));
  sh.by_out = FastDiv(static_cast<unsigned>(n_out));
  const unsigned blocks =
      static_cast<unsigned>((tuples + sh.tuples_per_block - 1) / sh.tuples_per_block);
  const size_t smem = static_cast<size_t>(n_terms) * n_out * sizeof(unsigned);
  bag_ema_kernel<<<blocks, kBagThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sh, a, p, adj, ent, out);
  return static_cast<int>(cudaGetLastError());
}
