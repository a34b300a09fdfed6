// Fused SpMM+eMA: one tree DP stage in one launch (sm_90a).
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
// columns of its source row, so one stage moves about |E| * B * C_p * 4 bytes
// of gathers (R-MAT, n = 2^20, u12's root stage: ~100 GB), against
// n * B * (C_a + C_p + n_out) * 4 bytes of compulsory traffic.  The eMA does
// n * B * n_out * n_splits FMAs out of shared memory.
//
// Design:
// * Ownership.  A CTA owns `rows` destination vertices of one coloring b
//   (grid.y) and one tile of output columns (grid.z).  It is the only writer
//   of those outputs, so there are no atomics and no cross-block pass, and
//   the result does not depend on launch order.
// * Passive-column tiles.  An aggregate of rows x C_p floats does not fit in
//   shared memory for wide stages (u12 reads 924 passive columns), so the
//   CTA loops over TILE_COLS-wide passive tiles.  For each tile it re-walks
//   its rows' edges into a rows x TILE_COLS shared aggregate (one warp per
//   row, lane l owning columns l and l + 32: coalesced 128-byte gathers,
//   four edges in flight), then applies exactly the split entries whose
//   passive column lies in the tile (the host buckets them per tile and per
//   output row, like colorsets.bucketed_split_entries).  The re-walks re-read
//   only the edge indices; every passive column is still gathered once.
// * The output tile accumulates in shared memory across the passive tiles
//   and is written once.  Entries of one output are applied in split order,
//   one thread per (row, output).
// * Empty destination blocks and rows walk no edges: their aggregate is
//   zero and they write zeros.  Hub blocks make some CTAs far longer than
//   the rest; splitting them is left to a later kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileCols = 64;  // passive columns per tile (two per lane)

__global__ void __launch_bounds__(kThreads)
spmm_ema_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ src,
                int n,
                const float* __restrict__ mp, int cp,
                const float* __restrict__ ma, int ca,
                int bsz,
                int n_batches,
                const int* __restrict__ batch_lo,
                const int* __restrict__ batch_cols,
                const int* __restrict__ batch_width,
                const int* __restrict__ batch_off,
                const int* __restrict__ ent_a,
                const int* __restrict__ ent_p,
                int n_out, int out_tile, int rows,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  float* agg = smem;                         // rows x kTileCols
  float* acc_out = smem + rows * kTileCols;  // rows x out_tile

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int o0 = blockIdx.z * out_tile;
  const int to = min(out_tile, n_out - o0);
  const int v0 = blockIdx.x * rows;
  const int nrows = min(rows, n - v0);
  const int64_t row_stride = static_cast<int64_t>(bsz) * cp;

  for (int i = threadIdx.x; i < rows * out_tile; i += kThreads) acc_out[i] = 0.f;

  for (int t = 0; t < n_batches; ++t) {
    const int lo = batch_lo[t];
    const int cols = batch_cols[t];
    const int width = batch_width[t];
    const int off = batch_off[t];
    const bool ok0 = lane < cols;
    const bool ok1 = lane + 32 < cols;

    // SpMM half: this tile's aggregate for the CTA's rows, in registers.
    for (int r = warp; r < nrows; r += kWarps) {
      const int v = v0 + r;
      const int beg = row_ptr[v];
      const int end = row_ptr[v + 1];
      const float* base = mp + static_cast<int64_t>(b) * cp + lo;
      float acc0 = 0.f, acc1 = 0.f;
      int e = beg;
      for (; e + 4 <= end; e += 4) {
        const float* r0 = base + src[e] * row_stride;
        const float* r1 = base + src[e + 1] * row_stride;
        const float* r2 = base + src[e + 2] * row_stride;
        const float* r3 = base + src[e + 3] * row_stride;
        if (ok0) {
          const float x0 = __ldg(r0 + lane), x1 = __ldg(r1 + lane);
          const float x2 = __ldg(r2 + lane), x3 = __ldg(r3 + lane);
          acc0 += x0; acc0 += x1; acc0 += x2; acc0 += x3;
        }
        if (ok1) {
          const float x0 = __ldg(r0 + lane + 32), x1 = __ldg(r1 + lane + 32);
          const float x2 = __ldg(r2 + lane + 32), x3 = __ldg(r3 + lane + 32);
          acc1 += x0; acc1 += x1; acc1 += x2; acc1 += x3;
        }
      }
      for (; e < end; ++e) {
        const float* row = base + src[e] * row_stride;
        if (ok0) acc0 += __ldg(row + lane);
        if (ok1) acc1 += __ldg(row + lane + 32);
      }
      agg[r * kTileCols + lane] = acc0;
      agg[r * kTileCols + lane + 32] = acc1;
    }
    __syncthreads();

    // eMA half: the tile's split entries, one thread per (row, output).
    for (int i = threadIdx.x; i < nrows * to; i += kThreads) {
      const int r = i / to;
      const int oo = i - r * to;
      const int o = o0 + oo;
      const float* arow = ma + (static_cast<int64_t>(v0 + r) * bsz + b) * ca;
      const int* ea = ent_a + off + o * width;
      const int* ep = ent_p + off + o * width;
      const float* ag = agg + r * kTileCols;
      float acc = acc_out[r * out_tile + oo];
      for (int j = 0; j < width; ++j) {
        const int a = ea[j];
        if (a >= 0) acc += __ldg(arow + a) * ag[ep[j]];
      }
      acc_out[r * out_tile + oo] = acc;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nrows * to; i += kThreads) {
    const int r = i / to;
    const int oo = i - r * to;
    out[(static_cast<int64_t>(v0 + r) * bsz + b) * n_out + o0 + oo] =
        acc_out[r * out_tile + oo];
  }
}

}  // namespace

extern "C" int spmm_ema_launch(const int* row_ptr, const int* src, int n,
                               const float* mp, int cp, const float* ma,
                               int ca, int bsz, int n_batches,
                               const int* batch_lo, const int* batch_cols,
                               const int* batch_width, const int* batch_off,
                               const int* ent_a, const int* ent_p, int n_out,
                               int out_tile, int rows, float* out,
                               void* stream) {
  if (n <= 0 || bsz <= 0 || n_out <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      static_cast<size_t>(rows) * (kTileCols + out_tile) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spmm_ema_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((n + rows - 1) / rows, bsz, (n_out + out_tile - 1) / out_tile);
  spmm_ema_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      row_ptr, src, n, mp, cp, ma, ca, bsz, n_batches, batch_lo, batch_cols,
      batch_width, batch_off, ent_a, ent_p, n_out, out_tile, rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spmm_ema_tile_cols() { return kTileCols; }
