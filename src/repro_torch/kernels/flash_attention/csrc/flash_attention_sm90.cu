// FlashAttention-2 forward on Hopper's tensor cores: bf16 q, k, v in the
// model's (b, s, h, d) layout, causal or not (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:30
// flash_attention_kernel (launched by flash_attention_call), the TPU kernel
// whose grid walks (batch*heads, q_blocks, kv_blocks) in order and carries
// the running max, normaliser and accumulator in VMEM scratch.  Here one
// CTA owns (batch, query head, 128-row query tile) and loops over its key
// tiles; the softmax state and the output accumulator stay in registers.
// fp32 inputs go to csrc/flash_attention.cu instead (CUDA cores, fp32
// products, for the fp32 logits gate).
//
// Semantics are those of flash_attention.cu: fp32 scores, running max,
// normaliser and accumulator; scale 1/sqrt(d) applied in the log2 domain;
// top-left causal alignment (query i sees keys j <= i); keys at or past
// `sk` masked; key tiles wholly above the diagonal never loaded.  Query
// head hq reads kv head hq / (h / h_kv): there is no repeated copy of K/V.
//
// Bound: operations.  At the LM forward's shape (b=4, s=4096, h=32, d=128,
// causal) the function is 4*b*h*s*s*d/2 = 5.50e11 FLOP, 0.556 ms at the
// dense bf16 peak of 989 TFLOP/s, against 0.34 GB of compulsory traffic
// (0.10 ms at 3.35 TB/s).  So the products belong on the tensor cores:
// both run as wgmma.
//
// Why P is split.  Rounding P to one bf16 before P.V gives errors of up to
// 2^-9 of each weight that do not cancel in outputs near zero.  An
// emulation of this kernel's arithmetic (64-key tiles, bf16 inputs, d=128,
// against fp32 attention) broke the card's gate |err| <= 1e-4 + 1e-2 |want|
// at 17,686 of 524,288 outputs at s=512 and 32,573 of 2,097,152 at s=2048.
// With P = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi), and
// O += p_hi.V + p_lo.V, no output broke it; the worst error was 0.0039,
// the same as with fp32 P.  This costs a second P.V product: 1.5x the
// tensor-core work of the function.  tests/test_torch_flash_attention.py
// keeps the emulation (one bf16 P breaks the gate at 5,246 of 131,072
// outputs at s=256, the split at none).
//
// Design.  384 threads: warpgroup 0 is the producer (one thread issues
// every copy; setmaxnreg gives its registers to the consumers), warpgroups
// 1 and 2 are consumers of 64 query rows each.
// - Loads: TMA over 4-D tensor maps (d, heads, s, b) built on the host for
//   each launch, boxes of one head x rows x min(d, 64) columns, so any
//   batch/row/head strides work and rows past sq or sk arrive as zeros.
//   Q is loaded once; K and V of each 128-key tile go through a 2-stage
//   ring with full (transaction-count) and empty (8 consumer warps)
//   mbarriers, so the next tile's copy overlaps this tile's products.
// - Shared-memory tiles are 128-byte swizzled at d >= 64 (d = 128 as two
//   64-column blocks), 64-byte at d = 32 and 32-byte at d = 16: the swizzle
//   the TMA writes is the one the wgmma descriptors read.
// - S = Q.K^T: wgmma m64n128k16, both operands K-major in shared memory,
//   fp32 accumulator in registers (64 per thread).
// - Softmax: the row max of the raw scores, then one FFMA and one
//   ex2.approx per weight; a row's 4 threads reduce with two shuffles.
// - O += P.V: wgmma m64n{d}k16 with A from registers (the S accumulator's
//   layout is the A-fragment layout, so p_hi/p_lo are packed in place) and
//   V as the MN-major B operand (transpose bit), fp32 O in registers.
// - Each consumer runs S, softmax, P.V in turn; the two consumers and the
//   producer's copies overlap one another.  Turn-taking between the
//   consumers (ping-pong) and running a tile's softmax under the previous
//   tile's P.V were tried and measured no faster on the H100: the second
//   holds S, P and O live at once and ptxas serialises the wgmmas.
// - Heaviest causal tiles launch first (grid y reversed), as in
//   flash_attention.cu.  Output rows past sq are never written.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWg = 64;           // query rows per consumer warpgroup
constexpr int kBlockM = 2 * kRowsPerWg;  // query rows per CTA
constexpr int kBlockN = 128;             // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 384;            // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 128 * 40 + 256 * 232 <= 384 * 168
constexpr float kMasked = -1e30f;

// Shared-memory geometry of one head-dim instantiation.
template <int D>
struct Geo {
  static constexpr int kCols = D < 64 ? D : 64;     // columns per swizzled block
  static constexpr int kPitch = kCols * 2;           // bytes per row of a block
  static constexpr int kColBlocks = D / kCols;       // 2 at d = 128, else 1
  static constexpr uint64_t kLayout = D >= 64 ? 1 : (D == 32 ? 2 : 3);  // 128B / 64B / 32B
  static constexpr int kQBytes = kRowsPerWg * D * 2;   // one warpgroup's Q
  static constexpr int kTileBytes = kBlockN * D * 2;   // one K or V tile
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kTileBytes + (1 + 3 * kStages) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// lasts 10 s means a copy or an arrival was lost: trap (the launch fails
// with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - start > 10000000000ull) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Registers a wgmma reads or writes asynchronously: the empty asm pins
// their values at this point, so the compiler neither reads an accumulator
// before the wait nor reuses an A fragment's registers while it is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in bits 62-63.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (Geo<D>::kLayout << 62);
}

// K-major operand (Q or K: rows x D, D contiguous): the descriptor of the
// 16 columns starting at column e of a tile of `rows` rows.  Inside a
// swizzled block the start moves by 32 bytes per 16 columns; the second
// 64-column block of d = 128 starts rows * 128 bytes further on.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int e) {
  using G = Geo<D>;
  const uint32_t addr = tile + (e / G::kCols) * rows * G::kPitch + (e % G::kCols) * 2;
  return make_desc<D>(addr, 16, 8 * G::kPitch);
}

// MN-major operand (V: keys x D, D contiguous) as B of P.V: the 16 keys
// starting at key r.  LBO steps between the 64-column blocks of d = 128,
// SBO between groups of 8 keys.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int r) {
  using G = Geo<D>;
  return make_desc<D>(tile + r * G::kPitch, kBlockN * G::kPitch, 8 * G::kPitch);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16, fp32) += A (registers, 4 x bf16x2) . B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32, fp32) += A (registers, 4 x bf16x2) . B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64, fp32) += A (registers, 4 x bf16x2) . B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128, fp32) = A . B when `first` (d is only written), else d += A . B;
  // A and B in shared memory, both K-major
  template <bool first>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
    if constexpr (first) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
          "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
          "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
          : "l"(a), "l"(b), "r"(0));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b), "r"(1));
    }
  }
  // d (64 x 128, fp32) += A (registers, 4 x bf16x2) . B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, int64_t o_sb, int64_t o_sr,
                            int64_t o_sh, int h, int group, int sq, int sk, int causal,
                            float scale_log2) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte boundary (the swizzle pattern's period)
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = s_base;
  const uint32_t sK = sQ + 2 * G::kQBytes;
  const uint32_t sV = sK + kStages * G::kTileBytes;
  const uint32_t bar_q = sV + kStages * G::kTileBytes;
  const uint32_t bar_k = bar_q + 8;                  // [kStages]: K of a stage landed
  const uint32_t bar_v = bar_k + 8 * kStages;        // [kStages]: V of a stage landed
  const uint32_t bar_e = bar_v + 8 * kStages;        // [kStages]: the stage is free

  const int bi = blockIdx.x / h;
  const int hq = blockIdx.x - bi * h;
  const int hkv = hq / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;   // heaviest causal tiles first
  int n_tiles = (sk + kBlockN - 1) / kBlockN;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, 2 * G::kQBytes);
      for (int w = 0; w < 2; ++w)
        for (int cb = 0; cb < G::kColBlocks; ++cb)
          tma_load(sQ + w * G::kQBytes + cb * kRowsPerWg * G::kPitch, &tq, bar_q,
                   cb * G::kCols, hq, q0 + w * kRowsPerWg, bi);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(bar_e + 8 * st, ((j / kStages) & 1) ^ 1);   // the first round passes
        const uint32_t k_tile = sK + st * G::kTileBytes;
        const uint32_t v_tile = sV + st * G::kTileBytes;
        mbar_expect_tx(bar_k + 8 * st, G::kTileBytes);
        for (int cb = 0; cb < G::kColBlocks; ++cb)
          tma_load(k_tile + cb * kBlockN * G::kPitch, &tk, bar_k + 8 * st, cb * G::kCols, hkv,
                   j * kBlockN, bi);
        mbar_expect_tx(bar_v + 8 * st, G::kTileBytes);
        for (int cb = 0; cb < G::kColBlocks; ++cb)
          tma_load(v_tile + cb * kBlockN * G::kPitch, &tv, bar_v + 8 * st, cb * G::kCols, hkv,
                   j * kBlockN, bi);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int first_row = q0 + cw * kRowsPerWg;
  // this thread's accumulator rows: row0 (regs 4n, 4n+1) and row0 + 8
  // (regs 4n+2, 4n+3); its columns are 8n + 2 (lane % 4) + {0, 1}
  const int row0 = first_row + (t >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t q_tile = sQ + cw * G::kQBytes;

  float o[D / 2];
  float s[kBlockN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max of the raw scores and normaliser of this thread's two rows;
  // key 0 is visible to every row, so the max is finite after tile 0
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * kBlockN;

    // S = Q K^T
    mbar_wait(bar_k + 8 * st, parity);
    const uint32_t k_tile = sK + st * G::kTileBytes;
    wgmma_fence();
    Wgmma<kBlockN>::template ss<true>(s, kmajor_desc<D>(q_tile, kRowsPerWg, 0),
                                      kmajor_desc<D>(k_tile, kBlockN, 0));
#pragma unroll
    for (int e = 16; e < D; e += 16)
      Wgmma<kBlockN>::template ss<false>(s, kmajor_desc<D>(q_tile, kRowsPerWg, e),
                                         kmajor_desc<D>(k_tile, kBlockN, e));
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // online softmax in the log2 domain; masked keys weigh exactly 0
    const bool edge = k0 + kBlockN > sk || (causal && k0 + kBlockN - 1 > first_row);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * n + 2 * i + c];
          if (edge) {
            const int key = k0 + 8 * n + col0 + c;
            if (key >= sk || (causal && key > row0 + 8 * i)) x = kMasked;
          }
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2], m_scaled[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = fast_exp2((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      m_scaled[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * n + 2 * i + c];
          x = fast_exp2(fmaf(x, scale_log2, -m_scaled[i]));
          sum[i] += x;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * n + 2 * i] *= alpha[i];
        o[4 * n + 2 * i + 1] *= alpha[i];
      }

    // P = p_hi + p_lo, packed as the A fragments of 16-key steps: step kk
    // takes accumulator registers 8kk..8kk+7 in pairs
    uint32_t p_hi[kBlockN / 16][4], p_lo[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, b - hf.y);
        p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += p_hi V + p_lo V
    mbar_wait(bar_v + 8 * st, parity);
    const uint32_t v_tile = sV + st * G::kTileBytes;
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      Wgmma<D>::rs(o, p_hi[kk], mnmajor_desc<D>(v_tile, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      Wgmma<D>::rs(o, p_lo[kk], mnmajor_desc<D>(v_tile, 16 * kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    pin(p_hi);
    pin(p_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e + 8 * st);   // this warp is done with the stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst = out + bi * o_sb + row * o_sr + hq * o_sh + col0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), found through the
// runtime so the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (b, s, heads, d) bf16 tensor with element strides (batch, row, head) as
// a 4-D map over (d, heads, s, b); boxes of one head x `rows` x min(d, 64).
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int s, int b,
              int64_t s_batch, int64_t s_row, int64_t s_head, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d < 64 ? d : 64), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = d >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk, int h,
           int h_kv, int causal, const int64_t* st, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, h, sq, b, st[0], st[1], st[2], kRowsPerWg) ||
      !make_map(&tk, k, D, h_kv, sk, b, st[3], st[4], st[5], kBlockN) ||
      !make_map(&tv, v, D, h_kv, sk, b, st[6], st[7], st[8], kBlockN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Geo<D>::kSmem + 1024;   // + alignment slack
  auto kernel = flash_attention_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (sq + kBlockM - 1) / kBlockM);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), st[9],
                                           st[10], st[11], h, h / h_kv, sq, sk, causal,
                                           scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, sq, h, d), k and v: (b, sk, h_kv, d), out: (b, sq, h, d), all bf16
// with unit stride on d.  `strides` holds the element strides (batch, row,
// head) of q, k, v and out in that order; the ones TMA reads must be
// multiples of 8 and the pointers 16-byte aligned.  Returns a cudaError_t.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* out,
                                           int b, int sq, int sk, int h, int h_kv, int d,
                                           int causal, const int64_t* strides, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return static_cast<int>(cudaSuccess);
  if (sk <= 0 || h_kv <= 0 || h % h_kv || (sq + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, out, b, sq, sk, h, h_kv, causal, strides, s);
    case 32: return launch<32>(q, k, v, out, b, sq, sk, h, h_kv, causal, strides, s);
    case 64: return launch<64>(q, k, v, out, b, sq, sk, h, h_kv, causal, strides, s);
    case 128: return launch<128>(q, k, v, out, b, sq, sk, h, h_kv, causal, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
