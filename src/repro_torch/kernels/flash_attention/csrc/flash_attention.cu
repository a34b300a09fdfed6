// FlashAttention-2 forward for fp32 q, k, v in the model's (b, s, h, d)
// layout, causal or not, on the CUDA cores (sm_90a).  bf16 inputs go to
// csrc/flash_attention_sm90.cu (tensor cores); this design serves the fp32
// forward, whose logits gate (within 5e-5 of max |logits| of fp32 sdpa)
// rules out bf16 or TF32 tensor-core products.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py  flash_attention_kernel
// (launched by flash_attention_call), the TPU kernel whose grid walks
// (batch*heads, q_blocks, kv_blocks) in order and carries the running max,
// normaliser and accumulator in VMEM scratch from one kv step to the next.
// Here blocks run in no order, so one CTA owns a (head, 64-row query tile)
// and walks its key tiles in a loop; the softmax state lives in registers.
//
// Semantics: scores, running max, normaliser and accumulator in fp32, scale
// 1/sqrt(d), top-left causal alignment (query i sees keys j <= i), key tiles
// strictly above the diagonal skipped.  Query head hq reads kv head
// hq / (h / h_kv) in place, with the caller's batch/row/head strides.  Rows
// past sq or sk load as zeros, keys at or past `sk` are masked (the TPU
// kernel gives its zero padding weight exp(0 - m) when causal=false), and
// output rows past sq are never written.
//
// Bound: operations.  A CTA does 2 * 64 * 64 * d multiply-adds per key
// tile against 2 * 64 * d * 4 bytes read, far above the card's ops-per-byte
// line, and the fp32 CUDA cores (67 TFLOP/s) are the only fp32 rate
// without rounding the inputs.
//
// Design: 256 threads as 16 x 16.  Thread (ty, tx) owns query rows
// 4ty..4ty+3; for S = Q K^T it owns keys tx + 16j (j < 4), for O += P V it
// owns D/16 output columns.  Q stays in shared memory for the whole CTA; K
// and then V of each key tile are staged through one shared buffer (rows
// padded by 4 floats, so the float4 reads of 8 neighbouring rows fall in
// distinct banks).  Row max is reduced over the row's 16 threads with
// shuffles; each thread keeps a partial normaliser, summed at the end.  P
// goes through shared memory transposed, so a thread reads its 4 rows'
// weights of one key as one float4.  Shared memory at d = 128 is 85 KB, so
// two CTAs share an SM.  Tiles of the causal diagonal's far end are
// launched first (heaviest work first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;      // query rows per CTA, keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr float kMasked = -1e30f;

// Element strides (batch, row, head) of q, k, v and out.
struct Strides {
  int64_t q[3], k[3], v[3], o[3];
};

// A (64 x D) tile of rows `row_stride` apart into shared memory rows of
// D + 4 floats; rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t row_stride, int valid) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < kBlock * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i - r * kVecPerRow) * 4;
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) =
        r < valid ? *reinterpret_cast<const float4*>(src + r * row_stride + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       Strides st, int h, int group, int sq, int sk, int causal,
                       float scale_log2) {
  constexpr int LD = D + 4;            // Q and K/V rows in shared memory
  constexpr int LDP = kBlock + 4;      // rows of P^T
  constexpr int kCols = D / 16;        // output columns per thread
  constexpr int kVec = D >= 64 ? 4 : 1;
  constexpr int kGroups = kCols / kVec;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBlock * LD;
  float* sPt = sKV + kBlock * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bi = blockIdx.x / h;
  const int hq = blockIdx.x - bi * h;
  const int hkv = hq / group;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * kBlock;
  const float* qp = q + bi * st.q[0] + q0 * st.q[1] + hq * st.q[2];
  const float* kp = k + bi * st.k[0] + hkv * st.k[2];
  const float* vp = v + bi * st.v[0] + hkv * st.v[2];

  load_tile<D>(sQ, qp, st.q[1], sq - q0);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kBlock - 1) / kBlock;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();   // the previous tile's V and P^T reads are done
    load_tile<D>(sKV, kp + k0 * st.k[1], st.k[1], sk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sKV + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

    // Online softmax in the log2 domain; masked keys get weight exactly 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool valid[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < sk && (!causal || kpos <= qpos);
        s[i][j] = valid[j] ? s[i][j] * scale_log2 : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? exp2f(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sPt + (tx + 16 * j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // S is done with K; P^T is complete
    load_tile<D>(sKV, vp + k0 * st.v[1], st.v[1], sk - k0);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(sPt + kk * LDP + ty * 4);
      const float* vrow = sKV + kk * LD;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if constexpr (kVec == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
          const float vs[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][g * 4 + e] = fmaf(p.x, vs[e], acc[0][g * 4 + e]);
            acc[1][g * 4 + e] = fmaf(p.y, vs[e], acc[1][g * 4 + e]);
            acc[2][g * 4 + e] = fmaf(p.z, vs[e], acc[2][g * 4 + e]);
            acc[3][g * 4 + e] = fmaf(p.w, vs[e], acc[3][g * 4 + e]);
          }
        } else {
          const float vs = vrow[g * 16 + tx];
          acc[0][g] = fmaf(p.x, vs, acc[0][g]);
          acc[1][g] = fmaf(p.y, vs, acc[1][g]);
          acc[2][g] = fmaf(p.z, vs, acc[2][g]);
          acc[3][g] = fmaf(p.w, vs, acc[3][g]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(row_sum16(l[i]), 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    float* o = out + bi * st.o[0] + row * st.o[1] + hq * st.o[2];
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = kVec == 4 ? g * 64 + tx * 4 + e : g * 16 + tx;
        o[col] = acc[i][g * kVec + e] * inv;
      }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, const Strides& st, int b,
           int sq, int sk, int h, int h_kv, int causal, cudaStream_t stream) {
  const int smem = (2 * kBlock * (D + 4) + kBlock * (kBlock + 4)) * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (sq + kBlock - 1) / kBlock);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, st, h, h / h_kv, sq, sk, causal,
                                           scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, sq, h, d), k and v: (b, sk, h_kv, d), out: (b, sq, h, d), all fp32
// with unit stride on d.  `strides` holds the element strides (batch, row,
// head) of q, k, v and out in that order, each a multiple of 4 (float4
// loads).  Keys at or past `sk` are masked.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int sq, int sk, int h, int h_kv, int d, int causal,
                                      const int64_t* strides, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return static_cast<int>(cudaSuccess);
  if (sk <= 0 || h_kv <= 0 || h % h_kv || (sq + kBlock - 1) / kBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(qf, kf, vf, of, st, b, sq, sk, h, h_kv, causal, s);
    case 32: return launch<32>(qf, kf, vf, of, st, b, sq, sk, h, h_kv, causal, s);
    case 64: return launch<64>(qf, kf, vf, of, st, b, sq, sk, h, h_kv, causal, s);
    case 128: return launch<128>(qf, kf, vf, of, st, b, sq, sk, h, h_kv, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
