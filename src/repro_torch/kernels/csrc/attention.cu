// Flash-attention forward (online softmax) on the SMs' FP32 units.
//
// Replaces src/repro/kernels/attention/kernel.py:73 flash_attention_call
// (pallas_call at :87, body _attn_kernel at :28): over fused batch x heads,
// a q-block of bq rows walks the KV tiles of bk rows in order, with a
// running max m, sum l and accumulator acc in f32; Q is scaled by d^-0.5
// in f32 before Q K^T; a causal tile is skipped when
// qi*bq + bq - 1 < ki*bk and masked with -1e30 inside; l is clamped at
// 1e-30 before the division.  Any of f32 and bf16 in (widened exactly to
// f32 on load), q's type out (bf16 rounded to nearest even).
//
// Bound.  Prefill (bq >= 64): operations, 4*d FLOP a score on FFMA
// (67 TFLOP/s); each KV element is reused by bq query rows.  Decode
// (bq = 1): bytes, every K and V element is read once for one query row.
//
// Design, prefill (flash_tile): one CTA of 256 threads per (fused head,
// q-block); the q-blocks with the longest causal rows are launched first.
// Shared memory holds Q^T (scaled), K^T and V for one tile; S = Q K^T
// stays in registers, a (bq/16) x (bk/16) tile a thread, and P is written
// over K^T (row-major, rows padded by 4 floats so the float4 stores of a
// quarter-warp fall in distinct banks) once every thread has read K^T.
// A thread holds the same bq/16 rows in S and in O, so its m, l and the
// rescale of acc stay in registers; the row max and sum are butterflies
// over the 16 threads that share the rows.  One stage, no cp.async: at
// d = 128 and bq = bk = 128 the tile takes 194 KiB of the 227 KB a block
// may use, so one CTA runs on an SM and the next tile's loads wait for
// the barrier.  Decode (flash_row): one CTA per (fused head, query row);
// scores are one warp per key (the row split over the 32 lanes, 16-byte
// loads for d = 128 f32), the tile's max and sum are block reductions,
// and P V runs with threads over d, 256/d key groups summed at the end.
// K and V are read straight from device memory: nothing is reused.
//
// Walk order: tiles are visited in ki order, as the reference does.  Tile 0
// always holds column 0 <= row, so m is finite from the first tile on and a
// row that a later tile masks whole contributes exp(-1e30 - m) = 0.  The
// causal skip is the reference's rule, so the visited fraction is the
// model's kv_fraction.  Math: expf (no fast-math), fma for the products.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int ATT_THREADS = 256;
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int PAD = 4;  // floats of padding per row of P

template <int BQ, int BK, int D>
constexpr size_t tile_smem() {
  constexpr size_t kp = D * BK > BQ * (BK + PAD) ? D * BK : BQ * (BK + PAD);
  return (static_cast<size_t>(D) * BQ + kp + static_cast<size_t>(BK) * D) * sizeof(float);
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    flash_tile(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
               void* __restrict__ o, int Sq, int Sk, float scale, int causal, int dtype) {
  static_assert(BQ % 64 == 0 && BK % 64 == 0 && D % 64 == 0, "tile shape");
  constexpr int TM = BQ / 16, TN = BK / 16, TD = D / 16, PS = BK + PAD;
  constexpr int KP = D * BK > BQ * PS ? D * BK : BQ * PS;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]: Q^T, scaled
  float* KP_ = Qt + D * BQ;                      // [D][BK]: K^T, then [BQ][PS]: P
  float* Vs = KP_ + KP;                          // [BK][D]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long qbase = (bh * Sq + q0) * D;

  for (int u = tid; u < BQ * D / 8; u += ATT_THREADS) {
    const int r = u % BQ, c = (u / BQ) * 8;
    float x[8];
    load_vec<8>(q, qbase + static_cast<long long>(r) * D + c, dtype, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qt[(c + e) * BQ + r] = __fmul_rn(x[e], scale);
  }

  float acc[TM][TD], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = Sk / BK;
  for (int ki = 0; ki < n_kv; ++ki) {
    if (causal && q0 + BQ - 1 < ki * BK) break;  // the reference's skip; later tiles too
    const long long kbase = (bh * Sk + static_cast<long long>(ki) * BK) * D;
    for (int u = tid; u < BK * D / 8; u += ATT_THREADS) {
      const int r = u % BK, c = (u / BK) * 8;
      float x[8];
      load_vec<8>(k, kbase + static_cast<long long>(r) * D + c, dtype, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) KP_[(c + e) * BK + r] = x[e];
    }
    for (int u = tid; u < BK * D / 8; u += ATT_THREADS) {
      const int r = u / (D / 8), c = (u % (D / 8)) * 8;
      float x[8];
      load_vec<8>(v, kbase + static_cast<long long>(r) * D + c, dtype, x);
      float4* dst = reinterpret_cast<float4*>(Vs + r * D + c);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(Qt + c * BQ + h * 64 + ty * 4);
        av[4 * h] = t.x;
        av[4 * h + 1] = t.y;
        av[4 * h + 2] = t.z;
        av[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(KP_ + c * BK + h * 64 + tx * 4);
        bv[4 * h] = t.x;
        bv[4 * h + 1] = t.y;
        bv[4 * h + 2] = t.z;
        bv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + (i / 4) * 64 + ty * 4 + i % 4;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = ki * BK + (j / 4) * 64 + tx * 4 + j % 4;
        if (causal && row < col) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, o));
      l[i] = __fmaf_rn(alpha, l[i], rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] = __fmul_rn(alpha, acc[i][j]);
    }
    __syncthreads();  // every thread has read K^T: P goes over it
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h)
        *reinterpret_cast<float4*>(KP_ + r * PS + h * 64 + tx * 4) =
            make_float4(s[i][4 * h], s[i][4 * h + 1], s[i][4 * h + 2], s[i][4 * h + 3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TM], vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = KP_[((i / 4) * 64 + ty * 4 + i % 4) * PS + j];
#pragma unroll
      for (int h = 0; h < TD / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(Vs + j * D + h * 64 + tx * 4);
        vv[4 * h] = t.x;
        vv[4 * h + 1] = t.y;
        vv[4 * h + 2] = t.z;
        vv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int dd = 0; dd < TD; ++dd) acc[i][dd] = __fmaf_rn(pv[i], vv[dd], acc[i][dd]);
    }
    __syncthreads();  // K^T/P and V are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = (i / 4) * 64 + ty * 4 + i % 4;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int h = 0; h < TD / 4; ++h) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = __fdiv_rn(acc[i][4 * h + e], den);
      store4(o, qbase + row * D + h * 64 + tx * 4, dtype, out);
    }
  }
}

// max (MAX) or sum of v over the block, in a fixed order, returned to every
// thread; `red` holds ATT_WARPS floats
template <bool MAX>
__device__ __forceinline__ float block_all(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < ATT_WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : __fadd_rn(r, red[w]);
  __syncthreads();  // red is reused by the next call
  return r;
}

template <int BK, int D>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_row(const void* __restrict__ q, const void* __restrict__ k, const void* __restrict__ v,
              void* __restrict__ o, int Sq, int Sk, float scale, int causal, int dtype) {
  static_assert(BK <= ATT_THREADS && D % 64 == 0 && ATT_THREADS % D == 0, "tile shape");
  constexpr int E = D / 32;           // elements of a row per lane
  constexpr int G = ATT_THREADS / D;  // key groups of P V
  __shared__ float p[BK];
  __shared__ float part[ATT_THREADS];
  __shared__ float red[ATT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, c = tid % D, g = tid / D;
  const long long bh = blockIdx.x;
  const int row = gridDim.y - 1 - blockIdx.y;
  const long long qbase = (bh * Sq + row) * D;

  float qv[E];
  load_vec<E>(q, qbase + lane * E, dtype, qv);
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = __fmul_rn(qv[e], scale);

  float m = NEG_INF, l = 0.f, acc = 0.f;
  const int n_kv = Sk / BK;
  for (int ki = 0; ki < n_kv; ++ki) {
    if (causal && row < ki * BK) break;  // the reference's skip at bq = 1
    const long long kbase = (bh * Sk + static_cast<long long>(ki) * BK) * D;
#pragma unroll 4
    for (int key = warp; key < BK; key += ATT_WARPS) {
      float kv[E];
      load_vec<E>(k, kbase + static_cast<long long>(key) * D + lane * E, dtype, kv);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s = __fmaf_rn(qv[e], kv[e], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) p[key] = causal && row < ki * BK + key ? NEG_INF : s;
    }
    __syncthreads();
    const float sv = tid < BK ? p[tid] : NEG_INF;
    const float m_new = fmaxf(m, block_all<true>(sv, red));
    const float alpha = expf(m - m_new);
    const float e = tid < BK ? expf(sv - m_new) : 0.f;
    if (tid < BK) p[tid] = e;  // each thread rewrites only the score it read
    l = __fmaf_rn(alpha, l, block_all<false>(e, red));  // its barrier publishes p
    m = m_new;
    acc = __fmul_rn(alpha, acc);
#pragma unroll 8
    for (int j = g; j < BK; j += G) acc = __fmaf_rn(p[j], load1(v, kbase + static_cast<long long>(j) * D + c, dtype), acc);
    __syncthreads();  // p is rewritten by the next tile
  }
  part[tid] = acc;
  __syncthreads();
  if (g == 0) {
    float t = part[c];
#pragma unroll
    for (int h = 1; h < G; ++h) t = __fadd_rn(t, part[h * D + c]);
    store1(o, qbase + c, dtype, __fdiv_rn(t, fmaxf(l, 1e-30f)));
  }
}

template <int BQ, int BK, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk,
                   float scale, int causal, int dtype, long long smem, cudaStream_t st) {
  const dim3 grid(BH, Sq / BQ);
  if constexpr (BQ == 1) {
    if (smem != 0) return cudaErrorInvalidValue;
    flash_row<BK, D><<<grid, ATT_THREADS, 0, st>>>(q, k, v, o, Sq, Sk, scale, causal, dtype);
  } else {
    if (smem != static_cast<long long>(tile_smem<BQ, BK, D>())) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tile<BQ, BK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    flash_tile<BQ, BK, D><<<grid, ATT_THREADS, smem, st>>>(q, k, v, o, Sq, Sk, scale, causal, dtype);
  }
  return cudaSuccess;
}

}  // namespace

// o = attention(q, k, v) over BH fused heads: q, o (BH, Sq, D), k, v
// (BH, Sk, D), row-major, one dtype; tiles of bq query rows and bk keys.
// The tilings compiled here are kernels/attention/kernel.py TILINGS x
// HEAD_DIMS, and smem must be its smem_bytes of the tiling (checked: the
// layout is this file's; 0 for bq = 1, whose buffers are static).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int BH,
                                  int Sq, int Sk, int D, int bq, int bk, int causal, float scale,
                                  int dtype, long long smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != F32 && dtype != BF16) || bq <= 0 || bk <= 0 || Sq % bq || Sk % bk ||
      Sq / bq > 65535)
    return finish(cudaErrorInvalidValue);
#define RT_ATT(BQ, BK, DD)                                                                  \
  if (bq == BQ && bk == BK && D == DD)                                                      \
    return finish(launch<BQ, BK, DD>(q, k, v, o, BH, Sq, Sk, scale, causal, dtype, smem, st));
  RT_ATT(64, 64, 64)
  RT_ATT(64, 128, 64)
  RT_ATT(128, 64, 64)
  RT_ATT(128, 128, 64)
  RT_ATT(64, 64, 128)
  RT_ATT(64, 128, 128)
  RT_ATT(128, 64, 128)
  RT_ATT(128, 128, 128)
  RT_ATT(1, 128, 64)
  RT_ATT(1, 256, 64)
  RT_ATT(1, 128, 128)
  RT_ATT(1, 256, 128)
#undef RT_ATT
  return finish(cudaErrorInvalidValue);
}
