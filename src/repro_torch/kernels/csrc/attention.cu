// Flash-attention forward (online softmax) on the SMs' FP32 units, in two
// routes: prefill tiles (flash_tile) and split-KV decode rows (flash_split,
// merged by flash_combine).
//
// Replaces src/repro/kernels/attention/kernel.py:73 flash_attention_call
// (pallas_call at :87, body _attn_kernel at :28): over fused batch x heads,
// a q-block of bq rows walks the KV tiles of bk rows in order, with a
// running max m, sum l and accumulator acc in f32; Q is scaled by the
// scale in f32 before Q K^T; a causal tile is skipped when
// qi*bq + bq - 1 < ki*bk and masked with -1e30 inside; l is clamped at
// 1e-30 before the division.  Any of f32 and bf16 in (widened exactly to
// f32 on load), q's type out (bf16 rounded to nearest even).  The
// reference repeats each KV head to its query heads before the kernel;
// here both routes read the KV head of a query head, h / rep with rep =
// H / Hkv, so no repeat is ever made.
//
// Bound.  Prefill (bq > 1): operations, 4*d FLOP a score on FFMA
// (67 TFLOP/s); each KV element is reused by bq query rows.  Decode
// (bq = 1): bytes, each K and V element of the cache read once for the
// rep query heads that share it.
//
// Design, prefill (flash_tile): one CTA of 2 bq threads per (batch, query
// head, q-block of bq rows), the q-blocks with the longest causal rows
// launched first.  q (B, Sq, H, d), k and v (B, Sk, Hkv, d) and the output
// (B, Sq, H, d) are addressed through their element strides, so the op
// hands the caller's tensors over with no copy.  Thread (ty, tx) of
// (bq / 8) x 16 holds rows 8 ty .. 8 ty + 7 of S and of O (TILE_ROWS), so
// its m, l and the rescale of O stay in registers, and the row max and sum
// are butterflies over the 16 threads that share the rows; its S columns
// are keys tx + 16 j (j < bk / 16), its O columns 4 tx + 64 h .. + 3.
//  * Q is loaded once, through registers, scaled with __fmul_rn into f32
//    shared memory (bq x d, row-major); rows past Sq are zero.
//  * K and V never pass through registers on their way to shared memory:
//    a TILE_STAGES-deep cp.async ring in dynamic shared memory carries, for
//    each KV tile in turn, d / KC K panels (bk keys x KC dims, rows padded
//    by 16 bytes so the 16-byte reads of 8 consecutive keys fall in distinct
//    banks) and then bk / VC V panels (VC keys x d), in the input dtype,
//    widened on read.  A stage is one panel of 16 elements a thread (4096
//    at bq = 128): KC = min(16 threads / bk, d), VC = min(16 threads / d,
//    bk).  Panels are filled while the FMAs of earlier ones run, with one
//    barrier a panel; keys past Sk land as zeros (cp.async with a source
//    size of 0), so a masked key adds 0 * 0.
//  * S = Q K^T as inner products over 4-element d chunks: per chunk a
//    thread reads its bk / 16 keys (16 bytes each in f32) and, row by row,
//    one Q float4 (a broadcast to the 16 threads of the rows): 8 (bk / 16) 4
//    FMAs for 8 + bk / 16 shared loads.  After a tile's last K panel, keys
//    past Sk and, causal, keys past the row score -1e30; then the online
//    softmax, and P goes to shared memory (bq x bk, f32).  The next panel's
//    barrier publishes it; P is rewritten only after the next tile's first
//    K panel barrier, when every thread is done reading it.
//  * O += P V: per 4 keys a thread reads 4 V rows at its d / 16 columns
//    and, row by row, one P float4 (a broadcast): 8 (d / 16) 4 FMAs for
//    d / 16 + 8 loads.  Every O element adds its products in key order.
//  * Rows past Sq are computed on zero Q and never stored; a causal walk
//    ends at the tile of the block's last real row (the reference's skip,
//    qi bq + bq - 1 < ki bk, with the block cut at Sq).
// Shared memory (kernels/attention/kernel.py smem_bytes computes the
// same): 4 (bq d + bq bk + TILE_STAGES max(bk (KC + 4), VC d)) bytes; at
// d = 128, 128 x 64 takes 150,528 B and 128 x 128 186,368 B (one CTA an
// SM).  f32 and bf16 share the layout (a bf16 panel fills half its slot;
// its K rows, padded by 16 bytes, make its 8-byte reads 2-way conflicted;
// the timed point is f32).  Why these shapes: 8 rows a thread is the
// least the design allows, so bq = 128 gives 256 threads, and at bk = 128
// a thread's S tile is 8 x 8, the f32 matmul's 128 x 128 tile (16 FMAs a
// 16-byte load); a panel of 16 elements a thread keeps each copy pass at
// four 16-byte copies and each barrier at 2048 FMAs a thread.  q-blocks of
// 64 rows (128 threads, two CTAs an SM) ran slower than both 128-row
// tilings on the causal S = 4096 point, so they are not compiled; nor did
// conflict-free Q and P rows, panels twice as large or less unrolling
// make the 128-row tiles faster.
//
// Design, decode (flash_split, flash_combine): the reference's sequence-
// parallel decode (src/repro/models/attention.py:229 _flash_decode) across
// the SMs of one card.  One CTA of 128 threads per (batch, query row, KV
// head, split) serves the rep query heads of its KV head, and reads the
// keys of its split (a whole number of bk tiles) once for all of them,
// straight from the cache's own (B, Sk, Hkv, d) layout through its strides.
// K and V pass through a SPLIT_STAGES-deep cp.async ring of 32-key stages
// (16-byte copies, rows padded by 16 bytes), so two stages of loads are in
// flight while one is scored: the split count is chosen by the host so that
// every CTA of the launch is resident at once, which keeps the bytes of
// (SPLIT_STAGES - 1) stages in flight on every SM.  Per stage: lane j of a
// warp scores key j against the warp's rows (q from shared memory, a
// broadcast); the same warp takes the row's max and sum with butterflies
// and writes P; then each thread accumulates P V for its (row, 16-byte
// column chunk) pairs.  Each split writes its m, l and acc[rep][d] in f32;
// flash_combine merges the splits of a query row in split order:
// M = max m_s, L = sum l_s exp(m_s - M), O = sum acc_s exp(m_s - M) /
// max(L, 1e-30).  No atomics, so results repeat bit for bit.
//
// Walk order and the finite running max: a walk visits its tiles in ki
// order, as the reference does, and starts at a key <= its row (tile 0 of
// a prefill walk; key 0 of decode split 0, and the first key of any causal
// split that is not skipped), so m is finite from the first tile on and a
// masked key contributes exp(-1e30 - m) = 0.  A causal split that lies
// wholly past its row is skipped by the reference's rule (its bytes are
// never read) and writes l = 0, which the combine leaves out of M, L and
// O whatever its m.  Scored instead, it would carry m = -1e30 and l = its
// key count (exp(-1e30 - (-1e30)) = 1 a key); split 0 holds key 0 <= row,
// so M is finite and such a split would weigh exp(-1e30 - M) = 0 all the
// same.  The causal skip is the reference's rule, so the visited fraction
// is the model's kv_fraction.  Math: expf (no fast-math), fma for the
// products.
#include <limits.h>

#include <type_traits>

#include "common.cuh"

using namespace rt;

namespace {

constexpr float NEG_INF = -1e30f;

// element strides of a (B, S, H, D) tensor whose last dimension is dense
struct Strides {
  long long b, s, h;
};

// ------------------------------------------------------------ prefill route

constexpr int TILE_ROWS = 8;    // query rows a thread holds in S and in O
constexpr int TILE_STAGES = 3;  // panels in the ring

__host__ __device__ constexpr int tile_threads(int bq) { return bq / TILE_ROWS * 16; }
// elements one ring stage carries: 16 a thread
__host__ __device__ constexpr int tile_panel(int bq) { return 16 * tile_threads(bq); }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
// dims of a K panel (bk keys x KC) and keys of a V panel (VC x d)
__host__ __device__ constexpr int tile_kc(int bq, int bk, int d) { return cmin(tile_panel(bq) / bk, d); }
__host__ __device__ constexpr int tile_vc(int bq, int bk, int d) { return cmin(tile_panel(bq) / d, bk); }
// floats of one ring slot: the larger panel in f32, K rows padded by 4 floats
__host__ __device__ constexpr int tile_slot(int bq, int bk, int d) {
  return bk * (tile_kc(bq, bk, d) + 4) > tile_vc(bq, bk, d) * d ? bk * (tile_kc(bq, bk, d) + 4)
                                                                  : tile_vc(bq, bk, d) * d;
}

template <int BQ, int BK, int D>
constexpr size_t tile_smem() {
  return (static_cast<size_t>(BQ) * D + static_cast<size_t>(BQ) * BK +
          static_cast<size_t>(TILE_STAGES) * tile_slot(BQ, BK, D)) * sizeof(float);
}

// four elements of T widened to float (exact for bf16): one 16-byte (f32)
// or 8-byte (bf16) load, shared or global
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(t.x << 16), __uint_as_float(t.x & 0xffff0000u),
                     __uint_as_float(t.y << 16), __uint_as_float(t.y & 0xffff0000u));
}

// four floats to T (bf16 rounded to nearest even): one 16- or 8-byte store
__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y), b = __floats2bfloat162_rn(x.z, x.w);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&a);
  t.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename T, int BQ, int BK, int D>
__global__ void __launch_bounds__(tile_threads(BQ))
    flash_tile(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int H, int rep, int Sq, int Sk, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, int causal) {
  constexpr int NT = tile_threads(BQ), TM = TILE_ROWS, TN = BK / 16, TD = D / 16;
  constexpr int KC = tile_kc(BQ, BK, D), VC = tile_vc(BQ, BK, D);
  constexpr int NKP = D / KC, NP = NKP + BK / VC;  // K panels, all panels of a KV tile
  constexpr int CH = 16 / sizeof(T);               // elements of one 16-byte copy
  constexpr int KROW = KC + CH;                    // a K panel row, padded by 16 bytes
  constexpr int SLOT = tile_slot(BQ, BK, D) * sizeof(float) / sizeof(T);
  static_assert(BQ % 64 == 0 && BK % 64 == 0 && D % 64 == 0 && D % KC == 0 && BK % VC == 0 &&
                    KC % CH == 0 && VC % 4 == 0 && (BK * KC / CH) % NT == 0 &&
                    (VC * D / CH) % NT == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D], scaled
  float* Ps = Qs + BQ * D;                       // [BQ][BK]
  T* ring = reinterpret_cast<T*>(Ps + BQ * BK);  // [TILE_STAGES][SLOT]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kg = k + b * ks.b + static_cast<long long>(h / rep) * ks.h;
  const T* vg = v + b * vs.b + static_cast<long long>(h / rep) * vs.h;
  int n_kv = (Sk + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, Sq) - 1) / BK + 1);  // the reference's skip
  const int steps = n_kv * NP;

  // the copies of step `step` (panel p of KV tile t) into its slot; one
  // commit group per call, empty past the last step
  auto issue = [&](int step) {
    if (step < steps) {
      T* dst = ring + (step % TILE_STAGES) * SLOT;
      const int t = step / NP, p = step % NP;
      if (p < NKP) {
#pragma unroll
        for (int it = 0; it < BK * KC / CH / NT; ++it) {
          const int u = tid + it * NT;
          const int r = u / (KC / CH), c = (u % (KC / CH)) * CH, key = t * BK + r;
          const bool in = key < Sk;
          cp_async16_zfill(dst + r * KROW + c, in ? kg + key * ks.s + p * KC + c : kg, in);
        }
      } else {
#pragma unroll
        for (int it = 0; it < VC * D / CH / NT; ++it) {
          const int u = tid + it * NT;
          const int r = u / (D / CH), c = (u % (D / CH)) * CH, key = t * BK + (p - NKP) * VC + r;
          const bool in = key < Sk;
          cp_async16_zfill(dst + r * D + c, in ? vg + key * vs.s + c : vg, in);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < TILE_STAGES - 1; ++st) issue(st);

  const T* qg = q + b * qs.b + static_cast<long long>(h) * qs.h;
  for (int u = tid; u < BQ * D / 4; u += NT) {
    const int r = u / (D / 4), c = (u % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) {
      x = ld4(qg + static_cast<long long>(q0 + r) * qs.s + c);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                      __fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(Qs + r * D + c) = x;
  }

  float s[TM][TN], acc[TM][TD], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }
  const float* Qr = Qs + ty * TM * D;   // this thread's rows of Q
  float* Pr = Ps + ty * TM * BK;        // and of P

  for (int step = 0; step < steps; ++step) {
    cp_async_wait(TILE_STAGES - 2);  // this thread's copies of `step` have landed
    __syncthreads();  // everyone's have (and Q, and P); everyone is done with step - 1's slot
    issue(step + TILE_STAGES - 1);   // into step - 1's slot
    const T* pan = ring + (step % TILE_STAGES) * SLOT;
    const int t = step / NP, p = step % NP;
    if (p < NKP) {  // S += Q[:, p KC : (p + 1) KC] K^T
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < KC; c += 4) {
        float4 kv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) kv[j] = ld4(pan + (tx + 16 * j) * KROW + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(Qr + i * D + p * KC + c);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = __fmaf_rn(qv.x, kv[j].x, s[i][j]);
            s[i][j] = __fmaf_rn(qv.y, kv[j].y, s[i][j]);
            s[i][j] = __fmaf_rn(qv.z, kv[j].z, s[i][j]);
            s[i][j] = __fmaf_rn(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
      if (p == NKP - 1) {  // the tile's scores are complete: online softmax, P out
        const int k0 = t * BK;
        const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = q0 + ty * TM + i;
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int col = k0 + tx + 16 * j;
            if (edge && (col >= Sk || (causal && col > row))) s[i][j] = NEG_INF;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_new = fmaxf(m[i], mx);
          const float alpha = expf(m[i] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = expf(s[i][j] - m_new);
            rs = __fadd_rn(rs, s[i][j]);
            Pr[i * BK + tx + 16 * j] = s[i][j];
          }
#pragma unroll
          for (int w = 8; w > 0; w >>= 1) rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, w));
          l[i] = __fmaf_rn(alpha, l[i], rs);
          m[i] = m_new;
#pragma unroll
          for (int j = 0; j < TD; ++j) acc[i][j] = __fmul_rn(alpha, acc[i][j]);
        }
      }
    } else {  // O += P[:, j0 : j0 + VC] V[j0 : j0 + VC]
      const int j0 = (p - NKP) * VC;
#pragma unroll
      for (int j = 0; j < VC; j += 4) {
        float4 vv[4][TD / 4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < TD / 4; ++c) vv[e][c] = ld4(pan + (j + e) * D + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 pv = *reinterpret_cast<const float4*>(Pr + i * BK + j0 + j);
          const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < TD / 4; ++c) {
              acc[i][4 * c] = __fmaf_rn(pe[e], vv[e][c].x, acc[i][4 * c]);
              acc[i][4 * c + 1] = __fmaf_rn(pe[e], vv[e][c].y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = __fmaf_rn(pe[e], vv[e][c].z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = __fmaf_rn(pe[e], vv[e][c].w, acc[i][4 * c + 3]);
            }
        }
      }
    }
  }
  cp_async_wait(0);  // the trailing empty groups

  T* og = o + b * os.b + static_cast<long long>(h) * os.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < TD / 4; ++c)
        st4(og + static_cast<long long>(row) * os.s + c * 64 + tx * 4,
            make_float4(__fdiv_rn(acc[i][4 * c], den), __fdiv_rn(acc[i][4 * c + 1], den),
                        __fdiv_rn(acc[i][4 * c + 2], den), __fdiv_rn(acc[i][4 * c + 3], den)));
    }
  }
}

// ------------------------------------------------------------ decode route

constexpr int SPLIT_THREADS = 128;
constexpr int SPLIT_WARPS = SPLIT_THREADS / 32;
constexpr int SPLIT_KEYS = 32;  // keys of one ring stage: one a lane when scored
constexpr int SPLIT_STAGES = 3;
constexpr int MAX_REP = 16;     // query heads a CTA serves (H / Hkv)
constexpr int ROWS_PER_WARP = MAX_REP / SPLIT_WARPS;
constexpr int COMBINE_THREADS = 256;

// 16 bytes of a row in shared memory, widened to float
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* x) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  }
  __device__ static float one(float t) { return t; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* x) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(h[e]);
  }
  __device__ static float one(__nv_bfloat16 t) { return __bfloat162float(t); }
};

// elements of one K or V row in the ring: 16 bytes of padding keep the
// 16-byte reads of 8 consecutive rows (one quarter-warp) on distinct banks
template <typename T, int D>
__host__ __device__ constexpr int split_row() {
  return D + Chunk<T>::N;
}

// dynamic shared memory of a launch: the ring, then in f32 the scaled q
// rows (rep x D), P (rep x SPLIT_KEYS) and the rescale factors (rep);
// kernels/attention/kernel.py split_smem_bytes computes the same
template <typename T, int D>
size_t split_smem(int rep) {
  return static_cast<size_t>(SPLIT_STAGES) * 2 * SPLIT_KEYS * split_row<T, D>() * sizeof(T) +
         static_cast<size_t>(rep) * (D + SPLIT_KEYS + 1) * sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
    flash_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part_m, float* __restrict__ part_l,
                float* __restrict__ part_acc, int Sq, int Sk, int H, int Hkv, int n_split,
                int split_keys, int bk, Strides qs, Strides ks, Strides vs, int causal,
                float scale) {
  constexpr int CH = Chunk<T>::N, NC = D / CH, ROW = split_row<T, D>();
  constexpr int NP = (MAX_REP * NC + SPLIT_THREADS - 1) / SPLIT_THREADS;  // pairs a thread
  static_assert(D % CH == 0 && CH % 4 == 0 && SPLIT_KEYS == 32, "tile shape");
  extern __shared__ float4 smem4[];
  const int rep = H / Hkv;
  T* ring = reinterpret_cast<T*>(smem4);  // [stage][K, V][key][ROW]
  float* Qs = reinterpret_cast<float*>(ring + SPLIT_STAGES * 2 * SPLIT_KEYS * ROW);  // [rep][D]
  float* Ps = Qs + rep * D;           // [rep][SPLIT_KEYS]
  float* As = Ps + rep * SPLIT_KEYS;  // [rep]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  long long idx = blockIdx.x;
  const int split = static_cast<int>(idx % n_split);
  idx /= n_split;
  const int g = static_cast<int>(idx % Hkv);
  idx /= Hkv;
  const int row = Sq - 1 - static_cast<int>(idx % Sq);  // the longest causal rows first
  const long long b = idx / Sq;
  // the partial of query row (b, row, g * rep + r) is number prow + r * n_split
  const long long prow = ((b * Sq + row) * H + static_cast<long long>(g) * rep) * n_split + split;

  const int k0 = split * split_keys;
  int k1 = min(k0 + split_keys, Sk);
  if (causal) k1 = min(k1, (row / bk + 1) * bk);  // the reference's skip: no tile past the row
  if (k1 <= k0) {  // wholly past the row: an empty partial
    for (int r = tid; r < rep; r += SPLIT_THREADS) {
      part_m[prow + r * n_split] = NEG_INF;
      part_l[prow + r * n_split] = 0.f;
    }
    for (int u = tid; u < rep * D; u += SPLIT_THREADS)
      part_acc[(prow + static_cast<long long>(u / D) * n_split) * D + u % D] = 0.f;
    return;
  }

  const T* kg = k + b * ks.b + static_cast<long long>(g) * ks.h;
  const T* vg = v + b * vs.b + static_cast<long long>(g) * vs.h;
  const int n_st = (k1 - k0) / SPLIT_KEYS;
  // the copies of stage st into its slot; one commit group per call
  auto issue = [&](int st) {
    if (st < n_st) {
      T* dk = ring + (st % SPLIT_STAGES) * 2 * SPLIT_KEYS * ROW;
      T* dv = dk + SPLIT_KEYS * ROW;
      const long long key0 = k0 + static_cast<long long>(st) * SPLIT_KEYS;
      for (int u = tid; u < SPLIT_KEYS * NC; u += SPLIT_THREADS) {
        const int j = u / NC, c = (u % NC) * CH;
        cp_async16(dk + j * ROW + c, kg + (key0 + j) * ks.s + c);
        cp_async16(dv + j * ROW + c, vg + (key0 + j) * vs.s + c);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < SPLIT_STAGES - 1; ++st) issue(st);

  const T* qg = q + b * qs.b + static_cast<long long>(row) * qs.s +
                static_cast<long long>(g) * rep * qs.h;
  for (int u = tid; u < rep * D; u += SPLIT_THREADS)
    Qs[u] = __fmul_rn(Chunk<T>::one(qg[(u / D) * qs.h + u % D]), scale);

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[NP][CH];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[i][e] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait(SPLIT_STAGES - 2);  // this thread's copies of stage st have landed
    __syncthreads();  // everyone's have (and q); everyone is done with stage st - 1
    issue(st + SPLIT_STAGES - 1);  // into the slot of stage st - 1
    const T* Ks = ring + (st % SPLIT_STAGES) * 2 * SPLIT_KEYS * ROW;
    const T* Vs = Ks + SPLIT_KEYS * ROW;

    // lane j scores key j against the warp's rows warp, warp + SPLIT_WARPS, ...
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += CH) {
      float kx[CH];
      Chunk<T>::load(Ks + lane * ROW + c, kx);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp + i * SPLIT_WARPS;
        if (r < rep) {
          const float4* qr = reinterpret_cast<const float4*>(Qs + r * D + c);
#pragma unroll
          for (int e = 0; e < CH / 4; ++e) {
            const float4 t = qr[e];
            s[i] = __fmaf_rn(t.x, kx[4 * e], s[i]);
            s[i] = __fmaf_rn(t.y, kx[4 * e + 1], s[i]);
            s[i] = __fmaf_rn(t.z, kx[4 * e + 2], s[i]);
            s[i] = __fmaf_rn(t.w, kx[4 * e + 3], s[i]);
          }
        }
      }
    }
    const bool masked = causal && k0 + st * SPLIT_KEYS + lane > row;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp + i * SPLIT_WARPS;
      if (r < rep) {  // the same for the whole warp
        const float sv = masked ? NEG_INF : s[i];
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float alpha = expf(m[i] - m_new);
        const float p = expf(sv - m_new);
        l[i] = __fmaf_rn(alpha, l[i], warp_sum(p));
        m[i] = m_new;
        Ps[r * SPLIT_KEYS + lane] = p;
        if (lane == 0) As[r] = alpha;
      }
    }
    __syncthreads();  // P and alpha are published

    // P V: thread tid owns the (row, 16-byte column chunk) pairs tid,
    // tid + SPLIT_THREADS, ...
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int pr = tid + i * SPLIT_THREADS;
      if (pr < rep * NC) {
        const int r = pr / NC, c = (pr % NC) * CH;
        const float a = As[r];
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[i][e] = __fmul_rn(a, acc[i][e]);
        const float* pp = Ps + r * SPLIT_KEYS;
#pragma unroll 8
        for (int j = 0; j < SPLIT_KEYS; ++j) {
          float vx[CH];
          Chunk<T>::load(Vs + j * ROW + c, vx);
          const float pj = pp[j];
#pragma unroll
          for (int e = 0; e < CH; ++e) acc[i][e] = __fmaf_rn(pj, vx[e], acc[i][e]);
        }
      }
    }
  }
  cp_async_wait(0);  // the trailing empty groups

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * SPLIT_WARPS;
    if (r < rep && lane == 0) {
      part_m[prow + r * n_split] = m[i];
      part_l[prow + r * n_split] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int pr = tid + i * SPLIT_THREADS;
    if (pr < rep * NC) {
      const int r = pr / NC, c = (pr % NC) * CH;
      float4* dst = reinterpret_cast<float4*>(
          part_acc + (prow + static_cast<long long>(r) * n_split) * D + c);
#pragma unroll
      for (int e = 0; e < CH / 4; ++e)
        dst[e] = make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2],
                             acc[i][4 * e + 3]);
    }
  }
}

// out[i] for i < n_out = rows * D: the splits of row i / D merged in split
// order; a split with l = 0 (empty) takes no part
__global__ void __launch_bounds__(COMBINE_THREADS)
    flash_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                  const float* __restrict__ part_acc, void* __restrict__ o, long long n_out,
                  int n_split, int D, int dtype) {
  const long long i = blockIdx.x * static_cast<long long>(COMBINE_THREADS) + threadIdx.x;
  if (i >= n_out) return;
  const long long r = i / D;
  const float* m = part_m + r * n_split;
  const float* l = part_l + r * n_split;
  const float* acc = part_acc + r * n_split * D + i % D;
  float M = __int_as_float(0xff800000);  // -inf
  for (int s = 0; s < n_split; ++s)
    if (l[s] > 0.f) M = fmaxf(M, m[s]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < n_split; ++s) {
    if (l[s] > 0.f) {
      const float w = expf(m[s] - M);
      L = __fmaf_rn(l[s], w, L);
      O = __fmaf_rn(acc[static_cast<long long>(s) * D], w, O);
    }
  }
  store1(o, i, dtype, __fdiv_rn(O, fmaxf(L, 1e-30f)));
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}, std::integral_constant<int, D>{}) for a compiled (dtype, D)
template <typename F>
cudaError_t with_type(int dtype, int D, F&& f) {
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  if (D == 64)
    return dtype == F32 ? f(Type<float>{}, std::integral_constant<int, 64>{})
                        : f(Type<__nv_bfloat16>{}, std::integral_constant<int, 64>{});
  if (D == 128)
    return dtype == F32 ? f(Type<float>{}, std::integral_constant<int, 128>{})
                        : f(Type<__nv_bfloat16>{}, std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

template <typename T, int BQ, int BK, int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale, int causal, long long smem, cudaStream_t st) {
  if (smem != static_cast<long long>(tile_smem<BQ, BK, D>())) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(flash_tile<T, BQ, BK, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  flash_tile<T, BQ, BK, D><<<dim3(B * H, (Sq + BQ - 1) / BQ), tile_threads(BQ), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / Hkv, Sq, Sk, qs, ks, vs, os, scale, causal);
  return cudaSuccess;
}

}  // namespace

// Prefill route.  o = attention(q, k, v): q and o (B, Sq, H, D), k and v
// (B, Sk, Hkv, D), one dtype, each addressed through its element strides
// (b, s, h) with the last dimension dense, 16-byte aligned; query head h
// reads KV head h / (H / Hkv); ceil(Sq / bq) q-blocks of bq rows walk
// ceil(Sk / bk) KV tiles of bk keys, the ragged edge masked.  The tilings
// compiled here are kernels/attention/kernel.py TILINGS with bq > 1 x
// HEAD_DIMS, and smem must be its smem_bytes of the tiling (checked: the
// layout is this file's).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int Hkv, int Sq, int Sk, int D, int bq, int bk,
                                  long long qsb, long long qss, long long qsh, long long ksb,
                                  long long kss, long long ksh, long long vsb, long long vss,
                                  long long vsh, long long osb, long long oss, long long osh,
                                  int causal, float scale, int dtype, long long smem,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 || bq <= 0 || bk <= 0 ||
      (Sq + bq - 1) / bq > 65535 || static_cast<long long>(B) * H > INT_MAX)
    return finish(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  return finish(with_type(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
#define RT_ATT(BQ, BK)                                                                      \
  if (bq == BQ && bk == BK)                                                                 \
    return launch_tile<T, BQ, BK, DD>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, os, scale, \
                                      causal, smem, st);
    RT_ATT(128, 64)
    RT_ATT(128, 128)
#undef RT_ATT
    return cudaErrorInvalidValue;
  }));
}

// Decode route, first pass.  The partials of every (query row, split):
// q (B, Sq, H, D) and k, v (B, Sk, Hkv, D), each addressed through its
// element strides (b, s, h) with the last dimension dense; n_split splits
// of split_keys keys (a multiple of bk, bk a multiple of 32), the last one
// shorter where Sk ends; part_m, part_l (B*Sq*H, n_split) and part_acc
// (B*Sq*H, n_split, D) in f32, query rows in (b, s, h) order.  smem must
// be kernel.py split_smem_bytes (checked against split_smem).
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v, float* part_m,
                               float* part_l, float* part_acc, int B, int Sq, int Sk, int H,
                               int Hkv, int D, int bk, int n_split, int split_keys,
                               long long qsb, long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb, long long vss,
                               long long vsh, int causal, float scale, int dtype, long long smem,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ctas = static_cast<long long>(B) * Sq * (Hkv > 0 ? Hkv : 0) * n_split;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > MAX_REP || bk <= 0 ||
      bk % SPLIT_KEYS || Sk % bk || split_keys <= 0 || split_keys % bk || n_split <= 0 ||
      static_cast<long long>(n_split - 1) * split_keys >= Sk ||
      static_cast<long long>(n_split) * split_keys < Sk || ctas > INT_MAX)
    return finish(cudaErrorInvalidValue);
  return finish(with_type(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
    if (smem != static_cast<long long>(split_smem<T, DD>(H / Hkv))) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_split<T, DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    flash_split<T, DD><<<static_cast<unsigned>(ctas), SPLIT_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_m,
        part_l, part_acc, Sq, Sk, H, Hkv, n_split, split_keys, bk, Strides{qsb, qss, qsh},
        Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, causal, scale);
    return cudaSuccess;
  }));
}

// CTAs of the decode route one SM holds at once, at a launch's shared
// memory (smem as for rt_flash_decode, for H / Hkv = rep)
extern "C" int rt_flash_decode_occupancy(int D, int dtype, int rep, long long smem,
                                         int* ctas_per_sm) {
  if (rep <= 0 || rep > MAX_REP) return finish(cudaErrorInvalidValue);
  return finish(with_type(dtype, D, [&](auto t, auto d) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int DD = decltype(d)::value;
    if (smem != static_cast<long long>(split_smem<T, DD>(rep))) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_split<T, DD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, flash_split<T, DD>,
                                                         SPLIT_THREADS, smem);
  }));
}

// Decode route, second pass: o (rows, D) in dtype, rows = B*Sq*H in
// q's (b, s, h) order, from rt_flash_decode's partials
extern "C" int rt_flash_combine(const float* part_m, const float* part_l, const float* part_acc,
                                void* o, long long rows, int n_split, int D, int dtype,
                                void* stream) {
  const long long n_out = rows * D;
  const long long blocks = (n_out + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if ((dtype != F32 && dtype != BF16) || rows <= 0 || n_split <= 0 || D <= 0 || blocks > INT_MAX)
    return finish(cudaErrorInvalidValue);
  flash_combine<<<static_cast<unsigned>(blocks), COMBINE_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(part_m, part_l, part_acc, o, n_out,
                                                       n_split, D, dtype);
  return finish(cudaSuccess);
}
