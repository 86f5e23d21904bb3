// Blocked matrix product C = A @ B on the SMs' FP32 units, f32 accumulation.
//
// Replaces src/repro/kernels/matmul/kernel.py:37 matmul_call (pallas_call
// at :49, body _matmul_kernel at :23): a (m/bm, n/bn, k/bk) grid with K
// innermost and sequential, the f32 accumulator in VMEM scratch, cast to
// the output type on the last K step.
//
// Bound: operations.  2mnk FLOP on (mk + kn + mn) elements; at 4096^3 that
// is 683 FLOP a byte in f32, ten times the ~20 the H100 needs before its
// FP32 units and not HBM are the limit.  f32 runs on FFMA (67 TFLOP/s):
// TF32 would miss the reference's f32 tolerance.  bf16 takes the simpler of
// the two routes: its elements are widened to f32 (exactly) on their way
// into shared memory and multiplied on the same FFMA loop, so this kernel
// reaches at most 67/989 of the bf16 tensor-core bound; the wgmma route is
// later work.
//
// Design: one CTA of 256 threads per (BM x BN) tile of C; the K loop runs
// inside the CTA in place of the TPU's sequential K grid axis.  Each step
// stages a BM x BK panel of A and a BK x BN panel of B in shared memory
// with 16-byte loads (8 elements a thread), then every thread adds the
// outer products of its (BM/16) x (BN/16) register tile, BK deep.  A is
// stored transposed (k-major), so a thread reads its rows of A as float4s;
// its rows are 4 consecutive rows in each 64-row half of the tile and its
// columns likewise, so the float4 reads of one quarter-warp are
// conflict-free.  The transposed store is conflict-free because
// neighbouring threads load neighbouring rows.  The accumulator stays in
// registers for the whole K loop and is rounded once into the output type
// (bf16 to nearest even).  No ragged edge: the wrapper requires the blocks
// to divide the problem, and rows to be 16-byte aligned.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int MM_THREADS = 256;
constexpr int VEC = 8;  // elements per 16-byte (bf16) or two 16-byte (f32) loads

template <int BM, int BN, int BK>
constexpr size_t mm_smem() {
  return static_cast<size_t>(BM + BN) * BK * sizeof(float);
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(MM_THREADS)
    matmul_tile(const void* __restrict__ a, const void* __restrict__ b, void* __restrict__ c,
                int N, int K, int in_dtype, int out_dtype) {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && BK % VEC == 0, "tile shape");
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [BK][BM]: A transposed
  float* Bs = As + BK * BM;                     // [BK][BN]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int u = tid; u < BM * BK / VEC; u += MM_THREADS) {
      const int r = u % BM, col = (u / BM) * VEC;
      float x[VEC];
      load_vec<VEC>(a, (m0 + r) * K + k0 + col, in_dtype, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) As[(col + e) * BM + r] = x[e];
    }
    for (int u = tid; u < BK * BN / VEC; u += MM_THREADS) {
      const int r = u / (BN / VEC), col = (u % (BN / VEC)) * VEC;
      float x[VEC];
      load_vec<VEC>(b, static_cast<long long>(k0 + r) * N + n0 + col, in_dtype, x);
      float4* dst = reinterpret_cast<float4*>(Bs + r * BN + col);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(As + kk * BM + h * 64 + ty * 4);
        av[4 * h] = t.x;
        av[4 * h + 1] = t.y;
        av[4 * h + 2] = t.z;
        av[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(Bs + kk * BN + h * 64 + tx * 4);
        bv[4 * h] = t.x;
        bv[4 * h + 1] = t.y;
        bv[4 * h + 2] = t.z;
        bv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the panels are overwritten by the next step
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      store4(c, row * N + n0 + h * 64 + tx * 4, out_dtype, &acc[i][4 * h]);
  }
}

template <int BM, int BN, int BK>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K, int in_dtype,
                   int out_dtype, long long smem, cudaStream_t st) {
  if (smem != static_cast<long long>(mm_smem<BM, BN, BK>())) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_tile<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(N / BN, M / BM);
  matmul_tile<BM, BN, BK><<<grid, MM_THREADS, smem, st>>>(a, b, c, N, K, in_dtype, out_dtype);
  return cudaSuccess;
}

}  // namespace

// c (M, N) = a (M, K) @ b (K, N), row-major, in tiles of bm x bn, bk deep.
// The tilings compiled here are kernels/matmul/kernel.py TILINGS, and smem
// must be its smem_bytes of the tiling (checked: the layout is this file's).
extern "C" int rt_matmul(const void* a, const void* b, void* c, int M, int N, int K, int bm,
                         int bn, int bk, int in_dtype, int out_dtype, long long smem,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dtypes = (in_dtype == F32 || in_dtype == BF16) && (out_dtype == F32 || out_dtype == BF16);
  if (!dtypes || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn || K % bk)
    return finish(cudaErrorInvalidValue);
#define RT_MM(BM, BN, BK)                                                               \
  if (bm == BM && bn == BN && bk == BK)                                                 \
    return finish(launch<BM, BN, BK>(a, b, c, M, N, K, in_dtype, out_dtype, smem, st));
  RT_MM(64, 64, 16)
  RT_MM(64, 128, 16)
  RT_MM(128, 64, 16)
  RT_MM(128, 128, 16)
  RT_MM(64, 64, 128)
  RT_MM(64, 128, 128)
  RT_MM(128, 64, 128)
  RT_MM(128, 128, 128)
#undef RT_MM
  return finish(cudaErrorInvalidValue);
}
