// Blocked matrix product C = A @ B with f32 accumulation, in two routes
// behind one C entry: bf16 on the tensor cores (wgmma fed by a TMA ring),
// f32 on the SMs' FP32 units (a cp.async ring feeding an FFMA tile).
//
// Replaces src/repro/kernels/matmul/kernel.py:37 matmul_call (pallas_call
// at :49, body _matmul_kernel at :23): a (m/bm, n/bn, k/bk) grid with K
// innermost and sequential, the f32 accumulator in VMEM scratch, cast to
// the output type on the last K step.  Here one CTA owns one bm x bn tile
// of C and runs the K loop itself; the accumulator stays in registers and
// is rounded once into the output type (bf16 to nearest even).  No ragged
// edge: the wrapper requires the blocks to divide the problem.
//
// Bound: operations.  2mnk FLOP on (mk + kn + mn) elements; at 4096^3 that
// is 683 FLOP a byte in f32 and 1365 in bf16, far above the ~20 (FP32
// units) and ~295 (bf16 tensor cores) the H100 needs before compute and
// not HBM is the limit.
//
// bf16 route (matmul_wgmma): 989 TFLOP/s are reached only through wgmma.
// One producer warpgroup, of which one thread issues TMA loads, fills a
// WG_STAGES-deep ring of (A: bm x 64, B: 64 x bn) stages in dynamic shared
// memory, both operands 128-byte swizzled; each stage has a "full"
// mbarrier (the producer's arrive with the stage's bytes as its
// transaction count) and an "empty" one (one arrive per consumer
// warpgroup).  bm / 64 consumer warpgroups each own 64 rows of the tile:
// per stage, four m64nBNk16 wgmmas read A K-major and B MN-major (y is
// (k, n) row-major, so B is used as it lies, transposed by wgmma's
// imm-trans-b, with no extra pass over y), keep one commit group in flight
// and release the previous stage when it completes.  With two consumer
// warpgroups, setmaxnreg moves registers from the producer (40) to the
// consumers (232): a 64 x 256 f32 accumulator is 128 registers a thread.
// The epilogue writes the fragment straight from registers.
//
// f32 route (matmul_ffma): TF32 would miss the reference's f32 tolerance,
// so products stay on FFMA (67 TFLOP/s).  A FF_STAGES-deep ring of
// (A^T: bk x bm, rows padded by FF_A_PAD floats; B: bk x bn) panels is
// filled by cp.async while the FMAs of an earlier stage run, with one
// barrier per K step: A element by element (4-byte copies that transpose
// it on the way, so the compute loop reads both operands as float4s),
// B in 16-byte copies.  Each of 256 threads owns a (bm/16) x (bn/16)
// register tile: rows 4 ty .. 4 ty + 3 of each 64-row half and columns
// 4 tx .. 4 tx + 3 of each 64-column half, so one quarter-warp reads one
// A address (a broadcast) and 8 consecutive float4s of B (conflict-free).
// Every output adds its products in k order, one __fmaf_rn each, so the
// result does not depend on the tiling.  Tiles up to 128 x 128 ask for two
// CTAs an SM (at most 128 registers a thread), wider ones for one.
#include "common.cuh"
#include "hopper.cuh"

using namespace rt;

namespace {

// ---------------------------------------------------------------- f32 route

constexpr int FF_THREADS = 256;
constexpr int FF_STAGES = 3;
constexpr int FF_A_PAD = 4;  // floats after each k-row of A^T: keeps float4 reads aligned

template <int BM, int BN, int BK, int STAGES = FF_STAGES>
constexpr size_t ffma_smem() {
  return static_cast<size_t>(STAGES) * (BK * (BM + FF_A_PAD) + BK * BN) * sizeof(float);
}

// two CTAs an SM where a thread's tile leaves room (at most 128 registers)
constexpr int ffma_min_blocks(int bm, int bn) { return bm * bn > 128 * 128 ? 1 : 2; }

template <int BM, int BN, int BK, int STAGES = FF_STAGES>
__global__ void __launch_bounds__(FF_THREADS, ffma_min_blocks(BM, BN))
    matmul_ffma(const float* __restrict__ a, const float* __restrict__ b, void* __restrict__ c,
                int N, int K, int out_dtype) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LDA = BM + FF_A_PAD;
  constexpr int A_STAGE = BK * LDA, B_STAGE = BK * BN, STAGE = A_STAGE + B_STAGE;  // floats
  // one pass of the threads copies A_ROWS rows of A's panel (one float a
  // thread, neighbouring threads on neighbouring k) and B_ROWS rows of B's
  // (16 bytes a thread)
  constexpr int A_ROWS = FF_THREADS / BK, B_COLS = BN / 4, B_ROWS = FF_THREADS / B_COLS;
  static_assert(BM % 64 == 0 && BN % 64 == 0 && FF_THREADS % BK == 0 && BM % A_ROWS == 0 &&
                    BK % B_ROWS == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int steps = K / BK;

  // this thread's copies: global sources advance by BK columns of A and BK
  // rows of B a step; shared destinations are fixed offsets in a slot
  const int ar = tid / BK, ak = tid % BK, br = tid / B_COLS, bc = (tid % B_COLS) * 4;
  const float* ga = a + (m0 + ar) * K + ak;
  const float* gb = b + static_cast<long long>(br) * N + n0 + bc;
  const long long a_pass = static_cast<long long>(A_ROWS) * K;
  const long long b_pass = static_cast<long long>(B_ROWS) * N;
  const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sa = s_base + (ak * LDA + ar) * 4, sb = s_base + (A_STAGE + br * BN + bc) * 4;

  // the copies of step `step` into its slot; one commit group per call,
  // empty past the last step, so group i is always step i
  auto issue = [&](int step) {
    if (step < steps) {
      const uint32_t slot = (step % STAGES) * STAGE * 4;
      const float* pa = ga + static_cast<long long>(step) * BK;
#pragma unroll
      for (int i = 0; i < BM / A_ROWS; ++i, pa += a_pass)
        cp_async4(sa + slot + i * A_ROWS * 4, pa);
      const float* pb = gb + static_cast<long long>(step) * BK * N;
#pragma unroll
      for (int i = 0; i < BK / B_ROWS; ++i, pb += b_pass)
        cp_async16(sb + slot + i * B_ROWS * BN * 4, pb);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait(STAGES - 2);  // this thread's copies of `step` have landed
    __syncthreads();  // so have everyone's, and every thread is done with step - 1's slot
    issue(step + STAGES - 1);   // into step - 1's slot
    const float* as = smem + (step % STAGES) * STAGE;
    const float* bs = as + A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(as + kk * LDA + h * 64 + ty * 4);
        av[4 * h] = t.x;
        av[4 * h + 1] = t.y;
        av[4 * h + 2] = t.z;
        av[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(bs + kk * BN + h * 64 + tx * 4);
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
  }
  cp_async_wait(0);  // the trailing empty groups

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      store4(c, row * N + n0 + h * 64 + tx * 4, out_dtype, &acc[i][4 * h]);
  }
}

template <int BM, int BN, int BK>
cudaError_t launch_ffma(const void* a, const void* b, void* c, int M, int N, int K, int out_dtype,
                        long long smem, cudaStream_t st) {
  if (smem != static_cast<long long>(ffma_smem<BM, BN, BK>())) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_ffma<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(N / BN, M / BM);
  matmul_ffma<BM, BN, BK><<<grid, FF_THREADS, smem, st>>>(static_cast<const float*>(a),
                                                          static_cast<const float*>(b), c, N, K,
                                                          out_dtype);
  return cudaSuccess;
}

// --------------------------------------------------------------- bf16 route

constexpr int WG_BK = 64;         // one 128-byte swizzle row of bf16
constexpr int WG_STAGES = 4;
constexpr int WG_SLACK = 1024;    // to align the ring by hand (swizzled tiles)
constexpr int BOX_BYTES = 64 * 128;  // one 64 x 64 bf16 box

template <int BM, int BN>
struct WgLayout {
  static constexpr int CONSUMERS = BM / 64;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // slack, the ring, then a full and an empty mbarrier a stage
  static constexpr size_t SMEM =
      WG_SLACK + static_cast<size_t>(WG_STAGES) * STAGE_BYTES + 2 * WG_STAGES * sizeof(uint64_t);
};

template <int BM, int BN>
__global__ void __launch_bounds__(WgLayout<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    matmul_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 void* __restrict__ c, int N, int K, int out_dtype) {
  using L = WgLayout<BM, BN>;
  static_assert(BM % 64 == 0 && L::CONSUMERS <= 2 && (BN == 128 || BN == 256), "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + WG_SLACK - 1) & ~static_cast<uint32_t>(WG_SLACK - 1);
  const uint32_t bars = ring + WG_STAGES * L::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = K / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), L::CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    if constexpr (L::CONSUMERS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(empty(s), ((t / WG_STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_arrive_expect_tx(full(s), L::STAGE_BYTES);
        const uint32_t a_dst = ring + s * L::STAGE_BYTES, b_dst = a_dst + L::A_BYTES;
        tma_load_2d(a_dst, &ta, t * WG_BK, m0, full(s));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(b_dst + j * BOX_BYTES, &tb, n0 + 64 * j, t * WG_BK, full(s));
      }
    }
  } else {
    // consumer warpgroup cw: rows [64 cw, 64 cw + 64) of the tile
    if constexpr (L::CONSUMERS == 2) setmaxnreg_inc<232>();
    const int cw = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < steps; ++t) {
      const int s = t % WG_STAGES;
      mbar_wait(full(s), (t / WG_STAGES) & 1);
      const uint32_t a_src = ring + s * L::STAGE_BYTES + cw * 64 * 128;
      const uint32_t b_src = ring + s * L::STAGE_BYTES + L::A_BYTES;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)  // 16 k: 32 B along A's rows, 16 B rows of B
        wgmma_bf16<BN>(acc, sw128_desc(a_src + kk * 32, 16, 1024),
                       sw128_desc(b_src + kk * 16 * 128, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // step t - 1's products are done: its stage may be refilled
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((t - 1) % WG_STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

    // fragment: warp w of the warpgroup holds rows 16w + lane/4 (+8); for
    // each 8-column group j, columns 8j + 2 (lane % 4) (+1)
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
    const long long row = m0 + cw * 64 + w * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const long long col = n0 + 8 * j + 2 * (lane % 4);
      store2(c, row * N + col, out_dtype, acc[4 * j], acc[4 * j + 1]);
      store2(c, (row + 8) * N + col, out_dtype, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int BM, int BN>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, int out_dtype,
                         long long smem, cudaStream_t st) {
  using L = WgLayout<BM, BN>;
  if (smem != static_cast<long long>(L::SMEM)) return cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and row strides (K, N multiples of 8 bf16)
  if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int e = encode_bf16_2d(&ta, a, M, K, BM, WG_BK);
  if (e == 0) e = encode_bf16_2d(&tb, b, K, N, WG_BK, 64);
  if (e != 0) return static_cast<cudaError_t>(e);
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_wgmma<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, M / BM);
  matmul_wgmma<BM, BN><<<grid, L::THREADS, smem, st>>>(ta, tb, c, N, K, out_dtype);
  return cudaSuccess;
}

}  // namespace

// c (M, N) = a (M, K) @ b (K, N), row-major, in tiles of bm x bn, bk deep:
// f32 inputs on the FFMA route, bf16 on the wgmma route (bk = 64).  The
// tilings compiled here are kernels/matmul/kernel.py TILINGS[route], and
// smem must be its plan's shared bytes for the tiling (checked against
// this file's layout).
extern "C" int rt_matmul(const void* a, const void* b, void* c, int M, int N, int K, int bm,
                         int bn, int bk, int in_dtype, int out_dtype, long long smem,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dtypes = (in_dtype == F32 || in_dtype == BF16) && (out_dtype == F32 || out_dtype == BF16);
  if (!dtypes || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn || K % bk)
    return finish(cudaErrorInvalidValue);
#define RT_FF(BM, BN, BK)                                                                   \
  if (in_dtype == F32 && bm == BM && bn == BN && bk == BK)                                  \
    return finish(launch_ffma<BM, BN, BK>(a, b, c, M, N, K, out_dtype, smem, st));
#define RT_WG(BM, BN)                                                                       \
  if (in_dtype == BF16 && bm == BM && bn == BN && bk == WG_BK)                              \
    return finish(launch_wgmma<BM, BN>(a, b, c, M, N, K, out_dtype, smem, st));
  RT_FF(64, 64, 32)
  RT_FF(64, 128, 32)
  RT_FF(64, 256, 32)
  RT_FF(128, 64, 32)
  RT_FF(128, 128, 32)
  RT_FF(128, 256, 32)
  RT_FF(64, 64, 16)
  RT_FF(64, 128, 16)
  RT_FF(64, 256, 16)
  RT_FF(128, 64, 16)
  RT_FF(128, 128, 16)
  RT_FF(128, 256, 16)
  RT_WG(64, 128)
  RT_WG(128, 128)
  RT_WG(128, 256)
#undef RT_FF
#undef RT_WG
  return finish(cudaErrorInvalidValue);
}
