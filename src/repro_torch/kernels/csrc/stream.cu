// Grid kernels of the paper's Table I stream loops: one CTA per block.
//
// Replaces the Pallas grid kernels of src/repro/kernels/stream/kernel.py:
//  * rt_grid_map    <- _streaming_call (:102) with _copy/_store/_update/
//                      _striad/_schoenauer_kernel (:47-64): A=B, A=s, A=s*A,
//                      A=B+s*C, A=B+C*D, one (block_rows, 128) block per
//                      "parallel" grid step.  It also takes the fused
//                      A=t*(B+s*C) of the triad->update chain.
//  * rt_grid_reduce <- _reduce_call (:150) with _load_kernel (:67) and
//                      _ddot_kernel (:78): sum(A) and sum(A*B) into (1, 1).
//
// Bound: device-memory bytes.  Each element is read and written once and
// costs at most a few FP32 operations (striad: 12 B and 2 FLOP per
// element), far below the ~20 FLOP/B the H100 needs before its FP32 units
// and not HBM are the limit.  So the design only has to keep HBM busy,
// with as many CTAs as blocks (8192 of 64 rows at 2^26 elements), which
// the hardware scheduler spreads over all SMs.  grid_reduce: 256 threads
// a CTA, 16-byte vector loads with neighbouring threads on neighbouring
// addresses.  grid_map (redesigned for Hopper): the block moves in and
// out by TMA bulk copies, which keep more bytes in flight per SM than
// registers do and spend no thread's issue slots on addresses; timed
// against a variant that issues every load of the block into registers
// before any arithmetic, with streaming hints, it was the faster of the
// two on every op with an input (PERF.md, Findings).
//
// On the TPU the reduction grid runs in order on one core and carries the
// sum in the output block from step to step.  Blocks here run in parallel
// and in no order, so each block writes its partial sum and a second pass
// (sum_partials) adds the partials in index order: deterministic, and no
// atomics.
#include "common.cuh"
#include "hopper.cuh"

using namespace rt;

namespace {

// A block moves through shared memory in pieces of PIECE_ROWS rows (the
// last one shorter), each input's piece in one of SLOTS ring slots with
// its own mbarrier: the reference's 64-row block is four pieces, all in
// flight at once, and a larger block reuses the slots, so no block_rows
// the wrapper accepts overflows shared memory.
constexpr int PIECE_ROWS = 16;
constexpr int SLOTS = 4;

// One (block_rows, 128) block a CTA.  Thread 0 starts the bulk copies of
// the first SLOTS pieces of every input; the threads compute each piece
// in place in the first input's slot as soon as it lands, and thread 0
// writes it back with a bulk store, so the first pieces' arithmetic and
// stores overlap the later pieces' loads.  A 64-row block is N x 32 KiB
// in f32 (64 KiB for striad), so three CTAs an SM keep 192 KiB of reads
// in flight.  A generator (store) has nothing to fetch and stores from
// registers.
template <int OP, int DT>
__global__ void __launch_bounds__(THREADS)
    grid_map(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
             const uint8_t* __restrict__ z, uint8_t* __restrict__ out, float s, float t,
             uint32_t block_bytes, uint32_t piece_bytes, int slots) {
  extern __shared__ __align__(128) uint8_t grid_smem[];
  __shared__ uint64_t full[SLOTS];
  constexpr int N = map_inputs(OP);
  const long long base = static_cast<long long>(blockIdx.x) * block_bytes;
  if constexpr (N == 0) {
    uint4* o = reinterpret_cast<uint4*>(out + base);
    const uint4 v = apply<OP, DT>(s, t, uint4{}, uint4{}, uint4{});
    for (uint32_t u = threadIdx.x; u < block_bytes / sizeof(uint4); u += THREADS) __stcs(o + u, v);
  } else {
    const uint8_t* in[3] = {x, y, z};
    const int pieces = static_cast<int>((block_bytes + piece_bytes - 1) / piece_bytes);
    // input j's slot r at (j * slots + r) * piece_bytes
    auto slot = [&](int j, int r) { return grid_smem + static_cast<size_t>(j * slots + r) * piece_bytes; };
    auto fetch = [&](int i) {  // thread 0: piece i of every input
      const uint32_t off = static_cast<uint32_t>(i) * piece_bytes;
      const uint32_t bytes = min(piece_bytes, block_bytes - off);
      const uint32_t bar = smem_u32(&full[i % slots]);
      mbar_arrive_expect_tx(bar, N * bytes);
#pragma unroll
      for (int j = 0; j < N; ++j)
        bulk_load(smem_u32(slot(j, i % slots)), in[j] + base + off, bytes, bar);
    };
    if (threadIdx.x == 0) {
      for (int r = 0; r < slots; ++r) mbar_init(smem_u32(&full[r]), 1);
      fence_barrier_init();
      for (int i = 0; i < slots; ++i) fetch(i);
    }
    __syncthreads();  // the barriers' initialisation, before anyone waits on them
    for (int i = 0; i < pieces; ++i) {
      const int r = i % slots;
      const uint32_t off = static_cast<uint32_t>(i) * piece_bytes;
      const uint32_t bytes = min(piece_bytes, block_bytes - off);
      mbar_wait(smem_u32(&full[r]), static_cast<uint32_t>((i / slots) & 1));
      uint4* a = reinterpret_cast<uint4*>(slot(0, r));
      const uint4* b = reinterpret_cast<const uint4*>(slot(N > 1 ? 1 : 0, r));
      const uint4* c = reinterpret_cast<const uint4*>(slot(N > 2 ? 2 : 0, r));
      for (uint32_t u = threadIdx.x; u < bytes / sizeof(uint4); u += THREADS)
        a[u] = apply<OP, DT>(s, t, a[u], N > 1 ? b[u] : uint4{}, N > 2 ? c[u] : uint4{});
      fence_proxy_async_smem();
      __syncthreads();  // every thread's writes, before the store reads them
      if (threadIdx.x == 0) {
        bulk_store(out + base + off, smem_u32(a), bytes);
        bulk_commit();
        // piece i + slots reuses the slot once this store has read it;
        // the others touch it only after those loads land
        if (i + slots < pieces) {
          bulk_wait_read<0>();
          fetch(i + slots);
        }
      }
    }
    if (threadIdx.x == 0) bulk_wait_read<0>();  // shared memory outlives the stores' reads
  }
}

template <int RED, int DT>
__global__ void __launch_bounds__(THREADS)
    grid_reduce(const uint4* __restrict__ x, const uint4* __restrict__ y,
                float* __restrict__ partial, int block_vectors) {
  const long long base = static_cast<long long>(blockIdx.x) * block_vectors;
  float acc = 0.f;
  for (int u = threadIdx.x; u < block_vectors; u += THREADS)
    acc = accumulate<RED, DT>(acc, x[base + u], RED == DDOT ? y[base + u] : uint4{});
  const float r = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = r;
}

struct MapArgs {
  const uint8_t *x, *y, *z;
  uint8_t* out;
  float s, t;
  long long n_blocks;
  uint32_t block_bytes, piece_bytes;
  int slots;
  cudaStream_t stream;
};

template <int OP, int DT>
cudaError_t launch_map(const MapArgs& a) {
  const size_t smem = static_cast<size_t>(map_inputs(OP)) * a.slots * a.piece_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      grid_map<OP, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  grid_map<OP, DT><<<static_cast<unsigned>(a.n_blocks), THREADS, smem, a.stream>>>(
      a.x, a.y, a.z, a.out, a.s, a.t, a.block_bytes, a.piece_bytes, a.slots);
  return cudaSuccess;
}

template <int DT>
cudaError_t dispatch_map(int op, const MapArgs& a) {
  switch (op) {
    case COPY: return launch_map<COPY, DT>(a);
    case STORE: return launch_map<STORE, DT>(a);
    case UPDATE: return launch_map<UPDATE, DT>(a);
    case STRIAD: return launch_map<STRIAD, DT>(a);
    case SCHOENAUER: return launch_map<SCHOENAUER, DT>(a);
    case TRIAD_UPDATE: return launch_map<TRIAD_UPDATE, DT>(a);
  }
  return cudaErrorInvalidValue;
}

template <int RED, int DT>
void launch_reduce(const uint4* x, const uint4* y, float* partial, long long n_blocks,
                   int block_vectors, cudaStream_t st) {
  grid_reduce<RED, DT><<<static_cast<unsigned>(n_blocks), THREADS, 0, st>>>(x, y, partial,
                                                                           block_vectors);
}

}  // namespace

// out (rows, 128) = op(s, t, x, y, z) over n_blocks blocks of block_rows rows.
extern "C" int rt_grid_map(int op, int dtype, const void* x, const void* y, const void* z,
                           void* out, float s, float t, long long n_blocks, int block_rows,
                           void* stream) {
  const uint32_t row_bytes = static_cast<uint32_t>(row_vectors(dtype) * sizeof(uint4));
  const int piece_rows = block_rows < PIECE_ROWS ? block_rows : PIECE_ROWS;
  const int pieces = (block_rows + piece_rows - 1) / piece_rows;
  const MapArgs a{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
                  static_cast<const uint8_t*>(z), static_cast<uint8_t*>(out), s, t, n_blocks,
                  block_rows * row_bytes, piece_rows * row_bytes,
                  pieces < SLOTS ? pieces : SLOTS, static_cast<cudaStream_t>(stream)};
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == F32) e = dispatch_map<F32>(op, a);
  else if (dtype == BF16) e = dispatch_map<BF16>(op, a);
  return finish(e);
}

// out[0] = sum over n_blocks blocks of x (LOAD) or x*y (DDOT); partial
// holds n_blocks floats of scratch.
extern "C" int rt_grid_reduce(int red, int dtype, const void* x, const void* y, void* partial,
                              void* out, long long n_blocks, int block_rows, void* stream) {
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* yv = static_cast<const uint4*>(y);
  float* part = static_cast<float*>(partial);
  const int bv = static_cast<int>(block_rows * row_vectors(dtype));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (red == LOAD && dtype == F32) launch_reduce<LOAD, F32>(xv, yv, part, n_blocks, bv, st);
  else if (red == LOAD && dtype == BF16) launch_reduce<LOAD, BF16>(xv, yv, part, n_blocks, bv, st);
  else if (red == DDOT && dtype == F32) launch_reduce<DDOT, F32>(xv, yv, part, n_blocks, bv, st);
  else if (red == DDOT && dtype == BF16) launch_reduce<DDOT, BF16>(xv, yv, part, n_blocks, bv, st);
  else return finish(cudaErrorInvalidValue);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_partials<<<1, THREADS, 0, st>>>(part, n_blocks, static_cast<float*>(out));
  return finish(cudaSuccess);
}
