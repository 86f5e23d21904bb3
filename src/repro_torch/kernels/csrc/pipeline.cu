// Multi-buffered pipeline kernels: the ECM overlap engine on Hopper.
//
// Replaces the Pallas pipeline kernels of src/repro/kernels/pipeline.py:
//  * rt_map_pipeline    <- map_pipeline_call (:234), _map_pipeline_kernel
//                          (:96): an elementwise map whose inputs stream
//                          through a num_stages-deep VMEM ring;
//  * rt_reduce_pipeline <- reduce_pipeline_call (:258),
//                          _reduce_pipeline_kernel (:170): the same ring
//                          feeding a chunk-ordered sum into (1, 1).
//
// Bound: device-memory bytes, as for the grid kernels (a few FP32
// operations per 4-12 B moved).  What the pipeline adds is control of the
// overlap that Eq. 1 is about: at depth 1 a CTA fetches a chunk, waits for
// it, computes and stores, then fetches the next, so transfer and compute
// strictly alternate (T_nOL + T_data); at depth k it keeps k-1 chunks in
// flight while it computes (max(T_data, T_OL)).
//
// Design.  On the TPU one core walks the chunks in order with DMA
// semaphores per ring slot.  Here a persistent grid of G = min(n_chunks,
// SMs) CTAs (G = 1 for the one-SM overlap pair) walks chunks i, i+G, ...;
// each CTA owns a ring of `stages` slots per input stream in dynamic
// shared memory, filled with cp.async (16 B per copy) and one commit group
// per chunk; cp.async.wait_group(stages-1) makes chunk k resident while
// chunks k+1..k+stages-1 are still in flight.  Depth 1 prefetches nothing.
// Each thread copies and later reads back exactly the same 16-byte
// vectors, so completion of its own copy group is all it needs: no
// __syncthreads guards the ring.  Results go straight from registers to
// device memory (stores are posted, so the reference's output ring and
// its write-back semaphores have no counterpart).  The reduction adds
// whole-chunk sums in chunk order with a fixed in-chunk tree and the CTA
// partials in CTA order: neither G, nor the chunk-to-CTA map, nor any
// summation order depends on the depth, so results are bit-identical
// across depths.  A ring over 48 KB is allowed with cudaFuncSetAttribute;
// the wrapper has checked it against the card's per-block limit.
#include "common.cuh"

using namespace rt;

namespace {

// The ring of one CTA: slot `slot` of input stream j holds chunk_vectors
// vectors at ring + (j * stages + slot) * chunk_vectors.
struct Ring {
  uint4* base;
  int stages;
  int chunk_vectors;

  __device__ uint4* slot(int j, long long k) const {
    return base + (static_cast<long long>(j) * stages + k % stages) * chunk_vectors;
  }
};

// Start the copies of this CTA's k-th chunk (global chunk blockIdx.x + k*G)
// into its ring slot.  Each thread copies vectors tid, tid+THREADS, ...
template <int N>
__device__ __forceinline__ void fetch(const Ring& r, const uint4* const* in, long long k) {
  const long long c = blockIdx.x + k * gridDim.x;
  for (int j = 0; j < N; ++j) {
    uint4* dst = r.slot(j, k);
    const uint4* src = in[j] + c * r.chunk_vectors;
    for (int u = threadIdx.x; u < r.chunk_vectors; u += THREADS) cp_async16(dst + u, src + u);
  }
}

// Chunks this CTA owns: blockIdx.x, blockIdx.x + G, ... below n_chunks.
__device__ __forceinline__ long long own_chunks(long long n_chunks) {
  return (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
}

// The ring schedule common to both kernels: warm-up (chunks 0..stages-2),
// then for every chunk start the one stages-1 ahead, wait for this one,
// and hand its slot to `body`.  Every thread commits one group per step,
// empty or not, so group k always belongs to chunk k.
template <int N, typename Body>
__device__ __forceinline__ void run_ring(const Ring& r, const uint4* const* in, long long mine,
                                         Body body) {
  for (int k = 0; k < r.stages - 1; ++k) {
    if (k < mine) fetch<N>(r, in, k);
    cp_async_commit();
  }
  for (long long k = 0; k < mine; ++k) {
    if (k + r.stages - 1 < mine) fetch<N>(r, in, k + r.stages - 1);
    cp_async_commit();
    cp_async_wait(r.stages - 1);
    body(k);
  }
}

template <int OP, int DT>
__global__ void __launch_bounds__(THREADS)
    map_pipeline(const uint4* __restrict__ x, const uint4* __restrict__ y,
                 const uint4* __restrict__ z, uint4* __restrict__ out, float s, float t,
                 long long n_chunks, int chunk_vectors, int stages) {
  extern __shared__ uint4 ring_smem[];
  constexpr int N = map_inputs(OP);
  const long long mine = own_chunks(n_chunks);
  if constexpr (N == 0) {  // generator (store): nothing to fetch
    for (long long k = 0; k < mine; ++k) {
      uint4* dst = out + (blockIdx.x + k * gridDim.x) * chunk_vectors;
      for (int u = threadIdx.x; u < chunk_vectors; u += THREADS)
        dst[u] = apply<OP, DT>(s, t, uint4{}, uint4{}, uint4{});
    }
  } else {
    const uint4* in[3] = {x, y, z};
    const Ring r{ring_smem, stages, chunk_vectors};
    run_ring<N>(r, in, mine, [&](long long k) {
      uint4* dst = out + (blockIdx.x + k * gridDim.x) * chunk_vectors;
      const uint4* a = r.slot(0, k);
      const uint4* b = r.slot(N > 1 ? 1 : 0, k);
      const uint4* c = r.slot(N > 2 ? 2 : 0, k);
      for (int u = threadIdx.x; u < chunk_vectors; u += THREADS)
        dst[u] = apply<OP, DT>(s, t, a[u], N > 1 ? b[u] : uint4{}, N > 2 ? c[u] : uint4{});
    });
  }
}

template <int RED, int DT>
__global__ void __launch_bounds__(THREADS)
    reduce_pipeline(const uint4* __restrict__ x, const uint4* __restrict__ y,
                    float* __restrict__ partial, long long n_chunks, int chunk_vectors,
                    int stages) {
  extern __shared__ uint4 ring_smem[];
  constexpr int N = red_inputs(RED);
  const uint4* in[2] = {x, y};
  const Ring r{ring_smem, stages, chunk_vectors};
  float acc = 0.f;  // meaningful in thread 0
  run_ring<N>(r, in, own_chunks(n_chunks), [&](long long k) {
    const uint4* a = r.slot(0, k);
    const uint4* b = r.slot(N > 1 ? 1 : 0, k);
    float v = 0.f;
    for (int u = threadIdx.x; u < chunk_vectors; u += THREADS)
      v = accumulate<RED, DT>(v, a[u], N > 1 ? b[u] : uint4{});
    const float chunk_sum = block_sum(v);
    if (threadIdx.x == 0) acc = __fadd_rn(acc, chunk_sum);
  });
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

struct Args {
  const uint4 *x, *y, *z;
  void* out;
  float s, t;
  long long n_chunks;
  int chunk_vectors, stages, ctas;
  size_t smem;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int OP, int DT>
cudaError_t launch_map(const Args& a) {
  const cudaError_t e = allow_smem(map_pipeline<OP, DT>, a.smem);
  if (e != cudaSuccess) return e;
  map_pipeline<OP, DT><<<a.ctas, THREADS, a.smem, a.stream>>>(
      a.x, a.y, a.z, static_cast<uint4*>(a.out), a.s, a.t, a.n_chunks, a.chunk_vectors,
      a.stages);
  return cudaSuccess;
}

template <int DT>
cudaError_t dispatch_map(int op, const Args& a) {
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
cudaError_t launch_reduce(const Args& a) {
  const cudaError_t e = allow_smem(reduce_pipeline<RED, DT>, a.smem);
  if (e != cudaSuccess) return e;
  reduce_pipeline<RED, DT><<<a.ctas, THREADS, a.smem, a.stream>>>(
      a.x, a.y, static_cast<float*>(a.out), a.n_chunks, a.chunk_vectors, a.stages);
  return cudaSuccess;
}

Args make_args(int dtype, int n_in, const void* x, const void* y, const void* z, void* out,
               float s, float t, long long n_chunks, int block_rows, int stages, int ctas,
               void* stream) {
  const int cv = static_cast<int>(block_rows * row_vectors(dtype));
  return Args{static_cast<const uint4*>(x),
              static_cast<const uint4*>(y),
              static_cast<const uint4*>(z),
              out, s, t, n_chunks, cv, stages, ctas,
              static_cast<size_t>(n_in) * stages * cv * sizeof(uint4),
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// out (rows, 128) = op(s, t, x, y, z), n_chunks chunks of block_rows rows
// through a `stages`-deep ring on `ctas` persistent CTAs.
extern "C" int rt_map_pipeline(int op, int dtype, const void* x, const void* y, const void* z,
                               void* out, float s, float t, long long n_chunks, int block_rows,
                               int stages, int ctas, void* stream) {
  if (op < COPY || op > TRIAD_UPDATE) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, map_inputs(op), x, y, z, out, s, t, n_chunks, block_rows,
                           stages, ctas, stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == F32) e = dispatch_map<F32>(op, a);
  else if (dtype == BF16) e = dispatch_map<BF16>(op, a);
  return finish(e);
}

// out[0] = sum of x (LOAD) or x*y (DDOT) over n_chunks chunks; partial
// holds `ctas` floats of scratch.
extern "C" int rt_reduce_pipeline(int red, int dtype, const void* x, const void* y,
                                  void* partial, void* out, long long n_chunks, int block_rows,
                                  int stages, int ctas, void* stream) {
  if (red != LOAD && red != DDOT) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, red_inputs(red), x, y, nullptr, partial, 0.f, 0.f, n_chunks,
                           block_rows, stages, ctas, stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (red == LOAD && dtype == F32) e = launch_reduce<LOAD, F32>(a);
  else if (red == LOAD && dtype == BF16) e = launch_reduce<LOAD, BF16>(a);
  else if (red == DDOT && dtype == F32) e = launch_reduce<DDOT, F32>(a);
  else if (red == DDOT && dtype == BF16) e = launch_reduce<DDOT, BF16>(a);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return finish(e);
  sum_partials<<<1, THREADS, 0, a.stream>>>(static_cast<const float*>(partial), ctas,
                                           static_cast<float*>(out));
  return finish(cudaSuccess);
}
