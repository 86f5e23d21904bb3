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
// semaphores per ring slot.  Here a persistent grid of G CTAs walks chunks
// i, i+G, ...; each CTA owns a ring of `stages` slots per input stream in
// dynamic shared memory.  G is min(n_chunks, SMs) for the reduction; for
// the map it is min(n_chunks, SMs x the map CTAs an SM holds at once,
// max(SMs, ceil(n_chunks / stages))): one CTA an SM, then as many rings,
// and bytes in flight, as shared memory allows while each ring still gets
// as many chunks as it has slots.  G = 1 for the one-SM overlap pair.
//
// map_pipeline (redesigned for Hopper): one thread moves every byte with
// TMA bulk copies, so the others spend no issue slots on copies.  A chunk
// of one input is block_rows x 128 contiguous elements, so a plain bulk
// copy (cp.async.bulk, no tensor map) fetches it; each input slot
// completes on its own mbarrier with the slot's byte count.  Results go
// into an output ring (the reference's out_scr / out_sem) that the same
// thread drains with bulk stores (cp.async.bulk ... bulk_group), waiting
// on wait_group.read before a slot is rewritten and before the CTA exits
// (the reference's drain; the writes complete with the grid).  Two
// output slots where they fit beside the input ring, else one (the
// wrapper decides; schoenauer's 64-row depth-2 ring leaves room for
// one): with two, one barrier a chunk both publishes the slot to the
// async proxy and frees the input slot; with one, a second barrier waits
// for the store to read it.  The fetch
// of chunk k + stages is issued once chunk k is computed, so depth 1
// fetches, waits, computes and stores before the next fetch (that store
// overlapping the next fetch, as in the reference), and depth k keeps
// k - 1 chunks in flight while it computes.
//
// reduce_pipeline: the ring is filled with cp.async (16 B per copy) and
// one commit group per chunk; cp.async.wait_group(stages-1) makes chunk k
// resident while chunks k+1..k+stages-1 are still in flight.  Each thread copies and later
// reads back exactly the same 16-byte vectors, so completion of its own
// copy group is all it needs: no __syncthreads guards the ring.  It adds
// whole-chunk sums in chunk order with a fixed in-chunk tree and the CTA
// partials in CTA order: neither G, nor the chunk-to-CTA map, nor any
// summation order depends on the depth, so results are bit-identical
// across depths.  A ring over 48 KB is allowed with cudaFuncSetAttribute;
// the wrapper has checked it against the card's per-block limit.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

using namespace rt;

namespace {

// The reduction's ring of one CTA: slot `slot` of input stream j holds
// chunk_vectors vectors at ring + (j * stages + slot) * chunk_vectors.
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

// The reduction's ring schedule: warm-up (chunks 0..stages-2),
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

// Shared memory of a map CTA: the input ring (slot `slot` of stream j at
// (j * stages + slot) * chunk_bytes), the output ring of out_slots slots,
// then one mbarrier per input slot.
struct MapRing {
  uint8_t* base;
  int n_in, stages, out_slots;
  uint32_t chunk_bytes;

  __device__ uint8_t* in(int j, int slot) const {
    return base + static_cast<size_t>(j * stages + slot) * chunk_bytes;
  }
  __device__ uint8_t* out(int slot) const { return in(n_in, 0) + static_cast<size_t>(slot) * chunk_bytes; }
  __device__ uint64_t* full(int slot) const {
    return reinterpret_cast<uint64_t*>(out(out_slots)) + slot;
  }
};

// Issued by one thread: the bulk copies of this CTA's k-th chunk (global
// chunk blockIdx.x + k*G) of every input into its ring slot, completing on
// the slot's mbarrier with the slot's bytes.
template <int N>
__device__ __forceinline__ void fetch_bulk(const MapRing& r, const uint8_t* const* in, long long k) {
  const int slot = static_cast<int>(k % r.stages);
  const long long c = blockIdx.x + k * gridDim.x;
  const uint32_t bar = smem_u32(r.full(slot));
  mbar_arrive_expect_tx(bar, N * r.chunk_bytes);
#pragma unroll
  for (int j = 0; j < N; ++j)
    bulk_load(smem_u32(r.in(j, slot)), in[j] + c * r.chunk_bytes, r.chunk_bytes, bar);
}

// The loop of one CTA.  Thread 0 starts the first `stages` chunks.  Then
// for every chunk: wait on its slot's mbarrier, compute it from the input
// slot into output slot k % out_slots, fence the writes for the async
// proxy and meet at one barrier; thread 0 then starts the chunk's bulk
// store and the fetch of chunk k + stages into the input slot just read.
// With two output slots, thread 0 waits before that barrier until the
// store of chunk k-1 has read its slot, so slot (k+1) % 2 is free when the
// other threads pass it; with one, it waits for chunk k's own store and a
// second barrier holds the others.
template <int OP, int DT>
__global__ void __launch_bounds__(THREADS)
    map_pipeline(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                 const uint8_t* __restrict__ z, uint8_t* __restrict__ out, float s, float t,
                 long long n_chunks, uint32_t chunk_bytes, int stages, int out_slots) {
  extern __shared__ __align__(128) uint8_t map_smem[];
  constexpr int N = map_inputs(OP);
  const MapRing r{map_smem, N, stages, out_slots, chunk_bytes};
  const long long mine = own_chunks(n_chunks);
  const int cv = static_cast<int>(chunk_bytes / sizeof(uint4));
  const bool lead = threadIdx.x == 0;
  auto dst = [&](long long k) { return out + (blockIdx.x + k * gridDim.x) * chunk_bytes; };
  if constexpr (N == 0) {  // generator (store): one slot, written once, stored per chunk
    uint4* o = reinterpret_cast<uint4*>(r.out(0));
    for (int u = threadIdx.x; u < cv; u += THREADS)
      o[u] = apply<OP, DT>(s, t, uint4{}, uint4{}, uint4{});
    fence_proxy_async_smem();
    __syncthreads();
    if (lead) {
      for (long long k = 0; k < mine; ++k) bulk_store(dst(k), smem_u32(o), chunk_bytes);
      bulk_commit();
      bulk_wait_read<0>();
    }
  } else {
    const uint8_t* in[3] = {x, y, z};
    if (lead) {
      for (int i = 0; i < stages; ++i) mbar_init(smem_u32(r.full(i)), 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (lead)
      for (long long k = 0; k < stages && k < mine; ++k) fetch_bulk<N>(r, in, k);
    for (long long k = 0; k < mine; ++k) {
      const int slot = static_cast<int>(k % stages);
      mbar_wait(smem_u32(r.full(slot)), static_cast<uint32_t>((k / stages) & 1));
      const uint4* a = reinterpret_cast<const uint4*>(r.in(0, slot));
      const uint4* b = reinterpret_cast<const uint4*>(r.in(N > 1 ? 1 : 0, slot));
      const uint4* c = reinterpret_cast<const uint4*>(r.in(N > 2 ? 2 : 0, slot));
      uint4* o = reinterpret_cast<uint4*>(r.out(static_cast<int>(k % out_slots)));
      for (int u = threadIdx.x; u < cv; u += THREADS)
        o[u] = apply<OP, DT>(s, t, a[u], N > 1 ? b[u] : uint4{}, N > 2 ? c[u] : uint4{});
      fence_proxy_async_smem();
      if (lead && out_slots > 1) bulk_wait_read<0>();
      __syncthreads();
      if (lead) {
        bulk_store(dst(k), smem_u32(o), chunk_bytes);
        bulk_commit();
        if (k + stages < mine) fetch_bulk<N>(r, in, k + stages);
      }
      if (out_slots == 1) {
        if (lead) bulk_wait_read<0>();
        __syncthreads();
      }
    }
    if (lead) bulk_wait_read<0>();  // the CTA's shared memory outlives the stores' reads
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
  int chunk_vectors, stages, out_slots, ctas;
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
      reinterpret_cast<const uint8_t*>(a.x), reinterpret_cast<const uint8_t*>(a.y),
      reinterpret_cast<const uint8_t*>(a.z), static_cast<uint8_t*>(a.out), a.s, a.t, a.n_chunks,
      static_cast<uint32_t>(a.chunk_vectors * sizeof(uint4)), a.stages, a.out_slots);
  return cudaSuccess;
}

// CTAs of map_pipeline<OP, DT> one SM holds at once at a launch's shared memory
template <int OP, int DT>
cudaError_t occupancy_map(const Args& a, int* ctas_per_sm) {
  const cudaError_t e = allow_smem(map_pipeline<OP, DT>, a.smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, map_pipeline<OP, DT>, THREADS,
                                                       a.smem);
}

// f(op, dtype tag) for the compiled map kernels
template <typename F>
cudaError_t with_map(int op, int dtype, F f) {
  auto by_op = [&](auto dt) -> cudaError_t {
    switch (op) {
      case COPY: return f(std::integral_constant<int, COPY>{}, dt);
      case STORE: return f(std::integral_constant<int, STORE>{}, dt);
      case UPDATE: return f(std::integral_constant<int, UPDATE>{}, dt);
      case STRIAD: return f(std::integral_constant<int, STRIAD>{}, dt);
      case SCHOENAUER: return f(std::integral_constant<int, SCHOENAUER>{}, dt);
      case TRIAD_UPDATE: return f(std::integral_constant<int, TRIAD_UPDATE>{}, dt);
    }
    return cudaErrorInvalidValue;
  };
  if (dtype == F32) return by_op(std::integral_constant<int, F32>{});
  if (dtype == BF16) return by_op(std::integral_constant<int, BF16>{});
  return cudaErrorInvalidValue;
}

// CTAs of reduce_pipeline<RED, DT> one SM holds at once at a launch's shared memory
template <int RED, int DT>
cudaError_t occupancy_reduce(const Args& a, int* ctas_per_sm) {
  const cudaError_t e = allow_smem(reduce_pipeline<RED, DT>, a.smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, reduce_pipeline<RED, DT>,
                                                       THREADS, a.smem);
}

template <int RED, int DT>
cudaError_t launch_reduce(const Args& a) {
  const cudaError_t e = allow_smem(reduce_pipeline<RED, DT>, a.smem);
  if (e != cudaSuccess) return e;
  reduce_pipeline<RED, DT><<<a.ctas, THREADS, a.smem, a.stream>>>(
      a.x, a.y, static_cast<float*>(a.out), a.n_chunks, a.chunk_vectors, a.stages);
  return cudaSuccess;
}

// The shared memory of a launch, as kernels/pipeline.py PipelineConfig.
// smem_bytes counts it: n_in * stages input slots, then (map kernels,
// out_slots > 0) the output slots and one 8-byte mbarrier per input slot;
// at least reserve_smem bytes (the rest unused), which caps the CTAs an SM
// holds (the Eq. 2 sweep reserves enough for one).
Args make_args(int dtype, int n_in, const void* x, const void* y, const void* z, void* out,
               float s, float t, long long n_chunks, int block_rows, int stages, int out_slots,
               int ctas, long long reserve_smem, void* stream) {
  const int cv = static_cast<int>(block_rows * row_vectors(dtype));
  const size_t slot = static_cast<size_t>(cv) * sizeof(uint4);
  const size_t ring = (static_cast<size_t>(n_in) * stages + out_slots) * slot +
                      (out_slots > 0 ? static_cast<size_t>(stages) * sizeof(uint64_t) : 0);
  const size_t smem = ring > static_cast<size_t>(reserve_smem) ? ring
                                                               : static_cast<size_t>(reserve_smem);
  return Args{static_cast<const uint4*>(x),
              static_cast<const uint4*>(y),
              static_cast<const uint4*>(z),
              out, s, t, n_chunks, cv, stages, out_slots, ctas, smem,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// out (rows, 128) = op(s, t, x, y, z), n_chunks chunks of block_rows rows
// through a `stages`-deep input ring and an out_slots-deep (1 or 2) output
// ring on `ctas` persistent CTAs.
extern "C" int rt_map_pipeline(int op, int dtype, const void* x, const void* y, const void* z,
                               void* out, float s, float t, long long n_chunks, int block_rows,
                               int stages, int out_slots, int ctas, long long reserve_smem,
                               void* stream) {
  if (out_slots < 1 || out_slots > 2) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, map_inputs(op), x, y, z, out, s, t, n_chunks, block_rows,
                           stages, out_slots, ctas, reserve_smem, stream);
  return finish(with_map(op, dtype, [&](auto o, auto d) {
    return launch_map<decltype(o)::value, decltype(d)::value>(a);
  }));
}

// CTAs of rt_map_pipeline one SM holds at once for the same op, dtype,
// block, depth, output slots and reserve
extern "C" int rt_map_pipeline_occupancy(int op, int dtype, int block_rows, int stages,
                                         int out_slots, long long reserve_smem, int* ctas_per_sm) {
  if (out_slots < 1 || out_slots > 2) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, map_inputs(op), nullptr, nullptr, nullptr, nullptr, 0.f, 0.f, 0,
                           block_rows, stages, out_slots, 0, reserve_smem, nullptr);
  return finish(with_map(op, dtype, [&](auto o, auto d) {
    return occupancy_map<decltype(o)::value, decltype(d)::value>(a, ctas_per_sm);
  }));
}

// out[0] = sum of x (LOAD) or x*y (DDOT) over n_chunks chunks; partial
// holds `ctas` floats of scratch.
extern "C" int rt_reduce_pipeline(int red, int dtype, const void* x, const void* y,
                                  void* partial, void* out, long long n_chunks, int block_rows,
                                  int stages, int ctas, long long reserve_smem, void* stream) {
  if (red != LOAD && red != DDOT) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, red_inputs(red), x, y, nullptr, partial, 0.f, 0.f, n_chunks,
                           block_rows, stages, 0, ctas, reserve_smem, stream);
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

// CTAs of rt_reduce_pipeline one SM holds at once for the same reduction,
// dtype, block, depth and reserve
extern "C" int rt_reduce_pipeline_occupancy(int red, int dtype, int block_rows, int stages,
                                            long long reserve_smem, int* ctas_per_sm) {
  if (red != LOAD && red != DDOT) return finish(cudaErrorInvalidValue);
  const Args a = make_args(dtype, red_inputs(red), nullptr, nullptr, nullptr, nullptr, 0.f, 0.f, 0,
                           block_rows, stages, 0, 0, reserve_smem, nullptr);
  cudaError_t e = cudaErrorInvalidValue;
  if (red == LOAD && dtype == F32) e = occupancy_reduce<LOAD, F32>(a, ctas_per_sm);
  else if (red == LOAD && dtype == BF16) e = occupancy_reduce<LOAD, BF16>(a, ctas_per_sm);
  else if (red == DDOT && dtype == F32) e = occupancy_reduce<DDOT, F32>(a, ctas_per_sm);
  else if (red == DDOT && dtype == BF16) e = occupancy_reduce<DDOT, BF16>(a, ctas_per_sm);
  return finish(e);
}
