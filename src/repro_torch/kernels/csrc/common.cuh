// Shared device code of the kernels (stream.cu, pipeline.cu, stencil.cu,
// matmul.cu, attention.cu).
//
// Arrays are the reference's (rows, 128) stream layout, row-major and
// contiguous; a 128-lane row is 512 B in f32 and 256 B in bf16, so every
// block of whole rows is a whole number of 16-byte vectors and no kernel
// needs a ragged edge.  Threads move 16 B at a time (uint4).
//
// Rounding is pinned with intrinsics and never left to nvcc's -fmad
// contraction, so every kernel computes the reference's per-element
// arithmetic bit for bit:
//  * f32: striad and schoenauer round once, as a fused multiply-add
//    (the reference's f32 result is fma(s, c, b) / fma(c, d, b));
//  * bf16: the operands are widened to float and the result is rounded
//    back to bf16 after every operation, with the scalar already in bf16.
// Sums accumulate in f32 in a fixed order: the order of a thread's own
// elements, then a fixed shuffle tree (block_sum), then the partials in
// index order (sum_partials).  No atomics, so results repeat bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// op codes; kernels/pipeline.py MAP_OPS and REDUCE_OPS hold the same numbers
enum Op { COPY = 0, STORE = 1, UPDATE = 2, STRIAD = 3, SCHOENAUER = 4, TRIAD_UPDATE = 5 };
enum Red { LOAD = 0, DDOT = 1 };
enum Dtype { F32 = 0, BF16 = 1 };
// host-side failures beyond cudaError_t's range (hopper.cuh; rt_error_string)
enum HostError { ERR_DRIVER_ENTRY = 100000, ERR_TMA_ENCODE = 100001 };

constexpr int THREADS = 256;
constexpr int LANES = 128;
constexpr int WARPS = THREADS / 32;

__host__ __device__ constexpr int map_inputs(int op) {
  return op == STORE ? 0 : op == SCHOENAUER ? 3 : (op == STRIAD || op == TRIAD_UPDATE) ? 2 : 1;
}

__host__ __device__ constexpr int red_inputs(int red) { return red == DDOT ? 2 : 1; }

__host__ constexpr int elem_bytes(int dtype) { return dtype == BF16 ? 2 : 4; }

// 16-byte vectors in `rows` rows of 128 lanes
__host__ constexpr long long row_vectors(int dtype) { return LANES * elem_bytes(dtype) / 16; }

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int OP>
__device__ __forceinline__ float op_f32(float s, float t, float x, float y, float z) {
  if constexpr (OP == STORE) return s;
  else if constexpr (OP == UPDATE) return __fmul_rn(s, x);
  else if constexpr (OP == STRIAD) return __fmaf_rn(s, y, x);
  else if constexpr (OP == SCHOENAUER) return __fmaf_rn(y, z, x);
  else return __fmul_rn(t, __fmaf_rn(s, y, x));  // TRIAD_UPDATE: update(t, striad(s, b, c))
}

template <int OP>
__device__ __forceinline__ float op_bf16(float s, float t, float x, float y, float z) {
  if constexpr (OP == STORE) return s;
  else if constexpr (OP == UPDATE) return bf(__fmul_rn(s, x));
  else if constexpr (OP == STRIAD) return bf(__fadd_rn(x, bf(__fmul_rn(s, y))));
  else if constexpr (OP == SCHOENAUER) return bf(__fadd_rn(x, bf(__fmul_rn(y, z))));
  else return bf(__fmul_rn(t, bf(__fadd_rn(x, bf(__fmul_rn(s, y))))));
}

// One 16-byte vector of the elementwise op.  x, y, z are the op's inputs
// in the reference's argument order (b, c, d); unused ones are ignored.
template <int OP, int DT>
__device__ __forceinline__ uint4 apply(float s, float t, uint4 x, uint4 y, uint4 z) {
  if constexpr (OP == COPY) {
    return x;  // bits as they are, NaN payloads included
  } else if constexpr (DT == F32) {
    const float* xa = reinterpret_cast<const float*>(&x);
    const float* ya = reinterpret_cast<const float*>(&y);
    const float* za = reinterpret_cast<const float*>(&z);
    uint4 r;
    float* ra = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) ra[i] = op_f32<OP>(s, t, xa[i], ya[i], za[i]);
    return r;
  } else {
    const __nv_bfloat16* xa = reinterpret_cast<const __nv_bfloat16*>(&x);
    const __nv_bfloat16* ya = reinterpret_cast<const __nv_bfloat16*>(&y);
    const __nv_bfloat16* za = reinterpret_cast<const __nv_bfloat16*>(&z);
    uint4 r;
    __nv_bfloat16* ra = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      ra[i] = __float2bfloat16_rn(op_bf16<OP>(s, t, __bfloat162float(xa[i]),
                                              __bfloat162float(ya[i]),
                                              __bfloat162float(za[i])));
    return r;
  }
}

// acc + the vector's terms, in element order: A[i] (LOAD) or A[i]*B[i]
// (DDOT; in bf16 the product is rounded to bf16 first, as the reference's
// `(a * b).astype(f32)` does).
template <int RED, int DT>
__device__ __forceinline__ float accumulate(float acc, uint4 x, uint4 y) {
  if constexpr (DT == F32) {
    const float* xa = reinterpret_cast<const float*>(&x);
    const float* ya = reinterpret_cast<const float*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc = __fadd_rn(acc, RED == LOAD ? xa[i] : __fmul_rn(xa[i], ya[i]));
  } else {
    const __nv_bfloat16* xa = reinterpret_cast<const __nv_bfloat16*>(&x);
    const __nv_bfloat16* ya = reinterpret_cast<const __nv_bfloat16*>(&y);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = __bfloat162float(xa[i]);
      acc = __fadd_rn(acc, RED == LOAD ? a : bf(__fmul_rn(a, __bfloat162float(ya[i]))));
    }
  }
  return acc;
}

// Sum of v over the block in a fixed tree: a butterfly inside each warp
// (both partners of a pair add the same two values, so every lane ends
// with the same sum), then the warp sums in warp order.  The result is
// valid in warp 0.  Every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) {
    r = lane < WARPS ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r = __fadd_rn(r, __shfl_xor_sync(0xffffffffu, r, o));
  }
  __syncthreads();  // warp_sums is reused by the next call
  return r;
}

// out[0] = sum of part[0..n): thread i takes i, i+THREADS, ... in index
// order, then block_sum.  One block.
__global__ void __launch_bounds__(THREADS) sum_partials(const float* __restrict__ part,
                                                        long long n, float* __restrict__ out) {
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n; i += THREADS) acc = __fadd_rn(acc, part[i]);
  const float r = block_sum(acc);
  if (threadIdx.x == 0) out[0] = r;
}

// cp.async: copies from device memory into shared memory that complete
// asynchronously, in commit groups.  16 bytes (cg: bypass L1) for the
// stream rings and matmul's B panels; 4 bytes (ca) for the stencil rings,
// whose rows start at any 4-byte boundary, and matmul's A panels, which
// they transpose.  `dst` is an address in the shared window.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  cp_async16(static_cast<unsigned>(__cvta_generic_to_shared(smem)), gmem);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  cp_async4(static_cast<unsigned>(__cvta_generic_to_shared(smem)), gmem);
}

// 16 bytes, or 16 zero bytes where !valid (a source size of 0 reads
// nothing; gmem must still be an address in the tensor)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_all;\n" ::: "memory"); break;  // deeper rings: correct, less overlap
  }
}

// N consecutive elements of `dtype` at element offset i of p, widened to
// float (exact for bf16).  One vector load: N f32 as N/4 float4s (float2
// for N = 2), N bf16 in 2N bytes; i must keep that vector aligned.
template <int N>
__device__ __forceinline__ void load_vec(const void* p, long long i, int dtype, float* out) {
  if (dtype == F32) {
    const float* f = static_cast<const float*>(p) + i;
    if constexpr (N == 2) {
      const float2 x = *reinterpret_cast<const float2*>(f);
      out[0] = x.x;
      out[1] = x.y;
    } else {
      static_assert(N % 4 == 0, "f32 vectors of 2 or 4k elements");
#pragma unroll
      for (int u = 0; u < N / 4; ++u) {
        const float4 x = reinterpret_cast<const float4*>(f)[u];
        out[4 * u] = x.x;
        out[4 * u + 1] = x.y;
        out[4 * u + 2] = x.z;
        out[4 * u + 3] = x.w;
      }
    }
  } else {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p) + i;
    alignas(16) __nv_bfloat16 h[N];
    if constexpr (N == 8) *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(b);
    else if constexpr (N == 4) *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(b);
    else *reinterpret_cast<unsigned*>(h) = *reinterpret_cast<const unsigned*>(b);
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = __bfloat162float(h[u]);
  }
}

__device__ __forceinline__ float load1(const void* p, long long i, int dtype) {
  return dtype == F32 ? static_cast<const float*>(p)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// four floats to elements i..i+3 of p in `dtype` (bf16 rounded to nearest
// even), one 16- or 8-byte store
__device__ __forceinline__ void store4(void* p, long long i, int dtype, const float* v) {
  if (dtype == F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    alignas(8) __nv_bfloat16 h[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) h[u] = __float2bfloat16_rn(v[u]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = *reinterpret_cast<const uint2*>(h);
  }
}

// two floats to elements i, i+1 of p in `dtype` (bf16 rounded to nearest
// even), one 8- or 4-byte store
__device__ __forceinline__ void store2(void* p, long long i, int dtype, float x, float y) {
  if (dtype == F32) *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(x, y);
  else *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store1(void* p, long long i, int dtype, float v) {
  if (dtype == F32) static_cast<float*>(p)[i] = v;
  else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// the error of the first failing call, else of the launches since
inline cudaError_t finish(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace rt

extern "C" const char* rt_error_string(int e) {
  if (e == rt::ERR_DRIVER_ENTRY) return "the driver's cuTensorMapEncodeTiled was not found";
  if (e == rt::ERR_TMA_ENCODE) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
