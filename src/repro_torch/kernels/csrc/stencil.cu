// Jacobi stencil kernels: the 2D 5-point and 3D 7-point sweeps on Hopper.
//
// Replaces the Pallas kernels of src/repro/kernels/stencil/kernel.py and
// src/repro/kernels/pipeline.py:
//  * rt_jacobi2d_grid   <- jacobi2d_call (:97), five_point_block (:41): the
//                          whole padded (H+2, W+2) array -> (H, W);
//  * rt_jacobi3d_grid   <- jacobi3d_call (:108), seven_point_block (:61):
//                          (D+2, H+2, W+2) -> (D, H, W);
//  * rt_halo_pipeline   <- halo_pipeline_call (pipeline.py:356),
//                          _halo_pipeline_kernel (:284): chunk c of the
//                          axis-0 rows reads the padded rows [c*b, c*b+b+2)
//                          (overlapping reads) and writes the disjoint output
//                          rows [c*b, (c+1)*b), through a num_stages-deep ring.
//
// Semantics: out = c0*c + c1*s on the interior, with s the neighbour sum
// associated per axis, outermost axis first (2D (N+S)+(W+E), 3D
// ((D+U)+(N+S))+(W+E)); out = c (the input's bits) wherever an index is
// at 0 or the last position of its axis.  Rounding is the reference
// oracle's (src/repro/kernels/stencil/ref.py), pinned with intrinsics and
// never left to -fmad: f32 rounds both products and then adds; bf16 rounds
// to bf16 after every operation, with c0 and c1 already bf16 values.  So
// every path is bit-identical to the plain version and to each other.
//
// Bound: device-memory bytes.  A sweep moves at least 8 B per point in f32
// (the input read once, the output written once) for 6 (2D) or 8 (3D)
// FP32 operations, below 1 FLOP/B where the card needs ~20 before its
// FP32 units are the limit.
//
// Whole-array kernels.  On the TPU the padded array is one VMEM block
// (validation sizes only).  Here one thread computes one output point and
// reads its neighbours straight from device memory; blocks of 32 x 8
// threads sweep rows (2D) or rows of one layer (3D), and L1/L2 serve the
// neighbours' re-reads.  They run at any size.
//
// Halo pipeline.  On the TPU one core walks the chunks with a DMA ring of
// whole (b+2, H+2, W+2) tiles.  At W = 8192 a slot of ten padded rows is
// 320 KiB, and one 3D layer of 514^2 is 1 MiB, both over the 227 KB of
// shared memory a block may use.  So a chunk here is (axis-0 block x tile
// of the trailing dims): a strip of tile_w columns (2D) or a tile_h x
// tile_w patch (3D), each fetched with its own one-point halo.  The
// axis-0 contract (block fit, chunks, depth cap) stays the reference's.
// A persistent grid of min(n_items, SMs) CTAs walks items i, i+G, ...
// (tiles fastest, so neighbouring CTAs share halo rows in L2).  Each CTA
// has a `stages`-deep ring of slots in dynamic shared memory, filled with
// 4-byte cp.async.ca copies (padded rows start at any element, so 16-byte
// copies would need alignment the layout does not give), one commit group
// per item; depth 1 prefetches nothing.  A thread reads neighbours that
// other threads copied, so a barrier follows each wait, and another keeps
// a slot from being refilled while it is still read.  In bf16 a row's
// words start at an even element: a slot row holds the window shifted by
// the parity of its first element, and the array's last element, alone in
// a word, is stored directly.  Offsets into the arrays are 64-bit.
#include "common.cuh"

using namespace rt;

namespace {

constexpr int TX = 32;  // whole-array kernels: 32 x 8 threads a block
constexpr int TY = THREADS / TX;
// Halo pipeline: 1024 threads, the most an SM holds, since one CTA an SM
// runs.  The kernel is bound by each SM's issue rate, not by HBM (one CTA
// alone runs as fast per SM as 132 together); with 256 threads the SM
// waits on shared-memory and arithmetic latency and runs at half speed.
constexpr int HALO_THREADS = 1024;
constexpr int HALO_WARPS = HALO_THREADS / 32;

template <int DT> struct Elem;
template <> struct Elem<F32> { using T = float; };
template <> struct Elem<BF16> { using T = __nv_bfloat16; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int DT>
__device__ __forceinline__ typename Elem<DT>::T from_f(float v) {
  if constexpr (DT == F32) return v;
  else return __float2bfloat16_rn(v);
}

template <int DT>
__device__ __forceinline__ float add(float a, float b) {
  const float r = __fadd_rn(a, b);
  if constexpr (DT == F32) return r;
  else return bf(r);
}

template <int DT>
__device__ __forceinline__ float mul(float a, float b) {
  const float r = __fmul_rn(a, b);
  if constexpr (DT == F32) return r;
  else return bf(r);
}

// c0*c + c1*s on the interior; the pairs are the neighbours along the
// outer (axis 0), middle (3D only) and inner (contiguous) axes.
template <int DIM, int DT>
__device__ __forceinline__ float interior(float c0, float c1, float c, float o_m, float o_p,
                                          float m_m, float m_p, float i_m, float i_p) {
  float s = add<DT>(o_m, o_p);
  if constexpr (DIM == 3) s = add<DT>(s, add<DT>(m_m, m_p));
  s = add<DT>(s, add<DT>(i_m, i_p));
  return add<DT>(mul<DT>(c0, c), mul<DT>(c1, s));
}

// Output (R, W) in 2D (H == 1) or (R, H, W) in 3D, from the padded input.
template <int DIM>
__device__ __forceinline__ bool on_edge(int g, int y, int x, int R, int H, int W) {
  return g == 0 || g == R - 1 || x == 0 || x == W - 1 || (DIM == 3 && (y == 0 || y == H - 1));
}

template <int DIM, int DT>
__global__ void __launch_bounds__(THREADS)
    jacobi_grid(const typename Elem<DT>::T* __restrict__ p, typename Elem<DT>::T* __restrict__ out,
                float c0, float c1, int R, int H, int W) {
  const int x = blockIdx.x * TX + threadIdx.x % TX;
  const int row = blockIdx.y * TY + threadIdx.x / TX;
  const int g = DIM == 3 ? static_cast<int>(blockIdx.z) : row;  // axis-0 index
  const int y = DIM == 3 ? row : 0;
  if (x >= W || g >= R || y >= H) return;
  const long long pw = W + 2LL;
  const long long so = DIM == 3 ? (H + 2LL) * pw : pw;  // axis-0 stride of the padded input
  const long long ci = (g + 1LL) * so + (DIM == 3 ? (y + 1LL) * pw : 0LL) + x + 1;
  const long long oi = (static_cast<long long>(g) * H + y) * W + x;
  if (on_edge<DIM>(g, y, x, R, H, W)) {
    out[oi] = p[ci];
    return;
  }
  const float mm = DIM == 3 ? to_f(p[ci - pw]) : 0.f;
  const float mp = DIM == 3 ? to_f(p[ci + pw]) : 0.f;
  out[oi] = from_f<DT>(interior<DIM, DT>(c0, c1, to_f(p[ci]), to_f(p[ci - so]), to_f(p[ci + so]),
                                          mm, mp, to_f(p[ci - 1]), to_f(p[ci + 1])));
}

// Geometry of one halo-pipeline call; 2D has H == 1 and tile_h == 1.
struct Halo {
  int R, H, W;        // output extent
  int b;              // axis-0 rows per chunk
  int tile_h, tile_w; // trailing-dim tile of the output
  int tiles_x, tiles; // tiles along W; tiles per axis-0 chunk
  int pitch;          // elements per slot row
  int lines;          // slot rows per axis-0 row: tile_h + 2 (3D) or 1 (2D)
  int stages;
  long long n_items;  // axis-0 chunks x tiles
  long long total;    // elements of the padded input
  long long pw, so;   // padded row stride; padded axis-0 stride

  __device__ long long slot_elems() const { return static_cast<long long>(b + 2) * lines * pitch; }
};

// One item: axis-0 chunk c, tile origin (y0, x0), tile extent (th, tw).
struct Item {
  int c, y0, x0, th, tw;
};

template <int DIM>
__device__ __forceinline__ Item decode(const Halo& h, long long i) {
  Item it;
  it.c = static_cast<int>(i / h.tiles);
  const int t = static_cast<int>(i % h.tiles);
  it.y0 = DIM == 3 ? (t / h.tiles_x) * h.tile_h : 0;
  it.x0 = (t % h.tiles_x) * h.tile_w;
  it.th = DIM == 3 ? min(h.tile_h, h.H - it.y0) : 1;
  it.tw = min(h.tile_w, h.W - it.x0);
  return it;
}

// Padded-input index of the first element of slot row (r, yl) of an item:
// axis-0 row c*b + r, padded row y0 + yl (3D), padded column x0.
template <int DIM>
__device__ __forceinline__ long long line_start(const Halo& h, const Item& it, int r, int yl) {
  const long long g = static_cast<long long>(it.c) * h.b + r;
  return g * h.so + (DIM == 3 ? (it.y0 + yl) * h.pw : 0LL) + it.x0;
}

// Start the copies of an item's window into a slot: each warp takes slot
// rows warp, warp + HALO_WARPS, ...; its lanes copy the row's 4-byte words.
template <int DIM, int DT>
__device__ __forceinline__ void fetch(const Halo& h, const typename Elem<DT>::T* p,
                                      typename Elem<DT>::T* slot, long long i) {
  using T = typename Elem<DT>::T;
  constexpr int EPW = 4 / sizeof(T);  // elements per word
  const Item it = decode<DIM>(h, i);
  const int used = DIM == 3 ? it.th + 2 : 1;  // slot rows of this tile per axis-0 row
  const int n_lines = (h.b + 2) * used;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(p);
  for (int l = warp; l < n_lines; l += HALO_WARPS) {
    const int r = l / used, yl = l % used;
    const long long g0 = line_start<DIM>(h, it, r, yl);
    const int shift = static_cast<int>(g0 % EPW);
    const long long w0 = (g0 - shift) / EPW;
    const int n_words = (shift + it.tw + 2 + EPW - 1) / EPW;
    T* dst = slot + (r * h.lines + yl) * h.pitch;
    uint32_t* dstw = reinterpret_cast<uint32_t*>(dst);
    for (int j = lane; j < n_words; j += 32) {
      const long long e = (w0 + j) * EPW;
      if (e + EPW - 1 < h.total) cp_async4(dstw + j, src + w0 + j);
      else dst[j * EPW] = p[e];  // the last element, alone in a word
    }
  }
}

// Compute an item from its slot: each thread takes tile points
// tid, tid + HALO_THREADS, ... and walks them down the chunk's b axis-0
// rows.  Slot offsets are 32-bit (a slot is below 227 KB); in bf16 the
// shift of a slot row is the parity of its first element's index, which
// changes with r and yl only where the strides are odd.
template <int DIM, int DT>
__device__ __forceinline__ void compute(const Halo& h, const typename Elem<DT>::T* slot,
                                        typename Elem<DT>::T* __restrict__ out, float c0, float c1,
                                        long long i) {
  using T = typename Elem<DT>::T;
  constexpr int EPW = 4 / sizeof(T);
  const Item it = decode<DIM>(h, i);
  const int s0 = EPW == 1 ? 0 : static_cast<int>(line_start<DIM>(h, it, 0, 0) & 1);
  const int so1 = static_cast<int>(h.so & 1), pw1 = static_cast<int>(h.pw & 1);
  const int row = h.lines * h.pitch;  // elements per axis-0 row of a slot
  auto raw = [&](int r, int yl, int xl) -> T {
    const int shift = EPW == 1 ? 0 : s0 ^ (r & so1) ^ (yl & pw1);
    return slot[r * row + yl * h.pitch + shift + xl];
  };
  auto at = [&](int r, int yl, int xl) { return to_f(raw(r, yl, xl)); };
  const long long layer = static_cast<long long>(h.H) * h.W;  // output axis-0 stride
  for (int e = threadIdx.x; e < it.th * it.tw; e += HALO_THREADS) {
    const int yy = e / it.tw, xx = e % it.tw;
    const int y = it.y0 + yy, x = it.x0 + xx;
    const int yc = DIM == 3 ? yy + 1 : 0;  // slot row of the centre within an axis-0 row
    const int g0 = it.c * h.b;
    long long oi = (static_cast<long long>(g0) * h.H + y) * h.W + x;
    const bool side = x == 0 || x == h.W - 1 || (DIM == 3 && (y == 0 || y == h.H - 1));
    for (int r = 0; r < h.b; ++r, oi += layer) {
      const int g = g0 + r;
      const T c = raw(r + 1, yc, xx + 1);
      if (side || g == 0 || g == h.R - 1) {
        out[oi] = c;
        continue;
      }
      const float mm = DIM == 3 ? at(r + 1, yc - 1, xx + 1) : 0.f;
      const float mp = DIM == 3 ? at(r + 1, yc + 1, xx + 1) : 0.f;
      out[oi] = from_f<DT>(interior<DIM, DT>(c0, c1, to_f(c), at(r, yc, xx + 1),
                                              at(r + 2, yc, xx + 1), mm, mp, at(r + 1, yc, xx),
                                              at(r + 1, yc, xx + 2)));
    }
  }
}

template <int DIM, int DT>
__global__ void __launch_bounds__(HALO_THREADS, 1)
    halo_pipeline(const typename Elem<DT>::T* __restrict__ p, typename Elem<DT>::T* __restrict__ out,
                  float c0, float c1, Halo h) {
  using T = typename Elem<DT>::T;
  extern __shared__ __align__(16) unsigned char halo_smem[];
  T* ring = reinterpret_cast<T*>(halo_smem);
  const long long mine = (h.n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto item = [&](long long k) { return blockIdx.x + k * gridDim.x; };
  auto slot = [&](long long k) { return ring + (k % h.stages) * h.slot_elems(); };
  for (int k = 0; k < h.stages - 1; ++k) {  // warm-up
    if (k < mine) fetch<DIM, DT>(h, p, slot(k), item(k));
    cp_async_commit();
  }
  for (long long k = 0; k < mine; ++k) {
    __syncthreads();  // every thread is done with item k-1, whose slot is refilled next
    if (k + h.stages - 1 < mine) fetch<DIM, DT>(h, p, slot(k + h.stages - 1), item(k + h.stages - 1));
    cp_async_commit();
    cp_async_wait(h.stages - 1);
    __syncthreads();  // item k is in its slot, whoever copied it
    compute<DIM, DT>(h, slot(k), out, c0, c1, item(k));
  }
}

template <int DIM, int DT>
cudaError_t launch_grid(const void* p, void* out, float c0, float c1, int R, int H, int W,
                        cudaStream_t st) {
  using T = typename Elem<DT>::T;
  const dim3 grid((W + TX - 1) / TX, ((DIM == 3 ? H : R) + TY - 1) / TY, DIM == 3 ? R : 1);
  jacobi_grid<DIM, DT><<<grid, THREADS, 0, st>>>(static_cast<const T*>(p), static_cast<T*>(out),
                                                 c0, c1, R, H, W);
  return cudaSuccess;
}

template <int DIM>
int grid_entry(int dtype, const void* p, void* out, float c0, float c1, int R, int H, int W,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == F32) e = launch_grid<DIM, F32>(p, out, c0, c1, R, H, W, st);
  else if (dtype == BF16) e = launch_grid<DIM, BF16>(p, out, c0, c1, R, H, W, st);
  return finish(e);
}

template <int DIM, int DT>
cudaError_t launch_halo(const void* p, void* out, float c0, float c1, const Halo& h, int ctas,
                        size_t smem, cudaStream_t st) {
  using T = typename Elem<DT>::T;
  const cudaError_t e = cudaFuncSetAttribute(
      halo_pipeline<DIM, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  halo_pipeline<DIM, DT><<<ctas, HALO_THREADS, smem, st>>>(static_cast<const T*>(p),
                                                      static_cast<T*>(out), c0, c1, h);
  return cudaSuccess;
}

}  // namespace

// out (H, W) = the 5-point sweep of the padded (H+2, W+2) input p.
extern "C" int rt_jacobi2d_grid(int dtype, const void* p, void* out, float c0, float c1, int H,
                                int W, void* stream) {
  return grid_entry<2>(dtype, p, out, c0, c1, H, 1, W, stream);
}

// out (D, H, W) = the 7-point sweep of the padded (D+2, H+2, W+2) input p.
extern "C" int rt_jacobi3d_grid(int dtype, const void* p, void* out, float c0, float c1, int D,
                                int H, int W, void* stream) {
  return grid_entry<3>(dtype, p, out, c0, c1, D, H, W, stream);
}

// The sweep of dimension `dim` (2: H == 1, tile_h == 1) through the halo
// pipeline, with the geometry the wrapper planned (pipeline.py halo_plan):
// chunks of `block` axis-0 rows x tiles of tile_h x tile_w (tiles_x along
// W, `tiles` per chunk, n_items in all), a `stages`-deep ring of slots of
// (block + 2) x lines x pitch elements in `smem` bytes, `ctas` persistent
// CTAs.
extern "C" int rt_halo_pipeline(int dim, int dtype, const void* p, void* out, float c0, float c1,
                                int R, int H, int W, int block, int stages, int tile_h,
                                int tile_w, int tiles_x, int tiles, int pitch, int lines,
                                long long n_items, int ctas, long long smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dim != 2 && dim != 3) || (dim == 2 && (H != 1 || tile_h != 1)) || block < 1 ||
      stages < 1 || R % block != 0)
    return finish(cudaErrorInvalidValue);
  Halo h;
  h.R = R;
  h.H = H;
  h.W = W;
  h.b = block;
  h.tile_h = tile_h;
  h.tile_w = tile_w;
  h.tiles_x = tiles_x;
  h.tiles = tiles;
  h.pitch = pitch;
  h.lines = lines;
  h.stages = stages;
  h.n_items = n_items;
  h.pw = W + 2LL;
  h.so = dim == 3 ? (H + 2LL) * h.pw : h.pw;
  h.total = (R + 2LL) * h.so;
  cudaError_t e = cudaErrorInvalidValue;
  if (dim == 2 && dtype == F32) e = launch_halo<2, F32>(p, out, c0, c1, h, ctas, smem, st);
  else if (dim == 2 && dtype == BF16) e = launch_halo<2, BF16>(p, out, c0, c1, h, ctas, smem, st);
  else if (dim == 3 && dtype == F32) e = launch_halo<3, F32>(p, out, c0, c1, h, ctas, smem, st);
  else if (dim == 3 && dtype == BF16) e = launch_halo<3, BF16>(p, out, c0, c1, h, ctas, smem, st);
  return finish(e);
}
