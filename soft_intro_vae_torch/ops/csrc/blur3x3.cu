// The style nets' fixed 3x3 blur, [1,2,1] x [1,2,1] / 16 with zero padding,
// for Hopper (sm_90a), forward and backward in one kernel.
//
// Replaces no TPU kernel: the JAX package's blur3x3
// (soft_intro_vae_tpu/models/style.py:55) is an XLA grouped convolution with no
// Pallas counterpart. The port had run it as PyTorch's depthwise convolution
// (F.conv2d with groups = C), whose ATen kernels (conv_depthwise2d_forward and
// _backward) moved the blur's bytes at about a tenth of the card's memory rate
// and made it the largest cost of the LOD-6 style step. So it has a kernel of
// its own.
//
// What it computes, per (b, c) plane of an NCHW tensor x (float32 or bf16):
//   y[r][c] = sum over kh, kw in 0..2 of w[kh][kw] * x[r + kh - 1][c + kw - 1],
//   w = [1,2,1]^T [1,2,1] / 16, x outside the plane = 0,
// with a float32 sum of the nine terms in ATen's order, each term an FMA
// (every w is a power of two, so each product is exact), rounded once to x's
// type: bit for bit what conv_depthwise2d_forward gives. The filter is
// symmetric and the padding zero, so the input gradient of the blur is the
// blur of the output gradient, exactly: the backward is this kernel on dy.
// ATen's backward walks the nine terms in the reverse order (kh = 0 reads row
// r + 1, kw = 0 column c + 1); `flip` sums them in that order, so dx is bit for
// bit conv_depthwise2d_backward's too.
//
// What bounds it: bytes. Nine FMAs an element against one element read and one
// written (4 bytes in bf16): far below the card's balance of operations to
// bytes. The least traffic is each input read once and each output written
// once. At the LOD-6 style step's b32 sites that is 25.70 GB a step, 7.67 ms at
// 3.35 TB/s; the two largest planes (32, 64, 256, 256) and (32, 128, 128, 128)
// hold 75% of it.
//
// The design: a CTA stages a contiguous run of x in shared memory, then writes
// y from the staged copy.
//   * Staging. A plane larger than the plan's tile is cut into K strips of R
//     rows, one CTA a strip; the CTA stages its R rows and the row above and
//     below them (the halo: (R + 2) / R of the strip's bytes, the halo rows
//     mostly L2 hits, since the neighbouring strips run beside it). Smaller
//     planes go P to a CTA, whole. Either way the staged rows are one
//     contiguous run of x, which every thread copies in 16-byte pieces with
//     cp.async (nothing held in registers, the CTA's every byte in flight at
//     once), or element by element where the run is not 16-byte aligned.
//   * Compute. W / V threads cover a row, V elements each (16 bytes: 8 bf16 or
//     4 f32, fewer where W is not a multiple); the CTA's other threads are
//     further "walkers", each taking a run of consecutive output rows of one
//     plane. A walker keeps three rows of its V + 2 columns in registers in
//     float32 and rolls down its run: a row is one 16-byte shared-memory read
//     and two scalar reads for the columns beside it, nine FMAs an output,
//     one 16-byte store to y.
// The launch plan (ops/blur_cuda.py ``plan``: V, R, K, P, threads, walkers,
// runs a plane, rows a run, shared bytes, grid) comes from the shape alone, in
// plain Python that the CPU tests hold to covering every element once; this
// file checks it and refuses one that does not fit. Indices into x and y are
// 64-bit.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory one CTA may use on sm_90
constexpr int kDefaultSmem = 48 * 1024;

// the filter's three distinct taps: corner, edge, centre
constexpr float kCorner = 0.0625f, kEdge = 0.125f, kCentre = 0.25f;

struct Geom {
  long long planes;  // B * C
  int h, w;
  int vec;           // V: elements a thread takes in a row
  int rows;          // R: output rows of a plane a CTA takes (h where planes_per_cta > 1)
  int strips;        // K: CTAs a plane
  int planes_per_cta;  // P
  int walkers;       // threads / (w / vec)
  int runs;          // runs a plane: walkers that share one plane's rows
  int run_rows;      // rows a run
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The staged row `row` (its first element) into dst[1..V], the columns beside
// it into dst[0] and dst[V + 1] (0 beyond the plane's edges).
template <typename T, int V>
__device__ __forceinline__ void load_row(float (&dst)[V + 2], const T* row, int col, int w) {
  const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(row + col);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i + 1] = to_float(v.v[i]);
  dst[0] = col > 0 ? to_float(row[col - 1]) : 0.f;
  dst[V + 1] = col + V < w ? to_float(row[col + V]) : 0.f;
}

template <int V>
__device__ __forceinline__ void zero_row(float (&dst)[V + 2]) {
#pragma unroll
  for (int i = 0; i < V + 2; ++i) dst[i] = 0.f;
}

// One output row from the rows above (a), at (b) and below (c), the nine
// terms in ATen's order: forward kh = 0..2 over a, b, c and kw = 0..2 left to
// right; kFlip the reverse (c, b, a, right to left), as ATen's backward.
template <typename T, int V, bool kFlip>
__device__ __forceinline__ void stencil_row(const float (&a)[V + 2], const float (&b)[V + 2],
                                            const float (&c)[V + 2], T* out) {
  Vec<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float s = 0.f;
    if (!kFlip) {
      s = fmaf(kCorner, a[i], s);
      s = fmaf(kEdge, a[i + 1], s);
      s = fmaf(kCorner, a[i + 2], s);
      s = fmaf(kEdge, b[i], s);
      s = fmaf(kCentre, b[i + 1], s);
      s = fmaf(kEdge, b[i + 2], s);
      s = fmaf(kCorner, c[i], s);
      s = fmaf(kEdge, c[i + 1], s);
      s = fmaf(kCorner, c[i + 2], s);
    } else {
      s = fmaf(kCorner, c[i + 2], s);
      s = fmaf(kEdge, c[i + 1], s);
      s = fmaf(kCorner, c[i], s);
      s = fmaf(kEdge, b[i + 2], s);
      s = fmaf(kCentre, b[i + 1], s);
      s = fmaf(kEdge, b[i], s);
      s = fmaf(kCorner, a[i + 2], s);
      s = fmaf(kEdge, a[i + 1], s);
      s = fmaf(kCorner, a[i], s);
    }
    o.v[i] = from_float<T>(s);
  }
  *reinterpret_cast<Vec<T, V>*>(out) = o;
}

// Output row r of a run: loads row r + 1 into `c` (zeros past the plane's last
// row), then writes row r from (a, b, c).
template <typename T, int V, bool kFlip>
__device__ __forceinline__ void step_row(float (&a)[V + 2], float (&b)[V + 2], float (&c)[V + 2],
                                         const T* tile, long long base, T* out, int r, int col,
                                         int h, int w) {
  if (r + 1 < h) {
    load_row<T, V>(c, tile + (base + r + 1) * w, col, w);
  } else {
    zero_row<V>(c);
  }
  stencil_row<T, V, kFlip>(a, b, c, out + (long long)r * w + col);
}

template <typename T, int V, bool kFlip>
__global__ void __launch_bounds__(kMaxThreads)
    blur3x3_stencil(const T* __restrict__ x, T* __restrict__ y, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const long long group = blockIdx.x / g.strips;
  const int strip = blockIdx.x % g.strips;
  const long long p0 = group * g.planes_per_cta;
  const int np = (int)min((long long)g.planes_per_cta, g.planes - p0);
  const int r0 = strip * g.rows;
  const int r1 = min(r0 + g.rows, g.h);
  const int rs = max(r0 - 1, 0);       // first staged row
  const int re = min(r1 + 1, g.h);     // past the last staged row
  const T* src = x + (p0 * g.h + rs) * (long long)g.w;
  const int count = ((np - 1) * g.h + (re - rs)) * g.w;  // one contiguous run

  const int bytes = count * (int)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const char* from = reinterpret_cast<const char*>(src);
    for (int i = threadIdx.x; i < (bytes >> 4); i += blockDim.x) {
      copy16_async(smem + 16 * i, from + 16 * i);
    }
    wait_async_copies();
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
  }
  __syncthreads();

  const int across = g.w / V;  // threads a row
  const int col = (threadIdx.x % across) * V;
  const int walker = threadIdx.x / across;
  for (int run = walker; run < np * g.runs; run += g.walkers) {
    const int pl = run / g.runs;
    const int a = r0 + (run % g.runs) * g.run_rows;
    const int b = min(a + g.run_rows, r1);
    if (a >= b) continue;
    // row r of the plane is staged row base + r (rows rs..re-1 of plane 0 in
    // a strip; rows 0..h-1 of each plane where rs = 0)
    const long long base = (long long)pl * g.h - rs;
    T* out = y + (p0 + pl) * g.h * (long long)g.w;
    float up[V + 2], mid[V + 2], down[V + 2];
    if (a > 0) {
      load_row<T, V>(up, tile + (base + a - 1) * g.w, col, g.w);
    } else {
      zero_row<V>(up);
    }
    load_row<T, V>(mid, tile + (base + a) * g.w, col, g.w);
    // three rows a turn, the roles rotating, so that no row is moved
    for (int r = a; r < b; r += 3) {
      step_row<T, V, kFlip>(up, mid, down, tile, base, out, r, col, g.h, g.w);
      if (r + 1 >= b) break;
      step_row<T, V, kFlip>(mid, down, up, tile, base, out, r + 1, col, g.h, g.w);
      if (r + 2 >= b) break;
      step_row<T, V, kFlip>(down, up, mid, tile, base, out, r + 2, col, g.h, g.w);
    }
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The plan's invariants (ops/blur_cuda.py ``plan``); true if it does not fit.
bool bad_plan(const Geom& g, int elem, int threads, int smem, int grid) {
  if (g.planes <= 0 || g.h <= 0 || g.w <= 0) return true;
  if (g.vec <= 0 || g.vec * elem > 16 || (g.vec & (g.vec - 1)) != 0 || g.w % g.vec != 0)
    return true;
  const int across = g.w / g.vec;
  if (g.walkers <= 0 || threads != across * g.walkers || threads > kMaxThreads) return true;
  if (g.rows <= 0 || g.strips <= 0 || (long long)g.rows * g.strips < g.h ||
      (long long)g.rows * (g.strips - 1) >= g.h)
    return true;
  if (g.planes_per_cta <= 0 || (g.planes_per_cta > 1 && g.rows != g.h)) return true;
  if (g.runs <= 0 || g.run_rows <= 0 || (long long)g.runs * g.run_rows < g.rows) return true;
  const long long staged = g.planes_per_cta > 1 ? (long long)g.planes_per_cta * g.h
                                                : (long long)std::min(g.rows + 2, g.h);
  if (smem < staged * g.w * elem || smem > kMaxSmem) return true;
  return (long long)grid != (long long)ceil_div(g.planes, g.planes_per_cta) * g.strips;
}

template <typename T, int V>
int launch(const void* x, void* y, const Geom& g, bool flip, int threads, int smem, int grid,
           cudaStream_t stream) {
  auto kernel = flip ? blur3x3_stencil<T, V, true> : blur3x3_stencil<T, V, false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (planes, h, w) contiguous, of dtype (0 f32, 1 bf16), not overlapping;
// y 16-byte aligned. flip: the backward's order of the nine terms. vec..grid:
// the launch plan of ops/blur_cuda.py ``plan``, checked here. Launches on
// `stream` and returns the launch's cudaError_t (0 on success) without
// synchronising.
int blur3x3(const void* x, void* y, long long planes, int h, int w, int dtype, int flip, int vec,
            int rows, int strips, int planes_per_cta, int walkers, int runs, int run_rows,
            int threads, int smem, int grid, cudaStream_t stream) {
  const Geom g{planes, h, w, vec, rows, strips, planes_per_cta, walkers, runs, run_rows};
  const int elem = dtype == 0 ? 4 : 2;
  if (x == nullptr || y == nullptr || dtype < 0 || dtype > 1 ||
      (reinterpret_cast<uintptr_t>(y) & 15) != 0 || bad_plan(g, elem, threads, smem, grid))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec) {
      case 4: return launch<float, 4>(x, y, g, flip != 0, threads, smem, grid, stream);
      case 2: return launch<float, 2>(x, y, g, flip != 0, threads, smem, grid, stream);
      default: return launch<float, 1>(x, y, g, flip != 0, threads, smem, grid, stream);
    }
  }
  switch (vec) {
    case 8: return launch<__nv_bfloat16, 8>(x, y, g, flip != 0, threads, smem, grid, stream);
    case 4: return launch<__nv_bfloat16, 4>(x, y, g, flip != 0, threads, smem, grid, stream);
    case 2: return launch<__nv_bfloat16, 2>(x, y, g, flip != 0, threads, smem, grid, stream);
    default: return launch<__nv_bfloat16, 1>(x, y, g, flip != 0, threads, smem, grid, stream);
  }
}

const char* blur3x3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
