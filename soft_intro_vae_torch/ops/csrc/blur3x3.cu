// The style nets' fixed 3x3 blur, [1,2,1] x [1,2,1] / 16 with zero padding,
// for Hopper (sm_90a), forward and backward in one kernel, on channels-last
// tensors.
//
// Replaces no TPU kernel: the JAX package's blur3x3
// (soft_intro_vae_tpu/models/style.py:55) is an XLA grouped convolution with no
// Pallas counterpart. The port had run it as PyTorch's depthwise convolution
// (F.conv2d with groups = C), whose ATen kernels (conv_depthwise2d_forward and
// _backward) moved the blur's bytes at about a tenth of the card's memory rate
// and made it the largest cost of the LOD-6 style step. So it has a kernel of
// its own.
//
// What it computes, per channel of a channels-last (B, C, H, W) tensor x,
// (B, H, W, C) in memory (float32 or bf16):
//   y[r][c] = sum over kh, kw in 0..2 of w[kh][kw] * x[r + kh - 1][c + kw - 1],
//   w = [1,2,1]^T [1,2,1] / 16, x outside the image = 0,
// with a float32 sum of the nine terms in ATen's order, each term an FMA
// (every w is a power of two, so each product is exact), rounded once to x's
// type: bit for bit what conv_depthwise2d_forward gives on an NCHW copy of x.
// The filter is symmetric and the padding zero, so the input gradient of the
// blur is the blur of the output gradient, exactly: the backward is this
// kernel on dy. ATen's backward walks the nine terms in the reverse order (kh
// = 0 reads row r + 1, kw = 0 column c + 1); `flip` sums them in that order, so
// dx is bit for bit conv_depthwise2d_backward's too.
//
// What bounds it: bytes. Nine FMAs an element against one element read and one
// written (4 bytes in bf16): far below the card's balance of operations to
// bytes. The least traffic is each input read once and each output written
// once. At the LOD-6 style step's b32 sites that is 25.70 GB a step, 7.67 ms at
// 3.35 TB/s; the two largest sites (32, 64, 256, 256) and (32, 128, 128, 128)
// hold 75% of it.
//
// The design. A CTA takes L consecutive pixels of a band of R rows of one
// image, all C channels, and walks down the band. It stages the rows, each
// with the pixels left and right of its L (the halo, clipped at the image's
// edges), through a ring of kRing rows in shared memory: in NHWC a staged row
// is one contiguous run of (L + 2) * C elements, which the threads copy in
// 16-byte pieces with cp.async, kRing - 3 rows ahead of the row they sum, so
// that loads stay in flight while they compute (element by element where a
// pixel's channels are not whole 16-byte pieces). A thread takes a unit of V
// channels of one pixel (16 bytes: 8 bf16 or 4 f32, fewer where C is not a
// multiple) and keeps three rows of its unit, at its pixel and the two beside
// it, in registers as they were loaded: a row is three shared-memory reads,
// nine FMAs a channel and one 16-byte store to y, and a warp's reads and
// stores are whole runs of neighbouring pixels. The rows above and below a
// band (2 / R of its rows) and the halo pixels are mostly L2 hits, so each
// input byte leaves device memory about once. The launch plan
// (ops/blur_cuda.py ``plan``: V, L, R, threads, shared bytes, grid) comes
// from the shape alone, in plain Python that the CPU tests hold to covering
// every element once; this file checks it and refuses one that does not
// fit. Indices into x and y are 64-bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // dynamic shared memory one CTA may use on sm_90
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kRing = 6;          // staged rows: three ahead of the three a row's sums read

// the filter's three distinct taps: corner, edge, centre
constexpr float kCorner = 0.0625f, kEdge = 0.125f, kCentre = 0.25f;

struct Geom {
  int images, h, w, c;
  int vec;      // V: channels a thread takes
  int cols;     // L: pixels of a row a CTA takes
  int rows;     // R: rows a CTA takes
  int col_blocks, row_blocks;
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

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zero_vec() {
  Vec<T, V> z;
#pragma unroll
  for (int i = 0; i < V; ++i) z.v[i] = from_float<T>(0.f);
  return z;
}

// The staged row at the thread's pixel (`row`, null where the row is outside
// the image) into dst as loaded: left of the pixel, at it, right of it, zeros
// beyond the image.
template <typename T, int V>
__device__ __forceinline__ void load_row(Vec<T, V> (&dst)[3], const T* row, bool left, bool right,
                                         int c) {
  if (row == nullptr) {
    dst[0] = dst[1] = dst[2] = zero_vec<T, V>();
    return;
  }
  dst[1] = *reinterpret_cast<const Vec<T, V>*>(row);
  dst[0] = left ? *reinterpret_cast<const Vec<T, V>*>(row - c) : zero_vec<T, V>();
  dst[2] = right ? *reinterpret_cast<const Vec<T, V>*>(row + c) : zero_vec<T, V>();
}

// One output unit from the rows above (a), at (b) and below (c), the nine
// terms in ATen's order: forward kh = 0..2 over a, b, c and kw = 0..2 left to
// right; kFlip the reverse (c, b, a, right to left), as ATen's backward.
template <typename T, int V, bool kFlip>
__device__ __forceinline__ void stencil(const Vec<T, V> (&a)[3], const Vec<T, V> (&b)[3],
                                        const Vec<T, V> (&c)[3], T* out) {
  Vec<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float s = 0.f;
    if (!kFlip) {
      s = fmaf(kCorner, to_float(a[0].v[i]), s);
      s = fmaf(kEdge, to_float(a[1].v[i]), s);
      s = fmaf(kCorner, to_float(a[2].v[i]), s);
      s = fmaf(kEdge, to_float(b[0].v[i]), s);
      s = fmaf(kCentre, to_float(b[1].v[i]), s);
      s = fmaf(kEdge, to_float(b[2].v[i]), s);
      s = fmaf(kCorner, to_float(c[0].v[i]), s);
      s = fmaf(kEdge, to_float(c[1].v[i]), s);
      s = fmaf(kCorner, to_float(c[2].v[i]), s);
    } else {
      s = fmaf(kCorner, to_float(c[2].v[i]), s);
      s = fmaf(kEdge, to_float(c[1].v[i]), s);
      s = fmaf(kCorner, to_float(c[0].v[i]), s);
      s = fmaf(kEdge, to_float(b[2].v[i]), s);
      s = fmaf(kCentre, to_float(b[1].v[i]), s);
      s = fmaf(kEdge, to_float(b[0].v[i]), s);
      s = fmaf(kCorner, to_float(a[2].v[i]), s);
      s = fmaf(kEdge, to_float(a[1].v[i]), s);
      s = fmaf(kCorner, to_float(a[0].v[i]), s);
    }
    o.v[i] = from_float<T>(s);
  }
  *reinterpret_cast<Vec<T, V>*>(out) = o;
}

// Starts staging row r of the image (pixels cs..ce-1, every channel) into
// ring slot `slot`, and commits it as one cp.async group in every thread (an
// empty group for a row outside 0..rmax), so the groups count rows.
template <typename T>
__device__ __forceinline__ void stage_row(T* slot, const T* img, int r, int rmax, int cs, int ce,
                                          const Geom& g, bool vector) {
  if (r >= 0 && r <= rmax) {
    const T* src = img + ((int64_t)r * g.w + cs) * g.c;
    const int run = (ce - cs) * g.c;
    if (vector) {
      for (int i = threadIdx.x; i < run * (int)sizeof(T) / 16; i += blockDim.x)
        copy16_async(reinterpret_cast<char*>(slot) + 16 * i,
                     reinterpret_cast<const char*>(src) + 16 * i);
    } else {
      for (int i = threadIdx.x; i < run; i += blockDim.x) slot[i] = src[i];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int V, bool kFlip>
__global__ void __launch_bounds__(kMaxThreads)
    blur3x3_stencil(const T* __restrict__ x, T* __restrict__ y, const Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int col_block = blockIdx.x % g.col_blocks;
  const int rest = blockIdx.x / g.col_blocks;
  const int row_block = rest % g.row_blocks;
  const int image = rest / g.row_blocks;
  const int r0 = row_block * g.rows, r1 = min(r0 + g.rows, g.h);
  const int q0 = col_block * g.cols, q1 = min(q0 + g.cols, g.w);
  const int cs = max(q0 - 1, 0), ce = min(q1 + 1, g.w);  // staged pixels
  const int rmax = min(r1, g.h - 1);                      // the last row the band reads
  const int pitch = (g.cols + 2) * g.c;                   // elements a ring slot
  const T* img = x + (int64_t)image * g.h * g.w * g.c;
  // whole 16-byte pieces where a pixel's channels are (then every staged row,
  // its slot and its source are 16-byte aligned)
  const bool vector = (g.c * (int)sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // ring row j holds image row r0 - 1 + j, in slot j % kRing
  for (int j = 0; j < kRing - 1; ++j)
    stage_row<T>(ring + (j % kRing) * pitch, img, r0 - 1 + j, rmax, cs, ce, g, vector);

  const int units = g.c / V;
  const int q = q0 + threadIdx.x / units;
  const bool active = q < q1;
  const int ch = (threadIdx.x - (threadIdx.x / units) * units) * V;
  const bool left = q > 0, right = q + 1 < g.w;
  const int at = (q - cs) * g.c + ch;  // the thread's pixel and unit in a slot
  auto row = [&](int j) -> const T* {
    const int r = r0 - 1 + j;
    return r < 0 || r >= g.h ? nullptr : ring + (j % kRing) * pitch + at;
  };
  T* out = y + (((int64_t)image * g.h + r0) * g.w + q) * g.c + ch;
  const int64_t stride = (int64_t)g.w * g.c;
  Vec<T, V> up[3], mid[3], down[3];
  // output row r0 + k needs ring rows k..k+2: rows 0..k+2 are done once at
  // most kRing - 4 of the groups committed before it are pending
  auto next = [&](int k, Vec<T, V> (&a)[3], Vec<T, V> (&b)[3], Vec<T, V> (&c)[3]) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 4) : "memory");
    __syncthreads();
    stage_row<T>(ring + ((k + kRing - 1) % kRing) * pitch, img, r0 + k + kRing - 2, rmax, cs, ce,
                 g, vector);
    if (active) {
      if (k == 0) {
        load_row<T, V>(a, row(0), left, right, g.c);
        load_row<T, V>(b, row(1), left, right, g.c);
      }
      load_row<T, V>(c, row(k + 2), left, right, g.c);
      stencil<T, V, kFlip>(a, b, c, out + k * stride);
    }
  };
  // three rows a turn, the roles rotating, so that no row is moved
  for (int k = 0; k < r1 - r0; k += 3) {
    next(k, up, mid, down);
    if (k + 1 >= r1 - r0) break;
    next(k + 1, mid, down, up);
    if (k + 2 >= r1 - r0) break;
    next(k + 2, down, up, mid);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// The plan's invariants (ops/blur_cuda.py ``plan``); true if it does not fit.
bool bad_plan(const Geom& g, int elem, int threads, int smem, int grid) {
  if (g.images <= 0 || g.h <= 0 || g.w <= 0 || g.c <= 0) return true;
  if (g.vec <= 0 || g.vec * elem > 16 || (g.vec & (g.vec - 1)) != 0 || g.c % g.vec != 0)
    return true;
  if (g.cols <= 0 || g.rows <= 0 || threads != g.cols * (g.c / g.vec) || threads > kMaxThreads)
    return true;
  if (g.col_blocks != ceil_div(g.w, g.cols) || g.row_blocks != ceil_div(g.h, g.rows)) return true;
  const int64_t staged = (int64_t)kRing * (g.cols + 2) * g.c * elem;
  if (smem < staged || smem > kMaxSmem) return true;
  return (int64_t)grid != (int64_t)g.images * g.row_blocks * g.col_blocks;
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

// x, y: (images, h, w, c) contiguous, of dtype (0 f32, 1 bf16), not
// overlapping, aligned to a unit of `vec` elements. flip: the backward's order
// of the nine terms. vec..grid: the launch plan of ops/blur_cuda.py ``plan``,
// checked here. Launches on `stream` and returns the launch's cudaError_t (0
// on success) without synchronising.
int blur3x3(const void* x, void* y, int images, int h, int w, int c, int dtype, int flip,
            int vec, int cols, int rows, int threads, int smem, int grid, cudaStream_t stream) {
  const Geom g{images, h, w, c, vec, cols, rows, ceil_div(w, cols > 0 ? cols : 1),
               ceil_div(h, rows > 0 ? rows : 1)};
  const int elem = dtype == 0 ? 4 : 2;
  if (x == nullptr || y == nullptr || dtype < 0 || dtype > 1 ||
      bad_plan(g, elem, threads, smem, grid) ||
      reinterpret_cast<uintptr_t>(x) % (vec * elem) != 0 ||
      reinterpret_cast<uintptr_t>(y) % (vec * elem) != 0)
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
