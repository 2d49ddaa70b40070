// Fused bias + leaky ReLU + instance norm (+ AdaIN) for Hopper (sm_90a),
// forward and backward.
//
// Replaces the Pallas TPU kernels of soft_intro_vae_tpu/ops/adain_pallas.py:
// _fwd_pallas (the forward) and _bwd_pallas (the backward of its custom VJP).
// Layout NCHW: x is (B, C, H, W), so each (b, c) plane of S = H*W elements is
// contiguous; n is (B, H, W); bias and nw are (C,); g, bst, mean, var and
// every per-plane gradient are (B, C) f32. x, y, dy and dx are f32 or bf16;
// all arithmetic is f32.
//
// Forward, per plane:
//   e   = leaky_relu(x + inject + bias, slope), inject = 0 (plain),
//         nw*n (noise) or ks*exp(x*x*c2) (corr, ks = 0.8*s/sqrt(2 pi),
//         c2 = -1/(2 s^2))
//   m   = mean(e), v = max(mean(e^2) - m^2, 0)          (one-pass moments)
//   y   = (e - m) * rsqrt(v + eps) * g + bst             (g, bst: affine only)
// Backward, per plane, from dy, dm, dv:
//   sdy = sum(dy), sde = sum(dy * ehat), ehat = (e - m) * rstd
//   de  = gain*(dy - sdy/S - ehat*sde/S) + dm/S + dv*2(e - m)/S
//   dp  = de * leaky_relu'(pre);  dx = dp (times 1 - x/s^2 * corr in corr mode)
//   per plane: sdy (d bst), sde (d g), sum(dp) (d bias), sum(dp*n) (d nw);
//   the caller sums the last two over b.
//
// What bounds it: bytes. Per element the forward does ~10 flops and the
// backward ~20 (plus one expf in corr mode) against 2*bytes(x) of traffic (x
// in, y out) and 3*bytes(x) (dy and x in, dx out): two orders of magnitude
// below the card's flop-per-byte balance. There is no matrix product, so the
// tensor cores play no part. The least traffic is one read of every input and
// one write of every output, and that is what the design does: each CTA
// stages its part of x (and dy) in shared memory once, takes the plane's sums
// from the staged copy, then reads the staged copy again to write y (dx)
// straight from registers with 16-byte stores. The activation e is never
// stored; it is recomputed from the staged x in both passes.
//
// Staging: where a CTA's run of elements is 16-byte aligned and a multiple of
// 16 bytes (S * bytes(T) % 16 == 0; the wrapper hands over 16-byte aligned
// base pointers), thread 0 issues 1-D bulk copies (cp.async.bulk, the TMA's
// non-tensor form) of the whole run into shared memory, completing on one
// mbarrier, so the CTA's every byte is in flight at once and no thread spends
// registers on the load; each thread then works on 16-byte units (8 bf16 or 4
// f32). Other sizes (S = 63, or 2x2 bf16 planes of 8 bytes) stage with scalar
// loads and work element by element.
//
// The launch plan, one per (B, C, S, dtype, direction), comes from
// ops/adain_cuda.py ``plan``; this file checks it and launches. Three tiers:
//   * small (S <= 256): a CTA of 128 threads owns k consecutive planes, one
//     contiguous run of k*S elements (which is what makes 16-byte copies legal
//     where one plane, 2x2 f32 = 16 bytes, is the whole vector), G = 128/k
//     lanes per plane (at most one warp); the sums are warp shuffles within
//     the G lanes only.
//   * plane: one CTA per plane, its sums reduced by shuffles, then across
//     warps through shared memory.
//   * cluster: a thread-block cluster of Q = 2..8 CTAs shares a plane, each
//     staging one slice; the CTAs' partial sums are combined through
//     distributed shared memory (map_shared_rank), always in rank order, so
//     every CTA gets the same bits. Rank 0 writes the per-plane outputs. Q is
//     the least power of two that brings a CTA's staged bytes to 64 KB, so
//     that three CTAs fit an SM's shared memory: a whole 256x256 plane (128
//     KB of bf16 x, 256 KB of x and dy in the backward, twice that in f32)
//     would leave one CTA per SM, and nothing to overlap one CTA's reduction
//     with another's copies. In bf16 the 256 planes of the top site make 512
//     CTAs of 512 threads (Q = 2) forward and 1024 of 256 threads (Q = 4)
//     backward. A thread takes 8 units per pass where the slice allows.
// The 64 KB and the 8 units were chosen on the card among other values
// (tools/torch_norm_plans.py). Persistent CTAs with two buffers, staging the
// noise slice as well, and copies in chunks, each on its own mbarrier, were
// measured too and did not pay (PERF.md). Planes whose slice would need more
// than one CTA's shared memory with Q = 8 (beyond ~925K bf16 elements
// forward, ~231K f32 backward) are refused by the plan; the style model's
// largest plane is 65536.
//
// Rounding: the producer (inject, bias, leaky ReLU) uses round-to-nearest
// intrinsics in the plain version's order, so nvcc cannot contract it into
// FMAs and `pre` has the plain version's bits: the leaky ReLU's branch (and
// its derivative, 1 or slope) is then taken on the same side as in
// ops/adain.py's bias_act_norm_plain. Every sum runs in a fixed order (a
// thread's units in order, shuffles within the warp, warps in order, cluster
// ranks in order) and no float atomics are used, so two launches on the same
// inputs give the same bits. Sums are taken in another order than PyTorch's,
// so m, v, y and the gradients agree with the plain version to a tolerance,
// not bit for bit. expf and rsqrtf (no --use_fast_math).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// the same numbers as ops/adain_cuda.py's plan
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kBlockSmem = 232448;  // shared memory one CTA may use on sm_90
constexpr int kStaticSmem = 1024;   // bound on the kernels' static shared memory
constexpr int kMaxDynamicSmem = kBlockSmem - kStaticSmem;
constexpr uint32_t kBulkChunk = 32768;  // bytes per bulk copy instruction

enum Mode { kPlain = 0, kNoise = 1, kCorr = 2 };

struct Consts {
  float eps;
  float slope;
  float corr_ks;      // 0.8 * s / sqrt(2 pi)
  float corr_c2;      // -0.5 / s^2
  float corr_inv_s2;  // 1 / s^2
};

// The launch plan (ops/adain_cuda.py Plan) and the launch's shape.
struct Plan {
  int k;        // planes per CTA (1 unless small)
  int lanes;    // G: threads per plane, k * G == threads
  int cluster;  // Q: CTAs per plane
  int threads;
  int slice;    // E: elements of a plane one CTA stages (S unless Q > 1)
  int unit;     // elements per thread step: 16 bytes' worth, or 1
  int smem;     // dynamic shared bytes
  int grid;     // CTAs
};

struct Geom {
  int planes, channels, size;
  int k, lanes, cluster, slice;
};

// ---- PTX helpers: mbarrier and 1-D bulk copy (TMA) ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A copy that never lands (a fault) traps after ~2^30 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- element access: a unit is 16 bytes of T (UNIT elements) or one element

template <int UNIT>
__device__ __forceinline__ void load_units(const float* p, float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int j = 0; j < UNIT; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  }
}

template <int UNIT>
__device__ __forceinline__ void load_units(const __nv_bfloat16* p, float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    v[0] = __bfloat162float(p[0]);
  } else {
    static_assert(UNIT % 8 == 0, "bf16 units are 16 bytes");
#pragma unroll
    for (int j = 0; j < UNIT; j += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + j);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(h[t]);
        v[j + 2 * t] = f.x;
        v[j + 2 * t + 1] = f.y;
      }
    }
  }
}

template <int UNIT>
__device__ __forceinline__ void store_units(float* p, const float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < UNIT; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

template <int UNIT>
__device__ __forceinline__ void store_units(__nv_bfloat16* p, const float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
#pragma unroll
    for (int j = 0; j < UNIT; j += 8) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[j + 2 * t], v[j + 2 * t + 1]);
      *reinterpret_cast<uint4*>(p + j) = q;
    }
  }
}

// ---- the producer, rounded as the plain version rounds it -----------------

__device__ __forceinline__ float corr_term(float x, const Consts& k) {
  return __fmul_rn(k.corr_ks, expf(__fmul_rn(__fmul_rn(x, x), k.corr_c2)));
}

// x + inject + bias, each step rounded on its own, in the plain version's order
template <int MODE>
__device__ __forceinline__ float pre_act(float x, float bias, float nw, float n, const Consts& k) {
  float xe = x;
  if (MODE == kNoise) xe = __fadd_rn(x, __fmul_rn(nw, n));
  if (MODE == kCorr) xe = __fadd_rn(x, corr_term(x, k));
  return __fadd_rn(xe, bias);
}

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre >= 0.f ? pre : __fmul_rn(slope, pre);
}

// ---- where a thread works --------------------------------------------------

struct Seg {
  int plane;      // the thread's plane (>= planes when its group has none)
  int lane;       // index among the G threads of the plane
  int rank;       // rank in the cluster (0 without one)
  int len;        // elements of the plane this CTA covers (0: no work)
  int slice0;     // first element of the plane this CTA covers
  int soff;       // offset of that element in the staged arrays
  int64_t run;    // global index of the CTA's first staged element
  int run_len;    // elements the CTA stages per array
};

__device__ __forceinline__ Seg segment(const Geom& g) {
  Seg s;
  const int group = threadIdx.x / g.lanes;
  s.lane = threadIdx.x - group * g.lanes;
  s.rank = blockIdx.x % g.cluster;
  const int p0 = (blockIdx.x / g.cluster) * g.k;
  const int nplanes = min(g.k, g.planes - p0);
  s.slice0 = s.rank * g.slice;
  const int slice_len = max(0, min(g.size - s.slice0, g.slice));
  s.plane = p0 + group;
  s.len = group < nplanes ? slice_len : 0;
  s.soff = group * g.size;  // groups > 0 only when k > 1, where the slice is the plane
  s.run = (int64_t)p0 * g.size + s.slice0;
  s.run_len = g.k == 1 ? slice_len : nplanes * g.size;
  return s;
}

// elements between two staged arrays: the CTA's largest run, 16-byte aligned
template <typename T>
__device__ __forceinline__ int stage_pitch(const Geom& g) {
  constexpr int per16 = 16 / sizeof(T);
  return (g.k * g.slice + per16 - 1) / per16 * per16;
}

// Copies run_len elements of each of the N arrays, from element `run` on, into
// shared memory (array a at sm + a * pitch). Vector plans: thread 0 issues
// bulk copies that complete on one mbarrier; scalar plans: every thread loads.
template <typename T, int UNIT, int N>
__device__ __forceinline__ void stage(T* sm, int pitch, const T* const* src, const Seg& s,
                                      uint64_t* bar) {
  if constexpr (UNIT == 1) {
#pragma unroll
    for (int a = 0; a < N; ++a)
      for (int i = threadIdx.x; i < s.run_len; i += blockDim.x)
        sm[a * pitch + i] = src[a][s.run + i];
    __syncthreads();
  } else {
    if (threadIdx.x == 0) mbar_init(bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)s.run_len * sizeof(T);
      mbar_expect_tx(bar, N * bytes);
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const char* from = reinterpret_cast<const char*>(src[a] + s.run);
        char* to = reinterpret_cast<char*>(sm + a * pitch);
        for (uint32_t off = 0; off < bytes; off += kBulkChunk)
          bulk_load(to + off, from + off, min(kBulkChunk, bytes - off), bar);
      }
    }
    mbar_wait(bar, 0);
  }
}

// ---- sums in a fixed order -------------------------------------------------

// Sums N values over the G threads of each plane; every thread gets the sums
// of its plane, with the same bits. G <= 32: a butterfly within the G lanes.
// G == blockDim.x: butterfly in each warp, then the warps' totals in order
// (red: N * kMaxWarps floats, not reused by the caller).
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int lanes, float* red) {
  const int width = lanes < 32 ? lanes : 32;
#pragma unroll
  for (int k = 0; k < N; ++k)
    for (int off = width >> 1; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lanes <= 32) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * kMaxWarps + warp] = v[k];
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[k * kMaxWarps + w];
    v[k] = s;
  }
}

// Split cluster barrier: arrive (release) now, wait (acquire) later; every
// arrive is followed by one wait before the next arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Sums the CTAs' totals over the cluster, ranks in order; every thread of
// every CTA gets the same bits (part: N floats of this CTA's shared memory).
// Ends with an arrive: the caller's next wait tells it that every CTA has
// read this CTA's part.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&v)[N], float* part, int ranks) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) part[k] = v[k];
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.f;
  for (int q = 0; q < ranks; ++q) {
    const float* r = cluster.map_shared_rank(part, q);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += r[k];
  }
  cluster_arrive();
}

// ---- the kernels -----------------------------------------------------------

template <typename T, int MODE, bool AFFINE, int UNIT>
__global__ void __launch_bounds__(kMaxThreads)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias, const float* __restrict__ g,
           const float* __restrict__ bst, const float* __restrict__ noise,
           const float* __restrict__ nw, T* __restrict__ y, float* __restrict__ mean,
           float* __restrict__ var, Geom geo, Consts k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2 * kMaxWarps];
  __shared__ float part[2];
  const Seg s = segment(geo);
  T* sx = reinterpret_cast<T*>(smem);
  const T* src[1] = {x};
  stage<T, UNIT, 1>(sx, stage_pitch<T>(geo), src, s, &bar);

  const bool work = s.len > 0;
  const int b = s.plane / geo.channels;
  const int c = s.plane - b * geo.channels;
  const float bias_c = work ? bias[c] : 0.f;
  const float nw_c = MODE == kNoise && work ? nw[c] : 0.f;
  const float* nb = MODE == kNoise ? noise + (int64_t)b * geo.size + s.slice0 : nullptr;
  const T* xs = sx + s.soff;
  const int units = s.len / UNIT;

  float acc[2] = {0.f, 0.f};
  for (int u = s.lane; u < units; u += geo.lanes) {
    float xv[UNIT], nv[UNIT] = {};
    load_units<UNIT>(xs + u * UNIT, xv);
    if (MODE == kNoise) load_units<UNIT>(nb + u * UNIT, nv);
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      const float e = leaky(pre_act<MODE>(xv[j], bias_c, nw_c, nv[j], k), k.slope);
      acc[0] += e;
      acc[1] += e * e;
    }
  }
  group_sum<2>(acc, geo.lanes, red);
  if (geo.cluster > 1) cluster_sum<2>(acc, part, geo.cluster);
  const float m = acc[0] / (float)geo.size;
  const float v = fmaxf(acc[1] / (float)geo.size - m * m, 0.f);
  const float rstd = rsqrtf(v + k.eps);
  const float a = AFFINE && work ? rstd * g[s.plane] : rstd;
  const float shift = AFFINE && work ? bst[s.plane] - m * a : -m * a;

  T* yp = y + (int64_t)s.plane * geo.size + s.slice0;
  for (int u = s.lane; u < units; u += geo.lanes) {
    float xv[UNIT], nv[UNIT] = {}, out[UNIT];
    load_units<UNIT>(xs + u * UNIT, xv);
    if (MODE == kNoise) load_units<UNIT>(nb + u * UNIT, nv);
#pragma unroll
    for (int j = 0; j < UNIT; ++j)
      out[j] = leaky(pre_act<MODE>(xv[j], bias_c, nw_c, nv[j], k), k.slope) * a + shift;
    store_units<UNIT>(yp + u * UNIT, out);
  }
  if (work && s.lane == 0 && s.rank == 0) {
    mean[s.plane] = m;
    var[s.plane] = v;
  }
  // no CTA leaves while another may still read its partial sums
  if (geo.cluster > 1) cluster_wait();
}

template <typename T, int MODE, bool AFFINE, int UNIT>
__global__ void __launch_bounds__(kMaxThreads)
bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ noise,
           const float* __restrict__ nw, const float* __restrict__ mean,
           const float* __restrict__ var, const float* __restrict__ dm,
           const float* __restrict__ dv, T* __restrict__ dx, float* __restrict__ dbst,
           float* __restrict__ dg, float* __restrict__ dbias, float* __restrict__ dnw, Geom geo,
           Consts k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[4 * kMaxWarps];
  __shared__ float part[4];
  const Seg s = segment(geo);
  const int pitch = stage_pitch<T>(geo);
  T* sx = reinterpret_cast<T*>(smem);
  const T* src[2] = {x, dy};
  stage<T, UNIT, 2>(sx, pitch, src, s, &bar);

  const bool work = s.len > 0;
  const int b = s.plane / geo.channels;
  const int c = s.plane - b * geo.channels;
  const float bias_c = work ? bias[c] : 0.f;
  const float nw_c = MODE == kNoise && work ? nw[c] : 0.f;
  const float m = work ? mean[s.plane] : 0.f;
  const float rstd = rsqrtf((work ? var[s.plane] : 0.f) + k.eps);
  const float* nb = MODE == kNoise ? noise + (int64_t)b * geo.size + s.slice0 : nullptr;
  const T* xs = sx + s.soff;
  const T* ds = sx + pitch + s.soff;
  const int units = s.len / UNIT;

  // pass 1: sum(dy) and sum(dy * ehat)
  float acc[2] = {0.f, 0.f};
  for (int u = s.lane; u < units; u += geo.lanes) {
    float xv[UNIT], dyv[UNIT], nv[UNIT] = {};
    load_units<UNIT>(xs + u * UNIT, xv);
    load_units<UNIT>(ds + u * UNIT, dyv);
    if (MODE == kNoise) load_units<UNIT>(nb + u * UNIT, nv);
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      const float e = leaky(pre_act<MODE>(xv[j], bias_c, nw_c, nv[j], k), k.slope);
      acc[0] += dyv[j];
      acc[1] += dyv[j] * ((e - m) * rstd);
    }
  }
  group_sum<2>(acc, geo.lanes, red);
  if (geo.cluster > 1) cluster_sum<2>(acc, part, geo.cluster);
  const float sdy = acc[0];
  const float sde = acc[1];
  const float u1 = sdy / (float)geo.size;
  const float u2 = sde / (float)geo.size;
  const float gain = AFFINE && work ? rstd * g[s.plane] : rstd;
  const float dm_s = work ? dm[s.plane] * (1.f / (float)geo.size) : 0.f;
  const float dv_s = work ? dv[s.plane] * (2.f / (float)geo.size) : 0.f;

  // pass 2: dx, sum(dp) and sum(dp * n)
  float acc2[2] = {0.f, 0.f};
  T* dxp = dx + (int64_t)s.plane * geo.size + s.slice0;
  for (int u = s.lane; u < units; u += geo.lanes) {
    float xv[UNIT], dyv[UNIT], nv[UNIT] = {}, out[UNIT];
    load_units<UNIT>(xs + u * UNIT, xv);
    load_units<UNIT>(ds + u * UNIT, dyv);
    if (MODE == kNoise) load_units<UNIT>(nb + u * UNIT, nv);
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      const float pre = pre_act<MODE>(xv[j], bias_c, nw_c, nv[j], k);
      const float e = leaky(pre, k.slope);
      const float ehat = (e - m) * rstd;
      const float de = gain * (dyv[j] - u1 - ehat * u2) + dm_s + dv_s * (e - m);
      const float dp = pre >= 0.f ? de : k.slope * de;
      acc2[0] += dp;
      if (MODE == kNoise) acc2[1] += dp * nv[j];
      out[j] = MODE == kCorr ? dp * (1.f - xv[j] * k.corr_inv_s2 * corr_term(xv[j], k)) : dp;
    }
    store_units<UNIT>(dxp + u * UNIT, out);
  }
  group_sum<2>(acc2, geo.lanes, red + 2 * kMaxWarps);
  if (geo.cluster > 1) {
    // only rank 0 writes the plane's sums, so only it gathers them
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      part[2] = acc2[0];
      part[3] = acc2[1];
    }
    cluster_wait();  // every CTA has read part[0..1] (cluster_sum's arrive)
    cluster_arrive();
    cluster_wait();  // every CTA has written part[2..3]
    if (threadIdx.x == 0 && s.rank == 0) {
      acc2[0] = acc2[1] = 0.f;
      for (int q = 0; q < geo.cluster; ++q) {
        const float* r = cluster.map_shared_rank(part, q);
        acc2[0] += r[2];
        acc2[1] += r[3];
      }
    }
    cluster_arrive();
  }
  if (work && s.lane == 0 && s.rank == 0) {
    dbst[s.plane] = sdy;
    dg[s.plane] = sde;
    dbias[s.plane] = acc2[0];
    dnw[s.plane] = acc2[1];
  }
  if (geo.cluster > 1) cluster_wait();
}

// ---- host side: check the plan, launch -------------------------------------

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// true when the plan does not describe a launch these kernels can run
bool bad_plan(int planes, int channels, int size, int elem, int arrays, const Plan& p) {
  if (planes <= 0 || channels <= 0 || size <= 0 || planes % channels != 0) return true;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0) return true;
  if (!pow2(p.lanes) || (p.lanes > 32 && p.lanes != p.threads)) return true;
  if (p.k < 1 || p.k * p.lanes != p.threads) return true;
  if (!pow2(p.cluster) || p.cluster > kMaxCluster || (p.cluster > 1 && p.k != 1)) return true;
  if (p.unit != 1 && (p.unit != 16 / elem || (int64_t)size * elem % 16 != 0)) return true;
  if (p.slice < 1 || p.slice % p.unit != 0) return true;
  if (p.cluster == 1 ? p.slice != size
                     : ((int64_t)p.slice * p.cluster < size ||
                        (int64_t)p.slice * (p.cluster - 1) >= size))
    return true;
  const int64_t ctas = p.cluster == 1 ? ((int64_t)planes + p.k - 1) / p.k
                                      : (int64_t)planes * p.cluster;
  if (p.grid != ctas) return true;
  const int64_t need = arrays * round16((int64_t)p.k * p.slice * elem);
  return p.smem < need || p.smem > kMaxDynamicSmem;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Plan& p, cudaStream_t stream, Args... args) {
  if (p.smem + kStaticSmem > 48 * 1024) {  // beyond the default limit, with the static share
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

struct Fwd {
  template <typename T, int MODE, bool AFFINE, int UNIT>
  static int run(const Plan& p, cudaStream_t stream, const void* x, const float* bias,
                 const float* g, const float* bst, const float* noise, const float* nw, void* y,
                 float* mean, float* var, Geom geo, Consts k) {
    return launch(fwd_kernel<T, MODE, AFFINE, UNIT>, p, stream, static_cast<const T*>(x), bias, g,
                  bst, noise, nw, static_cast<T*>(y), mean, var, geo, k);
  }
};

struct Bwd {
  template <typename T, int MODE, bool AFFINE, int UNIT>
  static int run(const Plan& p, cudaStream_t stream, const void* dy, const void* x,
                 const float* bias, const float* g, const float* noise, const float* nw,
                 const float* mean, const float* var, const float* dm, const float* dv, void* dx,
                 float* dbst, float* dg, float* dbias, float* dnw, Geom geo, Consts k) {
    return launch(bwd_kernel<T, MODE, AFFINE, UNIT>, p, stream, static_cast<const T*>(dy),
                  static_cast<const T*>(x), bias, g, noise, nw, mean, var, dm, dv,
                  static_cast<T*>(dx), dbst, dg, dbias, dnw, geo, k);
  }
};

// one instantiation per (dtype, mode, affine, vector or scalar units)
template <class L, typename T, int MODE, bool AFFINE, typename... A>
int by_unit(const Plan& p, A... a) {
  if (p.unit > 1) return L::template run<T, MODE, AFFINE, (int)(16 / sizeof(T))>(p, a...);
  return L::template run<T, MODE, AFFINE, 1>(p, a...);
}

template <class L, typename T, int MODE, typename... A>
int by_affine(bool affine, const Plan& p, A... a) {
  return affine ? by_unit<L, T, MODE, true>(p, a...) : by_unit<L, T, MODE, false>(p, a...);
}

template <class L, typename T, typename... A>
int by_mode(int mode, bool affine, const Plan& p, A... a) {
  switch (mode) {
    case kPlain: return by_affine<L, T, kPlain>(affine, p, a...);
    case kNoise: return by_affine<L, T, kNoise>(affine, p, a...);
    case kCorr: return by_affine<L, T, kCorr>(affine, p, a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype 0 = f32, 1 = bf16
template <class L, typename... A>
int dispatch(int dtype, int mode, bool affine, const Plan& p, A... a) {
  if (dtype == 0) return by_mode<L, float>(mode, affine, p, a...);
  if (dtype == 1) return by_mode<L, __nv_bfloat16>(mode, affine, p, a...);
  return (int)cudaErrorInvalidValue;
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// x, y: (planes, size) of dtype (0 f32, 1 bf16); planes = B*C, plane p =
// b*C + c. bias, nw: (C,) f32; g, bst, mean, var: (planes,) f32; noise:
// (B, size) f32. Pointers that the mode does not read may be null; the others
// are 16-byte aligned. mode 0/1/2 = plain/noise/corr. k..grid: the launch
// plan of ops/adain_cuda.py ``plan``, checked here. Launches on `stream` and
// returns the launch's cudaError_t (0 on success) without synchronising.
int bias_act_norm_fwd(const void* x, const float* bias, const float* g, const float* bst,
                      const float* noise, const float* nw, void* y, float* mean, float* var,
                      int planes, int channels, int size, int dtype, int mode, int affine,
                      int k, int lanes, int cluster, int threads, int slice, int unit, int smem,
                      int grid, float eps, float slope, float corr_ks, float corr_c2,
                      cudaStream_t stream) {
  const Plan p{k, lanes, cluster, threads, slice, unit, smem, grid};
  if (dtype < 0 || dtype > 1 || bad_plan(planes, channels, size, elem_bytes(dtype), 1, p) ||
      !aligned16(x) || !aligned16(y) || !aligned16(noise))
    return (int)cudaErrorInvalidValue;
  const Geom geo{planes, channels, size, k, lanes, cluster, slice};
  const Consts c{eps, slope, corr_ks, corr_c2, 0.f};
  return dispatch<Fwd>(dtype, mode, affine != 0, p, stream, x, bias, g, bst, noise, nw, y, mean,
                       var, geo, c);
}

// dy, x, dx: (planes, size) of dtype; dm, dv, mean, var, g: (planes,) f32;
// dbst, dg, dbias, dnw: (planes,) f32 outputs (dnw is 0 unless mode is noise).
int bias_act_norm_bwd(const void* dy, const void* x, const float* bias, const float* g,
                      const float* noise, const float* nw, const float* mean, const float* var,
                      const float* dm, const float* dv, void* dx, float* dbst, float* dg,
                      float* dbias, float* dnw, int planes, int channels, int size, int dtype,
                      int mode, int affine, int k, int lanes, int cluster, int threads, int slice,
                      int unit, int smem, int grid, float eps, float slope, float corr_ks,
                      float corr_c2, float corr_inv_s2, cudaStream_t stream) {
  const Plan p{k, lanes, cluster, threads, slice, unit, smem, grid};
  if (dtype < 0 || dtype > 1 || bad_plan(planes, channels, size, elem_bytes(dtype), 2, p) ||
      !aligned16(dy) || !aligned16(x) || !aligned16(dx) || !aligned16(noise))
    return (int)cudaErrorInvalidValue;
  const Geom geo{planes, channels, size, k, lanes, cluster, slice};
  const Consts c{eps, slope, corr_ks, corr_c2, corr_inv_s2};
  return dispatch<Bwd>(dtype, mode, affine != 0, p, stream, dy, x, bias, g, noise, nw, mean, var,
                       dm, dv, dx, dbst, dg, dbias, dnw, geo, c);
}

const char* bias_act_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
