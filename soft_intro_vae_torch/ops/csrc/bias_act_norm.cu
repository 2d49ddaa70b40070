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
// backward ~20 (plus one expf in corr mode) against 2*bytes(x) of traffic
// (x in, y out; dy and x in, dx out in the backward): two orders of magnitude
// below the card's flop-per-byte balance. The least traffic is one read of
// every input and one write of every output. The design: one block per
// (b, c) plane and two loops over it. Loop 1 recomputes e from x and
// accumulates the sums in registers; a fixed-order block reduction (warp
// shuffles, then one thread over the warps' partials, no float atomics) makes
// the result reproducible run to run. Loop 2 reads x again, recomputes e and
// writes the output. The second read of a plane (at most 256 KB in f32)
// mostly hits the 50 MB L2, so device-memory traffic stays near the least:
// the intermediate e is never stored. Block size grows with S so that the
// largest sites (4 x 64 planes of 256x256) fill every SM; the smallest sites
// (2048 planes of 2x2) waste most of a 32-thread block, and a later change
// can pack several planes into one block.
//
// Rounding: the producer (inject, bias, leaky ReLU) uses round-to-nearest
// intrinsics in the plain version's order, so nvcc cannot contract it into
// FMAs and `pre` has the plain version's bits: the leaky ReLU's branch (and
// its derivative, 1 or slope) is then taken on the same side as in
// ops/adain.py's bias_act_norm_plain. Sums are taken in another order than
// PyTorch's, so m, v, y and the gradients agree with the plain version to a
// tolerance, not bit for bit. expf and rsqrtf (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

enum Mode { kPlain = 0, kNoise = 1, kCorr = 2 };

struct Consts {
  float eps;
  float slope;
  float corr_ks;      // 0.8 * s / sqrt(2 pi)
  float corr_c2;      // -0.5 / s^2
  float corr_inv_s2;  // 1 / s^2
};

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

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

// Sum of N values over the block, in a fixed order; every thread gets the sums.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) smem[k * kMaxWarps + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += smem[k * kMaxWarps + w];
      smem[k * kMaxWarps] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = smem[k * kMaxWarps];
  __syncthreads();  // smem may be reused by the caller
}

template <typename T, int MODE, bool AFFINE>
__global__ void __launch_bounds__(kMaxThreads)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias, const float* __restrict__ g,
           const float* __restrict__ bst, const float* __restrict__ noise,
           const float* __restrict__ nw, T* __restrict__ y, float* __restrict__ mean,
           float* __restrict__ var, int channels, int size, Consts k) {
  __shared__ float smem[2 * kMaxWarps];
  const int plane = blockIdx.x;
  const int b = plane / channels;
  const int c = plane - b * channels;
  const int64_t base = (int64_t)plane * size;
  const float* nb = MODE == kNoise ? noise + (int64_t)b * size : nullptr;
  const float bias_c = bias[c];
  const float nw_c = MODE == kNoise ? nw[c] : 0.f;

  float acc[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float n = MODE == kNoise ? nb[i] : 0.f;
    const float e = leaky(pre_act<MODE>(load_f32(x, base + i), bias_c, nw_c, n, k), k.slope);
    acc[0] += e;
    acc[1] += e * e;
  }
  block_sum<2>(acc, smem);
  const float m = acc[0] / (float)size;
  const float v = fmaxf(acc[1] / (float)size - m * m, 0.f);
  const float rstd = rsqrtf(v + k.eps);
  const float a = AFFINE ? rstd * g[plane] : rstd;
  const float shift = AFFINE ? bst[plane] - m * a : -m * a;

  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float n = MODE == kNoise ? nb[i] : 0.f;
    const float e = leaky(pre_act<MODE>(load_f32(x, base + i), bias_c, nw_c, n, k), k.slope);
    store_f32(y, base + i, e * a + shift);
  }
  if (threadIdx.x == 0) {
    mean[plane] = m;
    var[plane] = v;
  }
}

template <typename T, int MODE, bool AFFINE>
__global__ void __launch_bounds__(kMaxThreads)
bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ noise,
           const float* __restrict__ nw, const float* __restrict__ mean,
           const float* __restrict__ var, const float* __restrict__ dm,
           const float* __restrict__ dv, T* __restrict__ dx, float* __restrict__ dbst,
           float* __restrict__ dg, float* __restrict__ dbias, float* __restrict__ dnw,
           int channels, int size, Consts k) {
  __shared__ float smem[2 * kMaxWarps];
  const int plane = blockIdx.x;
  const int b = plane / channels;
  const int c = plane - b * channels;
  const int64_t base = (int64_t)plane * size;
  const float* nb = MODE == kNoise ? noise + (int64_t)b * size : nullptr;
  const float bias_c = bias[c];
  const float nw_c = MODE == kNoise ? nw[c] : 0.f;
  const float m = mean[plane];
  const float rstd = rsqrtf(var[plane] + k.eps);

  // loop 1: sum(dy) and sum(dy * ehat)
  float acc[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float n = MODE == kNoise ? nb[i] : 0.f;
    const float e = leaky(pre_act<MODE>(load_f32(x, base + i), bias_c, nw_c, n, k), k.slope);
    const float d = load_f32(dy, base + i);
    acc[0] += d;
    acc[1] += d * ((e - m) * rstd);
  }
  block_sum<2>(acc, smem);
  const float sdy = acc[0];
  const float sde = acc[1];
  const float u1 = sdy / (float)size;
  const float u2 = sde / (float)size;
  const float gain = AFFINE ? rstd * g[plane] : rstd;
  const float dm_s = dm[plane] * (1.f / (float)size);
  const float dv_s = dv[plane] * (2.f / (float)size);

  // loop 2: dx, sum(dp) and sum(dp * n)
  float acc2[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const float n = MODE == kNoise ? nb[i] : 0.f;
    const float xv = load_f32(x, base + i);
    const float pre = pre_act<MODE>(xv, bias_c, nw_c, n, k);
    const float e = leaky(pre, k.slope);
    const float ehat = (e - m) * rstd;
    const float d = load_f32(dy, base + i);
    const float de = gain * (d - u1 - ehat * u2) + dm_s + dv_s * (e - m);
    const float dp = pre >= 0.f ? de : k.slope * de;
    acc2[0] += dp;
    if (MODE == kNoise) acc2[1] += dp * n;
    float dxv = dp;
    if (MODE == kCorr) dxv = dp * (1.f - xv * k.corr_inv_s2 * corr_term(xv, k));
    store_f32(dx, base + i, dxv);
  }
  block_sum<2>(acc2, smem);
  if (threadIdx.x == 0) {
    dbst[plane] = sdy;
    dg[plane] = sde;
    dbias[plane] = acc2[0];
    dnw[plane] = acc2[1];
  }
}

int threads_for(int size) {
  if (size >= 16384) return 1024;
  if (size >= 2048) return 512;
  if (size >= 256) return 256;
  if (size >= 64) return 64;
  return 32;
}

bool bad_shape(int planes, int channels, int size) {
  return planes <= 0 || channels <= 0 || size <= 0 || planes % channels != 0;
}

template <typename T, int MODE, bool AFFINE>
int launch_fwd(const void* x, const float* bias, const float* g, const float* bst,
               const float* noise, const float* nw, void* y, float* mean, float* var,
               int planes, int channels, int size, Consts k, cudaStream_t stream) {
  fwd_kernel<T, MODE, AFFINE><<<planes, threads_for(size), 0, stream>>>(
      static_cast<const T*>(x), bias, g, bst, noise, nw, static_cast<T*>(y), mean, var,
      channels, size, k);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, bool AFFINE>
int launch_bwd(const void* dy, const void* x, const float* bias, const float* g,
               const float* noise, const float* nw, const float* mean, const float* var,
               const float* dm, const float* dv, void* dx, float* dbst, float* dg,
               float* dbias, float* dnw, int planes, int channels, int size, Consts k,
               cudaStream_t stream) {
  bwd_kernel<T, MODE, AFFINE><<<planes, threads_for(size), 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), bias, g, noise, nw, mean, var, dm,
      dv, static_cast<T*>(dx), dbst, dg, dbias, dnw, channels, size, k);
  return (int)cudaGetLastError();
}

// dtype 0 = f32, 1 = bf16; mode 0/1/2 = plain/noise/corr; affine 0/1
#define BAN_DISPATCH(FN, ...)                                                        \
  switch (dtype * 6 + mode * 2 + (affine ? 1 : 0)) {                                 \
    case 0: return FN<float, kPlain, false>(__VA_ARGS__);                            \
    case 1: return FN<float, kPlain, true>(__VA_ARGS__);                             \
    case 2: return FN<float, kNoise, false>(__VA_ARGS__);                            \
    case 3: return FN<float, kNoise, true>(__VA_ARGS__);                             \
    case 4: return FN<float, kCorr, false>(__VA_ARGS__);                             \
    case 5: return FN<float, kCorr, true>(__VA_ARGS__);                              \
    case 6: return FN<__nv_bfloat16, kPlain, false>(__VA_ARGS__);                    \
    case 7: return FN<__nv_bfloat16, kPlain, true>(__VA_ARGS__);                     \
    case 8: return FN<__nv_bfloat16, kNoise, false>(__VA_ARGS__);                    \
    case 9: return FN<__nv_bfloat16, kNoise, true>(__VA_ARGS__);                     \
    case 10: return FN<__nv_bfloat16, kCorr, false>(__VA_ARGS__);                    \
    case 11: return FN<__nv_bfloat16, kCorr, true>(__VA_ARGS__);                     \
    default: return (int)cudaErrorInvalidValue;                                      \
  }

bool bad_selector(int dtype, int mode) {
  return dtype < 0 || dtype > 1 || mode < 0 || mode > 2;
}

}  // namespace

extern "C" {

// x, y: (planes, size) of dtype; planes = B*C, plane p = b*C + c. bias, nw: (C,)
// f32; g, bst, mean, var: (planes,) f32; noise: (B, size) f32. Pointers that
// the mode does not read may be null. Launches one block per plane on
// `stream` and returns the launch's cudaError_t (0 on success) without
// synchronising.
int bias_act_norm_fwd(const void* x, const float* bias, const float* g, const float* bst,
                      const float* noise, const float* nw, void* y, float* mean, float* var,
                      int planes, int channels, int size, int dtype, int mode, int affine,
                      float eps, float slope, float corr_ks, float corr_c2,
                      cudaStream_t stream) {
  if (bad_shape(planes, channels, size) || bad_selector(dtype, mode))
    return (int)cudaErrorInvalidValue;
  const Consts k{eps, slope, corr_ks, corr_c2, 0.f};
  BAN_DISPATCH(launch_fwd, x, bias, g, bst, noise, nw, y, mean, var, planes, channels, size,
               k, stream)
}

// dy, x, dx: (planes, size) of dtype; dm, dv, mean, var, g: (planes,) f32;
// dbst, dg, dbias, dnw: (planes,) f32 outputs (dnw is 0 unless mode is noise).
int bias_act_norm_bwd(const void* dy, const void* x, const float* bias, const float* g,
                      const float* noise, const float* nw, const float* mean, const float* var,
                      const float* dm, const float* dv, void* dx, float* dbst, float* dg,
                      float* dbias, float* dnw, int planes, int channels, int size, int dtype,
                      int mode, int affine, float eps, float slope, float corr_ks,
                      float corr_c2, float corr_inv_s2, cudaStream_t stream) {
  if (bad_shape(planes, channels, size) || bad_selector(dtype, mode))
    return (int)cudaErrorInvalidValue;
  const Consts k{eps, slope, corr_ks, corr_c2, corr_inv_s2};
  BAN_DISPATCH(launch_bwd, dy, x, bias, g, noise, nw, mean, var, dm, dv, dx, dbst, dg, dbias,
               dnw, planes, channels, size, k, stream)
}

const char* bias_act_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
