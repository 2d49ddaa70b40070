// uint8 NHWC -> float32 NCHW in [0, 1], correctly rounded, for Hopper (sm_90a).
//
// Replaces soft_intro_vae_tpu/ops/u8norm.py (u8_to_unit_f32), which the JAX
// step fuses into its program when it is given the canonical unit table
// (soft_intro_vae_tpu/train/step.py:154-164). It is not a Pallas kernel: XLA
// builds it from integer elementwise ops. The port needs a kernel of its own
// because the obvious PyTorch chain, x.float() / 255 on the card, is computed
// by ATen as a multiply by the reciprocal of the scalar, which is one ulp off
// the host's x.astype(float32) / float32(255) for many byte values; the
// reference and the JAX package train on the host's values.
//
// What it computes: y[b, c, h, w] = x[b, h, w, c] / 255 rounded once to
// float32 (IEEE division, __fdiv_rn, never a reciprocal: the build has no
// --use_fast_math), bit-equal to numpy for all 256 byte values. It also turns
// the bytes the host stores (NHWC) into the layout the nets take (NCHW), so a
// step normalizes its batch with this one launch.
//
// What bounds it: bytes, 1 read and 4 written an element. At the CIFAR-10
// recipe's batch (32, 32, 32, 3) that is 0.49 MB, 0.15 us at 3.35 TB/s, far
// below the launch itself; at a celeb256 batch (32, 256, 256, 3) 31.5 MB,
// 9.4 us. The design is the simple one: one thread an output element in a
// grid-stride loop, so consecutive threads write consecutive floats (each
// warp stores 128 contiguous bytes) and read bytes C apart, which lie in the
// same few cache lines. Indices are 64-bit: any B, H, W, C whose product fits
// in a tensor works, C = 1 included.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
u8norm_kernel(const uint8_t* __restrict__ x, float* __restrict__ y, long long hw, long long c,
              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x; o < n; o += stride) {
    const long long plane = o / hw;           // b * C + c
    const long long p = o - plane * hw;       // h * W + w
    const long long b = plane / c;
    const long long ch = plane - b * c;
    const uint8_t v = __ldg(x + (b * hw + p) * c + ch);
    y[o] = __fdiv_rn(static_cast<float>(v), 255.0f);
  }
}

}  // namespace

extern "C" {

// x (B, H, W, C) contiguous uint8 and y (B, C, H, W) contiguous float32, both
// on the current device; grid and threads: the launch plan of
// ops/u8norm_cuda.py ``plan``. Launches on `stream` and returns the launch's
// cudaError_t (0 on success) without synchronising.
int u8norm_nhwc_to_nchw(const uint8_t* x, float* y, long long batch, long long height,
                        long long width, long long channels, int grid, int threads,
                        cudaStream_t stream) {
  if (x == nullptr || y == nullptr || batch <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      grid <= 0 || threads <= 0 || threads > 1024 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long hw = height * width;
  const long long n = batch * channels * hw;
  u8norm_kernel<<<grid, threads, 0, stream>>>(x, y, hw, channels, n);
  return (int)cudaGetLastError();
}

const char* u8norm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
