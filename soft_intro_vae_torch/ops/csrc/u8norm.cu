// uint8 -> float32 in [0, 1], correctly rounded, in the host's NHWC order, for Hopper (sm_90a).
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
// What it computes: y[i] = x[i] / 255 rounded once to float32 (IEEE division,
// __fdiv_rn, never a reciprocal: the build has no --use_fast_math) over the
// flat buffer, bit-equal to numpy for all 256 byte values. The output keeps
// the input's NHWC order; the wrapper returns it as the (B, C, H, W) tensor
// with channels-last strides, the layout the image nets run in (the JAX
// package's nets are NHWC throughout), so a step normalizes its batch with
// this one launch and no layout change follows it.
//
// What bounds it: bytes, 1 read and 4 written an element. At the CIFAR-10
// recipe's batch (32, 32, 32, 3) that is 0.49 MB, 0.15 us at 3.35 TB/s, far
// below the launch itself; at a celeb256 batch (32, 256, 256, 3) 31.5 MB,
// 9.4 us.
//
// The design: one contiguous elementwise pass, measured on the card against
// other layouts of the same pass (tools/torch_u8norm_variants.py). Each
// thread of a grid-stride loop takes 16 input bytes an iteration as four
// 32-bit words a grid stride apart, so each of a warp's four loads reads 128
// contiguous bytes and each of its four 128-bit stores writes 512 contiguous
// bytes; the loop's counters are the only index arithmetic. (One 128-bit load
// a thread and four stores to the thread's own 64 output bytes measured at
// 43% of the bound at celeb256: a warp's stores then straddle 2 KB in 16-byte
// pieces.) The divide is a 256-entry table in shared memory that each block
// fills with __fdiv_rn before the loop, so a byte costs a shared-memory load
// instead of a division sequence. The launch plan (ops/u8norm_cuda.py
// ``plan``) splits the n elements into a head of fewer than 16, up to the
// first 16-byte boundary of the input (a slice of an odd-sized batch starts
// anywhere), the 16-byte runs, and a tail of fewer than 16; head and tail
// take one element a thread, in the same launch. When the head's length
// leaves the output's runs off a 16-byte boundary, the stores are scalar (a
// template instance of its own). Indices are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kVec = 16;  // input bytes a thread takes an iteration

__device__ __forceinline__ float unit(unsigned b) {
  return __fdiv_rn(__uint2float_rn(b), 255.0f);
}

// the four bytes of `w` (little-endian: the lowest byte first in memory) into
// the i-th run of four floats of y
template <bool kAlignedStores>
__device__ __forceinline__ void store4(const float* table, float* y, long long i, unsigned w) {
  const float4 f = make_float4(table[w & 0xffu], table[(w >> 8) & 0xffu],
                               table[(w >> 16) & 0xffu], table[w >> 24]);
  if (kAlignedStores) {
    reinterpret_cast<float4*>(y)[i] = f;
  } else {
    y[4 * i] = f.x;
    y[4 * i + 1] = f.y;
    y[4 * i + 2] = f.z;
    y[4 * i + 3] = f.w;
  }
}

template <bool kAlignedStores>
__global__ void u8norm_kernel(const uint8_t* __restrict__ x, float* __restrict__ y,
                              long long head, long long vectors, long long tail) {
  __shared__ float table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    table[i] = unit(i);
  }
  __syncthreads();
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned* xw = reinterpret_cast<const unsigned*>(x + head);
  float* yw = y + head;
  const long long words = 4 * vectors;
  for (long long base = first; base < words; base += 4 * stride) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + k * stride;
      w[k] = i < words ? __ldg(xw + i) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + k * stride;
      if (i < words) {
        store4<kAlignedStores>(table, yw, i, w[k]);
      }
    }
  }
  if (first < head) {
    y[first] = table[x[first]];
  }
  if (first < tail) {
    const long long i = head + kVec * vectors + first;
    y[i] = table[x[i]];
  }
}

}  // namespace

extern "C" {

// x (n,) uint8 and y (n,) float32, both contiguous on the current device;
// head, vectors, tail, grid and threads: the launch plan of
// ops/u8norm_cuda.py ``plan``, refused unless it covers the n elements and
// puts the vectors on 16-byte boundaries of x. Launches on `stream` and
// returns the launch's cudaError_t (0 on success) without synchronising.
int u8norm_to_unit_nhwc(const uint8_t* x, float* y, long long n, long long head,
                        long long vectors, long long tail, int grid, int threads,
                        cudaStream_t stream) {
  const bool covers = head >= 0 && head < kVec && tail >= 0 && tail < kVec && vectors >= 0 &&
                      head + kVec * vectors + tail == n;
  const bool aligned_loads = vectors == 0 || (reinterpret_cast<uintptr_t>(x + head) % kVec) == 0;
  if (x == nullptr || y == nullptr || n <= 0 || !covers || !aligned_loads || grid <= 0 ||
      threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      (long long)grid * threads < (head > tail ? head : tail)) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(y + head) % kVec == 0) {
    u8norm_kernel<true><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail);
  } else {
    u8norm_kernel<false><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail);
  }
  return (int)cudaGetLastError();
}

const char* u8norm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
