// Chamfer nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel soft_intro_vae_tpu/ops/chamfer_pallas.py
// (_nearest -> _min_kernel): for clouds a (B, N, 3) and b (B, M, 3) in f32,
// every point of a gets the squared distance to its nearest point of b and
// that point's index, lowest index on ties. One launch computes one
// direction; a chamfer call launches twice (a->b, b->a), where the TPU kernel
// took both directions from one pass.
//
// What bounds it: arithmetic. A direction costs B*N*M distances of 8 FLOP
// (3 sub, 3 mul, 2 add) plus a compare, on the FP32 CUDA cores (K=3 is far
// too shallow for the tensor cores); the bytes are O(B*(N+M)). The design
// keeps every operand on chip: one thread per point of a holds it in
// registers, and b streams through shared memory in structure-of-arrays
// chunks, so each distance costs two shared-memory broadcast reads per
// coordinate pair and no device-memory traffic.
//
// Exactness: the distance is (dx*dx + dy*dy) + dz*dz with round-to-nearest
// intrinsics, so nvcc cannot contract it into FMAs and the result is
// bit-identical to the plain PyTorch version (ops/chamfer.py nearest_plain),
// which computes the same expression one elementwise op at a time. A strict
// '<' over increasing j keeps the first index on ties, as torch.min does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // points of a per block
constexpr int kChunk = 1024;   // points of b per shared-memory chunk (12 KB)

__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ dist, int64_t* __restrict__ idx, int n, int m) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];

  const int batch = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;  // tail threads still help load b
  const float* ap = a + ((int64_t)batch * n + (active ? i : 0)) * 3;
  const float ax = ap[0], ay = ap[1], az = ap[2];
  const float* bb = b + (int64_t)batch * m * 3;

  float best = CUDART_INF_F;
  int best_j = 0;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int len = min(kChunk, m - j0);
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float* p = bb + (int64_t)(j0 + t) * 3;
      sx[t] = p[0];
      sy[t] = p[1];
      sz[t] = p[2];
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float dx = __fsub_rn(ax, sx[t]);
      const float dy = __fsub_rn(ay, sy[t]);
      const float dz = __fsub_rn(az, sz[t]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_j = j0 + t;
      }
    }
    __syncthreads();
  }
  if (active) {
    dist[(int64_t)batch * n + i] = best;
    idx[(int64_t)batch * n + i] = best_j;
  }
}

}  // namespace

extern "C" {

// a (B, N, 3), b (B, M, 3) contiguous f32 on the current device; dist (B, N)
// f32 and idx (B, N) int64 are written. Launches on `stream` and returns the
// launch's cudaError_t (0 on success) without synchronising.
int chamfer_nearest_launch(const float* a, const float* b, float* dist, int64_t* idx,
                           int batch, int n, int m, cudaStream_t stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  nearest_kernel<<<grid, kThreads, 0, stream>>>(a, b, dist, idx, n, m);
  return (int)cudaGetLastError();
}

const char* chamfer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
