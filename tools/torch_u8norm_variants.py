#!/usr/bin/env python3
"""Device time of u8norm kernel designs on the GPU, against the bound.

    python3 tools/torch_u8norm_variants.py [--root DIR]

Builds one library of u8norm designs (the source is below, written into the
checkout's ``soft_intro_vae_torch/_build/``) and times each, queued behind a
sleep kernel (``tools/torch_norm_sites.py device_ms``), at the CIFAR-10
batch (32, 32, 32, 3) and a celeb256 batch (32, 256, 256, 3), in turns (each
design twice, in order and in reverse), beside the package's own kernel
(``ops/u8norm_cuda.py``: ``word4 table`` at 128 threads, so that
configuration is timed once, as the package kernel) and the chain
``x.float().div(255)``. Every design
is first held bit-equal to ``ops/u8norm.py``'s plain version at both shapes
and at a slice 4 bytes off a 16-byte boundary (the designs store the
output's vectors as 128-bit words: a head of 12 keeps them aligned). The designs, each 16 input
bytes a thread an iteration of a grid-stride loop, differ in

  * the load/store pattern: ``vec16``, one 128-bit load a thread and four
    128-bit stores to the thread's 64 contiguous output bytes; ``word4``,
    four 32-bit loads a grid stride apart and four 128-bit stores, so that
    both each warp's loads and its stores are contiguous;
  * the divide: ``fdiv``, ``__fdiv_rn`` for each byte; ``table``, a 256-entry
    table in shared memory that each block fills with ``__fdiv_rn`` first;

and in the threads a block (64, 128 or 256). Prints the card's name and power
limit, one line a design and shape, then one JSON line. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float unit(unsigned b) { return __fdiv_rn(__uint2float_rn(b), 255.0f); }

template <bool kTable>
__device__ __forceinline__ float4 four(const float* table, unsigned w) {
  if (kTable) {
    return make_float4(table[w & 0xffu], table[(w >> 8) & 0xffu], table[(w >> 16) & 0xffu],
                       table[w >> 24]);
  }
  return make_float4(unit(w & 0xffu), unit((w >> 8) & 0xffu), unit((w >> 16) & 0xffu),
                     unit(w >> 24));
}

template <bool kTable>
__device__ __forceinline__ void fill(float* table) {
  if (kTable) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) table[i] = unit(i);
    __syncthreads();
  }
}

template <bool kTable>
__global__ void vec16(const uint8_t* __restrict__ x, float* __restrict__ y, long long head,
                      long long vectors, long long tail) {
  __shared__ float table[256];
  fill<kTable>(table);
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
  for (long long v = first; v < vectors; v += stride) {
    const uint4 q = __ldg(xv + v);
    yv[4 * v] = four<kTable>(table, q.x);
    yv[4 * v + 1] = four<kTable>(table, q.y);
    yv[4 * v + 2] = four<kTable>(table, q.z);
    yv[4 * v + 3] = four<kTable>(table, q.w);
  }
  if (first < head) y[first] = unit(x[first]);
  if (first < tail) y[head + 16 * vectors + first] = unit(x[head + 16 * vectors + first]);
}

template <bool kTable>
__global__ void word4(const uint8_t* __restrict__ x, float* __restrict__ y, long long head,
                      long long vectors, long long tail) {
  __shared__ float table[256];
  fill<kTable>(table);
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned* xw = reinterpret_cast<const unsigned*>(x + head);
  float4* yv = reinterpret_cast<float4*>(y + head);
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
      if (i < words) yv[i] = four<kTable>(table, w[k]);
    }
  }
  if (first < head) y[first] = unit(x[first]);
  if (first < tail) y[head + 16 * vectors + first] = unit(x[head + 16 * vectors + first]);
}

}  // namespace

extern "C" int u8norm_variant(int variant, const uint8_t* x, float* y, long long head,
                              long long vectors, long long tail, int grid, int threads,
                              cudaStream_t stream) {
  switch (variant) {
    case 0: vec16<false><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail); break;
    case 1: vec16<true><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail); break;
    case 2: word4<false><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail); break;
    case 3: word4<true><<<grid, threads, 0, stream>>>(x, y, head, vectors, tail); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

VARIANTS = ("vec16 fdiv", "vec16 table", "word4 fdiv", "word4 table")
SHAPES = ((32, 32, 32, 3), (32, 256, 256, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose soft_intro_vae_torch is used")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_u8norm_variants: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from soft_intro_vae_torch.ops import cuda_build, u8norm, u8norm_cuda
    from tools.torch_norm_sites import device_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "u8norm_variants.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    lib = ctypes.CDLL(cuda_build.build_many([(src, "u8norm_variants", ())])[0])
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.u8norm_variant.argtypes = [i, p, p, ll, ll, ll, i, i, p]
    lib.u8norm_variant.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launcher(variant, threads, x):
        n = x.numel()
        plan = u8norm_cuda.plan(n, x.data_ptr() % 16, sms)
        grid = min(-(-max(plan.vectors, plan.head, plan.tail) // threads),
                   u8norm_cuda.BLOCKS_PER_SM * sms)

        def run():
            y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            err = lib.u8norm_variant(variant, x.data_ptr(), y.data_ptr(), plan.head, plan.vectors,
                                     plan.tail, grid, threads, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {variant} launch failed: {err}")
            return y.permute(0, 3, 1, 2)

        return run

    gen = torch.Generator(device="cuda").manual_seed(3)
    # the package kernel is word4 table x128 (ops/csrc/u8norm.cu, u8norm_cuda.THREADS)
    configs = [(v, t) for v in range(len(VARIANTS)) for t in (64, 128, 256)
               if (VARIANTS[v], t) != ("word4 table", u8norm_cuda.THREADS)]
    results = {}
    for shape in SHAPES:
        n = 1
        for d in shape:
            n *= d
        x = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
        off = torch.randint(0, 256, (n + 16,), generator=gen, device="cuda",
                            dtype=torch.uint8)[4:n + 4].view(shape)
        for v, t in configs:
            for inp in (x, off):
                got = launcher(v, t, inp)()
                torch.cuda.synchronize()
                want = u8norm.u8_to_unit_nchw_plain(inp)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    print(f"FAIL: {VARIANTS[v]} x{t} differs from the plain version at {shape}")
                    return 1
        runs = {f"{VARIANTS[v]} x{t}": [] for v, t in configs}
        runs["package kernel"] = []
        runs["chain x.float().div(255)"] = []
        order = [(f"{VARIANTS[v]} x{t}", launcher(v, t, x)) for v, t in configs]
        order += [("package kernel", lambda: u8norm_cuda.u8_to_unit_nchw_cuda(x)),
                  ("chain x.float().div(255)", lambda: x.float().div(255))]
        for name, fn in order + order[::-1]:
            runs[name].append(device_ms(fn))
        bound = 5 * n / 3.35e12 * 1e3
        results[str(shape)] = {"bound_ms": bound, "ms": runs}
        for name, ms in runs.items():
            mean = sum(ms) / len(ms)
            print(f"{shape} {name:28s} {ms[0]:.5f}/{ms[1]:.5f} ms, {bound / mean:6.1%} of the "
                  f"{bound:.5f} ms bound")
    print(json.dumps({"card": card, "shapes": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
