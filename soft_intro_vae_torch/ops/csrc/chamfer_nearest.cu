// Chamfer nearest-neighbour search for Hopper (sm_90a), both directions in
// one pass.
//
// Replaces the Pallas TPU kernel soft_intro_vae_tpu/ops/chamfer_pallas.py
// (_nearest -> _min_kernel): for clouds x (B, N, 3) and y (B, M, 3) in f32,
// one launch returns, per batch element,
//   min_x, amin_x (B, N): for every point of x, the squared distance to its
//                         nearest point of y and that point's index;
//   min_y, amin_y (B, M): the same for every point of y over x;
// lowest index on ties, as torch.min and the TPU kernel keep it. Every
// distance is computed once and serves both directions.
//
// What bounds it: operations. A pair costs 8 FP32 instructions (3 sub, 3
// mul, 2 add; no FMA, see Exactness) on the CUDA cores (K = 3 is far too
// shallow for the tensor cores); the bytes are O(B*(N+M)). At (32, 2048,
// 2048) that is 1.34e8 pairs, 0.032 ms at 132 SMs x 128 lanes x 1.98 GHz.
// What a pair costs beyond those 8 is what the design is about:
//   * rows: each thread holds R = 8 points of x in registers and the CTA
//     streams y through shared memory, so one shared-memory read of a point of
//     y serves R pairs (three 16-byte loads bring four points). Distances are
//     non-negative, so their bit patterns order as uint32, and a row folds two
//     points into its running minimum with one three-way integer min
//     (VIMNMX3). Its argmin is recovered lazily: at the end of every tile of
//     8 points of y a row notes the tile if its minimum fell in it, and after
//     the chunk it rescans that one tile for the first j with d == min. The
//     tile noted is the first in which the final minimum appeared (a strict
//     '<' over tiles in increasing j), so the rescan finds the lowest index.
//   * columns: a thread takes the minimum of its R distances to a point of y
//     (four three-way mins); the warp's minimum is one __reduce_min_sync on
//     the bits, and __ballot_sync gives the lanes holding it. Lane 0 stores
//     (bits, ballot) of the k-th point of a window of 32 in a small shared
//     buffer of its warp (no branch, no atomic); at the window's end lane k
//     folds (bits, the lowest such lane's first row) into its warp's 64-bit
//     key for point k. A lane's R rows are consecutive and lanes map to
//     increasing x, so the lowest lane holding the minimum holds the lowest
//     row attaining it; a key's low word breaks ties by row. After the
//     chunk, the least of the warps' keys names one lane's R rows, which are
//     rescanned for the first row with d == min. Every warp runs the same
//     number of x blocks (blocks past the end repeat row N - 1 at a higher
//     index), so every branch around the warp-wide instructions is uniform.
//   * filling the card: B*N = 65536 rows at R = 8 are 256 warps, two an SM,
//     so y is split too: a work item is (b, s), all of x against slice s of
//     y (S slices a batch element). Its columns are then complete within the
//     CTA and written at once; its rows see only the slice, and their (bits,
//     j) keys go to a scratch array (B, S, N) in device memory. The launch is
//     cooperative: every CTA is resident, each takes items in turn, and after
//     a grid-wide barrier the CTAs take the min over s of each row's keys. At
//     (32, 2048, 2048): S = 8, 256 items of 8 warps, 256 CTAs on 132 SMs, two
//     resident an SM (16 warps). A thread-block cluster per batch element,
//     its row keys meeting in distributed shared memory, was measured first:
//     the card holds fewer clusters of 8 such CTAs at once than the 32 batch
//     elements need (the SMs of a GPC do not divide into clusters evenly;
//     chamfer_max_active_clusters counts them), so it ran in two waves.
//   * staging: a chunk of a slice (at most 4096 points) is copied into shared
//     memory with one 1-D bulk copy (cp.async.bulk on an mbarrier) where its
//     bytes are 16-byte aligned (M % 4 == 0, and the wrapper hands over a
//     16-byte aligned y), else with scalar loads; slices longer than a chunk
//     are streamed. Shared memory holds the chunk (12 bytes a point) and each
//     warp's column keys of it (8 bytes a point a warp).
//
// Exactness: the distance is (dx*dx + dy*dy) + dz*dz, dx = x - y, with
// round-to-nearest intrinsics, so nvcc cannot contract it into FMAs and every
// distance has the bits of the plain PyTorch version (ops/chamfer.py
// nearest_pair_plain). Every reduction is a minimum, exact in any order, and
// the keys break ties by index, so two launches give the same bits. Inputs
// are finite; a NaN distance is not ordered as torch.min orders it.
//
// The launch plan comes from ops/chamfer_cuda.py ``plan``; this file checks it
// and launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// the same numbers as ops/chamfer_cuda.py's plan
constexpr int kRows = 8;   // R: points of x a thread holds
constexpr int kTile = 8;   // points of y per row-argmin tile
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxChunk = 4096;     // points of y staged at once
constexpr int kBlockSmem = 232448;  // shared memory one CTA may use on sm_90
constexpr int kStaticSmem = 4096;   // bound on the kernel's static shared memory
constexpr int kMaxDynamicSmem = kBlockSmem - kStaticSmem;
constexpr uint32_t kBulkChunk = 32768;  // bytes per bulk copy instruction
constexpr unsigned long long kEmpty = ~0ull;

// The launch plan (ops/chamfer_cuda.py Plan).
struct Plan {
  int warps;   // W: warps per CTA, each on x blocks of 32*R rows in turn
  int slices;  // S: slices of y a batch element; a work item is (b, s)
  int slice;   // points of y a slice
  int chunk;   // points of y staged at once
  int bulk;    // 1: bulk copies, 0: scalar loads
  int smem;    // dynamic shared bytes
  int grid;    // CTAs, all resident (cooperative launch)
};

struct Geom {
  int batch, n, m, slices, slice, chunk, bulk;
};

// ---- PTX helpers: mbarrier and 1-D bulk copy (as in bias_act_norm.cu) ------

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

// ---- the distance and the keys ----------------------------------------------

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ uint32_t sqdist_bits(float ax, float ay, float az, float bx, float by,
                                                float bz) {
  return __float_as_uint(sqdist(ax, ay, az, bx, by, bz));
}

// (distance bits, index): the minimum key is the least distance, lowest index
__device__ __forceinline__ unsigned long long pack(uint32_t bits, uint32_t index) {
  return ((unsigned long long)bits << 32) | index;
}

// min(min(a, b), c): one VIMNMX3 on sm_90
__device__ __forceinline__ uint32_t min3(uint32_t a, uint32_t b, uint32_t c) {
  return min(min(a, b), c);
}

// A thread's R points of x and their minima over the chunk so far.
struct Rows {
  float x[kRows], y[kRows], z[kRows];
  uint32_t best[kRows];  // running minimum, as bits
  uint32_t seen[kRows];  // the minimum at the end of the last tile
  int tile[kRows];       // the tile in which `seen` was reached
};

// The warp's minimum over the thread's R distances to the k-th point of the
// window, and the lanes holding it, stored by lane 0 in the warp's window
// buffer.
__device__ __forceinline__ void column(uint2* window, const uint32_t (&d)[kRows], int k,
                                       int lane) {
  const uint32_t bits = min3(min3(d[0], d[1], d[2]), min3(d[3], d[4], d[5]), min(d[6], d[7]));
  const uint32_t m = __reduce_min_sync(0xffffffffu, bits);
  const uint32_t lanes = __ballot_sync(0xffffffffu, bits == m);
  if (lane == 0) window[k] = make_uint2(m, lanes);
}
static_assert(kRows == 8, "column's minimum is written out for R = 8");

// One point of y, the k-th of its window, against the thread's rows.
__device__ __forceinline__ void visit(Rows& w, uint2* window, float px, float py, float pz, int k,
                                      int lane) {
  uint32_t d[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    d[r] = sqdist_bits(w.x[r], w.y[r], w.z[r], px, py, pz);
    w.best[r] = min(w.best[r], d[r]);
  }
  column(window, d, k, lane);
}

// Two points, the k-th and (k+1)-th of the window: a row folds both into its
// minimum with one three-way min.
__device__ __forceinline__ void visit2(Rows& w, uint2* window, float ax, float ay, float az,
                                       float bx, float by, float bz, int k, int lane) {
  uint32_t da[kRows], db[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    da[r] = sqdist_bits(w.x[r], w.y[r], w.z[r], ax, ay, az);
    db[r] = sqdist_bits(w.x[r], w.y[r], w.z[r], bx, by, bz);
    w.best[r] = min3(w.best[r], da[r], db[r]);
  }
  column(window, da, k, lane);
  column(window, db, k + 1, lane);
}

// Folds a window's `count` column minima into the warp's keys for its points
// (col: the window's first point): lane k takes point k. The lowest lane
// holding the minimum holds the lowest row: lanes take consecutive runs of R
// rows.
__device__ __forceinline__ void flush(const uint2* window, unsigned long long* col, int count,
                                      uint32_t warp_row, int lane) {
  __syncwarp();
  const uint2 v = window[lane];
  __syncwarp();  // read before the next window overwrites it
  if (lane < count) {
    const unsigned long long key = pack(v.x, warp_row + (uint32_t)(__ffs(v.y) - 1) * kRows);
    if (key < col[lane]) col[lane] = key;
  }
}

// Notes the tile if a row's minimum fell in it: strict '<', tiles in order.
__device__ __forceinline__ void note_tile(Rows& w, int tile) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (w.best[r] < w.seen[r]) {
      w.seen[r] = w.best[r];
      w.tile[r] = tile;
    }
  }
}

// The 8 points of a full tile from sy: three 16-byte loads bring four points.
__device__ __forceinline__ void visit_tile(Rows& w, uint2* window, const float* sy, int t0,
                                           int lane) {
  const float4* p = reinterpret_cast<const float4*>(sy + t0 * 3);
  const int k0 = t0 & 31;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 a = p[3 * q], e = p[3 * q + 1], f = p[3 * q + 2];
    visit2(w, window, a.x, a.y, a.z, a.w, e.x, e.y, k0 + 4 * q, lane);
    visit2(w, window, e.z, e.w, f.x, f.y, f.z, f.w, k0 + 4 * q + 2, lane);
  }
}

// ---- the kernel ---------------------------------------------------------------

// All of x against one chunk of y (points c0 .. c0 + len of the batch
// element, staged at sy): the chunk's column minima and argmins are written,
// and each row's (bits, j) key over the chunk is folded into keys (written
// where `first_chunk`).
__device__ __forceinline__ void chunk_pass(const float* __restrict__ xb, const float* sy,
                                           unsigned long long* col, uint2* windows,
                                           unsigned long long* keys, float* __restrict__ min_y,
                                           int64_t* __restrict__ amin_y, int n, int c0, int len,
                                           int chunk, bool first_chunk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int block_rows = 32 * kRows;
  // the same count of x blocks for every warp, so that every branch around
  // the warp-wide reductions is uniform; blocks past the end repeat row n - 1
  const int iters = (n + warps * block_rows - 1) / (warps * block_rows);
  unsigned long long* wcol = col + warp * chunk;
  uint2* window = windows + warp * 32;
  for (int it = 0; it < iters; ++it) {
    const int blk = (it * warps + warp) * block_rows;
    const int first = blk + lane * kRows;
    Rows w;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // rows past the end repeat the last point: its distances, at a higher
      // index, never win a tie, and they are not written
      const int i = min(first + r, n - 1);
      w.x[r] = xb[i * 3];
      w.y[r] = xb[i * 3 + 1];
      w.z[r] = xb[i * 3 + 2];
      w.best[r] = w.seen[r] = 0xffffffffu;  // above every distance's bits
      w.tile[r] = 0;
    }
    int t0 = 0;
    for (; t0 + kTile <= len; t0 += kTile) {
      visit_tile(w, window, sy, t0, lane);
      note_tile(w, t0 / kTile);
      if ((t0 & 31) + kTile == 32) flush(window, wcol + t0 + kTile - 32, 32, blk, lane);
    }
    if (t0 < len) {  // a ragged last tile
      for (int q = t0; q < len; ++q)
        visit(w, window, sy[q * 3], sy[q * 3 + 1], sy[q * 3 + 2], q & 31, lane);
      note_tile(w, t0 / kTile);
    }
    if (len & 31) flush(window, wcol + (len & ~31), len & 31, blk, lane);

    // each row's argmin: the first j of its noted tile with d == min
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (first + r >= n) continue;
      const int j1 = min(w.tile[r] * kTile + kTile, len);
      int j = w.tile[r] * kTile;
      while (j < j1 - 1 && sqdist_bits(w.x[r], w.y[r], w.z[r], sy[j * 3], sy[j * 3 + 1],
                                       sy[j * 3 + 2]) != w.best[r])
        ++j;
      const unsigned long long key = pack(w.best[r], (uint32_t)(c0 + j));
      if (first_chunk || key < keys[first + r]) keys[first + r] = key;
    }
  }
  __syncthreads();

  // each column of the chunk: the least of the warps' keys names one lane's
  // R rows; the first of them with d == min is the argmin
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    unsigned long long key = col[q];
    for (int v = 1; v < warps; ++v) {
      const unsigned long long k = col[v * chunk + q];
      if (k < key) key = k;
    }
    const uint32_t bits = (uint32_t)(key >> 32);
    const int i0 = min((int)(uint32_t)key, n - 1);
    const int i1 = min(i0 + kRows, n);
    const float px = sy[q * 3], py = sy[q * 3 + 1], pz = sy[q * 3 + 2];
    int i = i0;
    while (i < i1 - 1 && sqdist_bits(xb[i * 3], xb[i * 3 + 1], xb[i * 3 + 2], px, py, pz) != bits)
      ++i;
    min_y[c0 + q] = __uint_as_float(bits);
    amin_y[c0 + q] = i;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 2)
nearest_pair_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ min_x, int64_t* __restrict__ amin_x,
                    float* __restrict__ min_y, int64_t* __restrict__ amin_y,
                    unsigned long long* row_keys, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ uint2 windows[kMaxWarps * 32];  // each warp's window of column minima
  const int warps = blockDim.x >> 5;
  const int n = g.n;
  // shared memory: the chunk, (x, y, z) a point; each warp's column keys of it
  float* sy = reinterpret_cast<float*>(smem);
  unsigned long long* col =
      reinterpret_cast<unsigned long long*>(smem + (g.chunk * 12 + 15) / 16 * 16);

  if (g.bulk && threadIdx.x == 0) mbar_init(&bar, 1);
  int phase = 0;
  const int items = g.batch * g.slices;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int64_t b = item / g.slices;
    const int s0 = (item % g.slices) * g.slice;
    const int s1 = min(g.m, s0 + g.slice);
    const float* xb = x + b * n * 3;
    const float* yb = y + b * g.m * 3;
    unsigned long long* keys = row_keys + (int64_t)item * n;  // (B, S, N)
    for (int c0 = s0; c0 < s1; c0 += g.chunk, ++phase) {
      const int len = min(g.chunk, s1 - c0);
      __syncthreads();  // the last chunk's readers are done; the barrier is set up
      if (g.bulk) {
        if (threadIdx.x == 0) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const uint32_t bytes = (uint32_t)len * 12;
          mbar_expect_tx(&bar, bytes);
          const char* from = reinterpret_cast<const char*>(yb + (int64_t)c0 * 3);
          char* to = reinterpret_cast<char*>(sy);
          for (uint32_t off = 0; off < bytes; off += kBulkChunk)
            bulk_load(to + off, from + off, min(kBulkChunk, bytes - off), &bar);
        }
      } else {
        for (int i = threadIdx.x; i < len * 3; i += blockDim.x) sy[i] = yb[(int64_t)c0 * 3 + i];
      }
      for (int i = threadIdx.x; i < warps * len; i += blockDim.x)
        col[(i / len) * g.chunk + i % len] = kEmpty;
      if (g.bulk) mbar_wait(&bar, phase & 1);
      __syncthreads();
      chunk_pass(xb, sy, col, windows, keys, min_y + b * g.m, amin_y + b * g.m, n, c0, len,
                 g.chunk, c0 == s0);
    }
  }

  // rows: every slice's key of a row, once every item is done
  cg::this_grid().sync();
  const int64_t rows = (int64_t)g.batch * n;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = r / n;
    const unsigned long long* k = row_keys + b * g.slices * n + (r - b * n);
    unsigned long long key = k[0];
    for (int s = 1; s < g.slices; ++s)
      if (k[(int64_t)s * n] < key) key = k[(int64_t)s * n];
    min_x[r] = __uint_as_float((uint32_t)(key >> 32));
    amin_x[r] = (uint32_t)key;
  }
}

// ---- host side: check the plan, launch ---------------------------------------

int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// true when the plan does not describe a launch this kernel can run
bool bad_plan(int batch, int n, int m, const Plan& p) {
  if (batch <= 0 || n <= 0 || m <= 0) return true;
  if (p.warps < 1 || p.warps > kMaxWarps) return true;
  // every slice holds some of y
  if (p.slices < 1 || p.slice < 1 || (int64_t)p.slice * p.slices < m ||
      (int64_t)p.slice * (p.slices - 1) >= m)
    return true;
  if (p.chunk < 1 || p.chunk > kMaxChunk || p.chunk > p.slice) return true;
  if (p.bulk != 0 && (p.bulk != 1 || m % 4 != 0 || p.slice % 4 != 0 || p.chunk % 4 != 0))
    return true;
  if (p.grid < 1 || (int64_t)p.grid > (int64_t)batch * p.slices) return true;
  const int64_t need = round16((int64_t)p.chunk * 12) + 8 * (int64_t)p.chunk * p.warps;
  return p.smem < need || p.smem > kMaxDynamicSmem;
}

}  // namespace

extern "C" {

// x (B, N, 3), y (B, M, 3) contiguous f32 on the current device, y 16-byte
// aligned when the plan stages with bulk copies; min_x (B, N) f32, amin_x
// (B, N) int64, min_y (B, M) f32, amin_y (B, M) int64 are written; row_keys
// is scratch of B*S*N 64-bit keys. warps..grid: the launch plan of
// ops/chamfer_cuda.py ``plan``, checked here; a grid that cannot be resident
// at once is refused by the cooperative launch. Launches on `stream` and
// returns the launch's cudaError_t (0 on success) without synchronising.
int chamfer_nearest_pair(const float* x, const float* y, float* min_x, int64_t* amin_x,
                         float* min_y, int64_t* amin_y, unsigned long long* row_keys, int batch,
                         int n, int m, int warps, int slices, int slice, int chunk, int bulk,
                         int smem, int grid, cudaStream_t stream) {
  const Plan p{warps, slices, slice, chunk, bulk, smem, grid};
  if (bad_plan(batch, n, m, p) || row_keys == nullptr) return (int)cudaErrorInvalidValue;
  if (bulk && reinterpret_cast<uintptr_t>(y) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (p.smem + kStaticSmem > 48 * 1024) {  // beyond the default limit, with the static share
    const cudaError_t e = cudaFuncSetAttribute(
        nearest_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Geom g{batch, n, m, slices, slice, chunk, bulk};
  const cudaError_t e = cudaLaunchKernelEx(&cfg, nearest_pair_kernel, x, y, min_x, amin_x, min_y,
                                           amin_y, row_keys, g);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// How many thread-block clusters of `cluster` CTAs of this kernel's shape
// (warps, smem) the current card holds at once (cudaOccupancyMaxActiveClusters),
// written to *count; returns the cudaError_t. It measures why the kernel does
// not give each batch element a cluster (see the header).
int chamfer_max_active_clusters(int warps, int smem, int cluster, int* count) {
  if (smem + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nearest_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, nearest_pair_kernel, &cfg);
}

const char* chamfer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
