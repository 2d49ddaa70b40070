// Fused bias + leaky ReLU + instance norm (+ AdaIN) for Hopper (sm_90a),
// forward and backward, on channels-last tensors.
//
// Replaces the Pallas TPU kernels of soft_intro_vae_tpu/ops/adain_pallas.py:
// _fwd_pallas (the forward) and _bwd_pallas (the backward of its custom VJP),
// which work on the JAX package's NHWC layout, as these do.
// Layout NHWC: x is a channels-last (B, C, H, W) tensor, (B, H, W, C) in
// memory, so an image is S = H*W pixels of C contiguous channels and a (b, c)
// plane is S elements strided by C; n is (B, H, W); bias and nw are (C,); g,
// bst, mean, var and every per-plane gradient are (B, C) f32. x, y, dy and dx
// are f32 or bf16; all arithmetic is f32.
//
// Forward, per plane:
//   e   = leaky_relu(x + inject + bias, slope), inject = 0 (plain),
//         nw*n (noise) or ks*exp(x*x*c2) (corr, ks = 0.8*s/sqrt(2 pi),
//         c2 = -1/(2 s^2))
//   m   = mean(e), v = max(mean(e^2) - m^2, 0)          (one-pass moments,
//         taken about e0, e at the image's first pixel: d = mean(e - e0),
//         m = e0 + d, v = max(mean((e - e0)^2) - d^2, 0))
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
// one write of every output, and that is what the design does.
//
// The design. A plane's sums need every pixel of its image, and the style
// model's top site holds 8 MB of bf16 an image (64 channels of 256x256),
// against 227 KB of shared memory a CTA. So an image is cut into T tiles of P
// whole pixels, a contiguous run of P*C elements each, and the launch runs
// 2*B*T CTAs, a sums and an apply item a tile. An item streams its tile
// through a ring of two slots of shared memory, a chunk of up to 32 KB a
// slot, staged with 1-D bulk copies (cp.async.bulk, the TMA's non-tensor
// form) that complete on the slot's mbarrier, the next chunk's copies in
// flight while the CTA works on the current one:
//   * a sums item takes its tile's per-channel sums (a thread owns a unit of
//     4 channels, 16 bytes of f32 or 8 of bf16, and walks the chunk's pixels,
//     R threads a unit; the R threads' sums are added in row order through
//     shared memory) and writes them to a partial-sums row of global memory.
//     It counts itself done for its image; the image's last sums item adds
//     the T rows in tile order, writes the plane statistics (mean and var;
//     sdy and sde in the backward) and raises the image's ready flag;
//   * an apply item waits for the flag and writes y (dx) from its staged
//     chunks. The backward's apply items then write their tiles' sums of dp
//     and dp*n, which the image's last one adds in tile order into d_bias
//     and d_nw.
// Items take tickets (an atomic counter), so they start in ticket order:
// sums(0), then sums(b) and apply(b - 1) for b = 1..B-1, then apply(B - 1).
// An apply item waits only for sums items of lower tickets, which never wait,
// so no launch can deadlock, whatever the card holds at once; and an image's
// sums are complete, as a rule, one image of items before its apply items
// start, so the wait is short. The noise plane n is read once a pixel for all
// its channels (each chunk's run staged beside it). The activation e is never
// stored; it is recomputed from the staged x in both items.
//
// What it costs: x (and dy) are read twice, once an item. The second read
// comes from L2 only where the tile is still there: y and dx are stored with
// the evict-first hint and the bulk copies carry L2 hints (a sums item's tile
// evict-last, an apply item's evict-first), but at the sites of 8 and 4 MB an
// image most of it comes from device memory again, since between a tile's
// two reads the ~400 CTAs in flight move more than L2 holds. Measured on the
// card at the top site in bf16: 59% of the byte bound forward, 54% backward,
// and 74% with the second read left out. Tiles of 256 KB pay a CTA's fixed
// costs (the ticket, the barriers, the counters) once for eight chunks. A
// design that holds each tile in shared memory until its image's sums are
// known reads x once, but an image of the top site takes up to two thirds of
// the card's shared memory, and its tiles' wait for the image left the card
// idle: slower, measured. So did persistent CTAs taking items in turn.
//
// The counters are int32 in a buffer the caller zeroes once: the ticket, the
// epoch (launches so far), and per image done, ready and done2. The CTA that
// takes the last ticket resets the ticket and moves the epoch on; an image's
// last sums item resets done and stamps ready with the launch's epoch + 1,
// which no other launch writes, so ready needs no reset; the backward's last
// apply item resets done2. So launches on one stream share the buffer with no
// memset; two launches must not use it at once (ops/adain_cuda.py keeps one
// buffer a stream). A wait that never ends traps after ~2^26 polls instead of
// hanging the card.
//
// 256 threads a CTA and 3 CTAs an SM (__launch_bounds__; two 32-KB slots and
// the sums' scratch a CTA). The launch plan, one per (B, C, S, dtype,
// direction, SMs), comes from ops/adain_cuda.py ``plan``; this file checks it
// and launches.
//
// The forward takes its moments about e0, e at the image's first pixel (read
// by every CTA of the image, so all shift alike), as ops/adain.py's
// bias_act_norm_plain does: a plane of equal values, as the generator's first
// block sees in its expanded const, then gives m = e0 and v = 0 exactly,
// where summed as they are (a long sum of equal values rounds) e - m would be
// a rounding residue times rsqrt(eps) = 1e4; and a plane whose mean is large
// against its spread loses less of v to the cancellation E[e^2] - m^2.
//
// Rounding: the producer (inject, bias, leaky ReLU) uses round-to-nearest
// intrinsics in the plain version's order, so nvcc cannot contract it into
// FMAs and `pre` has the plain version's bits: the leaky ReLU's branch (and
// its derivative, 1 or slope) is then taken on the same side as in
// ops/adain.py's bias_act_norm_plain. Every sum runs in a fixed order (a
// thread's pixels of a chunk in order, its chunks in order, a unit's threads
// in row order four at a time pairwise, tiles in fixed groups eight at a time
// pairwise) and no float atomics are used, so two launches on the same inputs give the
// same bits. Sums are taken in another order than PyTorch's, so m, v, y and
// the gradients agree with the plain version to a tolerance, not bit for
// bit. The chains of adds stay short (tens of adds at the style model's
// sites, not hundreds), because the one-pass variance E[e^2] - m^2 carries
// the sums' rounding into v at the ratio m^2 / v, which the nets'
// activations make large on some planes. expf and rsqrtf (no
// --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the same numbers as ops/adain_cuda.py's plan
constexpr int kMaxThreads = 256;
constexpr int kCtasPerSm = 3;          // __launch_bounds__
constexpr int kBlockSmem = 232448;     // shared memory one CTA may use on sm_90
constexpr int kStaticSmem = 1024;      // bound on the kernels' static shared memory
constexpr int kMaxDynamicSmem = kBlockSmem - kStaticSmem;
constexpr int kMaxImages = 65536;
constexpr int kUnit = 4;               // channels a thread takes a step (vector plans)
constexpr uint32_t kBulkChunk = 32768;  // bytes per bulk copy instruction
constexpr uint32_t kMaxPolls = 1u << 26;

enum Mode { kPlain = 0, kNoise = 1, kCorr = 2 };

struct Consts {
  float eps;
  float slope;
  float corr_ks;      // 0.8 * s / sqrt(2 pi)
  float corr_c2;      // -0.5 / s^2
  float corr_inv_s2;  // 1 / s^2
};

// The launch plan (ops/adain_cuda.py Plan).
struct Plan {
  int unit;     // channels a thread takes a step: 4, or 1
  int rows;     // R: threads a unit
  int threads;  // R * C / unit
  int chunk;    // pixels a chunk: a slot of the ring
  int pixels;   // P: pixels a tile
  int tiles;    // T: tiles an image
  int smem;     // dynamic shared bytes
  int grid;     // CTAs: 2 * B * T, a sums and an apply item a tile
};

struct Geom {
  int images, channels, size;
  int units, rows, chunk, pixels, tiles;
};

// What a CTA works on: its ticket's item.
struct Item {
  bool apply;   // the apply item of its tile, else the sums item
  int image;
  int tile;
  int count;    // pixels in the tile
  int64_t pix;  // global index of the tile's first pixel (image * S + first)
};

// ---- PTX helpers: mbarrier, 1-D bulk copy (TMA), flags --------------------

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

// L2 policies of the bulk copies: a sums item's tile is read again by its
// apply item (evict last); the apply item's read is the last (evict first)
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// ---- element access: a unit is 4 channels (16 bytes of f32, 8 of bf16) or one

template <int UNIT>
__device__ __forceinline__ void load_units(const float* p, float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    v[0] = p[0];
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

template <int UNIT>
__device__ __forceinline__ void load_units(const __nv_bfloat16* p, float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    v[0] = __bfloat162float(p[0]);
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// stores with the evict-first hint (st.global.cs)
template <int UNIT>
__device__ __forceinline__ void store_units(float* p, const float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    __stcs(p, v[0]);
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
}

template <int UNIT>
__device__ __forceinline__ void store_units(__nv_bfloat16* p, const float (&v)[UNIT]) {
  if constexpr (UNIT == 1) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v[0]);
    __stcs(reinterpret_cast<unsigned short*>(p), *reinterpret_cast<const unsigned short*>(&h));
  } else {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    __stcs(reinterpret_cast<uint2*>(p), q);
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

// e at the image's first pixel, channels c0.. c0 + UNIT - 1: the shift the
// forward takes its moments about, the same bits in every CTA of the image
template <typename T, int MODE, int UNIT>
__device__ __forceinline__ void first_pixel_e(const T* x, const float* noise, int image, int c0,
                                              const Geom& g, const float (&bias_c)[UNIT],
                                              const float (&nw_c)[UNIT], const Consts& k,
                                              float (&e0)[UNIT]) {
  float xv[UNIT];
  load_units<UNIT>(x + (int64_t)image * g.size * g.channels + c0, xv);
  const float n0 = MODE == kNoise ? noise[(int64_t)image * g.size] : 0.f;
#pragma unroll
  for (int j = 0; j < UNIT; ++j) e0[j] = leaky(pre_act<MODE>(xv[j], bias_c[j], nw_c[j], n0, k), k.slope);
}

// ---- tickets, staging, sums ------------------------------------------------

// The counters: flags[0] the ticket, flags[1] the epoch (launches so far),
// then done, ready and done2, kMaxImages each at fixed places, since ready
// keeps its stamps from launch to launch.
struct Flags {
  int* ticket;
  int* epoch;
  int* done;
  int* ready;
  int* done2;
};

__device__ __forceinline__ Flags flags_of(int* flags) {
  return Flags{flags, flags + 1, flags + 2, flags + 2 + kMaxImages, flags + 2 + 2 * kMaxImages};
}

// The CTA's item and the launch's epoch. Tickets are taken in order, so items
// start in order: sums(0), then sums(b) and apply(b - 1) for b = 1..B-1, then
// apply(B - 1), T tickets each. Every CTA reads the epoch before it takes its
// ticket; the CTA that takes the last ticket resets the ticket and moves the
// epoch on, for the next launch.
__device__ __forceinline__ Item take_item(const Geom& g, const Flags& f, int* s_ticket,
                                          int* s_epoch) {
  if (threadIdx.x == 0) {
    const int epoch = *reinterpret_cast<volatile int*>(f.epoch);
    __threadfence();
    const int t = atomicAdd(f.ticket, 1);
    if (t == (int)gridDim.x - 1) {
      __threadfence();
      atomicExch(f.ticket, 0);
      atomicAdd(f.epoch, 1);
    }
    *s_ticket = t;
    *s_epoch = epoch;
  }
  __syncthreads();
  const int ticket = *s_ticket;
  const int block = ticket / g.tiles;
  Item it;
  it.tile = ticket - block * g.tiles;
  if (block == 0) {
    it.apply = false;
    it.image = 0;
  } else if (block == 2 * g.images - 1) {
    it.apply = true;
    it.image = g.images - 1;
  } else {
    it.apply = (block & 1) == 0;
    it.image = it.apply ? block / 2 - 1 : (block + 1) / 2;
  }
  const int first = it.tile * g.pixels;
  it.count = min(g.pixels, g.size - first);
  it.pix = (int64_t)it.image * g.size + first;
  return it;
}

// elements between two staged arrays of a slot: a chunk's run, 16-byte aligned
template <typename T>
__device__ __forceinline__ int stage_pitch(const Geom& g) {
  constexpr int per16 = 16 / sizeof(T);
  return (g.chunk * g.channels + per16 - 1) / per16 * per16;
}

// The shared memory: two slots of a chunk's staged arrays and its noise run,
// then the sums' scratch.
template <typename T>
struct Smem {
  unsigned char* base;
  size_t slot_bytes;
  float* red;

  __device__ __forceinline__ T* staged(int slot) const {
    return reinterpret_cast<T*>(base + slot * slot_bytes);
  }
  __device__ __forceinline__ float* noise(int slot, int pitch, int arrays) const {
    return reinterpret_cast<float*>(base + slot * slot_bytes + (size_t)arrays * pitch * sizeof(T));
  }
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* smem, const Geom& g, int arrays) {
  Smem<T> s;
  s.base = smem;
  s.slot_bytes = (size_t)arrays * stage_pitch<T>(g) * sizeof(T) + (size_t)(g.chunk + 3) / 4 * 16;
  s.red = reinterpret_cast<float*>(smem + 2 * s.slot_bytes);
  return s;
}

// The pixels of chunk k of an item: [first, first + count) of its tile.
struct Chunk {
  int first;
  int count;
};

__device__ __forceinline__ Chunk chunk_of(const Geom& g, const Item& it, int k) {
  const int first = k * g.chunk;
  return Chunk{first, min(g.chunk, it.count - first)};
}

// whether a chunk's noise run goes by bulk copy (16-byte aligned and whole)
template <int MODE>
__device__ __forceinline__ bool noise_by_copy(const Item& it, const Chunk& c) {
  return MODE == kNoise && (it.pix + c.first) % 4 == 0 && c.count % 4 == 0;
}

// Thread 0 on vector plans: starts the copies of chunk k of the item (the N
// arrays' runs and, where it can, the noise run) into `slot` on its mbarrier.
template <typename T, int UNIT, int N, int MODE>
__device__ __forceinline__ void chunk_start(const Geom& g, const Item& it, int k, int slot,
                                            const Smem<T>& sm, int pitch, const T* const* src,
                                            const float* noise, uint64_t* bar, uint64_t policy) {
  if (UNIT == 1 || k * g.chunk >= it.count) return;
  const Chunk c = chunk_of(g, it, k);
  const bool by_copy = noise_by_copy<MODE>(it, c);
  const uint32_t bytes = (uint32_t)c.count * g.channels * sizeof(T);
  mbar_expect_tx(bar + slot, N * bytes + (by_copy ? c.count * 4 : 0));
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const char* from = reinterpret_cast<const char*>(src[a] + (it.pix + c.first) * g.channels);
    char* to = reinterpret_cast<char*>(sm.staged(slot) + a * pitch);
    for (uint32_t off = 0; off < bytes; off += kBulkChunk)
      bulk_load(to + off, from + off, min(kBulkChunk, bytes - off), bar + slot, policy);
  }
  if (by_copy)
    bulk_load(sm.noise(slot, pitch, N), noise + it.pix + c.first, c.count * 4, bar + slot, policy);
}

// Chunk k in `slot`, ready to read: what the copies could not bring (scalar
// plans: the arrays; an unaligned noise run), loaded by every thread; then the
// CTA waits for the slot's copies (its use k / 2, so parity (k / 2) % 2).
template <typename T, int UNIT, int N, int MODE>
__device__ __forceinline__ void chunk_wait(const Geom& g, const Item& it, int k, int slot,
                                           const Smem<T>& sm, int pitch, const T* const* src,
                                           const float* noise, uint64_t* bar) {
  const Chunk c = chunk_of(g, it, k);
  if constexpr (UNIT == 1) {
    const int64_t first = (it.pix + c.first) * g.channels;
    const int count = c.count * g.channels;
#pragma unroll
    for (int a = 0; a < N; ++a)
      for (int i = threadIdx.x; i < count; i += blockDim.x)
        sm.staged(slot)[a * pitch + i] = src[a][first + i];
  }
  if (MODE == kNoise && (UNIT == 1 || !noise_by_copy<MODE>(it, c))) {
    float* sn = sm.noise(slot, pitch, N);
    for (int i = threadIdx.x; i < c.count; i += blockDim.x) sn[i] = noise[it.pix + c.first + i];
  }
  __syncthreads();
  if constexpr (UNIT != 1) mbar_wait(bar + slot, (k >> 1) & 1);
}

// Thread 0: the ring's two mbarriers and the item's first two chunks.
template <typename T, int UNIT, int N, int MODE>
__device__ __forceinline__ void ring_start(const Geom& g, const Item& it, const Smem<T>& sm,
                                           int pitch, const T* const* src, const float* noise,
                                           uint64_t* bar, uint64_t policy) {
  if (threadIdx.x != 0) return;
  if (UNIT != 1) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
  }
  chunk_start<T, UNIT, N, MODE>(g, it, 0, 0, sm, pitch, src, noise, bar, policy);
  chunk_start<T, UNIT, N, MODE>(g, it, 1, 1, sm, pitch, src, noise, bar, policy);
}

// After chunk k is used: its slot takes chunk k + 2.
template <typename T, int UNIT, int N, int MODE>
__device__ __forceinline__ void ring_next(const Geom& g, const Item& it, int k, const Smem<T>& sm,
                                          int pitch, const T* const* src, const float* noise,
                                          uint64_t* bar, uint64_t policy) {
  __syncthreads();  // every thread is done with the slot
  if (threadIdx.x == 0)
    chunk_start<T, UNIT, N, MODE>(g, it, k + 2, k & 1, sm, pitch, src, noise, bar, policy);
}

template <int UNIT>
__device__ __forceinline__ void add_sums(float (&acc)[2][UNIT], const float (&part)[2][UNIT]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < UNIT; ++j) acc[k][j] += part[k][j];
}

// The tile's sums: acc[k][j] of thread (r, u) is sum k of channel u*UNIT + j
// over the thread's pixels. Adds the R threads of each unit in row order, four
// at a time pairwise, through `red` (2 * UNIT * threads floats) and writes value
// v = (k * UNIT + j) * U + u of the tile to row[v], 2C values.
template <int UNIT>
__device__ __forceinline__ void tile_sums(const float (&acc)[2][UNIT], float* red, float* row,
                                          const Geom& g) {
  const int nt = blockDim.x;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < UNIT; ++j) red[(k * UNIT + j) * nt + threadIdx.x] = acc[k][j];
  __syncthreads();
  const int nv = 2 * UNIT * g.units;
  for (int v = threadIdx.x; v < nv; v += nt) {
    const int kj = v / g.units;
    const int u = v - kj * g.units;
    const float* col = red + kj * nt + u;
    float s = 0.f;
    int r = 0;
    for (; r + 4 <= g.rows; r += 4)  // four rows pairwise, then into the sum
      s += (col[r * g.units] + col[(r + 1) * g.units]) +
           (col[(r + 2) * g.units] + col[(r + 3) * g.units]);
    for (; r < g.rows; ++r) s += col[r * g.units];
    row[v] = s;
  }
  __syncthreads();  // the row written (arrive's fence makes it visible first)
}

// Counts this CTA done at `counter` (one of T); true, in every thread, for the
// last of the T, which then sees what the others wrote before they counted.
__device__ __forceinline__ bool arrive(int* counter, int tiles, int* s_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the CTA's writes, before it counts itself done
    *s_last = atomicAdd(counter, 1) == tiles - 1;
  }
  __syncthreads();
  const bool last = *s_last != 0;
  if (last) __threadfence();
  return last;
}

template <int V>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// The image's sums: value v over its T tile rows (rows: T x nv floats), in a
// fixed order, into tot[v] (shared; at least max(nv, V * threads) floats). A
// thread adds V values at a time (V = 4: 16-byte loads); with fewer such
// quads than threads, G = threads / quads groups each add every G-th row, 8
// rows' loads in flight at once, added pairwise and then to the running sum,
// and the groups are added in order.
template <int V>
__device__ __forceinline__ void image_sums(const float* rows, int tiles, int nv, float* tot) {
  const int nt = blockDim.x;
  const int quads = nv / V;
  const int groups = quads >= nt ? 1 : nt / quads;
  for (int i = threadIdx.x; i < groups * quads; i += nt) {
    const int grp = i / quads;
    const int q = i - grp * quads;
    float s[V] = {};
    int t = grp;
    for (; t + 7 * groups < tiles; t += 8 * groups) {
      float v[8][V];
#pragma unroll
      for (int u = 0; u < 8; ++u) load_cg<V>(rows + (int64_t)(t + u * groups) * nv + q * V, v[u]);
#pragma unroll
      for (int j = 0; j < V; ++j)  // the 8 rows pairwise, then into the running sum
        s[j] += ((v[0][j] + v[1][j]) + (v[2][j] + v[3][j])) +
                ((v[4][j] + v[5][j]) + (v[6][j] + v[7][j]));
    }
    for (; t < tiles; t += groups) {
      float v[V];
      load_cg<V>(rows + (int64_t)t * nv + q * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += v[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) tot[i * V + j] = s[j];
  }
  __syncthreads();
  if (groups > 1 && threadIdx.x < quads) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float s = 0.f;
      for (int grp = 0; grp < groups; ++grp) s += tot[(grp * quads + threadIdx.x) * V + j];
      tot[threadIdx.x * V + j] = s;
    }
  }
  __syncthreads();
}

// sum k of channel c in a tot laid out as tile_sums' values
template <int UNIT>
__device__ __forceinline__ float total_of(const float* tot, int k, int c, int units) {
  const int u = c / UNIT;
  return tot[(k * UNIT + (c - u * UNIT)) * units + u];
}

// The image's last sums item: done reset, then ready stamped with the launch's
// epoch + 1 once every thread's writes are visible.
__device__ __forceinline__ void publish(int* done, int* ready, int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(done, 0);
    store_release(ready, epoch + 1);
  }
}

__device__ __forceinline__ void wait_ready(const int* ready, int epoch) {
  if (threadIdx.x == 0) {
    uint32_t polls = 0;
    while (load_acquire(ready) != epoch + 1) {
      if (++polls == kMaxPolls) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

// ---- the kernels -----------------------------------------------------------

template <typename T, int MODE, bool AFFINE, int UNIT>
__global__ void __launch_bounds__(kMaxThreads, kCtasPerSm)
fwd_kernel(const T* __restrict__ x, const float* __restrict__ bias, const float* __restrict__ g,
           const float* __restrict__ bst, const float* __restrict__ noise,
           const float* __restrict__ nw, T* __restrict__ y, float* __restrict__ mean,
           float* __restrict__ var, float* __restrict__ part, int* __restrict__ flags, Geom geo,
           Consts k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int s_ticket, s_epoch, s_last;
  const int ch = geo.channels;
  const Flags f = flags_of(flags);
  const Item it = take_item(geo, f, &s_ticket, &s_epoch);
  const int b = it.image;
  const int epoch = s_epoch;
  const Smem<T> sm = carve<T>(smem, geo, 1);
  const int pitch = stage_pitch<T>(geo);
  const T* src[1] = {x};
  const uint64_t policy = l2_policy(!it.apply);
  ring_start<T, UNIT, 1, MODE>(geo, it, sm, pitch, src, noise, bar, policy);
  const int chunks = (it.count + geo.chunk - 1) / geo.chunk;

  const int u = threadIdx.x % geo.units;
  const int r = threadIdx.x / geo.units;
  const int c0 = u * UNIT;
  float bias_c[UNIT], nw_c[UNIT];
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    bias_c[j] = bias[c0 + j];
    nw_c[j] = MODE == kNoise ? nw[c0 + j] : 0.f;
  }

  if (!it.apply) {
    // the tile's sums of e - e0 and (e - e0)^2, chunk by chunk
    float e0[UNIT];
    first_pixel_e<T, MODE, UNIT>(x, noise, b, c0, geo, bias_c, nw_c, k, e0);
    float acc[2][UNIT] = {};
    for (int q = 0; q < chunks; ++q) {
      chunk_wait<T, UNIT, 1, MODE>(geo, it, q, q & 1, sm, pitch, src, noise, bar);
      const T* xs = sm.staged(q & 1) + c0;
      const float* sn = sm.noise(q & 1, pitch, 1);
      const int count = chunk_of(geo, it, q).count;
      float cacc[2][UNIT] = {};  // the chunk's own sums: short chains of adds
      for (int p = r; p < count; p += geo.rows) {
        float xv[UNIT];
        load_units<UNIT>(xs + p * ch, xv);
        const float nv = MODE == kNoise ? sn[p] : 0.f;
#pragma unroll
        for (int j = 0; j < UNIT; ++j) {
          const float e = leaky(pre_act<MODE>(xv[j], bias_c[j], nw_c[j], nv, k), k.slope) - e0[j];
          cacc[0][j] += e;
          cacc[1][j] += e * e;
        }
      }
      add_sums<UNIT>(acc, cacc);
      ring_next<T, UNIT, 1, MODE>(geo, it, q, sm, pitch, src, noise, bar, policy);
    }
    tile_sums<UNIT>(acc, sm.red, part + ((int64_t)b * geo.tiles + it.tile) * 2 * ch, geo);
    // the image's last sums item adds the tiles' sums
    if (arrive(f.done + b, geo.tiles, &s_last)) {
      image_sums<UNIT>(part + (int64_t)b * geo.tiles * 2 * ch, geo.tiles, 2 * ch, sm.red);
      for (int c = threadIdx.x; c < ch; c += blockDim.x) {
        float e0c[1];
        const float one[1] = {bias[c]}, nwc[1] = {MODE == kNoise ? nw[c] : 0.f};
        first_pixel_e<T, MODE, 1>(x, noise, b, c, geo, one, nwc, k, e0c);
        const float d = total_of<UNIT>(sm.red, 0, c, geo.units) / (float)geo.size;
        mean[(int64_t)b * ch + c] = e0c[0] + d;
        var[(int64_t)b * ch + c] =
            fmaxf(total_of<UNIT>(sm.red, 1, c, geo.units) / (float)geo.size - d * d, 0.f);
      }
      publish(f.done + b, f.ready + b, epoch);
    }
    return;
  }

  // apply: y from the staged chunks
  float gc[UNIT], bc_[UNIT];
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    gc[j] = AFFINE ? g[(int64_t)b * ch + c0 + j] : 1.f;
    bc_[j] = AFFINE ? bst[(int64_t)b * ch + c0 + j] : 0.f;
  }
  wait_ready(f.ready + b, epoch);
  float a[UNIT], shift[UNIT];
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    const int64_t bc = (int64_t)b * ch + c0 + j;
    const float m = __ldcg(mean + bc);
    const float rstd = rsqrtf(__ldcg(var + bc) + k.eps);
    a[j] = AFFINE ? rstd * gc[j] : rstd;
    shift[j] = AFFINE ? bc_[j] - m * a[j] : -m * a[j];
  }
  for (int q = 0; q < chunks; ++q) {
    chunk_wait<T, UNIT, 1, MODE>(geo, it, q, q & 1, sm, pitch, src, noise, bar);
    const T* xs = sm.staged(q & 1) + c0;
    const float* sn = sm.noise(q & 1, pitch, 1);
    const Chunk c = chunk_of(geo, it, q);
    T* yg = y + (it.pix + c.first) * ch + c0;
    for (int p = r; p < c.count; p += geo.rows) {
      float xv[UNIT], out[UNIT];
      load_units<UNIT>(xs + p * ch, xv);
      const float nv = MODE == kNoise ? sn[p] : 0.f;
#pragma unroll
      for (int j = 0; j < UNIT; ++j)
        out[j] = leaky(pre_act<MODE>(xv[j], bias_c[j], nw_c[j], nv, k), k.slope) * a[j] + shift[j];
      store_units<UNIT>(yg + (int64_t)p * ch, out);
    }
    ring_next<T, UNIT, 1, MODE>(geo, it, q, sm, pitch, src, noise, bar, policy);
  }
}

template <typename T, int MODE, bool AFFINE, int UNIT>
__global__ void __launch_bounds__(kMaxThreads, kCtasPerSm)
bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ bias,
           const float* __restrict__ g, const float* __restrict__ noise,
           const float* __restrict__ nw, const float* __restrict__ mean,
           const float* __restrict__ var, const float* __restrict__ dm,
           const float* __restrict__ dv, T* __restrict__ dx, float* __restrict__ dbst,
           float* __restrict__ dg, float* __restrict__ dbias, float* __restrict__ dnw,
           float* __restrict__ part, int* __restrict__ flags, Geom geo, Consts k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int s_ticket, s_epoch, s_last;
  const int ch = geo.channels;
  const Flags f = flags_of(flags);
  const Item it = take_item(geo, f, &s_ticket, &s_epoch);
  const int b = it.image;
  const int epoch = s_epoch;
  const Smem<T> sm = carve<T>(smem, geo, 2);
  const int pitch = stage_pitch<T>(geo);
  const T* src[2] = {x, dy};
  const uint64_t policy = l2_policy(!it.apply);
  ring_start<T, UNIT, 2, MODE>(geo, it, sm, pitch, src, noise, bar, policy);
  const int chunks = (it.count + geo.chunk - 1) / geo.chunk;

  const int u = threadIdx.x % geo.units;
  const int r = threadIdx.x / geo.units;
  const int c0 = u * UNIT;
  float bias_c[UNIT], nw_c[UNIT], m[UNIT], rstd[UNIT];
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    const int64_t bc = (int64_t)b * ch + c0 + j;
    bias_c[j] = bias[c0 + j];
    nw_c[j] = MODE == kNoise ? nw[c0 + j] : 0.f;
    m[j] = mean[bc];
    rstd[j] = rsqrtf(var[bc] + k.eps);
  }
  float* rows = part + (int64_t)b * geo.tiles * 2 * ch;
  float* row = rows + (int64_t)it.tile * 2 * ch;

  if (!it.apply) {
    // the tile's sums of dy and dy * ehat, chunk by chunk
    float acc[2][UNIT] = {};
    for (int q = 0; q < chunks; ++q) {
      chunk_wait<T, UNIT, 2, MODE>(geo, it, q, q & 1, sm, pitch, src, noise, bar);
      const T* xs = sm.staged(q & 1) + c0;
      const T* ds = sm.staged(q & 1) + pitch + c0;
      const float* sn = sm.noise(q & 1, pitch, 2);
      const int count = chunk_of(geo, it, q).count;
      float cacc[2][UNIT] = {};
      for (int p = r; p < count; p += geo.rows) {
        float xv[UNIT], dyv[UNIT];
        load_units<UNIT>(xs + p * ch, xv);
        load_units<UNIT>(ds + p * ch, dyv);
        const float nv = MODE == kNoise ? sn[p] : 0.f;
#pragma unroll
        for (int j = 0; j < UNIT; ++j) {
          const float e = leaky(pre_act<MODE>(xv[j], bias_c[j], nw_c[j], nv, k), k.slope);
          cacc[0][j] += dyv[j];
          cacc[1][j] += dyv[j] * ((e - m[j]) * rstd[j]);
        }
      }
      add_sums<UNIT>(acc, cacc);
      ring_next<T, UNIT, 2, MODE>(geo, it, q, sm, pitch, src, noise, bar, policy);
    }
    tile_sums<UNIT>(acc, sm.red, row, geo);
    // the image's last sums item adds them: sdy (d bst) and sde (d g)
    if (arrive(f.done + b, geo.tiles, &s_last)) {
      image_sums<UNIT>(rows, geo.tiles, 2 * ch, sm.red);
      for (int c = threadIdx.x; c < ch; c += blockDim.x) {
        dbst[(int64_t)b * ch + c] = total_of<UNIT>(sm.red, 0, c, geo.units);
        dg[(int64_t)b * ch + c] = total_of<UNIT>(sm.red, 1, c, geo.units);
      }
      publish(f.done + b, f.ready + b, epoch);
    }
    return;
  }

  // apply: dx, and the tile's sums of dp and dp * n
  const float inv_size = 1.f / (float)geo.size;
  float gain[UNIT], u1[UNIT], u2[UNIT], dm_s[UNIT], dv_s[UNIT];
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    const int64_t bc = (int64_t)b * ch + c0 + j;
    gain[j] = AFFINE ? rstd[j] * g[bc] : rstd[j];
    dm_s[j] = dm[bc] * inv_size;
    dv_s[j] = dv[bc] * (2.f / (float)geo.size);
  }
  wait_ready(f.ready + b, epoch);
#pragma unroll
  for (int j = 0; j < UNIT; ++j) {
    const int64_t bc = (int64_t)b * ch + c0 + j;
    u1[j] = __ldcg(dbst + bc) / (float)geo.size;
    u2[j] = __ldcg(dg + bc) / (float)geo.size;
  }
  float acc[2][UNIT] = {};
  for (int q = 0; q < chunks; ++q) {
    chunk_wait<T, UNIT, 2, MODE>(geo, it, q, q & 1, sm, pitch, src, noise, bar);
    const T* xs = sm.staged(q & 1) + c0;
    const T* ds = sm.staged(q & 1) + pitch + c0;
    const float* sn = sm.noise(q & 1, pitch, 2);
    const Chunk c = chunk_of(geo, it, q);
    T* dxg = dx + (it.pix + c.first) * ch + c0;
    float cacc[2][UNIT] = {};
    for (int p = r; p < c.count; p += geo.rows) {
      float xv[UNIT], dyv[UNIT], out[UNIT];
      load_units<UNIT>(xs + p * ch, xv);
      load_units<UNIT>(ds + p * ch, dyv);
      const float nv = MODE == kNoise ? sn[p] : 0.f;
#pragma unroll
      for (int j = 0; j < UNIT; ++j) {
        const float pre = pre_act<MODE>(xv[j], bias_c[j], nw_c[j], nv, k);
        const float e = leaky(pre, k.slope);
        const float ehat = (e - m[j]) * rstd[j];
        const float de =
            gain[j] * (dyv[j] - u1[j] - ehat * u2[j]) + dm_s[j] + dv_s[j] * (e - m[j]);
        const float dp = pre >= 0.f ? de : k.slope * de;
        cacc[0][j] += dp;
        if (MODE == kNoise) cacc[1][j] += dp * nv;
        out[j] = MODE == kCorr ? dp * (1.f - xv[j] * k.corr_inv_s2 * corr_term(xv[j], k)) : dp;
      }
      store_units<UNIT>(dxg + (int64_t)p * ch, out);
    }
    add_sums<UNIT>(acc, cacc);
    ring_next<T, UNIT, 2, MODE>(geo, it, q, sm, pitch, src, noise, bar, policy);
  }
  // the sums items' rows were read before the flag rose: reuse them
  tile_sums<UNIT>(acc, sm.red, row, geo);
  if (arrive(f.done2 + b, geo.tiles, &s_last)) {
    image_sums<UNIT>(rows, geo.tiles, 2 * ch, sm.red);
    for (int c = threadIdx.x; c < ch; c += blockDim.x) {
      dbias[(int64_t)b * ch + c] = total_of<UNIT>(sm.red, 0, c, geo.units);
      dnw[(int64_t)b * ch + c] = total_of<UNIT>(sm.red, 1, c, geo.units);
    }
    if (threadIdx.x == 0) atomicExch(f.done2 + b, 0);
  }
}

// ---- host side: check the plan, launch -------------------------------------

int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// true when the plan does not describe a launch these kernels can run
bool bad_plan(int images, int channels, int size, int elem, int arrays, const Plan& p) {
  if (images <= 0 || images > kMaxImages || channels <= 0 || size <= 0) return true;
  if (p.unit == kUnit ? (int64_t)channels * elem % 16 != 0 : p.unit != 1) return true;
  const int units = channels / p.unit;
  if (p.rows < 1 || (int64_t)p.rows * units != p.threads || p.threads > kMaxThreads) return true;
  if (p.chunk < 1) return true;
  if (p.pixels < 1 || p.tiles != (size + p.pixels - 1) / p.pixels) return true;
  if ((int64_t)p.grid != (int64_t)2 * images * p.tiles) return true;
  const int64_t need = 2 * (arrays * round16((int64_t)p.chunk * channels * elem) +
                            (int64_t)(p.chunk + 3) / 4 * 16) +
                       (int64_t)2 * p.unit * p.threads * 4;
  return p.smem < need || p.smem > kMaxDynamicSmem;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Plan& p, cudaStream_t stream, Args... args) {
  if (p.smem + kStaticSmem > 48 * 1024) {  // beyond the default limit, with the static share
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<p.grid, p.threads, p.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

struct Fwd {
  template <typename T, int MODE, bool AFFINE, int UNIT>
  static int run(const Plan& p, cudaStream_t stream, const void* x, const float* bias,
                 const float* g, const float* bst, const float* noise, const float* nw, void* y,
                 float* mean, float* var, float* part, int* flags, Geom geo, Consts k) {
    return launch(fwd_kernel<T, MODE, AFFINE, UNIT>, p, stream, static_cast<const T*>(x), bias, g,
                  bst, noise, nw, static_cast<T*>(y), mean, var, part, flags, geo, k);
  }
};

struct Bwd {
  template <typename T, int MODE, bool AFFINE, int UNIT>
  static int run(const Plan& p, cudaStream_t stream, const void* dy, const void* x,
                 const float* bias, const float* g, const float* noise, const float* nw,
                 const float* mean, const float* var, const float* dm, const float* dv, void* dx,
                 float* dbst, float* dg, float* dbias, float* dnw, float* part, int* flags,
                 Geom geo, Consts k) {
    return launch(bwd_kernel<T, MODE, AFFINE, UNIT>, p, stream, static_cast<const T*>(dy),
                  static_cast<const T*>(x), bias, g, noise, nw, mean, var, dm, dv,
                  static_cast<T*>(dx), dbst, dg, dbias, dnw, part, flags, geo, k);
  }
};

// one instantiation per (dtype, mode, affine, vector or scalar units)
template <class L, typename T, int MODE, bool AFFINE, typename... A>
int by_unit(const Plan& p, A... a) {
  if (p.unit > 1) return L::template run<T, MODE, AFFINE, kUnit>(p, a...);
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

Geom geometry(int images, int channels, int size, const Plan& p) {
  return Geom{images, channels, size, channels / p.unit, p.rows, p.chunk, p.pixels, p.tiles};
}

}  // namespace

extern "C" {

// x, y: (images, size, channels) of dtype (0 f32, 1 bf16), 16-byte aligned.
// bias, nw: (channels,) f32; g, bst, mean, var: (images, channels) f32;
// noise: (images, size) f32. part: images * tiles * 2 * channels f32 of
// scratch; flags: 2 + 3 * kMaxImages int32, zero when first used (the
// source's header says how they stay usable). Pointers that the mode does not read may be null. mode 0/1/2 =
// plain/noise/corr. unit..grid: the launch plan of ops/adain_cuda.py
// ``plan``, checked here. Launches on `stream` and returns the launch's
// cudaError_t (0 on success) without synchronising.
int bias_act_norm_fwd(const void* x, const float* bias, const float* g, const float* bst,
                      const float* noise, const float* nw, void* y, float* mean, float* var,
                      float* part, int* flags, int images, int channels, int size, int dtype,
                      int mode, int affine, int unit, int rows, int threads, int chunk, int pixels,
                      int tiles, int smem, int grid, float eps, float slope, float corr_ks,
                      float corr_c2, cudaStream_t stream) {
  const Plan p{unit, rows, threads, chunk, pixels, tiles, smem, grid};
  if (dtype < 0 || dtype > 1 || bad_plan(images, channels, size, elem_bytes(dtype), 1, p) ||
      !aligned16(x) || !aligned16(y) || !aligned16(part) || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  const Consts c{eps, slope, corr_ks, corr_c2, 0.f};
  return dispatch<Fwd>(dtype, mode, affine != 0, p, stream, x, bias, g, bst, noise, nw, y, mean,
                       var, part, flags, geometry(images, channels, size, p), c);
}

// dy, x, dx: (images, size, channels) of dtype, 16-byte aligned; dm, dv,
// mean, var, g: (images, channels) f32; dbst, dg, dbias, dnw: (images,
// channels) f32 outputs (dnw is 0 unless mode is noise); part, flags as the
// forward's.
int bias_act_norm_bwd(const void* dy, const void* x, const float* bias, const float* g,
                      const float* noise, const float* nw, const float* mean, const float* var,
                      const float* dm, const float* dv, void* dx, float* dbst, float* dg,
                      float* dbias, float* dnw, float* part, int* flags, int images,
                      int channels, int size, int dtype, int mode, int affine, int unit, int rows,
                      int threads, int chunk, int pixels, int tiles, int smem, int grid, float eps,
                      float slope, float corr_ks, float corr_c2, float corr_inv_s2,
                      cudaStream_t stream) {
  const Plan p{unit, rows, threads, chunk, pixels, tiles, smem, grid};
  if (dtype < 0 || dtype > 1 || bad_plan(images, channels, size, elem_bytes(dtype), 2, p) ||
      !aligned16(dy) || !aligned16(x) || !aligned16(dx) || !aligned16(part) || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  const Consts c{eps, slope, corr_ks, corr_c2, corr_inv_s2};
  return dispatch<Bwd>(dtype, mode, affine != 0, p, stream, dy, x, bias, g, noise, nw, mean, var,
                       dm, dv, dx, dbst, dg, dbias, dnw, part, flags,
                       geometry(images, channels, size, p), c);
}

const char* bias_act_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
