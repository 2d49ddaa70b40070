// The image nets' float32 convolutions for Hopper (sm_90a): forward, input
// gradient and weight gradient of a stride-1 "same" convolution on
// channels-last tensors, as implicit GEMMs in full float32 FFMA.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA
// (soft_intro_vae_tpu/models/conv.py). The port ran them through cuDNN, which
// with TF32 off picks FFT and NCHW implicit-GEMM kernels for the channels-last
// nets and transposes into and out of them; at the CelebA-HQ 256 recipe those
// took ~92% of the step. So they have kernels of their own, taken only on the
// float32 route with cuDNN's TF32 off (ops/conv_f32.py).
//
// What it computes. x is (B, H, W, Cin) in memory, w (Cout, kh, kw, Cin) (a
// channels-last (Cout, Cin, k, k) weight), pad = (k - 1) / 2, stride 1:
//   fprop  y[m][n] = sum over kk of A(m, kk) * w[n][kk] (+ bias[n]),
//          m = (b, oh, ow) the output pixel (M = B*H*W), n the output channel,
//          kk = (r, s, c) (K = k*k*Cin), A(m, kk) = x[b][oh + r - pad][ow + s - pad][c]
//          and 0 outside the image;
//   dgrad  the input gradient is fprop on dy with the weight flipped in (r, s)
//          and its channels swapped, wt[c][r][s][n] = w[n][k-1-r][k-1-s][c]
//          (conv_f32_flip_kernel, one small re-layout a call);
//   wgrad  dw[n][kk] = sum over m of dy[m][n] * A(m, kk): a GEMM of
//          Cout x K over the B*H*W pixels, dw in the weight's own layout.
// Every product is an FFMA in float32 with a float32 sum; the order of the
// sums is fixed by the launch plan, so two runs, and a CUDA graph's replay
// against the eager call, are bit-equal. No TF32, no split of the operands, no
// Winograd or FFT: the direct convolution's arithmetic in another order.
//
// What bounds it: FFMA. A 3x3 conv of 64 channels does ~290 FLOP per byte of
// its input and output, far above the card's balance; the least time is the
// FLOPs at the 67 TFLOP/s float32 rate. The design is the classic register-
// tiled SGEMM: a CTA computes a BM x BN tile of the output through a ring of
// K-slices in shared memory, filled while the previous slice is summed, with
// zeros at the halo and the ragged edges; each thread keeps a TM x TN tile of
// sums in registers and accumulates outer products of fragments read from
// shared memory as float4s.
//   * fprop/dgrad: a K-slice of one filter tap is Cin contiguous floats of one
//     pixel, K-major in memory, while the outer products want each k's row of
//     pixels and of channels (MN-major): read as float4s, a thread's next k
//     then costs 16 registers, so the compiler can load it while it sums the
//     last. conv_f32_fprop_kernel stages the transposition through registers:
//     each thread loads its 16-byte pieces of the next slice while the CTA
//     computes the current one, and stores them transposed into the other of
//     two buffers. Where a pixel's channels are not whole 16-byte pieces (the
//     3-channel stem), or the output has a few channels (the predict conv, the
//     stem's input gradient), conv_f32_fprop_kmajor_kernel keeps both operands
//     K-major in a cp.async ring and reads a float4 of 4 k's a row.
//   * wgrad: the reduction runs over pixels, along which both dy (Cout
//     contiguous floats a pixel) and the patches (Cin contiguous floats a tap
//     and pixel) are strided; both are staged MN-major ([BK][rows]) and read
//     as float4s of four consecutive rows. A pixel's (oh, ow) is decoded by a
//     multiply-high (FastDiv).
// The tile shape and the split of the reduction come from (M, N, K) in plain
// Python (ops/conv_f32_cuda.py ``plan_fprop``/``plan_wgrad``), checked here:
// a grid that fills few SMs (4x4 to 16x16 planes of 512 channels in fprop; any
// wgrad, whose reduction is long) splits its reduction over CTAs, each writes
// its partial tile, and conv_f32_reduce_kernel sums the partials in split
// order, adding the bias. No float atomics anywhere. Indices into the tensors
// are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // dynamic shared memory one CTA may use on sm_90
constexpr int kDefaultSmem = 48 * 1024;

struct Geom {
  int h, w;       // the plane, the same for input and output (stride 1, same padding)
  int cin, cout;  // channels of the operand read as x (x, or dy in dgrad) and of the output
  int ksize, pad;
  int m;          // batch * h * w: pixels
  int k;          // ksize * ksize * cin
};

// n / d for 0 <= n < 2^31 by a multiply-high (CUTLASS's FastDivmod)
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int lg = 0;
    while ((1ll << lg) < d) ++lg;  // ceil(log2 d)
    const int p = 31 + lg;
    f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
    f.shr = (unsigned)(p - 32);
  }
  return f;
}

__device__ __forceinline__ int quot(const FastDiv& f, int n) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shr);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// V floats from global to shared memory, asynchronously; zeros where !valid
// (src is then not read)
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid);
template <>
__device__ __forceinline__ void copy_async<4>(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
template <>
__device__ __forceinline__ void copy_async<1>(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How NT threads copy an R x CP grid of pieces (R rows of CP pieces): a
// thread takes NCOL columns, col(c), of NROW rows, row(r) (rows >= R skipped
// where kRagged).
template <int R, int CP, int NT>
struct Grid {
  static constexpr bool kWide = CP > NT;
  static_assert(kWide ? CP % NT == 0 : NT % CP == 0, "pieces and threads must tile");
  static constexpr int NCOL = kWide ? CP / NT : 1;
  static constexpr int RSTEP = kWide ? 1 : NT / CP;
  static constexpr int NROW = (R + RSTEP - 1) / RSTEP;
  static constexpr bool kRagged = R % RSTEP != 0;
  __device__ static int col(int tid, int c) { return (kWide ? tid : tid % CP) + NT * c; }
  __device__ static int row(int tid, int r) { return (kWide ? 0 : tid / CP) + RSTEP * r; }
};

// ---------------------------------------------------------------- fprop ----

template <int BM, int BN, int BK, int TM, int TN, int STAGES>
constexpr int fprop_kmajor_smem() {
  return STAGES * (BM + BN) * (BK + 4) * 4 + BM * 16;
}

// The sums of conv_f32_fprop_kernel (below) with both operands K-major
// ([row][BK + 4]) through a ring of STAGES slices filled by cp.async, V
// floats a copy (V = 4 where Cin is a multiple of 4), each thread's rows and
// columns interleaved across the tile: for an output of a few channels (the
// 3-channel predict conv, the stem's input gradient), where the pixel rows
// are the work, and for a Cin that is not a multiple of 4 (the stem's 3).
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int V>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv_f32_fprop_kmajor_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                          const float* __restrict__ bias, float* __restrict__ out, Geom g,
                          int kt_per_split) {
  constexpr int TY = BM / TM, TX = BN / TN, NT = TY * TX, LD = BK + 4;
  using GA = Grid<BM, BK / V, NT>;
  using GB = Grid<BN, BK / V, NT>;
  static_assert(!GA::kWide && !GB::kWide, "a K-slice row is one thread's pieces");
  static_assert(BK % 4 == 0, "fragments are float4s along K");
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);        // [STAGES][BM][LD]
  float* Bs = As + STAGES * BM * LD;                  // [STAGES][BN][LD]
  int4* rows = reinterpret_cast<int4*>(Bs + STAGES * BN * LD);  // (m or -1, oh, ow) a row

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    int4 info = make_int4(-1, 0, 0, 0);
    if (m < g.m) {
      const int q = m / g.w;
      info = make_int4(m, q % g.h, m - q * g.w, 0);
    }
    rows[r] = info;
  }
  __syncthreads();

  const int ktiles = (g.k + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(ktiles - kt0, kt_per_split);
  const int col = GA::col(tid, 0) * V;

  auto load = [&](int slot, int kt) {
    const int k = kt * BK + col;
    const bool kin = k < g.k;
    int ci = 0, dy = 0, dx = 0;
    if (kin) {
      const int tap = k / g.cin;
      const int r = tap / g.ksize;
      ci = k - tap * g.cin;
      dy = r - g.pad;
      dx = tap - r * g.ksize - g.pad;
    }
    float* as = As + slot * BM * LD + col;
#pragma unroll
    for (int i = 0; i < GA::NROW; ++i) {
      const int r = GA::row(tid, i);
      if (GA::kRagged && r >= BM) break;
      const int4 info = rows[r];
      const int ih = info.y + dy, iw = info.z + dx;
      const bool ok = kin && info.x >= 0 && (unsigned)ih < (unsigned)g.h &&
                      (unsigned)iw < (unsigned)g.w;
      const float* src =
          ok ? x + ((int64_t)info.x + (int64_t)dy * g.w + dx) * g.cin + ci : x;
      copy_async<V>(as + r * LD, src, ok);
    }
    float* bs = Bs + slot * BN * LD + col;
#pragma unroll
    for (int j = 0; j < GB::NROW; ++j) {
      const int r = GB::row(tid, j);
      if (GB::kRagged && r >= BN) break;
      const int n = n0 + r;
      const bool ok = kin && n < g.cout;
      copy_async<V>(bs + r * LD, ok ? wt + (int64_t)n * g.k + k : wt, ok);
    }
  };

  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, kt0 + s);
    commit();
  }
  for (int t = 0; t < nkt; ++t) {
    wait_groups<STAGES - 2>();
    __syncthreads();  // slot t % STAGES has landed; slot (t - 1) % STAGES is free
    const int pre = t + STAGES - 1;
    if (pre < nkt) load(pre % STAGES, kt0 + pre);
    commit();
    const float* as = As + (t % STAGES) * BM * LD + ty * LD;
    const float* bs = Bs + (t % STAGES) * BN * LD + tx * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(as + i * TY * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(bs + j * TX * LD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  wait_groups<0>();

  float* dst = out + (int64_t)blockIdx.z * g.m * g.cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= g.cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      dst[(int64_t)m * g.cout + n] = v;
    }
  }
}

// out[z][m][n] = the sum over split z's K-slices of A(m, kk) * wt[n][kk], plus
// bias[n] where bias is given (one split); Cin a multiple of 4. Each thread
// loads its 16-byte pieces of the next K-slice into registers while the CTA
// computes the current one, then stores them transposed into an MN-major
// ([BK][rows]) double buffer, the rows XOR-swizzled by the slice's k / 4 so
// that neither those stores nor the float4 fragment reads meet on a bank.
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv_f32_fprop_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                             const float* __restrict__ bias, float* __restrict__ out, Geom g,
                             int kt_per_split) {
  constexpr int TY = BM / TM, TX = BN / TN, NT = TY * TX;
  constexpr int CP = BK / 4;          // float4 pieces a row of a slice
  constexpr int RSTEP = NT / CP;      // rows a pass of the threads loads
  static_assert(NT % CP == 0 && BM % RSTEP == 0, "passes of whole rows");
  constexpr int NA = BM / RSTEP, NB = (BN + RSTEP - 1) / RSTEP;
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK == 16, "the swizzle spans 32 rows");
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [2][BK][BM]
  float* Bs = As + 2 * BK * BM;                 // [2][BK][BN]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (g.k + BK - 1) / BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(ktiles - kt0, kt_per_split);
  const int col = (tid % CP) * 4, r0 = tid / CP;
  const int swz = (col >> 2) << 3;    // the swizzle of the thread's four k rows

  int a_m[NA], a_oh[NA], a_ow[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int m = m0 + r0 + RSTEP * i;
    a_m[i] = m < g.m ? m : -1;
    const int q = m / g.w;
    a_oh[i] = q % g.h;
    a_ow[i] = m - q * g.w;
  }
  int kk = kt0 * BK + col;
  int tap = kk / g.cin;
  int ci = kk - tap * g.cin;
  int tr = tap / g.ksize;
  int ts = tap - tr * g.ksize;

  float4 ra[NA], rb[NB];
  auto fetch = [&]() {
    const bool kin = kk < g.k;
    const int dy = tr - g.pad, dx = ts - g.pad;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int ih = a_oh[i] + dy, iw = a_ow[i] + dx;
      const bool ok = kin && a_m[i] >= 0 && (unsigned)ih < (unsigned)g.h &&
                      (unsigned)iw < (unsigned)g.w;
      ra[i] = ok ? __ldg(reinterpret_cast<const float4*>(
                       x + ((int64_t)a_m[i] + (int64_t)dy * g.w + dx) * g.cin + ci))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int r = r0 + RSTEP * j;
      const int n = n0 + r;
      const bool ok = kin && r < BN && n < g.cout;
      rb[j] = ok ? __ldg(reinterpret_cast<const float4*>(wt + (int64_t)n * g.k + kk))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    kk += BK;
    ci += BK;
    while (ci >= g.cin) {
      ci -= g.cin;
      if (++ts == g.ksize) ts = 0, ++tr;
    }
  };
  auto store = [&](int buf) {
    float* as = As + buf * BK * BM + col * BM;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = (r0 + RSTEP * i) ^ swz;
      as[r] = ra[i].x, as[BM + r] = ra[i].y, as[2 * BM + r] = ra[i].z, as[3 * BM + r] = ra[i].w;
    }
    float* bs = Bs + buf * BK * BN + col * BN;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int r0j = r0 + RSTEP * j;
      if (r0j >= BN) break;
      const int r = r0j ^ swz;
      bs[r] = rb[j].x, bs[BN + r] = rb[j].y, bs[2 * BN + r] = rb[j].z, bs[3 * BN + r] = rb[j].w;
    }
  };

  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nkt > 0) {
    fetch();
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < nkt; ++t) {
    const bool more = t + 1 < nkt;
    if (more) fetch();
    const float* as = As + (t & 1) * BK * BM;
    const float* bs = Bs + (t & 1) * BK * BN;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int s = ((k >> 2) & 3) << 3;
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + k * BM + ((ty * 4 + i * 4 * TY) ^ s));
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z, a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + k * BN + ((tx * 4 + j * 4 * TX) ^ s));
        b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z, b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store((t + 1) & 1);
    __syncthreads();
  }

  float* dst = out + (int64_t)blockIdx.z * g.m * g.cout;
  const bool vec_out = g.cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * 4 + (i / 4) * 4 * TY + i % 4;
    if (m >= g.m) continue;
    float* row = dst + (int64_t)m * g.cout;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int n = n0 + tx * 4 + j4 * 4 * TX;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = acc[i][4 * j4 + q];
        if (bias != nullptr && n + q < g.cout) v[q] += bias[n + q];
      }
      if (vec_out) {
        if (n < g.cout) *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < g.cout) row[n + q] = v[q];
      }
    }
  }
}

// ---------------------------------------------------------------- wgrad ----

template <int BM, int BN, int BK, int TM, int TN, int STAGES>
constexpr int wgrad_smem() {
  return STAGES * BK * (BM + BN) * 4;
}

// out[z][n][kk] = the sum over split z's pixels m of dy[m][n] * A(m, kk)
// (here n runs over the tile's BM rows and kk over its BN columns)
template <int BM, int BN, int BK, int TM, int TN, int STAGES, int VA, int VB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv_f32_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ out, Geom g, FastDiv fw, FastDiv fh,
                          int pt_per_split) {
  constexpr int TY = BM / TM, TX = BN / TN, NT = TY * TX;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "fragments are float4s of four rows");
  using GA = Grid<BK, BM / VA, NT>;
  using GB = Grid<BK, BN / VB, NT>;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [STAGES][BK][BM]: dy
  float* Bs = As + STAGES * BK * BM;            // [STAGES][BK][BN]: the patches

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int ptiles = (g.m + BK - 1) / BK;
  const int pt0 = blockIdx.z * pt_per_split;
  const int npt = min(ptiles - pt0, pt_per_split);

  // the thread's patch columns: a tap's pixel offset and a channel, fixed
  int b_dy[GB::NCOL], b_dx[GB::NCOL], b_ci[GB::NCOL];
  bool b_in[GB::NCOL];
#pragma unroll
  for (int c = 0; c < GB::NCOL; ++c) {
    const int kk = k0 + GB::col(tid, c) * VB;
    b_in[c] = kk < g.k;
    const int tap = b_in[c] ? kk / g.cin : 0;
    const int r = tap / g.ksize;
    b_ci[c] = b_in[c] ? kk - tap * g.cin : 0;
    b_dy[c] = r - g.pad;
    b_dx[c] = tap - r * g.ksize - g.pad;
  }

  auto load = [&](int slot, int pt) {
    const int p0 = pt * BK;
    float* as = As + slot * BK * BM;
#pragma unroll
    for (int c = 0; c < GA::NCOL; ++c) {
      const int ccol = GA::col(tid, c) * VA;
      const int n = n0 + ccol;
#pragma unroll
      for (int i = 0; i < GA::NROW; ++i) {
        const int r = GA::row(tid, i);
        if (GA::kRagged && r >= BK) break;
        const int p = p0 + r;
        const bool ok = p < g.m && n < g.cout;
        copy_async<VA>(as + r * BM + ccol, ok ? dy + (int64_t)p * g.cout + n : dy, ok);
      }
    }
    float* bs = Bs + slot * BK * BN;
#pragma unroll
    for (int i = 0; i < GB::NROW; ++i) {
      const int r = GB::row(tid, i);
      if (GB::kRagged && r >= BK) break;
      const int p = p0 + r;
      const int q = quot(fw, p);
      const int ow = p - q * g.w;
      const int oh = q - quot(fh, q) * g.h;
#pragma unroll
      for (int c = 0; c < GB::NCOL; ++c) {
        const int ih = oh + b_dy[c], iw = ow + b_dx[c];
        const bool ok = p < g.m && b_in[c] && (unsigned)ih < (unsigned)g.h &&
                        (unsigned)iw < (unsigned)g.w;
        const float* src =
            ok ? x + ((int64_t)p + (int64_t)b_dy[c] * g.w + b_dx[c]) * g.cin + b_ci[c] : x;
        copy_async<VB>(bs + r * BN + GB::col(tid, c) * VB, src, ok);
      }
    }
  };

  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < npt) load(s, pt0 + s);
    commit();
  }
  for (int t = 0; t < npt; ++t) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int pre = t + STAGES - 1;
    if (pre < npt) load(pre % STAGES, pt0 + pre);
    commit();
    const float* as = As + (t % STAGES) * BK * BM + ty * 4;
    const float* bs = Bs + (t % STAGES) * BK * BN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * BM + i * 4 * TY);
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z, a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + kk * BN + j * 4 * TX);
        b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z, b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  wait_groups<0>();

  float* dst = out + (int64_t)blockIdx.z * g.cout * g.k;
  const bool vec_out = g.k % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + ty * 4 + (i / 4) * 4 * TY + i % 4;
    if (n >= g.cout) continue;
    float* row = dst + (int64_t)n * g.k;
#pragma unroll
    for (int j4 = 0; j4 < TN / 4; ++j4) {
      const int kk = k0 + tx * 4 + j4 * 4 * TX;
      if (vec_out && kk < g.k) {
        *reinterpret_cast<float4*>(row + kk) = make_float4(
            acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2], acc[i][4 * j4 + 3]);
      } else if (!vec_out) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (kk + q < g.k) row[kk + q] = acc[i][4 * j4 + q];
      }
    }
  }
}

// ------------------------------------------------------- reduce and flip ----

// out[i] = ws[0][i] + ws[1][i] + ... + ws[splits - 1][i] (+ bias[i % n]), in
// that order; V = 4 where total and n are multiples of 4
template <int V>
__global__ void conv_f32_reduce_kernel(const float* __restrict__ ws,
                                       const float* __restrict__ bias, float* __restrict__ out,
                                       int64_t total, int n, int splits) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V; i < total; i += stride) {
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = ws[i + v];
    for (int z = 1; z < splits; ++z) {
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] += ws[(int64_t)z * total + i + v];
    }
    if (bias != nullptr) {
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] += bias[(i + v) % n];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) out[i + v] = s[v];
  }
}

constexpr int kFlipTile = 32;

// wt[c][r][s][n] = w[n][k-1-r][k-1-s][c]: per tap a (Cout x Cin) -> (Cin x
// Cout) transpose through a 32 x 33 tile of shared memory; block (32, 8)
__global__ void conv_f32_flip_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                     int cout, int cin, int ksize) {
  __shared__ float tile[kFlipTile][kFlipTile + 1];
  const int taps = ksize * ksize;
  const int tap = blockIdx.z;                     // the output's tap (r, s)
  const int src_tap = taps - 1 - tap;             // (k-1-r, k-1-s)
  const int c0 = blockIdx.x * kFlipTile, n0 = blockIdx.y * kFlipTile;
  for (int dy = threadIdx.y; dy < kFlipTile; dy += blockDim.y) {
    const int n = n0 + dy, c = c0 + threadIdx.x;
    if (n < cout && c < cin) tile[dy][threadIdx.x] = w[((int64_t)n * taps + src_tap) * cin + c];
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < kFlipTile; dy += blockDim.y) {
    const int c = c0 + dy, n = n0 + threadIdx.x;
    if (n < cout && c < cin) wt[((int64_t)c * taps + tap) * cout + n] = tile[threadIdx.x][dy];
  }
}

// ---------------------------------------------------------------- launch ----

template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// a launch plan's split: every split holds at least one of the tiles, and the
// splits cover them all
bool bad_split(int tiles, int splits, int per_split) {
  return splits < 1 || per_split < 1 || splits > 65535 ||
         (int64_t)splits * per_split < tiles || (int64_t)(splits - 1) * per_split >= tiles;
}

template <int BM, int BN, int BK, int TM, int TN>
int fprop(const float* x, const float* wt, const float* bias, float* out, const Geom& g, int vec,
          int splits, int kt_per_split, int threads, int smem, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int SMEM = 2 * BK * (BM + BN) * 4;
  if (threads != NT || smem != SMEM || vec != 4 || bad_split(ceil_div(g.k, BK), splits, kt_per_split) ||
      (bias != nullptr && splits != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(g.m, BM), ceil_div(g.cout, BN), splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = conv_f32_fprop_kernel<BM, BN, BK, TM, TN>;
  const int err = set_smem(kernel, SMEM);
  if (err != 0) return err;
  kernel<<<grid, NT, SMEM, stream>>>(x, wt, bias, out, g, kt_per_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN, int STAGES>
int fprop_kmajor(const float* x, const float* wt, const float* bias, float* out, const Geom& g,
                 int vec, int splits, int kt_per_split, int threads, int smem,
                 cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int SMEM = fprop_kmajor_smem<BM, BN, BK, TM, TN, STAGES>();
  static_assert(SMEM <= kMaxSmem, "the ring must fit a CTA's shared memory");
  if (threads != NT || smem != SMEM || bad_split(ceil_div(g.k, BK), splits, kt_per_split) ||
      (bias != nullptr && splits != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(g.m, BM), ceil_div(g.cout, BN), splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = vec == 4 ? conv_f32_fprop_kmajor_kernel<BM, BN, BK, TM, TN, STAGES, 4>
                         : conv_f32_fprop_kmajor_kernel<BM, BN, BK, TM, TN, STAGES, 1>;
  const int err = set_smem(kernel, SMEM);
  if (err != 0) return err;
  kernel<<<grid, NT, SMEM, stream>>>(x, wt, bias, out, g, kt_per_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN, int STAGES, int VA>
int wgrad_vb(const float* x, const float* dy, float* out, const Geom& g, int vec_b,
             int pt_per_split, dim3 grid, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int SMEM = wgrad_smem<BM, BN, BK, TM, TN, STAGES>();
  static_assert(SMEM <= kMaxSmem, "the ring must fit a CTA's shared memory");
  auto kernel = vec_b == 4 ? conv_f32_wgrad_kernel<BM, BN, BK, TM, TN, STAGES, VA, 4>
                           : conv_f32_wgrad_kernel<BM, BN, BK, TM, TN, STAGES, VA, 1>;
  const int err = set_smem(kernel, SMEM);
  if (err != 0) return err;
  kernel<<<grid, NT, SMEM, stream>>>(x, dy, out, g, fast_div(g.w), fast_div(g.h), pt_per_split);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK, int TM, int TN, int STAGES>
int wgrad(const float* x, const float* dy, float* out, const Geom& g, int vec_a, int vec_b,
          int splits, int pt_per_split, int threads, int smem, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BN / TN);
  if (threads != NT || smem != wgrad_smem<BM, BN, BK, TM, TN, STAGES>() ||
      bad_split(ceil_div(g.m, BK), splits, pt_per_split))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(g.cout, BM), ceil_div(g.k, BN), splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  return vec_a == 4
             ? wgrad_vb<BM, BN, BK, TM, TN, STAGES, 4>(x, dy, out, g, vec_b, pt_per_split, grid,
                                                       stream)
             : wgrad_vb<BM, BN, BK, TM, TN, STAGES, 1>(x, dy, out, g, vec_b, pt_per_split, grid,
                                                       stream);
}

// the geometry of a call, or false where it is not one the kernels take
bool geom(int batch, int h, int w, int cin, int cout, int ksize, Geom* g) {
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || ksize <= 0 || ksize % 2 == 0)
    return false;
  const int64_t m = (int64_t)batch * h * w, k = (int64_t)ksize * ksize * cin;
  if (m >= (1ll << 31) || k >= (1ll << 31) || m * cin >= (1ll << 40) || m * cout >= (1ll << 40))
    return false;
  *g = Geom{h, w, cin, cout, ksize, (ksize - 1) / 2, (int)m, (int)k};
  return true;
}

}  // namespace

extern "C" {

// fprop (and dgrad): x (batch, h, w, cin), wt (cout, ksize, ksize, cin), bias
// (cout) or null, out (splits, batch*h*w, cout); all contiguous float32, not
// overlapping, out 16-byte aligned where cout is a multiple of 4. tile:
// ops/conv_f32_cuda.py FPROP_TILES (0, 1 register-staged: vec 4 only; 2-4
// K-major); vec 4 (16-byte loads: cin a multiple of 4, x and wt 16-byte
// aligned) or 1; splits x kt_per_split K-slices of 16; threads and smem as
// the tile has them. Launches on `stream` and returns the launch's
// cudaError_t (0 on success) without synchronising.
int conv_f32_fprop(const float* x, const float* wt, const float* bias, float* out, int batch,
                   int h, int w, int cin, int cout, int ksize, int tile, int vec, int splits,
                   int kt_per_split, int threads, int smem, cudaStream_t stream) {
  Geom g;
  if (x == nullptr || wt == nullptr || out == nullptr || !geom(batch, h, w, cin, cout, ksize, &g) ||
      (vec != 1 && vec != 4) || (vec == 4 && (cin % 4 != 0 || !aligned(x, 16) || !aligned(wt, 16))) ||
      (cout % 4 == 0 && !aligned(out, 16)))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0: return fprop<128, 128, 16, 8, 8>(x, wt, bias, out, g, vec, splits, kt_per_split,
                                             threads, smem, stream);
    case 1: return fprop<256, 64, 16, 8, 8>(x, wt, bias, out, g, vec, splits, kt_per_split,
                                            threads, smem, stream);
    case 2: return fprop_kmajor<128, 4, 16, 4, 4, 4>(x, wt, bias, out, g, vec, splits,
                                                     kt_per_split, threads, smem, stream);
    case 3: return fprop_kmajor<128, 128, 16, 8, 8, 4>(x, wt, bias, out, g, vec, splits,
                                                       kt_per_split, threads, smem, stream);
    case 4: return fprop_kmajor<256, 64, 16, 8, 8, 4>(x, wt, bias, out, g, vec, splits,
                                                      kt_per_split, threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wgrad: x (batch, h, w, cin), dy (batch, h, w, cout), out (splits, cout,
// ksize*ksize*cin); contiguous float32. tile: ops/conv_f32_cuda.py
// WGRAD_TILES; vec_a 4 where cout is a multiple of 4 and dy 16-byte aligned,
// vec_b 4 where cin is and x is, else 1; splits x pt_per_split slices of 16
// pixels.
int conv_f32_wgrad(const float* x, const float* dy, float* out, int batch, int h, int w, int cin,
                   int cout, int ksize, int tile, int vec_a, int vec_b, int splits,
                   int pt_per_split, int threads, int smem, cudaStream_t stream) {
  Geom g;
  if (x == nullptr || dy == nullptr || out == nullptr ||
      !geom(batch, h, w, cin, cout, ksize, &g) || (vec_a != 1 && vec_a != 4) ||
      (vec_b != 1 && vec_b != 4) || (vec_a == 4 && (cout % 4 != 0 || !aligned(dy, 16))) ||
      (vec_b == 4 && (cin % 4 != 0 || !aligned(x, 16))) || !aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0: return wgrad<128, 128, 16, 8, 8, 4>(x, dy, out, g, vec_a, vec_b, splits,
                                                pt_per_split, threads, smem, stream);
    case 1: return wgrad<64, 128, 16, 8, 8, 4>(x, dy, out, g, vec_a, vec_b, splits, pt_per_split,
                                               threads, smem, stream);
    case 2: return wgrad<4, 128, 16, 4, 4, 4>(x, dy, out, g, vec_a, vec_b, splits, pt_per_split,
                                              threads, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[i] = sum over z < splits of ws[z][i] in order, + bias[i % n] where bias
// is given; ws (splits, total), out (total), bias (n). blocks of 256 threads.
int conv_f32_reduce(const float* ws, const float* bias, float* out, long long total, int n,
                    int splits, int blocks, cudaStream_t stream) {
  if (ws == nullptr || out == nullptr || total <= 0 || n <= 0 || total % n != 0 || splits < 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (total % 4 == 0 && n % 4 == 0 && aligned(ws, 16) && aligned(out, 16))
    conv_f32_reduce_kernel<4><<<blocks, 256, 0, stream>>>(ws, bias, out, total, n, splits);
  else
    conv_f32_reduce_kernel<1><<<blocks, 256, 0, stream>>>(ws, bias, out, total, n, splits);
  return (int)cudaGetLastError();
}

// wt (cin, ksize, ksize, cout) from w (cout, ksize, ksize, cin): the input
// gradient's weight, flipped in (r, s) with its channels swapped.
int conv_f32_flip(const float* w, float* wt, int cout, int cin, int ksize, cudaStream_t stream) {
  if (w == nullptr || wt == nullptr || cout <= 0 || cin <= 0 || ksize <= 0 || ksize % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ceil_div(cin, kFlipTile), ceil_div(cout, kFlipTile), ksize * ksize);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  conv_f32_flip_kernel<<<grid, dim3(kFlipTile, 8), 0, stream>>>(w, wt, cout, cin, ksize);
  return (int)cudaGetLastError();
}

const char* conv_f32_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
