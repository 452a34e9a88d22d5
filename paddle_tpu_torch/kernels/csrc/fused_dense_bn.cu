// K4, K5, K6: a matrix product with BatchNorm fused into it, for Hopper
// (sm_90a). One templated kernel, three entry points:
//
//   K4 (STATS):            y = x @ w, with per-column partial sums of
//                          the accumulator and of its square;
//   K5 (PROLOGUE):         y = act(x * scale + shift) @ w;
//   K6 (PROLOGUE + STATS): both.
//
// Replaces: the JAX package's ops/pallas/fused_dense_bn.py kernels
// _mm_stats_kernel (K4, launched by _mm_stats_pallas), _bn_mm_kernel
// (K5, _bn_mm_pallas) and _bn_mm_stats_kernel (K6,
// _bn_act_matmul_stats), which ResNet's fused 1x1 path reaches through
// matmul_stats (conv1 + bn1 statistics) and bn_act_matmul_stats (bn2
// apply + ReLU, conv3, bn3 statistics). Same semantics: x, w and y in
// one dtype; the product accumulates in f32 (f64 for f64 x); y is the
// accumulator rounded to x's dtype; the partial sums of y and y*y are
// taken from the accumulator before that rounding, one row per block of
// rows ([gm, N], finished by the caller); the prologue computes
// x * scale + shift in the accumulator's dtype (__fmul_rn / __fadd_rn:
// a rounded product and a rounded sum, as the plain version computes
// them, never one FMA), applies the ReLU and rounds to x's dtype
// before the product. Rows at or past M and columns at or past N are
// neither stored nor summed; the padded part of a tile is zero after
// the prologue (relu(0 * scale + shift) is not 0).
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// ResNet-50's bs-256 shapes the products are 2 M K N = 3.3-26 GFLOP
// each, moving x, w and y once (10-420 MB): K4 and K6 are
// compute-bound at the tensor-core rate where K and N are >= 256 and
// memory-bound at g0's K = 64 or N = 64 (M = 802816), where the
// operands' bytes take longer than the 6.6 GFLOP.
//
// What the design does about that bound. bf16 and f16 run the Hopper
// kernel (fused_mm_bn_sm90_kernel): one persistent block an SM walks
// over 128 x BN tiles of y, BN 64 where N <= 64 (g0's K4, N 64) and 128
// otherwise, with two consumer warpgroups of 64 rows and one producer
// warp. The producer keeps four k stages of 64 in flight by TMA (x's
// 128 x 64 box and w's BN / 64 boxes of 64 x 64, 128-byte swizzled,
// completing on an mbarrier a stage), running on into the next tile
// while the consumers finish the last; the consumers run wgmma
// m64nBNk16 with f32 accumulators, one product group in flight while
// the next stage is prepared. K4 reads x and w from shared memory (ss: w as the MN-major
// B operand). K5 and K6 read each thread's A fragment of x from the
// swizzled box into registers, apply the prologue there (in f32, then
// rounded and packed to 16 bits) and issue the rs form, so the
// normalised x never goes back to shared memory and needs no proxy
// fence; the next stage's prologue runs while the previous stage's
// products do. The statistics are column sums of the accumulator
// registers (shuffles across the eight rows of a warp, then the block's
// eight warps in shared memory: one row of ps and pss a block), and y is
// rounded into swizzled boxes in shared memory and written by one TMA
// store a box, which clips the rows past M and the columns past N and
// runs on while the next tile's products do. An
// N tile of 256 would halve the A re-reads at N >= 256 but needs 128
// accumulators a thread beside K5 and K6's two sets of A fragments,
// past the 168 registers a thread that 288 threads leave.
//
// Reached (chip_smoke.py and kernels/probe_sm90.py on an NVIDIA H100
// 80GB HBM3, 700 W; device time a call, cuBLAS's bare bf16 product in
// brackets): K4 0.173 ms at g0 (0.174) and 0.063 at g2 (0.052), near the
// product's own rate; K5 0.142 at g2 (0.057); K6 0.331 at g0 (0.194),
// 0.176 at g2 (0.056), 0.160 at g3 (0.046). K5 and K6 are limited by the
// prologue's f32 arithmetic on the register A fragments, done once for
// each N tile of a row (8 times at N 1024), during which the tensor
// cores wait. No kernel spills: 168 registers at most (K6, BN 128).
//
// TMA reads rows whose length is a multiple of 16 bytes from a 16-byte
// aligned base: K and N multiples of 8. The wrapper chooses by shape
// before any launch (`fused_dense_bn.py::kernel_route`): a bf16 or f16
// call whose K or N is not a multiple of 8, or whose x or w is not
// aligned, runs this kernel on zero-padded copies (K and N rounded up to
// 8, scale and shift padded with zeros, so the padded columns of the
// prologue's output are 0) and keeps y's and the sums' first N columns.
// Every ResNet-50 channel count is a multiple of 8.
//
// f32 and f64 run an FMA loop (64 x 64 tiles, 4 x 4 per thread): the
// reference multiplies f32 at full precision, so there is no TF32 here,
// and neither dtype is on the training path.
//
// C interface (loaded with ctypes): paddle_fused_dense_bn returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when TMA
// refuses a bf16 or f16 operand); it does not synchronise. dtype:
// 0 f32, 1 bf16, 2 f16, 3 f64. scale and shift are in the accumulator's
// dtype; ps and pss are [ceil(M / BM), N] in it (BM 128 for bf16 and
// f16, 64 for f32 and f64).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "sm90.cuh"

namespace {

// Storage type T, its accumulator Acc, and the roundings between them.
template <typename T>
struct Num;
template <>
struct Num<float> {
  using Acc = float;
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float a) { return a; }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};
template <>
struct Num<double> {
  using Acc = double;
  static __device__ __forceinline__ double in(double x) { return x; }
  static __device__ __forceinline__ double out(double a) { return a; }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
};
// The prologue on one element of x at column k: act(x * scale + shift)
// rounded to T, or 0 where the element lies outside the matrix.
template <typename T, bool PRO>
__device__ __forceinline__ T prologue(T v, bool valid, int k,
                                      const typename Num<T>::Acc* scale,
                                      const typename Num<T>::Acc* shift,
                                      int relu) {
  using Acc = typename Num<T>::Acc;
  if (!valid) return Num<T>::out(Acc(0));
  if (!PRO) return v;
  Acc a = Num<T>::add(Num<T>::mul(Num<T>::in(v), __ldg(scale + k)),
                      __ldg(shift + k));
  if (relu && a < Acc(0)) a = Acc(0);   // NaN passes, as jnp.maximum
  return Num<T>::out(a);
}

// The FMA kernel's epilogue. Cs holds the block's accumulator
// tile [BM][LDC]; red is scratch of 2 * NT accumulators. Stores y
// (rounded to T, 16 bytes at a time where the row allows) and, with
// STATS, the block's row of partial sums of y and y*y over its valid
// rows.
template <typename T, int BM, int BN, int LDC, int NT, bool STATS>
__device__ __forceinline__ void epilogue(
    const typename Num<T>::Acc* Cs, typename Num<T>::Acc* red, T* y,
    typename Num<T>::Acc* ps, typename Num<T>::Acc* pss, int64_t M, int N,
    int64_t m0, int n0, int64_t row_block) {
  using Acc = typename Num<T>::Acc;
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int rows = M - m0 < BM ? (int)(M - m0) : BM;
  const int cols = N - n0 < BN ? N - n0 : BN;
  const bool vec = (N % V) == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  for (int i = tid; i < BM * (BN / V); i += NT) {
    const int r = i / (BN / V);
    const int c = (i % (BN / V)) * V;
    if (r >= rows || c >= cols) continue;
    alignas(16) T out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = Num<T>::out(Cs[r * LDC + c + e]);
    T* dst = y + (m0 + r) * (int64_t)N + n0 + c;
    if (vec && c + V <= cols) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(out);
    } else {
      for (int e = 0; e < V && c + e < cols; ++e) dst[e] = out[e];
    }
  }
  if (!STATS) return;
  constexpr int SPLIT = NT / BN;         // threads summing one column
  const int col = tid % BN;
  const int part = tid / BN;
  Acc s = 0, ss = 0;
  for (int r = part; r < rows; r += SPLIT) {
    const Acc v = Cs[r * LDC + col];
    s += v;
    ss += v * v;
  }
  red[part * BN + col] = s;
  red[NT + part * BN + col] = ss;
  __syncthreads();
  if (tid < BN && tid < cols) {
    Acc ts = 0, tss = 0;
#pragma unroll
    for (int p = 0; p < SPLIT; ++p) {
      ts += red[p * BN + tid];
      tss += red[NT + p * BN + tid];
    }
    ps[row_block * N + n0 + tid] = ts;
    pss[row_block * N + n0 + tid] = tss;
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma, TMA, a producer warp
// ---------------------------------------------------------------------------

constexpr int GBM = 128;          // rows of y a block (two warpgroups of 64)
constexpr int GBK = 64;           // k a stage: one 128-byte box of x
constexpr int G_STAGES = 4;       // k stages in flight
constexpr int G_THREADS = 288;    // two consumer warpgroups + one warp
constexpr int G_CONSUMERS = 256;

// byte offsets in the block's shared memory (from a 1024-aligned base):
// the ring of stages (x's 128 x 64 box, then w's BN / 64 boxes of 64 k
// rows by 64 columns), the y tile (each warpgroup's BN / 64 boxes of
// 64 x 64), the partial sums of the eight consumer warps and the
// barriers
template <int BN>
struct MmSmem {
  static constexpr int A_BOX = GBM * 128;
  static constexpr int B_BOX = GBK * 128;
  static constexpr int STAGE = A_BOX + (BN / 64) * B_BOX;
  static constexpr int Y_BOX = 64 * 128;
  static constexpr int Y = G_STAGES * STAGE;
  static constexpr int RED = Y + 2 * (BN / 64) * Y_BOX;
  static constexpr int BAR = RED + 2 * 8 * BN * 4;
  static constexpr int BYTES = BAR + 8 * 2 * G_STAGES + 1024;
};

// K5 and K6's A fragments of one 64-wide k stage for this thread: x's
// elements from the swizzled box (rows row_a and row_a + 8 of the block,
// k columns 16 kk + 2c (+1, +8, +9)), act(x * scale + shift) in f32,
// rounded and packed as wgmma's 16-bit A operand; zero at or past M and
// K (the padded part of the tile)
template <typename T>
__device__ __forceinline__ void prologue_frags(
    uint32_t (&fr)[4][4], const unsigned char* a_box, int row_a, int g,
    int c, int k0, int K, bool row_ok0, bool row_ok1,
    const float* __restrict__ scale, const float* __restrict__ shift,
    int relu) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // k columns 16 kk + 2c + 8h (+1)
      const int k = k0 + 16 * kk + 2 * c + 8 * h;
      const bool k_ok = k < K;      // K is even: k + 1 < K too
      float2 sc = make_float2(0.f, 0.f), sh = sc;
      if (k_ok) {
        sc = __ldg(reinterpret_cast<const float2*>(scale + k));
        sh = __ldg(reinterpret_cast<const float2*>(shift + k));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows row_a + 8 i
        const bool ok = k_ok && (i ? row_ok1 : row_ok0);
        const uint32_t raw = *reinterpret_cast<const uint32_t*>(
            a_box + sm90::sw128(row_a + 8 * i, 2 * kk + h) + 4 * c);
        const T* e = reinterpret_cast<const T*>(&raw);
        float v0 = __fadd_rn(__fmul_rn(to_f32(e[0]), sc.x), sh.x);
        float v1 = __fadd_rn(__fmul_rn(to_f32(e[1]), sc.y), sh.y);
        if (relu) {                  // NaN passes, as jnp.maximum
          asm("max.NaN.f32 %0, %0, 0f00000000;" : "+f"(v0));
          asm("max.NaN.f32 %0, %0, 0f00000000;" : "+f"(v1));
        }
        fr[kk][2 * h + i] = ok ? sm90::pack2<T>(v0, v1) : 0u;
      }
    }
}

// A persistent block walks over 128 x BN tiles of y (n fastest, so the
// blocks running at once share x's rows in L2): consumer warpgroup wg
// owns a tile's rows 64 wg .. 64 wg + 63, and one producer warp streams
// the k stages of x and w through the ring, running ahead into the next
// tile while the consumers finish the last one. K4 (PRO false)
// multiplies from shared memory (ss); K5 and K6 take x through
// prologue_frags into registers (rs). One product group stays in
// flight: a stage is released once the next stage's group has been
// issued and the one before it retired.
template <typename T, int BN, bool PRO, bool STATS>
__global__ void __launch_bounds__(G_THREADS, 1)
fused_mm_bn_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap ty,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        float* __restrict__ ps, float* __restrict__ pss,
                        int M, int K, int N, int relu) {
  using L = MmSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + G_STAGES;

  const int gn = (N + BN - 1) / BN;
  const int n_tiles = (M + GBM - 1) / GBM * gn;
  const int nk = (K + GBK - 1) / GBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, G_CONSUMERS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= G_CONSUMERS) {   // the producer warp
    if (threadIdx.x == G_CONSUMERS) {
      int it = 0;                      // k stages issued, over all tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / gn * GBM, n0 = tile % gn * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % G_STAGES;
          if (it >= G_STAGES)
            sm90::mbar_wait(empty + s, (it / G_STAGES - 1) & 1);
          unsigned char* st = base + s * L::STAGE;
          sm90::mbar_arrive_expect_tx(full + s, L::STAGE);
          sm90::tma_load_2d(st, &tx, full + s, kt * GBK, m0);
#pragma unroll
          for (int x = 0; x < BN / 64; ++x)
            sm90::tma_load_2d(st + L::A_BOX + x * L::B_BOX, &tw, full + s,
                              n0 + 64 * x, kt * GBK);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int w = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int row_a = 64 * wg + 16 * w + g;   // this thread's rows, and + 8
  float* red = reinterpret_cast<float*>(base + L::RED);
  unsigned char* yb = base + L::Y + wg * (BN / 64) * L::Y_BOX;

  float acc[BN / 2];
  uint32_t fa[PRO ? 4 : 1][4], fb[PRO ? 4 : 1][4];
  int it = 0;                           // k stages consumed, over all tiles
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row_block = tile / gn;
    const int m0 = row_block * GBM, n0 = tile % gn * BN;
    const bool row_ok0 = m0 + row_a < M, row_ok1 = m0 + row_a + 8 < M;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    auto stage = [&](int kt, uint32_t (&fr)[PRO ? 4 : 1][4]) {
      const int s = it % G_STAGES;
      const unsigned char* st = base + s * L::STAGE;
      sm90::mbar_wait(full + s, (it / G_STAGES) & 1);
      if constexpr (PRO)
        prologue_frags<T>(fr, st, row_a, g, c, kt * GBK, K, row_ok0, row_ok1,
                          scale, shift, relu);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GBK / 16; ++kk) {
        // w's k rows 16 kk .. as the MN-major B operand
        const uint64_t db =
            sm90::desc_sw128(st + L::A_BOX + kk * 2048, L::B_BOX, 1024);
        if constexpr (PRO) {
          sm90::Wgmma<T, BN>::template rs<1>(acc, fr[kk], db, 1);
        } else {
          const uint64_t da = sm90::desc_sw128(
              st + wg * 64 * 128 + kk * 32, 16, 1024);
          sm90::Wgmma<T, BN>::template ss<1>(acc, da, db, 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();   // the previous stage's group has retired
      if (kt > 0) sm90::mbar_arrive(empty + (it - 1) % G_STAGES);
      ++it;
    };
    for (int kt = 0; kt < nk; kt += 2) {
      stage(kt, fa);
      if (kt + 1 < nk) stage(kt + 1, fb);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(empty + (it - 1) % G_STAGES);   // the tile's last

    if constexpr (STATS) {
      // column sums of the accumulator over this thread's valid rows,
      // then over the eight rows of the warp (lanes with one c), then
      // over the block's eight warps in shared memory; the first barrier
      // waits until the last tile's sums have been read
      const int warp8 = 4 * wg + w;
      sm90::named_sync(1, G_CONSUMERS);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = row_ok0 ? acc[4 * j + e] : 0.f;
          const float v1 = row_ok1 ? acc[4 * j + 2 + e] : 0.f;
          float s = v0 + v1, q = v0 * v0 + v1 * v1;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            q += __shfl_xor_sync(0xffffffffu, q, off);
          }
          if (g == 0) {
            red[warp8 * BN + 8 * j + 2 * c + e] = s;
            red[(8 + warp8) * BN + 8 * j + 2 * c + e] = q;
          }
        }
      sm90::named_sync(1, G_CONSUMERS);
      const int col = threadIdx.x;
      if (col < BN && n0 + col < N) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          s += red[p * BN + col];
          q += red[(8 + p) * BN + col];
        }
        ps[static_cast<int64_t>(row_block) * N + n0 + col] = s;
        pss[static_cast<int64_t>(row_block) * N + n0 + col] = q;
      }
    }

    // y: the accumulator rounded to T into this warpgroup's swizzled
    // boxes, once the last tile's stores have read them, then one TMA
    // store a box (rows past M and columns past N are not written)
    if (t == 0) sm90::bulk_wait_read();
    sm90::named_sync(2 + wg, 128);
    const int row_y = 16 * w + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            yb + (j / 8) * L::Y_BOX + sm90::sw128(row_y + 8 * i, j % 8) +
            4 * c) = sm90::pack2<T>(acc[4 * j + 2 * i],
                                    acc[4 * j + 2 * i + 1]);
    sm90::fence_proxy_async();
    sm90::named_sync(2 + wg, 128);
    if (t == 0 && m0 + 64 * wg < M) {
#pragma unroll
      for (int x = 0; x < BN / 64; ++x)
        if (n0 + 64 * x < N)
          sm90::tma_store_2d(&ty, yb + x * L::Y_BOX, n0 + 64 * x,
                             m0 + 64 * wg);
      sm90::bulk_commit();
    }
  }
  if (t == 0) sm90::bulk_wait_read();   // smem stays until read
}

// ---------------------------------------------------------------------------
// f32 / f64: an FMA loop
// ---------------------------------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16, FNT = 256;
constexpr int FLDA = FBM + 1;    // As is stored transposed: [FBK][FLDA]
constexpr int FLDB = FBN + 1;
constexpr int FLDC = FBN + 1;

template <typename T>
constexpr size_t fma_smem() {
  return sizeof(T) * (FBM * FLDC + 2 * FNT);     // >= the A and B tiles
}

template <typename T, bool PRO, bool STATS>
__global__ void __launch_bounds__(FNT)
fused_mm_bn_fma_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                       const T* __restrict__ shift, const T* __restrict__ w,
                       T* __restrict__ y, T* __restrict__ ps,
                       T* __restrict__ pss, int64_t M, int K, int N,
                       int relu) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  T* As = reinterpret_cast<T*>(g_smem);            // [FBK][FLDA]
  T* Bs = As + FBK * FLDA;                         // [FBK][FLDB]
  T* Cs = reinterpret_cast<T*>(g_smem);            // [FBM][FLDC], after
  T* red = Cs + FBM * FLDC;                        // [2][FNT]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int gn = (N + FBN - 1) / FBN;
  const int64_t row_block = blockIdx.x / gn;
  const int n0 = (int)(blockIdx.x % gn) * FBN;
  const int64_t m0 = row_block * FBM;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < FBM * FBK / FNT; ++i) {
      const int e = tid + i * FNT;
      const int r = e / FBK, k = e % FBK;
      const bool ok = m0 + r < M && k0 + k < K;
      const T v = ok ? x[(m0 + r) * (int64_t)K + k0 + k] : T(0);
      As[k * FLDA + r] = prologue<T, PRO>(v, ok, k0 + k, scale, shift, relu);
    }
#pragma unroll
    for (int i = 0; i < FBK * FBN / FNT; ++i) {
      const int e = tid + i * FNT;
      const int k = e / FBN, c = e % FBN;
      const bool ok = k0 + k < K && n0 + c < N;
      Bs[k * FLDB + c] = ok ? w[(int64_t)(k0 + k) * N + n0 + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * FLDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * FLDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty + 16 * i) * FLDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
  epilogue<T, FBM, FBN, FLDC, FNT, STATS>(Cs, red, y, ps, pss, M, N, m0, n0,
                                          row_block);
}

// The Hopper kernel at an N tile of BN; cudaErrorInvalidValue when TMA
// refuses an operand (the wrapper routes such shapes to a padded copy
// before the launch)
template <typename T, int BN, bool PRO, bool STATS>
cudaError_t launch_sm90_bn(const void* x, const void* scale,
                           const void* shift, const void* w, void* y,
                           void* ps, void* pss, int64_t M, int K, int N,
                           int relu, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if (M > 0x7fffffff - GBM) return cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  if (!sm90::make_map_2d(&mx, x, bf16, M, K, K, GBM) ||
      !sm90::make_map_2d(&mw, w, bf16, K, N, N, GBK) ||
      !sm90::make_map_2d(&my, y, bf16, M, N, N, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = MmSmem<BN>::BYTES;
  auto kern = fused_mm_bn_sm90_kernel<T, BN, PRO, STATS>;
  static cudaError_t set = cudaFuncSetAttribute(   // once a process
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaError_t err = set;
  if (err != cudaSuccess) return err;
  // one block an SM, each walking over tiles
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = ((M + GBM - 1) / GBM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kern<<<blocks, G_THREADS, smem, stream>>>(
      mx, mw, my, static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(ps),
      static_cast<float*>(pss), (int)M, K, N, relu);
  return cudaGetLastError();
}

// N tile: 64 where N is at most 64 (ResNet's g0 K4, N 64), else 128
template <typename T, bool PRO, bool STATS>
cudaError_t launch_sm90(const void* x, const void* scale, const void* shift,
                        const void* w, void* y, void* ps, void* pss,
                        int64_t M, int K, int N, int relu,
                        cudaStream_t stream) {
  if (N <= 64)
    return launch_sm90_bn<T, 64, PRO, STATS>(x, scale, shift, w, y, ps, pss,
                                             M, K, N, relu, stream);
  return launch_sm90_bn<T, 128, PRO, STATS>(x, scale, shift, w, y, ps, pss,
                                            M, K, N, relu, stream);
}

template <typename T, bool PRO, bool STATS>
cudaError_t launch_fma(const void* x, const void* scale, const void* shift,
                       const void* w, void* y, void* ps, void* pss,
                       int64_t M, int K, int N, int relu,
                       cudaStream_t stream) {
  const int64_t blocks = ((M + FBM - 1) / FBM) * ((N + FBN - 1) / FBN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  fused_mm_bn_fma_kernel<T, PRO, STATS>
      <<<(unsigned)blocks, FNT, fma_smem<T>(), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<const T*>(shift), static_cast<const T*>(w),
          static_cast<T*>(y), static_cast<T*>(ps), static_cast<T*>(pss), M, K,
          N, relu);
  return cudaGetLastError();
}

template <bool PRO, bool STATS>
cudaError_t dispatch(int dtype, const void* x, const void* scale,
                     const void* shift, const void* w, void* y, void* ps,
                     void* pss, int64_t M, int K, int N, int relu,
                     cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_fma<float, PRO, STATS>(x, scale, shift, w, y, ps, pss, M,
                                           K, N, relu, s);
    case 1:
      return launch_sm90<__nv_bfloat16, PRO, STATS>(x, scale, shift, w, y, ps,
                                                    pss, M, K, N, relu, s);
    case 2:
      return launch_sm90<__half, PRO, STATS>(x, scale, shift, w, y, ps, pss,
                                             M, K, N, relu, s);
    case 3:
      return launch_fma<double, PRO, STATS>(x, scale, shift, w, y, ps, pss,
                                            M, K, N, relu, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paddle_fused_dense_bn(const void* x, const void* scale,
                                     const void* shift, const void* w,
                                     void* y, void* ps, void* pss,
                                     long long M, int K, int N, int dtype,
                                     int prologue, int stats, int relu,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (prologue && stats)
    return (int)dispatch<true, true>(dtype, x, scale, shift, w, y, ps, pss, M,
                                     K, N, relu, s);
  if (prologue)
    return (int)dispatch<true, false>(dtype, x, scale, shift, w, y, ps, pss,
                                      M, K, N, relu, s);
  if (stats)
    return (int)dispatch<false, true>(dtype, x, scale, shift, w, y, ps, pss,
                                      M, K, N, relu, s);
  return (int)cudaErrorInvalidValue;
}
