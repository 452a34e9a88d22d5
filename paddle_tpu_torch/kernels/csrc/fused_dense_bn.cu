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
// What this simple design does about that bound. bf16 and f16 run on
// the tensor cores through nvcuda::wmma (16x16x16, f32 accumulate):
// 256 threads own a 128 x 128 tile of y, eight warps of 32 x 64 each;
// k advances 32 at a time through shared memory, the next k tile's
// global loads (16 bytes a thread where the row allows) issued before
// the current one's products, and the prologue applied as the tile is
// written to shared memory (K5 and K6 run two blocks an SM, so one
// block's prologue overlaps the other's products). The accumulator
// tile then goes through shared memory once: y rounded and stored 16
// bytes at a time, and the column sums taken there, so the statistics
// cost no pass over y in device memory. f32 and f64 run an FMA loop (64 x 64 tiles, 4 x 4 per
// thread): the reference multiplies f32 at full precision, so there is
// no TF32 here, and neither dtype is on the training path. No wgmma, no
// TMA, no warp specialisation: later work.
//
// C interface (loaded with ctypes): paddle_fused_dense_bn returns
// cudaGetLastError() after the launch; it does not synchronise. dtype:
// 0 f32, 1 bf16, 2 f16, 3 f64. scale and shift are in the accumulator's
// dtype; ps and pss are [ceil(M / BM), N] in it (BM 128 for bf16 and
// f16, 64 for f32 and f64).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
template <>
struct Num<__nv_bfloat16> : Num<float> {
  static __device__ __forceinline__ float in(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float a) {
    return __float2bfloat16_rn(a);
  }
};
template <>
struct Num<__half> : Num<float> {
  static __device__ __forceinline__ float in(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half out(float a) {
    return __float2half_rn(a);
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

// V consecutive elements of a row from global memory: one 16-byte load
// when the row allows it (`vec`: the row length is a multiple of V and
// all V lie inside the row), else one element at a time, 0 past `n`.
template <typename T, int V>
__device__ __forceinline__ void load_chunk(T (&dst)[V], const T* src,
                                           bool row_ok, int c, int n,
                                           bool vec) {
  if (row_ok && vec && c + V <= n) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      dst[e] = (row_ok && c + e < n) ? src[e] : Num<T>::out(0);
  }
}

// The epilogue shared by both kernels. Cs holds the block's accumulator
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
// bf16 / f16: tensor cores through wmma
// ---------------------------------------------------------------------------

constexpr int WBM = 128, WBN = 128, WBK = 32, WNT = 256;
constexpr int LDA = WBK + 8;     // T elements: rows 16-byte aligned, skewed
constexpr int LDB = WBN + 8;
constexpr int LDC = WBN + 4;     // floats
constexpr int A_CHUNKS = WBM * WBK / 8 / WNT;   // 16-byte chunks a thread
constexpr int B_CHUNKS = WBK * WBN / 8 / WNT;
constexpr size_t WMMA_SMEM =
    sizeof(float) * (WBM * LDC + 2 * WNT);     // >= the A and B tiles

// With the prologue, two blocks an SM (at most 128 registers a thread)
// hide its arithmetic behind the other block's products: K6 took 20-34%
// less time at ResNet-50's shapes on an H100 (chip_smoke.py phase 2).
// Without it, one block an SM keeps its 165 registers: at 128 ptxas
// spills the accumulators.
template <typename T, bool PRO, bool STATS>
__global__ void __launch_bounds__(WNT, PRO ? 2 : 1)
fused_mm_bn_wmma_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const T* __restrict__ w, T* __restrict__ y,
                        float* __restrict__ ps, float* __restrict__ pss,
                        int64_t M, int K, int N, int relu) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char g_smem[];
  T* As = reinterpret_cast<T*>(g_smem);            // [WBM][LDA]
  T* Bs = As + WBM * LDA;                          // [WBK][LDB]
  float* Cs = reinterpret_cast<float*>(g_smem);    // [WBM][LDC], after
  float* red = Cs + WBM * LDC;                     // [2][WNT]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;          // 4 x 2 warps
  const int gn = (N + WBN - 1) / WBN;
  const int64_t row_block = blockIdx.x / gn;       // n fastest: blocks of
  const int n0 = (int)(blockIdx.x % gn) * WBN;     // one row block share x
  const int64_t m0 = row_block * WBM;
  const bool vec_a = (K % 8) == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_b = (N % 8) == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;

  alignas(16) T ra[A_CHUNKS][8];
  alignas(16) T rb[B_CHUNKS][8];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * WNT;
      const int r = c / (WBK / 8), kc = (c % (WBK / 8)) * 8;
      const bool ok = m0 + r < M;
      load_chunk<T, 8>(ra[i], x + (m0 + r) * (int64_t)K + k0 + kc, ok,
                       k0 + kc, K, vec_a);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * WNT;
      const int kr = c / (WBN / 8), nc = (c % (WBN / 8)) * 8;
      const bool ok = k0 + kr < K;
      load_chunk<T, 8>(rb[i], w + (int64_t)(k0 + kr) * N + n0 + nc, ok,
                       n0 + nc, N, vec_b);
    }
  };
  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * WNT;
      const int r = c / (WBK / 8), kc = (c % (WBK / 8)) * 8;
      const bool ok = m0 + r < M;
      alignas(16) T v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = prologue<T, PRO>(ra[i][e], ok && k0 + kc + e < K,
                                k0 + kc + e, scale, shift, relu);
      *reinterpret_cast<uint4*>(As + r * LDA + kc) =
          *reinterpret_cast<const uint4*>(v);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * WNT;
      const int kr = c / (WBN / 8), nc = (c % (WBN / 8)) * 8;
      alignas(16) T v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rb[i][e];
      *reinterpret_cast<uint4*>(Bs + kr * LDB + nc) =
          *reinterpret_cast<const uint4*>(v);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += WBK) {
    store(k0);
    __syncthreads();
    if (k0 + WBK < K) load(k0 + WBK);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  epilogue<T, WBM, WBN, LDC, WNT, STATS>(Cs, red, y, ps, pss, M, N, m0, n0,
                                         row_block);
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

template <typename T, bool PRO, bool STATS>
cudaError_t launch_wmma(const void* x, const void* scale, const void* shift,
                        const void* w, void* y, void* ps, void* pss,
                        int64_t M, int K, int N, int relu,
                        cudaStream_t stream) {
  auto kern = fused_mm_bn_wmma_kernel<T, PRO, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WMMA_SMEM);
  if (err != cudaSuccess) return err;
  const int64_t blocks = ((M + WBM - 1) / WBM) * ((N + WBN - 1) / WBN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, WNT, WMMA_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(w),
      static_cast<T*>(y), static_cast<float*>(ps), static_cast<float*>(pss),
      M, K, N, relu);
  return cudaGetLastError();
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
      return launch_wmma<__nv_bfloat16, PRO, STATS>(x, scale, shift, w, y, ps,
                                                    pss, M, K, N, relu, s);
    case 2:
      return launch_wmma<__half, PRO, STATS>(x, scale, shift, w, y, ps, pss,
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
