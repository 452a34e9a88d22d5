// Flash-attention forward for Hopper (sm_90a): exact softmax attention
// over [B, T, N, H] tensors, causal or full, with an online softmax.
//
// Replaces: the JAX package's ops/pallas/attention.py::_splash_mha, i.e.
// jax's Pallas `splash_attention` forward kernel (make_splash_mha with a
// CausalMask or FullMask), which the serving path reaches through
// mha(causal=True) in models/gpt.py::apply_prefill. Same semantics:
// q is multiplied by the scale and rounded to q's dtype before the
// product (splash applies no scale itself; its caller folds it into q),
// scores, the running max and sum, and the output accumulator are f32,
// and the output is written in the input dtype. With an `lse` pointer
// the kernel also writes each row's logsumexp m + log(l) in f32
// ([B, N, Tq]), the residual of the backward kernels
// (flash_attention_bwd.cu) and the output of the JAX package's
// _splash_block_with_lse (ring attention's block); serving passes NULL.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at the
// serving path's largest call (B=1, T=1024, N=12, H=64, bf16, causal)
// q, k, v and o are 4 x 1.57 MB = 6.29 MB, 1.88 us at the memory rate,
// and the causal products are 2*2*T*(T+1)/2*H*N = 1.61 GFLOP, 1.63 us at
// the tensor-core rate: the call is memory-bound at about 1.9 us.
//
// Two kernels share the tiling idea: every byte of q, k and v is read
// from device memory once per query tile that needs it, the T x T
// scores never leave the SM, so device traffic stays O(T*H), and key
// tiles wholly above the diagonal are skipped (half the causal work).
//
// bf16 and f16: flash_fwd_sm90_kernel, on the tensor cores. One block
// owns 128 query rows of one (batch, head): two consumer warpgroups of
// 64 rows each and one producer warp (288 threads). The producer loads
// the q tile once and then the k and v tiles of 128 keys by TMA (4-d
// tensor maps over [B, T, N, H] with the tensors' own strides, so the
// views of a fused qkv projection need no copy) into a ring of two
// stages, each completing on its own mbarrier; the consumers release a
// stage once both warpgroups' products on it have retired. Each
// warpgroup scales its q rows in shared memory in place (rounded to T,
// then fence.proxy.async before wgmma reads them), takes S = Q K^T with
// wgmma from shared memory (128-byte swizzle), keeps the masking, the
// online softmax, the running max and sum and the LSE in f32 registers,
// and takes O += P V with P from registers as wgmma's A operand (the
// accumulator's register layout is the A fragment's) and v as the
// MN-major B operand. splash multiplies its f32 p by v in f32
// (splash_attention_kernel.py, `v.astype(float32)` before the product),
// and wgmma takes 16-bit operands only, so P goes in as two parts, hi =
// round(P) and lo = round(P - hi): P keeps about 16 significant bits
// (bf16) or 22 (f16) for one more product. Rounding P once would move
// 36-41% of the bf16 outputs off splash's, by up to 1e-2 of their RMS
// beyond one rounding step (tests/test_torch_hopper_numerics.py). The
// causal diagonal tile and Tk's ragged edge are masked to -inf (TMA
// reads rows past Tk as zeros); rows past Tq are not stored; causal
// grids launch the longest query tiles first. This removes the FMA
// kernel's limit (the products on the FP32 pipes from f32 shared
// memory, loads synchronous, nothing in flight), at one block an SM:
// within a warpgroup the softmax still waits for its product and the
// next tile's product for its softmax, which is later work.
//
// f32: flash_fwd_kernel, on the FP32 FMA pipes. wgmma has no full-f32
// form and TF32 keeps about three decimal digits, which the f32 parity
// gates (chip_smoke.py phases 6, 9, 14 and 16, TF32 off) would not
// pass; f32 is not on the training path. 256 threads as a 16 x 16 grid
// own a 64-query tile of one (batch, head). Thread (ty, tx) holds
// score rows ty + 16*i (i < 4) and columns tx + 16*j (j < 4) of each
// 64 x 64 score tile, and output columns tx + 16*d of the same rows.
// Row maxima and sums reduce over the 16 lanes sharing ty (one
// half-warp) with shuffles.
//
// C interface (loaded with ctypes): paddle_flash_attention_fwd returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue when TMA
// refuses a bf16/f16 tensor: the wrapper checks its rules first); it
// does not synchronise. Inputs are float32, bfloat16 or float16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the FMA kernel

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // key rows per tile
constexpr int TX = 16;              // threads across score / output columns
constexpr int TY = 16;              // threads across query rows
constexpr int NTHREADS = TX * TY;   // 256
constexpr int RPT = BQ / TY;        // query rows per thread
constexpr int CPT = BK / TX;        // score columns per thread
constexpr int LDP = BK + 1;         // padded row length of the score tile

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int N,
                 int Tq, int Tk, int64_t q_sb, int64_t q_st, int64_t q_sn,
                 int64_t k_sb, int64_t k_st, int64_t k_sn, int64_t v_sb,
                 int64_t v_st, int64_t v_sn, float scale, int causal) {
  constexpr int LD = HD + 1;        // padded row length of q/k/v tiles
  constexpr int DPT = HD / TX;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ps = Vs + BK * LD;         // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;

  const T* qb = q + b * q_sb + n * q_sn;
  const T* kb = k + b * k_sb + n * k_sn;
  const T* vb = v + b * v_sb + n * v_sn;

  // q tile, scaled and rounded to T as splash's caller does; rows past
  // Tq are zero and never written out
  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD, t = q0 + r;
    float x = 0.f;
    if (t < Tq) x = round_to<T>(to_f32(qb[t * q_st + c]) * scale);
    Qs[r * LD + c] = x;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD, c = i % HD, t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = to_f32(kb[t * k_st + c]);
        vx = to_f32(vb[t * v_st + c]);
      }
      Ks[r * LD + c] = kx;
      Vs[r * LD + c] = vx;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int h = 0; h < HD; ++h) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + TY * i) * LD + h];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + TX * j) * LD + h];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask the ragged edge and the upper triangle, then fold the tile
    // into each row's running max, sum and accumulator
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + TX * j;
        if (col >= Tk || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no unmasked key yet keeps alpha = 1 and p = 0
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty + TY * i) * LDP + tx + TX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vv[d] = Vs[c * LD + tx + TX * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + TY * i) * LDP + c];
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

  // o is contiguous [B, Tq, N, HD]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Tq) continue;
    const float inv = 1.f / l[i];
    T* orow = o + ((static_cast<int64_t>(b) * Tq + row) * N + n) * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[tx + TX * d] = from_f32<T>(acc[i][d] * inv);
    // lse is contiguous [B, N, Tq]; blockIdx.y = b * N + n
    if (lse != nullptr && tx == 0)
      lse[static_cast<int64_t>(blockIdx.y) * Tq + row] = m[i] + logf(l[i]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ + 2 * BK) * (HD + 1) +
                          static_cast<size_t>(BQ) * LDP);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int Tq, int Tk, const int64_t* st,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * N);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, N, Tq, Tk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 and f16: the Hopper kernel (wgmma, TMA, a producer warp)

constexpr int H_BK = 128;      // key rows per tile
constexpr int H_STAGES = 2;    // k/v tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      T* __restrict__ o, float* __restrict__ lse, int N,
                      int Tq, int Tk, float scale, int causal) {
  using L = sm90::AttnSmem<HD, H_BK, H_STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + H_STAGES;
  uint64_t* empty = v_full + H_STAGES;

  // causal: the longest rows (the last query tiles) are launched first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * sm90::ATT_BQ;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;
  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + sm90::ATT_BQ) : Tk;
  const int n_tiles = (k_end + H_BK - 1) / H_BK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bars, 1);
    for (int s = 0; s < H_STAGES; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(empty + s, sm90::ATT_CONSUMERS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= sm90::ATT_CONSUMERS) {   // the producer warp
    if (threadIdx.x == sm90::ATT_CONSUMERS)
      sm90::attn_produce<HD, H_BK, H_STAGES>(base, &tq, &tk, &tv, b, n, q0,
                                             n_tiles);
    return;
  }

  const int wg = threadIdx.x / 128;      // consumer warpgroup: rows 64 wg ..
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c = lane % 4;
  const int wrow = q0 + 64 * wg;         // the warpgroup's first row
  const int row0 = wrow + 16 * (t / 32) + lane / 4;   // and row0 + 8

  // q * scale rounded to T, in place (elementwise, so the swizzle does
  // not matter), as splash's caller folds the scale into q; then made
  // visible to wgmma's async proxy before the warpgroup reads it
  sm90::mbar_wait(bars, 0);
#pragma unroll
  for (int x = 0; x < L::NBOX; ++x) {
    uint4* qv = reinterpret_cast<uint4*>(base + L::Q + x * L::BOX_Q +
                                         wg * 64 * 128);
    for (int i = t; i < 64 * 128 / 16; i += 128) {
      uint4 w = qv[i];
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
      qv[i] = w;
    }
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1 + wg, 128);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this lane's part of each row's sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % H_STAGES;
    const uint32_t parity = (kt / H_STAGES) & 1;
    const int k0 = kt * H_BK;
    float p[H_BK / 2];
    sm90::mbar_wait(k_full + s, parity);
    sm90::attn_qk<T, HD, H_BK, H_STAGES>(p, base, base + L::K + s * L::TILE_K,
                                         wg);

    // the ragged edge of Tk and, on the diagonal tile, the keys above
    // each row: -inf
    if (k0 + H_BK > Tk || (causal && k0 + H_BK - 1 > wrow)) {
#pragma unroll
      for (int j = 0; j < H_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * c + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (col >= Tk || (causal && col > row)) p[4 * j + e] = -INFINITY;
        }
    }
    // fold the tile into each row's running max and sum; p = exp(s - m)
    // in f32 (exp2 of the scores in base 2), the sum of the f32 p
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < H_BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(p[4 * j + 2 * i], p[4 * j + 2 * i + 1]));
      mx = sm90::quad_max(mx);
      // a row with no unmasked key yet keeps p = 0 and alpha = 0 on
      // its zero sums
      const float ms = mx == -INFINITY ? 0.f : mx * LOG2E;
      const float alpha = sm90::exp2_approx(fmaf(m[i], LOG2E, -ms));
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < H_BK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          p[4 * j + e] = sm90::exp2_approx(fmaf(p[4 * j + e], LOG2E, -ms));
          rs += p[4 * j + e];
        }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 2 * i] *= alpha;
        acc[4 * j + 2 * i + 1] *= alpha;
      }
    }
    // P in two 16-bit parts, as splash multiplies its f32 p by v
    sm90::mbar_wait(v_full + s, parity);
    sm90::attn_pv<T, HD, H_BK, H_STAGES, true>(acc, p,
                                               base + L::V + s * L::TILE_K);
    sm90::mbar_arrive(empty + s);   // both products have read the stage
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = sm90::quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
  sm90::attn_store<T, HD>(o, acc, inv, b, n, N, Tq, row0, c);
  // lse is contiguous [B, N, Tq]; blockIdx.y = b * N + n
  if (lse != nullptr && c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Tq)
        lse[static_cast<int64_t>(blockIdx.y) * Tq + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int N, int Tq, int Tk,
                        const int64_t* st, float scale, int causal,
                        cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map_bthn(&mq, q, bf16, B, Tq, N, HD, st[0], st[1], st[2],
                           sm90::ATT_BQ) ||
      !sm90::make_map_bthn(&mk, k, bf16, B, Tk, N, HD, st[3], st[4], st[5],
                           H_BK) ||
      !sm90::make_map_bthn(&mv, v, bf16, B, Tk, N, HD, st[6], st[7], st[8],
                           H_BK))
    return cudaErrorInvalidValue;
  constexpr int smem = sm90::AttnSmem<HD, H_BK, H_STAGES>::BYTES;
  auto kernel = flash_fwd_sm90_kernel<T, HD>;
  static cudaError_t err = cudaFuncSetAttribute(   // once a process
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + sm90::ATT_BQ - 1) / sm90::ATT_BQ, B * N);
  kernel<<<grid, sm90::ATT_THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), lse, N, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// Strides are in elements; the last dimension of q, k and v must have
// stride 1. lse: NULL, or f32 [B, N, Tq] to receive each row's
// logsumexp.
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int N,
    int Tq, int Tk, int head_dim, int dtype, long long q_sb, long long q_st,
    long long q_sn, long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn, float scale, int causal,
    void* lse, void* stream) {
  if (B < 1 || N < 1 || Tq < 1 || Tk < 1 || B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[9] = {q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define PADDLE_FWD(TYPE, HD) \
  launch<TYPE, HD>(q, k, v, o, l, B, N, Tq, Tk, st, scale, causal, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) err = PADDLE_FWD(float, 64);
  else if (dtype == 0 && head_dim == 128) err = PADDLE_FWD(float, 128);
#undef PADDLE_FWD
#define PADDLE_FWD_SM90(TYPE, HD) \
  launch_sm90<TYPE, HD>(q, k, v, o, l, B, N, Tq, Tk, st, scale, causal, s)
  else if (dtype == 1 && head_dim == 64) err = PADDLE_FWD_SM90(__nv_bfloat16, 64);
  else if (dtype == 1 && head_dim == 128) err = PADDLE_FWD_SM90(__nv_bfloat16, 128);
  else if (dtype == 2 && head_dim == 64) err = PADDLE_FWD_SM90(__half, 64);
  else if (dtype == 2 && head_dim == 128) err = PADDLE_FWD_SM90(__half, 128);
#undef PADDLE_FWD_SM90
  return static_cast<int>(err);
}
