// Flash-attention forward with an additive bias for Hopper (sm_90a):
// softmax attention over [B, T, N, H] tensors with an f32 bias read
// through four element strides ([B, N, Tq, Tk] in the kernel's view),
// optionally causal, with an online softmax.
//
// Replaces: the JAX package's ops/pallas/attention.py::_pallas_mha,
// i.e. jax's legacy Pallas `flash_attention` forward
// (jax/experimental/pallas/ops/tpu/flash_attention.py, the
// _flash_attention_kernel that pallas_call runs), which the padded
// paths reach through mha(mask=...): models/transformer.py's encoder
// self-attention and cross-attention, and models/bert.py with an
// attention_mask. Same semantics, which are not splash's:
//
//   s = f32(q k^T) from the unscaled q; s += bias; s *= scale; causal
//   positions get + MASK_VALUE (-0.7 * FLT_MAX), not -inf;
//   keys in blocks of 128 (the reference's block): where all of them
//   fit one block, m = rowmax(s), p = exp(s - m), l = rowsum(p) and
//   out = round(p / l) @ v (the reference's one-step kernel); else,
//   per key block, m_next = max(m, rowmax(s)), p = exp(s - m_next),
//   l_corr = exp(m - m_next) * l, l_next = rowsum(p) + l_corr,
//   acc = acc * (l_corr / l_next) + (round(p) @ v) / l_next (1/l taken
//   as 1 where l is 0), skipping causal key blocks wholly above the
//   128-row query block; round() is the rounding to v's dtype. The
//   output is rounded once to q's dtype, and each row's l and m are
//   written (f32 [B, N, Tq]) for the backward kernels
//   (flash_attention_bias_bwd.cu). Keeping the reference's blocks keeps
//   its roundings of p at bf16: other blocks move the output by a bf16
//   step and, through delta, the gradients by more.
//
// The bias is read in place: mha's [B, 1, 1, Tk] key-padding mask comes
// as a stride-0 view, so the [B, N, Tq, Tk] f32 tensor that the JAX
// package's caller broadcasts is never built.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at
// Transformer-big's encoder call (B=128, T=Tk=128, N=16, H=64, bf16)
// q, k, v and o are 4 x 33.6 MB = 134 MB (40 us at the memory rate)
// plus a 64 KB key mask, against 2 products of 2*T*Tk*H per head,
// 8.6 GFLOP (8.7 us at the tensor-core rate): memory-bound at 40 us.
//
// Two kernels share the tiling idea: every byte of q, k and v is read
// once per query tile that needs it, and the T x Tk scores never leave
// the SM, so device traffic stays O(T*H); the bias is read once per
// score, a broadcast mask from cache.
//
// bf16 and f16: flash_bias_fwd_sm90_kernel, on the tensor cores, with
// the pipeline of flash_attention.cu's Hopper kernel (sm90.cuh): 128
// query rows a block in two consumer warpgroups and one producer warp,
// q once and k and v in tiles of 128 keys (the reference's block) by
// TMA through a two-stage ring of mbarriers, S = Q K^T and O += P V on
// wgmma, P rounded to v's dtype as the reference rounds it and fed from
// registers. The bias is read in the accumulator's register layout from
// global memory and L2; mha's key mask ([B, 1, 1, Tk], stride 0 across
// heads and rows, 8-byte aligned) takes a variant that reads it as
// pairs of columns before the product, so the loads overlap it. With
// 128-row query tiles the reference's causal skip is tile-aligned. The
// reference renormalises its accumulator on every key block; this one
// keeps it unnormalised (rescaled by exp(m - m_next)) and divides by l
// once, which moves only f32 roundings; the one-step case divides p by
// l before its rounding, as the reference (a / l from 1 / l and one
// residual step). This removes the FMA kernel's limit (the products on
// the FP32 pipes from f32 shared memory); within a warpgroup the
// softmax still waits for its product, which is later work.
//
// f32: flash_bias_fwd_kernel, on the FP32 FMA pipes: wgmma has no
// full-f32 form and TF32 would not pass the f32 parity gates
// (chip_smoke.py phases 9 and 14, TF32 off). 256 threads as a 16 x 16
// grid own a 64-query tile of one (batch, head): thread (ty, tx) holds
// score rows ty + 16*i (i < 4) and columns tx + 16*j (j < 8) of each
// 64 x 128 score tile, and output columns tx + 16*d of the same rows.
// The p tile reuses the k tile's shared memory once the scores are
// taken, so the q, k and v tiles take 83 KB at H=64 (two blocks per SM)
// and 165 KB at H=128 (one).
//
// C interface (loaded with ctypes): paddle_flash_attention_bias_fwd
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// when TMA refuses a bf16/f16 tensor: the wrapper checks its rules
// first); it does not synchronise.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the FMA kernel (BK, QB, MASK_VALUE and Strides serve both kernels)

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 128;             // key rows per tile: the reference's
                                    // block, whose roundings it keeps
constexpr int QB = 128;             // the reference's query block, for
                                    // the causal skip
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NTHREADS = TX * TY;   // 256
constexpr int RPT = BQ / TY;        // query rows per thread
constexpr int CPT = BK / TX;        // score columns per thread
constexpr int LDP = BK + 1;         // padded row length of the score tile
// jax's DEFAULT_MASK_VALUE, rounded to f32 from the double product
constexpr float MASK_VALUE = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

// element strides of q, k, v ([B, T, N, H]; H has stride 1) and of the
// bias ([B, N, Tq, Tk] view)
struct Strides {
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn;
  int64_t a_sb, a_sn, a_st, a_ss;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bias_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      T* __restrict__ o, float* __restrict__ l_out,
                      float* __restrict__ m_out, int N, int Tq, int Tk,
                      Strides st, float scale, int causal) {
  constexpr int LD = HD + 1;        // padded row length of q/k/v tiles
  constexpr int DPT = HD / TX;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ps = Ks;                   // [BQ][LDP], round(p), over the k
                                    // tile once the scores are taken
  static_assert(BQ * LDP <= BK * LD, "the p tile must fit the k tile");

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / N;
  const int n = blockIdx.y % N;

  const T* qb = q + b * st.q_sb + n * st.q_sn;
  const T* kb = k + b * st.k_sb + n * st.k_sn;
  const T* vb = v + b * st.v_sb + n * st.v_sn;
  const float* ab = bias + b * st.a_sb + n * st.a_sn;

  // the unscaled q tile; rows past Tq are zero and never written out
  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD, t = q0 + r;
    Qs[r * LD + c] = t < Tq ? to_f32(qb[t * st.q_st + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;
  }

  // causal: key blocks wholly above this tile's 128-row query block
  // are skipped, as the reference skips blocks that are not below or on
  // the diagonal; keys that fit one block take the one-step softmax
  const int k_end = causal ? min(Tk, (q0 / QB + 1) * QB) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const bool one_step = Tk <= BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD, c = i % HD, t = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        kx = to_f32(kb[t * st.k_st + c]);
        vx = to_f32(vb[t * st.v_st + c]);
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
    __syncthreads();  // every Ks read is done before Ps overwrites it

    // bias, scale and causal mask; columns past Tk drop out (-inf, p = 0)
    float corr[RPT], inv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + TX * j;
        float x = -INFINITY;
        if (col < Tk) {
          x = s[i][j];
          if (row < Tq) x += ab[row * st.a_st + col * st.a_ss];
          x *= scale;
          if (causal && col > row) x += MASK_VALUE;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // column k0 < Tk is in every tile, so m_next is finite
      const float m_next = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_next);   // p
        rs += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float l_corr = expf(m[i] - m_next) * l[i];
      const float l_next = rs + l_corr;
      inv[i] = (l_next == 0.f) ? 1.f : 1.f / l_next;
      corr[i] = l_corr * inv[i];
      l[i] = l_next;
      m[i] = m_next;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Ps[(ty + TY * i) * LDP + tx + TX * j] =
            round_to<T>(one_step ? s[i][j] / l_next : s[i][j]);
    }
    __syncthreads();

    float oc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int d = 0; d < DPT; ++d) oc[i][d] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vv[d] = Vs[c * LD + tx + TX * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + TY * i) * LDP + c];
#pragma unroll
        for (int d = 0; d < DPT; ++d) oc[i][d] = fmaf(p, vv[d], oc[i][d]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int d = 0; d < DPT; ++d)
        acc[i][d] = one_step ? oc[i][d]
                             : acc[i][d] * corr[i] + oc[i][d] * inv[i];
  }

  // o is contiguous [B, Tq, N, HD]; l and m contiguous [B, N, Tq]
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Tq) continue;
    T* orow = o + ((static_cast<int64_t>(b) * Tq + row) * N + n) * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) orow[tx + TX * d] = from_f32<T>(acc[i][d]);
    if (tx == 0) {
      const int64_t r = static_cast<int64_t>(blockIdx.y) * Tq + row;
      l_out[r] = l[i];
      m_out[r] = m[i];
    }
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * static_cast<size_t>(BQ + 2 * BK) * (HD + 1);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* l, float* m, int B,
                   int N, int Tq, int Tk, const Strides& st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_bias_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, B * N);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), l, m, N, Tq, Tk,
      st, scale, causal);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 and f16: the Hopper kernel (wgmma, TMA, a producer warp)

constexpr int H_STAGES = 2;    // k/v tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// a / b correctly rounded from r = 1 / b (one residual step): the
// reference's p / l without a division per element
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// KEY_MASK: the bias is one row of Tk values for every query row (mha's
// [B, 1, 1, Tk] padding mask: a_st 0, a_ss 1, 8-byte aligned rows), read
// as pairs of columns before the product so that the loads overlap it;
// otherwise every score reads its own element through the four strides
template <typename T, int HD, bool KEY_MASK>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_bias_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ bias, T* __restrict__ o,
                           float* __restrict__ l_out,
                           float* __restrict__ m_out, int N, int Tq, int Tk,
                           int64_t a_sb, int64_t a_sn, int64_t a_st,
                           int64_t a_ss, float scale, int causal) {
  using L = sm90::AttnSmem<HD, BK, H_STAGES>;
  static_assert(sm90::ATT_BQ == QB, "query tiles are the reference's blocks");
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
  // causal: key blocks wholly above this 128-row query block are
  // skipped, as the reference skips them; keys that fit one block take
  // the one-step softmax
  const int k_end = causal ? min(Tk, q0 + QB) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const bool one_step = Tk <= BK;

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
      sm90::attn_produce<HD, BK, H_STAGES>(base, &tq, &tk, &tv, b, n, q0,
                                           n_tiles);
    return;
  }

  const int wg = threadIdx.x / 128;      // consumer warpgroup: rows 64 wg ..
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // and row0 + 8
  const float* ab = bias + b * a_sb + n * a_sn;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this lane's part of each row's sum

  sm90::mbar_wait(bars, 0);   // the unscaled q tile
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % H_STAGES;
    const uint32_t parity = (kt / H_STAGES) & 1;
    const int k0 = kt * BK;
    float p[BK / 2];
    float2 mask[KEY_MASK ? BK / 8 : 1];
    if constexpr (KEY_MASK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = k0 + 8 * j + 2 * c;
        if (col + 1 < Tk) {
          mask[j] = __ldg(reinterpret_cast<const float2*>(ab + col));
        } else {
          mask[j].x = col < Tk ? __ldg(ab + col) : 0.f;
          mask[j].y = 0.f;
        }
      }
    }
    sm90::mbar_wait(k_full + s, parity);
    sm90::attn_qk<T, HD, BK, H_STAGES>(p, base, base + L::K + s * L::TILE_K,
                                       wg);

    // bias (in the accumulator's layout), scale and causal mask; columns
    // past Tk drop out (-inf, p = 0)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * c + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        float x = -INFINITY;
        if (col < Tk) {
          x = p[4 * j + e];
          if (row < Tq) {
            if constexpr (KEY_MASK)
              x += (e & 1) ? mask[j].y : mask[j].x;
            else
              x += __ldg(ab + row * a_st + col * a_ss);
          }
          x *= scale;
          if (causal && col > row) x += MASK_VALUE;
        }
        p[4 * j + e] = x;
      }
    // fold the tile into each row's running max and sum of the f32 p
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(p[4 * j + 2 * i], p[4 * j + 2 * i + 1]));
      // column k0 < Tk is in every tile, so the max is finite
      mx = sm90::quad_max(mx);
      alpha[i] = sm90::exp2_approx((m[i] - mx) * LOG2E);
      m[i] = mx;
      // p = expf(s - m), as the plain version computes it: p is rounded
      // to v's dtype, and an approximate exp rounds more p the other
      // way (one f16 seed of six went past ELEM_TOL with exp2)
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          p[4 * j + e] = expf(p[4 * j + e] - mx);
          rs += p[4 * j + e];
        }
      l[i] = l[i] * alpha[i] + rs;
    }
    if (one_step) {
      // the reference's one-step kernel: round(p / l) @ v, with l the
      // whole row's sum
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = sm90::quad_sum(l[i]);
        const float r = 1.f / l[i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          p[4 * j + 2 * i] = div_by(p[4 * j + 2 * i], l[i], r);
          p[4 * j + 2 * i + 1] = div_by(p[4 * j + 2 * i + 1], l[i], r);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    }
    // p rounded to v's dtype before the product, as the reference
    sm90::mbar_wait(v_full + s, parity);
    sm90::attn_pv<T, HD, BK, H_STAGES, false>(acc, p,
                                              base + L::V + s * L::TILE_K);
    sm90::mbar_arrive(empty + s);   // both products have read the stage
  }

  // the reference renormalises its accumulator on every key block; this
  // accumulator is unnormalised and divided once (1/l as 1 where l is 0)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!one_step) l[i] = sm90::quad_sum(l[i]);
    inv[i] = (one_step || l[i] == 0.f) ? 1.f : 1.f / l[i];
  }
  sm90::attn_store<T, HD>(o, acc, inv, b, n, N, Tq, row0, c);
  // l and m contiguous [B, N, Tq]; blockIdx.y = b * N + n
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < Tq) {
        const int64_t r = static_cast<int64_t>(blockIdx.y) * Tq + row;
        l_out[r] = l[i];
        m_out[r] = m[i];
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const float* bias, void* o, float* l, float* m, int B,
                        int N, int Tq, int Tk, const Strides& st, float scale,
                        int causal, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map_bthn(&mq, q, bf16, B, Tq, N, HD, st.q_sb, st.q_st,
                           st.q_sn, sm90::ATT_BQ) ||
      !sm90::make_map_bthn(&mk, k, bf16, B, Tk, N, HD, st.k_sb, st.k_st,
                           st.k_sn, BK) ||
      !sm90::make_map_bthn(&mv, v, bf16, B, Tk, N, HD, st.v_sb, st.v_st,
                           st.v_sn, BK))
    return cudaErrorInvalidValue;
  constexpr int smem = sm90::AttnSmem<HD, BK, H_STAGES>::BYTES;
  auto kernel = sm90::bias_is_key_mask(bias, st.a_sb, st.a_sn, st.a_st,
                                      st.a_ss)
                    ? flash_bias_fwd_sm90_kernel<T, HD, true>
                    : flash_bias_fwd_sm90_kernel<T, HD, false>;
  static cudaError_t err = sm90::allow_smem(   // once a process
      flash_bias_fwd_sm90_kernel<T, HD, true>,
      flash_bias_fwd_sm90_kernel<T, HD, false>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + sm90::ATT_BQ - 1) / sm90::ATT_BQ, B * N);
  kernel<<<grid, sm90::ATT_THREADS, smem, stream>>>(
      mq, mk, mv, bias, static_cast<T*>(o), l, m, N, Tq, Tk, st.a_sb,
      st.a_sn, st.a_st, st.a_ss, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// Strides are in elements: q, k, v as [B, T, N, H] (the last dimension
// must have stride 1), the f32 bias as [B, N, Tq, Tk] (any of them may
// be 0). o is contiguous [B, Tq, N, H]; l and m contiguous f32
// [B, N, Tq].
extern "C" int paddle_flash_attention_bias_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* l, void* m, int B, int N, int Tq, int Tk, int head_dim, int dtype,
    long long q_sb, long long q_st, long long q_sn, long long k_sb,
    long long k_st, long long k_sn, long long v_sb, long long v_st,
    long long v_sn, long long a_sb, long long a_sn, long long a_st,
    long long a_ss, float scale, int causal, void* stream) {
  if (B < 1 || N < 1 || Tq < 1 || Tk < 1 || B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn,
                   a_sb, a_sn, a_st, a_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(bias);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
#define PADDLE_FWD(TYPE, HD) \
  launch<TYPE, HD>(q, k, v, a, o, lp, mp, B, N, Tq, Tk, st, scale, causal, s)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) err = PADDLE_FWD(float, 64);
  else if (dtype == 0 && head_dim == 128) err = PADDLE_FWD(float, 128);
#undef PADDLE_FWD
#define PADDLE_FWD_SM90(TYPE, HD) \
  launch_sm90<TYPE, HD>(q, k, v, a, o, lp, mp, B, N, Tq, Tk, st, scale, \
                        causal, s)
  else if (dtype == 1 && head_dim == 64) err = PADDLE_FWD_SM90(__nv_bfloat16, 64);
  else if (dtype == 1 && head_dim == 128) err = PADDLE_FWD_SM90(__nv_bfloat16, 128);
  else if (dtype == 2 && head_dim == 64) err = PADDLE_FWD_SM90(__half, 64);
  else if (dtype == 2 && head_dim == 128) err = PADDLE_FWD_SM90(__half, 128);
#undef PADDLE_FWD_SM90
  return static_cast<int>(err);
}
