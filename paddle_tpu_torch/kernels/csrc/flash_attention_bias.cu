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
// What this simple design does about that bound: every byte of q, k
// and v is read once per query tile that needs it, and the T x Tk
// scores never leave the SM (registers and one 64 x 128 shared-memory
// tile), so device traffic stays O(T*H); the bias is read once per
// score, a broadcast mask from cache. The products run on the f32 FMA
// pipes from shared memory, not the tensor cores (no mma/wgmma, no
// TMA), so the kernel is compute-limited far above the bound; tensor
// cores are later work.
//
// Layout of one block: 256 threads as a 16 x 16 grid own a 64-query
// tile of one (batch, head): thread (ty, tx) holds score rows
// ty + 16*i (i < 4) and columns tx + 16*j (j < 8) of each 64 x 128
// score tile, and output columns tx + 16*d of the same rows. The p
// tile reuses the k tile's shared memory once the scores are taken, so
// the q, k and v tiles take 83 KB at H=64 (two blocks per SM) and
// 165 KB at H=128 (one).
//
// C interface (loaded with ctypes): paddle_flash_attention_bias_fwd
// returns cudaGetLastError() after the launch; it does not synchronise.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

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
  else if (dtype == 1 && head_dim == 64) err = PADDLE_FWD(__nv_bfloat16, 64);
  else if (dtype == 1 && head_dim == 128) err = PADDLE_FWD(__nv_bfloat16, 128);
  else if (dtype == 2 && head_dim == 64) err = PADDLE_FWD(__half, 64);
  else if (dtype == 2 && head_dim == 128) err = PADDLE_FWD(__half, 128);
#undef PADDLE_FWD
  return static_cast<int>(err);
}
