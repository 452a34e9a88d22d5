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
// What this simple design does about that bound: every byte of q, k and
// v is read from device memory once per query tile that needs it and
// never spilled; the T x T scores never leave the SM (they live in
// registers and one 64 x 64 shared-memory tile), so device traffic
// stays O(T*H) rather than O(T^2); and key tiles strictly above the
// diagonal are skipped, halving the causal work. The products run on
// the FP32 FMA pipes, not the tensor cores (no mma/wgmma, no TMA, no
// warp specialisation), so the kernel is compute-limited far above the
// bound at long T; moving the two products onto wgmma is later work.
//
// Layout of one block: 256 threads as a 16 x 16 grid own a 64-query
// tile of one (batch, head). Thread (ty, tx) holds score rows
// ty + 16*i (i < 4) and columns tx + 16*j (j < 4) of each 64 x 64 score
// tile, and output columns tx + 16*d of the same rows. Row maxima and
// sums reduce over the 16 lanes sharing ty (one half-warp) with
// shuffles.
//
// C interface (loaded with ctypes): paddle_flash_attention_fwd returns
// cudaGetLastError() after the launch; it does not synchronise. Inputs
// are float32, bfloat16 or float16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

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
  else if (dtype == 1 && head_dim == 64) err = PADDLE_FWD(__nv_bfloat16, 64);
  else if (dtype == 1 && head_dim == 128) err = PADDLE_FWD(__nv_bfloat16, 128);
  else if (dtype == 2 && head_dim == 64) err = PADDLE_FWD(__half, 64);
  else if (dtype == 2 && head_dim == 128) err = PADDLE_FWD(__half, 128);
#undef PADDLE_FWD
  return static_cast<int>(err);
}
