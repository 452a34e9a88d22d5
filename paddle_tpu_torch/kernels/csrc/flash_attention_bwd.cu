// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of exact
// softmax attention over [B, T, N, H] tensors, causal or full, from the
// forward's saved per-row logsumexp (LSE).
//
// Replaces: the JAX package's ops/pallas/attention.py::_splash_mha
// backward, i.e. the dq and dkv Pallas kernels of jax's splash attention
// (the custom vjp that make_splash_mha builds, attention.py:356), which
// jax.grad runs through models/bert.py::pretrain_loss and
// models/gpt.py::lm_loss. Each step is splash's:
//
//   delta  delta = rowsum(f32(o) * f32(do)), from the stored output in
//          the input dtype (splash's `di`, plain jnp outside its
//          kernels);
//   dkv    one block per (batch*head, key tile), looping over the
//          query tiles: P = exp(S - lse), dP = dO V^T,
//          dS = (dP - delta) * P, dV += round(P)^T dO,
//          dK += round(dS)^T Q;
//   dq     one block per (batch*head, query tile), looping over the
//          key tiles: the same P and dS, dQ += round(dS) K.
//
// At bf16 and f16 the backward is two launches, dq and then dkv: given
// the forward's output, the Hopper dq kernel computes its rows' delta in
// its prologue and writes it for dkv (stream order is the only
// synchronisation). At f32 it is three: delta_kernel, dkv and dq.
//
// round() is the rounding to the input dtype that splash applies before
// each product (a no-op at f32); scores, P, dS and every accumulator
// are f32. LSE and delta are inputs, so a caller holding them already
// (the ring attention's global LSE) passes its own. Q is multiplied by
// the scale and rounded to the input dtype before use, as the forward
// does; the returned dq is round(round(dQ) * scale), the gradient that
// jax takes through that multiply, so dq is with respect to the
// unscaled q.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): the
// backward reads q, k, v, o and dO and writes dq, dk and dv (8 tensors
// of B*T*N*H) plus the LSE and delta rows, against 5 products of
// 2*T*Tk*H per head (halved when causal). At BERT-base's training shape
// (B=256, T=128, N=12, H=64, bf16) that is 406 MB and 32 GFLOP: 121 us
// at the memory rate, 33 us at the tensor-core rate; at T 4096 (B=8,
// the same bytes) the 5 products are 1.03 TFLOP a layer, 1.04 ms at the
// tensor-core rate.
//
// What the design does about that bound. Common to both: the T x Tk
// scores and their gradients never leave the SM, so device traffic
// stays O(T*H); tiles above the diagonal are skipped; the dkv and dq
// blocks each own their accumulators, so no atomics and the same
// result every run. S and dP are computed in both kernels (7 products
// where 5 would do), the price of having no atomics.
//
// bf16 and f16 (flash_bwd_dkv_sm90_kernel, flash_bwd_dq_sm90_kernel):
// the products on the tensor cores. A block has two consumer
// warpgroups and one producer warp (288 threads). dkv owns 128 keys
// (64 a warpgroup), loaded once by TMA, and streams query tiles of 64
// (q and dO by TMA over the tensors' own strides, so a fused qkv
// projection's views need no copy; each tile's lse and delta rows
// loaded by the producer warp into the same stage) through a
// three-stage mbarrier ring. Per tile the consumers scale q in shared
// memory in place (rounded to T, then fence.proxy.async, as the
// forward), take S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16
// from shared memory, form P^T and dS^T in f32 registers (lse and
// delta lie along the columns), and, since the accumulator layout is
// register for register the A fragment, take dV += round(P^T) dO and
// dK += round(dS^T) Q_scaled with P^T and dS^T as the register A
// operand and dO and q as the MN-major B operand. dq mirrors it: 128
// queries a block (q scaled in place once, dO), key tiles of 64 (k, v)
// through the ring, S = Q K^T and dP = dO V^T from shared memory,
// lse and delta per row in registers, dQ += round(dS) K with k as the
// MN-major B operand. The folded delta pass (sm90.cuh's delta_load_o and
// delta_rows): each thread reads its quad's share of its two rows of o
// as 16-byte loads before the owned tiles' barrier, so the reads overlap
// their TMA, and the same elements of dO from the owned tile in shared
// memory, across the 128-byte swizzle, rather than from device memory
// again; it costs one read of o and the delta rows' write, half the
// bytes of the standalone pass, which read dO too in a launch of its
// own. splash rounds P and dS to the input dtype before
// these products (p.astype, ds.astype in jax's splash kernel), so the
// 16-bit A operand is its rounding exactly. Within a warpgroup the
// elementwise work waits for its products; the other warpgroup's
// products fill the tensor cores meanwhile.
//
// Reached (chip_smoke.py and kernels/probe_sm90.py on an NVIDIA H100
// 80GB HBM3, 700 W): at BERT-base's 256 x 128 the whole backward, dq
// with the delta pass folded in and then dkv, 0.410 ms a call (three
// launches 0.426, SDPA's backward 0.458) and 0.342 ms of device time
// (three launches 0.404: the fold adds 7 us to dq where the standalone
// pass took 70); dkv 0.262 and dq 0.212 ms a call (the FMA kernels took
// 1.252 and 1.056); at 8 x 4096 the whole backward 4.83 ms against
// SDPA's 2.54 (dkv 2.80, dq 2.04: about 300 TFLOP/s of the 7 products).
// 288 threads leave 168 registers a thread: at H 64 dkv takes 165 and
// dq 137 with no spill; at H 128 dkv spills 424 bytes and ptxas
// serialises its wgmma (dq 166, no spill).
//
// f32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel): the products on the
// f32 FMA pipes from shared memory, 64 x 64 tiles; wgmma has no full-
// f32 form and TF32 would not pass the f32 parity gates. Layout of one
// 256-thread block (16 x 16 threads, (ty, tx)): in the score phase a
// thread holds rows ty + 16*i and columns tx + 16*j (i, j < 4) of the
// 64 x 64 tile, as the FMA forward does; in the accumulation phase it
// holds accumulator rows ty + 16*i and head columns tx + 16*d.
//
// C interface (loaded with ctypes): each paddle_flash_attention_bwd_*
// function returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue when TMA refuses a bf16 or f16 tensor: the
// wrapper checks its rules first); none synchronises. o, dO, dq, dk and dv are contiguous [B, T, N, H]; lse
// and delta contiguous f32 [B, N, Tq]; q, k and v take strides.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;              // query rows per tile
constexpr int BK = 64;              // key rows per tile (== BQ: the
                                    // causal loops start at the diagonal)
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NTHREADS = TX * TY;   // 256
constexpr int RPT = BQ / TY;        // rows per thread
constexpr int CPT = BK / TX;        // score columns per thread
constexpr int LDP = BK + 1;         // padded row length of a score tile

struct Strides {
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn;
};

// rows [t0, t0 + 64) of one (b, n) slice of a [B, T, N, HD] tensor with
// row stride `st` into a [64][HD + 1] f32 tile; rows past T are zero.
// With `scale`, each value is multiplied and rounded to T first (q).
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int t0, int T_len,
                                          float scale, bool scaled) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD, t = t0 + r;
    float x = 0.f;
    if (t < T_len) {
      x = to_f32(src[t * st + c]);
      if (scaled) x = round_to<T>(x * scale);
    }
    dst[r * LD + c] = x;
  }
}

// S = Q K^T and dP = dO V^T for one 64 x 64 tile pair, then P and dS:
// p[i][j] and ds[i][j] for query row q0 + ty + 16i, key k0 + tx + 16j.
// Masked entries (past Tq or Tk, or above the diagonal) get P = dS = 0.
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* Ds, const float* Ks, const float* Vs,
    const float* Ls, const float* Es, int q0, int k0, int Tq, int Tk,
    int causal, float (&p)[RPT][CPT], float (&ds)[RPT][CPT]) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int h = 0; h < HD; ++h) {
    float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = Qs[(ty + TY * i) * LD + h];
      dov[i] = Ds[(ty + TY * i) * LD + h];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = Ks[(tx + TX * j) * LD + h];
      vv[j] = Vs[(tx + TX * j) * LD + h];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = k0 + tx + TX * j;
      const bool live = row < Tq && col < Tk && !(causal && col > row);
      p[i][j] = live ? expf(s[i][j] - Ls[r]) : 0.f;
      ds[i][j] = live ? (dp[i][j] - Es[r]) * p[i][j] : 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int N, int Tq,
                             int64_t rows) {
  // one warp per row of the [B, Tq, N] row space (o's own order)
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * HD;
  const T* drow = dout + row * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t n = row % N, bt = row / N, t = bt % Tq, b = bt / Tq;
    delta[(b * N + n) * Tq + t] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int Tq, int Tk, Strides st,
                     float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / TX;      // head columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Qs = Vs + BK * LD;         // [BQ][LD], scaled q
  float* Ds = Qs + BQ * LD;         // [BQ][LD], dO
  float* Ps = Ds + BQ * LD;         // [BQ][LDP], round(P)
  float* Ss = Ps + BQ * LDP;        // [BQ][LDP], round(dS)
  float* Ls = Ss + BQ * LDP;        // [BQ] lse
  float* Es = Ls + BQ;              // [BQ] delta

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int64_t row_st = static_cast<int64_t>(N) * HD;  // dO, dk, dv
  const T* qb = q + b * st.q_sb + n * st.q_sn;
  const T* dob = dout + (static_cast<int64_t>(b) * Tq * N + n) * HD;
  const float* lb = lse + static_cast<int64_t>(bn) * Tq;
  const float* eb = delta + static_cast<int64_t>(bn) * Tq;

  load_tile<T, HD>(Ks, k + b * st.k_sb + n * st.k_sn, st.k_st, k0, Tk, 0.f,
                   false);
  load_tile<T, HD>(Vs, v + b * st.v_sb + n * st.v_sn, st.v_st, k0, Tk, 0.f,
                   false);

  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc_k[i][d] = acc_v[i][d] = 0.f;

  // causal: query tiles wholly above this key tile see none of it
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (Tq + BQ - 1) / BQ;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, HD>(Qs, qb, st.q_st, q0, Tq, scale, true);
    load_tile<T, HD>(Ds, dob, row_st, q0, Tq, 0.f, false);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const bool in = q0 + r < Tq;
      Ls[r] = in ? lb[q0 + r] : 0.f;
      Es[r] = in ? eb[q0 + r] : 0.f;
    }
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    tile_p_ds<HD>(Qs, Ds, Ks, Vs, Ls, Es, q0, k0, Tq, Tk, causal, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        Ps[(ty + TY * i) * LDP + tx + TX * j] = round_to<T>(p[i][j]);
        Ss[(ty + TY * i) * LDP + tx + TX * j] = round_to<T>(ds[i][j]);
      }
    __syncthreads();

    // dV[key][h] += sum_q P[q][key] dO[q][h]; dK likewise with dS and Q
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], sv[RPT], dov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = Ps[r * LDP + ty + TY * i];
        sv[i] = Ss[r * LDP + ty + TY * i];
      }
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dov[d] = Ds[r * LD + tx + TX * d];
        qv[d] = Qs[r * LD + tx + TX * d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) {
          acc_v[i][d] = fmaf(pv[i], dov[d], acc_v[i][d]);
          acc_k[i][d] = fmaf(sv[i], qv[d], acc_k[i][d]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= Tk) continue;
    const int64_t off = (static_cast<int64_t>(b) * Tk + key) * row_st +
                        static_cast<int64_t>(n) * HD;
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dk[off + tx + TX * d] = from_f32<T>(acc_k[i][d]);
      dv[off + tx + TX * d] = from_f32<T>(acc_v[i][d]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int N, int Tq, int Tk, Strides st, float scale,
                    int causal) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD], scaled q
  float* Ds = Qs + BQ * LD;         // [BQ][LD], dO
  float* Ks = Ds + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ss = Vs + BK * LD;         // [BQ][LDP], round(dS)
  float* Ls = Ss + BQ * LDP;        // [BQ]
  float* Es = Ls + BQ;              // [BQ]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int64_t row_st = static_cast<int64_t>(N) * HD;  // dO, dq
  const T* kb = k + b * st.k_sb + n * st.k_sn;
  const T* vb = v + b * st.v_sb + n * st.v_sn;
  const float* lb = lse + static_cast<int64_t>(bn) * Tq;
  const float* eb = delta + static_cast<int64_t>(bn) * Tq;

  load_tile<T, HD>(Qs, q + b * st.q_sb + n * st.q_sn, st.q_st, q0, Tq, scale,
                   true);
  load_tile<T, HD>(Ds, dout + (static_cast<int64_t>(b) * Tq * N + n) * HD,
                   row_st, q0, Tq, 0.f, false);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Tq;
    Ls[r] = in ? lb[q0 + r] : 0.f;
    Es[r] = in ? eb[q0 + r] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  // causal: keys past this tile's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, HD>(Ks, kb, st.k_st, k0, Tk, 0.f, false);
    load_tile<T, HD>(Vs, vb, st.v_st, k0, Tk, 0.f, false);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    tile_p_ds<HD>(Qs, Ds, Ks, Vs, Ls, Es, q0, k0, Tq, Tk, causal, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        Ss[(ty + TY * i) * LDP + tx + TX * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dQ[q][h] += sum_key dS[q][key] K[key][h]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = Ss[(ty + TY * i) * LDP + c];
#pragma unroll
      for (int d = 0; d < DPT; ++d) kv[d] = Ks[c * LD + tx + TX * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = fmaf(sv[i], kv[d], acc[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= Tq) continue;
    T* out = dq + (static_cast<int64_t>(b) * Tq + row) * row_st +
             static_cast<int64_t>(n) * HD;
    // dq of the scaled q, rounded, then times the scale in T: the
    // gradient through splash's caller's q * scale
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      out[tx + TX * d] = from_f32<T>(round_to<T>(acc[i][d]) * scale);
  }
}

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(BQ) * (HD + 1) +
                          2 * static_cast<size_t>(BQ) * LDP + 2 * BQ);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(BQ) * (HD + 1) +
                          static_cast<size_t>(BQ) * LDP + 2 * BQ);
}

// ---------------------------------------------------------------------------
// bf16 and f16: the Hopper kernels (wgmma, TMA, a producer warp), on the
// backwards' tiles of sm90.cuh

using sm90::BWD_ROWS;
using sm90::BWD_STAGES;
using sm90::BWD_TILE;

// q * scale rounded to T, in place, for the rows [r0, r0 + rows) of a
// 128-byte-swizzled tile of `box_bytes` a box (elementwise, so the
// swizzle does not matter), by `count` threads from thread index `i0`;
// followed by fence.proxy.async, so wgmma's async proxy sees the writes
template <typename T, int HD>
__device__ __forceinline__ void scale_rows(unsigned char* tile, int box_bytes,
                                           int r0, int rows, float scale,
                                           int i0, int count) {
#pragma unroll
  for (int x = 0; x < HD / 64; ++x) {
    uint4* qv = reinterpret_cast<uint4*>(tile + x * box_bytes + r0 * 128);
    for (int i = i0; i < rows * 8; i += count) {
      uint4 w = qv[i];
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = from_f32<T>(to_f32(e[j]) * scale);
      qv[i] = w;
    }
  }
  sm90::fence_proxy_async();
}

// dK and dV for 128 keys of one (batch, head). Per query tile: S^T =
// K Q^T and dP^T = V dO^T (keys as rows, queries as columns), P^T =
// exp(S^T - lse) and dS^T = P^T (dP^T - delta) with lse and delta along
// the columns, then dV += round(P^T) dO and dK += round(dS^T) Q.
template <typename T, int HD>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int N,
                          int Tq, int Tk, float scale, int causal) {
  using L = sm90::BwdSmem<HD, 2>;   // the tile's lse and delta rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + BWD_STAGES;

  const int k0 = blockIdx.x * BWD_ROWS;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  // causal: query tiles wholly before this block's first key see none of
  // its keys
  const int qt0 = causal ? k0 / BWD_TILE : 0;
  const int n_qt = (Tq + BWD_TILE - 1) / BWD_TILE;
  const int n_iter = n_qt > qt0 ? n_qt - qt0 : 0;

  if (threadIdx.x == 0) sm90::bwd_init_bars(bars, 33);
  __syncthreads();

  if (threadIdx.x >= sm90::ATT_CONSUMERS) {   // the producer warp
    const int lane = threadIdx.x - sm90::ATT_CONSUMERS;
    if (lane == 0) sm90::bwd_load_owned<HD, 2>(base, &tk, &tv, b, n, k0);
    const float* lb = lse + static_cast<int64_t>(bn) * Tq;
    const float* eb = delta + static_cast<int64_t>(bn) * Tq;
    for (int it = 0; it < n_iter; ++it) {
      const int q0 = (qt0 + it) * BWD_TILE;
      float* rows = reinterpret_cast<float*>(
          sm90::bwd_load_tile<HD, 2>(base, &tq, &tdo, b, n, it, q0,
                                     lane == 0) + L::ROWS);
      for (int r = lane; r < BWD_TILE; r += 32) {
        const bool in = q0 + r < Tq;
        rows[r] = in ? lb[q0 + r] : 0.f;
        rows[BWD_TILE + r] = in ? eb[q0 + r] : 0.f;
      }
      sm90::mbar_arrive(full + it % BWD_STAGES);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32, c = lane % 4;
  const int kw = k0 + 64 * wg;                      // the warpgroup's keys
  const int row0 = kw + 16 * (t / 32) + lane / 4;   // and row0 + 8

  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  sm90::mbar_wait(bars, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % BWD_STAGES;
    const int q0 = (qt0 + it) * BWD_TILE;
    unsigned char* st = base + L::TILES + s * L::STAGE;
    sm90::mbar_wait(full + s, (it / BWD_STAGES) & 1);
    // the 256 consumers scale the shared q tile, then all see it
    scale_rows<T, HD>(st, L::BOX_TILE, 0, BWD_TILE, scale, threadIdx.x,
                      sm90::ATT_CONSUMERS);
    sm90::named_sync(1, sm90::ATT_CONSUMERS);
    // causal: a warpgroup whose keys all follow the tile's queries sees
    // none of it (kw and q0 are multiples of 64)
    if (!causal || kw <= q0) {
      float sp[32], dp[32];
      sm90::wgmma_fence();
      sm90::tile_product<T, HD>(sp, base + L::OWN_A + wg * 64 * 128,
                                L::BOX_OWN, st);
      sm90::tile_product<T, HD>(dp, base + L::OWN_B + wg * 64 * 128,
                                L::BOX_OWN, st + L::TILE_B);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sp);
      sm90::fence_regs(dp);
      const float* ls = reinterpret_cast<const float*>(st + L::ROWS);
      const float* es = ls + BWD_TILE;
      // the ragged end of Tq and the causal diagonal tile (kw == q0)
      const bool edge = q0 + BWD_TILE > Tq || (causal && kw == q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * c);
        const float2 e2 = *reinterpret_cast<const float2*>(es + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c + (e & 1);
          const int key = row0 + 8 * (e >> 1);
          float p = expf(sp[4 * j + e] - ((e & 1) ? l2.y : l2.x));
          if (edge && (q >= Tq || (causal && key > q))) p = 0.f;
          dp[4 * j + e] = (dp[4 * j + e] - ((e & 1) ? e2.y : e2.x)) * p;
          sp[4 * j + e] = p;
        }
      }
      uint32_t pa[4][4], sa[4][4];
      sm90::pack_frags<T>(pa, sp);
      sm90::pack_frags<T>(sa, dp);
      sm90::wgmma_fence();
      sm90::grad_product<T, HD>(acc_v, pa, st + L::TILE_B);   // dO
      sm90::grad_product<T, HD>(acc_k, sa, st);               // scaled q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_v);
      sm90::fence_regs(acc_k);
    }
    sm90::mbar_arrive(empty + s);
  }
  const auto same = [](float x) { return x; };
  sm90::store_rows<T, HD>(dk, acc_k, b, n, N, Tk, row0, c, same);
  sm90::store_rows<T, HD>(dv, acc_v, b, n, N, Tk, row0, c, same);
}

// dQ for 128 queries of one (batch, head): per key tile S = Q K^T and
// dP = dO V^T, P = exp(S - lse) and dS = P (dP - delta) with lse and
// delta per row, dQ += round(dS) K; the output round(round(dQ) scale).
// With `o` (the forward's output), delta is not read but computed in the
// prologue from o and the owned dO tile (sm90::delta_rows) and written to
// `delta` for the dkv launch that follows: the block owns its rows, so
// each row's delta is computed once, with no atomics.
template <typename T, int HD>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         const T* __restrict__ o, T* __restrict__ dq, int N,
                         int Tq, int Tk, float scale, int causal) {
  using L = sm90::BwdSmem<HD, 0>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = sm90::align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + BWD_STAGES;

  // causal: the longest rows (the last query tiles) are launched first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BWD_ROWS;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  // causal: keys past the block's last row are masked for every row
  const int k_end = causal ? min(Tk, q0 + BWD_ROWS) : Tk;
  const int n_kt = (k_end + BWD_TILE - 1) / BWD_TILE;

  if (threadIdx.x == 0) sm90::bwd_init_bars(bars, 1);
  __syncthreads();

  if (threadIdx.x >= sm90::ATT_CONSUMERS) {   // the producer warp
    if (threadIdx.x == sm90::ATT_CONSUMERS) {
      sm90::bwd_load_owned<HD, 0>(base, &tq, &tdo, b, n, q0);
      for (int kt = 0; kt < n_kt; ++kt)
        sm90::bwd_load_tile<HD, 0>(base, &tk, &tv, b, n, kt, kt * BWD_TILE,
                                   true);
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32, c = lane % 4;
  const int wrow = q0 + 64 * wg;                     // the warpgroup's rows
  const int row0 = wrow + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const bool fold = o != nullptr;   // uniform across the block

  float lr[2], er[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t at = static_cast<int64_t>(bn) * Tq + row;
    lr[i] = row < Tq ? lse[at] : 0.f;
    er[i] = row < Tq && !fold ? delta[at] : 0.f;
  }
  // the fold's share of o, read under the owned tiles' TMA; issued after
  // the rows' loads, so those do not queue behind it (the other order
  // puts one load's latency after the other's in every block)
  uint4 ov[2][HD / 32];
  if (fold) sm90::delta_load_o<T, HD>(ov, o, b, n, N, Tq, row0, row0 - q0, c);

  sm90::mbar_wait(bars, 0);
  if (fold) {
    sm90::delta_rows<T, HD>(er, ov, base + L::OWN_B, L::BOX_OWN, row0 - q0,
                            c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (c == 0 && row0 + 8 * i < Tq)
        delta[static_cast<int64_t>(bn) * Tq + row0 + 8 * i] = er[i];
  }
  // this warpgroup's q rows, scaled in place
  scale_rows<T, HD>(base + L::OWN_A, L::BOX_OWN, 64 * wg, 64, scale, t, 128);
  sm90::named_sync(1 + wg, 128);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % BWD_STAGES;
    const int k0 = kt * BWD_TILE;
    unsigned char* st = base + L::TILES + s * L::STAGE;
    sm90::mbar_wait(full + s, (kt / BWD_STAGES) & 1);
    // causal: a key tile wholly after the warpgroup's rows is masked
    if (!causal || k0 <= wrow) {
      float sp[32], dp[32];
      sm90::wgmma_fence();
      sm90::tile_product<T, HD>(sp, base + L::OWN_A + wg * 64 * 128,
                                L::BOX_OWN, st);
      sm90::tile_product<T, HD>(dp, base + L::OWN_B + wg * 64 * 128,
                                L::BOX_OWN, st + L::TILE_B);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sp);
      sm90::fence_regs(dp);
      // the ragged end of Tk and the causal diagonal tile (k0 == wrow)
      const bool edge = k0 + BWD_TILE > Tk || (causal && k0 == wrow);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * c + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          float p = expf(sp[4 * j + e] - lr[e >> 1]);
          if (edge && (key >= Tk || (causal && key > row))) p = 0.f;
          dp[4 * j + e] = (dp[4 * j + e] - er[e >> 1]) * p;
        }
      uint32_t sa[4][4];
      sm90::pack_frags<T>(sa, dp);
      sm90::wgmma_fence();
      sm90::grad_product<T, HD>(acc, sa, st);   // k
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(empty + s);
  }
  // dq of the scaled q, rounded, then times the scale in T: the
  // gradient through splash's caller's q * scale
  sm90::store_rows<T, HD>(dq, acc, b, n, N, Tq, row0, c,
                          [scale](float x) { return round_to<T>(x) * scale; });
}

template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int N, int Tq, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * Tq * N;
  constexpr int threads = 256;                 // 8 rows per block
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  delta_kernel<T, HD><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, N, Tq,
      rows);
  return cudaGetLastError();
}

// bf16 and f16 launch the Hopper kernels, f32 the FMA ones; the Hopper
// launches return cudaErrorInvalidValue when TMA refuses a tensor
template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int N,
                       int Tq, int Tk, Strides st, float scale, int causal,
                       cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap m[4];
    if (!sm90::bwd_maps<T, HD>(m, q, k, v, dout, B, N, Tq, Tk, st, true))
      return cudaErrorInvalidValue;
    constexpr int smem = sm90::BwdSmem<HD, 2>::BYTES;
    auto kernel = flash_bwd_dkv_sm90_kernel<T, HD>;
    static cudaError_t err = cudaFuncSetAttribute(   // once a process
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tk + BWD_ROWS - 1) / BWD_ROWS, B * N);
    kernel<<<grid, sm90::ATT_THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), N, Tq, Tk, scale, causal);
    return cudaGetLastError();
  } else {
    constexpr size_t smem = dkv_smem<HD>();
    auto kernel = flash_bwd_dkv_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((Tk + BK - 1) / BK, B * N);
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), N, Tq, Tk, st, scale,
        causal);
    return cudaGetLastError();
  }
}

// o: NULL, or (bf16 and f16 only) the forward's output, from which the
// Hopper dq kernel computes delta and writes it
template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, float* delta,
                      const void* o, void* dq, int B, int N, int Tq, int Tk,
                      Strides st, float scale, int causal,
                      cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap m[4];
    if (!sm90::bwd_maps<T, HD>(m, q, k, v, dout, B, N, Tq, Tk, st, false))
      return cudaErrorInvalidValue;
    constexpr int smem = sm90::BwdSmem<HD, 0>::BYTES;
    auto kernel = flash_bwd_dq_sm90_kernel<T, HD>;
    static cudaError_t err = cudaFuncSetAttribute(   // once a process
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BWD_ROWS - 1) / BWD_ROWS, B * N);
    kernel<<<grid, sm90::ATT_THREADS, smem, stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<const T*>(o),
        static_cast<T*>(dq), N, Tq, Tk, scale, causal);
    return cudaGetLastError();
  } else {
    if (o != nullptr) return cudaErrorInvalidValue;   // no FMA fold
    constexpr size_t smem = dq_smem<HD>();
    auto kernel = flash_bwd_dq_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((Tq + BQ - 1) / BQ, B * N);
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), N, Tq, Tk, st, scale, causal);
    return cudaGetLastError();
  }
}

}  // namespace

// Runs the statement given as the macro's tail with T (storage type)
// and HD (head dim) bound, or returns cudaErrorInvalidValue for a
// combination the kernels do not take. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; head_dim 64 or 128.
#define PADDLE_CASE(code, hd, type, dtype, head_dim, ...)                 \
  if (dtype == code && head_dim == hd) {                                  \
    using T = type;                                                       \
    constexpr int HD = hd;                                                \
    __VA_ARGS__;                                                          \
  }
#define PADDLE_DISPATCH(dtype, head_dim, ...)                             \
  PADDLE_CASE(0, 64, float, dtype, head_dim, __VA_ARGS__)                 \
  PADDLE_CASE(0, 128, float, dtype, head_dim, __VA_ARGS__)                \
  PADDLE_CASE(1, 64, __nv_bfloat16, dtype, head_dim, __VA_ARGS__)         \
  PADDLE_CASE(1, 128, __nv_bfloat16, dtype, head_dim, __VA_ARGS__)        \
  PADDLE_CASE(2, 64, __half, dtype, head_dim, __VA_ARGS__)                \
  PADDLE_CASE(2, 128, __half, dtype, head_dim, __VA_ARGS__)               \
  return static_cast<int>(cudaErrorInvalidValue)

extern "C" int paddle_flash_attention_bwd_delta(const void* o,
                                                const void* dout,
                                                void* delta, int B, int N,
                                                int Tq, int head_dim,
                                                int dtype, void* stream) {
  if (B < 1 || N < 1 || Tq < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* e = static_cast<float*>(delta);
  PADDLE_DISPATCH(dtype, head_dim,
                  return static_cast<int>(
                      launch_delta<T, HD>(o, dout, e, B, N, Tq, s)));
}

extern "C" int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int N,
    int Tq, int Tk, int head_dim, int dtype, long long q_sb, long long q_st,
    long long q_sn, long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn, float scale, int causal,
    void* stream) {
  if (B < 1 || N < 1 || Tq < 1 || Tk < 1 || B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* e = static_cast<const float*>(delta);
  PADDLE_DISPATCH(dtype, head_dim,
                  return static_cast<int>(launch_dkv<T, HD>(
                      q, k, v, dout, l, e, dk, dv, B, N, Tq, Tk, st, scale,
                      causal, s)));
}

// delta is read, or with a non-NULL o (the forward's output, contiguous
// [B, Tq, N, H], 16-byte aligned; bf16 and f16) computed and written
extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* delta, const void* o, void* dq, int B, int N,
    int Tq, int Tk, int head_dim, int dtype, long long q_sb, long long q_st,
    long long q_sn, long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn, float scale, int causal,
    void* stream) {
  if (B < 1 || N < 1 || Tq < 1 || Tk < 1 || B * N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* e = static_cast<float*>(delta);
  PADDLE_DISPATCH(dtype, head_dim,
                  return static_cast<int>(launch_dq<T, HD>(
                      q, k, v, dout, l, e, o, dq, B, N, Tq, Tk, st, scale,
                      causal, s)));
}
