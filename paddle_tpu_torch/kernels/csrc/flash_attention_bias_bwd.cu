// Flash-attention backward with an additive bias for Hopper (sm_90a):
// dq, dk, dv (and, when asked, the bias gradient) of the attention in
// flash_attention_bias.cu, from its saved per-row l and m.
//
// Replaces: the dkv and dq Pallas kernels of jax's legacy
// `flash_attention` (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq), the custom vjp
// that jax.grad runs through the JAX package's
// ops/pallas/attention.py::_pallas_mha. Two launches, each step for step
// the reference's, dq first; the third step, di = rowsum(f32(o) *
// f32(do)), is plain jnp there and at bf16 and f16 the prologue of the
// Hopper dq kernel here (sm90.cuh's delta_load_o and delta_rows, as in
// K1-bwd's dq), which writes it for dkv; at f32 it is K1's delta launch
// (flash_attention_bwd.cu):
//
//   dkv  one block per (batch*head, key tile), looping over the query
//        tiles: s recomputed with the bias, scale and causal mask,
//        p = exp(s - m) * (1/l), dp = dO V^T, ds = (dp - di) * p * scale,
//        dV += round(p)^T dO, dK += round(ds)^T Q (the unscaled q);
//   dq   one block per (batch*head, query tile), looping over the key
//        tiles: the same p and ds, dQ += round(ds) K, and with a dbias
//        pointer each tile of ds written in f32 (the gradient of the
//        bias, as the reference's ds output).
//
// round() is the rounding to the input dtype that the reference applies
// before each product (p.T.astype(do.dtype), ds.T.astype(do.dtype),
// ds.astype(k.dtype); a no-op at f32); scores, p, ds and every
// accumulator are f32, and dq, dk and dv are rounded once at the end.
// The reference adds MASK_VALUE (-0.7 * FLT_MAX) to causal positions,
// which makes their p exactly 0; tiles wholly above the diagonal are
// skipped, and dbias must then come zeroed, as the wrapper allocates it.
//
// Bound on the H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): the
// backward reads q, k, v, o and dO and writes dq, dk and dv (8 tensors
// of B*T*N*H) plus the l, m and delta rows, against 5 products of
// 2*T*Tk*H per head. At Transformer-big's shape (B=128, T=Tk=128,
// N=16, H=64, bf16) that is 269 MB and 21.5 GFLOP: 80 us at the memory
// rate, 22 us at the tensor-core rate.
//
// What the design does about that bound, in both kernels: the T x Tk
// scores and their gradients never leave the SM, so device traffic stays
// O(T*H); the dkv and dq blocks each own their accumulators (no atomics,
// the same result every run), at the price of computing s and dp twice
// (7 products where 5 would do).
//
// bf16 and f16 (flash_bias_bwd_dkv_sm90_kernel,
// flash_bias_bwd_dq_sm90_kernel): the products on the tensor cores, on
// K1-bwd's pipeline (the backwards' tiles of sm90.cuh): 288 threads, two
// consumer warpgroups and one producer warp. dkv owns 128 keys (64 a
// warpgroup), k and v loaded once by TMA, and streams query tiles of 64
// (q and dO by TMA over the tensors' own strides, so the views of a
// fused kv projection need no copy; each tile's 1/l, m and delta rows
// loaded by the producer warp into the same stage) through a three-stage
// mbarrier ring; per tile S^T = K Q^T and dP^T = V dO^T on wgmma
// m64n64k16 from shared memory, p^T and ds^T in f32 registers (1/l, m
// and delta along the columns), then, the accumulator layout being
// register for register the A fragment, dV += round(p^T) dO and dK +=
// round(ds^T) Q with p^T and ds^T packed to the input dtype as the
// register A operand and dO and q as the MN-major B operand. The
// reference rounds there, so the 16-bit operand is exact. dq mirrors it:
// 128 queries a block (q and dO once), key tiles of 64 (k, v), 1/l, m
// and delta per row in registers, dQ += round(ds) K. p is expf(x - m)
// times 1/l as the plain version computes it (an approximate exp, or 1/l
// folded into an exponent, would round other p the other way). The bias
// is read in the accumulator's layout: mha's [B, 1, 1, Tk] key mask
// (stride 0 across heads and rows) takes a KEY_MASK variant, which in
// dkv holds one value per accumulator row (key), read once a block, and
// in dq reads pairs of columns before each tile's products; any other
// bias (full [B, N, Tq, Tk], test cases only) reads each element from
// global memory and L2, transposed in dkv. Within a warpgroup the
// elementwise work waits for its products; the other warpgroup's
// products fill the tensor cores meanwhile.
//
// Reached (kernels/probe_sm90.py's device times on an NVIDIA H100 80GB
// HBM3, 700 W): at Transformer-big's 128 x 128 x 16 heads with a key
// mask dkv 0.166 ms and dq, with the delta pass folded in, 0.115 (0.107
// given delta; the standalone pass took 0.048), at padded BERT-base's
// 32 x 512 x 12 heads 0.268 and 0.204; chip_smoke.py's `ms` a call at
// the first shape 0.221 and 0.175, where the FMA kernels took 0.910 and
// 0.745, and the whole backward 0.345 (three launches 0.376, SDPA's
// backward 0.367). 288 threads leave 168 registers a thread: at H 64
// the key-mask dkv takes all 168 and dq 156, with no spill; the
// full-bias forms spill 12 (dq) and 80 (dkv) bytes, and at H 128 dq
// spills 32-140 bytes, dkv 436-544 bytes with its wgmma serialised
// (none is on a main path).
//
// f32 (flash_bias_bwd_dkv_kernel, flash_bias_bwd_dq_kernel): the
// products on the f32 FMA pipes from shared memory, 64 x 64 tiles; wgmma
// has no full-f32 form and TF32 would not pass the f32 parity gates.
// Layout of one 256-thread block (16 x 16 threads, (ty, tx)): in the
// score phase a thread holds rows ty + 16*i and columns tx + 16*j
// (i, j < 4) of the 64 x 64 tile; in the accumulation phase accumulator
// rows ty + 16*i and head columns tx + 16*d.
//
// C interface (loaded with ctypes): each paddle_flash_attention_bias_bwd_*
// function returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue when TMA refuses a bf16 or f16 tensor: the
// wrapper checks its rules first); none synchronises. dO, dq, dk and dv
// are contiguous [B, T, N, H]; l, m and delta contiguous f32 [B, N, Tq];
// dbias contiguous f32 [B, N, Tq, Tk]; q, k, v and the bias take strides.

#include <cuda_runtime.h>
#include <float.h>
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
constexpr float MASK_VALUE = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));

struct Strides {
  int64_t q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st, v_sn;
  int64_t a_sb, a_sn, a_st, a_ss;
};

// rows [t0, t0 + 64) of one (b, n) slice of a [B, T, N, HD] tensor with
// row stride `st` into a [64][HD + 1] f32 tile; rows past T are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int t0, int T_len) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD, t = t0 + r;
    dst[r * LD + c] = t < T_len ? to_f32(src[t * st + c]) : 0.f;
  }
}

// each query row's 1/l, m and delta for rows [q0, q0 + 64)
__device__ __forceinline__ void load_rows(float* Li, float* Ms, float* Es,
                                          const float* lb, const float* mb,
                                          const float* eb, int q0, int Tq) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < Tq;
    Li[r] = in ? 1.f / lb[q0 + r] : 0.f;
    Ms[r] = in ? mb[q0 + r] : 0.f;
    Es[r] = in ? eb[q0 + r] : 0.f;
  }
}

// s = Q K^T and dP = dO V^T for one 64 x 64 tile pair, then p and ds:
// p[i][j] and ds[i][j] for query row q0 + ty + 16i, key k0 + tx + 16j.
// Entries past Tq or Tk get p = ds = 0.
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* Qs, const float* Ds, const float* Ks, const float* Vs,
    const float* Li, const float* Ms, const float* Es, const float* ab,
    const Strides& st, int q0, int k0, int Tq, int Tk, float scale,
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
      if (row < Tq && col < Tk) {
        float x = (s[i][j] + ab[row * st.a_st + col * st.a_ss]) * scale;
        if (causal && col > row) x += MASK_VALUE;
        p[i][j] = expf(x - Ms[r]) * Li[r];
        ds[i][j] = (dp[i][j] - Es[r]) * p[i][j] * scale;
      } else {
        p[i][j] = ds[i][j] = 0.f;
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bias_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias,
                          const T* __restrict__ dout,
                          const float* __restrict__ l,
                          const float* __restrict__ m,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int N, int Tq, int Tk,
                          Strides st, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / TX;      // head columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Qs = Vs + BK * LD;         // [BQ][LD], unscaled q
  float* Ds = Qs + BQ * LD;         // [BQ][LD], dO
  float* Ps = Ds + BQ * LD;         // [BQ][LDP], round(p)
  float* Ss = Ps + BQ * LDP;        // [BQ][LDP], round(ds)
  float* Li = Ss + BQ * LDP;        // [BQ] 1/l
  float* Ms = Li + BQ;              // [BQ] m
  float* Es = Ms + BQ;              // [BQ] delta

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BK;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int64_t row_st = static_cast<int64_t>(N) * HD;  // dO, dk, dv
  const T* qb = q + b * st.q_sb + n * st.q_sn;
  const T* dob = dout + (static_cast<int64_t>(b) * Tq * N + n) * HD;
  const float* ab = bias + b * st.a_sb + n * st.a_sn;
  const int64_t rows = static_cast<int64_t>(bn) * Tq;

  load_tile<T, HD>(Ks, k + b * st.k_sb + n * st.k_sn, st.k_st, k0, Tk);
  load_tile<T, HD>(Vs, v + b * st.v_sb + n * st.v_sn, st.v_st, k0, Tk);

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
    load_tile<T, HD>(Qs, qb, st.q_st, q0, Tq);
    load_tile<T, HD>(Ds, dob, row_st, q0, Tq);
    load_rows(Li, Ms, Es, l + rows, m + rows, delta + rows, q0, Tq);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    tile_p_ds<HD>(Qs, Ds, Ks, Vs, Li, Ms, Es, ab, st, q0, k0, Tq, Tk, scale,
                  causal, p, ds);
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
flash_bias_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ l,
                         const float* __restrict__ m,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         float* __restrict__ dbias, int N, int Tq, int Tk,
                         Strides st, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / TX;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD], unscaled q
  float* Ds = Qs + BQ * LD;         // [BQ][LD], dO
  float* Ks = Ds + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Ss = Vs + BK * LD;         // [BQ][LDP], round(ds)
  float* Li = Ss + BQ * LDP;        // [BQ]
  float* Ms = Li + BQ;              // [BQ]
  float* Es = Ms + BQ;              // [BQ]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int64_t row_st = static_cast<int64_t>(N) * HD;  // dO, dq
  const T* kb = k + b * st.k_sb + n * st.k_sn;
  const T* vb = v + b * st.v_sb + n * st.v_sn;
  const float* ab = bias + b * st.a_sb + n * st.a_sn;
  const int64_t rows = static_cast<int64_t>(bn) * Tq;

  load_tile<T, HD>(Qs, q + b * st.q_sb + n * st.q_sn, st.q_st, q0, Tq);
  load_tile<T, HD>(Ds, dout + (static_cast<int64_t>(b) * Tq * N + n) * HD,
                   row_st, q0, Tq);
  load_rows(Li, Ms, Es, l + rows, m + rows, delta + rows, q0, Tq);

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
    load_tile<T, HD>(Ks, kb, st.k_st, k0, Tk);
    load_tile<T, HD>(Vs, vb, st.v_st, k0, Tk);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    tile_p_ds<HD>(Qs, Ds, Ks, Vs, Li, Ms, Es, ab, st, q0, k0, Tq, Tk, scale,
                  causal, p, ds);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + TX * j;
        Ss[(ty + TY * i) * LDP + tx + TX * j] = round_to<T>(ds[i][j]);
        if (dbias != nullptr && row < Tq && col < Tk)
          dbias[(rows + row) * Tk + col] = ds[i][j];
      }
    }
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
#pragma unroll
    for (int d = 0; d < DPT; ++d) out[tx + TX * d] = from_f32<T>(acc[i][d]);
  }
}

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(BQ) * (HD + 1) +
                          2 * static_cast<size_t>(BQ) * LDP + 3 * BQ);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * static_cast<size_t>(BQ) * (HD + 1) +
                          static_cast<size_t>(BQ) * LDP + 3 * BQ);
}

// ---------------------------------------------------------------------------
// bf16 and f16: the Hopper kernels (wgmma, TMA, a producer warp), on the
// backwards' tiles of sm90.cuh

using sm90::BWD_ROWS;
using sm90::BWD_STAGES;
using sm90::BWD_TILE;

// dK and dV for 128 keys of one (batch, head). Per query tile: S^T =
// K Q^T and dP^T = V dO^T (keys as rows, queries as columns), x = (S^T +
// bias^T) * scale, p^T = exp(x - m) * (1/l) and ds^T = (dP^T - delta) p^T
// scale with 1/l, m and delta along the columns, then dV += round(p^T) dO
// and dK += round(ds^T) Q. KEY_MASK: the bias is mha's key mask, one
// value per key (row), read once.
template <typename T, int HD, bool KEY_MASK>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_bias_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ bias,
                               const float* __restrict__ l,
                               const float* __restrict__ m,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int N,
                               int Tq, int Tk, int64_t a_sb, int64_t a_sn,
                               int64_t a_st, int64_t a_ss, float scale,
                               int causal) {
  using L = sm90::BwdSmem<HD, 3>;   // the tile's 1/l, m and delta rows
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
    if (lane == 0) sm90::bwd_load_owned<HD, 3>(base, &tk, &tv, b, n, k0);
    const int64_t at = static_cast<int64_t>(bn) * Tq;
    for (int it = 0; it < n_iter; ++it) {
      const int q0 = (qt0 + it) * BWD_TILE;
      float* rows = reinterpret_cast<float*>(
          sm90::bwd_load_tile<HD, 3>(base, &tq, &tdo, b, n, it, q0,
                                     lane == 0) + L::ROWS);
      for (int r = lane; r < BWD_TILE; r += 32) {
        const bool in = q0 + r < Tq;
        rows[r] = in ? 1.f / l[at + q0 + r] : 0.f;
        rows[BWD_TILE + r] = in ? m[at + q0 + r] : 0.f;
        rows[2 * BWD_TILE + r] = in ? delta[at + q0 + r] : 0.f;
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
  const float* ab = bias + b * a_sb + n * a_sn;
  float kmask[2];   // KEY_MASK: the bias of this thread's two keys
  if constexpr (KEY_MASK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      kmask[i] = row0 + 8 * i < Tk ? __ldg(ab + row0 + 8 * i) : 0.f;
  }

  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  sm90::mbar_wait(bars, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % BWD_STAGES;
    const int q0 = (qt0 + it) * BWD_TILE;
    unsigned char* st = base + L::TILES + s * L::STAGE;
    sm90::mbar_wait(full + s, (it / BWD_STAGES) & 1);
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
      const float* li = reinterpret_cast<const float*>(st + L::ROWS);
      const float* ms = li + BWD_TILE;
      const float* es = li + 2 * BWD_TILE;
      // the ragged end of Tq and the causal diagonal tile (kw == q0)
      const bool edge = q0 + BWD_TILE > Tq || (causal && kw == q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(li + 8 * j + 2 * c);
        const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * j + 2 * c);
        const float2 e2 = *reinterpret_cast<const float2*>(es + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * j + 2 * c + (e & 1);
          const int key = row0 + 8 * (e >> 1);
          float a;
          if constexpr (KEY_MASK)
            a = kmask[e >> 1];
          else
            a = q < Tq && key < Tk ? __ldg(ab + q * a_st + key * a_ss) : 0.f;
          const float x = (sp[4 * j + e] + a) * scale;
          float p = expf(x - ((e & 1) ? m2.y : m2.x)) * ((e & 1) ? l2.y : l2.x);
          if (edge && (q >= Tq || (causal && key > q))) p = 0.f;
          dp[4 * j + e] =
              (dp[4 * j + e] - ((e & 1) ? e2.y : e2.x)) * p * scale;
          sp[4 * j + e] = p;
        }
      }
      uint32_t pa[4][4], sa[4][4];
      sm90::pack_frags<T>(pa, sp);
      sm90::pack_frags<T>(sa, dp);
      sm90::wgmma_fence();
      sm90::grad_product<T, HD>(acc_v, pa, st + L::TILE_B);   // dO
      sm90::grad_product<T, HD>(acc_k, sa, st);               // q
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
// dP = dO V^T, x = (S + bias) * scale, p = exp(x - m) * (1/l) and ds =
// (dP - delta) p scale with 1/l, m and delta per row, dQ += round(ds) K;
// with `dbias`, ds in f32 to dbias. KEY_MASK: the bias is mha's key mask,
// read as pairs of columns before each tile's products. With `o` (the
// forward's output), delta is computed in the prologue from o and the
// owned dO tile and written to `delta` for dkv, once a row.
template <typename T, int HD, bool KEY_MASK>
__global__ void __launch_bounds__(sm90::ATT_THREADS, 1)
flash_bias_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ bias,
                              const float* __restrict__ l,
                              const float* __restrict__ m,
                              float* __restrict__ delta,
                              const T* __restrict__ o,
                              T* __restrict__ dq, float* __restrict__ dbias,
                              int N, int Tq, int Tk, int64_t a_sb,
                              int64_t a_sn, int64_t a_st, int64_t a_ss,
                              float scale, int causal) {
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
  const float* ab = bias + b * a_sb + n * a_sn;
  const bool fold = o != nullptr;   // uniform across the block

  float li[2], mr[2], er[2];   // li holds l until every load is issued
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t at = static_cast<int64_t>(bn) * Tq + row;
    li[i] = row < Tq ? l[at] : 0.f;
    mr[i] = row < Tq ? m[at] : 0.f;
    er[i] = row < Tq && !fold ? delta[at] : 0.f;
  }
  // the fold's share of o, read under the owned tiles' TMA; issued after
  // the rows' loads, so those do not queue behind it, and before 1/l, so
  // the thread does not wait on l before issuing it: either other order
  // puts one load's latency after the other's in every block
  uint4 ov[2][HD / 32];
  if (fold) sm90::delta_load_o<T, HD>(ov, o, b, n, N, Tq, row0, row0 - q0, c);
#pragma unroll
  for (int i = 0; i < 2; ++i) li[i] = row0 + 8 * i < Tq ? 1.f / li[i] : 0.f;

  sm90::mbar_wait(bars, 0);
  if (fold) {
    sm90::delta_rows<T, HD>(er, ov, base + L::OWN_B, L::BOX_OWN, row0 - q0,
                            c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (c == 0 && row0 + 8 * i < Tq)
        delta[static_cast<int64_t>(bn) * Tq + row0 + 8 * i] = er[i];
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % BWD_STAGES;
    const int k0 = kt * BWD_TILE;
    unsigned char* st = base + L::TILES + s * L::STAGE;
    // causal: a key tile wholly after the warpgroup's rows is masked
    const bool run = !causal || k0 <= wrow;
    float2 mask[KEY_MASK ? 8 : 1];
    if constexpr (KEY_MASK) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * c;
        if (run && key + 1 < Tk) {
          mask[j] = __ldg(reinterpret_cast<const float2*>(ab + key));
        } else {
          mask[j].x = run && key < Tk ? __ldg(ab + key) : 0.f;
          mask[j].y = 0.f;
        }
      }
    }
    sm90::mbar_wait(full + s, (kt / BWD_STAGES) & 1);
    if (run) {
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
          float a;
          if constexpr (KEY_MASK)
            a = (e & 1) ? mask[j].y : mask[j].x;
          else
            a = row < Tq && key < Tk ? __ldg(ab + row * a_st + key * a_ss)
                                     : 0.f;
          const float x = (sp[4 * j + e] + a) * scale;
          float p = expf(x - mr[e >> 1]) * li[e >> 1];
          if (edge && (key >= Tk || (causal && key > row))) p = 0.f;
          const float ds = (dp[4 * j + e] - er[e >> 1]) * p * scale;
          if (dbias != nullptr && row < Tq && key < Tk)
            dbias[(static_cast<int64_t>(bn) * Tq + row) * Tk + key] = ds;
          dp[4 * j + e] = ds;
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
  sm90::store_rows<T, HD>(dq, acc, b, n, N, Tq, row0, c,
                          [](float x) { return x; });
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *l, *m;
  float* delta;   // written by the Hopper dq kernel when it is given o
  int B, N, Tq, Tk;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

// bf16 and f16 launch the Hopper kernels, f32 the FMA ones; the Hopper
// launches return cudaErrorInvalidValue when TMA refuses a tensor
template <typename T, int HD>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap mp[4];
    if (!sm90::bwd_maps<T, HD>(mp, a.q, a.k, a.v, a.dout, a.B, a.N, a.Tq,
                               a.Tk, a.st, true))
      return cudaErrorInvalidValue;
    constexpr int smem = sm90::BwdSmem<HD, 3>::BYTES;
    static cudaError_t err = sm90::allow_smem(   // once a process
        flash_bias_bwd_dkv_sm90_kernel<T, HD, true>,
        flash_bias_bwd_dkv_sm90_kernel<T, HD, false>, smem);
    if (err != cudaSuccess) return err;
    auto kernel = sm90::bias_is_key_mask(a.bias, a.st.a_sb, a.st.a_sn,
                                         a.st.a_st, a.st.a_ss)
                      ? flash_bias_bwd_dkv_sm90_kernel<T, HD, true>
                      : flash_bias_bwd_dkv_sm90_kernel<T, HD, false>;
    dim3 grid((a.Tk + BWD_ROWS - 1) / BWD_ROWS, a.B * a.N);
    kernel<<<grid, sm90::ATT_THREADS, smem, a.stream>>>(
        mp[0], mp[1], mp[2], mp[3], a.bias, a.l, a.m, a.delta,
        static_cast<T*>(dk), static_cast<T*>(dv), a.N, a.Tq, a.Tk, a.st.a_sb,
        a.st.a_sn, a.st.a_st, a.st.a_ss, a.scale, a.causal);
    return cudaGetLastError();
  } else {
    constexpr size_t smem = dkv_smem<HD>();
    auto kernel = flash_bias_bwd_dkv_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((a.Tk + BK - 1) / BK, a.B * a.N);
    kernel<<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
        a.l, a.m, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.N,
        a.Tq, a.Tk, a.st, a.scale, a.causal);
    return cudaGetLastError();
  }
}

// o: NULL, or (bf16 and f16 only) the forward's output, from which the
// Hopper dq kernel computes delta and writes it
template <typename T, int HD>
cudaError_t launch_dq(const Args& a, const void* o, void* dq, float* dbias) {
  if constexpr (!std::is_same<T, float>::value) {
    CUtensorMap mp[4];
    if (!sm90::bwd_maps<T, HD>(mp, a.q, a.k, a.v, a.dout, a.B, a.N, a.Tq,
                               a.Tk, a.st, false))
      return cudaErrorInvalidValue;
    constexpr int smem = sm90::BwdSmem<HD, 0>::BYTES;
    static cudaError_t err = sm90::allow_smem(   // once a process
        flash_bias_bwd_dq_sm90_kernel<T, HD, true>,
        flash_bias_bwd_dq_sm90_kernel<T, HD, false>, smem);
    if (err != cudaSuccess) return err;
    auto kernel = sm90::bias_is_key_mask(a.bias, a.st.a_sb, a.st.a_sn,
                                         a.st.a_st, a.st.a_ss)
                      ? flash_bias_bwd_dq_sm90_kernel<T, HD, true>
                      : flash_bias_bwd_dq_sm90_kernel<T, HD, false>;
    dim3 grid((a.Tq + BWD_ROWS - 1) / BWD_ROWS, a.B * a.N);
    kernel<<<grid, sm90::ATT_THREADS, smem, a.stream>>>(
        mp[0], mp[1], mp[2], mp[3], a.bias, a.l, a.m, a.delta,
        static_cast<const T*>(o), static_cast<T*>(dq), dbias, a.N, a.Tq,
        a.Tk, a.st.a_sb, a.st.a_sn, a.st.a_st, a.st.a_ss, a.scale, a.causal);
    return cudaGetLastError();
  } else {
    if (o != nullptr) return cudaErrorInvalidValue;   // no FMA fold
    constexpr size_t smem = dq_smem<HD>();
    auto kernel = flash_bias_bwd_dq_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((a.Tq + BQ - 1) / BQ, a.B * a.N);
    kernel<<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<const T*>(a.dout),
        a.l, a.m, a.delta, static_cast<T*>(dq), dbias, a.N, a.Tq, a.Tk, a.st,
        a.scale, a.causal);
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

// Both entry points take, in order: q, k, v, bias, dO, l, m, delta, the
// outputs (dk, dv; or o, dq, dbias: dbias may be NULL, and with a
// non-NULL o, the forward's output (contiguous [B, Tq, N, H], 16-byte
// aligned; bf16 and f16), dq computes delta and writes it), B, N, Tq, Tk,
// head_dim, dtype, the 9 q/k/v strides ([B, T, N, H]), the 4 bias
// strides ([B, N, Tq, Tk]), scale, causal and the stream.
#define PADDLE_BWD_ARGS                                                   \
  const void *q, const void *k, const void *v, const void *bias,          \
      const void *dout, const void *l, const void *m, void *delta
#define PADDLE_BWD_TAIL                                                   \
  int B, int N, int Tq, int Tk, int head_dim, int dtype, long long q_sb,  \
      long long q_st, long long q_sn, long long k_sb, long long k_st,     \
      long long k_sn, long long v_sb, long long v_st, long long v_sn,     \
      long long a_sb, long long a_sn, long long a_st, long long a_ss,     \
      float scale, int causal, void *stream
#define PADDLE_BWD_PACK                                                   \
  if (B < 1 || N < 1 || Tq < 1 || Tk < 1 || B * N > 65535)                \
    return static_cast<int>(cudaErrorInvalidValue);                       \
  const Args a{q, k, v, dout,                                             \
               static_cast<const float*>(bias),                           \
               static_cast<const float*>(l),                              \
               static_cast<const float*>(m),                              \
               static_cast<float*>(delta), B, N, Tq, Tk,                  \
               Strides{q_sb, q_st, q_sn, k_sb, k_st, k_sn, v_sb, v_st,    \
                       v_sn, a_sb, a_sn, a_st, a_ss},                     \
               scale, causal, static_cast<cudaStream_t>(stream)}

extern "C" int paddle_flash_attention_bias_bwd_dkv(PADDLE_BWD_ARGS, void* dk,
                                                   void* dv,
                                                   PADDLE_BWD_TAIL) {
  PADDLE_BWD_PACK;
  PADDLE_DISPATCH(dtype, head_dim,
                  return static_cast<int>(launch_dkv<T, HD>(a, dk, dv)));
}

extern "C" int paddle_flash_attention_bias_bwd_dq(PADDLE_BWD_ARGS,
                                                  const void* o, void* dq,
                                                  void* dbias,
                                                  PADDLE_BWD_TAIL) {
  PADDLE_BWD_PACK;
  PADDLE_DISPATCH(dtype, head_dim,
                  return static_cast<int>(launch_dq<T, HD>(
                      a, o, dq, static_cast<float*>(dbias))));
}
