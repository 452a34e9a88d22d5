// Hopper (sm_90a) building blocks shared by the attention kernels and
// the fused matmul+BN kernels: TMA tiled loads completing on an
// mbarrier and TMA tiled stores, mbarrier phases, wgmma shared-memory
// descriptors for the 128-byte swizzle, and wgmma m64nNk16 with f32
// accumulation for bf16 and f16 operands, with A from shared memory or
// from registers. Plain wrappers over the PTX of PTX ISA 8.x; no
// CUTLASS.
//
// Layout conventions. Every tile is loaded by TMA as boxes of 64
// 16-bit elements (128 bytes) by R rows with CU_TENSOR_MAP_SWIZZLE_128B,
// into a buffer aligned to 1024 bytes: row r of a box is the 128 bytes
// at r * 128, its sixteen-byte chunks permuted by r % 8. A head dim of
// 128 is two such boxes, one after the other. wgmma reads the same
// swizzle through descriptors of layout type 1 (B128):
//   - K-major (the reduced dimension contiguous: q and k rows for
//     S = Q K^T): eight-row groups 1024 bytes apart (SBO); a step of 16
//     along the reduced dimension moves the start address 32 bytes
//     within the box, and the next box starts the next 64.
//   - MN-major (v rows for O = P V: the output dimension contiguous,
//     the reduced one across rows): eight-row groups along the reduced
//     dimension 1024 bytes apart (SBO), the next 64 output columns in
//     the next box (LBO = the box's bytes); a step of 16 along the
//     reduced dimension moves the start address 16 rows, 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"

namespace sm90 {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread initialises; the barrier completes a phase after `count`
// arrivals and every byte announced by arrive_expect_tx
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the block (and to the
// async proxy) before any thread uses them; followed by __syncthreads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this thread's arrival, announcing `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed: a barrier
// starts in phase 0, so the n-th completion (from 0) is awaited with
// parity n & 1. A wait of more than 2^34 cycles (about 10 s) traps, so
// a pipeline fault ends the launch with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// one box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`; completes `bytes` of the barrier's
// transaction count. Rows outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 2-d tensor map at (c0 innermost, c1) into shared memory
// at `dst`, completing on `bar` as tma_load_4d does
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// one box of shared memory at `src` out to a 2-d tensor map at (c0, c1);
// the parts of the box outside the tensor are not written. The writes of
// `src` must be fenced (fence_proxy_async) and synchronised first; the
// box may be reused, or the block may end, only after bulk_wait_read.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// waits until this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// orders this thread's generic-proxy writes to shared memory before
// later async-proxy reads (wgmma, TMA) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier over `count` threads (a warpgroup: 128), id 1..15
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// byte offset of the 16-byte chunk `chunk` (0-7) of row `row` in a
// 128-byte-swizzled box (see the header)
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand at `p` (see the
// header): leading and stride byte offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the instructions that issue and retire it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x (ex2.approx: relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded (to nearest even) into one register of the
// A fragment, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, f32 accumulators (N / 2 registers a thread:
// register 4j + e holds row 16 w + lane / 4 + 8 (e / 2) of the 64, and
// column 8 j + 2 (lane % 4) + e % 2, w the warp of the warpgroup).
// scale_d 0 overwrites D, 1 accumulates into it. TRANS_B 0 reads B
// K-major (the reduced dimension contiguous: k rows for S = Q K^T), 1
// MN-major (the output dimension contiguous: v rows for O = P V, w rows
// of x @ w). Two forms at N 64 and 128:
//   ss: D[64 x N] (+)= A[64 x 16] B[16 x N], A (K-major) and B in shared
//       memory, by descriptors;
//   rs: the same with A from registers (four 32-bit registers a thread,
//       the A fragment layout: the accumulator layout of a 64 x 16 tile).
// The users: S = Q K^T at N 128 (the forwards' key tiles) and at N 64
// (the backward's 64-row tiles); O += P V, dV += P^T dO, dK += dS^T Q
// and dQ += dS K at N = the head dim (rs); the fused matmul+BN template
// at its N tile of 64 or 128 (ss for K4, rs for K5 and K6).
#define SM90_D32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_D64(d) \
  SM90_D32(d), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_R32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64 \
  SM90_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// one specialisation a (type, N): TY the PTX type, the operand numbers
// after the N / 2 accumulators as strings
#define SM90_WGMMA(TYPE, TY, N, NR, DLIST, RLIST, A0, A1, A2, A3, A4, A5, A6) \
  template <>                                                                \
  struct Wgmma<TYPE, N> {                                                    \
    template <int TRANS_B>                                                   \
    static __device__ __forceinline__ void ss(float (&d)[NR], uint64_t da,   \
                                              uint64_t db, int scale_d) {    \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " A2 ", 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"    \
          RLIST "}, " A0 ", " A1 ", p, 1, 1, 0, " A3 ";\n}\n"                 \
          : DLIST(d)                                                         \
          : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));                   \
    }                                                                        \
    template <int TRANS_B>                                                   \
    static __device__ __forceinline__ void rs(float (&d)[NR],                \
                                              const uint32_t (&a)[4],        \
                                              uint64_t db, int scale_d) {    \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " A5 ", 0;\n"                    \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {"    \
          RLIST "}, {" A0 ", " A1 ", " A2 ", " A3 "}, " A4 ", p, 1, 1, " A6   \
          ";\n}\n"                                                           \
          : DLIST(d)                                                         \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
            "r"(scale_d), "n"(TRANS_B));                                     \
    }                                                                        \
  };

template <typename T, int N>
struct Wgmma;

// ss operands: da A0, db A1, scale_d A2, TRANS_B A3; rs operands: the A
// registers A0-A3, db A4, scale_d A5, TRANS_B A6
SM90_WGMMA(__nv_bfloat16, "bf16", 64, 32, SM90_D32, SM90_R32, "%32", "%33",
           "%34", "%35", "%36", "%37", "%38")
SM90_WGMMA(__nv_bfloat16, "bf16", 128, 64, SM90_D64, SM90_R64, "%64", "%65",
           "%66", "%67", "%68", "%69", "%70")
SM90_WGMMA(__half, "f16", 64, 32, SM90_D32, SM90_R32, "%32", "%33", "%34",
           "%35", "%36", "%37", "%38")
SM90_WGMMA(__half, "f16", 128, 64, SM90_D64, SM90_R64, "%64", "%65", "%66",
           "%67", "%68", "%69", "%70")

#undef SM90_WGMMA
#undef SM90_D32
#undef SM90_D64
#undef SM90_R32
#undef SM90_R64

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime so
// that the library needs no -lcuda; NULL when the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a 16-bit [B, T, N, H] tensor with element strides
// (sb, st, sn, 1), read in boxes of 64 head elements by `rows` rows of
// T at one (b, n), 128-byte swizzled; rows past T read as zeros. The
// strides of size-1 dimensions are never used and are replaced by
// valid ones. Returns false when TMA refuses the tensor (a base not 16-
// byte aligned, a stride not a multiple of 16 bytes).
inline bool make_map_bthn(CUtensorMap* map, const void* base, bool bf16,
                          int B, int T, int N, int H, int64_t sb, int64_t st,
                          int64_t sn, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (N == 1) sn = H;
  if (T == 1) st = sn * N;
  if (B == 1) sb = st * T;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a 16-bit row-major [rows, cols] matrix whose rows are
// `ld` elements apart, read and written in boxes of 64 columns (128
// bytes) by `box_rows` rows, 128-byte swizzled; elements outside the
// matrix read as zeros and are not written. Returns false when TMA
// refuses it (a base not 16-byte aligned, ld * 2 not a multiple of 16).
inline bool make_map_2d(CUtensorMap* map, const void* base, bool bf16,
                        int64_t rows, int64_t cols, int64_t ld,
                        int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

// --------------------------------------------- the attention forwards' tiles
//
// Shared by the bf16/f16 forwards of K1 (flash_attention.cu) and K2
// (flash_attention_bias.cu): one block owns BQ = 128 query rows of one
// (batch, head), two consumer warpgroups of 64 rows each, and one
// producer warp that loads the q tile once and then the k and v tiles
// of BK rows through a ring of STAGES buffers.

namespace sm90 {

constexpr int ATT_BQ = 128;        // query rows per block
constexpr int ATT_THREADS = 288;   // two consumer warpgroups + one warp
constexpr int ATT_CONSUMERS = 256;

// byte offsets in the block's shared memory (from a 1024-aligned base)
template <int HD, int BK, int STAGES>
struct AttnSmem {
  static constexpr int NBOX = HD / 64;         // 64-column boxes a row
  static constexpr int BOX_Q = ATT_BQ * 128;   // bytes of one q box
  static constexpr int BOX_K = BK * 128;       // bytes of one k or v box
  static constexpr int TILE_K = NBOX * BOX_K;  // one k or v tile
  static constexpr int Q = 0;
  static constexpr int K = Q + NBOX * BOX_Q;
  static constexpr int V = K + STAGES * TILE_K;
  static constexpr int BAR = V + STAGES * TILE_K;
  // q_full, then k_full, v_full and empty for each stage
  static constexpr int NBAR = 1 + 3 * STAGES;
  // with the slack for aligning the base to 1024 bytes
  static constexpr int BYTES = BAR + 8 * NBAR + 1024;
};

// the 1024-aligned base of the dynamic shared memory at `raw`
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// The producer (one thread): the q tile [q0, q0 + 128) once onto
// bars[0], then key tiles 0 .. n_tiles - 1 of k and v into stage
// kt % STAGES, each waiting until both consumer warpgroups have
// released the stage's previous tile (bars[1 + 2 STAGES + s]); k and v
// complete on their own barriers (bars[1 + s], bars[1 + STAGES + s]),
// so the product with k can start while v is on its way.
template <int HD, int BK, int STAGES>
__device__ __forceinline__ void attn_produce(unsigned char* base,
                                             const CUtensorMap* tq,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv,
                                             int b, int n, int q0,
                                             int n_tiles) {
  using L = AttnSmem<HD, BK, STAGES>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  mbar_arrive_expect_tx(bars, ATT_BQ * HD * 2);
#pragma unroll
  for (int x = 0; x < L::NBOX; ++x)
    tma_load_4d(base + L::Q + x * L::BOX_Q, tq, bars, 64 * x, n, q0, b);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    if (kt >= STAGES)
      mbar_wait(bars + 1 + 2 * STAGES + s, (kt / STAGES - 1) & 1);
    unsigned char* kb = base + L::K + s * L::TILE_K;
    unsigned char* vb = base + L::V + s * L::TILE_K;
    mbar_arrive_expect_tx(bars + 1 + s, BK * HD * 2);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x)
      tma_load_4d(kb + x * L::BOX_K, tk, bars + 1 + s, 64 * x, n, kt * BK, b);
    mbar_arrive_expect_tx(bars + 1 + STAGES + s, BK * HD * 2);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x)
      tma_load_4d(vb + x * L::BOX_K, tv, bars + 1 + STAGES + s, 64 * x, n,
                  kt * BK, b);
  }
}

// S[64 x BK] = Q K^T for warpgroup `wg` (rows 64 wg .. of the q tile)
// against the k tile at `kb`; issued, committed and retired
template <typename T, int HD, int BK, int STAGES>
__device__ __forceinline__ void attn_qk(float (&s)[BK / 2],
                                        const unsigned char* base,
                                        const unsigned char* kb, int wg) {
  using L = AttnSmem<HD, BK, STAGES>;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = desc_sw128(
        base + L::Q + (kk / 4) * L::BOX_Q + wg * 64 * 128 + (kk % 4) * 32, 16,
        1024);
    const uint64_t db =
        desc_sw128(kb + (kk / 4) * L::BOX_K + (kk % 4) * 32, 16, 1024);
    Wgmma<T, BK>::template ss<0>(s, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// O[64 x HD] += P V for one warpgroup, with v from the tile at `vb` as
// the MN-major B operand and P from registers: s's accumulator layout
// is, register for register, the A fragments of the 16-key steps. With
// SPLIT false, P is rounded to T (the legacy flash kernel's p.astype(
// v.dtype)); with SPLIT true, P = hi + lo with hi = round(P) and lo =
// round(P - hi), two products a step, so P keeps about twice T's
// significant bits (splash's f32 P). Issued, committed and retired.
template <typename T, int HD, int BK, int STAGES, bool SPLIT>
__device__ __forceinline__ void attn_pv(float (&o)[HD / 2],
                                        const float (&p)[BK / 2],
                                        const unsigned char* vb) {
  using L = AttnSmem<HD, BK, STAGES>;
  uint32_t hi[BK / 16][4], lo[SPLIT ? BK / 16 : 1][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = p[8 * kk + 2 * r], x1 = p[8 * kk + 2 * r + 1];
      hi[kk][r] = pack2<T>(x0, x1);
      if constexpr (SPLIT) {
        const float h0 = round_to<T>(x0), h1 = round_to<T>(x1);
        lo[kk][r] = pack2<T>(x0 - h0, x1 - h1);   // x - h is exact in f32
      }
    }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc_sw128(vb + kk * 2048, L::BOX_K, 1024);
    Wgmma<T, HD>::template rs<1>(o, hi[kk], db, 1);
    if constexpr (SPLIT) Wgmma<T, HD>::template rs<1>(o, lo[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// the row reductions of the accumulator layout: the four lanes of a
// quad hold one row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// o (f32, this thread's rows `row0` and `row0 + 8`) times inv[i], rounded
// to T, into the contiguous [B, Tq, N, HD] output at (b, n)
template <typename T, int HD>
__device__ __forceinline__ void attn_store(T* out, const float (&o)[HD / 2],
                                           const float (&inv)[2], int b,
                                           int n, int N, int Tq, int row0,
                                           int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    T* orow = out + ((static_cast<int64_t>(b) * Tq + row) * N + n) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c) =
          pack2<T>(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
  }
}

// the dynamic shared memory of both variants of a kernel template (K2's
// KEY_MASK true and false), raised to `smem` bytes
template <typename K>
cudaError_t allow_smem(K with_mask, K without, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      with_mask, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e != cudaSuccess ? e : cudaFuncSetAttribute(
      without, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// true for mha's [B, 1, 1, Tk] key-padding mask as the K2 kernels see it
// (f32 element strides [B, N, Tq, Tk]): one row of Tk values for every
// query row, read as pairs of columns (8-byte aligned rows)
inline bool bias_is_key_mask(const float* bias, int64_t a_sb, int64_t a_sn,
                             int64_t a_st, int64_t a_ss) {
  return a_st == 0 && a_ss == 1 && a_sb % 2 == 0 && a_sn % 2 == 0 &&
         reinterpret_cast<uintptr_t>(bias) % 8 == 0;
}

}  // namespace sm90

// -------------------------------------------- the attention backwards' tiles
//
// Shared by the bf16/f16 backwards of K1 (flash_attention_bwd.cu) and K2
// (flash_attention_bias_bwd.cu). Both launch ATT_THREADS (288): two
// consumer warpgroups of 64 rows and one producer warp. dkv: a block owns
// 128 keys (warpgroup wg the keys 64 wg ..), loaded once, and loops over
// query tiles of 64 rows (q and dO by TMA, the tile's f32 rows by the
// producer warp's loads) through a ring of BWD_STAGES. dq: a block owns
// 128 queries (q and dO loaded once) and loops over key tiles of 64 rows
// (k and v) through the ring. Each tile's two score products run from
// shared memory (ss, both operands K-major); their accumulators become,
// register for register, the A operand of the two (dkv) or one (dq)
// gradient products (rs, with the B operand MN-major).

namespace sm90 {

constexpr int BWD_ROWS = 128;    // rows a block owns (keys or queries)
constexpr int BWD_TILE = 64;     // rows of the tiles it loops over
constexpr int BWD_STAGES = 3;    // tiles in flight

// byte offsets in the block's shared memory (from a 1024-aligned base):
// the two tensors owned (k and v, or q and dO: 128 rows, NBOX boxes of
// 64 columns each), then BWD_STAGES stages of the two streamed tensors
// (64 rows each, then NROWS f32 rows of the tile: dkv's lse and delta, or
// 1/l, m and delta), then the barriers: the owned tensors' one, then full
// and empty a stage
template <int HD, int NROWS>
struct BwdSmem {
  static constexpr int NBOX = HD / 64;
  static constexpr int BOX_OWN = BWD_ROWS * 128;
  static constexpr int BOX_TILE = BWD_TILE * 128;
  static constexpr int OWN_A = 0;
  static constexpr int OWN_B = NBOX * BOX_OWN;
  static constexpr int TILES = 2 * NBOX * BOX_OWN;
  // within a stage: tile a, tile b, then the rows
  static constexpr int TILE_B = NBOX * BOX_TILE;
  static constexpr int ROWS = 2 * NBOX * BOX_TILE;
  static constexpr int STAGE =
      (ROWS + NROWS * 4 * BWD_TILE + 1023) / 1024 * 1024;
  static constexpr int BAR = TILES + BWD_STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * BWD_STAGES) + 1024;
};

// one thread initialises the barriers of a backward block: the owned
// tensors' (one TMA arrival), then each stage's full (`full_count`
// arrivals) and empty (every consumer thread's)
__device__ __forceinline__ void bwd_init_bars(uint64_t* bars,
                                              uint32_t full_count) {
  mbar_init(bars, 1);
  for (int s = 0; s < BWD_STAGES; ++s) {
    mbar_init(bars + 1 + s, full_count);
    mbar_init(bars + 1 + BWD_STAGES + s, ATT_CONSUMERS);
  }
  mbar_init_fence();
}

// The producer of a backward block (lane 0 of its warp in dkv, its one
// thread in dq): the 128 owned rows at r0 of tensors a and b (k and v in
// dkv, q and dO in dq) once onto bars[0]
template <int HD, int NROWS>
__device__ __forceinline__ void bwd_load_owned(unsigned char* base,
                                               const CUtensorMap* ta,
                                               const CUtensorMap* tb, int b,
                                               int n, int r0) {
  using L = BwdSmem<HD, NROWS>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  mbar_arrive_expect_tx(bars, 2 * BWD_ROWS * HD * 2);
#pragma unroll
  for (int x = 0; x < L::NBOX; ++x) {
    tma_load_4d(base + L::OWN_A + x * L::BOX_OWN, ta, bars, 64 * x, n, r0, b);
    tma_load_4d(base + L::OWN_B + x * L::BOX_OWN, tb, bars, 64 * x, n, r0, b);
  }
}

// The producer's step `it` of the ring: waits until both warpgroups
// released stage it % BWD_STAGES (from the ring's second lap on), then,
// when `issue` (one thread), loads the 64 rows at r0 of the streamed
// tensors a and b into it by TMA, completing on its full barrier.
// Returns the stage. In dkv the producer warp then writes the stage's
// f32 rows and every lane arrives on full (33 arrivals with the TMA's).
template <int HD, int NROWS>
__device__ __forceinline__ unsigned char* bwd_load_tile(
    unsigned char* base, const CUtensorMap* ta, const CUtensorMap* tb, int b,
    int n, int it, int r0, bool issue) {
  using L = BwdSmem<HD, NROWS>;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR) + 1;
  uint64_t* empty = full + BWD_STAGES;
  const int s = it % BWD_STAGES;
  if (it >= BWD_STAGES) mbar_wait(empty + s, (it / BWD_STAGES - 1) & 1);
  unsigned char* st = base + L::TILES + s * L::STAGE;
  if (issue) {
    mbar_arrive_expect_tx(full + s, 2 * BWD_TILE * HD * 2);
#pragma unroll
    for (int x = 0; x < L::NBOX; ++x) {
      tma_load_4d(st + x * L::BOX_TILE, ta, full + s, 64 * x, n, r0, b);
      tma_load_4d(st + L::TILE_B + x * L::BOX_TILE, tb, full + s, 64 * x, n,
                  r0, b);
    }
  }
  return st;
}

// D[64 x 64] = A B^T for one warpgroup: A the 64 rows at `a` (in a tile
// of `a_box` bytes a box), B the 64-row tile at `b`, both K-major over
// HD; the first step overwrites D. Issued, not committed.
template <typename T, int HD>
__device__ __forceinline__ void tile_product(float (&d)[32],
                                             const unsigned char* a,
                                             int a_box,
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da =
        desc_sw128(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        desc_sw128(b + (kk / 4) * BWD_TILE * 128 + (kk % 4) * 32, 16, 1024);
    Wgmma<T, 64>::template ss<0>(d, da, db, kk > 0);
  }
}

// acc[64 x HD] += A B for one warpgroup: A [64 x 64] the packed fragments
// of its four 16-column steps (pack_frags); B the 64-row tile at `b` as
// the MN-major operand. Issued, not committed.
template <typename T, int HD>
__device__ __forceinline__ void grad_product(float (&acc)[HD / 2],
                                             const uint32_t (&a)[4][4],
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 2048, BWD_TILE * 128, 1024);
    Wgmma<T, HD>::template rs<1>(acc, a[kk], db, 1);
  }
}

// a [64 x 64] tile in the accumulator layout, rounded to T, as the A
// fragments of its four 16-column steps
template <typename T>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

// rows row0 and row0 + 8 (< T_len) of a contiguous [B, T_len, N, HD]
// output at (b, n): f(accumulator) rounded to T
template <typename T, int HD, typename F>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[HD / 2],
                                           int b, int n, int N, int T_len,
                                           int row0, int c, F f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T_len) continue;
    T* orow = out + ((static_cast<int64_t>(b) * T_len + row) * N + n) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c) =
          pack2<T>(f(acc[4 * j + 2 * i]), f(acc[4 * j + 2 * i + 1]));
  }
}

// The delta pass folded into a dq block's prologue: delta = rowsum(f32(o)
// * f32(dO)) for the thread's rows row0 and row0 + 8 (local rows r0 and
// r0 + 8 of the owned tiles), which the four threads of its quad share.
// Each thread takes HD / 4 elements of a row: two 16-byte chunks of each
// 64-column box, the chunks of the box's first half for rows of one
// parity and of its second half for the other, so the two quads of a
// quarter warp (neighbouring rows) read disjoint banks of the swizzled
// dO tile. delta_load_o issues the o half (16-byte loads from the
// contiguous [B, Tq, N, HD] output; rows past Tq read as zeros) after
// the block's other row loads and before the owned tiles' barrier
// wait, so it overlaps their TMA without delaying the rows; delta_rows
// then reads the same elements of dO from the owned tile in shared
// memory (rows past Tq are TMA's zeros), sums the products in f32 and
// reduces across the quad.
__device__ __forceinline__ int delta_chunk(int j, int r, int c) {
  return c + 4 * ((j ^ r) & 1);   // the physical chunk in its box
}

// 16 bytes through the read-only path, issued where it stands: an asm
// volatile is not moved past the barrier wait (another asm volatile)
// that follows it, where an __ldg, an invariant load, may be sunk
__device__ __forceinline__ uint4 ld_nc_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T, int HD>
__device__ __forceinline__ void delta_load_o(uint4 (&ov)[2][HD / 32],
                                             const T* o, int b, int n, int N,
                                             int Tq, int row0, int r0,
                                             int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i, r = r0 + 8 * i;
    const T* orow = o + ((static_cast<int64_t>(b) * Tq + row) * N + n) * HD;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) {
      // the logical chunk that the swizzle puts at the physical one
      const int chunk = delta_chunk(j, r, c) ^ (r & 7);
      ov[i][j] = row < Tq ? ld_nc_v4(orow + 64 * (j / 2) + 8 * chunk)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void delta_rows(float (&er)[2],
                                           const uint4 (&ov)[2][HD / 32],
                                           const unsigned char* tile,
                                           int box_bytes, int r0, int c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) {
      const uint4 d = *reinterpret_cast<const uint4*>(
          tile + (j / 2) * box_bytes + r * 128 + 16 * delta_chunk(j, r, c));
      const uint4 w = ov[i][j];
      const T* oe = reinterpret_cast<const T*>(&w);
      const T* de = reinterpret_cast<const T*>(&d);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(to_f32(oe[e]), to_f32(de[e]), s);
    }
    er[i] = quad_sum(s);
  }
}

// the four tensor maps of a backward launch: q, k and v with their own
// element strides (st.q_sb ..), dO contiguous; BWD_ROWS rows a box for the
// tensors a block owns (k and v in dkv, q and dO in dq), BWD_TILE for the
// others
template <typename T, int HD, typename S>
bool bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int N, int Tq, int Tk, const S& st,
              bool dkv) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const int rq = dkv ? BWD_TILE : BWD_ROWS, rk = dkv ? BWD_ROWS : BWD_TILE;
  return make_map_bthn(m + 0, q, bf16, B, Tq, N, HD, st.q_sb, st.q_st,
                       st.q_sn, rq) &&
         make_map_bthn(m + 1, k, bf16, B, Tk, N, HD, st.k_sb, st.k_st,
                       st.k_sn, rk) &&
         make_map_bthn(m + 2, v, bf16, B, Tk, N, HD, st.v_sb, st.v_st,
                       st.v_sn, rk) &&
         make_map_bthn(m + 3, dout, bf16, B, Tq, N, HD,
                       static_cast<int64_t>(Tq) * N * HD,
                       static_cast<int64_t>(N) * HD, HD, rq);
}

}  // namespace sm90
