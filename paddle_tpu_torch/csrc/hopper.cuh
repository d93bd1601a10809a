// Hopper (sm_90a) primitives shared by the port's hand-written kernels:
// TMA tile loads into shared memory, 16-byte cp.async copies, mbarriers
// that count their bytes,
// `wgmma` warpgroup products on 128-byte-swizzled shared tiles, register
// rebalancing between warpgroups, and the host helper that encodes a
// `CUtensorMap` without linking libcuda (the driver function is fetched
// through the runtime's entry-point query, so the build flags stay those
// of every other kernel library).
//
// Tile layout. Every operand tile is a stack of 64-column panels: panel p
// holds columns [64p, 64p + 64) of `rows` rows, each row 128 bytes of bf16
// or float16 (the products, the fragments and the maps take either type,
// a template argument; the accumulator is f32 in both),
// swizzled as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it (16-byte chunk c
// of row r lands at chunk c ^ (r % 8) of that row, within 1024-byte atoms
// of 8 rows). A panel must start on a 1024-byte boundary. `wgmma` reads the
// same layout through a descriptor with layout type 1 (128B swizzle) and a
// stride of 1024 bytes between 8-row groups:
//   * K-major (the contraction index is the column): a 16-deep slice of
//     the contraction starts 32 bytes further into the panel;
//   * MN-major (the contraction index is the row, read with the transpose
//     flag): a 16-deep slice starts 16 rows = 2048 bytes further, and one
//     instruction covers the panel's 64 columns, so the leading byte offset
//     (the stride between panels) is never used.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. A wait that
// outlasts 2^28 polls (seconds; a broken protocol, never a slow tile)
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(addr, parity); ++n)
    if (n == (1u << 28)) __trap();
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Box at (c0, c1, c2) (innermost first) of a 3-D map into shared memory;
// completion is counted in bytes on `bar`. Elements outside the tensor
// arrive as zeros and count all the same.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// -------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory, asynchronously (bypassing L1).
// A thread's copies form groups; `cp_async_wait<N>` returns once all but
// its N most recent groups have landed. Other threads see the data only
// after a barrier (`__syncwarp` or `__syncthreads`).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
// The same copy, or 16 zero bytes into `dst` when `valid` is false (`src`
// is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------- register rebalancing
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- wgmma
// Descriptor of a 128B-swizzled tile starting at `p` (see the header). The
// start address sits in the low bits in 16-byte units, so `desc(p) +
// (bytes >> 4)` is the descriptor of `p + bytes` (shared addresses stay
// below 2^18).
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t a = smem_u32(p);
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);  // start address
  d |= static_cast<uint64_t>(1) << 16;            // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // 8 rows x 128 bytes
  d |= static_cast<uint64_t>(1) << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the asm statements order only each other).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the bf16 pairs of a register A operand: their conversions
// must not sink past the wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// True for float16 operands (the wgmma type field "f16"), false for bf16.
template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;

#define HOPPER_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_D32 HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
#define HOPPER_D64                                                      \
  HOPPER_D32, HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
#define HOPPER_SS_N64(TY)                                               \
  "{\n"                                                                 \
  ".reg .pred p;\n"                                                     \
  "setp.ne.b32 p, %34, 0;\n"                                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                          \
  "}\n"
#define HOPPER_SS_N128(TY)                                              \
  "{\n"                                                                 \
  ".reg .pred p;\n"                                                     \
  "setp.ne.b32 p, %66, 0;\n"                                            \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"       \
  "}\n"
#define HOPPER_RS_N64_TB(TY)                                            \
  "{\n"                                                                 \
  ".reg .pred p;\n"                                                     \
  "setp.ne.b32 p, %37, 0;\n"                                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"             \
  "}\n"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B K-major in shared memory.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  if constexpr (kF16<T>)
    asm volatile(HOPPER_SS_N64("f16")
                 : HOPPER_D32
                 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(HOPPER_SS_N64("bf16")
                 : HOPPER_D32
                 : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A and B K-major in shared
// memory.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  if constexpr (kF16<T>)
    asm volatile(HOPPER_SS_N128("f16")
                 : HOPPER_D64
                 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(HOPPER_SS_N128("bf16")
                 : HOPPER_D64
                 : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A in registers (the layout of an
// accumulator fragment, two 16-bit values a register), B MN-major in
// shared memory (read through the transpose flag).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (kF16<T>)
    asm volatile(HOPPER_RS_N64_TB("f16")
                 : HOPPER_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
  else
    asm volatile(HOPPER_RS_N64_TB("bf16")
                 : HOPPER_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(1));
}

#undef HOPPER_SS_N64
#undef HOPPER_SS_N128
#undef HOPPER_RS_N64_TB
#undef HOPPER_D64
#undef HOPPER_D32
#undef HOPPER_D8

// Accumulator fragment of a 64 x N wgmma result: element i of thread t of
// the warpgroup sits at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
// and column 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// Two f32 values rounded to T (round to nearest even) in one register,
// `lo` in the low half: a pair of an A operand, or of an output row.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (kF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Columns [16j, 16j + 16) of an f32 accumulator fragment, rounded to T,
// as the register A operand of a product over those columns.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const float (&s)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    a[j][0] = pack16<T>(s[8 * j + 0], s[8 * j + 1]);
    a[j][1] = pack16<T>(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack16<T>(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack16<T>(s[8 * j + 6], s[8 * j + 7]);
  }
}

// --------------------------------------------------------- host: maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess)
      f = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                            : nullptr;
  }();
  return fn;
}

// A bf16 or float16 tensor [n][rows][cols] (contiguous, cols a multiple of
// 64) as a 3-D map whose box is one 64-column panel of `box_rows` rows, 128B
// swizzled. Boxes that reach past `rows` (or `n`) read zeros there, never
// the next matrix's rows. Returns false when the map cannot be encoded.
template <typename T = __nv_bfloat16>
inline bool make_map_16(CUtensorMap* map, const void* base, int n, int rows,
                        int cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(cols) * 2 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             kF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
