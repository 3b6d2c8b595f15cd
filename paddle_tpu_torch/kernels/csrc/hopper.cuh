// Hopper building blocks shared by the flash-attention kernels (sm_90a):
// TMA tile loads into 128-byte-swizzled shared memory, mbarrier pipelines,
// warpgroup register hand-off, and wgmma (warpgroup matrix multiply) with
// its shared-memory descriptors.
//
// Element types. The kernels take bf16 or fp16 operands (`Elem<T>`): the
// two share every fragment, descriptor and tile layout below and
// accumulate in f32; they differ only in the products' type string
// (.bf16 / .f16), the TMA data type and the f32 -> pair rounding.
//
// Layout contract. Every operand tile in shared memory is what a TMA load
// of a box of 64 16-bit columns (128 bytes, the swizzle span) writes with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes, the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8), tiles 1024-byte aligned. A head dimension
// of 128 is two such boxes, one after the other. wgmma reads them through
// descriptors of layout type B128:
//   * K-major (the reduction dimension runs along the 128-byte row): 8-row
//     groups 1024 bytes apart (SBO); a 16-column step of the reduction
//     moves the start address by 32 bytes inside the row;
//   * MN-major (rows run along the reduction dimension, transpose flag 1):
//     8-row groups of the reduction 1024 bytes apart (SBO), 64-column
//     atoms of the output dimension LBO bytes apart; a 16-row step of the
//     reduction moves the start address by 2048 bytes.
// The f32 accumulator of m64nNk16 gives thread (warp w, lane 4g + t) of the
// warpgroup rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1:
// d[4j + 2h + e] is (row 16w + g + 8h, column 8j + 2t + e). A 16-bit A
// fragment from registers for a 16-column step kk is the same pattern,
// packed in pairs, so an accumulator re-packs into the A operand of the
// next product without leaving the registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ---- element types ------------------------------------------------------------
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ __half round(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
constexpr bool kIsHalf = std::is_same_v<T, __half>;

// mma.sync m16n8k16, f32 += T x T (A row-major, B column-major fragments)
template <typename T>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
#define HOPPER_MMA_16816(TY)                                              \
  asm volatile(                                                           \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "          \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"           \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (kIsHalf<T>)
    HOPPER_MMA_16816("f16");
  else
    HOPPER_MMA_16816("bf16");
#undef HOPPER_MMA_16816
}

// a wait that lasts this many cycles (seconds) means a lost arrival or a
// wrong phase: trap, so that the launch fails instead of hanging the card
constexpr long long kHangCycles = 8000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
#pragma unroll 1
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      start = clock64();
    } else if (clock64() - start > kHangCycles) {
      __trap();
    }
  }
}

// ---- TMA ----------------------------------------------------------------------
// one box of a [BH, S, D] tensor map at (column c0, row c1, head c2) into
// shared memory, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// writes of this thread to shared memory become visible to the async proxy
// (wgmma operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `count` threads (a multiple of 32), id 1..15
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- warpgroup registers ------------------------------------------------------
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma ------------------------------------------------------------------
// shared-memory descriptor, 128-byte swizzle; lbo/sbo in bytes
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// K-major operand: rows 128 bytes apart, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_b128(addr, 16, 1024);
}

// MN-major operand whose 64-column atoms lie `atom_bytes` apart
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr,
                                                 uint32_t atom_bytes) {
  return desc_b128(addr, atom_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A fragment of the 16-column step kk of an accumulator, rounded to T
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N],
                                       int kk) {
  a[0] = Elem<T>::pack(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = Elem<T>::pack(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = Elem<T>::pack(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = Elem<T>::pack(c[8 * kk + 6], c[8 * kk + 7]);
}

// m64nNk16, f32 += T x T. _ss: A and B from shared memory (N 32, 64, 128);
// _rs: A from registers (N 64, 128). TA / TB: 0 K-major, 1 MN-major
// (transposed). Each body is one asm statement per element type: the type
// string is part of the instruction.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db) {
#define HOPPER_WGMMA_SS_N32(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                             \
      "%16, %17, p, 1, 1, %19, %20;\n}\n"                                   \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15])                                                         \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))
  if constexpr (kIsHalf<T>)
    HOPPER_WGMMA_SS_N32("f16");
  else
    HOPPER_WGMMA_SS_N32("bf16");
#undef HOPPER_WGMMA_SS_N32
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
#define HOPPER_WGMMA_SS_N64(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p, 1, 1, %35, %36;\n}\n"                                   \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))
  if constexpr (kIsHalf<T>)
    HOPPER_WGMMA_SS_N64("f16");
  else
    HOPPER_WGMMA_SS_N64("bf16");
#undef HOPPER_WGMMA_SS_N64
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
#define HOPPER_WGMMA_RS_N64(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                       \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),        \
        "n"(TB))
  if constexpr (kIsHalf<T>)
    HOPPER_WGMMA_RS_N64("f16");
  else
    HOPPER_WGMMA_RS_N64("bf16");
#undef HOPPER_WGMMA_RS_N64
}

template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
#define HOPPER_WGMMA_SS_N128(TY)                                            \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "%64, %65, p, 1, 1, %67, %68;\n}\n"                                   \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))
  if constexpr (kIsHalf<T>)
    HOPPER_WGMMA_SS_N128("f16");
  else
    HOPPER_WGMMA_SS_N128("bf16");
#undef HOPPER_WGMMA_SS_N128
}

template <typename T, int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
#define HOPPER_WGMMA_RS_N128(TY)                                            \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                       \
      :                                                                     \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),        \
        "n"(TB))
  if constexpr (kIsHalf<T>)
    HOPPER_WGMMA_RS_N128("f16");
  else
    HOPPER_WGMMA_RS_N128("bf16");
#undef HOPPER_WGMMA_RS_N128
}

// the products by output width
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32<T, TA, TB>(d, da, db);
  else if constexpr (N == 64) wgmma_ss_n64<T, TA, TB>(d, da, db);
  else wgmma_ss_n128<T, TA, TB>(d, da, db);
}

template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64<T, TB>(d, a, db);
  else wgmma_rs_n128<T, TB>(d, a, db);
}

}  // namespace hopper

// host: the tensor map of a contiguous [bh, S, D] tensor of T (bf16 or
// fp16), read in boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzle; rows past S read as zeros. Returns 0 or the driver's CUresult.
template <typename T>
static inline int encode_bhsd_map(CUtensorMap* map, const void* ptr, int bh,
                                  int S, int D, int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      map, hopper::Elem<T>::kTma, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)r;
}
