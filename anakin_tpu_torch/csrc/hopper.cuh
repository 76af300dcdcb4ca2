// Hopper primitives shared by the wgmma kernels (matmul_w4.cu,
// flash_attention.cu): wgmma shared-memory descriptors and instructions,
// mbarriers, TMA copies, and the host's encoding of TMA tensor maps.
// Every device helper is inlined; shared-memory addresses are 32-bit ints
// (__cvta_generic_to_shared).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace ak {

// wgmma shared-memory descriptors of a K-major tile: 8-row groups 8 x the
// row bytes apart (SBO), layout type 2 (SWIZZLE_64B, 64-byte rows) or 3
// (SWIZZLE_32B, 32-byte rows)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (16ull << 32) | (3ull << 62);
}

// wgmma m64n128k16, float32 += bf16 x bf16, A from registers (a warp's 16
// rows in the mma.sync m16n8k16 A-fragment order), B K-major from a
// shared-memory descriptor
#define AK_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : AK_F8(0), AK_F8(8), AK_F8(16), AK_F8(24), AK_F8(32), AK_F8(40), AK_F8(48), AK_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// wgmma m64n64k8, float32 += tf32 x tf32, A from registers (a warp's 16
// rows in the mma.sync m16n8k8 A-fragment order), B K-major from a
// shared-memory descriptor; scale_d 0 writes d = A B
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : AK_F8(0), AK_F8(8), AK_F8(16), AK_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef AK_F8

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// mbarrier and TMA helpers (shared-memory addresses as 32-bit ints)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// the box at (c0, c1) of a 2-D tensor map into shared memory at dst; its
// bytes complete on bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap& map, int c0,
                                       int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}
// the box at (c0, c1, c2) of a 3-D tensor map into shared memory at dst;
// its bytes complete on bar
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap& map, int c0,
                                       int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma descriptors of bf16 tiles in the 128-byte swizzle (TMA's
// SWIZZLE_128B: rows of 64 values, 8-row atoms of 1 KB, 1 KB aligned),
// layout type 1.  K-major (rows along M or N, k contiguous): 8-row groups
// 1 KB apart (SBO); a k step of 16 inside the 64-value row moves the start
// address by 32 bytes.  MN-major (rows along k, M or N contiguous): 8-k
// groups 1 KB apart (SBO), 64-column slabs `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma m64nNk16, float32 += bf16 x bf16, into d in the accumulator layout
// (g = lane / 4, t = lane % 4, a warp's 16 rows of the 64: d[j][0], d[j][1]
// row g, columns 8j + 2t, 8j + 2t + 1; d[j][2], d[j][3] the same at row
// g + 8), which is mma.sync's C fragment a n8 tile.
#define AK_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define AK_D16(j) AK_D4(j), AK_D4(j + 1), AK_D4(j + 2), AK_D4(j + 3)
// A [64 x 16] and B [16 x N] both K-major from shared-memory descriptors;
// d = A B, writing d only (its old values are not an input, so they need
// not stay live up to it).  N: 64 or 128.
#define AK_W4(j) "=f"(d[j][0]), "=f"(d[j][1]), "=f"(d[j][2]), "=f"(d[j][3])
#define AK_W16(j) AK_W4(j), AK_W4(j + 1), AK_W4(j + 2), AK_W4(j + 3)
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[N / 8][4], uint64_t da,
                                               uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_ss_first: N 64 or 128");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : AK_W16(0), AK_W16(4)
        : "l"(da), "l"(db), "r"(0));
  else if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : AK_W16(0), AK_W16(4), AK_W16(8), AK_W16(12)
        : "l"(da), "l"(db), "r"(0));
}
#undef AK_W16
#undef AK_W4
// The same, d += A B.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N 64 or 128");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : AK_D16(0), AK_D16(4)
        : "l"(da), "l"(db), "r"(1));
  else if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : AK_D16(0), AK_D16(4), AK_D16(8), AK_D16(12)
        : "l"(da), "l"(db), "r"(1));
}
// A from registers (a warp's 16 rows in the mma.sync m16n8k16 A-fragment
// order), B [16 x N] MN-major (transposed: N contiguous) from a shared-
// memory descriptor; d += A B.  N: 64, 128 or 256.
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs_mn: N 64, 128 or 256");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : AK_D16(0), AK_D16(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : AK_D16(0), AK_D16(4), AK_D16(8), AK_D16(12)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else if constexpr (N == 256)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : AK_D16(0), AK_D16(4), AK_D16(8), AK_D16(12), AK_D16(16), AK_D16(20), AK_D16(24), AK_D16(28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef AK_D16
#undef AK_D4

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map of rows x cols elements (row stride `pitch` bytes) in
// boxes of box_rows x box_cols, out-of-range elements read as zero.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                              size_t cols, size_t rows, size_t pitch, int box_cols,
                       int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D tensor map of bf16 [n2][n1][n0] (contiguous, n0 innermost) in boxes
// of box0 x box1 x 1 with the 128-byte swizzle, out-of-range elements read
// as zero.
inline bool tensor_map_3d(CUtensorMap* map, const void* base, size_t n0, size_t n1,
                          size_t n2, int box0, int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace ak
