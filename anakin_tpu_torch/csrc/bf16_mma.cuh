// Helpers shared by flash_attention.cu and matmul_w4.cu: bf16 mma.sync
// m16n8k16 with float32 accumulation, the packing of two values into one
// 32-bit fragment register, cp.async and ldmatrix, and launch set-up.
//
// Fragment layout of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A 16x16: a[0] = (row g,   cols 2t, 2t+1)   a[1] = (row g+8, cols 2t, 2t+1)
//            a[2] = (row g,   cols 2t+8, 2t+9) a[3] = (row g+8, cols 2t+8, 2t+9)
//   B 16x8:  b[0] = (rows 2t, 2t+1, col g)     b[1] = (rows 2t+8, 2t+9, col g)
//   C 16x8:  c[0], c[1] = (row g, cols 2t, 2t+1)
//            c[2], c[3] = (row g+8, cols 2t, 2t+1)
// In every packed register the lower 16 bits hold the lower index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ak {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// round-to-nearest-even, as torch's and XLA's float -> bfloat16 casts
__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (src is not
// read then, but must be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory, lanes 8i..8i+7 addressing the
// rows of matrix i; ldsm4t transposes each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// SMs of the current device
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// lets `Kernel` take `bytes` of dynamic shared memory, once per device
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static unsigned long long done = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (done >> dev & 1))) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

}  // namespace ak
