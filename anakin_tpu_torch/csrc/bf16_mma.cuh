// bf16 tensor-core helpers shared by flash_attention.cu and matmul_w4.cu:
// mma.sync m16n8k16 with float32 accumulation, and the packing of two
// values into one 32-bit fragment register.
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

}  // namespace ak
