// Helpers shared by flash_attention.cu and matmul_w4.cu for float32
// products on the tensor cores: the split of a float32 value into two TF32
// parts, and TF32 mma.sync m16n8k8 with float32 accumulation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ak {

// x = hi + lo, both TF32 as the tensor core reads a register: it ignores
// the low 13 bits.  hi is x's bits plus half a TF32 ulp, so the MMA sees x
// rounded to nearest with ties away from zero (cvt.rna.tf32's value); lo is
// x minus that value, exact in float32, which the MMA truncates to 11
// significant bits (about 2^-22 of x).  Three instructions where
// cvt.rna.tf32.f32 alone compiles to five.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// c += a b on TF32 operands (m16n8k8, float32 accumulation).  Fragments
// (g = lane / 4, t = lane % 4): a[0] (row g, k t), a[1] (row g+8, k t),
// a[2] (row g, k t+4), a[3] (row g+8, k t+4); b0 (k t, col g), b1 (k t+4,
// col g); c as in mma_bf16
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ak
