// The element steps of the int8 kernels' fused epilogue, shared by
// int8_igemm.cuh (matmul_int8, conv3x3_int8) and depthwise3x3_int8.cu:
//
//   y = act(y)                                   (activate)
//   out = int8(clip(rint(y * inv_out_scale), -127, 127))   (requant)
//   or y written as float32 / bfloat16            (store_out)
//
// Every float operation is a separately rounded IEEE op (__fmul_rn /
// __fadd_rn, so nvcc cannot contract them into FMAs), rounding is
// half-to-even (rintf), and the requant multiplies by the reciprocal the
// caller passes in: the Pallas kernels' numerics, bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ak {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_LEAKY = 3,
           ACT_SIGMOID = 4, ACT_TANH = 5 };
enum OutKind { OUT_S8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

__device__ __forceinline__ float activate(float y, int act, float alpha) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.0f);
    case ACT_RELU6: return fminf(fmaxf(y, 0.0f), 6.0f);
    case ACT_LEAKY: return y >= 0.0f ? y : __fmul_rn(y, alpha);
    case ACT_SIGMOID: return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    case ACT_TANH: return tanhf(y);
    default: return y;
  }
}

// 1.5 * 2^23: a float in [2^23, 2^24) has integer spacing, so adding it to
// |v| < 2^22 rounds v to an integer, half to even, into the low mantissa
// bits, and the bits of the sum minus MAGIC_BITS are that integer.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// clip(rint(y * inv), -127, 127), clipped first and rounded by the magic
// addition: the same integer as rint-then-clip for every float, NaN
// included (-127 either way), with no float-to-int conversion (those run
// at a quarter of the FP32 rate or less).  MAGIC_BITS has a zero low byte,
// so the sum's low byte is the int8 result.
__device__ __forceinline__ int8_t requant(float y, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(y, inv), -127.0f), 127.0f);
  return static_cast<int8_t>(__float_as_int(__fadd_rn(v, MAGIC)));
}

// float(i), exactly, for |i| < 2^22, without an int-to-float conversion
__device__ __forceinline__ float small_int_to_float(int i) {
  return __fsub_rn(__int_as_float(i + MAGIC_BITS), MAGIC);
}

// out[idx] = y as int8 (requantized), float32 or bfloat16.
__device__ __forceinline__ void store_out(void* out, int out_kind, size_t idx,
                                          float y, float inv_out_scale) {
  if (out_kind == OUT_S8) {
    static_cast<int8_t*>(out)[idx] = requant(y, inv_out_scale);
  } else if (out_kind == OUT_F32) {
    static_cast<float*>(out)[idx] = y;
  } else {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  }
}

}  // namespace ak
