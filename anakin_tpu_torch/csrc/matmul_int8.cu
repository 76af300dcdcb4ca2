// matmul_int8: int8 [M, K] x int8 [K, N] -> int32 in registers, then the
// fused dequant / bias / residual / activation / requant epilogue, written
// once as int8, float32 or bfloat16 [M, N].
//
// Replaces the TPU kernel anakin_tpu/kernels/matmul_int8.py::matmul_int8.
// On ResNet-50 at batch 128 it serves the 1x1 convolutions (M up to
// 128 * 56 * 56, K and N 64 ... 2048), the strided convolutions through an
// int8 im2col, and the classifier (M 128, K 2048, N 1000).
//
// What bounds it on an H100: at these shapes 2*M*N*K operations over
// M*K + K*N + M*N bytes is 30 ... 500 operations a byte, so a kernel at the
// int8 tensor-core rate (1,979 TOP/s) would be limited by operations for the
// wide layers and by bytes (3.35 TB/s) for the narrow ones.  This first
// version is neither: mma.sync from double-buffered shared memory (see
// int8_igemm.cuh) reaches a fraction of the wgmma rate.  What the design
// does keep is the traffic: the int32 accumulator never goes to device
// memory, an int8 residual is dequantized in the epilogue instead of being
// widened to float in memory first, and the ragged edges are masked rather
// than padded, so no operand is copied before the launch.
#include "int8_igemm.cuh"

extern "C" int ak_matmul_int8(const void* a, const void* b, const void* scale,
                              const void* bias, const void* res, int res_kind,
                              float res_scale, void* out, int out_kind, int M,
                              int N, int K, int act, float alpha,
                              float inv_out_scale, void* stream) {
  if (M == 0 || N == 0) return 0;
  ak::Params p{};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.res = res;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.act = act;
  p.alpha = alpha;
  p.res_kind = res_kind;
  p.res_scale = res_scale;
  p.out_kind = out_kind;
  p.inv_out_scale = inv_out_scale;
  const bool vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;
  return ak::launch_igemm<false>(p, vec_a, vec_b,
                                 static_cast<cudaStream_t>(stream));
}
