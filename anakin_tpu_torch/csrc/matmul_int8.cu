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
// int8 tensor-core rate (1,979 TOP/s) is limited by operations for the
// wide layers and by bytes (3.35 TB/s) for the narrow ones.  The design
// (int8_igemm.cuh) feeds wgmma from a cp.async ring in swizzled shared
// memory, reads the weight in the [N][K] layout prepared once per Net, and
// picks its tile per shape (64-wide for N = 64, a K split across a cluster
// for the classifier); the int32 accumulator never goes to device memory,
// an int8 residual is dequantized in the epilogue instead of being widened
// to float in memory first, and the ragged edges are the copies' zero fill,
// so no operand is copied before the launch.
#include "int8_igemm.cuh"

// b: the prepared weight [N][ldb] (kernels/matmul_int8.py::prepare_b).
extern "C" int ak_matmul_int8(const void* a, const void* b, int ldb,
                              const void* scale,
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
  p.ldb = ldb;
  p.act = act;
  p.alpha = alpha;
  p.res_kind = res_kind;
  p.res_scale = res_scale;
  p.out_kind = out_kind;
  p.inv_out_scale = inv_out_scale;
  return ak::launch_igemm<false>(p, static_cast<cudaStream_t>(stream));
}

// The tile a launch of M x N x K takes (int8_igemm.cuh, pick_config): the
// block tile's rows and N width, and the number of K splits.
extern "C" void ak_igemm_config(int M, int N, int K, int* bm, int* bn,
                                int* splits) {
  const ak::igemm::Config c = ak::igemm::pick_config(M, N, K);
  *bm = ak::igemm::BM;
  *bn = c.bn;
  *splits = c.splits;
}
