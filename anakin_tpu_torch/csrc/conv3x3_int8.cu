// conv3x3_int8: 3x3 stride-1 pad-1 convolution of an NHWC int8 image with
// an HWIO int8 weight, int32 accumulation in registers, and the same fused
// epilogue as matmul_int8 (dequant / bias / residual / relu, relu6 or
// leaky_relu / requant), written once as int8, float32 or bfloat16.
//
// Replaces the TPU kernel anakin_tpu/kernels/conv_int8.py::conv3x3_int8,
// which pads the image and computes the nine taps as shifted whole-image
// products in VMEM.  Here the convolution is an implicit GEMM: the rows are
// the N*H*W output pixels, the reduction runs over K = 9*C in (dy, dx, c)
// order, and the A tile is gathered straight from the unpadded image, with
// the one-pixel halo supplied as zeros by the copies themselves.  No
// padded copy and no im2col matrix is ever written to device memory.
//
// What bounds it on an H100: ResNet-50's 3x3 layers at batch 128 do
// 2*N*H*W*9*C*O operations on N*H*W*(C+O) + 9*C*O bytes, several hundred
// operations a byte, so they are limited by the int8 tensor-core rate.  The
// core (int8_igemm.cuh) runs wgmma on a cp.async ring whose A pieces are
// gathered per tap, the halo being the copy's zero fill; the weight is the
// [O][9 C] copy prepared once per Net.  The image rows are re-read once for
// each of the nine taps, mostly from L2.
#include "int8_igemm.cuh"

// w: the prepared weight [O][ldb], ldb >= 9 C (kernels/matmul_int8.py::
// prepare_b of the HWIO weight).
extern "C" int ak_conv3x3_int8(const void* x, const void* w, int ldb,
                               const void* scale,
                               const void* bias, const void* res, int res_kind,
                               float res_scale, void* out, int out_kind,
                               int N, int H, int W, int C, int O, int act,
                               float alpha, float inv_out_scale, void* stream) {
  if (N == 0 || H == 0 || W == 0 || O == 0) return 0;
  ak::Params p{};
  p.a = static_cast<const int8_t*>(x);
  p.b = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.res = res;
  p.out = out;
  p.M = N * H * W;
  p.N = O;
  p.K = 9 * C;
  p.ldb = ldb;
  p.H = H;
  p.W = W;
  p.C = C;
  p.act = act;
  p.alpha = alpha;
  p.res_kind = res_kind;
  p.res_scale = res_scale;
  p.out_kind = out_kind;
  p.inv_out_scale = inv_out_scale;
  return ak::launch_igemm<true>(p, static_cast<cudaStream_t>(stream));
}
