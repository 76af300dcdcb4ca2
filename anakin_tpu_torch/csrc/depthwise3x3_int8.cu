// depthwise3x3_int8: 3x3 depthwise convolution, pad 1, stride 1 or 2,
// channel multiplier 1, of an NHWC int8 image with a [3, 3, 1, C] int8
// weight, int32 accumulation in registers and the int8 kernels' fused
// epilogue (dequant / bias / relu, relu6 or leaky_relu / requant), written
// once as int8, float32 or bfloat16:
//
//   acc[n,ho,wo,c] = sum_{dy,dx} x[n, s*ho+dy-1, s*wo+dx-1, c] * w[dy,dx,0,c]
//   y = act(float(acc) * scale[c] + bias[c]),  scale = in_scale * w_scale
//   out = int8(clip(rint(y * inv_out_scale), -127, 127))  or  f32 / bf16 y
//
// Replaces the TPU kernel anakin_tpu/kernels/depthwise_int8.py::
// depthwise3x3_int8.  That kernel pads the image, rolls int32 products
// along sublanes for the +-1 column taps, and splits a stride-2 image into
// four parity planes, because Mosaic has no strided int8 loads and no int8
// rotates.  None of that is needed here: the halo is a bounds check, the
// stride is index arithmetic, and no padded or parity-split copy is made.
// Any H and W are taken at either stride, odd ones at stride 2 included
// (Ho = (H - 1) / 2 + 1; the last row and column's taps past the image are
// halo), as the JAX package's default XLA route computes them.
//
// What bounds it on an H100: 18 operations per output element against at
// least 2 bytes (one int8 read of x, one int8 write of y, at stride 1), so
// it is bound by memory bandwidth, x + y + w bytes over 3.35 TB/s.  This
// first version gives each thread one output pixel x 16 contiguous channels
// (16-byte loads of x and w, 16 int32 accumulators); the nine taps of
// neighbouring pixels re-read x, mostly from L1/L2.  Shared-memory row
// tiles, so that each input byte leaves HBM once, are the next step.  A
// ragged C or a misaligned pointer takes a one-channel-per-thread path.
#include "int8_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;

struct DwParams {
  const int8_t* x;     // [N, H, W, C]
  const int8_t* w;     // [3, 3, 1, C]
  const float* scale;  // [C], already in_scale * w_scale
  const float* bias;   // [C] or null
  void* out;           // [N, Ho, Wo, C]
  int N, H, W, C, Ho, Wo, stride;
  int act;
  float alpha;
  int out_kind;
  float inv_out_scale;
};

__device__ __forceinline__ int sbyte(uint32_t word, int j) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * j)) & 0xffu));
}

// acc[4k + j] += x byte (4k + j) * w byte (4k + j), for the 16 lanes.
__device__ __forceinline__ void mac16(int (&acc)[VEC], const uint4 xv,
                                      const uint4 wv) {
  const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[4 * k + j] += sbyte(xs[k], j) * sbyte(ws[k], j);
}

// Output pixel (n, ho, wo) and channel chunk of flat thread index i.
__device__ __forceinline__ void decompose(const DwParams& p, size_t i,
                                          int chunks, int& n, int& ho, int& wo,
                                          int& chunk) {
  chunk = static_cast<int>(i % chunks);
  size_t pix = i / chunks;
  wo = static_cast<int>(pix % p.Wo);
  pix /= p.Wo;
  ho = static_cast<int>(pix % p.Ho);
  n = static_cast<int>(pix / p.Ho);
}

__global__ void __launch_bounds__(THREADS) dw3x3_vec16_kernel(const DwParams p) {
  const int chunks = p.C / VEC;
  const size_t total = static_cast<size_t>(p.N) * p.Ho * p.Wo * chunks;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  int n, ho, wo, chunk;
  decompose(p, i, chunks, n, ho, wo, chunk);
  const int c0 = chunk * VEC;

  int acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = ho * p.stride + dy - 1;
    if (ih < 0 || ih >= p.H) continue;
    const int8_t* row = p.x + (static_cast<size_t>(n) * p.H + ih) * p.W * p.C;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = wo * p.stride + dx - 1;
      if (iw < 0 || iw >= p.W) continue;
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(
          row + static_cast<size_t>(iw) * p.C + c0));
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(
          p.w + (dy * 3 + dx) * p.C + c0));
      mac16(acc, xv, wv);
    }
  }

  float y[VEC];
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(p.scale + c0) + q);
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[4 * q + j] = __fmul_rn(static_cast<float>(acc[4 * q + j]), sv[j]);
    if (p.bias) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + c0) + q);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) y[4 * q + j] = __fadd_rn(y[4 * q + j], bv[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) y[j] = ak::activate(y[j], p.act, p.alpha);

  const size_t o = (((static_cast<size_t>(n) * p.Ho + ho) * p.Wo + wo) * p.C) + c0;
  if (p.out_kind == ak::OUT_S8) {
    uint32_t words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    ak::requant(y[4 * k + j], p.inv_out_scale))) << (8 * j);
      words[k] = word;
    }
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + o) =
        make_uint4(words[0], words[1], words[2], words[3]);
  } else if (p.out_kind == ak::OUT_F32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      dst[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
  } else {
    __nv_bfloat16 h[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) h[j] = __float2bfloat16_rn(y[j]);
    uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o);
    dst[0] = *reinterpret_cast<const uint4*>(h);
    dst[1] = *reinterpret_cast<const uint4*>(h + 8);
  }
}

// One output element per thread: any C, any alignment.
__global__ void __launch_bounds__(THREADS) dw3x3_scalar_kernel(const DwParams p) {
  const size_t total = static_cast<size_t>(p.N) * p.Ho * p.Wo * p.C;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  int n, ho, wo, c;
  decompose(p, i, p.C, n, ho, wo, c);
  int acc = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = ho * p.stride + dy - 1;
    if (ih < 0 || ih >= p.H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = wo * p.stride + dx - 1;
      if (iw < 0 || iw >= p.W) continue;
      const size_t xi = ((static_cast<size_t>(n) * p.H + ih) * p.W + iw) * p.C + c;
      acc += static_cast<int>(p.x[xi]) *
             static_cast<int>(p.w[(dy * 3 + dx) * p.C + c]);
    }
  }
  float y = __fmul_rn(static_cast<float>(acc), p.scale[c]);
  if (p.bias) y = __fadd_rn(y, p.bias[c]);
  ak::store_out(p.out, p.out_kind, i, ak::activate(y, p.act, p.alpha),
                p.inv_out_scale);
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

extern "C" int ak_depthwise3x3_int8(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int out_kind, int N, int H,
                                    int W, int C, int stride, int act,
                                    float alpha, float inv_out_scale,
                                    void* stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  DwParams p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.act = act;
  p.alpha = alpha;
  p.out_kind = out_kind;
  p.inv_out_scale = inv_out_scale;
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % VEC == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(scale) && aligned16(bias) && aligned16(out);
  const size_t pixels = static_cast<size_t>(N) * p.Ho * p.Wo;
  const size_t threads = vec ? pixels * (C / VEC) : pixels * C;
  const size_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec)
    dw3x3_vec16_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p);
  else
    dw3x3_scalar_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
