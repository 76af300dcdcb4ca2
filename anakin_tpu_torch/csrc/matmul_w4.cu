// matmul_w4: x [M, K] (bf16 or float32) times int4 weights with group-wise
// scales, out [M, N] float32.
//
//   W[k, n] = cast_to_x_dtype(float(int4[k, n]) * scales[k / G, n])
//   out     = x @ W, summed in float32
//
// Packing (quant.quantize._w4_group_quantize): packed [K/2, N] int8; in
// each group of G rows, packed row r holds row r in its low nibble and row
// r + G/2 in its high nibble.  The low nibble sign-extends as
// ((p & 0xF) ^ 8) - 8, the high one is the arithmetic p >> 4.
//
// Replaces the TPU kernel anakin_tpu/kernels/matmul_w4.py::matmul_w4,
// variant v1, which unpacks a [TK/2, TN] block of bytes in VMEM with int32
// shifts and a concat and feeds the MXU.  Here a block unpacks 32 packed
// rows x 128 columns at a time (64 weight rows: 32 low, 32 high) straight
// from registers into a bf16 tile in shared memory, transposed to [n][k] (and
// swizzled, see wt_off) so that each mma B fragment is one 32-bit shared
// load without bank conflicts, and the next chunk's
// bytes are already in flight while the tensor cores work on this one.
//
// What bounds it on an H100: at the decode shapes (M = 8) it is bytes:
// K/2 * N packed bytes plus K/G * N * 4 bytes of scales dominate, about
// 2.75 us per MLP projection and 10.7 us for the 32000-wide head at
// 3.35 TB/s; the 2*M*N*K operations are negligible.  So the design keeps
// the weights at half a byte each all the way to shared memory, and fills
// the card at M = 8 by splitting K: a (8192 -> 2048) projection has only
// 16 column blocks of 128 for 132 SMs, so each column block is split over
// up to ~264/16 K ranges (whole groups), each writing a float32 partial to
// a workspace that a second, tiny pass sums in a fixed order.  The result
// is deterministic: no atomics.
//
// bf16 x: mma.sync m16n8k16 with float32 accumulation, the weight rounded
// to bf16 after the float32 scale multiply, as the Pallas kernel does before
// its dot.  M <= 16 uses one 16-row warp tile per block (8 warps across
// 128 columns); larger M uses 64-row blocks (4 x 2 warps), so each
// unpacked weight tile serves 64 rows.  float32 x: fp32 FMA (no TF32), one
// thread per column and 8 rows per block.  Against the plain version the
// result differs only by the order of the float32 sums.
//
// Variant v2 (V2 = true) replaces the same TPU kernel's variant v2
// (`_make_kernel_v2`), which dequantizes in x's dtype T:
//
//   s    = T(scale)
//   w_lo = T((T(lo_u ^ 8) - 8) * s)              lo_u = p & 0xF
//   w_hi = T((T(p) - T(lo_u)) * (s * 0.0625))
//   out  = x_lo @ w_lo + x_hi @ w_hi, summed in float32
//
// The Pallas kernel splits x into per-group low and high halves outside the
// kernel because Mosaic had no int8 subtraction; here x is indexed per half
// inside the kernel, as v1 does, and only the weight dequant differs.  Every
// product above is exact in float32 before its one rounding to T, so for
// float32 x, or scales already in bf16, v2 equals v1 bit for bit; with
// float32 scales and bf16 x it rounds the scale to bf16 first.
//
// This first version uses no cp.async, TMA or wgmma; those, and a
// persistent schedule, are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int BN = 128;       // columns per block
constexpr int CH = 32;        // packed rows per chunk (64 weight rows)
constexpr int LDW = 2 * CH + 8;  // bf16 stride of the [n][k] tile (36 words)
constexpr int THREADS = 256;

struct Args {
  const void* x;
  const int8_t* packed;
  const float* scales;
  float* out;  // [M, N], or the [splits, M, N] workspace
  int M, N, K, G, splits, vec;
};

// element offset of k-pair p (weight rows 2p, 2p+1 of the chunk) of column
// n in the [n][k] tile: the pair index is XOR-swizzled by the column's
// group of 8, so that both the unpacking stores (16 columns x 2 pairs per
// warp) and the mma fragment reads (8 columns x 4 pairs) hit 32 distinct
// banks
__device__ __forceinline__ int wt_off(int n, int p) {
  return n * LDW + 2 * (p ^ ((n >> 3) << 1));
}

__device__ __forceinline__ int lo4(int p) { return ((p & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int hi4(int p) { return p >> 4; }  // p: sign-extended byte

// The dequantized weights of byte p (sign-extended) under group scale s,
// before the rounding to x's dtype.  v2's s is already in x's dtype.
template <bool V2>
__device__ __forceinline__ float w_lo(int p, float s) {
  if (V2) return __fmul_rn(static_cast<float>((p & 0xF) ^ 8) - 8.0f, s);
  return __fmul_rn(static_cast<float>(lo4(p)), s);
}
template <bool V2>
__device__ __forceinline__ float w_hi(int p, float s) {
  if (V2)
    return __fmul_rn(static_cast<float>(p) - static_cast<float>(p & 0xF),
                     __fmul_rn(s, 0.0625f));
  return __fmul_rn(static_cast<float>(hi4(p)), s);
}

// groups [g0, g1) of split s
__device__ __forceinline__ void split_range(const Args& a, int s, int& g0,
                                            int& g1) {
  const int ng = a.K / a.G;
  g0 = (int)((long long)s * ng / a.splits);
  g1 = (int)((long long)(s + 1) * ng / a.splits);
}

// 8 bytes of packed row `r`, columns [n, n + 8), zeros past N
__device__ __forceinline__ uint2 load8(const Args& a, int r, int n) {
  const int8_t* p = a.packed + (size_t)r * a.N + n;
  if (a.vec && n + 8 <= a.N) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n + j < a.N)
      w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j)))
                  << (8 * (j % 4));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ int byte_of(uint2 v, int j) {
  const uint32_t w = j < 4 ? v.x : v.y;
  return static_cast<int>(static_cast<int8_t>((w >> (8 * (j % 4))) & 0xFFu));
}

// ---------------------------------------------------------------- bf16
// WM: warps along M, 1 (16-row blocks) or 4 (64-row blocks)
template <int WM, bool V2>
__global__ void __launch_bounds__(THREADS) w4_bf16(Args a) {
  constexpr int WN = 8 / WM;          // warps along N
  constexpr int NT = BN / WN / 8;     // n-tiles of 8 per warp
  __shared__ __align__(16) __nv_bfloat16 wt[BN * LDW];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 16 * WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int half = a.G / 2;
  int g0, g1;
  split_range(a, blockIdx.z, g0, g1);
  const int cpg = half / CH;                 // chunks per group
  const int c_end = (g1 - g0) * cpg;

  // loader role: packed rows 2*rp, 2*rp+1 of the chunk, columns cc..cc+7
  const int rp = threadIdx.x / 16, cc = (threadIdx.x % 16) * 8;
  auto packed_row = [&](int c) {
    const int grp = g0 + c / cpg;
    return grp * half + (c % cpg) * CH + 2 * rp;
  };

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int ra = m0 + wm * 16 + g, rb = ra + 8;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  uint2 p0 = make_uint2(0, 0), p1 = p0;
  if (c_end > 0) {
    p0 = load8(a, packed_row(0), n0 + cc);
    p1 = load8(a, packed_row(0) + 1, n0 + cc);
  }
  float sc[8];
  int sc_group = -1;
  for (int c = 0; c < c_end; ++c) {
    const int grp = g0 + c / cpg;
    if (grp != sc_group) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = n0 + cc + j < a.N ? __ldg(a.scales + (size_t)grp * a.N + n0 + cc + j) : 0.f;
        if (V2) sc[j] = __bfloat162float(__float2bfloat16_rn(sc[j]));
      }
      sc_group = grp;
    }
    // unpack, scale in float32, round to bf16, store as [n][k] pairs
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b0 = byte_of(p0, j), b1 = byte_of(p1, j);
      *reinterpret_cast<uint32_t*>(wt + wt_off(cc + j, rp)) =
          ak::pack_f32_bf16(w_lo<V2>(b0, sc[j]), w_lo<V2>(b1, sc[j]));
      *reinterpret_cast<uint32_t*>(wt + wt_off(cc + j, CH / 2 + rp)) =
          ak::pack_f32_bf16(w_hi<V2>(b0, sc[j]), w_hi<V2>(b1, sc[j]));
    }
    __syncthreads();
    if (c + 1 < c_end) {  // next chunk's bytes in flight during the mma
      p0 = load8(a, packed_row(c + 1), n0 + cc);
      p1 = load8(a, packed_row(c + 1) + 1, n0 + cc);
    }
    // k-steps 0, 1: weight rows grp*G + (c % cpg)*CH + [0, 32) (low
    // nibbles); k-steps 2, 3: the same + G/2 (high nibbles)
    const int klo = grp * a.G + (c % cpg) * CH;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int kx = (ks < 2 ? klo + ks * 16 : klo + half + (ks - 2) * 16) + 2 * t;
      uint32_t af[4];
      const uint32_t* xa = reinterpret_cast<const uint32_t*>(x + (size_t)ra * a.K + kx);
      const uint32_t* xb = reinterpret_cast<const uint32_t*>(x + (size_t)rb * a.K + kx);
      af[0] = ra < a.M ? xa[0] : 0u;
      af[1] = rb < a.M ? xb[0] : 0u;
      af[2] = ra < a.M ? xa[4] : 0u;
      af[3] = rb < a.M ? xb[4] : 0u;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (wn * NT + nt) * 8 + g;
        ak::mma_bf16(acc[nt], af,
                     *reinterpret_cast<const uint32_t*>(wt + wt_off(n, ks * 8 + t)),
                     *reinterpret_cast<const uint32_t*>(wt + wt_off(n, ks * 8 + 4 + t)));
      }
    }
    __syncthreads();
  }

  float* out = a.out + (size_t)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + (wn * NT + nt) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? rb : ra;
      if (row >= a.M) continue;
      if (col < a.N) out[(size_t)row * a.N + col] = acc[nt][2 * h];
      if (col + 1 < a.N) out[(size_t)row * a.N + col + 1] = acc[nt][2 * h + 1];
    }
  }
}

// ---------------------------------------------------------------- float32
constexpr int FM = 8, FTHREADS = 128;

template <bool V2>
__global__ void __launch_bounds__(FTHREADS) w4_f32(Args a) {
  __shared__ float xs[FM][2 * CH];  // x columns of this chunk: low, high rows
  const int n = blockIdx.x * FTHREADS + threadIdx.x;
  const int m0 = blockIdx.y * FM;
  const int half = a.G / 2;
  int g0, g1;
  split_range(a, blockIdx.z, g0, g1);
  const float* x = static_cast<const float*>(a.x);

  float acc[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) acc[i] = 0.f;
  for (int grp = g0; grp < g1; ++grp) {
    const float s = n < a.N ? __ldg(a.scales + (size_t)grp * a.N + n) : 0.f;
    for (int c = 0; c < half; c += CH) {
      for (int i = threadIdx.x; i < FM * 2 * CH; i += FTHREADS) {
        const int m = i / (2 * CH), kl = i % (2 * CH);
        const int k = grp * a.G + c + (kl < CH ? kl : half + kl - CH);
        xs[m][kl] = m0 + m < a.M ? x[(size_t)(m0 + m) * a.K + k] : 0.f;
      }
      __syncthreads();
      if (n < a.N) {
        for (int r = 0; r < CH; ++r) {
          const int p = a.packed[(size_t)(grp * half + c + r) * a.N + n];
          const float wl = w_lo<V2>(p, s);
          const float wh = w_hi<V2>(p, s);
#pragma unroll
          for (int m = 0; m < FM; ++m)
            acc[m] = fmaf(xs[m][CH + r], wh, fmaf(xs[m][r], wl, acc[m]));
        }
      }
      __syncthreads();
    }
  }
  if (n < a.N) {
    float* out = a.out + (size_t)blockIdx.z * a.M * a.N;
    for (int m = 0; m < FM && m0 + m < a.M; ++m) out[(size_t)(m0 + m) * a.N + n] = acc[m];
  }
}

// out[m, n] = sum over s of ws[s, m, n], s in order
__global__ void sum_splits(const float* ws, float* out, int splits, size_t mn) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
    out[i] = v;
  }
}

template <bool V2>
void launch(const Args& a, int bf16, cudaStream_t st) {
  if (bf16) {
    if (a.M <= 16) {
      dim3 grid((a.N + BN - 1) / BN, (a.M + 15) / 16, a.splits);
      w4_bf16<1, V2><<<grid, THREADS, 0, st>>>(a);
    } else {
      dim3 grid((a.N + BN - 1) / BN, (a.M + 63) / 64, a.splits);
      w4_bf16<4, V2><<<grid, THREADS, 0, st>>>(a);
    }
  } else {
    dim3 grid((a.N + FTHREADS - 1) / FTHREADS, (a.M + FM - 1) / FM, a.splits);
    w4_f32<V2><<<grid, FTHREADS, 0, st>>>(a);
  }
}

}  // namespace

// Splits of K the launch will use (the caller sizes the workspace from it).
extern "C" int ak_matmul_w4_splits(int M, int N, int K, int G, int bf16) {
  const int bm = bf16 ? (M <= 16 ? 16 : 64) : FM;
  const int bn = bf16 ? BN : FTHREADS;
  const long long blocks = (long long)((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int ng = K / G;
  long long s = (2 * 132 + blocks - 1) / blocks;
  return (int)(s < 1 ? 1 : (s > ng ? ng : s));
}

// v2: 0 for variant v1, 1 for variant v2.
extern "C" int ak_matmul_w4(const void* x, const void* packed, const void* scales,
                            void* out, void* workspace, int bf16, int v2, int M,
                            int N, int K, int G, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || G <= 0 || K % G != 0 || (G / 2) % CH != 0 || splits < 1 ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{x, static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
         static_cast<float*>(splits > 1 ? workspace : out), M, N, K, G, splits,
         (N % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0) ? 1 : 0};
  if (v2)
    launch<true>(a, bf16, st);
  else
    launch<false>(a, bf16, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  sum_splits<<<blocks, 256, 0, st>>>(static_cast<const float*>(workspace),
                                     static_cast<float*>(out), splits, mn);
  return cudaGetLastError();
}
