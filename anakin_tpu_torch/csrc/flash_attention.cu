// flash_attention: forward attention with an online softmax that never
// writes the [Sq, Sk] score matrix to device memory, with causal and
// segment masks and grouped-query heads.
//
//   s   = (q . k) * sm_scale, masked to -0.7 * FLT_MAX where col > row
//         (causal) or q_seg[row] != kv_seg[col]
//   out = softmax(s) @ v, in q's dtype; a row whose running sum stays 0
//         gives 0
//
// q [B, H, Sq, D], k and v [B, Hkv, Sk, D] with H a multiple of Hkv (query
// head h reads kv head h / (H / Hkv), so the grouped heads are never copied
// H / Hkv times), segment ids [B, Sq] and [B, Sk] int32 or null, all
// contiguous; bf16 or float32.
//
// Replaces the TPU kernel anakin_tpu/kernels/flash_attention.py::
// flash_attention, whose grid walks (batch * head, q tile, kv tile) with the
// kv axis sequential and the running max, sum and accumulator in VMEM.
// Here one block owns one (batch * head, q tile) and loops over the kv tiles
// itself, keeping the running max, sum and output accumulator in
// registers; a causal block stops at the diagonal tile.  A ragged Sq or Sk
// is masked in the kernel (columns past Sk weigh exactly 0), so nothing is
// padded.
//
// What bounds it on an H100: the function reads q, k, v once and writes
// out once, and does 4 * D operations per unmasked (row, col) pair.  At the
// LLM prefill's [8, 16, 512, 128] with 8 kv heads that is about 50 MB and
// 8.6 G operations: bytes (15 us at 3.35 TB/s) bound it over the bf16
// tensor-core rate (8.7 us).  At S = 2048 the operations bound it.
//
// bf16 (flash_bf16): 4 warps, 64 query rows, kv tiles of 64 keys in shared
// memory.  Each warp keeps its 16 rows of q as mma.sync A fragments.
// S = q k^T is mma.sync m16n8k16 with float32 accumulation: the bf16
// products are exact, so S equals the Pallas kernel's float32 dot up to
// the order of the sums.  P @ V: P is float32 in the C fragments; it goes
// into the A operand as two bf16 halves, hi = bf16(P) and lo = bf16(P - hi),
// with two mma each, so P keeps about 16 bits (relative error <= 2^-17)
// against the 8 of a single bf16 rounding.  The output's relative error
// stays far below its own bf16 rounding (2^-9): stated tolerance against
// the plain version, |diff| <= 2^-7 |want| + 3e-5 max|v|, one bf16 ulp.
//
// float32 (flash_f32): fp32 FMA (no TF32), 4 threads per query row, 32 rows
// and kv tiles of 16 keys per block, p staged in shared memory.  Stated
// tolerance: |diff| <= 3e-5 max|v| (float32 sums in another order).
//
// This first version loads its tiles with plain 16-byte loads and no
// pipelining; cp.async / TMA double-buffering and wgmma are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

// the Pallas kernel's _MASK_VALUE: -0.7 * float32 max formed in double
constexpr float kMask = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;  // [B, Sq] or null
  const int* kseg;  // [B, Sk] or null
  void* out;
  int H, Hkv, Sq, Sk, causal;
  float sm_scale;
};

// number of kv tiles a block of query rows [q0, q0 + rows) has to visit
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int rows,
                                        int bk) {
  int n = (a.Sk + bk - 1) / bk;
  if (a.causal) {
    int last = min(q0 + rows, a.Sq) - 1;  // columns <= last row only
    n = min(n, last / bk + 1);
  }
  return n;
}

// score -> masked score: -inf past Sk (weight exactly 0), the Pallas mask
// value where causal or segment masking removes the pair
__device__ __forceinline__ float mask_score(const Args& a, float s, int row,
                                            int col, int qs, const int* kseg_s,
                                            int col_in_tile) {
  if (col >= a.Sk) return -INFINITY;
  if (a.causal && col > row) return kMask;
  if (a.qseg != nullptr && qs != kseg_s[col_in_tile]) return kMask;
  return s;
}

// ---------------------------------------------------------------- bf16
constexpr int BQ = 64, BK = 64, WARPS = 4;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
    flash_bf16(Args a) {
  constexpr int LD = D + 8;  // bf16 row stride: conflict-free fragment reads
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];
  __shared__ int kseg_s[BK];

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           (size_t)bh * a.Sq * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            ((size_t)b * a.Hkv + hk) * a.Sk * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            ((size_t)b * a.Hkv + hk) * a.Sk * D;

  // this thread's two query rows
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  int qs0 = 0, qs1 = 0;
  if (a.qseg != nullptr) {
    if (r0 < a.Sq) qs0 = a.qseg[(size_t)b * a.Sq + r0];
    if (r1 < a.Sq) qs1 = a.qseg[(size_t)b * a.Sq + r1];
  }

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(q + (size_t)r0 * D + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(q + (size_t)r1 * D + c);
    qa[kk][0] = r0 < a.Sq ? p0[0] : 0u;
    qa[kk][1] = r1 < a.Sq ? p1[0] : 0u;
    qa[kk][2] = r0 < a.Sq ? p0[4] : 0u;
    qa[kk][3] = r1 < a.Sq ? p1[4] : 0u;
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = kv_tiles(a, q0, BQ, BK);
  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * BK;
    // K and V tiles: 16-byte chunks, rows past Sk zero-filled
    for (int c = threadIdx.x; c < BK * D / 8; c += WARPS * 32) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (key0 + r < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(kg + (size_t)(key0 + r) * D + cc);
        vv = *reinterpret_cast<const uint4*>(vg + (size_t)(key0 + r) * D + cc);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + cc) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + cc) = vv;
    }
    if (a.kseg != nullptr && threadIdx.x < BK)
      kseg_s[threadIdx.x] = key0 + threadIdx.x < a.Sk
                                ? a.kseg[(size_t)b * a.Sk + key0 + threadIdx.x]
                                : 0;
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        ak::mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    // scale, mask, running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cit = nt * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        s[nt][e] = mask_score(a, s[nt][e] * a.sm_scale, hi ? r1 : r0,
                              key0 + cit, hi ? qs1 : qs0, kseg_s, cit);
        if (hi) mx1 = fmaxf(mx1, s[nt][e]); else mx0 = fmaxf(mx0, s[nt][e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;

    // acc = acc * alpha + P @ V, P split into bf16 hi + lo; the products
    // accumulate straight into the rescaled acc (registers are the limit)
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a[0]: row g, n-tile 2kk; a[1]: row g+8, n-tile 2kk;
        // a[2]: row g, n-tile 2kk+1; a[3]: row g+8, n-tile 2kk+1
        const float p0 = s[2 * kk + (i >> 1)][(i & 1) ? 2 : 0];
        const float p1 = s[2 * kk + (i >> 1)][(i & 1) ? 3 : 1];
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
        ph[i] = ak::pack_bf16(h0, h1);
        pl[i] = ak::pack_f32_bf16(p0 - __bfloat162float(h0),
                                  p1 - __bfloat162float(h1));
      }
      const __nv_bfloat16* v0 = vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = v0 + dt * 8;
        const uint32_t b0 = ak::pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = ak::pack_bf16(vp[8 * LD], vp[9 * LD]);
        ak::mma_bf16(o[dt], ph, b0, b1);
        ak::mma_bf16(o[dt], pl, b0, b1);
      }
    }
    __syncthreads();  // the tiles are overwritten next
  }

  const float li0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float li1 = l1 == 0.f ? 1.f : 1.f / l1;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + (size_t)bh * a.Sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * D + c) =
          ak::pack_f32_bf16(o[dt][0] * li0, o[dt][1] * li0);
    if (r1 < a.Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)r1 * D + c) =
          ak::pack_f32_bf16(o[dt][2] * li1, o[dt][3] * li1);
  }
}

// ---------------------------------------------------------------- float32
constexpr int FQ = 32, FK = 16, FTHREADS = 128;  // 4 threads per query row

template <int D>
__global__ void __launch_bounds__(FTHREADS) flash_f32(Args a) {
  __shared__ float qs_[FQ * (D + 1)];
  __shared__ float ks[FK * (D + 1)];
  __shared__ float vs[FK * D];
  __shared__ float ps[FQ * (FK + 1)];
  __shared__ int kseg_s[FK];

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * FQ;
  const int rl = threadIdx.x / 4, t = threadIdx.x % 4, row = q0 + rl;
  const float* q = static_cast<const float*>(a.q) + (size_t)bh * a.Sq * D;
  const float* kg = static_cast<const float*>(a.k) +
                    ((size_t)b * a.Hkv + hk) * a.Sk * D;
  const float* vg = static_cast<const float*>(a.v) +
                    ((size_t)b * a.Hkv + hk) * a.Sk * D;

  for (int i = threadIdx.x; i < FQ * D; i += FTHREADS) {
    const int r = i / D, c = i % D;
    qs_[r * (D + 1) + c] = q0 + r < a.Sq ? q[(size_t)(q0 + r) * D + c] : 0.f;
  }
  const int qsg = (a.qseg != nullptr && row < a.Sq) ? a.qseg[(size_t)b * a.Sq + row] : 0;

  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_tiles = kv_tiles(a, q0, FQ, FK);
  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * FK;
    for (int i = threadIdx.x; i < FK * D; i += FTHREADS) {
      const int r = i / D, c = i % D;
      const bool in = key0 + r < a.Sk;
      ks[r * (D + 1) + c] = in ? kg[(size_t)(key0 + r) * D + c] : 0.f;
      vs[r * D + c] = in ? vg[(size_t)(key0 + r) * D + c] : 0.f;
    }
    if (a.kseg != nullptr && threadIdx.x < FK)
      kseg_s[threadIdx.x] = key0 + threadIdx.x < a.Sk
                                ? a.kseg[(size_t)b * a.Sk + key0 + threadIdx.x]
                                : 0;
    __syncthreads();

    // this thread's keys: t, t + 4, t + 8, t + 12 of the tile
    float s[FK / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < FK / 4; ++i) {
      const int cit = t + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        dot = fmaf(qs_[rl * (D + 1) + d], ks[cit * (D + 1) + d], dot);
      s[i] = mask_score(a, dot * a.sm_scale, row, key0 + cit, qsg, kseg_s, cit);
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float al = expf(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < FK / 4; ++i) {
      s[i] = expf(s[i] - mn);
      sum += s[i];
      ps[rl * (FK + 1) + t + 4 * i] = s[i];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = al * l + sum;
    __syncwarp();  // a row's four threads share one warp
    // this thread's output dims: t, t + 4, ...
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int kk = 0; kk < FK; ++kk)
        pv = fmaf(ps[rl * (FK + 1) + kk], vs[kk * D + t + 4 * i], pv);
      acc[i] = acc[i] * al + pv;
    }
    __syncthreads();
  }

  if (row < a.Sq) {
    const float li = l == 0.f ? 1.f : 1.f / l;
    float* out = static_cast<float*>(a.out) + ((size_t)bh * a.Sq + row) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) out[t + 4 * i] = acc[i] * li;
  }
}

template <int D>
cudaError_t launch(const Args& a, int BH, int bf16, cudaStream_t stream) {
  if (bf16) {
    dim3 grid(BH, (a.Sq + BQ - 1) / BQ);
    flash_bf16<D><<<grid, WARPS * 32, 0, stream>>>(a);
  } else {
    dim3 grid(BH, (a.Sq + FQ - 1) / FQ);
    flash_f32<D><<<grid, FTHREADS, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int ak_flash_attention(const void* q, const void* k, const void* v,
                                  const void* qseg, const void* kseg, void* out,
                                  int bf16, int B, int H, int Hkv, int Sq,
                                  int Sk, int D, int causal, float sm_scale,
                                  void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk == 0 || Hkv == 0 || H % Hkv != 0 || (qseg == nullptr) != (kseg == nullptr))
    return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(qseg), static_cast<const int*>(kseg),
         out, H, Hkv, Sq, Sk, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B * H, bf16, s);
    case 64: return launch<64>(a, B * H, bf16, s);
    case 128: return launch<128>(a, B * H, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
