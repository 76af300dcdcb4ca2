// matmul_w4: x [M, K] (bf16 or float32) times int4 weights with group-wise
// scales (float32 or bf16), out [M, N] float32.
//
//   W[k, n] = cast_to_x_dtype(float(int4[k, n]) * scales[k / G, n])
//   out     = x @ W, summed in float32
//
// Packing (quant.quantize._w4_group_quantize): packed [K/2, N] int8; in
// each group of G rows, packed row r holds row r in its low nibble and row
// r + G/2 in its high nibble.  The low nibble sign-extends as
// ((p & 0xF) ^ 8) - 8, the high one is the arithmetic p >> 4.  bf16 scales
// are widened to float32 in registers, which is exact, so a net that hands
// over bf16 scales needs no cast.
//
// Replaces the TPU kernel anakin_tpu/kernels/matmul_w4.py::matmul_w4,
// variant v1, which unpacks a [TK/2, TN] block of bytes in VMEM with int32
// shifts and a concat and feeds the MXU.
//
// What bounds it on an H100: at the decode shapes (bf16 x, M = 8) bytes:
// K/2 * N packed bytes plus the scales, about 2.7 us per MLP projection and
// 10.7 us for the 32000-wide head at 3.35 TB/s; the 2*M*N*K operations are
// negligible.  Such a call moves only 8-32 MB, 60-240 KB per SM, so its
// time is set by how soon every SM has its bytes in flight, how wide the
// rows it reads are, how little the dequant costs per weight, and the fixed
// costs around them: staging x, and summing the splits of K.
//
// bf16 x, M <= 16 (w4_small, the decode path): operands swapped, so that
// the weights are mma.sync m16n8k16's 16-row A operand (16 output columns)
// and x^T the n8 B operand (8 rows of x; two n8 tiles for M <= 16).
//   * A block owns 128 columns and 4 warps; warp w takes chunks w, w + 4,
//     ... of the block's K range (a chunk is 32 packed rows x 128 columns
//     of raw bytes, the group's 128 scales and the chunk's 64 k of x) into
//     a private cp.async ring of STAGES chunks, STAGES - 1 ahead.  Rows are
//     read 128 bytes wide, chunks need no block barrier (only __syncwarp),
//     and x needs no staging pass: each chunk brings its own.
//   * A lane reads its A fragments as two 32-bit shared loads per k-step
//     and strip of 32 columns: packed rows 2t and 2t + 1 at columns
//     4g..4g+3.  The mma's k order is permuted to match (k-index 2t, 2t+1
//     are the low nibbles of those rows, 2t+8, 2t+9 their high nibbles), so
//     its B fragment is two adjacent bf16 of x at the low-nibble k and two
//     at the high-nibble k; the column order too (column 4g + j is row g or
//     g + 8 of m-tile j / 2), so no byte moves between lanes.  The 16-byte
//     pieces of a row are XOR-swizzled by the row, so all of it hits 32
//     distinct banks.
//   * Dequant, for bf16 scales and for v2 (the decode path): two weights
//     at a time in bf16x2 arithmetic: PRMT puts the bytes of the two rows
//     in the two halves, (u ^ 8) | 0x4300 is the bf16 128 + (u ^ 8), one
//     HSUB2 of 136 gives the signed nibbles exactly and one HMUL2 by the
//     scale rounds each product once, which is exact before the rounding
//     (a 4-bit times an 8-bit significand), so it equals unpack_w4 /
//     unpack_w4_v2 bit for bit.  v1 with float32 scales: the nibble becomes
//     float32 by exponent bias, ((u ^ 8) | 0x4B000000) - (2^23 + 8), times
//     the scale in float32 (rounded, as unpack_w4 forms it), then two
//     weights round to bf16 in one cvt.rn.bf16x2.f32.
//   * Split K without a workspace: the warps' partials are summed in
//     shared memory in warp order, and the S splits of one column tile are
//     one thread-block cluster: after a cluster barrier each block sums a
//     slice of the tile over the S partials in rank order, through
//     distributed shared memory.  Deterministic, no atomics, no second
//     launch.  S is sized for about two blocks per SM (at most 8, the
//     portable cluster size).
//
// bf16 x, M > 16 (w4_bf16): 64-row blocks (4 x 2 warps); a block unpacks 32
// packed rows x 128 columns at a time into a swizzled bf16 [n][k] tile in
// shared memory, so each unpacked tile serves 64 rows of x.  float32 x
// (w4_f32): fp32 FMA (no TF32), one thread per column and 8 rows per block.
// These two write float32 partials per split to a workspace that sum_splits
// adds in a fixed order.
//
// Groups that are not a multiple of 64 (w4_rows): the quantizer writes any
// even G that divides K (G = 32, or G = K = 96), and then a 32-row chunk of
// packed rows can straddle groups.  This route indexes the group, and so
// the scale row and the low / high k of x, per packed row: one thread per
// column and 8 rows of x per block, x staged in shared memory per chunk in
// float32, each weight dequantized as unpack_w4 / unpack_w4_v2 forms it
// (rounded to x's dtype), fp32 FMA, K split over blocks through the
// workspace.  A simple route, not a fast one; the groups the models use
// (multiples of 64) keep the routes above.
//
// Against the plain version every route differs only by the order of the
// float32 sums.
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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  const void* x;
  const int8_t* packed;
  const void* scales;  // [K/G, N] float32, or bf16 when sbf16
  float* out;          // [M, N], or the [splits, M, N] workspace
  int M, N, K, G, splits, vec, sbf16;
};

// scale of group grp, column n, widened to float32
__device__ __forceinline__ float load_scale(const Args& a, int grp, int n) {
  const size_t i = (size_t)grp * a.N + n;
  if (a.sbf16)
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.scales) + i));
  return __ldg(static_cast<const float*>(a.scales) + i);
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

// groups [g0, g1) of split s of `splits`
__device__ __forceinline__ void split_range(const Args& a, int s, int splits,
                                            int& g0, int& g1) {
  const int ng = a.K / a.G;
  g0 = (int)((long long)s * ng / splits);
  g1 = (int)((long long)(s + 1) * ng / splits);
}

// ------------------------------------------------- bf16, M <= 16 (decode)
constexpr int SWARPS = 4;         // warps per block, each a slice of K
constexpr int SBN = 128;          // columns per block: 4 strips of 32 per warp
constexpr int SCH = 32;           // packed rows per chunk
constexpr int STAGES = 3;         // chunks per warp ring
constexpr int MAX_SPLITS = 8;     // portable cluster size
constexpr int CHUNK = SCH * SBN;  // weight bytes of a chunk
constexpr int XROW = 2 * SCH * 2 + 16;  // x bytes of a chunk and row: 64 k, padded
constexpr float kBias = 8388616.0f;  // 2^23 + 8

// bytes of one ring slot of w4_small<MT>: the chunk's weights, its group's
// scales (float32 or bf16) and its 2 x 32 k of x for 8 MT rows
__host__ __device__ constexpr int slot_bytes(int mt) { return CHUNK + SBN * 4 + 8 * mt * XROW; }
// shared bytes of w4_small<MT>; the partial sums reuse the ring
__host__ __device__ constexpr int small_smem(int mt) { return SWARPS * STAGES * slot_bytes(mt); }
static_assert(SWARPS * 8 * 2 * SBN * 4 <= SWARPS * STAGES * CHUNK, "partials fit the ring");

// byte offset of the 16-byte piece h of chunk row r: the piece index is
// XOR-swizzled by the row, so that the fragment reads of rows 2t and 2t + 1
// (t = 0..3) at 8 lanes' columns hit 32 distinct banks
__device__ __forceinline__ int piece_off(int r, int h) {
  return r * SBN + 16 * (h ^ (2 * ((r >> 1) & 3)));
}

// nibble at bit `shift` of w -> its signed value in float32
__device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - kBias;
}

__device__ __forceinline__ uint32_t rn2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&v);
}

// nibbles at bits 0-3 and 16-19 of v -> bf16x2 of their signed values
// times s2: (u ^ 8) | 0x4300 is the bf16 128 + (u ^ 8), minus 136 exactly,
// then one rounded bf16 product
__device__ __forceinline__ uint32_t deq2(uint32_t v, __nv_bfloat162 s2) {
  uint32_t u = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t k136 = 0x43084308u;
  const __nv_bfloat162 q = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&u),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  __nv_bfloat162 w = __hmul2(q, s2);
  return *reinterpret_cast<uint32_t*>(&w);
}

// MT n8 tiles of x rows (M <= 8 * MT).  FAST: the dequant in bf16x2
// arithmetic, exact for bf16 scales and for v2 (whose scale is rounded to
// bf16 first): q * s has at most 12 significant bits, so the bf16 product
// rounds it once, as the float32 product rounded to bf16 does.  Otherwise
// (v1 with float32 scales) the float32 product, rounded to float32 and
// then to bf16, as unpack_w4 forms it.
//
// A block owns 128 columns; its SWARPS warps take the chunks kw, kw +
// SWARPS, ... of the block's K range, each over all 128 columns (4 strips
// of 32).  The grid is (column tiles, 1, splits), one cluster of `splits`
// blocks per column tile.
template <int MT, bool FAST>
__global__ void __launch_bounds__(SWARPS * 32) w4_small(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem);  // [warp][8MT][128], after the loop
  constexpr int SLOT = slot_bytes(MT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * SBN;
  const int splits = gridDim.z;
  const int half = a.G / 2, cpg = half / SCH;
  int g0, g1;
  split_range(a, blockIdx.z, splits, g0, g1);
  const int nc = (g1 - g0) * cpg;
  const int ni = warp < nc ? (nc - warp + SWARPS - 1) / SWARPS : 0;  // this warp's chunks
  const int sbytes = a.sbf16 ? 2 : 4;
  uint8_t* wring = smem + warp * STAGES * SLOT;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  // this warp's i-th chunk (block chunk warp + i SWARPS) into slot i % STAGES:
  // [32 rows x 128 columns of bytes][128 scales][8MT rows x (32 + 32) k of x]
  auto issue = [&](int i) {
    if (i < ni) {
      const int c = warp + i * SWARPS;
      const int grp = g0 + c / cpg;
      const int prow = grp * half + (c % cpg) * SCH;
      uint8_t* dst = wring + (i % STAGES) * SLOT;
      uint8_t* sdst = dst + CHUNK;
      uint8_t* xdst = sdst + SBN * 4;
      if (a.vec) {
#pragma unroll
        for (int k = 0; k < CHUNK / 16 / 32; ++k) {  // 4 rows of 128 bytes a round
          const int p = lane + 32 * k, r = p / 8, h = p % 8;
          const bool ok = n0 + 16 * h < a.N;
          ak::cp16(dst + piece_off(r, h),
               ok ? a.packed + (size_t)(prow + r) * a.N + n0 + 16 * h : a.packed, ok);
        }
        if (lane * 16 < SBN * sbytes) {
          const int cs = n0 + lane * 16 / sbytes;  // first column of the piece
          const bool ok = cs < a.N;
          ak::cp16(sdst + lane * 16,
               ok ? static_cast<const uint8_t*>(a.scales) +
                        ((size_t)grp * a.N + cs) * sbytes
                  : a.scales, ok);
        }
      } else {  // N or a pointer not 16-byte aligned: byte by byte
        const int8_t* src = a.packed + (size_t)(prow + lane) * a.N + n0;
        for (int h = 0; h < SBN / 16; ++h) {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (n0 + 16 * h + j < a.N)
              w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + 16 * h + j)))
                          << (8 * (j % 4));
          *reinterpret_cast<uint4*>(dst + piece_off(lane, h)) = make_uint4(w[0], w[1], w[2], w[3]);
        }
        for (int n = lane; n < SBN; n += 32) {
          if (a.sbf16) {
            const uint16_t* s = static_cast<const uint16_t*>(a.scales);
            reinterpret_cast<uint16_t*>(sdst)[n] =
                n0 + n < a.N ? __ldg(s + (size_t)grp * a.N + n0 + n) : 0;
          } else {
            reinterpret_cast<float*>(sdst)[n] =
                n0 + n < a.N ? __ldg(static_cast<const float*>(a.scales) +
                                     (size_t)grp * a.N + n0 + n) : 0.f;
          }
        }
      }
      // x rows 0 .. 8MT - 1 at the chunk's low-nibble k and high-nibble k,
      // 4 pieces of 8 k each; rows past M zero
      const int klo = grp * a.G + (c % cpg) * SCH;
#pragma unroll
      for (int k = 0; k < MT * 2; ++k) {
        const int p = lane + 32 * k, m = p / 8, hi = (p / 4) % 2, q = p % 4;
        const bool ok = m < a.M;
        ak::cp16(xdst + m * XROW + 64 * hi + 16 * q,
             ok ? x + (size_t)m * a.K + klo + (hi ? half : 0) + 8 * q : a.x, ok);
      }
    }
    ak::cp_commit();  // an empty group past the end keeps the count uniform
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  float acc[4][2][MT][4];  // [strip][m-tile][n8 tile][C fragment]
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        acc[u][ii][mt][0] = acc[u][ii][mt][1] = acc[u][ii][mt][2] = acc[u][ii][mt][3] = 0.f;

  for (int i = 0; i < ni; ++i) {
    ak::cp_wait<STAGES - 2>();
    __syncwarp();  // chunk i is in for every lane; chunk i - 1 was read
    issue(i + STAGES - 1);
    const uint8_t* w = wring + (i % STAGES) * SLOT;
    const uint8_t* sp = w + CHUNK;
    const uint8_t* xp = sp + SBN * 4;
    // B fragments: x^T at k-index 2t, 2t + 1 = packed rows 8ks + 2t, + 1:
    // their low-nibble k (b0) and high-nibble k (b1), adjacent in x
    uint32_t xb[4][MT][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          xb[ks][mt][hi] = *reinterpret_cast<const uint32_t*>(
              xp + (8 * mt + g) * XROW + 64 * hi + 2 * (8 * ks + 2 * t));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // the group's scales of columns 32u + 4g .. 32u + 4g + 3
      float s[4];
      if (a.sbf16) {
        const uint2 v = *reinterpret_cast<const uint2*>(sp + 2 * (32 * u + 4 * g));
        s[0] = __uint_as_float(v.x << 16);
        s[1] = __uint_as_float(v.x & 0xFFFF0000u);
        s[2] = __uint_as_float(v.y << 16);
        s[3] = __uint_as_float(v.y & 0xFFFF0000u);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(sp + 4 * (32 * u + 4 * g));
        s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
      }
      __nv_bfloat162 s2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s2[j] = __float2bfloat162_rn(s[j]);  // exact for bf16
      const int hp = 2 * u + g / 4;  // the 16-byte piece of columns 32u + 4g..
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int ra = 8 * ks + 2 * t;
        const uint32_t wa = *reinterpret_cast<const uint32_t*>(w + piece_off(ra, hp) + 4 * (g % 4));
        const uint32_t wb = *reinterpret_cast<const uint32_t*>(w + piece_off(ra + 1, hp) + 4 * (g % 4));
        const uint32_t wa4 = wa >> 4, wb4 = wb >> 4;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          uint32_t af[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // columns 32u + 4g + 2ii + h: rows g, g + 8
            const int j = 2 * ii + h;
            if (FAST) {
              // byte j of row 2t in the low half, of row 2t + 1 in the high
              const uint32_t sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12);
              af[h] = deq2(__byte_perm(wa, wb, sel), s2[j]);
              af[2 + h] = deq2(__byte_perm(wa4, wb4, sel), s2[j]);
            } else {
              const int sh = 8 * j;
              af[h] = rn2(nib(wa, sh) * s[j], nib(wb, sh) * s[j]);
              af[2 + h] = rn2(nib(wa, sh + 4) * s[j], nib(wb, sh + 4) * s[j]);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ak::mma_bf16(acc[u][ii][mt], af, xb[ks][mt][0], xb[ks][mt][1]);
        }
      }
    }
  }
  ak::cp_wait<0>();
  __syncthreads();  // the ring is free for the partials

  // acc[u][ii][mt]: C rows g, g + 8 are columns 32u + 4g + 2ii, +1; C
  // columns 2t, 2t + 1 are x rows 8 mt + 2t, 8 mt + 2t + 1
  const int rows = min(a.M, 8 * MT);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(part + (warp * 8 * MT + 8 * mt + 2 * t + e) * SBN +
                                   32 * u + 4 * g) =
            make_float4(acc[u][0][mt][e], acc[u][0][mt][2 + e], acc[u][1][mt][e],
                        acc[u][1][mt][2 + e]);
  // the tile is summed over the warps in order, into warp 0's slot, then
  // over the cluster's blocks in rank order: each block writes a slice
  __syncthreads();
  const int quads = rows * SBN / 4;
  for (int q = threadIdx.x; q < quads; q += SWARPS * 32) {
    const int m = 4 * q / SBN, cq = 4 * q % SBN;
    float4 sum = *reinterpret_cast<const float4*>(part + m * SBN + cq);
    for (int k = 1; k < SWARPS; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(part + (k * 8 * MT + m) * SBN + cq);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    *reinterpret_cast<float4*>(part + m * SBN + cq) = sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rank = splits > 1 ? (int)cluster.block_rank() : 0;
  const int q0 = rank * quads / splits, q1 = (rank + 1) * quads / splits;
  for (int q = q0 + threadIdx.x; q < q1; q += SWARPS * 32) {
    const int m = 4 * q / SBN, cq = 4 * q % SBN;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)  // all loads in flight at once
      if (r < splits)
        v[r] = *reinterpret_cast<const float4*>(
            (splits > 1 ? cluster.map_shared_rank(part, r) : part) + m * SBN + cq);
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r)
      if (r < splits) {
        sum.x += v[r].x; sum.y += v[r].y; sum.z += v[r].z; sum.w += v[r].w;
      }
    const int n = n0 + cq;
    float* o = a.out + (size_t)m * a.N + n;
    if (a.vec && n < a.N) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
      const float w[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n + k < a.N) o[k] = w[k];
    }
  }
  if (splits > 1) cluster.sync();  // no block leaves while another reads its partial
}

// ------------------------------------------------------- bf16, M > 16
constexpr int BN = 128;          // columns per block
constexpr int CH = 32;           // packed rows per chunk (64 weight rows)
constexpr int LDW = 2 * CH + 8;  // bf16 stride of the [n][k] tile (36 words)
constexpr int THREADS = 256;
constexpr int WM = 4, WN = 2;    // warps along M (16 rows each) and N
constexpr int NT = BN / WN / 8;  // n-tiles of 8 per warp

// element offset of k-pair p (weight rows 2p, 2p+1 of the chunk) of column
// n in the [n][k] tile: the pair index is XOR-swizzled by the column's
// group of 8, so that both the unpacking stores (16 columns x 2 pairs per
// warp) and the mma fragment reads (8 columns x 4 pairs) hit 32 distinct
// banks
__device__ __forceinline__ int wt_off(int n, int p) {
  return n * LDW + 2 * (p ^ ((n >> 3) << 1));
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

template <bool V2>
__global__ void __launch_bounds__(THREADS) w4_bf16(Args a) {
  __shared__ __align__(16) __nv_bfloat16 wt[BN * LDW];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 16 * WM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int half = a.G / 2;
  int g0, g1;
  split_range(a, blockIdx.z, a.splits, g0, g1);
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
        sc[j] = n0 + cc + j < a.N ? load_scale(a, grp, n0 + cc + j) : 0.f;
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
  split_range(a, blockIdx.z, a.splits, g0, g1);
  const float* x = static_cast<const float*>(a.x);

  float acc[FM];
#pragma unroll
  for (int i = 0; i < FM; ++i) acc[i] = 0.f;
  for (int grp = g0; grp < g1; ++grp) {
    const float s = n < a.N ? load_scale(a, grp, n) : 0.f;
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

// ------------------------------------------- any even G (G % 64 != 0)
constexpr int RM = 8, RTHREADS = 128, RCH = 32;  // x rows, columns, packed rows a chunk

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// packed rows [r0, r1) of split s of `splits`
__device__ __forceinline__ void row_range(int k2, int s, int splits, int& r0, int& r1) {
  r0 = (int)((long long)s * k2 / splits);
  r1 = (int)((long long)(s + 1) * k2 / splits);
}

template <bool V2, bool XBF16>
__global__ void __launch_bounds__(RTHREADS) w4_rows(Args a) {
  __shared__ float xs[RM][2 * RCH];  // x at the chunk's low-nibble k, then high
  const int n = blockIdx.x * RTHREADS + threadIdx.x;
  const int m0 = blockIdx.y * RM;
  const int half = a.G / 2;
  int r0, r1;
  row_range(a.K / 2, blockIdx.z, a.splits, r0, r1);

  float acc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) acc[i] = 0.f;
  for (int c0 = r0; c0 < r1; c0 += RCH) {
    for (int i = threadIdx.x; i < RM * 2 * RCH; i += RTHREADS) {
      const int m = i / (2 * RCH), j = i % (2 * RCH), pr = c0 + j % RCH;
      float v = 0.f;
      if (m0 + m < a.M && pr < r1) {
        const int grp = pr / half;
        const size_t k = (size_t)grp * a.G + (pr - grp * half) + (j >= RCH ? half : 0);
        const size_t xi = (size_t)(m0 + m) * a.K + k;
        v = XBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[xi])
                  : static_cast<const float*>(a.x)[xi];
      }
      xs[m][j] = v;
    }
    __syncthreads();
    if (n < a.N) {
      const int rows = min(RCH, r1 - c0);
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const int pr = c0 + j;
        float sc = load_scale(a, pr / half, n);
        if (V2 && XBF16) sc = round_bf16(sc);  // v2 scales in x's dtype
        const int p = a.packed[(size_t)pr * a.N + n];
        float wl = w_lo<V2>(p, sc), wh = w_hi<V2>(p, sc);
        if (XBF16) {
          wl = round_bf16(wl);
          wh = round_bf16(wh);
        }
#pragma unroll
        for (int m = 0; m < RM; ++m)
          acc[m] = fmaf(xs[m][RCH + j], wh, fmaf(xs[m][j], wl, acc[m]));
      }
    }
    __syncthreads();
  }
  if (n < a.N) {
    float* out = a.out + (size_t)blockIdx.z * a.M * a.N;
    for (int m = 0; m < RM && m0 + m < a.M; ++m) out[(size_t)(m0 + m) * a.N + n] = acc[m];
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

// Splits of K for w4_small: about two blocks per SM, whole groups, at most
// one cluster's worth.
int small_splits(int N, int K, int G) {
  const int tiles = (N + SBN - 1) / SBN, ng = K / G;
  int s = (2 * ak::sm_count() + tiles / 2) / tiles;
  s = s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
  return s > ng ? ng : s;
}

template <int MT, bool FAST>
cudaError_t launch_small(const Args& a, cudaStream_t st) {
  const int s = small_splits(a.N, a.K, a.G);
  const cudaError_t e = ak::allow_smem<w4_small<MT, FAST>>(small_smem(MT));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + SBN - 1) / SBN, 1, s);
  cfg.blockDim = dim3(SWARPS * 32);
  cfg.dynamicSmemBytes = small_smem(MT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w4_small<MT, FAST>, a);
}

template <bool V2>
cudaError_t launch(const Args& a, int bf16, cudaStream_t st) {
  if (a.G % 64 != 0) {
    dim3 grid((a.N + RTHREADS - 1) / RTHREADS, (a.M + RM - 1) / RM, a.splits);
    if (bf16)
      w4_rows<V2, true><<<grid, RTHREADS, 0, st>>>(a);
    else
      w4_rows<V2, false><<<grid, RTHREADS, 0, st>>>(a);
    return cudaGetLastError();
  }
  // v2's scale is rounded to bf16 before its product, so bf16x2
  // arithmetic is exact for it as for bf16 scales
  const bool fast = V2 || a.sbf16;
  if (bf16 && a.M <= 8)
    return fast ? launch_small<1, true>(a, st) : launch_small<1, false>(a, st);
  if (bf16 && a.M <= 16)
    return fast ? launch_small<2, true>(a, st) : launch_small<2, false>(a, st);
  if (bf16) {
    dim3 grid((a.N + BN - 1) / BN, (a.M + 16 * WM - 1) / (16 * WM), a.splits);
    w4_bf16<V2><<<grid, THREADS, 0, st>>>(a);
  } else {
    dim3 grid((a.N + FTHREADS - 1) / FTHREADS, (a.M + FM - 1) / FM, a.splits);
    w4_f32<V2><<<grid, FTHREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Splits of K into the workspace the launch will use (the caller sizes the
// workspace from it): 1 for bf16 x with M <= 16, whose splits are summed in
// a cluster's shared memory.  dtypes: bit 0 set for bf16 x.
extern "C" int ak_matmul_w4_splits(int M, int N, int K, int G, int dtypes) {
  const int bf16 = dtypes & 1;
  if (G % 64 != 0) {  // w4_rows: splits of whole 32-row chunks
    const long long blocks =
        (long long)((N + RTHREADS - 1) / RTHREADS) * ((M + RM - 1) / RM);
    const int chunks = (K / 2 + RCH - 1) / RCH;
    long long s = (8 * 132 + blocks - 1) / blocks;  // 8 blocks an SM
    return (int)(s < 1 ? 1 : (s > chunks ? chunks : s));
  }
  if (bf16 && M <= 16) return 1;
  const int bm = bf16 ? 16 * WM : FM;
  const int bn = bf16 ? BN : FTHREADS;
  const long long blocks = (long long)((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  const int ng = K / G;
  long long s = (2 * 132 + blocks - 1) / blocks;
  return (int)(s < 1 ? 1 : (s > ng ? ng : s));
}

// dtypes: bit 0 set for bf16 x (else float32), bit 1 for bf16 scales (else
// float32).  v2: 0 for variant v1, 1 for variant v2.
extern "C" int ak_matmul_w4(const void* x, const void* packed, const void* scales,
                            void* out, void* workspace, int dtypes, int v2, int M,
                            int N, int K, int G, int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || G <= 0 || G % 2 != 0 || K % G != 0 || splits < 1 ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const int bf16 = dtypes & 1, sbf16 = (dtypes >> 1) & 1;
  const bool small = bf16 && M <= 16 && G % 64 == 0;
  if (small && splits != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(packed) |
                          reinterpret_cast<uintptr_t>(scales) |
                          reinterpret_cast<uintptr_t>(out);
  // w4_small copies 16-byte pieces of a row and stores float4s; the others
  // load 8 bytes at a time
  const int vec = small ? (N % 16 == 0 && align % 16 == 0)
                        : (N % 8 == 0 && reinterpret_cast<uintptr_t>(packed) % 8 == 0);
  Args a{x, static_cast<const int8_t*>(packed), scales,
         static_cast<float*>(splits > 1 ? workspace : out), M, N, K, G, splits,
         vec ? 1 : 0, sbf16};
  cudaError_t err = v2 ? launch<true>(a, bf16, st) : launch<false>(a, bf16, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  sum_splits<<<blocks, 256, 0, st>>>(static_cast<const float*>(workspace),
                                     static_cast<float*>(out), splits, mn);
  return cudaGetLastError();
}
