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
// bf16 x, M > 16 (w4_wgmma, the bucket admissions: M = 8 x the bucket):
// bounded by operations there (2 M N K over 989 TFLOP/s: 0.139 ms at M
// 4096, K 2048, N 8192), so its design is wgmma's.  Operands swapped as in
// w4_small: out^T = W^T x^T, with the dequantized weights wgmma's A
// operand from registers (m64: 64 output columns a tile) and x its B
// operand from shared memory (n128: 128 rows of x), k16 a step.
//   * A block owns 256 columns x 128 rows of x.  Each of its two
//     warpgroups owns 128 columns (two m64n128 accumulators, 128 float32
//     registers a thread); both read the same x tiles.  A weight is
//     dequantized once per 128 rows of x, in registers, never stored.
//   * A ring of WSTAGES slots in dynamic shared memory, WSTAGES - 2 chunks
//     ahead of the MMA, filled by TMA (one thread issues a chunk's boxes;
//     a full mbarrier a slot counts their bytes, an empty one the warps
//     that are done with it).  A chunk is 64 k: two x tiles of 128 rows x
//     32 k in the 64-byte swizzle that wgmma's descriptor reads (the low-
//     nibble k and, G/2 on, the high-nibble k), 32 packed rows x 256
//     columns of raw bytes in the 128-byte swizzle, and the group's 256
//     scales.  TMA zero-fills rows past M and columns past N (zero bytes
//     and zero scales dequantize to 0).  Where N or a pointer is not 16-
//     byte aligned, which TMA needs, every thread copies the weights and
//     scales byte by byte instead, with a block barrier a chunk.
//   * One ldmatrix.x4.trans a 16-column strip gives a lane its bytes of
//     the whole chunk: packed rows 2t and 2t + 1 of each 8-row group at
//     columns 2g and 2g + 1, which are the A fragment's rows g and g + 8
//     (so no byte moves between lanes).  k step p (0, 1) takes the low
//     nibbles of packed rows 16p .. 16p + 15 against x tile 0, k step 2 + p
//     their high nibbles against x tile 1.  The dequant is w4_small's
//     (deq2, or v1's float32 product for float32 scales).
//   * One wgmma group a chunk (8 wgmmas), waited for only before the next
//     chunk's dequant writes the fragment registers again: ptxas
//     serializes every wgmma when a wgmma's input registers are written
//     while a group is in flight (C7513), so the overlap comes from the
//     two warpgroups taking turns (named barriers): one's group runs on
//     the tensor cores while the other dequantizes.
//   * Each thread stores its accumulators straight to out as float2s
//     (every 32-byte sector whole; staging through shared memory measured
//     slower).  A grid that would leave over half the SMs idle splits K
//     over a cluster of up to 8 blocks, whose partial tiles are summed in
//     rank order through distributed shared memory: deterministic, no
//     workspace, no atomics.
//
// float32 x (w4_f32): fp32 FMA (no TF32), one thread per column and 8 rows
// per block; it writes float32 partials per split to a workspace that
// sum_splits adds in a fixed order.
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
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "int8_igemm.cuh"  // swz, desc_sw128: the 128-byte swizzle wgmma reads

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

// ------------------------------------------------- bf16, M > 16 (wgmma)
constexpr int WBN = 256;      // output columns a block: 2 warpgroups x 2 m64 tiles
constexpr int WBM = 128;      // rows of x a block: the wgmma's n
constexpr int WTHREADS = 256;
constexpr int WSTAGES = 6;    // ring slots, WSTAGES - 2 chunks ahead
constexpr int WXT = WBM * 64;             // an x tile: 128 rows x 32 bf16 (64-byte swizzle)
constexpr int WWT = SCH * 128;            // a weight half: 32 packed rows x 128 columns
constexpr int WSLOT = 2 * WXT + 2 * WWT + WBN * 4;  // + the group's scales: 25,600
constexpr int WLDC = WBN + 4;             // float stride of the output tile
constexpr int WRING = WSTAGES * WSLOT;
constexpr int WSMEM = WRING + 1024 + 16 * WSTAGES;  // + alignment slack, the mbarriers
static_assert(WSLOT % 1024 == 0 && WXT % 1024 == 0 && WWT % 1024 == 0,
              "every tile 1 KB aligned, as the swizzles");
static_assert(WBM * WLDC * 4 <= WRING, "the output tile fits the ring");

// byte offset of 16-byte piece h (0..15) of packed row r in a chunk's
// weights: two 128-column halves, each [32][128] in the 128-byte swizzle
// (TMA's SWIZZLE_128B), so the 8 rows of an ldmatrix phase hit distinct
// banks
__device__ __forceinline__ int wswz(int r, int h) {
  return (h >> 3) * WWT + r * 128 + 16 * ((h & 7) ^ (r & 7));
}

// wgmma shared-memory descriptor of a K-major tile in the 64-byte swizzle:
// 8-row groups 512 bytes apart (SBO), layout type 2 (SWIZZLE_64B)
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// wgmma m64n128k16, float32 += bf16 x bf16, A from registers (a warp's 16
// rows in the mma.sync m16n8k16 A-fragment order), B K-major from a
// shared-memory descriptor
#define AK_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : AK_F8(0), AK_F8(8), AK_F8(16), AK_F8(24), AK_F8(32), AK_F8(40), AK_F8(48), AK_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef AK_F8

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarrier and TMA helpers (shared-memory addresses as 32-bit ints)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// the box at (c0, c1) of a 2-D tensor map into shared memory at dst; its
// bytes complete on bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap& map, int c0,
                                       int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// The A fragment of the k step over packed rows 16p .. 16p + 15, their low
// (sh 0) or high (sh 4) nibbles, from va, vb, a lane's ldmatrix words of
// rows 16p .. 16p + 7 and 16p + 8 .. 16p + 15: byte 0 / 2 = rows 2t / 2t + 1
// at column 2g (fragment row g), byte 1 / 3 the same at column 2g + 1 (row
// g + 8).  s0, s1 (h0, h1 in bf16x2) scale the two columns.
template <bool FAST>
__device__ __forceinline__ void deq_frag(uint32_t (&f)[4], uint32_t va, uint32_t vb,
                                         int sh, float s0, float s1,
                                         __nv_bfloat162 h0, __nv_bfloat162 h1) {
  if (FAST) {
    f[0] = deq2(va >> sh, h0);
    f[1] = deq2(va >> (sh + 8), h1);
    f[2] = deq2(vb >> sh, h0);
    f[3] = deq2(vb >> (sh + 8), h1);
  } else {
    f[0] = rn2(nib(va, sh) * s0, nib(va, sh + 16) * s0);
    f[1] = rn2(nib(va, sh + 8) * s1, nib(va, sh + 24) * s1);
    f[2] = rn2(nib(vb, sh) * s0, nib(vb, sh + 16) * s0);
    f[3] = rn2(nib(vb, sh + 8) * s1, nib(vb, sh + 24) * s1);
  }
}

// FAST as for w4_small.  The grid is (column tiles, row tiles, splits), one
// cluster of `splits` blocks per output tile.  tx: x [M, K] bf16, boxes of
// 128 rows x 32 k; tw: packed [K/2, N] bytes, boxes of 32 rows x 128
// columns; ts: scales [K/G, N], boxes of one row x 256 columns (tw and ts
// only when a.vec).
template <bool FAST>
__global__ void __launch_bounds__(WTHREADS, 1)
    w4_wgmma(const Args a, const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap ts) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the ring, 1 KB aligned (the swizzles act on address bits), offset from
  // the array so that its accesses stay shared-memory ones; then two
  // mbarriers a slot: full (its TMA bytes have landed) and empty (every
  // warp is done with it: its wgmma group waited for, its weights read)
  uint8_t* ring = smem + ((1024 - (static_cast<uint32_t>(
                                       __cvta_generic_to_shared(smem)) & 1023)) & 1023);
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t full = ring_addr + WRING, empty = full + 8 * WSTAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * WBN, m0 = blockIdx.y * WBM;
  const int splits = gridDim.z;
  const int half = a.G / 2, cpg = half / SCH;
  const int nchunks = a.K / (2 * SCH);
  const int c0 = (int)((long long)blockIdx.z * nchunks / splits);
  const int nc = (int)((long long)(blockIdx.z + 1) * nchunks / splits) - c0;
  const int sbytes = a.sbf16 ? 2 : 4;
  // bytes a slot's mbarrier waits for: the two x tiles, and with a.vec the
  // weights and the scales
  const uint32_t tx_bytes = 2 * WXT + (a.vec ? 2 * WWT + WBN * sbytes : 0);

  if (tid == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's chunk c0 + j into slot j % WSTAGES: [x low k][x high k]
  // [weights, two halves][scales].  Thread 0 issues the TMA copies once
  // the slot's last chunk is released; without a.vec (N or a pointer not
  // 16-byte aligned) every thread copies the weights and scales byte by
  // byte, and a block barrier a chunk keeps the warps in step.
  const int wp = tid & 15, wr = tid >> 4;  // byte-by-byte roles
  auto issue = [&](int j) {
    const int slot = j % WSTAGES;
    const uint32_t st = ring_addr + slot * WSLOT;
    const int c = c0 + j, grp = c / cpg, cc = c - grp * cpg;
    const int klo = grp * a.G + cc * SCH;    // the chunk's first low-nibble k
    const int prow = grp * half + cc * SCH;  // its first packed row
    if (tid == 0) {
      if (j >= WSTAGES) mbar_wait(empty + 8 * slot, (j / WSTAGES - 1) & 1);
      const uint32_t bar = full + 8 * slot;
      mbar_expect_tx(bar, tx_bytes);
      tma_2d(st, tx, klo, m0, bar);
      tma_2d(st + WXT, tx, klo + half, m0, bar);
      if (a.vec) {
        tma_2d(st + 2 * WXT, tw, n0, prow, bar);
        tma_2d(st + 2 * WXT + WWT, tw, n0 + 128, prow, bar);
        tma_2d(st + 2 * WXT + 2 * WWT, ts, n0, grp, bar);
      }
    }
    if (!a.vec) {
      uint8_t* sw = ring + slot * WSLOT + 2 * WXT;
      uint8_t* ss = sw + 2 * WWT;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + 16 * i, n = n0 + 16 * wp;
        const int8_t* src = a.packed + (size_t)(prow + r) * a.N + n;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (n + k < a.N)
            w[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + k)))
                        << (8 * (k % 4));
        *reinterpret_cast<uint4*>(sw + wswz(r, wp)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
      static_assert(WBN == WTHREADS, "one scale a thread");
      const bool ok = n0 + tid < a.N;
      const size_t i = (size_t)grp * a.N + n0 + tid;
      if (a.sbf16)
        reinterpret_cast<uint16_t*>(ss)[tid] =
            ok ? __ldg(static_cast<const uint16_t*>(a.scales) + i) : 0;
      else
        reinterpret_cast<float*>(ss)[tid] =
            ok ? __ldg(static_cast<const float*>(a.scales) + i) : 0.f;
    }
  };

  // zeroed before any wgmma is in flight, then written by wgmma alone
  float acc[2][64];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[u][i] = 0.f;
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  for (int s = 0; s < WSTAGES - 2 && s < nc; ++s) issue(s);
  // this warp's 16-column strip of tile 0 (tile 1: 4 strips on), and the
  // column of this lane's fragment row g (row g + 8: the next column)
  const int strip = 8 * (warp >> 2) + (warp & 3);
  const int col = 16 * strip + 2 * g;
  for (int j = 0; j < nc; ++j) {
    // chunk j has landed (without a.vec: after the barrier, every thread's
    // copies too, and every warp is done with chunk j - 2, whose slot the
    // copies below refill)
    mbar_wait(full + 8 * (j % WSTAGES), (j / WSTAGES) & 1);
    if (!a.vec) __syncthreads();
    const uint8_t* sw = ring + (j % WSTAGES) * WSLOT + 2 * WXT;
    const uint8_t* ss = sw + 2 * WWT;
    uint32_t wv[2][4];  // [tile][8 packed rows]
    ak::ldsm4t(wv[0], sw + wswz(lane, strip));
    ak::ldsm4t(wv[1], sw + wswz(lane, strip + 4));
    float s[2][2];
    __nv_bfloat162 h[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = col + 64 * u;
      if (a.sbf16) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(ss + 2 * c);
        s[u][0] = __uint_as_float(v << 16);
        s[u][1] = __uint_as_float(v & 0xFFFF0000u);
      } else {
        const float2 v = *reinterpret_cast<const float2*>(ss + 4 * c);
        s[u][0] = v.x;
        s[u][1] = v.y;
      }
      h[u][0] = __float2bfloat162_rn(s[u][0]);  // exact for bf16 scales; v2's rounding
      h[u][1] = __float2bfloat162_rn(s[u][1]);
    }
    const uint32_t xaddr = ring_addr + (j % WSTAGES) * WSLOT;
    // the previous chunk's wgmma group ran over the barrier and the loads
    // above; it must be done before the fragment registers are written
    // again (ptxas serializes every wgmma otherwise, C7513)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(wv[u][i])::"memory");
    if (j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % WSTAGES));
    // k step 2q + p: the low (q 0) or high (q 1) nibbles of packed rows
    // 16p .. 16p + 15, against x tile q at k 16p
    uint32_t af[4][2][4];  // [k step][tile][fragment]
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        deq_frag<FAST>(af[ks][u], wv[u][2 * (ks & 1)], wv[u][2 * (ks & 1) + 1],
                       4 * (ks >> 1), s[u][0], s[u][1], h[u][0], h[u][1]);
    // the warpgroups take turns at the tensor cores: warpgroup 0 issues
    // chunk j's group once warpgroup 1 has issued chunk j - 1's, and 1
    // once 0 has issued chunk j's, so that one's group runs alone while
    // the other dequantizes (named barriers 1 and 2: one side arrives, the
    // other waits)
    if ((warp >> 2) == 0 && j > 0)
      asm volatile("bar.sync 1, %0;\n" ::"n"(WTHREADS) : "memory");
    if ((warp >> 2) == 1)
      asm volatile("bar.sync 2, %0;\n" ::"n"(WTHREADS) : "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = desc_sw64(xaddr + (ks >> 1) * WXT + 32 * (ks & 1));
      wgmma_bf16_n128(acc[0], af[ks][0], db);
      wgmma_bf16_n128(acc[1], af[ks][1], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if ((warp >> 2) == 0)
      asm volatile("bar.arrive 2, %0;\n" ::"n"(WTHREADS) : "memory");
    if ((warp >> 2) == 1 && j + 1 < nc)
      asm volatile("bar.arrive 1, %0;\n" ::"n"(WTHREADS) : "memory");
    if (j + WSTAGES - 2 < nc) issue(j + WSTAGES - 2);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  // acc[u][4 nb + 2 h + e]: fragment row 16 (warp % 4) + g + 8 h, that is
  // column col + 64 u + h, and x row 8 nb + 2 t + e.  Without a split the
  // lanes store their column pairs as they are: each 32-byte sector is
  // written whole by one instruction
  if (splits == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * nb + 2 * t + e, n = n0 + col + 64 * u;
          if (m < a.M && n < a.N) {
            float* o = a.out + (size_t)m * a.N + n;
            if (a.vec) {
              *reinterpret_cast<float2*>(o) = make_float2(acc[u][4 * nb + e], acc[u][4 * nb + 2 + e]);
            } else {
              o[0] = acc[u][4 * nb + e];
              if (n + 1 < a.N) o[1] = acc[u][4 * nb + 2 + e];
            }
          }
        }
    return;
  }
  // split K: the partial tile goes through shared memory (the ring, free
  // now), and each block of the cluster stores a slice of the tile's rows,
  // summed over the splits in rank order
  __syncthreads();
  float* tile = reinterpret_cast<float*>(ring);  // [WBM][WLDC]
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(tile + (8 * nb + 2 * t + e) * WLDC + col + 64 * u) =
            make_float2(acc[u][4 * nb + e], acc[u][4 * nb + 2 + e]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * WBM / splits, r1 = (rank + 1) * WBM / splits;
  constexpr int QPR = WBN / 4;  // float4s a row
  for (int q = tid; q < (r1 - r0) * QPR; q += WTHREADS) {
    const int r = r0 + q / QPR, cq = 4 * (q % QPR);
    const int m = m0 + r, n = n0 + cq;
    if (m >= a.M || n >= a.N) continue;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k)  // all loads in flight at once
      if (k < splits)
        v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, k) +
                                                r * WLDC + cq);
    float4 sum = v[0];
#pragma unroll
    for (int k = 1; k < MAX_SPLITS; ++k)
      if (k < splits) {
        sum.x += v[k].x; sum.y += v[k].y; sum.z += v[k].z; sum.w += v[k].w;
      }
    float* o = a.out + (size_t)m * a.N + n;
    if (a.vec) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
      const float w[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n + k < a.N) o[k] = w[k];
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// ---------------------------------------------------------------- float32
constexpr int FM = 8, FTHREADS = 128;

template <bool V2>
__global__ void __launch_bounds__(FTHREADS) w4_f32(Args a) {
  __shared__ float xs[FM][2 * SCH];  // x columns of this chunk: low, high rows
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
    for (int c = 0; c < half; c += SCH) {
      for (int i = threadIdx.x; i < FM * 2 * SCH; i += FTHREADS) {
        const int m = i / (2 * SCH), kl = i % (2 * SCH);
        const int k = grp * a.G + c + (kl < SCH ? kl : half + kl - SCH);
        xs[m][kl] = m0 + m < a.M ? x[(size_t)(m0 + m) * a.K + k] : 0.f;
      }
      __syncthreads();
      if (n < a.N) {
        for (int r = 0; r < SCH; ++r) {
          const int p = a.packed[(size_t)(grp * half + c + r) * a.N + n];
          const float wl = w_lo<V2>(p, s);
          const float wh = w_hi<V2>(p, s);
#pragma unroll
          for (int m = 0; m < FM; ++m)
            acc[m] = fmaf(xs[m][SCH + r], wh, fmaf(xs[m][r], wl, acc[m]));
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

// Splits of K for w4_wgmma: none while the grid fills half the SMs or
// more; else enough blocks for about one an SM, at most one cluster's
// worth and one 64-deep chunk a split.
int wgmma_splits(int M, int N, int K) {
  const long long blocks =
      (long long)((N + WBN - 1) / WBN) * ((M + WBM - 1) / WBM);
  const int sms = ak::sm_count();
  if (2 * blocks > sms) return 1;
  long long s = sms / blocks;
  s = s > MAX_SPLITS ? MAX_SPLITS : s;
  s = s > K / (2 * SCH) ? K / (2 * SCH) : s;
  return s < 1 ? 1 : (int)s;
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tensor map of rows x cols elements (row stride `pitch` bytes) in
// boxes of box_rows x box_cols, out-of-range elements read as zero.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                size_t cols, size_t rows, size_t pitch, int box_cols, int box_rows,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool FAST>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  const int s = wgmma_splits(a.M, a.N, a.K);
  CUtensorMap tx, tw, ts;
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, (size_t)a.K * 2,
                  32, WBM, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  tw = tx;  // unread without a.vec
  ts = tx;
  if (a.vec &&
      (!tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.packed, a.N, a.K / 2, a.N, 128,
                   SCH, CU_TENSOR_MAP_SWIZZLE_128B) ||
       !tensor_map(&ts,
                   a.sbf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   a.scales, a.N, a.K / a.G, (size_t)a.N * (a.sbf16 ? 2 : 4), WBN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  cudaError_t e = ak::allow_smem<w4_wgmma<FAST>>(WSMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + WBN - 1) / WBN, (a.M + WBM - 1) / WBM, s);
  cfg.blockDim = dim3(WTHREADS);
  cfg.dynamicSmemBytes = WSMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, w4_wgmma<FAST>, a, tx, tw, ts);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The routes, as ak_matmul_w4_route names them.
enum Route { ROUTE_SMALL = 0, ROUTE_WGMMA = 1, ROUTE_F32 = 2, ROUTE_ROWS = 3 };

int route_of(int M, int G, int bf16) {
  if (G % 64 != 0) return ROUTE_ROWS;
  if (!bf16) return ROUTE_F32;
  return M <= 16 ? ROUTE_SMALL : ROUTE_WGMMA;
}

template <bool V2>
cudaError_t launch(const Args& a, int bf16, int route, cudaStream_t st) {
  // v2's scale is rounded to bf16 before its product, so bf16x2
  // arithmetic is exact for it as for bf16 scales
  const bool fast = V2 || a.sbf16;
  if (route == ROUTE_SMALL) {
    if (a.M <= 8)
      return fast ? launch_small<1, true>(a, st) : launch_small<1, false>(a, st);
    return fast ? launch_small<2, true>(a, st) : launch_small<2, false>(a, st);
  }
  if (route == ROUTE_WGMMA)
    return fast ? launch_wgmma<true>(a, st) : launch_wgmma<false>(a, st);
  if (route == ROUTE_ROWS) {
    dim3 grid((a.N + RTHREADS - 1) / RTHREADS, (a.M + RM - 1) / RM, a.splits);
    if (bf16)
      w4_rows<V2, true><<<grid, RTHREADS, 0, st>>>(a);
    else
      w4_rows<V2, false><<<grid, RTHREADS, 0, st>>>(a);
  } else {
    dim3 grid((a.N + FTHREADS - 1) / FTHREADS, (a.M + FM - 1) / FM, a.splits);
    w4_f32<V2><<<grid, FTHREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// The route a launch takes: 0 w4_small (bf16 x, M <= 16), 1 w4_wgmma (bf16
// x, M > 16), 2 w4_f32 (float32 x), 3 w4_rows (G not a multiple of 64).
// dtypes as for ak_matmul_w4; N and K do not choose a route.
extern "C" int ak_matmul_w4_route(int M, int N, int K, int G, int dtypes) {
  (void)N;
  (void)K;
  return route_of(M, G, dtypes & 1);
}

// Splits of K into the workspace the launch will use (the caller sizes the
// workspace from it): 1 for bf16 x with a group that is a multiple of 64,
// whose splits are summed in a cluster's shared memory.  dtypes: bit 0 set
// for bf16 x.
extern "C" int ak_matmul_w4_splits(int M, int N, int K, int G, int dtypes) {
  const int route = route_of(M, G, dtypes & 1);
  if (route == ROUTE_ROWS) {  // splits of whole 32-row chunks
    const long long blocks =
        (long long)((N + RTHREADS - 1) / RTHREADS) * ((M + RM - 1) / RM);
    const int chunks = (K / 2 + RCH - 1) / RCH;
    long long s = (8 * 132 + blocks - 1) / blocks;  // 8 blocks an SM
    return (int)(s < 1 ? 1 : (s > chunks ? chunks : s));
  }
  if (route != ROUTE_F32) return 1;
  const long long blocks =
      (long long)((N + FTHREADS - 1) / FTHREADS) * ((M + FM - 1) / FM);
  const int ng = K / G;
  long long s = (2 * 132 + blocks - 1) / blocks;
  return (int)(s < 1 ? 1 : (s > ng ? ng : s));
}

// Splits of K the launch takes, however they are summed: in a cluster's
// shared memory (w4_small, w4_wgmma) or through the workspace.
extern "C" int ak_matmul_w4_kernel_splits(int M, int N, int K, int G, int dtypes) {
  const int route = route_of(M, G, dtypes & 1);
  if (route == ROUTE_SMALL) return small_splits(N, K, G);
  if (route == ROUTE_WGMMA) return wgmma_splits(M, N, K);
  return ak_matmul_w4_splits(M, N, K, G, dtypes);
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
  const int route = route_of(M, G, bf16);
  if ((route == ROUTE_SMALL || route == ROUTE_WGMMA) && splits != 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(packed) |
                          reinterpret_cast<uintptr_t>(scales) |
                          reinterpret_cast<uintptr_t>(out);
  // w4_small and w4_wgmma copy 16-byte pieces of a row and store float4s
  const int vec = N % 16 == 0 && align % 16 == 0;
  Args a{x, static_cast<const int8_t*>(packed), scales,
         static_cast<float*>(splits > 1 ? workspace : out), M, N, K, G, splits,
         vec ? 1 : 0, sbf16};
  cudaError_t err =
      v2 ? launch<true>(a, bf16, route, st) : launch<false>(a, bf16, route, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  sum_splits<<<blocks, 256, 0, st>>>(static_cast<const float*>(workspace),
                                     static_cast<float*>(out), splits, mn);
  return cudaGetLastError();
}
