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
// What bounds it on an H100: at the decode shapes (M = 8) bytes: K/2 * N
// packed bytes plus the scales, about 2.7 us per MLP projection and 10.7 us
// for the 32000-wide head at 3.35 TB/s; the 2*M*N*K operations are
// negligible.  Such a call moves only 8-32 MB, 60-240 KB per SM, so its
// time is set by how soon every SM has its bytes in flight, how wide the
// rows it reads are, how little the dequant costs per weight, and the fixed
// costs around them: staging x, and summing the splits of K.
//
// Chunks.  Every route but w4_rows walks K in chunks of 32 packed rows,
// each two half-chunks of 16.  Where G % 32 == 0 a half-chunk lies in one
// group: it has one scale row, and its x is two runs of 16 k, at the low-
// nibble k of its rows and, G/2 on, at their high-nibble k (half_chunk).
// Where G % 64 == 0 both halves of a chunk share the group and the runs
// join into two of 32 k; where G is 32, 96, ... a chunk can straddle two
// groups at its half-chunk boundary, and the routes take a scale row and
// the x runs per half-chunk.  The last chunk's second half lies past K when
// K / 2 is an odd number of 16 rows; its weights read as zero.
//
// bf16 x, M <= 16 (w4_small, the decode path): operands swapped, so that
// the weights are mma.sync m16n8k16's 16-row A operand (16 output columns)
// and x^T the n8 B operand (8 rows of x; two n8 tiles for M <= 16).
//   * A block owns 128 columns and 4 warps; warp w takes chunks w, w + 4,
//     ... of the block's K range (a chunk's 32 packed rows x 128 columns of
//     raw bytes, its one or two scale rows and its 64 k of x, the two low
//     runs and then the two high runs) into a private cp.async ring of
//     STAGES chunks, STAGES - 1 ahead.  Rows are read 128 bytes wide,
//     chunks need no block barrier (only __syncwarp), and x needs no
//     staging pass: each chunk brings its own.
//   * A lane reads its A fragments as two 32-bit shared loads per k-step
//     and strip of 32 columns: packed rows 2t and 2t + 1 at columns
//     4g..4g+3.  The mma's k order is permuted to match (k-index 2t, 2t+1
//     are the low nibbles of those rows, 2t+8, 2t+9 their high nibbles), so
//     its B fragment is two adjacent bf16 of x at the low-nibble k and two
//     at the high-nibble k; the column order too (column 4g + j is row g or
//     g + 8 of m-tile j / 2), so no byte moves between lanes.  A k-step
//     takes 8 packed rows, so it never leaves a half-chunk.  The 16-byte
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
//     portable cluster size), in whole chunks.
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
//     that are done with it).  A chunk's x is 128 rows x 64 k: where G %
//     64 == 0 two tiles of 32 k in the 64-byte swizzle that wgmma's
//     descriptor reads (the low-nibble k and, G/2 on, the high-nibble k),
//     else four runs of 16 k in the 32-byte swizzle (each half-chunk's low
//     and high run); then 32 packed rows x 256 columns of raw bytes in the
//     128-byte swizzle, and the scale rows of 256 columns.  TMA zero-fills
//     rows past M and columns past N (zero bytes and zero scales dequantize
//     to 0).  Where N or a pointer is not 16-byte aligned, which TMA needs,
//     every thread copies the weights and scales byte by byte instead, with
//     a block barrier a chunk.
//   * One ldmatrix.x4.trans a 16-column strip gives a lane its bytes of
//     the whole chunk: packed rows 2t and 2t + 1 of each 8-row group at
//     columns 2g and 2g + 1, which are the A fragment's rows g and g + 8
//     (so no byte moves between lanes).  k step p (0, 1) takes the low
//     nibbles of packed rows 16p .. 16p + 15, half-chunk p, against its low
//     run of x, k step 2 + p their high nibbles against its high run.  The
//     dequant is w4_small's (deq2, or v1's float32 product for float32
//     scales), with half-chunk p's scales.
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
// float32 x (w4_small<TF>, M <= 16; w4_wgmma_tf32, M > 16): the frames
// above on the TF32 tensor cores, kept float32 by a split of x.  The
// signed nibble is an integer in [-8, 7], exact in TF32, so it is the A
// operand itself: no per-weight product and no split of the weight.  x =
// hi + lo (split_tf32: hi is x rounded to TF32, lo the rest, read
// truncated to TF32 by the MMA), two TF32 products a k step (q x_hi + q
// x_lo), summed over a half-chunk (one group) into a float32 accumulator
// acc_g, then acc += s[g, n] * acc_g in float32.
//   * M <= 16: mma.sync m16n8k8 in w4_small's block, ring and split of K;
//     x staged as float32 (rows twice as wide), each lane splitting its B
//     fragments as it reads them.  A lane reads one 32-bit word per k step
//     and strip: packed row 4s + t at columns 4g..4g+3, whose low nibbles
//     are k t and high nibbles k t + 4 of the two m-tiles; the pieces of a
//     row are swizzled by row & 3 for this read.
//   * M > 16: wgmma m64n64k8 .tf32 with the nibbles as A from registers and
//     x as B from shared memory (TF32 wgmma needs B K-major: x's rows).
//     A block owns 256 columns x 64 rows of x, so that each warpgroup
//     keeps acc and acc_g (2 x 32 registers each); the ring holds a
//     chunk's four x runs (64 rows x 16 floats, 64-byte swizzle, one TMA
//     box each), their lo parts, the weights and two scale rows.  When a
//     chunk has landed, every thread splits a share of its x in place (hi)
//     and into the lo buffer, then a proxy fence and a block barrier hand
//     it to both warpgroups.  The ldmatrix row order is permuted (lane 8i
//     + j reads packed row 8i + j / 2 + 4 (j % 2)), so that a lane's word
//     of 8-row group i holds rows 8i + t and 8i + t + 4: the A fragment's
//     k t and k t + 4 in x's natural order.  One wgmma group a half-chunk
//     (its first product writes acc_g, scale-d 0); the FMA into acc waits
//     for it just before the next half-chunk's dequant, and the two
//     warpgroups take turns per half-chunk.
//   * Operations bound them at M > 16: 2 TF32 products x 2 M N K over 495
//     TFLOP/s (0.555 ms at M 4096, K 2048, N 8192); bytes at M <= 16.
//   * Error against the plain version: x_hi + x_lo is x within 2^-21 |x|,
//     each product q x_hi, q x_lo is exact and the sums are float32, so the
//     result differs from the exact sum of q x by the float32 sums' error
//     and 2^-21 of |x| @ |q|; v1's unpack_w4 rounds each fl(q s) once, which
//     the kernel does not.  Both stay within the plain version's own
//     summation bound, 2 K 2^-24 (|x| @ |W|).  For float32 x v2 equals v1,
//     so one kernel serves both.
//
// Groups that are not a multiple of 32 (w4_rows): the quantizer writes any
// even G that divides K (G = 6, 16 or 48, or G = K = 100), and then a
// half-chunk can straddle groups.  This route indexes the group, and so
// the scale row and the low / high k of x, per packed row: one thread per
// column and 8 rows of x per block, x staged in shared memory per chunk in
// float32, each weight dequantized as unpack_w4 / unpack_w4_v2 forms it
// (rounded to x's dtype), fp32 FMA, K split over blocks through the
// workspace, summed by sum_splits.  A route chosen by the shape (no
// library call takes such a group either), not a fast one.
//
// Against the plain version the bf16 routes and w4_rows differ only by the
// order of the float32 sums; the float32 routes as stated above.
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
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using ak::desc_sw32;
using ak::desc_sw64;
using ak::fence_acc;
using ak::mbar_arrive;
using ak::mbar_expect_tx;
using ak::mbar_init;
using ak::mbar_wait;
using ak::tensor_map;
using ak::tma_2d;
using ak::wgmma_bf16_n128;
using ak::wgmma_tf32_n64;

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

// ---------------------------------------------- chunks and half-chunks
constexpr int SCH = 32;  // packed rows a chunk
constexpr int HCH = 16;  // packed rows a half-chunk

// Half-chunk hc, packed rows 16 hc .. 16 hc + 15, for G % 32 == 0: its
// group (the scale row), the k of x at its first row's low nibble (the
// high nibble's is klo + G / 2), and whether it lies inside K.
struct Half {
  int grp, klo;
  bool ok;
};

__device__ __forceinline__ Half half_chunk(const Args& a, int hc) {
  const int half = a.G / 2, prow = HCH * hc, grp = prow / half;
  return {grp, grp * a.G + prow - grp * half, prow < a.K / 2};
}

// the two half-chunks of chunk c.  `two` false (G % 64 == 0): one group a
// chunk, found with one division, and every chunk inside K
__device__ __forceinline__ void chunk_halves(const Args& a, int c, bool two, Half& h0,
                                             Half& h1) {
  if (two) {
    h0 = half_chunk(a, 2 * c);
    h1 = half_chunk(a, 2 * c + 1);
  } else {
    const int cpg = a.G / (2 * SCH), grp = c / cpg;
    h0 = {grp, grp * a.G + (c - grp * cpg) * SCH, true};
    h1 = {grp, h0.klo + HCH, true};
  }
}

__host__ __device__ __forceinline__ int n_chunks(int K) { return (K / 2 + SCH - 1) / SCH; }

// chunks [c0, c1) of split s of `splits`
__device__ __forceinline__ void chunk_range(int K, int s, int splits, int& c0, int& c1) {
  const int nc = n_chunks(K);
  c0 = (int)((long long)s * nc / splits);
  c1 = (int)((long long)(s + 1) * nc / splits);
}

// ------------------------------------------------------ M <= 16 (decode)
constexpr int SWARPS = 4;         // warps per block, each a slice of K
constexpr int SBN = 128;          // columns per block: 4 strips of 32 per warp
constexpr int STAGES = 3;         // chunks per warp ring
constexpr int MAX_SPLITS = 8;     // portable cluster size
constexpr int CHUNK = SCH * SBN;  // weight bytes of a chunk
constexpr int SROW = SBN * 4;     // bytes of a scale row in a slot (float32 or bf16)
constexpr float kBias = 8388616.0f;  // 2^23 + 8

// x bytes of a chunk and row, for eb-byte elements: 64 k, padded by 16
__host__ __device__ constexpr int xrow(int eb) { return 64 * eb + 16; }
// bytes of one ring slot of w4_small<MT>: the chunk's weights, two scale
// rows (float32 or bf16) and its 64 k of x for 8 MT rows
__host__ __device__ constexpr int slot_bytes(int mt, int eb) {
  return CHUNK + 2 * SROW + 8 * mt * xrow(eb);
}
// shared bytes of w4_small<MT>; the partial sums reuse the ring
__host__ __device__ constexpr int small_smem(int mt, int eb) {
  return SWARPS * STAGES * slot_bytes(mt, eb);
}
static_assert(SWARPS * 8 * 2 * SBN * 4 <= SWARPS * STAGES * CHUNK, "partials fit the ring");

// byte offset of the 16-byte piece h of chunk row r: the piece index is
// XOR-swizzled by the row, so that a k step's fragment reads hit 32
// distinct banks: rows 2t and 2t + 1 (t = 0..3) at 8 lanes' columns for
// bf16 (two loads), rows 4s + t for TF32 (one load)
template <bool TF>
__device__ __forceinline__ int piece_off(int r, int h) {
  return r * SBN + 16 * (h ^ (2 * ((TF ? r : r >> 1) & 3)));
}

// nibble at bit `shift` of w -> its signed value in float32
__device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - kBias;
}

// byte b of v, a biased nibble u ^ 8 -> the signed nibble as a float32
// (TF32-exact) register: PRMT makes the float 2^23 + (u ^ 8)
__device__ __forceinline__ uint32_t nib_tf32(uint32_t v, int b) {
  return __float_as_uint(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | b)) - kBias);
}

// the low (hi = false) or high nibbles of the four bytes of w, biased (^ 8)
__device__ __forceinline__ uint32_t nibbles8(uint32_t w, bool hi) {
  return ((hi ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
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

// four scales, of columns c .. c + 3 of a slot's scale row, as float32
__device__ __forceinline__ void scales4(const uint8_t* row, int c, bool sbf16, float (&s)[4]) {
  if (sbf16) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + 2 * c);
    s[0] = __uint_as_float(v.x << 16);
    s[1] = __uint_as_float(v.x & 0xFFFF0000u);
    s[2] = __uint_as_float(v.y << 16);
    s[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * c);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  }
}

// MT n8 tiles of x rows (M <= 8 * MT).  TWO: G % 64 != 0, so a chunk's
// half-chunks may lie in two groups.  TF: float32 x on TF32 mma.sync
// m16n8k8 (the nibble as A, x split, the scale on the group's sum).  Else
// bf16 x on mma.sync m16n8k16; FAST: the dequant in bf16x2 arithmetic,
// exact for bf16 scales and for v2 (whose scale is rounded to bf16 first):
// q * s has at most 12 significant bits, so the bf16 product rounds it
// once, as the float32 product rounded to bf16 does.  Otherwise (v1 with
// float32 scales) the float32 product, rounded to float32 and then to
// bf16, as unpack_w4 forms it.
//
// A block owns 128 columns; its SWARPS warps take the chunks kw, kw +
// SWARPS, ... of the block's K range, each over all 128 columns (4 strips
// of 32).  The grid is (column tiles, 1, splits), one cluster of `splits`
// blocks per column tile.
template <int MT, bool FAST, bool TF, bool TWO>
__global__ void __launch_bounds__(SWARPS * 32) w4_small(Args a) {
  constexpr int EB = TF ? 4 : 2;  // bytes of an element of x
  constexpr int XROW = xrow(EB);
  constexpr int SLOT = slot_bytes(MT, EB);
  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem);  // [warp][8MT][128], after the loop

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * SBN;
  const int splits = gridDim.z;
  const int half = a.G / 2;
  // a scale row a half-chunk where a chunk can straddle two groups (TWO:
  // G % 64 != 0), and always on the TF32 route, whose scales come per
  // half-chunk
  constexpr bool two = TF || TWO;
  int cb, ce;
  chunk_range(a.K, blockIdx.z, splits, cb, ce);
  const int nc = ce - cb;
  const int ni = warp < nc ? (nc - warp + SWARPS - 1) / SWARPS : 0;  // this warp's chunks
  const int sbytes = a.sbf16 ? 2 : 4;
  uint8_t* wring = smem + warp * STAGES * SLOT;

  // this warp's i-th chunk (block chunk warp + i SWARPS) into slot i % STAGES:
  // [32 rows x 128 columns of bytes][2 scale rows][8MT rows x 64 k of x]
  auto issue = [&](int i) {
    if (i < ni) {
      const int c = cb + warp + i * SWARPS;
      Half h0, h1;
      chunk_halves(a, c, TWO, h0, h1);
      uint8_t* dst = wring + (i % STAGES) * SLOT;
      uint8_t* sdst = dst + CHUNK;
      uint8_t* xdst = sdst + 2 * SROW;
      const int8_t* wsrc = a.packed + (size_t)SCH * c * a.N + n0;  // packed row 32c
      if (a.vec) {
#pragma unroll
        for (int k = 0; k < CHUNK / 16 / 32; ++k) {  // 4 rows of 128 bytes a round
          const int p = lane + 32 * k, r = p / 8, h = p % 8;
          const bool ok = n0 + 16 * h < a.N && (r < HCH || h1.ok);
          ak::cp16(dst + piece_off<TF>(r, h),
                   ok ? wsrc + (size_t)r * a.N + 16 * h : a.packed, ok);
        }
        if (lane * 16 < SBN * sbytes) {
          const int cs = n0 + lane * 16 / sbytes;  // first column of the piece
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j == 1 && !two) break;
            const Half hj = j ? h1 : h0;
            const bool ok = cs < a.N && hj.ok;
            ak::cp16(sdst + j * SROW + lane * 16,
                     ok ? static_cast<const uint8_t*>(a.scales) +
                              ((size_t)hj.grp * a.N + cs) * sbytes
                        : a.scales, ok);
          }
        }
      } else {  // N or a pointer not 16-byte aligned: byte by byte
        const bool rok = lane < HCH || h1.ok;
        const int8_t* src = wsrc + (size_t)lane * a.N;
        for (int h = 0; h < SBN / 16; ++h) {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (rok && n0 + 16 * h + j < a.N)
              w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + 16 * h + j)))
                          << (8 * (j % 4));
          *reinterpret_cast<uint4*>(dst + piece_off<TF>(lane, h)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
        for (int j = 0; j < 1 + two; ++j) {
          const Half hj = j ? h1 : h0;
          for (int n = lane; n < SBN; n += 32) {
            const bool ok = n0 + n < a.N && hj.ok;
            const size_t si = (size_t)hj.grp * a.N + n0 + n;
            if (a.sbf16)
              reinterpret_cast<uint16_t*>(sdst + j * SROW)[n] =
                  ok ? __ldg(static_cast<const uint16_t*>(a.scales) + si) : 0;
            else
              reinterpret_cast<float*>(sdst + j * SROW)[n] =
                  ok ? __ldg(static_cast<const float*>(a.scales) + si) : 0.f;
          }
        }
      }
      // x rows 0 .. 8MT - 1: the two half-chunks' low-nibble runs of 16 k,
      // then their high-nibble runs, in 16-byte pieces of 16 / EB elements;
      // rows past M and a half-chunk past K zero
#pragma unroll
      for (int k = 0; k < MT * EB; ++k) {
        const int p = lane + 32 * k, m = p / (4 * EB), q = p % (4 * EB);
        const int run = q / (2 * EB), j = q / EB % 2, sub = q % EB;
        const Half hj = j ? h1 : h0;
        const bool ok = m < a.M && hj.ok;
        const size_t e = (size_t)m * a.K + hj.klo + (run ? half : 0) + sub * (16 / EB);
        ak::cp16(xdst + m * XROW + 16 * q,
                 ok ? static_cast<const uint8_t*>(a.x) + e * EB : a.x, ok);
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
    const uint8_t* xp = sp + 2 * SROW;
    if constexpr (TF) {
      const float* xf = reinterpret_cast<const float*>(xp);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // B fragments of half-chunk hh's k step s: x^T at k-index t, the
        // low-nibble k of packed row 16hh + 4s + t, and t + 4, its
        // high-nibble k; each split into its TF32 hi and lo
        uint32_t bh[4][MT][2], bl[4][MT][2];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
              ak::split_tf32(xf[(8 * mt + g) * (XROW / 4) + 32 * hi + 16 * hh + 4 * s + t],
                             bh[s][mt][hi], bl[s][mt][hi]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float sc[4];  // the group's scales of columns 32u + 4g .. 32u + 4g + 3
          scales4(sp + hh * SROW, 32 * u + 4 * g, a.sbf16, sc);
          float accg[2][MT][4];  // the half-chunk's sum, before its scale
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              accg[ii][mt][0] = accg[ii][mt][1] = accg[ii][mt][2] = accg[ii][mt][3] = 0.f;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            // packed row 16hh + 4s + t at columns 32u + 4g + j: byte j is
            // column 4g + j, row g (j even) or g + 8 of m-tile j / 2; its
            // low nibble k t, its high nibble k t + 4
            const uint32_t wd = *reinterpret_cast<const uint32_t*>(
                w + piece_off<true>(16 * hh + 4 * s + t, 2 * u + g / 4) + 4 * (g % 4));
            const uint32_t lo8 = nibbles8(wd, false), hi8 = nibbles8(wd, true);
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const uint32_t af[4] = {nib_tf32(lo8, 2 * ii), nib_tf32(lo8, 2 * ii + 1),
                                      nib_tf32(hi8, 2 * ii), nib_tf32(hi8, 2 * ii + 1)};
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) {
                ak::mma_tf32(accg[ii][mt], af, bh[s][mt][0], bh[s][mt][1]);
                ak::mma_tf32(accg[ii][mt], af, bl[s][mt][0], bl[s][mt][1]);
              }
            }
          }
          // C rows g, g + 8 of m-tile ii are columns 4g + 2ii, 4g + 2ii + 1
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[u][ii][mt][e] = fmaf(sc[2 * ii + e / 2], accg[ii][mt][e], acc[u][ii][mt][e]);
        }
      }
    } else {
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
        float s[4];
        __nv_bfloat162 s2[4];
        const int hp = 2 * u + g / 4;  // the 16-byte piece of columns 32u + 4g..
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks == 0 || (ks == 2 && two)) {
            // half-chunk ks / 2's scales of columns 32u + 4g .. 32u + 4g + 3
            scales4(sp + (ks / 2) * SROW, 32 * u + 4 * g, a.sbf16, s);
#pragma unroll
            for (int j = 0; j < 4; ++j) s2[j] = __float2bfloat162_rn(s[j]);  // exact for bf16
          }
          const int ra = 8 * ks + 2 * t;
          const uint32_t wa =
              *reinterpret_cast<const uint32_t*>(w + piece_off<false>(ra, hp) + 4 * (g % 4));
          const uint32_t wb =
              *reinterpret_cast<const uint32_t*>(w + piece_off<false>(ra + 1, hp) + 4 * (g % 4));
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

// ------------------------------------------------------ M > 16 (wgmma)
constexpr int WBN = 256;      // output columns a block: 2 warpgroups x 2 m64 tiles
constexpr int WBM = 128;      // rows of x a block of w4_wgmma: the wgmma's n
constexpr int WTHREADS = 256;
constexpr int WSTAGES = 6;    // ring slots of w4_wgmma, WSTAGES - 2 chunks ahead
constexpr int WXT = WBM * 64;             // an x tile: 128 rows x 64 bytes
constexpr int WWT = SCH * 128;            // a weight half: 32 packed rows x 128 columns
constexpr int WSROW = WBN * 4;            // a scale row of 256 columns
// a slot of w4_wgmma: the x tiles, the weights, one scale row or (two) a
// row a half-chunk: 25,600 or 26,624 bytes
__host__ __device__ constexpr int wslot(bool two) {
  return 2 * WXT + 2 * WWT + (two ? 2 : 1) * WSROW;
}
constexpr int WLDC = WBN + 4;             // float stride of the output tile
// shared bytes of w4_wgmma: the ring, alignment slack, the mbarriers
__host__ __device__ constexpr int wsmem(bool two) {
  return WSTAGES * wslot(two) + 1024 + 16 * WSTAGES;
}
static_assert(wslot(false) % 1024 == 0 && wslot(true) % 1024 == 0 && WXT % 1024 == 0 &&
              WWT % 1024 == 0, "every tile 1 KB aligned, as the swizzles");
static_assert(WBM * WLDC * 4 <= WSTAGES * wslot(false), "the output tile fits the ring");

// byte offset of 16-byte piece h (0..15) of packed row r in a chunk's
// weights: two 128-column halves, each [32][128] in the 128-byte swizzle
// (TMA's SWIZZLE_128B), so the 8 rows of an ldmatrix phase hit distinct
// banks
__device__ __forceinline__ int wswz(int r, int h) {
  return (h >> 3) * WWT + r * 128 + 16 * ((h & 7) ^ (r & 7));
}

// Without a.vec (N or a pointer not 16-byte aligned) the threads of a
// wgmma block copy chunk c's weights and its half-chunks' scale rows (h0,
// and h1 with TWO) into a slot byte by byte: sw [two 128-column halves,
// 128-byte swizzle], then the scale rows at sw + 2 WWT, WSROW apart.
// Packed rows past K read as zero.
template <bool TWO>
__device__ __forceinline__ void copy_bytes(const Args& a, uint8_t* sw, int c, int n0,
                                           const Half& h0, const Half& h1, int tid) {
  const int wp = tid & 15, wr = tid >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + 16 * i, n = n0 + 16 * wp, prow = SCH * c + r;
    const int8_t* src = a.packed + (size_t)prow * a.N + n;
    // (with G % 64 == 0 every chunk lies inside K)
    const bool in = !TWO || prow < a.K / 2;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (in && n + k < a.N)
        w[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + k))) << (8 * (k % 4));
    *reinterpret_cast<uint4*>(sw + wswz(r, wp)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static_assert(WBN == WTHREADS, "one scale a thread");
  const bool ok = n0 + tid < a.N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j == 1 && !TWO) break;
    uint8_t* ss = sw + 2 * WWT + j * WSROW;
    const size_t i = (size_t)(j ? h1 : h0).grp * a.N + n0 + tid;
    if (a.sbf16)
      reinterpret_cast<uint16_t*>(ss)[tid] =
          ok ? __ldg(static_cast<const uint16_t*>(a.scales) + i) : 0;
    else
      reinterpret_cast<float*>(ss)[tid] =
          ok ? __ldg(static_cast<const float*>(a.scales) + i) : 0.f;
  }
}

// The block's output tile from its accumulators: acc[u][4 nb + 2 h + e] is
// column col + 64 u + h and x row m0 + 8 nb + 2 t + e.  Without a split
// the lanes store their column pairs as they are (each 32-byte sector is
// written whole by one instruction); with one the partial tile goes
// through shared memory (the ring, free by then), and each block of the
// cluster stores a slice of the tile's rows, summed over the splits in
// rank order.
template <int BM>
__device__ __forceinline__ void store_tile(const Args& a, float (&acc)[2][BM / 2],
                                           uint8_t* ring, int m0, int n0, int col, int t,
                                           int tid, int splits) {
  constexpr int NB = BM / 8;
  if (splits == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
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
  __syncthreads();
  float* tile = reinterpret_cast<float*>(ring);  // [BM][WLDC]
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(tile + (8 * nb + 2 * t + e) * WLDC + col + 64 * u) =
            make_float2(acc[u][4 * nb + e], acc[u][4 * nb + 2 + e]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * BM / splits, r1 = (rank + 1) * BM / splits;
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

// FAST as for w4_small.  TWO: G % 64 != 0, so a chunk's half-chunks may
// lie in two groups: x in four runs of 16 k, a scale row each.  The grid
// is (column tiles, row tiles, splits), one cluster of `splits` blocks per
// output tile.  tx: x [M, K] bf16, boxes of 128 rows x 32 k in the 64-byte
// swizzle, or with TWO of 128 rows x 16 k in the 32-byte swizzle; tw:
// packed [K/2, N] bytes, boxes of 32 rows x 128 columns; ts: scales [K/G,
// N], boxes of one row x 256 columns (tw and ts only when a.vec).  The
// kernel is close to bound by instruction issue (one warpgroup dequantizes
// while the other's group runs), so TWO's bookkeeping is compiled only
// into its own instantiation.
template <bool FAST, bool TWO>
__global__ void __launch_bounds__(WTHREADS, 1)
    w4_wgmma(const Args a, const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap ts) {
  constexpr int WSLOT = wslot(TWO), WRING = WSTAGES * WSLOT;
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
  const int nchunks = TWO ? n_chunks(a.K) : a.K / (2 * SCH);
  const int c0 = (int)((long long)blockIdx.z * nchunks / splits);
  const int nc = (int)((long long)(blockIdx.z + 1) * nchunks / splits) - c0;
  const int sbytes = a.sbf16 ? 2 : 4;
  // bytes a slot's mbarrier waits for: the x tiles, and with a.vec the
  // weights and the scale rows
  const uint32_t tx_bytes = 2 * WXT + (a.vec ? 2 * WWT + (TWO ? 2 : 1) * WBN * sbytes : 0);

  if (tid == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's chunk c0 + j into slot j % WSTAGES: [x low k][x high k]
  // [weights, two halves][scale rows].  Thread 0 issues the TMA copies once
  // the slot's last chunk is released; without a.vec (N or a pointer not
  // 16-byte aligned) every thread copies the weights and scales byte by
  // byte, and a block barrier a chunk keeps the warps in step.  With TWO a
  // second half-chunk past K takes the first's x and scales: its weights
  // are zero.
  const int wp = tid & 15, wr = tid >> 4;  // byte-by-byte roles
  auto issue = [&](int j) {
    const int slot = j % WSTAGES;
    const uint32_t st = ring_addr + slot * WSLOT;
    if constexpr (TWO) {
      const int c = c0 + j;
      Half h0, h1;
      chunk_halves(a, c, true, h0, h1);
      if (!h1.ok) h1 = h0;
      if (tid == 0) {
        if (j >= WSTAGES) mbar_wait(empty + 8 * slot, (j / WSTAGES - 1) & 1);
        const uint32_t bar = full + 8 * slot;
        mbar_expect_tx(bar, tx_bytes);
        tma_2d(st, tx, h0.klo, m0, bar);
        tma_2d(st + WXT / 2, tx, h1.klo, m0, bar);
        tma_2d(st + WXT, tx, h0.klo + half, m0, bar);
        tma_2d(st + WXT + WXT / 2, tx, h1.klo + half, m0, bar);
        if (a.vec) {
          tma_2d(st + 2 * WXT, tw, n0, SCH * c, bar);
          tma_2d(st + 2 * WXT + WWT, tw, n0 + 128, SCH * c, bar);
          tma_2d(st + 2 * WXT + 2 * WWT, ts, n0, h0.grp, bar);
          tma_2d(st + 2 * WXT + 2 * WWT + WSROW, ts, n0, h1.grp, bar);
        }
      }
      if (!a.vec) copy_bytes<true>(a, ring + slot * WSLOT + 2 * WXT, c, n0, h0, h1, tid);
      return;
    }
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
    // the scales of half-chunk p (with TWO, p's own row; else both the
    // chunk's one row) at this thread's columns
    float s[2][2][2];  // [half-chunk][tile][column]
    __nv_bfloat162 h[2][2][2];
#pragma unroll
    for (int p = 0; p < (TWO ? 2 : 1); ++p)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = col + 64 * u;
        const uint8_t* row = ss + p * WSROW;
        if (a.sbf16) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(row + 2 * c);
          s[p][u][0] = __uint_as_float(v << 16);
          s[p][u][1] = __uint_as_float(v & 0xFFFF0000u);
        } else {
          const float2 v = *reinterpret_cast<const float2*>(row + 4 * c);
          s[p][u][0] = v.x;
          s[p][u][1] = v.y;
        }
        h[p][u][0] = __float2bfloat162_rn(s[p][u][0]);  // exact for bf16 scales; v2's rounding
        h[p][u][1] = __float2bfloat162_rn(s[p][u][1]);
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
    // 16p .. 16p + 15 (half-chunk p), against its run of x
    uint32_t af[4][2][4];  // [k step][tile][fragment]
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int p = TWO ? ks & 1 : 0;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        deq_frag<FAST>(af[ks][u], wv[u][2 * (ks & 1)], wv[u][2 * (ks & 1) + 1], 4 * (ks >> 1),
                       s[p][u][0], s[p][u][1], h[p][u][0], h[p][u][1]);
    }
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
      const int q = ks >> 1, p = ks & 1;
      const uint64_t db = TWO ? desc_sw32(xaddr + q * WXT + p * (WXT / 2))
                              : desc_sw64(xaddr + q * WXT + 32 * p);
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
  store_tile<WBM>(a, acc, ring, m0, n0, col, t, tid, splits);
}

// ------------------------------------------- float32, M > 16 (TF32 wgmma)
constexpr int TBM = 64;        // rows of x a block: the wgmma's n
constexpr int TSTAGES = 4;     // ring slots, TSTAGES - 2 chunks ahead
constexpr int TXT = TBM * 64;  // an x run: 64 rows x 16 floats (64-byte swizzle)
// four x runs (TF32 hi after the split), their lo parts, the weights, two
// scale rows: 43,008
constexpr int TSLOT = 8 * TXT + 2 * WWT + 2 * WSROW;
constexpr int TRING = TSTAGES * TSLOT;
constexpr int TSMEM = TRING + 1024 + 16 * TSTAGES;
static_assert(TSLOT % 1024 == 0 && TXT % 1024 == 0, "every tile 1 KB aligned");
static_assert(TBM * WLDC * 4 <= TRING, "the output tile fits the ring");

// x = hi + lo for a 16-byte piece of x in place: hi (cvt.rna.tf32's value,
// as split_tf32 forms it, its low 13 bits cleared) and lo = x - hi
__device__ __forceinline__ void split_piece(uint4& v, uint4& lo) {
  uint32_t* e = reinterpret_cast<uint32_t*>(&v);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h, r;
    ak::split_tf32(__uint_as_float(e[i]), h, r);
    e[i] = h & 0xffffe000u;
    l[i] = r;
  }
}

// The grid is (column tiles, row tiles, splits), one cluster of `splits`
// blocks per output tile.  tx: x [M, K] float32, boxes of 64 rows x 16 k in
// the 64-byte swizzle; tw, ts as for w4_wgmma (only when a.vec).
__global__ void __launch_bounds__(WTHREADS, 1)
    w4_wgmma_tf32(const Args a, const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ts) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the ring, 1 KB aligned as w4_wgmma's, then the mbarriers
  uint8_t* ring = smem + ((1024 - (static_cast<uint32_t>(
                                       __cvta_generic_to_shared(smem)) & 1023)) & 1023);
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t full = ring_addr + TRING, empty = full + 8 * TSTAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * WBN, m0 = blockIdx.y * TBM;
  const int splits = gridDim.z;
  const int half = a.G / 2;
  const bool two = half % SCH != 0;  // a chunk's half-chunks in two groups
  int c0, c1;
  chunk_range(a.K, blockIdx.z, splits, c0, c1);
  const int nc = c1 - c0;
  const int sbytes = a.sbf16 ? 2 : 4;
  const uint32_t tx_bytes = 4 * TXT + (a.vec ? 2 * WWT + 2 * WBN * sbytes : 0);

  if (tid == 0) {
    for (int i = 0; i < TSTAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, WTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's chunk c0 + j into slot j % TSTAGES: [x: half-chunk 0's low
  // run, 1's low run, 0's high run, 1's high run][their lo parts, written
  // by the split][weights, two halves][two scale rows], as w4_wgmma's
  auto issue = [&](int j) {
    const int slot = j % TSTAGES;
    const uint32_t st = ring_addr + slot * TSLOT;
    const int c = c0 + j;
    Half h0, h1;
    if (tid == 0 || !a.vec) {
      chunk_halves(a, c, two, h0, h1);
      if (!h1.ok) h1 = h0;
    }
    if (tid == 0) {
      if (j >= TSTAGES) mbar_wait(empty + 8 * slot, (j / TSTAGES - 1) & 1);
      const uint32_t bar = full + 8 * slot;
      mbar_expect_tx(bar, tx_bytes);
      tma_2d(st, tx, h0.klo, m0, bar);
      tma_2d(st + TXT, tx, h1.klo, m0, bar);
      tma_2d(st + 2 * TXT, tx, h0.klo + half, m0, bar);
      tma_2d(st + 3 * TXT, tx, h1.klo + half, m0, bar);
      if (a.vec) {
        tma_2d(st + 8 * TXT, tw, n0, SCH * c, bar);
        tma_2d(st + 8 * TXT + WWT, tw, n0 + 128, SCH * c, bar);
        tma_2d(st + 8 * TXT + 2 * WWT, ts, n0, h0.grp, bar);
        tma_2d(st + 8 * TXT + 2 * WWT + WSROW, ts, n0, h1.grp, bar);
      }
    }
    if (!a.vec) copy_bytes<true>(a, ring + slot * TSLOT + 8 * TXT, c, n0, h0, h1, tid);
  };

  // acc: the block's sums; accg: a half-chunk's, written by wgmma alone
  // (its first product with scale-d 0) and read after the group is waited for
  float acc[2][32], accg[2][32];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = accg[u][i] = 0.f;
  fence_acc(accg[0]);
  fence_acc(accg[1]);

  for (int s = 0; s < TSTAGES - 2 && s < nc; ++s) issue(s);
  const int strip = 8 * (warp >> 2) + (warp & 3);
  const int col = 16 * strip + 2 * g;
  // the packed row this lane addresses for ldmatrix: lane 8i + j of matrix
  // i reads row 8i + j / 2 + 4 (j % 2), so the transposed word of lane (g,
  // t) holds rows 8i + t (bytes 0, 1) and 8i + t + 4 (bytes 2, 3) at
  // columns 2g, 2g + 1: the A fragment's (row g, k t), (g + 8, t), (g, t +
  // 4), (g + 8, t + 4), with k in x's order
  const int lrow = 8 * (lane >> 3) + ((lane & 7) >> 1) + 4 * (lane & 1);
  float sprev[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // the scales of accg's half-chunk
  for (int j = 0; j < nc; ++j) {
    const int slot = j % TSTAGES;
    mbar_wait(full + 8 * slot, (j / TSTAGES) & 1);
    uint8_t* sx = ring + slot * TSLOT;
    // every thread splits its share of the chunk's x; the generic writes
    // are fenced for the async proxy (wgmma) before the barrier hands them
    // to both warpgroups (without a.vec, the barrier also sees every
    // thread's byte copies in)
    for (int i = tid; i < 4 * TXT / 16; i += WTHREADS) {
      uint4 v = reinterpret_cast<uint4*>(sx)[i], lo;
      split_piece(v, lo);
      reinterpret_cast<uint4*>(sx)[i] = v;
      reinterpret_cast<uint4*>(sx + 4 * TXT)[i] = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint8_t* sw = sx + 8 * TXT;
    const uint8_t* ss = sw + 2 * WWT;
    uint32_t wv[2][4];  // [tile][8-row group]
    ak::ldsm4t(wv[0], sw + wswz(lrow, strip));
    ak::ldsm4t(wv[1], sw + wswz(lrow, strip + 4));
    const uint32_t xaddr = ring_addr + slot * TSLOT;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 2 * j + hh;  // the block's half-chunk group
      float s[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = col + 64 * u;
        if (a.sbf16) {
          const uint32_t v = *reinterpret_cast<const uint32_t*>(ss + hh * WSROW + 2 * c);
          s[u][0] = __uint_as_float(v << 16);
          s[u][1] = __uint_as_float(v & 0xFFFF0000u);
        } else {
          const float2 v = *reinterpret_cast<const float2*>(ss + hh * WSROW + 4 * c);
          s[u][0] = v.x;
          s[u][1] = v.y;
        }
      }
      // the previous half-chunk's group must be done before its sum is
      // read and the fragment registers are written again (C7513)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(accg[0]);
      fence_acc(accg[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(wv[u][i])::"memory");
      if (n > 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            acc[u][i] = fmaf(sprev[u][(i >> 1) & 1], accg[u][i], acc[u][i]);
      }
      if (hh == 0 && j > 0 && lane == 0) mbar_arrive(empty + 8 * ((j - 1) % TSTAGES));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        sprev[u][0] = s[u][0];
        sprev[u][1] = s[u][1];
      }
      // k step 2q + b: the low (q 0) or high (q 1) nibbles of 8-row group
      // 2hh + b, against x's run q of half-chunk hh at k 8b
      uint32_t af[4][2][4];  // [k step][tile][fragment]
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t v8 = nibbles8(wv[u][2 * hh + (ks & 1)], ks >> 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) af[ks][u][e] = nib_tf32(v8, e);
        }
      if ((warp >> 2) == 0 && n > 0)
        asm volatile("bar.sync 1, %0;\n" ::"n"(WTHREADS) : "memory");
      if ((warp >> 2) == 1)
        asm volatile("bar.sync 2, %0;\n" ::"n"(WTHREADS) : "memory");
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t xh = xaddr + (2 * (ks >> 1) + hh) * TXT + 32 * (ks & 1);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          wgmma_tf32_n64(accg[u], af[ks][u], desc_sw64(xh), ks != 0);
          wgmma_tf32_n64(accg[u], af[ks][u], desc_sw64(xh + 4 * TXT), 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if ((warp >> 2) == 0)
        asm volatile("bar.arrive 2, %0;\n" ::"n"(WTHREADS) : "memory");
      if ((warp >> 2) == 1 && n + 1 < 2 * nc)
        asm volatile("bar.arrive 1, %0;\n" ::"n"(WTHREADS) : "memory");
    }
    if (j + TSTAGES - 2 < nc) issue(j + TSTAGES - 2);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(accg[0]);
  fence_acc(accg[1]);
  if (nc > 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] = fmaf(sprev[u][(i >> 1) & 1], accg[u][i], acc[u][i]);
  }
  store_tile<TBM>(a, acc, ring, m0, n0, col, t, tid, splits);
}

// ------------------------------------------- any even G (G % 32 != 0)
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

// Splits of K for w4_small: about two blocks per SM, at most one
// cluster's worth, and a chunk a warp for each split (a split of fewer
// chunks costs more in the cluster's sum than it saves).
int small_splits(int N, int K) {
  const int tiles = (N + SBN - 1) / SBN, most = n_chunks(K) / SWARPS;
  int s = (2 * ak::sm_count() + tiles / 2) / tiles;
  s = s > MAX_SPLITS ? MAX_SPLITS : s;
  s = s > most ? most : s;
  return s < 1 ? 1 : s;
}

// A launch of `kernel` with `smem` bytes of dynamic shared memory, its
// grid's z a cluster of `s` blocks
template <typename... Kargs>
cudaError_t launch_cluster(void (*kernel)(Kargs...), dim3 grid, int threads, int smem,
                           int s, cudaStream_t st, const Kargs&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MT, bool FAST, bool TF, bool TWO>
cudaError_t launch_small(const Args& a, cudaStream_t st) {
  constexpr int smem = small_smem(MT, TF ? 4 : 2);
  const int s = small_splits(a.N, a.K);
  const cudaError_t e = ak::allow_smem<w4_small<MT, FAST, TF, TWO>>(smem);
  if (e != cudaSuccess) return e;
  return launch_cluster(w4_small<MT, FAST, TF, TWO>, dim3((a.N + SBN - 1) / SBN, 1, s),
                        SWARPS * 32, smem, s, st, a);
}

// w4_small for M <= 8 or M <= 16, and TWO by G
template <bool FAST, bool TF>
cudaError_t launch_small(const Args& a, cudaStream_t st) {
  if ((a.G / 2) % SCH != 0)
    return a.M <= 8 ? launch_small<1, FAST, TF, true>(a, st)
                    : launch_small<2, FAST, TF, true>(a, st);
  return a.M <= 8 ? launch_small<1, FAST, TF, false>(a, st)
                  : launch_small<2, FAST, TF, false>(a, st);
}

// Splits of K for the wgmma routes (bm rows of x a block): none while the
// grid fills half the SMs or more; else enough blocks for about one an
// SM, at most one cluster's worth and one chunk a split.
int wgmma_splits(int M, int N, int K, int bm) {
  const long long blocks = (long long)((N + WBN - 1) / WBN) * ((M + bm - 1) / bm);
  const int sms = ak::sm_count();
  if (2 * blocks > sms) return 1;
  long long s = sms / blocks;
  s = s > MAX_SPLITS ? MAX_SPLITS : s;
  s = s > n_chunks(K) ? n_chunks(K) : s;
  return s < 1 ? 1 : (int)s;
}

// The weights' and scales' tensor maps of the wgmma routes: packed [K/2,
// N] in boxes of 32 rows x 128 columns (128-byte swizzle), scales [K/G, N]
// in boxes of one row x 256 columns.  Without a.vec they are not read, and
// are copies of tx.
bool weight_maps(const Args& a, const CUtensorMap& tx, CUtensorMap* tw, CUtensorMap* ts) {
  *tw = tx;
  *ts = tx;
  return !a.vec ||
         (tensor_map(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.packed, a.N, a.K / 2, a.N, 128,
                     SCH, CU_TENSOR_MAP_SWIZZLE_128B) &&
          tensor_map(ts,
                     a.sbf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     a.scales, a.N, a.K / a.G, (size_t)a.N * (a.sbf16 ? 2 : 4), WBN, 1,
                     CU_TENSOR_MAP_SWIZZLE_NONE));
}

template <bool FAST, bool TWO>
cudaError_t launch_wgmma(const Args& a, cudaStream_t st) {
  const int s = wgmma_splits(a.M, a.N, a.K, WBM);
  // x in boxes of 32 k (64-byte swizzle), or of 16 k (32-byte swizzle)
  // where a chunk's half-chunks may lie in two groups
  CUtensorMap tx, tw, ts;
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K, a.M, (size_t)a.K * 2,
                  TWO ? 16 : 32, WBM,
                  TWO ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !weight_maps(a, tx, &tw, &ts))
    return cudaErrorInvalidValue;
  const cudaError_t e = ak::allow_smem<w4_wgmma<FAST, TWO>>(wsmem(TWO));
  if (e != cudaSuccess) return e;
  return launch_cluster(w4_wgmma<FAST, TWO>,
                        dim3((a.N + WBN - 1) / WBN, (a.M + WBM - 1) / WBM, s), WTHREADS,
                        wsmem(TWO), s, st, a, tx, tw, ts);
}

cudaError_t launch_wgmma_tf32(const Args& a, cudaStream_t st) {
  const int s = wgmma_splits(a.M, a.N, a.K, TBM);
  CUtensorMap tx, tw, ts;
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.x, a.K, a.M, (size_t)a.K * 4, 16,
                  TBM, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !weight_maps(a, tx, &tw, &ts))
    return cudaErrorInvalidValue;
  const cudaError_t e = ak::allow_smem<w4_wgmma_tf32>(TSMEM);
  if (e != cudaSuccess) return e;
  return launch_cluster(w4_wgmma_tf32,
                        dim3((a.N + WBN - 1) / WBN, (a.M + TBM - 1) / TBM, s), WTHREADS,
                        TSMEM, s, st, a, tx, tw, ts);
}

// The routes, as ak_matmul_w4_route names them.
enum Route {
  ROUTE_SMALL = 0,
  ROUTE_WGMMA = 1,
  ROUTE_SMALL_TF32 = 2,
  ROUTE_WGMMA_TF32 = 3,
  ROUTE_ROWS = 4
};

int route_of(int M, int G, int bf16) {
  if (G % 32 != 0) return ROUTE_ROWS;
  if (!bf16) return M <= 16 ? ROUTE_SMALL_TF32 : ROUTE_WGMMA_TF32;
  return M <= 16 ? ROUTE_SMALL : ROUTE_WGMMA;
}

template <bool V2>
cudaError_t launch(const Args& a, int bf16, int route, cudaStream_t st) {
  // v2's scale is rounded to bf16 before its product, so bf16x2
  // arithmetic is exact for it as for bf16 scales
  const bool fast = V2 || a.sbf16;
  switch (route) {
    case ROUTE_SMALL:
      return fast ? launch_small<true, false>(a, st) : launch_small<false, false>(a, st);
    case ROUTE_WGMMA:
      if ((a.G / 2) % SCH != 0)
        return fast ? launch_wgmma<true, true>(a, st) : launch_wgmma<false, true>(a, st);
      return fast ? launch_wgmma<true, false>(a, st) : launch_wgmma<false, false>(a, st);
    case ROUTE_SMALL_TF32:  // float32 x: v2 is v1
      return launch_small<false, true>(a, st);
    case ROUTE_WGMMA_TF32:
      return launch_wgmma_tf32(a, st);
    default: {
      dim3 grid((a.N + RTHREADS - 1) / RTHREADS, (a.M + RM - 1) / RM, a.splits);
      if (bf16)
        w4_rows<V2, true><<<grid, RTHREADS, 0, st>>>(a);
      else
        w4_rows<V2, false><<<grid, RTHREADS, 0, st>>>(a);
      return cudaGetLastError();
    }
  }
}

}  // namespace

// The route a launch takes: 0 w4_small (bf16 x, M <= 16), 1 w4_wgmma (bf16
// x, M > 16), 2 w4_small on TF32 (float32 x, M <= 16), 3 w4_wgmma_tf32
// (float32 x, M > 16), 4 w4_rows (G not a multiple of 32).  dtypes as for
// ak_matmul_w4; N and K do not choose a route.
extern "C" int ak_matmul_w4_route(int M, int N, int K, int G, int dtypes) {
  (void)N;
  (void)K;
  return route_of(M, G, dtypes & 1);
}

// Splits of K into the workspace the launch will use (the caller sizes the
// workspace from it): 1 but for w4_rows; the other routes sum their splits
// in a cluster's shared memory.  dtypes: bit 0 set for bf16 x.
extern "C" int ak_matmul_w4_splits(int M, int N, int K, int G, int dtypes) {
  if (route_of(M, G, dtypes & 1) != ROUTE_ROWS) return 1;
  // splits of whole 32-row chunks, about 8 blocks an SM
  const long long blocks =
      (long long)((N + RTHREADS - 1) / RTHREADS) * ((M + RM - 1) / RM);
  const int chunks = (K / 2 + RCH - 1) / RCH;
  long long s = (8 * 132 + blocks - 1) / blocks;
  return (int)(s < 1 ? 1 : (s > chunks ? chunks : s));
}

// Splits of K the launch takes, however they are summed: in a cluster's
// shared memory or through the workspace (w4_rows).
extern "C" int ak_matmul_w4_kernel_splits(int M, int N, int K, int G, int dtypes) {
  switch (route_of(M, G, dtypes & 1)) {
    case ROUTE_SMALL:
    case ROUTE_SMALL_TF32:
      return small_splits(N, K);
    case ROUTE_WGMMA:
      return wgmma_splits(M, N, K, WBM);
    case ROUTE_WGMMA_TF32:
      return wgmma_splits(M, N, K, TBM);
    default:
      return ak_matmul_w4_splits(M, N, K, G, dtypes);
  }
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
  if (route != ROUTE_ROWS && splits != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(packed) |
                          reinterpret_cast<uintptr_t>(scales) |
                          reinterpret_cast<uintptr_t>(out);
  // the chunked routes copy 16-byte pieces of a row and store float4s
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
