// The int8 implicit-GEMM core shared by matmul_int8.cu and conv3x3_int8.cu:
// a tiled int8 GEMM for Hopper with a fused dequant / bias / residual /
// activation / requant epilogue.
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]                (int32, on chip)
//   y = act(float(acc) * scale[n] + bias[n] + residual[m, n])
//   out = int8(clip(rint(y * inv_out_scale), -127, 127))  or  f32 / bf16 y
//
// A is either a row-major int8 matrix [M, K] (CONV = false) or, for the
// implicit-GEMM 3x3 s1 p1 convolution (CONV = true), the virtual im2col
// matrix of an NHWC int8 image [M / (H * W), H, W, C] with K = 9 * C in
// (dy, dx, c) order; no im2col matrix and no padded copy is ever written.
// B is the weight prepared once as [N][ldb] int8, K contiguous and zero from
// K to ldb (a multiple of 16): the layout an int8 wgmma takes (K-major only,
// no transpose modifier), so no block transposes B.  kernels/matmul_int8.py::prepare_b makes it; a Net
// makes it once per weight when it is built.
//
// Design:
//   * A ring of STAGES stages in dynamic shared memory, each a 128 x 128-byte
//     A tile and a BN x 128-byte B tile, in the 128-byte swizzled layout
//     (16-byte piece c of row r at r * 128 + 16 (c ^ (r % 8)), what TMA's
//     SWIZZLE_128B writes), which wgmma's descriptors read.  Every thread
//     fills it with
//     cp.async, STAGES - 1 K tiles ahead of the MMA, with no register
//     staging.  Halo pixels, rows past M and bytes past K are the copy's own
//     zero fill (cp.async with source size 0).  Each 16-byte piece of a
//     conv row lies in one tap when C % 16 == 0 (4-byte pieces for C % 4
//     == 0, bytes otherwise; likewise K for the GEMM).
//   * MMA: two warpgroups, each wgmma.mma_async.m64nBNk32.s32.s8.s8 over
//     its 64 rows, both operands from shared memory, four k-steps a stage.
//     (Eight warps of ldmatrix + mma.sync.m16n8k32 on the same ring
//     measured 9-13% slower: PERF.md, PR 6.)  One block barrier per
//     128-deep K tile.  Every warp loads: there is no producer warp, since each
//     piece of a conv row needs its own tap and halo test, which one TMA
//     box does not give (TMA's im2col mode would).
//   * Tiles are chosen per shape at launch: 128 x 128, or 128 x 64 where
//     N <= 64 or the grid would be short; where it still holds fewer blocks
//     than SMs, K is split over up to 8 blocks of one thread-block cluster,
//     whose int32 partial tiles are summed through distributed shared
//     memory (exact, so in any order).  96 KB of shared memory a block, so
//     two blocks share an SM and one's epilogue overlaps the other's loads
//     and MMA.  (One persistent block an SM, or 64-row blocks four an SM,
//     measured slower: PERF.md, PR 6.)
//   * Epilogue: the int32 tile goes through shared memory (the ring, free
//     by then), never device memory.  Its common case (int8 out; no or an
//     int8 residual; no activation, relu or relu6), most of ResNet-50's
//     layers, is specialized at compile time (epilogue_fast):
//     eight columns a lane, no branch on the epilogue's kind per element,
//     and all of a lane's residual rows loaded before the first is
//     finished.  Every other case takes four columns a
//     lane (16-byte scale / bias loads, a 4-, 8- or 16-byte residual load
//     and store), ragged edges one element.
//
// Numerics follow the Pallas kernels bit for bit: every epilogue operation
// is a separately rounded IEEE float op (__fmul_rn / __fadd_rn, so nvcc
// cannot contract them into FMAs), rounding is half-to-even (rintf), and
// the requant multiplies by the reciprocal passed in by the caller.  The
// element steps (activate, requant, store_out) are in int8_epilogue.cuh.
#pragma once

#include <cooperative_groups.h>

#include "bf16_mma.cuh"
#include "int8_epilogue.cuh"

namespace ak {

enum ResKind { RES_NONE = 0, RES_F32 = 1, RES_BF16 = 2, RES_S8 = 3 };

struct Params {
  const int8_t* a;
  const int8_t* b;     // the prepared weight [N][ldb]: K contiguous, 0 past K
  const float* scale;  // [N], already in_scale * w_scale
  const float* bias;   // [N] or null
  const void* res;     // [M, N] or null
  void* out;           // [M, N]
  int M, N, K, ldb;
  int H, W, C;         // CONV only
  int act;
  float alpha;
  int res_kind;
  float res_scale;     // RES_S8: residual = float(r) * res_scale
  int out_kind;
  float inv_out_scale; // OUT_S8
  int vec_epi;         // N % 4 == 0 and every epilogue pointer 16-byte aligned
  int fast_epi;        // vec_epi, N % 8 == 0, int8 out, no or int8 residual,
                       // no, relu or relu6 activation: epilogue_fast
};

// y before the activation, for one element.
__device__ __forceinline__ float dequant(const Params& p, size_t idx, int n,
                                         int acc, float scale, float bias) {
  float y = __fmul_rn(static_cast<float>(acc), scale);
  if (p.bias) y = __fadd_rn(y, bias);
  if (p.res_kind == RES_F32) {
    y = __fadd_rn(y, static_cast<const float*>(p.res)[idx]);
  } else if (p.res_kind == RES_BF16) {
    y = __fadd_rn(y, __bfloat162float(
                         static_cast<const __nv_bfloat16*>(p.res)[idx]));
  } else if (p.res_kind == RES_S8) {
    const float r = static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
    y = __fadd_rn(y, __fmul_rn(r, p.res_scale));
  }
  return activate(y, p.act, p.alpha);
}

__device__ __forceinline__ void store_one(const Params& p, size_t idx, float y) {
  store_out(p.out, p.out_kind, idx, y, p.inv_out_scale);
}

// Four neighbouring outputs out[m, n .. n+3], n % 4 == 0, all in range;
// s and b hold scale[n .. n+3] and bias[n .. n+3].
__device__ __forceinline__ void epilogue_vec4(const Params& p, int m, int n,
                                              const int4 acc, const float4 s,
                                              const float4 b) {
  const size_t idx = static_cast<size_t>(m) * p.N + n;
  float y[4] = {__fmul_rn(static_cast<float>(acc.x), s.x),
                __fmul_rn(static_cast<float>(acc.y), s.y),
                __fmul_rn(static_cast<float>(acc.z), s.z),
                __fmul_rn(static_cast<float>(acc.w), s.w)};
  if (p.bias) {
    y[0] = __fadd_rn(y[0], b.x);
    y[1] = __fadd_rn(y[1], b.y);
    y[2] = __fadd_rn(y[2], b.z);
    y[3] = __fadd_rn(y[3], b.w);
  }
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  bool has_res = true;
  if (p.res_kind == RES_F32) {
    const float4 v = *reinterpret_cast<const float4*>(
        static_cast<const float*>(p.res) + idx);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if (p.res_kind == RES_BF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.res) + idx);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = __bfloat162float(h[j]);
  } else if (p.res_kind == RES_S8) {
    const char4 v = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(p.res) + idx);
    r[0] = __fmul_rn(static_cast<float>(v.x), p.res_scale);
    r[1] = __fmul_rn(static_cast<float>(v.y), p.res_scale);
    r[2] = __fmul_rn(static_cast<float>(v.z), p.res_scale);
    r[3] = __fmul_rn(static_cast<float>(v.w), p.res_scale);
  } else {
    has_res = false;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (has_res) y[j] = __fadd_rn(y[j], r[j]);
    y[j] = activate(y[j], p.act, p.alpha);
  }
  if (p.out_kind == OUT_S8) {
    char4 q;
    q.x = requant(y[0], p.inv_out_scale);
    q.y = requant(y[1], p.inv_out_scale);
    q.z = requant(y[2], p.inv_out_scale);
    q.w = requant(y[3], p.inv_out_scale);
    *reinterpret_cast<char4*>(static_cast<int8_t*>(p.out) + idx) = q;
  } else if (p.out_kind == OUT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + idx) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
    __nv_bfloat16 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(y[j]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
        *reinterpret_cast<const uint2*>(h);
  }
}

namespace igemm {

constexpr int BM = 128;       // rows of a block tile: two 64-row warpgroups
constexpr int BK = 128;       // K bytes of a ring stage: one swizzle row
constexpr int THREADS = 256;
constexpr int MAX_SPLITS = 8;  // portable cluster size

enum AMode { A_VEC16 = 0, A_VEC4 = 1, A_BYTE = 2 };

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int STAGE = (BM + BN) * BK;  // bytes: A tile, then B tile
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LDC = BN + 4;  // int32 row stride of the staged tile
  static constexpr int SMEM = RING + 1024;  // + slack to align the ring to 1 KB
  static_assert(BM * LDC * 4 <= RING, "the int32 tile fits the ring");
};

// byte offset of 16-byte piece c of row r in a 128-byte swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

// 4 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// 8-row groups 1024 bytes apart (SBO), layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k32(int (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (BN == 128) wgmma_n128(d, da, db);
  else wgmma_n64(d, da, db);
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The A loader's view of one row: a GEMM row pointer (null past M) or a
// conv pixel.
template <bool CONV>
struct ARow {
  const int8_t* ptr;
  int oh, ow;
};

// Bytes [k, k + n) of conv row r (n = 4 or 1, inside one tap), or null
// where they are halo, past M or past K.
template <bool CONV>
__device__ __forceinline__ const int8_t* a_src(const Params& p,
                                               const ARow<CONV>& r, int k) {
  if (k >= p.K || r.ptr == nullptr) return nullptr;
  if (!CONV) return r.ptr + k;
  const int tap = k / p.C;
  const int c = k - tap * p.C;
  const int dy = tap / 3, dx = tap - 3 * dy;
  const int ih = r.oh + dy - 1, iw = r.ow + dx - 1;
  if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return nullptr;
  return r.ptr + ((dy - 1) * p.W + (dx - 1)) * p.C + c;
}

// The 16-byte piece at k of row r into shared memory at dst.
template <bool CONV, int AM>
__device__ __forceinline__ void load_a_piece(const Params& p,
                                             const ARow<CONV>& r, int k,
                                             int8_t* dst) {
  if (AM == A_VEC16) {
    const int8_t* s = a_src<CONV>(p, r, k);
    cp16(dst, s ? s : p.a, s != nullptr);
  } else if (AM == A_VEC4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* s = a_src<CONV>(p, r, k + 4 * j);
      cp4(dst + 4 * j, s ? s : p.a, s != nullptr);
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* s = a_src<CONV>(p, r, k + 4 * i + j);
        if (s) word |= static_cast<uint32_t>(static_cast<uint8_t>(*s)) << (8 * j);
      }
      w[i] = word;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The epilogue of the common case (int8 out; no or an int8 residual; no
// activation, relu or relu6; with or without bias), specialized at compile
// time, so that no element takes a branch on the epilogue's kind: a lane
// finishes eight neighbouring columns of each of its rows, from two 16-byte
// reads of the staged int32 tile, an 8-byte residual load (all of the
// lane's rows' loads issued before any row is finished, so their latency
// is paid once) and one 8-byte store.  The float steps are dequant's, in
// its order.
template <int BN, int LDC, int ACT, bool RES, bool BIAS>
__device__ __forceinline__ void epilogue_fast(const Params& p, const int* stage,
                                              int m0, int n0, int warp,
                                              int lane) {
  constexpr int LPR = BN / 8, RPW = 32 / LPR;  // lanes a row, rows a warp pass
  const int c = 8 * (lane % LPR);
  const int n = n0 + c;
  if (n >= p.N) return;  // N % 8 == 0: n .. n+7 all in range otherwise
  float sc[8], bi[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(p.scale + n + 4 * h);
    sc[4 * h] = v.x; sc[4 * h + 1] = v.y; sc[4 * h + 2] = v.z; sc[4 * h + 3] = v.w;
    if (BIAS) {
      const float4 w = *reinterpret_cast<const float4*>(p.bias + n + 4 * h);
      bi[4 * h] = w.x; bi[4 * h + 1] = w.y; bi[4 * h + 2] = w.z; bi[4 * h + 3] = w.w;
    }
  }
  const int8_t* res = static_cast<const int8_t*>(p.res);
  int8_t* out = static_cast<int8_t*>(p.out);
  // the lane's rows r0 + i STEP; all their residual loads in flight at once
  constexpr int STEP = 8 * RPW, ITERS = BM / STEP;
  const int r0 = warp * RPW + lane / LPR;
  uint2 rv[ITERS];
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int m = m0 + r0 + i * STEP;
    rv[i] = make_uint2(0u, 0u);
    if (RES && m < p.M)
      rv[i] = *reinterpret_cast<const uint2*>(res + static_cast<size_t>(m) * p.N + n);
  }
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int r = r0 + i * STEP, m = m0 + r;
    if (m >= p.M) break;
    const size_t idx = static_cast<size_t>(m) * p.N + n;
    const int4 a0 = *reinterpret_cast<const int4*>(stage + r * LDC + c);
    const int4 a1 = *reinterpret_cast<const int4*>(stage + r * LDC + c + 4);
    const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = __fmul_rn(static_cast<float>(av[j]), sc[j]);
      if (BIAS) y = __fadd_rn(y, bi[j]);
      if (RES) {
        const uint32_t word = j < 4 ? rv[i].x : rv[i].y;
        const float rj = static_cast<float>(
            static_cast<int8_t>((word >> (8 * (j % 4))) & 0xffu));
        y = __fadd_rn(y, __fmul_rn(rj, p.res_scale));
      }
      if (ACT == ACT_RELU) y = fmaxf(y, 0.0f);
      if (ACT == ACT_RELU6) y = fminf(fmaxf(y, 0.0f), 6.0f);
      w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      requant(y, p.inv_out_scale))) << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(out + idx) = make_uint2(w[0], w[1]);
  }
}

template <int BN, int LDC, int ACT>
__device__ __forceinline__ void epilogue_fast_act(const Params& p,
                                                  const int* stage, int m0,
                                                  int n0, int warp, int lane) {
  if (p.res_kind == RES_S8) {
    if (p.bias) epilogue_fast<BN, LDC, ACT, true, true>(p, stage, m0, n0, warp, lane);
    else epilogue_fast<BN, LDC, ACT, true, false>(p, stage, m0, n0, warp, lane);
  } else {
    if (p.bias) epilogue_fast<BN, LDC, ACT, false, true>(p, stage, m0, n0, warp, lane);
    else epilogue_fast<BN, LDC, ACT, false, false>(p, stage, m0, n0, warp, lane);
  }
}

// Block tile (blockIdx.y, blockIdx.x) of BM x BN outputs over the K tiles
// of split blockIdx.z (a cluster of gridDim.z blocks when it is > 1).
template <bool CONV, int AM, int BN>
__global__ void __launch_bounds__(THREADS, 2) igemm_s8(const Params p) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = gridDim.z;
  const int nk_all = (p.K + BK - 1) / BK;
  const int kt0 = static_cast<int>(static_cast<long long>(blockIdx.z) * nk_all / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * nk_all / splits);
  const int nkb = kt1 - kt0;

  // loader: piece column pc of rows lr + 32 i of the A tile and the B tile
  const int pc = tid & 7, lr = tid >> 3;
  ARow<CONV> arow[BM / 32];
#pragma unroll
  for (int i = 0; i < BM / 32; ++i) {
    const int m = m0 + lr + 32 * i;
    arow[i].ptr = nullptr;
    arow[i].oh = arow[i].ow = 0;
    if (m < p.M) {
      if (CONV) {
        const int hw = p.H * p.W;
        const int img = m / hw, rem = m - img * hw;
        arow[i].oh = rem / p.W;
        arow[i].ow = rem - arow[i].oh * p.W;
        arow[i].ptr = p.a + static_cast<size_t>(m) * p.C;
      } else {
        arow[i].ptr = p.a + static_cast<size_t>(m) * p.K;
      }
    }
  }

  // K tile kt0 + j into ring stage j % STAGES
  auto issue = [&](int j) {
    int8_t* sa = ring + (j % STAGES) * T::STAGE;
    int8_t* sb = sa + BM * BK;
    const int k = (kt0 + j) * BK + 16 * pc;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i)
      load_a_piece<CONV, AM>(p, arow[i], k, sa + swz(lr + 32 * i, pc));
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int n = n0 + lr + 32 * i;
      const bool ok = n < p.N && k < p.ldb;
      cp16(sb + swz(lr + 32 * i, pc),
           ok ? p.b + static_cast<size_t>(n) * p.ldb + k : p.b, ok);
    }
  };

  // accumulators: the warpgroup's m64nBN fragment
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkb) issue(s);
    cp_commit();
  }
  const int wg = warp >> 2;  // warpgroup: rows 64 wg .. 64 wg + 63
  for (int j = 0; j < nkb; ++j) {
    // stage j is in (this thread's copies), visible to the async proxy
    // that wgmma reads through; after the barrier, everyone's is, and
    // every warp is done with stage j - 1, whose slot is refilled now
    cp_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (j + STAGES - 1 < nkb) issue(j + STAGES - 1);
    cp_commit();
    const int8_t* sa = ring + (j % STAGES) * T::STAGE;
    const int8_t* sb = sa + BM * BK;
    const uint32_t a_addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(sa + wg * 64 * BK));
    const uint32_t b_addr = static_cast<uint32_t>(__cvta_generic_to_shared(sb));
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      wgmma_k32<BN>(acc, desc_sw128(a_addr + 32 * ks), desc_sw128(b_addr + 32 * ks));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for the int32 tile

  // int32 tile -> shared [BM][LDC]: the wgmma fragment gives a thread rows
  // (g, g + 8) of its warp's 16-row slab and columns (2 tig, 2 tig + 1) of
  // each 8-column block.
  int* stage = reinterpret_cast<int*>(ring);
  {
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(stage + (r0 + 8 * h) * T::LDC + nb * 8 + 2 * tig) =
            make_int2(acc[4 * nb + 2 * h], acc[4 * nb + 2 * h + 1]);
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();
  else
    __syncthreads();

  if constexpr (AM == A_VEC16) {  // the path's shapes: the specialized epilogue
    if (splits == 1 && p.fast_epi) {
      if (p.act == ACT_RELU)
        epilogue_fast_act<BN, T::LDC, ACT_RELU>(p, stage, m0, n0, warp, lane);
      else if (p.act == ACT_RELU6)
        epilogue_fast_act<BN, T::LDC, ACT_RELU6>(p, stage, m0, n0, warp, lane);
      else
        epilogue_fast_act<BN, T::LDC, ACT_NONE>(p, stage, m0, n0, warp, lane);
      return;
    }
  }

  // Epilogue: split s of the cluster finishes rows [BM s / S, BM (s + 1) /
  // S) of the tile, summing the S partial tiles.  LPR lanes share a row,
  // each with four neighbouring columns; scale and bias are loaded once.
  constexpr int LPR = BN / 4, RPW = 32 / LPR;
  const int rank = splits > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int r_lo = rank * BM / splits, r_hi = (rank + 1) * BM / splits;
  const int c = 4 * (lane % LPR);
  const int n = n0 + c;
  float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.vec_epi && n < p.N) {  // N % 4 == 0, so n .. n+3 are all in range
    s4 = *reinterpret_cast<const float4*>(p.scale + n);
    if (p.bias) b4 = *reinterpret_cast<const float4*>(p.bias + n);
  }
  if (n < p.N) {
    // Not unrolled: an unrolled epilogue loop made ptxas fall to 48-64
    // registers with ~1 KB of spills and the kernels 3-8x slower (PR 1).
#pragma unroll 1
    for (int r = r_lo + warp * RPW + lane / LPR; r < r_hi; r += 8 * RPW) {
      const int m = m0 + r;
      if (m >= p.M) break;
      int4 a4 = *reinterpret_cast<const int4*>(stage + r * T::LDC + c);
      if (splits > 1) {
        a4 = make_int4(0, 0, 0, 0);
        for (int s = 0; s < splits; ++s) {
          const int4 v = *reinterpret_cast<const int4*>(
              cluster.map_shared_rank(stage, s) + r * T::LDC + c);
          a4.x += v.x; a4.y += v.y; a4.z += v.z; a4.w += v.w;
        }
      }
      if (p.vec_epi) {
        epilogue_vec4(p, m, n, a4, s4, b4);
      } else {
        const int av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j >= p.N) break;
          const size_t idx = static_cast<size_t>(m) * p.N + n + j;
          store_one(p, idx, dequant(p, idx, n + j, av[j], p.scale[n + j],
                                    p.bias ? p.bias[n + j] : 0.0f));
        }
      }
    }
  }
  if (splits > 1) cluster.sync();  // no block leaves while another reads it
}

template <bool CONV, int AM, int BN>
int launch_tile(const Params& p, int splits, cudaStream_t stream) {
  constexpr auto kernel = igemm_s8<CONV, AM, BN>;
  cudaError_t e = allow_smem<kernel>(Tile<BN>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Tile<BN>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool CONV, int BN>
int launch_mode(const Params& p, int amode, int splits, cudaStream_t stream) {
  if (amode == A_VEC16) return launch_tile<CONV, A_VEC16, BN>(p, splits, stream);
  if (amode == A_VEC4) return launch_tile<CONV, A_VEC4, BN>(p, splits, stream);
  return launch_tile<CONV, A_BYTE, BN>(p, splits, stream);
}

// The tile configuration a launch takes: the N width of the block tile
// (128, or 64 where N <= 64 or 128-wide tiles would leave SMs idle) and the
// number of K splits (1, or enough to give every SM a block, at most one
// cluster of 8 and one K tile a split).
struct Config {
  int bn, splits;
};

inline Config pick_config(int M, int N, int K) {
  const int sms = sm_count();
  const long long mt = (M + BM - 1) / BM;
  Config c{128, 1};
  if (N <= 64 || mt * ((N + 127) / 128) < sms) c.bn = 64;
  const long long blocks = mt * ((N + c.bn - 1) / c.bn);
  const int nk = (K + BK - 1) / BK;
  if (blocks < sms) {
    long long s = (sms + blocks - 1) / blocks;
    s = s > MAX_SPLITS ? MAX_SPLITS : s;
    c.splits = static_cast<int>(s > nk ? (nk > 0 ? nk : 1) : s);
  }
  return c;
}

}  // namespace igemm

// 16-byte alignment of every pointer the vector epilogue touches.
inline bool epilogue_vectorizable(const Params& p) {
  auto al = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return p.N % 4 == 0 && al(p.scale) && al(p.bias) && al(p.res) && al(p.out);
}

// How the A loader reads: 16-byte pieces where every piece of a row lies
// in one tap / inside K and is 16-byte aligned (`unit` = C for the conv, K
// for the GEMM), 4-byte pieces where 4 does, bytes otherwise.
inline int a_mode(const void* a, int unit) {
  const uintptr_t q = reinterpret_cast<uintptr_t>(a);
  if (unit % 16 == 0 && q % 16 == 0) return igemm::A_VEC16;
  if (unit % 4 == 0 && q % 4 == 0) return igemm::A_VEC4;
  return igemm::A_BYTE;
}

// Returns a cudaError_t.
template <bool CONV>
inline int launch_igemm(Params p, cudaStream_t stream) {
  if (p.ldb % 16 != 0 || p.ldb < p.K ||
      reinterpret_cast<uintptr_t>(p.b) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec_epi = epilogue_vectorizable(p) ? 1 : 0;
  p.fast_epi = p.vec_epi && p.N % 8 == 0 && p.out_kind == OUT_S8 &&
               (p.res_kind == RES_NONE || p.res_kind == RES_S8) &&
               (p.act == ACT_NONE || p.act == ACT_RELU || p.act == ACT_RELU6);
  const int amode = a_mode(p.a, CONV ? p.C : p.K);
  const igemm::Config c = igemm::pick_config(p.M, p.N, p.K);
  return c.bn == 128
             ? igemm::launch_mode<CONV, 128>(p, amode, c.splits, stream)
             : igemm::launch_mode<CONV, 64>(p, amode, c.splits, stream);
}

}  // namespace ak
