// Tiled int8 GEMM with a fused dequant / bias / residual / activation /
// requant epilogue, shared by matmul_int8.cu and conv3x3_int8.cu.
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]                (int32, on chip)
//   y = act(float(acc) * scale[n] + bias[n] + residual[m, n])
//   out = int8(clip(rint(y * inv_out_scale), -127, 127))  or  f32 / bf16 y
//
// A is either a row-major int8 matrix [M, K] (CONV = false) or, for the
// implicit-GEMM 3x3 s1 p1 convolution (CONV = true), the virtual im2col
// matrix of an NHWC int8 image [M / (H * W), H, W, C] with K = 9 * C in
// (dy, dx, c) order; the halo is zero-filled by bounds checks while the tile
// is loaded, never by a padded copy.  B is row-major int8 [K, N] (an HWIO
// weight reshaped to [9 * C, O] for the conv).
//
// Block: 256 threads, a 128 x 128 output tile, K in steps of 64.  Each of
// the 8 warps owns a 64 x 32 sub-tile as 4 x 4 mma.sync.m16n8k32 s8 tiles
// with int32 accumulators in registers.  Tiles are double-buffered in shared
// memory: the next tile's global loads are issued before the current tile's
// mma work and stored after it.  B is transposed to [n][k] while it is
// stored (a 4 x 4 byte transpose in registers), so both operands' fragments
// are single 32-bit shared loads.
//
// Epilogue: the mma fragments scatter each thread's outputs over 8 rows, so
// the accumulators go through shared memory (the operand buffers, free by
// then) in two halves of 64 rows.  Each thread then finishes the same four
// neighbouring columns in eight rows: scale and bias are loaded once, as
// 16 bytes each, and each row takes a 4-, 8- or 16-byte residual load and a
// 4-, 8- or 16-byte store, a warp covering 128 contiguous columns.  The int32
// tile never reaches device memory.  Ragged edges take a one-element path.
//
// Numerics follow the Pallas kernels bit for bit: every epilogue operation
// is a separately rounded IEEE float op (__fmul_rn / __fadd_rn, so nvcc
// cannot contract them into FMAs), rounding is half-to-even (rintf), and
// the requant multiplies by the reciprocal passed in by the caller.  The
// element steps (activate, requant, store_out) are in int8_epilogue.cuh.
#pragma once

#include "int8_epilogue.cuh"

namespace ak {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
// shared row stride in bytes: 80 = 20 words makes the fragment reads of the
// 8 row groups of a warp fall on distinct banks
constexpr int LDS = BK + 16;
constexpr int THREADS = 256;
// int32 row stride of the epilogue's staging tile; 16-byte aligned rows
constexpr int LDC = BN + 4;
static_assert(64 * LDC * 4 <= 2 * (BM + BN) * LDS, "staging tile too big");

enum ResKind { RES_NONE = 0, RES_F32 = 1, RES_BF16 = 2, RES_S8 = 3 };

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* scale;  // [N], already in_scale * w_scale
  const float* bias;   // [N] or null
  const void* res;     // [M, N] or null
  void* out;           // [M, N]
  int M, N, K;
  int H, W, C;         // CONV only
  int act;
  float alpha;
  int res_kind;
  float res_scale;     // RES_S8: residual = float(r) * res_scale
  int out_kind;
  float inv_out_scale; // OUT_S8
  int vec_epi;         // N % 4 == 0 and every epilogue pointer 16-byte aligned
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One A row of the conv's virtual im2col matrix: output pixel (img, oh, ow).
struct ConvRow {
  int img, oh, ow;
  bool ok;
};

// A[m, k] of the virtual matrix, 0 outside the image (the conv halo).
template <bool CONV>
__device__ __forceinline__ int8_t load_a_byte(const Params& p, int m,
                                              const ConvRow& r, int k) {
  if (k >= p.K) return 0;
  if (!CONV) return p.a[static_cast<size_t>(m) * p.K + k];
  const int tap = k / p.C;
  const int c = k - tap * p.C;
  const int dy = tap / 3;
  const int ih = r.oh + dy - 1;
  const int iw = r.ow + (tap - 3 * dy) - 1;
  if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return 0;
  return p.a[((static_cast<size_t>(r.img) * p.H + ih) * p.W + iw) * p.C + c];
}

// 16 consecutive k of one A row.  VEC: K % 16 == 0 (GEMM) or C % 16 == 0
// (conv) and a 16-byte aligned base, so the 16 bytes are one aligned load
// that lies inside one tap.
template <bool CONV, bool VEC>
__device__ __forceinline__ uint4 load_a_chunk(const Params& p, int m,
                                              const ConvRow& r, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!r.ok) return v;
  if (VEC) {
    if (k >= p.K) return v;
    if (!CONV) return *reinterpret_cast<const uint4*>(
        p.a + static_cast<size_t>(m) * p.K + k);
    const int tap = k / p.C;
    const int c = k - tap * p.C;
    const int dy = tap / 3;
    const int ih = r.oh + dy - 1;
    const int iw = r.ow + (tap - 3 * dy) - 1;
    if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return v;
    return *reinterpret_cast<const uint4*>(
        p.a + ((static_cast<size_t>(r.img) * p.H + ih) * p.W + iw) * p.C + c);
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t byte =
          static_cast<uint8_t>(load_a_byte<CONV>(p, m, r, k + 4 * i + j));
      word |= static_cast<uint32_t>(byte) << (8 * j);
    }
    w[i] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// B[k .. k+3][n .. n+3] transposed to four words, word j = B[k..k+3][n+j].
// VEC: N % 4 == 0 and a 4-byte aligned base.
template <bool VEC>
__device__ __forceinline__ void load_b_block(const Params& p, int k, int n,
                                             uint32_t (&v)[4]) {
  uint32_t w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kk = k + r;
    uint32_t word = 0;
    if (kk < p.K) {
      const int8_t* row = p.b + static_cast<size_t>(kk) * p.N;
      if (VEC) {
        if (n < p.N) word = *reinterpret_cast<const uint32_t*>(row + n);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < p.N)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(row[n + j]))
                    << (8 * j);
        }
      }
    }
    w[r] = word;
  }
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(t0, t2, 0x5410);
  v[1] = __byte_perm(t0, t2, 0x7632);
  v[2] = __byte_perm(t1, t3, 0x5410);
  v[3] = __byte_perm(t1, t3, 0x7632);
}

// Which 4 x 4 block of the 64 x 128 B tile item `idx` (0..511) loads: four
// neighbouring lanes take four k-blocks and eight lanes eight n-blocks, so
// each k row is read as 32 contiguous bytes.
__device__ __forceinline__ void b_block_of(int idx, int& kq, int& nq) {
  kq = (idx & 3) + 4 * ((idx >> 5) & 3);
  nq = ((idx >> 2) & 7) + 8 * (idx >> 7);
}

// Global -> registers: this thread's two A chunks and two B blocks of the
// K tile starting at k0.
template <bool CONV, bool VEC_A, bool VEC_B>
__device__ __forceinline__ void load_tile(const Params& p, const int (&a_m)[2],
                                          const ConvRow (&a_r)[2], int tid,
                                          int n0, int k0, uint4 (&a_reg)[2],
                                          uint32_t (&b_reg)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a_reg[i] = load_a_chunk<CONV, VEC_A>(p, a_m[i], a_r[i],
                                         k0 + (tid & 3) * 16);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int kq, nq;
    b_block_of(tid + THREADS * i, kq, nq);
    load_b_block<VEC_B>(p, k0 + kq * 4, n0 + nq * 4, b_reg[i]);
  }
}

// Registers -> shared buffer: A rows as loaded, B transposed to [n][k].
__device__ __forceinline__ void store_tile(int8_t* buf, int tid,
                                           const uint4 (&a_reg)[2],
                                           const uint32_t (&b_reg)[2][4]) {
  int8_t* sA = buf;
  int8_t* sB = buf + BM * LDS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + 64 * i;
    *reinterpret_cast<uint4*>(sA + row * LDS + (tid & 3) * 16) = a_reg[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int kq, nq;
    b_block_of(tid + THREADS * i, kq, nq);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(sB + (nq * 4 + j) * LDS + kq * 4) =
          b_reg[i][j];
  }
}

template <bool CONV, bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS) igemm_s8_kernel(const Params p) {
  __shared__ __align__(16) int8_t smem[2][(BM + BN) * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // mma group id
  const int tig = lane & 3;   // thread in group
  const int wm = warp >> 2;   // warp row: 64 rows each
  const int wn = warp & 3;    // warp col: 32 cols each
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A loader: rows (tid / 4) and (tid / 4 + 64), 16-byte chunk tid % 4
  int a_m[2];
  ConvRow a_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    a_m[i] = m;
    a_r[i].ok = m < p.M;
    a_r[i].img = a_r[i].oh = a_r[i].ow = 0;
    if (CONV && a_r[i].ok) {
      const int hw = p.H * p.W;
      const int img = m / hw;
      const int rem = m - img * hw;
      a_r[i].img = img;
      a_r[i].oh = rem / p.W;
      a_r[i].ow = rem - a_r[i].oh * p.W;
    }
  }

  uint4 a_reg[2];
  uint32_t b_reg[2][4];

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (p.K + BK - 1) / BK;
  load_tile<CONV, VEC_A, VEC_B>(p, a_m, a_r, tid, n0, 0, a_reg, b_reg);
  store_tile(smem[0], tid, a_reg, b_reg);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more)
      load_tile<CONV, VEC_A, VEC_B>(p, a_m, a_r, tid, n0, (kt + 1) * BK,
                                    a_reg, b_reg);
    const int8_t* sA = smem[kt & 1];
    const int8_t* sB = smem[kt & 1] + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + g;
        const int8_t* r0 = sA + row * LDS + ks + tig * 4;
        const int8_t* r8 = r0 + 8 * LDS;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + g;
        const int8_t* c0 = sB + col * LDS + ks + tig * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    if (more) store_tile(smem[(kt + 1) & 1], tid, a_reg, b_reg);
    __syncthreads();
  }

  // Epilogue, 64 rows at a time through shared memory (see the header).
  // Lane l of a warp keeps the four columns 4l .. 4l+3 of the tile for every
  // row it finishes, so it loads their scale and bias once, and each warp
  // finishes whole rows, eight rows apart.
  static_assert(BN == 4 * 32 && THREADS % 32 == 0, "epilogue layout");
  constexpr int ROWS_PER_PASS = THREADS / 32;
  int* stage = reinterpret_cast<int*>(&smem[0][0]);
  const int c = lane * 4;
  const int n = n0 + c;
  float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.vec_epi && n < p.N) {  // N % 4 == 0, so n .. n+3 are all in range
    s4 = *reinterpret_cast<const float4*>(p.scale + n);
    if (p.bias) b4 = *reinterpret_cast<const float4*>(p.bias + n);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (wm == half) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            *reinterpret_cast<int2*>(
                stage + (mt * 16 + g + 4 * e) * LDC + wn * 32 + nt * 8 +
                tig * 2) = make_int2(acc[mt][nt][e], acc[mt][nt][e + 1]);
    }
    __syncthreads();
    if (n < p.N) {
      // Not unrolled: unrolling this loop makes ptxas fall to 48-64
      // registers with ~1 KB of spills and the kernels 3-8x slower.
#pragma unroll 1
      for (int i = 0; i < 64 / ROWS_PER_PASS; ++i) {
        const int r = warp + ROWS_PER_PASS * i;
        const int m = m0 + half * 64 + r;
        if (m >= p.M) break;
        const int4 a4 = *reinterpret_cast<const int4*>(stage + r * LDC + c);
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
    __syncthreads();
  }
}

// 16-byte alignment of every pointer the vector epilogue touches.
inline bool epilogue_vectorizable(const Params& p) {
  auto al = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return p.N % 4 == 0 && al(p.scale) && al(p.bias) && al(p.res) && al(p.out);
}

template <bool CONV>
inline int launch_igemm(Params p, bool vec_a, bool vec_b, cudaStream_t stream) {
  p.vec_epi = epilogue_vectorizable(p) ? 1 : 0;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (vec_a && vec_b)
    igemm_s8_kernel<CONV, true, true><<<grid, THREADS, 0, stream>>>(p);
  else if (vec_a)
    igemm_s8_kernel<CONV, true, false><<<grid, THREADS, 0, stream>>>(p);
  else if (vec_b)
    igemm_s8_kernel<CONV, false, true><<<grid, THREADS, 0, stream>>>(p);
  else
    igemm_s8_kernel<CONV, false, false><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ak
