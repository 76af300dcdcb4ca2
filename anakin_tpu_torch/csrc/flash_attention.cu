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
// contiguous; bf16 or float32.  Head dims D: 32, 64, 80, 96, 128 and 256
// in bf16 (256 with one 16-row tile a warp and 32-key tiles, for
// registers), the same but 256 in float32 (its 16 x 256 float32 q tile and
// accumulator a warp would not fit beside the split).
//
// Replaces the TPU kernel anakin_tpu/kernels/flash_attention.py::
// flash_attention, whose grid walks (batch * head, q tile, kv tile) with the
// kv axis sequential and the running max, sum and accumulator in VMEM.
// Here one block owns a tile of query rows and loops over the kv tiles
// itself, keeping the running max, sum and output accumulator in
// registers; a causal block stops at its last row's diagonal tile.  A
// ragged Sq or Sk is masked in the kernel (columns past Sk weigh exactly
// 0), so nothing is padded.
//
// What bounds it on an H100: the function reads q, k, v once and writes
// out once, and does 4 * D operations per unmasked (row, col) pair (6 * D
// here, see P below).  At the LLM prefill's [8, 16, 512, 128] with 8 kv
// heads that is about 50 MB and 8.6 G operations: bytes (15 us at 3.35
// TB/s) bound it over the bf16 tensor-core rate (8.7 us; 13 us at 6 * D).
// At S = 2048 the operations bound it.  So the kernel has to keep the
// tensor cores fed from shared memory and spend few other instructions per
// score.
//
// bf16 (flash_bf16): 4 warps, 128 query rows a block, each warp two tiles
// of 16 rows (one where the grid would hold fewer than two blocks an SM;
// then 64 rows a block), kv tiles of 32 keys (64 with one row tile).
//   * Each K and V fragment a warp reads feeds both of its row tiles, which
//     halves the shared-memory reads per mma and gives each warp two
//     independent chains of mma and softmax work.
//   * Grouped heads share a block: when H / Hkv is even, the block holds
//     the rows of two query heads of one kv head, so each K/V tile leaves
//     L2 once for 128 rows (else 128 rows of one head).
//   * q, then the K/V tiles, stream through cp.async into dynamic shared
//     memory, the next tile in flight during this one's mma, one block
//     barrier per tile.  Rows are padded by 16 bytes, so ldmatrix reads 8
//     rows from 8 distinct bank groups.
//   * Fragments come from ldmatrix.x4 (q and K, for S = q k^T) and
//     ldmatrix.x4.trans (V, for P V).
//   * Scores are scaled by sm_scale * log2(e) and exponentiated with one
//     ex2.approx each.  Only a tile that crosses a warp's diagonal, runs past
//     Sk, or has segment ids is masked; the others take one FFMA and one
//     ex2 per score.  The accumulator is rescaled only when a row's max
//     moved.
//   * Causal q tiles are scheduled heaviest first (the last rows visit the
//     most kv tiles), so the short blocks fill the tail.
// What is left: mma.sync with every fragment through registers keeps it
// slower than PyTorch's fused attention at the prefill shape (PERF.md);
// wgmma with K and V as shared-memory operands is the next step.
// S = q k^T is mma.sync m16n8k16 with float32 accumulation: the bf16
// products are exact, so S equals the Pallas kernel's float32 dot up to the
// order of the sums.  P @ V: P is float32 in the C fragments; it goes into
// the A operand as two bf16 halves, hi = bf16(P) and lo = bf16(P - hi), with
// two mma each, so P keeps about 16 bits (relative error <= 2^-17) against
// the 8 of a single bf16 rounding, as the Pallas kernel's float32 P does.
// The output's relative error stays far below its own bf16 rounding (2^-9):
// stated tolerance against the plain version, |diff| <= 2^-7 |want| + 3e-5
// max|v|, one bf16 ulp.
//
// float32 (flash_tf32): float32 operands on the tensor cores, kept float32
// by a split.  Each operand x becomes hi, x rounded to TF32 (11 significant
// bits, nearest with ties away from zero, as cvt.rna), and lo = x - hi,
// which the MMA reads truncated to TF32, so hi + lo keeps about 22 bits;
// each product is three mma.sync m16n8k8 TF32 products into one float32
// accumulator: lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, about 2^-22 of
// the product, is dropped).  Both q k^T and P V are split so: one TF32 pass
// misses the tolerance below 3-11 times over, the split stays 100 times
// inside it (tests/test_torch_flash_split.py emulates both; on the card the
// error is a few times the emulation's, which leaves out the tensor cores'
// own float32 accumulation, and stays within 5% of the tolerance).  The
// block is flash_bf16's: 4 warps of one or two 16-row tiles (the launch
// picks as for bf16), two query heads a block where a kv head serves an
// even number, causal q tiles heaviest first, a 2-stage cp.async K/V ring,
// masks only on diagonal, ragged or segment tiles, ex2 on scores in log2
// units, the accumulator rescaled only when a row's max moved.  kv tiles
// of 32 keys (16 with two row tiles at D > 64, for shared memory: two
// blocks an SM).
//   * Rows are float32, padded to D + 4: ldmatrix on 32-bit words hands
//     each lane word t of row g of an 8 x 4 matrix, the TF32 fragment, so
//     q and K fragments come from ldmatrix.x4 (8 rows at an odd number of
//     16-byte units apart: no bank conflict), and V's, read across rows
//     for P V's B operand, from 32-bit loads on distinct banks.
//   * P V's k index is permuted (k t is key 2t, k t+4 key 2t+1), so P's A
//     fragment is the thread's own S fragment: no shuffle.
//   * q is split from shared memory on each kv tile (its hi / lo for the
//     whole loop would take 128 registers a row tile at D = 128).
//   * The split is integer and float work (split_tf32, tf32_mma.cuh), the
//     most of the loop's instructions beside the MMAs: every warp splits
//     the whole K and V tile it reads.
// What bounds it: 3 x 4 D operations an unmasked (row, col) pair at the
// TF32 tensor-core rate (495 TFLOP/s); at the path's shapes (S 512 and
// 2048, D 128) these, not the bytes.
// Stated tolerance against the plain version: |diff| <= 3e-5 max|v|
// (float32 sums in another order and the split's 2^-21 of each product).
// Single-pass TF32 is not this route: it is not float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

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
constexpr int FW = 4;             // warps per block
constexpr int FSTAGES = 2;        // kv tiles in the ring
// MQ: 16-row tiles of q per warp (2, or 1 where the grid would be short,
// and always for D = 256); keys per kv tile: 32 with two row tiles or D =
// 256, 64 otherwise (registers: D = 256 holds a 16 x 256 float32
// accumulator a warp)
__host__ __device__ constexpr int kv_block(int d, int mq) {
  return mq == 2 || d > 128 ? 32 : 64;
}
// query rows per block, over 1 or 2 heads
__host__ __device__ constexpr int block_rows(int mq) { return 16 * mq * FW; }
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int MQ>
constexpr int flash_smem() {
  return FSTAGES * (2 * kv_block(D, MQ) * (D + 8) * 2 + kv_block(D, MQ) * 4) +
         FW * 16 * MQ * (D + 8) * 2;
}

// 2^x: one MUFU.EX2 (relative error about 2^-22); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile of a warp's MQ row tiles, after S = q k^T: scale S into log2
// units (sm_scale * log2 e), mask it where the tile crosses the warp's
// diagonal, runs past Sk or has segment ids, update the running max m and
// sum l of this thread's rows (g and g + 8 of each row tile), turn S into P
// in place, and rescale the accumulator o where some row's max moved.
template <int D, int MQ, int FBK>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[MQ][FBK / 8][4],
                                             float (&o)[MQ][D / 8][4], float (&m)[MQ][2],
                                             float (&l)[MQ][2], int wr0, int key0, int b,
                                             const int* kseg_s) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float sc = a.sm_scale * kLog2e;
  const bool masked = (a.causal && key0 + FBK - 1 > wr0) || key0 + FBK > a.Sk ||
                      a.qseg != nullptr;
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (masked) {
      const int r0 = wr0 + 16 * mq + g;  // this thread's rows: r0, r0 + 8
      int qs[2] = {0, 0};
      if (a.qseg != nullptr) {
        if (r0 < a.Sq) qs[0] = a.qseg[(size_t)b * a.Sq + r0];
        if (r0 + 8 < a.Sq) qs[1] = a.qseg[(size_t)b * a.Sq + r0 + 8];
      }
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cit = nt * 8 + 2 * t + (e & 1);
          const int hi = e >> 1;
          s[mq][nt][e] = mask_score(a, s[mq][nt][e] * sc, r0 + 8 * hi, key0 + cit,
                                    qs[hi], kseg_s, cit);
          if (hi) mx1 = fmaxf(mx1, s[mq][nt][e]); else mx0 = fmaxf(mx0, s[mq][nt][e]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[mq][nt][0], s[mq][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mq][nt][2], s[mq][nt][3]));
      }
      mx0 *= sc;
      mx1 *= sc;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[mq][0], mx0), mn1 = fmaxf(m[mq][1], mx1);
    const float al0 = ex2(m[mq][0] - mn0), al1 = ex2(m[mq][1] - mn1);
    m[mq][0] = mn0;
    m[mq][1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FBK / 8; ++nt) {
      if (masked) {
        s[mq][nt][0] = ex2(s[mq][nt][0] - mn0);
        s[mq][nt][1] = ex2(s[mq][nt][1] - mn0);
        s[mq][nt][2] = ex2(s[mq][nt][2] - mn1);
        s[mq][nt][3] = ex2(s[mq][nt][3] - mn1);
      } else {
        s[mq][nt][0] = ex2(fmaf(s[mq][nt][0], sc, -mn0));
        s[mq][nt][1] = ex2(fmaf(s[mq][nt][1], sc, -mn0));
        s[mq][nt][2] = ex2(fmaf(s[mq][nt][2], sc, -mn1));
        s[mq][nt][3] = ex2(fmaf(s[mq][nt][3], sc, -mn1));
      }
      sum0 += s[mq][nt][0] + s[mq][nt][1];
      sum1 += s[mq][nt][2] + s[mq][nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l[mq][0] = al0 * l[mq][0] + sum0;
    l[mq][1] = al1 * l[mq][1] + sum1;
    // acc = acc * alpha, skipped where no row's max moved
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[mq][dt][0] *= al0;
        o[mq][dt][1] *= al0;
        o[mq][dt][2] *= al1;
        o[mq][dt][3] *= al1;
      }
    }
  }
}

// hpb: query heads per block (1 or 2).  Grid: (B * Hkv * (H / Hkv) / hpb,
// q tiles), the q tiles in y from the last (heaviest under causal) down.
// Each warp owns MQ tiles of 16 query rows, so every K and V fragment it
// reads from shared memory feeds MQ mma.
template <int D, int MQ>
__global__ void __launch_bounds__(FW * 32) flash_bf16(Args a, int hpb) {
  constexpr int LD = D + 8;  // bf16 row stride: 16 bytes of padding
  constexpr int WR = 16 * MQ;  // query rows per warp
  constexpr int FBK = kv_block(D, MQ);
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [FSTAGES][FBK][LD]
  __nv_bfloat16* vs = ks + FSTAGES * FBK * LD;
  __nv_bfloat16* qsm = vs + FSTAGES * FBK * LD;                  // [FW][WR][LD]
  int* ksg = reinterpret_cast<int*>(qsm + FW * WR * LD);          // [FSTAGES][FBK]

  const int R = a.H / a.Hkv, groups = R / hpb, bq = block_rows(MQ) / hpb;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int hg = blockIdx.x % groups, hk = (blockIdx.x / groups) % a.Hkv;
  const int b = blockIdx.x / (groups * a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wph = FW / hpb;  // warps per head
  const int h = hk * R + hg * hpb + warp / wph;
  const int q0 = qt * bq, wr0 = q0 + (warp % wph) * WR;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           ((size_t)b * a.H + h) * a.Sq * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            ((size_t)b * a.Hkv + hk) * a.Sk * D;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            ((size_t)b * a.Hkv + hk) * a.Sk * D;

  const int n_tiles = kv_tiles(a, q0, bq, FBK);
  const int w_tiles = wr0 < a.Sq ? kv_tiles(a, wr0, WR, FBK) : 0;

  {  // this warp's rows of q, rows past Sq zero: the oldest cp.async group
    __nv_bfloat16* qd = qsm + warp * WR * LD;
    for (int c = lane; c < WR * D / 8; c += 32) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const bool ok = wr0 + r < a.Sq;
      ak::cp16(qd + r * LD + cc, q + (ok ? (size_t)(wr0 + r) * D + cc : 0), ok);
    }
    ak::cp_commit();
  }
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int key0 = j * FBK, slot = j % FSTAGES;
      __nv_bfloat16* kd = ks + slot * FBK * LD;
      __nv_bfloat16* vd = vs + slot * FBK * LD;
      for (int c = threadIdx.x; c < FBK * D / 8; c += FW * 32) {
        const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
        const bool ok = key0 + r < a.Sk;
        const size_t off = ok ? (size_t)(key0 + r) * D + cc : 0;
        ak::cp16(kd + r * LD + cc, kg + off, ok);
        ak::cp16(vd + r * LD + cc, vg + off, ok);
      }
      if (a.kseg != nullptr && threadIdx.x < FBK)
        ksg[slot * FBK + threadIdx.x] =
            key0 + (int)threadIdx.x < a.Sk ? a.kseg[(size_t)b * a.Sk + key0 + threadIdx.x] : 0;
    }
    ak::cp_commit();
  };
#pragma unroll
  for (int j = 0; j < FSTAGES - 1; ++j) issue(j);

  float o[MQ][D / 8][4];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[mq][i][0] = o[mq][i][1] = o[mq][i][2] = o[mq][i][3] = 0.f;
  // running max (in units of sm_scale * log2 e) and sum of each row
  float m[MQ][2], l[MQ][2];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) m[mq][0] = m[mq][1] = -INFINITY, l[mq][0] = l[mq][1] = 0.f;
  const __nv_bfloat16* qw = qsm + warp * WR * LD;

  for (int j = 0; j < n_tiles; ++j) {
    ak::cp_wait<FSTAGES - 2>();
    __syncthreads();  // tile j (and q) is in; every warp is done with tile j - 1
    issue(j + FSTAGES - 1);
    if (j >= w_tiles) continue;  // past this warp's diagonal
    const int key0 = j * FBK, slot = j % FSTAGES;
    const __nv_bfloat16* kt = ks + slot * FBK * LD;
    const __nv_bfloat16* vt = vs + slot * FBK * LD;

    // S = q k^T for this warp's rows and the tile's keys; ldmatrix
    // matrices: K (keys 8nt.., d 16kk..), (.., d 16kk+8..), the same at
    // kk+1; q (rows 16mq.., d 16kk..) x4 as one A fragment.  Where D / 16
    // is odd (D = 80) the last step has no kk+1: its K matrices 2-3 repeat
    // 0-1 and go unused.
    float s[MQ][FBK / 8][4];
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) s[mq][nt][0] = s[mq][nt][1] = s[mq][nt][2] = s[mq][nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      const bool pair = kk + 1 < D / 16;
      uint32_t qa[MQ][2][4];
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (c == 0 || pair)
            ak::ldsm4(qa[mq][c], qw + (16 * mq + lane % 16) * LD + (kk + c) * 16 + lane / 16 * 8);
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) {
        uint32_t kb[4];
        ak::ldsm4(kb, kt + (nt * 8 + lane % 8) * LD + (kk + (pair ? lane / 16 : 0)) * 16 +
                          (lane / 8) % 2 * 8);
#pragma unroll
        for (int mq = 0; mq < MQ; ++mq) {
          ak::mma_bf16(s[mq][nt], qa[mq][0], kb[0], kb[1]);
          if (pair) ak::mma_bf16(s[mq][nt], qa[mq][1], kb[2], kb[3]);
        }
      }
    }

    // scale into log2 units, mask where needed, running max and sum, P
    softmax_tile<D, MQ, FBK>(a, s, o, m, l, wr0, key0, b, ksg + slot * FBK);

    // acc += P @ V, P split into bf16 hi + lo; ldmatrix.trans matrices:
    // (keys 16kk.., d 8dt..), (keys 16kk+8.., d 8dt..), the same at dt + 1
#pragma unroll
    for (int kk = 0; kk < FBK / 16; ++kk) {
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p0 = s[mq][2 * kk + (i >> 1)][(i & 1) ? 2 : 0];
          const float p1 = s[mq][2 * kk + (i >> 1)][(i & 1) ? 3 : 1];
          const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
          ph[i] = ak::pack_bf16(h0, h1);
          pl[i] = ak::pack_f32_bf16(p0 - __bfloat162float(h0),
                                    p1 - __bfloat162float(h1));
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t vb[4];
          ak::ldsm4t(vb, vt + (kk * 16 + (lane / 8) % 2 * 8 + lane % 8) * LD + (dt + lane / 16) * 8);
          ak::mma_bf16(o[mq][dt], ph, vb[0], vb[1]);
          ak::mma_bf16(o[mq][dt + 1], ph, vb[2], vb[3]);
          ak::mma_bf16(o[mq][dt], pl, vb[0], vb[1]);
          ak::mma_bf16(o[mq][dt + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }
  ak::cp_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       ((size_t)b * a.H + h) * a.Sq * D;
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wr0 + 16 * mq + g + 8 * e;
      if (r >= a.Sq) continue;
      const float li = l[mq][e] == 0.f ? 1.f : 1.f / l[mq][e];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * D + dt * 8 + 2 * t) =
            ak::pack_f32_bf16(o[mq][dt][2 * e] * li, o[mq][dt][2 * e + 1] * li);
    }
}

// ---------------------------------------------------------------- float32
// The float32 route keeps flash_bf16's block, ring and schedule; its tiles
// are float32 rows (D + 4 floats: 16 bytes of padding) and its products are
// split-TF32 mma.sync m16n8k8, three a product.
__host__ __device__ constexpr int tf32_kv_block(int d, int mq) {
  return mq == 2 && d > 64 ? 16 : 32;
}

template <int D, int MQ>
constexpr int tf32_smem() {
  return (FSTAGES * (2 * tf32_kv_block(D, MQ) * (D + 4) + tf32_kv_block(D, MQ)) +
          FW * 16 * MQ * (D + 4)) * 4;
}

// c += (ah + al)(bh + bl) but for al bl: the three-product split
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  ak::mma_tf32(c, al, bh0, bh1);
  ak::mma_tf32(c, ah, bl0, bl1);
  ak::mma_tf32(c, ah, bh0, bh1);
}

// As flash_bf16, on float32 q, k, v and out.
template <int D, int MQ>
__global__ void __launch_bounds__(FW * 32) flash_tf32(Args a, int hpb) {
  constexpr int LD = D + 4;    // float row stride: 16 bytes of padding
  constexpr int WR = 16 * MQ;  // query rows per warp
  constexpr int FBK = tf32_kv_block(D, MQ);
  extern __shared__ __align__(16) uint8_t smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [FSTAGES][FBK][LD]
  float* vs = ks + FSTAGES * FBK * LD;
  float* qsm = vs + FSTAGES * FBK * LD;        // [FW][WR][LD]
  int* ksg = reinterpret_cast<int*>(qsm + FW * WR * LD);  // [FSTAGES][FBK]

  const int R = a.H / a.Hkv, groups = R / hpb, bq = block_rows(MQ) / hpb;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int hg = blockIdx.x % groups, hk = (blockIdx.x / groups) % a.Hkv;
  const int b = blockIdx.x / (groups * a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wph = FW / hpb;  // warps per head
  const int h = hk * R + hg * hpb + warp / wph;
  const int q0 = qt * bq, wr0 = q0 + (warp % wph) * WR;
  const float* q = static_cast<const float*>(a.q) + ((size_t)b * a.H + h) * a.Sq * D;
  const float* kg = static_cast<const float*>(a.k) + ((size_t)b * a.Hkv + hk) * a.Sk * D;
  const float* vg = static_cast<const float*>(a.v) + ((size_t)b * a.Hkv + hk) * a.Sk * D;

  const int n_tiles = kv_tiles(a, q0, bq, FBK);
  const int w_tiles = wr0 < a.Sq ? kv_tiles(a, wr0, WR, FBK) : 0;

  {  // this warp's rows of q, rows past Sq zero: the oldest cp.async group
    float* qd = qsm + warp * WR * LD;
    for (int c = lane; c < WR * D / 4; c += 32) {
      const int r = c / (D / 4), cc = (c % (D / 4)) * 4;
      const bool ok = wr0 + r < a.Sq;
      ak::cp16(qd + r * LD + cc, q + (ok ? (size_t)(wr0 + r) * D + cc : 0), ok);
    }
    ak::cp_commit();
  }
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int key0 = j * FBK, slot = j % FSTAGES;
      float* kd = ks + slot * FBK * LD;
      float* vd = vs + slot * FBK * LD;
      for (int c = threadIdx.x; c < FBK * D / 4; c += FW * 32) {
        const int r = c / (D / 4), cc = (c % (D / 4)) * 4;
        const bool ok = key0 + r < a.Sk;
        const size_t off = ok ? (size_t)(key0 + r) * D + cc : 0;
        ak::cp16(kd + r * LD + cc, kg + off, ok);
        ak::cp16(vd + r * LD + cc, vg + off, ok);
      }
      if (a.kseg != nullptr && threadIdx.x < FBK)
        ksg[slot * FBK + threadIdx.x] =
            key0 + (int)threadIdx.x < a.Sk ? a.kseg[(size_t)b * a.Sk + key0 + threadIdx.x] : 0;
    }
    ak::cp_commit();
  };
#pragma unroll
  for (int j = 0; j < FSTAGES - 1; ++j) issue(j);

  float o[MQ][D / 8][4];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[mq][i][0] = o[mq][i][1] = o[mq][i][2] = o[mq][i][3] = 0.f;
  // running max (in units of sm_scale * log2 e) and sum of each row
  float m[MQ][2], l[MQ][2];
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) m[mq][0] = m[mq][1] = -INFINITY, l[mq][0] = l[mq][1] = 0.f;
  const float* qw = qsm + warp * WR * LD;

  for (int j = 0; j < n_tiles; ++j) {
    ak::cp_wait<FSTAGES - 2>();
    __syncthreads();  // tile j (and q) is in; every warp is done with tile j - 1
    issue(j + FSTAGES - 1);
    if (j >= w_tiles) continue;  // past this warp's diagonal
    const int key0 = j * FBK, slot = j % FSTAGES;
    const float* kt = ks + slot * FBK * LD;
    const float* vt = vs + slot * FBK * LD;

    // S = q k^T, 16 d a pass (two k steps of 8).  ldmatrix on 32-bit data:
    // lane (g, t) gets word t of row g of each 8 x 4 matrix, which is the
    // TF32 fragment layout.  q matrices: (rows 16mq.., d 16kp..), (rows
    // 16mq+8.., d 16kp..), the same at d + 4; K: (keys 8nt.., d 16kp + 4i..)
    // for i = 0..3, so kf[nt][2c], kf[nt][2c+1] are k step 2kp+c's b0, b1.
    float s[MQ][FBK / 8][4];
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) s[mq][nt][0] = s[mq][nt][1] = s[mq][nt][2] = s[mq][nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 16; ++kp) {
      uint32_t qh[MQ][2][4], ql[MQ][2][4], kh[FBK / 8][4], kl[FBK / 8][4];
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t r[4];
          ak::ldsm4(r, qw + (16 * mq + lane % 16) * LD + kp * 16 + c * 8 + lane / 16 * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) ak::split_tf32(__uint_as_float(r[i]), qh[mq][c][i], ql[mq][c][i]);
        }
#pragma unroll
      for (int nt = 0; nt < FBK / 8; ++nt) {
        uint32_t r[4];
        ak::ldsm4(r, kt + (nt * 8 + lane % 8) * LD + kp * 16 + lane / 8 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) ak::split_tf32(__uint_as_float(r[i]), kh[nt][i], kl[nt][i]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int nt = 0; nt < FBK / 8; ++nt)
#pragma unroll
          for (int mq = 0; mq < MQ; ++mq)
            mma_tf32x3(s[mq][nt], qh[mq][c], ql[mq][c], kh[nt][2 * c], kh[nt][2 * c + 1],
                       kl[nt][2 * c], kl[nt][2 * c + 1]);
    }

    // scale into log2 units, mask where needed, running max and sum, P
    softmax_tile<D, MQ, FBK>(a, s, o, m, l, wr0, key0, b, ksg + slot * FBK);

    // acc += P V, 8 keys a k step.  The k index is permuted so that no
    // value moves between lanes: step kk's k t is key 8kk + 2t and k t+4 is
    // key 8kk + 2t + 1, so P's A fragment is this thread's own S fragment
    // (keys 2t, 2t+1 of n tile kk) and V's b0, b1 are rows 2t, 2t+1 at
    // column g, two 32-bit loads (banks 8t + g: LD % 16 == 4)
#pragma unroll
    for (int kk = 0; kk < FBK / 8; ++kk) {
      uint32_t ph[MQ][4], pl[MQ][4];
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        ak::split_tf32(s[mq][kk][0], ph[mq][0], pl[mq][0]);
        ak::split_tf32(s[mq][kk][2], ph[mq][1], pl[mq][1]);
        ak::split_tf32(s[mq][kk][1], ph[mq][2], pl[mq][2]);
        ak::split_tf32(s[mq][kk][3], ph[mq][3], pl[mq][3]);
      }
      const float* vr = vt + (kk * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int d0 = 0; d0 < D / 8; d0 += 2) {
        uint32_t vh[2][2], vl[2][2];
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          ak::split_tf32(vr[(d0 + j2) * 8], vh[j2][0], vl[j2][0]);
          ak::split_tf32(vr[(d0 + j2) * 8 + LD], vh[j2][1], vl[j2][1]);
        }
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
          for (int mq = 0; mq < MQ; ++mq)
            mma_tf32x3(o[mq][d0 + j2], ph[mq], pl[mq], vh[j2][0], vh[j2][1], vl[j2][0],
                       vl[j2][1]);
      }
    }
  }
  ak::cp_wait<0>();

  float* out = static_cast<float*>(a.out) + ((size_t)b * a.H + h) * a.Sq * D;
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wr0 + 16 * mq + g + 8 * e;
      if (r >= a.Sq) continue;
      const float li = l[mq][e] == 0.f ? 1.f : 1.f / l[mq][e];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(out + (size_t)r * D + dt * 8 + 2 * t) =
            make_float2(o[mq][dt][2 * e] * li, o[mq][dt][2 * e + 1] * li);
    }
}

template <int D, int MQ>
cudaError_t launch_bf16(const Args& a, int B, int hpb, cudaStream_t stream) {
  constexpr int smem = flash_smem<D, MQ>();
  const cudaError_t e = ak::allow_smem<flash_bf16<D, MQ>>(smem);
  if (e != cudaSuccess) return e;
  const int bq = block_rows(MQ) / hpb;
  dim3 grid(B * a.Hkv * (a.H / a.Hkv / hpb), (a.Sq + bq - 1) / bq);
  flash_bf16<D, MQ><<<grid, FW * 32, smem, stream>>>(a, hpb);
  return cudaGetLastError();
}

template <int D, int MQ>
cudaError_t launch_tf32(const Args& a, int B, int hpb, cudaStream_t stream) {
  constexpr int smem = tf32_smem<D, MQ>();
  const cudaError_t e = ak::allow_smem<flash_tf32<D, MQ>>(smem);
  if (e != cudaSuccess) return e;
  const int bq = block_rows(MQ) / hpb;
  dim3 grid(B * a.Hkv * (a.H / a.Hkv / hpb), (a.Sq + bq - 1) / bq);
  flash_tf32<D, MQ><<<grid, FW * 32, smem, stream>>>(a, hpb);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int B, int bf16, cudaStream_t stream) {
  if constexpr (D > 128) {  // bf16 only, one row tile a warp
    if (!bf16) return cudaErrorInvalidValue;
    const int hpb = (a.H / a.Hkv) % 2 == 0 ? 2 : 1;
    return launch_bf16<D, 1>(a, B, hpb, stream);
  } else {
    // two query heads a block where a kv head serves an even number; two
    // row tiles a warp unless that leaves fewer than two blocks an SM
    const int R = a.H / a.Hkv, hpb = R % 2 == 0 ? 2 : 1;
    const int bq = block_rows(2) / hpb;
    const long long blocks = (long long)B * a.Hkv * (R / hpb) * ((a.Sq + bq - 1) / bq);
    const bool two = blocks >= 2 * ak::sm_count();
    if (bf16)
      return two ? launch_bf16<D, 2>(a, B, hpb, stream) : launch_bf16<D, 1>(a, B, hpb, stream);
    return two ? launch_tf32<D, 2>(a, B, hpb, stream) : launch_tf32<D, 1>(a, B, hpb, stream);
  }
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
    case 32: return launch<32>(a, B, bf16, s);
    case 64: return launch<64>(a, B, bf16, s);
    case 80: return launch<80>(a, B, bf16, s);
    case 96: return launch<96>(a, B, bf16, s);
    case 128: return launch<128>(a, B, bf16, s);
    case 256: return launch<256>(a, B, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
