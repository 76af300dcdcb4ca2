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
// in bf16, the same but 256 in float32 (its 16 x 256 float32 q tile and
// accumulator a warp would not fit beside the split).  The route follows
// the dtype and D alone: bf16 at D 64, 128 and 256 (rows of whole 64-column
// slabs) on flash_wgmma, bf16 at D 32, 80 and 96 on flash_bf16, float32 on
// flash_tf32 (ak_flash_attention_route).  A failure returns its error; no
// route stands in for another.
//
// Replaces the TPU kernel anakin_tpu/kernels/flash_attention.py::
// flash_attention, whose grid walks (batch * head, q tile, kv tile) with the
// kv axis sequential and the running max, sum and accumulator in VMEM.
// Here one block owns a tile of query rows and loops over the kv tiles
// itself, keeping the running max, sum and output accumulator in
// registers; a causal block stops at its last row's diagonal tile.  A
// ragged Sq or Sk is masked in the kernel (columns past Sk weigh exactly
// 0), so nothing is padded.  Causal q tiles are scheduled heaviest first
// (the last rows visit the most kv tiles), so the short blocks fill the
// tail.  Grouped heads share a block: when H / Hkv is even, the block holds
// the rows of two query heads of one kv head, so each K/V tile leaves L2
// once for both.
//
// What bounds it on an H100: the function reads q, k, v once and writes
// out once, and does 4 * D operations per unmasked (row, col) pair (6 * D
// in the bf16 routes, see P below).  At the LLM prefill's [8, 16, 512, 128]
// with 8 kv heads that is about 50 MB and 8.6 G operations: bytes (15 us
// at 3.35 TB/s) bound it over the bf16 tensor-core rate (8.7 us; 13 us at
// 6 * D).  From S = 1024 on the operations bound it (0.208 ms at S = 2048
// and 6 * D).  So the kernel has to keep the tensor cores fed from shared
// memory and spend few other instructions per score.
//
// The online softmax, every route: scores are scaled by sm_scale * log2(e)
// and exponentiated with one ex2.approx each.  Only a tile that crosses a
// warp's diagonal, runs past Sk, or has segment ids is masked; the others
// take one FFMA and one ex2 per score.  The accumulator is rescaled only
// when a row's max moved.
//
// P V in bf16: P is float32 in the S accumulator; it goes into the A
// operand as two bf16 halves, hi = bf16(P) and lo = bf16(P - hi), each
// multiplied by V, so P keeps about 16 bits (relative error <= 2^-17)
// against the 8 of a single bf16 rounding, as the Pallas kernel's float32 P
// does (one rounding misses the tolerance below 3-14 times over; tests/
// test_torch_flash_bf16.py emulates both).  S = q k^T accumulates in
// float32 and the bf16 products are exact, so S equals the Pallas kernel's
// float32 dot up to the order of the sums.  The output's relative error
// stays far below its own bf16 rounding (2^-9): stated tolerance against
// the plain version, |diff| <= 2^-7 |want| + 3e-5 max|v|, one bf16 ulp.
//
// bf16 on wgmma (flash_wgmma, D 64, 128, 256): one producer warpgroup and
// two consumer warpgroups (one where two would leave SMs idle, as in the b1
// prefill, and at D = 256), each consumer 64 query rows, the wgmma m64
// tile; setmaxnreg hands the producer's registers to the consumers (24 /
// 240).
//   * TMA copies q once a block and the K and V tiles of 64 keys through
//     rings of 2 stages (3 at D = 64), as 64-column slabs in the 128-byte
//     swizzle.  The tensor maps are 3-D ([heads, S, D]), so a box past S
//     reads zeros, never the next head's rows.  One thread of the producer
//     issues the boxes; K of tile j goes before V of tile j - 1, the order
//     the consumers read them, each with a full and an empty mbarrier, the
//     kv tile's segment ids beside K.
//   * S = q K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major), so no fragment passes through registers.  O += P V is
//     wgmma m64nDk16 with P's hi and lo packed straight from the S
//     accumulator (two adjacent n8 tiles of it are one k16 A fragment: the
//     accumulator's layout is mma.sync's C fragment) and V from shared
//     memory as an MN-major operand.
//   * At D <= 128 each phase issues S_j and P_{j-1} V_{j-1} as two groups
//     and runs S_j's softmax while the P V group is in flight; P and O are
//     written only once no group of the warpgroup is in flight, and no
//     wgmma sits in a branch, so ptxas keeps every wgmma asynchronous.
//     The two consumers take turns at the tensor cores (named barriers),
//     so one's softmax runs beside the other's products.  At D = 256 (O
//     alone is 128 registers) one group at a time.
//   * What bounds it: the tensor cores' 6 * D operations a pair from S
//     = 1024 on, the bytes below.  The S product is m64n64k16 (64-key
//     tiles, see WgLayout), whose two shared-memory operands alone would
//     take the SM's whole shared-memory bandwidth at the tensor rate.
//     PERF.md gives its time beside the bound.
//
// bf16 on mma.sync (flash_bf16, D 32, 80, 96: rows that are not whole
// 64-column slabs): 4 warps, 128 query rows a block, each warp two tiles of
// 16 rows (one where the grid would hold fewer than two blocks an SM; then
// 64 rows a block), kv tiles of 32 keys (64 with one row tile).
//   * Each K and V fragment a warp reads feeds both of its row tiles, which
//     halves the shared-memory reads per mma and gives each warp two
//     independent chains of mma and softmax work.
//   * q, then the K/V tiles, stream through cp.async into dynamic shared
//     memory, the next tile in flight during this one's mma, one block
//     barrier per tile.  Rows are padded by 16 bytes, so ldmatrix reads 8
//     rows from 8 distinct bank groups.
//   * Fragments come from ldmatrix.x4 (q and K, for S = q k^T) and
//     ldmatrix.x4.trans (V, for P V); mma.sync m16n8k16 with float32
//     accumulation.  Every fragment passes through registers, which bounds
//     it below the wgmma route; no model path launches these head dims.
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
#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using ak::fence_acc;
using ak::mbar_arrive;
using ak::mbar_expect_tx;
using ak::mbar_init;
using ak::mbar_wait;
using ak::tma_3d;

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

// ---------------------------------------------------------------- bf16, mma.sync
constexpr int FW = 4;             // warps per block
constexpr int FSTAGES = 2;        // kv tiles in the ring
// MQ: 16-row tiles of q per warp (2, or 1 where the grid would be short);
// keys per kv tile: 32 with two row tiles, 64 otherwise
__host__ __device__ constexpr int kv_block(int mq) { return mq == 2 ? 32 : 64; }
// query rows per block, over 1 or 2 heads
__host__ __device__ constexpr int block_rows(int mq) { return 16 * mq * FW; }
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int MQ>
constexpr int flash_smem() {
  return FSTAGES * (2 * kv_block(MQ) * (D + 8) * 2 + kv_block(MQ) * 4) +
         FW * 16 * MQ * (D + 8) * 2;
}

// 2^x: one MUFU.EX2 (relative error about 2^-22); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile of scores s of a 16-row tile (NT n8 tiles from key0), this
// thread's rows r0 + g and r0 + g + 8, after S = q k^T: scale S into log2
// units (sm_scale * log2 e), mask it where `masked` (the tile crosses the
// rows' diagonal, runs past Sk or has segment ids), update the running max
// m and sum l, turn S into P in place, and set al to the factor each row's
// accumulator has to be rescaled by (1 where its max did not move).
template <int NT>
__device__ __forceinline__ void softmax_rows(const Args& a, float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&al)[2], bool masked,
                                             int r0, int key0, int b, const int* kseg_s) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float sc = a.sm_scale * kLog2e;
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (masked) {
    const int rg = r0 + g;  // this thread's rows: rg, rg + 8
    int qs[2] = {0, 0};
    if (a.qseg != nullptr) {
      if (rg < a.Sq) qs[0] = a.qseg[(size_t)b * a.Sq + rg];
      if (rg + 8 < a.Sq) qs[1] = a.qseg[(size_t)b * a.Sq + rg + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cit = nt * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        s[nt][e] = mask_score(a, s[nt][e] * sc, rg + 8 * hi, key0 + cit, qs[hi], kseg_s, cit);
        if (hi) mx1 = fmaxf(mx1, s[nt][e]); else mx0 = fmaxf(mx0, s[nt][e]);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 *= sc;
    mx1 *= sc;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  al[0] = ex2(m[0] - mn0);
  al[1] = ex2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (masked) {
      s[nt][0] = ex2(s[nt][0] - mn0);
      s[nt][1] = ex2(s[nt][1] - mn0);
      s[nt][2] = ex2(s[nt][2] - mn1);
      s[nt][3] = ex2(s[nt][3] - mn1);
    } else {
      s[nt][0] = ex2(fmaf(s[nt][0], sc, -mn0));
      s[nt][1] = ex2(fmaf(s[nt][1], sc, -mn0));
      s[nt][2] = ex2(fmaf(s[nt][2], sc, -mn1));
      s[nt][3] = ex2(fmaf(s[nt][3], sc, -mn1));
    }
    sum0 += s[nt][0] + s[nt][1];
    sum1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  l[0] = al[0] * l[0] + sum0;
  l[1] = al[1] * l[1] + sum1;
}

// acc = acc * alpha row by row, skipped where no row's max moved in the
// warp
template <int NT>
__device__ __forceinline__ void rescale(float (&o)[NT][4], const float (&al)[2]) {
  if (__any_sync(0xffffffffu, al[0] != 1.f || al[1] != 1.f)) {
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      o[dt][0] *= al[0];
      o[dt][1] *= al[0];
      o[dt][2] *= al[1];
      o[dt][3] *= al[1];
    }
  }
}

// One kv tile of a warp's MQ row tiles (the mma.sync routes): the scores
// of each row tile through softmax_rows, its accumulator rescaled at once.
// Masks apply where the tile crosses the warp's diagonal (its first row
// wr0), runs past Sk or has segment ids.
template <int D, int MQ, int FBK>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[MQ][FBK / 8][4],
                                             float (&o)[MQ][D / 8][4], float (&m)[MQ][2],
                                             float (&l)[MQ][2], int wr0, int key0, int b,
                                             const int* kseg_s) {
  const bool masked = (a.causal && key0 + FBK - 1 > wr0) || key0 + FBK > a.Sk ||
                      a.qseg != nullptr;
#pragma unroll
  for (int mq = 0; mq < MQ; ++mq) {
    float al[2];
    softmax_rows<FBK / 8>(a, s[mq], m[mq], l[mq], al, masked, wr0 + 16 * mq, key0, b, kseg_s);
    rescale<D / 8>(o[mq], al);
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
  constexpr int FBK = kv_block(MQ);
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

// ---------------------------------------------------------------- bf16, wgmma
// flash_wgmma: a producer warpgroup and NC consumer warpgroups of 64 query
// rows each (the wgmma m64 tile).  The producer copies q once and the K and V
// tiles through rings by TMA; each consumer runs S = q K^T (wgmma, both
// operands in shared memory), the softmax on S in its registers, and O +=
// P V (wgmma, P from registers as bf16 hi and lo, V in shared memory).
constexpr int WGT = 128;  // threads a warpgroup

// flash_wgmma's tiles and shared memory: kv tiles of 64 keys, rings of ST
// K tiles and ST V tiles (3 at D = 64, else 2: shared memory).  Every tile
// is D / 64 slabs of 64 columns (128 bytes a row) in TMA's 128-byte
// swizzle, 1 KB aligned.  Registers: a block's 12 warps leave a thread 168
// (3 warps share one of the SM's four 16K-register files); the consumers
// hold O (D / 2), S_j (BN / 2) and P's hi and lo (BN / 2), so the producer
// hands its registers to them (setmaxnreg 24 / 240).  64 keys measured
// faster than 128 on the prefill's shape and about 4% slower at S 2048
// (PERF.md; anakin_tpu_torch/tools/kernel_variants.py over
// tools/flash_wgmma_study.json).
template <int D, int NC>
struct WgLayout {
  static constexpr int BN = 64;
  static constexpr int ST = D > 64 ? 2 : 3;
  static constexpr int SLABS = D / 64;
  static constexpr int QT = 64 * D * 2;  // a consumer's q tile
  static constexpr int KT = BN * D * 2;  // a K or V tile
  // byte offsets in the 1 KB-aligned buffer: q tiles, the K ring, the V
  // ring, the K tiles' segment ids [ST][BN], the mbarriers (full_q, then
  // full_k, full_v, empty_k, empty_v, ST each)
  static constexpr int K = NC * QT;
  static constexpr int V = K + ST * KT;
  static constexpr int SEG = V + ST * KT;
  static constexpr int BAR = SEG + ST * BN * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * ST) + 1024;  // + alignment slack
  static_assert(QT % 1024 == 0 && BN * 128 % 1024 == 0, "1 KB aligned slabs");
  static_assert(BYTES <= 232448, "shared memory of a block");
};

// The block: query rows [q0, q0 + 64 NC / hpb) of hpb heads of one kv
// head; consumer c owns 64 rows (with two heads a block, rows q0.. of head
// c of the pair).  The grid is flash_bf16's.  The producer issues K of
// tile j, then V of tile j - 1, the order the consumers read them, each
// into its ring once every consumer warp has released the slot (empty_k,
// empty_v), with the kv tile's segment ids beside K.
//
// D <= 128, a consumer's phase j issues S_j = q K_j^T and O += P_{j-1}
// V_{j-1} as two wgmma groups, takes S_j's softmax while the P V group
// runs, then waits for it, rescales O and splits P_j into its A fragments:
// P and O are written only while no group of the warpgroup is in flight,
// so ptxas keeps every wgmma asynchronous.  D = 256 (O alone is 128
// registers) keeps one group in flight: S_j, its softmax, then P_j V_j.
// With two consumers, named barriers 1 and 2 hand the tensor cores back
// and forth: one's turn issues once the other's has issued, so one's
// softmax runs beside the other's products.  Both consumers walk the
// block's kv tiles and no wgmma sits in a branch (ptxas serializes every
// wgmma of a kernel where one does, C7520); a tile past a consumer's
// diagonal is masked whole.
template <int D, int NC>
__global__ void __launch_bounds__((NC + 1) * WGT, 1)
    flash_wgmma(const Args a, int hpb, const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using L = WgLayout<D, NC>;
  constexpr int BN = L::BN, ST = L::ST;
  extern __shared__ __align__(16) uint8_t smem[];
  // 1 KB aligned (the swizzle acts on address bits), offset from the array
  // so that its accesses stay shared-memory ones
  uint8_t* buf = smem + ((1024 - (static_cast<uint32_t>(
                                      __cvta_generic_to_shared(smem)) & 1023)) & 1023);
  const uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  int* ksg = reinterpret_cast<int*>(buf + L::SEG);
  const uint32_t full_q = sb + L::BAR, full_k = full_q + 8, full_v = full_k + 8 * ST;
  const uint32_t empty_k = full_v + 8 * ST, empty_v = empty_k + 8 * ST;

  const int R = a.H / a.Hkv, groups = R / hpb, bq = 64 * NC / hpb;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int hg = blockIdx.x % groups, hk = (blockIdx.x / groups) % a.Hkv;
  const int b = blockIdx.x / (groups * a.Hkv);
  const int q0 = qt * bq, n_tiles = kv_tiles(a, q0, bq, BN);
  // the warpgroup (NC: the producer) and warp through a shuffle, so that
  // ptxas sees them warp-uniform: a branch on them is then no divergent
  // path (wgmma and setmaxnreg need whole warpgroups)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WGT, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32 % 4, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full_k + 8 * i, a.kseg != nullptr ? 32 : 1);  // the warp's segment ids too
      mbar_init(full_v + 8 * i, 1);
      mbar_init(empty_k + 8 * i, 4 * NC);
      mbar_init(empty_v + 8 * i, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {  // the producer: its first warp, lane 0, issues the copies
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(full_q, NC * L::QT);
      for (int c = 0; c < NC; ++c) {
        const int h = hk * R + hg * hpb + (hpb == 2 ? c : 0);
        const int r0 = q0 + (hpb == 2 ? 0 : 64 * c);
        for (int sl = 0; sl < L::SLABS; ++sl)
          tma_3d(sb + c * L::QT + sl * 64 * 128, tq, 64 * sl, r0, b * a.H + h, full_q);
      }
    }
    const int bk = b * a.Hkv + hk;
    for (int j = 0; j <= n_tiles; ++j) {
      if (j < n_tiles) {  // K of tile j and its segment ids
        const int slot = j % ST, key0 = j * BN;
        if (j >= ST) mbar_wait(empty_k + 8 * slot, (j / ST - 1) & 1);
        if (a.kseg != nullptr) {
          for (int c = lane; c < BN; c += 32)
            ksg[slot * BN + c] =
                key0 + c < a.Sk ? a.kseg[(size_t)b * a.Sk + key0 + c] : 0;
          if (lane != 0) mbar_arrive(full_k + 8 * slot);
        }
        if (lane == 0) {
          mbar_expect_tx(full_k + 8 * slot, L::KT);
          for (int sl = 0; sl < L::SLABS; ++sl)
            tma_3d(sb + L::K + slot * L::KT + sl * BN * 128, tk, 64 * sl, key0, bk,
                   full_k + 8 * slot);
        }
      }
      if (j > 0) {  // V of tile j - 1
        const int i = j - 1, slot = i % ST;
        if (i >= ST) mbar_wait(empty_v + 8 * slot, (i / ST - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full_v + 8 * slot, L::KT);
          for (int sl = 0; sl < L::SLABS; ++sl)
            tma_3d(sb + L::V + slot * L::KT + sl * BN * 128, tv, 64 * sl, i * BN, bk,
                   full_v + 8 * slot);
        }
      }
    }
    return;
  }

  // a consumer
  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wr0 = q0 + (hpb == 2 ? 0 : 64 * wg) + 16 * warp;  // this warp's 16 rows
  const uint32_t qs = sb + wg * L::QT;

  // zeroed before any wgmma is in flight, then written by wgmma and by the
  // rescale between groups
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  fence_acc(o);
  // running max (in units of sm_scale * log2 e) and sum of rows g, g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];
  float s[BN / 8][4];                       // S_j, then P_j
  uint32_t ph[BN / 16][4], pl[BN / 16][4];  // P_j: bf16 hi, lo A fragments

  // Turns at the tensor cores, numbered 0 .. last: consumer 0 takes turn p
  // once consumer 1 has issued its turn p - 1, consumer 1 once consumer 0
  // has issued turn p (named barriers 1 and 2: one side arrives, the other
  // waits)
  auto take_turn = [&](int p) {
    if constexpr (NC == 2) {
      if (wg == 0 && p > 0) asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WGT) : "memory");
      if (wg == 1) asm volatile("bar.sync 2, %0;\n" ::"n"(2 * WGT) : "memory");
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  };
  auto pass_turn = [&](int p, int last) {
    if constexpr (NC == 2) {
      if (wg == 0) asm volatile("bar.arrive 2, %0;\n" ::"n"(2 * WGT) : "memory");
      if (wg == 1 && p < last) asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * WGT) : "memory");
    }
  };
  // K_j / V_j landed: waited for before the turn is taken, so that a wait
  // for data never holds the other consumer back
  auto wait_k = [&](int j) { mbar_wait(full_k + 8 * (j % ST), (j / ST) & 1); };
  auto wait_v = [&](int j) { mbar_wait(full_v + 8 * (j % ST), (j / ST) & 1); };
  // S_j = q K_j^T, 16 d a step (K-major operands).  A step's descriptor is
  // the tile's plus its offset / 16 (the address field cannot carry: shared
  // addresses are below 2^18); q's is made opaque each tile, so that ptxas
  // adds the offsets in place of holding D / 16 descriptors over the loop
  auto issue_s = [&](int j) {
    uint64_t dq = ak::desc_sw128(qs);
    asm volatile("" : "+l"(dq));
    const uint64_t dk = ak::desc_sw128(sb + L::K + (j % ST) * L::KT);
    ak::wgmma_ss_first<BN>(s, dq, dk);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      ak::wgmma_ss<BN>(s, dq + ((kk / 4) * 64 * 128 + 32 * (kk % 4)) / 16,
                       dk + ((kk / 4) * BN * 128 + 32 * (kk % 4)) / 16);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  auto issue_pv = [&](int j) {  // O += (P_j hi + P_j lo) V_j, 16 keys a step (V MN-major)
    const uint64_t dv = ak::desc_mn_sw128(sb + L::V + (j % ST) * L::KT, BN * 128);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      ak::wgmma_rs_mn<D>(o, ph[kk], dv + kk * 16 * 128 / 16);
      ak::wgmma_rs_mn<D>(o, pl[kk], dv + kk * 16 * 128 / 16);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // S_j's softmax (its group done), then K_j's slot released (its segment
  // ids read: every lane is past the softmax's shuffles)
  auto softmax = [&](int j) {
    fence_acc(s);
    const int key0 = j * BN;
    const bool masked = (a.causal && key0 + BN - 1 > wr0) || key0 + BN > a.Sk ||
                        a.qseg != nullptr;
    softmax_rows<BN / 8>(a, s, m, l, al, masked, wr0, key0, b, ksg + (j % ST) * BN);
    if (lane == 0) mbar_arrive(empty_k + 8 * (j % ST));
  };
  // every group done: O rescaled by S_j's max move, and P_j as P V's A
  // fragments (k step kk is keys 16kk.., two adjacent n8 tiles of S; hi =
  // bf16(P), lo = bf16(P - hi))
  auto finish = [&]() {
    fence_acc(o);
    fence_acc(s);
    rescale<D / 8>(o, al);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = s[2 * kk + (i >> 1)][(i & 1) ? 2 : 0];
        const float p1 = s[2 * kk + (i >> 1)][(i & 1) ? 3 : 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - __low2float(hi),
                                                        p1 - __high2float(hi));
        ph[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][i] = *reinterpret_cast<const uint32_t*>(&lo);
      }
  };
  auto release_v = [&](int j) {  // P_j V_j done with V_j
    if (lane == 0) mbar_arrive(empty_v + 8 * (j % ST));
  };

  mbar_wait(full_q, 0);
  if constexpr (D <= 128) {
    // turn 0: S_0 alone
    wait_k(0);
    take_turn(0);
    issue_s(0);
    pass_turn(0, n_tiles);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    softmax(0);
    finish();
    // turn j: S_j and P_{j-1} V_{j-1} in flight, then S_j's softmax while
    // the P V group runs
    for (int j = 1; j < n_tiles; ++j) {
      wait_k(j);
      wait_v(j - 1);
      take_turn(j);
      issue_s(j);
      issue_pv(j - 1);
      pass_turn(j, n_tiles);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      softmax(j);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release_v(j - 1);
      finish();
    }
    // the last turn: P V of the last tile
    wait_v(n_tiles - 1);
    take_turn(n_tiles);
    issue_pv(n_tiles - 1);
    pass_turn(n_tiles, n_tiles);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    release_v(n_tiles - 1);
  } else {
    // tile j: S_j in one turn, its softmax, P_j V_j in the next; each
    // group is waited for before its registers are reused
    for (int j = 0; j < n_tiles; ++j) {
      wait_k(j);
      take_turn(2 * j);
      issue_s(j);
      pass_turn(2 * j, 2 * n_tiles - 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      softmax(j);
      finish();
      wait_v(j);
      take_turn(2 * j + 1);
      issue_pv(j);
      pass_turn(2 * j + 1, 2 * n_tiles - 1);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release_v(j);
    }
  }
  fence_acc(o);

  // the output head, from a fresh read of the block index and an opaque
  // copy of H, so that nothing the epilogue alone needs (the head, R,
  // groups) stays live over the loop: the D = 128 consumers sit at the
  // 168-register edge
  uint32_t bx;
  int He = a.H;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  asm volatile("" : "+r"(He));
  const int Re = He / a.Hkv, ge = Re / hpb;
  const int h = ((int)bx / ge) % a.Hkv * Re + (int)bx % ge * hpb + (hpb == 2 ? wg : 0);
  const int g = lane / 4, t = lane % 4;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + ((size_t)b * a.H + h) * a.Sq * D;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = wr0 + g + 8 * e;
    if (r >= a.Sq) continue;
    const float li = l[e] == 0.f ? 1.f : 1.f / l[e];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * D + dt * 8 + 2 * t) =
          ak::pack_f32_bf16(o[dt][2 * e] * li, o[dt][2 * e + 1] * li);
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

template <int D, int NC>
cudaError_t launch_wgmma(const Args& a, int B, int hpb, cudaStream_t stream) {
  using L = WgLayout<D, NC>;
  // q over [B H, Sq, D] and k, v over [B Hkv, Sk, D]: a box past a head's
  // last row reads zeros, never the next head's rows
  CUtensorMap tq, tk, tv;
  if (!ak::tensor_map_3d(&tq, a.q, D, a.Sq, (size_t)B * a.H, 64, 64) ||
      !ak::tensor_map_3d(&tk, a.k, D, a.Sk, (size_t)B * a.Hkv, 64, L::BN) ||
      !ak::tensor_map_3d(&tv, a.v, D, a.Sk, (size_t)B * a.Hkv, 64, L::BN))
    return cudaErrorInvalidValue;
  const cudaError_t e = ak::allow_smem<flash_wgmma<D, NC>>(L::BYTES);
  if (e != cudaSuccess) return e;
  const int bq = 64 * NC / hpb;
  dim3 grid(B * a.Hkv * (a.H / a.Hkv / hpb), (a.Sq + bq - 1) / bq);
  flash_wgmma<D, NC><<<grid, (NC + 1) * WGT, L::BYTES, stream>>>(a, hpb, tq, tk, tv);
  return cudaGetLastError();
}

// The routes, as ak_flash_attention_route names them: bf16 at head dims
// whose rows are whole 64-column slabs on wgmma, other bf16 head dims on
// mma.sync, float32 on split-TF32 mma.sync.
enum Route { ROUTE_WGMMA = 0, ROUTE_BF16 = 1, ROUTE_TF32 = 2 };

int route_of(int bf16, int D) {
  if (!bf16) return ROUTE_TF32;
  return D == 64 || D == 128 || D == 256 ? ROUTE_WGMMA : ROUTE_BF16;
}

// two query heads a block where a kv head serves an even number
int heads_per_block(int H, int Hkv) { return (H / Hkv) % 2 == 0 ? 2 : 1; }

// Query rows a block holds (over its heads).  flash_wgmma: two consumer
// warpgroups, 128 rows, unless that grid would hold fewer blocks than SMs
// or D = 256 (then one, 64 rows of one head); the mma.sync routes: two row
// tiles a warp, 128 rows, unless that leaves fewer than two blocks an SM
// (then 64).
int block_rows_of(int route, int B, int H, int Hkv, int Sq, int D) {
  const int hpb = heads_per_block(H, Hkv), bq = 128 / hpb;
  const long long blocks = (long long)B * Hkv * (H / Hkv / hpb) * ((Sq + bq - 1) / bq);
  if (route == ROUTE_WGMMA) return D < 256 && blocks >= ak::sm_count() ? 128 : 64;
  return blocks >= 2 * ak::sm_count() ? 128 : 64;
}

template <int D>
cudaError_t launch(const Args& a, int B, int bf16, cudaStream_t stream) {
  const int route = route_of(bf16, D);
  const int hpb = heads_per_block(a.H, a.Hkv);
  const bool two = block_rows_of(route, B, a.H, a.Hkv, a.Sq, D) == 128;
  if constexpr (D == 256) {  // one consumer a block (block_rows_of)
    if (route == ROUTE_WGMMA) return launch_wgmma<D, 1>(a, B, 1, stream);
  } else if constexpr (D == 64 || D == 128) {
    if (route == ROUTE_WGMMA)
      return two ? launch_wgmma<D, 2>(a, B, hpb, stream) : launch_wgmma<D, 1>(a, B, 1, stream);
  } else {
    if (route == ROUTE_BF16)
      return two ? launch_bf16<D, 2>(a, B, hpb, stream) : launch_bf16<D, 1>(a, B, hpb, stream);
  }
  if constexpr (D > 128) {  // float32 takes D <= 128
    return cudaErrorInvalidValue;
  } else {
    return two ? launch_tf32<D, 2>(a, B, hpb, stream) : launch_tf32<D, 1>(a, B, hpb, stream);
  }
}

}  // namespace

// The route a launch takes: 0 flash_wgmma (bf16, D 64, 128, 256), 1
// flash_bf16 (bf16 mma.sync: D 32, 80, 96), 2 flash_tf32 (float32); -1 for
// a head dim no route takes.  Sk does not choose it.
extern "C" int ak_flash_attention_route(int bf16, int B, int H, int Hkv, int Sq, int D) {
  (void)B;
  (void)H;
  (void)Hkv;
  (void)Sq;
  switch (D) {
    case 32: case 64: case 80: case 96: case 128: return route_of(bf16, D);
    case 256: return bf16 ? ROUTE_WGMMA : -1;
    default: return -1;
  }
}

// Query rows a block of that launch holds (over its one or two heads).
extern "C" int ak_flash_attention_block_rows(int bf16, int B, int H, int Hkv, int Sq,
                                             int D) {
  if (Hkv <= 0 || H % Hkv != 0) return 0;
  return block_rows_of(route_of(bf16, D), B, H, Hkv, Sq, D);
}

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
