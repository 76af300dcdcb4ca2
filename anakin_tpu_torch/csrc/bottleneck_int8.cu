// bottleneck_int8: one identity-shortcut ResNet bottleneck block in one
// kernel, x [N, H, W, C] int8 -> y [N, H, W, C]:
//
//   a = requant_a(relu(x @ wa * sa + ba))          1x1, C -> P
//   b = requant_b(relu(conv3x3(a, wb) * sb + bb))  3x3 s1 p1, P -> P
//   y = relu(b @ wc * sc + bc + x * res_scale)     1x1, P -> C
//   y written as int8 (requant_out), float32 or bfloat16
//
// where sa = in_scale * wsa, sb = a_scale * wsb, sc = b_scale * wsc are the
// caller's float32 scale rows and requant_s(v) = int8(clip(rint(v * (1 /
// s)), -127, 127)).  Every float step is the one the unfused kernels'
// epilogue takes (int8_epilogue.cuh, separately rounded), so the block
// equals matmul_int8 -> conv3x3_int8 -> matmul_int8 bit for bit.
//
// Replaces the TPU kernel anakin_tpu/kernels/bottleneck_int8.py::
// bottleneck_int8, which keeps a batch block's whole chain in VMEM, pads W
// to a multiple of 8 and lines the 3x3 taps and the residual up with rolls
// of 32-bit partial sums (Mosaic workarounds, not part of the function).
//
// What bounds it on an H100: a ResNet-50 identity block at batch 128 does
// 2 N H W (2 C P + 9 P P) = 55.9 G int8 operations (28.2 us at 1,979 TOP/s)
// on 2 N H W C bytes of x and y.  Stages 1-2 (56 x 56 x 256, 28 x 28 x 512)
// are bound by bytes (61 and 31 us), stages 3-4 (14 x 14 x 1024, 7 x 7 x
// 2048) by operations (28 us each).  Inside the kernel the epilogues weigh
// most: dequant, bias, relu and requant of (2 P + C) values a pixel, each a
// chain of dependent instructions on the ALUs while the tensor cores wait;
// at stages 3-4 every block also streams all three weights from L2 (1.1
// and 4.4 MB a block).
//
// Design.  One launch, no scratch: the weights come prepared as [N][K]
// (kernels/matmul_int8.py::prepare_b; a Net holds them), K contiguous, the
// layout an int8 wgmma reads.  One block per (image, band of TH output
// rows), four warpgroups.  Shared memory holds:
//   a ring  of 128-deep K chunks: the stage's weight chunk (TN rows of 128
//           bytes in the 128-byte swizzle that wgmma's descriptors read) and,
//           in stage a, the chunk of x [TM][144]; in stage c the output
//           tile's residual x; at a tile's last chunk its scale and bias.
//           Filled by cp.async from every thread, S - 2 chunks ahead; stage
//           b's slots hold the weight chunk alone, so it gets twice as many.
//   a tile  [TH + 2][W + 2][P + 16] int8: `a` for the band's rows and one
//           halo row above and below, between two zero columns.  Rows
//           outside the image stay 0: the 3x3 pads `a` with zeros, and
//           requant(relu(ba)) of a zero input is not 0.
//   b tile  [TH W][P + 16] int8.
// Each stage is a GEMM over the band: wgmma.mma_async m64n64k32 s32.s8.s8
// with A from registers and B from the ring's swizzled chunk, one chunk's
// wgmma group in flight while the next chunk is waited for and loaded.  A
// is loaded by ldmatrix: in stage b straight from the a tile at each tap's
// offset (a shared-memory descriptor over a swizzled tile cannot start one
// pixel further on), in stage c from the b tile, in stage a from the ring's
// x chunk; the 16 bytes of padding a row keep those reads conflict-free.  A
// tile's first wgmma overwrites the accumulators (scale-d 0): zeroing them
// with other instructions made ptxas serialize every wgmma.  The int32
// accumulators stay in registers; the epilogues of stages a and b write
// int8 straight into the a and b tiles, stage c's goes out through the
// residual's place in the ring in 16-byte pieces (int8) or as float pairs,
// with predicated stores and no int-to-float conversion for the residual.
// Only x, the weights and y touch device memory; a and b never do.
//
// Three tile shapes (the launch picks from P, C, H and W): 256 x 64 for P
// = 64, 128 x 128 where P % 128 == 0, and 64 x 256 where an image has
// fewer pixels than a 128-row tile and P % 256 == 0 (7 x 7 at stage 4).
// TH is the most rows whose tiles fit, evened out over the image's bands.
// C and P must be multiples of 64.
//
// Instructions (SASS, chip_smoke.py phase 1; nvcc 12.8, sm_90a): a stage's
// tile loop is 750-895 instructions a thread for 32 outputs and one K chunk
// (the chunk alone 160-225, of which 4 wgmma and 4 ldmatrix): about 9
// floating-point steps an output (I2F, scale, bias, relu, the requant's
// multiply, two clamps and the rounding add; the residual's three more in
// stage c) and as many integer ones.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 14,
// PERF.md): 2.324 ms over ResNet-50 b128's 12 identity blocks against 3.758
// for the previous design and 2.371 for the unfused chain matmul_int8 ->
// conv3x3_int8 -> matmul_int8 in the same run, 17.8% of the 0.413 ms bound:
// stage 1 0.298 ms a block (chain 0.361), stage 2 0.208 (0.196), stage 3
// 0.160 (0.158), stage 4 0.145 (0.125).
//
#include "int8_igemm.cuh"

namespace {

using ak::igemm::desc_sw128;
using ak::igemm::fence_regs;
using ak::igemm::swz;

constexpr int BK = ak::igemm::BK;  // K chunk: one 128-byte swizzle row
constexpr int ALD = BK + 16;       // row stride of stage a's x chunk, bytes

// A launch configuration: WGM x WGN warpgroups, each a 64 x 64 sub-tile
// (its wgmma is m64n64k32) of the TM x TN output tile, and a ring of S_
// stage-a slots.
template <int WGM_, int WGN_, int S_>
struct Cfg {
  static constexpr int WGM = WGM_, WGN = WGN_, BN = 64, S = S_;
  static constexpr int NT = 128 * WGM * WGN;  // threads
  static_assert(S >= 3, "one chunk in flight, one refilled, one computed");
  static constexpr int TM = 64 * WGM;
  static constexpr int TN = BN * WGN;
  static constexpr int RS = TN + 16;  // residual row stride, bytes
  // A ring slot holds the B chunk [TN][128] (swizzled, 1 KB aligned, as the
  // swizzle needs) and, at a tile's last chunk, its scale and bias [2][TN]
  // float32; between the two, in stage a the x chunk [TM][ALD], in stage c
  // the tile's residual x [TM][RS] (overwritten with int8 y).  The ring's
  // bytes are S of the larger of those slots; stage b, whose slots hold the
  // weight chunk alone, gets as many as fit (at most 8), so its weights
  // stream further ahead.
  static constexpr int EPI_A = TN * BK + TM * ALD;
  static constexpr int EPI_B = TN * BK;
  static constexpr int EPI_C = TN * BK + TM * RS;
  static constexpr int SLOT_A = (EPI_A + 2 * TN * 4 + 1023) / 1024 * 1024;
  static constexpr int SLOT_B = (EPI_B + 2 * TN * 4 + 1023) / 1024 * 1024;
  static constexpr int SLOT_C = (EPI_C + 2 * TN * 4 + 1023) / 1024 * 1024;
  static constexpr int RING = S * (SLOT_A > SLOT_C ? SLOT_A : SLOT_C);
};

struct Args {
  const int8_t* x;
  const int8_t* wa;  // prepared: [P][C]
  const int8_t* wb;  // prepared: [P][9 P], k = (3 dy + dx) P + c
  const int8_t* wc;  // prepared: [C][P]
  const float* sa;
  const float* sb;
  const float* sc;
  const float* ba;  // each bias may be null
  const float* bb;
  const float* bc;
  void* out;
  int out_kind;
  int N, H, W, C, P, TH;
  float inv_a, inv_b, res_scale, inv_out;
};

enum Stage { STAGE_A = 0, STAGE_B = 1, STAGE_C = 2 };

// wgmma m64n64k32 s8 with A from registers (a warp's 16 rows in the
// mma.sync m16n8k32 A-fragment order, as ldmatrix.x4 gives it) and B from a
// shared-memory descriptor; d = A B + (accumulate ? d : 0).  A tile's
// first k step passes accumulate = 0 instead of zeroing d: an instruction
// other than wgmma that writes d while a wgmma group may be in flight makes
// ptxas serialize every wgmma of the kernel.
#define AK_D8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                 "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_rs_n64(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : AK_D8(0), AK_D8(8), AK_D8(16), AK_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef AK_D8

// y of one element before the requant: separately rounded float steps in
// the order of ak::dequant (int8_igemm.cuh).
__device__ __forceinline__ float finish(int acc, float s, const float* bias,
                                        float b) {
  float y = __fmul_rn(static_cast<float>(acc), s);
  if (bias) y = __fadd_rn(y, b);
  return y;
}

// Position of a (output tile, K chunk) pair in a stage's sequence: the
// chunk kt of the tile at rows m0, columns n0; K chunks innermost, then
// column tiles.
struct Cursor {
  int kt, m0, n0;
  __device__ __forceinline__ void next(int nk, int tn, int nn, int tm) {
    if (++kt < nk) return;
    kt = 0;
    n0 += tn;
    if (n0 < nn) return;
    n0 = 0;
    m0 += tm;
  }
};

// One GEMM stage over the band.  The loop runs over (output tile, K chunk)
// pairs in one sequence, the ring S - 1 pairs ahead, so the loads stay in
// flight across tile boundaries too (stage c of the first ResNet stage has
// one chunk per tile).
template <class T, int ST, int OUT = ak::OUT_S8>
__device__ __forceinline__ void run_stage(const Args& a, int8_t* at,
                                          int8_t* bt, int8_t* ring, int img,
                                          int h0, int the) {
  constexpr int TM = T::TM, TN = T::TN, BN = T::BN, NT = T::NT;
  constexpr int SLOT = ST == STAGE_A ? T::SLOT_A : ST == STAGE_B ? T::SLOT_B : T::SLOT_C;
  constexpr int EPI = ST == STAGE_A ? T::EPI_A : ST == STAGE_B ? T::EPI_B : T::EPI_C;
  constexpr int STAGES = T::RING / SLOT < 8 ? T::RING / SLOT : 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;  // warpgroup
  const int wm = wg % T::WGM, wn = wg / T::WGM;
  const int W = a.W, W2 = a.W + 2, P = a.P, lda = a.P + 16;
  // stage a computes the a-tile rows [ra0, ra1) that lie in the image; a
  // tile row tr is image row h0 - 1 + tr
  const int ra0 = h0 == 0 ? 1 : 0;
  const int ra1 = min(the + 2, a.H - h0 + 1);
  const int M = ST == STAGE_A ? (ra1 - ra0) * W : the * W;
  const int Nn = ST == STAGE_C ? a.C : P;
  const int K = ST == STAGE_A ? a.C : (ST == STAGE_B ? 9 * P : P);
  const int8_t* B = ST == STAGE_A ? a.wa : (ST == STAGE_B ? a.wb : a.wc);
  const float* scale = ST == STAGE_A ? a.sa : (ST == STAGE_B ? a.sb : a.sc);
  const float* bias = ST == STAGE_A ? a.ba : (ST == STAGE_B ? a.bb : a.bc);
  const int nk = (K + BK - 1) / BK;
  const int total = (M + TM - 1) / TM * (Nn / TN) * nk;
  // x row of band pixel m: stage a's pixels start one row above the band
  // (at a-tile row ra0), stage c's at the band's first row
  const int8_t* x_band =
      a.x + ((static_cast<size_t>(img) * a.H + h0 - (ST == STAGE_A ? 1 - ra0 : 0)) *
             W) * a.C;

  // stage a's x rows (8 pieces a row) and stage c's residual rows (TN / 16)
  constexpr int QPR = ST == STAGE_A ? BK / 16 : TN / 16;
  constexpr int A_PIECES = ST == STAGE_B ? 0 : TM * QPR;
  constexpr int A_CP = (A_PIECES + NT - 1) / NT;
  Cursor in{0, 0, 0};  // the next pair to issue
  // cp.async of the next pair (`in`) into ring slot slot_i
  auto issue = [&](int slot_i) {
    int8_t* slot = ring + slot_i * SLOT;
    const int k0 = in.kt * BK;
#pragma unroll
    for (int i = 0; i < TN * 8 / NT; ++i) {  // the weight chunk, swizzled
      const int idx = threadIdx.x + NT * i, r = idx >> 3, q = idx & 7;
      if (k0 + 16 * q < K)  // a 64-deep last chunk: its wgmma reads half
        ak::cp16(slot + swz(r, q),
                 B + static_cast<size_t>(in.n0 + r) * K + k0 + q * 16, true);
    }
    if (in.kt == nk - 1) {  // the tile's scale and bias, for its epilogue
      constexpr int QS = TN / 4;  // 16-byte pieces of one row
      static_assert(2 * QS <= NT, "one piece a thread");
      const int t = threadIdx.x, q = t % QS;
      const float* row = t < QS ? scale : bias;
      if (t < 2 * QS && row != nullptr)
        ak::cp16(slot + EPI + (t / QS) * TN * 4 + q * 16, row + in.n0 + q * 4,
                 true);
    }
    if (ST == STAGE_A || (ST == STAGE_C && in.kt == nk - 1)) {
      int8_t* sa = slot + TN * BK;
#pragma unroll
      for (int i = 0; i < (A_CP > 0 ? A_CP : 1); ++i) {
        const int idx = threadIdx.x + NT * i;
        if (A_PIECES % NT && idx >= A_PIECES) break;
        const int r = idx / QPR, q = idx % QPR;
        const bool ok = in.m0 + r < M;
        // band pixel m is x row m of x_band
        const int8_t* src = ok ? x_band + static_cast<size_t>(in.m0 + r) * a.C
                               : a.x;
        if (ST == STAGE_A) {  // the K chunk of x
          if (k0 + 16 * q < K)
            ak::cp16(sa + r * ALD + q * 16, src + (ok ? k0 + q * 16 : 0), ok);
        } else {  // the tile's residual, for its epilogue
          ak::cp16(sa + r * T::RS + q * 16, src + (ok ? in.n0 + q * 16 : 0), ok);
        }
      }
    }
    in.next(nk, TN, Nn, TM);
  };

  // written first by each tile's first wgmma (accumulate = 0), never by
  // other instructions while a wgmma group may be in flight
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // ldmatrix rows: lane l addresses row (l % 8) + 8 ((l / 8) % 2) of its
  // warp's 16 rows at byte 16 (l / 16) of each 32-byte k step.  rbase: the
  // shared-memory offset of this lane's row, in stage a within the ring's x
  // chunk, in stage b the a-tile pixel of tap (0, 0), in stage c the b-tile
  // row; rows past M read row M - 1 and are not stored.
  const int lr = wm * 64 + (warp & 3) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_k = 16 * (lane >> 4);
  int rbase = 0;

  // The ring runs S - 2 chunks ahead of the one computed, and one chunk's
  // wgmma group stays in flight while the next chunk is waited for, issued
  // and loaded into registers: chunk it - 2's slot is the one refilled.
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < total) issue(s);
    ak::cp_commit();
  }
  // stage b: the tap and channel offset at which the next chunk starts
  int tap0 = 0, c_in_tap = 0;
  // One K chunk of the tile at (m0, n0): it is the chunk's place in the
  // stage's sequence (its ring slot), af the A-fragment buffer of its
  // parity (not the one the chunk in flight reads).  Leaves the chunk's
  // wgmma group in flight and the one before it done.
  auto chunk = [&](int it, int kt, uint32_t (&af)[4][4]) {
    // chunk it has landed (this thread's copies), visible to the async
    // proxy that wgmma reads B through; after the barrier everyone's has,
    // and every warpgroup is done with chunk it - 2, whose slot is refilled
    ak::cp_wait<STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (it + STAGES - 2 < total) issue((it + STAGES - 2) % STAGES);
    ak::cp_commit();

    const int8_t* slot = ring + (it % STAGES) * SLOT;
    const int k0 = kt * BK;
    const int nks = min(BK, K - k0) / 32;  // 4, or 2 in a 64-deep last chunk
    // stage b: k0 = tap P + c (tap, c kept by the caller's loop), and each
    // 32-byte k step lies in one tap (P % 32 == 0)
    int tap = tap0, c = c_in_tap;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nks) break;
      const int k = k0 + 32 * ks;
      const int8_t* src;
      if (ST == STAGE_A) {
        src = slot + TN * BK + rbase + 32 * ks + a_k;
      } else if (ST == STAGE_B) {
        const int dy = tap / 3;  // a constant divisor: a multiply, no division
        src = at + (dy * W2 + tap - 3 * dy) * lda + c + rbase + a_k;
        c += 32;
        if (c == P) c = 0, ++tap;
      } else {
        src = bt + rbase + k + a_k;
      }
      ak::ldsm4(af[ks], src);
    }
    const uint32_t b_addr = static_cast<uint32_t>(
        __cvta_generic_to_shared(slot + wn * BN * BK));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nks) break;
      wgmma_rs_n64(acc, af[ks], desc_sw128(b_addr + 32 * ks), kt | ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (ST == STAGE_B) {  // the next chunk's first tap and offset in it
      c_in_tap += BK;
      while (c_in_tap >= P) c_in_tap -= P, ++tap0;
    }
  };

  uint32_t af0[4][4], af1[4][4];
  const int tiles_n = Nn / TN;
  const int tiles = total / nk;
  for (int t = 0; t < tiles; ++t) {
    const int m0 = (t / tiles_n) * TM, n0 = (t % tiles_n) * TN;
    {
      const int r = min(m0 + lr, M - 1);
      rbase = ST == STAGE_A ? lr * ALD
              : ST == STAGE_B ? ((r / W) * W2 + r % W) * lda
                              : r * lda;
    }
    // the tile's wgmma pipeline: closed (wait 0) before its epilogue reads
    // the accumulators
    fence_regs(acc);
    tap0 = 0;
    c_in_tap = 0;
    for (int kt = 0; kt < nk; kt += 2) {
      chunk(t * nk + kt, kt, af0);
      if (kt + 1 < nk) chunk(t * nk + kt + 1, kt + 1, af1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    const int slot_i = (t * nk + nk - 1) % STAGES;  // the tile's last chunk
    const int8_t* slot = ring + slot_i * SLOT;

    // Epilogue from the fragment: acc[4 nb + 2 h + e] is row 16 (warp % 4)
    // + g + 8 h of the warpgroup's 64, column 8 nb + 2 tig + e of its BN.
    // Each of the thread's two rows gets its destination first; the column
    // loop then runs without a division or a branch on the output's kind.
    // stage c: the residual [TM][RS], overwritten with int8 y
    int8_t* res = ring + slot_i * SLOT + TN * BK;
    const float* sc = reinterpret_cast<const float*>(slot + EPI);
    const int row0 = wm * 64 + (warp & 3) * 16 + g;
    const int c0 = wn * BN + tig * 2;  // the thread's first column in the tile
    bool ok[2];
    int8_t* dst[2];   // stages a, b: the row in the a / b tile; c: in res
    size_t oidx[2];   // stage c: the row's output element at column n0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lrow = row0 + 8 * h, r = m0 + lrow;
      ok[h] = r < M;
      oidx[h] = static_cast<size_t>(x_band - a.x) + static_cast<size_t>(r) * a.C + n0;
      if (ST == STAGE_A) {
        const int tr = ra0 + r / W, tc = r % W;
        dst[h] = at + (tr * W2 + tc + 1) * lda + n0;
      } else if (ST == STAGE_B) {
        dst[h] = bt + r * lda + n0;
      } else {
        dst[h] = res + lrow * T::RS;
      }
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int nl = c0 + nb * 8;
      const float2 s2 = *reinterpret_cast<const float2*>(sc + nl);
      const float2 b2 = bias ? *reinterpret_cast<const float2*>(sc + TN + nl)
                             : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // computed for rows past M too (their residual rows are the copies'
        // zeros), stored only for rows below it: predicated stores, no branch
        float y0 = finish(acc[4 * nb + 2 * h], s2.x, bias, b2.x);
        float y1 = finish(acc[4 * nb + 2 * h + 1], s2.y, bias, b2.y);
        if (ST == STAGE_C) {
          const char2 x2 = *reinterpret_cast<const char2*>(dst[h] + nl);
          y0 = fmaxf(__fadd_rn(y0, __fmul_rn(ak::small_int_to_float(x2.x),
                                             a.res_scale)), 0.0f);
          y1 = fmaxf(__fadd_rn(y1, __fmul_rn(ak::small_int_to_float(x2.y),
                                             a.res_scale)), 0.0f);
        } else {
          y0 = fmaxf(y0, 0.0f);
          y1 = fmaxf(y1, 0.0f);
        }
        if (ST == STAGE_C && OUT == ak::OUT_F32) {
          if (ok[h])
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + oidx[h] + nl) =
                make_float2(y0, y1);
        } else if (ST == STAGE_C && OUT == ak::OUT_BF16) {
          if (ok[h])
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + oidx[h] + nl) =
                __floats2bfloat162_rn(y0, y1);
        } else {
          // int8: into the a / b tile, or stage c's staging (stored below)
          const float inv = ST == STAGE_A ? a.inv_a : ST == STAGE_B ? a.inv_b : a.inv_out;
          char2 q;
          q.x = ak::requant(y0, inv);
          q.y = ak::requant(y1, inv);
          if (ok[h]) *reinterpret_cast<char2*>(dst[h] + nl) = q;
        }
      }
    }
    if (ST == STAGE_C && OUT == ak::OUT_S8) {
      // the int8 tile, row by row in 16-byte pieces
      __syncthreads();
      constexpr int PIECES = TM * TN / 16, QR = TN / 16;
#pragma unroll
      for (int i = 0; i < (PIECES + NT - 1) / NT; ++i) {
        const int idx = threadIdx.x + NT * i;
        const int r = idx / QR, q = idx % QR;
        if ((PIECES % NT == 0 || idx < PIECES) && m0 + r < M)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.out) +
                                    (x_band - a.x) +
                                    static_cast<size_t>(m0 + r) * a.C + n0 +
                                    q * 16) =
              *reinterpret_cast<const uint4*>(res + r * T::RS + q * 16);
      }
    }
  }
  ak::cp_wait<0>();  // only empty groups are left; keep none across stages
}

// the a tile and the b tile
template <class T>
size_t tiles_bytes(int th, int W, int P) {
  const size_t lda = P + 16;
  return (size_t)(th + 2) * (W + 2) * lda + (size_t)th * W * lda;
}

// dynamic shared memory of a block: 1 KB of slack to align the ring
template <class T>
size_t smem_bytes(int th, int W, int P) {
  return 1024 + (size_t)T::RING + tiles_bytes<T>(th, W, P);
}

template <class T>
__global__ void __launch_bounds__(T::NT, 1) bottleneck_kernel(const Args a) {
  constexpr int NT = T::NT;
  extern __shared__ __align__(16) int8_t smem_raw[];
  // the ring 1 KB aligned, as the swizzle needs: offset from smem_raw so
  // that the compiler keeps the shared space (LDS / STS, not generic LD /
  // ST) for every pointer made from it
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  int8_t* ring = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int bands = (a.H + a.TH - 1) / a.TH;
  const int img = blockIdx.x / bands;
  const int h0 = (blockIdx.x % bands) * a.TH;
  const int the = min(a.TH, a.H - h0);
  const int lda = a.P + 16;
  int8_t* at = ring + T::RING;
  int8_t* bt = at + (a.TH + 2) * (a.W + 2) * lda;

  const int a_words = (a.TH + 2) * (a.W + 2) * lda / 16;
  for (int i = threadIdx.x; i < a_words; i += NT)
    reinterpret_cast<uint4*>(at)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  run_stage<T, STAGE_A>(a, at, bt, ring, img, h0, the);
  __syncthreads();
  run_stage<T, STAGE_B>(a, at, bt, ring, img, h0, the);
  __syncthreads();
  if (a.out_kind == ak::OUT_S8)
    run_stage<T, STAGE_C, ak::OUT_S8>(a, at, bt, ring, img, h0, the);
  else if (a.out_kind == ak::OUT_F32)
    run_stage<T, STAGE_C, ak::OUT_F32>(a, at, bt, ring, img, h0, the);
  else
    run_stage<T, STAGE_C, ak::OUT_BF16>(a, at, bt, ring, img, h0, the);
}

// The configurations, four warpgroups each (16 warps: the epilogues are
// long chains of dependent instructions, and 8 warps an SM left them
// waiting on latency): 256 x 64 tiles for P = 64 (ResNet stage 1), 128 x
// 128 for P % 128 == 0, and 64 x 256 where an image has fewer pixels than a
// 128-row tile (7 x 7 at stage 4: 49 of 64 rows busy, not 49 of 128).  The
// rings: 3 slots where a deeper one would cost the band height (256 x 64,
// 64 x 256), 4 for 128 x 128 (faster at stage 2).
using CfgNarrow = Cfg<4, 1, 3>;
using CfgMid = Cfg<2, 2, 4>;
using CfgWide = Cfg<1, 4, 3>;
// The most shared memory one block may opt in to; read once.
int smem_block_limit() {
  static const int lim = [] {
    int dev = 0, block = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    return block;
  }();
  return lim;
}

// Rows per band: the most whose tiles fit in a block's shared memory,
// evened out over the image's bands; 0 when not even one row fits.
template <class T>
int pick_band(int H, int W, int P) {
  int th = H;
  while (th > 0 && smem_bytes<T>(th, W, P) > (size_t)smem_block_limit()) --th;
  if (th == 0) return 0;
  const int bands = (H + th - 1) / th;
  return (H + bands - 1) / bands;
}

template <class T>
int launch(const Args& a, cudaStream_t st) {
  // opt in once to all the shared memory the device offers (above 48 KB)
  constexpr auto kernel = bottleneck_kernel<T>;
  const cudaError_t opt_in = ak::allow_smem<kernel>(smem_block_limit());
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const size_t bytes = smem_bytes<T>(a.TH, a.W, a.P);
  const long long blocks = (long long)a.N * ((a.H + a.TH - 1) / a.TH);
  kernel<<<static_cast<unsigned>(blocks), T::NT, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_kind: ak::OutKind.  Weights prepared (kernels/matmul_int8.py::
// prepare_b): wa [P][C], wb [P][9 P], wc [C][P] int8; scale rows sa [P], sb
// [P], sc [C] float32; biases float32 or null; x, the weights and the
// scale and bias rows 16-byte aligned.  Returns cudaErrorInvalidValue,
// launching nothing, unless C and P are multiples of 64 and one row of the
// image fits in shared memory.
extern "C" int ak_bottleneck_int8(
    const void* x, const void* wa, const void* sa, const void* ba,
    const void* wb, const void* sb, const void* bb, const void* wc,
    const void* sc, const void* bc, void* out, int out_kind, int N, int H,
    int W, int C, int P, float inv_a, float inv_b, float res_scale,
    float inv_out, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (C <= 0 || P <= 0 || C % 64 || P % 64) return cudaErrorInvalidValue;
  const int cfg = P % 128 || C % 128 ? 0
                  : H * W < CfgMid::TM && P % 256 == 0 && C % 256 == 0 ? 2 : 1;
  const int th = cfg == 2   ? pick_band<CfgWide>(H, W, P)
                 : cfg == 1 ? pick_band<CfgMid>(H, W, P)
                            : pick_band<CfgNarrow>(H, W, P);
  if (th == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{static_cast<const int8_t*>(x),   static_cast<const int8_t*>(wa),
         static_cast<const int8_t*>(wb),  static_cast<const int8_t*>(wc),
         static_cast<const float*>(sa),   static_cast<const float*>(sb),
         static_cast<const float*>(sc),   static_cast<const float*>(ba),
         static_cast<const float*>(bb),   static_cast<const float*>(bc),
         out, out_kind, N, H, W, C, P, th, inv_a, inv_b, res_scale, inv_out};
  return cfg == 2   ? launch<CfgWide>(a, st)
         : cfg == 1 ? launch<CfgMid>(a, st)
                    : launch<CfgNarrow>(a, st);
}
