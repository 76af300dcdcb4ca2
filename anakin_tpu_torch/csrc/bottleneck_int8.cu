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
// Design.  A first small kernel transposes the three weights to [n][k]
// (output channel major), the layout of an mma.sync B fragment, so that
// the main kernel copies weight chunks to shared memory as they are.  The
// main kernel runs one block per (image, band of TH output rows).  Shared
// memory holds:
//   a tile  [TH + 2][W + 2][P + 16] int8: `a` for the band's rows and one
//           halo row above and below, between two zero columns.  Rows
//           outside the image stay 0: the 3x3 pads `a` with zeros, and
//           requant(relu(ba)) of a zero input is not 0.
//   b tile  [TH * W][P + 16] int8.
//   a ring  of S slots, each a 64-deep K chunk of the weights and, in stage
//           a, of x; in stage c also the output tile's residual x; at a
//           tile's last chunk its scale and bias.
// The ring is filled by cp.async, S - 1 chunks ahead of the mma work, so
// the L2 / HBM latency of the weights and x hides behind the tensor cores.
// Stage a computes `a` for the band's rows inside the image, stage b reads
// its implicit im2col rows straight from the a tile (a K chunk of 64 lies
// inside one tap because P % 64 == 0), and stage c reads b from its tile.
// Only x, the weights and y touch device memory; a and b never do.  The 16
// bytes of padding per pixel row make the ldmatrix reads of 8 neighbouring
// rows fall on distinct banks.  An int8 y goes back through the residual's
// place in the ring and leaves in 16-byte row pieces.
//
// Each stage is a GEMM over the band with mma.sync m16n8k32 s8, fragments
// by ldmatrix, int32 accumulators in registers, each warp a 32 x 32
// sub-tile.  The epilogues (dequant, bias, relu, requant of 300 k outputs
// a block in ResNet's first stage) take about as long as the mma work, and
// a block's warps run them at the same time, so where the tiles fit in half
// an SM two blocks share it and one's epilogue overlaps the other's mma
// (Cfg below).  TH is the most rows whose tiles fit, evened out over the
// image's bands (pick_band); C and P must be multiples of 64.
//
// What bounds it on an H100: a ResNet-50 identity block at batch 128 does
// 2 * N * H * W * (2 * C * P + 9 * P * P) = 55.9 G int8 operations on
// 2 * N * H * W * C bytes of x and y: stages 1-2 (C 256, 512) are bound by
// bytes, stages 3-4 (C 1024, 2048) by operations.  This version recomputes
// the halo rows of `a` per band and runs mma.sync rather than wgmma; warp
// groups that take turns between mma and epilogue (or wgmma with a
// producer warp) are the next step.
#include "int8_igemm.cuh"

namespace {

constexpr int BK = 64;           // K chunk
constexpr int LDS = BK + 16;     // ring row stride, bytes (20 words)

// A launch configuration: WM_ x WN_ warps, each a 32 x 32 sub-tile of the
// TM x TN output tile, a ring of S_ slots, and BPS_ blocks an SM where a
// band of MIN_TWO rows or more fits in half of its shared memory.
template <int WM_, int WN_, int S_, int BPS_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, S = S_, BPS = BPS_;
  static constexpr int NT = 32 * WM * WN;  // threads
  static constexpr int TM = 32 * WM;
  static constexpr int TN = 32 * WN;
  static constexpr int RS = TN + 16;  // residual row stride, bytes
  static constexpr int A_ROW = LDS > RS ? LDS : RS;
  // one ring slot: the B chunk [TN][LDS], then the A chunk [TM][LDS] or
  // the residual [TM][RS], then the tile's scale and bias [2][TN] float32
  static constexpr int EPI = TN * LDS + TM * A_ROW;
  static constexpr int SLOT = EPI + 2 * TN * 4;
};

struct Args {
  const int8_t* x;
  const int8_t* wa;  // transposed: [P][C]
  const int8_t* wb;  // transposed: [P][9 P], k = (3 dy + dx) P + c
  const int8_t* wc;  // transposed: [C][P]
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

// Four 8 x 16-byte matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; register j of lane l gets bytes 4 (l % 4) ..
// 4 (l % 4) + 3 of row l / 4 of matrix j: an mma.sync s8 fragment.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp16(int8_t* dst, const int8_t* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
template <class T, int ST>
__device__ __forceinline__ void run_stage(const Args& a, int8_t* at,
                                          int8_t* bt, int8_t* ring, int img,
                                          int h0, int the) {
  constexpr int TM = T::TM, TN = T::TN, NT = T::NT, WM = T::WM;
  constexpr int STAGES = T::S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
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
  const int nk = K / BK;
  const int total = (M + TM - 1) / TM * (Nn / TN) * nk;
  // x row of band pixel m: stage a's pixels start one row above the band
  // (at a-tile row ra0), stage c's at the band's first row
  const int8_t* x_band =
      a.x + ((static_cast<size_t>(img) * a.H + h0 - (ST == STAGE_A ? 1 - ra0 : 0)) *
             W) * a.C;

  // stage a's x rows and stage c's residual rows this thread copies, as
  // many a pair as A_CP, QPR 16-byte pieces a row
  constexpr int A_PIECES = ST == STAGE_A ? TM * 4 : ST == STAGE_C ? TM * TN / 16 : 0;
  constexpr int A_CP = (A_PIECES + NT - 1) / NT;
  constexpr int QPR = ST == STAGE_A ? 4 : TN / 16;
  Cursor in{0, 0, 0};  // the next pair to issue
  // cp.async of the next pair (`in`) into ring slot slot_i
  auto issue = [&](int slot_i) {
    int8_t* slot = ring + slot_i * T::SLOT;
    const int k0 = in.kt * BK;
#pragma unroll
    for (int i = 0; i < TN * 4 / NT; ++i) {
      const int idx = threadIdx.x + NT * i, r = idx >> 2, q = idx & 3;
      cp16(slot + r * LDS + q * 16,
           B + static_cast<size_t>(in.n0 + r) * K + k0 + q * 16, true);
    }
    if (in.kt == nk - 1) {  // the tile's scale and bias, for its epilogue
      constexpr int QS = TN / 4;  // 16-byte pieces of one row
      static_assert(2 * QS <= NT, "one piece a thread");
      const int t = threadIdx.x, q = t % QS;
      const float* row = t < QS ? scale : bias;
      if (t < 2 * QS && row != nullptr)
        cp16(slot + T::EPI + (t / QS) * TN * 4 + q * 16,
             reinterpret_cast<const int8_t*>(row + in.n0 + q * 4), true);
    }
    if (A_CP > 0 && (ST == STAGE_A || in.kt == nk - 1)) {
      int8_t* sa = slot + TN * LDS;
#pragma unroll
      for (int i = 0; i < (A_CP > 0 ? A_CP : 1); ++i) {
        const int idx = threadIdx.x + NT * i;
        if (A_PIECES % NT && idx >= A_PIECES) break;
        const int r = idx / QPR, q = idx % QPR;
        const bool ok = in.m0 + r < M;
        // band pixel m is x row m of x_band
        const int8_t* src = ok ? x_band + static_cast<size_t>(in.m0 + r) * a.C
                               : a.x;
        if (ST == STAGE_A)  // the K chunk of x
          cp16(sa + r * LDS + q * 16, src + (ok ? k0 + q * 16 : 0), ok);
        else  // the tile's residual, for its epilogue
          cp16(sa + r * T::RS + q * 16, src + (ok ? in.n0 + q * 16 : 0), ok);
      }
    }
    in.next(nk, TN, Nn, TM);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  // ldmatrix rows: lane l addresses row (l % 8) + 8 ((l / 8) % 2) of each
  // 16-row A tile at byte 16 (l / 16), and row (l % 8) of n-tile 2 p + (l /
  // 16) at byte 16 ((l / 8) % 2) of the B chunk.  rbase[mt]: the
  // shared-memory offset of this lane's A row of tile mt, in stage a within
  // the ring's A chunk, in stage b the a-tile pixel of tap (0, 0), in stage
  // c the b-tile row; rows past M read row M - 1 and are not stored.
  const int a_lr = (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  const int b_off = (wn * 32 + 8 * (lane >> 4) + (lane & 7)) * LDS +
                    16 * ((lane >> 3) & 1);
  int rbase[2];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }
  Cursor cur{0, 0, 0};  // the pair computed
  for (int it = 0; it < total; ++it) {
    // pair it has landed, and every warp is done with slot (it - 1) % STAGES
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int slot_i = it % STAGES;
    if (it + STAGES - 1 < total)
      issue(slot_i == 0 ? STAGES - 1 : slot_i - 1);
    cp_commit();

    const int8_t* slot = ring + slot_i * T::SLOT;
    const int m0 = cur.m0, n0 = cur.n0, kt = cur.kt;
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int lr = wm * 32 + mt * 16 + a_lr;
        const int r = min(m0 + lr, M - 1);
        rbase[mt] = ST == STAGE_A ? lr * LDS
                    : ST == STAGE_B ? ((r / W) * W2 + r % W) * lda
                                    : r * lda;
      }
    }
    const int k0 = kt * BK;
    const int8_t* sB = slot + b_off;
    const int8_t* abase;
    if (ST == STAGE_A) {
      abase = slot + TN * LDS + a_k;
    } else if (ST == STAGE_B) {
      const int tap = k0 / P;
      abase = at + ((tap / 3) * W2 + tap % 3) * lda + (k0 - tap * P) + a_k;
    } else {
      abase = bt + k0 + a_k;
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm4(af[mt], abase + rbase[mt] + ks);
#pragma unroll
      for (int p = 0; p < 2; ++p) ldsm4(bf[p], sB + p * 16 * LDS + ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b2[2] = {bf[nt >> 1][2 * (nt & 1)],
                                  bf[nt >> 1][2 * (nt & 1) + 1]};
          ak::mma_s8(acc[mt][nt], af[mt], b2);
        }
    }

    if (kt == nk - 1) {
      // Epilogue from the fragments: thread holds rows (g, g + 8) of each
      // 16-row tile, columns (2 tig, 2 tig + 1) of each 8-column tile.
      // stage c: the residual [TM][RS], overwritten with int8 y
      int8_t* res = ring + slot_i * T::SLOT + TN * LDS;
      const float* sc = reinterpret_cast<const float*>(slot + T::EPI);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nl = wn * 32 + nt * 8 + tig * 2, n = n0 + nl;
        const float2 s2 = *reinterpret_cast<const float2*>(sc + nl);
        const float2 b2 = bias ? *reinterpret_cast<const float2*>(sc + TN + nl)
                               : make_float2(0.0f, 0.0f);
        const float s0 = s2.x, s1 = s2.y, b0 = b2.x, b1 = b2.y;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = wm * 32 + mt * 16 + g + 8 * h, r = m0 + lr;
            float y0 = finish(acc[mt][nt][2 * h], s0, bias, b0);
            float y1 = finish(acc[mt][nt][2 * h + 1], s1, bias, b1);
            acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0;
            if (r >= M) continue;
            if (ST == STAGE_A) {
              const int tr = ra0 + r / W, tc = r % W;
              char2 q;
              q.x = ak::requant(fmaxf(y0, 0.0f), a.inv_a);
              q.y = ak::requant(fmaxf(y1, 0.0f), a.inv_a);
              *reinterpret_cast<char2*>(at + (tr * W2 + tc + 1) * lda + n) = q;
            } else if (ST == STAGE_B) {
              char2 q;
              q.x = ak::requant(fmaxf(y0, 0.0f), a.inv_b);
              q.y = ak::requant(fmaxf(y1, 0.0f), a.inv_b);
              *reinterpret_cast<char2*>(bt + r * lda + n) = q;
            } else {
              const size_t idx = static_cast<size_t>(x_band - a.x) +
                                 static_cast<size_t>(r) * a.C + n;
              const char2 x2 =
                  *reinterpret_cast<const char2*>(res + lr * T::RS + nl);
              y0 = fmaxf(__fadd_rn(y0, __fmul_rn(static_cast<float>(x2.x),
                                                 a.res_scale)), 0.0f);
              y1 = fmaxf(__fadd_rn(y1, __fmul_rn(static_cast<float>(x2.y),
                                                 a.res_scale)), 0.0f);
              if (a.out_kind == ak::OUT_S8) {  // stored below, 16 bytes a copy
                char2 q;
                q.x = ak::requant(y0, a.inv_out);
                q.y = ak::requant(y1, a.inv_out);
                *reinterpret_cast<char2*>(res + lr * T::RS + nl) = q;
              } else if (a.out_kind == ak::OUT_F32) {
                *reinterpret_cast<float2*>(static_cast<float*>(a.out) + idx) =
                    make_float2(y0, y1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(
                    static_cast<__nv_bfloat16*>(a.out) + idx) =
                    __floats2bfloat162_rn(y0, y1);
              }
            }
          }
      }
    }
    if (ST == STAGE_C && kt == nk - 1 && a.out_kind == ak::OUT_S8) {
      // the int8 tile, row by row in 16-byte pieces
      __syncthreads();
      constexpr int PIECES = TM * TN / 16, QPR = TN / 16;
      const int8_t* res = ring + slot_i * T::SLOT + TN * LDS;
#pragma unroll
      for (int i = 0; i < (PIECES + NT - 1) / NT; ++i) {
        const int idx = threadIdx.x + NT * i;
        const int r = idx / QPR, q = idx % QPR;
        if ((PIECES % NT == 0 || idx < PIECES) && m0 + r < M)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.out) +
                                    (x_band - a.x) +
                                    static_cast<size_t>(m0 + r) * a.C + n0 +
                                    q * 16) =
              *reinterpret_cast<const uint4*>(res + r * T::RS + q * 16);
      }
    }
    cur.next(nk, TN, Nn, TM);
  }
  cp_wait<0>();  // only empty groups are left; keep none across stages
}

template <class T>
__global__ void __launch_bounds__(T::NT, T::BPS) bottleneck_kernel(const Args a) {
  constexpr int NT = T::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int bands = (a.H + a.TH - 1) / a.TH;
  const int img = blockIdx.x / bands;
  const int h0 = (blockIdx.x % bands) * a.TH;
  const int the = min(a.TH, a.H - h0);
  const int lda = a.P + 16;
  int8_t* at = smem;
  int8_t* bt = at + (a.TH + 2) * (a.W + 2) * lda;
  int8_t* ring = bt + a.TH * a.W * lda;

  const int a_words = (a.TH + 2) * (a.W + 2) * lda / 16;
  for (int i = threadIdx.x; i < a_words; i += NT)
    reinterpret_cast<uint4*>(at)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  run_stage<T, STAGE_A>(a, at, bt, ring, img, h0, the);
  __syncthreads();
  run_stage<T, STAGE_B>(a, at, bt, ring, img, h0, the);
  __syncthreads();
  run_stage<T, STAGE_C>(a, at, bt, ring, img, h0, the);
}

// src [rows][cols] -> dst [cols][rows] for the three weights at once, one
// 64 x 64 tile a block (rows and cols are multiples of 64), with 16-byte
// loads and stores through a shared tile.
struct Transpose {
  const int8_t* src;
  int8_t* dst;
  int rows, cols;
};
struct Transposes {
  Transpose t[3];
  int first[3];  // the first block of each
};

__global__ void __launch_bounds__(256) transpose_weights(const Transposes ts) {
  __shared__ __align__(16) int8_t tile[64][80];
  // constant indices only: a computed one would copy ts to the stack
  const bool c2 = blockIdx.x >= ts.first[2], c1 = blockIdx.x >= ts.first[1];
  const Transpose t = c2 ? ts.t[2] : c1 ? ts.t[1] : ts.t[0];
  const int b = blockIdx.x - (c2 ? ts.first[2] : c1 ? ts.first[1] : 0);
  const int tiles_c = t.cols / 64;
  const int r0 = (b / tiles_c) * 64, c0 = (b % tiles_c) * 64;
  const int row = threadIdx.x >> 2, q = threadIdx.x & 3;
  *reinterpret_cast<uint4*>(&tile[row][q * 16]) = *reinterpret_cast<const uint4*>(
      t.src + static_cast<size_t>(r0 + row) * t.cols + c0 + q * 16);
  __syncthreads();
  // output row c0 + row: input rows r0 + 16 q .. r0 + 16 q + 15 of column row
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(
                  tile[q * 16 + 4 * i + k][row])) << (8 * k);
  }
  *reinterpret_cast<uint4*>(t.dst + static_cast<size_t>(c0 + row) * t.rows +
                            r0 + q * 16) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The configurations: 128 x 64 tiles for P = 64 (ResNet stage 1), 64 x 128
// for P % 128 == 0 (fewer idle rows in the small images of the later
// stages), both two blocks an SM so that one block's epilogue overlaps the
// other's mma work.  A shorter ring buys 64 x 128 a taller band in half an
// SM.
using CfgNarrow = Cfg<4, 2, 4, 2>;
using CfgMid = Cfg<2, 4, 2, 2>;
constexpr int MIN_TWO = 4;

template <class T>
size_t smem_bytes(int th, int W, int P) {
  const size_t lda = P + 16;
  return (size_t)(th + 2) * (W + 2) * lda + (size_t)th * W * lda +
         (size_t)T::S * T::SLOT;
}

// The device's shared memory: the most one block may opt in to, and what
// each of two blocks may have on one SM; read once.
struct SmemLimits {
  int block, half_sm;
};
const SmemLimits& smem_limits() {
  static const SmemLimits lim = [] {
    int dev = 0, block = 0, sm = 0, reserved = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                               dev) != cudaSuccess)
      return SmemLimits{0, 0};
    return SmemLimits{block, sm / 2 - reserved};
  }();
  return lim;
}

// The most rows whose tiles fit in `limit` bytes, evened out over the
// image's bands; 0 when not even one row fits.
template <class T>
int fit_band(int H, int W, int P, int limit) {
  int th = H;
  while (th > 0 && smem_bytes<T>(th, W, P) > (size_t)limit) --th;
  if (th == 0) return 0;
  const int bands = (H + th - 1) / th;
  return (H + bands - 1) / bands;
}

// Rows per band: two blocks an SM where T asks for it and a band of
// MIN_TWO rows fits, else one.
template <class T>
int pick_band(int H, int W, int P) {
  const SmemLimits& lim = smem_limits();
  if (T::BPS == 2) {
    const int th = fit_band<T>(H, W, P, lim.half_sm);
    if (th >= MIN_TWO || th == H) return th;
  }
  return fit_band<T>(H, W, P, lim.block);
}

template <class T>
int launch(const Args& a, cudaStream_t st) {
  // opt in once to all the shared memory the device offers (above 48 KB)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_limits().block);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const size_t bytes = smem_bytes<T>(a.TH, a.W, a.P);
  const long long blocks = (long long)a.N * ((a.H + a.TH - 1) / a.TH);
  bottleneck_kernel<T><<<static_cast<unsigned>(blocks), T::NT, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_kind: ak::OutKind.  Weights wa [C, P], wb [3, 3, P, P], wc [P, C]
// int8; scale rows sa [P], sb [P], sc [C] float32; biases float32 or null.
// ws: 2 C P + 9 P P bytes of device scratch for the transposed weights,
// 16-byte aligned, as x and the weights are.  Returns cudaErrorInvalidValue,
// launching nothing, unless C and P are multiples of 64 and one row of the
// image fits in shared memory.
extern "C" int ak_bottleneck_int8(
    const void* x, const void* wa, const void* sa, const void* ba,
    const void* wb, const void* sb, const void* bb, const void* wc,
    const void* sc, const void* bc, void* out, void* ws, int out_kind, int N,
    int H, int W, int C, int P, float inv_a, float inv_b, float res_scale,
    float inv_out, void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (C <= 0 || P <= 0 || C % 64 || P % 64) return cudaErrorInvalidValue;
  const bool mid = P % 128 == 0 && C % 128 == 0;
  const int th = mid ? pick_band<CfgMid>(H, W, P) : pick_band<CfgNarrow>(H, W, P);
  if (th == 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* wat = static_cast<int8_t*>(ws);
  int8_t* wbt = wat + (size_t)C * P;
  int8_t* wct = wbt + (size_t)9 * P * P;
  const int blocks_a = C * P / 4096, blocks_b = 9 * P * P / 4096;
  const Transposes ts{{{static_cast<const int8_t*>(wa), wat, C, P},
                       {static_cast<const int8_t*>(wb), wbt, 9 * P, P},
                       {static_cast<const int8_t*>(wc), wct, P, C}},
                      {0, blocks_a, blocks_a + blocks_b}};
  transpose_weights<<<2 * blocks_a + blocks_b, 256, 0, st>>>(ts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{static_cast<const int8_t*>(x), wat, wbt, wct,
         static_cast<const float*>(sa),  static_cast<const float*>(sb),
         static_cast<const float*>(sc),  static_cast<const float*>(ba),
         static_cast<const float*>(bb),  static_cast<const float*>(bc),
         out, out_kind, N, H, W, C, P, th, inv_a, inv_b, res_scale, inv_out};
  return mid ? launch<CfgMid>(a, st) : launch<CfgNarrow>(a, st);
}
