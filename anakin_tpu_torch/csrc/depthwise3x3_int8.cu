// depthwise3x3_int8: 3x3 depthwise convolution, pad 1, stride 1 or 2,
// channel multiplier 1, of an NHWC int8 image with a [3, 3, 1, C] int8
// weight, int32 accumulation in registers and the int8 kernels' fused
// epilogue (dequant / bias / relu, relu6 or leaky_relu / requant), written
// once as int8, float32 or bfloat16:
//
//   acc[n,ho,wo,c] = sum_{dy,dx} x[n, s*ho+dy-1, s*wo+dx-1, c] * w[dy,dx,0,c]
//   y = act(float(acc) * scale[c] + bias[c]),  scale = in_scale * w_scale
//   out = int8(clip(rint(y * inv_out_scale), -127, 127))  or  f32 / bf16 y
//
// Replaces the TPU kernel anakin_tpu/kernels/depthwise_int8.py::
// depthwise3x3_int8.  That kernel pads the image, rolls int32 products
// along sublanes for the +-1 column taps, and splits a stride-2 image into
// four parity planes, because Mosaic has no strided int8 loads and no int8
// rotates.  Here the halo is the copies' zero fill and the stride is index
// arithmetic.  Any H and W are taken at either stride, odd ones at stride 2
// included (Ho = (H - 1) / 2 + 1), as the JAX package's default XLA route
// computes them.
//
// What bounds it on an H100: 18 operations per output against at least 2
// bytes (x read once, y written once, at stride 1), so memory bandwidth: x
// + y + w bytes over 3.35 TB/s, 0.191 ms for MobileNet v1's 13 calls at
// b128 and 0.231 ms for v2's 17.  At their 247 M and 295 M outputs that
// leaves about ten instructions an output, so the instruction stream
// matters as much as the bytes.
//
// Design (the tiled route, dw3x3_tiled):
//   * A block takes one image, a band of TH output rows and G chunks of 32
//     channels.  It stages the band's input rows (halo included) into
//     shared memory with 16-byte cp.async pieces, zero-filled outside the
//     image, so each byte of x leaves HBM once (the bands' shared halo rows
//     excepted).  TH is the most rows whose tile fits 36 KB, evened out
//     over the image; G is 1, or more on a narrow image (14 x 14, 7 x 7),
//     so that the block's 8 warps still have work.
//   * Lane l of a warp owns one channel; 32 lanes read 32 neighbouring
//     bytes of one pixel, so the shared-memory reads are conflict-free.  A
//     warp takes four neighbouring output columns of its channel over a run
//     of R output rows.  For each input row it packs the 3 + 3 s bytes it
//     needs into words with __byte_perm and forms the four windows
//     [x(s wo - 1), x(s wo), x(s wo + 1), -] of its outputs (stride 2 takes
//     even and odd columns apart by the same byte_perm: the Pallas kernel's
//     parity planes, made in registers); each window is one __dp4a against
//     the tap row's weight word [k0, k1, k2, 0], built once per thread.  A
//     window row serves the three output rows it lies under, kept in
//     registers in rotation.
//   * The epilogue's float steps are the unfused kernels' (int8_epilogue.cuh),
//     with no int/float conversion instruction: |acc| <= 9 * 127^2 < 2^22
//     becomes a float by the exact 1.5 * 2^23 addition, and the requant
//     rounds by it (I2F / F2I run at 16 an SM a clock on Hopper, an eighth
//     of the FP32 rate).  The activation and the output type are template
//     arguments.  A warp's int8 stores are 32 neighbouring channels of one
//     pixel: one 32-byte sector an instruction.
//   Counted in SASS (cuobjdump -sass of the built library, chip_smoke.py
//   phase 1; nvcc 12.8, sm_90a): the stride-1 int8 relu kernel's row loop
//   is 351 instructions for 12 outputs (3 rows x 4 columns; the guarded
//   store path of a ragged last column block included), so at most 29 an
//   output, 3 of them dp4a and none a conversion.  The previous kernel was
//   2,488 straight-line instructions for a thread's 16 outputs (every
//   activation and output kind inlined): 530 IMAD and 472 SHF / PRMT, the
//   byte-by-byte products alone about 27 an output.
// Shapes: C % 16 == 0 and x on a 16-byte boundary (MobileNet's C are 32 ...
// 1024, 144 = 9 x 16 among them; a 16-channel chunk leaves half the warp
// idle).  Anything else, and images too wide for three staged rows, take
// the one-channel-a-thread route (dw3x3_scalar_kernel).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 10,
// PERF.md): 0.429 ms per MobileNet v1 forward and 0.575 per v2 against the
// previous kernel's 0.849 and 1.048, 41-66% of the bound on the 56 and 112
// pixel images, 18-45% on the 7 to 28 pixel ones.  The loads and the
// compute of a block do not overlap (it stages, then computes).  Neither
// fewer instructions an output (the activation and output kind as template
// arguments) nor, in variants not kept, four channels a lane (a
// 4-byte store for four outputs), more blocks an SM or a persistent
// two-tile block (one band's copies in flight while the previous band is
// computed) moved the large shapes: what holds them at half the bound is
// not measured yet (no per-instruction profiler on the card).
#include <type_traits>

#include "bf16_mma.cuh"
#include "int8_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;                // channels a chunk: one a lane
constexpr int TILE_BYTES = 36 * 1024;    // staged input rows, at most

struct DwParams {
  const int8_t* x;     // [N, H, W, C]
  const int8_t* w;     // [3, 3, 1, C]
  const float* scale;  // [C], already in_scale * w_scale
  const float* bias;   // [C] or null
  void* out;           // [N, Ho, Wo, C]
  int N, H, W, C, Ho, Wo, stride;
  int act;
  float alpha;
  int out_kind;
  float inv_out_scale;
  // the tiled route's plan (plan_tiles)
  int TH;   // output rows a block
  int R;    // output rows a warp's run
  int nCB;  // four-column blocks of an output row
  int TW;   // staged columns: input columns -1 .. TW - 2
  int G;    // 32-channel chunks a block (a power of two)
  int lgG;  // log2 G
};

// bytes b0 .. b3 (each in the low byte of its word) as one word
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2,
                                          uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// The four windows of one staged input row: win[j] holds the three input
// bytes under output column 4 cb + j in bytes 0 .. 2 (byte 3 meets a zero
// weight).  `row` points at the row's first byte for this lane's window 0.
template <int S>
__device__ __forceinline__ void windows(const uint8_t* row, uint32_t (&win)[4]) {
  constexpr int B = CHUNK;  // byte stride of one staged column
  if (S == 1) {  // input columns 4 cb - 1 .. 4 cb + 4
    const uint32_t p0 = pack4(row[0], row[B], row[2 * B], row[3 * B]);
    const uint32_t p1 = __byte_perm(row[4 * B], row[5 * B], 0x0040);
    win[0] = p0;
    win[1] = __byte_perm(p0, p1, 0x4321);
    win[2] = __byte_perm(p0, p1, 0x5432);
    win[3] = __byte_perm(p0, p1, 0x6543);
  } else {       // input columns 8 cb - 1 .. 8 cb + 7
    const uint32_t p0 = pack4(row[0], row[B], row[2 * B], row[3 * B]);
    const uint32_t p1 = pack4(row[4 * B], row[5 * B], row[6 * B], row[7 * B]);
    const uint32_t p2 = row[8 * B];
    win[0] = p0;
    win[1] = __byte_perm(p0, p1, 0x5432);
    win[2] = p1;
    win[3] = __byte_perm(p1, p2, 0x5432);
  }
}

template <int ACT>
__device__ __forceinline__ float act_of(float y, float alpha) {
  if (ACT == ak::ACT_RELU) return fmaxf(y, 0.0f);
  if (ACT == ak::ACT_RELU6) return fminf(fmaxf(y, 0.0f), 6.0f);
  if (ACT == ak::ACT_LEAKY) return y >= 0.0f ? y : __fmul_rn(y, alpha);
  return y;
}

// The element type of output kind OUT (ak::OutKind), and y stored as it.
template <int OUT>
using OutT = typename std::conditional<
    OUT == ak::OUT_S8, int8_t,
    typename std::conditional<OUT == ak::OUT_F32, float, __nv_bfloat16>::type>::type;

template <int OUT>
__device__ __forceinline__ void put(OutT<OUT>* q, float y, float inv) {
  if constexpr (OUT == ak::OUT_S8) *q = ak::requant(y, inv);
  else if constexpr (OUT == ak::OUT_F32) *q = y;
  else *q = __float2bfloat16_rn(y);
}

template <int S, int ACT, int OUT>
__global__ void __launch_bounds__(THREADS) dw3x3_tiled(const DwParams p) {
  // [G][rows][TW][CHUNK] (chunk-major, so a lane's column stride is CHUNK)
  // for the block's work item: an image, a band of TH output rows and a
  // group of G chunks
  extern __shared__ __align__(16) uint8_t cur[];
  const int groups_c = (p.C + CHUNK * p.G - 1) / (CHUNK * p.G);
  const int bands = (p.Ho + p.TH - 1) / p.TH;
  int w = blockIdx.x;
  const int c0 = (w % groups_c) * CHUNK * p.G;
  w /= groups_c;
  const int ho0 = (w % bands) * p.TH;
  const int n = w / bands;
  const int the = min(p.TH, p.Ho - ho0);
  const int rows_max = (p.TH - 1) * S + 3;

  // stage the band: 16-byte pieces, zeros outside the image; piece q of a
  // pixel is channels c0 + 16 q .. c0 + 16 q + 15, in chunk q / 2
  {
    const int lg_pieces = p.lgG + 1;  // 2 G pieces a pixel
    const int rows = (the - 1) * S + 3;
    const int ih0 = ho0 * S - 1;
    for (int r = 0; r < rows; ++r) {
      const int ih = ih0 + r;
      const bool row_ok = ih >= 0 && ih < p.H;
      const int8_t* xrow =
          p.x + (static_cast<size_t>(n) * p.H + ih) * p.W * p.C + c0 - p.C;
      for (int i = threadIdx.x; i < p.TW << lg_pieces; i += blockDim.x) {
        const int q = i & ((1 << lg_pieces) - 1), col = i >> lg_pieces;
        const bool ok = row_ok && col >= 1 && col <= p.W && c0 + 16 * q < p.C;
        ak::cp16(cur + (((q >> 1) * rows_max + r) * p.TW + col) * CHUNK + 16 * (q & 1),
                 ok ? xrow + col * p.C + 16 * q : p.x, ok);
      }
    }
    ak::cp_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's chunk g within the group (the warps are a multiple of G) and
  // the lane's channel: weights as tap-row words, scale and bias, loaded
  // while the copies land
  const int g = warp & (p.G - 1);
  const int c = c0 + CHUNK * g + lane;
  const bool live = c < p.C;  // C % 32 == 16: half of the last chunk
  uint32_t wk[3] = {0u, 0u, 0u};
  float sc = 0.0f, bi = 0.0f;
  if (live) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint8_t* wr = reinterpret_cast<const uint8_t*>(p.w) + 3 * dy * p.C + c;
      wk[dy] = pack4(__ldg(wr), __ldg(wr + p.C), __ldg(wr + 2 * p.C), 0u);
    }
    sc = __ldg(p.scale + c);
    if (p.bias) bi = __ldg(p.bias + c);
  }
  ak::cp_wait<0>();
  __syncthreads();
  if (!live) return;  // no barrier follows
  const int groups = (the + p.R - 1) / p.R;
  const int items = p.nCB * groups;
  const int nw = (blockDim.x >> 5) >> p.lgG;  // warps on one chunk
  const int rstride = p.TW * CHUNK;
  const uint8_t* chunk_tile = cur + g * rows_max * rstride;
  for (int it = warp >> p.lgG; it < items; it += nw) {
    const int cb = it % p.nCB, grp = it / p.nCB;
    const int r0 = grp * p.R, r1 = min(the, r0 + p.R);
    const uint8_t* base = chunk_tile + (S * 4 * cb) * CHUNK + lane;
    const int wo0 = 4 * cb;
    const int nj = min(4, p.Wo - wo0);
    // the output at (row r0, column wo0) of this lane's channel; the next
    // row is out_row further on
    OutT<OUT>* q = static_cast<OutT<OUT>*>(p.out) +
                   ((static_cast<size_t>(n) * p.Ho + ho0 + r0) * p.Wo + wo0) *
                       p.C + c;
    const size_t out_row = static_cast<size_t>(p.Wo) * p.C;
    // the next output row from the windows of its three tap rows
    auto row_out = [&](const uint32_t (&w0)[4], const uint32_t (&w1)[4],
                       const uint32_t (&w2)[4]) {
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the signed form: int operands (the unsigned overload would read
        // each byte as 0 .. 255)
        int acc = __dp4a(static_cast<int>(w0[j]), static_cast<int>(wk[0]), 0);
        acc = __dp4a(static_cast<int>(w1[j]), static_cast<int>(wk[1]), acc);
        acc = __dp4a(static_cast<int>(w2[j]), static_cast<int>(wk[2]), acc);
        // |acc| <= 9 * 127 * 127 = 145,161 < 2^22
        y[j] = __fmul_rn(ak::small_int_to_float(acc), sc);
        if (p.bias) y[j] = __fadd_rn(y[j], bi);
        y[j] = act_of<ACT>(y[j], p.alpha);
      }
      if (nj == 4) {  // the common case: no per-output test
#pragma unroll
        for (int j = 0; j < 4; ++j) put<OUT>(q + j * p.C, y[j], p.inv_out_scale);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nj) put<OUT>(q + j * p.C, y[j], p.inv_out_scale);
      }
      q += out_row;
    };
    // three window rows in rotation (no register moves between rows)
    uint32_t wa[4], wb[4], wc[4];
    if (S == 1) {  // output row r: staged rows r, r + 1, r + 2
      windows<S>(base + r0 * rstride, wa);
      windows<S>(base + (r0 + 1) * rstride, wb);
#pragma unroll 1
      for (int r = r0; r < r1; r += 3) {
        windows<S>(base + (r + 2) * rstride, wc);
        row_out(wa, wb, wc);
        if (r + 1 >= r1) break;
        windows<S>(base + (r + 3) * rstride, wa);
        row_out(wb, wc, wa);
        if (r + 2 >= r1) break;
        windows<S>(base + (r + 4) * rstride, wb);
        row_out(wc, wa, wb);
      }
    } else {       // output row r: staged rows 2 r, 2 r + 1, 2 r + 2
      windows<S>(base + 2 * r0 * rstride, wa);
#pragma unroll 1
      for (int r = r0; r < r1; r += 2) {
        windows<S>(base + (2 * r + 1) * rstride, wb);
        windows<S>(base + (2 * r + 2) * rstride, wc);
        row_out(wa, wb, wc);
        if (r + 1 >= r1) break;
        windows<S>(base + (2 * r + 3) * rstride, wb);
        windows<S>(base + (2 * r + 4) * rstride, wa);
        row_out(wc, wb, wa);
      }
    }
  }
}

// Output pixel (n, ho, wo) and channel c of flat thread index i.
__device__ __forceinline__ void decompose(const DwParams& p, size_t i, int& n,
                                          int& ho, int& wo, int& c) {
  c = static_cast<int>(i % p.C);
  size_t pix = i / p.C;
  wo = static_cast<int>(pix % p.Wo);
  pix /= p.Wo;
  ho = static_cast<int>(pix % p.Ho);
  n = static_cast<int>(pix / p.Ho);
}

// One output element per thread: any C, any alignment.
__global__ void __launch_bounds__(THREADS) dw3x3_scalar_kernel(const DwParams p) {
  const size_t total = static_cast<size_t>(p.N) * p.Ho * p.Wo * p.C;
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= total) return;
  int n, ho, wo, c;
  decompose(p, i, n, ho, wo, c);
  int acc = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int ih = ho * p.stride + dy - 1;
    if (ih < 0 || ih >= p.H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int iw = wo * p.stride + dx - 1;
      if (iw < 0 || iw >= p.W) continue;
      const size_t xi = ((static_cast<size_t>(n) * p.H + ih) * p.W + iw) * p.C + c;
      acc += static_cast<int>(p.x[xi]) *
             static_cast<int>(p.w[(dy * 3 + dx) * p.C + c]);
    }
  }
  float y = __fmul_rn(static_cast<float>(acc), p.scale[c]);
  if (p.bias) y = __fadd_rn(y, p.bias[c]);
  ak::store_out(p.out, p.out_kind, i, ak::activate(y, p.act, p.alpha),
                p.inv_out_scale);
}

// The tiled route's plan: G chunks of 32 channels a block (more where the
// image is narrow, so that a block's warps have work), TH output rows a
// block (the most whose staged rows fit TILE_BYTES, evened out over the
// image), R rows a warp's run (short enough that all 8 warps have work).
// Returns the block's shared-memory bytes, or 0 where three staged rows of
// one chunk do not fit (an image wider than about 370 pixels).
int plan_tiles(DwParams& p) {
  const int S = p.stride;
  p.nCB = (p.Wo + 3) / 4;
  p.TW = S * 4 * p.nCB + 2;
  const int chunks = (p.C + CHUNK - 1) / CHUNK;
  p.G = 1;
  while (p.G < 8 && p.nCB * p.G < 8 && chunks % (2 * p.G) == 0 &&
         3 * p.TW * CHUNK * 2 * p.G <= TILE_BYTES)
    p.G *= 2;
  p.lgG = p.G == 1 ? 0 : p.G == 2 ? 1 : p.G == 4 ? 2 : 3;
  const int row_bytes = p.TW * CHUNK * p.G;
  const int max_rows = TILE_BYTES / row_bytes;
  if (max_rows < 3) return 0;
  int th = min((max_rows - 3) / S + 1, p.Ho);
  const int bands = (p.Ho + th - 1) / th;
  p.TH = (p.Ho + bands - 1) / bands;
  const int runs = (8 + p.nCB * p.G - 1) / (p.nCB * p.G);  // a column block's
  p.R = max(1, (p.TH + runs - 1) / runs);
  return ((p.TH - 1) * S + 3) * row_bytes;
}

template <int S, int ACT>
int launch_tiled(const DwParams& p, int smem, int blocks, int threads,
                 cudaStream_t st) {
  // smem <= TILE_BYTES, under the 48 KB a launch may take without opting in
  if (p.out_kind == ak::OUT_S8)
    dw3x3_tiled<S, ACT, ak::OUT_S8><<<blocks, threads, smem, st>>>(p);
  else if (p.out_kind == ak::OUT_F32)
    dw3x3_tiled<S, ACT, ak::OUT_F32><<<blocks, threads, smem, st>>>(p);
  else
    dw3x3_tiled<S, ACT, ak::OUT_BF16><<<blocks, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_act(const DwParams& p, int smem, int blocks, int threads,
               cudaStream_t st) {
  switch (p.act) {
    case ak::ACT_RELU: return launch_tiled<S, ak::ACT_RELU>(p, smem, blocks, threads, st);
    case ak::ACT_RELU6: return launch_tiled<S, ak::ACT_RELU6>(p, smem, blocks, threads, st);
    case ak::ACT_LEAKY: return launch_tiled<S, ak::ACT_LEAKY>(p, smem, blocks, threads, st);
    default: return launch_tiled<S, ak::ACT_NONE>(p, smem, blocks, threads, st);
  }
}

}  // namespace

extern "C" int ak_depthwise3x3_int8(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int out_kind, int N, int H,
                                    int W, int C, int stride, int act,
                                    float alpha, float inv_out_scale,
                                    void* stream) {
  if (stride != 1 && stride != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (act != ak::ACT_NONE && act != ak::ACT_RELU && act != ak::ACT_RELU6 &&
      act != ak::ACT_LEAKY)
    return static_cast<int>(cudaErrorInvalidValue);
  DwParams p{};
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.act = act;
  p.alpha = alpha;
  p.out_kind = out_kind;
  p.inv_out_scale = inv_out_scale;
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                       ? plan_tiles(p) : 0;
  if (smem > 0) {
    const long long work = static_cast<long long>(N) *
                           ((p.Ho + p.TH - 1) / p.TH) *
                           ((C + CHUNK * p.G - 1) / (CHUNK * p.G));
    if (work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    // warps: a multiple of G, each chunk's share at most its items
    const int items = p.nCB * ((p.TH + p.R - 1) / p.R);
    const int threads = 32 * p.G * min(THREADS / 32 / p.G, items);
    return stride == 1
               ? launch_act<1>(p, smem, static_cast<int>(work), threads, s)
               : launch_act<2>(p, smem, static_cast<int>(work), threads, s);
  }
  const size_t threads = static_cast<size_t>(N) * p.Ho * p.Wo * C;
  const size_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidConfiguration);
  dw3x3_scalar_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
