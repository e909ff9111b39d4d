// JPEG's integer islow DCT for Hopper: the forward stage (samples →
// quantized coefficients in zigzag order) and the inverse stage (zigzag
// coefficients → dequantized, inverse-transformed, shifted and clamped
// samples), one launch each.
//
// Replaces: the jnp stages encode_plane_to_zigzag and
// decode_zigzag_to_plane, go_dicom_codec_tpu/ops/dct8x8.py:177 and :197,
// which XLA fuses into one program each (the reference's .50/.51 device
// stage: go_dicom_codec_tpu/pipeline.py:383, codecs/jpeg_common.py:384).
// Both run the op sequence of ops/dct_int.py (libjpeg's islow: CONST_BITS
// 13, PASS1_BITS 2 for 8-bit samples and 1 above, fused dequantization),
// so that streams and pixels equal the numpy lane, the native mirror and
// the plain torch version bit for bit.
//
// Arithmetic: every + − × is int32 with two's-complement wraparound, done
// in unsigned (signed overflow is undefined in C++, and the reference's
// lanes wrap: 16-bit samples under the 12-bit profile give coefficients
// past int16 and products past int32); >> is the arithmetic shift of the
// signed value (the reference's _descale). The quantizer's
// (|c| + d/2) // d floors as numpy's and jnp's // do: |INT32_MIN| stays
// INT32_MIN and the sum can wrap negative.
//
// Bound: device memory in principle. At [32, 512, 512] the forward moves
// 1 or 2 bytes of samples and 4 of coefficients a sample, the inverse 2
// or 4 and 1 or 2; about 40 integer operations a sample come lower on the
// card's integer rate. In practice both kernels are held by instruction
// issue (a few hundred SASS instructions a warp's four blocks), so the
// design counts instructions.
//
// Design: eight threads an 8×8 block, one row each; a CTA of 256 threads
// holds 32 blocks of one plane, an R × C tile of the plane's block grid
// (C = 2^log_c the least power of two that covers the block columns, at
// most 32; R = 32 / C). A warp's four blocks are then one run of 256
// coefficients in the [P, nby, nbx, 64] layout (C >= 4: neighbours in a
// block row; C < 4: whole rows of nbx = C blocks), and its live blocks a
// prefix of the run.
// - No division on the card. The CTA's plane and tile come from blockIdx
//   (x holds a power of two of tiles a plane times the planes, so no
//   grid dimension's 65535 bounds the planes), its blocks from the
//   thread index, all by shifts and masks, and offsets inside a plane
//   are unsigned 32-bit (a plane of 65535² samples is 2^32 − 2^17 + 1 of
//   them). The quantizer divides by d = 8q through the host's exact
//   reciprocal of each table entry (ops/jpeg_islow.py `reciprocals`): for
//   n in [0, 2^31), ⌊n/d⌋ = umulhi(n, m) >> s with m = ⌈2^(31+l)/d⌉, l =
//   ⌈log2 d⌉, s = l − 1 (the round-up method for an invariant divisor:
//   m·d − 2^(31+l) < d ≤ 2^l); the sum num = |c| + d/2 wraps negative
//   only for |c| within d/2 of 2^31, and there numpy's ⌊num/d⌋ is
//   ~⌊~num/d⌋ with ~num < 2^31 (`quantize`).
// - Forward: a thread loads its block row (one 8-, 16- or 32-byte load
//   where the row lies inside the plane and is aligned, else eight loads
//   at edge-clamped indices: the reference's edge replication, with no
//   padded copy), runs the row pass in registers (the level shift taken
//   out of the row's sum alone), and writes it to its block's tile in
//   shared memory (8 rows at a pitch of 9 words: every access of a warp
//   hits 32 distinct banks); the same thread then reads a column, runs
//   the column pass and writes it back; each lane finally quantizes four
//   zigzag indices of two of its warp's blocks, with those entries'
//   reciprocals in registers (the host's table is in zigzag order), and
//   stores them in two 16-byte stores.
// - Inverse: each plane carries an index into a [T, 64] stack of tables
//   in zigzag order (luma and chroma, or frames with their own DQT, in
//   one launch; no index array means table 0). Each lane loads 16 bytes
//   of its warp's run of int16 or int32 coefficients at a time, widens
//   and dequantizes them into the tiles in raster order, and each thread
//   runs a column pass, then (after the transpose through the tile) a row
//   pass, shifts, clamps and stores its 8 output samples in one store.
// - Occupancy: both kernels are held to 32 registers (8 CTAs, 2048
//   threads an SM): a thread has one row of loads in flight, so the card
//   hides their latency with threads.
// - Only __syncwarp() orders the tile: a block's eight threads and its
//   tile belong to one warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLogBlocks = 5;
constexpr int kBlocks = 1 << kLogBlocks;  // 8×8 blocks a CTA
constexpr int kThreads = 8 * kBlocks;     // a thread a block row
constexpr int kMinBlocks = 8;  // CTAs an SM: 2048 threads, <= 32 registers
constexpr int kPitch = 9;              // words a tile row in shared memory

constexpr int kConstBits = 13;
constexpr int FIX_0_298631336 = 2446;
constexpr int FIX_0_390180644 = 3196;
constexpr int FIX_0_541196100 = 4433;
constexpr int FIX_0_765366865 = 6270;
constexpr int FIX_0_899976223 = 7373;
constexpr int FIX_1_175875602 = 9633;
constexpr int FIX_1_501321110 = 12299;
constexpr int FIX_1_847759065 = 15137;
constexpr int FIX_1_961570560 = 16069;
constexpr int FIX_2_053119869 = 16819;
constexpr int FIX_2_562915447 = 20995;
constexpr int FIX_3_072711026 = 25172;

// The tile word of each zigzag index (T.81 Figure A.6), four to an
// int4: raster position p at (p >> 3) * kPitch + (p & 7).
__device__ const int4 kZigzagTile[16] = {
    {0, 1, 9, 18},   {10, 2, 3, 11},  {19, 27, 36, 28}, {20, 12, 4, 5},
    {13, 21, 29, 37}, {45, 54, 46, 38}, {30, 22, 14, 6}, {7, 15, 23, 31},
    {39, 47, 55, 63}, {64, 56, 48, 40}, {32, 24, 16, 25}, {33, 41, 49, 57},
    {65, 66, 58, 50}, {42, 34, 43, 51}, {59, 67, 68, 60}, {52, 61, 69, 70}};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// (x + 2^(n-1)) >> n, the add wrapping, the shift arithmetic (n >= 1).
__device__ __forceinline__ int descale(int x, int n) {
  return wadd(x, 1 << (n - 1)) >> n;
}

// One 8-point forward islow pass (dct_int._fdct_pass): kFinal false is the
// row pass (even terms << p1, odd descaled by CONST_BITS - p1), true the
// column pass (even descaled by p1, odd by CONST_BITS + p1).
template <bool kFinal, int P1>
__device__ __forceinline__ void fdct_pass(const int (&d)[8], int (&o)[8]) {
  const int tmp0 = wadd(d[0], d[7]);
  const int tmp7 = wsub(d[0], d[7]);
  const int tmp1 = wadd(d[1], d[6]);
  const int tmp6 = wsub(d[1], d[6]);
  const int tmp2 = wadd(d[2], d[5]);
  const int tmp5 = wsub(d[2], d[5]);
  const int tmp3 = wadd(d[3], d[4]);
  const int tmp4 = wsub(d[3], d[4]);

  const int tmp10 = wadd(tmp0, tmp3);
  const int tmp13 = wsub(tmp0, tmp3);
  const int tmp11 = wadd(tmp1, tmp2);
  const int tmp12 = wsub(tmp1, tmp2);

  constexpr int kOddShift = kFinal ? kConstBits + P1 : kConstBits - P1;
  if (kFinal) {
    o[0] = descale(wadd(tmp10, tmp11), P1);
    o[4] = descale(wsub(tmp10, tmp11), P1);
  } else {
    o[0] = wmul(wadd(tmp10, tmp11), 1 << P1);
    o[4] = wmul(wsub(tmp10, tmp11), 1 << P1);
  }

  int z1 = wmul(wadd(tmp12, tmp13), FIX_0_541196100);
  o[2] = descale(wadd(z1, wmul(tmp13, FIX_0_765366865)), kOddShift);
  o[6] = descale(wsub(z1, wmul(tmp12, FIX_1_847759065)), kOddShift);

  z1 = wadd(tmp4, tmp7);
  int z2 = wadd(tmp5, tmp6);
  int z3 = wadd(tmp4, tmp6);
  int z4 = wadd(tmp5, tmp7);
  const int z5 = wmul(wadd(z3, z4), FIX_1_175875602);
  const int t4 = wmul(tmp4, FIX_0_298631336);
  const int t5 = wmul(tmp5, FIX_2_053119869);
  const int t6 = wmul(tmp6, FIX_3_072711026);
  const int t7 = wmul(tmp7, FIX_1_501321110);
  z1 = wmul(z1, -FIX_0_899976223);
  z2 = wmul(z2, -FIX_2_562915447);
  z3 = wadd(wmul(z3, -FIX_1_961570560), z5);
  z4 = wadd(wmul(z4, -FIX_0_390180644), z5);

  o[7] = descale(wadd(wadd(t4, z1), z3), kOddShift);
  o[5] = descale(wadd(wadd(t5, z2), z4), kOddShift);
  o[3] = descale(wadd(wadd(t6, z2), z3), kOddShift);
  o[1] = descale(wadd(wadd(t7, z1), z4), kOddShift);
}

// One 8-point inverse islow pass (dct_int._idct_pass): kFinal false is the
// column pass (descaled by CONST_BITS - p1), true the row pass (descaled by
// CONST_BITS + p1 + 3).
template <bool kFinal, int P1>
__device__ __forceinline__ void idct_pass(const int (&s)[8], int (&o)[8]) {
  int z2 = s[2];
  int z3 = s[6];
  int z1 = wmul(wadd(z2, z3), FIX_0_541196100);
  int tmp2 = wsub(z1, wmul(z3, FIX_1_847759065));
  int tmp3 = wadd(z1, wmul(z2, FIX_0_765366865));
  const int t0 = wmul(wadd(s[0], s[4]), 1 << kConstBits);
  const int t1 = wmul(wsub(s[0], s[4]), 1 << kConstBits);
  const int tmp10 = wadd(t0, tmp3);
  const int tmp13 = wsub(t0, tmp3);
  const int tmp11 = wadd(t1, tmp2);
  const int tmp12 = wsub(t1, tmp2);

  int tmp0 = s[7];
  int tmp1 = s[5];
  tmp2 = s[3];
  tmp3 = s[1];
  z1 = wadd(tmp0, tmp3);
  z2 = wadd(tmp1, tmp2);
  z3 = wadd(tmp0, tmp2);
  int z4 = wadd(tmp1, tmp3);
  const int z5 = wmul(wadd(z3, z4), FIX_1_175875602);
  tmp0 = wmul(tmp0, FIX_0_298631336);
  tmp1 = wmul(tmp1, FIX_2_053119869);
  tmp2 = wmul(tmp2, FIX_3_072711026);
  tmp3 = wmul(tmp3, FIX_1_501321110);
  z1 = wmul(z1, -FIX_0_899976223);
  z2 = wmul(z2, -FIX_2_562915447);
  z3 = wadd(wmul(z3, -FIX_1_961570560), z5);
  z4 = wadd(wmul(z4, -FIX_0_390180644), z5);
  tmp0 = wadd(wadd(tmp0, z1), z3);
  tmp1 = wadd(wadd(tmp1, z2), z4);
  tmp2 = wadd(wadd(tmp2, z2), z3);
  tmp3 = wadd(wadd(tmp3, z1), z4);

  constexpr int kShift = kFinal ? kConstBits + P1 + 3 : kConstBits - P1;
  o[0] = descale(wadd(tmp10, tmp3), kShift);
  o[7] = descale(wsub(tmp10, tmp3), kShift);
  o[1] = descale(wadd(tmp11, tmp2), kShift);
  o[6] = descale(wsub(tmp11, tmp2), kShift);
  o[2] = descale(wadd(tmp12, tmp1), kShift);
  o[5] = descale(wsub(tmp12, tmp1), kShift);
  o[3] = descale(wadd(tmp13, tmp0), kShift);
  o[4] = descale(wsub(tmp13, tmp0), kShift);
}

// dct_int.quantize_islow for one coefficient c by d = 8q (1 <= q <=
// 65535, checked by the host), from the entry's reciprocal m and hs =
// (d/2) << 5 | s: round half away from zero of c / d, |c| and the sum
// wrapping, the division flooring as numpy's, with no divide and no
// branch. num = |c| + d/2 as int32 is negative (wrapped) only in
// [−2^31, −2^31 + d/2], and there ⌊num/d⌋ = −⌈(2^32 − num)/d⌉ =
// ~⌊~num/d⌋ with ~num < 2^31: one reciprocal multiply serves both, the
// wrap as an xor mask.
__device__ __forceinline__ int quantize(int c, int m, int hs) {
  const unsigned mag = c < 0 ? 0u - static_cast<unsigned>(c)
                             : static_cast<unsigned>(c);
  const unsigned num = mag + (static_cast<unsigned>(hs) >> 5);  // no wrap
  const unsigned wrap = static_cast<unsigned>(static_cast<int>(num) >> 31);
  const unsigned quot =
      (__umulhi(num ^ wrap, static_cast<unsigned>(m)) >> (hs & 31)) ^ wrap;
  return c < 0 ? static_cast<int>(0u - quot) : static_cast<int>(quot);
}

// Eight samples of one type, moved in one aligned load or store.
template <typename T>
struct alignas(8 * sizeof(T)) Row8 {
  T v[8];
};

// Block row y of the block at column x0 of a plane row: one load inside
// the plane, else the edge-clamped columns.
template <typename T>
__device__ __forceinline__ void load_row(const T* row, unsigned x0,
                                         unsigned w, int (&d)[8]) {
  const T* p = row + x0;
  if (x0 + 8 <= w &&
      (reinterpret_cast<std::uintptr_t>(p) & (sizeof(Row8<T>) - 1)) == 0) {
    const Row8<T> r = *reinterpret_cast<const Row8<T>*>(p);
#pragma unroll
    for (int c = 0; c < 8; ++c) d[c] = static_cast<int>(r.v[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned xc = x0 + c < w ? x0 + c : w - 1;
      d[c] = static_cast<int>(row[xc]);
    }
  }
}

// Coefficients of type C (int16 or int32) in sixteen bytes.
template <typename C>
constexpr int kPer16 = sizeof(C) == 2 ? 8 : 4;

// Sixteen bytes of coefficients, moved in one load or store.
template <typename C>
struct alignas(16) Vec16 {
  C v[kPer16<C>];
};

// The launch's geometry: the plane's block grid, the CTA tile's columns
// as a power of two, and the sizes of a plane in and out.
struct Geometry {
  unsigned h, w;           // samples a plane (the inverse: nby·8, nbx·8)
  unsigned nby, nbx;       // blocks a plane
  int log_c;               // CTA tile: 2^log_c blocks across, 32 >> log_c down
  int log_gx;              // 2^log_gx CTA tiles across a plane in grid x
  long long plane_in;      // elements a plane of the input
  long long plane_out;     // elements a plane of the output
};

// The plane of this thread's CTA: grid x holds 2^log_gx tiles a plane.
__device__ __forceinline__ long long plane_of(const Geometry& g) {
  return blockIdx.x >> g.log_gx;
}

// The block this thread's CTA tile puts at local index lb: (by, bx).
__device__ __forceinline__ void block_of(const Geometry& g, int lb,
                                         unsigned& by, unsigned& bx) {
  const unsigned cx = blockIdx.x & ((1u << g.log_gx) - 1);
  bx = (cx << g.log_c) + (lb & ((1 << g.log_c) - 1));
  by = (blockIdx.y << (kLogBlocks - g.log_c)) + (lb >> g.log_c);
}

// [P, H, W] samples of type T → [P, nby, nbx, 64] int32 zigzag
// coefficients; recip holds each zigzag index's {m, hs} (``quantize``).
template <typename T, int P1>
__global__ void __launch_bounds__(kThreads, kMinBlocks) jpeg_fdct_islow_kernel(
    const T* __restrict__ x, int* __restrict__ out,
    const int4* __restrict__ recip, Geometry g, int level_shift) {
  __shared__ int tile[kBlocks][8][kPitch];
  const int r = threadIdx.x & 7;   // the row, then the column, it runs
  const int lb = threadIdx.x >> 3;  // its block within the CTA
  unsigned by, bx;
  block_of(g, lb, by, bx);
  const bool live = by < g.nby && bx < g.nbx;
  const long long plane = plane_of(g);
  int o[8];
  if (live) {
    const unsigned y = by * 8 + r < g.h ? by * 8 + r : g.h - 1;
    int d[8];
    load_row(x + plane * g.plane_in + y * g.w, bx * 8, g.w, d);
    fdct_pass<false, P1>(d, o);  // o[u]: row y's frequency u
    // the level shift, taken out of the samples: mod 2^32 it moves only
    // the sum of the eight, o[0]
    o[0] = wsub(o[0], wmul(level_shift, 8 << P1));
#pragma unroll
    for (int c = 0; c < 8; ++c) tile[lb][r][c] = o[c];
  }
  __syncwarp();
  if (live) {
    int d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = tile[lb][k][r];
    fdct_pass<true, P1>(d, o);  // o[v]: coefficient (v, u = r)
  }
  __syncwarp();  // every column is read before the coefficients land
  if (live) {
#pragma unroll
    for (int v = 0; v < 8; ++v) tile[lb][v][r] = o[v];
  }
  __syncwarp();
  // The warp's four blocks are one run of 256 coefficients in out (C >= 4:
  // neighbours in a block row; else whole rows of nbx = C blocks), and
  // the live ones a prefix of it. Lane l quantizes and stores zigzag
  // indices z0..z0 + 3 (z0 = 4l mod 64) of blocks l / 16 and l / 16 + 2
  // as two 16-byte stores.
  const int lane = threadIdx.x & 31;
  const int wb = (threadIdx.x >> 5) * 4;
  const int z0 = (lane * 4) & 63;
  const int4 t = __ldg(kZigzagTile + (z0 >> 2));
  const int4 ka = __ldg(recip + (z0 >> 1));  // entries z0, z0 + 1
  const int4 kb = __ldg(recip + (z0 >> 1) + 1);
  unsigned wy, wx;
  block_of(g, wb, wy, wx);
  int* ow = out + plane * g.plane_out + (wy * g.nbx + wx) * 64 + lane * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = (lane >> 4) + 2 * h;
    unsigned jy, jx;
    block_of(g, wb + j, jy, jx);
    if (jy < g.nby && jx < g.nbx) {
      const int* tb = &tile[wb + j][0][0];
      int4 v;
      v.x = quantize(tb[t.x], ka.x, ka.y);
      v.y = quantize(tb[t.y], ka.z, ka.w);
      v.z = quantize(tb[t.z], kb.x, kb.y);
      v.w = quantize(tb[t.w], kb.z, kb.w);
      *reinterpret_cast<int4*>(ow + 128 * h) = v;
    }
  }
}

// [P, nby, nbx, 64] zigzag coefficients of type C (int16 or int32) →
// [P, nby * 8, nbx * 8] samples of type T in [0, max_val], plane p
// dequantized by table tidx[p] of the [T, 64] stack, in zigzag order
// (table 0 without tidx).
template <typename C, typename T, int P1>
__global__ void __launch_bounds__(kThreads, kMinBlocks) jpeg_idct_islow_kernel(
    const C* __restrict__ zz, T* __restrict__ out,
    const int* __restrict__ qtables, const int* __restrict__ tidx,
    Geometry g, int level_shift, int max_val) {
  constexpr int kPer = kPer16<C>;            // coefficients a load: 8 or 4
  constexpr int kLoads = sizeof(C) >> 1;     // loads a lane: 1 or 2
  __shared__ int tile[kBlocks][8][kPitch];
  const int r = threadIdx.x & 7;
  const int lb = threadIdx.x >> 3;
  unsigned by, bx;
  block_of(g, lb, by, bx);
  const long long plane = plane_of(g);
  // The warp's four blocks are one run of 256 coefficients in zz, the live
  // ones a prefix (as in the forward). Lane l loads zigzag indices z0..z0 +
  // kPer − 1 (z0 = kPer·l mod 64) of block kPer·l / 64 (and, from int32,
  // of the block two on) in 16-byte loads, and dequantizes them into the
  // tiles in raster order (the 12-bit profile halves them, rounding up).
  const int lane = threadIdx.x & 31;
  const int wb = (threadIdx.x >> 5) * 4;
  const int z0 = (lane * kPer) & 63;
  const int* qz = qtables + (tidx ? __ldg(tidx + plane) : 0) * 64 + z0;
  int q[kPer], t[kPer];
#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const int4 qv = __ldg(reinterpret_cast<const int4*>(qz + i));
    const int4 tv = __ldg(kZigzagTile + ((z0 + i) >> 2));
    q[i] = qv.x, q[i + 1] = qv.y, q[i + 2] = qv.z, q[i + 3] = qv.w;
    t[i] = tv.x, t[i + 1] = tv.y, t[i + 2] = tv.z, t[i + 3] = tv.w;
  }
  unsigned wy, wx;
  block_of(g, wb, wy, wx);
  const C* zw = zz + plane * g.plane_in + (wy * g.nbx + wx) * 64;
#pragma unroll
  for (int h = 0; h < kLoads; ++h) {
    const int e = (h * 32 + lane) * kPer;  // the lane's first coefficient
    const int j = e >> 6;
    unsigned jy, jx;
    block_of(g, wb + j, jy, jx);
    Vec16<C> c{};
    if (jy < g.nby && jx < g.nbx)
      c = *reinterpret_cast<const Vec16<C>*>(zw + e);
    int* tb = &tile[wb + j][0][0];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int dq = wmul(static_cast<int>(c.v[i]), q[i]);
      if (P1 == 1) dq = wadd(dq, 1) >> 1;
      tb[t[i]] = dq;
    }
  }
  __syncwarp();
  int s[8], o[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) s[v] = tile[lb][v][r];
  idct_pass<false, P1>(s, o);  // column u = r: o[y]
  __syncwarp();  // every column is read before the pass results land
#pragma unroll
  for (int y = 0; y < 8; ++y) tile[lb][y][r] = o[y];
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 8; ++u) s[u] = tile[lb][r][u];
  idct_pass<true, (P1 == 1 ? 0 : P1)>(s, o);  // row y = r: o[x]
  if (by >= g.nby || bx >= g.nbx) return;
  Row8<T> px;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int v = wadd(o[c], level_shift);
    px.v[c] = static_cast<T>(v < 0 ? 0 : (v > max_val ? max_val : v));
  }
  T* op = out + plane * g.plane_out;
  *reinterpret_cast<Row8<T>*>(op + (by * 8 + r) * g.w + bx * 8) = px;
}

// The grid of a launch over n_planes planes of g: x the plane's CTA
// tiles across (rounded up to a power of two, so that a CTA finds its
// plane and tile by a shift and a mask; the surplus tiles hold no block)
// times the planes, y the tiles down. Fills g.log_c and g.log_gx; x 0
// when the planes pass the grid.
dim3 grid_of(Geometry& g, long long n_planes) {
  g.log_c = 0;
  while ((1u << g.log_c) < g.nbx && g.log_c < kLogBlocks) ++g.log_c;
  const unsigned across = (g.nbx + (1u << g.log_c) - 1) >> g.log_c;
  g.log_gx = 0;
  while ((1u << g.log_gx) < across) ++g.log_gx;
  const unsigned rows = kLogBlocks - g.log_c;
  const long long x = n_planes << g.log_gx;
  return dim3(x <= 0x7fffffffLL ? static_cast<unsigned>(x) : 0u,
              (g.nby + (1u << rows) - 1) >> rows, 1);
}

// Runs fn on the card of ``device``, making it current for the call.
template <typename Fn>
cudaError_t on_device(int device, Fn fn) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return err;
  fn();
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

template <typename T>
void launch_fdct(const void* x, void* out, const int4* recip, Geometry g,
                 dim3 grid, int level_shift, cudaStream_t stream) {
  const T* src = static_cast<const T*>(x);
  int* dst = static_cast<int*>(out);
  if (level_shift >= 1024) {
    jpeg_fdct_islow_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        src, dst, recip, g, level_shift);
  } else {
    jpeg_fdct_islow_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        src, dst, recip, g, level_shift);
  }
}

template <typename C, typename T>
void launch_idct(const void* zz, void* out, const int* qtables,
                 const int* tidx, Geometry g, dim3 grid, int level_shift,
                 int max_val, cudaStream_t stream) {
  const C* src = static_cast<const C*>(zz);
  T* dst = static_cast<T*>(out);
  if (level_shift >= 1024) {
    jpeg_idct_islow_kernel<C, T, 1><<<grid, kThreads, 0, stream>>>(
        src, dst, qtables, tidx, g, level_shift, max_val);
  } else {
    jpeg_idct_islow_kernel<C, T, 2><<<grid, kThreads, 0, stream>>>(
        src, dst, qtables, tidx, g, level_shift, max_val);
  }
}

template <typename C>
void launch_idct_out(int dtype, const void* zz, void* out,
                     const int* qtables, const int* tidx, Geometry g,
                     dim3 grid, int level_shift, int max_val,
                     cudaStream_t stream) {
  if (dtype == 0) {
    launch_idct<C, std::uint8_t>(zz, out, qtables, tidx, g, grid,
                                 level_shift, max_val, stream);
  } else if (dtype == 1) {
    launch_idct<C, std::uint16_t>(zz, out, qtables, tidx, g, grid,
                                  level_shift, max_val, stream);
  } else {
    launch_idct<C, int>(zz, out, qtables, tidx, g, grid, level_shift,
                        max_val, stream);
  }
}

}  // namespace

// dtype codes (ops/jpeg_islow.py, _kernels.JPEG_DTYPES): 0 uint8, 1 uint16,
// 2 int32; coefficient codes (_kernels.JPEG_COEF_DTYPES): 0 int16, 1
// int32. The pass-1 precision follows the level shift as
// dct_int.pass1_bits: 1 at 1024 and above, else 2. Sides are at most
// 65535 samples (DICOM's); the caller checks the tables' values.
extern "C" int gdct_jpeg_fdct_islow(const void* x, int dtype, void* out,
                                    const void* recip, long long n_planes,
                                    int h, int w, int level_shift, int device,
                                    void* stream) {
  if (n_planes < 0 || h < 1 || w < 1 || h > 65535 || w > 65535 ||
      dtype < 0 || dtype > 2 ||
      (reinterpret_cast<std::uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_planes == 0) return static_cast<int>(cudaSuccess);
  Geometry g{static_cast<unsigned>(h), static_cast<unsigned>(w),
             static_cast<unsigned>((h + 7) >> 3),
             static_cast<unsigned>((w + 7) >> 3), 0, 0,
             static_cast<long long>(h) * w, 0};
  g.plane_out = static_cast<long long>(g.nby) * g.nbx * 64;
  const dim3 grid = grid_of(g, n_planes);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int4* k = static_cast<const int4*>(recip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    if (dtype == 0) {
      launch_fdct<std::uint8_t>(x, out, k, g, grid, level_shift, s);
    } else if (dtype == 1) {
      launch_fdct<std::uint16_t>(x, out, k, g, grid, level_shift, s);
    } else {
      launch_fdct<int>(x, out, k, g, grid, level_shift, s);
    }
  }));
}

extern "C" int gdct_jpeg_idct_islow(const void* zz, int coef_dtype,
                                    void* out, int dtype,
                                    const void* qtables, const void* tidx,
                                    long long n_planes, int nby, int nbx,
                                    int level_shift, int max_val, int device,
                                    void* stream) {
  if (n_planes < 0 || nby < 1 || nbx < 1 || nby > 8192 || nbx > 8192 ||
      dtype < 0 || dtype > 2 || coef_dtype < 0 || coef_dtype > 1 ||
      max_val < 0 || (reinterpret_cast<std::uintptr_t>(out) & 31) != 0 ||
      (reinterpret_cast<std::uintptr_t>(zz) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_planes == 0) return static_cast<int>(cudaSuccess);
  Geometry g{static_cast<unsigned>(nby) * 8, static_cast<unsigned>(nbx) * 8,
             static_cast<unsigned>(nby), static_cast<unsigned>(nbx), 0, 0,
             static_cast<long long>(nby) * nbx * 64,
             static_cast<long long>(nby) * nbx * 64};
  const dim3 grid = grid_of(g, n_planes);
  if (grid.x == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int* q = static_cast<const int*>(qtables);
  const int* t = static_cast<const int*>(tidx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(on_device(device, [&] {
    if (coef_dtype == 0) {
      launch_idct_out<std::int16_t>(dtype, zz, out, q, t, g, grid,
                                    level_shift, max_val, s);
    } else {
      launch_idct_out<int>(dtype, zz, out, q, t, g, grid, level_shift,
                           max_val, s);
    }
  }));
}
