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
// INT32_MIN and the sum can wrap negative, and C's / truncates.
//
// Bound: device memory. At [32, 512, 512] the forward moves 1 or 2 bytes
// of samples and 4 of coefficients a sample, the inverse 4 and 1 or 2;
// about 40 integer operations a sample (with a 32-bit divide a
// coefficient) come lower on the card's integer rate.
//
// Design (simple first): eight threads an 8×8 block, one row each; a CTA
// of 256 threads holds 32 blocks, consecutive in the output's
// [plane, block row, block column] order, so that a warp's four blocks are
// 1 KB of contiguous coefficients.
// - Forward: a thread loads its block row (one 8-, 16- or 32-byte load
//   where the row lies inside the plane and is aligned, else eight loads
//   at edge-clamped indices: the reference's edge replication, with no
//   padded copy), runs the row pass in registers, and writes it to its
//   block's tile in shared memory (8 rows at a pitch of 9 words: every
//   access of a warp hits 32 distinct banks); the same thread then reads
//   a column, runs the column pass, quantizes it and writes it back; the
//   warp finally stores its four blocks' 256 coefficients in zigzag order
//   as eight coalesced 128-byte rows.
// - Inverse: the warp loads its four blocks' 256 coefficients as eight
//   coalesced rows, dequantizes them into the tiles in raster order, and
//   each thread runs a column pass, then (after the transpose through the
//   tile) a row pass, shifts, clamps and stores its 8 output samples in
//   one store.
// - Only __syncwarp() orders the tile: a block's eight threads and its
//   tile belong to one warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = kThreads / 8;  // 8×8 blocks a CTA: a thread a row
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

// Zigzag scan order (T.81 Figure A.6): index i → raster position.
__device__ const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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

// dct_int.quantize_islow for one coefficient c and d = 8q (8 <= d <=
// 8 · 65535, checked by the wrapper): round half away from zero of c / d,
// with |c| and the sum wrapping and the division flooring as numpy's.
__device__ __forceinline__ int quantize(int c, int d) {
  const int mag = c < 0 ? wsub(0, c) : c;
  const int num = wadd(mag, d >> 1);
  int q = num / d;
  if (num < 0 && q * d != num) --q;  // C truncates; // floors
  return c < 0 ? wsub(0, q) : q;
}

// Eight samples of one type, moved in one aligned load or store.
template <typename T>
struct alignas(8 * sizeof(T)) Row8 {
  T v[8];
};

// Block row y of the block at column x0 of a plane row, less the level
// shift: one load inside the plane, else the edge-clamped columns.
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int x0, int w,
                                         int level_shift, int (&d)[8]) {
  const T* p = row + x0;
  if (x0 + 8 <= w &&
      reinterpret_cast<std::uintptr_t>(p) % sizeof(Row8<T>) == 0) {
    const Row8<T> r = *reinterpret_cast<const Row8<T>*>(p);
#pragma unroll
    for (int c = 0; c < 8; ++c) d[c] = wsub(static_cast<int>(r.v[c]),
                                            level_shift);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int xc = x0 + c < w ? x0 + c : w - 1;
      d[c] = wsub(static_cast<int>(row[xc]), level_shift);
    }
  }
}

// [P, H, W] samples of type T → [P, nby, nbx, 64] int32 zigzag coefficients.
template <typename T, int P1>
__global__ void __launch_bounds__(kThreads) jpeg_fdct_islow_kernel(
    const T* __restrict__ x, int* __restrict__ out,
    const int* __restrict__ qtable, int h, int w, int nbx,
    long long per_plane, long long n_blocks, int level_shift) {
  __shared__ int tile[kBlocks][8][kPitch];
  const int r = threadIdx.x & 7;   // the row, then the column, it runs
  const int lb = threadIdx.x >> 3;  // its block within the CTA
  const long long first = static_cast<long long>(blockIdx.x) * kBlocks;
  const long long g = first + lb;
  const bool live = g < n_blocks;

  int o[8];
  if (live) {
    const long long plane = g / per_plane;
    const int rem = static_cast<int>(g - plane * per_plane);
    const int by = rem / nbx;
    const int bx = rem - by * nbx;
    const int y = by * 8 + r < h ? by * 8 + r : h - 1;
    int d[8];
    load_row(x + (plane * h + y) * static_cast<long long>(w), bx * 8, w,
             level_shift, d);
    fdct_pass<false, P1>(d, o);  // o[u]: row y's frequency u
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
  __syncwarp();  // every column is read before the quantized ones land
  if (live) {
#pragma unroll
    for (int v = 0; v < 8; ++v)
      tile[lb][v][r] = quantize(o[v], __ldg(qtable + v * 8 + r) * 8);
  }
  __syncwarp();
  // the warp's four blocks, 256 coefficients in zigzag order: lane l
  // stores index l and l + 32 of each, eight coalesced 128-byte rows
  const int lane = threadIdx.x & 31;
  const int wb = (threadIdx.x >> 5) * 4;  // the warp's first block
  const int p_lo = __ldg(kZigzag + lane);
  const int p_hi = __ldg(kZigzag + lane + 32);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = wb + (k >> 1);
    const int p = (k & 1) ? p_hi : p_lo;
    if (first + b < n_blocks)
      out[(first + b) * 64 + lane + 32 * (k & 1)] = tile[b][p >> 3][p & 7];
  }
}

// [P, nby, nbx, 64] int32 zigzag coefficients → [P, nby * 8, nbx * 8]
// samples of type T in [0, max_val].
template <typename T, int P1>
__global__ void __launch_bounds__(kThreads) jpeg_idct_islow_kernel(
    const int* __restrict__ zz, T* __restrict__ out,
    const int* __restrict__ qtable, int nby, int nbx, long long per_plane,
    long long n_blocks, int level_shift, int max_val) {
  __shared__ int tile[kBlocks][8][kPitch];
  const long long first = static_cast<long long>(blockIdx.x) * kBlocks;
  // the warp's four blocks as eight coalesced rows, dequantized into the
  // tiles in raster order (the 12-bit profile halves them, rounding up)
  const int lane = threadIdx.x & 31;
  const int wb = (threadIdx.x >> 5) * 4;
  const int p_lo = __ldg(kZigzag + lane);
  const int p_hi = __ldg(kZigzag + lane + 32);
  const int q_lo = __ldg(qtable + p_lo);
  const int q_hi = __ldg(qtable + p_hi);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = wb + (k >> 1);
    const int p = (k & 1) ? p_hi : p_lo;
    int c = 0;
    if (first + b < n_blocks) c = zz[(first + b) * 64 + lane + 32 * (k & 1)];
    int dq = wmul(c, (k & 1) ? q_hi : q_lo);
    if (P1 == 1) dq = wadd(dq, 1) >> 1;
    tile[b][p >> 3][p & 7] = dq;
  }
  __syncwarp();
  const int r = threadIdx.x & 7;
  const int lb = threadIdx.x >> 3;
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

  const long long g = first + lb;
  if (g >= n_blocks) return;
  const long long plane = g / per_plane;
  const int rem = static_cast<int>(g - plane * per_plane);
  const int by = rem / nbx;
  const int bx = rem - by * nbx;
  Row8<T> px;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int v = wadd(o[c], level_shift);
    px.v[c] = static_cast<T>(v < 0 ? 0 : (v > max_val ? max_val : v));
  }
  const long long row = (plane * nby + by) * 8 + r;
  *reinterpret_cast<Row8<T>*>(out + row * nbx * 8 + bx * 8) = px;
}

template <typename T>
cudaError_t launch_fdct(const void* x, void* out, const int* qtable,
                        int h, int w, int nbx, long long per_plane,
                        long long n_blocks, int level_shift, unsigned grid,
                        cudaStream_t stream) {
  const T* src = static_cast<const T*>(x);
  int* dst = static_cast<int*>(out);
  if (level_shift >= 1024) {
    jpeg_fdct_islow_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        src, dst, qtable, h, w, nbx, per_plane, n_blocks, level_shift);
  } else {
    jpeg_fdct_islow_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        src, dst, qtable, h, w, nbx, per_plane, n_blocks, level_shift);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_idct(const void* zz, void* out, const int* qtable,
                        int nby, int nbx, long long per_plane,
                        long long n_blocks, int level_shift, int max_val,
                        unsigned grid, cudaStream_t stream) {
  const int* src = static_cast<const int*>(zz);
  T* dst = static_cast<T*>(out);
  if (level_shift >= 1024) {
    jpeg_idct_islow_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        src, dst, qtable, nby, nbx, per_plane, n_blocks, level_shift,
        max_val);
  } else {
    jpeg_idct_islow_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        src, dst, qtable, nby, nbx, per_plane, n_blocks, level_shift,
        max_val);
  }
  return cudaGetLastError();
}

// CTAs for n_blocks 8×8 blocks, or 0 when the grid would be too large.
unsigned grid_for(long long n_blocks) {
  const long long grid = (n_blocks + kBlocks - 1) / kBlocks;
  return grid <= 0x7fffffffLL ? static_cast<unsigned>(grid) : 0u;
}

}  // namespace

// dtype codes (ops/jpeg_islow.py, _kernels.JPEG_DTYPES): 0 uint8, 1 uint16,
// 2 int32. The pass-1 precision follows the level shift as
// dct_int.pass1_bits: 1 at 1024 and above, else 2.
extern "C" int gdct_jpeg_fdct_islow(const void* x, int dtype, void* out,
                                    const void* qtable, long long n_planes,
                                    int h, int w, int level_shift,
                                    void* stream) {
  if (n_planes < 0 || h < 1 || w < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nby = (h + 7) / 8;
  const int nbx = (w + 7) / 8;
  const long long per_plane = static_cast<long long>(nby) * nbx;
  const long long n_blocks = n_planes * per_plane;
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n_blocks);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int* q = static_cast<const int*>(qtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_fdct<std::uint8_t>(x, out, q, h, w, nbx, per_plane,
                                    n_blocks, level_shift, grid, s);
  } else if (dtype == 1) {
    err = launch_fdct<std::uint16_t>(x, out, q, h, w, nbx, per_plane,
                                     n_blocks, level_shift, grid, s);
  } else {
    err = launch_fdct<int>(x, out, q, h, w, nbx, per_plane, n_blocks,
                           level_shift, grid, s);
  }
  return static_cast<int>(err);
}

extern "C" int gdct_jpeg_idct_islow(const void* zz, void* out, int dtype,
                                    const void* qtable, long long n_planes,
                                    int nby, int nbx, int level_shift,
                                    int max_val, void* stream) {
  if (n_planes < 0 || nby < 1 || nbx < 1 || dtype < 0 || dtype > 2 ||
      max_val < 0 || reinterpret_cast<std::uintptr_t>(out) % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_plane = static_cast<long long>(nby) * nbx;
  const long long n_blocks = n_planes * per_plane;
  if (n_blocks == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(n_blocks);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int* q = static_cast<const int*>(qtable);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_idct<std::uint8_t>(zz, out, q, nby, nbx, per_plane,
                                    n_blocks, level_shift, max_val, grid, s);
  } else if (dtype == 1) {
    err = launch_idct<std::uint16_t>(zz, out, q, nby, nbx, per_plane,
                                     n_blocks, level_shift, max_val, grid,
                                     s);
  } else {
    err = launch_idct<int>(zz, out, q, nby, nbx, per_plane, n_blocks,
                           level_shift, max_val, grid, s);
  }
  return static_cast<int>(err);
}
