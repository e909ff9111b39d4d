// Irreversible 9/7 lifting (ISO/IEC 15444-1 Annex F) in float32: the 2D
// tile pass that the lossy stages of j2k97_fwd_stage.cu and
// j2k97_inv_stage.cu share, on the 5/3's frame (lifting.cuh: the level
// table, the symmetric fold, the buffer's even-columns-first layout, the
// plane groups and the cooperative launch helpers).
//
// A level of the 9/7 over a window of w×h samples is one pass over output
// tiles of T×T samples. A block lifts a tile from buffers of (T+2·kHalo)²
// floats: the tile and a halo of kHalo samples on each side, read through
// whole-sample symmetric extension (fold), which is the reference's edge
// clamp for both parities. Each lifting step is a symmetric two-tap sum,
// so the extension commutes with it, in float32 too: a mirrored sample
// adds the same two operands in swapped order, and IEEE addition
// commutes. Every step at e reads e-1 and e+1, so a halo of one sample a
// step makes every sample of the tile come out as a pass over whole
// lines gives it: 4 for the forward (its four steps), 6 for the inverse
// (the reference's six, two of them with a coefficient of 0.0, which
// still turn -0.0 into +0.0 and an inf into a NaN).
//
// Arithmetic: each operation rounded once, in the reference's order
// (go_dicom_codec_tpu/ops/dwt97.py): a step is d + c * (l + r), the sum
// first, then the product, then the add. __fadd_rn and __fmul_rn are never
// contracted into a fused multiply-add, whatever nvcc's -fmad.
//
// An axis of one sample is not transformed at all, at either parity: no
// lifting and no K or 1/K scaling (the reference's fwd97_2d and inv97_2d).

#pragma once

#include <cuda_runtime.h>

#include "lifting.cuh"

namespace gdct97 {

using gdct::kThreads;
using gdct::Walk;
using gdct::xs;

// The float32 roundings of the reference's constants (a Python float times
// a float32 array is float32 in jnp and torch), as hexadecimal literals.
constexpr float kAlpha = -0x1.960ce6p+0f;  // -1.586134342
constexpr float kBeta = -0x1.b2035cp-5f;   // -0.052980118
constexpr float kGamma = 0x1.c40cecp-1f;   // 0.882911075
constexpr float kDelta = 0x1.c626aap-2f;   // 0.443506852
constexpr float kK = 0x1.3aecb0p+0f;       // 1.230174105
constexpr float kInvK = 0x1.a03386p-1f;    // 0.812893066

// The ICT (ops/mct.py): forward rows Y, Cb, Cr of R, G, B; inverse.
constexpr float kYr = 0x1.322d0ep-2f, kYg = 0x1.2c8b44p-1f,
                kYb = 0x1.d2f1aap-4f;  // 0.299, 0.587, 0.114
constexpr float kCbr = -0x1.59999ap-3f, kCbg = -0x1.5335d2p-2f,
                kCbb = 0x1.000000p-1f;  // -0.16875, -0.331260, 0.5
constexpr float kCrr = 0x1.000000p-1f, kCrg = -0x1.acbd12p-2f,
                kCrb = -0x1.4d0bb6p-4f;  // 0.5, -0.41869, -0.08131
constexpr float kInvCr = 0x1.66e978p+0f;    // 1.402
constexpr float kInvCbG = -0x1.60639ep-2f;  // -0.34413
constexpr float kInvCrG = -0x1.6da3c2p-1f;  // -0.71414
constexpr float kInvCb = 0x1.c5a1cap+0f;    // 1.772

// d + c * (l + r), each operation rounded once.
__device__ __forceinline__ float lift(float d, float c, float l, float r) {
  return __fadd_rn(d, __fmul_rn(c, __fadd_rn(l, r)));
}

// (c0 * a + c1 * b) + c2 * e, each operation rounded once: a row of the
// forward ICT.
__device__ __forceinline__ float dot3(float c0, float a, float c1, float b,
                                      float c2, float e) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, a), __fmul_rn(c1, b)),
                   __fmul_rn(c2, e));
}

// One tile of a level window and its buffers' geometry (lifting.cuh::Tile
// with a halo of kHalo samples). The ext rows and columns of a buffer are
// the tile's and kHalo more on each side; ext index e sits at window
// position (tile origin - kHalo + e). kHalo is even, and tile origins are
// multiples of the even tile side, so e has the parity of its window
// position.
template <int kHalo>
struct Tile {
  static_assert(kHalo % 2 == 0, "the halo keeps parity");
  int pitch, hx, words;    // (T + 2·kHalo) words a row, odds from hx
  int ty0, tx0, tey, tex;  // origin and extent in the window
  int eyn, exn;            // ext rows and columns: extent + 2·kHalo

  __device__ __forceinline__ Tile(int t, int w, int h, int ty, int tx)
      : pitch(t + 2 * kHalo),
        hx((t + 2 * kHalo) >> 1),
        words((t + 2 * kHalo) * (t + 2 * kHalo)),
        ty0(ty * t),
        tx0(tx * t),
        tey(min(t, h - ty * t)),
        tex(min(t, w - tx * t)),
        eyn(min(t, h - ty * t) + 2 * kHalo),
        exn(min(t, w - tx * t) + 2 * kHalo) {}
};

// Shared memory of one buffer of tile side t, in floats.
__host__ __device__ __forceinline__ int tile_words(int t, int halo) {
  return (t + 2 * halo) * (t + 2 * halo);
}

// Loads a tile's ext samples into its kNb buffers: thread i takes ext
// columns i % 64 and i % 64 + 64 (exn <= 64 + 2·kHalo <= 128) of rows
// i / 64, i / 64 + 4, ...; kLoadRows rows' loads are issued before any of
// them is stored. src.fetch<kNb>(y, x, v) reads the kNb values of window
// position (y, x) (any y, x: it folds them), as floats.
template <int kHalo, int kNb, typename Src>
__device__ __forceinline__ void load_tile(const Src& src,
                                          const Tile<kHalo>& t, float* buf) {
  constexpr int kLoadRows = kNb == 1 ? 4 : 2;
  const int c = threadIdx.x & 63;
  const int cols = c + 64 < t.exn ? 2 : (c < t.exn ? 1 : 0);
  const int s0 = xs(c, t.hx), s1 = xs(c + 64, t.hx);
  for (int y = threadIdx.x >> 6; y < t.eyn; y += 4 * kLoadRows) {
    float v[kLoadRows][2][kNb];
#pragma unroll
    for (int j = 0; j < kLoadRows; ++j) {
      const int yy = y + 4 * j;
      if (yy < t.eyn && cols > 0) {
        src.template fetch<kNb>(t.ty0 - kHalo + yy, t.tx0 - kHalo + c,
                                v[j][0]);
        if (cols > 1) {
          src.template fetch<kNb>(t.ty0 - kHalo + yy, t.tx0 - kHalo + 64 + c,
                                  v[j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadRows; ++j) {
      const int yy = y + 4 * j;
      if (yy < t.eyn && cols > 0) {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          buf[k * t.words + yy * t.pitch + s0] = v[j][0][k];
          if (cols > 1) buf[k * t.words + yy * t.pitch + s1] = v[j][1][k];
        }
      }
    }
  }
  __syncthreads();
}

// A lifting step along y in kNb buffers: b[e] = lift(b[e], c, b[e-1],
// b[e+1]) at rows e = first, first + 2, ... (count of them), in every
// stored column. Ends with a block barrier.
template <int kHalo, int kNb>
__device__ __forceinline__ void step_y(float* buf, const Tile<kHalo>& t,
                                       int first, int count, float c) {
  if (count <= 0) return;
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float* b = buf + k * t.words + first * t.pitch;
    for (Walk w(t.pitch); w.s < count; w.next()) {
      float* p = b + 2 * w.s * t.pitch + w.f;
      *p = lift(*p, c, p[-t.pitch], p[t.pitch]);
    }
  }
  __syncthreads();
}

// The same along x: columns e = first, first + 2, ... (count) of rows
// [y_lo, y_hi), consecutive words in a buffer row, as their neighbours.
template <int kHalo, int kNb>
__device__ __forceinline__ void step_x(float* buf, const Tile<kHalo>& t,
                                       int first, int count, float c,
                                       int y_lo, int y_hi) {
  if (count <= 0) return;
  const int c0 = xs(first, t.hx), cl = xs(first - 1, t.hx),
            cr = xs(first + 1, t.hx);
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float* b = buf + k * t.words + y_lo * t.pitch;
    for (Walk w(count); w.s < y_hi - y_lo; w.next()) {
      float* row = b + w.s * t.pitch + w.f;
      row[c0] = lift(row[c0], c, row[cl], row[cr]);
    }
  }
  __syncthreads();
}

// Scales the low samples (parity lo) by `low` and the high ones by `high`
// in rows [y_lo, y_hi) of every stored column: along y a row's parity
// decides, along x (by_x) a column's (the words from hx on are the odd
// columns).
template <int kHalo, int kNb>
__device__ __forceinline__ void scale(float* buf, const Tile<kHalo>& t,
                                      bool by_x, int lo, float low,
                                      float high, int y_lo, int y_hi) {
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    float* b = buf + k * t.words + y_lo * t.pitch;
    for (Walk w(t.pitch); w.s < y_hi - y_lo; w.next()) {
      const int parity = by_x ? (w.f >= t.hx) : ((y_lo + w.s) & 1);
      float* p = b + w.s * t.pitch + w.f;
      *p = __fmul_rn(*p, parity == lo ? low : high);
    }
  }
  __syncthreads();
}

// The first ext index >= 1 of parity p, and how many of that parity lie in
// [first, n - 2]: the positions of a step over n ext samples.
__device__ __forceinline__ int first_of(int p) { return p ? 1 : 2; }
__device__ __forceinline__ int count_of(int n, int p) {
  return (n - first_of(p)) / 2;
}

// The forward 9/7 of a loaded tile: along y (every buffer column) the
// predict-update pairs (α, β), (γ, δ), then low × 1/K and high × K on the
// tile's rows; then the same along x on the tile's rows. lo_x, lo_y: the
// low samples' parity (0 at an even window origin); w, h: the window's
// size (a side of 1 is not transformed).
template <int kHalo, int kNb>
__device__ __forceinline__ void fwd_lift(float* buf, const Tile<kHalo>& t,
                                         int lo_x, int lo_y, int w, int h) {
  const int y_lo = kHalo, y_hi = kHalo + t.tey;
  if (h > 1) {
    const int d = 1 - lo_y, s = lo_y;
    step_y<kHalo, kNb>(buf, t, first_of(d), count_of(t.eyn, d), kAlpha);
    step_y<kHalo, kNb>(buf, t, first_of(s), count_of(t.eyn, s), kBeta);
    step_y<kHalo, kNb>(buf, t, first_of(d), count_of(t.eyn, d), kGamma);
    step_y<kHalo, kNb>(buf, t, first_of(s), count_of(t.eyn, s), kDelta);
    scale<kHalo, kNb>(buf, t, false, lo_y, kInvK, kK, y_lo, y_hi);
  }
  if (w > 1) {
    const int d = 1 - lo_x, s = lo_x;
    step_x<kHalo, kNb>(buf, t, first_of(d), count_of(t.exn, d), kAlpha, y_lo,
                       y_hi);
    step_x<kHalo, kNb>(buf, t, first_of(s), count_of(t.exn, s), kBeta, y_lo,
                       y_hi);
    step_x<kHalo, kNb>(buf, t, first_of(d), count_of(t.exn, d), kGamma, y_lo,
                       y_hi);
    step_x<kHalo, kNb>(buf, t, first_of(s), count_of(t.exn, s), kDelta, y_lo,
                       y_hi);
    scale<kHalo, kNb>(buf, t, true, lo_x, kInvK, kK, y_lo, y_hi);
  }
}

// The inverse 9/7 of a loaded tile (buffers hold the ext coefficients in
// interleaved order): along x over every buffer row, low × K and high ×
// 1/K, then the pairs (0, -δ), (-γ, -β), (-α, 0) as the reference runs
// them; then the same along y over every buffer column.
template <int kHalo, int kNb>
__device__ __forceinline__ void inv_lift(float* buf, const Tile<kHalo>& t,
                                         int lo_x, int lo_y, int w, int h) {
  if (w > 1) {
    const int d = 1 - lo_x, s = lo_x;
    const int fd = first_of(d), nd = count_of(t.exn, d);
    const int fs = first_of(s), ns = count_of(t.exn, s);
    scale<kHalo, kNb>(buf, t, true, lo_x, kK, kInvK, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fd, nd, 0.0f, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fs, ns, -kDelta, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fd, nd, -kGamma, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fs, ns, -kBeta, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fd, nd, -kAlpha, 0, t.eyn);
    step_x<kHalo, kNb>(buf, t, fs, ns, 0.0f, 0, t.eyn);
  }
  if (h > 1) {
    const int d = 1 - lo_y, s = lo_y;
    const int fd = first_of(d), nd = count_of(t.eyn, d);
    const int fs = first_of(s), ns = count_of(t.eyn, s);
    scale<kHalo, kNb>(buf, t, false, lo_y, kK, kInvK, 0, t.eyn);
    step_y<kHalo, kNb>(buf, t, fd, nd, 0.0f);
    step_y<kHalo, kNb>(buf, t, fs, ns, -kDelta);
    step_y<kHalo, kNb>(buf, t, fd, nd, -kGamma);
    step_y<kHalo, kNb>(buf, t, fs, ns, -kBeta);
    step_y<kHalo, kNb>(buf, t, fd, nd, -kAlpha);
    step_y<kHalo, kNb>(buf, t, fs, ns, 0.0f);
  }
}

}  // namespace gdct97
