// Irreversible 9/7 lifting (ISO/IEC 15444-1 Annex F) in float32: the
// register-resident strip pass that the lossy stages of j2k97_fwd_stage.cu
// and j2k97_inv_stage.cu share, after the register-based DWT of Enfedaque,
// Auli-Llinàs and Moure (IEEE TPDS 26(12), 2015), on the 5/3's frame
// (lifting.cuh: the symmetric fold, the plane groups, the cooperative
// launch helpers).
//
// A level of the 9/7 over a window of w×h samples is one pass over work
// items: strips of L lanes of a warp (L = 4, 8, 16 or 32, from the level's
// table row; a warp runs 32 / L strips side by side) and segments of S
// output rows (from the row too). Lane l of a strip holds kPairs pairs of
// ext columns, the kCols = 2·kPairs columns from x = xo + kCols·l, with
// xo = (the strip's first output column) - kHalo + lo_x, so that each
// pair is a low sample and the high sample right of it, whatever the
// window's origin parity. A strip yields kCols·L - 2·kHalo output
// columns: 120 forward and 116 inverse at 32 lanes. A segment walks its
// rows as pairs, a low row and the high row below it, from yo = (its
// first row) - kHalo + lo_y down, S/2 + kHalo pairs.
//
// - Along x, a step at a column reads its two neighbours: the lane's own
//   samples and, at a lane's ends, the neighbouring lane's, through
//   __shfl_up_sync and __shfl_down_sync: one shuffle a step, row and
//   plane. No shared memory, no barrier.
// - Along y, the steps run in registers as a rolling window (Column): as
//   pair q arrives, every step fires whose two neighbours now exist, and
//   pair q - kSteps / 2 comes out final. A lane keeps two rows of state a
//   step pair (its columns, each plane), not the segment.
// - Inside a level the warps share nothing; a level ends at a grid barrier
//   (grid rows) or, in the head (the coarse levels, one block a plane
//   group), at a block barrier.
//
// Halos are loaded through whole-sample symmetric extension (fold), the
// reference's edge clamp for both parities. Each lifting step is a
// symmetric two-tap sum, so the extension commutes with it, in float32
// too: a mirrored sample adds the same two operands in swapped order, and
// IEEE addition commutes. Each step spoils one more sample at each end of a
// strip or a segment (the lanes and rows past its ends are not there), so a
// halo of one sample a step leaves every output sample as a pass over whole
// lines gives it: 4 for the forward (its four steps), 6 for the inverse
// (the reference's six, two of them with a coefficient of 0.0, which still
// turn -0.0 into +0.0 and an inf into a NaN).
//
// Arithmetic: each operation rounded once, in the reference's order
// (go_dicom_codec_tpu/ops/dwt97.py): a step is d + c * (l + r), the sum
// first, then the product, then the add. __fadd_rn and __fmul_rn are never
// contracted into a fused multiply-add, whatever nvcc's -fmad. The scale
// by K or 1/K is its own multiply.
//
// An axis of one sample is not transformed at all, at either parity: no
// lifting and no K or 1/K scaling (the reference's fwd97_2d and inv97_2d).

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "lifting.cuh"

namespace gdct97 {

using gdct::kThreads;
constexpr int kWarps = kThreads / 32;
// The pairs of columns (a low one, the high one right of it) a lane
// holds: a strip of L lanes is kCols · L ext columns.
constexpr int kPairs = 2;
constexpr int kCols = 2 * kPairs;

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

// The lifting steps of a side, in the reference's order: step i lifts the
// high samples (i even) or the low ones (i odd). Forward: the pairs
// (α, β), (γ, δ); inverse: (0, -δ), (-γ, -β), (-α, 0).
template <bool kInverse>
struct Steps {
  static constexpr int n = kInverse ? 6 : 4;
  __host__ __device__ static constexpr float c(int i) {
    return kInverse ? (i == 1 ? -kDelta
                       : i == 2 ? -kGamma
                       : i == 3 ? -kBeta
                       : i == 4 ? -kAlpha
                                : 0.0f)
                    : (i == 0 ? kAlpha
                       : i == 1 ? kBeta
                       : i == 2 ? kGamma
                                : kDelta);
  }
};

// A row of a 9/7 stage's table: one level. kind, w, h, even_x, even_y,
// in_off, out_off as lifting.cuh::Row; lanes: the lanes of its strips
// (4, 8, 16 or 32); seg: the output rows of its segments (even).
struct Row97 {
  int kind, w, h, even_x, even_y, in_off, out_off, lanes, seg;
};
constexpr int kRow97Cols = 9;

// A stage's table, passed by value: kernel parameters, indexed by row
// from constant memory. scratch: words of a plane's scratch area.
struct Schedule97 {
  int n_rows, scratch;
  Row97 row[gdct::kMaxRows];
};

// The strips and segments of a level: its work items a plane group.
struct Items {
  int strips, segs;
  __host__ __device__ __forceinline__ Items(const Row97& r, int halo)
      : strips((r.w + kCols * r.lanes - 2 * halo - 1) /
               (kCols * r.lanes - 2 * halo)),
        segs((r.h + r.seg - 1) / r.seg) {}
  __host__ __device__ __forceinline__ long long count() const {
    return static_cast<long long>(strips) * segs;
  }
};

// Reads and checks a 9/7 stage's table (n_rows rows of kRow97Cols int32)
// into s, for planes of width × height and a halo of `halo`: the first
// row reads the stage's input and the last writes its output, every other
// reads and writes scratch within scratch_words (forward: a level reads
// its w×h window and writes its LL; inverse: the other way round).
// max_warps: the most warps a grid row keeps busy, a plane. Returns a
// CUDA error code.
inline int read_schedule97(const int* table, int n_rows, int scratch_words,
                           int width, int height, int halo, bool inverse,
                           Schedule97* s, long long* max_warps) {
  if (n_rows < 0 || n_rows > gdct::kMaxRows || scratch_words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s->n_rows = n_rows;
  s->scratch = scratch_words;
  *max_warps = 1;
  for (int k = 0; k < n_rows; ++k) {
    const int* v = table + k * kRow97Cols;
    Row97& r = s->row[k];
    r = Row97{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]};
    const long long area = static_cast<long long>(r.w) * r.h;
    const long long ll = static_cast<long long>((r.w + r.even_x) >> 1) *
                         ((r.h + r.even_y) >> 1);
    const long long in_words = inverse ? ll : area;
    const long long out_words = inverse ? area : ll;
    if ((r.kind != gdct::kGridRow && r.kind != gdct::kBlockRow) ||
        r.w < 1 || r.h < 1 || r.w > width || r.h > height ||
        (r.lanes != 4 && r.lanes != 8 && r.lanes != 16 && r.lanes != 32) ||
        kCols * r.lanes <= 2 * halo || r.seg < 2 || r.seg % 2 != 0 ||
        r.in_off < -1 || r.out_off < -1 || (r.in_off >= 0) != (k > 0) ||
        (r.out_off >= 0) != (k < n_rows - 1) ||
        (r.in_off >= 0 && r.in_off + in_words > scratch_words) ||
        (r.out_off >= 0 && r.out_off + out_words > scratch_words)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (r.kind == gdct::kGridRow) {
      *max_warps = std::max(*max_warps,
                            (Items(r, halo).count() + 32 / r.lanes - 1) /
                                (32 / r.lanes));
    }
  }
  return 0;
}

// Whole-sample symmetric extension of window position q (any q) into
// [0, n): gdct::fold's mapping, by reflections at the ends rather than a
// division (a halo reaches at most a few periods past a window's end).
__device__ __forceinline__ int fold97(int q, int n) {
  if (n == 1) return 0;
  while (q < 0 || q >= n) q = q < 0 ? -q : 2 * (n - 1) - q;
  return q;
}

// This lane's place in the strips of its warp: a warp runs 32 / L strips
// of L lanes side by side, each its own work item. Every lane of a warp
// runs the same steps in the same order (an item's control flow depends
// on its level alone; stores are predicated), so the shuffles take the
// whole warp's mask and a width of L.
struct Lanes {
  int lane;      // in its strip
  int slot;      // its strip among the warp's
  int per_warp;  // strips a warp
  int width;     // L

  __device__ __forceinline__ explicit Lanes(int lanes) {
    const int id = threadIdx.x & 31;
    width = lanes;
    per_warp = 32 / lanes;
    slot = id / lanes;
    lane = id - slot * lanes;
  }
  // the next lane's v (the strip's last lane its own) and the previous
  // lane's (the first lane its own)
  __device__ __forceinline__ float down(float v) const {
    return __shfl_down_sync(0xffffffffu, v, 1, width);
  }
  __device__ __forceinline__ float up(float v) const {
    return __shfl_up_sync(0xffffffffu, v, 1, width);
  }
};

// The steps along x of one row of kNb planes, each lane holding kPairs
// pairs: v[k][2p] a low sample, v[k][2p + 1] the high one right of it. A
// high step reads the lane's low samples and the next lane's first, a
// low step the previous lane's last high sample and the lane's.
template <bool kInverse, int kNb>
__device__ __forceinline__ void lift_x(const Lanes& ln,
                                       float (&v)[kNb][kCols]) {
#pragma unroll
  for (int i = 0; i < Steps<kInverse>::n; ++i) {
    const float c = Steps<kInverse>::c(i);
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
      if (i % 2 == 0) {
        const float next = ln.down(v[k][0]);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          v[k][2 * p + 1] = lift(v[k][2 * p + 1], c, v[k][2 * p],
                                 p + 1 < kPairs ? v[k][2 * p + 2] : next);
        }
      } else {
        const float prev = ln.up(v[k][kCols - 1]);
#pragma unroll
        for (int p = kPairs - 1; p >= 0; --p) {
          v[k][2 * p] = lift(v[k][2 * p], c, p > 0 ? v[k][2 * p - 1] : prev,
                             v[k][2 * p + 1]);
        }
      }
    }
  }
}

// The steps along y as a rolling window over a segment's pairs of rows
// (a low row s, the high row d below it), for every column of a lane and
// kNb planes. For each pair of steps j (high step 2j, low step 2j + 1) it
// keeps the low row step 2j reads next and the high row it lifts next
// (s[j], d[j]), and d[m] the last high row out; all 0.0 at first. push
// takes pair q and leaves pair q - m, final, in (s, d): step 2j lifts
// d of pair q - j - 1 from the low rows q - j - 1 and q - j, step 2j + 1
// the low row q - j - 1 from the high rows q - j - 2 and q - j - 1.
template <bool kInverse, int kNb>
struct Column {
  static constexpr int m = Steps<kInverse>::n / 2;
  float s[m][kNb][kCols], d[m + 1][kNb][kCols];

  __device__ __forceinline__ Column() {
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int j = 0; j < m; ++j) s[j][k][c] = d[j][k][c] = 0.0f;
        d[m][k][c] = 0.0f;
      }
    }
  }

  __device__ __forceinline__ void push(float (&lo)[kNb][kCols],
                                       float (&hi)[kNb][kCols]) {
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float s_new = lo[k][c], d_prev = hi[k][c];
#pragma unroll
        for (int j = 0; j < m; ++j) {
          const float d_out = lift(d[j][k][c], Steps<kInverse>::c(2 * j),
                                   s[j][k][c], s_new);
          const float s_out = lift(s[j][k][c], Steps<kInverse>::c(2 * j + 1),
                                   d[j + 1][k][c], d_out);
          s[j][k][c] = s_new;
          d[j][k][c] = d_prev;
          d_prev = d_out;
          s_new = s_out;
        }
        d[m][k][c] = d_prev;
        lo[k][c] = s_new;
        hi[k][c] = d_prev;
      }
    }
  }
};

// One work item's place: the strip's output columns [x_lo, x_hi), the
// lane's window columns x, x + 1, ..., x + kCols - 1 (folded: fx[c]), the
// segment's output rows [y_lo, y_hi) and the row of its first pair, yo.
// An item that is not `valid` (a warp's spare strip in its last round)
// runs as its warp's first and stores nothing.
struct Item {
  int x, fx[kCols], x_lo, x_hi, y_lo, y_hi, yo;

  __device__ __forceinline__ Item(const Row97& r, const Items& it,
                                  long long item, bool valid,
                                  const Lanes& ln, int halo) {
    const int strip = static_cast<int>(item % it.strips);
    const int seg = static_cast<int>(item / it.strips);
    const int out_w = kCols * r.lanes - 2 * halo;
    x_lo = strip * out_w;
    x_hi = valid ? min(x_lo + out_w, r.w) : x_lo;
    x = x_lo - halo + (1 - r.even_x) + kCols * ln.lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c) fx[c] = fold97(x + c, r.w);
    y_lo = seg * r.seg;
    y_hi = valid ? min(y_lo + r.seg, r.h) : y_lo;
    yo = y_lo - halo + (1 - r.even_y);
  }
  __device__ __forceinline__ bool stored(int c) const {
    return x + c >= x_lo && x + c < x_hi;
  }
  __device__ __forceinline__ bool row_out(int y) const {
    return y >= y_lo && y < y_hi;
  }
};

// Row kinds for a Src's finish and an Emit: a low row, a high row, or
// the one row of a window one sample high (no step or scale along y).
enum RowKind { kLowRow = 0, kHighRow = 1, kOnlyRow = 2 };

// Runs one work item: the segment's pairs of rows from src — load<kNb>(y,
// it, raw) issues the loads of window row y (any y: it folds it) into
// raw[k][c], the lane's columns of plane k in the source's type;
// finish<kNb>(raw, v, kind) makes them the float32 values the steps along
// y take (widened; in the inverse lifted along x and scaled) — through
// the Column, each row out to emit(y, v, kind), which stores the rows of
// the segment (it.row_out) and only those. A window of one row goes from
// finish to emit as it is. Pair q + 1's loads are issued as soon as pair
// q is finished, so they are in flight while pair q is lifted and
// stored. (Loads two and three pairs ahead ran slower on the H100:
// PERF.md §6.)
template <bool kInverse, int kNb, typename Src, typename Emit>
__device__ __forceinline__ void run_item(const Row97& r, const Item& it,
                                         const Src& src, const Emit& emit,
                                         int halo) {
  using Raw = typename Src::Raw;
  constexpr int m = Column<kInverse, kNb>::m;
  Raw raw[2][kNb][kCols];
  float lo[kNb][kCols], hi[kNb][kCols];
  if (r.h == 1) {
    src.template load<kNb>(0, it, raw[0]);
    src.template finish<kNb>(raw[0], lo, kOnlyRow);
    emit(0, lo, kOnlyRow);
    return;
  }
  Column<kInverse, kNb> col;
  const int n = r.seg / 2 + halo;
  src.template load<kNb>(it.yo, it, raw[0]);
  src.template load<kNb>(it.yo + 1, it, raw[1]);
  for (int q = 0; q < n; ++q) {
    src.template finish<kNb>(raw[0], lo, kLowRow);
    src.template finish<kNb>(raw[1], hi, kHighRow);
    if (q + 1 < n) {
      src.template load<kNb>(it.yo + 2 * q + 2, it, raw[0]);
      src.template load<kNb>(it.yo + 2 * q + 3, it, raw[1]);
    }
    col.push(lo, hi);
    if (q >= m) {  // rows outside the segment are lifted, not stored
      const int y = it.yo + 2 * (q - m);
      emit(y, lo, kLowRow);
      emit(y + 1, hi, kHighRow);
    }
  }
}

// Every work item of a level for `groups` plane groups of `per` items:
// item i of group g is g · per + i, the strips of warp w taking items
// w · per_warp, ... in rounds of `warps` warps. run(g, item, valid) runs
// one; every lane of a warp runs the same rounds, a spare strip of the
// last one an invalid item.
template <typename Run>
__device__ __forceinline__ void for_items(long long groups, long long per,
                                          long long warp, long long warps,
                                          const Lanes& ln, const Run& run) {
  const long long total = groups * per, step = warps * ln.per_warp;
  for (long long base = warp * ln.per_warp; base < total; base += step) {
    const long long i = base + ln.slot;
    const bool valid = i < total;
    const long long at = valid ? i : base;
    const long long g = at / per;
    run(g, at - g * per, valid);
  }
}

// The warps of a stage kernel that the current device holds at once (its
// cooperative grid, as the launch measures it) and the warps of one block:
// what a level table's segment heights are chosen for (ops/dwt97.py).
inline int resident_warps(const void* kernel, int* grid_warps,
                          int* block_warps) {
  if (kernel == nullptr || grid_warps == nullptr || block_warps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int resident = 0;
  const cudaError_t err = gdct::resident_blocks(kernel, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid_warps = resident * kWarps;
  *block_warps = kWarps;
  return 0;
}

}  // namespace gdct97
