// The JPEG 2000 irreversible decode stage in one launch, for Hopper:
// dequantized float32 coefficients → multilevel inverse 9/7 → inverse ICT
// → round half to even (saturating) → inverse DC shift → clip and narrow
// cast.
//
// Replaces: go_dicom_codec_tpu/pipeline.py:460-485
// (_j2k_decode_device_stage_97) with ops/dwt97.py:76-139
// (inv97_multilevel) and ops/mct.py:72-78 (ict_inverse), which XLA fuses
// into one program on the TPU.
//
// Bound: device memory. The stage must read its float32 input once and
// write its output once: 6 bytes a sample into uint16 ("narrow"), 8 into
// int32 or float32 ("pixels", "coeffs"). Each level's float32
// reconstruction, the LL of the level below, is written once and read back
// once (8/3 bytes a sample over all levels). Its time on an H100 stands in
// PERF.md §6.
//
// Design: j2k_inv_stage.cu's skeleton in float32 with lifting97.cuh's
// register-resident strip pass (a halo of 6: the reference's six lifting
// steps): one persistent cooperative launch over a host-built table of
// levels (Row97: each level's strip lanes and segment rows), coarsest
// first, each level one strip pass:
//
// 1. The head: the coarsest levels, at most 64 samples each way, are
//    block rows, one block a plane group running all of them with only
//    block barriers between them.
// 2. The finer levels are grid rows: their work items (plane group,
//    strip, segment) over the strips of every warp of the grid, a grid
//    barrier after each; inside a level the warps share nothing: no shared
//    memory, no block barrier. A level's reconstruction goes to scratch
//    (two areas in turns: a level may not overwrite what other items of
//    its own pass still read).
//
// Both run one inlined copy of the level pass (inv_level). A warp's strip
// walks its segment's rows in pairs. Each row it loads — a lane's low
// columns from the packed row's low half and its high columns from the
// high half, so a row is two coalesced runs of 64 floats, the LL from
// where the level above wrote it (row.in_off in scratch; the coarsest
// level's from the input), the high bands from the input, which is never
// written — is scaled by K and 1/K and lifted along x at once through
// warp shuffles, scaled along y, and goes into the column steps, which run
// in registers as the rows arrive (gdct97::Column). Each row that comes
// out is stored interleaved:
//
// 3. The finest level stores the samples: with mct set and a frame of 3 or
//    more components, components 0-2 are one item of three planes and
//    their inverse ICT runs at the store (components 3 and up pass
//    through); then __float2int_rn (round half to even; NaN → 0, out of
//    range → INT32_MIN or INT32_MAX, as the reference's jnp.round and
//    astype) and the unshift in wrapping int32; "pixels" writes int32,
//    "narrow" clips to [lo, hi] and writes 16 bits, "coeffs" writes the
//    float32 reconstruction (no ICT).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "lifting97.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::wadd;
using gdct97::Item;
using gdct97::kCols;
using gdct97::Lanes;
using gdct97::Row97;
using gdct97::Schedule97;

constexpr int kHalo = 6;

enum Epilogue { kCoeffs = 0, kPixels = 1, kNarrow = 2 };

// What the output gets for a reconstructed sample v at e.
struct Pixels {
  void* out;  // kCoeffs: float32; kPixels: int32; kNarrow: 16 bits
  int epilogue, dc, lo, hi;

  __device__ __forceinline__ void put(long long e, float v) const {
    if (epilogue == kCoeffs) {
      static_cast<float*>(out)[e] = v;
      return;
    }
    const int p = wadd(__float2int_rn(v), dc);
    if (epilogue == kNarrow) {
      static_cast<uint16_t*>(out)[e] =
          static_cast<uint16_t>(min(max(p, lo), hi));
    } else {
      static_cast<int*>(out)[e] = p;
    }
  }

  // Components 0-2 of a frame from their Y, Cb, Cr at e, e + stride, ...
  // (ops/mct.py ict_inverse: g = (y + c1·cb) + c2·cr).
  __device__ __forceinline__ void put_ict(long long e, long long stride,
                                          float y, float cb, float cr) const {
    put(e, __fadd_rn(y, __fmul_rn(gdct97::kInvCr, cr)));
    put(e + stride,
        __fadd_rn(__fadd_rn(y, __fmul_rn(gdct97::kInvCbG, cb)),
                  __fmul_rn(gdct97::kInvCrG, cr)));
    put(e + 2 * stride, __fadd_rn(y, __fmul_rn(gdct97::kInvCb, cb)));
  }
};

// A level's packed coefficients for run_item, for one work item: row y of
// the window is packed row py; the lane's columns are packed columns
// px[c] (low for even c, high for odd c). Where both are low (py < sny,
// px < snx) the sample is the LL's, from `ll`, else the input's, `h`.
// finish scales a row by K and 1/K and lifts it along x, then scales it
// along y.
struct Packed {
  using Raw = float;
  const float* h;
  long long h_stride;
  int h_pitch;
  const float* ll;
  long long ll_stride;
  int ll_pitch, w, hgt, lo_y, sny;
  int px[kCols];
  bool low[kCols];
  const Lanes& ln;

  template <int kNb>
  __device__ __forceinline__ void load(int y, const Item&,
                                       float (&raw)[kNb][kCols]) const {
    const int py =
        gdct::interleaved_to_packed(gdct97::fold97(y, hgt), sny, lo_y);
    const float* hrow = h + static_cast<long long>(py) * h_pitch;
    const bool ll_row = py < sny;
    const float* lrow =
        ll_row ? ll + static_cast<long long>(py) * ll_pitch : hrow;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float* at = (low[c] ? lrow : hrow) + px[c];
      const long long stride = low[c] && ll_row ? ll_stride : h_stride;
#pragma unroll
      for (int k = 0; k < kNb; ++k) raw[k][c] = at[k * stride];
    }
  }

  template <int kNb>
  __device__ __forceinline__ void finish(const float (&raw)[kNb][kCols],
                                         float (&v)[kNb][kCols],
                                         int kind) const {
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[k][c] = raw[k][c];
    }
    if (w > 1) {
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v[k][c] = __fmul_rn(v[k][c], c % 2 ? gdct97::kInvK : gdct97::kK);
        }
      }
      gdct97::lift_x<true, kNb>(ln, v);
    }
    if (kind != gdct97::kOnlyRow) {
      const float f = kind == gdct97::kLowRow ? gdct97::kK : gdct97::kInvK;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[k][c] = __fmul_rn(v[k][c], f);
      }
    }
  }
};

// Where a level's rows go: its planes at `base` (scratch, `stride` words
// apart, rows `pitch` words apart), or the output (base null) through the
// epilogue, the ICT for an item of three planes with `ict`.
struct Recon {
  float* base;
  long long stride;
  int pitch;
  Pixels px;
  long long plane0, plane_size;
  int width;
  bool ict;
  const Item& it;

  template <int kNb>
  __device__ __forceinline__ void operator()(int y,
                                             float (&v)[kNb][kCols],
                                             int) const {
    if (!it.row_out(y)) return;
    const int x = it.x;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (!it.stored(c)) continue;
      if (base != nullptr) {
        float* dst = base + static_cast<long long>(y) * pitch + x + c;
#pragma unroll
        for (int k = 0; k < kNb; ++k) dst[k * stride] = v[k][c];
        continue;
      }
      const long long e =
          plane0 * plane_size + static_cast<long long>(y) * width + x + c;
      if constexpr (kNb == 3) {
        if (ict) {
          px.put_ict(e, plane_size, v[0][c], v[1][c], v[2][c]);
          continue;
        }
      }
#pragma unroll
      for (int k = 0; k < kNb; ++k) px.put(e + k * plane_size, v[k][c]);
    }
  }
};

// Work item `item` of level `r` for the kNb planes from plane0: its
// packed coefficients (the LL from `ll` at `ll_pitch`, the high bands
// from `h`), its reconstruction to `scratch` (out_off >= 0) or the output.
template <int kNb>
__device__ __forceinline__ void inv_item(const Row97& r, long long item,
                                         bool valid, const Lanes& ln,
                                         const float* h, const float* ll,
                                         long long ll_stride, int ll_pitch,
                                         float* scratch,
                                         long long scratch_words,
                                         long long plane0,
                                         long long plane_size, int width,
                                         const Pixels& pix, bool ict) {
  const Item it(r, gdct97::Items(r, kHalo), item, valid, ln, kHalo);
  const int lo_x = 1 - r.even_x;
  const int snx = (r.w + r.even_x) >> 1, sny = (r.h + r.even_y) >> 1;
  Packed src{h, plane_size, width, ll, ll_stride, ll_pitch, r.w, r.h,
             1 - r.even_y, sny, {}, {}, ln};
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    src.px[c] = gdct::interleaved_to_packed(it.fx[c], snx, lo_x);
    src.low[c] = src.px[c] < snx;
  }
  const Recon emit{r.out_off < 0 ? nullptr : scratch + r.out_off,
                   scratch_words, r.w, pix, plane0, plane_size, width, ict,
                   it};
  gdct97::run_item<true, kNb>(r, it, src, emit, kHalo);
}

// Level `r` for the plane groups [g_lo, g_hi), its items over `warps`
// warps from `warp`; the head's rows and the grid rows call it from one
// place, so the kernel holds one copy of the strip pass.
template <bool kIct>
__device__ __forceinline__ void inv_level(Row97 r, long long scratch_words,
                                       long long g_lo, long long g_hi,
                                       long long warp, long long warps,
                                       bool g3, int n_comps,
                                       const float* src, float* scratch,
                                       long long plane_size, int width,
                                       Pixels px) {
  const Lanes ln(r.lanes);
  const long long per = gdct97::Items(r, kHalo).count();
  gdct97::for_items(g_hi - g_lo, per, warp, warps, ln,
                    [&](long long g, long long item, bool valid) {
    const gdct::Group grp = gdct::group(g_lo + g, n_comps, g3);
    const float* h = src + grp.plane0 * plane_size;
    float* area = scratch + grp.plane0 * scratch_words;
    // the LL: the input at the coarsest level, else the level above's
    const float* ll = r.in_off < 0 ? h : area + r.in_off;
    const long long ll_stride = r.in_off < 0 ? plane_size : scratch_words;
    const int ll_pitch = r.in_off < 0 ? width : (r.w + r.even_x) >> 1;
    if constexpr (kIct) {
      if (grp.nb == 3) {
        inv_item<3>(r, item, valid, ln, h, ll, ll_stride, ll_pitch, area,
                    scratch_words, grp.plane0, plane_size, width, px, g3);
        return;
      }
    }
    inv_item<1>(r, item, valid, ln, h, ll, ll_stride, ll_pitch, area,
                scratch_words, grp.plane0, plane_size, width, px, g3);
  });
}

template <bool kIct>
__global__ void __launch_bounds__(kThreads, kIct ? 1 : 2)
    inv97_stage_kernel(const float* src, float* scratch, int n_frames,
                       int n_comps, int height, int width, Schedule97 s,
                       int mct, Pixels px) {
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const bool ict = kIct && mct != 0 && n_comps >= 3;

  if (s.n_rows == 0) {  // no level: the epilogue of the input
    const long long tid =
        blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long f = 0; f < n_frames; ++f) {
      for (long long e = tid; e < plane_size; e += stride) {
        const long long at = f * n_comps * plane_size + e;
        int c = 0;
        if (ict) {
          px.put_ict(at, plane_size, src[at], src[at + plane_size],
                     src[at + 2 * plane_size]);
          c = 3;
        }
        for (; c < n_comps; ++c) {
          px.put(at + c * plane_size, src[at + c * plane_size]);
        }
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
    }
    // the ICT group: only the finest level stores the samples
    const bool g3 = ict && r1 == s.n_rows;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    // the head: one block a plane group, all its levels; a grid row: every
    // group over every warp of the grid
    const bool head = s.row[r0].kind == gdct::kBlockRow;
    const gdct::Share sh = head ? gdct::share(n_groups)
                                : gdct::Share{0, n_groups};
    for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
      for (int ri = r0; ri < r1; ++ri) {
        inv_level<kIct>(s.row[ri], s.scratch, gi, head ? gi + 1 : n_groups,
                        head ? warp : blockIdx.x * gdct97::kWarps + warp,
                        head ? gdct97::kWarps
                             : static_cast<long long>(gridDim.x) *
                                   gdct97::kWarps,
                        g3, n_comps, src, scratch, plane_size, width, px);
        if (head) __syncthreads();  // the next level reads this one's
      }
    }
    r0 = r1;
    if (r0 < s.n_rows) grid.sync();  // the next level reads this one's
  }
}

const void* stage_kernel(bool ict) {
  return ict ? reinterpret_cast<const void*>(inv97_stage_kernel<true>)
             : reinterpret_cast<const void*>(inv97_stage_kernel<false>);
}

}  // namespace

// src: float32 dequantized coefficients [n_frames × n_comps planes, H, W]
// (not the output itself). table: n_rows rows of gdct97::kRow97Cols int32
// (lifting97.cuh::Row97), coarsest first; scratch: n_planes ×
// scratch_words float32 (may be null when scratch_words is 0).
// out: float32 (epilogue 0), int32 (1) or 16 bits (2) [planes, H, W], the
// planes frame-major (n_comps a frame). mct: the inverse ICT of components
// 0-2 where n_comps >= 3 (not with epilogue 0); dc: added after the round;
// lo, hi: the narrow clip.
extern "C" int gdct_j2k97_inv_stage(const void* src, void* out,
                                    void* scratch, int n_frames, int n_comps,
                                    int height, int width, const int* table,
                                    int n_rows, int scratch_words,
                                    int epilogue, int mct, int dc, int lo,
                                    int hi, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      epilogue < kCoeffs || epilogue > kNarrow || src == nullptr ||
      out == nullptr || out == src ||
      (scratch_words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule97 s{};
  long long max_warps = 0;
  const int bad = gdct97::read_schedule97(table, n_rows, scratch_words,
                                          width, height, kHalo, true, &s,
                                          &max_warps);
  if (bad) return bad;
  if (epilogue == kCoeffs) mct = 0;
  const bool ict = mct != 0 && n_comps >= 3;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  // blocks to keep every grid row's items and every plane group busy
  const long long want =
      n_rows > 0
          ? std::max(n_planes,
                     (n_planes * max_warps + gdct97::kWarps - 1) /
                         gdct97::kWarps)
          : (static_cast<long long>(height) * width + kThreads - 1) /
                kThreads;

  const void* kernel = stage_kernel(ict);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, want)));

  const float* src_t = static_cast<const float*>(src);
  float* scratch_t = static_cast<float*>(scratch);
  Pixels px{out, epilogue, epilogue == kCoeffs ? 0 : dc, lo, hi};
  void* args[] = {&src_t, &scratch_t, &n_frames, &n_comps, &height, &width,
                  &s,     &mct,       &px};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The warps of the kernel that gdct_j2k97_inv_stage launches with the
// inverse ICT or without (`ict`: mct with 3 components or more, and not
// epilogue 0) that the current device holds at once, and the warps of one
// block (gdct97::resident_warps).
extern "C" int gdct_j2k97_inv_warps(int ict, int* grid_warps,
                                    int* block_warps) {
  return gdct97::resident_warps(stage_kernel(ict != 0), grid_warps,
                                block_warps);
}
