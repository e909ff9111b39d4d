// The JPEG 2000 irreversible forward stage in one launch, for Hopper:
// samples → DC shift in wrapping int32 → float32 → ICT of RGB → multilevel
// forward 9/7 → float32 packed [L | H] coefficients.
//
// Replaces: go_dicom_codec_tpu/codecs/jpeg2000.py:699-704 (the
// fwd97_multilevel_jit branch of the lossy tile transform) with
// ops/mct.py:14-18 and :57-69 (dc_level_shift, ict_forward) and
// ops/dwt97.py:60-127 (fwd97_multilevel), which XLA fuses into one
// program on the TPU. The deadzone quantizer stays on the host, as in the
// reference (codecs/jpeg2000.py:705-714).
//
// Bound: device memory. The stage must read its input once and write its
// float32 output once: 6 bytes a sample from uint16, 8 from int32 or
// float32; each level's float32 LL is written once and read back once by
// the next level (8/3 bytes a sample over all levels). Its time on an
// H100 stands in PERF.md §6.
//
// Design: j2k_fwd_stage.cu's skeleton in float32 with lifting97.cuh's
// register-resident strip pass (a halo of 4: the forward's four lifting
// steps): one persistent cooperative launch over a host-built table of
// levels (Row97: each level's strip lanes and segment rows), finest
// first:
//
// - grid rows: the level's work items (plane group, strip, segment) over
//   the strips of every warp of the grid, then grid.sync(), since the
//   next level reads what other warps wrote; inside a level the warps
//   share nothing: no shared memory, no block barrier;
// - block rows (the head): the coarse levels, at most 64 samples each
//   way, run in one block a plane group, one after another with block
//   barriers between them only.
//
// Both run one inlined copy of the level pass (fwd_level). A warp's strip
// walks its segment's rows in pairs: it loads a low and a high row (32
// lanes of 4 columns: 256 or 512 coalesced bytes a row), the column steps
// fire in registers as the rows arrive (gdct97::Column), and each row
// that comes out, scaled by 1/K or K, is lifted along x at once through
// warp shuffles, scaled, and stored at its packed place: its HL, LH and
// HH samples to the output, which they reach final, its LL to scratch
// (two areas in turns), the last level's to the output.
//
// The first level reads the input in its own type: an integer sample is
// widened, less the DC shift in wrapping int32 and rounded to float32
// (__int2float_rn, as torch's and jnp's casts); a float32 sample (the
// Part-2 path: shifted and matrixed already) is taken as it is. With mct a
// frame's components 0-2 are one item of three planes, and the ICT runs
// as they are loaded. A later level reads the LL that the level before
// wrote to scratch. The input is never written: it must not be the
// output.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "lifting97.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::wsub;
using gdct97::Item;
using gdct97::kCols;
using gdct97::Lanes;
using gdct97::Row97;
using gdct97::Schedule97;

constexpr int kHalo = 4;

// A sample as the transform takes it: less `shift` in wrapping int32, then
// float32; a float32 sample as it is.
template <typename T>
__device__ __forceinline__ float widen(T v, int shift) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __int2float_rn(wsub(static_cast<int>(v), shift));
  }
}

// The bits of a sample as a Raw word: an integer widened to int32, a
// float32 as it is.
template <typename T>
__device__ __forceinline__ uint32_t to_raw(T v) {
  if constexpr (std::is_same_v<T, float>) {
    return __float_as_uint(v);
  } else {
    return static_cast<uint32_t>(static_cast<int>(v));
  }
}

// A level's input for run_item: planes of a w×h window from `base`,
// `stride` words apart, rows `pitch` words apart. The first level
// (`typed`) reads the stage's samples, T, and widens them less `shift`;
// with `ict` (three planes) they are R, G, B and the rows come out as Y,
// Cb, Cr. A later level reads the float32 LL in scratch (`base` read as
// floats).
template <typename T>
struct In {
  using Raw = uint32_t;
  const void* base;
  long long stride;
  int pitch, h, shift;
  bool typed, ict;

  template <int kNb>
  __device__ __forceinline__ void load(int y, const Item& it,
                                       uint32_t (&raw)[kNb][kCols]) const {
    const long long row = static_cast<long long>(gdct97::fold97(y, h)) * pitch;
    if (typed) {
      const T* at = static_cast<const T*>(base) + row;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          raw[k][c] = to_raw(at[k * stride + it.fx[c]]);
        }
      }
    } else {
      const uint32_t* at = static_cast<const uint32_t*>(base) + row;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) raw[k][c] = at[k * stride + it.fx[c]];
      }
    }
  }

  template <int kNb>
  __device__ __forceinline__ void finish(const uint32_t (&raw)[kNb][kCols],
                                         float (&v)[kNb][kCols], int) const {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        if constexpr (std::is_same_v<T, float>) {
          v[k][c] = __uint_as_float(raw[k][c]);
        } else {
          v[k][c] = typed ? widen(static_cast<int>(raw[k][c]), shift)
                          : __uint_as_float(raw[k][c]);
        }
      }
      if constexpr (kNb == 3) {
        if (ict) {
          const float r = v[0][c], g = v[1][c], b = v[2][c];
          v[0][c] = gdct97::dot3(gdct97::kYr, r, gdct97::kYg, g,
                                 gdct97::kYb, b);
          v[1][c] = gdct97::dot3(gdct97::kCbr, r, gdct97::kCbg, g,
                                 gdct97::kCbb, b);
          v[2][c] = gdct97::dot3(gdct97::kCrr, r, gdct97::kCrg, g,
                                 gdct97::kCrb, b);
        }
      }
    }
  }
};

// A level's rows as they come out of the column steps: scaled along y,
// lifted and scaled along x, stored at their packed places (the LL to
// scratch where out_off >= 0, the rest to the output). The lane's packed
// columns px[c], whether they are stored and whether they are low, are
// the item's.
struct Out {
  const Row97& r;
  const Lanes& ln;
  float* out;      // the group's first output plane
  float* scratch;  // the level's LL area of the group's first plane
  long long plane_size, scratch_words;
  int width, snx, sny, px[kCols];
  bool keep[kCols], ll[kCols];
  const Item& it;

  __device__ __forceinline__ Out(const Row97& r_, const Item& it_,
                                 const Lanes& ln_, float* out_,
                                 float* scratch_, long long plane_size_,
                                 long long scratch_words_, int width_)
      : r(r_),
        ln(ln_),
        out(out_),
        scratch(scratch_),
        plane_size(plane_size_),
        scratch_words(scratch_words_),
        width(width_),
        snx((r_.w + r_.even_x) >> 1),
        sny((r_.h + r_.even_y) >> 1),
        it(it_) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      px[c] = gdct::interleaved_to_packed(it.x + c, snx, 1 - r.even_x);
      keep[c] = it.stored(c);
      ll[c] = px[c] < snx && r.out_off >= 0;
    }
  }

  template <int kNb>
  __device__ __forceinline__ void operator()(int y,
                                             float (&v)[kNb][kCols],
                                             int kind) const {
    if (kind != gdct97::kOnlyRow) {
      const float f = kind == gdct97::kLowRow ? gdct97::kInvK : gdct97::kK;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[k][c] = __fmul_rn(v[k][c], f);
      }
    }
    if (r.w > 1) {
      gdct97::lift_x<false, kNb>(ln, v);
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          v[k][c] = __fmul_rn(v[k][c], c % 2 ? gdct97::kK : gdct97::kInvK);
        }
      }
    }
    if (!it.row_out(y)) return;
    const int py = gdct::interleaved_to_packed(y, sny, 1 - r.even_y);
    float* orow = out + static_cast<long long>(py) * width;
    float* srow = scratch + static_cast<long long>(py) * snx;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (!keep[c]) continue;
      const bool to_scratch = ll[c] && py < sny;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        if (to_scratch) {
          srow[k * scratch_words + px[c]] = v[k][c];
        } else {
          orow[k * plane_size + px[c]] = v[k][c];
        }
      }
    }
  }
};

// Work item `item` of level `r` for the kNb planes from plane0.
template <int kNb, typename T>
__device__ __forceinline__ void fwd_item(const Row97& r, long long item,
                                         bool valid, const Lanes& ln,
                                         const In<T>& in, long long plane0,
                                         float* out, float* scratch,
                                         long long scratch_words,
                                         long long plane_size, int width) {
  const Item it(r, gdct97::Items(r, kHalo), item, valid, ln, kHalo);
  const Out emit(r, it, ln, out + plane0 * plane_size,
                 r.out_off < 0 ? nullptr
                               : scratch + plane0 * scratch_words + r.out_off,
                 plane_size, scratch_words, width);
  gdct97::run_item<false, kNb>(r, it, in, emit, kHalo);
}

// Level `r` for the plane groups [g_lo, g_hi), its items over `warps`
// warps from `warp`; the head's rows and the grid rows call it from one
// place, so the kernel holds one copy of the strip pass.
template <bool kIct, typename T>
__device__ __forceinline__ void fwd_level(Row97 r, long long scratch_words,
                                       long long g_lo, long long g_hi,
                                       long long warp, long long warps,
                                       bool g3, int n_comps, const T* src,
                                       int shift, float* out, float* scratch,
                                       long long plane_size, int width) {
  const Lanes ln(r.lanes);
  const long long per = gdct97::Items(r, kHalo).count();
  gdct97::for_items(g_hi - g_lo, per, warp, warps, ln,
                    [&](long long g, long long item, bool valid) {
    const gdct::Group grp = gdct::group(g_lo + g, n_comps, g3);
    const bool first = r.in_off < 0;
    const In<T> in{first ? static_cast<const void*>(src + grp.plane0 *
                                                          plane_size)
                         : scratch + grp.plane0 * scratch_words + r.in_off,
                   first ? plane_size : scratch_words, first ? width : r.w,
                   r.h, shift, first, first && g3};
    if constexpr (kIct) {
      if (grp.nb == 3) {
        fwd_item<3>(r, item, valid, ln, in, grp.plane0, out, scratch,
                    scratch_words, plane_size, width);
        return;
      }
    }
    fwd_item<1>(r, item, valid, ln, in, grp.plane0, out, scratch,
                scratch_words, plane_size, width);
  });
}

template <typename T, bool kIct>
__global__ void __launch_bounds__(kThreads, kIct ? 1 : 2)
    fwd97_stage_kernel(const T* src, float* out, float* scratch,
                       int n_frames, int n_comps, int height, int width,
                       int shift, int mct, Schedule97 s) {
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const bool ict = kIct && mct != 0 && n_comps >= 3;

  if (s.n_rows == 0) {  // no level: the shift, float32 and the ICT only
    const long long tid =
        blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long f = 0; f < n_frames; ++f) {
      for (long long e = tid; e < plane_size; e += stride) {
        const long long at = f * n_comps * plane_size + e;
        int c = 0;
        if (ict) {
          const In<T> in{src, 0, 0, 1, shift, true, true};
          uint32_t raw[3][kCols];
          float v[3][kCols];
          for (int k = 0; k < 3; ++k) {
            for (int c = 0; c < kCols; ++c) {
              raw[k][c] = to_raw(src[at + k * plane_size]);
            }
          }
          in.template finish<3>(raw, v, gdct97::kOnlyRow);
          for (; c < 3; ++c) out[at + c * plane_size] = v[c][0];
        }
        for (; c < n_comps; ++c) {
          out[at + c * plane_size] = widen(src[at + c * plane_size], shift);
        }
      }
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    // the ICT group: only the first level reads the samples
    const bool g3 = ict && r0 == 0;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
    }
    // the head: one block a plane group, all its levels; a grid row: every
    // group over every warp of the grid
    const bool head = s.row[r0].kind == gdct::kBlockRow;
    const gdct::Share sh = head ? gdct::share(n_groups)
                                : gdct::Share{0, n_groups};
    for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
      for (int ri = r0; ri < r1; ++ri) {
        fwd_level<kIct>(s.row[ri], s.scratch, gi,
                        head ? gi + 1 : n_groups,
                        head ? warp : blockIdx.x * gdct97::kWarps + warp,
                        head ? gdct97::kWarps
                             : static_cast<long long>(gridDim.x) *
                                   gdct97::kWarps,
                        g3, n_comps, src, shift, out, scratch, plane_size,
                        width);
        if (head) __syncthreads();  // the next level reads this one's LL
      }
    }
    r0 = r1;
    if (r0 < s.n_rows) grid.sync();  // the next level reads this one's LL
  }
}

template <typename T>
const void* stage_kernel(bool ict) {
  return ict ? reinterpret_cast<const void*>(fwd97_stage_kernel<T, true>)
             : reinterpret_cast<const void*>(fwd97_stage_kernel<T, false>);
}

// The kernel of `dtype` (gdct_j2k97_fwd_stage's codes), or null.
const void* stage_kernel(int dtype, bool ict) {
  switch (dtype) {
    case 0:
      return stage_kernel<uint16_t>(ict);
    case 1:
      return stage_kernel<int16_t>(ict);
    case 2:
      return stage_kernel<int>(ict);
    case 3:
      return stage_kernel<uint8_t>(ict);
    case 4:
      return stage_kernel<float>(ict);
    default:
      return nullptr;
  }
}

template <typename T>
int launch(const void* src, void* out, void* scratch, int n_frames,
           int n_comps, int height, int width, int shift, int mct,
           const int* table, int n_rows, int scratch_words, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      src == nullptr || out == nullptr || out == src ||
      (std::is_same_v<T, float> && shift != 0) ||
      (scratch_words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule97 s{};
  long long max_warps = 0;
  const int bad = gdct97::read_schedule97(table, n_rows, scratch_words,
                                          width, height, kHalo, false, &s,
                                          &max_warps);
  if (bad) return bad;
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

  const void* kernel = stage_kernel<T>(ict);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, want)));

  const T* src_t = static_cast<const T*>(src);
  float* out_t = static_cast<float*>(out);
  float* scratch_t = static_cast<float*>(scratch);
  void* args[] = {&src_t,  &out_t, &scratch_t, &n_frames, &n_comps,
                  &height, &width, &shift,     &mct,      &s};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: [n_frames × n_comps planes, H, W] of dtype 0 uint16, 1 int16,
// 2 int32, 3 uint8, 4 float32 (shift 0; not the output itself). mct: the
// ICT of components 0-2 where n_comps >= 3. table: n_rows rows of
// gdct97::kRow97Cols int32 (lifting97.cuh::Row97), finest first;
// scratch: n_planes × scratch_words float32 (may be null when
// scratch_words is 0). out: float32 [planes, H, W].
extern "C" int gdct_j2k97_fwd_stage(const void* src, int dtype, void* out,
                                    void* scratch, int n_frames, int n_comps,
                                    int height, int width, int shift,
                                    int mct, const int* table, int n_rows,
                                    int scratch_words, void* stream) {
  switch (dtype) {
    case 0:
      return launch<uint16_t>(src, out, scratch, n_frames, n_comps, height,
                              width, shift, mct, table, n_rows,
                              scratch_words, stream);
    case 1:
      return launch<int16_t>(src, out, scratch, n_frames, n_comps, height,
                             width, shift, mct, table, n_rows,
                             scratch_words, stream);
    case 2:
      return launch<int>(src, out, scratch, n_frames, n_comps, height, width,
                         shift, mct, table, n_rows, scratch_words,
                         stream);
    case 3:
      return launch<uint8_t>(src, out, scratch, n_frames, n_comps, height,
                             width, shift, mct, table, n_rows,
                             scratch_words, stream);
    case 4:
      return launch<float>(src, out, scratch, n_frames, n_comps, height,
                           width, shift, mct, table, n_rows,
                           scratch_words, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The warps of the kernel that gdct_j2k97_fwd_stage launches for `dtype`
// (its codes) and `ict` (mct with 3 components or more) that the current
// device holds at once, and the warps of one block (gdct97::resident_warps).
extern "C" int gdct_j2k97_fwd_warps(int dtype, int ict, int* grid_warps,
                                    int* block_warps) {
  return gdct97::resident_warps(stage_kernel(dtype, ict != 0), grid_warps,
                                block_warps);
}
