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
// Design: j2k_fwd_stage.cu's skeleton in float32 with lifting97.cuh's tile
// pass (a halo of 4: the forward's four lifting steps): one persistent
// cooperative launch over a host-built table of levels
// (lifting.cuh::Row), finest first:
//
// - grid rows: the level's (plane group, tile) items spread over the grid,
//   then grid.sync(), since the next level reads what other blocks wrote;
// - block rows: the coarse levels whose window fits one tile run in one
//   block a plane group, one after another with only block barriers.
//
// The first level reads the input in its own type: an integer sample is
// widened, less the DC shift in wrapping int32 and rounded to float32
// (__int2float_rn, as torch's and jnp's casts); a float32 sample (the
// Part-2 path: shifted and matrixed already) is taken as it is. With mct a
// frame's components 0-2 are one item of three buffers, and the ICT runs
// as they are loaded. A later level reads the LL that the level before
// wrote to scratch (two areas in turns). Each level writes its HL, LH and
// HH bands, which are final, to the output, its LL to scratch, the last
// level's to the output. The input is never written: it must not be the
// output.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "lifting97.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::Row;
using gdct::Schedule;
using gdct::wsub;

constexpr int kHalo = 4;
using Tile = gdct97::Tile<kHalo>;

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

// A level's input: planes of a w×h window from `base`, `stride` words
// apart, rows `pitch` words apart, widened (the first level's samples;
// shift 0 and no ICT for the LL in scratch); with `ict` (three planes) the
// planes are R, G, B and the buffers get Y, Cb, Cr.
template <typename T>
struct In {
  const T* base;
  long long stride;
  int pitch, w, h, shift;
  bool ict;

  template <int kNb>
  __device__ __forceinline__ void fetch(int y, int x, float* v) const {
    const T* at = base +
                  static_cast<long long>(gdct::fold(y, h)) * pitch +
                  gdct::fold(x, w);
#pragma unroll
    for (int k = 0; k < kNb; ++k) v[k] = widen(at[k * stride], shift);
    if constexpr (kNb == 3) {
      if (ict) {
        const float r = v[0], g = v[1], b = v[2];
        v[0] = gdct97::dot3(gdct97::kYr, r, gdct97::kYg, g, gdct97::kYb, b);
        v[1] =
            gdct97::dot3(gdct97::kCbr, r, gdct97::kCbg, g, gdct97::kCbb, b);
        v[2] =
            gdct97::dot3(gdct97::kCrr, r, gdct97::kCrg, g, gdct97::kCrb, b);
      }
    }
  }
};

// One tile of level `r` for the kNb planes from plane0: load the tile and
// its halo, lift, store each sample at its packed place: the LL to scratch
// (r.out_off >= 0) or the output, the high bands to the output. Thread i
// stores column i % 64 of the tile's rows i / 64, i / 64 + 4, ...
template <int kNb, typename Load>
__device__ void fwd_tile(const Load& load, const Row& r, int tsize,
                         long long tile, long long plane0, float* out,
                         float* scratch, int scratch_words,
                         long long plane_size, int width, float* buf) {
  const int tiles_x = (r.w + tsize - 1) / tsize;
  const Tile t(tsize, r.w, r.h, static_cast<int>(tile / tiles_x),
               static_cast<int>(tile % tiles_x));
  const int lo_x = r.even_x ? 0 : 1, lo_y = r.even_y ? 0 : 1;
  gdct97::load_tile<kHalo, kNb>(load, t, buf);
  gdct97::fwd_lift<kHalo, kNb>(buf, t, lo_x, lo_y, r.w, r.h);

  const int snx = (r.w + 1 - lo_x) >> 1, sny = (r.h + 1 - lo_y) >> 1;
  const int nlx = (t.tex + 1 - lo_x) >> 1, nly = (t.tey + 1 - lo_y) >> 1;
  const int c = threadIdx.x & 63;
  if (c < t.tex) {
    // the tile's columns in packed order: its lows, then its highs
    const bool low_x = c < nlx;
    const int ox = low_x ? c : c - nlx;
    const int bx = (low_x ? lo_x : 1 - lo_x) * t.hx + kHalo / 2 + ox;
    const int px = (low_x ? 0 : snx) + (t.tx0 >> 1) + ox;
    for (int oy = threadIdx.x >> 6; oy < t.tey; oy += 4) {
      const bool low_y = oy < nly;
      const int o = low_y ? oy : oy - nly;
      const int by = (low_y ? lo_y : 1 - lo_y) + kHalo + 2 * o;
      const int py = (low_y ? 0 : sny) + (t.ty0 >> 1) + o;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const float v = buf[k * t.words + by * t.pitch + bx];
        if (low_y && low_x && r.out_off >= 0) {
          scratch[(plane0 + k) * scratch_words + r.out_off +
                  static_cast<long long>(py) * snx + px] = v;
        } else {
          out[(plane0 + k) * plane_size +
              static_cast<long long>(py) * width + px] = v;
        }
      }
    }
  }
  __syncthreads();  // the next tile loads into buf again
}

// fwd_tile for a group of nb planes. kIct: the launch has groups of three
// planes (the gray kernel carries no code for them).
template <bool kIct, typename Load, typename... Args>
__device__ __forceinline__ void fwd_tile_nb(const Load& load, int nb,
                                            Args&... args) {
  if constexpr (kIct) {
    if (nb == 3) {
      fwd_tile<3>(load, args...);
      return;
    }
  }
  fwd_tile<1>(load, args...);
}

// Every tile of level `ri` for one plane group, or tile `tile` alone.
template <bool kIct, typename T>
__device__ void fwd_level(const Schedule& s, int ri, long long tile,
                          gdct::Group g, bool ict, const T* src, int shift,
                          float* out, float* scratch, long long plane_size,
                          int width, float* buf) {
  const Row& r = s.row[ri];
  const int tiles = ((r.w + s.tile - 1) / s.tile) *
                    ((r.h + s.tile - 1) / s.tile);
  const long long first = tile < 0 ? 0 : tile;
  const long long end = tile < 0 ? tiles : tile + 1;
  for (long long t = first; t < end; ++t) {
    if (r.in_off < 0) {
      const In<T> load{src + g.plane0 * plane_size, plane_size, width, r.w,
                       r.h, shift, ict};
      fwd_tile_nb<kIct>(load, g.nb, r, s.tile, t, g.plane0, out, scratch,
                        s.scratch, plane_size, width, buf);
    } else {
      const In<float> load{scratch + g.plane0 * s.scratch + r.in_off,
                           s.scratch, r.w, r.w, r.h, 0, false};
      fwd_tile_nb<kIct>(load, g.nb, r, s.tile, t, g.plane0, out, scratch,
                        s.scratch, plane_size, width, buf);
    }
  }
}

template <typename T, bool kIct>
__global__ void __launch_bounds__(kThreads, gdct::kMinBlocks)
    fwd97_stage_kernel(const T* src, float* out, float* scratch,
                       int n_frames, int n_comps, int height, int width,
                       int shift, int mct, Schedule s) {
  extern __shared__ float buf[];
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
          const In<T> in{src + at, plane_size, 0, 1, 1, shift, true};
          float v[3];
          in.template fetch<3>(0, 0, v);
          for (; c < 3; ++c) out[at + c * plane_size] = v[c];
        }
        for (; c < n_comps; ++c) {
          out[at + c * plane_size] = widen(src[at + c * plane_size], shift);
        }
      }
    }
    return;
  }
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    // the ICT group: only the first level reads the samples
    const bool g3 = ict && r0 == 0;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
      const gdct::Share sh = gdct::share(n_groups);
      for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
        const gdct::Group g = gdct::group(gi, n_comps, g3);
        for (int ri = r0; ri < r1; ++ri) {
          fwd_level<kIct>(s, ri, -1, g, g3, src, shift, out, scratch,
                          plane_size, width, buf);
        }
      }
    } else {
      const Row& r = s.row[r0];
      const long long tiles = static_cast<long long>(
                                  (r.w + s.tile - 1) / s.tile) *
                              ((r.h + s.tile - 1) / s.tile);
      for (long long it = blockIdx.x; it < n_groups * tiles;
           it += gridDim.x) {
        const long long gi = it / tiles;
        fwd_level<kIct>(s, r0, it - gi * tiles, gdct::group(gi, n_comps, g3),
                        g3, src, shift, out, scratch, plane_size, width, buf);
      }
    }
    r0 = r1;
    if (r0 < s.n_rows) grid.sync();  // the next level reads this one's LL
  }
}

template <typename T>
int launch(const void* src, void* out, void* scratch, int n_frames,
           int n_comps, int height, int width, int shift, int mct,
           const int* table, int n_rows, int tile, int scratch_words,
           void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      src == nullptr || out == nullptr || out == src ||
      (std::is_same_v<T, float> && shift != 0) ||
      (scratch_words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  long long max_tiles = 0;
  const int bad = gdct::read_schedule(table, n_rows, tile, scratch_words,
                                      width, height, false, &s, &max_tiles);
  if (bad) return bad;
  const bool ict = mct != 0 && n_comps >= 3;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  const long long max_items =
      n_rows > 0 ? n_planes * max_tiles
                 : (static_cast<long long>(height) * width + kThreads - 1) /
                       kThreads;
  const size_t smem =
      n_rows > 0 ? static_cast<size_t>(ict ? 3 : 1) *
                       gdct97::tile_words(tile, kHalo) * sizeof(float)
                 : 0;

  const void* kernel =
      ict ? reinterpret_cast<const void*>(fwd97_stage_kernel<T, true>)
          : reinterpret_cast<const void*>(fwd97_stage_kernel<T, false>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, max_items)));

  const T* src_t = static_cast<const T*>(src);
  float* out_t = static_cast<float*>(out);
  float* scratch_t = static_cast<float*>(scratch);
  void* args[] = {&src_t,  &out_t, &scratch_t, &n_frames, &n_comps,
                  &height, &width, &shift,     &mct,      &s};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: [n_frames × n_comps planes, H, W] of dtype 0 uint16, 1 int16,
// 2 int32, 3 uint8, 4 float32 (shift 0; not the output itself). mct: the
// ICT of components 0-2 where n_comps >= 3. table: n_rows rows of
// gdct::kRowCols int32 (lifting.cuh::Row), finest first, tile: their tile
// side; scratch: n_planes × scratch_words float32 (may be null when
// scratch_words is 0). out: float32 [planes, H, W].
extern "C" int gdct_j2k97_fwd_stage(const void* src, int dtype, void* out,
                                    void* scratch, int n_frames, int n_comps,
                                    int height, int width, int shift,
                                    int mct, const int* table, int n_rows,
                                    int tile, int scratch_words,
                                    void* stream) {
  switch (dtype) {
    case 0:
      return launch<uint16_t>(src, out, scratch, n_frames, n_comps, height,
                              width, shift, mct, table, n_rows, tile,
                              scratch_words, stream);
    case 1:
      return launch<int16_t>(src, out, scratch, n_frames, n_comps, height,
                             width, shift, mct, table, n_rows, tile,
                             scratch_words, stream);
    case 2:
      return launch<int>(src, out, scratch, n_frames, n_comps, height, width,
                         shift, mct, table, n_rows, tile, scratch_words,
                         stream);
    case 3:
      return launch<uint8_t>(src, out, scratch, n_frames, n_comps, height,
                             width, shift, mct, table, n_rows, tile,
                             scratch_words, stream);
    case 4:
      return launch<float>(src, out, scratch, n_frames, n_comps, height,
                           width, shift, mct, table, n_rows, tile,
                           scratch_words, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
