// The JPEG 2000 reversible decode stage in one launch, for Hopper: packed
// 5/3 coefficients → multilevel inverse 5/3 → inverse RCT → inverse DC
// shift → clip and narrow cast.
//
// Replaces: go_dicom_codec_tpu/pipeline.py:433-457
// (_j2k_decode_device_stage) and ops/dwt53.py:315 (inv53_multilevel), which
// XLA fuses into one program on the TPU.
//
// Bound: device memory. The stage must read its input once and write its
// output once: int16 in and uint16 out ("narrow"), 4 bytes a sample; int32
// in and out ("pixels", "coeffs"), 8. Each level's int32 reconstruction,
// the LL of the level below, is written once and read back once (8/3 bytes
// a sample over all levels). On an NVIDIA H100 80GB HBM3 at 700 W the
// narrow stage of 32 gray 512² frames takes 0.179 ms against a 0.010 ms
// bound: a tile pass waits on its loads (PERF.md §6).
//
// Design: the skeleton of j2k_fwd_stage.cu run backwards: one persistent
// cooperative launch over a host-built table of levels (lifting.cuh::Row),
// coarsest first, each level one tile pass (lifting.cuh): a block loads the
// packed coefficients that reconstruct its tile and a halo of 2 — the LL
// from where the level above wrote it (row.in_off in scratch; the
// coarsest level's from the input), the high bands from the input, which is
// never written, a sample at a time (16-byte loads of the low and high
// runs, scattered to their interleaved places, ran slower on the H100,
// PERF.md) — then undoes the row lifting and the column lifting in shared
// memory and stores the tile interleaved:
//
// 1. The head. The coarsest levels have too few tiles to fill the card and
//    would each cost a grid barrier. Those whose window holds at most the
//    host's budget of samples (64² at 512² frames: levels 4 and 5, chosen
//    on the H100 against none and 128², PERF.md) are block rows: one block
//    a plane group runs all of them with only block barriers between them.
// 2. The finer levels are grid rows: (plane group, tile) items over the
//    grid, a grid barrier after each. A level's reconstruction goes to
//    scratch (ping-pong between two areas: a level may not overwrite what
//    other tiles of its own pass still read).
// 3. The finest level stores the samples: with mct set and a frame of 3 or
//    more components, components 0-2 are one item of three buffers and
//    their inverse RCT runs at the store (components 3 and up pass
//    through); then the unshift, in wrapping int32; "pixels" writes int32,
//    "narrow" clips to [lo, hi] and writes 16 bits, "coeffs" writes the
//    reconstruction. No epilogue phase runs after it.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "lifting.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::Row;
using gdct::Tile;
using gdct::wadd;
using gdct::Walk;
using gdct::wsub;

enum Epilogue { kCoeffs = 0, kPixels = 1, kNarrow = 2 };

// The table (lifting.cuh::Schedule): row[r].in_off is -1 where the
// level's LL lies in the input (the coarsest level), else in scratch;
// row[r].out_off is -1 for the output (the finest level), else where its
// w×h reconstruction goes in scratch.
using gdct::Schedule;

// What the output gets for a reconstructed sample v at e.
struct Pixels {
  void* out;  // kCoeffs, kPixels: int32; kNarrow: 16 bits
  int epilogue, dc, lo, hi;

  __device__ __forceinline__ void put(long long e, int v) const {
    v = wadd(v, dc);
    if (epilogue == kNarrow) {
      static_cast<uint16_t*>(out)[e] =
          static_cast<uint16_t>(min(max(v, lo), hi));
    } else {
      static_cast<int*>(out)[e] = v;
    }
  }

  // Components 0-2 of a frame from their Y, U, V at e, e + stride, ...
  __device__ __forceinline__ void put_rct(long long e, long long stride,
                                          int y, int u, int v) const {
    const int g = wsub(y, wadd(u, v) >> 2);
    put(e, wadd(v, g));
    put(e + stride, g);
    put(e + 2 * stride, wadd(u, g));
  }
};

// A level's packed coefficients for its planes at the packed place of
// window position (y, x): the LL (py < sny, px < snx) from `ll`, the rest
// from the input `h`, widened.
template <typename T, typename TL>
struct Packed {
  const T* h;
  long long h_stride;
  int h_pitch;
  const TL* ll;
  long long ll_stride;
  int ll_pitch, w, hgt, lo_x, lo_y, snx, sny;

  template <int kNb>
  struct Raw {
    int v[kNb];
  };

  template <int kNb>
  __device__ __forceinline__ Raw<kNb> fetch(int y, int x) const {
    const int py =
        gdct::interleaved_to_packed(gdct::fold(y, hgt), sny, lo_y);
    const int px = gdct::interleaved_to_packed(gdct::fold(x, w), snx, lo_x);
    Raw<kNb> raw;
    if (py < sny && px < snx) {
      const TL* at = ll + static_cast<long long>(py) * ll_pitch + px;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        raw.v[k] = static_cast<int>(at[k * ll_stride]);
      }
    } else {
      const T* at = h + static_cast<long long>(py) * h_pitch + px;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        raw.v[k] = static_cast<int>(at[k * h_stride]);
      }
    }
    return raw;
  }

  template <int kNb>
  __device__ __forceinline__ void put(const Raw<kNb>& raw, int* dst,
                                      int words) const {
#pragma unroll
    for (int k = 0; k < kNb; ++k) dst[k * words] = raw.v[k];
  }
};

// Where a level's reconstruction goes: its planes at `base` (scratch,
// `stride` words apart, rows `pitch` words), or the output (base null).
struct Recon {
  int* base;
  long long stride;
  int pitch;
  Pixels px;
  long long plane0, plane_size;
  int width;
  bool rct;

  template <int kNb>
  __device__ __forceinline__ void put(int qy, int qx, const int* at,
                                      int words) const {
    if (base != nullptr) {
      int* dst = base + static_cast<long long>(qy) * pitch + qx;
#pragma unroll
      for (int k = 0; k < kNb; ++k) dst[k * stride] = at[k * words];
      return;
    }
    const long long e =
        plane0 * plane_size + static_cast<long long>(qy) * width + qx;
    if constexpr (kNb == 3) {
      if (rct) {
        px.put_rct(e, plane_size, at[0], at[words], at[2 * words]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < kNb; ++k) px.put(e + k * plane_size, at[k * words]);
  }
};

// One tile of level `r` for kNb planes: load the packed coefficients of
// the tile and its halo in interleaved order, undo the lifting, store.
// Thread i stores column i % 64 of the tile's rows i / 64, i / 64 + 4, ...
template <int kNb, typename Load>
__device__ void inv_tile(const Load& load, const Recon& store, const Row& r,
                         int tsize, long long tile, int* buf) {
  const int tiles_x = (r.w + tsize - 1) / tsize;
  const Tile t(tsize, r.w, r.h, static_cast<int>(tile / tiles_x),
               static_cast<int>(tile % tiles_x));
  gdct::load_tile<kNb>(load, t, buf);
  gdct::inv_lift<kNb>(buf, t, r.even_x ? 0 : 1, r.even_y ? 0 : 1, r.w, r.h);
  const int c = threadIdx.x & 63;
  if (c < t.tex) {
    const int bx = gdct::xs(2 + c, t.hx);
    for (int oy = threadIdx.x >> 6; oy < t.tey; oy += 4) {
      store.put<kNb>(t.ty0 + oy, t.tx0 + c, buf + (2 + oy) * t.pitch + bx,
                     t.words);
    }
  }
  __syncthreads();  // the next tile loads into buf again
}

// inv_tile for a group of nb planes. kRct: the launch has groups of three
// planes (the gray kernels carry no code for them, and so fewer
// registers).
template <bool kRct, typename Load, typename... Args>
__device__ __forceinline__ void inv_tile_nb(const Load& load, int nb,
                                            Args&... args) {
  if constexpr (kRct) {
    if (nb == 3) {
      inv_tile<3>(load, args...);
      return;
    }
  }
  inv_tile<1>(load, args...);
}

// Every tile of level `ri` for one plane group, or tile `tile` alone.
template <bool kRct, typename T>
__device__ void inv_level(const Schedule& s, int ri, long long tile,
                          gdct::Group g, bool rct, const T* src, int* scratch,
                          long long plane_size, int width, const Pixels& px,
                          int* buf) {
  const Row& r = s.row[ri];
  const int lo_x = r.even_x ? 0 : 1, lo_y = r.even_y ? 0 : 1;
  const int snx = (r.w + r.even_x) >> 1, sny = (r.h + r.even_y) >> 1;
  const T* h = src + g.plane0 * plane_size;
  const Recon store{
      r.out_off < 0 ? nullptr : scratch + g.plane0 * s.scratch + r.out_off,
      s.scratch, r.w, px, g.plane0, plane_size, width, rct};
  const int tiles = ((r.w + s.tile - 1) / s.tile) *
                    ((r.h + s.tile - 1) / s.tile);
  const long long first = tile < 0 ? 0 : tile;
  const long long end = tile < 0 ? tiles : tile + 1;
  for (long long t = first; t < end; ++t) {
    if (r.in_off < 0) {
      const Packed<T, T> load{h,     plane_size, width, h,    plane_size,
                              width, r.w,        r.h,   lo_x, lo_y,
                              snx,   sny};
      inv_tile_nb<kRct>(load, g.nb, store, r, s.tile, t, buf);
    } else {
      const Packed<T, int> load{h,
                                plane_size,
                                width,
                                scratch + g.plane0 * s.scratch + r.in_off,
                                s.scratch,
                                snx,
                                r.w,
                                r.h,
                                lo_x,
                                lo_y,
                                snx,
                                sny};
      inv_tile_nb<kRct>(load, g.nb, store, r, s.tile, t, buf);
    }
  }
}

template <typename T, bool kRct>
__global__ void __launch_bounds__(kThreads, gdct::kMinBlocks)
    inv_stage_kernel(const T* src, int* scratch, int n_frames, int n_comps,
                     int height, int width, Schedule s, int mct, Pixels px) {
  extern __shared__ int buf[];
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const bool rct = kRct && mct != 0 && n_comps >= 3;

  if (s.n_rows == 0) {  // no level: the epilogue of the input
    const long long tid =
        blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long f = 0; f < n_frames; ++f) {
      for (long long e = tid; e < plane_size; e += stride) {
        const long long at = f * n_comps * plane_size + e;
        int c = 0;
        if (rct) {
          px.put_rct(at, plane_size, static_cast<int>(src[at]),
                     static_cast<int>(src[at + plane_size]),
                     static_cast<int>(src[at + 2 * plane_size]));
          c = 3;
        }
        for (; c < n_comps; ++c) {
          px.put(at + c * plane_size,
                 static_cast<int>(src[at + c * plane_size]));
        }
      }
    }
    return;
  }
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
    }
    // the RCT group: only the finest level stores the samples
    const bool g3 = rct && r1 == s.n_rows;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    if (s.row[r0].kind == gdct::kBlockRow) {
      const gdct::Share sh = gdct::share(n_groups);
      for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
        const gdct::Group g = gdct::group(gi, n_comps, g3);
        for (int ri = r0; ri < r1; ++ri) {
          inv_level<kRct>(s, ri, -1, g, g3, src, scratch, plane_size, width,
                          px, buf);
        }
      }
    } else {
      const Row& r = s.row[r0];
      const long long tiles = static_cast<long long>(
                                  (r.w + s.tile - 1) / s.tile) *
                              ((r.h + s.tile - 1) / s.tile);
      const gdct::Share sh = gdct::share(n_groups * tiles);
      for (long long it = sh.first; it < n_groups * tiles; it += sh.step) {
        const long long gi = it / tiles;
        inv_level<kRct>(s, r0, it - gi * tiles,
                        gdct::group(gi, n_comps, g3), g3, src, scratch,
                        plane_size, width, px, buf);
      }
    }
    r0 = r1;
    if (r0 < s.n_rows) grid.sync();  // the next level reads this one's
  }
}

template <typename T>
int launch(const void* src, void* out, void* scratch, int n_frames,
           int n_comps, int height, int width, const int* table, int n_rows,
           int tile, int scratch_words, int epilogue, int mct, int dc, int lo,
           int hi, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      epilogue < kCoeffs || epilogue > kNarrow || out == nullptr ||
      out == src || (scratch_words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  long long max_tiles = 0;
  const int bad = gdct::read_schedule(table, n_rows, tile, scratch_words,
                                      width, height, true, &s, &max_tiles);
  if (bad) return bad;
  if (epilogue == kCoeffs) mct = 0;
  const bool rct = mct != 0 && n_comps >= 3;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  const long long max_items =
      n_rows > 0 ? n_planes * max_tiles
                 : (static_cast<long long>(height) * width + kThreads - 1) /
                       kThreads;
  const size_t smem =
      n_rows > 0 ? static_cast<size_t>(rct ? 3 : 1) * gdct::tile_words(tile) *
                       sizeof(int)
                 : 0;

  const void* kernel =
      rct ? reinterpret_cast<const void*>(inv_stage_kernel<T, true>)
          : reinterpret_cast<const void*>(inv_stage_kernel<T, false>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, max_items)));

  const T* src_t = static_cast<const T*>(src);
  int* scratch_t = static_cast<int*>(scratch);
  Pixels px{out, epilogue, epilogue == kCoeffs ? 0 : dc, lo, hi};
  void* args[] = {&src_t, &scratch_t, &n_frames, &n_comps, &height, &width,
                  &s,     &mct,       &px};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: packed coefficients [n_frames × n_comps planes, H, W] of dtype
// 1 int16 or 2 int32, as in j2k_fwd_stage.cu (not the output itself).
// table: n_rows rows of gdct::kRowCols int32 (lifting.cuh::Row), coarsest
// first, tile: their tile side; scratch: n_planes × scratch_words int32
// (may be null when scratch_words is 0). out: int32 (epilogue 0, 1) or 16
// bits (2) [planes, H, W], the planes frame-major (n_comps a frame).
extern "C" int gdct_j2k_inv_stage(const void* src, int dtype, void* out,
                                  void* scratch, int n_frames, int n_comps,
                                  int height, int width, const int* table,
                                  int n_rows, int tile, int scratch_words,
                                  int epilogue, int mct, int dc, int lo,
                                  int hi, void* stream) {
  switch (dtype) {
    case 1:
      return launch<int16_t>(src, out, scratch, n_frames, n_comps, height,
                             width, table, n_rows, tile, scratch_words,
                             epilogue, mct, dc, lo, hi, stream);
    case 2:
      return launch<int>(src, out, scratch, n_frames, n_comps, height, width,
                         table, n_rows, tile, scratch_words, epilogue, mct,
                         dc, lo, hi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
