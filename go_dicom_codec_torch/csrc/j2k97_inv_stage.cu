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
// Design: j2k_inv_stage.cu's skeleton in float32 with lifting97.cuh's tile
// pass: one persistent cooperative launch over a host-built table of
// levels (lifting.cuh::Row), coarsest first, each level one tile pass: a
// block loads the packed coefficients that reconstruct its tile and a halo
// of 6 (the reference's six lifting steps) — the LL from where the level
// above wrote it (row.in_off in scratch; the coarsest level's from the
// input), the high bands from the input, which is never written — then
// undoes the row lifting and the column lifting in shared memory and
// stores the tile interleaved:
//
// 1. The head: the coarsest levels whose window holds at most the host's
//    budget of samples are block rows, one block a plane group running
//    all of them with only block barriers between them.
// 2. The finer levels are grid rows: (plane group, tile) items over the
//    grid, a grid barrier after each; a level's reconstruction goes to
//    scratch (two areas in turns: a level may not overwrite what other
//    tiles of its own pass still read).
// 3. The finest level stores the samples: with mct set and a frame of 3 or
//    more components, components 0-2 are one item of three buffers and
//    their inverse ICT runs at the store (components 3 and up pass
//    through); then __float2int_rn (round half to even; NaN → 0, out of
//    range → INT32_MIN or INT32_MAX, as the reference's jnp.round and
//    astype) and the unshift in wrapping int32; "pixels" writes int32,
//    "narrow" clips to [lo, hi] and writes 16 bits, "coeffs" writes the
//    float32 reconstruction (no ICT).

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "lifting97.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::Row;
using gdct::Schedule;
using gdct::wadd;

constexpr int kHalo = 6;
using Tile = gdct97::Tile<kHalo>;

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

// A level's packed coefficients for its planes at the packed place of
// window position (y, x): the LL (py < sny, px < snx) from `ll`, the rest
// from the input `h`.
struct Packed {
  const float* h;
  long long h_stride;
  int h_pitch;
  const float* ll;
  long long ll_stride;
  int ll_pitch, w, hgt, lo_x, lo_y, snx, sny;

  template <int kNb>
  __device__ __forceinline__ void fetch(int y, int x, float* v) const {
    const int py =
        gdct::interleaved_to_packed(gdct::fold(y, hgt), sny, lo_y);
    const int px = gdct::interleaved_to_packed(gdct::fold(x, w), snx, lo_x);
    if (py < sny && px < snx) {
      const float* at = ll + static_cast<long long>(py) * ll_pitch + px;
#pragma unroll
      for (int k = 0; k < kNb; ++k) v[k] = at[k * ll_stride];
    } else {
      const float* at = h + static_cast<long long>(py) * h_pitch + px;
#pragma unroll
      for (int k = 0; k < kNb; ++k) v[k] = at[k * h_stride];
    }
  }
};

// Where a level's reconstruction goes: its planes at `base` (scratch,
// `stride` words apart, rows `pitch` words apart), or the output (base
// null).
struct Recon {
  float* base;
  long long stride;
  int pitch;
  Pixels px;
  long long plane0, plane_size;
  int width;
  bool ict;

  template <int kNb>
  __device__ __forceinline__ void put(int qy, int qx, const float* at,
                                      int words) const {
    if (base != nullptr) {
      float* dst = base + static_cast<long long>(qy) * pitch + qx;
#pragma unroll
      for (int k = 0; k < kNb; ++k) dst[k * stride] = at[k * words];
      return;
    }
    const long long e =
        plane0 * plane_size + static_cast<long long>(qy) * width + qx;
    if constexpr (kNb == 3) {
      if (ict) {
        px.put_ict(e, plane_size, at[0], at[words], at[2 * words]);
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
template <int kNb>
__device__ void inv_tile(const Packed& load, const Recon& store,
                         const Row& r, int tsize, long long tile,
                         float* buf) {
  const int tiles_x = (r.w + tsize - 1) / tsize;
  const Tile t(tsize, r.w, r.h, static_cast<int>(tile / tiles_x),
               static_cast<int>(tile % tiles_x));
  gdct97::load_tile<kHalo, kNb>(load, t, buf);
  gdct97::inv_lift<kHalo, kNb>(buf, t, r.even_x ? 0 : 1, r.even_y ? 0 : 1,
                               r.w, r.h);
  const int c = threadIdx.x & 63;
  if (c < t.tex) {
    const int bx = gdct::xs(kHalo + c, t.hx);
    for (int oy = threadIdx.x >> 6; oy < t.tey; oy += 4) {
      store.put<kNb>(t.ty0 + oy, t.tx0 + c,
                     buf + (kHalo + oy) * t.pitch + bx, t.words);
    }
  }
  __syncthreads();  // the next tile loads into buf again
}

// inv_tile for a group of nb planes. kIct: the launch has groups of three
// planes (the gray kernel carries no code for them).
template <bool kIct, typename... Args>
__device__ __forceinline__ void inv_tile_nb(int nb, Args&... args) {
  if constexpr (kIct) {
    if (nb == 3) {
      inv_tile<3>(args...);
      return;
    }
  }
  inv_tile<1>(args...);
}

// Every tile of level `ri` for one plane group, or tile `tile` alone.
template <bool kIct>
__device__ void inv_level(const Schedule& s, int ri, long long tile,
                          gdct::Group g, bool ict, const float* src,
                          float* scratch, long long plane_size, int width,
                          const Pixels& px, float* buf) {
  const Row& r = s.row[ri];
  const int lo_x = r.even_x ? 0 : 1, lo_y = r.even_y ? 0 : 1;
  const int snx = (r.w + r.even_x) >> 1, sny = (r.h + r.even_y) >> 1;
  const float* h = src + g.plane0 * plane_size;
  const Recon store{
      r.out_off < 0 ? nullptr : scratch + g.plane0 * s.scratch + r.out_off,
      s.scratch, r.w, px, g.plane0, plane_size, width, ict};
  // the LL: the input at the coarsest level, else the level above's
  const Packed load =
      r.in_off < 0
          ? Packed{h, plane_size, width, h, plane_size, width, r.w, r.h,
                   lo_x, lo_y, snx, sny}
          : Packed{h, plane_size, width,
                   scratch + g.plane0 * s.scratch + r.in_off, s.scratch, snx,
                   r.w, r.h, lo_x, lo_y, snx, sny};
  const int tiles = ((r.w + s.tile - 1) / s.tile) *
                    ((r.h + s.tile - 1) / s.tile);
  const long long first = tile < 0 ? 0 : tile;
  const long long end = tile < 0 ? tiles : tile + 1;
  for (long long t = first; t < end; ++t) {
    inv_tile_nb<kIct>(g.nb, load, store, r, s.tile, t, buf);
  }
}

template <bool kIct>
__global__ void __launch_bounds__(kThreads, gdct::kMinBlocks)
    inv97_stage_kernel(const float* src, float* scratch, int n_frames,
                       int n_comps, int height, int width, Schedule s,
                       int mct, Pixels px) {
  extern __shared__ float buf[];
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
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
    }
    // the ICT group: only the finest level stores the samples
    const bool g3 = ict && r1 == s.n_rows;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    if (s.row[r0].kind == gdct::kBlockRow) {
      const gdct::Share sh = gdct::share(n_groups);
      for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
        const gdct::Group g = gdct::group(gi, n_comps, g3);
        for (int ri = r0; ri < r1; ++ri) {
          inv_level<kIct>(s, ri, -1, g, g3, src, scratch, plane_size, width,
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
        inv_level<kIct>(s, r0, it - gi * tiles, gdct::group(gi, n_comps, g3),
                        g3, src, scratch, plane_size, width, px, buf);
      }
    }
    r0 = r1;
    if (r0 < s.n_rows) grid.sync();  // the next level reads this one's
  }
}

}  // namespace

// src: float32 dequantized coefficients [n_frames × n_comps planes, H, W]
// (not the output itself). table: n_rows rows of gdct::kRowCols int32
// (lifting.cuh::Row), coarsest first, tile: their tile side; scratch:
// n_planes × scratch_words float32 (may be null when scratch_words is 0).
// out: float32 (epilogue 0), int32 (1) or 16 bits (2) [planes, H, W], the
// planes frame-major (n_comps a frame). mct: the inverse ICT of components
// 0-2 where n_comps >= 3 (not with epilogue 0); dc: added after the round;
// lo, hi: the narrow clip.
extern "C" int gdct_j2k97_inv_stage(const void* src, void* out,
                                    void* scratch, int n_frames, int n_comps,
                                    int height, int width, const int* table,
                                    int n_rows, int tile, int scratch_words,
                                    int epilogue, int mct, int dc, int lo,
                                    int hi, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      epilogue < kCoeffs || epilogue > kNarrow || src == nullptr ||
      out == nullptr || out == src ||
      (scratch_words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  long long max_tiles = 0;
  const int bad = gdct::read_schedule(table, n_rows, tile, scratch_words,
                                      width, height, true, &s, &max_tiles);
  if (bad) return bad;
  if (epilogue == kCoeffs) mct = 0;
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
      ict ? reinterpret_cast<const void*>(inv97_stage_kernel<true>)
          : reinterpret_cast<const void*>(inv97_stage_kernel<false>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, max_items)));

  const float* src_t = static_cast<const float*>(src);
  float* scratch_t = static_cast<float*>(scratch);
  Pixels px{out, epilogue, epilogue == kCoeffs ? 0 : dc, lo, hi};
  void* args[] = {&src_t, &scratch_t, &n_frames, &n_comps, &height, &width,
                  &s,     &mct,       &px};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
