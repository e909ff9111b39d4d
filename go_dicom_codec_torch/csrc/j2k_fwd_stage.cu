// The JPEG 2000 lossless forward stage in one launch, for Hopper: widen →
// DC shift → RCT of RGB → multilevel reversible 5/3 → one of three
// epilogues.
//
// Replaces: go_dicom_codec_tpu/pipeline.py:22-33
// (j2k_lossless_encode_transform), :43-52 (_pipeline_device_stage),
// :56-63 and :368-376 (the RGB stages: DC shift and RCT first) and
// ops/dwt53.py:276 (fwd53_multilevel), which XLA fuses into one program on
// the TPU.
//
// Bound: device memory. The stage reads its input once and writes its
// output once (uint16 in and int16 out: 4 bytes a sample; int32 in and
// out: 8); each level's int32 LL is written once and read back once by the
// next level (8/3 bytes a sample over all levels). On an NVIDIA H100 80GB
// HBM3 at 700 W the narrow stage of 32 gray 512² frames takes 0.132 ms
// against a 0.010 ms bound: a tile pass waits on its loads (PERF.md §6).
//
// Design: one persistent cooperative launch over a host-built table of
// levels (lifting.cuh::Row). A level is one tile pass (lifting.cuh: the
// tile and a halo of 2 in shared memory, columns then rows, each sample
// stored at its packed [L | H] place in both dimensions):
//
// - grid rows: the level's (plane group, tile) items spread over the grid,
//   then grid.sync(), since the next level reads what other blocks wrote;
// - block rows: the coarse levels whose window fits one tile run in one
//   block a plane group, one after another with only block barriers (the
//   counterpart of the inverse stage's head).
//
// The first level reads the input in its own type, widened, less the DC
// shift; with `rct` a frame's components 0-2 are one item of three
// buffers, and the RCT runs as they are loaded. A later level reads the
// int32 LL that the level before wrote to the scratch area. Where a
// window's rows are whole 16-byte vectors (512² planes, their LL) a tile
// loads 16 bytes at a time, else a sample at a time. Each level
// writes its HL, LH and HH bands, which are final, to the output; its LL
// goes to scratch (ping-pong between two areas: a level may not overwrite
// what other tiles of its own pass still read), the last level's to the
// output. So the input is never written: it must not be the output.
//
// Epilogues, where a sample is final:
// - kCoeffs: the int32 coefficients (fwd53_multilevel_);
// - kNarrow: the coefficients cast to int16 (wrapping, as .to(int16)) and
//   the max |coeff| over all planes, folded in as they are written and
//   combined by one atomicMax a block (the pipelines' narrow readback);
// - kStats: the int32 coefficients, then per 64×64 (cb×cb) code-block the
//   max |coeff| and its bit-plane count (j2k_lossless_encode_transform), a
//   read of its own: the code-blocks are cut from the packed array and do
//   not line up with the tiles.
//
// |INT_MIN| stays INT_MIN, as in torch and jnp, so it never raises a max;
// the zero padding of a partial code-block enters its max as a 0.

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
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

enum Epilogue { kCoeffs = 0, kNarrow = 1, kStats = 2 };

// The table (lifting.cuh::Schedule): row[r].in_off is -1 for the stage
// input, else where the level's w×h input lies in scratch; row[r].out_off
// is -1 for the output, else where its LL goes in scratch.
using gdct::Schedule;

struct Outputs {
  int* coef;         // kCoeffs, kStats: [planes, H, W] int32
  uint16_t* narrow;  // kNarrow: [planes, H, W] int16 bits
  int* maxabs;       // kNarrow: one int32
  int* cb_max;       // kStats: [planes, nby, nbx]
  int* cb_bits;      // kStats: [planes, nby, nbx]
};

__device__ __forceinline__ int wabs(int c) {
  return c < 0 ? static_cast<int>(0u - static_cast<unsigned>(c)) : c;
}

// A final coefficient v at e of the output; m: this thread's max |c|.
__device__ __forceinline__ void put(const Outputs& out, bool narrow,
                                    long long e, int v, int& m) {
  if (narrow) {
    out.narrow[e] = static_cast<uint16_t>(v);
    m = max(m, wabs(v));
  } else {
    out.coef[e] = v;
  }
}

// The max of v over the block; every thread gets it. `red` is kWarps words
// of the dynamic buffer, free once the levels are done: the kernel
// declares no static shared memory.
constexpr int kWarps = kThreads / 32;
__device__ __forceinline__ int block_max(int v, int* red) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w) v = max(v, red[w]);
  __syncthreads();  // red is written again by the next call
  return v;
}

// A level's input: planes of a w×h window from `base`, `stride` words
// apart, rows `pitch` words apart, widened and less `shift`; with `rct`
// (three planes) the planes are R, G, B and the buffers get Y, U, V.
template <typename T>
struct In {
  const T* base;
  long long stride;
  int pitch, w, h, shift;
  bool rct;

  // Whole rows of 16-byte vectors: every row and plane starts on a
  // 16-byte boundary, and a window row is its whole pitch (no vector
  // reads past a row) of at least 3 samples (one mirror reaches).
  static constexpr int kVec = 16 / sizeof(T);
  __device__ __forceinline__ bool vec() const {
    return pitch == w && w % kVec == 0 && w >= 3 && stride % kVec == 0 &&
           reinterpret_cast<uintptr_t>(base) % 16 == 0;
  }

  template <int kNb>
  struct Raw {
    T v[kNb];
  };

  template <int kNb>
  __device__ __forceinline__ Raw<kNb> fetch(int y, int x) const {
    const T* at = base +
                  static_cast<long long>(gdct::fold(y, h)) * pitch +
                  gdct::fold(x, w);
    Raw<kNb> raw;
#pragma unroll
    for (int k = 0; k < kNb; ++k) raw.v[k] = at[k * stride];
    return raw;
  }

  template <int kNb>
  __device__ __forceinline__ void put(const Raw<kNb>& raw, int* dst,
                                      int words) const {
    int v[kNb];
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
      v[k] = wsub(static_cast<int>(raw.v[k]), shift);
    }
    if constexpr (kNb == 3) {
      if (rct) {
        dst[0] = wadd(wadd(v[0], wadd(v[1], v[1])), v[2]) >> 2;
        dst[words] = wsub(v[2], v[1]);
        dst[2 * words] = wsub(v[0], v[1]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < kNb; ++k) dst[k * words] = v[k];
  }
};

// The tile's ext samples loaded 16 bytes at a time (In::vec()): thread i
// takes vectors i, i + 256, ... of the rows' spans [a0, x_hi), all of its
// loads issued before any is used. Rows fold as they are read; along x a
// loaded sample lands at its own ext column and, near a window edge, at
// the one that mirrors onto it.
template <int kNb, typename T>
__device__ __forceinline__ void load_tile_vec(const In<T>& in, const Tile& t,
                                              int* buf) {
  constexpr int V = In<T>::kVec;
  constexpr int kBatch = kNb == 1 ? 4 : 1;  // three planes: 12 registers
  const int x_lo = max(t.tx0 - 2, 0), x_hi = min(t.tx0 + t.tex + 2, in.w);
  const int a0 = x_lo / V * V;
  const int nvec = (x_hi - a0 + V - 1) / V;
  const int items = t.eyn * nvec;
  const int e0 = t.tx0 - 2;  // the window column of ext column 0
  for (int i0 = threadIdx.x; i0 < items; i0 += kBatch * blockDim.x) {
    uint4 raw[kBatch][kNb];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < items) {
        const int yy = i / nvec;
        const T* row = in.base +
                       static_cast<long long>(gdct::fold(t.ty0 - 2 + yy,
                                                         in.h)) *
                           in.pitch +
                       a0 + (i - yy * nvec) * V;
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          raw[j][k] = *reinterpret_cast<const uint4*>(row + k * in.stride);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i >= items) continue;
      const int yy = i / nvec;
      const int x0 = a0 + (i - yy * nvec) * V;
      int* row = buf + yy * t.pitch;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int x = x0 + q;
        typename In<T>::template Raw<kNb> v;
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          v.v[k] = reinterpret_cast<const T*>(&raw[j][k])[q];
        }
        // x itself, then the positions -x (left edge) and 2(w-1) - x
        // (right edge) that fold onto it
        const int es[3] = {x - e0, -x - e0, 2 * (in.w - 1) - x - e0};
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const int e = es[m];
          const bool own = m == 0 ? x < x_hi
                                  : (m == 1 ? x > 0 : x < in.w - 1);
          if (own && e >= 0 && e < t.exn) {
            in.template put<kNb>(v, row + gdct::xs(e, t.hx), t.words);
          }
        }
      }
    }
  }
  __syncthreads();
}

// One tile of level `r` for the kNb planes from plane0: load the tile and
// its halo, lift, store each sample at its packed place: the LL to scratch
// (r.out_off >= 0) or the output, the high bands to the output. Thread i
// stores column i % 64 of the tile's rows i / 64, i / 64 + 4, ...
template <int kNb, typename Load>
__device__ void fwd_tile(const Load& load, const Row& r, int tsize,
                         long long tile, long long plane0,
                         const Outputs& out, bool narrow, int* scratch,
                         int scratch_words, long long plane_size, int width,
                         int* buf, int& m) {
  const int tiles_x = (r.w + tsize - 1) / tsize;
  const Tile t(tsize, r.w, r.h, static_cast<int>(tile / tiles_x),
               static_cast<int>(tile % tiles_x));
  const int lo_x = r.even_x ? 0 : 1, lo_y = r.even_y ? 0 : 1;
  if (load.vec()) {
    load_tile_vec<kNb>(load, t, buf);
  } else {
    gdct::load_tile<kNb>(load, t, buf);
  }
  gdct::fwd_lift<kNb>(buf, t, lo_x, lo_y, r.w, r.h);

  const int snx = (r.w + 1 - lo_x) >> 1, sny = (r.h + 1 - lo_y) >> 1;
  const int nlx = (t.tex + 1 - lo_x) >> 1, nly = (t.tey + 1 - lo_y) >> 1;
  const int c = threadIdx.x & 63;
  if (c < t.tex) {
    // the tile's columns in packed order: its lows, then its highs
    const bool low_x = c < nlx;
    const int ox = low_x ? c : c - nlx;
    const int bx = (low_x ? lo_x : 1 - lo_x) * t.hx + 1 + ox;
    const int px = (low_x ? 0 : snx) + (t.tx0 >> 1) + ox;
    for (int oy = threadIdx.x >> 6; oy < t.tey; oy += 4) {
      const bool low_y = oy < nly;
      const int o = low_y ? oy : oy - nly;
      const int by = (low_y ? lo_y : 1 - lo_y) + 2 + 2 * o;
      const int py = (low_y ? 0 : sny) + (t.ty0 >> 1) + o;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const int v = buf[k * t.words + by * t.pitch + bx];
        if (low_y && low_x && r.out_off >= 0) {
          scratch[(plane0 + k) * scratch_words + r.out_off +
                  static_cast<long long>(py) * snx + px] = v;
        } else {
          put(out, narrow, (plane0 + k) * plane_size +
                               static_cast<long long>(py) * width + px,
              v, m);
        }
      }
    }
  }
  __syncthreads();  // the next tile loads into buf again
}

// fwd_tile for a group of nb planes. kRct: the launch has groups of three
// planes (the gray kernels carry no code for them, and so fewer
// registers).
template <bool kRct, typename Load, typename... Args>
__device__ __forceinline__ void fwd_tile_nb(const Load& load, int nb,
                                            Args&... args) {
  if constexpr (kRct) {
    if (nb == 3) {
      fwd_tile<3>(load, args...);
      return;
    }
  }
  fwd_tile<1>(load, args...);
}

// Every tile of level `r` for one plane group, or tile `tile` alone.
template <bool kRct, typename T>
__device__ void fwd_level(const Schedule& s, int ri, long long tile,
                          gdct::Group g, bool rct, const T* src, int shift,
                          const Outputs& out, bool narrow, int* scratch,
                          long long plane_size, int width, int* buf, int& m) {
  const Row& r = s.row[ri];
  const int tiles = ((r.w + s.tile - 1) / s.tile) *
                    ((r.h + s.tile - 1) / s.tile);
  const long long first = tile < 0 ? 0 : tile;
  const long long end = tile < 0 ? tiles : tile + 1;
  for (long long t = first; t < end; ++t) {
    if (r.in_off < 0) {
      const In<T> load{src + g.plane0 * plane_size, plane_size, width, r.w,
                       r.h, shift, rct};
      fwd_tile_nb<kRct>(load, g.nb, r, s.tile, t, g.plane0, out, narrow,
                        scratch, s.scratch, plane_size, width, buf, m);
    } else {
      const In<int> load{scratch + g.plane0 * s.scratch + r.in_off,
                         s.scratch, r.w, r.w, r.h, 0, false};
      fwd_tile_nb<kRct>(load, g.nb, r, s.tile, t, g.plane0, out, narrow,
                        scratch, s.scratch, plane_size, width, buf, m);
    }
  }
}

template <typename T, bool kRct>
__global__ void __launch_bounds__(kThreads, gdct::kMinBlocks)
    fwd_stage_kernel(const T* src, int* scratch, int n_frames, int n_comps,
                     int height, int width, int shift, int mct, Schedule s,
                     int epilogue, int cb, Outputs out) {
  extern __shared__ int buf[];
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  const bool rct = kRct && mct != 0 && n_comps >= 3;
  const bool narrow = epilogue == kNarrow;
  int m = INT_MIN;
  bool synced = false;
  if (narrow && blockIdx.x == 0 && threadIdx.x == 0) *out.maxabs = INT_MIN;

  if (s.n_rows == 0) {  // no level: widen, shift and the RCT only
    const long long tid =
        blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long f = 0; f < n_frames; ++f) {
      for (long long e = tid; e < plane_size; e += stride) {
        const long long at = f * n_comps * plane_size + e;
        int c = 0;
        if (rct) {
          const In<T> in{src + at, plane_size, 0, 1, 1, shift, true};
          int v[3];
          in.template put<3>(in.template fetch<3>(0, 0), v, 1);
          for (; c < 3; ++c) put(out, narrow, at + c * plane_size, v[c], m);
        }
        for (; c < n_comps; ++c) {
          put(out, narrow, at + c * plane_size,
              wsub(static_cast<int>(src[at + c * plane_size]), shift), m);
        }
      }
    }
  }
  for (int r0 = 0; r0 < s.n_rows;) {
    int r1 = r0 + 1;
    // the RCT group: only the first level reads the samples
    const bool g3 = rct && r0 == 0;
    const long long n_groups =
        static_cast<long long>(n_frames) * gdct::groups(n_comps, g3);
    if (s.row[r0].kind == gdct::kBlockRow) {
      while (r1 < s.n_rows && s.row[r1].kind == gdct::kBlockRow) ++r1;
      const gdct::Share sh = gdct::share(n_groups);
      for (long long gi = sh.first; gi < n_groups; gi += sh.step) {
        const gdct::Group g = gdct::group(gi, n_comps, g3);
        for (int ri = r0; ri < r1; ++ri) {
          fwd_level<kRct>(s, ri, -1, g, g3, src, shift, out, narrow,
                          scratch, plane_size, width, buf, m);
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
        fwd_level<kRct>(s, r0, it - gi * tiles,
                        gdct::group(gi, n_comps, g3), g3, src, shift, out,
                        narrow, scratch, plane_size, width, buf, m);
      }
    }
    r0 = r1;
    // the next level reads this one's LL; the epilogues read every
    // output, and the max must not meet the atomic's initial value late
    if (r0 < s.n_rows || epilogue == kStats || (narrow && !synced)) {
      grid.sync();
      synced = true;
    }
  }

  if (narrow) {
    if (!synced) grid.sync();  // no level ran: order the initial value
    m = block_max(m, buf);
    if (threadIdx.x == 0) atomicMax(out.maxabs, m);
  } else if (epilogue == kStats) {
    if (!synced) grid.sync();
    const int nby = (height + cb - 1) / cb, nbx = (width + cb - 1) / cb;
    const long long items = n_planes * nby * nbx;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long plane = it / (nby * nbx);
      const int r = static_cast<int>(it - plane * nby * nbx);
      const int y0 = (r / nbx) * cb, x0 = (r % nbx) * cb;
      const int bh = min(cb, height - y0), bw = min(cb, width - x0);
      const int* block = out.coef + plane * plane_size +
                         static_cast<long long>(y0) * width + x0;
      int mb = (bh < cb || bw < cb) ? 0 : INT_MIN;  // the padding's zeros
      for (int k = threadIdx.x; k < bh * bw; k += blockDim.x) {
        const int y = k / bw;
        const long long at = static_cast<long long>(y) * width + k - y * bw;
        mb = max(mb, wabs(block[at]));
      }
      mb = block_max(mb, buf);
      if (threadIdx.x == 0) {
        out.cb_max[it] = mb;
        out.cb_bits[it] = mb > 0 ? 32 - __clz(mb) : 0;
      }
    }
  }
}

template <typename T>
int launch(const void* src, void* scratch, int n_frames, int n_comps,
           int height, int width, int shift, int mct, const int* table,
           int n_rows, int tile, int scratch_words, int epilogue, int cb,
           Outputs out, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 ||
      epilogue < kCoeffs || epilogue > kStats ||
      (epilogue == kStats && cb < 1) ||
      (epilogue == kNarrow ? out.narrow == nullptr || out.maxabs == nullptr
                           : out.coef == nullptr) ||
      (epilogue == kStats && (out.cb_max == nullptr ||
                              out.cb_bits == nullptr)) ||
      (scratch_words > 0 && scratch == nullptr) ||
      (out.coef != nullptr && out.coef == src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  long long max_tiles = 0;
  const int bad = gdct::read_schedule(table, n_rows, tile, scratch_words,
                                      width, height, false, &s, &max_tiles);
  if (bad) return bad;
  const bool rct = mct != 0 && n_comps >= 3;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  // items: a plane's tiles at most; the epilogues' code-blocks; elementwise
  // when no level runs
  long long max_items = n_planes * max_tiles;
  if (n_rows == 0) {
    max_items = (static_cast<long long>(height) * width + kThreads - 1) /
                kThreads;
  }
  if (epilogue == kStats) {
    max_items = std::max(max_items, n_planes * ((height + cb - 1) / cb) *
                                        ((width + cb - 1) / cb));
  }
  size_t smem = kWarps * sizeof(int);  // block_max's scratch
  if (n_rows > 0) {
    smem = std::max(smem, static_cast<size_t>(rct ? 3 : 1) *
                              gdct::tile_words(tile) * sizeof(int));
  }

  const void* kernel =
      rct ? reinterpret_cast<const void*>(fwd_stage_kernel<T, true>)
          : reinterpret_cast<const void*>(fwd_stage_kernel<T, false>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid = static_cast<unsigned>(
      std::max<long long>(1, std::min<long long>(resident, max_items)));

  const T* src_t = static_cast<const T*>(src);
  int* scratch_t = static_cast<int*>(scratch);
  void* args[] = {&src_t, &scratch_t, &n_frames, &n_comps, &height, &width,
                  &shift, &mct,       &s,        &epilogue, &cb,    &out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: [n_frames × n_comps planes, H, W] of dtype 0 uint16, 1 int16,
// 2 int32, 3 uint8 (not the output itself). mct: the RCT of components
// 0-2 where n_comps >= 3. table: n_rows rows of gdct::kRowCols int32
// (lifting.cuh::Row), tile: their tile side; scratch: n_planes ×
// scratch_words int32 (may be null when scratch_words is 0). Epilogue 0
// writes coef; 1 narrow and maxabs (coef unused, may be null); 2 coef,
// cb_max and cb_bits.
extern "C" int gdct_j2k_fwd_stage(const void* src, int dtype, void* coef,
                                  void* scratch, int n_frames, int n_comps,
                                  int height, int width, int shift, int mct,
                                  const int* table, int n_rows, int tile,
                                  int scratch_words, int epilogue, int cb,
                                  void* narrow, void* maxabs, void* cb_max,
                                  void* cb_bits, void* stream) {
  const Outputs out{static_cast<int*>(coef), static_cast<uint16_t*>(narrow),
                    static_cast<int*>(maxabs), static_cast<int*>(cb_max),
                    static_cast<int*>(cb_bits)};
  switch (dtype) {
    case 0:
      return launch<uint16_t>(src, scratch, n_frames, n_comps, height, width,
                              shift, mct, table, n_rows, tile, scratch_words,
                              epilogue, cb, out, stream);
    case 1:
      return launch<int16_t>(src, scratch, n_frames, n_comps, height, width,
                             shift, mct, table, n_rows, tile, scratch_words,
                             epilogue, cb, out, stream);
    case 2:
      return launch<int>(src, scratch, n_frames, n_comps, height, width,
                         shift, mct, table, n_rows, tile, scratch_words,
                         epilogue, cb, out, stream);
    case 3:
      return launch<uint8_t>(src, scratch, n_frames, n_comps, height, width,
                             shift, mct, table, n_rows, tile, scratch_words,
                             epilogue, cb, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
