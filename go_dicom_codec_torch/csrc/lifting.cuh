// Reversible 5/3 lifting (ISO/IEC 15444-1 Annex F): the 2D tile pass that
// the fused stages of j2k_fwd_stage.cu and j2k_inv_stage.cu share, for
// planes of every line length (a tile and its halo fit in shared memory
// whatever the plane's size), and their launch helpers.
//
// A tile is lifted on its interleaved samples with whole-sample symmetric
// extension, which is the edge clamp of the reference for both parities
// (the mirror keeps parity, so the neighbours of a low sample are high
// samples and the other way round). The packed [L | H] order is produced
// (forward) or undone (inverse) by the index map of the stage's store
// (forward) or load (inverse).
//
// Arithmetic is int32 with two's-complement wraparound (done in unsigned,
// since signed overflow is undefined in C++) and arithmetic >>, as jnp.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace gdct {

constexpr int kThreads = 256;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Packed index of interleaved position p.
__device__ __forceinline__ int interleaved_to_packed(int p, int sn, int lo0) {
  return (p & 1) == lo0 ? (p - lo0) >> 1 : sn + ((p - (1 - lo0)) >> 1);
}

// The items k = threadIdx.x, threadIdx.x + blockDim.x, ... of a block's
// loop over k = s * fast + f (f < fast), as (s, f), without a division a
// step: s and f advance by blockDim.x's quotient and remainder by `fast`.
struct Walk {
  int s, f, ds, df, fast;

  __device__ __forceinline__ explicit Walk(int fast_) : fast(fast_) {
    s = threadIdx.x / fast;
    f = threadIdx.x - s * fast;
    ds = blockDim.x / fast;
    df = blockDim.x - ds * fast;
  }
  __device__ __forceinline__ void next() {
    f += df;
    s += ds;
    if (f >= fast) {
      f -= fast;
      ++s;
    }
  }
};

// ---- The 2D tile pass of the fused stages --------------------------------
//
// One level of the 5/3 over a window of w×h samples runs as one pass over
// output tiles of T×T samples (T even). Tile origins are multiples of T in
// the window, so a tile's samples have the window's parities: along x a
// sample at q is low-pass when q % 2 == lo_x (0 at an even window origin).
// A block lifts a tile from a buffer of (T+4)×(T+4) words: the tile and a
// halo of 2 samples on each side, read through whole-sample symmetric
// extension (fold). That extension commutes with the 5/3 lifting, so every
// sample inside the tile comes out as a pass over whole lines gives it, and
// no block needs another's halo: it is recomputed, not exchanged.
//
// Forward: column steps over every buffer column, then row steps over the
// tile's rows. Inverse: row steps over every buffer row, then column steps
// over the tile's columns. A step at e reads e-1 and e+1, so the halo of 2
// covers a predict and an update.
//
// Layout: buffer row y holds ext column e (x = tx0 - 2 + e) at word xs(e):
// the even columns first, the odd ones from hx = (T+4)/2 on. A row step
// touches every other column, so in this order its 32 lanes read and write
// 32 consecutive words: no bank conflicts. A column step takes 32
// consecutive stored columns of one row a warp: none either.

// A row of a stage's table: one level. kind: kGridRow (its tiles spread
// over the grid, a grid barrier after it) or kBlockRow (a run of such rows
// is one phase: one block a plane group runs all of them, with only block
// barriers between them). in_off / out_off: word offsets in a plane's
// scratch area, or -1 for the stage's input / output (see each stage).
struct Row {
  int kind, w, h, even_x, even_y, in_off, out_off;
};
constexpr int kRowCols = 7;
enum RowKind { kGridRow = 0, kBlockRow = 1 };

// A stage's table, passed by value: kernel parameters, indexed by row
// from constant memory. scratch: words of a plane's scratch area.
constexpr int kMaxRows = 64;
struct Schedule {
  int n_rows, tile, scratch;
  Row row[kMaxRows];
};

// Whole-sample symmetric extension of window position q (any q): the
// extension repeats with period 2(n - 1) and keeps parity.
__device__ __forceinline__ int fold(int q, int n) {
  if (q >= 0 && q < n) return q;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  q %= period;
  if (q < 0) q += period;
  return q < n ? q : period - q;
}

// Word of ext column e in a buffer row (evens first, odds from hx on).
__device__ __forceinline__ int xs(int e, int hx) {
  return (e & 1) * hx + (e >> 1);
}

// One tile of a level window: its buffers' geometry and its place. The
// tile side is at most kMaxTile: a block's 256 threads take 64 columns of
// 4 rows at a time.
constexpr int kMaxTile = 64;
// Blocks of a fused stage's kernel resident on an SM: 2 caps its registers
// at 128 a thread. On the H100 3, 4, 6 and 8 (80 registers down to 32,
// with spills) ran the stages slower (PERF.md).
constexpr int kMinBlocks = 2;
struct Tile {
  int pitch, hx, words;    // (T+4) words a row, odds from hx, a buffer
  int ty0, tx0, tey, tex;  // origin and extent in the window
  int eyn, exn;            // ext rows and columns: extent + 4

  __device__ __forceinline__ Tile(int t, int w, int h, int ty, int tx)
      : pitch(t + 4),
        hx((t + 4) >> 1),
        words((t + 4) * (t + 4)),
        ty0(ty * t),
        tx0(tx * t),
        tey(min(t, h - ty * t)),
        tex(min(t, w - tx * t)),
        eyn(min(t, h - ty * t) + 4),
        exn(min(t, w - tx * t) + 4) {}
};

// Shared memory of one buffer of tile side t, in words.
__host__ __device__ __forceinline__ int tile_words(int t) {
  return (t + 4) * (t + 4);
}

// Loads a tile's ext samples into its kNb buffers, a sample at a time.
// Thread i takes ext column i % 64 (and i % 64 + 64 where the tile is that
// wide) of rows i / 64, i / 64 + 4, ...; kLoadRows rows' loads are issued
// before any of them is used, so that a warp does not wait out the
// memory's latency once a sample. src.fetch<kNb>(y, x) reads the raw
// values of window position (y, x) (any y, x: it folds them);
// src.put<kNb>(raw, dst, words) writes them, converted, to dst[0],
// dst[words], ...
template <int kNb, typename Src>
__device__ __forceinline__ void load_tile(const Src& src, const Tile& t,
                                          int* buf) {
  // 9 and 13 rows in flight spilled registers and ran slower (PERF.md)
  constexpr int kLoadRows = kNb == 1 ? 4 : 3;
  const int c = threadIdx.x & 63;
  const int cols = c + 64 < t.exn ? 2 : (c < t.exn ? 1 : 0);
  const int s0 = xs(c, t.hx), s1 = xs(c + 64, t.hx);
  for (int y = threadIdx.x >> 6; y < t.eyn; y += 4 * kLoadRows) {
    typename Src::template Raw<kNb> raw[kLoadRows][2];
#pragma unroll
    for (int j = 0; j < kLoadRows; ++j) {
      const int yy = y + 4 * j;
      if (yy < t.eyn && cols > 0) {
        raw[j][0] = src.template fetch<kNb>(t.ty0 - 2 + yy, t.tx0 - 2 + c);
        if (cols > 1) {
          raw[j][1] =
              src.template fetch<kNb>(t.ty0 - 2 + yy, t.tx0 + 62 + c);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadRows; ++j) {
      const int yy = y + 4 * j;
      if (yy < t.eyn && cols > 0) {
        src.template put<kNb>(raw[j][0], buf + yy * t.pitch + s0, t.words);
        if (cols > 1) {
          src.template put<kNb>(raw[j][1], buf + yy * t.pitch + s1,
                                t.words);
        }
      }
    }
  }
  __syncthreads();
}

// The two lifting steps: predict (rnd 0, >> 1) and update (rnd 2, >> 2).
template <bool kUpdate>
__device__ __forceinline__ int lift_term(int l, int r) {
  return kUpdate ? wadd(wadd(l, r), 2) >> 2 : wadd(l, r) >> 1;
}

// A lifting step along y in kNb buffers: b[e] += (kAdd) or -= the step's
// term of b[e-1] and b[e+1] at rows e = first, first + 2, ... (count of
// them), in every stored column (those past the tile hold nothing that a
// stored sample reads). Ends with a block barrier.
template <int kNb, bool kUpdate, bool kAdd>
__device__ __forceinline__ void step_y(int* buf, const Tile& t, int first,
                                       int count) {
  if (count <= 0) return;
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    int* b = buf + k * t.words + first * t.pitch;
    for (Walk w(t.pitch); w.s < count; w.next()) {
      int* p = b + 2 * w.s * t.pitch + w.f;
      const int v = lift_term<kUpdate>(p[-t.pitch], p[t.pitch]);
      *p = kAdd ? wadd(*p, v) : wsub(*p, v);
    }
  }
  __syncthreads();
}

// The same along x: columns e = first, first + 2, ... (count) of rows
// [y_lo, y_hi). In a buffer row they are consecutive words, and so are
// their neighbours e - 1 and e + 1.
template <int kNb, bool kUpdate, bool kAdd>
__device__ __forceinline__ void step_x(int* buf, const Tile& t, int first,
                                       int count, int y_lo, int y_hi) {
  if (count <= 0) return;
  const int c0 = xs(first, t.hx), cl = xs(first - 1, t.hx),
            cr = xs(first + 1, t.hx);
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    int* b = buf + k * t.words + y_lo * t.pitch;
    for (Walk w(count); w.s < y_hi - y_lo; w.next()) {
      int* row = b + w.s * t.pitch + w.f;
      const int v = lift_term<kUpdate>(row[cl], row[cr]);
      row[c0] = kAdd ? wadd(row[c0], v) : wsub(row[c0], v);
    }
  }
  __syncthreads();
}

// A window side of one sample: at odd parity it is a high-pass sample,
// ×2 forward and >>1 inverse (reference dwt53.go:70-73, :176); the row
// (along y) or the column (along x) of ext index 2.
__device__ __forceinline__ int single(int v, bool inverse) {
  return inverse ? v >> 1 : wadd(v, v);
}

template <int kNb>
__device__ __forceinline__ void single_y(int* buf, const Tile& t,
                                         bool inverse) {
  for (int k = threadIdx.x; k < kNb * t.pitch; k += blockDim.x) {
    int* p = buf + (k / t.pitch) * t.words + 2 * t.pitch + k % t.pitch;
    *p = single(*p, inverse);
  }
  __syncthreads();
}

template <int kNb>
__device__ __forceinline__ void single_x(int* buf, const Tile& t,
                                         bool inverse, int y_lo, int y_hi) {
  const int rows = y_hi - y_lo;
  for (int k = threadIdx.x; k < kNb * rows; k += blockDim.x) {
    int* p = buf + (k / rows) * t.words + (y_lo + k % rows) * t.pitch +
             xs(2, t.hx);
    *p = single(*p, inverse);
  }
  __syncthreads();
}

// The forward 5/3 of a loaded tile (buffers hold the ext samples): the
// column steps over every buffer column, then the row steps over the
// tile's rows. lo_x, lo_y: 0 at an even window origin, else 1; w, h: the
// window's size (a side of 1 takes the ×2 rule or nothing).
template <int kNb>
__device__ __forceinline__ void fwd_lift(int* buf, const Tile& t, int lo_x,
                                         int lo_y, int w, int h) {
  if (h > 1) {
    const int fp = lo_y ? 2 : 1;  // first high row >= 1: predict
    step_y<kNb, false, false>(buf, t, fp, (t.eyn - fp) / 2);
    const int fu = 2 + lo_y;      // first low row >= 2: update
    step_y<kNb, true, true>(buf, t, fu, (t.eyn - 1 - fu) / 2);
  } else if (lo_y) {
    single_y<kNb>(buf, t, false);
  }
  if (w > 1) {
    const int fp = lo_x ? 2 : 1;
    step_x<kNb, false, false>(buf, t, fp, (t.exn - fp) / 2, 2, 2 + t.tey);
    const int fu = 2 + lo_x;
    step_x<kNb, true, true>(buf, t, fu, (t.exn - 1 - fu) / 2, 2,
                            2 + t.tey);
  } else if (lo_x) {
    single_x<kNb>(buf, t, false, 2, 2 + t.tey);
  }
}

// The inverse 5/3 of a loaded tile (buffers hold the ext coefficients in
// interleaved order): the row steps over every buffer row, then the column
// steps (over every buffer column; the tile's are the ones stored).
template <int kNb>
__device__ __forceinline__ void inv_lift(int* buf, const Tile& t, int lo_x,
                                         int lo_y, int w, int h) {
  if (w > 1) {
    const int fu = lo_x ? 1 : 2;  // first low column >= 1: undo update
    step_x<kNb, true, false>(buf, t, fu, (t.exn - fu) / 2, 0, t.eyn);
    const int fp = 3 - lo_x;      // first high column >= 2: undo predict
    step_x<kNb, false, true>(buf, t, fp, (t.exn - 1 - fp) / 2, 0, t.eyn);
  } else if (lo_x) {
    single_x<kNb>(buf, t, true, 0, t.eyn);
  }
  if (h > 1) {
    const int fu = lo_y ? 1 : 2;
    step_y<kNb, true, false>(buf, t, fu, (t.eyn - fu) / 2);
    const int fp = 3 - lo_y;
    step_y<kNb, false, true>(buf, t, fp, (t.eyn - 1 - fp) / 2);
  } else if (lo_y) {
    single_y<kNb>(buf, t, true);
  }
}

// Reads and checks a stage's table (n_rows rows of kRowCols int32) into
// s, for planes of width × height: the first row reads the stage's input
// and the last writes its output, every other reads and writes scratch
// within scratch_words. A level reads in_words and writes out_words
// (forward: its w×h window, then its LL; inverse: its LL, then its w×h
// reconstruction). max_tiles: the most tiles of a grid row. Returns a
// CUDA error code.
inline int read_schedule(const int* table, int n_rows, int tile,
                         int scratch_words, int width, int height,
                         bool inverse, Schedule* s, long long* max_tiles) {
  if (n_rows < 0 || n_rows > kMaxRows || tile < 2 || tile % 2 != 0 ||
      tile > kMaxTile || scratch_words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s->n_rows = n_rows;
  s->tile = tile;
  s->scratch = scratch_words;
  *max_tiles = 1;
  for (int k = 0; k < n_rows; ++k) {
    const int* v = table + k * kRowCols;
    Row& r = s->row[k];
    r = Row{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
    const long long area = static_cast<long long>(r.w) * r.h;
    const long long ll = static_cast<long long>((r.w + r.even_x) >> 1) *
                         ((r.h + r.even_y) >> 1);
    const long long in_words = inverse ? ll : area;
    const long long out_words = inverse ? area : ll;
    if ((r.kind != kGridRow && r.kind != kBlockRow) || r.w < 1 || r.h < 1 ||
        r.w > width || r.h > height || r.in_off < -1 || r.out_off < -1 ||
        (r.in_off >= 0) != (k > 0) || (r.out_off >= 0) != (k < n_rows - 1) ||
        (r.in_off >= 0 && r.in_off + in_words > scratch_words) ||
        (r.out_off >= 0 && r.out_off + out_words > scratch_words)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (r.kind == kGridRow) {
      *max_tiles =
          std::max(*max_tiles, static_cast<long long>((r.w + tile - 1) /
                                                      tile) *
                                   ((r.h + tile - 1) / tile));
    }
  }
  return 0;
}

// This block's share of `items` work items: first, first + step, ... Where
// the items are fewer than the blocks, they go to blocks spread evenly
// over the grid rather than to the first ones.
struct Share {
  long long first, step;
};
__device__ __forceinline__ Share share(long long items) {
  const long long stride = max(1LL, gridDim.x / items);
  if (blockIdx.x % stride != 0) return {items, 1};
  return {blockIdx.x / stride, gridDim.x / stride};
}

// The plane groups of a phase: with the colour transform (rct) a frame's
// components 0-2 are one group of three planes, every other component a
// group of one. Group g of a phase's n_frames × groups(...) groups.
struct Group {
  long long plane0;  // its first plane
  int nb;            // its planes
};
__device__ __forceinline__ int groups(int n_comps, bool rct) {
  return rct ? n_comps - 2 : n_comps;
}
__device__ __forceinline__ Group group(long long g, int n_comps, bool rct) {
  const int per = groups(n_comps, rct);
  const long long frame = g / per;
  const int gi = static_cast<int>(g - frame * per);
  const int comp = rct ? (gi == 0 ? 0 : gi + 2) : gi;
  return {frame * n_comps + comp, rct && gi == 0 ? 3 : 1};
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute is set once for each kernel and device and raised
// only when a launch needs more; it is a ceiling, so a smaller launch
// needs no call.
inline cudaError_t reserve_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  struct Entry {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static std::vector<Entry> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Entry* entry = nullptr;
  for (Entry& e : done) {
    if (e.kernel == kernel && e.device == device) entry = &e;
  }
  if (entry != nullptr && entry->bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (entry != nullptr) {
    entry->bytes = bytes;
  } else {
    done.push_back({kernel, device, bytes});
  }
  return cudaSuccess;
}

// The blocks of `kernel` (kThreads threads each) that the current device
// holds at once with `smem` bytes of shared memory each (after raising its
// limit to that), cached per kernel, device and size, so that only a first
// launch asks the CUDA runtime: the grid of a cooperative launch. A kernel
// that does not fit at all is refused.
inline cudaError_t resident_blocks(const void* kernel, size_t smem,
                                   int* blocks) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> done;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : done) {
      if (e.kernel == kernel && e.device == device && e.smem == smem) {
        *blocks = e.blocks;
        return cudaSuccess;
      }
    }
  }
  if ((err = reserve_smem(kernel, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  done.push_back({kernel, device, smem, *blocks});
  return cudaSuccess;
}

}  // namespace gdct
