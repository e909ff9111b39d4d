// The JPEG 2000 reversible decode stage in one launch, for Hopper: packed
// 5/3 coefficients → multilevel inverse 5/3 → inverse RCT → inverse DC
// shift → clip and narrow cast.
//
// Replaces: go_dicom_codec_tpu/pipeline.py:433-457
// (_j2k_decode_device_stage) and ops/dwt53.py:315 (inv53_multilevel), which
// XLA fuses into one program on the TPU. Before it the port ran about 14
// launches for a decode chunk of gray frames (a widening copy, ten lifting
// passes, the unshift, the clamp and the cast) and about 21 for RGB.
//
// Bound: device memory. The stage must read its input once and write its
// output once: int16 in and uint16 out ("narrow"), 4 bytes a sample; int32
// in and out ("pixels", "coeffs"), 8. The lifting passes in between move
// each window sample twice more.
//
// Design: one persistent cooperative launch with the skeleton of
// j2k_fwd_stage.cu (a host-built pass table passed by value, blocks looping
// over (plane, line group) items of lift_lines, grid.sync() between passes,
// a grid capped at the co-resident blocks; a phase with fewer items than
// blocks hands them to blocks spread over the grid), in three phases:
//
// 1. The head. The inverse starts at the coarsest levels, whose passes
//    have too few items to fill the card and would each cost a grid
//    barrier. Those whose window holds at most the host's budget of samples
//    (64² at 512² frames: levels 4 and 5, measured on the H100 against
//    none and 128², PERF.md) run in one block a plane: it reads the
//    plane's head window into shared memory (the tile), runs every row and
//    column pass of those levels there with only __syncthreads() between
//    them and writes the window back once. A pass cannot undo the packed
//    [L | H] order in place, so lift_lines copies each group of lines from
//    the tile into a small second buffer (lpb lines of at most ~2048
//    samples) and back.
// 2. The grid passes of the finer levels. No pass widens the whole plane
//    first: a sample is first read by the first pass of the level whose
//    high bands hold it. So each pass loads the window that earlier passes
//    wrote (done_lines × done_n in its own line order) from the int32
//    coefficients and the rest from the input in its own type.
// 3. The epilogue, over (frame, row) items: the inverse RCT of components
//    0-2 when mct is set and a frame has 3 or more (components 3 and up
//    pass through), then the unshift, in wrapping int32; "pixels" writes
//    int32, "narrow" clips to [lo, hi] and writes 16 bits, "coeffs" only
//    copies what no pass touched. Without the RCT, where the last pass
//    covers the whole plane, that pass stores the pixels itself and the
//    phase is skipped.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "lifting.cuh"

namespace cg = cooperative_groups;

namespace {

using gdct::kThreads;
using gdct::line_pitch;
using gdct::wadd;
using gdct::wsub;

constexpr int kMaxPasses = 64;
// a table row: n_lines, line_stride, n, elem_stride, lpb, even, done_lines,
// done_n
constexpr int kTableCols = 8;

enum Epilogue { kCoeffs = 0, kPixels = 1, kNarrow = 2 };

struct Pass {
  long long line_stride, elem_stride;
  int n_lines, n, lpb, even, done_lines, done_n;
};

// Passed by value: kernel parameters, indexed by pass from constant memory.
// pass[0, n_head) are the head's, their strides in the tile (head_w words a
// row); pass[n_head, n_head + n_passes) the grid's. The epilogue reads
// final_w × final_h at the top-left of a plane from the coefficients.
struct Schedule {
  int n_head, n_passes, head_w, head_h, final_w, final_h;
  int fuse;  // the last grid pass stores the pixels
  int epi;   // the epilogue phase runs
  Pass pass[kMaxPasses];
};

// What the epilogue writes for a reconstructed sample v at e.
struct Pixels {
  void* out;  // kCoeffs: the coefficients; kPixels int32; kNarrow 16 bits
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
};

// A grid pass's loads: the first done_lines lines' first done_n samples
// from the coefficients, the rest from the input, widened.
template <typename T>
struct Fresh {
  const T* src;
  const int* coef;
  int line0, done_lines, done_n;

  __device__ __forceinline__ int operator()(int j, int i, long long at) const {
    return (line0 + j < done_lines && i < done_n) ? coef[at]
                                                  : static_cast<int>(src[at]);
  }
};

// The last pass's stores when it takes the epilogue.
struct PixelStore {
  Pixels px;
  long long base;

  __device__ __forceinline__ void operator()(long long at, int v) const {
    px.put(base + at, v);
  }
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    inv_stage_kernel(const T* src, int* coef, int n_frames, int n_comps,
                     int height, int width, Schedule s, int mct, Pixels px) {
  extern __shared__ int buf[];
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const int n_planes = n_frames * n_comps;

  if (s.head_w > 0) {
    const int hw = s.head_w, tile_size = hw * s.head_h;
    int* tile = buf;
    int* lines = buf + tile_size;
    const Share sh = share(n_planes);
    for (long long plane = sh.first; plane < n_planes; plane += sh.step) {
      const long long off = plane * plane_size;
      for (int k = threadIdx.x; k < tile_size; k += blockDim.x) {
        const int y = k / hw;
        tile[k] = static_cast<int>(
            src[off + static_cast<long long>(y) * width + k - y * hw]);
      }
      __syncthreads();
      for (int p = 0; p < s.n_head; ++p) {
        const int n_lines = s.pass[p].n_lines, n = s.pass[p].n;
        const int lpb = s.pass[p].lpb;
        const long long line_stride = s.pass[p].line_stride;
        const long long elem_stride = s.pass[p].elem_stride;
        const bool even = s.pass[p].even != 0;
        for (int line0 = 0; line0 < n_lines; line0 += lpb) {
          int* at = tile + line0 * line_stride;
          gdct::lift_lines<true>(gdct::Widen<int>{at, 0}, gdct::Put{at},
                                 lines, min(lpb, n_lines - line0), n,
                                 line_stride, elem_stride, even);
        }
      }
      for (int k = threadIdx.x; k < tile_size; k += blockDim.x) {
        const int y = k / hw;
        coef[off + static_cast<long long>(y) * width + k - y * hw] = tile[k];
      }
      __syncthreads();  // the next plane loads the tile again
    }
    grid.sync();
  }

  const int last = s.n_head + s.n_passes - 1;
  for (int k = s.n_head; k <= last; ++k) {
    const int n_lines = s.pass[k].n_lines, n = s.pass[k].n;
    const int lpb = s.pass[k].lpb;
    const long long line_stride = s.pass[k].line_stride;
    const long long elem_stride = s.pass[k].elem_stride;
    const bool even = s.pass[k].even != 0;
    const int done_lines = s.pass[k].done_lines, done_n = s.pass[k].done_n;
    const bool fused = k == last && s.fuse;
    const int per_plane = (n_lines + lpb - 1) / lpb;
    const long long items = static_cast<long long>(n_planes) * per_plane;
    const Share sh = share(items);
    for (long long it = sh.first; it < items; it += sh.step) {
      const long long plane = it / per_plane;
      const int line0 = static_cast<int>(it - plane * per_plane) * lpb;
      const int nl = min(lpb, n_lines - line0);
      const long long off = plane * plane_size + line0 * line_stride;
      const Fresh<T> load{src + off, coef + off, line0, done_lines, done_n};
      if (fused) {
        gdct::lift_lines<true>(load, PixelStore{px, off}, buf, nl, n,
                               line_stride, elem_stride, even);
      } else {
        gdct::lift_lines<true>(load, gdct::Put{coef + off}, buf, nl, n,
                               line_stride, elem_stride, even);
      }
    }
    if (k < last || s.epi) grid.sync();
  }
  if (!s.epi) return;

  const bool rct = mct != 0 && n_comps >= 3;
  const long long items = static_cast<long long>(n_frames) * height;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long frame = it / height;
    const int y = static_cast<int>(it - frame * height);
    const long long row =
        frame * n_comps * plane_size + static_cast<long long>(y) * width;
    for (int x = threadIdx.x; x < width; x += blockDim.x) {
      const bool done = y < s.final_h && x < s.final_w;
      const long long e = row + x;
      int c = 0;
      if (rct) {
        int v[3];
        for (int q = 0; q < 3; ++q) {
          const long long eq = e + q * plane_size;
          v[q] = done ? coef[eq] : static_cast<int>(src[eq]);
        }
        const int g = wsub(v[0], wadd(v[1], v[2]) >> 2);
        px.put(e, wadd(v[2], g));
        px.put(e + plane_size, g);
        px.put(e + 2 * plane_size, wadd(v[1], g));
        c = 3;
      }
      for (; c < n_comps; ++c) {
        const long long ec = e + c * plane_size;
        px.put(ec, done ? coef[ec] : static_cast<int>(src[ec]));
      }
    }
  }
}

template <typename T>
int launch(const void* src, void* coef, void* out, int n_frames, int n_comps,
           int height, int width, const long long* table, int n_head,
           int n_passes, int head_w, int head_h, int final_w, int final_h,
           int epilogue, int mct, int dc, int lo, int hi, void* stream) {
  if (n_frames < 1 || n_comps < 1 || height < 1 || width < 1 || n_head < 0 ||
      n_passes < 0 || n_head + n_passes > kMaxPasses || head_w < 0 ||
      head_w > width || head_h < 0 || head_h > height ||
      (head_w > 0) != (head_h > 0) || (n_head > 0 && head_w == 0) ||
      final_w < 0 || final_w > width || final_h < 0 || final_h > height ||
      epilogue < kCoeffs || epilogue > kNarrow ||
      (epilogue != kCoeffs && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  s.n_head = n_head;
  s.n_passes = n_passes;
  s.head_w = head_w;
  s.head_h = head_h;
  s.final_w = final_w;
  s.final_h = final_h;
  const long long n_planes = static_cast<long long>(n_frames) * n_comps;
  const size_t tile = static_cast<size_t>(head_w) * head_h * sizeof(int);
  size_t smem = tile;
  long long max_items = head_w > 0 ? n_planes : 1;
  for (int k = 0; k < n_head + n_passes; ++k) {
    const long long* row = table + k * kTableCols;
    Pass& p = s.pass[k];
    p.n_lines = static_cast<int>(row[0]);
    p.line_stride = row[1];
    p.n = static_cast<int>(row[2]);
    p.elem_stride = row[3];
    p.lpb = static_cast<int>(row[4]);
    p.even = static_cast<int>(row[5]);
    p.done_lines = static_cast<int>(row[6]);
    p.done_n = static_cast<int>(row[7]);
    if (p.n_lines < 1 || p.n < 1 || p.lpb < 1 || p.done_lines < 0 ||
        p.done_lines > p.n_lines || p.done_n < 0 || p.done_n > p.n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t lines =
        static_cast<size_t>(p.lpb) * line_pitch(p.n) * sizeof(int);
    if (k < n_head) {
      smem = std::max(smem, tile + lines);
    } else {
      smem = std::max(smem, lines);
      max_items = std::max(max_items, n_planes * ((p.n_lines + p.lpb - 1) /
                                                  p.lpb));
    }
  }
  if (epilogue == kCoeffs) mct = 0;
  // Without the RCT the last pass stores the pixels where it covers the
  // whole plane (windows are nested at the top-left: its area says so).
  if (n_passes > 0 && epilogue != kCoeffs && !(mct != 0 && n_comps >= 3)) {
    const Pass& last = s.pass[n_head + n_passes - 1];
    s.fuse = static_cast<long long>(last.n_lines) * last.n ==
             static_cast<long long>(height) * width;
  }
  s.epi = !s.fuse &&
          (epilogue != kCoeffs ||
           (src != coef && static_cast<long long>(final_w) * final_h <
                               static_cast<long long>(height) * width));
  if (s.epi) {
    max_items = std::max(max_items, static_cast<long long>(n_frames) * height);
  }

  const void* kernel = reinterpret_cast<const void*>(inv_stage_kernel<T>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(resident, max_items));

  const T* src_t = static_cast<const T*>(src);
  int* coef_t = static_cast<int*>(coef);
  Pixels px{epilogue == kCoeffs ? coef : out, epilogue,
            epilogue == kCoeffs ? 0 : dc, lo, hi};
  void* args[] = {&src_t, &coef_t, &n_frames, &n_comps, &height, &width,
                  &s,     &mct,    &px};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 int16, 2 int32, as in j2k_fwd_stage.cu (src may be coef itself
// when it is int32). table: n_head + n_passes rows of kTableCols int64.
// out: int32 (epilogue 1, may be coef) or 16-bit (2) [planes, H, W], the
// planes frame-major (n_comps a frame); unused for 0.
extern "C" int gdct_j2k_inv_stage(const void* src, int dtype, void* coef,
                                  void* out, int n_frames, int n_comps,
                                  int height, int width,
                                  const long long* table, int n_head,
                                  int n_passes, int head_w, int head_h,
                                  int final_w, int final_h, int epilogue,
                                  int mct, int dc, int lo, int hi,
                                  void* stream) {
  switch (dtype) {
    case 1:
      return launch<int16_t>(src, coef, out, n_frames, n_comps, height, width,
                             table, n_head, n_passes, head_w, head_h, final_w,
                             final_h, epilogue, mct, dc, lo, hi, stream);
    case 2:
      return launch<int>(src, coef, out, n_frames, n_comps, height, width,
                         table, n_head, n_passes, head_w, head_h, final_w,
                         final_h, epilogue, mct, dc, lo, hi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
