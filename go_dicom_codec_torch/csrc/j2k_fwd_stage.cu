// The JPEG 2000 lossless forward stage in one launch, for Hopper: widen →
// DC shift → multilevel reversible 5/3 → one of three epilogues.
//
// Replaces: go_dicom_codec_tpu/pipeline.py:22-33
// (j2k_lossless_encode_transform), :43-52 (_pipeline_device_stage) and
// ops/dwt53.py:276 (fwd53_multilevel), which XLA fuses into one program on
// the TPU. Before it the port ran about 15 launches for one stage call
// (widen, shift, ten lifting passes, narrow cast, abs, amax), each costing
// more host time than the device time of a pass from level 2 down.
//
// Bound: device memory. The stage reads its input once and writes its
// output once (uint16 in and int16 out: 4 bytes a sample; int32 in and
// out: 8); the lifting passes in between move each window sample twice
// more, and the epilogue reads the coefficients once again.
//
// Design: one persistent cooperative launch. Blocks loop over (plane,
// line group) work items of one pass, then the whole grid meets at
// grid.sync() before the next pass, since a pass reads lines that other
// blocks wrote in the pass before. The grid is capped at the blocks that
// are co-resident at the largest pass's shared memory, which a cooperative
// launch requires. The passes are the per-pass kernel's body
// (lifting.cuh::lift_lines: whole lines in shared memory at an odd pitch,
// in place), from a table the host builds from the level windows: pass 0
// reads the input in its own type, widens and shifts it, and writes the
// coefficient buffer; every later pass runs in place there. The epilogue
// then reads the coefficients once:
//
// - kCoeffs: nothing more (fwd53_multilevel_);
// - kNarrow: the coefficients cast to int16 (wrapping, as .to(int16)) and
//   the max |coeff| over all planes, by one atomicMax a block (the
//   pipelines' narrow readback);
// - kStats: per 64×64 (cb×cb) code-block the max |coeff| and its bit-plane
//   count (j2k_lossless_encode_transform).
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
using gdct::line_pitch;
using gdct::wsub;

constexpr int kMaxPasses = 64;
// a table row: n_lines, line_stride, n, elem_stride, lpb, even
constexpr int kTableCols = 6;

enum Epilogue { kCoeffs = 0, kNarrow = 1, kStats = 2 };

struct Pass {
  long long line_stride, elem_stride;
  int n_lines, n, lpb, even;
};

// Passed by value: kernel parameters, indexed by pass from constant memory.
struct Schedule {
  int n_passes;
  Pass pass[kMaxPasses];
};

struct Outputs {
  uint16_t* narrow;  // kNarrow: [planes, H, W] int16 bits
  int* maxabs;       // kNarrow: one int32
  int* cb_max;       // kStats: [planes, nby, nbx]
  int* cb_bits;      // kStats: [planes, nby, nbx]
};

__device__ __forceinline__ int wabs(int c) {
  return c < 0 ? static_cast<int>(0u - static_cast<unsigned>(c)) : c;
}

// The max of v over the block; every thread gets it. `red` is kWarps words
// of the dynamic buffer, free once the passes are done: the kernel declares
// no static shared memory, so a line of up to SMEM_MAX_BYTES / 4 samples
// (_kernels.py) fits beside nothing else.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_stage_kernel(const T* src, int* coef, int n_planes, int height,
                     int width, int shift, Schedule s, int epilogue, int cb,
                     Outputs out) {
  extern __shared__ int buf[];
  cg::grid_group grid = cg::this_grid();
  const long long plane_size = static_cast<long long>(height) * width;
  const long long total = n_planes * plane_size;
  const long long tid =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  if (epilogue == kNarrow && tid == 0) *out.maxabs = INT_MIN;
  if (s.n_passes == 0) {  // no lifting: widen and shift only
    for (long long e = tid; e < total; e += stride) {
      coef[e] = wsub(static_cast<int>(src[e]), shift);
    }
    grid.sync();
  }
  for (int k = 0; k < s.n_passes; ++k) {
    const int n_lines = s.pass[k].n_lines, n = s.pass[k].n;
    const int lpb = s.pass[k].lpb;
    const long long line_stride = s.pass[k].line_stride;
    const long long elem_stride = s.pass[k].elem_stride;
    const bool even = s.pass[k].even != 0;
    const int per_plane = (n_lines + lpb - 1) / lpb;
    const long long items = static_cast<long long>(n_planes) * per_plane;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long plane = it / per_plane;
      const int line0 = static_cast<int>(it - plane * per_plane) * lpb;
      const int nl = min(lpb, n_lines - line0);
      const long long off = plane * plane_size + line0 * line_stride;
      if (k == 0) {
        gdct::lift_lines<false>(src + off, coef + off, shift, buf, nl, n,
                                line_stride, elem_stride, even);
      } else {
        gdct::lift_lines<false>(coef + off, coef + off, 0, buf, nl, n,
                                line_stride, elem_stride, even);
      }
    }
    grid.sync();
  }

  if (epilogue == kNarrow) {
    int m = INT_MIN;
    for (long long e = tid; e < total; e += stride) {
      const int c = coef[e];
      out.narrow[e] = static_cast<uint16_t>(c);
      m = max(m, wabs(c));
    }
    m = block_max(m, buf);
    if (threadIdx.x == 0) atomicMax(out.maxabs, m);
  } else if (epilogue == kStats) {
    const int nby = (height + cb - 1) / cb, nbx = (width + cb - 1) / cb;
    const long long items = static_cast<long long>(n_planes) * nby * nbx;
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long plane = it / (nby * nbx);
      const int r = static_cast<int>(it - plane * nby * nbx);
      const int y0 = (r / nbx) * cb, x0 = (r % nbx) * cb;
      const int bh = min(cb, height - y0), bw = min(cb, width - x0);
      const int* block = coef + plane * plane_size +
                         static_cast<long long>(y0) * width + x0;
      int m = (bh < cb || bw < cb) ? 0 : INT_MIN;  // the padding's zeros
      for (int k = threadIdx.x; k < bh * bw; k += blockDim.x) {
        const int y = k / bw;
        const long long at = static_cast<long long>(y) * width + k - y * bw;
        m = max(m, wabs(block[at]));
      }
      m = block_max(m, buf);
      if (threadIdx.x == 0) {
        out.cb_max[it] = m;
        out.cb_bits[it] = m > 0 ? 32 - __clz(m) : 0;
      }
    }
  }
}

template <typename T>
int launch(const void* src, void* coef, int n_planes, int height, int width,
           int shift, const long long* table, int n_passes, int epilogue,
           int cb, Outputs out, void* stream) {
  if (n_planes < 1 || height < 1 || width < 1 || n_passes < 0 ||
      n_passes > kMaxPasses || epilogue < kCoeffs || epilogue > kStats ||
      (epilogue == kStats && cb < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Schedule s{};
  s.n_passes = n_passes;
  size_t smem = kWarps * sizeof(int);  // block_max's scratch
  const long long total = static_cast<long long>(n_planes) * height * width;
  long long max_items = (total + kThreads - 1) / kThreads;
  for (int k = 0; k < n_passes; ++k) {
    const long long* row = table + k * kTableCols;
    Pass& p = s.pass[k];
    p.n_lines = static_cast<int>(row[0]);
    p.line_stride = row[1];
    p.n = static_cast<int>(row[2]);
    p.elem_stride = row[3];
    p.lpb = static_cast<int>(row[4]);
    p.even = static_cast<int>(row[5]);
    if (p.n_lines < 1 || p.n < 1 || p.lpb < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = std::max(smem, static_cast<size_t>(p.lpb) * line_pitch(p.n) *
                              sizeof(int));
    max_items = std::max(max_items, static_cast<long long>(n_planes) *
                                        ((p.n_lines + p.lpb - 1) / p.lpb));
  }
  if (epilogue == kStats) {
    max_items = std::max(max_items, static_cast<long long>(n_planes) *
                                        ((height + cb - 1) / cb) *
                                        ((width + cb - 1) / cb));
  }

  const void* kernel = reinterpret_cast<const void*>(fwd_stage_kernel<T>);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for grid.sync()
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(resident, max_items));

  const T* src_t = static_cast<const T*>(src);
  int* coef_t = static_cast<int*>(coef);
  void* args[] = {&src_t, &coef_t, &n_planes, &height, &width, &shift,
                  &s,     &epilogue, &cb, &out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 uint16, 1 int16, 2 int32 (src may be coef itself when it is
// int32). table: n_passes rows of kTableCols int64.
extern "C" int gdct_j2k_fwd_stage(const void* src, int dtype, void* coef,
                                  int n_planes, int height, int width,
                                  int shift, const long long* table,
                                  int n_passes, int epilogue, int cb,
                                  void* narrow, void* maxabs, void* cb_max,
                                  void* cb_bits, void* stream) {
  const Outputs out{static_cast<uint16_t*>(narrow), static_cast<int*>(maxabs),
                    static_cast<int*>(cb_max), static_cast<int*>(cb_bits)};
  switch (dtype) {
    case 0:
      return launch<uint16_t>(src, coef, n_planes, height, width, shift,
                              table, n_passes, epilogue, cb, out, stream);
    case 1:
      return launch<int16_t>(src, coef, n_planes, height, width, shift, table,
                             n_passes, epilogue, cb, out, stream);
    case 2:
      return launch<int>(src, coef, n_planes, height, width, shift, table,
                         n_passes, epilogue, cb, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
