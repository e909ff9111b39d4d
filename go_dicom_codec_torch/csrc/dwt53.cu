// Reversible 5/3 lifting passes (ISO/IEC 15444-1 Annex F) for Hopper.
//
// Replaces: the jnp lifting of go_dicom_codec_tpu/ops/dwt53.py, which XLA
// fuses on the TPU — fwd53_1d (:71) for dwt53_fwd_pass and inv53_1d (:112)
// for dwt53_inv_pass. One call is one 1D pass, along rows or along
// columns, over a window at the top-left of every [H, W] plane of a
// [B, H, W] int32 array; a 2D level is two calls. The forward transform of
// lines that fit in shared memory runs as one launch of j2k_fwd_stage.cu;
// these passes serve the inverse and lines too long for shared memory.
//
// Bound: device memory. A pass reads and writes each sample of the window
// once (8 bytes) for ~6 integer operations per sample, far below the
// H100's compute line.
//
// Two routes, chosen by the caller from the line length:
//
// - shared memory (lines of up to 58111 samples): a block copies whole
//   lines into shared memory, lifts them there and writes them back, so
//   HBM sees one coalesced read and one coalesced write per sample and the
//   pass can run in place (writing L at row i would otherwise clobber
//   input row 2i still needs). Row passes put one or more rows in a block;
//   column passes put up to 32 neighbouring columns in a block so that
//   each row segment is one 128-byte transaction (lifting.cuh);
// - long lines (DICOM allows 65535 samples a side): the caller copies the
//   window to a snapshot of the window's size, then one launch computes
//   each output sample straight from the snapshot. A forward low needs the
//   five interleaved samples around it, a forward high three; the inverse
//   needs the same of the packed L and H. Twice the traffic of the
//   shared-memory route, for frames that are rare.

#include <algorithm>

#include "lifting.cuh"

namespace {

using gdct::interleaved_to_packed;
using gdct::kThreads;
using gdct::line_pitch;
using gdct::mirror;
using gdct::packed_to_interleaved;
using gdct::wadd;
using gdct::wsub;

template <bool kInverse>
__global__ void dwt53_pass_kernel(int* data, long long batch_stride,
                                  int n_lines, long long line_stride, int n,
                                  long long elem_stride, int lpb,
                                  int blocks_per_plane, int even) {
  extern __shared__ int buf[];  // [lpb][line_pitch(n)]
  const long long plane = blockIdx.x / blocks_per_plane;
  const int line0 = (blockIdx.x % blocks_per_plane) * lpb;
  const int nl = min(lpb, n_lines - line0);
  int* base = data + plane * batch_stride + line0 * line_stride;
  gdct::lift_lines<kInverse>(base, base, 0, buf, nl, n, line_stride,
                             elem_stride, even != 0);
}

// Window sample t of the pass, t over [planes][lines][n] in the order that
// keeps neighbouring threads on neighbouring addresses: (plane, line j,
// sample i) and its offset in the array.
struct Site {
  long long plane;
  int j, i;
};

__device__ __forceinline__ Site site(long long t, int n_lines, int n,
                                     bool rows) {
  const long long per_plane = static_cast<long long>(n_lines) * n;
  const long long plane = t / per_plane;
  const int k = static_cast<int>(t - plane * per_plane);
  const int j = rows ? k / n : k % n_lines;
  const int i = rows ? k - j * n : k / n_lines;
  return {plane, j, i};
}

// One line of the snapshot: sample q of the line, interleaved (forward)
// or read through the packed map (inverse).
struct Line {
  const int* base;
  long long stride;
  int n, lo0, sn;
  bool packed;

  __device__ __forceinline__ int operator()(int q) const {
    return base[(packed ? interleaved_to_packed(q, sn, lo0) : q) * stride];
  }
};

// Forward: the packed output sample at interleaved position p.
__device__ __forceinline__ int fwd_sample(const Line& x, int p) {
  const int n = x.n;
  const bool high = (p & 1) != x.lo0;
  auto hi = [&](int q) {  // predicted high at interleaved q
    return wsub(x(q), wadd(x(mirror(q - 1, n)), x(mirror(q + 1, n))) >> 1);
  };
  if (high) return hi(p);
  return wadd(x(p),
              wadd(wadd(hi(mirror(p - 1, n)), hi(mirror(p + 1, n))), 2) >> 2);
}

// Inverse: the interleaved output sample at position p.
__device__ __forceinline__ int inv_sample(const Line& y, int p) {
  const int n = y.n;
  const bool high = (p & 1) != y.lo0;
  auto lo = [&](int q) {  // low with the update undone, at interleaved q
    return wsub(y(q),
                wadd(wadd(y(mirror(q - 1, n)), y(mirror(q + 1, n))), 2) >> 2);
  };
  if (!high) return lo(p);
  return wadd(y(p), wadd(lo(mirror(p - 1, n)), lo(mirror(p + 1, n))) >> 1);
}

// snap holds each plane's window alone, [n_lines * n] words a plane, line
// j's sample i at j * snap_line + i * snap_elem.
template <bool kInverse>
__global__ void long_pass_kernel(const int* snap, int* data, long long total,
                                 long long batch_stride, int n_lines,
                                 long long line_stride, int n,
                                 long long elem_stride, long long snap_line,
                                 long long snap_elem, int even) {
  const bool rows = elem_stride == 1;
  const int lo0 = even ? 0 : 1;
  const int sn = (n + 1 - lo0) / 2;
  const long long snap_plane = static_cast<long long>(n_lines) * n;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Site s = site(t, n_lines, n, rows);
    const long long line = s.plane * batch_stride + s.j * line_stride;
    const Line x{snap + s.plane * snap_plane + s.j * snap_line, snap_elem, n,
                 lo0, sn, kInverse};
    int v;
    if (n == 1) {  // the ×2 / >>1 rule of lift_lines
      v = even ? x(0) : (kInverse ? x(0) >> 1 : wadd(x(0), x(0)));
    } else if (kInverse) {
      v = inv_sample(x, s.i);  // written at interleaved i
    } else {
      v = fwd_sample(x, packed_to_interleaved(s.i, sn, lo0));  // packed i
    }
    data[line + s.i * elem_stride] = v;
  }
}

template <bool kInverse>
int launch(void* data, long long n_planes, long long batch_stride,
           int n_lines, long long line_stride, int n, long long elem_stride,
           int lpb, int even, void* stream) {
  const long long per_plane = (n_lines + lpb - 1) / lpb;
  const long long blocks = n_planes * per_plane;
  if (lpb < 1 || n < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(lpb) * line_pitch(n) * sizeof(int);
  const cudaError_t err = gdct::reserve_smem(
      reinterpret_cast<const void*>(dwt53_pass_kernel<kInverse>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dwt53_pass_kernel<kInverse>
      <<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<int*>(data), batch_stride, n_lines, line_stride, n,
          elem_stride, lpb, static_cast<int>(per_plane), even);
  return static_cast<int>(cudaGetLastError());
}

int launch_long(void* data, const void* snap, long long n_planes,
                long long batch_stride, int n_lines, long long line_stride,
                int n, long long elem_stride, long long snap_line,
                long long snap_elem, int even, int inverse, void* stream) {
  if (n < 1 || n_lines < 1 || n_planes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = n_planes * n_lines * n;
  const unsigned blocks = static_cast<unsigned>(
      std::min<long long>((total + kThreads - 1) / kThreads, 132LL * 64));
  auto kernel = inverse ? long_pass_kernel<true> : long_pass_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(snap), static_cast<int*>(data), total,
      batch_stride, n_lines, line_stride, n, elem_stride, snap_line,
      snap_elem, even);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gdct_dwt53_fwd_pass(void* data, long long n_planes,
                                   long long batch_stride, int n_lines,
                                   long long line_stride, int n,
                                   long long elem_stride, int lpb, int even,
                                   void* stream) {
  return launch<false>(data, n_planes, batch_stride, n_lines, line_stride, n,
                       elem_stride, lpb, even, stream);
}

extern "C" int gdct_dwt53_inv_pass(void* data, long long n_planes,
                                   long long batch_stride, int n_lines,
                                   long long line_stride, int n,
                                   long long elem_stride, int lpb, int even,
                                   void* stream) {
  return launch<true>(data, n_planes, batch_stride, n_lines, line_stride, n,
                      elem_stride, lpb, even, stream);
}

// The long-line route of either pass: `snap` is a copy of the window that
// the caller made on the same stream (see long_pass_kernel for its layout).
extern "C" int gdct_dwt53_long_pass(void* data, const void* snap,
                                    long long n_planes, long long batch_stride,
                                    int n_lines, long long line_stride, int n,
                                    long long elem_stride, long long snap_line,
                                    long long snap_elem, int even, int inverse,
                                    void* stream) {
  return launch_long(data, snap, n_planes, batch_stride, n_lines, line_stride,
                     n, elem_stride, snap_line, snap_elem, even, inverse,
                     stream);
}
