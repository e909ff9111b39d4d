// Reversible 5/3 lifting passes (ISO/IEC 15444-1 Annex F) for Hopper.
//
// Replaces: the jnp lifting of go_dicom_codec_tpu/ops/dwt53.py, which XLA
// fuses on the TPU — fwd53_1d (:71) for dwt53_fwd_pass and inv53_1d (:112)
// for dwt53_inv_pass. One launch is one 1D pass, along rows or along
// columns, over a window at the top-left of every [H, W] plane of a
// [B, H, W] int32 array; a 2D level is two launches.
//
// Bound: device memory. A pass reads and writes each sample of the window
// once (8 bytes) for ~6 integer operations per sample, far below the
// H100's compute line.
//
// Design: a block copies whole lines into shared memory, lifts them there
// and writes them back, so HBM sees one coalesced read and one coalesced
// write per sample and the pass can run in place (writing L at row i would
// otherwise clobber input row 2i still needs). Row passes put one or more
// rows in a block; column passes put up to 32 neighbouring columns in a
// block so that each row segment is one 128-byte transaction; lines sit in
// shared memory at an odd pitch, so those 32 columns fall in 32 different
// banks. Lifting runs
// on the interleaved samples with whole-sample symmetric extension, which
// is the edge clamp of the reference for both parities; the packed
// [L | H] order is produced (forward) or undone (inverse) by the index
// map of the global store (forward) or load (inverse).
//
// Arithmetic is int32 with two's-complement wraparound (done in unsigned,
// since signed overflow is undefined in C++) and arithmetic >>, as jnp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Whole-sample symmetric extension of an interleaved index (n >= 2).
__device__ __forceinline__ int mirror(int q, int n) {
  return q < 0 ? -q : (q >= n ? 2 * (n - 1) - q : q);
}

// Interleaved position of packed index i: lows first, then highs.
__device__ __forceinline__ int packed_to_interleaved(int i, int sn, int lo0) {
  return i < sn ? 2 * i + lo0 : 2 * (i - sn) + (1 - lo0);
}

// Words between lines in shared memory: n made odd, so that the 32 lanes
// of a warp that take 32 neighbouring columns of a column pass, at one
// position each, hit 32 different banks (a stride of n = 512 would put
// them all in one bank).
__host__ __device__ __forceinline__ int line_pitch(int n) { return n | 1; }

// Lift every line of buf ([nl][line_pitch(n)], n interleaved samples each)
// over positions first, first + 2, ... (count per line): buf[p] += sign *
// ((buf[l] + buf[r] + rnd) >> shift) with l, r the mirrored neighbours of p.
__device__ __forceinline__ void lift(int* buf, int nl, int n, int first,
                                     int count, int rnd, int shift,
                                     bool add) {
  const int total = nl * count;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int j = k / count;
    const int p = first + 2 * (k - j * count);
    int* line = buf + j * line_pitch(n);
    const int t = wadd(wadd(line[mirror(p - 1, n)], line[mirror(p + 1, n)]),
                       rnd) >> shift;
    line[p] = add ? wadd(line[p], t) : wsub(line[p], t);
  }
}

template <bool kInverse>
__global__ void dwt53_pass_kernel(int* __restrict__ data,
                                  long long batch_stride, int n_lines,
                                  long long line_stride, int n,
                                  long long elem_stride, int lpb,
                                  int blocks_per_plane, int even) {
  extern __shared__ int buf[];  // [lpb][line_pitch(n)]
  const long long plane = blockIdx.x / blocks_per_plane;
  const int line0 = (blockIdx.x % blocks_per_plane) * lpb;
  const int nl = min(lpb, n_lines - line0);
  int* base = data + plane * batch_stride + line0 * line_stride;
  const int total = nl * n;
  const bool rows = elem_stride == 1;
  const int lo0 = even ? 0 : 1;
  const int sn = (n + 1 - lo0) / 2;  // number of low-pass samples
  const int dn = n - sn;
  const int ld = line_pitch(n);

  // Coalesced load: consecutive threads take consecutive addresses.
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int j = rows ? k / n : k % nl;
    const int i = rows ? k - j * n : k / nl;
    const int p = kInverse ? packed_to_interleaved(i, sn, lo0) : i;
    buf[j * ld + p] = base[j * line_stride + i * elem_stride];
  }
  __syncthreads();

  if (n == 1) {
    // A single sample at odd parity is a high-pass sample: ×2 forward,
    // >>1 inverse (reference dwt53.go:70-73, :176). Even parity: identity.
    if (!even) {
      for (int k = threadIdx.x; k < nl; k += blockDim.x) {
        buf[k] = kInverse ? (buf[k] >> 1) : wadd(buf[k], buf[k]);
      }
    }
  } else if (!kInverse) {
    lift(buf, nl, n, 1 - lo0, dn, 0, 1, false);  // predict highs
    __syncthreads();
    lift(buf, nl, n, lo0, sn, 2, 2, true);       // update lows
  } else {
    lift(buf, nl, n, lo0, sn, 2, 2, false);      // undo update
    __syncthreads();
    lift(buf, nl, n, 1 - lo0, dn, 0, 1, true);   // undo predict
  }
  __syncthreads();

  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int j = rows ? k / n : k % nl;
    const int i = rows ? k - j * n : k / nl;
    const int p = kInverse ? i : packed_to_interleaved(i, sn, lo0);
    base[j * line_stride + i * elem_stride] = buf[j * ld + p];
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
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dwt53_pass_kernel<kInverse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dwt53_pass_kernel<kInverse>
      <<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<int*>(data), batch_stride, n_lines, line_stride, n,
          elem_stride, lpb, static_cast<int>(per_plane), even);
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
