// Reversible 5/3 lifting (ISO/IEC 15444-1 Annex F): the pieces that the
// per-pass kernels of dwt53.cu and the fused forward stage of
// j2k_fwd_stage.cu share.
//
// Lines are lifted on their interleaved samples with whole-sample
// symmetric extension, which is the edge clamp of the reference for both
// parities (the mirror keeps parity, so the neighbours of a low sample are
// high samples and the other way round). The packed [L | H] order is
// produced (forward) or undone (inverse) by the index map of the global
// store (forward) or load (inverse).
//
// Arithmetic is int32 with two's-complement wraparound (done in unsigned,
// since signed overflow is undefined in C++) and arithmetic >>, as jnp.

#pragma once

#include <cuda_runtime.h>

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

// Whole-sample symmetric extension of an interleaved index (n >= 2).
__device__ __forceinline__ int mirror(int q, int n) {
  return q < 0 ? -q : (q >= n ? 2 * (n - 1) - q : q);
}

// Interleaved position of packed index i: lows first, then highs.
__device__ __forceinline__ int packed_to_interleaved(int i, int sn, int lo0) {
  return i < sn ? 2 * i + lo0 : 2 * (i - sn) + (1 - lo0);
}

// Packed index of interleaved position p.
__device__ __forceinline__ int interleaved_to_packed(int p, int sn, int lo0) {
  return (p & 1) == lo0 ? (p - lo0) >> 1 : sn + ((p - (1 - lo0)) >> 1);
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

// One block's share of a pass: nl lines of n samples, line j's sample i at
// in[j * line_stride + i * elem_stride] (and the same offset of out), are
// read widened to int32 less `shift`, lifted in shared memory and written
// to out. in and out may be one buffer: every read of the block comes
// before its first write. Ends with a barrier, so a block may call it
// again for other lines.
template <bool kInverse, typename TIn>
__device__ __forceinline__ void lift_lines(const TIn* in, int* out, int shift,
                                           int* buf, int nl, int n,
                                           long long line_stride,
                                           long long elem_stride, bool even) {
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
    buf[j * ld + p] =
        wsub(static_cast<int>(in[j * line_stride + i * elem_stride]), shift);
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
    out[j * line_stride + i * elem_stride] = buf[j * ld + p];
  }
  __syncthreads();
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

}  // namespace gdct
