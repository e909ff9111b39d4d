// Reversible 5/3 lifting (ISO/IEC 15444-1 Annex F): the pieces that the
// per-pass kernels of dwt53.cu and the fused stages of j2k_fwd_stage.cu and
// j2k_inv_stage.cu share.
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

// Lift every line of buf ([nl][line_pitch(n)], n interleaved samples each)
// over positions first, first + 2, ... (count per line): buf[p] += sign *
// ((buf[l] + buf[r] + rnd) >> shift) with l, r the mirrored neighbours of p.
__device__ __forceinline__ void lift(int* buf, int nl, int n, int first,
                                     int count, int rnd, int shift,
                                     bool add) {
  for (Walk w(count); w.s < nl; w.next()) {
    const int p = first + 2 * w.f;
    int* line = buf + w.s * line_pitch(n);
    const int t = wadd(wadd(line[mirror(p - 1, n)], line[mirror(p + 1, n)]),
                       rnd) >> shift;
    line[p] = add ? wadd(line[p], t) : wsub(line[p], t);
  }
}

// The loads and stores of lift_lines: sample i of line j, at `at` = j *
// line_stride + i * elem_stride from the block's first line.
template <typename T>
struct Widen {  // in[at] widened to int32, less `shift`
  const T* in;
  int shift;
  __device__ __forceinline__ int operator()(int, int, long long at) const {
    return wsub(static_cast<int>(in[at]), shift);
  }
};

struct Put {  // out[at] = v
  int* out;
  __device__ __forceinline__ void operator()(long long at, int v) const {
    out[at] = v;
  }
};

// One block's share of a pass: nl lines of n samples, line j's sample i
// read as load(j, i, at), lifted in shared memory and handed to
// store(at, v). Load and store may address one buffer: every read of the
// block comes before its first write. Ends with a barrier, so a block may
// call it again for other lines.
template <bool kInverse, typename Load, typename Store>
__device__ __forceinline__ void lift_lines(const Load& load,
                                           const Store& store, int* buf,
                                           int nl, int n,
                                           long long line_stride,
                                           long long elem_stride, bool even) {
  const bool rows = elem_stride == 1;
  const int lo0 = even ? 0 : 1;
  const int sn = (n + 1 - lo0) / 2;  // number of low-pass samples
  const int dn = n - sn;
  const int ld = line_pitch(n);

  // Coalesced load: consecutive threads take consecutive addresses.
  for (Walk w(rows ? n : nl); w.s < (rows ? nl : n); w.next()) {
    const int j = rows ? w.s : w.f;
    const int i = rows ? w.f : w.s;
    const int p = kInverse ? packed_to_interleaved(i, sn, lo0) : i;
    buf[j * ld + p] = load(j, i, j * line_stride + i * elem_stride);
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

  for (Walk w(rows ? n : nl); w.s < (rows ? nl : n); w.next()) {
    const int j = rows ? w.s : w.f;
    const int i = rows ? w.f : w.s;
    const int p = kInverse ? i : packed_to_interleaved(i, sn, lo0);
    store(j * line_stride + i * elem_stride, buf[j * ld + p]);
  }
  __syncthreads();
}

// The same, reading in[at] widened to int32 less `shift` and writing
// out[at].
template <bool kInverse, typename TIn>
__device__ __forceinline__ void lift_lines(const TIn* in, int* out, int shift,
                                           int* buf, int nl, int n,
                                           long long line_stride,
                                           long long elem_stride, bool even) {
  lift_lines<kInverse>(Widen<TIn>{in, shift}, Put{out}, buf, nl, n,
                       line_stride, elem_stride, even);
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
