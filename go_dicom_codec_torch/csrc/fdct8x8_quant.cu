// Fused 8×8 DCT-II + quantization for Hopper.
//
// Replaces: fdct8x8_quant_pallas, go_dicom_codec_tpu/ops/pallas_dct.py:58
// (pallas_call at :83). Computes, per 8×8 block of [B, H, W] int32
// samples: x - level_shift → float32 D·X·Dᵀ → / qtable → round half away
// from zero → int32, raster order within each block.
//
// Bound: device memory. ~16 FMAs per sample against 8 bytes of traffic
// (int32 in, int32 out) puts the kernel far below the H100's compute line.
//
// Design: one block of 256 threads owns an 8-row × 32-column tile (four
// 8×8 blocks side by side), so loads and stores are 128-byte coalesced
// rows. Both matrix products run in shared memory from one read of the
// tile: thread (u, c) forms Y[u][c] = Σ_x D[u][x]·X[x][c], then
// Z[u][v] = Σ_y Y[u][8b+y]·D[v][y]. D and the quant divisors are staged
// once per block into shared memory. The TPU kernel's 128×128
// block-diagonal Dᵀ and its W % 128 lane rule are gone: H and W need only
// be multiples of 8. Division stays the IEEE divide (no fast math), so a
// result differs from the plain version only by float summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;             // columns per tile: four 8×8 blocks
constexpr int kThreads = 8 * kTileW;   // one thread per sample of the tile

__global__ void __launch_bounds__(kThreads)
fdct8x8_quant_kernel(const int* __restrict__ x, int* __restrict__ out,
                     const float* __restrict__ dmat,
                     const float* __restrict__ qtab, int h, int w,
                     float level_shift, int tiles_x) {
  __shared__ float d[64];
  __shared__ float q[64];
  __shared__ float xs[8][kTileW];
  __shared__ float ys[8][kTileW];

  const int t = threadIdx.x;
  const int row = t / kTileW;   // sample row in the tile; u in both stages
  const int c = t % kTileW;     // sample column in the tile
  if (t < 64) {
    d[t] = dmat[t];
    q[t] = qtab[t];
  }
  const int block_rows = h / 8;
  long long tile = blockIdx.x;
  const int tx = static_cast<int>(tile % tiles_x);
  tile /= tiles_x;
  const int ty = static_cast<int>(tile % block_rows);
  const long long plane = tile / block_rows;
  const int col = tx * kTileW + c;
  const bool valid = col < w;  // W % 8 == 0: a partial tile holds whole blocks
  const long long off =
      (plane * h + ty * 8 + row) * static_cast<long long>(w) + col;

  xs[row][c] = valid ? static_cast<float>(x[off]) - level_shift : 0.0f;
  __syncthreads();

  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += d[row * 8 + k] * xs[k][c];
  ys[row][c] = acc;
  __syncthreads();

  const int b0 = c & ~7;  // first column of this sample's 8×8 block
  const int v = c & 7;
  acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc += ys[row][b0 + k] * d[v * 8 + k];
  const float r = acc / q[row * 8 + v];
  // round half away from zero (reference encoder.go:458-465)
  const float rr = r >= 0.0f ? floorf(r + 0.5f) : -floorf(-r + 0.5f);
  if (valid) out[off] = static_cast<int>(rr);
}

}  // namespace

extern "C" int gdct_fdct8x8_quant(const void* x, void* out, const void* d,
                                  const void* qtable, long long n_planes,
                                  int h, int w, float level_shift,
                                  void* stream) {
  if (h % 8 != 0 || w % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long blocks = n_planes * (h / 8) * tiles_x;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fdct8x8_quant_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out),
      static_cast<const float*>(d), static_cast<const float*>(qtable), h, w,
      level_shift, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
