// Fused 8×8 DCT-II + quantization for Hopper.
//
// Replaces: fdct8x8_quant_pallas, go_dicom_codec_tpu/ops/pallas_dct.py:58
// (pallas_call at :83). Computes, per 8×8 block of [B, H, W] int32
// samples: x - level_shift → float32 Y = D·X, then Z = Y·Dᵀ → Z / qtable
// (IEEE divide) → round half away from zero → int32, saturating (NaN → 0,
// as XLA's cast), raster order within each block. H % 8 == W % 8 == 0.
//
// Bound: device memory. 8 bytes a sample (int32 in, int32 out) against
// ~35 float operations, far below the H100's float32 rate: the kernel has
// to keep HBM busy. A first design (one 4-byte load a thread, blocks of
// 256 threads in lockstep over an 8×32 tile, the tables re-read per tile)
// reached 30 % of the bound.
//
// Design:
// - A warp owns a tile of 8 rows × 32 columns: four 8×8 blocks side by
//   side, the lanes of a block past W masked. Warps of a persistent grid
//   (the blocks the card holds at once) walk the tiles; a tile index is
//   divided once, then each step adds the stride's quotient and remainder.
// - Memory: a lane moves two 16-byte chunks, chunk lane % 8 of tile rows
//   lane / 8 and lane / 8 + 4, so that each warp instruction covers four
//   whole 128-byte rows (a lane owning one 32-byte block row would fill
//   only half of each 32-byte sector per instruction, and even a plain
//   copy in that layout falls well short of the x+1 copy). Loads go by
//   cp.async into a per-warp ring of kStages tiles, so each warp has the
//   next tiles in flight while it computes; stores are streaming 16-byte
//   stores. The wrapper checks that x and out are 16-byte aligned.
// - Compute: both 8-point products run in registers with D whole held in
//   registers for the walk (and the lane's row of divisors). The warp's
//   tile in shared memory, at a block pitch of 72 floats that keeps every
//   access free of bank conflicts, turns rows into columns and back:
//   X chunks in, X column out; Y = D·X column by column (the TPU kernel's
//   order); Y column in, Y row out; Z = Y·Dᵀ row by row; Z row in, Z
//   chunks out. Only __syncwarp() orders it: no block-wide barrier.
// - The same arithmetic as the plain version: IEEE divide by Q, round half
//   away from zero, saturating conversion (no fast math).
//
// Measured at [32, 512, 512] (chip_smoke.py: torch.profiler device time,
// NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 0.0275 ms against the
// 0.0200 ms byte bound and 0.0237 ms for an x+1 copy of the same tensor.

#include <cuda_runtime.h>

#include "lifting.cuh"  // gdct::resident_blocks, gdct::kThreads

namespace {

constexpr int kWarps = gdct::kThreads / 32;
constexpr int kBlocksPerTile = 4;               // 8×8 blocks across a tile
constexpr int kTileW = 8 * kBlocksPerTile;      // 32 columns
// floats a block in shared memory: rows of 8 at a block pitch of 72, so
// that a warp's column reads (four blocks, eight columns) and its row
// accesses (a quarter warp per block) each hit 32 distinct banks
constexpr int kPitch = 72;
constexpr int kStages = 3;  // tiles a warp has requested: this one and ahead

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kStages - 1 of this thread's copy groups are pending
__device__ __forceinline__ void wait_oldest_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// round half away from zero (reference encoder.go:458-465): floor(r + 0.5)
// for r ≥ 0, else -floor(-r + 0.5), which is ceil(r - 0.5) bit for bit
// (float rounding is symmetric). cvt.rmi/.rpi.s32.f32 clamp to the int32
// range and give 0 for NaN (PTX ISA, cvt): the saturating cast of XLA.
__device__ __forceinline__ int quant(float z, float q) {
  const float r = z / q;
  return r >= 0.0f ? __float2int_rd(r + 0.5f) : __float2int_ru(r - 0.5f);
}

// A warp's walk over the tiles: tile = g * tiles_x + tx, g the block row
// over every plane (planes are contiguous, so block row g starts at
// g * 8 * w). One division at the start; each step adds the stride's
// quotient and remainder.
struct Walk {
  long long tile, g;
  int tx;
  __device__ void step(long long stride, long long sq, int sr,
                       int tiles_x) {
    tile += stride;
    g += sq;
    tx += sr;
    if (tx >= tiles_x) {
      tx -= tiles_x;
      ++g;
    }
  }
};

__global__ void __launch_bounds__(gdct::kThreads, 2)
fdct8x8_quant_kernel(const int* __restrict__ x, int* __restrict__ out,
                     const float* __restrict__ dmat,
                     const float* __restrict__ qtab, int w,
                     float level_shift, long long n_tiles, int tiles_x) {
  __shared__ __align__(16) float xs[kWarps][kBlocksPerTile * kPitch];
  // each lane's two chunks of the tiles in flight, [stage][row half][lane]
  __shared__ __align__(16) int4 ring[kWarps][kStages][2][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // compute roles: the lane's 8×8 block in the tile and its column there
  // (first product), then its row (second product)
  const int blk = lane >> 3;
  const int j = lane & 7;
  // memory roles: the lane moves 16-byte chunk m of rows rm and rm + 4 of
  // the tile, so that one instruction of the warp covers four whole
  // 128-byte rows; the chunk lies in block m / 2, half m % 2
  const int m = lane & 7;
  const int rm = lane >> 3;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (first >= n_tiles) return;
  // D whole and row j of the divisors, in registers for the whole walk
  float d[64], qj[8];
#pragma unroll
  for (int k = 0; k < 64; ++k) d[k] = __ldg(dmat + k);
#pragma unroll
  for (int v = 0; v < 8; ++v) qj[v] = __ldg(qtab + j * 8 + v);

  const long long sq = stride / tiles_x;
  const int sr = static_cast<int>(stride - sq * tiles_x);
  float* tile_s = xs[warp];
  float* xw = tile_s + blk * kPitch;  // this lane's block
  float4* row = reinterpret_cast<float4*>(xw + j * 8);
  // chunk m of tile rows rm and rm + 4 in shared memory
  float4* chunk = reinterpret_cast<float4*>(tile_s + (m >> 1) * kPitch +
                                            rm * 8 + (m & 1) * 4);
  Walk cur{first, first / tiles_x, 0};
  cur.tx = static_cast<int>(first - cur.g * tiles_x);

  // the chunk's offset in row rm of the tile, and whether its block is
  // inside the plane (W % 8 == 0: a block is all in or all out)
  auto chunk_at = [&](const Walk& t) {
    return (t.g * 8 + rm) * static_cast<long long>(w) + t.tx * kTileW + m * 4;
  };
  auto inside = [&](const Walk& t) {
    return t.tx * kTileW + (m >> 1) * 8 < w;
  };
  const long long four_rows = 4LL * w;
  int4(*slots)[2][32] = ring[warp];
  Walk ahead = cur;  // the next tile to request
  // request this lane's chunks of the tile at `ahead` into ring slot `slot`
  auto request = [&](int slot) {
    if (ahead.tile < n_tiles && inside(ahead)) {
      const int* p = x + chunk_at(ahead);
      copy16_async(&slots[slot][0][lane], p);
      copy16_async(&slots[slot][1][lane], p + four_rows);
    }
    commit_async();  // an empty group past the end keeps the count
    ahead.step(stride, sq, sr, tiles_x);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) request(k);
  for (int i = 0; cur.tile < n_tiles; ++i) {
    request((i + kStages - 1) % kStages);
    wait_oldest_async();  // this lane's chunks of tile i have landed
    const int4 a0 = slots[i % kStages][0][lane];
    const int4 a1 = slots[i % kStages][1][lane];

    // X chunks in, X column j out
    chunk[0] = make_float4(static_cast<float>(a0.x) - level_shift,
                           static_cast<float>(a0.y) - level_shift,
                           static_cast<float>(a0.z) - level_shift,
                           static_cast<float>(a0.w) - level_shift);
    chunk[8] = make_float4(static_cast<float>(a1.x) - level_shift,
                           static_cast<float>(a1.y) - level_shift,
                           static_cast<float>(a1.z) - level_shift,
                           static_cast<float>(a1.w) - level_shift);
    __syncwarp();
    float c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = xw[k * 8 + j];
    // Y[u][j] = Σ_k D[u][k] · X[k][j]
    float yc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float acc = d[u * 8] * c[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) acc = fmaf(d[u * 8 + k], c[k], acc);
      yc[u] = acc;
    }
    __syncwarp();  // every lane has read X before Y takes its place
    // Y column j in, Y row j out
#pragma unroll
    for (int u = 0; u < 8; ++u) xw[u * 8 + j] = yc[u];
    __syncwarp();
    const float4 lo = row[0], hi = row[1];
    const float yr[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    // Z[j][v] = Σ_k Y[j][k] · D[v][k], quantized
    int o[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float z = yr[0] * d[v * 8];
#pragma unroll
      for (int k = 1; k < 8; ++k) z = fmaf(yr[k], d[v * 8 + k], z);
      o[v] = quant(z, qj[v]);
    }
    __syncwarp();  // every lane has read Y before Z takes its place
    // Z row j in (rows 4-7 write their halves in the other order, so that
    // each instruction's quarter warp hits distinct banks), Z chunks out
    int4* zrow = reinterpret_cast<int4*>(row);
    const int4 z0 = make_int4(o[0], o[1], o[2], o[3]);
    const int4 z1 = make_int4(o[4], o[5], o[6], o[7]);
    const bool swap = j >= 4;
    zrow[swap] = swap ? z1 : z0;
    zrow[!swap] = swap ? z0 : z1;
    __syncwarp();
    const int4* zc = reinterpret_cast<const int4*>(chunk);
    if (inside(cur)) {
      int* p = out + chunk_at(cur);
      __stcs(reinterpret_cast<int4*>(p), zc[0]);
      __stcs(reinterpret_cast<int4*>(p + four_rows), zc[8]);
    }
    __syncwarp();  // every lane has read Z before the next tile's X
    cur.step(stride, sq, sr, tiles_x);
  }
}

}  // namespace

extern "C" int gdct_fdct8x8_quant(const void* x, void* out, const void* d,
                                  const void* qtable, long long n_planes,
                                  int h, int w, float level_shift,
                                  void* stream) {
  if (h % 8 != 0 || w % 8 != 0 || n_planes < 0 ||
      reinterpret_cast<unsigned long long>(x) % 16 != 0 ||
      reinterpret_cast<unsigned long long>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long n_tiles = n_planes * (h / 8) * tiles_x;
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  int resident = 0;
  cudaError_t err = gdct::resident_blocks(
      reinterpret_cast<const void*>(fdct8x8_quant_kernel), 0, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (n_tiles + kWarps - 1) / kWarps;
  const unsigned grid =
      static_cast<unsigned>(wanted < resident ? wanted : resident);
  fdct8x8_quant_kernel<<<grid, gdct::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out),
      static_cast<const float*>(d), static_cast<const float*>(qtable), w,
      level_shift, n_tiles, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
