// Histogram (bincount) for Hopper (sm_90a): out[b] = number of i with
// values[i] == b, for b in [0, num_bins); negative values and values >=
// num_bins are dropped.  out is [num_bins] int32, zeroed by the caller.
//
// Replaces the Pallas TPU kernel histogram_pallas / _histogram_kernel
// (repro/kernels/histogram.py), and computes what that kernel computes: its
// one-hot is taken against iota [0, num_bins), so it drops values >=
// num_bins as well as negatives (the jnp oracle histogram_ref clips them
// into the last bin instead).
//
// The TPU kernel counts by one-hot comparison against every bin, because a
// scatter-add serialises there: N * num_bins compares.  Here the histogram
// lives in shared memory and takes atomic adds, N of them; what bounds it
// on this card is the bytes (N * 4 read, num_bins * 4 written) and the
// atomics on a heavy value.  The design:
//   * a warp folds equal bins first (__match_any_sync) and one lane adds the
//     group's size, so a heavy hitter (the skew the count exists to find)
//     costs one shared-memory atomic per warp, not 32;
//   * bins are tiled over blockIdx.y, TILE_BINS (192 KB of dynamic shared
//     memory) at a time, so a range of 100,000 bins, 400 KB, which does not
//     fit in one block, is counted in three tiles, each block reading its
//     values once per tile; a block ignores the values outside its tile;
//   * the blocks of one tile stride over the values, then add their non-zero
//     bins to out in device memory.  Integer adds commute, so out does not
//     depend on the order of the atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_BINS = 49152;           // 192 KB of dynamic shared memory
constexpr long long VALUES_PER_BLOCK = 32768;
constexpr int MAX_BLOCKS_PER_TILE = 264;   // two per SM of an H100

__global__ void __launch_bounds__(THREADS)
histogram_kernel(const int32_t* __restrict__ values, long long n, int num_bins, int tile,
                 uint32_t* __restrict__ out) {
  extern __shared__ uint32_t hist[];
  const int lo = blockIdx.y * tile;
  const int width = min(tile, num_bins - lo);
  for (int b = threadIdx.x; b < width; b += THREADS) hist[b] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  // base is the same for every lane, so whole warps enter each iteration
  // and __match_any_sync sees all 32 lanes
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS; base < n; base += step) {
    const long long i = base + threadIdx.x;
    uint32_t bin = 0xFFFFFFFFu;  // no bin: width <= TILE_BINS
    if (i < n) {
      const int32_t x = values[i];
      if (x >= lo && x - lo < width) bin = static_cast<uint32_t>(x - lo);
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
    if (bin != 0xFFFFFFFFu && lane == __ffs(peers) - 1) {
      atomicAdd(hist + bin, static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += THREADS) {
    if (hist[b] != 0u) atomicAdd(out + lo + b, hist[b]);
  }
}

}  // namespace

extern "C" {

// values: [n] int32 on the card; out: [num_bins] int32 storage, zeroed by
// the caller, counted as uint32.  Returns the launch's cudaError_t
// (0 = launched).
int histogram_launch(const void* values, long long n, int num_bins, void* out, void* stream) {
  if (n < 0 || num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tile = num_bins < TILE_BINS ? num_bins : TILE_BINS;
  const int tiles = (num_bins + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + VALUES_PER_BLOCK - 1) / VALUES_PER_BLOCK;
  if (blocks > MAX_BLOCKS_PER_TILE) blocks = MAX_BLOCKS_PER_TILE;
  const size_t bytes = sizeof(uint32_t) * static_cast<size_t>(tile);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  histogram_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), n, num_bins, tile, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
