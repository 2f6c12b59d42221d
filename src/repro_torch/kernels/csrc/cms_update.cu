// Count-Min table increment for Hopper (sm_90a): for each sketched column c
// of a row block [N, stride] and each sketch row d, the [width] histogram of
// mix32(rows[n, c], seeds[d]) % width over the N rows.  out is
// [n_cols, depth, width] int32, zeroed by the caller.
//
// Replaces the Pallas TPU kernel cms_update_pallas / _cms_update_kernel
// (repro/kernels/sketch_update.py), and the sketch half (_cms_block) of
// fused_ingest_pallas and fused_ingest_dense_pallas
// (repro/kernels/ingest_fused.py): the fused ingest wrapper launches this
// kernel beside its destination kernels.
//
// The TPU kernels count by one-hot comparison against every bucket, because
// a scatter-add serialises there; that costs N * width compares per table.
// Here a table is a histogram in shared memory with atomic adds: N adds per
// table.  What bounds it on this card: the hash (about ten int32
// operations per key and table: the mix32 rounds and the unsigned modulo)
// and the bytes, N * 4 read per column; both are tiny next to the ingest
// pass around it.  The design:
//   * grid (ceil(N / ROWS_PER_BLOCK), n_cols * depth): one table per
//     blockIdx.y, so a block hashes one column with one seed;
//   * a warp folds equal buckets first (__match_any_sync) and one lane adds
//     the group's size, so a heavy key (the skew the sketch exists to find)
//     costs one shared-memory atomic per warp, not 32;
//   * the block then adds its non-zero bins to the table in device memory.
//     Integer adds commute, so the table does not depend on the order of
//     the atomics: it equals the host's bucket_np histogram bit for bit;
//   * a table wider than SMEM_BINS is counted with atomics in device memory
//     directly (the same sums).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 4096;
constexpr int SMEM_BINS = 12288;  // 48 KB: the static shared-memory limit
constexpr int MAX_COLS = 16;
constexpr int MAX_DEPTH = 32;

struct Params {
  int cols[MAX_COLS];
  uint32_t seeds[MAX_DEPTH];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
cms_kernel(const int32_t* __restrict__ rows, int64_t n, int stride, Params p,
           int depth, uint32_t width, uint32_t* __restrict__ out) {
  __shared__ uint32_t hist[SMEM ? SMEM_BINS : 1];
  const int table = blockIdx.y;
  const int col = p.cols[table / depth];
  const uint32_t seed = p.seeds[table % depth];
  uint32_t* dst = out + static_cast<int64_t>(table) * width;
  if constexpr (SMEM) {
    for (uint32_t b = threadIdx.x; b < width; b += THREADS) hist[b] = 0u;
    __syncthreads();
  }
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * ROWS_PER_BLOCK;
  const int64_t end = begin + ROWS_PER_BLOCK < n ? begin + ROWS_PER_BLOCK : n;
  const int lane = threadIdx.x & 31;
  // base is the same for every lane, so whole warps enter each iteration
  // and __match_any_sync sees all 32 lanes
  for (int64_t base = begin; base < end; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const bool ok = i < end;
    // an idle lane's key, 0xFFFFFFFF, is no bucket: width < 2^31
    const uint32_t b =
        ok ? mix32(static_cast<uint32_t>(rows[i * stride + col]), seed) % width
           : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, b);
    if (ok && lane == __ffs(peers) - 1) {
      const uint32_t c = static_cast<uint32_t>(__popc(peers));
      if constexpr (SMEM) {
        atomicAdd(hist + b, c);
      } else {
        atomicAdd(dst + b, c);
      }
    }
  }
  if constexpr (SMEM) {
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < width; b += THREADS) {
      if (hist[b] != 0u) atomicAdd(dst + b, hist[b]);
    }
  }
}

}  // namespace

extern "C" {

int cms_max_cols() { return MAX_COLS; }
int cms_max_depth() { return MAX_DEPTH; }

// rows: [n, stride] int32, contiguous; cols [n_cols] (each < stride) and
// seeds [depth] (uint32 bit patterns) are host arrays.  out: [n_cols, depth,
// width] int32 storage, zeroed by the caller, counted as uint32.  Returns the
// launch's cudaError_t (0 = launched).
int cms_launch(const void* rows, long long n, int stride, const int* cols,
               int n_cols, const unsigned* seeds, int depth, unsigned width,
               void* out, void* stream) {
  if (n_cols < 1 || n_cols > MAX_COLS || depth < 1 || depth > MAX_DEPTH ||
      width < 1u || width >= 0x80000000u || stride < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params p{};
  for (int i = 0; i < n_cols; ++i) p.cols[i] = cols[i];
  for (int i = 0; i < depth; ++i) p.seeds[i] = seeds[i];
  const dim3 grid(static_cast<unsigned>((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK),
                  static_cast<unsigned>(n_cols * depth));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (width <= static_cast<unsigned>(SMEM_BINS)) {
    cms_kernel<true><<<grid, THREADS, 0, st>>>(r, n, stride, p, depth, width, o);
  } else {
    cms_kernel<false><<<grid, THREADS, 0, st>>>(r, n, stride, p, depth, width, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
