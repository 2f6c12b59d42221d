// Count-Min table increment for Hopper (sm_90a): for each sketched column c
// of a row block [N, stride] and each sketch row d, the [width] histogram of
// mix32(rows[n, c], seeds[d]) % width over the N rows.  out is
// [n_cols, depth, width] int32.
//
// Replaces the Pallas TPU kernel cms_update_pallas / _cms_update_kernel
// (repro/kernels/sketch_update.py), and the sketch half (_cms_block) of
// fused_ingest_pallas and fused_ingest_dense_pallas
// (repro/kernels/ingest_fused.py): the fused ingest wrapper launches this
// kernel beside its destination kernels.
//
// The TPU kernels count by one-hot comparison against every bucket, because
// a scatter-add serialises there; that costs N * width compares per table.
// Here a table is a histogram in shared memory with atomic adds.  The work
// is tiny (the stream's call: 100,000 keys, 4 tables of 2,048 buckets, about
// twenty instructions a key and table), so what bounds the kernel is the
// launch, the latency of one pass over the keys, and the merge of the
// CTAs' tables into one.  The design:
//   * one CTA of 256 threads takes about 1,024 rows and reads each key
//     once: every table of the key's column (each seed) is counted from
//     that one read, the modulo by width a multiply-high with a magic
//     number (Granlund and Montgomery) instead of a division, UNROLL keys a
//     thread loaded before any is counted.  Each lane adds its own keys:
//     Hopper's shared-memory atomics absorb equal keys within a warp, and a
//     warp fold (__match_any_sync) measured slower on the stream's skewed
//     keys and on all-equal keys alike (PERF.md, PR 19);
//   * the 8 CTAs of a thread-block cluster merge their tables over
//     distributed shared memory: CTA r of the cluster sums slice r of every
//     CTA's tables (16-byte ld.shared::cluster loads) and writes it once;
//   * where one cluster covers all N rows (N <= cms_one_cluster_rows()),
//     the merged slices are the table itself: stored, zeros included, so
//     the caller need not zero it (no fill launch).  With more rows each
//     cluster adds its non-zero merged bins to a zeroed table with atomics.
//     Integer adds commute, so the table does not depend on the order of
//     the atomics: it equals the host's bucket_np histogram bit for bit;
//   * as many tables as fit in SMEM_WORDS share a CTA's shared memory
//     (blockIdx.y walks groups of tables); a table wider than SMEM_WORDS is
//     counted with atomics in device memory directly, each key still read
//     once for all its tables, a warp folding equal keys first there (one
//     address in device memory serialises its atomics in L2).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UNROLL = 4;            // keys a thread loads before it counts them
constexpr int SMEM_WORDS = 12288;    // 48 KB of tables a CTA
constexpr int MAX_COLS = 16;
constexpr int MAX_DEPTH = 32;
constexpr int THREADS = 256;
constexpr int CS = 8;                // CTAs a cluster (portable)
constexpr int ROWS_PER_CTA = 1024;   // a CTA's rows, until MAX_CLUSTERS clusters
constexpr int MAX_CLUSTERS = 16;
constexpr int GLOBAL_CTAS = 1024;    // the wide-table kernel's grid, at most
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Params {
  int cols[MAX_COLS];
  uint32_t seeds[MAX_DEPTH];
  const int32_t* rows;
  long long n;
  long long rows_per_cta;
  uint32_t* out;
  int stride;
  int depth;
  int n_tables;        // n_cols * depth
  int group;           // tables a CTA holds in shared memory
  uint32_t width;
  uint32_t magic;      // x / width = (hi + ((x - hi) >> 1)) >> shift, hi = umulhi(x, magic)
  int shift;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t bucket(uint32_t key, uint32_t seed, const Params& p) {
  const uint32_t x = mix32(key, seed);
  if (p.width == 1u) return 0u;
  const uint32_t hi = __umulhi(x, p.magic);
  return x - ((hi + ((x - hi) >> 1)) >> p.shift) * p.width;
}

// Count rows [begin, end) of column c into tables [d_lo, d_hi) of that
// column, table d at first + (d - d_lo) * width: one key a lane, UNROLL keys
// loaded before any is counted.  Whole warps run every iteration (base is
// warp uniform), so the match and the ballot see all 32 lanes.  FOLD: equal
// keys of a warp are counted by one lane (false: each lane adds its own).
template <int T, bool FOLD>
__device__ __forceinline__ void count_column(const Params& p, int c, int d_lo, int d_hi,
                                             long long begin, long long end, uint32_t* first) {
  const int lane = threadIdx.x & 31;
  const int col = p.cols[c];
  for (long long base = begin + (threadIdx.x & ~31); base < end;
       base += static_cast<long long>(T) * UNROLL) {
    uint32_t keys[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + static_cast<long long>(j) * T + lane;
      ok[j] = i < end;
      keys[j] = ok[j] ? static_cast<uint32_t>(__ldg(p.rows + i * p.stride + col)) : 0u;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      bool lead = ok[j];
      uint32_t cnt = 1u;
      if constexpr (FOLD) {
        // an idle lane's key may equal a live one: the ballot drops it
        const unsigned peers = __match_any_sync(FULL, keys[j]) & __ballot_sync(FULL, ok[j]);
        lead = ok[j] && lane == __ffs(peers) - 1;
        cnt = static_cast<uint32_t>(__popc(peers));
      }
      if (lead) {
        for (int d = d_lo; d < d_hi; ++d) {
          atomicAdd(first + static_cast<long long>(d - d_lo) * p.width +
                        bucket(keys[j], p.seeds[d], p),
                    cnt);
        }
      }
    }
  }
}

// Tables [t0, t1) counted over rows [begin, end); dst is table t0's storage
// (shared memory, or the output itself), the tables after it in order.
template <int T, bool FOLD>
__device__ __forceinline__ void count_tables(const Params& p, int t0, int t1, long long begin,
                                             long long end, uint32_t* dst) {
  for (int c = t0 / p.depth; c * p.depth < t1; ++c) {
    const int d_lo = max(t0 - c * p.depth, 0);
    const int d_hi = min(t1 - c * p.depth, p.depth);
    count_column<T, FOLD>(p, c, d_lo, d_hi, begin, end,
                          dst + static_cast<long long>(c * p.depth + d_lo - t0) * p.width);
  }
}

// Four words of CTA `rank`'s shared memory at the address of `local` in
// this CTA's: a 16-byte distributed-shared-memory load.
__device__ __forceinline__ uint4 load_rank(const uint4* local, unsigned rank) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote));
  return v;
}

// Tables that fit in shared memory: clusters of CS CTAs along x, each CTA
// over its chunk of rows; blockIdx.y is the group of tables.  write: one
// cluster covers all rows, so the merged bins are stored (out need not be
// zeroed); otherwise they are added to a zeroed out.
__global__ void __launch_bounds__(THREADS)
cms_cluster_kernel(Params p, int write) {
  __shared__ uint4 tab4[SMEM_WORDS / 4];
  uint32_t* tab = reinterpret_cast<uint32_t*>(tab4);
  cg::cluster_group cluster = cg::this_cluster();
  const int t0 = blockIdx.y * p.group;
  const int t1 = min(t0 + p.group, p.n_tables);
  const int words = (t1 - t0) * static_cast<int>(p.width);
  const int words4 = (words + 3) / 4;
  for (int w = threadIdx.x; w < words4; w += THREADS) tab4[w] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * p.rows_per_cta;
  const long long end = min(begin + p.rows_per_cta, p.n);
  count_tables<THREADS, false>(p, t0, t1, begin, end, tab);
  // every CTA of the cluster has counted: CTA r sums slice r over the cluster
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const int slice4 = (words4 + CS - 1) / CS;
  const int lo4 = static_cast<int>(rank) * slice4;
  const int hi4 = min(lo4 + slice4, words4);
  uint32_t* out = p.out + static_cast<long long>(t0) * p.width;
  for (int w4 = lo4 + threadIdx.x; w4 < hi4; w4 += THREADS) {
    uint32_t sum[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < CS; ++q) {  // unrolled: the loads are in flight together
      const uint4 v = load_rank(tab4 + w4, (rank + q) % CS);
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    // slice r of this CTA's tables is read by this CTA alone: it takes the sums
    tab4[w4] = make_uint4(sum[0], sum[1], sum[2], sum[3]);
  }
  // this CTA has read its peers' tables: it tells them so, writes its slice
  // out meanwhile, and leaves only when every peer has read its tables
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  for (int w4 = lo4 + threadIdx.x; w4 < hi4; w4 += THREADS) {
    const uint4 v = tab4[w4];
    const uint32_t sum[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = 4 * w4 + e;
      if (w >= words) break;
      if (write) {
        out[w] = sum[e];
      } else if (sum[e] != 0u) {
        atomicAdd(out + w, sum[e]);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Tables wider than shared memory: atomics in device memory (out zeroed),
// every table of a key's column from one read of the key, equal keys of a
// warp folded.
__global__ void __launch_bounds__(THREADS)
cms_global_kernel(Params p) {
  const long long begin = static_cast<long long>(blockIdx.x) * p.rows_per_cta;
  const long long end = min(begin + p.rows_per_cta, p.n);
  count_tables<THREADS, true>(p, 0, p.n_tables, begin, end, p.out);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int cms_max_cols() { return MAX_COLS; }
int cms_max_depth() { return MAX_DEPTH; }
int cms_smem_words() { return SMEM_WORDS; }
// rows up to which one cluster counts them all (and stores the table)
int cms_one_cluster_rows() { return CS * ROWS_PER_CTA; }

// rows: [n, stride] int32, contiguous; cols [n_cols] (each < stride) and
// seeds [depth] (uint32 bit patterns) are host arrays.  out: [n_cols, depth,
// width] int32 storage counted as uint32: zeroed by the caller, except
// where width <= cms_smem_words() and n <= cms_one_cluster_rows() (one
// cluster stores every entry).  Returns the launch's cudaError_t (0 =
// launched; a refused cluster launch is not 0).
int cms_launch(const void* rows, long long n, int stride, const int* cols, int n_cols,
               const unsigned* seeds, int depth, unsigned width, void* out, void* stream) {
  if (n_cols < 1 || n_cols > MAX_COLS || depth < 1 || depth > MAX_DEPTH || width < 1u ||
      width >= 0x80000000u || stride < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params p{};
  for (int i = 0; i < n_cols; ++i) p.cols[i] = cols[i];
  for (int i = 0; i < depth; ++i) p.seeds[i] = seeds[i];
  p.rows = static_cast<const int32_t*>(rows);
  p.n = n;
  p.out = static_cast<uint32_t*>(out);
  p.stride = stride;
  p.depth = depth;
  p.n_tables = n_cols * depth;
  p.width = width;
  if (width >= 2u) {  // Granlund and Montgomery 1994, figure 4.1
    int lg = 0;
    while ((1ull << lg) < width) ++lg;
    p.magic = static_cast<uint32_t>(((1ull << 32) * ((1ull << lg) - width)) / width + 1);
    p.shift = lg - 1;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width > static_cast<unsigned>(SMEM_WORDS)) {
    long long ctas = (n + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
    if (ctas > GLOBAL_CTAS) ctas = GLOBAL_CTAS;
    p.rows_per_cta = (n + ctas - 1) / ctas;
    cms_global_kernel<<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  p.group = SMEM_WORDS / static_cast<int>(width);
  if (p.group > p.n_tables) p.group = p.n_tables;
  const int groups = (p.n_tables + p.group - 1) / p.group;
  long long clusters = (n + static_cast<long long>(CS) * ROWS_PER_CTA - 1) /
                       (static_cast<long long>(CS) * ROWS_PER_CTA);
  if (clusters > MAX_CLUSTERS) clusters = MAX_CLUSTERS;
  const long long ctas = clusters * CS;
  p.rows_per_cta = (n + ctas - 1) / ctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas), static_cast<unsigned>(groups), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cms_cluster_kernel, p, static_cast<int>(clusters == 1));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, one warp: the launch floor that K4's time is read
// against (chip_smoke.py times it the way it times the kernels).
int cms_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
