// Fused streaming-ingest pass for Hopper (sm_90a): for a row block
// [N, arity] and a route program (repro_torch.kernels.ingest_fused.
// route_program, compiled on the host from the dense encoding of
// dense_route_encoding, Wp columns),
//   dest  [N, Wp]  the reducer each (row, column) emission goes to, -1 where
//                  the column is padding, a pin fails or an exclude hits;
//   rank  [N, Wp]  the number of earlier emissions to the same reducer in
//                  flat row-major order (what a stable sort by destination
//                  gives), -1 where dest is -1;
//   counts [k_pad] emissions per reducer.
// The Count-Min half of the pass is csrc/cms_update.cu, which the Python
// wrapper launches beside these kernels.
//
// Replaces the Pallas TPU kernels fused_ingest_dense_pallas
// (_dest_block_dense, _rank_counts_block) and fused_ingest_pallas
// (_dest_block, _rank_counts_block) of repro/kernels/ingest_fused.py.  The
// static-table variant is the same kernels: its wrapper encodes the table
// with dense_route_encoding (Wp = W) and counts num_reducers destinations.
// Wp and k_pad are any sizes the caller needs.
//
// The TPU kernels rank by a dense order comparison inside each block of B
// rows ((B * W)^2 compares) and count by one-hot against every reducer.
// Here the rank is a counting sort's, over tiles of rows_per_tile rows
// (at most MAX_TILE emissions), in three kernels:
//   1. ingest_count_kernel, grid (tiles, ranges): a block stages its tile's
//      rows in shared memory (at most MAX_ROW_WORDS words, one coalesced
//      read) and evaluates the tile's destinations a column group at a
//      time across a warp, 32 rows a warp, so the warp's lanes share one
//      group's terms; it writes dest through a shared-memory batch of
//      BATCH_ROWS x BATCH_COLS (range 0's blocks only) and counts the
//      destinations of its range with shared-memory atomics, which commute,
//      so the counts do not depend on the order; then it writes its row of
//      table [tiles, k_pad].  Destinations are split into ranges of RANGE,
//      so shared memory holds the counters for any k_pad.
//   2. ingest_scan_kernel: down each destination's column of the table, the
//      exclusive prefix over tiles; counts[d] = the column total.
//   3. ingest_rank_kernel, grid (tiles, ranges): the block's eight warps
//      each own a contiguous eighth of the tile, with 16-bit counters of
//      their own for the range.  Each warp counts its segment with
//      shared-memory atomics (A); the block turns the counts into an
//      exclusive prefix across warps (B); each warp walks its segment
//      again in flat order, 32 emissions a step, lanes of
//      one destination meeting by __match_any_sync (C), so an emission's
//      rank is its tile's base from the table, plus the warps before it,
//      plus the counter before the step, plus its peers in lower lanes.  The
//      walk's order is fixed, so the rank is the stable one whatever the
//      scheduling; rank is written once.  The loads of dest and of the
//      bases of UNROLL steps are issued before the steps, so their latency
//      is paid once for the group and not on the walk's chain.
// What bounds the pass on this card: the bytes of dest and rank, 8 * N * Wp,
// each written once (the table, N * Wp / tile * k_pad words, and the
// second and third reads of dest stay in the 50 MB L2 at the stream's
// shapes), and the integer work of the destinations.  route_program keeps
// that work small: columns that differ only in their base (a residual's
// replicas) form a group whose terms are evaluated once a row; a group's
// pins and excludes that are on and its hashed terms that can be non-zero
// are four words each, read as int4; and each modulo by a hashed
// dimension is a multiply-high and shifts with the magic number of
// Granlund and Montgomery (1994, figure 4.1), computed on the host.  All
// arithmetic on ids is uint32, whose wraparound is the reference's int32
// semantics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;         // steps of a warp whose loads are in flight together
constexpr int MAX_TILE = 65535;   // emissions per tile: 16-bit counters in the rank kernel
constexpr int MAX_ROW_WORDS = 8192;  // a tile's rows staged by the count kernel: 32 KB
constexpr int BATCH_ROWS = 256;   // the count kernel's dest batch: 256 rows
constexpr int BATCH_COLS = 32;    // by 32 columns, staged to be written coalesced
constexpr int RANGE = 12288;      // destinations per block: 8 warps x 2 bytes = 192 KB
constexpr int SCAN_X = 32;        // destinations per scan block
constexpr int SCAN_Y = 32;        // tile segments per scan block
constexpr uint32_t NONE = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// A column group's tests and hashed terms (route_program) applied to one
// row: false where a test fails, else true with h the sum of the hashed
// terms.  A test is (col, value, must_equal, 0); a hashed term is (col,
// seed, dim, stride) then (magic, shift, 0, 0), dim >= 2.
__device__ __forceinline__ bool group_terms(const int32_t* row, const int4* __restrict__ t,
                                            int tests, int hashed, uint32_t& h) {
  for (int j = 0; j < tests; ++j) {
    const int4 q = __ldg(t + j);
    if ((row[q.x] == q.y) != (q.z != 0)) return false;
  }
  t += tests;
  h = 0u;
  for (int j = 0; j < hashed; ++j) {
    const int4 a = __ldg(t + 2 * j);
    const int4 m = __ldg(t + 2 * j + 1);
    const uint32_t x = mix32(static_cast<uint32_t>(row[a.x]), static_cast<uint32_t>(a.y));
    const uint32_t hi = __umulhi(x, static_cast<uint32_t>(m.x));
    const uint32_t q = (hi + ((x - hi) >> 1)) >> m.y;  // x / dim
    h += (x - q * static_cast<uint32_t>(a.z)) * static_cast<uint32_t>(a.w);
  }
  return true;
}

// The slot of destination d in the range [lo, lo + width), NONE outside it
// (d = -1 included).
__device__ __forceinline__ uint32_t in_range(int32_t d, int lo, int width) {
  const uint32_t rel = static_cast<uint32_t>(d) - static_cast<uint32_t>(lo);
  return d >= 0 && rel < static_cast<uint32_t>(width) ? rel : NONE;
}

__global__ void __launch_bounds__(THREADS)
ingest_count_kernel(const int32_t* __restrict__ rows, int n, int arity,
                    const int4* __restrict__ prog, int wp, int k_pad, int rows_per_tile,
                    int32_t* __restrict__ dest, uint32_t* __restrict__ table) {
  extern __shared__ uint32_t smem[];
  const int tile = blockIdx.x;
  const int lo = blockIdx.y * RANGE;
  const int width = min(RANGE, k_pad - lo);
  const int r0 = tile * rows_per_tile;
  const int n_rows = min(n, r0 + rows_per_tile) - r0;
  const int64_t off = static_cast<int64_t>(r0) * wp;
  const int pitch = min(wp, BATCH_COLS) | 1;  // odd: a warp's 32 rows hit 32 banks
  uint32_t* cnt = smem;                                     // [width]
  int32_t* batch = reinterpret_cast<int32_t*>(cnt + width);  // [BATCH_ROWS][pitch]
  int32_t* tile_rows = batch + BATCH_ROWS * pitch;          // [n_rows][arity]
  for (int i = threadIdx.x; i < width; i += THREADS) cnt[i] = 0u;
  const int32_t* src = rows + static_cast<int64_t>(r0) * arity;
  for (int i = threadIdx.x; i < n_rows * arity; i += THREADS) tile_rows[i] = __ldg(src + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool writes = blockIdx.y == 0;  // uniform in the block
  const int4 top = __ldg(prog);        // (groups, wp, bases, owners)
  const uint32_t* bases = reinterpret_cast<const uint32_t*>(prog + top.z);
  const int32_t* owners = reinterpret_cast<const int32_t*>(prog + top.w);
  int32_t* tile_dest = dest + off;
  for (int b0 = 0; b0 < n_rows; b0 += BATCH_ROWS) {
    const int b_rows = min(BATCH_ROWS, n_rows - b0);
    const int n_rg = (b_rows + 31) / 32;
    for (int c0 = 0; c0 < wp; c0 += BATCH_COLS) {
      const int cw = min(BATCH_COLS, wp - c0);
      // item (g, rg): column group g's columns in [c0, c0 + cw) for the 32
      // rows of row group rg, a row a lane: the warp reads one group's
      // terms (broadcast loads, no divergence in its loops) and evaluates
      // them once for all of the group's columns
      const int g0 = __ldg(owners + c0);
      const int n_items = (__ldg(owners + c0 + cw - 1) - g0 + 1) * n_rg;
      for (int it = warp; it < n_items; it += WARPS) {
        const int g = g0 + it / n_rg;
        const int r = (it - (g - g0) * n_rg) * 32 + lane;
        if (r >= b_rows) continue;
        const int4 hd = __ldg(prog + 1 + 2 * g);  // (first column, columns, tests, hashed)
        uint32_t h = 0u;
        const bool ok = hd.z >= 0 && group_terms(tile_rows + (b0 + r) * arity,
                                                 prog + __ldg(prog + 2 + 2 * g).x, hd.z, hd.w, h);
        const int c1 = min(hd.x + hd.y, c0 + cw);
        for (int c = max(hd.x, c0); c < c1; ++c) {
          const int32_t d = ok ? static_cast<int32_t>(__ldg(bases + c) + h) : -1;
          const uint32_t key = in_range(d, lo, width);
          if (key != NONE) atomicAdd(cnt + key, 1u);
          batch[r * pitch + c - c0] = d;
        }
      }
      if (writes) {  // the batch's dest, row-major and coalesced
        __syncthreads();
        int r = threadIdx.x / cw, c = threadIdx.x % cw;
        const int step_r = THREADS / cw, step_c = THREADS % cw;
        while (r < b_rows) {
          tile_dest[(b0 + r) * wp + c0 + c] = batch[r * pitch + c];
          r += step_r;
          c += step_c;
          if (c >= cw) {
            c -= cw;
            ++r;
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  uint32_t* out = table + static_cast<int64_t>(tile) * k_pad + lo;
  for (int i = threadIdx.x; i < width; i += THREADS) out[i] = cnt[i];
}

// table [tiles, k_pad]: each entry becomes the count of its destination in
// all earlier tiles; counts[d] is the column's total.  A block takes SCAN_X
// destinations (coalesced) and splits the tiles into SCAN_Y segments.
__global__ void __launch_bounds__(SCAN_X * SCAN_Y)
ingest_scan_kernel(uint32_t* __restrict__ table, int tiles, int k_pad,
                   int32_t* __restrict__ counts) {
  __shared__ uint32_t part[SCAN_Y][SCAN_X + 1];
  const int d = blockIdx.x * SCAN_X + threadIdx.x;
  const int seg = (tiles + SCAN_Y - 1) / SCAN_Y;
  const int t0 = threadIdx.y * seg;
  const int t1 = min(tiles, t0 + seg);
  uint32_t sum = 0u;
  if (d < k_pad) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) sum += table[static_cast<int64_t>(t) * k_pad + d];
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0) {
    uint32_t run = 0u;
    for (int y = 0; y < SCAN_Y; ++y) {
      const uint32_t c = part[y][threadIdx.x];
      part[y][threadIdx.x] = run;
      run += c;
    }
    if (d < k_pad) counts[d] = static_cast<int32_t>(run);
  }
  __syncthreads();
  if (d < k_pad) {
    uint32_t run = part[threadIdx.y][threadIdx.x];
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      const int64_t i = static_cast<int64_t>(t) * k_pad + d;
      const uint32_t c = table[i];
      table[i] = run;
      run += c;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
ingest_rank_kernel(const int32_t* __restrict__ dest, int n, int wp, int k_pad,
                   int rows_per_tile, const uint32_t* __restrict__ table,
                   int32_t* __restrict__ rank) {
  extern __shared__ uint16_t wcnt[];  // [WARPS][pitch]: each warp's counters
  const int tile = blockIdx.x;
  const int lo = blockIdx.y * RANGE;
  const int width = min(RANGE, k_pad - lo);
  const int pitch = (width + 1) & ~1;
  const int r0 = tile * rows_per_tile;
  const int e_n = (min(n, r0 + rows_per_tile) - r0) * wp;
  const int64_t off = static_cast<int64_t>(r0) * wp;
  uint32_t* words = reinterpret_cast<uint32_t*>(wcnt);
  for (int i = threadIdx.x; i < WARPS * pitch / 2; i += THREADS) words[i] = 0u;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int seg = ((e_n + WARPS - 1) / WARPS + 31) & ~31;  // whole steps a warp
  const int s0 = warp * seg;
  const int s1 = min(e_n, s0 + seg);
  uint16_t* mine = wcnt + warp * pitch;
  uint32_t* mine_words = reinterpret_cast<uint32_t*>(mine);  // pitch is even

  // A: each warp counts its segment in its own counters, two to a word,
  // with shared-memory atomics: counting needs no order, and a half
  // never carries into the next (a segment has < 65536 emissions).
  for (int b = s0; b < s1; b += 32 * UNROLL) {
    int32_t d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = b + u * 32 + lane;
      d[u] = e < s1 ? dest[off + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t key = in_range(d[u], lo, width);
      if (key != NONE) atomicAdd(mine_words + (key >> 1), 1u << ((key & 1u) * 16));
    }
  }
  __syncthreads();

  // B: a warp's counter becomes the count of its destination in the
  // tile's earlier warps (a 16-bit value: a tile has <= MAX_TILE emissions)
  for (int j = threadIdx.x; j < width; j += THREADS) {
    uint32_t run = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t c = wcnt[w * pitch + j];
      wcnt[w * pitch + j] = static_cast<uint16_t>(run);
      run += c;
    }
  }
  __syncthreads();

  // C: the walk in flat order
  const uint32_t* base_row = table + static_cast<int64_t>(tile) * k_pad + lo;
  const bool writes_none = blockIdx.y == 0;  // range 0 writes the -1 ranks
  for (int b = s0; b < s1; b += 32 * UNROLL) {
    int32_t d[UNROLL];
    uint32_t base[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = b + u * 32 + lane;
      d[u] = e < s1 ? dest[off + e] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t key = in_range(d[u], lo, width);
      base[u] = key != NONE ? __ldg(base_row + key) : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = b + u * 32 + lane;
      const uint32_t key = in_range(d[u], lo, width);
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
      const int leader = __ffs(peers) - 1;
      uint32_t before = 0u;
      if (key != NONE && lane == leader) {
        before = mine[key];
        mine[key] = static_cast<uint16_t>(before + __popc(peers));
      }
      __syncwarp();
      before = __shfl_sync(0xFFFFFFFFu, before, leader);
      if (e < s1) {
        if (key != NONE) {
          rank[off + e] = static_cast<int32_t>(base[u] + before + __popc(peers & lower));
        } else if (writes_none && d[u] < 0) {
          rank[off + e] = -1;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Emissions per tile, the limit of the rank kernel's 16-bit counters, and
// words of rows per tile, the count kernel's staging: the Python wrapper
// sizes tiles with the kernel's own numbers.
int ingest_max_tile() { return MAX_TILE; }
int ingest_max_row_words() { return MAX_ROW_WORDS; }

// rows [n, arity] int32; prog: the route program of route_program (int32,
// 16-byte aligned), with every column index < arity and every destination
// < k_pad (the wrapper checks these).  dest, rank [n, wp] and counts [k_pad]
// int32, table [ceil(n / rows_per_tile), k_pad] uint32: written in full
// here.  Returns the first failing call's cudaError_t (0 = all launched).
int ingest_launch(const void* rows, int n, int arity, const void* prog, int wp, int k_pad,
                  int rows_per_tile, void* dest, void* rank, void* counts, void* table,
                  void* stream) {
  if (n < 1 || arity < 1 || wp < 1 || k_pad < 1 || rows_per_tile < 1 ||
      static_cast<int64_t>(rows_per_tile) * wp > MAX_TILE ||
      static_cast<int64_t>(rows_per_tile) * arity > MAX_ROW_WORDS ||
      static_cast<int64_t>(n) * wp >= (int64_t{1} << 31) ||
      (k_pad + RANGE - 1) / RANGE > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int ranges = (k_pad + RANGE - 1) / RANGE;
  const int width = k_pad < RANGE ? k_pad : RANGE;
  const int pitch = (wp < BATCH_COLS ? wp : BATCH_COLS) | 1;
  const size_t count_smem =
      sizeof(uint32_t) * (static_cast<size_t>(width) + static_cast<size_t>(BATCH_ROWS) * pitch +
                          static_cast<size_t>(rows_per_tile < n ? rows_per_tile : n) * arity);
  const size_t rank_smem = sizeof(uint16_t) * WARPS * static_cast<size_t>((width + 1) & ~1);
  if (count_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ingest_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(count_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rank_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ingest_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(rank_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int32_t* d = static_cast<int32_t*>(dest);
  uint32_t* t = static_cast<uint32_t*>(table);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(ranges));
  ingest_count_kernel<<<grid, THREADS, count_smem, st>>>(
      static_cast<const int32_t*>(rows), n, arity, static_cast<const int4*>(prog), wp, k_pad,
      rows_per_tile, d, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ingest_scan_kernel<<<(k_pad + SCAN_X - 1) / SCAN_X, dim3(SCAN_X, SCAN_Y), 0, st>>>(
      t, tiles, k_pad, static_cast<int32_t*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ingest_rank_kernel<<<grid, THREADS, rank_smem, st>>>(d, n, wp, k_pad, rows_per_tile, t,
                                                       static_cast<int32_t*>(rank));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
