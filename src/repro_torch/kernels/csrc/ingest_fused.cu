// Fused streaming-ingest pass for Hopper (sm_90a): for a row block
// [N, arity] and a route table given as data (the dense encoding of
// repro_torch.kernels.ingest_fused.dense_route_encoding, Wp columns),
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
// static-table variant is the same kernel: its wrapper encodes the table
// with dense_route_encoding (Wp = W, V = the longest exclude list) and
// counts num_reducers destinations.  Wp and k_pad are any sizes the
// caller needs (the TPU kernels' power-of-two Wp and k_pad % 128 == 0
// are padding for their compiler, not needed here).
//
// The TPU kernels rank by a dense order comparison inside each block of B
// rows ((B * W)^2 compares) and count by one-hot against every reducer.
// Neither is needed here.  The rank is a counting sort's, in three kernels:
//   1. tile_kernel: one block per tile of rows_per_tile rows (at most
//      MAX_TILE emissions).  All threads compute the tile's destinations
//      (the hash, pin and exclude terms; the bound of the pass).  Then warp
//      0 walks the tile in flat order, 32 emissions a step: lanes with the
//      same destination find each other (__match_any_sync), the lowest adds
//      the group's size to that destination's 16-bit counter in shared
//      memory, and each lane's in-tile rank is the counter before the add
//      plus the number of its peers in lower lanes.  The order is fixed, so
//      the rank is the stable one, whatever the scheduling.  Last the block
//      writes its per-destination counts, a row of table [tiles, k_pad].
//   2. scan_kernel: down each destination's column of the table, the
//      exclusive prefix over tiles, and counts[d] = the column total.
//   3. fix_kernel: rank += table[tile of the row][dest].
// What bounds the pass: integer operations for the hashes (a mix32 and an
// unsigned modulo per hashed term of each emission) and the bytes of dest
// and rank, 8 * N * Wp, written once; the serial walk of step 1 is the
// latency this first version leaves to a later one.  All arithmetic on ids
// is uint32, whose wraparound is the reference's int32 semantics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;                // steps of warp 0 whose loads are in flight together
constexpr int MAX_TILE = 65535;          // emissions per tile: 16-bit counters
constexpr int MAX_K_PAD = 112 * 1024;    // 2 bytes each in shared memory: 224 KB
constexpr int SCAN_X = 32;               // destinations per scan block
constexpr int SCAN_Y = 32;               // tile segments per scan block
constexpr int FIX_THREADS = 256;

struct Enc {
  const int32_t* col_base;
  const int32_t* col_valid;
  const int32_t* h_col;
  const int32_t* h_seed;
  const int32_t* h_dim;
  const int32_t* h_stride;
  const int32_t* p_col;
  const int32_t* p_val;
  const int32_t* p_on;
  const int32_t* e_col;
  const int32_t* e_val;
  const int32_t* e_on;
  int h, p, v;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x ^= seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// _dest_block_dense for one (row, column): the encoding's column w applied
// to one row, term for term.
__device__ __forceinline__ int32_t dest_of(const int32_t* __restrict__ row, int w,
                                           const Enc& e) {
  if (__ldg(e.col_valid + w) == 0) return -1;
  for (int j = 0; j < e.p; ++j) {
    const int k = w * e.p + j;
    if (__ldg(e.p_on + k) != 0 && row[__ldg(e.p_col + k)] != __ldg(e.p_val + k)) return -1;
  }
  for (int j = 0; j < e.p; ++j) {
    const int k = w * e.p + j;
    const int32_t x = row[__ldg(e.e_col + k)];
    for (int t = 0; t < e.v; ++t) {
      const int kv = k * e.v + t;
      if (__ldg(e.e_on + kv) != 0 && x == __ldg(e.e_val + kv)) return -1;
    }
  }
  uint32_t base = static_cast<uint32_t>(__ldg(e.col_base + w));
  for (int j = 0; j < e.h; ++j) {
    const int k = w * e.h + j;
    const uint32_t stride = static_cast<uint32_t>(__ldg(e.h_stride + k));
    if (stride == 0u) continue;  // a padded slot adds (x % 1) * 0 = 0
    const uint32_t x = static_cast<uint32_t>(row[__ldg(e.h_col + k)]);
    const uint32_t seed = static_cast<uint32_t>(__ldg(e.h_seed + k));
    base += (mix32(x, seed) % static_cast<uint32_t>(__ldg(e.h_dim + k))) * stride;
  }
  return static_cast<int32_t>(base);
}

__global__ void __launch_bounds__(THREADS)
tile_kernel(const int32_t* __restrict__ rows, int n, int arity, Enc enc, int wp,
            int k_pad, int rows_per_tile, int32_t* dest, int32_t* rank,
            uint32_t* __restrict__ table) {
  extern __shared__ uint32_t cnt[];  // k_pad 16-bit counters, two per word
  const int tile = blockIdx.x;
  const int r0 = tile * rows_per_tile;
  const int r1 = min(n, r0 + rows_per_tile);
  const int e_n = (r1 - r0) * wp;  // this tile's emissions, <= MAX_TILE
  const int64_t off = static_cast<int64_t>(r0) * wp;
  for (int i = threadIdx.x; i < (k_pad + 1) / 2; i += THREADS) cnt[i] = 0u;
  for (int e = threadIdx.x; e < e_n; e += THREADS) {
    const int r = r0 + e / wp;
    dest[off + e] = dest_of(rows + static_cast<int64_t>(r) * arity, e % wp, enc);
  }
  __syncthreads();  // the tile's dest and the zeroed counters, block-wide

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned lower = (1u << lane) - 1u;
    for (int base = 0; base < e_n; base += 32 * UNROLL) {
      int32_t d[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * 32 + lane;
        d[u] = e < e_n ? dest[off + e] : -1;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * 32 + lane;
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, d[u]);
        const int leader = __ffs(peers) - 1;
        uint32_t before = 0u;
        if (d[u] >= 0 && lane == leader) {
          // two leaders may share a word (d, d ^ 1): the add is atomic; a
          // half never carries, since a tile has <= 65535 emissions
          const int shift = (d[u] & 1) * 16;
          const uint32_t add = static_cast<uint32_t>(__popc(peers)) << shift;
          before = (atomicAdd(cnt + (d[u] >> 1), add) >> shift) & 0xFFFFu;
        }
        before = __shfl_sync(0xFFFFFFFFu, before, leader);
        if (e < e_n) {
          rank[off + e] =
              d[u] >= 0 ? static_cast<int32_t>(before + __popc(peers & lower)) : -1;
        }
      }
    }
  }
  __syncthreads();

  uint32_t* row_out = table + static_cast<int64_t>(tile) * k_pad;
  for (int i = threadIdx.x; i < k_pad; i += THREADS) {
    row_out[i] = (cnt[i >> 1] >> ((i & 1) * 16)) & 0xFFFFu;
  }
}

// table [tiles, k_pad]: each entry becomes the count of its destination in
// all earlier tiles; counts[d] is the column's total.  A block takes SCAN_X
// destinations (coalesced) and splits the tiles into SCAN_Y segments.
__global__ void __launch_bounds__(SCAN_X * SCAN_Y)
scan_kernel(uint32_t* __restrict__ table, int tiles, int k_pad,
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

__global__ void __launch_bounds__(FIX_THREADS)
fix_kernel(const int32_t* __restrict__ dest, int32_t* __restrict__ rank,
           const uint32_t* __restrict__ table, int64_t total, int wp, int k_pad,
           int rows_per_tile) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * FIX_THREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * FIX_THREADS + threadIdx.x;
       e < total; e += step) {
    const int32_t d = dest[e];
    if (d >= 0) {
      const int64_t tile = e / wp / rows_per_tile;
      rank[e] += static_cast<int32_t>(table[tile * k_pad + d]);
    }
  }
}

}  // namespace

extern "C" {

// Layout limits, so the Python wrapper checks them with the kernel's own
// numbers.
int ingest_max_k_pad() { return MAX_K_PAD; }
int ingest_max_tile() { return MAX_TILE; }

// rows [n, arity] int32; enc: the twelve encoding arrays, flattened and
// concatenated in _ENC_KEYS order (col_base [wp], col_valid [wp], h_col,
// h_seed, h_dim, h_stride [wp, h], p_col, p_val, p_on, e_col [wp, p], e_val,
// e_on [wp, p, v]), with every column index < arity, every h_dim >= 1 and
// every destination < k_pad (the wrapper checks these).  dest, rank [n, wp]
// and counts [k_pad] int32, table [ceil(n / rows_per_tile), k_pad] uint32:
// written in full here.  Returns the first launch's cudaError_t (0 = all
// launched).
int ingest_launch(const void* rows, int n, int arity, const void* enc, int wp,
                  int h, int p, int v, int k_pad, int rows_per_tile, void* dest,
                  void* rank, void* counts, void* table, void* stream) {
  if (n < 1 || arity < 1 || wp < 1 || h < 1 || p < 1 || v < 1 || k_pad < 1 ||
      k_pad > MAX_K_PAD || rows_per_tile < 1 ||
      static_cast<int64_t>(rows_per_tile) * wp > MAX_TILE ||
      static_cast<int64_t>(n) * wp >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* q = static_cast<const int32_t*>(enc);
  Enc e;
  e.col_base = q;  q += wp;
  e.col_valid = q; q += wp;
  e.h_col = q;     q += wp * h;
  e.h_seed = q;    q += wp * h;
  e.h_dim = q;     q += wp * h;
  e.h_stride = q;  q += wp * h;
  e.p_col = q;     q += wp * p;
  e.p_val = q;     q += wp * p;
  e.p_on = q;      q += wp * p;
  e.e_col = q;     q += wp * p;
  e.e_val = q;     q += wp * p * v;
  e.e_on = q;
  e.h = h;
  e.p = p;
  e.v = v;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const size_t smem = static_cast<size_t>((k_pad + 1) / 2) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int32_t* d = static_cast<int32_t*>(dest);
  int32_t* r = static_cast<int32_t*>(rank);
  uint32_t* t = static_cast<uint32_t*>(table);
  tile_kernel<<<tiles, THREADS, smem, st>>>(static_cast<const int32_t*>(rows), n, arity,
                                            e, wp, k_pad, rows_per_tile, d, r, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<(k_pad + SCAN_X - 1) / SCAN_X, dim3(SCAN_X, SCAN_Y), 0, st>>>(
      t, tiles, k_pad, static_cast<int32_t*>(counts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(n) * wp;
  const int64_t want = (total + FIX_THREADS - 1) / FIX_THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  fix_kernel<<<blocks, FIX_THREADS, 0, st>>>(d, r, t, total, wp, k_pad, rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
