// Reduce-phase block equi-join for Hopper (sm_90a): per reducer, the number
// of (r, s) pairs equal on all C key columns with both weights > 0, and the
// checksum sum(w_r * w_s) over those pairs, mod 2^32.
//
// Replaces the Pallas TPU kernels block_join_pallas / _block_join_kernel and
// tiled_join_pallas / _tiled_join_kernel (repro/kernels/block_join.py).  The
// flat join is the K = 1 launch of the same kernel.
//
// What bounds it on this card: integer operations.  A pair of valid slots
// costs C compares and two adds (count, weight); validity is tested once per
// row, not per pair.  That is sum_k n_r(k) * n_s(k) * (C + 2) int32
// operations (K * cap_r * cap_s * (C + 2) when every slot is valid) against
// the int32 pipe, while the bytes are read once,
// K * (cap_r + cap_s) * (C + 1) * 4.  The design follows from that:
//   * grid (K * ceil(cap_r / TILE_R), 1, ceil(cap_s / S_CHUNK)); a block
//     keeps RPT R rows per thread in registers and streams its S rows
//     through shared memory in tiles, so each key is read from device
//     memory once per block;
//   * binned reducers are mostly padding (weight 0 marks an invalid slot),
//     so a block with no valid R row exits, an S tile with no valid row is
//     skipped, and an invalid S row is skipped: the work follows the valid
//     pairs, not cap_r * cap_s;
//   * the checksum factors per R row: sum_s eq * w_r * w_s =
//     w_r * sum_s eq * w_s (mod 2^32), one add per pair instead of a
//     multiply-add;
//   * all arithmetic is uint32_t, whose wraparound is defined and is the
//     reference semantics (signed overflow would be undefined behaviour);
//   * a warp-shuffle and shared-memory reduction, then one atomicAdd per
//     block into cnt[k] and chk[k].  Unsigned adds commute mod 2^32, so the
//     result does not depend on the order of the atomics.
// Tensor-core (wgmma) compare tricks and TMA staging are left for later.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RPT = 4;                  // R rows per thread, in registers
constexpr int TILE_R = THREADS * RPT;   // R rows per block
constexpr int TILE_S = 256;             // S rows per shared-memory tile
constexpr int S_CHUNK = 2048;           // S rows per block (grid z)
// Widest link instantiated.  The repo's binary queries join on one column,
// but a two-relation query from make_query may share several; the eight
// instantiations cost a few seconds of nvcc.
constexpr int MAX_C = 8;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
block_join_kernel(const int32_t* __restrict__ rk, const int32_t* __restrict__ rw,
                  const int32_t* __restrict__ sk, const int32_t* __restrict__ sw,
                  uint32_t* __restrict__ cnt, uint32_t* __restrict__ chk,
                  int cap_r, int cap_s, int r_tiles) {
  __shared__ int32_t s_key[TILE_S * C];
  __shared__ uint32_t s_w[TILE_S];
  __shared__ uint32_t red[2][THREADS / 32];

  const int k = blockIdx.x / r_tiles;
  const int r0 = (blockIdx.x % r_tiles) * TILE_R;
  const int64_t r_base = static_cast<int64_t>(k) * cap_r;
  const int64_t s_base = static_cast<int64_t>(k) * cap_s;

  int32_t key[RPT][C];
  uint32_t w[RPT];  // 0 = invalid slot (weight <= 0)
  bool any_r = false;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i * THREADS + threadIdx.x;
    w[i] = 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) key[i][c] = 0;
    if (r < cap_r) {
      const int32_t wi = rw[r_base + r];
      w[i] = wi > 0 ? static_cast<uint32_t>(wi) : 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) key[i][c] = rk[(r_base + r) * C + c];
    }
    any_r |= w[i] != 0u;
  }
  if (!__syncthreads_or(any_r)) return;  // the whole block exits together

  uint32_t n_eq[RPT], w_eq[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) n_eq[i] = w_eq[i] = 0u;

  const int s_begin = blockIdx.z * S_CHUNK;
  const int s_end = min(cap_s, s_begin + S_CHUNK);
  for (int t0 = s_begin; t0 < s_end; t0 += TILE_S) {
    const int n = min(TILE_S, s_end - t0);
    bool any_s = false;
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const int32_t wj = sw[s_base + t0 + j];
      const uint32_t v = wj > 0 ? static_cast<uint32_t>(wj) : 0u;
      s_w[j] = v;
      any_s |= v != 0u;
    }
    const int32_t* src = sk + (s_base + t0) * C;
    for (int j = threadIdx.x; j < n * C; j += THREADS) s_key[j] = src[j];
    if (__syncthreads_or(any_s)) {  // also the barrier after the tile load
      for (int j = 0; j < n; ++j) {
        const uint32_t v = s_w[j];
        if (v == 0u) continue;  // same j for every thread: no divergence
        int32_t s[C];
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = s_key[j * C + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          bool eq = true;
#pragma unroll
          for (int c = 0; c < C; ++c) eq &= key[i][c] == s[c];
          n_eq[i] += eq ? 1u : 0u;
          w_eq[i] += eq ? v : 0u;
        }
      }
    }
    __syncthreads();  // the tile is read before the next one overwrites it
  }

  uint32_t t_cnt = 0u, t_chk = 0u;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    t_cnt += w[i] != 0u ? n_eq[i] : 0u;
    t_chk += w[i] * w_eq[i];
  }
  t_cnt = warp_sum(t_cnt);
  t_chk = warp_sum(t_chk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = t_cnt;
    red[1][warp] = t_chk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t b_cnt = 0u, b_chk = 0u;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      b_cnt += red[0][i];
      b_chk += red[1][i];
    }
    if (b_cnt != 0u) {
      atomicAdd(cnt + k, b_cnt);
      atomicAdd(chk + k, b_chk);
    }
  }
}

template <int C>
cudaError_t launch(const void* rk, const void* rw, const void* sk, const void* sw,
                   void* cnt, void* chk, int k, int cap_r, int cap_s,
                   cudaStream_t stream) {
  const int r_tiles = (cap_r + TILE_R - 1) / TILE_R;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(k) * r_tiles), 1,
                  static_cast<unsigned>((cap_s + S_CHUNK - 1) / S_CHUNK));
  block_join_kernel<C><<<grid, THREADS, 0, stream>>>(
      static_cast<const int32_t*>(rk), static_cast<const int32_t*>(rw),
      static_cast<const int32_t*>(sk), static_cast<const int32_t*>(sw),
      static_cast<uint32_t*>(cnt), static_cast<uint32_t*>(chk), cap_r, cap_s,
      r_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Layout constants, so the Python wrapper checks grid limits with the
// kernel's own numbers.
int block_join_tile_r() { return TILE_R; }
int block_join_s_chunk() { return S_CHUNK; }
int block_join_max_c() { return MAX_C; }

// r_keys [K, cap_r, C], r_weights [K, cap_r], s_keys [K, cap_s, C],
// s_weights [K, cap_s]: contiguous int32.  cnt, chk [K]: int32 storage,
// zeroed by the caller, accumulated as uint32.  Returns the launch's
// cudaError_t (0 = launched).
int block_join_launch(const void* rk, const void* rw, const void* sk,
                      const void* sw, void* cnt, void* chk, int k, int cap_r,
                      int cap_s, int c, void* stream) {
  if (k <= 0 || cap_r <= 0 || cap_s <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 2: return launch<2>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 3: return launch<3>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 4: return launch<4>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 5: return launch<5>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 6: return launch<6>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 7: return launch<7>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    case 8: return launch<8>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
