// Reduce-phase block equi-join for Hopper (sm_90a): per reducer, the number
// of (r, s) pairs equal on all C key columns with both weights > 0, and the
// checksum sum(w_r * w_s) over those pairs, mod 2^32.
//
// Replaces the Pallas TPU kernels block_join_pallas / _block_join_kernel and
// tiled_join_pallas / _tiled_join_kernel (repro/kernels/block_join.py).  The
// flat join is the K = 1 launch of the same kernel.
//
// The TPU kernels compare every R row with every S row.  The function needs
// far less: grouped by key value v, count = sum_v n_R(v) * n_S(v) and
// checksum = sum_v (sum of w_r with key v) * (sum of w_s with key v), both
// identities of the ring of integers mod 2^32, so an aggregate-by-key join
// gives the same bits with O(n_R + n_S) work a reducer.  What bounds it on
// this card is then the bytes, every weight and the keys of the valid rows
// read once: binned reducers are mostly padding (weight 0 marks an invalid
// slot).  The design:
//   * grid K * ceil(cap_r / chunk): a block is one (reducer, R chunk) pair;
//     chunk (rows) and slots (hash-table size, a power of two above chunk)
//     come from the Python wrapper's chunk_geometry, so shared memory holds
//     any cap_r and any C: wider keys give smaller chunks;
//   * build: the block stages its chunk's valid rows, compacted, weights
//     and keys, in shared memory, then inserts each of them into an
//     open-addressing table (linear probing) keyed by the row's index: a
//     slot is claimed by atomicCAS of the index, and a key is compared with
//     the staged key of the row that claimed it, so no thread reads a key
//     that is still being written.  A slot holds the rows' count and the
//     sum of their weights.  Rows of one warp that share a key meet first
//     (__match_any_sync on the key's hash, checked column by column against
//     the group's leader; __reduce_add_sync sums the group's weights) and
//     the leader inserts the group, so a heavy hitter's rows cost one
//     insert a warp, not one a row;
//   * probe: the block streams all of its reducer's S rows and probes once
//     per valid S row: a hit adds the slot's count and its weight sum times
//     w_s;
//   * a warp-shuffle and shared-memory reduction, then one atomicAdd per
//     block into cnt[k] and chk[k].  Unsigned adds commute mod 2^32, so the
//     result does not depend on the order of the atomics; all arithmetic is
//     uint32_t, whose wraparound is the reference semantics.
// C = 1, the repo's binary joins, is instantiated on its own (keys in
// registers); every other C takes the same code with C a run-time value.
// The C = 1 copy pays for itself: run-time-C code that also loads the
// first key column ahead of use took about 10 % longer on the batch
// join's operands on an H100 (PERF.md).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 12;  // rows a thread has in flight at once: 3,072 a block
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// A hash of a key tuple; for C = 1 a bijection of the key, so rows of one
// hash are rows of one key.
__device__ __forceinline__ uint32_t key_hash(const int32_t* key, int c) {
  uint32_t h = 0x9E3779B9u;
  for (int j = 0; j < c; ++j) h = fmix32(h ^ static_cast<uint32_t>(key[j]));
  return h;
}

__device__ __forceinline__ bool same_key(const int32_t* a, const int32_t* b, int c) {
  for (int j = 0; j < c; ++j) {
    if (a[j] != b[j]) return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int CS>
__global__ void __launch_bounds__(THREADS)
hash_join_kernel(const int32_t* __restrict__ rk, const int32_t* __restrict__ rw,
                 const int32_t* __restrict__ sk, const int32_t* __restrict__ sw,
                 uint32_t* __restrict__ cnt, uint32_t* __restrict__ chk, int cap_r,
                 int cap_s, int c_rt, int chunk, int slots, int chunks) {
  const int C = CS > 0 ? CS : c_rt;
  extern __shared__ uint32_t smem[];
  uint32_t* t_row = smem;              // [slots] the row that claimed the slot
  uint32_t* t_cnt = t_row + slots;     // [slots] rows with the slot's key
  uint32_t* t_sum = t_cnt + slots;     // [slots] their weight sum
  uint32_t* r_w = t_sum + slots;       // [chunk] the valid rows' weights, compacted
  int32_t* r_key = reinterpret_cast<int32_t*>(r_w + chunk);  // [chunk, C] their keys
  __shared__ uint32_t red[2][THREADS / 32];

  const int k = blockIdx.x / chunks;
  const int r0 = (blockIdx.x % chunks) * chunk;
  const int n_r = min(chunk, cap_r - r0);
  const int64_t r_base = static_cast<int64_t>(k) * cap_r + r0;
  const int64_t s_base = static_cast<int64_t>(k) * cap_s;
  const uint32_t mask = static_cast<uint32_t>(slots - 1);

  // S rows a group of UNROLL a thread: weights, then (C = 1) the keys of
  // the valid ones.  The first group's loads are issued before the chunk
  // is staged and its keys before the build, so they are in flight
  // meanwhile.
  int32_t s_w[UNROLL], s_k[UNROLL];
  auto load_s_weights = [&](int j0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * THREADS;
      s_w[u] = j < cap_s ? __ldg(sw + s_base + j) : 0;
    }
  };
  auto load_s_keys = [&](int j0) {
    if constexpr (CS == 1) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s_k[u] = s_w[u] > 0 ? __ldg(sk + s_base + j0 + u * THREADS) : 0;
      }
    }
  };
  load_s_weights(threadIdx.x);

  // stage the chunk's valid rows, compacted (their order does not matter
  // to an aggregate): weights and keys
  __shared__ int n_valid;
  for (int i = threadIdx.x; i < slots; i += THREADS) {
    t_row[i] = EMPTY;
    t_cnt[i] = 0u;
    t_sum[i] = 0u;
  }
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  // b is the same for every thread, so whole warps vote in each iteration
  for (int b = 0; b < n_r; b += THREADS * UNROLL) {
    int32_t w[UNROLL], key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = b + u * THREADS + threadIdx.x;
      w[u] = i < n_r ? __ldg(rw + r_base + i) : 0;
    }
    if constexpr (CS == 1) {  // every key load issued before the first store
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        key[u] = w[u] > 0 ? __ldg(rk + r_base + b + u * THREADS + threadIdx.x) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned vote = __ballot_sync(0xFFFFFFFFu, w[u] > 0);
      int at = 0;
      if (lane == 0 && vote != 0u) at = atomicAdd(&n_valid, __popc(vote));
      at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(vote & lower);
      if (w[u] > 0) {
        r_w[at] = static_cast<uint32_t>(w[u]);
        if constexpr (CS == 1) {
          r_key[at] = key[u];
        } else {
          const int64_t i = r_base + b + u * THREADS + threadIdx.x;
          for (int j = 0; j < C; ++j) r_key[at * C + j] = __ldg(rk + i * C + j);
        }
      }
    }
  }
  __syncthreads();
  const int n_v = n_valid;
  if (n_v == 0) return;  // the whole block exits together
  load_s_keys(threadIdx.x);

  // build.  base is the same for every lane, so whole warps enter each
  // iteration and __match_any_sync sees all 32 lanes.
  for (int base = 0; base < n_v; base += THREADS) {
    const int i = base + threadIdx.x;
    const uint32_t w = i < n_v ? r_w[i] : 0u;
    const int32_t* key = r_key + static_cast<int64_t>(i) * C;
    const uint32_t h = w != 0u ? key_hash(key, C) : 0u;
    const unsigned peers =
        __match_any_sync(0xFFFFFFFFu, w != 0u ? (uint64_t{1} << 32) | h : uint64_t{0});
    const int leader = __ffs(peers) - 1;
    // the group agrees with its leader column by column (a hash collision
    // of two keys leaves a lane out; it inserts alone)
    bool eq = true;
    for (int j = 0; j < C; ++j) {
      const int32_t mine = w != 0u ? key[j] : 0;
      eq &= __shfl_sync(0xFFFFFFFFu, mine, leader) == mine;
    }
    // agg, the lanes that agree with the leader, has the same value in
    // each of them: each lane sums over its own part
    const unsigned agg = __ballot_sync(0xFFFFFFFFu, eq) & peers;
    const uint32_t g_sum = __reduce_add_sync(eq ? agg : 1u << lane, w);
    if (w == 0u || (lane != leader && eq)) continue;
    const uint32_t n_add = eq ? static_cast<uint32_t>(__popc(agg)) : 1u;
    for (uint32_t s = h & mask;; s = (s + 1u) & mask) {
      uint32_t owner = t_row[s];
      if (owner == EMPTY) owner = atomicCAS(t_row + s, EMPTY, static_cast<uint32_t>(i));
      if (owner == EMPTY || same_key(r_key + static_cast<int64_t>(owner) * C, key, C)) {
        atomicAdd(t_cnt + s, n_add);
        atomicAdd(t_sum + s, g_sum);
        break;
      }
    }
  }
  __syncthreads();

  // probe with every valid S row of the reducer
  uint32_t b_cnt = 0u, b_chk = 0u;
  // a hit adds the slot's count and its weight sum times w_s
  auto probe = [&](uint32_t h, const auto& matches, uint32_t w_s) {
    for (uint32_t s = h & mask;; s = (s + 1u) & mask) {
      const uint32_t owner = t_row[s];
      if (owner == EMPTY) return;
      if (matches(r_key + static_cast<int64_t>(owner) * C)) {
        b_cnt += t_cnt[s];
        b_chk += t_sum[s] * w_s;
        return;
      }
    }
  };
  for (int j0 = threadIdx.x; j0 < cap_s; j0 += THREADS * UNROLL) {
    if (j0 != threadIdx.x) {
      load_s_weights(j0);
      load_s_keys(j0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (s_w[u] <= 0) continue;
      const uint32_t w_s = static_cast<uint32_t>(s_w[u]);
      if constexpr (CS == 1) {
        const int32_t kv = s_k[u];
        probe(key_hash(&kv, 1), [&](const int32_t* rkey) { return *rkey == kv; }, w_s);
      } else {
        const int32_t* key = sk + (s_base + j0 + u * THREADS) * C;
        probe(key_hash(key, C), [&](const int32_t* rkey) { return same_key(rkey, key, C); },
              w_s);
      }
    }
  }

  b_cnt = warp_sum(b_cnt);
  b_chk = warp_sum(b_chk);
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = b_cnt;
    red[1][warp] = b_chk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t a_cnt = 0u, a_chk = 0u;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      a_cnt += red[0][i];
      a_chk += red[1][i];
    }
    if (a_cnt != 0u) {
      atomicAdd(cnt + k, a_cnt);
      atomicAdd(chk + k, a_chk);
    }
  }
}

template <int CS>
cudaError_t launch(const void* rk, const void* rw, const void* sk, const void* sw, void* cnt,
                   void* chk, int k, int cap_r, int cap_s, int c, int chunk, int slots,
                   cudaStream_t stream) {
  const int chunks = (cap_r + chunk - 1) / chunk;
  const size_t smem = sizeof(uint32_t) * (3 * static_cast<size_t>(slots) +
                                          static_cast<size_t>(chunk) * (c + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hash_join_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  hash_join_kernel<CS><<<static_cast<unsigned>(static_cast<int64_t>(k) * chunks), THREADS,
                         smem, stream>>>(
      static_cast<const int32_t*>(rk), static_cast<const int32_t*>(rw),
      static_cast<const int32_t*>(sk), static_cast<const int32_t*>(sw),
      static_cast<uint32_t*>(cnt), static_cast<uint32_t*>(chk), cap_r, cap_s, c, chunk,
      slots, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r_keys [K, cap_r, C], r_weights [K, cap_r], s_keys [K, cap_s, C],
// s_weights [K, cap_s]: contiguous int32.  cnt, chk [K]: int32 storage,
// zeroed by the caller, accumulated as uint32.  chunk (R rows a block) and
// slots (a power of two > chunk) as chunk_geometry gives them.  Returns the
// launch's cudaError_t (0 = launched).
int block_join_launch(const void* rk, const void* rw, const void* sk, const void* sw,
                      void* cnt, void* chk, int k, int cap_r, int cap_s, int c, int chunk,
                      int slots, void* stream) {
  if (k <= 0 || cap_r <= 0 || cap_s <= 0) return 0;
  if (c < 1 || chunk < 1 || slots <= chunk || (slots & (slots - 1)) != 0 ||
      static_cast<int64_t>(k) * ((cap_r + chunk - 1) / chunk) >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 1) return launch<1>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, c, chunk, slots, st);
  return launch<0>(rk, rw, sk, sw, cnt, chk, k, cap_r, cap_s, c, chunk, slots, st);
}

}  // extern "C"
