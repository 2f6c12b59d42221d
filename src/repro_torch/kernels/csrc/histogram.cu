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
// scatter-add serialises there: N * num_bins compares.  Here every value is
// read once and counted with atomic adds.  What bounds it on this card is
// the atomics: a value whose bin is sparse costs one, and a heavy value
// would cost one a warp at a single address, where they serialise.  The
// design follows the density of the input, not the TPU's dense one-hot:
//   * every kernel reads each value once, UNROLL of them a thread before it
//     counts any, and a warp folds equal values first (__match_any_sync):
//     one lane adds the group's size;
//   * narrow ranges (num_bins <= SMEM_BINS, 48 KB): each CTA counts its
//     values into a private histogram in shared memory (four CTAs an SM)
//     and adds its non-zero bins to out;
//   * wide ranges (the §9.1 join column: 10^6 values over 100,000 bins,
//     about ten a bin, so a CTA's histogram of the whole range would be
//     almost all zeros): the sparse mass goes straight to out with device
//     atomics (out, 400 KB there, stays in the 50 MB L2), and the values
//     that repeat inside a CTA are folded in a small table of SLOTS tagged
//     slots in shared memory: a value a warp saw more than once claims its
//     slot if the slot is free, and later occurrences of a value that holds
//     a slot are added there.  A heavy value (10 % of the §9.1 column)
//     therefore costs about one device atomic a CTA, not one a warp.  A
//     cluster whose distributed shared memory holds the whole range (2 CTAs
//     of 200 KB for 100,000 bins, merged once a cluster) was measured
//     against it and was slower: at this density it issues about as many
//     device atomics and each CTA also zeroes and scans its 50,000 bins
//     (PERF.md, PR 19).
// Integer adds commute, so out does not depend on the order of the atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr int SMEM_BINS = 12288;        // the narrow kernel's histogram: 48 KB
constexpr int SLOTS = 2048;             // the sparse kernel's tagged slots: 16 KB
constexpr int SLOT_BITS = 11;
constexpr int CTAS_PER_SM = 4;
constexpr long long VALUES_PER_CTA = static_cast<long long>(THREADS) * UNROLL;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;  // no value: values counted are < 2^31
constexpr unsigned FULL = 0xFFFFFFFFu;

// The values of this CTA's chunk, UNROLL a thread loaded before any is
// counted; count(v, c) takes each distinct in-range value of a warp once,
// with its count, on the first lane that holds it.  Whole warps run every
// iteration (base is warp uniform), so the match sees all 32 lanes.
template <typename Count>
__device__ __forceinline__ void for_each_folded(const int32_t* __restrict__ values, long long n,
                                                uint32_t num_bins, long long per_cta,
                                                Count count) {
  const long long begin = static_cast<long long>(blockIdx.x) * per_cta;
  const long long end = min(begin + per_cta, n);
  const int lane = threadIdx.x & 31;
  for (long long base = begin + (threadIdx.x & ~31); base < end;
       base += static_cast<long long>(THREADS) * UNROLL) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + static_cast<long long>(j) * THREADS + lane;
      // a negative value reads as >= 2^31 > num_bins: dropped with the rest
      v[j] = i < end ? static_cast<uint32_t>(__ldg(values + i)) : EMPTY;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const bool ok = v[j] < num_bins;
      const unsigned peers = __match_any_sync(FULL, v[j]);
      if (ok && lane == __ffs(peers) - 1) count(v[j], static_cast<uint32_t>(__popc(peers)));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
histogram_narrow_kernel(const int32_t* __restrict__ values, long long n, uint32_t num_bins,
                        long long per_cta, uint32_t* __restrict__ out) {
  __shared__ uint32_t hist[SMEM_BINS];
  for (uint32_t b = threadIdx.x; b < num_bins; b += THREADS) hist[b] = 0u;
  __syncthreads();
  for_each_folded(values, n, num_bins, per_cta,
                  [&](uint32_t v, uint32_t c) { atomicAdd(hist + v, c); });
  __syncthreads();
  for (uint32_t b = threadIdx.x; b < num_bins; b += THREADS) {
    if (hist[b] != 0u) atomicAdd(out + b, hist[b]);
  }
}

__global__ void __launch_bounds__(THREADS)
histogram_sparse_kernel(const int32_t* __restrict__ values, long long n, uint32_t num_bins,
                        long long per_cta, uint32_t* __restrict__ out) {
  __shared__ uint32_t tag[SLOTS];
  __shared__ uint32_t cnt[SLOTS];
  for (int s = threadIdx.x; s < SLOTS; s += THREADS) {
    tag[s] = EMPTY;
    cnt[s] = 0u;
  }
  __syncthreads();
  for_each_folded(values, n, num_bins, per_cta, [&](uint32_t v, uint32_t c) {
    const uint32_t s = (v * 2654435761u) >> (32 - SLOT_BITS);
    // a slot's tag changes once, from EMPTY: a tag read equal to v stays v
    uint32_t t = tag[s];
    if (t == EMPTY && c > 1u) {  // a repeat inside the warp: claim the slot if it is free
      const uint32_t prev = atomicCAS(tag + s, EMPTY, v);
      t = prev == EMPTY ? v : prev;
    }
    if (t == v) {
      atomicAdd(cnt + s, c);
    } else {
      atomicAdd(out + v, c);
    }
  });
  __syncthreads();
  for (int s = threadIdx.x; s < SLOTS; s += THREADS) {
    if (tag[s] != EMPTY && cnt[s] != 0u) atomicAdd(out + tag[s], cnt[s]);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

extern "C" {

int histogram_smem_bins() { return SMEM_BINS; }

// values: [n] int32 on the card; out: [num_bins] int32 storage, zeroed by
// the caller, counted as uint32: the narrow kernel for num_bins <=
// SMEM_BINS, the sparse one above.  Returns the launch's cudaError_t (0 =
// launched; a refused launch is not 0).
int histogram_launch(const void* values, long long n, int num_bins, void* out, void* stream) {
  if (n < 0 || num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int32_t* v = static_cast<const int32_t*>(values);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t bins = static_cast<uint32_t>(num_bins);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long ctas = (n + VALUES_PER_CTA - 1) / VALUES_PER_CTA;
  if (ctas > static_cast<long long>(CTAS_PER_SM) * sms) ctas = static_cast<long long>(CTAS_PER_SM) * sms;
  const long long per_cta = (n + ctas - 1) / ctas;
  if (num_bins <= SMEM_BINS) {
    histogram_narrow_kernel<<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(v, n, bins, per_cta,
                                                                            o);
  } else {
    histogram_sparse_kernel<<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(v, n, bins, per_cta,
                                                                            o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
