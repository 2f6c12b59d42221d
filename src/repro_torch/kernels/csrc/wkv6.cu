// RWKV-6 wkv recurrence for Hopper (sm_90a).  For r, k, v, w [B, L, H, hd]
// fp32 (any strides over batch, position and head, the last dimension
// contiguous), u [H, hd] and an optional initial state s0 [B, H, hd, hd]
// (zero when absent), per (b, h) and token t:
//   y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S[i, j] <- w_t[i] * S[i, j] + k_t[i] * v_t[j]
// y is written as [B, L, H, hd] and the final S as [B, H, hd, hd].
//
// Replaces the Pallas TPU kernel wkv6_pallas / _wkv6_kernel
// (repro/kernels/wkv6.py), which computes this from S = 0, and the model's
// scan that carries S in and out (repro/models/rwkv6.py, _wkv_scan).
//
// What differs from the TPU kernel: its grid is (B*H, L/chunk) with the
// chunk dimension sequential, and the [hd, hd] state is carried in VMEM
// scratch from one grid step to the next.  Blocks here run in parallel in no
// order and carry nothing between them, so one block owns one (b, h) and
// walks the whole sequence itself, the state in registers: thread j holds
// column j of S (hd floats).  There is no time chunk, so any L >= 1 is taken
// (the L = 1 of a decode step too) and nothing is padded.
//
// What bounds it on this card: bytes.  r, k, v, w in and y out are 20 bytes
// per (b, t, h, j) against about 5 hd flop, so at hd = 64 the card's memory
// is the limit (the wrapper's caller computes the bound).  But the steps in
// t depend on each other: with one block of hd threads per (b, h), B*H
// blocks (160 for rwkv6-3b at B = 4) do not fill 132 SMs deeply, and each
// token's work is a chain of hd fused multiply-adds per thread.  The design
// keeps that chain short and fed:
//   * tiles of T tokens of r, k, v and w are copied into shared memory by
//     cp.async, two stages, so the next tile's loads overlap this tile's
//     work and there is one __syncthreads per tile, not per token;
//   * per token a thread reads r, k, w and u over i from shared memory as
//     float4 broadcasts, and its own v_j;
//   * y_j = sum_i r_i S_ij + v_j * sum_i r_i u_i k_i, the first sum in four
//     partial sums; S_ij <- fma(w_i, S_ij, k_i v_j);
//   * the state is read once at the start and written once at the end.  s0
//     and s_out may be one buffer: each block reads its (b, h) slice before
//     it writes it, and no other block touches it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STAGE_FLOATS = 4096;  // r, k, v, w of one tile: 16 KB a stage

struct Args {
  const float* q[4];  // r, k, v, w at (b, t, h) = (0, 0, 0)
  long long st[4][3];  // their strides of batch, position, head
  const float* u;
  const float* s0;  // nullptr: start from zero
  float* y;
  float* s_out;
  int L, H;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// tile n of r, k, v, w (tokens nT .. nT + T - 1, as far as L) into dst
template <int HD, int T>
__device__ __forceinline__ void load_tile(float (*dst)[T][HD], const float* const* src,
                                          const Args& a, int n, int j) {
  const int t0 = n * T;
  const int cnt = min(T, a.L - t0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int t = 0; t < cnt; ++t) cp_async4(&dst[q][t][j], src[q] + (t0 + t) * a.st[q][1]);
  }
  cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(const Args a) {
  constexpr int T = STAGE_FLOATS / (4 * HD);  // tokens a tile
  __shared__ __align__(16) float tile[2][4][T][HD];
  __shared__ __align__(16) float su[HD];
  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int L = a.L;
  const float* src[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) src[q] = a.q[q] + b * a.st[q][0] + h * a.st[q][2] + j;

  su[j] = a.u[h * HD + j];  // read after the first __syncthreads below
  float S[HD];
  const long long sbase = static_cast<long long>(bh) * HD * HD + j;
  if (a.s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = a.s0[sbase + i * HD];
  } else {
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = 0.f;
  }

  const int ntiles = (L + T - 1) / T;
  float* y = a.y + (static_cast<long long>(b) * L * a.H + h) * HD + j;
  const long long y_step = static_cast<long long>(a.H) * HD;
  load_tile<HD, T>(tile[0], src, a, 0, j);
  for (int n = 0; n < ntiles; ++n) {
    if (n + 1 < ntiles) {
      // into the stage that tile n - 1 used, freed by the sync that ended it
      load_tile<HD, T>(tile[(n + 1) & 1], src, a, n + 1, j);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int t0 = n * T;
    const int cnt = min(T, L - t0);
    float(*cur)[T][HD] = tile[n & 1];
    for (int t = 0; t < cnt; ++t) {
      const float vj = cur[2][t][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&cur[0][t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&cur[1][t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&cur[3][t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        y0 = fmaf(r4.x, S[i], y0);
        y1 = fmaf(r4.y, S[i + 1], y1);
        y2 = fmaf(r4.z, S[i + 2], y2);
        y3 = fmaf(r4.w, S[i + 3], y3);
        a0 = fmaf(r4.x * u4.x, k4.x, a0);
        a1 = fmaf(r4.y * u4.y, k4.y, a1);
        a0 = fmaf(r4.z * u4.z, k4.z, a0);
        a1 = fmaf(r4.w * u4.w, k4.w, a1);
        S[i] = fmaf(w4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
      }
      y[(t0 + t) * y_step] = ((y0 + y1) + (y2 + y3)) + vj * (a0 + a1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) a.s_out[sbase + i * HD] = S[i];
}

template <int HD>
int launch(const Args& a, int bh, cudaStream_t stream) {
  wkv6_kernel<HD><<<bh, HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, w: fp32 on the card, element (b, t, h, i) at
//   base + b * strides[3q] + t * strides[3q + 1] + h * strides[3q + 2] + i
// for q = 0..3 in that order; u [H, hd], s0 (may be null) and s_out
// [B, H, hd, hd] and y [B, L, H, hd] contiguous; s_out may equal s0.
// hd is a multiple of 16 in [16, 128].  Returns the launch's cudaError_t
// (0 = launched).
int wkv6_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                const void* s0, void* y, void* s_out, int B, int L, int H, int hd,
                const long long* strides, void* stream) {
  if (B < 1 || L < 1 || H < 1 || static_cast<long long>(B) * H > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const void* q[4] = {r, k, v, w};
  for (int i = 0; i < 4; ++i) {
    a.q[i] = static_cast<const float*>(q[i]);
    for (int d = 0; d < 3; ++d) a.st[i][d] = strides[3 * i + d];
  }
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = static_cast<float*>(y);
  a.s_out = static_cast<float*>(s_out);
  a.L = L;
  a.H = H;
  const int bh = B * H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, bh, st);
    case 32: return launch<32>(a, bh, st);
    case 48: return launch<48>(a, bh, st);
    case 64: return launch<64>(a, bh, st);
    case 80: return launch<80>(a, bh, st);
    case 96: return launch<96>(a, bh, st);
    case 112: return launch<112>(a, bh, st);
    case 128: return launch<128>(a, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
