// RWKV-6 wkv recurrence's backward (K7b) for Hopper (sm_90a).  The forward
// (K7, wkv6.cu) is, per (b, h) and token t, with S_0 = s0:
//   y_t[j] = sum_i r_t[i] * (S_{t-1}[i, j] + u[i] * k_t[i] * v_t[j])
//   S_t[i, j] = w_t[i] * S_{t-1}[i, j] + k_t[i] * v_t[j]
// With G_t = dL/dS_t, starting from G_L = dS_final (zero when absent) and
// running backwards as G_{t-1} = w_t o G_t + r_t dy_t^T:
//   dr_t[i] = sum_j (S_{t-1}[i, j] + u[i] k_t[i] v_t[j]) dy_t[j]
//   dk_t[i] = sum_j (G_t[i, j] + r_t[i] u[i] dy_t[j]) v_t[j]
//   dv_t[j] = sum_i (G_t[i, j] + r_t[i] u[i] dy_t[j]) k_t[i]
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   du[h, i] = sum_{b, t} r_t[i] k_t[i] sum_j v_t[j] dy_t[j]
//   ds0 = G_0
// All inputs fp32 and contiguous: r, k, v, w, dy [B, L, H, hd], u [H, hd],
// s0 and dS_final [B, H, hd, hd] (either may be absent).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel for
// wkv6_pallas and differentiates the model's chunked, checkpointed scan
// (repro/models/rwkv6.py, _wkv_scan) by autodiff.
//
// The difficulty is that dw_t and dr_t need S_{t-1} while G runs from the
// last token to the first.  S_{t-1} is not rebuilt from S_t by dividing out
// the decay: rwkv6's decay exp(-exp(.)) underflows to 0 and the division
// blows up.  Instead the kernel runs in two sweeps, like the JAX package's
// checkpointed outer scan:
//   A. forward over the sequence, storing the state before every tile of
//      T = 8 tokens into a scratch buffer (snap);
//   B. backward over the tiles, last first: reload the tile's first state,
//      recompute the tile's T states S_{t-1} into registers, then walk the
//      tile's tokens backwards carrying G.
// Columns j of S and of G evolve independently (both recurrences scale rows
// and add an outer product), so, as in K7, a (b, h) is split over hd / JC
// blocks of JC columns.  Thread (i, g) holds row i and the C = 4 columns
// JC y + C g ... of its block: its own elements of S and G, nothing shared.
// Nothing is added by atomics, so two calls give the same bits:
//   * dr, dk and dw sum over j: the G = JC / C lanes of a row (adjacent)
//     meet once a tile in a shuffle reduce-scatter, and each block writes
//     its partial sums (part); wkv6_bwd_sum_kernel adds the hd / JC blocks'
//     partials in block order;
//   * dv sums over i: the 8 rows of a warp meet in a shuffle reduce-scatter,
//     then the warps' sums are added in warp order through shared memory;
//   * du sums over b, t and j: each thread carries its row's sum over the
//     tiles, the 4 lanes of a row add theirs by a butterfly, each (b, block)
//     writes one row of du_part, and wkv6_bwd_du_kernel adds them in order.
// Tiles of r, k, w (every row) and v, dy (the block's columns) are staged
// in shared memory once a tile; T tokens a tile keep the per-tile costs (two
// barriers, the reduce-scatters) off the per-token path.
//
// What bounds it on this card: bytes.  The function reads r, k, v, w, dy
// (20 bytes per (b, t, h, i)) and writes dr, dk, dv, dw (16), against about
// 14 hd flop of work per (b, t, h, i) in the two sweeps, so memory is the
// bound (chip_smoke.py's _wkv_bwd_work reckons it).  This design moves more than the
// function needs: r, k, v, w and dy are read in both sweeps, the snapshots
// (one state a tile) are written and read once, and the partials of dr, dk
// and dw (3 hd / JC values a (b, t, h, i)) are written and read once.  A
// first design: right before fast.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 8;       // tokens a tile
constexpr int JC = 16;     // state columns a block
constexpr int C = 4;       // columns a thread
constexpr int G = JC / C;  // threads a row, adjacent lanes

struct Args {
  const float *r, *k, *v, *w, *dy;  // [B, L, H, hd]
  const float* u;                   // [H, hd]
  const float* s0;                  // [B, H, hd, hd]; nullptr: zero
  const float* ds;                  // dL/dS_final [B, H, hd, hd]; nullptr: zero
  float* snap;                      // [ntiles, B, H, hd, hd]: the state before each tile
  float* part;                      // [3, NB, B, L, H, hd]: dr, dk, dw over each block's columns
  float* dv;                        // [B, L, H, hd]
  float* du_part;                   // [B, NB, H, hd]
  float* ds0;                       // [B, H, hd, hd]
  int B, L, H;
};

template <int HD>
struct Tile {
  float r[T][HD], k[T][HD], w[T][HD];  // every row
  float v[T][JC], dy[T][JC];           // the block's columns
};

// Tile n's tokens into shared memory; tokens past L are zeros (never read).
// Sweep A reads k, w and v only (FULL = false).
template <int HD, bool FULL>
__device__ __forceinline__ void stage(Tile<HD>& tile, const Args& a, int b, int h, int t0,
                                      int cnt, int jc0) {
  constexpr int NT = G * HD, R4 = HD / 4, V4 = JC / 4;
  for (int x = threadIdx.x; x < 3 * T * R4; x += NT) {
    const int q = x / (T * R4), t = (x / R4) % T, c = x % R4;
    if (!FULL && q == 0) continue;
    const float* src = q == 0 ? a.r : (q == 1 ? a.k : a.w);
    float* dst = q == 0 ? &tile.r[t][4 * c] : (q == 1 ? &tile.k[t][4 * c] : &tile.w[t][4 * c]);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < cnt) {
      val = *reinterpret_cast<const float4*>(
          src + ((static_cast<long long>(b) * a.L + t0 + t) * a.H + h) * HD + 4 * c);
    }
    *reinterpret_cast<float4*>(dst) = val;
  }
  for (int x = threadIdx.x; x < 2 * T * V4; x += NT) {
    const int q = x / (T * V4), t = (x / V4) % T, c = x % V4;
    if (!FULL && q == 1) continue;
    const float* src = q == 0 ? a.v : a.dy;
    float* dst = q == 0 ? &tile.v[t][4 * c] : &tile.dy[t][4 * c];
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < cnt) {
      val = *reinterpret_cast<const float4*>(
          src + ((static_cast<long long>(b) * a.L + t0 + t) * a.H + h) * HD + jc0 + 4 * c);
    }
    *reinterpret_cast<float4*>(dst) = val;
  }
}

// Reduce-scatter over the lanes lane ^ (O << SHIFT), O = P/2 .. 1, with
// p = (lane >> SHIFT) % P: each lane holds N partial sums of the same N
// values; at each step it keeps one half and adds its partner's copy of that
// half, so it ends with the totals of N / P consecutive values from `base`.
template <int N, int O, int SHIFT>
struct Scatter {
  static __device__ __forceinline__ void run(float* xs, int p, int& base) {
    if constexpr (O > 0) {
      const bool hi = (p & O) != 0;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float lo_v = xs[x], hi_v = xs[x + N / 2];
        xs[x] = (hi ? hi_v : lo_v) + __shfl_xor_sync(0xFFFFFFFFu, hi ? lo_v : hi_v, O << SHIFT);
      }
      if (hi) base += N / 2;
      Scatter<N / 2, O / 2, SHIFT>::run(xs, p, base);
    }
  }
};

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
}

__device__ __forceinline__ void store4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
}

template <int HD>
__global__ void __launch_bounds__(G * HD) wkv6_bwd_kernel(const Args a) {
  constexpr int NT = G * HD, NWARP = NT / 32;
  static_assert(HD % JC == 0 && NT % 32 == 0 && G == 4, "geometry");
  __shared__ __align__(16) Tile<HD> tile;
  __shared__ __align__(16) float red[NWARP][T][JC];  // dv: each warp's sum over its 8 rows

  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int i = tid / G, g = tid % G;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int y = blockIdx.y, NB = gridDim.y, jc0 = y * JC;
  const int L = a.L, ntiles = (L + T - 1) / T;
  const long long state = static_cast<long long>(a.B) * a.H * HD * HD;
  const long long at = (static_cast<long long>(bh) * HD + i) * HD + jc0 + g * C;  // S[b, h, i, j]

  // A. forward: the state before each tile into snap (the last tile's
  // successors are not needed)
  float S[C];
  if (a.s0 != nullptr) {
    load4(S, a.s0 + at);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) S[c] = 0.f;
  }
  for (int n = 0; n < ntiles; ++n) {
    store4(a.snap + n * state + at, S);
    if (n == ntiles - 1) break;
    __syncthreads();  // the previous tile's reads are done
    stage<HD, false>(tile, a, b, h, n * T, T, jc0);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float kt = tile.k[t][i], wt = tile.w[t][i];
#pragma unroll
      for (int c = 0; c < C; ++c) S[c] = fmaf(wt, S[c], kt * tile.v[t][g * C + c]);
    }
  }

  // B. backward, the last tile first
  float Gs[C];
  if (a.ds != nullptr) {
    load4(Gs, a.ds + at);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) Gs[c] = 0.f;
  }
  const float ui = a.u[h * HD + i];
  float du = 0.f;
  for (int n = ntiles - 1; n >= 0; --n) {
    const int cnt = min(T, L - n * T);
    __syncthreads();  // the previous tile's reads of tile and red are done
    stage<HD, true>(tile, a, b, h, n * T, cnt, jc0);
    __syncthreads();
    // the tile's states S_{t-1}, recomputed from its first
    float Sp[T][C];
    load4(S, a.snap + n * state + at);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float kt = tile.k[t][i], wt = tile.w[t][i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        Sp[t][c] = S[c];
        S[c] = fmaf(wt, S[c], kt * tile.v[t][g * C + c]);
      }
    }
    float rows[3 * T];  // this lane's dr, dk, dw of token t at q T + t
    float cols[T * C];  // this row's dv terms of (token t, column c) at t C + c
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      float dr = 0.f, dk = 0.f, dw = 0.f, vdy = 0.f;
      if (t < cnt) {
        const float rt = tile.r[t][i], kt = tile.k[t][i], wt = tile.w[t][i];
        const float ar = rt * ui, ak = ui * kt;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float vc = tile.v[t][g * C + c], dyc = tile.dy[t][g * C + c];
          dr = fmaf(fmaf(ak, vc, Sp[t][c]), dyc, dr);
          const float gp = fmaf(ar, dyc, Gs[c]);
          dk = fmaf(gp, vc, dk);
          dw = fmaf(Gs[c], Sp[t][c], dw);
          cols[t * C + c] = gp * kt;
          vdy = fmaf(vc, dyc, vdy);
          Gs[c] = fmaf(wt, Gs[c], rt * dyc);
        }
        du = fmaf(rt * kt, vdy, du);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) cols[t * C + c] = 0.f;
      }
      rows[t] = dr, rows[T + t] = dk, rows[2 * T + t] = dw;
    }
    // dr, dk, dw: the G lanes of the row meet; lane g keeps 3 T / G values
    int base = 0;
    Scatter<3 * T, G / 2, 0>::run(rows, g, base);
#pragma unroll
    for (int x = 0; x < 3 * T / G; ++x) {
      const int q = (base + x) / T, t = (base + x) % T;
      if (t < cnt) {
        a.part[((((static_cast<long long>(q) * NB + y) * a.B + b) * L + n * T + t) * a.H + h) *
                   HD + i] = rows[x];
      }
    }
    // dv: the warp's 8 rows meet (lanes 4 apart); lane p = lane / 4 keeps
    // token p's C columns, then the warps' sums are added in order
    base = 0;
    Scatter<T * C, 4, 2>::run(cols, lane / G, base);
#pragma unroll
    for (int c = 0; c < C; ++c) red[wid][base / C][g * C + c] = cols[c];
    __syncthreads();
    for (int x = tid; x < T * JC; x += NT) {
      const int t = x / JC, jc = x % JC;
      if (t < cnt) {
        float acc = red[0][t][jc];
#pragma unroll
        for (int q = 1; q < NWARP; ++q) acc += red[q][t][jc];
        a.dv[((static_cast<long long>(b) * L + n * T + t) * a.H + h) * HD + jc0 + jc] = acc;
      }
    }
  }
  store4(a.ds0 + at, Gs);
  du += __shfl_xor_sync(0xFFFFFFFFu, du, 1);
  du += __shfl_xor_sync(0xFFFFFFFFu, du, 2);
  if (g == 0) a.du_part[((static_cast<long long>(b) * NB + y) * a.H + h) * HD + i] = du;
}

// dr, dk, dw: the NB blocks' partials of each element added in block order.
__global__ void wkv6_bwd_sum_kernel(const float4* __restrict__ part, int nb, long long n4,
                                    float4* __restrict__ out) {
  for (long long x = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; x < 3 * n4;
       x += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long q = x / n4, e = x % n4;
    const float4* p = part + q * nb * n4 + e;
    float4 acc = p[0];
    for (int y = 1; y < nb; ++y) {
      const float4 v = p[y * n4];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    out[q * n4 + e] = acc;
  }
}

// du[h, i] = sum over b, then the NB blocks, of du_part, in that order.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, int B, int nb, int hhd,
                                   float* __restrict__ du) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= hhd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int y = 0; y < nb; ++y) acc += du_part[(static_cast<long long>(b) * nb + y) * hhd + x];
  du[x] = acc;
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.B * a.H), HD / JC);
  wkv6_bwd_kernel<HD><<<grid, G * HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, w, dy: fp32 [B, L, H, hd], contiguous and 16-byte aligned; u
// [H, hd]; s0 and ds [B, H, hd, hd] (either may be null); hd a multiple of 16
// in [16, 128].  Scratch the caller allocates: snap [ceil(L / 8), B, H, hd,
// hd], part [3, hd / 16, B, L, H, hd], du_part [B, hd / 16, H, hd].  Outputs:
// grads [3, B, L, H, hd] (dr, dk, dw), dv [B, L, H, hd], du [H, hd], ds0
// [B, H, hd, hd].  Three kernels on `stream`; returns the first launch's
// cudaError_t that is not 0 (0 = all launched).
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* dy, const void* s0, const void* ds, void* snap, void* part,
                    void* du_part, void* grads, void* dv, void* du, void* ds0, int B, int L, int H,
                    int hd, void* stream) {
  if (B < 1 || L < 1 || H < 1 || hd % JC != 0 ||
      static_cast<long long>(B) * H > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.dy = static_cast<const float*>(dy);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.ds = static_cast<const float*>(ds);
  a.snap = static_cast<float*>(snap);
  a.part = static_cast<float*>(part);
  a.dv = static_cast<float*>(dv);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.B = B, a.L = L, a.H = H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (hd) {
    case 16: err = launch<16>(a, st); break;
    case 32: err = launch<32>(a, st); break;
    case 48: err = launch<48>(a, st); break;
    case 64: err = launch<64>(a, st); break;
    case 80: err = launch<80>(a, st); break;
    case 96: err = launch<96>(a, st); break;
    case 112: err = launch<112>(a, st); break;
    case 128: err = launch<128>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int nb = hd / JC;
  const long long n4 = static_cast<long long>(B) * L * H * hd / 4;
  const long long blocks = (3 * n4 + 255) / 256;
  wkv6_bwd_sum_kernel<<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                        st>>>(static_cast<const float4*>(part), nb, n4, static_cast<float4*>(grads));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  wkv6_bwd_du_kernel<<<(H * hd + 127) / 128, 128, 0, st>>>(a.du_part, B, nb, H * hd,
                                                          static_cast<float*>(du));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
