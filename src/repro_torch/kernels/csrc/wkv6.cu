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
// order and carry nothing between them, so each block walks the whole
// sequence itself with its part of the state in registers.  There is no
// time chunk, so any L >= 1 is taken (the L = 1 of a decode step too) and
// nothing is padded.
//
// What bounds it on this card: bytes.  r, k, v, w in and y out are 20 bytes
// per (b, t, h, j) against about 5 hd flop, so at hd = 64 the card's memory
// is the limit of the bound.  The kernel itself is bound by its instruction
// stream and its latency: three fp32 instructions per state element and
// token (r S into y, k v, w S + k v) on the CUDA cores, the shared-memory
// reads that feed them, and a chain of dependent steps in t.  The design
// spreads that over as many threads as the state has room for, and keeps
// the per-token work to those three instructions:
//   * columns j of S evolve independently (S[:, j] <- w o S[:, j] + k v_j),
//     so a (b, h) is split over hd / JC blocks of JC columns: the grid is
//     B*H x hd/JC (640 blocks for rwkv6-3b's 160 heads at JC = 16);
//   * inside a block, thread tid holds a tile of the state: the C columns
//     of column group tid / P and the R = hd / P rows of the float4 groups
//     p, p + P, ... with p = tid % P.  The P threads of a column group sit
//     in adjacent lanes and read P different 16-byte words of a shared row
//     (no bank conflict); each word of r, k, w serves C columns;
//   * the tile's T tokens are unrolled (with no test between them in a
//     whole tile, so that the compiler hoists the next token's loads above
//     this token's sums), each thread keeping its partial y_j of every
//     (token, column); the P lanes then meet once a tile by a
//     reduce-scatter of __shfl_xor_sync steps, each lane ending with the
//     totals of T C / P of them, which it stores;
//   * the bonus a_t = sum_i r_i u_i k_i is the same for every j: it is
//     computed once per token, by a reduction over i, into shared memory,
//     while the tile's sums run, and added as v_j a_t where y is stored;
//   * tiles of T tokens of r, k and w (all of i) and v (the block's JC
//     columns) are copied into shared memory by 16-byte cp.async, each
//     thread's copies dealt out once; STAGES tiles are in shared memory, so
//     while tile n is walked the next ones are in flight.  Two
//     __syncthreads a tile: one when it has landed, one before y is stored
//     (the bonus);
//   * the state is read once at the start and written once at the end, a
//     row's C columns as one 16-byte word.  s0 and s_out may be one buffer:
//     each block reads its columns of its (b, h) before it writes them, and
//     no other block touches them.
// JC, P and C are template parameters, one geometry a head dim, chosen in
// wkv6_launch below (kernels/wkv6.py's launch_geometry names the same).  At
// hd = 64 it is the fastest of five geometries timed on the card (PERF.md).
// A decode step (L = 1) has no sequence to spread: it takes
// wkv6_step_kernel, one block of hd threads a head, each holding a column.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 8;       // tokens a tile
constexpr int STAGES = 4;  // tiles in shared memory: n walked, n + 1 ready, the rest in flight

struct Args {
  const float* q[4];  // r, k, v, w at (b, t, h) = (0, 0, 0)
  long long st[4][3];  // their strides of batch, position, head
  const float* u;
  const float* s0;  // nullptr: start from zero
  float* y;
  float* s_out;
  int L, H;
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int HD, int JC>
struct Stage {
  float rkw[3][T][HD];  // r, k, w over every row i
  float v[T][JC];       // v over the block's columns
};

// The 16-byte copies of one tile, dealt out to the threads once: copy
// s = tid + NT i of a tile is (array, token, 16-byte column), the same in
// every tile but for the tile's first token.
template <int HD, int JC, int NT>
struct Copies {
  static constexpr int ROW4 = HD / 4, V4 = JC / 4;
  static constexpr int N = 3 * T * ROW4 + T * V4;  // copies a tile
  static constexpr int PER = (N + NT - 1) / NT;    // copies a thread
  const float* src[PER];  // tile 0's word
  long long step[PER];    // from one tile to the next (elements)
  unsigned dst[PER];      // byte offset in a stage
  int tok[PER];           // token in the tile (T: no copy)

  __device__ __forceinline__ Copies(const float* r, const float* k, const float* v,
                                    const float* w, const Args& a, int jc0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = threadIdx.x + NT * i;
      tok[i] = T;
      src[i] = r;
      step[i] = 0;
      dst[i] = 0;
      if (s < 3 * T * ROW4) {
        const int qq = s / (T * ROW4), t = (s / ROW4) % T, c = s % ROW4;
        const int q = qq == 2 ? 3 : qq;  // r, k, w
        const float* base = qq == 0 ? r : (qq == 1 ? k : w);
        tok[i] = t;
        src[i] = base + t * a.st[q][1] + 4 * c;
        step[i] = T * a.st[q][1];
        dst[i] = static_cast<unsigned>(sizeof(float) * ((qq * T + t) * HD + 4 * c));
      } else if (s < N) {
        const int e = s - 3 * T * ROW4, t = e / V4, c = e % V4;
        tok[i] = t;
        src[i] = v + t * a.st[2][1] + jc0 + 4 * c;
        step[i] = T * a.st[2][1];
        dst[i] = static_cast<unsigned>(sizeof(float) * (3 * T * HD + t * JC + 4 * c));
      }
    }
  }

  // tile n into `stage`; tokens past L are not copied (and not read)
  __device__ __forceinline__ void load(Stage<HD, JC>& stage, int n, int cnt) const {
    const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(&stage));
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (tok[i] < cnt) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + dst[i]),
                     "l"(src[i] + n * step[i]));
      }
    }
  }
};

// The bonus a_t = sum_i r_i u_i k_i of every token of a stage: TPT = NT / T
// adjacent lanes a token, lane q summing the float4 row groups q, q + TPT,
// ... below hd (its u in registers, uq), then a shuffle reduction.
template <int HD, int NT>
struct Bonus {
  static constexpr int TPT = NT / T, NQ = (HD / 4 + TPT - 1) / TPT;
  float4 uq[NQ];

  __device__ __forceinline__ Bonus(const float* u) {
    const int q = threadIdx.x % TPT;
#pragma unroll
    for (int m = 0; m < NQ; ++m) {
      const int g = q + TPT * m;
      uq[m] = g < HD / 4 ? *reinterpret_cast<const float4*>(u + 4 * g) : make_float4(0, 0, 0, 0);
    }
  }

  template <int JC>
  __device__ __forceinline__ void run(const Stage<HD, JC>& cur, float* out) const {
    const int t = threadIdx.x / TPT, q = threadIdx.x % TPT;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < NQ; ++m) {
      const int g = q + TPT * m;
      if (g < HD / 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&cur.rkw[0][t][4 * g]);
        const float4 k4 = *reinterpret_cast<const float4*>(&cur.rkw[1][t][4 * g]);
        acc = fmaf(r4.x * uq[m].x, k4.x, acc);
        acc = fmaf(r4.y * uq[m].y, k4.y, acc);
        acc = fmaf(r4.z * uq[m].z, k4.z, acc);
        acc = fmaf(r4.w * uq[m].w, k4.w, acc);
      }
    }
#pragma unroll
    for (int o = TPT / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (q == 0) out[t] = acc;
  }
};

// Reduce-scatter over the P adjacent lanes of a column group: each lane
// holds N (>= P) partial sums of the same N values; at each step a lane
// keeps one half of what it holds and adds its partner's copy of that half,
// so after log2(P) steps lane p holds the totals of N / P consecutive
// values, from `base` on.
template <int N, int O>
struct Scatter {
  static __device__ __forceinline__ void run(float* ys, int p, int& base) {
    if constexpr (O > 0) {
      const bool hi = (p & O) != 0;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float lo_v = ys[x], hi_v = ys[x + N / 2];
        ys[x] = (hi ? hi_v : lo_v) + __shfl_xor_sync(0xFFFFFFFFu, hi ? lo_v : hi_v, O);
      }
      if (hi) base += N / 2;
      Scatter<N / 2, O / 2>::run(ys, p, base);
    }
  }
};

template <int HD, int JC>
struct Shared {
  Stage<HD, JC> stage[STAGES];
  float bonus[T];
};

// Thread tid holds, of the block's JC columns, the C columns of column group
// g = tid / P and, of the hd rows, the R = hd / P rows of the float4 groups
// p, p + P, p + 2P, ... with p = tid % P: the P threads of a column group
// sit in adjacent lanes and read P different 16-byte words of a shared row
// (no bank conflict).
template <int HD, int JC, int P, int C>
__global__ void __launch_bounds__(JC / C * P) wkv6_split_kernel(const Args a) {
  using Sh = Shared<HD, JC>;
  constexpr int NT = JC / C * P;  // threads a block
  constexpr int R = HD / P;       // state rows a thread holds
  constexpr int NG = R / 4;       // float4 row groups a thread holds
  constexpr int KEPT = T * C / P;  // (token, column) totals a lane ends with
  static_assert(HD % JC == 0 && JC % C == 0 && JC % 4 == 0 && (C == 2 || C == 4), "geometry");
  static_assert(HD % (4 * P) == 0 && 32 % P == 0 && KEPT >= 1 && KEPT * P == T * C, "geometry");
  static_assert(NT % 32 == 0 && NT / T <= 32 && (NT / T) * T == NT, "geometry");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sh& sh = *reinterpret_cast<Sh*>(smem_raw);

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int jc0 = blockIdx.y * JC;
  const int p = threadIdx.x % P, g = threadIdx.x / P;
  const int j0 = jc0 + g * C;  // this thread's first column
  const int L = a.L;
  const Copies<HD, JC, NT> copies(a.q[0] + b * a.st[0][0] + h * a.st[0][2],
                                  a.q[1] + b * a.st[1][0] + h * a.st[1][2],
                                  a.q[2] + b * a.st[2][0] + h * a.st[2][2],
                                  a.q[3] + b * a.st[3][0] + h * a.st[3][2], a, jc0);

  const Bonus<HD, NT> bonus(a.u + h * HD);
  float S[NG][4][C];  // S[row 4 (p + P m) + e][column j0 + c]
  const long long sbase = static_cast<long long>(bh) * HD * HD + j0;
  // a state row's C columns are adjacent: 8- or 16-byte words where the
  // buffers allow (the wrapper's are aligned; a view may not be)
  constexpr int VW = C % 4 == 0 ? 4 : 2;
  const bool vec = ((reinterpret_cast<uintptr_t>(a.s0) | reinterpret_cast<uintptr_t>(a.s_out)) &
                    (4 * VW - 1)) == 0;
#pragma unroll
  for (int m = 0; m < NG; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long at = sbase + (4 * (p + P * m) + e) * HD;
      if (a.s0 == nullptr) {
#pragma unroll
        for (int c = 0; c < C; ++c) S[m][e][c] = 0.f;
      } else if (vec) {
#pragma unroll
        for (int c = 0; c < C; c += VW) {
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(a.s0 + at + c);
            S[m][e][c] = x.x, S[m][e][c + 1] = x.y, S[m][e][c + 2] = x.z, S[m][e][c + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(a.s0 + at + c);
            S[m][e][c] = x.x, S[m][e][c + 1] = x.y;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) S[m][e][c] = a.s0[at + c];
      }
    }

  const int ntiles = (L + T - 1) / T;
  float* y = a.y + (static_cast<long long>(b) * L * a.H + h) * HD + j0;
  const long long y_step = static_cast<long long>(a.H) * HD;

  // tiles 0 .. STAGES - 2 in flight
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) {
    if (n < ntiles) copies.load(sh.stage[n], n, min(T, L - n * T));
    cp_async_commit();
  }

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<STAGES - 2>();  // tile n (this thread's copies); later ones may fly
    // tile n is visible; tile n - 1's stage and the bonus slot are free
    __syncthreads();
    const int ahead = n + STAGES - 1;
    if (ahead < ntiles) copies.load(sh.stage[ahead % STAGES], ahead, min(T, L - ahead * T));
    cp_async_commit();
    // tile n's bonus, needed only where y is stored: its reduction overlaps
    // the tokens' sums
    const Stage<HD, JC>& cur = sh.stage[n % STAGES];
    bonus.run(cur, sh.bonus);
    const int cnt = min(T, L - n * T);
    // The tile's tokens, unrolled: token t's sums need only the state after
    // token t - 1, so neighbouring tokens' loads and sums overlap, and the
    // P lanes of a column group meet once a tile, not once a token.
    float ys[T * C];  // this lane's partial y of (token t, column c) at t C + c
#pragma unroll
    for (int x = 0; x < T * C; ++x) ys[x] = 0.f;
    auto token = [&](int t) {
      float cv[C];
#pragma unroll
      for (int c = 0; c < C; c += VW) {
        if constexpr (VW == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&cur.v[t][g * C + c]);
          cv[c] = v4.x, cv[c + 1] = v4.y, cv[c + 2] = v4.z, cv[c + 3] = v4.w;
        } else {
          const float2 v2 = *reinterpret_cast<const float2*>(&cur.v[t][g * C + c]);
          cv[c] = v2.x, cv[c + 1] = v2.y;
        }
      }
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        const int i = 4 * (p + P * m);
        const float4 r4 = *reinterpret_cast<const float4*>(&cur.rkw[0][t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&cur.rkw[1][t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&cur.rkw[2][t][i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            ys[t * C + c] = fmaf(rr[e], S[m][e][c], ys[t * C + c]);
            S[m][e][c] = fmaf(ww[e], S[m][e][c], kk[e] * cv[c]);
          }
      }
    };
    if (cnt == T) {  // a whole tile: no test between tokens, so their loads can be hoisted
#pragma unroll
      for (int t = 0; t < T; ++t) token(t);
    } else {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t < cnt) token(t);
      }
    }
    int base = 0;
    Scatter<T * C, P / 2>::run(ys, p, base);
    // plus the bonus v_j a_t
    __syncthreads();  // the bonus is visible
    const float* an = sh.bonus;
#pragma unroll
    for (int x = 0; x < KEPT; ++x) {
      const int t = (base + x) / C, c = (base + x) % C;
      if (t < cnt) y[(n * T + t) * y_step + c] = fmaf(cur.v[t][g * C + c], an[t], ys[x]);
    }
  }

#pragma unroll
  for (int m = 0; m < NG; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long at = sbase + (4 * (p + P * m) + e) * HD;
      if (vec) {
#pragma unroll
        for (int c = 0; c < C; c += VW) {
          if constexpr (VW == 4) {
            *reinterpret_cast<float4*>(a.s_out + at + c) =
                make_float4(S[m][e][c], S[m][e][c + 1], S[m][e][c + 2], S[m][e][c + 3]);
          } else {
            *reinterpret_cast<float2*>(a.s_out + at + c) = make_float2(S[m][e][c], S[m][e][c + 1]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) a.s_out[at + c] = S[m][e][c];
      }
    }
}

template <int HD, int JC, int P, int C>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const auto fn = wkv6_split_kernel<HD, JC, P, C>;
  const int bytes = static_cast<int>(sizeof(Shared<HD, JC>));
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), HD / JC);
  fn<<<grid, JC / C * P, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The decode step (L = 1): one block per (b, h), thread j < hd holding
// column j of S (hd floats, read once, coalesced across j), no pipeline.
// r, k and w are staged in shared memory; the bonus is one block
// reduction; y_j and the new column follow in one pass over i.  The block
// is whole warps (hd = 16, 48, ... leave lanes idle).
template <int HD>
__global__ void __launch_bounds__((HD + 31) / 32 * 32) wkv6_step_kernel(const Args a) {
  constexpr int NW = (HD + 31) / 32;
  __shared__ __align__(16) float sr[HD], sk[HD], sw[HD];
  __shared__ float part[NW];
  const int j = threadIdx.x;
  const bool live = j < HD;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const long long sbase = static_cast<long long>(bh) * HD * HD + j;
  float S[HD];
  float vj = 0.f, bon = 0.f;
  if (live) {
    const float* in[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) in[q] = a.q[q] + b * a.st[q][0] + h * a.st[q][2] + j;
    const float rj = *in[0], kj = *in[1];
    vj = *in[2];
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = a.s0 != nullptr ? a.s0[sbase + i * HD] : 0.f;
    sr[j] = rj;
    sk[j] = kj;
    sw[j] = *in[3];
    bon = rj * a.u[h * HD + j] * kj;  // lane i's term of the bonus sum_i r_i u_i k_i
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bon += __shfl_xor_sync(0xFFFFFFFFu, bon, o);
  if (j % 32 == 0) part[j / 32] = bon;
  __syncthreads();
  if (!live) return;
  bon = 0.f;
#pragma unroll
  for (int q = 0; q < NW; ++q) bon += part[q];
  float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
  for (int i = 0; i < HD; i += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(&sr[i]);
    const float4 k4 = *reinterpret_cast<const float4*>(&sk[i]);
    const float4 w4 = *reinterpret_cast<const float4*>(&sw[i]);
    y0 = fmaf(r4.x, S[i], y0);
    y1 = fmaf(r4.y, S[i + 1], y1);
    y2 = fmaf(r4.z, S[i + 2], y2);
    y3 = fmaf(r4.w, S[i + 3], y3);
    S[i] = fmaf(w4.x, S[i], k4.x * vj);
    S[i + 1] = fmaf(w4.y, S[i + 1], k4.y * vj);
    S[i + 2] = fmaf(w4.z, S[i + 2], k4.z * vj);
    S[i + 3] = fmaf(w4.w, S[i + 3], k4.w * vj);
  }
  a.y[(static_cast<long long>(b) * a.H + h) * HD + j] = fmaf(vj, bon, (y0 + y1) + (y2 + y3));
#pragma unroll
  for (int i = 0; i < HD; ++i) a.s_out[sbase + i * HD] = S[i];
}

template <int HD>
int launch_step(const Args& a, int bh, cudaStream_t stream) {
  wkv6_step_kernel<HD><<<bh, (HD + 31) / 32 * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, w: fp32 on the card, element (b, t, h, i) at
//   base + b * strides[3q] + t * strides[3q + 1] + h * strides[3q + 2] + i
// for q = 0..3 in that order, every base 16-byte aligned and every stride a
// multiple of 4; u [H, hd], s0 (may be null) and s_out [B, H, hd, hd] and
// y [B, L, H, hd] contiguous; s_out may equal s0; hd a multiple of 16 in
// [16, 128].  L = 1 takes the decode step's kernel, any longer L the split
// kernel at hd's geometry (JC, P, C).  Returns the launch's cudaError_t
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
  if (L == 1) {  // the decode step
    switch (hd) {
      case 16: return launch_step<16>(a, bh, st);
      case 32: return launch_step<32>(a, bh, st);
      case 48: return launch_step<48>(a, bh, st);
      case 64: return launch_step<64>(a, bh, st);
      case 80: return launch_step<80>(a, bh, st);
      case 96: return launch_step<96>(a, bh, st);
      case 112: return launch_step<112>(a, bh, st);
      case 128: return launch_step<128>(a, bh, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {  // <HD, JC, P, C>
    case 16: return launch<16, 16, 4, 2>(a, bh, st);
    case 32: return launch<32, 32, 8, 4>(a, bh, st);
    case 48: return launch<48, 16, 4, 2>(a, bh, st);
    case 64: return launch<64, 16, 16, 4>(a, bh, st);
    case 80: return launch<80, 16, 4, 2>(a, bh, st);
    case 96: return launch<96, 32, 8, 4>(a, bh, st);
    case 112: return launch<112, 16, 4, 2>(a, bh, st);
    case 128: return launch<128, 32, 16, 4>(a, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
