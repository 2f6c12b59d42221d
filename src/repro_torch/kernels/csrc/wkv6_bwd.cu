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
// last token to the first, and that S_{t-1} is not rebuilt from S_t by
// dividing out the decay: rwkv6's decay exp(-exp(.)) is exactly 0 in fp32
// for arguments above about 4.5.  The sequence is cut into chunks of CH = 32
// tokens so that it runs in parallel, in three passes:
//   A. (wkv6_bwd_state_kernel, blockIdx.y = 0) the state at every chunk's
//      start, chunk after chunk: S_end = diag(P) S_start + K~^T V, with
//      K~[s, i] = k_s[i] prod_{s < tau <= end} w_tau[i] and P the chunk's
//      product of w;
//   B. (the same launch, blockIdx.y = 1) the gradient state at every
//      chunk's end, last chunk first: G_{start-1} = diag(P) G_end + R~^T dY,
//      with R~[t, i] = r_t[i] prod_{start <= tau < t} w_tau[i]; ds0 is G
//      before the first token.  A and B do not depend on each other;
//   C. (wkv6_bwd_chunk_kernel) every chunk in parallel, from S at its start
//      and G at its end: a forward walk stores the state before every tile
//      of T = 8 tokens in shared memory, then a backward walk recomputes each
//      tile's states S_{t-1} into registers and carries G through the tile.
// Decay products are formed by multiplying w (K~ from the chunk's end, R~
// from its start), never by dividing by it or differencing log w, so a
// decay of 0 gives zeros and no NaN.  A ragged last chunk is padded with
// tokens that change nothing (r = k = v = dy = 0, w = 1).
//
// Pass C's geometry: a block holds ROWS = 16 whole rows of the state (all
// hd columns), thread (row, 4 adjacent columns), so dr, dk and dw, sums
// over a row, stay in the block (shuffles over the row's hd / 4 adjacent
// lanes).  dv sums over all rows: the rows of a warp meet by shuffles, the
// warps in warp order through shared memory, and the hd / 16 blocks of a
// (b, h, chunk), one thread-block cluster, in rank order over distributed
// shared memory; no partials go to device memory.  The chunk's inputs are
// staged by cp.async, one group a tile, so the forward walk starts on the
// first tile while the others arrive.  du: each block writes its rows' sum
// over the chunk (du_part) and wkv6_bwd_du_kernel adds them over b and the
// chunks in that order.  Nothing is added by atomics: two calls give the
// same bits.
//
// What bounds it on this card.  The function needs 14 hd^2 + 14 hd fp32
// operations a (b, t, h) against 36 hd bytes, so operations
// (chip_smoke.py's _wkv_bwd_work).  This design does 18.5 hd^2
// (_wkv_bwd_design_work): passes A and B 4 (a product and an add a state
// element and token each), pass C's forward walk 1.5 (the states before
// its tiles), its backward walk 2 (the tile's states again) and 11 (dr, dk,
// dw, dv and G), all on the CUDA cores in fp32 (the tensor cores' TF32
// keeps too few digits for 2e-4 unless split in three).  It also moves more
// bytes: every input twice (A or B, then C) and the chunks' boundary states
// (written by A and B, read by C), which bound A and B.  Pass C is bound by
// its shared-memory and shuffle traffic (about 30 wavefronts a warp and
// token) and the latency of its reduce-scatters, with three blocks (24
// warps) an SM at hd = 64.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CH = 32;       // tokens a chunk
constexpr int T = 8;         // tokens a tile of pass C
constexpr int NT = CH / T;   // tiles a chunk
constexpr int HALF = T / 2;  // tokens whose row sums are reduced together
constexpr int ROWS = 16;     // state rows a pass-C block
constexpr int AB_ROWS = 32;  // a pass-A/B block: at most AB_ROWS x AB_COLS state elements,
constexpr int AB_COLS = 64;  //   AB_CA columns a thread
constexpr int AB_CA = 4;

struct Args {
  const float *r, *k, *v, *w, *dy;  // [B, L, H, hd]
  const float* u;                   // [H, hd]
  const float* s0;                  // [B, H, hd, hd]; nullptr: zero
  const float* ds;                  // dL/dS_final [B, H, hd, hd]; nullptr: zero
  float* sbuf;                      // [NC, B, H, hd, hd]: S at each chunk's start
  float* gbuf;                      // [NC, B, H, hd, hd]: G at each chunk's end
  float *dr, *dk, *dw, *dv;         // [B, L, H, hd]
  float* du_part;                   // [B, NC, H, hd]
  float* ds0;                       // [B, H, hd, hd]
  int B, L, H, NC;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most n (0 .. 3) of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }

__device__ __forceinline__ float4 ones4() { return make_float4(1.f, 1.f, 1.f, 1.f); }

__device__ __forceinline__ float4 zeros4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// (b, t, h)'s first element in a [B, L, H, hd] array, from the row index
// tb = b L H + h of (b, 0, h)
__device__ __forceinline__ long long elem(long long tb, int t, int H, int hd) {
  return (tb + static_cast<long long>(t) * H) * hd;
}

// ---------------------------------------------------------------- A and B
// Geometry of passes A and B: a block holds BR x BC state elements of one
// (b, h), thread (4 rows, CA columns).
template <int HD>
struct Square {
  static constexpr int BR = HD < AB_ROWS ? HD : AB_ROWS;  // rows a block
  static constexpr int BC = HD < AB_COLS ? HD : AB_COLS;  // columns a block
  static constexpr int CA = AB_CA;                        // columns a thread
  static constexpr int NI = BR / 4, NJ = BC / CA;         // threads along rows, columns
  static constexpr int NTH = NI * NJ;                     // threads a block
  static constexpr int NB = (HD / BR) * (HD / BC);        // blocks a (b, h)
  static constexpr int BUF = 2 * CH * BR + CH * BC;       // floats a staged chunk
};

// Tokens [t0, t0 + CH) of a's and the decay's rows [i0, i0 + BR) and of c's
// columns [j0, j0 + BC) into buf = {a [CH][BR], w [CH][BR], c [CH][BC]}; a
// token past L as one that changes nothing (a and c zero, w one).
template <int HD>
__device__ __forceinline__ void stage_square(float* buf, const float* a, const float* w,
                                             const float* c, long long tb, int H, int t0, int L,
                                             int i0, int j0) {
  using Q = Square<HD>;
  constexpr int RQ = Q::BR / 4, CQ = Q::BC / 4, NR = 2 * CH * RQ;
  for (int x = threadIdx.x; x < NR + CH * CQ; x += Q::NTH) {
    const bool row = x < NR;
    const int y = row ? x : x - NR;
    const int q = row ? y / (CH * RQ) : 2;
    const int t = row ? (y / RQ) % CH : y / CQ;
    const int f = row ? y % RQ : y % CQ;
    float* dst = buf + (row ? (q * CH + t) * Q::BR : 2 * CH * Q::BR + t * Q::BC) + 4 * f;
    if (t0 + t < L) {
      const float* src = q == 0 ? a : (q == 1 ? w : c);
      cp_async16(dst, src + elem(tb, t0 + t, H, HD) + (row ? i0 : j0) + 4 * f);
    } else {
      st4(dst, q == 1 ? ones4() : zeros4());
    }
  }
}

// Passes A (blockIdx.y = 0) and B (1).  Every state element evolves on its
// own (its row's k or r and w, its column's v or dy), so the blocks need
// nothing from each other.  Chunks are staged by cp.async, the next one
// while this one is summed.
template <int HD>
__global__ void __launch_bounds__(Square<HD>::NTH) wkv6_bwd_state_kernel(const Args a) {
  using Q = Square<HD>;
  constexpr int CA = Q::CA;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, ti = tid / Q::NJ, tj = tid % Q::NJ;
  const int part = blockIdx.x % Q::NB, bh = blockIdx.x / Q::NB;
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = (part / (HD / Q::BC)) * Q::BR, j0 = (part % (HD / Q::BC)) * Q::BC;
  const bool grad = blockIdx.y == 1;
  const float* rows = grad ? a.r : a.k;
  const float* cols = grad ? a.dy : a.v;
  const float* init = grad ? a.ds : a.s0;
  float* out = grad ? a.gbuf : a.sbuf;
  const long long state = static_cast<long long>(a.B) * a.H * HD * HD;
  const long long at = (static_cast<long long>(bh) * HD + i0 + 4 * ti) * HD + j0 + CA * tj;
  const long long tb = static_cast<long long>(b) * a.L * a.H + h;
  const int nc = a.NC;

  float S[4][CA];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < CA; y += 4) {
      const float4 s = init != nullptr ? ld4(init + at + x * HD + y) : zeros4();
      S[x][y] = s.x, S[x][y + 1] = s.y, S[x][y + 2] = s.z, S[x][y + 3] = s.w;
    }
  stage_square<HD>(smem, rows, a.w, cols, tb, a.H, (grad ? nc - 1 : 0) * CH, a.L, i0, j0);
  cp_commit();
  for (int s = 0; s < nc; ++s) {
    const int c = grad ? nc - 1 - s : s;
    const float* buf = smem + (s & 1) * Q::BUF;
    if (s + 1 < nc) {
      stage_square<HD>(smem + ((s + 1) & 1) * Q::BUF, rows, a.w, cols, tb, a.H,
                       (grad ? c - 1 : c + 1) * CH, a.L, i0, j0);
      cp_commit();
      cp_wait(1);
    } else {
      cp_wait(0);
    }
    __syncthreads();
    // A: the state at the chunk's start; B: G at the chunk's end
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < CA; y += 4) {
        st4(out + c * state + at + x * HD + y,
            make_float4(S[x][y], S[x][y + 1], S[x][y + 2], S[x][y + 3]));
      }
    float dec[4] = {1.f, 1.f, 1.f, 1.f}, U[4][CA] = {};
#pragma unroll 4
    for (int n = 0; n < CH; ++n) {
      // A: K~ from the chunk's end (suffix products); B: R~ from its start
      const int t = grad ? n : CH - 1 - n;
      const float4 av = ld4(buf + t * Q::BR + 4 * ti);
      const float4 wv = ld4(buf + (CH + t) * Q::BR + 4 * ti);
      float cx[CA];
#pragma unroll
      for (int y = 0; y < CA; y += 4) {
        const float4 cv = ld4(buf + 2 * CH * Q::BR + t * Q::BC + CA * tj + y);
        cx[y] = cv.x, cx[y + 1] = cv.y, cx[y + 2] = cv.z, cx[y + 3] = cv.w;
      }
      const float ax[4] = {av.x * dec[0], av.y * dec[1], av.z * dec[2], av.w * dec[3]};
      dec[0] *= wv.x, dec[1] *= wv.y, dec[2] *= wv.z, dec[3] *= wv.w;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < CA; ++y) U[x][y] = fmaf(ax[x], cx[y], U[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < CA; ++y) S[x][y] = fmaf(dec[x], S[x][y], U[x][y]);
    __syncthreads();  // buf is staged into again two chunks on
  }
  if (grad) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < CA; y += 4) {
        st4(a.ds0 + at + x * HD + y, make_float4(S[x][y], S[x][y + 1], S[x][y + 2], S[x][y + 3]));
      }
  }
}

// ---------------------------------------------------------------- pass C
// Shared memory of a pass-C block, in floats.  r, k, w are staged apart
// (cp.async copies rows as they lie), then packed with a_t = v_t . dy_t
// into RKWA, one 16-byte load a token and row; their staging shares its
// room with RED and DV, which the backward walk fills once they are dead.
template <int HD>
struct ChunkSmem {
  static constexpr int P = HD / 4;        // lanes a row
  static constexpr int NTH = ROWS * P;    // threads a block
  static constexpr int NWARP = NTH / 32;  // warps a block
  static constexpr int V = 0;                        // v [CH][HD]
  static constexpr int DY = V + CH * HD;             // dy [CH][HD]
  static constexpr int SNAP = DY + CH * HD;          // the state before each tile [NT][ROWS][HD]
  static constexpr int RKWA = SNAP + NT * ROWS * HD; // (r, k, w, a_t) [CH][ROWS][4]
  static constexpr int OUT = RKWA + CH * ROWS * 4;   // dr, dk, dw [3][CH][ROWS]
  static constexpr int CB = OUT + 3 * CH * ROWS;     // sum over the block's rows of r u k [CH]
  static constexpr int AV = CB + CH;                 // a_t [CH]
  static constexpr int X = AV + CH;                  // the shared room:
  static constexpr int R = X;                        //   r, k, w of the block's rows [CH][ROWS]
  static constexpr int K = R + CH * ROWS;            //   (staging, forward walk), or
  static constexpr int W = K + CH * ROWS;
  static constexpr int RED = X;                      //   each warp's dv of a tile [NWARP][T][HD]
  static constexpr int DV = RED + NWARP * T * HD;    //   and the block's rows' dv [CH][HD]
  static constexpr int SIZE = X + (3 * CH * ROWS > NWARP * T * HD + CH * HD
                                       ? 3 * CH * ROWS : NWARP * T * HD + CH * HD);
};

// Tile n of the chunk from token t0 into shared memory: r, k, w of the
// block's rows, v and dy (every column); tokens past L change nothing.
template <int HD>
__device__ __forceinline__ void stage_tile(float* sm, const Args& a, long long tb, int t0, int n,
                                           int i0) {
  using M = ChunkSmem<HD>;
  constexpr int RQ = ROWS / 4, CQ = HD / 4, NR = 3 * T * RQ;
  for (int x = threadIdx.x; x < NR + 2 * T * CQ; x += M::NTH) {
    const bool row = x < NR;
    const int y = row ? x : x - NR;
    const int q = row ? y / (T * RQ) : y / (T * CQ);
    const int t = row ? (y / RQ) % T : (y / CQ) % T;
    const int f = row ? y % RQ : y % CQ;
    const int tok = n * T + t;  // in the chunk
    float* dst = row ? sm + (M::R + q * CH * ROWS) + tok * ROWS + 4 * f
                     : sm + (q == 0 ? M::V : M::DY) + tok * HD + 4 * f;
    if (t0 + tok < a.L) {
      const float* src = row ? (q == 0 ? a.r : (q == 1 ? a.k : a.w)) : (q == 0 ? a.v : a.dy);
      cp_async16(dst, src + elem(tb, t0 + tok, a.H, HD) + (row ? i0 : 0) + 4 * f);
    } else {
      st4(dst, row && q == 2 ? ones4() : zeros4());
    }
  }
}

// Reduce-scatter over the P adjacent lanes of a row: each lane holds N
// partial sums of the same N values.  Halving steps over lane ^ O, O = P/2,
// P/4, ..., leave each lane the totals of max(N / P, 1) consecutive values
// from `base`; where N < P the remaining steps add the partner's copy (a
// butterfly), so P / N adjacent lanes end with the same total.
template <int N, int O>
__device__ __forceinline__ void scatter(float* xs, int g, int& base) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool hi = (g & O) != 0;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float lo = xs[x], up = xs[x + N / 2];
        xs[x] = (hi ? up : lo) + __shfl_xor_sync(0xFFFFFFFFu, hi ? lo : up, O);
      }
      if (hi) base += N / 2;
      scatter<N / 2, O / 2>(xs, g, base);
    } else {
      xs[0] += __shfl_xor_sync(0xFFFFFFFFu, xs[0], O);
      scatter<1, O / 2>(xs, g, base);
    }
  }
}

// HALF row sums of tokens x0 .. x0 + HALF - 1, each lane holding its
// columns' part, into array q of the OUT staging [3][CH][ROWS] at row il.
template <int HD>
__device__ __forceinline__ void row_sums(float* xs, int g, int il, float* out, int q, int x0) {
  constexpr int P = HD / 4, KEEP = HALF >= P ? HALF / P : 1, SPAN = HALF >= P ? 1 : P / HALF;
  int base = 0;
  scatter<HALF, P / 2>(xs, g, base);
  if (g % SPAN == 0) {
#pragma unroll
    for (int x = 0; x < KEEP; ++x) out[(q * CH + x0 + base + x) * ROWS + il] = xs[x];
  }
}

// Pass C: one block per (b, h, chunk, 16 rows); the hd / 16 blocks of a
// (b, h, chunk) form a cluster (rank = row group), as `launch` launches it.
template <int HD>
__global__ void __launch_bounds__(ROWS * HD / 4, HD <= 64 ? 3 : 1)
    wkv6_bwd_chunk_kernel(const Args a) {
  using M = ChunkSmem<HD>;
  constexpr int P = M::P, NTH = M::NTH, NWARP = M::NWARP, CL = HD / ROWS;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int il = tid / P, g = tid % P, j0 = 4 * g;
  const int rg = blockIdx.x % CL;
  const int c = (blockIdx.x / CL) % a.NC;
  const int bh = blockIdx.x / CL / a.NC;
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = rg * ROWS, i = i0 + il;
  const int t0 = c * CH, cnt = min(CH, a.L - t0);
  const long long state = static_cast<long long>(a.B) * a.H * HD * HD;
  const long long at = (static_cast<long long>(bh) * HD + i) * HD + j0;
  const long long tb = static_cast<long long>(b) * a.L * a.H + h;

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    stage_tile<HD>(sm, a, tb, t0, n, i0);
    cp_commit();
  }
  float S[4], G[4];
  {
    const float4 s = ld4(a.sbuf + c * state + at), gg = ld4(a.gbuf + c * state + at);
    S[0] = s.x, S[1] = s.y, S[2] = s.z, S[3] = s.w;
    G[0] = gg.x, G[1] = gg.y, G[2] = gg.z, G[3] = gg.w;
  }
  // forward walk: the state before each tile
  st4(sm + M::SNAP + il * HD + j0, make_float4(S[0], S[1], S[2], S[3]));
#pragma unroll
  for (int n = 0; n + 1 < NT; ++n) {
    cp_wait(NT - 1 - n);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int x = n * T + t;
      const float kt = sm[M::K + x * ROWS + il], wt = sm[M::W + x * ROWS + il];
      const float4 vv = ld4(sm + M::V + x * HD + j0);
      S[0] = fmaf(wt, S[0], kt * vv.x), S[1] = fmaf(wt, S[1], kt * vv.y);
      S[2] = fmaf(wt, S[2], kt * vv.z), S[3] = fmaf(wt, S[3], kt * vv.w);
    }
    st4(sm + M::SNAP + ((n + 1) * ROWS + il) * HD + j0, make_float4(S[0], S[1], S[2], S[3]));
  }
  cp_wait(0);
  __syncthreads();
  // a_t = v_t . dy_t and the block's rows' sum of r u k, a token a warp
  {
    const float ul = lane < ROWS ? a.u[h * HD + i0 + lane] : 0.f;
    for (int t = wid; t < CH; t += NWARP) {
      float pa = 0.f;
#pragma unroll
      for (int j = lane; j < HD; j += 32) pa = fmaf(sm[M::V + t * HD + j], sm[M::DY + t * HD + j], pa);
      float pc = lane < ROWS ? sm[M::R + t * ROWS + lane] * ul * sm[M::K + t * ROWS + lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        pa += __shfl_xor_sync(0xFFFFFFFFu, pa, o);
        pc += __shfl_xor_sync(0xFFFFFFFFu, pc, o);
      }
      if (lane == 0) sm[M::AV + t] = pa, sm[M::CB + t] = pc;
    }
  }
  __syncthreads();
  // (r, k, w, a) packed a token and row
  for (int x = tid; x < CH * ROWS; x += NTH) {
    st4(sm + M::RKWA + 4 * x,
        make_float4(sm[M::R + x], sm[M::K + x], sm[M::W + x], sm[M::AV + x / ROWS]));
  }
  __syncthreads();  // R, K, W are dead: RED and DV take their room

  // backward walk, the last tile first
  const float mu = g == 0 ? a.u[h * HD + i] : 0.f;  // the bonus terms, once a row
  float du = 0.f;
#pragma unroll 1
  for (int n = NT - 1; n >= 0; --n) {
    // the tile's states S_{t-1}
    float Sp[T][4];
    {
      const float4 s = ld4(sm + M::SNAP + (n * ROWS + il) * HD + j0);
      S[0] = s.x, S[1] = s.y, S[2] = s.z, S[3] = s.w;
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int x = n * T + t;
#pragma unroll
      for (int q = 0; q < 4; ++q) Sp[t][q] = S[q];
      if (t + 1 < T) {
        const float4 p = ld4(sm + M::RKWA + 4 * (x * ROWS + il));
        const float4 vv = ld4(sm + M::V + x * HD + j0);
        S[0] = fmaf(p.z, S[0], p.y * vv.x), S[1] = fmaf(p.z, S[1], p.y * vv.y);
        S[2] = fmaf(p.z, S[2], p.y * vv.z), S[3] = fmaf(p.z, S[3], p.y * vv.w);
      }
    }
    if (n + 1 < NT) __syncthreads();  // the previous tile's RED has been read
    // G back through the tile: dr, dk, dw (row sums), dv (the warp's rows meet)
#pragma unroll
    for (int hf = 1; hf >= 0; --hf) {
      float dr[HALF], dk[HALF], dw[HALF];
#pragma unroll
      for (int t = HALF - 1; t >= 0; --t) {
        const int tt = hf * HALF + t, x = n * T + tt;
        const float4 p = ld4(sm + M::RKWA + 4 * (x * ROWS + il));  // r, k, w, a
        const float4 vv = ld4(sm + M::V + x * HD + j0), dd = ld4(sm + M::DY + x * HD + j0);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w}, dx[4] = {dd.x, dd.y, dd.z, dd.w};
        const float ma = mu * p.w;
        float pr = ma * p.y, pk = ma * p.x, pw = 0.f, dv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pr = fmaf(Sp[tt][q], dx[q], pr);
          pk = fmaf(G[q], vx[q], pk);
          pw = fmaf(G[q], Sp[tt][q], pw);
          dv[q] = G[q] * p.y;
          G[q] = fmaf(p.z, G[q], p.x * dx[q]);
        }
        du = fmaf(p.x * p.y, p.w, du);
        dr[t] = pr, dk[t] = pk, dw[t] = pw;
#pragma unroll
        for (int o = P; o < 32; o *= 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) dv[q] += __shfl_xor_sync(0xFFFFFFFFu, dv[q], o);
        }
        if (lane < P) st4(sm + M::RED + (wid * T + tt) * HD + j0, make_float4(dv[0], dv[1], dv[2], dv[3]));
      }
      const int x0 = n * T + hf * HALF;
      row_sums<HD>(dr, g, il, sm + M::OUT, 0, x0);
      row_sums<HD>(dk, g, il, sm + M::OUT, 1, x0);
      row_sums<HD>(dw, g, il, sm + M::OUT, 2, x0);
    }
    __syncthreads();  // the tile's RED is complete
    // the block's rows' dv of the tile: the warps in order, then the bonus
    for (int x = tid; x < T * HD; x += NTH) {
      const int t = n * T + x / HD, j = x % HD;
      float acc = sm[M::RED + x];
#pragma unroll
      for (int q = 1; q < NWARP; ++q) acc += sm[M::RED + q * T * HD + x];
      sm[M::DV + t * HD + j] = fmaf(sm[M::CB + t], sm[M::DY + t * HD + j], acc);
    }
  }
  __syncthreads();  // OUT and DV are complete
  // dr, dk, dw of the chunk's tokens and the block's rows
  for (int x = tid; x < 3 * CH * (ROWS / 4); x += NTH) {
    const int q = x / (CH * ROWS / 4), t = (x / (ROWS / 4)) % CH, f = x % (ROWS / 4);
    if (t < cnt) {
      float* dst = q == 0 ? a.dr : (q == 1 ? a.dk : a.dw);
      st4(dst + elem(tb, t0 + t, a.H, HD) + i0 + 4 * f, ld4(sm + M::OUT + (q * CH + t) * ROWS + 4 * f));
    }
  }
  if (g == 0) a.du_part[((static_cast<long long>(b) * a.NC + c) * a.H + h) * HD + i] = du;
  // dv: block rg adds columns [16 rg, 16 rg + 16) over the cluster's blocks in rank order
  if constexpr (CL > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int x = tid; x < CH * (ROWS / 4); x += NTH) {
      const int t = x / (ROWS / 4), f = x % (ROWS / 4);
      if (t < cnt) {
        const int off = M::DV + t * HD + i0 + 4 * f;
        float4 acc = ld4(cluster.map_shared_rank(sm, 0) + off);
#pragma unroll
        for (int q = 1; q < CL; ++q) {
          const float4 y = ld4(cluster.map_shared_rank(sm, q) + off);
          acc.x += y.x, acc.y += y.y, acc.z += y.z, acc.w += y.w;
        }
        st4(a.dv + elem(tb, t0 + t, a.H, HD) + i0 + 4 * f, acc);
      }
    }
    cluster.sync();  // no block leaves while another reads its DV
  } else {
    for (int x = tid; x < CH * (ROWS / 4); x += NTH) {
      const int t = x / (ROWS / 4), f = x % (ROWS / 4);
      if (t < cnt) st4(a.dv + elem(tb, t0 + t, a.H, HD) + 4 * f, ld4(sm + M::DV + t * HD + 4 * f));
    }
  }
}

// du[h, i] = sum over b, then the chunks, of du_part, in that order.
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ du_part, int B, int nc, int hhd,
                                   float* __restrict__ du) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= hhd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) acc += du_part[(static_cast<long long>(b) * nc + c) * hhd + x];
  du[x] = acc;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using Q = Square<HD>;
  constexpr int smem_ab = 2 * Q::BUF * static_cast<int>(sizeof(float));
  constexpr int smem_c = ChunkSmem<HD>::SIZE * static_cast<int>(sizeof(float));
  static const int set = allow_smem(wkv6_bwd_state_kernel<HD>, smem_ab) |
                         allow_smem(wkv6_bwd_chunk_kernel<HD>, smem_c);
  if (set != 0) return set;
  const dim3 grid_ab(static_cast<unsigned>(a.B * a.H * Q::NB), 2);
  wkv6_bwd_state_kernel<HD><<<grid_ab, Q::NTH, smem_ab, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // pass C: clusters of hd / 16 blocks along x, one cluster a (b, h, chunk)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(a.B) * a.H * a.NC * (HD / ROWS)));
  cfg.blockDim = dim3(ChunkSmem<HD>::NTH);
  cfg.dynamicSmemBytes = smem_c;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = HD / ROWS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, wkv6_bwd_chunk_kernel<HD>, a));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tokens a chunk: the wrapper sizes its scratch by it.
int wkv6_bwd_chunk() { return CH; }

// r, k, v, w, dy: fp32 [B, L, H, hd], contiguous and 16-byte aligned; u
// [H, hd]; s0 and ds [B, H, hd, hd] (either may be null); hd one of 16, 32,
// 64, 128.  Scratch the caller allocates, NC = ceil(L / wkv6_bwd_chunk()):
// sbuf and gbuf [NC, B, H, hd, hd], du_part [B, NC, H, hd].  Outputs: grads
// [3, B, L, H, hd] (dr, dk, dw), dv [B, L, H, hd], du [H, hd], ds0 [B, H,
// hd, hd].  Three kernels on `stream`; returns the first launch's
// cudaError_t that is not 0 (0 = all launched).
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* dy, const void* s0, const void* ds, void* sbuf, void* gbuf,
                    void* du_part, void* grads, void* dv, void* du, void* ds0, int B, int L, int H,
                    int hd, void* stream) {
  const long long nc = (static_cast<long long>(L) + CH - 1) / CH;
  if (B < 1 || L < 1 || H < 1 || nc * B * H * (hd / ROWS) > 0x7FFFFFFFLL) {
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
  a.sbuf = static_cast<float*>(sbuf);
  a.gbuf = static_cast<float*>(gbuf);
  const long long n = static_cast<long long>(B) * L * H * hd;
  a.dr = static_cast<float*>(grads);
  a.dk = a.dr + n;
  a.dw = a.dk + n;
  a.dv = static_cast<float*>(dv);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.B = B, a.L = L, a.H = H, a.NC = static_cast<int>(nc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (hd) {
    case 16: err = launch<16>(a, st); break;
    case 32: err = launch<32>(a, st); break;
    case 64: err = launch<64>(a, st); break;
    case 128: err = launch<128>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  wkv6_bwd_du_kernel<<<(H * hd + 127) / 128, 128, 0, st>>>(a.du_part, B, a.NC, H * hd,
                                                          static_cast<float*>(du));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
