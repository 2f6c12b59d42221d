// FlashAttention backward for Hopper (sm_90a): for the forward of
// csrc/flash_attention.cu, o = softmax(scale * q k^T) v with grouped KV
// heads (query head h reads kv head g = h / (H / Hkv)) and the start-aligned
// causal mask, given o, the forward's per-row log-sum-exp `lse` (fp32
// [B, H, Lq]) and the output's gradient do, it computes
//   P_ij  = exp(scale * q_i . k_j - lse_i)   (0 where the mask drops j)
//   dv_j  = sum_i P_ij do_i
//   dS_ij = P_ij (do_i . v_j - delta_i),      delta_i = do_i . o_i
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_i dS_ij q_i
// where dk and dv of a kv head sum over the query heads of its group.
//
// There is no TPU kernel to replace: the JAX package differentiates the
// plain attention (repro/models/layers.py, _sdpa / _sdpa_chunked) and its
// Pallas forward has no backward.  This is the backward of the port's own
// forward, which the training path runs (kernels/flash_attention.py,
// FlashAttentionFn).
//
// Structure: a key-tile kernel and a query-tile kernel on one stream.
//   * the key-tile kernel: a block owns a tile of keys of one (batch, kv
//     head) and walks every query tile of every query head of its group,
//     rebuilding S and dP, and keeps dk and dv in registers; it writes them
//     once, so no two blocks touch one output (no atomics).
//   * the query-tile kernel: a block owns a tile of queries of one (batch,
//     head), walks the key tiles and keeps dq in registers.
// Every sum has one order fixed by the code, so two calls give the same
// bits.  S and dP are rebuilt in both kernels: 7 products a (query, key)
// pair where 5 would do.  A single key-tile kernel that adds each query
// tile's dQ share in key-tile order (semaphores, fp32 bulk adds: 5
// products and the same bits every call) measured slower on the card.
//
// What bounds it on this card: operations, 2 D flops for each of the five
// products of a (query, key) pair the mask keeps, against q, k, v, o, do
// read once and dq, dk, dv written once.  Three variants, chosen by dtype
// and D (kernels/flash_attention.py, bwd_kernel_variant):
//   * fp32: FMAs on the CUDA cores, 32 x 32 tiles, 256 threads each
//     holding 2 x 2 scores; no TF32.  The parity path.  A delta pass (one
//     warp a row) runs first;
//   * bf16, D = 64, 80 or 128 (namespace wgb below): wgmma with TMA loads,
//     128 keys a key-tile block and 128 queries a query-tile block.  The
//     training paths of OLMo-1B (D = 128), hubert-xlarge and Zamba2's
//     shared block (D = 80) run here;
//   * bf16, other D: mma.sync m16n8k16 with ldmatrix fragments, 64 x 64
//     tiles, four warps of 16 rows, after the delta pass.  Its
//     accumulators cover at most 128 columns of the head dim: a larger D
//     runs its columns in chunks over grid.z, each chunk rebuilding S and
//     dP over the whole D (D = 256 does the score work twice).
// In the bf16 kernels P and dS are rounded to bf16 as the A operands of
// their products, as the forward rounds P before P.V; every sum is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DC_MAX = 128;  // head-dim columns a block accumulates

struct BwdShape {
  int H, group, Lq, Lk, D, causal;
  int dc;  // columns of the head dim a block accumulates (grid.z chunks)
  float scale;
  // strides of batch, head, position; the head dimension is contiguous
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---- 1. delta_i = do_i . o_i ------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, BwdShape s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  if (row >= s.Lq) return;
  const T* op = o + b * s.os[0] + h * s.os[1] + row * s.os[2];
  const T* dp = dout + b * s.dos[0] + h * s.dos[1] + row * s.dos[2];
  float acc = 0.f;
  for (int c = lane; c < s.D; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) delta[static_cast<long long>(bh) * s.Lq + row] = acc;
}

// ---- fp32: CUDA cores ---------------------------------------------------------
constexpr int FT = 32;         // keys a tile and queries a tile
constexpr int F_THREADS = 256;  // 16 x 16: thread (ty, tx)

// rows [row0, row0 + FT) of a [L, D] slab into a [FT][ld] shared tile; rows
// at or past `valid` are zero
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* src, long long stride,
                                         int row0, int valid, int D) {
  for (int i = threadIdx.x; i < FT * D; i += F_THREADS) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] = r < valid ? src[(row0 + r) * stride + c] : 0.f;
  }
}

// a[i][j] = sum_d x[(2 ty + i)][d] y[(tx + 16 j)][d] and the same for x2, y2:
// the two 2 x 2 score blocks of this thread (S and dP)
__device__ __forceinline__ void two_dots(float (&a)[2][2], float (&a2)[2][2], const float* x,
                                         const float* y, const float* x2, const float* y2,
                                         int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) a[i][j] = a2[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float xr[2], yr[2], x2r[2], y2r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xr[i] = x[(2 * ty + i) * ld + d];
      x2r[i] = x2[(2 * ty + i) * ld + d];
      yr[i] = y[(tx + 16 * i) * ld + d];
      y2r[i] = y2[(tx + 16 * i) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        a[i][j] = fmaf(xr[i], yr[j], a[i][j]);
        a2[i][j] = fmaf(x2r[i], y2r[j], a2[i][j]);
      }
  }
}

// Key-tile kernel: block (key tile, batch * Hkv, column chunk).  Thread
// (ty, tx) owns keys 2 ty, 2 ty + 1 of the tile: scores against queries
// tx, tx + 16, and dk, dv at columns c0 + tx + 16 jj.
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, BwdShape s) {
  extern __shared__ float fsm[];
  const int D = s.D, ld = D + 1;  // odd pitch: a column read hits 16 banks
  float* sk = fsm;               // [FT][ld]
  float* sv = sk + FT * ld;      // [FT][ld]
  float* sq = sv + FT * ld;      // [FT][ld]
  float* sdo = sq + FT * ld;     // [FT][ld]
  float* sp = sdo + FT * ld;     // [FT keys][FT + 1]
  float* sds = sp + FT * (FT + 1);
  float* slse = sds + FT * (FT + 1);  // [FT]
  float* sdel = slse + FT;            // [FT]
  constexpr int NJ = DC_MAX / 16;

  const int n0 = blockIdx.x * FT;
  const int bg = blockIdx.y, b = bg / (s.H / s.group), g = bg % (s.H / s.group);
  const int c0 = blockIdx.z * s.dc, nc = min(s.dc, D - c0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_keys = min(FT, s.Lk - n0);

  load_f32(sk, ld, k + b * s.ks[0] + g * s.ks[1], s.ks[2], n0, n_keys, D);
  load_f32(sv, ld, v + b * s.vs[0] + g * s.vs[1], s.vs[2], n0, n_keys, D);

  float acc_k[2][NJ], acc_v[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  // queries before the tile's first key are masked for all its keys
  const int m_start = s.causal ? n0 : 0;
  for (int hh = 0; hh < s.group; ++hh) {
    const int h = g * s.group + hh;
    const float* qb = q + b * s.qs[0] + h * s.qs[1];
    const float* dob = dout + b * s.dos[0] + h * s.dos[1];
    const float* lb = lse + (static_cast<long long>(b) * s.H + h) * s.Lq;
    const float* db = delta + (static_cast<long long>(b) * s.H + h) * s.Lq;
    for (int m0 = m_start; m0 < s.Lq; m0 += FT) {
      const int n_q = min(FT, s.Lq - m0);
      __syncthreads();  // the previous tile's sq, sdo, sp and sds are consumed
      load_f32(sq, ld, qb, s.qs[2], m0, n_q, D);
      load_f32(sdo, ld, dob, s.dos[2], m0, n_q, D);
      if (tid < FT) {
        slse[tid] = tid < n_q ? lb[m0 + tid] : 0.f;
        sdel[tid] = tid < n_q ? db[m0 + tid] : 0.f;
      }
      __syncthreads();

      float sc[2][2], dp[2][2];  // [key][query]
      two_dots(sc, dp, sk, sq, sv, sdo, ld, D, ty, tx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = n0 + 2 * ty + i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = tx + 16 * j, qpos = m0 + ql;
          const bool keep = key < s.Lk && qpos < s.Lq && (!s.causal || qpos >= key);
          const float p = keep ? expf(sc[i][j] * s.scale - slse[ql]) : 0.f;
          sp[(2 * ty + i) * (FT + 1) + ql] = p;
          sds[(2 * ty + i) * (FT + 1) + ql] = p * (dp[i][j] - sdel[ql]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < n_q; ++qq) {
        float pv[2], dsv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          pv[i] = sp[(2 * ty + i) * (FT + 1) + qq];
          dsv[i] = sds[(2 * ty + i) * (FT + 1) + qq];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = tx + 16 * jj;
          if (c < nc) {
            const float dov = sdo[qq * ld + c0 + c], qv = sq[qq * ld + c0 + c];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              acc_v[i][jj] = fmaf(pv[i], dov, acc_v[i][jj]);
              acc_k[i][jj] = fmaf(dsv[i], qv, acc_k[i][jj]);
            }
          }
        }
      }
    }
  }

  float* dkb = dk + b * s.dks[0] + g * s.dks[1];
  float* dvb = dv + b * s.dvs[0] + g * s.dvs[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + 2 * ty + i;
    if (key >= s.Lk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < nc) {
        dkb[key * s.dks[2] + c0 + c] = acc_k[i][jj] * s.scale;
        dvb[key * s.dvs[2] + c0 + c] = acc_v[i][jj];
      }
    }
  }
}

// Query-tile kernel: block (query tile, batch * H, column chunk).  Thread
// (ty, tx) owns queries 2 ty, 2 ty + 1: scores against keys tx, tx + 16,
// and dq at columns c0 + tx + 16 jj.
__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, BwdShape s) {
  extern __shared__ float fsm[];
  const int D = s.D, ld = D + 1;
  float* sq = fsm;              // [FT][ld]
  float* sdo = sq + FT * ld;    // [FT][ld]
  float* sk = sdo + FT * ld;    // [FT][ld]
  float* sv = sk + FT * ld;     // [FT][ld]
  float* sds = sv + FT * ld;    // [FT queries][FT + 1]
  constexpr int NJ = DC_MAX / 16;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * FT;  // the longest causal blocks first
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, g = h / s.group;
  const int c0 = blockIdx.z * s.dc, nc = min(s.dc, D - c0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n_q = min(FT, s.Lq - m0);
  const float* kb = k + b * s.ks[0] + g * s.ks[1];
  const float* vb = v + b * s.vs[0] + g * s.vs[1];

  load_f32(sq, ld, q + b * s.qs[0] + h * s.qs[1], s.qs[2], m0, n_q, D);
  load_f32(sdo, ld, dout + b * s.dos[0] + h * s.dos[1], s.dos[2], m0, n_q, D);
  float row_lse[2], row_del[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = m0 + 2 * ty + i;
    row_lse[i] = qpos < s.Lq ? lse[static_cast<long long>(bh) * s.Lq + qpos] : 0.f;
    row_del[i] = qpos < s.Lq ? delta[static_cast<long long>(bh) * s.Lq + qpos] : 0.f;
  }

  float acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  const int n_end = s.causal ? min(s.Lk, m0 + FT) : s.Lk;
  for (int n0 = 0; n0 < n_end; n0 += FT) {
    const int n_keys = min(FT, s.Lk - n0);
    __syncthreads();  // the previous tile's sk, sv and sds are consumed
    load_f32(sk, ld, kb, s.ks[2], n0, n_keys, D);
    load_f32(sv, ld, vb, s.vs[2], n0, n_keys, D);
    __syncthreads();

    float sc[2][2], dp[2][2];  // [query][key]
    two_dots(sc, dp, sq, sk, sdo, sv, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = m0 + 2 * ty + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = tx + 16 * j, key = n0 + kl;
        const bool keep = key < s.Lk && qpos < s.Lq && (!s.causal || qpos >= key);
        const float p = keep ? expf(sc[i][j] * s.scale - row_lse[i]) : 0.f;
        sds[(2 * ty + i) * (FT + 1) + kl] = p * (dp[i][j] - row_del[i]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < n_keys; ++kk) {
      float dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = sds[(2 * ty + i) * (FT + 1) + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = tx + 16 * jj;
        if (c < nc) {
          const float kv = sk[kk * ld + c0 + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) acc[i][jj] = fmaf(dsv[i], kv, acc[i][jj]);
        }
      }
    }
  }

  float* dqb = dq + b * s.dqs[0] + h * s.dqs[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = m0 + 2 * ty + i;
    if (qpos >= s.Lq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < nc) dqb[qpos * s.dqs[2] + c0 + c] = acc[i][jj] * s.scale;
    }
  }
}

// ---- bf16: tensor cores -------------------------------------------------------
constexpr int BT = 64;            // keys a tile and queries a tile
constexpr int MMA_THREADS = 128;  // 4 warps, warp w owns rows 16 w .. 16 w + 15

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + BT) of a [L, D] slab into a [BT][ld] shared tile, 16
// bytes a load; rows at or past `valid` are zero.  The wrapper holds every
// stride to a multiple of 8 elements and every base to 16 bytes.
__device__ __forceinline__ void load_bf16(bf16* dst, int ld, const bf16* src, long long stride,
                                          int row0, int valid, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < BT * chunks; i += MMA_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Fragment layouts are those of mma.m16n8k16 (PTX ISA): lane = 4 g + t4; an
// accumulator holds (row g, cols 2 t4, 2 t4 + 1) and (row g + 8, the same
// cols).  acc (16 x 64, eight 16 x 8 tiles) += A rows of this warp times
// the 64 rows of B, both [rows][D] tiles in shared memory (B as the
// column-major operand: acc = A B^T).
__device__ __forceinline__ void warp_scores(float (&acc)[8][4], const bf16* a_tile,
                                            const bf16* b_tile, int ld, int D, int warp,
                                            int lane) {
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + (warp * 16 + (lm & 1) * 8 + lr) * ld + kk * 16 + (lm >> 1) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bb[4];
      ldsm_x4(bb, b_tile + ((2 * jp + (lm >> 1)) * 8 + lr) * ld + kk * 16 + (lm & 1) * 8);
      mma_bf16(acc[2 * jp], a, bb[0], bb[1]);
      mma_bf16(acc[2 * jp + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x NC columns of this warp, NDC / 8 tiles) += A (16 x 64, as
// bf16 A fragments over four k steps of 16) times rows [0, 64) of `tile`
// ([64][ld], row-major, columns c0 ..), the k steps that hold a live row
__device__ __forceinline__ void warp_accumulate(float (&acc)[DC_MAX / 8][4],
                                                const uint32_t (&a)[4][4], const bf16* tile,
                                                int ld, int c0, int nd, int steps, int lane) {
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t >= steps) break;
#pragma unroll
    for (int np = 0; np < DC_MAX / 16; ++np) {
      if (2 * np < nd) {
        uint32_t bv[4];
        const int col = c0 + (2 * np + (lm >> 1)) * 8;
        ldsm_x4_trans(bv, tile + (t * 16 + (lm & 1) * 8 + lr) * ld + col);
        mma_bf16(acc[2 * np], a[t], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], a[t], bv[2], bv[3]);
      }
    }
  }
}

// Key-tile kernel: block (key tile, batch * Hkv, column chunk); warp w owns
// keys 16 w .. 16 w + 15 of the tile.  Per query tile it rebuilds S^T = K
// Q^T and dP^T = V dO^T (keys as rows), then dv += P^T dO and dk += dS^T Q.
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, BwdShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = s.D, ld = D + 8;  // row pitch: ldmatrix's 8 row addresses hit 8 bank groups
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [BT][ld]
  bf16* sv = sk + BT * ld;
  bf16* sq = sv + BT * ld;
  bf16* sdo = sq + BT * ld;
  float* slse = reinterpret_cast<float*>(sdo + BT * ld);  // [BT], log2 units
  float* sdel = slse + BT;                                // [BT]
  constexpr int NDC = DC_MAX / 8;
  constexpr float kLog2e = 1.4426950408889634f;

  const int n0 = blockIdx.x * BT;
  const int hkv = s.H / s.group;
  const int bg = blockIdx.y, b = bg / hkv, g = bg % hkv;
  const int c0 = blockIdx.z * s.dc, nd = min(s.dc, D - c0) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const int n_keys = min(BT, s.Lk - n0);
  const float sl2 = s.scale * kLog2e;

  load_bf16(sk, ld, k + b * s.ks[0] + g * s.ks[1], s.ks[2], n0, n_keys, D);
  load_bf16(sv, ld, v + b * s.vs[0] + g * s.vs[1], s.vs[2], n0, n_keys, D);

  float acc_k[NDC][4], acc_v[NDC][4];
#pragma unroll
  for (int n = 0; n < NDC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int key0 = n0 + warp * 16 + gr;  // this thread's keys: key0 and key0 + 8

  const int m_start = s.causal ? n0 : 0;
  for (int hh = 0; hh < s.group; ++hh) {
    const int h = g * s.group + hh;
    const float* lb = lse + (static_cast<long long>(b) * s.H + h) * s.Lq;
    const float* db = delta + (static_cast<long long>(b) * s.H + h) * s.Lq;
    for (int m0 = m_start; m0 < s.Lq; m0 += BT) {
      const int n_q = min(BT, s.Lq - m0);
      __syncthreads();  // the previous tile's sq and sdo are consumed
      load_bf16(sq, ld, q + b * s.qs[0] + h * s.qs[1], s.qs[2], m0, n_q, D);
      load_bf16(sdo, ld, dout + b * s.dos[0] + h * s.dos[1], s.dos[2], m0, n_q, D);
      if (threadIdx.x < BT) {
        slse[threadIdx.x] = threadIdx.x < n_q ? lb[m0 + threadIdx.x] * kLog2e : 0.f;
        sdel[threadIdx.x] = threadIdx.x < n_q ? db[m0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      // P^T (keys as rows, queries as columns), zero under the mask
      float st[8][4];
      warp_scores(st, sk, sq, ld, D, warp, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = j * 8 + 2 * t4 + (e & 1), qpos = m0 + ql;
          const int key = key0 + 8 * (e >> 1);
          const bool keep = key < s.Lk && qpos < s.Lq && (!s.causal || qpos >= key);
          st[j][e] = keep ? exp2f(fmaf(st[j][e], sl2, -slse[ql])) : 0.f;
        }
      float dpt[8][4];
      warp_scores(dpt, sv, sdo, ld, D, warp, lane);
      uint32_t pa[4][4], dsa[4][4];  // A fragments over the query dim (k = query)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = st[j][e] * (dpt[j][e] - sdel[j * 8 + 2 * t4 + (e & 1)]);
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(st[j][0], st[j][1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(st[j][2], st[j][3]);
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      const int steps = (n_q + 15) / 16;
      warp_accumulate(acc_v, pa, sdo, ld, c0, nd, steps, lane);
      warp_accumulate(acc_k, dsa, sq, ld, c0, nd, steps, lane);
    }
  }

  bf16* dkb = dk + b * s.dks[0] + g * s.dks[1];
  bf16* dvb = dv + b * s.dvs[0] + g * s.dvs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s.Lk) continue;
#pragma unroll
    for (int n = 0; n < NDC; ++n) {
      if (n < nd) {
        const int c = c0 + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dkb + key * s.dks[2] + c) =
            pack_bf16(acc_k[n][2 * r] * s.scale, acc_k[n][2 * r + 1] * s.scale);
        *reinterpret_cast<uint32_t*>(dvb + key * s.dvs[2] + c) =
            pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      }
    }
  }
}

// Query-tile kernel: block (query tile, batch * H, column chunk); warp w
// owns queries 16 w .. 16 w + 15.  Per key tile it rebuilds S = Q K^T and
// dP = dO V^T, then dq += dS K.
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, BwdShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = s.D, ld = D + 8;
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BT][ld]
  bf16* sdo = sq + BT * ld;
  bf16* sk = sdo + BT * ld;
  bf16* sv = sk + BT * ld;
  constexpr int NDC = DC_MAX / 8;
  constexpr float kLog2e = 1.4426950408889634f;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;  // the longest causal blocks first
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, g = h / s.group;
  const int c0 = blockIdx.z * s.dc, nd = min(s.dc, D - c0) / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  const float sl2 = s.scale * kLog2e;
  const bf16* kb = k + b * s.ks[0] + g * s.ks[1];
  const bf16* vb = v + b * s.vs[0] + g * s.vs[1];

  load_bf16(sq, ld, q + b * s.qs[0] + h * s.qs[1], s.qs[2], m0, min(BT, s.Lq - m0), D);
  load_bf16(sdo, ld, dout + b * s.dos[0] + h * s.dos[1], s.dos[2], m0, min(BT, s.Lq - m0), D);
  const int q0 = m0 + warp * 16 + gr;  // this thread's queries: q0 and q0 + 8
  float row_lse[2], row_del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + 8 * r;
    row_lse[r] = qpos < s.Lq ? lse[static_cast<long long>(bh) * s.Lq + qpos] * kLog2e : 0.f;
    row_del[r] = qpos < s.Lq ? delta[static_cast<long long>(bh) * s.Lq + qpos] : 0.f;
  }

  float acc[NDC][4];
#pragma unroll
  for (int n = 0; n < NDC; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_end = s.causal ? min(s.Lk, m0 + BT) : s.Lk;
  for (int n0 = 0; n0 < n_end; n0 += BT) {
    const int n_keys = min(BT, s.Lk - n0);
    __syncthreads();  // the previous tile's sk and sv are consumed
    load_bf16(sk, ld, kb, s.ks[2], n0, n_keys, D);
    load_bf16(sv, ld, vb, s.vs[2], n0, n_keys, D);
    __syncthreads();

    float sc[8][4], dp[8][4];
    warp_scores(sc, sq, sk, ld, D, warp, lane);
    warp_scores(dp, sdo, sv, ld, D, warp, lane);
    uint32_t dsa[4][4];  // A fragments over the key dim (k = key)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t4 + (e & 1), r = e >> 1, qpos = q0 + 8 * r;
        const bool keep = key < s.Lk && qpos < s.Lq && (!s.causal || qpos >= key);
        const float p = keep ? exp2f(fmaf(sc[j][e], sl2, -row_lse[r])) : 0.f;
        ds[e] = p * (dp[j][e] - row_del[r]);
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    warp_accumulate(acc, dsa, sk, ld, c0, nd, (n_keys + 15) / 16, lane);
  }

  bf16* dqb = dq + b * s.dqs[0] + h * s.dqs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + 8 * r;
    if (qpos >= s.Lq) continue;
#pragma unroll
    for (int n = 0; n < NDC; ++n) {
      if (n < nd) {
        *reinterpret_cast<uint32_t*>(dqb + qpos * s.dqs[2] + c0 + n * 8 + 2 * t4) =
            pack_bf16(acc[n][2 * r] * s.scale, acc[n][2 * r + 1] * s.scale);
      }
    }
  }
}

// ---- bf16, D in {64, 80, 128}: wgmma and TMA ----------------------------------
// FlashAttention-3's pieces on two kernels, each output with one owner.
//   * flash_bwd_dq_wgmma_kernel runs first: a block owns 128 queries of one
//     (batch, head), K6's forward shape: a producer warpgroup loads Q, dO
//     and O once and K and V tiles of 64 keys through a ring; two consumer
//     warpgroups form delta = rowsum(dO * O) from shared memory, write it
//     and lse * log2(e) for the other kernel, then rebuild S = Q K^T and
//     dP = dO V^T tile by tile, form dS and add dS K into dq.
//   * flash_bwd_dkdv_wgmma_kernel: a block owns 128 keys of one (batch, kv
//     head), warpgroups 0 and 1 64 keys each, and walks every 64-query tile
//     of every query head of its group.  Thread 0 issues the TMA loads: K
//     and V once, Q and dO tiles (with their lse * log2(e) and delta rows)
//     through a ring of STAGES stages, each refilled once every thread has
//     released it (full and empty mbarriers).  A tile takes four products:
//     S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16 from shared memory; P^T
//     is computed while dP^T runs), then dV += P^T dO and dK += dS^T Q (P^T
//     and dS^T as bf16 register fragments).  dK and dV stay in registers
//     and are stored once.  256 threads and no producer warpgroup: ptxas
//     gives such a block 255 registers a thread, and the consumers need
//     about 232 (dK and dV hold D / 2 each); with a producer warpgroup and
//     setmaxnreg ptxas kept them under about 200, spilled, and serialized
//     the wgmmas.
// Tiles are stored as in the forward (hopper.cuh): at D = 80 two swizzled
// chunks a row, columns 80-127 zeros that TMA writes and no product reads.
// S^T, dP^T, S and dP take D / 16 = 5 k steps; dV, dK and dQ are m64n80k16
// (40 accumulator registers a thread for each, 64 at D = 128).  Keeping a
// tile's dV and dK (or dQ) products in flight while the next tile's scores
// are issued, which those registers would allow, made ptxas serialize every
// wgmma (C7515) and measured slower (PERF.md, Findings).
// Below the bound (PERF.md, Findings) each warpgroup runs its products, its
// exponentials and its waits in turn; and by count the key-tile kernel's
// S^T and dP^T (m64n64k16, both operands from shared memory: 4 KB an
// instruction of 32 tensor clocks) ask for shared memory at about its
// 128 bytes a clock (not measured apart).
namespace wgb {

using namespace hopper;

constexpr int BN = 128;       // keys a block (two consumer warpgroups of 64)
constexpr int BM = 64;        // queries a tile
constexpr int STAGES = 3;     // Q/dO tiles in the ring
constexpr int THREADS = 256;  // two consumer warpgroups; thread 0 also loads
constexpr float kLog2e = 1.4426950408889634f;

struct Work {
  int n_bg, n_qt, pitch;  // batch * Hkv; query tiles of BM; rows of lse2 and delta
  const float* lse;       // the forward's [B * H][Lq]
  float* lse2;            // [B * H][pitch]: lse * log2(e), +inf past Lq (the dQ kernel writes it)
  float* delta;           // [B * H][pitch]: rowsum(dO * O), 0 past Lq (the dQ kernel writes it)
  bf16* dk;
  bf16* dv;
};

// `bytes` (a multiple of 16) from global to shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// P^T over one 64 x 64 tile of S^T, in place (a wgmma accumulator: this
// thread holds keys key0 and key0 + 8, queries q0 + 8 j + 2 t4 + {0, 1};
// element 4 j + e at key key0 + 8 (e >> 1), query ... + (e & 1)), from the
// tile's lse2 row in shared memory.  MASK: the tile holds a masked pair (a
// key past Lk, or a key after a query under the causal mask).
template <bool MASK>
__device__ __forceinline__ void p_tile(float (&st)[32], const float* lse2, int key0, int q0,
                                       int t4, int Lk, int causal, float sl2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(st[4 * j + e], sl2, -((e & 1) ? l.y : l.x)));
      if (MASK) {
        const int key = key0 + 8 * (e >> 1), q = q0 + 8 * j + 2 * t4 + (e & 1);
        if (key >= Lk || (causal && key > q)) p = 0.f;
      }
      st[4 * j + e] = p;
    }
  }
}

// accumulator (64 x 64) -> bf16 A fragments over its columns (k = column)
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// Block x: key tile x / n_bg of bg = x % n_bg (batch * Hkv + kv head), so
// key tile 0 of every bg, under the causal mask the longest, starts first.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, const BwdShape s,
                            const Work w) {
  constexpr int NCH = chunks(D);
  constexpr int KV = BN * chunk_cols(D);  // elements of the K (or V) tile
  constexpr int QT = BM * chunk_cols(D);  // elements of a Q (or dO) tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kv_full;
  __shared__ __align__(16) float slse[STAGES][BM], sdel[STAGES][BM];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on 1024
  bf16* sk = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  bf16* sv = sk + KV;
  bf16* sq = sv + KV;  // stage st: sq + st QT
  bf16* sdo = sq + STAGES * QT;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int j = blockIdx.x / w.n_bg, bg = blockIdx.x % w.n_bg;
  const int hkv = s.H / s.group, b = bg / hkv, g = bg % hkv;
  const int i0 = s.causal ? j * BN / BM : 0;  // queries before the tile's first key are masked
  const int per = w.n_qt - i0, tiles = s.group * per;
  const float sl2 = s.scale * kLog2e;
  const bf16* kw = sk + wg * 64 * CHUNK;  // this warpgroup's K and V rows, chunk 0
  const bf16* vw = sv + wg * 64 * CHUNK;

  // tile t (query head g group + t / per, query tile i0 + t % per) into
  // stage t % STAGES: Q and dO boxes, lse2 and delta rows
  auto issue = [&](int t) {
    const int h = g * s.group + t / per, i = i0 + t % per, st = t % STAGES;
    mbar_expect_tx(&full[st], 2 * QT * 2 + 2 * BM * 4);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load(sq + st * QT + c * BM * CHUNK, &tq, &full[st], c * CHUNK, i * BM, h, b);
      tma_load(sdo + st * QT + c * BM * CHUNK, &tdo, &full[st], c * CHUNK, i * BM, h, b);
    }
    const long long row = static_cast<long long>(b * s.H + h) * w.pitch + i * BM;
    bulk_load(slse[st], w.lse2 + row, BM * 4, &full[st]);
    bulk_load(sdel[st], w.delta + row, BM * 4, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], THREADS);  // every thread releases the stage
    }
    mbar_init(&kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&kv_full, 2 * KV * 2);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = c * BN * CHUNK + half * 64 * CHUNK;
        tma_load(sk + off, &tk, &kv_full, c * CHUNK, j * BN + half * 64, g, b);
        tma_load(sv + off, &tv, &kv_full, c * CHUNK, j * BN + half * 64, g, b);
      }
    }
    for (int t = 0; t < STAGES && t < tiles; ++t) issue(t);
  }
  __syncthreads();  // the barriers are initialised

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
  const int k0 = j * BN + wg * 64;
  const int key0 = k0 + warp * 16 + g8;  // this thread's keys: key0 and key0 + 8
  mbar_wait(&kv_full, 0);

  for (int t = 0; t < tiles; ++t) {
    const int m0 = (i0 + t % per) * BM, st = t % STAGES;
    mbar_wait(&full[st], (t / STAGES) & 1);
    const bf16* cq = sq + st * QT;
    const bf16* cdo = sdo + st * QT;

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, both operands
    // K-major (k steps of 16 walk 32 bytes along a swizzled row); P^T is
    // computed while dP^T runs, then dS^T, then both as bf16 fragments
    float sT[32], dpT[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BN * CHUNK + (kk % 4) * 16;
      const int oq = (kk / 4) * BM * CHUNK + (kk % 4) * 16;
      wgmma_ss_n64(sT, desc(kw + ok, 16, 1024), desc(cq + oq, 16, 1024), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int ok = (kk / 4) * BN * CHUNK + (kk % 4) * 16;
      const int oq = (kk / 4) * BM * CHUNK + (kk % 4) * 16;
      wgmma_ss_n64(dpT, desc(vw + ok, 16, 1024), desc(cdo + oq, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_one();  // S^T is in; dP^T may still run
    fence_regs(sT);
    if (k0 + 64 > s.Lk || (s.causal && k0 + 63 > m0)) {
      p_tile<true>(sT, slse[st], key0, m0, t4, s.Lk, s.causal, sl2);
    } else {
      p_tile<false>(sT, slse[st], key0, m0, t4, s.Lk, s.causal, sl2);
    }
    wg_wait_all();
    fence_regs(dpT);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 dl = *reinterpret_cast<const float2*>(sdel[st] + 8 * jj + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpT[4 * jj + e] = sT[4 * jj + e] * (dpT[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_frags(pa, sT);
    to_frags(dsa, dpT);

    // dV += P^T dO and dK += dS^T Q: A from registers (k = query), B
    // MN-major: k steps of 16 queries are 2048 bytes apart, chunks BM rows
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rs_mma<D>(dv, pa[kk], desc(cdo + kk * 16 * CHUNK, BM * CHUNK * 2, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rs_mma<D>(dk, dsa[kk], desc(cq + kk * 16 * CHUNK, BM * CHUNK * 2, 1024));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && t + STAGES < tiles) {  // refill the stage once every thread is done
      mbar_wait(&empty[st], (t / STAGES) & 1);
      issue(t + STAGES);
    }
  }

  bf16* dkb = w.dk + b * s.dks[0] + g * s.dks[1];
  bf16* dvb = w.dv + b * s.dvs[0] + g * s.dvs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s.Lk) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int c = jj * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkb + key * s.dks[2] + c) =
          pack_bf16(dk[4 * jj + 2 * r] * s.scale, dk[4 * jj + 2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dvb + key * s.dvs[2] + c) =
          pack_bf16(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
    }
  }
}

// The query-tile dQ kernel: 128 queries a block (warpgroup wg owns 64), Q,
// dO and O loaded once (O for delta), K and V tiles of 64 keys through a
// ring; S = Q K^T, dP = dO V^T, dS, dq += dS K.  setmaxnreg moves registers from the
// producer (24 a thread) to the consumers (240), which need fewer than 168.
constexpr int DQ_BM = 128, DQ_BN = 64, DQ_STAGES = 3, DQ_THREADS = 384;

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap to, const BwdShape s,
                          const Work w, bf16* __restrict__ dq) {
  constexpr int NCH = chunks(D);
  constexpr int QT = DQ_BM * chunk_cols(D), KT = DQ_BN * chunk_cols(D);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[DQ_STAGES], empty[DQ_STAGES];
  bf16* sq = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  bf16* sdo = sq + QT;
  bf16* so = sdo + QT;  // O, for delta
  bf16* sk = so + QT;   // stage st: sk + 2 st KT, sv = sk + KT
  const int m0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;  // the longest causal blocks first
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H, g_kv = h / s.group;
  const int n_end = s.causal ? min(s.Lk, m0 + DQ_BM) : s.Lk;
  const int n_tiles = (n_end + DQ_BN - 1) / DQ_BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&bar_q, 3 * QT * 2);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = c * DQ_BM * CHUNK + half * 64 * CHUNK;
          tma_load(sq + off, &tq, &bar_q, c * CHUNK, m0 + half * 64, h, b);
          tma_load(sdo + off, &tdo, &bar_q, c * CHUNK, m0 + half * 64, h, b);
          tma_load(so + off, &to, &bar_q, c * CHUNK, m0 + half * 64, h, b);
        }
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % DQ_STAGES;
        mbar_wait(&empty[st], ((n / DQ_STAGES) & 1) ^ 1);
        bf16* ck = sk + 2 * st * KT;
        mbar_expect_tx(&full[st], 2 * KT * 2);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load(ck + c * DQ_BN * CHUNK, &tk, &full[st], c * CHUNK, n * DQ_BN, g_kv, b);
          tma_load(ck + KT + c * DQ_BN * CHUNK, &tv, &full[st], c * CHUNK, n * DQ_BN, g_kv, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int row0 = m0 + wg * 64 + warp * 16 + g8;  // and row0 + 8
  const float sl2 = s.scale * kLog2e;
  const bf16* qw = sq + wg * 64 * CHUNK;
  const bf16* dow = sdo + wg * 64 * CHUNK;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  // delta = rowsum(dO * O) for this thread's rows row0 and row0 + 8: the four
  // threads of a row each take two 16-byte units of every chunk (O and dO
  // share the swizzle, so the units pair up as stored; at D = 80 the zeros
  // past column 80 add nothing); rows past Lq are zeros.  Then lse *
  // log2(e), +inf past Lq, and both written for the key-tile kernel, which
  // runs next.
  mbar_wait(&bar_q, 0);
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = wg * 64 + warp * 16 + g8 + 8 * r, row = m0 + rl;
    float x = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int u = t4; u < 8; u += 4) {
        const int off = c * DQ_BM * CHUNK + rl * CHUNK + u * 8;
        const uint4 a = *reinterpret_cast<const uint4*>(so + off);
        const uint4 d = *reinterpret_cast<const uint4*>(sdo + off);
        const uint32_t as[4] = {a.x, a.y, a.z, a.w}, ds[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&as[e]));
          const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ds[e]));
          x = fmaf(af.x, df.x, fmaf(af.y, df.y, x));
        }
      }
    }
    x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
    x += __shfl_xor_sync(0xFFFFFFFFu, x, 2);
    dl[r] = x;
    l2[r] = row < s.Lq ? w.lse[static_cast<long long>(bh) * s.Lq + row] * kLog2e
                       : __int_as_float(0x7f800000);
    if (t4 == 0) {
      const long long at = static_cast<long long>(bh) * w.pitch + row;
      w.delta[at] = dl[r];
      w.lse2[at] = l2[r];
    }
  }

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % DQ_STAGES;
    mbar_wait(&full[st], (n / DQ_STAGES) & 1);
    const bf16* ck = sk + 2 * st * KT;
    const bf16* cv = ck + KT;
    const int n0 = n * DQ_BN;
    float sc[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int oq = (kk / 4) * DQ_BM * CHUNK + (kk % 4) * 16;
      const int ok = (kk / 4) * DQ_BN * CHUNK + (kk % 4) * 16;
      wgmma_ss_n64(sc, desc(qw + oq, 16, 1024), desc(ck + ok, 16, 1024), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int oq = (kk / 4) * DQ_BM * CHUNK + (kk % 4) * 16;
      const int ok = (kk / 4) * DQ_BN * CHUNK + (kk % 4) * 16;
      wgmma_ss_n64(dp, desc(dow + oq, 16, 1024), desc(cv + ok, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    const bool mask = n0 + DQ_BN > s.Lk || (s.causal && n0 + DQ_BN - 1 > m0 + wg * 64);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      float p = ex2(fmaf(sc[e], sl2, -l2[r]));
      if (mask) {
        const int key = n0 + 8 * (e >> 2) + 2 * t4 + (e & 1), row = row0 + 8 * r;
        if (key >= s.Lk || (s.causal && key > row)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dl[r]);
    }
    uint32_t dsa[4][4];
    to_frags(dsa, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      rs_mma<D>(acc, dsa[kk], desc(ck + kk * 16 * CHUNK, DQ_BN * CHUNK * 2, 1024));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

  bf16* dqb = dq + b * s.dqs[0] + h * s.dqs[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s.Lq) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(dqb + row * s.dqs[2] + jj * 8 + 2 * t4) =
          pack_bf16(acc[4 * jj + 2 * r] * s.scale, acc[4 * jj + 2 * r + 1] * s.scale);
    }
  }
}

}  // namespace wgb

// ---- launch -------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* delta, float* dq, float* dk, float* dv,
               int B, const BwdShape& s, cudaStream_t st) {
  const int nz = (s.D + s.dc - 1) / s.dc, hkv = s.H / s.group;
  flash_bwd_delta_kernel<float><<<dim3((s.Lq + 7) / 8, B * s.H), 256, 0, st>>>(o, dout, delta, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tile = static_cast<size_t>(FT) * (s.D + 1) * sizeof(float);
  const size_t kv_bytes = 4 * tile + (2 * FT * (FT + 1) + 2 * FT) * sizeof(float);
  if ((err = allow_smem(flash_bwd_dkdv_f32_kernel, kv_bytes)) != cudaSuccess) return err;
  flash_bwd_dkdv_f32_kernel<<<dim3((s.Lk + FT - 1) / FT, B * hkv, nz), F_THREADS, kv_bytes, st>>>(
      q, k, v, dout, lse, delta, dk, dv, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t q_bytes = 4 * tile + FT * (FT + 1) * sizeof(float);
  if ((err = allow_smem(flash_bwd_dq_f32_kernel, q_bytes)) != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<<<dim3((s.Lq + FT - 1) / FT, B * s.H, nz), F_THREADS, q_bytes, st>>>(
      q, k, v, dout, lse, delta, dq, s);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B,
                const BwdShape& s, cudaStream_t st) {
  const int nz = (s.D + s.dc - 1) / s.dc, hkv = s.H / s.group;
  flash_bwd_delta_kernel<bf16><<<dim3((s.Lq + 7) / 8, B * s.H), 256, 0, st>>>(o, dout, delta, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tile = static_cast<size_t>(BT) * (s.D + 8) * sizeof(bf16);
  const size_t kv_bytes = 4 * tile + 2 * BT * sizeof(float);
  if ((err = allow_smem(flash_bwd_dkdv_bf16_kernel, kv_bytes)) != cudaSuccess) return err;
  flash_bwd_dkdv_bf16_kernel<<<dim3((s.Lk + BT - 1) / BT, B * hkv, nz), MMA_THREADS, kv_bytes,
                               st>>>(q, k, v, dout, lse, delta, dk, dv, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t q_bytes = 4 * tile;
  if ((err = allow_smem(flash_bwd_dq_bf16_kernel, q_bytes)) != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<<<dim3((s.Lq + BT - 1) / BT, B * s.H, nz), MMA_THREADS, q_bytes, st>>>(
      q, k, v, dout, lse, delta, dq, s);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernels: the query-tile dQ kernel, which also writes delta and
// lse2, then the key-tile dK/dV kernel.
template <int D>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                 const float* lse, float* delta, float* lse2, bf16* dq, bf16* dk, bf16* dv,
                 int B, int Hkv, const BwdShape& s, cudaStream_t st) {
  using namespace wgb;
  Work w{};
  w.n_bg = B * Hkv;
  w.n_qt = (s.Lq + BM - 1) / BM;
  w.pitch = (s.Lq + DQ_BM - 1) / DQ_BM * DQ_BM;
  w.lse = lse;
  w.lse2 = lse2;
  w.delta = delta;
  w.dk = dk;
  w.dv = dv;
  CUtensorMap mq, mk, mv, mdo, mo;  // boxes of 64 rows
  CUresult res = hopper::make_map(&mq, q, B, s.H, s.Lq, D, s.qs, 64);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mk, k, B, Hkv, s.Lk, D, s.ks, 64);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mv, v, B, Hkv, s.Lk, D, s.vs, 64);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mdo, dout, B, s.H, s.Lq, D, s.dos, 64);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mo, o, B, s.H, s.Lq, D, s.os, 64);
  if (res != CUDA_SUCCESS) return hopper::kTensorMapError + static_cast<int>(res);
  const size_t dq_bytes = static_cast<size_t>(3 * DQ_BM + 2 * DQ_STAGES * DQ_BN) *
                            hopper::chunk_cols(D) * sizeof(bf16) + 1024;
  const auto fdq = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t err = allow_smem(fdq, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fdq<<<dim3((s.Lq + DQ_BM - 1) / DQ_BM, B * s.H), DQ_THREADS, dq_bytes, st>>>(mq, mk, mv, mdo, mo,
                                                                             s, w, dq);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const size_t bytes =
      static_cast<size_t>(2 * BN + 2 * STAGES * BM) * chunk_cols(D) * sizeof(bf16) + 1024;
  const auto fkv = flash_bwd_dkdv_wgmma_kernel<D>;
  if ((err = allow_smem(fkv, bytes)) != cudaSuccess) return static_cast<int>(err);
  fkv<<<w.n_bg * ((s.Lk + BN - 1) / BN), THREADS, bytes, st>>>(mq, mk, mv, mdo, s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o, dout: the forward's inputs and output and the output's
// gradient, all fp32 (variant 0) or all bf16, the head dimension
// contiguous, D a multiple of 16 in [16, 256].  variant
// (kernels/flash_attention.py, bwd_kernel_variant): 0 = fp32 on the CUDA
// cores, 1 = bf16 with mma.sync, 2 = bf16 with wgmma and TMA (D = 64, 80
// or 128).  lse: the forward's fp32 [B, H, Lq] log-sum-exp, contiguous.
// delta: fp32 scratch, [B, H, Lq] for variants 0 and 1, [B, H, pitch] for
// 2, pitch = Lq rounded up to 128; lse2: fp32 [B, H, pitch] scratch for
// variant 2 (null otherwise).  dq [B, H, Lq, D], dk and dv [B, Hkv, Lk, D]
// in the input type, written whole.  strides: 24 element strides, (batch,
// head, position) of q, k, v, o, dout, dq, dk, dv in turn; for bf16 every
// stride a multiple of 8 and every pointer 16-byte aligned.  dc: the
// columns a block accumulates (a multiple of 16, at most 128:
// kernels/flash_attention.py, BWD_CHUNK; variants 0 and 1).  Returns the
// launches' cudaError_t (0 = launched), or 10000 + the CUresult of a
// tensor map that was refused.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* lse2,
                               void* dq, void* dk, void* dv, int variant, int B, int H, int Hkv,
                               int Lq, int Lk, int D, int dc, const long long* strides,
                               float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lk < 1 || D < 16 || D > 256 ||
      D % 16 != 0 || dc < 16 || dc > DC_MAX || dc % 16 != 0 || (causal && Lq != Lk) ||
      static_cast<long long>(B) * H > 65535 || variant < 0 || variant > 2 ||
      (variant == 2 && ((D != 64 && D != 80 && D != 128) || lse2 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdShape s{};
  s.H = H;
  s.group = H / Hkv;
  s.Lq = Lq;
  s.Lk = Lk;
  s.D = D;
  s.dc = dc;
  s.causal = causal ? 1 : 0;
  s.scale = scale;
  long long* dst[8] = {s.qs, s.ks, s.vs, s.os, s.dos, s.dqs, s.dks, s.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* del = static_cast<float*>(delta);
  if (variant == 2) {
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    const auto* ob = static_cast<const bf16*>(o);
    const auto* db = static_cast<const bf16*>(dout);
    auto* l2 = static_cast<float*>(lse2);
    auto* dqb = static_cast<bf16*>(dq);
    auto* dkb = static_cast<bf16*>(dk);
    auto* dvb = static_cast<bf16*>(dv);
    if (D == 64)
      return launch_wgmma<64>(qb, kb, vb, ob, db, l, del, l2, dqb, dkb, dvb, B, Hkv, s, st);
    if (D == 80)
      return launch_wgmma<80>(qb, kb, vb, ob, db, l, del, l2, dqb, dkb, dvb, B, Hkv, s, st);
    return launch_wgmma<128>(qb, kb, vb, ob, db, l, del, l2, dqb, dkb, dvb, B, Hkv, s, st);
  }
  if (variant == 1) {
    return launch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                       static_cast<const bf16*>(dout), l, del, static_cast<bf16*>(dq),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, s, st);
  }
  return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<const float*>(o),
                    static_cast<const float*>(dout), l, del, static_cast<float*>(dq),
                    static_cast<float*>(dk), static_cast<float*>(dv), B, s, st);
}

}  // extern "C"
