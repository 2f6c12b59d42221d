// FlashAttention forward for Hopper (sm_90a): for q [B, H, Lq, D] and k, v
// [B, Hkv, Lk, D] (fp32 or bf16, any strides over batch, head and position,
// the head dimension contiguous), o [B, H, Lq, D] in q's type with
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j],
// g = h / (H / Hkv) (grouped-query attention), and under `causal` the keys
// with j > i masked (start-aligned: the wrapper holds Lq == Lk).
//
// Replaces the Pallas TPU kernel flash_attention_pallas / _flash_kernel
// (repro/kernels/flash_attention.py).  What it keeps from it: scores, the
// softmax and the accumulator in fp32 (for bf16, see below); masked scores
// are the finite -1e30 and p is zeroed under the mask, so a tile whose keys
// are all masked for a row adds nothing and never makes exp(-inf - -inf) =
// NaN; l == 0 divides by 1 at the end (the safe_l guard); key tiles wholly
// above the diagonal are skipped.
//
// What differs: the TPU grid walks the key blocks in order and carries the
// running max, denominator and accumulator in VMEM scratch across grid
// steps.  Blocks here run in parallel in no order, so each block owns a
// tile of queries of one (batch, head) and loops over the key tiles itself,
// with the running max, denominator and accumulator in registers.  GQA is
// the block's own index arithmetic; ragged lengths are masked in the kernel
// (no padding to the block size).
//
// What bounds it on this card: operations, 4 * D per (query, key) pair that
// the mask keeps (two products), against q, k, v and o moved once.  Three
// kernels; the wrapper chooses by dtype and D (kernels/flash_attention.py,
// kernel_variant) and passes the choice on:
//   * fp32, any D: FMAs on the CUDA cores (67 TFLOP/s at most), 64 queries a
//     block, 4 x 4 scores per thread; no TF32, so it agrees with the plain
//     version to 2e-5.  The parity path of the fp32 checks;
//   * bf16, D = 64, 80 or 128 (the FlashAttention-3 shape, namespace wg below):
//     128 queries a block, two consumer warpgroups of 64 rows and a
//     producer warpgroup whose one thread issues the TMA loads: Q once, K
//     and V through a ring of three 128-key stages with full and empty
//     mbarriers, so the next tiles are in flight while the consumers
//     compute.  S = Q K^T and O += P V are wgmma.mma_async m64n128k16 /
//     m64nDk16 with fp32 accumulators, Q, K and V read from shared memory in
//     the 128-byte swizzle that TMA writes, P from registers; setmaxnreg
//     moves registers from the producer to the consumers.  The online
//     softmax works in log2 units (exp2 with scale * log2(e) folded into one
//     multiply), masks only the diagonal and the ragged last tile, and the
//     epilogue stages O in the warpgroup's Q rows for 16-byte stores.  At
//     D = 80 (hubert-xlarge, Zamba2's shared block) a row is two swizzled
//     chunks, the second holding columns 64-79 and zeros that TMA writes
//     (hopper.cuh): S takes five k steps of 16, and O += P V is
//     m64n80k16, so the products run at 80 and not at 128.  A second
//     score tile in the registers this frees, for FlashAttention-3's
//     overlap of the next tile's S with this tile's softmax, spilled and
//     made ptxas serialize the wgmmas (PERF.md, Findings);
//   * bf16, other D (16 to 256): mma.sync m16n8k16 with ldmatrix fragments,
//     64 queries a block and 64-key tiles loaded by every thread.
// In both bf16 kernels the scores are exact products of the bf16 inputs
// summed in fp32, as the TPU kernel's fp32 products of widened inputs are;
// p is rounded to bf16 before P.V (the TPU kernel keeps it fp32), a relative
// error of at most 2^-9 per weight, while the row sums l stay fp32.
//
// Each kernel also writes, where the caller passes a buffer (`lse`, fp32
// [B, H, Lq]; the training path asks for it, serving does not), each
// query row's log-sum-exp of its scaled scores, m + log(l) in natural
// units: the backward (csrc/flash_attention_bwd.cu) rebuilds P from it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;            // queries per block
constexpr int BN = 64;            // keys per tile
constexpr int THREADS = 256;      // fp32: 16 x 16, thread (ty, tx) owns rows 4ty..4ty+3
constexpr int MMA_THREADS = 128;  // bf16: 4 warps, warp w owns rows 16w..16w+15
constexpr float kMasked = -1e30f;

struct Shape {
  int H, group, Lq, Lk, D, causal;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];  // strides of batch, head, position
};

// sum or max over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// a row's log-sum-exp from its running max m and sum l (natural units); a
// row with no live key (l == 0) gets +inf, so that exp(s - lse) is 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

// ---- fp32: CUDA cores -------------------------------------------------------
// DMAX bounds D (a multiple of 16): the thread keeps DMAX / 16 output
// columns of each of its rows in registers, column tx + 16 jj.
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Shape s) {
  extern __shared__ float smem[];
  const int D = s.D;
  const int ld = D + 1;  // odd row pitch: a column read hits 16 banks
  float* sq = smem;             // [BM][ld]
  float* sk = sq + BM * ld;     // [BN][ld]
  float* sv = sk + BN * ld;     // [BN][ld]
  float* sp = sv + BN * ld;     // [BM][BN + 1]
  constexpr int NJ = DMAX / 16;
  const int nj = D / 16;

  // the longest (causal) query blocks start first
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / s.H, h = bh % s.H, g = h / s.group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * s.qs[0] + h * s.qs[1];
  const float* kb = k + b * s.ks[0] + g * s.ks[1];
  const float* vb = v + b * s.vs[0] + g * s.vs[1];

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int row = m0 + r;
    sq[r * ld + c] = row < s.Lq ? qb[row * s.qs[2] + c] : 0.f;
  }

  float acc[4][NJ];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  // keys past the block's last query are masked for every row: skip them
  const int n_end = s.causal ? min(s.Lk, m0 + BM) : s.Lk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's sk, sv and sp are consumed
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int key = n0 + r;
      const bool in = key < s.Lk;  // a ragged tile's rows are zero, not garbage
      sk[r * ld + c] = in ? kb[key * s.ks[2] + c] : 0.f;
      sv[r * ld + c] = in ? vb[key * s.vs[2] + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(4 * ty + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax over this tile, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = m0 + 4 * ty + i;
      bool keep[4];
      float tile_max = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = n0 + tx + 16 * j;
        keep[j] = kpos < s.Lk && (!s.causal || qpos >= kpos);
        sc[i][j] = keep[j] ? sc[i][j] * s.scale : kMasked;
        tile_max = fmaxf(tile_max, sc[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(tile_max));
      const float alpha = expf(m_i[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(sc[i][j] - m_new) : 0.f;
        sp[(4 * ty + i) * (BN + 1) + tx + 16 * j] = p;
        p_sum += p;
      }
      l_i[i] = alpha * l_i[i] + half_warp_sum(p_sum);
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    const int n_keys = min(BN, s.Lk - n0);
    for (int c = 0; c < n_keys; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(4 * ty + i) * (BN + 1) + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj < nj) {
          const float vv = sv[c * ld + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

  float* ob = o + b * s.os[0] + h * s.os[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= s.Lq) continue;
    const float safe_l = l_i[i] > 0.f ? l_i[i] : 1.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (jj < nj) ob[row * s.os[2] + tx + 16 * jj] = acc[i][jj] / safe_l;
    }
    if (lse != nullptr && tx == 0) {
      lse[static_cast<long long>(bh) * s.Lq + row] = row_lse(m_i[i], l_i[i]);
    }
  }
}

// ---- bf16: tensor cores ----------------------------------------------------
using bf16 = __nv_bfloat16;

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

// rows [row0, row0 + 64) of a [L, D] slab with row pitch `stride` into a
// [64][ld] shared tile, 16 bytes a load; rows past `valid` are zero.  The
// wrapper holds every stride to a multiple of 8 elements and every base to
// 16 bytes.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long stride,
                                          int row0, int valid, int D) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < BM * chunks; i += MMA_THREADS) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Fragment layouts are those of mma.m16n8k16 (PTX ISA): lane = 4 g + t; an
// accumulator holds (row g, cols 2t, 2t+1) and (row g + 8, the same cols).
// DMAX bounds D: a warp keeps DMAX / 8 output tiles of 16 x 8 in registers.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = s.D;
  const int ld = D + 8;  // row pitch: ldmatrix's 8 row addresses hit 8 bank groups
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BM][ld]
  bf16* sk = sq + BM * ld;                        // [BN][ld]
  bf16* sv = sk + BN * ld;                        // [BN][ld]
  constexpr int ND = DMAX / 8;
  const int nd = D / 8;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest blocks first
  const int bh = blockIdx.y;
  const int b = bh / s.H, h = bh % s.H, g_kv = h / s.group;
  const bf16* qb = q + b * s.qs[0] + h * s.qs[1];
  const bf16* kb = k + b * s.ks[0] + g_kv * s.ks[1];
  const bf16* vb = v + b * s.vs[0] + g_kv * s.vs[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane's address

  load_tile(sq, ld, qb, s.qs[2], m0, min(BM, s.Lq - m0), D);

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};
  const int qrow = m0 + warp * 16 + g;  // and qrow + 8

  const int n_end = s.causal ? min(s.Lk, m0 + BM) : s.Lk;
  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // the previous tile's sk and sv are consumed
    load_tile(sk, ld, kb, s.ks[2], n0, min(BN, s.Lk - n0), D);
    load_tile(sv, ld, vb, s.vs[2], n0, min(BN, s.Lk - n0), D);
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, eight 16 x 8 tiles
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + (warp * 16 + (lm & 1) * 8 + lr) * ld + kk * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, sk + ((2 * jp + (lm >> 1)) * 8 + lr) * ld + kk * 16 + (lm & 1) * 8);
        mma_bf16(sc[2 * jp], a, bk[0], bk[1]);
        mma_bf16(sc[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax; the four lanes of a row group share its max and sum
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = n0 + j * 8 + 2 * t4 + (e & 1);
        const bool keep = kpos < s.Lk && (!s.causal || qrow + (e >> 1) * 8 >= kpos);
        sc[j][e] = keep ? sc[j][e] * s.scale : kMasked;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float m_new[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
      m_new[r] = fmaxf(m_r[r], x);
      alpha[r] = expf(m_r[r] - m_new[r]);
    }
    // p, zero under the mask, packed as the A fragments of P V (k = key)
    uint32_t pa[4][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = n0 + j * 8 + 2 * t4 + (e & 1);
        const bool keep = kpos < s.Lk && (!s.causal || qrow + (e >> 1) * 8 >= kpos);
        p[e] = keep ? expf(sc[j][e] - m_new[e >> 1]) : 0.f;
        ps[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xFFFFFFFFu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xFFFFFFFFu, ps[r], 2);
      l_r[r] = alpha[r] * l_r[r] + ps[r];
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V over the 16-key steps that hold a live key
    const int steps = (min(BN, s.Lk - n0) + 15) / 16;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t >= steps) break;
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        if (2 * np < nd) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, sv + (t * 16 + (lm & 1) * 8 + lr) * ld + (2 * np + (lm >> 1)) * 8);
          mma_bf16(oacc[2 * np], pa[t], bv[0], bv[1]);
          mma_bf16(oacc[2 * np + 1], pa[t], bv[2], bv[3]);
        }
      }
    }
  }

  bf16* ob = o + b * s.os[0] + h * s.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= s.Lq) continue;
    const float safe_l = l_r[r] > 0.f ? l_r[r] : 1.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n < nd) {
        *reinterpret_cast<uint32_t*>(ob + row * s.os[2] + n * 8 + 2 * t4) =
            pack_bf16(oacc[n][2 * r] / safe_l, oacc[n][2 * r + 1] / safe_l);
      }
    }
    if (lse != nullptr && t4 == 0) {
      lse[static_cast<long long>(bh) * s.Lq + row] = row_lse(m_r[r], l_r[r]);
    }
  }
}

// ---- bf16, D in {64, 80, 128}: wgmma, TMA and a ring of K/V tiles -----------
// One block owns 128 queries of one (batch, head): warpgroups 0 and 1
// (threads 0-255) consume, 64 query rows each; warpgroup 2 produces, and of
// it one thread issues every TMA load.  setmaxnreg moves registers from the
// producer (24 a thread) to the consumers (240).  Q is loaded once; K and V
// tiles of 128 keys go through a ring of STAGES stages, each with a "K full",
// a "V full" and an "empty" mbarrier, so the producer keeps the next tiles in
// flight while the consumers compute.  Every tile is stored as chunks(D)
// column chunks of [128 rows][64 bf16] with the 128-byte swizzle (hopper.cuh;
// at D = 80 the second chunk's columns 80-127 are zeros that no product
// reads).
namespace wg {

constexpr int BM = 128;       // queries a block (two consumer warpgroups of 64)
constexpr int BN = 128;       // keys a tile
constexpr int STAGES = 3;     // K/V tiles in the ring
constexpr int THREADS = 384;  // two consumer warpgroups and one producer
using namespace hopper;  // CHUNK, mbarriers, TMA, descriptors, wgmma (hopper.cuh)

// Online softmax of one 64 x 128 score tile held as a wgmma accumulator:
// this thread holds rows row0 and row0 + 8, keys n0 + 8 j + 2 t4 + {0, 1}
// for j < 16 (element 4 j + e: row row0 + 8 (e >> 1), key ... + (e & 1)).
// MASK: the tile holds masked keys (the diagonal or the ragged last tile);
// other tiles skip the test.  Writes p, rounded to bf16, as the A fragments
// of P V, and returns the factor that rescales the old accumulator.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], uint32_t (&pa)[8][4], int n0,
                                             int row0, int t4, int Lk, int causal, float sl2) {
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (MASK) {
      const int key = n0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (key >= Lk || (causal && key > row)) sc[i] = kMasked;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = mx[r];
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
    const float m_new = fmaxf(m_r[r], x * sl2);  // in units of log2, scale folded in
    alpha[r] = ex2(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];  // this thread's share of the row sum; the quad adds at the end
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      p[e] = ex2(fmaf(sc[i], sl2, -m_r[e >> 1]));
      if (MASK) {
        const int key = n0 + 8 * j + 2 * t4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= Lk || (causal && key > row)) p[e] = 0.f;
      }
      l_r[e >> 1] += p[e];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                       float* __restrict__ lse, const Shape s) {
  constexpr int NCH = chunks(D);                // swizzled column chunks of a row
  constexpr int TILE = BN * chunk_cols(D);      // elements of a K, V (or the Q) tile
  constexpr uint32_t TILE_BYTES = TILE * 2;     // TMA counts the zeros past D too
  static_assert(BM == BN, "Q and a K/V tile share the chunk layout");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full_k[STAGES], full_v[STAGES], empty[STAGES];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on 1024
  bf16* sq = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  bf16* sk = sq + TILE;              // stage st: sk + 2 st TILE
  bf16* sv = sq + 2 * TILE;          // stage st: sv + 2 st TILE

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / s.H, h = bh % s.H, g_kv = h / s.group;
  // keys past the block's last query are masked for every row: skip them
  const int n_end = s.causal ? min(s.Lk, m0 + BM) : s.Lk;
  const int n_tiles = (n_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty[st], 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&bar_q, TILE_BYTES);  // rows past Lq arrive as zeros and count
#pragma unroll
      for (int c = 0; c < NCH; ++c) tma_load(sq + c * BM * CHUNK, &tq, &bar_q, c * CHUNK, m0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);  // the first round passes at once
        bf16* dk = sk + 2 * st * TILE;
        bf16* dv = sv + 2 * st * TILE;
        mbar_expect_tx(&full_k[st], TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(dk + c * BN * CHUNK, &tk, &full_k[st], c * CHUNK, n * BN, g_kv, b);
        mbar_expect_tx(&full_v[st], TILE_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(dv + c * BN * CHUNK, &tv, &full_v[st], c * CHUNK, n * BN, g_kv, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows m0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = m0 + wg * 64 + warp * 16 + g;  // and row0 + 8
  const float sl2 = s.scale * 1.4426950408889634f;  // scale * log2(e)
  const bf16* sq_w = sq + wg * 64 * CHUNK;           // this warpgroup's rows, chunk 0

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};

  mbar_wait(&bar_q, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % STAGES;
    const uint32_t parity = (n / STAGES) & 1;
    const int n0 = n * BN;
    const bf16* ck = sk + 2 * st * TILE;
    const bf16* cv = sv + 2 * st * TILE;

    // S = Q K^T: 64 x 128, both operands K-major; k steps of 16 walk 32 bytes
    // along a swizzled row, then to the next 64-column chunk (D / 16 steps:
    // five at D = 80)
    float sc[64];
    mbar_wait(&full_k[st], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BM * CHUNK + (kk % 4) * 16;
      wgmma_ss_n128(sc, desc(sq_w + off, 16, 1024), desc(ck + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    float alpha[2];
    uint32_t pa[8][4];
    const bool need_mask = n0 + BN > s.Lk || (s.causal && n0 + BN - 1 > m0 + wg * 64);
    if (need_mask) {
      softmax_tile<true>(sc, m_r, l_r, alpha, pa, n0, row0, t4, s.Lk, s.causal, sl2);
    } else {
      softmax_tile<false>(sc, m_r, l_r, alpha, pa, n0, row0, t4, s.Lk, s.causal, sl2);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V: A = p from registers, B = V, MN-major (transposed): k steps
    // of 16 keys are 2048 bytes apart, the 64-column chunks 16 KB (LBO); N =
    // D (at 80 the B operand reaches 16 columns into the second chunk)
    mbar_wait(&full_v[st], parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      rs_mma<D>(oacc, pa[kk], desc(cv + kk * 16 * CHUNK, BN * CHUNK * 2, 1024));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(oacc);
    mbar_arrive(&empty[st]);
  }

  // ---- epilogue: O / l in bf16, staged in this warpgroup's Q rows (the same
  // swizzled layout), then 16-byte stores through the output's strides ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 1);
    l += __shfl_xor_sync(0xFFFFFFFFu, l, 2);
    inv[r] = 1.f / (l > 0.f ? l : 1.f);  // safe_l: a row with no live key divides by 1
    const int row = row0 + 8 * r;
    if (lse != nullptr && t4 == 0 && row < s.Lq) {
      // m_r is in log2 units with the scale folded in
      lse[static_cast<long long>(bh) * s.Lq + row] = row_lse(m_r[r] * 0.6931471805599453f, l);
    }
  }
  named_sync(1 + wg);  // every warp of this warpgroup is done reading its Q rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = warp * 16 + g + 8 * r;  // row within the warpgroup
      const int unit = (j % 8) ^ (rl & 7);
      bf16* dst = sq + (j / 8) * BM * CHUNK + (wg * 64 + rl) * CHUNK + unit * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(oacc[4 * j + 2 * r] * inv[r], oacc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  named_sync(1 + wg);
  bf16* ob = o + b * s.os[0] + h * s.os[1];
  for (int u = tid; u < 64 * (D / 8); u += 128) {
    const int rl = u / (D / 8), cu = u % (D / 8);
    const int row = m0 + wg * 64 + rl;
    if (row >= s.Lq) continue;
    const bf16* src =
        sq + (cu / 8) * BM * CHUNK + (wg * 64 + rl) * CHUNK + (((cu % 8) ^ (rl & 7)) * 8);
    *reinterpret_cast<uint4*>(ob + row * s.os[2] + cu * 8) = *reinterpret_cast<const uint4*>(src);
  }
}

}  // namespace wg

// ---- launch -----------------------------------------------------------------
template <typename T, typename Kernel>
int launch(Kernel fn, int threads, size_t bytes, const void* q, const void* k, const void* v,
           void* o, float* lse, int B, const Shape& s, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s.Lq + BM - 1) / BM), static_cast<unsigned>(B * s.H));
  fn<<<grid, threads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               const Shape& s, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (static_cast<size_t>(BM + 2 * BN) * (s.D + 1) +
                                        static_cast<size_t>(BM) * (BN + 1));
  return launch<float>(flash_fwd_f32_kernel<DMAX>, THREADS, bytes, q, k, v, o, lse, B, s, st);
}

template <int DMAX>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                const Shape& s, cudaStream_t st) {
  const size_t bytes = sizeof(bf16) * static_cast<size_t>(BM + 2 * BN) * (s.D + 8);
  return launch<bf16>(flash_fwd_bf16_kernel<DMAX>, MMA_THREADS, bytes, q, k, v, o, lse, B, s,
                      st);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int Hkv, const Shape& s, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  CUresult res = hopper::make_map(&mq, q, B, s.H, s.Lq, D, s.qs, wg::BM);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mk, k, B, Hkv, s.Lk, D, s.ks, wg::BN);
  if (res == CUDA_SUCCESS) res = hopper::make_map(&mv, v, B, Hkv, s.Lk, D, s.vs, wg::BN);
  if (res != CUDA_SUCCESS) return hopper::kTensorMapError + static_cast<int>(res);
  const size_t bytes = static_cast<size_t>(1 + 2 * wg::STAGES) * wg::BN * hopper::chunk_cols(D) *
                           sizeof(bf16) + 1024;  // + alignment
  const auto fn = wg::flash_fwd_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s.Lq + wg::BM - 1) / wg::BM),
                  static_cast<unsigned>(B * s.H));
  fn<<<grid, wg::THREADS, bytes, st>>>(mq, mk, mv, static_cast<bf16*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers, all fp32 (variant 0) or all bf16 (1, 2).
// variant (kernels/flash_attention.py, kernel_variant): 0 = fp32 on the
// CUDA cores, 1 = bf16 with mma.sync (D a multiple of 16 up to 256),
// 2 = bf16 with wgmma and TMA (D = 64, 80 or 128).
// lse: null, or fp32 [B, H, Lq] contiguous for each row's log-sum-exp.
// strides: 12 element strides, (batch, head, position) of q, k, v and o in
// turn; the head dimension is contiguous in all four.  For bf16 every
// stride is a multiple of 8 and every pointer 16-byte aligned.  Returns the
// launch's cudaError_t (0 = launched), or 10000 + the CUresult of a tensor
// map that was refused.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* lse_out,
                           int variant,
                           int B, int H, int Hkv, int Lq, int Lk, int D,
                           const long long* strides, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lk < 1 || D < 16 ||
      D > 256 || D % 16 != 0 || (causal && Lq != Lk) || static_cast<long long>(B) * H > 65535 ||
      variant < 0 || variant > 2 || (variant == 2 && D != 64 && D != 80 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{};
  s.H = H;
  s.group = H / Hkv;
  s.Lq = Lq;
  s.Lk = Lk;
  s.D = D;
  s.causal = causal ? 1 : 0;
  s.scale = scale;
  for (int i = 0; i < 3; ++i) {
    s.qs[i] = strides[i];
    s.ks[i] = strides[3 + i];
    s.vs[i] = strides[6 + i];
    s.os[i] = strides[9 + i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (variant == 0) {
    if (D <= 64) return launch_f32<64>(q, k, v, o, lse, B, s, st);
    if (D <= 128) return launch_f32<128>(q, k, v, o, lse, B, s, st);
    return launch_f32<256>(q, k, v, o, lse, B, s, st);
  }
  if (variant == 2) {
    if (D == 64) return launch_wgmma<64>(q, k, v, o, lse, B, Hkv, s, st);
    if (D == 80) return launch_wgmma<80>(q, k, v, o, lse, B, Hkv, s, st);
    return launch_wgmma<128>(q, k, v, o, lse, B, Hkv, s, st);
  }
  if (D <= 64) return launch_bf16<64>(q, k, v, o, lse, B, s, st);
  if (D <= 128) return launch_bf16<128>(q, k, v, o, lse, B, s, st);
  return launch_bf16<256>(q, k, v, o, lse, B, s, st);
}

}  // extern "C"
