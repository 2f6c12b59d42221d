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
// steps.  Blocks here run in parallel in no order, so one block owns 64
// queries of one (batch, head) and loops over the key tiles itself, with the
// running max, denominator and accumulator in registers.  GQA is the
// block's own index arithmetic; ragged lengths are masked in the kernel (no
// padding to the block size).
//
// What bounds it on this card: operations, 4 * D per (query, key) pair that
// the mask keeps (two products), against q, k, v and o moved once.  Two
// kernels share the tiling (64 queries a block, 64-key tiles staged in
// shared memory):
//   * fp32: FMAs on the CUDA cores (67 TFLOP/s at most), 4 x 4 scores per
//     thread; no TF32, so it agrees with the plain version to 2e-5;
//   * bf16: the tensor cores through mma.sync m16n8k16 with fp32
//     accumulation, one warp per 16 queries, fragments loaded with
//     ldmatrix.  The scores are exact products of the bf16 inputs summed in
//     fp32, as the TPU kernel's fp32 products of widened inputs are; p is
//     rounded to bf16 before P.V (the TPU kernel keeps it fp32), a relative
//     error of at most 2^-9 per weight, while the row sums l stay fp32.
// wgmma and TMA are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ---- fp32: CUDA cores -------------------------------------------------------
// DMAX bounds D (a multiple of 16): the thread keeps DMAX / 16 output
// columns of each of its rows in registers, column tx + 16 jj.
template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Shape s) {
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
                      const bf16* __restrict__ v, bf16* __restrict__ o, Shape s) {
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
  }
}

// ---- launch -----------------------------------------------------------------
template <typename T, typename Kernel>
int launch(Kernel fn, int threads, size_t bytes, const void* q, const void* k, const void* v,
           void* o, int B, const Shape& s, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s.Lq + BM - 1) / BM), static_cast<unsigned>(B * s.H));
  fn<<<grid, threads, bytes, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), s);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, const Shape& s,
               cudaStream_t st) {
  const size_t bytes = sizeof(float) * (static_cast<size_t>(BM + 2 * BN) * (s.D + 1) +
                                        static_cast<size_t>(BM) * (BN + 1));
  return launch<float>(flash_fwd_f32_kernel<DMAX>, THREADS, bytes, q, k, v, o, B, s, st);
}

template <int DMAX>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, const Shape& s,
                cudaStream_t st) {
  const size_t bytes = sizeof(bf16) * static_cast<size_t>(BM + 2 * BN) * (s.D + 8);
  return launch<bf16>(flash_fwd_bf16_kernel<DMAX>, MMA_THREADS, bytes, q, k, v, o, B, s, st);
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers; dtype 0 = fp32, 1 = bf16 (all four alike).
// strides: 12 element strides, (batch, head, position) of q, k, v and o in
// turn; the head dimension is contiguous in all four.  For bf16 every
// stride is a multiple of 8 and every pointer 16-byte aligned.  Returns the
// launch's cudaError_t (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int H, int Hkv, int Lq, int Lk, int D,
                           const long long* strides, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Lq < 1 || Lk < 1 || D < 16 ||
      D > 256 || D % 16 != 0 || (causal && Lq != Lk) || static_cast<long long>(B) * H > 65535 ||
      (dtype != 0 && dtype != 1)) {
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
  if (dtype == 0) {
    if (D <= 64) return launch_f32<64>(q, k, v, o, B, s, st);
    if (D <= 128) return launch_f32<128>(q, k, v, o, B, s, st);
    return launch_f32<256>(q, k, v, o, B, s, st);
  }
  if (D <= 64) return launch_bf16<64>(q, k, v, o, B, s, st);
  if (D <= 128) return launch_bf16<128>(q, k, v, o, B, s, st);
  return launch_bf16<256>(q, k, v, o, B, s, st);
}

}  // extern "C"
