// Banded self-attention with a learned relative-position table (Gaddy &
// Klein's encoder attention), forward and backward, for Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// articulatory_tpu_torch/ops/banded_attention.py, which holds the plain
// PyTorch version beside it).
//
// Replaces no kernel of the JAX package: articulatory_tpu/layers/
// transformer.py computes this attention in plain jnp over the dense
// (B, H, L, L) logits. For q, k, v (B, H, L, d), the table E (H, W, d),
// W = 2m - 1, M = m - 1, and in training a keep mask (B, H, L, W) uint8:
//
//     s[i, j] = q_i . k_j / sqrt(d) + q_i . E[j - i + M]   for |j - i| <= M
//     o_i     = sum_j softmax_j(s[i, :]) keep[i, j - i + M] / (1 - p) v_j
//
// (the dense path's -1e8 entries have probability exactly 0, see the
// Python module). Outputs: o (B, H, L, d) and the rows' log-sum-exp
// (B, H, L) f32; the backward's dq, dk, dv (B, H, L, d) and the table's
// gradient as partial sums (S, H, W, d) f32 that the wrapper adds. Scratch
// from the wrapper: R = q E^T, and in the backward dS and P', each a
// banded (B H, L, W) f32 array.
//
// What bounds it: per query and head, W keys make 6 W d operations
// forward (q k^T, q E^T, P V) and 12 W d backward (dO v^T, dS k, dR E, dv,
// dk, dE; the kernels recompute q k^T and q E^T besides), against q, k, v,
// o, their gradients and the mask once each in device memory: about 100
// operations a byte at d 96, m 100, so the 3xTF32 operation bound (495
// TFLOP/s / 3) rules. f32 inputs are split into tf32 hi and lo parts and each product
// is three tf32 tensor-core products (lo hi, hi lo, hi hi), close to f32
// accuracy as the port's other f32 kernels; bf16 inputs are widened to f32
// in shared memory and take the same path.
//
// Design. Tensor-core products are warp-level mma.sync m16n8k8 tf32 (not
// wgmma's 64-row tiles): each warp owns 16 rows, and the band of a warp's
// 16 queries (W + 15 keys) is narrower than a 64-row tile's (W + 63), so a
// warp skips every 8-key slice outside its own band and does within about
// 12 % of the in-band products at m 100. Tiles are staged in shared memory
// as f32 by 16-byte loads, every thread's loads issued before its stores,
// and split into hi and lo as fragments are read; a tile's band entries
// (R and the keep bytes) are loaded into registers before its products, so
// their latency passes under them. Where a product's depth runs over keys
// or queries (P V, dS k, P^T dO, dS^T q, dR^T q), k index t of the
// fragment stands for row 2t of the tile and t + 4 for 2t + 1, so that a
// C fragment (columns 2t, 2t + 1) is an A fragment as it stands and no
// shuffle is needed. Shared memory holds no (rows, W) array, so it does
// not grow with the band, and blocks stay small enough for two or more on
// an SM.
// - banded_attn_rel_kernel: R = q E^T, a block of 64 queries against the
//   table in 32-row tiles, into the scratch array (run by both passes:
//   recomputing it is cheaper than keeping it).
// - banded_attn_fwd_kernel: a block of 64 queries (four warps) walks the
//   keys of its window in 32-row tiles of k and v: q k^T, the relative
//   term read from R along each row's band, the online softmax, dropout on
//   the probabilities, P V folded into the output with the tile's rescale.
// - banded_attn_bwd_q_kernel: the same block over the same tiles, from the
//   forward's log-sum-exp: P, dP = dO v^T, dS = P (dP' - rowsum(dO o)),
//   dq += dS k; dS and the kept, scaled probabilities P' are written once
//   into two banded arrays; then dq += dR E from the block's own band of
//   dS, read back in (64, 32) tiles.
// - banded_attn_bwd_kv_kernel: a block of 64 keys over the 32-row query
//   tiles of its window, reading the bands: dv = P'^T dO, dk = dS^T q / sqrt d.
// - banded_attn_bwd_table_kernel: dE[h] = sum over (b, i) of dR^T q, a
//   block a (row split, head, 64 table rows), each 32-row tile's products
//   summed apart and then added; the splits' partial sums are added in a
//   fixed order by the wrapper. No atomics anywhere: the gradients are the
//   same bits from call to call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "vec.cuh"

namespace port_kernels {
namespace banded {

constexpr int kThreads = 128;  // four warps
constexpr int kBlock = 64;     // rows a block, 16 a warp
constexpr int kStep = 32;      // rows of each tile the loops walk over
constexpr int kBand = 68;      // row stride of a (32, 64) band tile (4 mod 32)

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* e;          // (H, W, dim) contiguous
  const uint8_t* keep;    // (B, H, L, W), null without dropout
  const void* o;          // (B, H, L, dim) contiguous
  const void* dout;
  const float* lse;       // (B, H, L)
  void* out;              // o in the forward, dq in the backward
  float* out_lse;
  void* dk;
  void* dv;
  float* dr;              // (B H, L, W): dS
  float* pd;              // (B H, L, W): P'
  float* part;            // (splits, H, W, dim)
  float* r;               // (B H, L, W): R = q E^T
  long long sq[3], sk[3], sv[3], sdo[3];  // batch, head, row strides
  int heads, length, dim, width, half, rows, rows_per_split;
  float scale, keep_scale;
  bool vec;  // every row of q, k, v, do and the table aligned for 4-wide loads
};

template <int kD>
__host__ __device__ constexpr int row_stride() {
  return kD + 4;  // 4 mod 32: fragment reads free of bank conflicts
}

template <int kD>
size_t rel_smem() {
  return sizeof(float) * (kBlock + kStep) * row_stride<kD>();
}

template <int kD>
size_t fwd_smem() {
  return sizeof(float) * (kBlock + 2 * kStep) * row_stride<kD>();
}

template <int kD>
size_t bwd_q_smem() {
  return sizeof(float) *
         ((2 * kBlock + 2 * kStep) * row_stride<kD>() + kBlock);
}

template <int kD>
size_t bwd_kv_smem() {
  return sizeof(float) * (2 * kStep * kBand + 2 * kStep * row_stride<kD>());
}

template <int kD>
size_t bwd_table_smem() {
  return sizeof(float) * (kStep * kBand + kStep * row_stride<kD>());
}

// ---- tf32 tensor-core products ---------------------------------------------

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32(a[i]);
    f.lo[i] = tf32(a[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  f.hi[0] = tf32(b0);
  f.lo[0] = tf32(b0 - __uint_as_float(f.hi[0]));
  f.hi[1] = tf32(b1);
  f.lo[1] = tf32(b1 - __uint_as_float(f.hi[1]));
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8) += a (16 x 8) b (8 x 8) in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// Fragments from shared memory, for lane (g, t) = (lane / 4, lane % 4).
// A (16 x 8) from 16 rows of s (row stride ld), k columns kk..kk + 7.
__device__ __forceinline__ FragA a_rows(const float* s, int ld, int kk,
                                        int g, int t) {
  const float* p = s + g * ld + kk + t;
  return frag_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// A (16 x 8) = s^T: A[m][k] = s[row of k][m], k index t standing for row
// kk + 2t and t + 4 for kk + 2t + 1.
__device__ __forceinline__ FragA a_cols(const float* s, int ld, int kk, int g,
                                        int t) {
  const float* p = s + (kk + 2 * t) * ld + g;
  return frag_a(p[0], p[8], p[ld], p[ld + 8]);
}

// A from a C fragment (rows g, g + 8; columns 2t, 2t + 1), k index t
// standing for column 2t and t + 4 for 2t + 1.
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// B (8 x 8) with B[k][n] = s[n][kk + k]: 8 rows of s hold the 8 columns.
__device__ __forceinline__ FragB b_rows(const float* s, int ld, int kk, int g,
                                        int t) {
  const float* p = s + g * ld + kk + t;
  return frag_b(p[0], p[4]);
}

// B (8 x 8) with B[k][n] = s[kk + k][n0 + n].
__device__ __forceinline__ FragB b_cols(const float* s, int ld, int kk,
                                        int n0, int g, int t) {
  const float* p = s + (kk + t) * ld + n0 + g;
  return frag_b(p[0], p[4 * ld]);
}

// B (8 x 8) with B[k][n] = s[row of k][n0 + n], k index t standing for row
// kk + 2t and t + 4 for kk + 2t + 1 (the pairing of a_from_c and a_cols).
__device__ __forceinline__ FragB b_pairs(const float* s, int ld, int kk,
                                         int n0, int g, int t) {
  const float* p = s + (kk + 2 * t) * ld + n0 + g;
  return frag_b(p[0], p[ld]);
}

// ---- staging ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store1(T* p, float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    *p = __float2bfloat16(v);
  } else {
    *p = v;
  }
}

// 4 elements from p widened to f32 in one 16-byte (f32) or 8-byte (bf16)
// load; p aligned to it.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

// Elements [c, c + 4) of the row at p as f32, zero past dim: one load4
// where vec, else one load a column.
template <typename T>
__device__ __forceinline__ float4 load_chunk(const T* p, int c, int dim,
                                             bool vec) {
  if (vec) return load4(p);
  float4 x;
  x.x = load1(p);
  x.y = c + 1 < dim ? load1(p + 1) : 0.f;
  x.z = c + 2 < dim ? load1(p + 2) : 0.f;
  x.w = c + 3 < dim ? load1(p + 3) : 0.f;
  return x;
}

// Rows [r0, r0 + kN) of a (., dim) matrix at base (row stride rs) into s
// (row stride kD + 4) as f32, zero outside [0, limit) and past dim; every
// thread's loads issued before its stores.
template <typename T, int kD, int kN>
__device__ __forceinline__ void load_rows(float* s, const T* base,
                                          long long rs, int r0, int limit,
                                          int dim, bool vec) {
  constexpr int ld = row_stride<kD>(), kC = kD / 4, kChunks = kN * kC;
#pragma unroll
  for (int n = 0; n < (kChunks + kThreads - 1) / kThreads; ++n) {
    const int idx = threadIdx.x + n * kThreads;
    if (kChunks % kThreads != 0 && idx >= kChunks) break;
    const int r = idx / kC, c = (idx - r * kC) * 4, row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= 0 && row < limit && c < dim) {
      x = load_chunk(base + row * rs + c, c, dim, vec);
    }
    *reinterpret_cast<float4*>(s + r * ld + c) = x;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// r[i][c] = q_i . E_c (r's row stride W) for the warp's 16 rows from i0
// below length (qw, in shared memory) and c < W, the table streamed
// through es in kStep-row tiles. Every thread of the block calls.
template <typename T, int kD>
__device__ __forceinline__ void relative(const float* qw, float* es,
                                         float* r, int i0, int length,
                                         const T* e, int width, int dim,
                                         bool vec, int g, int t) {
  constexpr int ld = row_stride<kD>();
  for (int e0 = 0; e0 < width; e0 += kStep) {
    __syncthreads();
    load_rows<T, kD, kStep>(es, e, dim, e0, width, dim, vec);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kD; kk += 8) {
      const FragA fa = a_rows(qw, ld, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma3(acc[nt], fa, b_rows(es + nt * 8 * ld, ld, kk, g, t));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + g + 8 * (c >> 1);
        const int col = e0 + nt * 8 + 2 * t + (c & 1);
        if (col < width && i < length) {
          r[(long long)i * width + col] = acc[nt][c];
        }
      }
    }
  }
}

// Whether the 8 keys from n0 can hold a key of the band of the warp's
// queries [i0, i0 + 16).
__device__ __forceinline__ bool live_keys(int n0, int i0, int half,
                                          int length) {
  return n0 < length && n0 <= i0 + 15 + half && n0 + 7 >= i0 - half;
}

// The band's entries of the thread's 16 (query, key) pairs of the tile
// from k0 (rows g and g + 8 of the warp, keys nt * 8 + 2t and + 1): R, 0
// outside the band, and the keep byte, 1 outside the band or without a
// mask; returns which pairs lie in the band (bit 4 nt + c). Read before the
// tile's products, so that the loads' latency passes under them.
__device__ __forceinline__ unsigned band_loads(
    float (&rv)[4][4], unsigned char (&kb)[4][4], const float* r,
    const uint8_t* keep, const bool (&live)[4], int i0, int k0, int length,
    int width, int half, int g, int t) {
  unsigned inside = 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + g + 8 * (c >> 1);
      const int j = k0 + nt * 8 + 2 * t + (c & 1), rel = j - i + half;
      const bool in =
          live[nt] && i < length && j < length && rel >= 0 && rel < width;
      const long long at = (long long)i * width + rel;
      rv[nt][c] = in ? r[at] : 0.f;
      kb[nt][c] = in && keep != nullptr ? keep[at] : 1;
      inside |= (in ? 1u : 0u) << (4 * nt + c);
    }
  }
  return inside;
}

// ---- relative term -----------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    banded_attn_rel_kernel(const Args a) {
  constexpr int ld = row_stride<kD>();
  extern __shared__ float smem[];
  float* qs = smem;
  float* es = qs + kBlock * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kBlock;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* e = static_cast<const T*>(a.e) + (long long)h * a.width * a.dim;
  load_rows<T, kD, kBlock>(qs, q, a.sq[2], q0, a.length, a.dim, a.vec);
  relative<T, kD>(qs + warp * 16 * ld, es,
                  a.r + (long long)bh * a.length * a.width, q0 + warp * 16,
                  a.length, e, a.width, a.dim, a.vec, g, t);
}

// ---- forward ---------------------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    banded_attn_fwd_kernel(const Args a) {
  constexpr int ld = row_stride<kD>();
  constexpr int kN = kD / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlock * ld;
  float* vs = ks + kStep * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int length = a.length, width = a.width, half = a.half;
  const int q0 = blockIdx.x * kBlock, i0 = q0 + warp * 16;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const long long band = (long long)bh * length * width;
  const float* r = a.r + band;
  const uint8_t* keep = a.keep ? a.keep + band : nullptr;
  const float* qw = qs + warp * 16 * ld;

  load_rows<T, kD, kBlock>(qs, q, a.sq[2], q0, length, a.dim, a.vec);
  const float kscale = keep != nullptr ? a.keep_scale : 1.f;
  float m_run[2] = {-1e30f, -1e30f}, l_run[2] = {0.f, 0.f};
  float acc[kN][4] = {};
  const int kstart = max(0, q0 - half), kend = min(length, q0 + kBlock + half);
  for (int k0 = kstart; k0 < kend; k0 += kStep) {
    __syncthreads();
    load_rows<T, kD, kStep>(ks, k, a.sk[2], k0, length, a.dim, a.vec);
    load_rows<T, kD, kStep>(vs, v, a.sv[2], k0, length, a.dim, a.vec);
    __syncthreads();
    if (i0 >= length || k0 > i0 + 15 + half || k0 + kStep - 1 < i0 - half) {
      continue;
    }
    bool live[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      live[nt] = live_keys(k0 + nt * 8, i0, half, length);
    }
    float rv[4][4];
    unsigned char kb[4][4];
    const unsigned inside = band_loads(rv, kb, r, keep, live, i0, k0, length,
                                       width, half, g, t);
    float s[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kD; kk += 8) {
      const FragA fa = a_rows(qw, ld, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (live[nt]) mma3(s[nt], fa, b_rows(ks + nt * 8 * ld, ld, kk, g, t));
      }
    }
    // the logits, -inf outside the band, and the rows' maxima
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = inside >> (4 * nt + c) & 1u
                       ? s[nt][c] * a.scale + rv[nt][c]
                       : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
      }
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m_new[rr] = fmaxf(m_run[rr], quad_max(mx[rr]));
      alpha[rr] = expf(m_run[rr] - m_new[rr]);
      l_run[rr] *= alpha[rr];
      m_run[rr] = m_new[rr];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[nt][c] - m_new[c >> 1]);
        l_run[c >> 1] += p;
        s[nt][c] = kb[nt][c] ? p * kscale : 0.f;
      }
    }
    // the tile's P V summed apart, then folded into the rescaled output in
    // f32 (the tensor cores' own additions truncate)
    float part[kN][4] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (!live[nt]) continue;
      const FragA fa = a_from_c(s[nt]);
#pragma unroll
      for (int dn = 0; dn < kN; ++dn) {
        mma3(part[dn], fa, b_pairs(vs, ld, nt * 8, dn * 8, g, t));
      }
    }
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[dn][c] = acc[dn][c] * alpha[c >> 1] + part[dn][c];
      }
    }
  }

  T* o = static_cast<T*>(a.out) + (long long)bh * length * a.dim;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + g + 8 * rr;
    const float l = quad_sum(l_run[rr]);
    if (i >= length) continue;
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = dn * 8 + 2 * t + cc;
        if (col < a.dim) {
          store1(o + (long long)i * a.dim + col, acc[dn][2 * rr + cc] / l);
        }
      }
    }
    if (t == 0) a.out_lse[(long long)bh * length + i] = m_run[rr] + logf(l);
  }
}

// ---- backward: query blocks ------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    banded_attn_bwd_q_kernel(const Args a) {
  constexpr int ld = row_stride<kD>();
  constexpr int kN = kD / 8;
  constexpr int ldd = kStep + 4;  // row stride of a (64, 32) tile of dR
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * ld;
  float* ks = dos + kBlock * ld;
  float* vs = ks + kStep * ld;
  float* delta = vs + kStep * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int length = a.length, width = a.width, half = a.half;
  const int q0 = blockIdx.x * kBlock, i0 = q0 + warp * 16;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const T* dout =
      static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const T* o = static_cast<const T*>(a.o) + (long long)bh * length * a.dim;
  const T* e = static_cast<const T*>(a.e) + (long long)h * width * a.dim;
  const long long band = (long long)bh * length * width;
  const float* r = a.r + band;
  float* dr = a.dr + band;
  float* pd = a.pd + band;
  const uint8_t* keep = a.keep ? a.keep + band : nullptr;
  const float* qw = qs + warp * 16 * ld;
  const float* dow = dos + warp * 16 * ld;

  load_rows<T, kD, kBlock>(qs, q, a.sq[2], q0, length, a.dim, a.vec);
  load_rows<T, kD, kBlock>(dos, dout, a.sdo[2], q0, length, a.dim, a.vec);
  __syncthreads();
  // delta_i = dO_i . o_i, a warp a row
  for (int rr = 0; rr < 16; ++rr) {
    const int i = i0 + rr;
    float sum = 0.f;
    if (i < length) {
      for (int c = lane; c < a.dim; c += 32) {
        sum += dow[rr * ld + c] * load1(o + (long long)i * a.dim + c);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) delta[warp * 16 + rr] = sum;
  }
  __syncwarp();
  float lse[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + g + 8 * rr;
    lse[rr] = i < length ? a.lse[(long long)bh * length + i] : 0.f;
    dlt[rr] = delta[warp * 16 + g + 8 * rr];
  }
  const float kscale = keep != nullptr ? a.keep_scale : 1.f;
  float dq[kN][4] = {};
  const int kstart = max(0, q0 - half), kend = min(length, q0 + kBlock + half);
  for (int k0 = kstart; k0 < kend; k0 += kStep) {
    __syncthreads();
    load_rows<T, kD, kStep>(ks, k, a.sk[2], k0, length, a.dim, a.vec);
    load_rows<T, kD, kStep>(vs, v, a.sv[2], k0, length, a.dim, a.vec);
    __syncthreads();
    if (i0 >= length || k0 > i0 + 15 + half || k0 + kStep - 1 < i0 - half) {
      continue;
    }
    bool live[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      live[nt] = live_keys(k0 + nt * 8, i0, half, length);
    }
    float rv[4][4];
    unsigned char kb[4][4];
    const unsigned inside = band_loads(rv, kb, r, keep, live, i0, k0, length,
                                       width, half, g, t);
    // s = q k^T and dP = dO v^T, eight independent sums
    float sv[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kD; kk += 8) {
      const FragA fq = a_rows(qw, ld, kk, g, t);
      const FragA fd = a_rows(dow, ld, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!live[nt]) continue;
        mma3(sv[nt], fq, b_rows(ks + nt * 8 * ld, ld, kk, g, t));
        mma3(dp[nt], fd, b_rows(vs + nt * 8 * ld, ld, kk, g, t));
      }
    }
    // dS in sv's place; dS and the kept probabilities into the bands
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        float ds = 0.f;
        if (inside >> (4 * nt + c) & 1u) {
          const float p = expf(sv[nt][c] * a.scale + rv[nt][c] - lse[rr]);
          const float dpk = kb[nt][c] ? dp[nt][c] * kscale : 0.f;
          ds = p * (dpk - dlt[rr]);
          const int i = i0 + g + 8 * rr;
          const long long at =
              (long long)i * width + k0 + nt * 8 + 2 * t + (c & 1) - i + half;
          dr[at] = ds;
          pd[at] = kb[nt][c] ? p * kscale : 0.f;
        }
        sv[nt][c] = ds;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (!live[nt]) continue;
      const FragA fa = a_from_c(sv[nt]);
#pragma unroll
      for (int dn = 0; dn < kN; ++dn) {
        mma3(dq[dn], fa, b_pairs(ks, ld, nt * 8, dn * 8, g, t));
      }
    }
  }
#pragma unroll
  for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[dn][c] *= a.scale;
  }
  // dq += dR E: dR is dS over the band, as this block wrote it into dr
  // (its own writes, visible to it after the barrier); tiles of 32 table
  // rows (ks) against the block's (64, 32) tile of dR (in qs's place)
  float* drs = qs;
  for (int e0 = 0; e0 < width; e0 += kStep) {
    __syncthreads();
    load_rows<T, kD, kStep>(ks, e, a.dim, e0, width, a.dim, a.vec);
#pragma unroll
    for (int n = 0; n < kBlock * kStep / kThreads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int rr = idx / kStep, c = idx % kStep;
      const int i = q0 + rr, rel = e0 + c, j = i + rel - half;
      drs[rr * ldd + c] =
          i < length && rel < width && j >= 0 && j < length
              ? dr[(long long)i * width + rel]
              : 0.f;
    }
    __syncthreads();
    if (i0 >= length) continue;
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 8) {
      if (e0 + kk >= width) break;
      const FragA fa = a_rows(drs + warp * 16 * ldd, ldd, kk, g, t);
#pragma unroll
      for (int dn = 0; dn < kN; ++dn) {
        mma3(dq[dn], fa, b_cols(ks, ld, kk, dn * 8, g, t));
      }
    }
  }
  T* dqo = static_cast<T*>(a.out) + (long long)bh * length * a.dim;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + g + 8 * rr;
    if (i >= length) continue;
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = dn * 8 + 2 * t + cc;
        if (col < a.dim) {
          store1(dqo + (long long)i * a.dim + col, dq[dn][2 * rr + cc]);
        }
      }
    }
  }
}

// ---- backward: key blocks --------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    banded_attn_bwd_kv_kernel(const Args a) {
  constexpr int ld = row_stride<kD>();
  constexpr int kN = kD / 8;
  extern __shared__ float smem[];
  float* ps = smem;
  float* dss = ps + kStep * kBand;
  float* qs = dss + kStep * kBand;
  float* dos = qs + kStep * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int length = a.length, width = a.width, half = a.half;
  const int k0 = blockIdx.x * kBlock, j0 = k0 + warp * 16;
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* dout =
      static_cast<const T*>(a.dout) + b * a.sdo[0] + h * a.sdo[1];
  const long long band = (long long)bh * length * width;

  float dk[kN][4] = {}, dv[kN][4] = {};
  const int qstart = max(0, k0 - half), qend = min(length, k0 + kBlock + half);
  for (int qt = qstart; qt < qend; qt += kStep) {
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kStep * kBlock / kThreads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int r = idx / kBlock, c = idx % kBlock;
      const int i = qt + r, j = k0 + c, rel = j - i + half;
      const bool inside = i < length && j < length && rel >= 0 && rel < width;
      const long long at = band + (long long)i * width + rel;
      ps[r * kBand + c] = inside ? a.pd[at] : 0.f;
      dss[r * kBand + c] = inside ? a.dr[at] : 0.f;
    }
    load_rows<T, kD, kStep>(qs, q, a.sq[2], qt, length, a.dim, a.vec);
    load_rows<T, kD, kStep>(dos, dout, a.sdo[2], qt, length, a.dim, a.vec);
    __syncthreads();
    if (j0 >= length) continue;
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 8) {
      // the 8 queries from qt + kk against the band of keys [j0, j0 + 16)
      if (!live_keys(qt + kk, j0, half, length)) continue;
      const FragA fp = a_cols(ps + warp * 16, kBand, kk, g, t);
      const FragA fs = a_cols(dss + warp * 16, kBand, kk, g, t);
#pragma unroll
      for (int dn = 0; dn < kN; ++dn) {
        mma3(dv[dn], fp, b_pairs(dos, ld, kk, dn * 8, g, t));
        mma3(dk[dn], fs, b_pairs(qs, ld, kk, dn * 8, g, t));
      }
    }
  }
  const long long out = (long long)bh * length * a.dim;
  T* dko = static_cast<T*>(a.dk) + out;
  T* dvo = static_cast<T*>(a.dv) + out;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + g + 8 * r;
    if (j >= length) continue;
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = dn * 8 + 2 * t + cc;
        if (col < a.dim) {
          store1(dko + (long long)j * a.dim + col, dk[dn][2 * r + cc] * a.scale);
          store1(dvo + (long long)j * a.dim + col, dv[dn][2 * r + cc]);
        }
      }
    }
  }
}

// ---- backward: the table ---------------------------------------------------

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    banded_attn_bwd_table_kernel(const Args a) {
  constexpr int ld = row_stride<kD>();
  constexpr int kN = kD / 8;
  extern __shared__ float smem[];
  float* drs = smem;
  float* qs = drs + kStep * kBand;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, h = blockIdx.y, w0 = blockIdx.z * kBlock;
  const int length = a.length, width = a.width, half = a.half;
  const int first = split * a.rows_per_split;
  const int last = min(first + a.rows_per_split, a.rows);
  const T* q = static_cast<const T*>(a.q) + h * a.sq[1];

  float acc[kN][4] = {};
  for (int r0 = first; r0 < last; r0 += kStep) {
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kStep * kBlock / kThreads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int r = idx / kBlock, c = idx % kBlock;
      const int row = r0 + r, rel = w0 + c;
      float x = 0.f;
      if (row < last && rel < width) {
        const int b = row / length, i = row - b * length, j = i + rel - half;
        if (j >= 0 && j < length) {
          x = a.dr[((long long)(b * a.heads + h) * length + i) * width + rel];
        }
      }
      drs[r * kBand + c] = x;
    }
    constexpr int kC = kD / 4;
#pragma unroll
    for (int n = 0; n < kStep * kC / kThreads; ++n) {
      const int idx = threadIdx.x + n * kThreads;
      const int r = idx / kC, c = (idx - r * kC) * 4, row = r0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < last && c < a.dim) {
        const int b = row / length, i = row - b * length;
        x = load_chunk(q + b * a.sq[0] + i * a.sq[2] + c, c, a.dim, a.vec);
      }
      *reinterpret_cast<float4*>(qs + r * ld + c) = x;
    }
    __syncthreads();
    // a tile's products summed apart, then added in f32: the tensor cores'
    // own additions truncate, over thousands of rows
    float part[kN][4] = {};
#pragma unroll
    for (int kk = 0; kk < kStep; kk += 8) {
      const FragA fa = a_cols(drs + warp * 16, kBand, kk, g, t);
#pragma unroll
      for (int dn = 0; dn < kN; ++dn) {
        mma3(part[dn], fa, b_pairs(qs, ld, kk, dn * 8, g, t));
      }
    }
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dn][c] += part[dn][c];
    }
  }
  float* out = a.part + (long long)(split * a.heads + h) * width * a.dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rel = w0 + warp * 16 + g + 8 * r;
    if (rel >= width) continue;
#pragma unroll
    for (int dn = 0; dn < kN; ++dn) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = dn * 8 + 2 * t + cc;
        if (col < a.dim) out[(long long)rel * a.dim + col] = acc[dn][2 * r + cc];
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

template <typename T, int kD>
cudaError_t forward(const Args& a, int batch, cudaStream_t stream) {
  const dim3 grid(blocks(a.length), batch * a.heads);
  const cudaError_t err = launch(banded_attn_rel_kernel<T, kD>, grid,
                                 rel_smem<kD>(), a, stream);
  if (err != cudaSuccess) return err;
  return launch(banded_attn_fwd_kernel<T, kD>, grid, fwd_smem<kD>(), a,
                stream);
}

template <typename T, int kD>
cudaError_t backward(const Args& a, int batch, int splits,
                     cudaStream_t stream) {
  const dim3 grid(blocks(a.length), batch * a.heads);
  cudaError_t err = launch(banded_attn_rel_kernel<T, kD>, grid,
                           rel_smem<kD>(), a, stream);
  if (err != cudaSuccess) return err;
  err = launch(banded_attn_bwd_q_kernel<T, kD>, grid, bwd_q_smem<kD>(), a,
               stream);
  if (err != cudaSuccess) return err;
  err = launch(banded_attn_bwd_kv_kernel<T, kD>, grid, bwd_kv_smem<kD>(), a,
               stream);
  if (err != cudaSuccess) return err;
  return launch(banded_attn_bwd_table_kernel<T, kD>,
                dim3(splits, a.heads, blocks(a.width)), bwd_table_smem<kD>(),
                a, stream);
}

// kD: the head size rounded up to 32, 64, 96 or 128 (the wrapper holds
// dim <= 128).
template <typename T>
cudaError_t forward_any(const Args& a, int batch, cudaStream_t stream) {
  if (a.dim <= 32) return forward<T, 32>(a, batch, stream);
  if (a.dim <= 64) return forward<T, 64>(a, batch, stream);
  if (a.dim <= 96) return forward<T, 96>(a, batch, stream);
  return forward<T, 128>(a, batch, stream);
}

template <typename T>
cudaError_t backward_any(const Args& a, int batch, int splits,
                         cudaStream_t stream) {
  if (a.dim <= 32) return backward<T, 32>(a, batch, splits, stream);
  if (a.dim <= 64) return backward<T, 64>(a, batch, splits, stream);
  if (a.dim <= 96) return backward<T, 96>(a, batch, splits, stream);
  return backward<T, 128>(a, batch, splits, stream);
}

// Whether rows at p with these strides (elements) take 4-wide loads: 16
// bytes in f32; the bf16 path reads 8 and needs less, and its pointers
// pass this test whenever they would pass its own.
bool aligned(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0 && s2 % 4 == 0;
}

Args args(const void* q, const void* k, const void* v, const void* e,
          const void* keep, long long sqb, long long sqh, long long sql,
          long long skb, long long skh, long long skl, long long svb,
          long long svh, long long svl, int heads, int length, int dim,
          int width, float keep_scale) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.e = e;
  a.keep = static_cast<const uint8_t*>(keep);
  a.sq[0] = sqb, a.sq[1] = sqh, a.sq[2] = sql;
  a.sk[0] = skb, a.sk[1] = skh, a.sk[2] = skl;
  a.sv[0] = svb, a.sv[1] = svh, a.sv[2] = svl;
  a.heads = heads;
  a.length = length;
  a.dim = dim;
  a.width = width;
  a.half = (width - 1) / 2;
  a.scale = 1.f / sqrtf((float)dim);
  a.keep_scale = keep_scale;
  a.vec = dim % 4 == 0 && aligned(q, sqb, sqh, sql) &&
          aligned(k, skb, skh, skl) && aligned(v, svb, svh, svl) &&
          aligned(e, 0, 0, dim);
  return a;
}

}  // namespace banded
}  // namespace port_kernels

using port_kernels::banded::Args;
using port_kernels::banded::aligned;
using port_kernels::banded::args;

extern "C" {

// Each returns the cudaError_t of its launches (0 on success); stream is a
// cudaStream_t and nothing synchronises. dtype 0 is float32, 1 bfloat16
// (q, k, v, the table, o, do and the gradients alike). keep is the
// (B, H, L, W) uint8 mask, or null without dropout; keep_scale 1 / (1 - p).
// Strides are in elements (batch, head, row; each row contiguous); the
// table, o and the outputs are contiguous. r is scratch for R = q E^T,
// (B H, L, W) f32. The forward writes o and lse (B, H, L) f32.
int banded_attention_forward(int dtype, const void* q, const void* k,
                             const void* v, const void* e, const void* keep,
                             void* o, float* lse, float* r, long long sqb,
                             long long sqh, long long sql, long long skb,
                             long long skh, long long skl, long long svb,
                             long long svh, long long svl, int batch,
                             int heads, int length, int dim, int width,
                             float keep_scale, void* stream) {
  Args a = args(q, k, v, e, keep, sqb, sqh, sql, skb, skh, skl, svb, svh,
                svl, heads, length, dim, width, keep_scale);
  a.out = o;
  a.out_lse = lse;
  a.r = r;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? port_kernels::banded::forward_any<float>(a, batch, s)
             : port_kernels::banded::forward_any<__nv_bfloat16>(a, batch, s);
}

// The backward from the forward's o and lse and do (strides sd*): dq, dk,
// dv (B, H, L, dim) in dtype, dS and P' into dr and pd (B H, L, W) f32
// (scratch), and the table's gradient as `splits` partial sums over
// rows_per_split rows (b, i) each into part (splits, H, W, dim) f32.
int banded_attention_backward(
    int dtype, const void* q, const void* k, const void* v, const void* e,
    const void* keep, const void* o, const void* dout, const float* lse,
    void* dq, void* dk, void* dv, float* dr, float* pd, float* part, float* r,
    long long sqb, long long sqh, long long sql, long long skb, long long skh,
    long long skl, long long svb, long long svh, long long svl,
    long long sdb, long long sdh, long long sdl, int batch, int heads,
    int length, int dim, int width, int splits, int rows_per_split,
    float keep_scale, void* stream) {
  Args a = args(q, k, v, e, keep, sqb, sqh, sql, skb, skh, skl, svb, svh,
                svl, heads, length, dim, width, keep_scale);
  a.o = o;
  a.dout = dout;
  a.sdo[0] = sdb, a.sdo[1] = sdh, a.sdo[2] = sdl;
  a.vec = a.vec && aligned(dout, sdb, sdh, sdl);
  a.lse = lse;
  a.out = dq;
  a.dk = dk;
  a.dv = dv;
  a.dr = dr;
  a.pd = pd;
  a.part = part;
  a.r = r;
  a.rows = batch * length;
  a.rows_per_split = rows_per_split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? port_kernels::banded::backward_any<float>(a, batch,
                                                                splits, s)
                    : port_kernels::banded::backward_any<__nv_bfloat16>(
                          a, batch, splits, s);
}

const char* banded_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
