// Backward of the fused HiFi-GAN residual pair (resblock_pair.cu) for Hopper
// (sm_90a), f32 in 3xTF32, CUDA C++ with a plain C interface (loaded with
// ctypes by articulatory_tpu_torch/ops/resblock_pair.py).
//
// The JAX package has no backward for its pair kernel (its models
// differentiate XLA convolutions); this one replaces the port's backward by
// recomputation (a plain pair forward through cuDNN under autograd, then its
// gradient), which took ~140 ms of device time a training step. For
//
//     a = lrelu(x), h = conv1(a, dilation d) + b1, g = lrelu(h),
//     y = x + conv2(g) + b2
//
// over x (B, T, C), SAME zero padding, w (tap, in, out), and gy = dL/dy:
//
//     dg = conv2^T(gy)                      dh = dg * lrelu'(h)
//     dx = gy + lrelu'(x) * conv1^T(dh)     db2 = sum gy, db1 = sum dh
//     dw2[k] = sum_{b,t} g[t + k - p2]^T gy[t]
//     dw1[k] = sum_{b,t} a[t + (k - p1) d]^T dh[t]
//
// with rows outside [0, T) zero. The four gradient convolutions are
// 8*B*T*C*C*K flops, twice the forward's, and bound by operations at every
// stage: 3xTF32 (three tf32 products a multiply-add, f32's tolerances, as
// the forward) leaves 165 TFLOP/s of the card's 495 TF32. The design keeps
// the tensor cores fed with what the forward already does well and adds the
// two things the backward needs, a transposed convolution and a GEMM whose
// depth is B*T rows:
//
// - pair_bwd_split_kernel: one launch splits the weights into tf32 hi/lo,
//   w1 as the forward's split ((2, K, out, in), for recomputing h) and both
//   weights tap-flipped and not transposed ((2, K, in, out)): the transposed
//   convolution's B operand (depth = out, N = in) is K-major in the stored
//   layout, so it needs no transpose.
// - pair_bwd_hidden_kernel and pair_bwd_input_kernel, the data gradient: the
//   forward's implicit GEMM over time rows (conv_wgmma in pair_conv.cuh: a
//   window of rows in shared memory read by ldmatrix and split in registers,
//   weight tiles through a TMA ring kept full by one producer warpgroup, two
//   consumer warpgroups on wgmma, 32 k steps summed on the tensor cores and
//   folded into f32, here every 2 k steps: the forward's 32 cost the
//   gradients 3-8x cuDNN f32's distance from float64). The hidden kernel
//   recomputes h from lrelu(x) in its window, keeps lrelu'(h) as one bit an
//   accumulator (where h lies within the sum's error of 0, the bit comes
//   from an exact f64 sum, so the gradients take every lrelu' as float64
//   does), and writes g for dw2; then dg = conv2^T(gy) from a gy window, and
//   dh = dg * lrelu'(h) to device memory. The input kernel reads dh windows,
//   computes conv1^T(dh) with the dilation, and writes dx = gy + lrelu'(x) *
//   it. dh passes through device memory because the weight gradient reads it
//   anyway; in exchange neither kernel drops halo rows, as the fused forward
//   does: each tile reads its own halo'd window. The tile rule is the
//   forward's (make_plan), with no rows lost.
// - pair_bwd_weight_kernel, the weight gradient: dW as a (K C) x C matrix,
//   rows (tap, in), M = K*C, N = C (outputs), depth = B*T rows. Both
//   operands are M-major in (B, T, C), and wgmma takes 32-bit operands
//   K-major only. B, the gradient (gy or dh), is copied by cp.async a chunk
//   of 32 rows at a time, then transposed and split into tf32 hi/lo in one
//   pass into the layout the forward's TMA writes (64-byte swizzle, K-major,
//   16 rows of depth a stage), so the forward's wgmma step reads it. A, the
//   activation (g, or x with lrelu), stays in its (t, in) layout in a window
//   of the chunk's rows plus the taps' reach; each tap's shift is a row
//   offset, so A goes to registers by 32-bit loads (a row stride of 8 mod 32
//   words keeps them free of bank conflicts) and is split there, as the
//   forward splits its A. cp.async brings the next chunk while the current
//   one is multiplied; each chunk's products fold into f32. A block takes
//   128 rows of M (both warpgroups, m64 each) by WN outputs (32, 64 or 128),
//   and a share of the chunks (split-K over rows, chosen for the fewest
//   waves x chunks); each writes its partial sums to a workspace the wrapper
//   allocates, and pair_bwd_reduce_kernel adds them in a fixed order. The
//   biases' column sums come from the same pass over B (the first M block),
//   in f64. No float atomics anywhere: the gradients are bit-equal from call
//   to call.
//
// The mbarrier, TMA, ldmatrix and wgmma wrappers are in hopper.cuh; the
// convolution, its geometry and the weights' tensor maps in pair_conv.cuh,
// shared with the forward.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "hopper.cuh"
#include "pair_conv.cuh"
#include "vec.cuh"

namespace {

using namespace port_kernels;

// ---------------------------------------------------------------- splits

// blockIdx.z over [0, k1): w1 into s1 (2, k1, out, in) as the forward's
// split_tf32; [k1, 2 k1): w1 into r1 (2, k1, in, out) with tap j = w1's
// k1 - 1 - j; [2 k1, 2 k1 + k2): w2 into r2 likewise. [0] tf32(w), [1]
// tf32(w - [0]). A 32 x 32 tile of one tap a block. The last z, blockIdx.y
// 0: w1's squared column norms, wn2[n] = sum over (tap, in) of w1^2, in a
// fixed order.
__global__ void __launch_bounds__(256)
    pair_bwd_split_kernel(const float* __restrict__ w1,
                          const float* __restrict__ w2, float* __restrict__ s1,
                          float* __restrict__ r1, float* __restrict__ r2,
                          float* __restrict__ wn2, int C, int k1, int k2) {
  __shared__ float tile[32][33];
  const int z = blockIdx.z;
  const int in0 = blockIdx.y * 32, out0 = blockIdx.x * 32;
  if (z == 2 * k1 + k2) {
    if (blockIdx.y != 0) return;
    const int n = out0 + threadIdx.x;
    float sum = 0.f;
    for (int q = threadIdx.y; n < C && q < k1 * C; q += 8) {
      const float v = __ldg(w1 + (size_t)q * C + n);
      sum += v * v;
    }
    tile[threadIdx.y][threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.y == 0 && n < C) {
      for (int r = 1; r < 8; ++r) sum += tile[r][threadIdx.x];
      wn2[n] = sum;
    }
    return;
  }
  if (z < k1) {
    const float* w = w1 + (size_t)z * C * C;
    for (int r = threadIdx.y; r < 32; r += 8) {
      const int i = in0 + r, o = out0 + threadIdx.x;
      tile[r][threadIdx.x] =
          i < C && o < C ? __ldg(w + (size_t)i * C + o) : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < 32; r += 8) {
      const int o = out0 + r, i = in0 + threadIdx.x;
      if (o >= C || i >= C) continue;
      const float v = tile[threadIdx.x][r];
      const uint32_t hi = to_tf32(v);
      s1[((size_t)z * C + o) * C + i] = __uint_as_float(hi);
      s1[((size_t)(k1 + z) * C + o) * C + i] =
          __uint_as_float(to_tf32(v - __uint_as_float(hi)));
    }
    return;
  }
  const bool second = z >= 2 * k1;
  const int k = second ? k2 : k1;
  const int j = second ? z - 2 * k1 : z - k1;
  const float* w = (second ? w2 : w1) + (size_t)(k - 1 - j) * C * C;
  float* r = second ? r2 : r1;
  for (int q = threadIdx.y; q < 32; q += 8) {
    const int i = in0 + q, o = out0 + threadIdx.x;
    if (i >= C || o >= C) continue;
    const float v = __ldg(w + (size_t)i * C + o);
    const uint32_t hi = to_tf32(v);
    r[((size_t)j * C + i) * C + o] = __uint_as_float(hi);
    r[((size_t)(k + j) * C + i) * C + o] =
        __uint_as_float(to_tf32(v - __uint_as_float(hi)));
  }
}

// ------------------------------------------------------- data gradient

// k steps summed on the tensor cores before a fold into f32: in the data
// gradient one ring stage (16 channels), in the weight gradient one chunk
// (32 rows), where the products wait for the next chunk anyway. The
// forward's 32 left the gradients 3-8x cuDNN f32's distance from float64
// (to 3.4e-6, relative L2), since the tensor cores truncate each partial
// sum's adds; these read 0.7-1x it, for 3 % more time (H100, the 36
// training and 9 MRI last-stage shapes).
constexpr int kDataFoldSteps = 2;
constexpr int kWeightFoldSteps = 4;

// Window rows [0, n) = src rows first + [0, n) (lrelu'd if kLrelu), zeros
// outside [0, T); kBatch 16-byte loads in flight a thread.
template <bool kLrelu>
__device__ __forceinline__ void stage_window(float* win, int ld,
                                             const float* __restrict__ src,
                                             int first, int n, int seq_len,
                                             int C, float slope) {
  constexpr int kBatch = 8;
  const int vecs = C / 4;
  const int vectors = n * vecs;
  for (int f = threadIdx.x; f < vectors; f += kBatch * kConsumers) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = f + u * kConsumers;
      const int r = idx / vecs;
      const int g = first + r;
      v[u] = make_uint4(0, 0, 0, 0);
      if (idx < vectors && g >= 0 && g < seq_len)
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)g * C +
                                                    (idx - r * vecs) * 4));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = f + u * kConsumers;
      if (idx >= vectors) break;
      const int r = idx / vecs;
      if constexpr (kLrelu) lrelu16<float>(v[u], slope);
      *reinterpret_cast<uint4*>(win + (size_t)r * ld + (idx - r * vecs) * 4) =
          v[u];
    }
  }
}

// |h| <= 2^-17 ||a's window of h|| ||w1's column||: within reach of the
// 3xTF32 sum's error (its largest read on an H100 ~2^-22.4 of that product
// with folds every 32 k steps, less with kDataFoldSteps), so h's sign is
// settled by an exact sum. Compared squared.
constexpr float kTie = 1.0f / (1ull << 34);

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// h - b1 at global row t (of this batch row), output n, in f64 from x and
// w1 as they are (lrelu with the f64 slope): the whole warp, inputs over
// the lanes, summed across them.
__device__ __forceinline__ double exact_conv1(const float* __restrict__ xb,
                                              const float* __restrict__ w1,
                                              int t, int n, int seq_len, int C,
                                              int k1, int dil,
                                              double slope) {
  const int lane = threadIdx.x % 32;
  double s = 0.0;
  for (int j = 0; j < k1; ++j) {
    const int r = t + (j - (k1 - 1) / 2) * dil;
    if (r < 0 || r >= seq_len) continue;
    const float* xr = xb + (size_t)r * C;
    const float* wj = w1 + (size_t)j * C * C + n;
    for (int c = lane; c < C; c += 32) {
      const double v = __ldg(xr + c);
      s = fma(v > 0.0 ? v : v * slope, (double)__ldg(wj + (size_t)c * C), s);
    }
  }
  return warp_sum(s);
}

// The consumer warpgroups' part of both data kernels. kHidden: h from the
// lrelu(x) window (conv1, map 1), g out if asked, then dg from the gy window
// (conv2^T, map 2) and dh = dg * lrelu'(h) into out. Otherwise: conv1^T
// from the dh window (map 1) and dx = gy + lrelu'(x) * it into out.
// Accumulator element 4q + e of an m64nWN fragment is row 16 warp + lane/4
// + 8 (e / 2), output 8q + 2 (lane % 4) + e % 2.
//
// lrelu'(h) jumps at 0, so an h within the sum's error of 0 could take the
// other side from an exact h, and its dh would be off by 0.9 dg. Such h
// (kTie, from the window's row norms and w1's column norms wn2) are summed
// again exactly in f64 by their warp, and their sign taken from that.
template <int WN, int MT, bool kHidden>
__device__ __forceinline__ void data_consume(
    const float* __restrict__ x, const float* __restrict__ gy,
    const float* __restrict__ dh_in, const float* __restrict__ b1,
    const float* __restrict__ w1, const float* __restrict__ wn2,
    float* __restrict__ out, float* __restrict__ g, int seq_len, int C,
    int k1, int k2, int dil, float slope, double slope64, int stages,
    bool split_n, const Geometry& geo, uint32_t ring, float* win,
    float* biases, uint32_t full0, uint32_t empty0, int t0,
    size_t batch_off) {
  const int rows = geo.rows;
  const int halo1 = (k1 - 1) / 2 * dil;
  const int ld = geo.row_bytes / 4;
  const uint32_t window = smem_u32(win);
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int wg = threadIdx.x / 128;
  const int row0 = split_n ? 0 : wg * 64 * MT;
  const int n0 = split_n ? wg * WN : 0;
  float acc[MT][1][WN / 2];
  int it = 0;

  // squared norms of the window's rows, then of each h row's K taps
  float* rn2 = biases + 512;
  float* ra2 = rn2 + geo.win_rows;
  if constexpr (kHidden) {
    stage_window<true>(win, ld, x + batch_off, t0 - halo1, rows + 2 * halo1,
                       seq_len, C, slope);
    for (int n = threadIdx.x; n < 256; n += kConsumers)
      biases[n] = b1 != nullptr && n < C ? __ldg(b1 + n) : 0.f;
    consumers_sync();
    for (int r = threadIdx.x / 32; r < rows + 2 * halo1; r += kConsumers / 32) {
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += win[r * ld + c] * win[r * ld + c];
      sum = warp_sum(sum);
      if (lane == 0) rn2[r] = sum;
    }
    consumers_sync();
    for (int r = threadIdx.x; r < rows; r += kConsumers) {
      float sum = 0.f;
      for (int j = 0; j < k1; ++j) sum += rn2[r + j * dil];
      ra2[r] = sum;
    }
  } else {
    stage_window<false>(win, ld, dh_in + batch_off, t0 - halo1,
                        rows + 2 * halo1, seq_len, C, slope);
  }
  consumers_sync();
  conv_wgmma<float, WN, 1, MT, kDataFoldSteps>(
      acc, window, geo.row_bytes, row0, n0, geo.nbox, k1, dil, C, ring, full0,
      empty0, stages, it);

  if constexpr (kHidden) {
    // lrelu'(h) as bits (bit i of pos[mt]: h > 0), ties (tie[mt]), and
    // g = lrelu(h)
    uint64_t pos[MT], tie[MT];
    float bias[WN / 4];
    load_bias<WN>(biases, n0, bias);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pos[mt] = tie[mt] = 0;
#pragma unroll
      for (int q = 0; q < WN / 8; ++q) {
        const int n = n0 + q * 8 + 2 * (lane % 4);
        const float2 wn = n < C ? __ldg(reinterpret_cast<const float2*>(
                                      wn2 + n))
                                : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * q + 2 * half;
          const float h0 = acc[mt][0][i] + bias[2 * q];
          const float h1 = acc[mt][0][i + 1] + bias[2 * q + 1];
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          const bool valid = n < C && t0 + r < seq_len;
          pos[mt] |= (uint64_t)(h0 > 0.f) << i;
          pos[mt] |= (uint64_t)(h1 > 0.f) << (i + 1);
          if (valid) {
            tie[mt] |= (uint64_t)(h0 * h0 <= kTie * ra2[r] * wn.x) << i;
            tie[mt] |= (uint64_t)(h1 * h1 <= kTie * ra2[r] * wn.y) << (i + 1);
          }
          if (g != nullptr && valid)
            *reinterpret_cast<float2*>(g + batch_off +
                                       (size_t)(t0 + r) * C + n) =
                make_float2(lrelu(h0, slope), lrelu(h1, slope));
        }
      }
      // each tie of the warp in turn, its owner's lowest first
      for (uint32_t who; (who = __ballot_sync(~0u, tie[mt] != 0)) != 0;) {
        const int owner = __ffs(who) - 1;
        const int i =
            __shfl_sync(~0u, __ffsll((long long)tie[mt]) - 1, owner);
        const int r =
            row0 + mt * 64 + warp * 16 + owner / 4 + 8 * ((i % 4) / 2);
        const int n = n0 + (i / 4) * 8 + 2 * (owner % 4) + i % 2;
        const double h = exact_conv1(x + batch_off, w1, t0 + r, n, seq_len,
                                     C, k1, dil, slope64) +
                         (double)biases[n];
        if (lane == owner) {
          pos[mt] = h > 0.0 ? pos[mt] | (1ull << i) : pos[mt] & ~(1ull << i);
          tie[mt] &= ~(1ull << i);
        }
      }
    }
    const int halo2 = (k2 - 1) / 2;
    consumers_sync();  // both warpgroups are done reading the x window
    stage_window<false>(win, ld, gy + batch_off, t0 - halo2, rows + 2 * halo2,
                        seq_len, C, slope);
    consumers_sync();
    conv_wgmma<float, WN, 1, MT, kDataFoldSteps>(
        acc, window, geo.row_bytes, row0, n0, geo.nbox, k2, 1, C, ring, full0,
        empty0, stages, it);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < WN / 8; ++q) {
        const int n = n0 + q * 8 + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * q + 2 * half;
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          if (n >= C || t0 + r >= seq_len) continue;
          const float s0 = (pos[mt] >> i) & 1 ? 1.f : slope;
          const float s1 = (pos[mt] >> (i + 1)) & 1 ? 1.f : slope;
          *reinterpret_cast<float2*>(out + batch_off + (size_t)(t0 + r) * C +
                                     n) =
              make_float2(acc[mt][0][i] * s0, acc[mt][0][i + 1] * s1);
        }
      }
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < WN / 8; ++q) {
        const int n = n0 + q * 8 + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * q + 2 * half;
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          if (n >= C || t0 + r >= seq_len) continue;
          const size_t at = batch_off + (size_t)(t0 + r) * C + n;
          const float2 xv = __ldg(reinterpret_cast<const float2*>(x + at));
          const float2 gv = __ldg(reinterpret_cast<const float2*>(gy + at));
          *reinterpret_cast<float2*>(out + at) = make_float2(
              gv.x + (xv.x > 0.f ? 1.f : slope) * acc[mt][0][i],
              gv.y + (xv.y > 0.f ? 1.f : slope) * acc[mt][0][i + 1]);
        }
      }
    }
  }
}

// Both data kernels: the forward's block (ring, window, barriers, biases)
// with no rows lost to halos. map1 and map2 are (2k, N, depth) f32 splits
// (3D maps, as the forward's); the input kernel has k2 = 0.
template <int WN, int MT, bool kHidden>
__device__ __forceinline__ void data_block(
    uint8_t* smem_raw, const CUtensorMap* map1, const CUtensorMap* map2,
    const float* x, const float* gy, const float* dh_in, const float* b1,
    const float* w1, const float* wn2, float* out, float* g, int seq_len,
    int C, int k1, int k2, int dil, float slope, double slope64, int stages,
    int split_n) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = kHidden ? (k2 - 1) / 2 : 0;
  const bool split = split_n != 0;
  const Geometry geo = geometry(4, WN, 1, MT, split, C, halo1, halo2);
  const int stage_bytes = kStageBytesAnOutput * geo.nbox;
  float* win = reinterpret_cast<float*>(base + stages * stage_bytes);
  const uint32_t full0 = smem_u32(win) + geo.win_rows * geo.row_bytes;
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  float* biases =
      reinterpret_cast<float*>(base + (empty0 + 8 * kMaxStages - ring));
  constexpr int kChunk = Tile<float>::kChunk;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int t0 = blockIdx.x * geo.rows;
  const size_t batch_off = (size_t)blockIdx.y * seq_len * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never rejoined (setmaxnreg).
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      const int n1 = k1 * chunks;
      for (int i = 0; i < (k1 + k2) * chunks; ++i) {
        const int s = i % stages;
        mbar_wait(empty0 + 8 * s, ((i / stages) & 1) ^ 1);
        const bool first = i < n1;
        const int j = first ? i : i - n1;
        const int tap = j / chunks;
        const int chunk = j - tap * chunks;
        const CUtensorMap* map = first ? map1 : map2;
        const int k = first ? k1 : k2;
        const uint32_t dst = ring + s * stage_bytes;
        mbar_expect_tx(full0 + 8 * s, stage_bytes);
        tma_load_3d(dst, map, chunk * kChunk, 0, tap, full0 + 8 * s);
        tma_load_3d(dst + geo.nbox * 64, map, chunk * kChunk, 0, k + tap,
                    full0 + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    data_consume<WN, MT, kHidden>(x, gy, dh_in, b1, w1, wn2, out, g,
                                  seq_len, C, k1, k2, dil, slope, slope64,
                                  stages, split, geo, ring, win, biases,
                                  full0, empty0, t0, batch_off);
  }
}

// h, g and dh: map1 the forward's split of w1, map2 the flipped split of w2;
// w1 itself and its squared column norms wn2 for the ties.
template <int WN, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    pair_bwd_hidden_kernel(const __grid_constant__ CUtensorMap map1,
                           const __grid_constant__ CUtensorMap map2,
                           const float* __restrict__ x,
                           const float* __restrict__ gy,
                           const float* __restrict__ b1,
                           const float* __restrict__ w1,
                           const float* __restrict__ wn2,
                           float* __restrict__ dh, float* __restrict__ g,
                           int seq_len, int C, int k1, int k2, int dil,
                           float slope, double slope64, int stages,
                           int split_n) {
  extern __shared__ uint8_t smem_raw[];
  data_block<WN, MT, true>(smem_raw, &map1, &map2, x, gy, nullptr, b1, w1,
                           wn2, dh, g, seq_len, C, k1, k2, dil, slope,
                           slope64, stages, split_n);
}

// dx: map1 the flipped split of w1.
template <int WN, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    pair_bwd_input_kernel(const __grid_constant__ CUtensorMap map1,
                          const float* __restrict__ x,
                          const float* __restrict__ gy,
                          const float* __restrict__ dh,
                          float* __restrict__ dx, int seq_len, int C, int k1,
                          int dil, float slope, int stages, int split_n) {
  extern __shared__ uint8_t smem_raw[];
  data_block<WN, MT, false>(smem_raw, &map1, &map1, x, gy, dh, nullptr,
                            nullptr, nullptr, dx, nullptr, seq_len, C, k1, 0,
                            dil, slope, 0.0, stages, split_n);
}

// ----------------------------------------------------- weight gradient

constexpr int kWeightThreads = 256;  // two warpgroups, both multiplying
constexpr int kWeightRows = 128;     // rows of M (tap, in) a block

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Writes of the threads to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A of one k step (rows off0 and off1 of the window, k = lane % 4 and + 4
// of the step, at row offset k0), lrelu'd if act, split into tf32 hi
// (f[0..3]) and lo (f[4..7]), in wgmma's m64k8 fragment order.
__device__ __forceinline__ void load_a_rows(const float* win, int off0,
                                            int off1, int k0, int ld, int act,
                                            float slope, uint32_t (&f)[8]) {
  const float* p = win + k0 * ld;
  float a[4] = {p[off0], p[off1], p[off0 + 4 * ld], p[off1 + 4 * ld]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = act ? lrelu(a[i], slope) : a[i];
    f[i] = to_tf32(v);
    f[4 + i] = to_tf32(v - __uint_as_float(f[i]));
  }
}

// One k step: A into f, then lo*hi, hi*lo, hi*hi into part (fresh: a new
// partial sum), with at most this step's group in flight afterwards.
template <int WN>
__device__ __forceinline__ void weight_step(float (&part)[1][1][WN / 2],
                                            uint32_t (&f)[8],
                                            const float* win, int off0,
                                            int off1, int ks, int ld, int act,
                                            float slope, uint32_t bt,
                                            bool fresh) {
  load_a_rows(win, off0, off1, ks * 8 + threadIdx.x % 4, ld, act, slope, f);
  wgmma_fence();
  mma_step<float, WN>(part[0][0], f, bt + (ks / 2) * 128 * WN, 0, ks % 2, WN,
                      fresh);
  wgmma_commit();
  wgmma_wait<1>();
}

// dW partial sums of one split of the rows: part_w[split] (K C x C), and
// for the first M block the column sums of q, part_b[split] (C, f64).
// p: the activation (x with act = 1, lrelu'd here; or g), q: the gradient
// (dh or gy), both (B, T, C). blockIdx.x = n block x mblocks + m block,
// blockIdx.y = the split, which takes chunks [y cps, (y + 1) cps) of
// depth rows each (chunk c: batch c / per_row, rows (c % per_row) depth).
template <int WN>
__global__ void __launch_bounds__(kWeightThreads, 1)
    pair_bwd_weight_kernel(const float* __restrict__ p,
                           const float* __restrict__ q,
                           float* __restrict__ part_w,
                           double* __restrict__ part_b, int seq_len, int C,
                           int K, int dil, float slope, int act, int depth,
                           int wi, int ld, int mblocks, int cps, int total,
                           int per_row) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t bt = (raw + 1023) & ~1023u;  // B tiles, 16 rows a stage
  uint8_t* base = smem_raw + (bt - raw);
  float* qraw = reinterpret_cast<float*>(base + depth * 8 * WN);  // [2][depth][WN]
  const int halo = (K - 1) / 2 * dil;
  const int win_rows = depth + 2 * halo;
  float* pwin = qraw + 2 * depth * WN;  // [2][win_rows][ld]
  double* bsum = reinterpret_cast<double*>(pwin + 2 * win_rows * ld);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = (tid / 32) % 4;
  const int wg = tid / 128;
  const int mb = blockIdx.x % mblocks;
  const int n0 = (blockIdx.x / mblocks) * WN;
  const int M = K * C;
  const int i_lo = wi == C ? 0 : (mb * kWeightRows) % C;
  const bool sums = part_b != nullptr && mb == 0;
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m =
        min(mb * kWeightRows + wg * 64 + warp * 16 + lane / 4 + 8 * h, M - 1);
    const int tap = m / C;
    off[h] = (halo + (tap - (K - 1) / 2) * dil) * ld + (m - tap * C - i_lo);
  }

  const int c_begin = blockIdx.y * cps;
  const int c_end = min(c_begin + cps, total);
  auto prefetch = [&](int c, int buf) {
    const int b = c / per_row;
    const int t0 = (c - b * per_row) * depth;
    const float* pb = p + (size_t)b * seq_len * C;
    const float* qb = q + (size_t)b * seq_len * C;
    const uint32_t qdst = smem_u32(qraw + buf * depth * WN);
    for (int idx = tid; idx < depth * WN / 4; idx += kWeightThreads) {
      const int r = idx / (WN / 4);
      const int col = n0 + (idx - r * (WN / 4)) * 4;
      const bool valid = t0 + r < seq_len && col < C;
      cp_async16(qdst + (uint32_t)(r * WN + col - n0) * 4,
                 valid ? qb + (size_t)(t0 + r) * C + col : q, valid);
    }
    const uint32_t pdst = smem_u32(pwin + buf * win_rows * ld);
    for (int idx = tid; idx < win_rows * wi / 4; idx += kWeightThreads) {
      const int r = idx / (wi / 4);
      const int col = (idx - r * (wi / 4)) * 4;
      const int t = t0 - halo + r;
      const bool valid = t >= 0 && t < seq_len;
      cp_async16(pdst + (uint32_t)(r * ld + col) * 4,
                 valid ? pb + (size_t)t * C + i_lo + col : p, valid);
    }
    cp_async_commit();
  };

  float acc[1][1][WN / 2];
  float part[1][1][WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[0][0][i] = 0.f;
  uint32_t frag[2][8];
  int summed = 0;  // k steps in part since the last fold
  double colsum = 0.0;  // column n0 + tid % WN of q, rows of this thread
  if (c_begin < c_end) prefetch(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    __syncthreads();  // the last chunk's B tiles and buffers are read
    if (c + 1 < c_end) {
      prefetch(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in shared memory
    // B: q's rows [4 kq, 4 kq + 4) of output n, transposed and split into
    // the 64-byte-swizzled K-major tiles (hi, then lo, 16 rows a stage)
    const float* qb = qraw + buf * depth * WN;
    for (int idx = tid; idx < depth / 4 * WN; idx += kWeightThreads) {
      const int n = idx % WN;
      const int kq = idx / WN;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = qb[(4 * kq + e) * WN + n];
      if (sums) colsum += ((double)v[0] + v[1]) + ((double)v[2] + v[3]);
      uint4 hi, lo;
      uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = to_tf32(v[e]);
        l[e] = to_tf32(v[e] - __uint_as_float(h[e]));
      }
      uint8_t* tile = base + (kq / 4) * 128 * WN + n * 64 +
                      (((kq % 4) ^ ((n >> 1) & 3)) * 16);
      *reinterpret_cast<uint4*>(tile) = hi;
      *reinterpret_cast<uint4*>(tile + WN * 64) = lo;
    }
    fence_async_shared();
    __syncthreads();
    const float* win = pwin + buf * win_rows * ld;
    for (int ks = 0; ks < depth / 8; ks += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (summed == kWeightFoldSteps) {
          fold(acc, part);
          summed = 0;
        }
        weight_step<WN>(part, frag[u], win, off[0], off[1], ks + u, ld, act,
                        slope, bt, summed == 0);
        ++summed;
      }
    }
    wgmma_wait<0>();
    fence_operands(part[0][0]);
  }
  if (summed > 0) fold(acc, part);

  // this block's partial sums, rows mb * 128 + [0, 128) of M, outputs n0 +
  // [0, WN), in the accumulator's layout
  float* out = part_w + (size_t)blockIdx.y * M * C;
#pragma unroll
  for (int q4 = 0; q4 < WN / 8; ++q4) {
    const int n = n0 + q4 * 8 + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mb * kWeightRows + wg * 64 + warp * 16 + lane / 4 +
                    half * 8;
      if (m < M && n < C)
        *reinterpret_cast<float2*>(out + (size_t)m * C + n) =
            make_float2(acc[0][0][4 * q4 + 2 * half],
                        acc[0][0][4 * q4 + 2 * half + 1]);
    }
  }
  if (sums) {
    bsum[tid] = colsum;
    __syncthreads();
    if (tid < WN && n0 + tid < C) {
      double s = 0.0;
      for (int r = tid; r < kWeightThreads; r += WN) s += bsum[r];
      part_b[(size_t)blockIdx.y * C + n0 + tid] = s;
    }
  }
}

// dw = the splits' partial sums added in order; db likewise (f64), if asked.
__global__ void __launch_bounds__(256)
    pair_bwd_reduce_kernel(const float* __restrict__ part_w,
                           const double* __restrict__ part_b,
                           float* __restrict__ dw, float* __restrict__ db,
                           int splits, int M, int C) {
  const size_t n = (size_t)M * C;
  if (dw != nullptr) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
      float s = part_w[i];
      for (int k = 1; k < splits; ++k) s += part_w[(size_t)k * n + i];
      dw[i] = s;
    }
  }
  if (db != nullptr && blockIdx.x == 0) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      double s = part_b[c];
      for (int k = 1; k < splits; ++k) s += part_b[(size_t)k * C + c];
      db[c] = (float)s;
    }
  }
}

// ------------------------------------------------------------------ host

using HiddenKernel = void (*)(CUtensorMap, CUtensorMap, const float*,
                              const float*, const float*, const float*,
                              const float*, float*, float*, int, int, int, int,
                              int, float, double, int, int);
using InputKernel = void (*)(CUtensorMap, const float*, const float*,
                             const float*, float*, int, int, int, int, float,
                             int, int);
using WeightKernel = void (*)(const float*, const float*, float*, double*, int,
                              int, int, int, float, int, int, int, int, int,
                              int, int, int);

// The data kernels' instantiations, the forward's f32 set: WN outputs x MT
// m64 tiles a warpgroup.
HiddenKernel hidden_kernel(int wn, int mt) {
  switch (wn * 8 + mt) {
    case 128 * 8 + 1: return pair_bwd_hidden_kernel<128, 1>;
    case 64 * 8 + 1: return pair_bwd_hidden_kernel<64, 1>;
    case 64 * 8 + 2: return pair_bwd_hidden_kernel<64, 2>;
    case 32 * 8 + 1: return pair_bwd_hidden_kernel<32, 1>;
    case 32 * 8 + 2: return pair_bwd_hidden_kernel<32, 2>;
    case 32 * 8 + 4: return pair_bwd_hidden_kernel<32, 4>;
    default: return nullptr;
  }
}

InputKernel input_kernel(int wn, int mt) {
  switch (wn * 8 + mt) {
    case 128 * 8 + 1: return pair_bwd_input_kernel<128, 1>;
    case 64 * 8 + 1: return pair_bwd_input_kernel<64, 1>;
    case 64 * 8 + 2: return pair_bwd_input_kernel<64, 2>;
    case 32 * 8 + 1: return pair_bwd_input_kernel<32, 1>;
    case 32 * 8 + 2: return pair_bwd_input_kernel<32, 2>;
    case 32 * 8 + 4: return pair_bwd_input_kernel<32, 4>;
    default: return nullptr;
  }
}

WeightKernel weight_kernel(int wn) {
  switch (wn) {
    case 128: return pair_bwd_weight_kernel<128>;
    case 64: return pair_bwd_weight_kernel<64>;
    case 32: return pair_bwd_weight_kernel<32>;
    default: return nullptr;
  }
}

struct DataPlan {
  int wn, mt, stages;
  bool split_n;
  Geometry geo;
  size_t smem;
};

// Shared memory of a data kernel: the forward's, and the hidden kernel's
// row norms (rn2 over the window, ra2 over the rows).
size_t data_smem(const Geometry& geo, int stages) {
  return smem_bytes(geo, stages) + (size_t)(geo.win_rows + geo.rows) * 4;
}

// The forward's tile rule (make_plan) for f32, with every row of a block
// kept: the fewest waves x MT, ties to the larger MT, the deepest ring.
DataPlan make_data_plan(int sms, int batch, int seq_len, int C, int halo1,
                        int halo2) {
  const bool split_n = C > 128;
  const int wn = C > 64 ? 128 : C > 32 ? 64 : 32;
  DataPlan best{0, 0, 0, false, {}, 0};
  long best_cost = 0;
  for (int mt = 1; mt * wn <= 128; mt *= 2) {
    const Geometry geo = geometry(4, wn, 1, mt, split_n, C, halo1, halo2);
    int stages = kMaxStages;
    while (stages >= 2 && data_smem(geo, stages) > kMaxSmem) --stages;
    if (stages < 2) continue;
    const long blocks = (long)((seq_len + geo.rows - 1) / geo.rows) * batch;
    const long cost = (blocks + sms - 1) / sms * mt;
    if (best.mt == 0 || cost <= best_cost) {
      best = {wn, mt, stages, split_n, geo, data_smem(geo, stages)};
      best_cost = cost;
    }
  }
  return best;
}

struct WeightPlan {
  int wn, depth, wi, ld, mblocks, nblocks, splits, cps, total, per_row;
  size_t smem;
};

size_t weight_smem(int wn, int depth, int win_rows, int ld) {
  return 1024 + (size_t)depth * 8 * wn + 2 * (size_t)depth * wn * 4 +
         2 * (size_t)win_rows * ld * 4 + kWeightThreads * sizeof(double);
}

// A block's own cost (its first chunk's loads, its partial sums out, their
// reduction) in chunks, and the fewest chunks a split takes.
constexpr int kBlockChunks = 2;
constexpr int kMinChunks = 8;

// M = K C rows (tap, in) in blocks of 128, N = C in blocks of WN; the
// window holds 128 inputs where C is a multiple of 128 (a block's rows are
// one tap's), else all C, at a row stride of 8 mod 32 floats; chunks of 32
// rows (16 where the window would not fit); the splits of the B T rows
// (kMinChunks or more each) that give the fewest waves x (chunks a block +
// kBlockChunks), ties to fewer splits.
WeightPlan make_weight_plan(int sms, int batch, int seq_len, int C, int K,
                            int dil) {
  WeightPlan plan{};
  plan.wn = C > 64 ? 128 : C > 32 ? 64 : 32;
  plan.wi = C % 128 == 0 ? 128 : C;
  plan.ld = plan.wi + (8 - plan.wi % 32 + 32) % 32;
  const int halo = (K - 1) / 2 * dil;
  plan.depth = 32;
  while (plan.depth > 16 &&
         weight_smem(plan.wn, plan.depth, plan.depth + 2 * halo, plan.ld) >
             kMaxSmem)
    plan.depth /= 2;
  plan.smem = weight_smem(plan.wn, plan.depth, plan.depth + 2 * halo, plan.ld);
  if (plan.smem > kMaxSmem) return WeightPlan{};
  plan.mblocks = (K * C + kWeightRows - 1) / kWeightRows;
  plan.nblocks = (C + plan.wn - 1) / plan.wn;
  plan.per_row = (seq_len + plan.depth - 1) / plan.depth;
  plan.total = batch * plan.per_row;
  const long tiles = (long)plan.mblocks * plan.nblocks;
  long best = -1;
  for (int s = 1; s <= plan.total && s <= 4 * sms; ++s) {
    const int cps = (plan.total + s - 1) / s;
    if (s > 1 && cps < kMinChunks) break;
    const int splits = (plan.total + cps - 1) / cps;
    const long cost = (tiles * splits + sms - 1) / sms * (cps + kBlockChunks);
    if (best < 0 || cost < best) {
      best = cost;
      plan.cps = cps;
      plan.splits = splits;
    }
  }
  return plan;
}

// The SM count of the device, with the kernels' shared-memory limits set
// on first use; the plans, cached per shape.
cudaError_t device_sms(int device, int* sms) {
  static std::map<int, int> sms_of;
  const auto it = sms_of.find(device);
  if (it != sms_of.end()) {
    *sms = it->second;
    return cudaSuccess;
  }
  auto allow = [](const void* kernel) {
    return kernel == nullptr
               ? cudaSuccess
               : cudaFuncSetAttribute(kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kMaxSmem);
  };
  for (int wn = 32; wn <= 128; wn *= 2) {
    for (int mt = 1; mt <= 4; mt *= 2) {
      cudaError_t err =
          allow(reinterpret_cast<const void*>(hidden_kernel(wn, mt)));
      if (err == cudaSuccess)
        err = allow(reinterpret_cast<const void*>(input_kernel(wn, mt)));
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err =
        allow(reinterpret_cast<const void*>(weight_kernel(wn)));
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  sms_of[device] = *sms;
  return cudaSuccess;
}

struct Plans {
  DataPlan hidden, input;
  WeightPlan w1, w2;
};

cudaError_t plans_for(int batch, int seq_len, int C, int k1, int k2, int dil,
                      Plans* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::map<std::array<int, 7>, Plans> cache;
  const std::array<int, 7> key{device, batch, seq_len, C, k1, k2, dil};
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int sms = 0;
  err = device_sms(device, &sms);
  if (err != cudaSuccess) return err;
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  Plans p{make_data_plan(sms, batch, seq_len, C, halo1, halo2),
          make_data_plan(sms, batch, seq_len, C, halo1, 0),
          make_weight_plan(sms, batch, seq_len, C, k1, dil),
          make_weight_plan(sms, batch, seq_len, C, k2, 1)};
  if (p.hidden.mt == 0 || p.input.mt == 0 || p.w1.wn == 0 || p.w2.wn == 0)
    return cudaErrorInvalidValue;  // does not fit
  cache[key] = p;
  *out = p;
  return cudaSuccess;
}

// The workspace: the three weight splits, w1's column norms, dh, g (for
// dw2), and each
// weight's partial sums (f32) and column sums (f64); 256-byte aligned.
struct Layout {
  size_t s1, r1, r2, wn2, dh, g, pw1, pb1, pw2, pb2, bytes;
};

Layout layout(const Plans& p, int batch, int seq_len, int C, int k1, int k2,
              bool w1, bool w2) {
  Layout l{};
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const size_t cc = (size_t)C * C * sizeof(float);
  const size_t act = (size_t)batch * seq_len * C * sizeof(float);
  l.s1 = take(2 * k1 * cc);
  l.r1 = take(2 * k1 * cc);
  l.r2 = take(2 * k2 * cc);
  l.wn2 = take((size_t)C * sizeof(float));
  l.dh = take(act);
  l.g = w2 ? take(act) : 0;
  if (w1) {
    l.pw1 = take((size_t)p.w1.splits * k1 * cc);
    l.pb1 = take((size_t)p.w1.splits * C * sizeof(double));
  }
  if (w2) {
    l.pw2 = take((size_t)p.w2.splits * k2 * cc);
    l.pb2 = take((size_t)p.w2.splits * C * sizeof(double));
  }
  l.bytes = at;
  return l;
}

bool valid_shape(int batch, int seq_len, int C, int k1, int k2, int dil) {
  return batch > 0 && seq_len > 0 && C >= 8 && C <= 256 && C % 8 == 0 &&
         k1 >= 1 && k2 >= 1 && k1 % 2 == 1 && k2 % 2 == 1 && dil >= 1;
}

cudaError_t launch_weight(const WeightPlan& plan, const float* p,
                          const float* q, float* part_w, double* part_b,
                          float* dw, float* db, int seq_len, int C, int K,
                          int dil, float slope, int act, cudaStream_t stream) {
  const dim3 grid(plan.mblocks * plan.nblocks, plan.splits);
  weight_kernel(plan.wn)<<<grid, kWeightThreads, plan.smem, stream>>>(
      p, q, part_w, part_b, seq_len, C, K, dil, slope, act, plan.depth,
      plan.wi, plan.ld, plan.mblocks, plan.cps, plan.total, plan.per_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int m = K * C;
  const int blocks = (int)(((size_t)m * C + 255) / 256 < 1024
                               ? ((size_t)m * C + 255) / 256
                               : 1024);
  pair_bwd_reduce_kernel<<<blocks, 256, 0, stream>>>(
      part_w, part_b, dw, db, plan.splits, m, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of workspace resblock_pair_backward_f32 needs for this shape, with
// the weight gradients it will compute (need_w1: dw1 or db1; need_w2: dw2 or
// db2). Returns the cudaError_t (the plans need the current device).
int resblock_pair_backward_workspace(int batch, int seq_len, int channels,
                                     int k1, int k2, int dilation,
                                     int need_w1, int need_w2,
                                     size_t* bytes) {
  if (!valid_shape(batch, seq_len, channels, k1, k2, dilation))
    return (int)cudaErrorInvalidValue;
  Plans plans;
  const cudaError_t err =
      plans_for(batch, seq_len, channels, k1, k2, dilation, &plans);
  if (err != cudaSuccess) return (int)err;
  *bytes = layout(plans, batch, seq_len, channels, k1, k2, need_w1 != 0,
                  need_w2 != 0)
               .bytes;
  return (int)cudaSuccess;
}

// The pair's gradients from x, gy (B, T, C), w1 (k1, C, C), b1 (C or
// null), w2 (k2, C, C), all f32: dx (null: not computed), dw1 and db1
// (computed if either is not null; each written if not null), dw2 and db2
// likewise. ws: at least resblock_pair_backward_workspace's bytes,
// 256-byte aligned. C a multiple of 8 up to 256 (the wrapper pads), x, gy
// and dx 16-byte aligned. The slope is lrelu's, in f64 as the ties' exact
// sums take it (f32 elsewhere). Launches on stream and does not synchronise;
// returns the cudaError_t of the launches.
int resblock_pair_backward_f32(const void* x, const void* gy, const void* w1,
                               const void* b1, const void* w2, void* dx,
                               void* dw1, void* db1, void* dw2, void* db2,
                               void* ws, size_t ws_bytes, int batch,
                               int seq_len, int channels, int k1, int k2,
                               int dilation, double slope64, void* stream) {
  const int C = channels;
  const float slope = (float)slope64;
  if (!valid_shape(batch, seq_len, C, k1, k2, dilation))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(gy, 16) || !aligned(ws, 256) ||
      (dx != nullptr && !aligned(dx, 16)))
    return (int)cudaErrorMisalignedAddress;
  const bool need_w1 = dw1 != nullptr || db1 != nullptr;
  const bool need_w2 = dw2 != nullptr || db2 != nullptr;
  Plans plans;
  cudaError_t err = plans_for(batch, seq_len, C, k1, k2, dilation, &plans);
  if (err != cudaSuccess) return (int)err;
  const Layout l = layout(plans, batch, seq_len, C, k1, k2, need_w1, need_w2);
  if (ws_bytes < l.bytes) return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(ws);
  float* s1 = reinterpret_cast<float*>(base + l.s1);
  float* r1 = reinterpret_cast<float*>(base + l.r1);
  float* r2 = reinterpret_cast<float*>(base + l.r2);
  float* dh = reinterpret_cast<float*>(base + l.dh);
  float* g = need_w2 ? reinterpret_cast<float*>(base + l.g) : nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gyf = static_cast<const float*>(gy);

  float* wn2 = reinterpret_cast<float*>(base + l.wn2);
  const float* w1f = static_cast<const float*>(w1);
  const int tiles = (C + 31) / 32;
  pair_bwd_split_kernel<<<dim3(tiles, tiles, 2 * k1 + k2 + 1), dim3(32, 8),
                          0, st>>>(w1f, static_cast<const float*>(w2), s1, r1,
                                   r2, wn2, C, k1, k2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  {
    const DataPlan& plan = plans.hidden;
    CUtensorMap map1, map2;
    err = cached_weight_map<float>(&map1, s1, k1, C, plan.geo.nbox);
    if (err == cudaSuccess)
      err = cached_weight_map<float>(&map2, r2, k2, C, plan.geo.nbox);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((seq_len + plan.geo.rows - 1) / plan.geo.rows, batch);
    hidden_kernel(plan.wn, plan.mt)<<<grid, kWgThreads, plan.smem, st>>>(
        map1, map2, xf, gyf, static_cast<const float*>(b1), w1f, wn2, dh, g,
        seq_len, C, k1, k2, dilation, slope, slope64, plan.stages,
        plan.split_n ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dx != nullptr) {
    const DataPlan& plan = plans.input;
    CUtensorMap map1;
    err = cached_weight_map<float>(&map1, r1, k1, C, plan.geo.nbox);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((seq_len + plan.geo.rows - 1) / plan.geo.rows, batch);
    input_kernel(plan.wn, plan.mt)<<<grid, kWgThreads, plan.smem, st>>>(
        map1, xf, gyf, dh, static_cast<float*>(dx), seq_len, C, k1, dilation,
        slope, plan.stages, plan.split_n ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (need_w2) {
    err = launch_weight(plans.w2, g, gyf,
                        reinterpret_cast<float*>(base + l.pw2),
                        db2 != nullptr
                            ? reinterpret_cast<double*>(base + l.pb2)
                            : nullptr,
                        static_cast<float*>(dw2), static_cast<float*>(db2),
                        seq_len, C, k2, 1, slope, 0, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (need_w1) {
    err = launch_weight(plans.w1, xf, dh,
                        reinterpret_cast<float*>(base + l.pw1),
                        db1 != nullptr
                            ? reinterpret_cast<double*>(base + l.pb1)
                            : nullptr,
                        static_cast<float*>(dw1), static_cast<float*>(db1),
                        seq_len, C, k1, dilation, slope, 1, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
