// Fused HiFi-GAN residual pair for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by articulatory_tpu_torch/ops/resblock_pair.py).
//
// Replaces articulatory_tpu/ops/pallas/resblock.py::resblock_pair_pallas:
//
//     y = x + conv2(lrelu(conv1(lrelu(x), dilation=d)))
//
// over x (B, T, C), SAME zero padding, with the folded (post weight norm)
// kernels w1 (K1, C, C) and w2 (K2, C, C) in (tap, in, out) order. conv2 has
// dilation 1 and sees zeros outside [0, T), exactly as the unfused pair does.
// A pair does 4*T*C*C*K flops against 2*T*C elements of activation traffic,
// 2*C*K flops per element, from 96 (C 32, K 3) to 5632 (C 256, K 11).
//
// One kernel template, resblock_pair_wgmma<T, WN, NB, MT>, runs both types
// on the tensor cores with f32 accumulators in registers. Each convolution
// is an implicit GEMM, M = time rows, N = output channels, depth = C x K:
// - A, the activations: lrelu(x) is staged once per block in T in shared
//   memory over the rows plus both halos (row stride C * sizeof(T) + 16
//   bytes, so the eight rows of an ldmatrix fall on distinct banks). Tap j's
//   A is the window shifted by j*d rows, which is no multiple of a swizzle
//   atom, so A goes to registers with ldmatrix (any 16-byte row address)
//   and wgmma takes it from there. A k step is 32 bytes of a row in both
//   types, so the same x4 ldmatrix gives each thread its fragment: rows
//   lane/4 and +8, 16-bit k pairs (bf16) or 32-bit k values (tf32) lane%4
//   and +4.
// - B, the weights: one ring stage holds the (tap, input chunk) tile of w1
//   and then of w2 for the block's outputs, 128 bytes an output channel,
//   read by TMA with swizzle into a ring of up to 6 stages with full/empty
//   mbarriers. One thread of a producer warpgroup keeps the ring full; the
//   producer hands its registers to the two consumer warpgroups
//   (setmaxnreg, 40 and 232 a thread), which run wgmma on each tile.
//   Out-of-range rows and columns of a box are filled with zeros by TMA.
// - h never leaves the SM: conv1 computes the block's rows of h (the tile
//   plus conv2's halo), its epilogue adds b1, applies lrelu, zeroes rows
//   outside [0, T), and writes h over the x window once both warpgroups are
//   past conv1. conv2 reads it the same way. Its epilogue loads the tile's x
//   into the window with 16-byte loads, writes y = x + (acc + b2) over it in
//   the accumulator's layout, and copies y out with 16-byte stores.
// - The tile rule (make_plan) picks MT m64 tiles per warpgroup from the SM
//   count and the shape, for the fewest waves x rows, and the deepest ring
//   that fits; plans are cached per shape.
//
// bfloat16 (the hybrid decode's stages 0-2): bf16 in and out, wgmma
// m64n64k16. Against 989 TFLOP/s and 3.35 TB/s the pair is bound by
// operations at C 256/128/64 and by bytes at C 32. B is a 64 x 64 box a 64
// output channels, read with 128-byte swizzle straight from the (tap, in,
// out) layout (out contiguous: wgmma's transposed, MN-major B), so the host
// does no layout work; N 64 blocks side by side (NB), both warpgroups split
// the rows (128 * MT a block). Staged activations, h and y are rounded to
// bf16, sums are f32.
//
// float32 (the parity mode: the f32 decode, hybrid stage 3, all of
// training): 3xTF32 on wgmma m64nNk8.f32.tf32.tf32, N = 32, 64 or 128 a
// warpgroup. Each operand is split into two tf32 values, a = a_hi + a_lo
// (cvt.rna: a_hi = tf32(a), a_lo = tf32(a - a_hi)), and every k step
// issues lo*hi, hi*lo, then hi*hi into the same f32 accumulators: about 22
// bits of each product, so the kernel holds f32's tolerances, where one
// tf32 product (11 bits) would not. Bound by operations at every stage:
// three tf32 products a multiply-add, 165 TFLOP/s effective of the 495
// TF32 peak (2.5x the 67 TFLOP/s of fp32 FMAs).
// - A is split in registers after ldmatrix; lrelu(x) and h stay f32.
// - The tensor cores' own additions truncate, so each convolution sums 32
//   k steps at a time in a partial sum and folds it into the accumulators
//   with f32 adds (conv_wgmma); one sum over the whole depth missed f32's
//   limit against a float64 pair (1e-5 of max |y|) at C 256, K 11.
// - wgmma takes 32-bit B only K-major, and the (tap, in, out) layout is
//   MN-major, so split_tf32_kernel (below; the wrapper caches its output on
//   the decode's frozen kernels and runs it every call in training) writes
//   w_hi and w_lo as one (2, K, out, in) tensor. TMA reads (16 inputs x N
//   outputs) boxes of it with 64-byte swizzle, hi then lo, 128 bytes an
//   output, into each ring stage.
// - C 256 does not fit the bf16 layout (a 128-row window is 185 KB at
//   1040 bytes a row), so above C 128 a block takes 64 rows of h and each
//   warpgroup half of the outputs (split_n); at C <= 128 the warpgroups
//   split the rows (128 * MT). Shared memory at the worst halo (K 11, d 5:
//   rows + 50 window rows), ring stages x stage bytes + window:
//   C 256: 3 x 32 KB + 114 x 1040 B = 220,032 B in all;
//   C 128: 6 x 16 KB + 178 x 528 B = 195,456 B;
//   C 64 (MT 2): 6 x 8 KB + 306 x 272 B = 135,552 B;
//   C 32 (MT 4): 6 x 4 KB + 562 x 144 B = 108,672 B
//   (plus 1024 bytes of alignment slack, barriers and biases).
// - C is a multiple of 8 (the wrapper zero-pads other C); N above C reads
//   zero weights and is not written.
//
// The mbarrier, TMA, ldmatrix and wgmma wrappers, the tf32 split, the fold
// and the tensor-map encoder are in hopper.cuh, shared with
// scale_disc_head.cu; one convolution of the pair (conv_wgmma), the block
// geometry and the weights' tensor maps in pair_conv.cuh, shared with the
// pair's backward (resblock_pair_backward.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "pair_conv.cuh"
#include "vec.cuh"

namespace {

using namespace port_kernels;

// The consumer warpgroups' part of the kernel: stage x, conv1, h, conv2, y.
// A wgmma group holds one or two k steps; two A-fragment buffers let one
// group's ldmatrix overlap the previous group's products.
template <typename T, int WN, int NB, int MT>
__device__ __forceinline__ void consume(
    const T* __restrict__ x, const T* __restrict__ b1, const T* __restrict__ b2,
    T* __restrict__ y, int seq_len, int C, int k1, int k2, int dil,
    float slope, int stages, bool split_n, const Geometry& geo, uint32_t ring,
    T* win, float* biases, uint32_t full0, uint32_t empty0, int t0,
    size_t batch_off) {
  const int rows = geo.rows;  // h rows conv1 computes
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  const int tile = rows - 2 * halo2;  // output rows of the block
  const int pad = halo1 + halo2;
  const int ld = geo.row_bytes / (int)sizeof(T);  // window row stride
  const uint32_t window = smem_u32(win);
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int wg = threadIdx.x / 128;
  // this warpgroup's rows and outputs
  const int row0 = split_n ? 0 : wg * 64 * MT;
  const int n0 = split_n ? wg * NB * WN : 0;
  const T* xb = x + batch_off;
  T* yb = y + batch_off;
  constexpr int kPerVec = 16 / sizeof(T);  // elements of a 16-byte vector
  const int vecs = C / kPerVec;             // 16-byte vectors a row

  // 1. window = lrelu(x) over [t0 - pad, t0 - pad + rows + 2*halo1), in T;
  //    zeros outside [0, T). kBatch loads in flight a thread.
  constexpr int kBatch = 8;
  const int vectors = (rows + 2 * halo1) * vecs;
  for (int first = threadIdx.x; first < vectors;
       first += kBatch * kConsumers) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = first + u * kConsumers;
      const int r = idx / vecs;
      const int g = t0 - pad + r;
      v[u] = make_uint4(0, 0, 0, 0);
      if (idx < vectors && g >= 0 && g < seq_len)
        v[u] = __ldg(reinterpret_cast<const uint4*>(
            xb + (size_t)g * C + (idx - r * vecs) * kPerVec));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = first + u * kConsumers;
      if (idx >= vectors) break;
      const int r = idx / vecs;
      lrelu16<T>(v[u], slope);
      *reinterpret_cast<uint4*>(win + (size_t)r * ld +
                                (idx - r * vecs) * kPerVec) = v[u];
    }
  }
  for (int n = threadIdx.x; n < 2 * 256; n += kConsumers) {
    const T* b = n < 256 ? b1 : b2;
    const int c = n % 256;
    biases[n] = b != nullptr && c < C ? load1(b + c) : 0.f;
  }
  consumers_sync();

  float acc[MT][NB][WN / 2];
  int it = 0;
  conv_wgmma<T, WN, NB, MT>(acc, window, geo.row_bytes, row0, n0, geo.nbox,
                            k1, dil, C, ring, full0, empty0, stages, it);
  consumers_sync();  // both warpgroups are done reading the x window

  // 2. h = T(lrelu(T(conv1 + b1))) over [t0 - halo2, t0 - halo2 + rows),
  //    zeros outside [0, T), written over the window. Accumulator element
  //    4q + e of an m64nWN fragment is row 16 warp + lane/4 + 8 (e / 2),
  //    output 8q + 2 (lane % 4) + e % 2.
  for (int idx = threadIdx.x; idx < 2 * halo2 * vecs; idx += kConsumers) {
    const int r = idx / vecs;  // rows conv2 reads only for rows it drops
    *reinterpret_cast<uint4*>(win + (size_t)(rows + r) * ld +
                              (idx - r * vecs) * kPerVec) =
        make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float bias[WN / 4];
    load_bias<WN>(biases, n0 + nb * WN, bias);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < WN / 8; ++q) {
        const int n = n0 + nb * WN + q * 8 + 2 * (lane % 4);
        if (n >= C) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          const int g = t0 - halo2 + r;
          float h0 = 0.f, h1 = 0.f;
          if (g >= 0 && g < seq_len) {
            h0 = lrelu(working<T>(acc[mt][nb][4 * q + 2 * half] + bias[2 * q]),
                       slope);
            h1 = lrelu(working<T>(acc[mt][nb][4 * q + 2 * half + 1] +
                                  bias[2 * q + 1]),
                       slope);
          }
          store2<T>(win + (size_t)r * ld + n, h0, h1);
        }
      }
    }
  }
  consumers_sync();

  // 3. y = x + (conv2(h) + b2), rounded once, over [t0, t0 + tile) in [0, T)
  conv_wgmma<T, WN, NB, MT>(acc, window, geo.row_bytes, row0, n0, geo.nbox,
                            k2, 1, C, ring, full0, empty0, stages, it);
  // x of the tile's rows, loaded whole with 16-byte loads into the window
  // (free once both warpgroups are past conv2), then read in the
  // accumulator's layout
  consumers_sync();
  {
    const int vectors = tile * vecs;
    for (int first = threadIdx.x; first < vectors;
         first += kBatch * kConsumers) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = first + u * kConsumers;
        const int r = idx / vecs;
        v[u] = make_uint4(0, 0, 0, 0);
        if (idx < vectors && t0 + r < seq_len)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              xb + (size_t)(t0 + r) * C + (idx - r * vecs) * kPerVec));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = first + u * kConsumers;
        if (idx >= vectors) break;
        const int r = idx / vecs;
        *reinterpret_cast<uint4*>(win + (size_t)r * ld +
                                  (idx - r * vecs) * kPerVec) = v[u];
      }
    }
  }
  consumers_sync();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float bias[WN / 4];
    load_bias<WN>(biases + 256, n0 + nb * WN, bias);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < WN / 8; ++q) {
        const int n = n0 + nb * WN + q * 8 + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          const int g = t0 + r;
          if (n < C && r < tile && g < seq_len) {
            T* p = win + (size_t)r * ld + n;
            const float2 xf = load2<T>(p);
            store2<T>(p,
                      xf.x + (acc[mt][nb][4 * q + 2 * half] + bias[2 * q]),
                      xf.y + (acc[mt][nb][4 * q + 2 * half + 1] +
                              bias[2 * q + 1]));
          }
        }
      }
    }
  }
  // y of the tile, written over its x in the window, goes out in 16-byte
  // stores
  consumers_sync();
  for (int idx = threadIdx.x; idx < tile * vecs; idx += kConsumers) {
    const int r = idx / vecs;
    if (t0 + r >= seq_len) break;
    const int c = (idx - r * vecs) * kPerVec;
    *reinterpret_cast<uint4*>(yb + (size_t)(t0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(win + (size_t)r * ld + c);
  }
}

// w1_map and w2_map: bf16, the (tap, in, out) weights as 2D maps; f32, the
// (2, tap, out, in) tf32 splits as 3D maps (split_tf32_kernel).
template <typename T, int WN, int NB, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    resblock_pair_wgmma(const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const T* __restrict__ x, const T* __restrict__ b1,
                        const T* __restrict__ b2, T* __restrict__ y,
                        int seq_len, int C, int k1, int k2, int dil,
                        float slope, int stages, int split_n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  // only f32 splits the outputs; bf16 keeps the row split at compile time
  const bool split = std::is_same_v<T, float> && split_n != 0;
  const Geometry geo = geometry(sizeof(T), WN, NB, MT, split, C, halo1,
                                halo2);
  const int stage_bytes = kStageBytesAnOutput * geo.nbox;
  T* win = reinterpret_cast<T*>(base + stages * stage_bytes);
  const uint32_t full0 = smem_u32(win) + geo.win_rows * geo.row_bytes;
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  float* biases =
      reinterpret_cast<float*>(base + (empty0 + 8 * kMaxStages - ring));
  constexpr int kChunk = Tile<T>::kChunk;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int t0 = blockIdx.x * (geo.rows - 2 * halo2);
  const size_t batch_off = (size_t)blockIdx.y * seq_len * C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never rejoined, so that ptxas applies
  // setmaxnreg to each.
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    // producer: every (tap, chunk) tile of w1, then of w2, through the ring
    if (threadIdx.x == kConsumers) {
      const int n1 = k1 * chunks;
      for (int i = 0; i < (k1 + k2) * chunks; ++i) {
        const int s = i % stages;
        mbar_wait(empty0 + 8 * s, ((i / stages) & 1) ^ 1);
        const bool first = i < n1;
        const int j = first ? i : i - n1;
        const int tap = j / chunks;
        const int chunk = j - tap * chunks;
        const CUtensorMap* map = first ? &w1_map : &w2_map;
        const uint32_t dst = ring + s * stage_bytes;
        mbar_expect_tx(full0 + 8 * s, stage_bytes);
        if constexpr (std::is_same_v<T, float>) {
          // hi at tap, lo at k + tap of the (2k, out, in) map
          const int k = first ? k1 : k2;
          tma_load_3d(dst, map, chunk * kChunk, 0, tap, full0 + 8 * s);
          tma_load_3d(dst + geo.nbox * 64, map, chunk * kChunk, 0, k + tap,
                      full0 + 8 * s);
        } else {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            tma_load_2d(dst + nb * kBf16Box * kBf16Box * 2, map,
                        nb * kBf16Box, tap * C + chunk * kChunk,
                        full0 + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<T, WN, NB, MT>(x, b1, b2, y, seq_len, C, k1, k2, dil, slope,
                           stages, split, geo, ring, win, biases,
                           full0, empty0, t0, batch_off);
  }
}

// w1 (k1, C, C) and w2 (k2, C, C), (tap, in, out) f32, into s1 (2, k1, C, C)
// and s2 (2, k2, C, C), (tap, out, in): [0] tf32(w), [1] tf32(w - [0]).
// A 32 x 32 tile of one tap a block, transposed through shared memory;
// blockIdx.z runs over the taps of w1 and then of w2.
__global__ void __launch_bounds__(256)
    split_tf32_kernel(const float* __restrict__ w1,
                      const float* __restrict__ w2, float* __restrict__ s1,
                      float* __restrict__ s2, int C, int k1, int k2) {
  __shared__ float tile[32][33];
  const bool second = blockIdx.z >= (unsigned)k1;
  const int tap = second ? blockIdx.z - k1 : blockIdx.z;
  const int k = second ? k2 : k1;
  const float* w = (second ? w2 : w1) + (size_t)tap * C * C;
  float* s = second ? s2 : s1;
  const int in0 = blockIdx.y * 32, out0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = in0 + r, o = out0 + threadIdx.x;
    tile[r][threadIdx.x] = i < C && o < C ? __ldg(w + (size_t)i * C + o) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int o = out0 + r, i = in0 + threadIdx.x;
    if (o >= C || i >= C) continue;
    const float v = tile[threadIdx.x][r];
    const uint32_t hi = to_tf32(v);
    const uint32_t lo = to_tf32(v - __uint_as_float(hi));
    s[((size_t)tap * C + o) * C + i] = __uint_as_float(hi);
    s[((size_t)(k + tap) * C + o) * C + i] = __uint_as_float(lo);
  }
}


template <typename T>
using PairKernel = void (*)(CUtensorMap, CUtensorMap, const T*, const T*,
                            const T*, T*, int, int, int, int, int, float, int,
                            int);

// The instantiations. bf16: NB 64-wide output blocks (ceil(C / 64)) x MT
// m64 tiles a warpgroup, at most 128 accumulator registers a thread. f32:
// one block of WN outputs (32, 64 or 128) x MT, at most 64 accumulator
// registers a thread (the tf32 A fragments take twice the registers).
template <typename T>
PairKernel<T> pair_kernel(int wn, int nb, int mt);

template <>
PairKernel<__nv_bfloat16> pair_kernel<__nv_bfloat16>(int wn, int nb,
                                                  int mt) {
  using B = __nv_bfloat16;
  if (wn != 64) return nullptr;
  switch (nb * 8 + mt) {
    case 1 * 8 + 1: return resblock_pair_wgmma<B, 64, 1, 1>;
    case 1 * 8 + 2: return resblock_pair_wgmma<B, 64, 1, 2>;
    case 1 * 8 + 4: return resblock_pair_wgmma<B, 64, 1, 4>;
    case 2 * 8 + 1: return resblock_pair_wgmma<B, 64, 2, 1>;
    case 2 * 8 + 2: return resblock_pair_wgmma<B, 64, 2, 2>;
    case 3 * 8 + 1: return resblock_pair_wgmma<B, 64, 3, 1>;
    case 4 * 8 + 1: return resblock_pair_wgmma<B, 64, 4, 1>;
    default: return nullptr;
  }
}

template <>
PairKernel<float> pair_kernel<float>(int wn, int nb, int mt) {
  if (nb != 1) return nullptr;
  switch (wn * 8 + mt) {
    case 128 * 8 + 1: return resblock_pair_wgmma<float, 128, 1, 1>;
    case 64 * 8 + 1: return resblock_pair_wgmma<float, 64, 1, 1>;
    case 64 * 8 + 2: return resblock_pair_wgmma<float, 64, 1, 2>;
    case 32 * 8 + 1: return resblock_pair_wgmma<float, 32, 1, 1>;
    case 32 * 8 + 2: return resblock_pair_wgmma<float, 32, 1, 2>;
    case 32 * 8 + 4: return resblock_pair_wgmma<float, 32, 1, 4>;
    default: return nullptr;
  }
}

struct Plan {
  int wn, nb, mt, stages;
  bool split_n;
  Geometry geo;
  size_t smem;
};

// The tile rule. The outputs a warpgroup takes follow from C (bf16: all C
// in 64-wide blocks; f32: WN = 32, 64 or 128, and above C 128 the two
// warpgroups split the outputs of 64 shared rows). A block computes
// (64 or 128) * MT rows of h and keeps that less 2 * halo2 rows of y, and
// its time grows with MT; blocks run one an SM (the ring and the window fill
// its shared memory). Take the MT with the fewest waves x MT, ties to the
// larger MT (fewer weight tiles read a row), and the deepest ring (up to
// kMaxStages) that fits.
template <typename T>
Plan make_plan(int sms, int batch, int seq_len, int C, int halo1, int halo2) {
  constexpr bool f32 = std::is_same_v<T, float>;
  const bool split_n = f32 && C > 128;
  const int wn = f32 ? (C > 64 ? 128 : C > 32 ? 64 : 32) : 64;
  const int nb = f32 ? 1 : (C + 63) / 64;
  const int max_n = f32 ? 128 : 256;  // MT * NB * WN, the accumulators' cap
  Plan best{0, 0, 0, 0, false, {}, 0};
  long best_cost = 0;
  for (int mt = 1; mt * nb * wn <= max_n; mt *= 2) {
    const Geometry geo =
        geometry(sizeof(T), wn, nb, mt, split_n, C, halo1, halo2);
    const int tile = geo.rows - 2 * halo2;
    if (tile < 1) continue;
    int stages = kMaxStages;
    while (stages >= 2 && smem_bytes(geo, stages) > kMaxSmem) --stages;
    if (stages < 2) continue;
    const long blocks = (long)((seq_len + tile - 1) / tile) * batch;
    const long cost = (blocks + sms - 1) / sms * mt;
    if (best.mt == 0 || cost <= best_cost) {
      best = {wn, nb, mt, stages, split_n, geo, smem_bytes(geo, stages)};
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch_pair(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* y, int batch, int seq_len, int C, int k1,
                int k2, int dil, float slope, cudaStream_t stream) {
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  Plan plan{0, 0, 0, 0, false, {}, 0};
  {
    static std::map<int, int> sms_of;  // device -> SM count, attributes set
    static std::map<std::array<int, 6>, Plan> plans;  // shape -> plan
    const std::array<int, 6> key{device, batch, seq_len, C, halo1, halo2};
    std::lock_guard<std::mutex> lock(cache_mutex);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      plan = it->second;
    } else {
      if (sms_of.find(device) == sms_of.end()) {
        for (int wn = 32; wn <= 128; wn *= 2) {
          for (int nb = 1; nb <= 4; ++nb) {
            for (int mt = 1; mt <= 4; mt *= 2) {
              const PairKernel<T> kernel = pair_kernel<T>(wn, nb, mt);
              if (kernel == nullptr) continue;
              err = cudaFuncSetAttribute(
                  kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  (int)kMaxSmem);
              if (err != cudaSuccess) return (int)err;
            }
          }
        }
        int sms = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return (int)err;
        sms_of[device] = sms;
      }
      plan = make_plan<T>(sms_of[device], batch, seq_len, C, halo1, halo2);
      if (plan.mt == 0) return (int)cudaErrorInvalidValue;  // does not fit
      plans[key] = plan;
    }
  }
  CUtensorMap w1_map, w2_map;
  err = cached_weight_map<T>(&w1_map, w1, k1, C, plan.geo.nbox);
  if (err == cudaSuccess)
    err = cached_weight_map<T>(&w2_map, w2, k2, C, plan.geo.nbox);
  if (err != cudaSuccess) return (int)err;
  const int tile = plan.geo.rows - 2 * halo2;
  const dim3 grid((seq_len + tile - 1) / tile, batch);
  const PairKernel<T> kernel = pair_kernel<T>(plan.wn, plan.nb, plan.mt);
  kernel<<<grid, kWgThreads, plan.smem, stream>>>(
      w1_map, w2_map, static_cast<const T*>(x), static_cast<const T*>(b1),
      static_cast<const T*>(b2), static_cast<T*>(y), seq_len, C, k1, k2, dil,
      slope, plan.stages, plan.split_n ? 1 : 0);
  return (int)cudaGetLastError();
}

// C a multiple of Tile<T>::kStep up to 256 (the wrapper pads other C) and
// 16-byte aligned x, y and weights (for f32, the tf32 splits).
template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* y, int batch, int seq_len, int C, int k1,
             int k2, int dil, float slope, void* stream) {
  constexpr int kStep = Tile<T>::kStep;
  if (batch < 0 || seq_len < 0 || C < kStep || C > 256 || C % kStep != 0 ||
      k1 < 1 || k2 < 1 || dil < 1 || k1 % 2 == 0 || k2 % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w1, 16) || !aligned(w2, 16) ||
      !aligned(y, 16))
    return (int)cudaErrorMisalignedAddress;
  if (batch == 0 || seq_len == 0) return (int)cudaSuccess;
  return launch_pair<T>(x, w1, b1, w2, b2, y, batch, seq_len, C, k1, k2, dil,
                        slope, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). b1 and b2 may be
// null (no bias). stream is a cudaStream_t; the call does not synchronise.

// f32: s1 and s2 are the tf32 splits of w1 and w2
// (resblock_pair_split_tf32).
int resblock_pair_f32(const void* x, const void* s1, const void* b1,
                      const void* s2, const void* b2, void* y, int batch,
                      int seq_len, int channels, int k1, int k2, int dilation,
                      float slope, void* stream) {
  return dispatch<float>(x, s1, b1, s2, b2, y, batch, seq_len, channels, k1,
                         k2, dilation, slope, stream);
}

int resblock_pair_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, int batch,
                       int seq_len, int channels, int k1, int k2, int dilation,
                       float slope, void* stream) {
  return dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, y, batch, seq_len,
                                 channels, k1, k2, dilation, slope, stream);
}

// w1 (k1, C, C) and w2 (k2, C, C) f32, (tap, in, out), into s1 (2, k1, C, C)
// and s2 (2, k2, C, C), (tap, out, in), tf32 hi and lo: one launch.
int resblock_pair_split_tf32(const void* w1, const void* w2, void* s1,
                             void* s2, int channels, int k1, int k2,
                             void* stream) {
  if (channels < 1 || k1 < 1 || k2 < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (channels + 31) / 32;
  split_tf32_kernel<<<dim3(tiles, tiles, k1 + k2), dim3(32, 8), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(s1), static_cast<float*>(s2), channels, k1, k2);
  return (int)cudaGetLastError();
}

const char* resblock_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
