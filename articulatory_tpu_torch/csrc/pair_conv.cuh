// The f32 and bf16 convolution machinery of the fused residual pair
// (resblock_pair.cu) that its backward (resblock_pair_backward.cu) shares:
// one convolution as an implicit GEMM over a window of time rows in shared
// memory with the weights through a TMA ring (conv_wgmma), the block
// geometry and its shared memory, and the weights' tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace port_kernels {

constexpr int kMaxStages = 6;       // depth of the weight ring
constexpr int kBf16Box = 64;        // bf16 weight box: 64 inputs x 64 outputs
constexpr int kStageBytesAnOutput = 128;  // ring bytes per output channel

// The products of one k step into d: outputs n .. n + WN of the stage's
// tile at b_stage (nbox outputs; for f32, the lo tile follows the hi one).
// f32 with fresh set overwrites d (a new partial sum, conv_wgmma).
template <typename T, int WN>
__device__ __forceinline__ void mma_step(float (&d)[WN / 2],
                                         const uint32_t (&f)[Tile<T>::kFrag],
                                         uint32_t b_stage, int n, int kstep,
                                         int nbox, bool fresh) {
  if constexpr (std::is_same_v<T, float>) {
    const uint32_t hi = b_stage + n * 64 + kstep * 32;
    const uint32_t lo = hi + nbox * 64;
    // the small products first, into the same accumulators
    wgmma_tf32<WN>(d, f + 4, b_desc_k64(hi), fresh ? 0 : 1);
    wgmma_tf32<WN>(d, f, b_desc_k64(lo), 1);
    wgmma_tf32<WN>(d, f, b_desc_k64(hi), 1);
  } else {
    wgmma_bf16(d, f,
               b_desc_bf16(b_stage + (n / kBf16Box) * kBf16Box * kBf16Box * 2 +
                           kstep * 16 * kBf16Box * 2));
  }
}

// lrelu over the 16 bytes of v, rounded to T.
template <typename T>
__device__ __forceinline__ void lrelu16(uint4& v, float slope) {
  if constexpr (std::is_same_v<T, float>) {
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = lrelu(f[q], slope);
  } else {
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h2[q]);
      h2[q] = __floats2bfloat162_rn(lrelu(f.x, slope), lrelu(f.y, slope));
    }
  }
}

// The biases of the WN/4 outputs a thread holds in one WN-wide block that
// starts at output n: bias[2q + e] is output n + 8q + 2 (lane % 4) + e;
// zero past C.
template <int WN>
__device__ __forceinline__ void load_bias(const float* b, int n,
                                          float (&bias)[WN / 4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < WN / 8; ++q) {
    const float2 v =
        *reinterpret_cast<const float2*>(b + n + q * 8 + 2 * (lane % 4));
    bias[2 * q] = v.x;
    bias[2 * q + 1] = v.y;
  }
}

// One group of wgmmas: up to kGroup k steps of one weight tile, A fragments
// into buffer BUF; fresh (f32) starts a new partial sum in acc.
template <typename T, int WN, int NB, int MT, int BUF>
__device__ __forceinline__ void conv_group(
    float (&acc)[MT][NB][WN / 2],
    uint32_t (&frag)[2][Tile<T>::kGroup][MT][Tile<T>::kFrag], uint32_t a_step,
    uint32_t b_stage, int row_bytes, int k0, int ksteps, int n0, int nbox,
    bool fresh) {
  constexpr int kGroup = Tile<T>::kGroup;
#pragma unroll
  for (int kk = 0; kk < kGroup; ++kk) {
    if (k0 + kk < ksteps) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a<T>(a_step + mt * 64 * row_bytes + (k0 + kk) * 32,
                  frag[BUF][kk][mt]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kGroup; ++kk) {
    if (k0 + kk < ksteps) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_step<T, WN>(acc[mt][nb], frag[BUF][kk][mt], b_stage,
                          n0 + nb * WN, k0 + kk, nbox, fresh && kk == 0);
      }
    }
  }
  wgmma_commit();
  // at most this group in flight: the other fragment buffer is free again
  wgmma_wait<1>();
}

// The group into fragment buffer buf, and buf flipped for the next one.
template <typename T, int WN, int NB, int MT>
__device__ __forceinline__ void next_group(
    float (&acc)[MT][NB][WN / 2],
    uint32_t (&frag)[2][Tile<T>::kGroup][MT][Tile<T>::kFrag], int& buf,
    uint32_t a_step, uint32_t b_stage, int row_bytes, int k0, int ksteps,
    int n0, int nbox, bool fresh) {
  if (buf)
    conv_group<T, WN, NB, MT, 1>(acc, frag, a_step, b_stage, row_bytes, k0,
                                 ksteps, n0, nbox, fresh);
  else
    conv_group<T, WN, NB, MT, 0>(acc, frag, a_step, b_stage, row_bytes, k0,
                                 ksteps, n0, nbox, fresh);
  buf ^= 1;
}

// f32: k steps summed on the tensor cores before the sum is folded into
// the accumulators (256 input channels).
constexpr int kFoldSteps = 32;

// One convolution of the pair as an implicit GEMM over k taps x ceil(C /
// kChunk) weight tiles, which arrive through the ring in order (stage
// counter it, shared with the producer's order). The warpgroup's rows are
// row0 + [0, 64 * MT), its outputs n0 + [0, NB * WN); row r's A at tap j
// is window row r + j * dil. acc[mt][nb] holds rows row0 + 64 mt + [0, 64),
// outputs n0 + WN nb + [0, WN).
//
// f32 sums kFoldSteps k steps at a time in a partial sum on the tensor
// cores and folds each into acc with f32 adds. The tensor cores' own
// additions truncate, and over the whole depth (C x K, up to 2816) their
// bias grew past f32's tolerance against a float64 pair (1e-5 of max |y|)
// at C 256, K 11; a partial sum's truncations are relative to its own,
// smaller size, and the folds round to nearest.
template <typename T, int WN, int NB, int MT, int kFoldAt = kFoldSteps>
__device__ __forceinline__ void conv_wgmma(float (&acc)[MT][NB][WN / 2],
                                           uint32_t window, int row_bytes,
                                           int row0, int n0, int nbox, int k,
                                           int dil, int C, uint32_t ring,
                                           uint32_t full0, uint32_t empty0,
                                           int stages, int& it) {
  constexpr int kChunk = Tile<T>::kChunk;
  constexpr int kStep = Tile<T>::kStep;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[mt][nb][i] = 0.f;
    }
  }
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  // ldmatrix x4: lanes 0-7 address rows 0-7 (bytes 0-15 of the k step),
  // lanes 8-15 rows 8-15 (bytes 0-15), lanes 16-23 rows 0-7 (bytes 16-31),
  // lanes 24-31 rows 8-15 (bytes 16-31): the four registers are then
  // wgmma's A fragment of a 16-row slice
  const uint32_t a_lane =
      window +
      (uint32_t)(row0 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
          row_bytes +
      (lane >> 4) * 16;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int stage_bytes = kStageBytesAnOutput * nbox;
  uint32_t frag[2][Tile<T>::kGroup][MT][Tile<T>::kFrag];
  constexpr bool kFold = std::is_same_v<T, float>;
  float part[kFold ? MT : 1][NB][kFold ? WN / 2 : 1];
  int summed = 0;  // f32: k steps in part since the last fold
  int buf = 0;     // fragment buffer of the next group
  int s = it % stages;
  uint32_t phase = (it / stages) & 1;
  int prev = -1;  // ring slot of the previous tile, freed once it is read
  for (int tap = 0; tap < k; ++tap) {
    for (int chunk = 0; chunk < chunks; ++chunk) {
      mbar_wait(full0 + 8 * s, phase);
      const int ksteps = min(kChunk / kStep, (C - chunk * kChunk) / kStep);
      const uint32_t a_step = a_lane + (uint32_t)(tap * dil) * row_bytes +
                              chunk * kChunk * (int)sizeof(T);
      const uint32_t b_stage = ring + s * stage_bytes;
      for (int k0 = 0; k0 < ksteps; k0 += Tile<T>::kGroup) {
        if constexpr (kFold) {
          if (summed == kFoldAt) {
            fold(acc, part);
            summed = 0;
          }
          next_group<T, WN, NB, MT>(part, frag, buf, a_step, b_stage,
                                    row_bytes, k0, ksteps, n0, nbox,
                                    summed == 0);
          ++summed;  // one k step a group
        } else {
          next_group<T, WN, NB, MT>(acc, frag, buf, a_step, b_stage,
                                    row_bytes, k0, ksteps, n0, nbox, false);
        }
        if (k0 == 0 && prev >= 0) {  // the previous tile is read: free it
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
      }
      prev = s;
      ++it;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
  }
  if constexpr (kFold) {
    fold(acc, part);
  } else {
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_operands(acc[mt][nb]);
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * prev);
}

// The block's geometry: rows of h it computes, the outputs of one ring
// stage's box, and the window's rows and row stride.
struct Geometry {
  int rows, nbox, win_rows, row_bytes;
};

__host__ __device__ inline Geometry geometry(int elem, int wn, int nb, int mt,
                                             bool split_n, int C, int halo1,
                                             int halo2) {
  const int halo = halo1 > halo2 ? halo1 : halo2;
  const int rows = (split_n ? 64 : 128) * mt;
  return {rows, (split_n ? 2 : 1) * nb * wn, rows + 2 * halo,
          elem * C + 16};
}

// Shared memory: the ring (1024-byte aligned, for the swizzle), the window,
// the barriers, b1 and b2 in f32; plus slack to align the ring.
inline size_t smem_bytes(const Geometry& g, int stages) {
  return 1024 + (size_t)stages * kStageBytesAnOutput * g.nbox +
         (size_t)g.win_rows * g.row_bytes + 16 * kMaxStages +
         2 * 256 * sizeof(float);
}

// bf16: w (k, C, C) as a 2D map of (k * C rows of inputs) x (C outputs),
// 64 x 64 boxes with 128-byte swizzle. f32: the split (2k, C out, C in) as
// a 3D map, (16 inputs x nbox outputs x 1) boxes with 64-byte swizzle.
// Out-of-range elements read zero.
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const void* w, int k, int C,
                       int nbox) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  CUresult res;
  if constexpr (std::is_same_v<T, float>) {
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)C,
                                (cuuint64_t)2 * k};
    const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(float),
                                   (cuuint64_t)C * C * sizeof(float)};
    const cuuint32_t box[3] = {(cuuint32_t)Tile<float>::kChunk,
                               (cuuint32_t)nbox, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w),
                 dims, strides, box, elem_strides,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)k * C};
    const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {kBf16Box, kBf16Box};
    const cuuint32_t elem_strides[2] = {1, 1};
    res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
                 dims, strides, box, elem_strides,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Each weight's map, encoded once per (address, k, C, nbox) and type.
template <typename T>
cudaError_t cached_weight_map(CUtensorMap* map, const void* w, int k, int C,
                              int nbox) {
  static TensorMapCache maps;
  return maps.get(map,
                  {reinterpret_cast<uint64_t>(w), (uint64_t)k, (uint64_t)C,
                   (uint64_t)nbox},
                  [&](CUtensorMap* m) { return weight_map<T>(m, w, k, C, nbox); });
}

}  // namespace port_kernels
