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
//
// What bounds it: on the generator's main path (C 256..32, K 3..11) a pair
// does 4*T*C*C*K flops against 2*T*C elements of activation traffic, i.e.
// 2*C*K flops per activation element: from 96 (C 32, K 3) to 5632 (C 256,
// K 11) flops per element. Every main-path shape is bound by arithmetic,
// not by device memory. This first version runs the arithmetic as fp32 FMAs
// (no TF32, so the f32 mode is the parity mode); bf16 tensor cores (wgmma
// with TMA-fed tiles) are the later redesign.
//
// Design: one block per (time tile, batch row) produces all C output
// channels of its tile, because conv2 needs every channel of the
// intermediate h. The block stages lrelu(x) over the tile plus both halos in
// shared memory, computes conv1 into a second shared window (the tile plus
// conv2's halo, rows outside [0, T) zeroed), then conv2 plus the residual
// straight to device memory, so h never leaves the SM. Weights are read tap
// by tap from L2 (they do not fit in shared memory next to the windows at
// C 256). Each thread accumulates kRows time rows x VEC output channels in
// registers, so each weight vector it loads feeds kRows * VEC FMAs and each
// activation vector VEC * VEC FMAs. The tile length is chosen so conv1's
// rows fill whole passes of the block, in as few waves of blocks over the
// SMs as it can (see choose_tile).
//
// bf16 mode: bf16 in and out, f32 accumulation. The staged activations and
// h are rounded to bf16 where the unfused bf16 convolutions round their
// inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block (at most)
constexpr int kRows = 8;                    // time rows per thread per pass
constexpr size_t kMaxSmem = 232448;         // bytes a block may use on sm_90

using port_kernels::load1;
using port_kernels::Vec;
using port_kernels::working;

// ---- VEC consecutive floats of shared memory ------------------------------

template <int VEC>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// acc[i][o] = sum over tap, ci of src[roff[i] + tap*dil*C + ci] *
//             w[(tap*C + ci)*C + co + o]
// src is a shared-memory window (rows x C floats); roff[i] = row_i * C.
template <typename T, int VEC>
__device__ __forceinline__ void conv_rows(float (&acc)[kRows][VEC],
                                          const float* __restrict__ src,
                                          const T* __restrict__ w,
                                          const int (&roff)[kRows], int C,
                                          int K, int dil, int co) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int o = 0; o < VEC; ++o) acc[i][o] = 0.f;
  }
  for (int tap = 0; tap < K; ++tap) {
    const T* wt = w + (size_t)tap * C * C + co;
    const float* s = src + tap * dil * C;
#pragma unroll 2
    for (int ci = 0; ci < C; ci += VEC) {
      float wv[VEC][VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        Vec<T, VEC>::load(wt + (size_t)(ci + q) * C, wv[q]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float av[VEC];
        lds<VEC>(s + roff[i] + ci, av);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
#pragma unroll
          for (int o = 0; o < VEC; ++o) {
            acc[i][o] = fmaf(av[q], wv[q][o], acc[i][o]);
          }
        }
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    resblock_pair_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                         const T* __restrict__ b1, const T* __restrict__ w2,
                         const T* __restrict__ b2, T* __restrict__ y,
                         int seq_len, int C, int k1, int k2, int dil,
                         float slope, int tile) {
  extern __shared__ float4 smem4[];
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  const int pad = halo1 + halo2;
  const int mid = tile + 2 * halo2;  // rows of h conv2 reads
  const int win = tile + 2 * pad;    // rows of x conv1 reads
  float* a1 = reinterpret_cast<float*>(smem4);  // lrelu(x), win x C
  float* a2 = a1 + (size_t)win * C;             // lrelu(h), mid x C

  const int groups = C / VEC;  // threads along the channel axis
  const int tx = threadIdx.x % groups;
  const int ty = threadIdx.x / groups;
  const int nty = blockDim.x / groups;
  const int co = tx * VEC;
  const int step = nty * kRows;  // rows per pass of the block
  const int t0 = blockIdx.x * tile;
  const size_t base = (size_t)blockIdx.y * seq_len * C;
  const T* xb = x + base;
  T* yb = y + base;

  // 1. a1 = lrelu(x) over [t0 - pad, t0 + tile + pad); zeros outside [0, T)
  for (int idx = threadIdx.x; idx < win * groups; idx += blockDim.x) {
    const int r = idx / groups;
    const int c = (idx - r * groups) * VEC;
    const int g = t0 - pad + r;
    float v[VEC];
    if (g >= 0 && g < seq_len) {
      Vec<T, VEC>::load(xb + (size_t)g * C + c, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        v[q] = working<T>(v[q] >= 0.f ? v[q] : v[q] * slope);
      }
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = 0.f;
    }
    sts<VEC>(a1 + (size_t)r * C + c, v);
  }
  __syncthreads();

  float bias[VEC];
  int roff[kRows];
  float acc[kRows][VEC];

  // 2. a2 = lrelu(conv1(a1) + b1) over [t0 - halo2, t0 + tile + halo2);
  //    zeros outside [0, T), as the unfused conv2's zero padding
#pragma unroll
  for (int o = 0; o < VEC; ++o) bias[o] = b1 ? load1(b1 + co + o) : 0.f;
  for (int p = 0; p < mid; p += step) {
    const int first = p + ty * kRows;
    if (first >= mid) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) roff[i] = min(first + i, mid - 1) * C;
    conv_rows<T, VEC>(acc, a1, w1, roff, C, k1, dil, co);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = first + i;
      const int g = t0 - halo2 + r;
      if (r < mid) {
        float v[VEC];
#pragma unroll
        for (int o = 0; o < VEC; ++o) {
          const float h = working<T>(acc[i][o] + bias[o]);
          v[o] = (g >= 0 && g < seq_len)
                     ? working<T>(h >= 0.f ? h : h * slope)
                     : 0.f;
        }
        sts<VEC>(a2 + (size_t)r * C + co, v);
      }
    }
  }
  __syncthreads();

  // 3. y = x + conv2(a2) + b2 over [t0, t0 + tile) within [0, T)
#pragma unroll
  for (int o = 0; o < VEC; ++o) bias[o] = b2 ? load1(b2 + co + o) : 0.f;
  for (int p = 0; p < tile; p += step) {
    const int first = p + ty * kRows;
    if (first >= tile) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) roff[i] = min(first + i, tile - 1) * C;
    conv_rows<T, VEC>(acc, a2, w2, roff, C, k2, 1, co);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = first + i;
      const int g = t0 + r;
      if (r < tile && g < seq_len) {
        float v[VEC];
        Vec<T, VEC>::load(xb + (size_t)g * C + co, v);
#pragma unroll
        for (int o = 0; o < VEC; ++o) v[o] += acc[i][o] + bias[o];
        Vec<T, VEC>::store(yb + (size_t)g * C + co, v);
      }
    }
  }
}

size_t smem_bytes(int tile, int C, int halo1, int halo2) {
  const size_t rows = (size_t)(tile + 2 * (halo1 + halo2)) + tile + 2 * halo2;
  return rows * C * sizeof(float);
}

// Both caches below are keyed by the device and guarded by one mutex, so the
// per-launch host work is a map lookup: the shared-memory attribute is set
// and the SM count read once per (instantiation, device), and the tile is
// chosen once per (instantiation, device, shape).
std::mutex cache_mutex;

template <typename T, int VEC>
cudaError_t device_sms(int device, int* sms) {
  static std::map<int, int> known;  // device -> SM count
  const auto it = known.find(device);
  if (it != known.end()) {
    *sms = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      resblock_pair_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) known[device] = *sms;
  return err;
}

// conv1's rows (tile + 2*halo2) fill m whole passes, and a block's time
// grows with m. Blocks run in waves of (SMs x blocks resident per SM, which
// the tile's shared memory bounds), so take the m with the fewest
// waves x m. At C 256 that is m = 1 with two or three resident blocks,
// whose extra warps hide the latency of the weight loads better than
// longer tiles at one block per SM do.
template <typename T, int VEC>
cudaError_t choose_tile(int sms, int batch, int seq_len, int C, int halo1,
                        int halo2, int* tile) {
  const int groups = C / VEC;
  const int nty = kThreads / groups;
  const int step = nty * kRows;
  long best = 0;
  *tile = 0;
  for (int m = 1;; ++m) {
    const int rows = m * step - 2 * halo2;
    if (rows < 1) continue;
    const size_t bytes = smem_bytes(rows, C, halo1, halo2);
    if (bytes > kMaxSmem) break;
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resblock_pair_kernel<T, VEC>, groups * nty, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) break;
    const long blocks = (long)((seq_len + rows - 1) / rows) * batch;
    const long slots = (long)sms * per_sm;
    const long cost = (blocks + slots - 1) / slots * m;
    if (*tile == 0 || cost < best) {
      *tile = rows;
      best = cost;
    }
    if (blocks <= slots) break;  // one wave: a longer tile only costs more
  }
  return *tile == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T, int VEC>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y, int batch, int seq_len, int C, int k1,
           int k2, int dil, float slope, cudaStream_t stream) {
  const int groups = C / VEC;
  if (groups < 1 || groups > kThreads) return (int)cudaErrorInvalidValue;
  const int nty = kThreads / groups;
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int tile = 0;
  {
    static std::map<std::array<int, 6>, int> tiles;  // shape -> tile
    const std::array<int, 6> key{device, batch, seq_len, C, halo1, halo2};
    std::lock_guard<std::mutex> lock(cache_mutex);
    const auto it = tiles.find(key);
    if (it != tiles.end()) {
      tile = it->second;
    } else {
      int sms = 0;
      err = device_sms<T, VEC>(device, &sms);
      if (err == cudaSuccess)
        err = choose_tile<T, VEC>(sms, batch, seq_len, C, halo1, halo2,
                                  &tile);
      if (err != cudaSuccess) return (int)err;
      tiles[key] = tile;
    }
  }
  const size_t smem = smem_bytes(tile, C, halo1, halo2);
  const dim3 grid((seq_len + tile - 1) / tile, batch);
  resblock_pair_kernel<T, VEC><<<grid, groups * nty, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), seq_len, C, k1, k2, dil,
      slope, tile);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* y, int batch, int seq_len, int C, int k1,
             int k2, int dil, float slope, void* stream) {
  if (batch < 0 || seq_len < 0 || C < 1 || k1 < 1 || k2 < 1 || dil < 1 ||
      k1 % 2 == 0 || k2 % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || seq_len == 0) return (int)cudaSuccess;
  const uintptr_t vec_bytes = 4 * sizeof(T);
  const bool vec4 = C % 4 == 0 && aligned(x, vec_bytes) &&
                    aligned(w1, vec_bytes) && aligned(w2, vec_bytes) &&
                    aligned(y, vec_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    return launch<T, 4>(x, w1, b1, w2, b2, y, batch, seq_len, C, k1, k2, dil,
                        slope, s);
  return launch<T, 1>(x, w1, b1, w2, b2, y, batch, seq_len, C, k1, k2, dil,
                      slope, s);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). b1 and b2 may be
// null (no bias). stream is a cudaStream_t; the call does not synchronise.
int resblock_pair_f32(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* y, int batch,
                      int seq_len, int channels, int k1, int k2, int dilation,
                      float slope, void* stream) {
  return dispatch<float>(x, w1, b1, w2, b2, y, batch, seq_len, channels, k1,
                         k2, dilation, slope, stream);
}

int resblock_pair_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, int batch,
                       int seq_len, int channels, int k1, int k2, int dilation,
                       float slope, void* stream) {
  return dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, y, batch, seq_len,
                                 channels, k1, k2, dilation, slope, stream);
}

const char* resblock_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
