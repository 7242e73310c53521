// HiFi-GAN scale-discriminator head (layers 0 and 1) for Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// articulatory_tpu_torch/ops/scale_disc_head.py).
//
// Replaces articulatory_tpu/ops/pallas/scale_disc_head.py::scale_disc_head_pallas:
//
//     h0 = lrelu(conv(x, w0, k 15, 1 -> 128, pad 7) + b0)
//     h1 = lrelu(grouped conv(h0, wg, k 41, 128 -> 128, 4 groups,
//                             stride s, pad 20) + b1)
//
// over x (B, T, 1). w0 is (15, 1, 128) and wg the grouped (41, 32, 128)
// kernel in (tap, in within the group, out) order; output channel o belongs
// to group o / 32 and reads input channels [32 g, 32 g + 32). h0 rows outside
// [0, T) are zero in layer 1 (its own zero padding), not lrelu(b0). Returns
// h0 (B, T, 128) in natural time order and h1 (B, T1, 128), T1 =
// (T - 1) / s + 1. The stride is a runtime argument: the repo's configs run
// layer 1 at stride 4, the Pallas kernel fixed it at 2. Any T >= 1 works.
//
// What bounds it: per pair of layers 2*B*T*128*15 + 2*B*T1*128*32*41 flops
// against x, h0 and h1 once each in device memory. At stride 4 that is
// ~1340 flops per byte of f32 output: bound by operations in f32 (fp32
// FMAs, no tensor cores, 67 TFLOP/s). This first version runs fp32 FMAs.
//
// Design: where the TPU design does not carry over. The Pallas kernel
// densified the grouped kernel to (41, 128, 128), four times the work, and
// lane-padded 15 taps to 128 for the MXU and Mosaic's DMA; here each output
// channel sums over its own group only, 32 inputs by 41 taps. One block owns
// a tile of h1 rows of one batch row. It stages its x window (the tile's
// h0 window plus 7 samples each side) in shared memory, computes layer 0
// into a shared h0 window (rows tile*s + 40, zeroed outside [0, T)) and
// writes to device memory only the h0 rows it owns, [r0*s, (r0+tile)*s)
// within [0, T), so every h0 row is written once. Layer 1 then reads the
// shared window. wg (672 KB in f32) does not fit in shared memory, so each
// tap's (32, 128) slice is read through L1/L2, 4 input channels x 4 output
// channels at a time, and feeds kRows time rows held in registers. The tile
// length is chosen for occupancy from the SM count (see choose_tile).
//
// bf16 mode: bf16 in and out, f32 accumulation; h0 and h1 are rounded to
// bf16 where the unfused bf16 convolutions round their outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;        // threads per block
constexpr int kChannels = 128;       // h0 and h1 channels
constexpr int kVec = 4;              // output channels per thread
constexpr int kLanes = kChannels / kVec;     // threads along channels (32)
constexpr int kRowThreads = kThreads / kLanes;  // threads along time (8)
constexpr int kRows = 4;             // h1 rows per thread per pass
constexpr int kStep = kRowThreads * kRows;   // h1 rows per pass (32)
constexpr int kGroupIn = 32;         // input channels per group of layer 1
constexpr int kK0 = 15, kPad0 = 7;   // layer 0
constexpr int kK1 = 41, kPad1 = 20;  // layer 1
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

using port_kernels::load1;
using port_kernels::working;
template <typename T>
using Vec4 = port_kernels::Vec<T, kVec>;

// h0 rows of the shared window for a tile of `rows` h1 rows: those layer 1
// reads, and those the block owns (they reach further when stride > 21).
__host__ __device__ __forceinline__ int window_rows(int rows, int stride) {
  const int taps = (rows - 1) * stride + kK1;
  const int owned = rows * stride + kPad1;
  return taps > owned ? taps : owned;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_disc_head_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                           const T* __restrict__ b0, const T* __restrict__ wg,
                           const T* __restrict__ b1, T* __restrict__ h0,
                           T* __restrict__ h1, int seq_len, int out_len,
                           int stride, float slope, int tile) {
  extern __shared__ float4 smem4[];
  const int r0 = blockIdx.x * tile;            // first h1 row of the block
  const int rows = min(tile, out_len - r0);    // h1 rows of the block
  const int lo = r0 * stride - kPad1;          // h0 row of window row 0
  const int win = window_rows(rows, stride);
  const int own_lo = r0 * stride;
  const int own_hi = min((r0 + rows) * stride, seq_len);
  float* h0s = reinterpret_cast<float*>(smem4);                   // win x 128
  float* xs = h0s + (size_t)window_rows(tile, stride) * kChannels;  // x window

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int co = tx * kVec;
  const T* xb = x + (size_t)blockIdx.y * seq_len;
  T* h0b = h0 + (size_t)blockIdx.y * seq_len * kChannels;
  T* h1b = h1 + (size_t)blockIdx.y * out_len * kChannels;

  // 1. x over [lo - 7, lo + win + 7), zeros outside [0, T)
  for (int i = threadIdx.x; i < win + 2 * kPad0; i += blockDim.x) {
    const int g = lo - kPad0 + i;
    xs[i] = (g >= 0 && g < seq_len) ? load1(xb + g) : 0.f;
  }
  __syncthreads();

  // 2. layer 0 into the window; rows outside [0, T) are zero for layer 1
  {
    float w[kK0][kVec];
    float bias[kVec];
#pragma unroll
    for (int k = 0; k < kK0; ++k) {
#pragma unroll
      for (int o = 0; o < kVec; ++o) w[k][o] = load1(w0 + k * kChannels + co + o);
    }
#pragma unroll
    for (int o = 0; o < kVec; ++o) bias[o] = b0 ? load1(b0 + co + o) : 0.f;
    for (int j = ty; j < win; j += kRowThreads) {
      float acc[kVec] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kK0; ++k) {
        const float xv = xs[j + k];
#pragma unroll
        for (int o = 0; o < kVec; ++o) acc[o] = fmaf(xv, w[k][o], acc[o]);
      }
      const int g = lo + j;
      float v[kVec];
#pragma unroll
      for (int o = 0; o < kVec; ++o) {
        const float h = working<T>(acc[o] + bias[o]);
        v[o] = (g >= 0 && g < seq_len) ? working<T>(h >= 0.f ? h : h * slope)
                                       : 0.f;
      }
      *reinterpret_cast<float4*>(h0s + (size_t)j * kChannels + co) =
          make_float4(v[0], v[1], v[2], v[3]);
      if (g >= own_lo && g < own_hi) {
        Vec4<T>::store(h0b + (size_t)g * kChannels + co, v);
      }
    }
  }
  __syncthreads();

  // 3. layer 1: each output channel sums over its group's 32 inputs x 41 taps
  const int cin = co / kGroupIn * kGroupIn;
  float bias[kVec];
#pragma unroll
  for (int o = 0; o < kVec; ++o) bias[o] = b1 ? load1(b1 + co + o) : 0.f;
  for (int p = 0; p < rows; p += kStep) {
    const int first = p + ty * kRows;
    if (first >= rows) continue;
    int roff[kRows];
    float acc[kRows][kVec];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      roff[i] = min(first + i, rows - 1) * stride * kChannels + cin;
#pragma unroll
      for (int o = 0; o < kVec; ++o) acc[i][o] = 0.f;
    }
    for (int k = 0; k < kK1; ++k) {
      const T* wk = wg + (size_t)k * kGroupIn * kChannels + co;
      const float* s = h0s + (size_t)k * kChannels;
#pragma unroll 2
      for (int ci = 0; ci < kGroupIn; ci += kVec) {
        float wv[kVec][kVec];
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          Vec4<T>::load(wk + (size_t)(ci + q) * kChannels, wv[q]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(s + roff[i] + ci);
          const float av[kVec] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
#pragma unroll
            for (int o = 0; o < kVec; ++o) {
              acc[i][o] = fmaf(av[q], wv[q][o], acc[i][o]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = first + i;
      if (r < rows) {
        float v[kVec];
#pragma unroll
        for (int o = 0; o < kVec; ++o) {
          const float h = working<T>(acc[i][o] + bias[o]);
          v[o] = h >= 0.f ? h : h * slope;
        }
        Vec4<T>::store(h1b + (size_t)(r0 + r) * kChannels + co, v);
      }
    }
  }
}

size_t smem_bytes(int tile, int stride) {
  const size_t win = window_rows(tile, stride);
  return (win * kChannels + win + 2 * kPad0) * sizeof(float);
}

// Both caches below are keyed by the device and guarded by one mutex: the
// shared-memory attribute is set and the SM count read once per
// (instantiation, device), the tile chosen once per (device, shape).
std::mutex cache_mutex;

template <typename T>
cudaError_t device_sms(int device, int* sms) {
  static std::map<int, int> known;  // device -> SM count
  const auto it = known.find(device);
  if (it != known.end()) {
    *sms = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      scale_disc_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) known[device] = *sms;
  return err;
}

// A block's time grows with its passes over kStep rows (a tile shorter than
// kStep still takes one pass), and blocks run in waves of SMs x blocks
// resident per SM (bounded by the window's shared memory). Take the tile
// with the fewest waves x passes, the longer one on a tie (less layer-0
// halo recomputed). Tiles shorter than kStep are candidates only so that a
// large stride still fits a window in shared memory.
template <typename T>
cudaError_t choose_tile(int sms, int batch, int out_len, int stride,
                        int* tile) {
  long best = 0;
  *tile = 0;
  for (int c = 1;; c = c < kStep ? 2 * c : c + kStep) {
    const int rows = min(c, out_len);
    const size_t bytes = smem_bytes(rows, stride);
    if (bytes > kMaxSmem) break;
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scale_disc_head_kernel<T>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) break;
    const long blocks = (long)((out_len + rows - 1) / rows) * batch;
    const long slots = (long)sms * per_sm;
    const long cost =
        (blocks + slots - 1) / slots * ((rows + kStep - 1) / kStep);
    if (*tile == 0 || cost <= best) {
      *tile = rows;
      best = cost;
    }
    if (rows == out_len || (rows >= kStep && blocks <= slots)) break;
  }
  return *tile == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* wg,
           const void* b1, void* h0, void* h1, int batch, int seq_len,
           int stride, float slope, void* stream) {
  if (batch < 0 || seq_len < 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0 || seq_len == 0) return (int)cudaSuccess;
  const uintptr_t vec_bytes = kVec * sizeof(T);
  if (!aligned(wg, vec_bytes) || !aligned(h0, vec_bytes) ||
      !aligned(h1, vec_bytes))
    return (int)cudaErrorMisalignedAddress;
  const int out_len = (seq_len - 1) / stride + 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int tile = 0;
  {
    static std::map<std::array<int, 4>, int> tiles;  // shape -> tile
    const std::array<int, 4> key{device, batch, out_len, stride};
    std::lock_guard<std::mutex> lock(cache_mutex);
    const auto it = tiles.find(key);
    if (it != tiles.end()) {
      tile = it->second;
    } else {
      int sms = 0;
      err = device_sms<T>(device, &sms);
      if (err == cudaSuccess)
        err = choose_tile<T>(sms, batch, out_len, stride, &tile);
      if (err != cudaSuccess) return (int)err;
      tiles[key] = tile;
    }
  }
  const dim3 grid((out_len + tile - 1) / tile, batch);
  scale_disc_head_kernel<T>
      <<<grid, kThreads, smem_bytes(tile, stride),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const T*>(w0),
          static_cast<const T*>(b0), static_cast<const T*>(wg),
          static_cast<const T*>(b1), static_cast<T*>(h0), static_cast<T*>(h1),
          seq_len, out_len, stride, slope, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). b0 and b1 may be
// null (no bias). h0 is (batch, seq_len, 128), h1 (batch, (seq_len - 1) /
// stride + 1, 128). stream is a cudaStream_t; the call does not synchronise.
int scale_disc_head_f32(const void* x, const void* w0, const void* b0,
                        const void* wg, const void* b1, void* h0, void* h1,
                        int batch, int seq_len, int stride, float slope,
                        void* stream) {
  return launch<float>(x, w0, b0, wg, b1, h0, h1, batch, seq_len, stride,
                       slope, stream);
}

int scale_disc_head_bf16(const void* x, const void* w0, const void* b0,
                         const void* wg, const void* b1, void* h0, void* h1,
                         int batch, int seq_len, int stride, float slope,
                         void* stream) {
  return launch<__nv_bfloat16>(x, w0, b0, wg, b1, h0, h1, batch, seq_len,
                               stride, slope, stream);
}

const char* scale_disc_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
