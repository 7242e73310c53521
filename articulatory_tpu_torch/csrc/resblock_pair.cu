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
// Both kernels below keep the intermediate h in shared memory: a block owns
// every channel of a time tile, because conv2 needs every channel of h.
//
// What bounds it: a pair does 4*T*C*C*K flops against 2*T*C elements of
// activation traffic, 2*C*K flops per element, from 96 (C 32, K 3) to 5632
// (C 256, K 11).
//
// float32 (resblock_pair_kernel): the parity mode, fp32 FMAs (no TF32), so
// every shape is bound by the 67 TFLOP/s fp32 rate. The block stages
// lrelu(x) over the tile plus both halos in shared memory, computes conv1
// into a second shared window (the tile plus conv2's halo, rows outside
// [0, T) zeroed), then conv2 plus the residual straight to device memory.
// Weights are read tap by tap from L2. Each thread accumulates kRows time
// rows x VEC output channels in registers. The tile length is chosen so
// conv1's rows fill whole passes of the block, in as few waves of blocks over
// the SMs as it can (see choose_tile).
//
// bfloat16 (resblock_pair_wgmma): bf16 in and out, f32 accumulation, on the
// tensor cores. Against 989 TFLOP/s and 3.35 TB/s the pair is bound by
// operations at C 256/128/64 and by bytes at C 32. Each convolution is an
// implicit GEMM, M = time rows, N = C, depth = C x K, run as wgmma
// m64n64k16 (one instruction shape for every C; N 64 blocks side by side)
// with f32 accumulators in registers:
// - A, the activations: lrelu(x) is staged once per block in bf16 in shared
//   memory over the rows plus both halos (row stride 2C + 16 bytes, so the
//   eight rows of an ldmatrix fall on distinct banks). Tap j's A is the
//   window shifted by j*d rows, which is no multiple of the 8-row swizzle
//   atom, so A goes to registers with ldmatrix (any 16-byte row address)
//   and wgmma takes it from there.
// - B, the weights: (tap, 64-input-channel chunk) tiles of w1 and then w2,
//   64 x 64 bf16 (8 KB) per 64 output channels, read by TMA with 128-byte
//   swizzle straight from the (tap, in, out) layout (out contiguous: wgmma's
//   transposed, MN-major B) into a ring of stages in shared memory, so the
//   host does no layout work. One thread of a producer warpgroup keeps the
//   ring full and reports to mbarriers; the producer hands its registers to
//   the two consumer warpgroups (setmaxnreg, 40 and 232 a thread), which
//   run wgmma on each tile. Out-of-range rows and columns of a box (C < 64,
//   the last tap) are filled with zeros by the TMA unit.
// - Many rows per weight tile: both warpgroups (128 * MT rows) share every
//   tile, and the tile rule (plan_bf16) picks MT = 1, 2 or 4 m64 tiles per
//   warpgroup (at most 128 accumulator registers a thread) from the SM count
//   and the shape, for the fewest waves x rows.
// - h never leaves the SM: conv1 computes 128 * MT rows (the tile plus
//   conv2's halo), its epilogue adds b1, rounds to bf16, applies lrelu,
//   rounds, zeroes rows outside [0, T), and writes h over the x window (both
//   warpgroups are past conv1 by then). conv2 reads it the same way. Its
//   epilogue loads the tile's x into the window with 16-byte loads, writes
//   y = x + (acc + b2), rounded once, over it in the accumulator's layout,
//   and copies y out with 16-byte stores (faster than 4-byte stores in the
//   accumulator's layout at every C above 32).
// The rounding points are the FMA kernel's: staged activations and h in
// bf16, sums in f32.

#include <cuda.h>
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

// ---- bf16: tensor-core (wgmma) pair fed by TMA weight tiles --------------

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after the producer hands its own to the consumers
// (setmaxnreg): 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunk = 64;                   // input channels per weight tile
constexpr int kTileBytes = kChunk * 64 * 2;  // 64 x 64 bf16 per 64 outputs
constexpr int kMaxStages = 6;                // depth of the weight ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One box of a 2D tensor map (inner coordinate c0, outer c1) into shared
// memory at dst; completion is reported to bar as transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Named barrier over the two consumer warpgroups (the producer warpgroup
// is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties the accumulators to this point of the program, so that no read of
// them moves above a wgmma_wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a 64 (input channels, K) x 64 (outputs, N)
// bf16 tile as TMA writes it with 128-byte swizzle: N contiguous (MN-major),
// 8-row K groups 1024 bytes apart. The field for the stride between 64-wide
// N blocks is set to the same value: at N 64 there is one block.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 f32, the wgmma accumulator fragment) += A (64 x 16 bf16, the
// ldmatrix fragment a) x B (16 x 64 bf16 in shared memory, transposed).
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The biases of the 16 outputs a thread holds in one 64-wide block nb:
// bias[2q + e] is output 64 nb + 8q + 2 (lane % 4) + e; zero past C.
__device__ __forceinline__ void load_bias(const float* b, int nb,
                                          float (&bias)[16]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(
        b + nb * 64 + q * 8 + 2 * (lane % 4));
    bias[2 * q] = v.x;
    bias[2 * q + 1] = v.y;
  }
}

// One group of wgmmas: up to two k steps (16 input channels each) of one
// weight tile, A fragments into buffer BUF.
template <int NB, int MT, int BUF>
__device__ __forceinline__ void conv_group(float (&acc)[MT][NB][32],
                                           uint32_t (&frag)[2][2][MT][4],
                                           uint32_t a_step, uint32_t b_step,
                                           int row_bytes, int k0, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (k0 + kk < ksteps) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a_step + mt * 64 * row_bytes + (k0 + kk) * 32,
                    frag[BUF][kk][mt]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if (k0 + kk < ksteps) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_n64(acc[mt][nb], frag[BUF][kk][mt],
                    b_desc(b_step + nb * kTileBytes + (k0 + kk) * 16 * 128));
      }
    }
  }
  wgmma_commit();
  // at most this group in flight: the other fragment buffer is free again
  wgmma_wait<1>();
}

// One convolution of the pair as an implicit GEMM over k taps x ceil(C/64)
// weight tiles, which arrive through the ring in order (stage counter it,
// shared with the producer's order). The warpgroup's rows are row0 +
// [0, 64 * MT); row r's A at tap j is window row r + j * dil. acc[mt][nb]
// holds rows row0 + 64 mt + [0, 64), outputs 64 nb + [0, 64).
template <int NB, int MT>
__device__ __forceinline__ void conv_wgmma(float (&acc)[MT][NB][32],
                                           uint32_t window, int row_bytes,
                                           int row0, int k, int dil, int C,
                                           uint32_t ring, uint32_t full0,
                                           uint32_t empty0, int stages,
                                           int& it) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][nb][i] = 0.f;
    }
  }
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  // ldmatrix x4: lanes 0-7 address rows 0-7 (k 0-7), lanes 8-15 rows 8-15
  // (k 0-7), lanes 16-23 rows 0-7 (k 8-15), lanes 24-31 rows 8-15 (k 8-15):
  // the four registers are then wgmma's A fragment of a 16-row slice
  const uint32_t a_lane =
      window +
      (uint32_t)(row0 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
          row_bytes +
      (lane >> 4) * 16;
  const int chunks = (C + kChunk - 1) / kChunk;
  uint32_t frag[2][2][MT][4];
  int buf = 0;  // fragment buffer of the next group
  int s = it % stages;
  uint32_t phase = (it / stages) & 1;
  int prev = -1;  // ring slot of the previous tile, freed once it is read
  for (int tap = 0; tap < k; ++tap) {
    for (int chunk = 0; chunk < chunks; ++chunk) {
      mbar_wait(full0 + 8 * s, phase);
      const int ksteps = min(4, (C - chunk * kChunk) / 16);
      const uint32_t a_step =
          a_lane + (uint32_t)(tap * dil) * row_bytes + chunk * kChunk * 2;
      const uint32_t b_step = ring + s * NB * kTileBytes;
      for (int k0 = 0; k0 < ksteps; k0 += 2) {
        if (buf)
          conv_group<NB, MT, 1>(acc, frag, a_step, b_step, row_bytes, k0,
                                ksteps);
        else
          conv_group<NB, MT, 0>(acc, frag, a_step, b_step, row_bytes, k0,
                                ksteps);
        buf ^= 1;
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
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_operands(acc[mt][nb]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * prev);
}

// Shared memory: the ring (1024-byte aligned, for the swizzle), the window
// (rows of 2C + 16 bytes), the barriers, b1 and b2 in f32; plus slack to
// align the ring.
size_t wgmma_smem_bytes(int nb, int mt, int stages, int C, int halo1,
                        int halo2) {
  const int rows = 128 * mt + 2 * (halo1 > halo2 ? halo1 : halo2);
  return 1024 + (size_t)stages * nb * kTileBytes + (size_t)rows * (2 * C + 16) +
         16 * kMaxStages + 2 * 256 * sizeof(float);
}

// The consumer warpgroups' part of the kernel: stage x, conv1, h, conv2, y.
// A wgmma group holds up to two k steps; two A-fragment buffers let one
// group's ldmatrix overlap the previous group's products.
template <int NB, int MT>
__device__ __forceinline__ void consume(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ b1,
    const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
    int seq_len, int C, int k1, int k2, int dil, float slope, int stages,
    uint32_t ring, __nv_bfloat16* win, float* biases, uint32_t full0,
    uint32_t empty0, int t0, size_t batch_off) {
  const int rows = 128 * MT;  // h rows conv1 computes
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  const int tile = rows - 2 * halo2;  // output rows of the block
  const int pad = halo1 + halo2;
  const int ld = C + 8;  // window row stride, elements
  const int row_bytes = 2 * ld;
  const uint32_t window = smem_u32(win);
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int row0 = (threadIdx.x / 128) * 64 * MT;  // this warpgroup's rows
  const __nv_bfloat16* xb = x + batch_off;
  __nv_bfloat16* yb = y + batch_off;
  const int vecs = C / 8;  // 16-byte vectors a row

  // 1. window = bf16(lrelu(x)) over [t0 - pad, t0 - pad + rows + 2*halo1);
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
            xb + (size_t)g * C + (idx - r * vecs) * 8));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = first + u * kConsumers;
      if (idx >= vectors) break;
      const int r = idx / vecs;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h2[q]);
        h2[q] = __floats2bfloat162_rn(lrelu(f.x, slope), lrelu(f.y, slope));
      }
      *reinterpret_cast<uint4*>(win + (size_t)r * ld + (idx - r * vecs) * 8) =
          v[u];
    }
  }
  for (int n = threadIdx.x; n < 2 * 256; n += kConsumers) {
    const __nv_bfloat16* b = n < 256 ? b1 : b2;
    const int c = n % 256;
    biases[n] = b != nullptr && c < C ? __bfloat162float(__ldg(b + c)) : 0.f;
  }
  consumers_sync();

  float acc[MT][NB][32];
  int it = 0;
  conv_wgmma<NB, MT>(acc, window, row_bytes, row0, k1, dil, C, ring, full0,
                     empty0, stages, it);
  consumers_sync();  // both warpgroups are done reading the x window

  // 2. h = bf16(lrelu(bf16(conv1 + b1))) over [t0 - halo2, t0 - halo2 +
  //    rows), zeros outside [0, T), written over the window. Accumulator
  //    element 4q + e of an m64n64 fragment is row 16 warp + lane/4 + 8
  //    (e / 2), output 8q + 2 (lane % 4) + e % 2.
  for (int idx = threadIdx.x; idx < 2 * halo2 * vecs; idx += kConsumers) {
    const int r = idx / vecs;  // rows conv2 reads only for rows it drops
    *reinterpret_cast<uint4*>(win + (size_t)(rows + r) * ld +
                              (idx - r * vecs) * 8) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float bias[16];
    load_bias(biases, nb, bias);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = nb * 64 + q * 8 + 2 * (lane % 4);
        if (n >= C) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          const int g = t0 - halo2 + r;
          float h0 = 0.f, h1 = 0.f;
          if (g >= 0 && g < seq_len) {
            h0 = lrelu(round_bf16(acc[mt][nb][4 * q + 2 * half] + bias[2 * q]),
                       slope);
            h1 = lrelu(round_bf16(acc[mt][nb][4 * q + 2 * half + 1] +
                                  bias[2 * q + 1]),
                       slope);
          }
          *reinterpret_cast<__nv_bfloat162*>(win + (size_t)r * ld + n) =
              __floats2bfloat162_rn(h0, h1);
        }
      }
    }
  }
  consumers_sync();

  // 3. y = x + (conv2(h) + b2), rounded once, over [t0, t0 + tile) in [0, T)
  conv_wgmma<NB, MT>(acc, window, row_bytes, row0, k2, 1, C, ring, full0,
                     empty0, stages, it);
  // x of the tile's rows, loaded whole with 16-byte loads into the window
  // (free once both warpgroups are past conv2), then read in the
  // accumulator's layout
  consumers_sync();
  {
    constexpr int kBatch = 8;
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
              xb + (size_t)(t0 + r) * C + (idx - r * vecs) * 8));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = first + u * kConsumers;
        if (idx >= vectors) break;
        const int r = idx / vecs;
        *reinterpret_cast<uint4*>(win + (size_t)r * ld + (idx - r * vecs) * 8) =
            v[u];
      }
    }
  }
  consumers_sync();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float bias[16];
    load_bias(biases + 256, nb, bias);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = nb * 64 + q * 8 + 2 * (lane % 4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
          const int g = t0 + r;
          if (n < C && r < tile && g < seq_len) {
            __nv_bfloat162* p =
                reinterpret_cast<__nv_bfloat162*>(win + (size_t)r * ld + n);
            const float2 xf = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(
                xf.x + (acc[mt][nb][4 * q + 2 * half] + bias[2 * q]),
                xf.y + (acc[mt][nb][4 * q + 2 * half + 1] + bias[2 * q + 1]));
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
    const int c = (idx - r * vecs) * 8;
    *reinterpret_cast<uint4*>(yb + (size_t)(t0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(win + (size_t)r * ld + c);
  }
}

template <int NB, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    resblock_pair_wgmma(const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ b2,
                        __nv_bfloat16* __restrict__ y, int seq_len, int C,
                        int k1, int k2, int dil, float slope, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  const int tile = 128 * MT - 2 * halo2;  // output rows of the block
  const int win_rows = 128 * MT + 2 * (halo1 > halo2 ? halo1 : halo2);
  __nv_bfloat16* win =
      reinterpret_cast<__nv_bfloat16*>(base + stages * NB * kTileBytes);
  const uint32_t full0 = smem_u32(win + (size_t)win_rows * (C + 8));
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  float* biases =
      reinterpret_cast<float*>(base + (empty0 + 8 * kMaxStages - ring));
  const int chunks = (C + kChunk - 1) / kChunk;
  const int t0 = blockIdx.x * tile;
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
        const int j = i < n1 ? i : i - n1;
        const int tap = j / chunks;
        const int chunk = j - tap * chunks;
        const CUtensorMap* map = i < n1 ? &w1_map : &w2_map;
        const uint32_t dst = ring + s * NB * kTileBytes;
        mbar_expect_tx(full0 + 8 * s, NB * kTileBytes);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_2d(dst + nb * kTileBytes, map, nb * 64,
                      tap * C + chunk * kChunk, full0 + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<NB, MT>(x, b1, b2, y, seq_len, C, k1, k2, dil, slope, stages,
                    ring, win, biases, full0, empty0, t0, batch_off);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime's
// entry-point query (no -lcuda at link time).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  std::lock_guard<std::mutex> lock(cache_mutex);
  if (!found) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// w (k, C, C) bf16 as a 2D map of (k * C rows of inputs) x (C outputs),
// boxes of 64 x 64 with 128-byte swizzle; out-of-range elements read zero.
cudaError_t weight_map(CUtensorMap* map, const void* w, int k, int C) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)k * C};
  const cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, kChunk};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using WgmmaKernel = void (*)(CUtensorMap, CUtensorMap, const __nv_bfloat16*,
                             const __nv_bfloat16*, const __nv_bfloat16*,
                             __nv_bfloat16*, int, int, int, int, int, float,
                             int);

// The instantiations: NB 64-wide output blocks (ceil(C / 64)) x MT m64
// tiles per warpgroup, at most 128 accumulator registers a thread.
WgmmaKernel wgmma_kernel(int nb, int mt) {
  switch (nb * 8 + mt) {
    case 1 * 8 + 1: return resblock_pair_wgmma<1, 1>;
    case 1 * 8 + 2: return resblock_pair_wgmma<1, 2>;
    case 1 * 8 + 4: return resblock_pair_wgmma<1, 4>;
    case 2 * 8 + 1: return resblock_pair_wgmma<2, 1>;
    case 2 * 8 + 2: return resblock_pair_wgmma<2, 2>;
    case 3 * 8 + 1: return resblock_pair_wgmma<3, 1>;
    case 4 * 8 + 1: return resblock_pair_wgmma<4, 1>;
    default: return nullptr;
  }
}

struct Plan {
  int mt, stages;
  size_t smem;
};

// The bf16 tile rule. A block computes 128 * MT rows of h and keeps
// 128 * MT - 2 * halo2 of y, and its time grows with MT; blocks run one an
// SM (the ring and the window fill its shared memory). Take the MT with the
// fewest waves x MT, ties to the larger MT (fewer weight tiles read a row),
// and the deepest ring (up to kMaxStages) that fits.
Plan plan_bf16(int sms, int batch, int seq_len, int C, int halo1, int halo2) {
  const int nb = (C + 63) / 64;
  Plan best{0, 0, 0};
  long best_cost = 0;
  for (int mt = 1; mt * nb <= 4; mt *= 2) {
    const int tile = 128 * mt - 2 * halo2;
    if (tile < 1) continue;
    int stages = kMaxStages;
    while (stages >= 2 &&
           wgmma_smem_bytes(nb, mt, stages, C, halo1, halo2) > kMaxSmem)
      --stages;
    if (stages < 2) continue;
    const long blocks = (long)((seq_len + tile - 1) / tile) * batch;
    const long cost = (blocks + sms - 1) / sms * mt;
    if (best.mt == 0 || cost <= best_cost) {
      best = {mt, stages, wgmma_smem_bytes(nb, mt, stages, C, halo1, halo2)};
      best_cost = cost;
    }
  }
  return best;
}

int launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* y, int batch, int seq_len, int C, int k1,
                int k2, int dil, float slope, cudaStream_t stream) {
  const int nb = (C + 63) / 64;
  const int halo1 = (k1 - 1) / 2 * dil;
  const int halo2 = (k2 - 1) / 2;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  Plan plan{0, 0, 0};
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
        for (int n = 1; n <= 4; ++n) {
          for (int m = 1; m <= 4; m *= 2) {
            const WgmmaKernel kernel = wgmma_kernel(n, m);
            if (kernel == nullptr) continue;
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)kMaxSmem);
            if (err != cudaSuccess) return (int)err;
          }
        }
        int sms = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return (int)err;
        sms_of[device] = sms;
      }
      plan = plan_bf16(sms_of[device], batch, seq_len, C, halo1, halo2);
      if (plan.mt == 0) return (int)cudaErrorInvalidValue;  // does not fit
      plans[key] = plan;
    }
  }
  CUtensorMap w1_map, w2_map;
  err = weight_map(&w1_map, w1, k1, C);
  if (err == cudaSuccess) err = weight_map(&w2_map, w2, k2, C);
  if (err != cudaSuccess) return (int)err;
  const int tile = 128 * plan.mt - 2 * halo2;
  const dim3 grid((seq_len + tile - 1) / tile, batch);
  const WgmmaKernel kernel = wgmma_kernel(nb, plan.mt);
  kernel<<<grid, kWgThreads, plan.smem, stream>>>(
      w1_map, w2_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y),
      seq_len, C, k1, k2, dil, slope, plan.stages);
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

// bf16 takes C a multiple of 16 up to 256 (the wrapper pads other C) and
// 16-byte aligned x, y, w1 and w2.
int dispatch_bf16(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* y, int batch,
                  int seq_len, int C, int k1, int k2, int dil, float slope,
                  void* stream) {
  if (batch < 0 || seq_len < 0 || C < 16 || C > 256 || C % 16 != 0 ||
      k1 < 1 || k2 < 1 || dil < 1 || k1 % 2 == 0 || k2 % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(w1, 16) || !aligned(w2, 16) ||
      !aligned(y, 16))
    return (int)cudaErrorMisalignedAddress;
  if (batch == 0 || seq_len == 0) return (int)cudaSuccess;
  return launch_bf16(x, w1, b1, w2, b2, y, batch, seq_len, C, k1, k2, dil,
                     slope, static_cast<cudaStream_t>(stream));
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
  return dispatch_bf16(x, w1, b1, w2, b2, y, batch, seq_len, channels, k1, k2,
                       dilation, slope, stream);
}

const char* resblock_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
