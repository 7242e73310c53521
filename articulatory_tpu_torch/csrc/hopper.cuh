// Hopper (sm_90a) primitives shared by the port's tensor-core kernels
// (resblock_pair.cu, scale_disc_head.cu): mbarriers, TMA loads, ldmatrix,
// wgmma and its shared-memory descriptors, the tf32 split, the fold of
// partial sums, and the tensor-map encoder with its cache.
//
// Both kernels have the same warp-specialised shape: one producer
// warpgroup, of which one thread keeps a ring of weight tiles full by TMA,
// and two consumer warpgroups that run wgmma on the tiles; the producer
// hands its registers to the consumers with setmaxnreg.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <type_traits>

namespace port_kernels {

constexpr size_t kMaxSmem = 232448;           // bytes a block may use on sm_90
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and one producer warpgroup
// registers a thread after the producer hands its own to the consumers
// (setmaxnreg): 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Per element type: the input channels of one of resblock_pair's ring
// stages, of one wgmma k step (32 bytes of an activation row), the k steps
// of one of its wgmma groups, and the A registers of one k step of one m64
// tile.
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kChunk = 64;
  static constexpr int kStep = 16;
  static constexpr int kGroup = 2;
  static constexpr int kFrag = 4;
};

template <>
struct Tile<float> {
  static constexpr int kChunk = 16;
  static constexpr int kStep = 8;
  static constexpr int kGroup = 1;
  static constexpr int kFrag = 8;  // tf32 hi in 0-3, lo in 4-7
};

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

// The same for a 3D tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
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
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a 64 (input channels, K) x 64 (outputs, N)
// bf16 tile as TMA writes it with 128-byte swizzle: N contiguous (MN-major),
// 8-row K groups 1024 bytes apart. The field for the stride between 64-wide
// N blocks is set to the same value: at N 64 there is one block.
__device__ __forceinline__ uint64_t b_desc_bf16(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Shared-memory descriptor of a K-major weight tile as TMA writes it with
// 64-byte swizzle: one 64-byte row of K (16 tf32 or 32 bf16 inputs) an
// output channel, 8-row N groups 512 bytes apart. addr moves 32 bytes
// along a row for the second k step; the leading offset is unused.
__device__ __forceinline__ uint64_t b_desc_k64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d (64 x 64 f32, the wgmma accumulator fragment) += A (64 x 16 bf16, the
// ldmatrix fragment a) x B (16 x 64 bf16 in shared memory, transposed).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
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

// d (64 x N f32) = A (64 x 8 tf32 in registers: a[0..3]) x B (8 x N tf32,
// K-major in shared memory) + (scale_d ? d : 0).
#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t* a, uint64_t desc,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n\t}"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n\t}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n\t}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

#undef ACC8

// f32 -> tf32, round to nearest, ties away from zero (low 13 bits zero).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// A fragment of one k step of one m64 tile: ldmatrix, and for f32 the
// split into tf32 hi (f[0..3]) and lo (f[4..7]).
template <typename T>
__device__ __forceinline__ void load_a(uint32_t addr,
                                       uint32_t (&f)[Tile<T>::kFrag]) {
  if constexpr (std::is_same_v<T, float>) {
    uint32_t raw[4];
    ldmatrix_x4(addr, raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = __uint_as_float(raw[i]);
      f[i] = to_tf32(a);
      f[4 + i] = to_tf32(a - __uint_as_float(f[i]));
    }
  } else {
    ldmatrix_x4(addr, f);
  }
}

// acc += part, once the wgmmas writing part are done (f32 adds, rounded to
// nearest). The tensor cores' own additions truncate; a partial sum's
// truncations are relative to its own, smaller size.
template <int MT, int NB, int N>
__device__ __forceinline__ void fold(float (&acc)[MT][NB][N],
                                     float (&part)[MT][NB][N]) {
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_operands(part[mt][nb]);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[mt][nb][i] += part[mt][nb][i];
    }
  }
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// Two consecutive elements of T in shared memory, as floats.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same_v<T, float>) {
    return *reinterpret_cast<const float2*>(p);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// The caches of a kernel library (the entry point, tensor maps, plans) are
// guarded by one mutex, so the per-launch host work is map lookups.
inline std::mutex cache_mutex;

inline cudaError_t encode_fn(EncodeTiled* fn) {
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

// A tensor map is a function of the address, shape and box alone, so each
// weight's is encoded once and kept, keyed by (address, shape and box
// fields): the decode's weights never move, training's move between steps
// (the caching allocator mostly hands back the same addresses). At most
// kMaxMaps are kept. One cache per caller; encode(map) makes a missing map.
constexpr size_t kMaxMaps = 4096;

class TensorMapCache {
 public:
  using Key = std::array<uint64_t, 4>;

  template <typename Encode>
  cudaError_t get(CUtensorMap* map, const Key& key, Encode encode) {
    {
      std::lock_guard<std::mutex> lock(cache_mutex);
      const auto it = maps_.find(key);
      if (it != maps_.end()) {
        *map = it->second;
        return cudaSuccess;
      }
    }
    const cudaError_t err = encode(map);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (maps_.size() >= kMaxMaps) maps_.clear();
    maps_[key] = *map;
    return cudaSuccess;
  }

 private:
  std::map<Key, CUtensorMap> maps_;
};

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace port_kernels
