// HiFi-GAN scale-discriminator head (layers 0 and 1) for Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded with ctypes by
// articulatory_tpu_torch/ops/scale_disc_head.py).
//
// Replaces articulatory_tpu/ops/pallas/scale_disc_head.py::scale_disc_head_pallas
// (:150):
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
// (T - 1) / s + 1. The stride is a runtime argument (the repo's configs run
// layer 1 at stride 4, the Pallas kernel fixed it at 2); any T >= 1.
//
// What bounds it: 2*B*T*128*15 + 2*B*T1*128*32*41 flops, 96 % of them in
// layer 1, against x, h0 and h1 once each in device memory. f32 runs layer
// 1 as 3xTF32 (three tf32 products a multiply-add) and is bound by
// operations (495 TFLOP/s / 3); bf16 (989 TFLOP/s) is bound by bytes, by the
// h0 store above all (128 channels a sample of x). Inside a block, the
// weights each block streams from L2 (41 taps of its group) and layer 0's
// serial phase are the costs the tile size trades against the waves.
//
// Design, one template scale_disc_head_wgmma<T, MT> for both types. A
// block takes one group of one batch row over a tile of up to 128 * MT h1
// rows: the groups share no inputs, and a block that holds one group's
// window (32 channels a row) keeps four times the rows of one that holds
// all 128, so each weight tile it streams serves four times the rows.
// - Layer 0 (15 taps, one input channel) stays on the CUDA cores in fp32
//   FMAs, for the group's 32 channels. The block stages its x window in
//   shared memory; each thread computes 16 bytes of channels (4 f32, 8
//   bf16) of 4 (f32) or 2 (bf16) consecutive rows from x values in
//   registers and writes
//   them straight into the h0 window in the layout layer 1's A operand
//   reads, and, for the h0 rows the block owns ([t0 s, (t0 + V) s) within
//   [0, T)), once to device memory in a 16-byte store. Rows outside [0, T)
//   are zero in the window. bf16 rounds after the bias add and after the
//   lrelu, where the unfused bf16 convolution rounds.
// - Layer 1 is an implicit GEMM for the group: M = h1 rows, N = the group's
//   32 outputs, depth = 32 inputs x 41 taps = 1312. Each k step (32 bytes
//   of an h0 row: 8 tf32 or 16 bf16 inputs) issues one m64n32 wgmma an m64
//   tile (f32: three). The grouped weight is never densified (the Pallas
//   kernel's (41, 128, 128) is four times the tensor work).
// - A comes from a polyphase h0 window: tap k of h1 row t reads h0 row
//   s t + k - 20, window row r = s (t - t0) + k, which is kept at phase
//   r mod s, row r div s. Every tap then reads contiguous rows of one phase
//   (phase k mod s, from row (t - t0) + k div s), so ldmatrix's eight rows of
//   a k step fall on distinct banks (row stride 32 * sizeof(T) + 16 bytes),
//   where rows s apart in a plain layout could share them. It generalises
//   the Pallas kernel's even/odd split to any s, and costs no device-memory
//   traffic: layer 0 writes it. Only the phases a tap reads are kept,
//   min(s, 41) of them, V + 40 / s rows each (V the block's h1 rows).
// - B comes by TMA into a ring of up to 16 stages (full/empty mbarriers):
//   one producer warpgroup (one thread issues the loads) and two consumer
//   warpgroups with setmaxnreg, as in resblock_pair.cu; the consumer
//   warpgroups split the rows. wgmma reads 32-bit B only K-major, so a prep
//   kernel (split_weights_kernel) writes wg as (parts, 41, 128 out, 32 in):
//   f32 tf32 hi then lo, bf16 the weights as they are. A stage is one tap
//   of the group: 32 outputs x 64-byte K chunks (f32 2 chunks of 16 inputs,
//   hi and lo: 8 KB; bf16 one chunk of 32 inputs: 2 KB), boxes read with
//   64-byte swizzle. The k steps of a stage go into their own fragment
//   buffers, so all but one stay in flight while the next is loaded.
// - f32 is 3xTF32: layer 0 writes each h0 value to the window as two
//   copies, tf32 hi and lo (a tf32 split in the GEMM loop, once for each of
//   the ~41 / s taps that read a value, cost more time than the products
//   in a probe), each k step loads both with ldmatrix and issues lo*hi,
//   hi*lo, hi*hi into a partial sum
//   that is folded into f32 accumulators every kFoldSteps k steps (the
//   tensor cores' own additions truncate), so the head keeps f32's accuracy
//   against a float64 reference, which one tf32 product would not.
// - Tiles (make_plan): MT m64 tiles a warpgroup, f32 1 or 2, bf16 1, 2 or
//   4. Shared memory at stride 4, window rows x row bytes + ring stages:
//   f32 MT 1 (128 rows): 2 x 552 x 144 B + 8 x 8 KB = 224,512 B; bf16 MT 4
//   (512 rows): 2088 x 80 B + 16 x 2 KB = 199,808 B (plus alignment,
//   barriers and x). Where the window of a full tile does not fit (a large
//   stride: at s 64 it holds 41 phases), a block keeps fewer valid rows V;
//   ldmatrix's rows past V are clamped to row V - 1 and their results
//   dropped. The plan is cached per shape.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "vec.cuh"

namespace {

using namespace port_kernels;

constexpr int kChannels = 128;       // h0 and h1 channels
constexpr int kGroups = 4;           // groups of layer 1
constexpr int kGroupIn = 32;         // input (and output) channels a group
constexpr int kK0 = 15, kPad0 = 7;   // layer 0
constexpr int kK1 = 41, kPad1 = 20;  // layer 1
constexpr int kMaxStages = 16;       // depth of the weight ring
constexpr int kBoxRow = 64;          // bytes of one output's K chunk
constexpr int kBoxBytes = kGroupIn * kBoxRow;   // one TMA box: 32 outputs
constexpr int kBarrierBytes = 16 * kMaxStages;  // full and empty mbarriers
constexpr int kMaxRows0 = 8;         // layer-0 rows a thread takes, at most

// f32: k steps summed on the tensor cores before the sum is folded into
// the accumulators (256 of a group's 1312 inputs x taps).
constexpr int kFoldSteps = 32;

// Per element type: parts of the prepared weights and copies of the h0
// window (f32: tf32 hi and lo), 64-byte K chunks a tap, k steps (32 bytes)
// and bytes of a ring stage (one tap), channels of 16 bytes, and layer-0
// rows a thread takes a pass (bf16 holds the weights of twice the channels
// in registers).
template <typename T>
struct Head {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kParts = kF32 ? 2 : 1;
  static constexpr int kChunks = kGroupIn * (int)sizeof(T) / kBoxRow;
  static constexpr int kSteps = 2 * kChunks;
  static constexpr int kStageBytes = kChunks * kParts * kBoxBytes;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kRows0 = kF32 ? 4 : 2;
};

// The h0 window of a block that keeps `valid` h1 rows: phases x rows, each
// row the group's 32 channels of T plus 16 bytes; span is the h0 rows layer
// 0 covers, those layer 1 reads and those the block owns (they reach
// further when the stride is above 21).
struct Window {
  int valid, phases, rows, row_bytes, span;
};

__host__ __device__ inline Window window(int elem, int valid, int stride) {
  const int taps = (valid - 1) * stride + kK1;
  const int owned = valid * stride + kPad1;
  return {valid, stride < kK1 ? stride : kK1, valid + (kK1 - 1) / stride,
          kGroupIn * elem + 16, taps > owned ? taps : owned};
}

// x window entries: layer 0's inputs for the span, and up to a pass of
// rows past it (read, not used).
__host__ __device__ inline int x_entries(const Window& w) {
  return w.span + 2 * kPad0 + kMaxRows0;
}

// Shared memory: the ring (1024-byte aligned, for the swizzle), the
// barriers, the window's parts and the x window in f32; plus slack to
// align the ring.
template <typename T>
size_t smem_bytes(const Window& w, int stages) {
  return 1024 + (size_t)stages * Head<T>::kStageBytes + kBarrierBytes +
         (size_t)Head<T>::kParts * w.phases * w.rows * w.row_bytes +
         (size_t)x_entries(w) * sizeof(float);
}

// d (64 x 32 f32) += A (64 x 16 bf16, the ldmatrix fragment a) x B (16 x 32
// bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %21, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The products of one k step of one m64 tile into d, B at b (the group's
// 32 outputs, moved to the k step; for f32 the lo box follows the hi one).
// f32 with fresh set overwrites d (a new partial sum).
template <typename T>
__device__ __forceinline__ void tile_step(float (&d)[16],
                                          const uint32_t (&f)[Tile<T>::kFrag],
                                          uint32_t b, bool fresh) {
  if constexpr (Head<T>::kF32) {
    // the small products first, into the same accumulators
    wgmma_tf32<32>(d, f + 4, b_desc_k64(b), fresh ? 0 : 1);
    wgmma_tf32<32>(d, f, b_desc_k64(b + kBoxBytes), 1);
    wgmma_tf32<32>(d, f, b_desc_k64(b), 1);
  } else {
    wgmma_bf16_n32(d, f, b_desc_k64(b));
  }
}

// 16 bytes of T from kVec floats already rounded to T: for bf16 the high
// halves of the f32 patterns, by byte permutes (a conversion issues at an
// eighth of the FMA rate on sm_90).
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&v)[Head<T>::kVec]) {
  if constexpr (Head<T>::kF32) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = __byte_perm(__float_as_uint(v[2 * q]),
                         __float_as_uint(v[2 * q + 1]), 0x7632);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// f32 -> tf32, round to nearest, ties away from zero, as cvt.rna.tf32.f32
// for finite values, by integer operations (cheaper than a conversion).
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// Layer 0 for the group's channels c_g .. c_g + 32 over the block's span of
// h0 rows (window row r is h0 row lo + r), into the window (f32: its tf32
// hi and lo copies, win_lo bytes apart, so that layer 1 splits no operand)
// and, for owned rows, device memory. A thread takes kRows0 consecutive
// rows of 16 bytes of channels a pass, from x in registers.
template <typename T>
__device__ __forceinline__ void layer0(const float* xs, const T* __restrict__ w0,
                                       const T* __restrict__ b0, T* h0b,
                                       T* win, uint32_t win_lo,
                                       const Window& geo, int stride,
                                       int seq_len, int c_g, int lo,
                                       int own_lo, int own_hi, float slope) {
  constexpr int kVec = Head<T>::kVec;
  constexpr int kRows0 = Head<T>::kRows0;
  constexpr int kLanes = kGroupIn / kVec;                // threads a row
  constexpr int kPass = kConsumers / kLanes * kRows0;    // rows a pass
  const int c = (threadIdx.x % kLanes) * kVec;  // within the group
  float w[kK0][kVec];
  float bias[kVec];
#pragma unroll
  for (int k = 0; k < kK0; ++k) {
#pragma unroll
    for (int o = 0; o < kVec; ++o)
      w[k][o] = load1(w0 + k * kChannels + c_g + c + o);
  }
#pragma unroll
  for (int o = 0; o < kVec; ++o) bias[o] = b0 ? load1(b0 + c_g + c + o) : 0.f;
  const int ld = geo.row_bytes / (int)sizeof(T);
  for (int r0 = threadIdx.x / kLanes * kRows0; r0 < geo.span; r0 += kPass) {
    float xv[kRows0 + kK0 - 1];
#pragma unroll
    for (int i = 0; i < kRows0 + kK0 - 1; ++i) xv[i] = xs[r0 + i];
    int phase = r0 % stride, pr = r0 / stride;
#pragma unroll
    for (int i = 0; i < kRows0; ++i) {
      const int r = r0 + i, g = lo + r;
      const bool kept = phase < geo.phases && pr < geo.rows && r < geo.span;
      const bool owned = g >= own_lo && g < own_hi;
      if (kept || owned) {
        float acc[kVec];
#pragma unroll
        for (int o = 0; o < kVec; ++o) acc[o] = 0.f;
#pragma unroll
        for (int k = 0; k < kK0; ++k) {
#pragma unroll
          for (int o = 0; o < kVec; ++o)
            acc[o] = fmaf(xv[i + k], w[k][o], acc[o]);
        }
        float v[kVec];
#pragma unroll
        for (int o = 0; o < kVec; ++o) {
          const float h = working<T>(acc[o] + bias[o]);
          v[o] = (g >= 0 && g < seq_len) ? working<T>(lrelu(h, slope)) : 0.f;
        }
        if (owned)
          *reinterpret_cast<uint4*>(h0b + (size_t)g * kChannels + c_g + c) =
              pack16<T>(v);
        if (kept) {
          T* at = win + (size_t)(phase * geo.rows + pr) * ld + c;
          if constexpr (Head<T>::kF32) {
            float hi[kVec], rest[kVec];
#pragma unroll
            for (int o = 0; o < kVec; ++o) {
              hi[o] = tf32_round(v[o]);
              rest[o] = tf32_round(v[o] - hi[o]);
            }
            *reinterpret_cast<uint4*>(at) = pack16<T>(hi);
            *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(at) +
                                      win_lo) = pack16<T>(rest);
          } else {
            *reinterpret_cast<uint4*>(at) = pack16<T>(v);
          }
        }
      }
      if (++phase == stride) {
        phase = 0;
        ++pr;
      }
    }
  }
}

// A fragment of one k step of one m64 tile: ldmatrix, and for f32 the lo
// copy of the window (win_lo bytes on) into f[4..7].
template <typename T>
__device__ __forceinline__ void load_frag(uint32_t addr, uint32_t win_lo,
                                          uint32_t (&f)[Tile<T>::kFrag]) {
  if constexpr (Head<T>::kF32) {
    uint32_t hi[4], rest[4];
    ldmatrix_x4(addr, hi);
    ldmatrix_x4(addr + win_lo, rest);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = hi[i];
      f[4 + i] = rest[i];
    }
  } else {
    ldmatrix_x4(addr, f);
  }
}

// The consumer warpgroups' part of the kernel for group g of rows t0 +
// [0, valid): stage x, layer 0, layer 1 on the tensor cores, h1 out. Each
// warpgroup takes MT m64 tiles of rows.
template <typename T, int MT>
__device__ __forceinline__ void consume(
    const T* __restrict__ x, const T* __restrict__ w0, const T* __restrict__ b0,
    const T* __restrict__ b1, T* __restrict__ h0, T* __restrict__ h1,
    int seq_len, int out_len, int stride, float slope, const Window& geo,
    T* win, float* xs, uint32_t ring, uint32_t full0, uint32_t empty0,
    int stages, int t0, int grp) {
  const int b = blockIdx.y;
  const int c_g = grp * kGroupIn;      // the group's first channel
  const int lo = t0 * stride - kPad1;  // h0 row of window row 0
  const int own_lo = t0 * stride;
  const int own_hi = min((t0 + geo.valid) * stride, seq_len);

  // 1. x over [lo - 7, lo + span + 7) and a pass's rows on, zeros outside
  //    [0, T)
  //    kBatch loads in flight a thread
  const T* xb = x + (size_t)b * seq_len;
  constexpr int kBatch = 4;
  const int entries = x_entries(geo);
  for (int first = threadIdx.x; first < entries;
       first += kBatch * kConsumers) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = first + u * kConsumers, g = lo - kPad0 + i;
      v[u] = i < entries && g >= 0 && g < seq_len ? load1(xb + g) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = first + u * kConsumers;
      if (i < entries) xs[i] = v[u];
    }
  }
  consumers_sync();

  // 2. layer 0 into the polyphase window and the owned h0 rows
  const uint32_t win_lo = geo.phases * geo.rows * geo.row_bytes;
  layer0<T>(xs, w0, b0, h0 + (size_t)b * seq_len * kChannels, win, win_lo,
            geo, stride, seq_len, c_g, lo, own_lo, own_hi, slope);
  consumers_sync();

  // 3. layer 1: per tap one ring stage of kSteps k steps. Each k step is
  //    one wgmma group (MT tiles; f32 three products each) into fragment
  //    buffer j, with up to kSteps - 1 groups in flight.
  constexpr bool kF32 = Head<T>::kF32;
  constexpr int kSteps = Head<T>::kSteps;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int row0 = (threadIdx.x / 128) * 64 * MT;  // this warpgroup's rows
  // ldmatrix x4: lanes 0-7 address rows 0-7 (bytes 0-15 of the k step),
  // lanes 8-15 rows 8-15, lanes 16-31 the same rows' bytes 16-31; rows past
  // the block's valid rows read row valid - 1 (their results are dropped)
  uint32_t a_lane[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min(row0 + mt * 64 + warp * 16 + (lane & 7) +
                          ((lane >> 3) & 1) * 8,
                      geo.valid - 1);
    a_lane[mt] = smem_u32(win) + (uint32_t)r * geo.row_bytes + (lane >> 4) * 16;
  }
  float acc[MT][1][16];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[mt][0][i] = 0.f;
  }
  float part[kF32 ? MT : 1][1][kF32 ? 16 : 1];
  uint32_t frag[kSteps][MT][Tile<T>::kFrag];
  int summed = 0;  // f32: k steps in part since the last fold
  int s = 0;
  uint32_t parity = 0;
  int prev = -1;  // ring slot of the previous stage, freed once it is read
  for (int tap = 0; tap < kK1; ++tap) {
    const uint32_t a_tap =
        (uint32_t)((tap % stride) * geo.rows + tap / stride) * geo.row_bytes;
    mbar_wait(full0 + 8 * s, parity);
    const uint32_t b_stage = ring + s * Head<T>::kStageBytes;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int chunk = j / 2, kk = j % 2;
      if constexpr (kF32) {
        if (summed == kFoldSteps) {
          fold(acc, part);
          summed = 0;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_frag<T>(a_lane[mt] + a_tap + chunk * kBoxRow + kk * 32, win_lo,
                     frag[j][mt]);
      wgmma_fence();
      const uint32_t bj =
          b_stage + chunk * Head<T>::kParts * kBoxBytes + kk * 32;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kF32)
          tile_step<T>(part[mt][0], frag[j][mt], bj, summed == 0);
        else
          tile_step<T>(acc[mt][0], frag[j][mt], bj, false);
      }
      wgmma_commit();
      // at most kSteps - 1 groups in flight: buffer j + 1 is free again
      wgmma_wait<kSteps - 1>();
      if constexpr (kF32) ++summed;
      if (j == kSteps - 2 && prev >= 0) {  // the previous stage is read
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
    }
    prev = s;
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  if constexpr (kF32) {
    fold(acc, part);
  } else {
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt][0]);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(empty0 + 8 * prev);

  // 4. h1 = lrelu(T(acc + b1)) over the block's valid rows within [0, T1).
  //    Accumulator element 4q + e of an m64n32 fragment is row 16 warp +
  //    lane/4 + 8 (e / 2), output 8q + 2 (lane % 4) + e % 2.
  T* h1b = h1 + (size_t)b * out_len * kChannels;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = c_g + q * 8 + 2 * (lane % 4);
    const float bias0 = b1 ? load1(b1 + o) : 0.f;
    const float bias1 = b1 ? load1(b1 + o + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 64 + warp * 16 + lane / 4 + half * 8;
        const int t = t0 + r;
        if (r < geo.valid && t < out_len) {
          const float v0 = working<T>(acc[mt][0][4 * q + 2 * half] + bias0);
          const float v1 =
              working<T>(acc[mt][0][4 * q + 2 * half + 1] + bias1);
          store2<T>(h1b + (size_t)t * kChannels + o, lrelu(v0, slope),
                    lrelu(v1, slope));
        }
      }
    }
  }
}

// w_map: the prepared weights (parts * 41 * 128 rows of 32 inputs) as a
// 2D map, boxes of 64 bytes x 32 outputs with 64-byte swizzle. Block
// (blockIdx.x / 4, blockIdx.x % 4, blockIdx.y) takes the rows of one time
// tile, one group and one batch row.
template <typename T, int MT>
__global__ void __launch_bounds__(kWgThreads, 1)
    scale_disc_head_wgmma(const __grid_constant__ CUtensorMap w_map,
                          const T* __restrict__ x, const T* __restrict__ w0,
                          const T* __restrict__ b0, const T* __restrict__ b1,
                          T* __restrict__ h0, T* __restrict__ h1, int seq_len,
                          int out_len, int stride, float slope, int valid,
                          int stages) {
  constexpr int kStageBytes = Head<T>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - raw);
  const Window geo = window(sizeof(T), valid, stride);
  const uint32_t full0 = ring + stages * kStageBytes;
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  T* win = reinterpret_cast<T*>(base + stages * kStageBytes + kBarrierBytes);
  float* xs = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(win) +
      (size_t)Head<T>::kParts * geo.phases * geo.rows * geo.row_bytes);
  const int t0 = (blockIdx.x / kGroups) * valid;
  const int grp = blockIdx.x % kGroups;

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
    // producer: the group's weights of every tap through the ring
    if (threadIdx.x == kConsumers) {
      for (int tap = 0; tap < kK1; ++tap) {
        const int s = tap % stages;
        mbar_wait(empty0 + 8 * s, ((tap / stages) & 1) ^ 1);
        const uint32_t dst = ring + s * kStageBytes;
        mbar_expect_tx(full0 + 8 * s, kStageBytes);
#pragma unroll
        for (int chunk = 0; chunk < Head<T>::kChunks; ++chunk) {
#pragma unroll
          for (int part = 0; part < Head<T>::kParts; ++part)
            tma_load_2d(dst + (chunk * Head<T>::kParts + part) * kBoxBytes,
                        &w_map, chunk * kBoxRow / (int)sizeof(T),
                        (part * kK1 + tap) * kChannels + grp * kGroupIn,
                        full0 + 8 * s);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<T, MT>(x, w0, b0, b1, h0, h1, seq_len, out_len, stride, slope,
                   geo, win, xs, ring, full0, empty0, stages, t0, grp);
  }
}

// wg (41, 32, 128), (tap, in, out), into s (parts, 41, 128, 32), (part,
// tap, out, in): f32 [0] tf32(w), [1] tf32(w - [0]); bf16 [0] w. A 32 x 32
// tile of one tap a block, transposed through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
    split_weights_kernel(const T* __restrict__ wg, T* __restrict__ s) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.y, out0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < kGroupIn; r += 8)  // r: input
    tile[r][threadIdx.x] =
        load1(wg + ((size_t)tap * kGroupIn + r) * kChannels + out0 +
              threadIdx.x);
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {  // r: output out0 + r
    const float v = tile[threadIdx.x][r];
    const size_t at =
        ((size_t)tap * kChannels + out0 + r) * kGroupIn + threadIdx.x;
    if constexpr (Head<T>::kF32) {
      const uint32_t hi = to_tf32(v);
      s[at] = __uint_as_float(hi);
      s[at + (size_t)kK1 * kChannels * kGroupIn] =
          __uint_as_float(to_tf32(v - __uint_as_float(hi)));
    } else {
      s[at] = __float2bfloat16(v);
    }
  }
}

// The prepared weights as a 2D map: 32 inputs (inner) x parts * 41 * 128
// rows, boxes of 64 bytes x 32 outputs, 64-byte swizzle.
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const void* ws) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)kGroupIn,
                              (cuuint64_t)Head<T>::kParts * kK1 * kChannels};
  const cuuint64_t strides[1] = {(cuuint64_t)kGroupIn * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(kBoxRow / sizeof(T)),
                             (cuuint32_t)kGroupIn};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map,
      Head<T>::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ws), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t cached_weight_map(CUtensorMap* map, const void* ws) {
  static TensorMapCache maps;
  return maps.get(map, {reinterpret_cast<uint64_t>(ws), 0, 0, 0},
                  [&](CUtensorMap* m) { return weight_map<T>(m, ws); });
}

template <typename T>
using HeadKernel = void (*)(CUtensorMap, const T*, const T*, const T*,
                            const T*, T*, T*, int, int, int, float, int, int);

// The instantiations: MT m64 tiles a warpgroup, 128 * MT rows a block. f32
// MT 1 and 2 (its accumulators, partial sums and four k steps of tf32
// fragments in flight fill the registers at 2); bf16 MT 1, 2 and 4.
template <typename T>
HeadKernel<T> head_kernel(int mt) {
  if (mt == 1) return scale_disc_head_wgmma<T, 1>;
  if (mt == 2) return scale_disc_head_wgmma<T, 2>;
  if constexpr (!Head<T>::kF32) {
    if (mt == 4) return scale_disc_head_wgmma<T, 4>;
  }
  return nullptr;
}

struct Plan {
  int mt, valid, stages;
  size_t smem;
};

// The tile rule. A block of MT tiles a warpgroup keeps up to 128 * MT h1
// rows of one group, fewer where their window does not fit beside a ring
// of 2 stages; blocks run one an SM. A block's time grows with MT, plus a
// fixed part about that of one MT (the weights' 41 stages through the ring,
// layer 0's halo, the pipeline's fill). Take the fewest waves x (MT + 1),
// ties to the smaller MT (a larger one may keep fewer valid rows than it
// computes), and the deepest ring (up to kMaxStages) that fits.
template <typename T>
Plan make_plan(int sms, int batch, int out_len, int stride) {
  Plan best{0, 0, 0, 0};
  long best_cost = 0;
  for (int mt = 1; mt <= 4; mt *= 2) {
    if (head_kernel<T>(mt) == nullptr) continue;
    int valid = min(128 * mt, out_len);
    while (valid > 0 &&
           smem_bytes<T>(window(sizeof(T), valid, stride), 2) > kMaxSmem)
      --valid;
    if (valid == 0) continue;
    const Window geo = window(sizeof(T), valid, stride);
    int stages = kMaxStages;
    while (smem_bytes<T>(geo, stages) > kMaxSmem) --stages;
    const long blocks = (long)((out_len + valid - 1) / valid) * kGroups * batch;
    const long cost = (blocks + sms - 1) / sms * (mt + 1);
    if (best.mt == 0 || cost < best_cost) {
      best = {mt, valid, stages, smem_bytes<T>(geo, stages)};
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch(const void* x, const void* w0, const void* b0, const void* ws,
           const void* b1, void* h0, void* h1, int batch, int seq_len,
           int stride, float slope, cudaStream_t stream) {
  if (batch < 0 || seq_len < 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (!aligned(ws, 16) || !aligned(h0, 16) || !aligned(h1, 16))
    return (int)cudaErrorMisalignedAddress;
  if (batch == 0 || seq_len == 0) return (int)cudaSuccess;
  const int out_len = (seq_len - 1) / stride + 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  Plan plan{0, 0, 0, 0};
  {
    static std::map<int, int> sms_of;  // device -> SM count, attributes set
    static std::map<std::array<int, 4>, Plan> plans;  // shape -> plan
    const std::array<int, 4> key{device, batch, out_len, stride};
    std::lock_guard<std::mutex> lock(cache_mutex);
    const auto it = plans.find(key);
    if (it != plans.end()) {
      plan = it->second;
    } else {
      if (sms_of.find(device) == sms_of.end()) {
        for (int mt = 1; mt <= 4; mt *= 2) {
          const HeadKernel<T> kernel = head_kernel<T>(mt);
          if (kernel == nullptr) continue;
          err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              (int)kMaxSmem);
          if (err != cudaSuccess) return (int)err;
        }
        int sms = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return (int)err;
        sms_of[device] = sms;
      }
      plan = make_plan<T>(sms_of[device], batch, out_len, stride);
      if (plan.mt == 0) return (int)cudaErrorInvalidValue;  // does not fit
      plans[key] = plan;
    }
  }
  CUtensorMap w_map;
  err = cached_weight_map<T>(&w_map, ws);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((out_len + plan.valid - 1) / plan.valid * kGroups, batch);
  head_kernel<T>(plan.mt)<<<grid, kWgThreads, plan.smem, stream>>>(
      w_map, static_cast<const T*>(x), static_cast<const T*>(w0),
      static_cast<const T*>(b0), static_cast<const T*>(b1), static_cast<T*>(h0),
      static_cast<T*>(h1), seq_len, out_len, stride, slope, plan.valid,
      plan.stages);
  return (int)cudaGetLastError();
}

template <typename T>
int split(const void* wg, void* s, cudaStream_t stream) {
  if (!aligned(s, 16)) return (int)cudaErrorMisalignedAddress;
  split_weights_kernel<T><<<dim3(kChannels / 32, kK1), dim3(32, 8), 0,
                            stream>>>(static_cast<const T*>(wg),
                                      static_cast<T*>(s));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). b0 and b1 may be
// null (no bias). ws is scale_disc_head_split_*'s output for wg. h0 is
// (batch, seq_len, 128), h1 (batch, (seq_len - 1) / stride + 1, 128).
// stream is a cudaStream_t; the call does not synchronise.
int scale_disc_head_f32(const void* x, const void* w0, const void* b0,
                        const void* ws, const void* b1, void* h0, void* h1,
                        int batch, int seq_len, int stride, float slope,
                        void* stream) {
  return launch<float>(x, w0, b0, ws, b1, h0, h1, batch, seq_len, stride,
                       slope, static_cast<cudaStream_t>(stream));
}

int scale_disc_head_bf16(const void* x, const void* w0, const void* b0,
                         const void* ws, const void* b1, void* h0, void* h1,
                         int batch, int seq_len, int stride, float slope,
                         void* stream) {
  return launch<__nv_bfloat16>(x, w0, b0, ws, b1, h0, h1, batch, seq_len,
                               stride, slope,
                               static_cast<cudaStream_t>(stream));
}

// wg (41, 32, 128) into ws (2, 41, 128, 32) f32 (tf32 hi, lo) or
// (1, 41, 128, 32) bf16: one launch.
int scale_disc_head_split_f32(const void* wg, void* ws, void* stream) {
  return split<float>(wg, ws, static_cast<cudaStream_t>(stream));
}

int scale_disc_head_split_bf16(const void* wg, void* ws, void* stream) {
  return split<__nv_bfloat16>(wg, ws, static_cast<cudaStream_t>(stream));
}

const char* scale_disc_head_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
