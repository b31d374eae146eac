// int8 convolution for Hopper (sm_90a): s8 activations x s8 weights summed
// in int32 on the tensor cores through wgmma, with a fused dequantizing
// epilogue, and the passes of dynamic quantization that feed it.
//
// Replaces no Pallas kernel: the JAX package computes this convolution with
// XLA, lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32 (medical_image_editing_tpu/ops/
// quantized_conv.py:104-108), its activation passes (_quantize_sym, :56-61)
// and its weight fold (:86-87 with _quantize_sym) with XLA reductions and
// elementwise ops. PyTorch has no int8 convolution on CUDA (F.conv2d refuses
// torch.int8), so the port writes all four by hand.
//
// * channel_absmax_kernel: amax over (N, H, W) of |x[:, c]| for an NCHW f32
//   or bf16 activation, into a zeroed (C,) f32 vector. Block partial maxima
//   meet through atomicMax on the float's bits (non-negative floats order as
//   their bit patterns), so the result does not depend on the order: it is
//   exactly the plain version's.
// * conv_s8_weights_kernel: the weight fold in one launch, one block an
//   output channel o (at most 9 * 512 values): x_scale[c] =
//   max(amax[c], 1e-12) / 127, k_fold = W[o] * x_scale[cin], k_scale[o] =
//   max(amax |k_fold[o]|, 1e-12) / 127 (a block max: exact in any order),
//   codes clamp(rint(k_fold / k_scale[o]), +-127) written as s8 [tap][o][c],
//   zero for c past Cin; block 0 also writes x_scale for quantize_s8. Every
//   division is __fdiv_rn and every product __fmul_rn, as the plain torch
//   ops round them. It replaces ~16 torch launches a convolution. Bound: a
//   few microseconds of bytes (the f32 weight read, the codes written).
// * quantize_s8_kernel: q = clamp(rint(x / scale[c]), -127, 127) as s8, with
//   IEEE division (__fdiv_rn) and round half to even (rintf; roundf would
//   round half away from zero), written channels-innermost (NHWC) with the
//   channels padded by zeros to a multiple of 32, so that one K-step of the
//   GEMM below reads 32 contiguous bytes of one pixel. A block transposes a
//   tile of 32 pixels x 32 channels through shared memory: reads along the
//   pixels of one channel, writes 4-byte words along the channels.
// * conv_s8: an implicit GEMM, M = output pixels (N*Ho*Wo, flat, any batch
//   and size), N = Cout, K = taps x Cin padded to 32. Stride 1, any kernel
//   size, dilation and symmetric padding per axis: the decoder's 3x3 SAME,
//   1x1 and the ASPP's rates 2/6/12/18. Two kernels share the tile, the
//   tensor cores and the epilogue; they differ in how K reaches shared
//   memory. ops/quantized_conv.py::conv_s8_instance picks one of
//   CONV_S8_INSTANCES (below) by shape.
//   - What bounds it. The decoder's 512^2 and 256^2 convolutions (Cout
//     <= 64) are bound by bytes, mostly the f32 output (32 -> 32, 3x3, 512^2,
//     batch 8: 67 MB of s8 in, 268 MB of f32 out, 0.100 ms at 3.35 TB/s
//     against 0.020 ms of operations). The Cin >= 256 convolutions at
//     32^2-64^2 are bound by the int8 tensor-core rate (1979 TOP/s dense):
//     512 -> 512 at 32^2 is 38.7 G operations for 10 MB of bytes. In
//     between, what each block copies into shared memory bounds it: the
//     copies run at 2.4-3.4 TB/s over the card (tools/conv_s8_sweep.py on
//     an H100), so the design copies as few bytes as it can.
//   - The tile: BM = 128 output pixels x BN = 32, 64 or 128 output
//     channels (the least multiple of 32 past Cout up to 128) a block of
//     two warpgroups; each warpgroup issues
//     wgmma.mma_async.m64nBNk32.s32.s8.s8 with A and B from shared memory
//     descriptors, 16-64 int32 sums a thread. wgmma for every shape: at the
//     bytes-bound shapes the 64-row granularity costs nothing and the
//     accumulators are few, so an mma.sync path would only add code.
//   - The ring: STAGES shared-memory slots, each 16 bytes one cp.async
//     (src-size 0 zero-fills a tap outside the image, a pixel past M, a
//     channel past Cout and a chunk past the last: nothing is read),
//     PREFETCH steps in flight ahead of the one multiplied; after each
//     step's wgmma batch the warpgroup waits until at most STAGES - 1 -
//     PREFETCH batches run, so no slot is refilled before its batch is done
//     (cp.async.wait_group, then fence.proxy.async and a block barrier
//     before wgmma reads what the copies wrote).
//   - conv_s8_kernel<BN, KC, ...> (any shape): a step is KC 32-byte chunks
//     q = (tap, 32 channels) of the flat (taps x Cp) reduction: A gathers
//     each pixel's tap-shifted 32 bytes (9 x 4 KB a 3x3 chunk), B the
//     weights. Shared memory is K-major in the swizzle of its row width
//     (KB = 32 KC bytes: 16-byte piece c of row r at c ^ ((r*KB >> 7) &
//     (KB/16 - 1))), which the descriptors name (stride offset 8 KB bytes,
//     start advanced 32 bytes a k32 slice). It takes Cin <= 32, the 1x1
//     convolutions and rows narrower than 64 (32^2).
//   - conv_s8_kernel_rows<BN, KYS, ...> (3x3, Wo % 64 == 0, Cin > 32): each
//     warpgroup's 64 pixels are one run of one output row, so the 3 taps of
//     a kernel row read one segment of 64 + 2 dw input pixels at shifts
//     of dw. A step is KYS = 3 kernel rows x 32 channels: the segments, K-major
//     without swizzle (rows at a 16-byte pitch, the two 16-byte halves of a
//     k32 slice a segment apart), and the 9 taps' weights; a tap's A is its
//     segment at start + 16 kx dw bytes. Each input byte is copied 3 times,
//     not 9: at 64 -> 32, 512^2 0.43 against 0.55 ms, at 256 -> 256, 64^2
//     0.083 against 0.12 ms (H100, tools/conv_s8_sweep.py).
//   - Epilogue (store_tile): out = f32(acc) * k_scale[o], then + bias[o],
//     each rounded once (__int2float_rn, __fmul_rn, __fadd_rn: nvcc would
//     otherwise contract the two into an FMA and lose bit-equality with the
//     plain version), or the raw int32 sums; staged through the ring as
//     [channel][pixel] and written NCHW with 16-byte stores along the
//     pixels (a tile of flat pixels is contiguous in each channel when
//     Ho*Wo is a multiple of the store's elements; else element by element),
//     bf16 rounded once at the store (__float2bfloat16_rn). Several blocks
//     are resident an SM (the registers allow 2-4), so one block's stores
//     overlap the others' copies.
//   - Determinism: integer sums are exact in any order; each output is
//     written once, with no atomics; reruns are bit-identical. |acc| <=
//     127^2 * 9 * 512 < 2^31: no overflow.
//
// Plain C interface, bound with ctypes: pointers and the stream come in as
// void*, and each entry returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kK = 32;           // channels a chunk of K (one wgmma k32)
constexpr int kConvThreads = 256;  // conv: two warpgroups
constexpr int kBM = 128;           // output pixels a block, 64 a warpgroup
constexpr int kEpiPad = 4;         // staged epilogue row: kBM + 4 words
constexpr int kWThreads = 256;     // weight fold

constexpr int kAbsThreads = 256;
constexpr int kAbsItems = 16;  // elements a thread of the absmax
constexpr int kQPix = 32;      // quantize: pixels a block
constexpr int kQThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// ---- channel absmax --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAbsThreads)
channel_absmax_kernel(const T* __restrict__ x, float* __restrict__ amax, int c, long long hw) {
  const int ch = blockIdx.y, img = blockIdx.z;
  const T* src = x + ((long long)img * c + ch) * hw;
  const long long start = (long long)blockIdx.x * kAbsThreads * kAbsItems + threadIdx.x;
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kAbsItems; ++i) {
    const long long j = start + (long long)i * kAbsThreads;
    if (j < hw) m = fmaxf(m, fabsf(load_f32(src + j)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[kAbsThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kAbsThreads / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(reinterpret_cast<int*>(amax + ch), __float_as_int(m));
  }
}

// ---- quantize to s8, NCHW -> NHWC padded ------------------------------------

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_s8_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   int8_t* __restrict__ q, int c, int cp, long long hw) {
  __shared__ int8_t tile[kK][kQPix + 4];  // [channel][pixel]
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kQPix;
  const int c0 = blockIdx.y * kK;
  const int img = blockIdx.z;
  // read: lane = pixel, 8 channels a pass
  {
    const int px = tid & 31;
    const long long p = p0 + px;
#pragma unroll
    for (int k = 0; k < kK / (kQThreads / 32); ++k) {
      const int ci = (tid >> 5) + k * (kQThreads / 32);
      const int ch = c0 + ci;
      int v = 0;
      if (ch < c && p < hw) {
        const float f = load_f32(x + ((long long)img * c + ch) * hw + p);
        const float r = rintf(__fdiv_rn(f, scale[ch]));
        v = (int)fminf(fmaxf(r, -127.f), 127.f);
      }
      tile[ci][px] = (int8_t)v;
    }
  }
  __syncthreads();
  // write: one 4-byte word (channels 4j..4j+3) of one pixel a thread
  {
    const int px = tid >> 3, j = tid & 7;
    const long long p = p0 + px;
    if (p < hw) {
      const uint32_t word = (uint32_t)(uint8_t)tile[4 * j][px] |
                            (uint32_t)(uint8_t)tile[4 * j + 1][px] << 8 |
                            (uint32_t)(uint8_t)tile[4 * j + 2][px] << 16 |
                            (uint32_t)(uint8_t)tile[4 * j + 3][px] << 24;
      *reinterpret_cast<uint32_t*>(q + ((long long)img * hw + p) * cp + c0 + 4 * j) = word;
    }
  }
}

// ---- the weight fold ------------------------------------------------------------

__device__ __forceinline__ float sym_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
}

// w (cout, cin, taps) f32, amax (cin,) f32 -> codes (taps, cout, cp) s8,
// k_scale (cout,), x_scale (cin,) (written by block 0). One block a channel.
__global__ void __launch_bounds__(kWThreads)
conv_s8_weights_kernel(const float* __restrict__ w, const float* __restrict__ amax,
                       int8_t* __restrict__ codes, float* __restrict__ k_scale,
                       float* __restrict__ x_scale, int cout, int cin, int cp, int taps) {
  const int o = blockIdx.x;
  const float* wo = w + (long long)o * cin * taps;
  const int n = cin * taps;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += kWThreads) {
    const int c = i / taps;
    m = fmaxf(m, fabsf(__fmul_rn(wo[i], sym_scale(amax[c]))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[kWThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int i = 1; i < kWThreads / 32; ++i) m = fmaxf(m, part[i]);
  const float ks = sym_scale(m);
  if (threadIdx.x == 0) k_scale[o] = ks;
  if (o == 0)
    for (int c = threadIdx.x; c < cin; c += kWThreads) x_scale[c] = sym_scale(amax[c]);
  for (int i = threadIdx.x; i < taps * cp; i += kWThreads) {
    const int tap = i / cp, c = i - tap * cp;
    int v = 0;
    if (c < cin) {
      const float r = rintf(__fdiv_rn(__fmul_rn(wo[c * taps + tap], sym_scale(amax[c])), ks));
      v = (int)fminf(fmaxf(r, -127.f), 127.f);
    }
    codes[((long long)tap * cout + o) * cp + c] = (int8_t)v;
  }
}

// ---- the implicit GEMM --------------------------------------------------------

struct ConvShape {
  int n, h, w, cp;           // input (NHWC, channels padded to cp)
  int ho, wo, cout;          // output
  int kh, kw, dh, dw, ph, pw;
};

template <int BN, int KC, int STAGES>
struct Tile {
  static constexpr int KB = kK * KC;  // bytes of K a stage row
  static constexpr int A_BYTES = kBM * KB;
  static constexpr int B_BYTES = BN * KB;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_BYTES = BN * (kBM + kEpiPad) * 4;
  // + 1024: the ring starts at the next 1024-byte boundary (the 128-byte
  // swizzle's atom) of the dynamic shared memory
  static constexpr int SMEM = (PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES) + 1024;
  static_assert(KC == 1 || KC == 2 || KC == 4, "a stage row is 32, 64 or 128 bytes");
  static_assert(STAGES >= 3, "one stage multiplied, one in flight, one being filled");
  static_assert(SMEM <= 232448, "the shared memory a block can have");
  static_assert(BN == 32 || BN == 64 || BN == 128, "wgmma n32, n64 or n128");
};

// the byte offset of byte `off` of a K-major tile with rows of KB bytes,
// under the KB-byte swizzle (16-byte piece bits [4, 7) XOR row bits [7, 10))
template <int KB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (KB / 16 - 1)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid, bool l1) {
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  if (l1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K-major shared-memory matrix descriptor: start >> 4, leading offset 1
// (unused by the swizzled layouts), stride offset between 8-row groups,
// base offset 0 (tiles sit on their swizzle atom), the swizzle mode.
template <int KB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t swz = KB == 128 ? 1 : KB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * KB) >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major) . B (N x 32, K-major)^T; accumulator layout
// (PTX ISA, wgmma D fragments): warp w of the warpgroup, lane = 4g + t,
// d[i] = D[16w + g + 8((i >> 1) & 1)][8(i >> 2) + 2t + (i & 1)].
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One stage of the ring: chunks q0 .. q0 + KC - 1 of A (this thread's pixel
// row, half h) and of B.
template <int BN, int KC>
__device__ __forceinline__ void load_stage(uint32_t a_s, uint32_t b_s, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq, const ConvShape& s,
                                           int q0, int q_total, int cpc, int co0, int row,
                                           int half, bool m_ok, int oh, int ow,
                                           long long xbase) {
  constexpr int KB = kK * KC;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int q = q0 + j;
    bool valid = m_ok && q < q_total;
    const int8_t* src = xq;
    if (valid) {
      const int tap = q / cpc, c32 = q - tap * cpc;
      const int ky = tap / s.kw, kx = tap - ky * s.kw;
      const int ih = oh - s.ph + ky * s.dh, iw = ow - s.pw + kx * s.dw;
      valid = ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
      src = xq + (xbase + (long long)ih * s.w + iw) * s.cp + c32 * kK + 16 * half;
    }
    cp_async16(a_s + swizzle<KB>(row * KB + (2 * j + half) * 16), valid ? src : xq, valid, true);
  }
#pragma unroll
  for (int u = threadIdx.x; u < BN * 2 * KC; u += kConvThreads) {
    const int j = u / (2 * BN), r = u - j * 2 * BN;
    const int n = r >> 1, h = r & 1;
    const int q = q0 + j;
    const bool valid = q < q_total && co0 + n < s.cout;
    const int8_t* src = wq;
    if (valid) {
      const int tap = q / cpc, c32 = q - tap * cpc;
      src = wq + ((long long)tap * s.cout + co0 + n) * s.cp + c32 * kK + 16 * h;
    }
    cp_async16(b_s + swizzle<KB>(n * KB + (2 * j + h) * 16), src, valid, false);
  }
}

// The epilogue of both GEMM kernels, once the last wgmma batch is done:
// dequantize warpgroup wg's accumulators, stage the tile [channel][pixel]
// in the (then free) ring, and store it NCHW.
template <int BN, typename OutT>
__device__ __forceinline__ void store_tile(int (&acc)[BN / 2], uint8_t* smem,
                                           const float* __restrict__ k_scale,
                                           const float* __restrict__ bias, OutT* __restrict__ y,
                                           const ConvShape& s, long long m0, int co0,
                                           long long m_total, long long hwo) {
  const int tid = threadIdx.x, wg = tid >> 7;
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the tile through it

  // dequantize and stage [channel][pixel]
  constexpr int kLd = kBM + kEpiPad;
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  {
    const int lane = tid & 31, w = (tid >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      const int rr = 64 * wg + 16 * w + g + 8 * ((i >> 1) & 1);
      const int co = co0 + col;
      uint32_t v = 0;
      if constexpr (std::is_same_v<OutT, int>) {
        v = (uint32_t)acc[i];
      } else if (co < s.cout) {
        float f = __fmul_rn(__int2float_rn(acc[i]), k_scale[co]);
        if (bias != nullptr) f = __fadd_rn(f, bias[co]);
        v = __float_as_uint(f);
      }
      stage[col * kLd + rr] = v;
    }
  }
  __syncthreads();

  // store: groups of G pixels of one channel, 16 bytes when aligned
  constexpr int G = 16 / sizeof(OutT);
  constexpr int kGroups = kBM / G;
  const bool vec = hwo % G == 0;
#pragma unroll
  for (int u = tid; u < BN * kGroups; u += kConvThreads) {
    const int col = u / kGroups, gi = u - col * kGroups;
    const int co = co0 + col;
    if (co >= s.cout) continue;
    const long long mg = m0 + gi * G;
    const uint32_t* src = stage + col * kLd + gi * G;
    if (vec) {
      if (mg >= m_total) continue;
      const long long img = mg / hwo;
      OutT* dst = y + (img * s.cout + co) * hwo + (mg - img * hwo);
      if constexpr (std::is_same_v<OutT, __nv_bfloat16>) {
        const uint4 lo = *reinterpret_cast<const uint4*>(src);
        const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
        const uint32_t f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 a = __float2bfloat16_rn(__uint_as_float(f[2 * e]));
          const __nv_bfloat16 b = __float2bfloat16_rn(__uint_as_float(f[2 * e + 1]));
          packed[e] = (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      }
    } else {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const long long me = mg + e;
        if (me >= m_total) break;
        const long long img = me / hwo;
        OutT* dst = y + (img * s.cout + co) * hwo + (me - img * hwo);
        if constexpr (std::is_same_v<OutT, int>)
          *dst = (int)src[e];
        else
          *dst = from_f32<OutT>(__uint_as_float(src[e]));
      }
    }
  }
}

// OutT float / bf16: the dequantized output; int: the raw sums (k_scale and
// bias unused).
template <int BN, int KC, int STAGES, int PREFETCH, int MINB, typename OutT>
__global__ void __launch_bounds__(kConvThreads, MINB)
conv_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ k_scale, const float* __restrict__ bias,
               OutT* __restrict__ y, ConvShape s) {
  using T = Tile<BN, KC, STAGES>;
  constexpr int kInFlight = STAGES - 1 - PREFETCH;  // wgmma batches left running
  static_assert(kInFlight == 0 || kInFlight == 1, "PREFETCH is STAGES - 1 or - 2");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const long long hwo = (long long)s.ho * s.wo;
  const long long m_total = (long long)s.n * hwo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * BN;
  const int cpc = s.cp / kK;
  const int q_total = s.kh * s.kw * cpc;
  const int iters = (q_total + KC - 1) / KC;

  // this thread's gather row: pixel m0 + row, 16-byte half `half` of a chunk
  const int row = tid >> 1, half = tid & 1;
  const long long m = m0 + row;
  const bool m_ok = m < m_total;
  int oh = 0, ow = 0;
  long long xbase = 0;
  if (m_ok) {
    const long long img = m / hwo;
    const int r = (int)(m - img * hwo);
    oh = r / s.wo;
    ow = r - oh * s.wo;
    xbase = img * s.h * s.w;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int wg = tid >> 7;
#pragma unroll
  for (int st = 0; st < PREFETCH; ++st) {
    if (st < iters)
      load_stage<BN, KC>(base + st * T::STAGE_BYTES, base + st * T::STAGE_BYTES + T::A_BYTES, xq,
                         wq, s, st * KC, q_total, cpc, co0, row, half, m_ok, oh, ow, xbase);
    cp_async_commit();
  }
  for (int kb = 0; kb < iters; ++kb) {
    cp_async_wait<PREFETCH - 1>();  // this thread's copies of stage kb have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's; and the batch that read the slot refilled now is done
    {
      const int nk = kb + PREFETCH;
      if (nk < iters) {
        const uint32_t st = base + (nk % STAGES) * T::STAGE_BYTES;
        load_stage<BN, KC>(st, st + T::A_BYTES, xq, wq, s, nk * KC, q_total, cpc, co0, row, half,
                           m_ok, oh, ow, xbase);
      }
      cp_async_commit();
    }
    const uint32_t a_s = base + (kb % STAGES) * T::STAGE_BYTES + wg * 64 * T::KB;
    const uint32_t b_s = base + (kb % STAGES) * T::STAGE_BYTES + T::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC; ++j)
      wgmma_s8(acc, smem_desc<T::KB>(a_s + 32 * j), smem_desc<T::KB>(b_s + 32 * j));
    wgmma_commit();
    wgmma_wait<kInFlight>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_tile<BN, OutT>(acc, smem, k_scale, bias, y, s, m0, co0, m_total, hwo);
}

// ---- the row-segment GEMM ------------------------------------------------

constexpr int kRowM = 64;  // output pixels a warpgroup: one run of one output row

// K-major shared-memory matrix descriptor without swizzle: rows at a 16-byte
// pitch (8-row groups 128 bytes apart), the two 16-byte halves of a k32
// slice `lbo` bytes apart; any 16-byte aligned start, so a tap's shift along
// the row is a start `shift * 16` bytes further.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

constexpr int kRowKW = 3;  // the row kernel's kernel width

// Output rows of width Wo % 64 == 0 and a kernel 3 wide: each warpgroup's
// 64 pixels are one run of one output row, so the 3 taps of a kernel row
// ky read one segment of seg = 64 + 2 * dw input pixels, shifted by kx * dw.
// A step of the K loop is (KYS kernel rows, 32 channels): for each row,
// both warpgroups' segments (2 x seg rows x 32 bytes) and the 3 taps'
// weights (3 x BN rows x 32 bytes), each 16 bytes one cp.async,
// zero-filled past the image; then 3 KYS wgmma a warpgroup, A at the
// tap's shift. Each input byte crosses into shared memory kh times, not
// 3 * kh.
template <int BN, int KYS, int STAGES, int PREFETCH, int MINB, typename OutT>
__global__ void __launch_bounds__(kConvThreads, MINB)
conv_s8_kernel_rows(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                    const float* __restrict__ k_scale, const float* __restrict__ bias,
                    OutT* __restrict__ y, ConvShape s) {
  constexpr int kInFlight = STAGES - 1 - PREFETCH;  // wgmma batches left running
  static_assert(kInFlight == 0 || kInFlight == 1, "PREFETCH is STAGES - 1 or - 2");
  constexpr int kAPieces = 2;  // A copies a thread a step: 4 * seg <= 512 (dw <= 32)
  constexpr int kBPieces = (kRowKW * 2 * BN + kConvThreads - 1) / kConvThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long hwo = (long long)s.ho * s.wo;
  const long long m_total = (long long)s.n * hwo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int co0 = blockIdx.y * BN;
  const int cpc = s.cp / kK;
  const int steps = s.kh / KYS * cpc;
  const int seg = kRowM + (kRowKW - 1) * s.dw;
  const int row_a = 2 * seg * kK;  // a kernel row's two segments
  const int a_bytes = KYS * row_a;
  const int stage_bytes = a_bytes + KYS * kRowKW * BN * kK;
  const long long row_bytes = (long long)s.w * s.cp;

  // This thread's A copies, the same every step: piece u = (segment g, row
  // r, half h) of the two warpgroups' segments; what changes with the step
  // is the input row ih and the 32 channels. Pixels past M, columns past
  // the image: never valid (zero-filled).
  int a_dst[kAPieces], a_oh[kAPieces];
  long long a_src[kAPieces];
  bool a_ok[kAPieces];
#pragma unroll
  for (int p = 0; p < kAPieces; ++p) {
    const int u = tid + p * kConvThreads;
    const int g = u >= 2 * seg, rem = u - g * 2 * seg;
    const int r = rem >> 1, h = rem & 1;
    const long long mg = m0 + kRowM * g;
    const bool live = u < 4 * seg && mg < m_total;
    const long long img = live ? mg / hwo : 0;
    const int rr = (int)(mg - img * hwo);
    const int oh = live ? rr / s.wo : 0;
    const int iw = (live ? rr - oh * s.wo : 0) - s.pw + r;
    a_ok[p] = live && iw >= 0 && iw < s.w;
    a_oh[p] = oh - s.ph;
    a_src[p] = (img * s.h * s.w + iw) * s.cp + 16 * h;
    a_dst[p] = u < 4 * seg ? g * seg * kK + h * seg * 16 + r * 16 : -1;
  }
  // and its B copies: piece u = (tap kx, channel n, half h)
  int b_dst[kBPieces];
  long long b_src[kBPieces];
  bool b_ok[kBPieces];
#pragma unroll
  for (int p = 0; p < kBPieces; ++p) {
    const int u = tid + p * kConvThreads;
    const int kx = u / (2 * BN), rem = u - kx * 2 * BN;
    const int n = rem >> 1, h = rem & 1;
    b_ok[p] = co0 + n < s.cout;
    b_src[p] = ((long long)kx * s.cout + co0 + n) * s.cp + 16 * h;
    b_dst[p] = u < kRowKW * 2 * BN ? a_bytes + kx * BN * kK + h * BN * 16 + n * 16 : -1;
  }

  auto load = [&](uint32_t st, int step) {
    const int ky0 = step / cpc * KYS, c32 = step % cpc;
#pragma unroll
    for (int kyl = 0; kyl < KYS; ++kyl) {
      const int ky = ky0 + kyl;
#pragma unroll
      for (int p = 0; p < kAPieces; ++p) {
        if (a_dst[p] < 0) continue;
        const int ih = a_oh[p] + ky * s.dh;
        const bool valid = a_ok[p] && ih >= 0 && ih < s.h;
        const int8_t* src = valid ? xq + a_src[p] + ih * row_bytes + c32 * kK : xq;
        cp_async16(st + kyl * row_a + a_dst[p], src, valid, true);
      }
      const long long b_step = (long long)ky * kRowKW * s.cout * s.cp + c32 * kK;
#pragma unroll
      for (int p = 0; p < kBPieces; ++p) {
        if (b_dst[p] < 0) continue;
        cp_async16(st + kyl * kRowKW * BN * kK + b_dst[p], b_ok[p] ? wq + b_src[p] + b_step : wq,
                   b_ok[p], false);
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int st = 0; st < PREFETCH; ++st) {
    if (st < steps) load(base + st * stage_bytes, st);
    cp_async_commit();
  }
  for (int kb = 0; kb < steps; ++kb) {
    cp_async_wait<PREFETCH - 1>();  // this thread's copies of step kb have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's; and the batch that read the slot refilled now is done
    {
      const int nk = kb + PREFETCH;
      if (nk < steps) load(base + (nk % STAGES) * stage_bytes, nk);
      cp_async_commit();
    }
    const uint32_t st = base + (kb % STAGES) * stage_bytes;
    const uint32_t a_s = st + wg * seg * kK;
    const uint32_t b_s = st + a_bytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kyl = 0; kyl < KYS; ++kyl)
#pragma unroll
      for (int kx = 0; kx < kRowKW; ++kx)
        wgmma_s8(acc, plain_desc(a_s + kyl * row_a + kx * s.dw * 16, seg * 16),
                 plain_desc(b_s + (kyl * kRowKW + kx) * BN * kK, BN * 16));
    wgmma_commit();
    wgmma_wait<kInFlight>();
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_tile<BN, OutT>(acc, smem, k_scale, bias, y, s, m0, co0, m_total, hwo);
}

// Dynamic shared memory of a row-kernel launch: the ring (no more slots
// than steps) or the staged epilogue, whichever is larger, and the
// 128-byte alignment.
template <int BN, int KYS, int STAGES>
int row_smem(const ConvShape& s) {
  const int seg = kRowM + (kRowKW - 1) * s.dw;
  const int steps = s.kh / KYS * (s.cp / kK);
  const int pipe = (steps < STAGES ? steps : STAGES) * KYS * (2 * seg * kK + kRowKW * BN * kK);
  const int epi = BN * (kBM + kEpiPad) * 4;
  return (pipe > epi ? pipe : epi) + 128;
}

template <int BN, int KYS, int STAGES, int PREFETCH, int MINB, typename OutT>
int launch_row(const int8_t* xq, const int8_t* wq, const float* ks, const float* b, void* y,
               const ConvShape& s, cudaStream_t st) {
  if (s.wo % kRowM != 0 || s.kw != kRowKW || s.kh % KYS != 0 ||
      4 * (kRowM + (kRowKW - 1) * s.dw) > 2 * kConvThreads)
    return (int)cudaErrorInvalidValue;
  const int smem = row_smem<BN, KYS, STAGES>(s);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = conv_s8_kernel_rows<BN, KYS, STAGES, PREFETCH, MINB, OutT>;
  const cudaError_t err =  // past 48 KB only when asked for, on the current device
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)s.n * s.ho * s.wo;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (s.cout + BN - 1) / BN);
  kernel<<<grid, kConvThreads, smem, st>>>(xq, wq, ks, b, static_cast<OutT*>(y), s);
  return (int)cudaGetLastError();
}

template <int BN, int KC, int STAGES, int PREFETCH, int MINB, typename OutT>
int launch_conv(const int8_t* xq, const int8_t* wq, const float* ks, const float* b, void* y,
                const ConvShape& s, cudaStream_t st) {
  using T = Tile<BN, KC, STAGES>;
  auto kernel = conv_s8_kernel<BN, KC, STAGES, PREFETCH, MINB, OutT>;
  const cudaError_t err =  // past 48 KB only when asked for, on the current device
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)s.n * s.ho * s.wo;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (s.cout + BN - 1) / BN);
  kernel<<<grid, kConvThreads, T::SMEM, st>>>(xq, wq, ks, b, static_cast<OutT*>(y), s);
  return (int)cudaGetLastError();
}

// The instances: (kernel, BN, KC, STAGES, PREFETCH) as ops/quantized_conv.py::
// conv_s8_instance names them (kernel 0: conv_s8_kernel, KC chunks a stage;
// 1: conv_s8_kernel_rows, KC its KYS kernel rows a step; PREFETCH stages
// loaded ahead of the one multiplied: STAGES - 2 leaves one wgmma batch
// running, STAGES - 1 none), and the blocks an SM each is compiled for.
#define CONV_S8_INSTANCES(X) \
  X(0, 32, 2, 4, 2, 2)       \
  X(0, 64, 2, 4, 2, 2)       \
  X(0, 128, 2, 4, 2, 2)      \
  X(1, 32, 3, 2, 1, 2)       \
  X(1, 64, 3, 2, 1, 2)       \
  X(1, 128, 3, 2, 1, 2)

template <typename OutT>
int launch_instance(int kernel, int bn, int kc, int stages, int prefetch, const int8_t* xq,
                    const int8_t* wq, const float* ks, const float* b, void* y,
                    const ConvShape& s, cudaStream_t st) {
#define CONV_S8_DISPATCH(KERNEL, BN, KC, STAGES, PREFETCH, MINB)                          \
  if (kernel == KERNEL && bn == BN && kc == KC && stages == STAGES && prefetch == PREFETCH) { \
    if constexpr (KERNEL == 0)                                                             \
      return launch_conv<BN, KC, STAGES, PREFETCH, MINB, OutT>(xq, wq, ks, b, y, s, st);   \
    else                                                                                   \
      return launch_row<BN, KC, STAGES, PREFETCH, MINB, OutT>(xq, wq, ks, b, y, s, st);    \
  }
  CONV_S8_INSTANCES(CONV_S8_DISPATCH)
#undef CONV_S8_DISPATCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype of x: 0 = float32, 1 = bfloat16. x NCHW contiguous; amax (c,) f32,
// zeroed by the caller.
int conv_s8_absmax_launch(const void* x, void* amax, int dtype, int n, int c, long long hw,
                          void* stream) {
  const long long per_block = (long long)kAbsThreads * kAbsItems;
  const dim3 grid((unsigned)((hw + per_block - 1) / per_block), c, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    channel_absmax_kernel<float><<<grid, kAbsThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(amax), c, hw);
  } else if (dtype == 1) {
    channel_absmax_kernel<__nv_bfloat16><<<grid, kAbsThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(amax), c, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// w (cout, cin, kh, kw) f32 contiguous, amax (cin,) f32 -> codes (taps,
// cout, cp) s8 (cp a multiple of 32, zero past cin), k_scale (cout,) f32,
// x_scale (cin,) f32.
int conv_s8_weights_launch(const void* w, const void* amax, void* codes, void* k_scale,
                           void* x_scale, int cout, int cin, int cp, int taps, void* stream) {
  if (cp % kK != 0 || cp < cin || cout < 1) return (int)cudaErrorInvalidValue;
  conv_s8_weights_kernel<<<cout, kWThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(amax), static_cast<int8_t*>(codes),
      static_cast<float*>(k_scale), static_cast<float*>(x_scale), cout, cin, cp, taps);
  return (int)cudaGetLastError();
}

// x NCHW contiguous (dtype as above), scale (c,) f32 -> q (n, hw, cp) s8,
// cp a multiple of 32, channels c..cp-1 written as 0.
int conv_s8_quantize_launch(const void* x, const void* scale, void* q, int dtype, int n, int c,
                            int cp, long long hw, void* stream) {
  if (cp % kK != 0 || cp < c) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((hw + kQPix - 1) / kQPix), cp / kK, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quantize_s8_kernel<float><<<grid, kQThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<int8_t*>(q), c, cp, hw);
  } else if (dtype == 1) {
    quantize_s8_kernel<__nv_bfloat16><<<grid, kQThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<int8_t*>(q), c, cp, hw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// xq (n, h, w, cp) s8, wq (kh*kw, cout, cp) s8, k_scale (cout,) f32, bias
// (cout,) f32 or null -> y (n, cout, ho, wo), out_dtype 0 = float32,
// 1 = bfloat16, 2 = int32 (the raw sums); (kernel, bn, kc, stages, prefetch)
// one of CONV_S8_INSTANCES.
int conv_s8_launch(const void* xq, const void* wq, const void* k_scale, const void* bias,
                   void* y, int out_dtype, int n, int h, int w, int cp, int cout, int ho,
                   int wo, int kh, int kw, int dh, int dw, int ph, int pw, int kernel, int bn,
                   int kc, int stages, int prefetch, void* stream) {
  if (cp % kK != 0) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, w, cp, ho, wo, cout, kh, kw, dh, dw, ph, pw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* ks = static_cast<const float*>(k_scale);
  const float* b = static_cast<const float*>(bias);
  if (out_dtype == 0)
    return launch_instance<float>(kernel, bn, kc, stages, prefetch, x8, w8, ks, b, y, s, st);
  if (out_dtype == 1)
    return launch_instance<__nv_bfloat16>(kernel, bn, kc, stages, prefetch, x8, w8, ks, b, y,
                                          s, st);
  if (out_dtype == 2)
    return launch_instance<int>(kernel, bn, kc, stages, prefetch, x8, w8, ks, b, y, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
