// int8 convolution for Hopper (sm_90a): s8 activations x s8 weights summed
// in int32 on the tensor cores, with a fused dequantizing epilogue, and the
// two activation passes of dynamic quantization that feed it.
//
// Replaces no Pallas kernel: the JAX package computes this convolution with
// XLA, lax.conv_general_dilated on int8 operands with
// preferred_element_type=int32 (medical_image_editing_tpu/ops/
// quantized_conv.py:104-108), and its activation passes (_quantize_sym,
// :56-61) with XLA reductions and elementwise ops. PyTorch has no int8
// convolution on CUDA (F.conv2d refuses torch.int8), so the port writes all
// three by hand.
//
// * channel_absmax_kernel: amax over (N, H, W) of |x[:, c]| for an NCHW f32
//   or bf16 activation, into a zeroed (C,) f32 vector. Block partial maxima
//   meet through atomicMax on the float's bits (non-negative floats order as
//   their bit patterns), so the result does not depend on the order: it is
//   exactly the plain version's.
// * quantize_s8_kernel: q = clamp(rint(x / scale[c]), -127, 127) as s8, with
//   IEEE division (__fdiv_rn) and round half to even (rintf; roundf would
//   round half away from zero), written channels-innermost (NHWC) with the
//   channels padded by zeros to a multiple of 32, so that one K-step of the
//   GEMM below reads 32 contiguous bytes of one pixel. A block transposes a
//   tile of 32 pixels x 32 channels through shared memory: reads along the
//   pixels of one channel, writes 4-byte words along the channels.
// * conv_s8_kernel: an implicit GEMM. M = output pixels (N*Ho*Wo, flat, so
//   any batch and size; the grid's x dimension walks it, past 65535 rows of
//   blocks), N = Cout, K = (tap, Cin padded to 32), issued as
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 from inline PTX. Stride
//   1, any kernel size, dilation and symmetric padding per axis: the 3x3
//   SAME, 1x1 and the ASPP's dilated convolutions (rates 2, 6, 12, 18 with
//   padding equal to the rate) of the decoder. A block of 4 warps owns 128
//   pixels x 32 output channels; a warp 32 pixels (two m16 tiles) x 32
//   channels (four n8 tiles), 32 int32 sums a thread. Each lane reads its A
//   and B fragments straight from device memory (L1/L2 serve the 9-fold
//   reuse of the taps): a tap outside the image, a pixel past M and a
//   channel past Cout read as 0, and n8 tiles wholly past Cout are skipped
//   (Cout = 1 runs one of four). Weights come as s8 [tap][Cout][Cin_padded].
//   Epilogue: out = f32(acc) * k_scale[o], then + bias[o], each rounded
//   once (__int2float_rn, __fmul_rn, __fadd_rn: nvcc would otherwise
//   contract the two into an FMA and lose bit-equality with the plain
//   version), then stored NCHW in f32 or bf16 (__float2bfloat16_rn); or, as
//   a check, the raw int32 sums. |acc| <= 127^2 * 9 * 512 < 2^31: no
//   overflow; integer sums are exact in any order.
// * What bounds it. At the decoder's widest full-resolution convolution
//   (32 -> 32, 3x3, 512^2, batch 8) a call reads 67 MB of s8 and writes
//   268 MB of f32: 0.100 ms at 3.35 TB/s, against 0.0195 ms for its 38.7 G
//   integer operations at 1979 TOP/s (dense int8). So the bytes bound it,
//   mostly the f32 output. The design spends no effort on the tensor-core
//   rate: no shared-memory staging of the halo, no cp.async / TMA, no
//   wgmma, and the fragments of a tap are re-read for every tap and every
//   block of 32 output channels. Staged halos, wgmma and fusing the absmax
//   into the previous layer's epilogue are later work.
// * Determinism. Each output is summed by one lane in a fixed order, with no
//   atomics; reruns are bit-identical.
//
// Plain C interface, bound with ctypes: pointers and the stream come in as
// void*, and each entry returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // conv: 4 warps
constexpr int kBlockM = 128;   // output pixels a block
constexpr int kBlockN = 32;    // output channels a block
constexpr int kMTiles = 2;     // m16 tiles a warp
constexpr int kNTiles = 4;     // n8 tiles a warp
constexpr int kK = 32;         // channels a K-step (one m16n8k32)
static_assert(kBlockM == 4 * 16 * kMTiles && kBlockN == 8 * kNTiles, "warp layout");

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

// ---- the implicit GEMM --------------------------------------------------------

// d += a . b for one m16n8k32 s8 tile. Fragment layout (PTX ISA, "Matrix
// Fragments for mma.m16n8k32" with .s8), lane = 4g + t, bytes of a register
// in increasing k from the low byte:
//   a[0] = A[g][4t..4t+3]       a[1] = A[g+8][4t..4t+3]
//   a[2] = A[g][16+4t..16+4t+3] a[3] = A[g+8][16+4t..16+4t+3]
//   b[0] = B[4t..4t+3][g]       b[1] = B[16+4t..16+4t+3][g]
//   d[0], d[1] = C[g][2t, 2t+1]     d[2], d[3] = C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

struct ConvShape {
  int n, h, w, cp;           // input (NHWC, channels padded to cp)
  int ho, wo, cout;          // output
  int kh, kw, dh, dw, ph, pw;
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// OutT float / bf16: the dequantized output; int: the raw sums (k_scale and
// bias unused).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ k_scale, const float* __restrict__ bias,
               OutT* __restrict__ y, ConvShape s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long hwo = (long long)s.ho * s.wo;
  const long long m_total = (long long)s.n * hwo;
  const long long m_warp = (long long)blockIdx.x * kBlockM + warp * (16 * kMTiles);
  const int co0 = blockIdx.y * kBlockN;

  // the four pixels of this lane's A rows: tile mt, half (rows g, g + 8)
  int oh[kMTiles][2], ow[kMTiles][2];
  long long xbase[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = m_warp + 16 * mt + 8 * hf + g;
      if (m < m_total) {
        const long long img = m / hwo;
        const int r = (int)(m - img * hwo);
        oh[mt][hf] = r / s.wo;
        ow[mt][hf] = r - oh[mt][hf] * s.wo;
        xbase[mt][hf] = img * s.h * s.w * s.cp;
      } else {  // past M: every tap reads outside the image
        oh[mt][hf] = -(1 << 29);
        ow[mt][hf] = 0;
        xbase[mt][hf] = 0;
      }
    }
  // n8 tiles that hold at least one channel < cout (warp-uniform)
  int n_live = 0;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) n_live += co0 + 8 * nt < s.cout;
  const int co_b = co0 + g;  // this lane's B column in n8 tile 0

  int acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  const int taps = s.kh * s.kw;
  const int ksteps = s.cp / kK;
  for (int tap = 0; tap < taps; ++tap) {
    const int ky = tap / s.kw, kx = tap - ky * s.kw;
    const int8_t* xp[kMTiles][2];
    bool in[kMTiles][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ih = oh[mt][hf] - s.ph + ky * s.dh, iw = ow[mt][hf] - s.pw + kx * s.dw;
        in[mt][hf] = ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
        xp[mt][hf] = xq + xbase[mt][hf] + ((long long)(in[mt][hf] ? ih : 0) * s.w +
                                           (in[mt][hf] ? iw : 0)) * s.cp + 4 * t;
      }
    const int8_t* wp = wq + ((long long)tap * s.cout + co_b) * s.cp + 4 * t;
    for (int kc = 0; kc < ksteps; ++kc) {
      const int k0 = kc * kK;
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        a[mt][0] = in[mt][0] ? ld32(xp[mt][0] + k0) : 0u;
        a[mt][1] = in[mt][1] ? ld32(xp[mt][1] + k0) : 0u;
        a[mt][2] = in[mt][0] ? ld32(xp[mt][0] + k0 + 16) : 0u;
        a[mt][3] = in[mt][1] ? ld32(xp[mt][1] + k0 + 16) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        if (nt >= n_live) break;
        const bool live = co_b + 8 * nt < s.cout;
        const int8_t* bp = wp + (long long)8 * nt * s.cp + k0;
        const uint32_t b0 = live ? ld32(bp) : 0u, b1 = live ? ld32(bp + 16) : 0u;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // epilogue: d[j] is pixel row g + 8 (j >> 1), channel 2t + (j & 1)
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = m_warp + 16 * mt + 8 * hf + g;
      if (m >= m_total) continue;
      const long long img = m / hwo;
      const long long r = m - img * hwo;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + 8 * nt + 2 * t + e;
          if (co >= s.cout) continue;
          const int v = acc[mt][nt][2 * hf + e];
          OutT* dst = y + (img * s.cout + co) * hwo + r;
          if constexpr (std::is_same_v<OutT, int>) {
            *dst = v;
          } else {
            float f = __fmul_rn(__int2float_rn(v), k_scale[co]);
            if (bias != nullptr) f = __fadd_rn(f, bias[co]);
            *dst = from_f32<OutT>(f);
          }
        }
    }
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
// 1 = bfloat16, 2 = int32 (the raw sums).
int conv_s8_launch(const void* xq, const void* wq, const void* k_scale, const void* bias,
                   void* y, int out_dtype, int n, int h, int w, int cp, int cout, int ho,
                   int wo, int kh, int kw, int dh, int dw, int ph, int pw, void* stream) {
  if (cp % kK != 0) return (int)cudaErrorInvalidValue;
  const ConvShape s{n, h, w, cp, ho, wo, cout, kh, kw, dh, dw, ph, pw};
  const long long m = (long long)n * ho * wo;
  const dim3 grid((unsigned)((m + kBlockM - 1) / kBlockM), (cout + kBlockN - 1) / kBlockN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* ks = static_cast<const float*>(k_scale);
  const float* b = static_cast<const float*>(bias);
  if (out_dtype == 0) {
    conv_s8_kernel<float><<<grid, kThreads, 0, st>>>(x8, w8, ks, b, static_cast<float*>(y), s);
  } else if (out_dtype == 1) {
    conv_s8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        x8, w8, ks, b, static_cast<__nv_bfloat16*>(y), s);
  } else if (out_dtype == 2) {
    conv_s8_kernel<int><<<grid, kThreads, 0, st>>>(x8, w8, ks, b, static_cast<int*>(y), s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
