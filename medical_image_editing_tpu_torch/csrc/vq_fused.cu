// Fused VQ assignment for Hopper (sm_90a): per row of the flattened (N, C)
// f32 features, the nearest code of the (K, C) codebook, its codebook row,
// and the per-code counts (K,) and sums (K, C) that feed the EMA update.
//
// Replaces medical_image_editing_tpu/ops/vq_pallas.py::_vq_kernel, the
// Pallas TPU kernel. Same function; a different design:
//
// * What bounds it. Counting each input byte read once and each output byte
//   written once, the encode point of the editing service (N = 8*512*512,
//   C = 16, K = 10) moves ~277 MB for ~0.7 GFLOP of scoring, so at 3.35 TB/s
//   and 67 TFLOP/s (f32 outside the tensor cores) it is memory bound: ~83 us.
//   Wide codebooks (C = 512, K = 64; C = 64, K = 512) are compute bound.
//   The design reads the features once from device memory for the scores
//   (the per-code sums re-read the same rows while they are still in L1/L2)
//   and keeps the codebook and its norms in shared memory.
// * Precision. Scores 2*x.e - |e|^2 are true f32 FFMA on the CUDA cores, no
//   TF32 (TF32 flips ids near decision boundaries). Codes are scanned
//   upward with a strict '>', so ties go to the first index, as argmax does.
// * Grid accumulation. The TPU grid runs in order and carries counts/sums
//   across steps in its output blocks. Hopper blocks run in parallel in no
//   order, so each block writes its own partial counts and sums (summed over
//   its rows in row order) and a second small kernel reduces the partials in
//   a fixed order. No float atomics: two runs on one input are bit-identical.
// * Ragged N is masked here (the last block takes the remainder rows).
//
// Plain C interface, bound with ctypes: pointers and the stream come in as
// void*, and each entry returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, both kernels
constexpr int kTileK = 16;     // codes scored per register tile
constexpr int kLanes = kThreads / 32;  // block lanes per slot in the reduce

__global__ void __launch_bounds__(kThreads)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                 int n, int c, int k, int k_pad, int rows_per_block,
                 int32_t* __restrict__ ids, float* __restrict__ quant,
                 float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* e_s = smem;                                   // (k_pad, c), zero past k
  float* esq_s = e_s + (size_t)k_pad * c;              // (k_pad,)
  int* ids_s = reinterpret_cast<int*>(esq_s + k_pad);  // (rows_per_block,)

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long left = (long long)n - row0;
  const int rows = left < rows_per_block ? (int)left : rows_per_block;
  const float* xb = x + row0 * c;

  for (int i = tid; i < k_pad * c; i += kThreads) e_s[i] = i < k * c ? embed[i] : 0.f;
  __syncthreads();
  for (int j = tid; j < k_pad; j += kThreads) {
    float s = 0.f;
    for (int cc = 0; cc < c; ++cc) s = fmaf(e_s[j * c + cc], e_s[j * c + cc], s);
    esq_s[j] = s;
  }
  __syncthreads();

  // 1. assignment, one thread per row; the codebook reads are broadcasts
  for (int r = tid; r < rows; r += kThreads) {
    const float* xr = xb + (size_t)r * c;
    float best = -INFINITY;
    int best_k = 0;
    for (int k0 = 0; k0 < k; k0 += kTileK) {
      float acc[kTileK];
#pragma unroll
      for (int j = 0; j < kTileK; ++j) acc[j] = 0.f;
      const float* et = e_s + (size_t)k0 * c;
      for (int cc = 0; cc < c; ++cc) {
        const float xv = __ldg(xr + cc);
#pragma unroll
        for (int j = 0; j < kTileK; ++j) acc[j] = fmaf(xv, et[j * c + cc], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kTileK; ++j) {
        const float s = 2.f * acc[j] - esq_s[k0 + j];
        if (k0 + j < k && s > best) {
          best = s;
          best_k = k0 + j;
        }
      }
    }
    ids_s[r] = best_k;
    ids[row0 + r] = best_k;
  }
  __syncthreads();

  // 2. quantized rows: a coalesced copy of the chosen codebook rows
  float* qb = quant + row0 * c;
  for (int i = tid; i < rows * c; i += kThreads) {
    const int r = i / c;
    qb[i] = e_s[ids_s[r] * c + (i - r * c)];
  }

  // 3. this block's counts (slots [0, k)) and sums (slots [k, k + k*c)),
  //    each slot summed by one thread over the block's rows in row order
  const int slots = k + k * c;
  float* pb = partials + (size_t)blockIdx.x * slots;
  for (int s = tid; s < slots; s += kThreads) {
    float acc = 0.f;
    if (s < k) {
      for (int r = 0; r < rows; ++r) acc += ids_s[r] == s ? 1.f : 0.f;
    } else {
      const int kk = (s - k) / c, cc = (s - k) - kk * c;
      for (int r = 0; r < rows; ++r)
        if (ids_s[r] == kk) acc += xb[(size_t)r * c + cc];
    }
    pb[s] = acc;
  }
}

// Sums the per-block partials in a fixed order: 32 slots per block, each
// summed by 8 lanes over a strided set of blocks, then the lanes in order.
__global__ void __launch_bounds__(kThreads)
vq_reduce_kernel(const float* __restrict__ partials, int nblocks, int k, int c,
                 float* __restrict__ counts, float* __restrict__ sums) {
  __shared__ float red[kLanes][32];
  const int slots = k + k * c;
  const int sx = threadIdx.x & 31, sy = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + sx;
  float acc = 0.f;
  if (s < slots)
    for (int b = sy; b < nblocks; b += kLanes) acc += partials[(size_t)b * slots + s];
  red[sy][sx] = acc;
  __syncthreads();
  if (sy == 0 && s < slots) {
    float t = red[0][sx];
    for (int l = 1; l < kLanes; ++l) t += red[l][sx];
    if (s < k)
      counts[s] = t;
    else
      sums[s - k] = t;
  }
}

int k_padded(int k) { return (k + kTileK - 1) / kTileK * kTileK; }

}  // namespace

extern "C" {

// Dynamic shared memory the assignment kernel needs for one block.
long long vq_fused_smem_bytes(int k, int c, int rows_per_block) {
  const long long kp = k_padded(k);
  return (long long)sizeof(float) * (kp * c + kp) + (long long)sizeof(int) * rows_per_block;
}

// Number of per-block partial slots (floats) the caller must provide.
long long vq_fused_partials(int n, int k, int c, int rows_per_block) {
  const long long nblocks = (n + rows_per_block - 1) / rows_per_block;
  return nblocks * (k + (long long)k * c);
}

int vq_fused_launch(const void* x, const void* embed, int n, int c, int k,
                    int rows_per_block, void* ids, void* quant, void* counts,
                    void* sums, void* partials, void* stream) {
  const int kp = k_padded(k);
  const long long smem = vq_fused_smem_bytes(k, c, rows_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblocks = (n + rows_per_block - 1) / rows_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vq_assign_kernel<<<nblocks, kThreads, (size_t)smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(embed), n, c, k, kp,
      rows_per_block, static_cast<int32_t*>(ids), static_cast<float*>(quant),
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slots = k + k * c;
  vq_reduce_kernel<<<(slots + 31) / 32, kThreads, 0, st>>>(
      static_cast<const float*>(partials), nblocks, k, c,
      static_cast<float*>(counts), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // extern "C"
