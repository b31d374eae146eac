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
//   Wide codebooks (C = 64, K = 512) are compute bound.
// * One template, two instances. vq_assign_kernel<16, 10> is every shipped
//   config's first-stage codebook: C and K are compile-time, a thread holds
//   its row in registers and scores exactly K codes, each code read from
//   shared memory as 16-byte broadcasts. vq_assign_kernel<0, 0> reads C and
//   K from its arguments and takes every other shape.
// * Staging. A block is persistent: it walks the tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ... of the rows, and copies each tile (a
//   contiguous span of rows*C floats) into shared memory once with 16-byte
//   cp.async, the next tile while it works on this one (<16, 10>). Rows are
//   padded to row_stride(C) floats, so that eight rows read at one 16-byte
//   offset meet no bank conflict. Every feature byte comes from device
//   memory once: the scores and the sums both read the staged tile.
// * Stores. Ids one int32 a row, consecutive threads on consecutive rows;
//   quantized rows by a warp together, 16 bytes a lane (<16, 10>) or one
//   float a lane along the channels (<0, 0>).
// * Precision. Scores 2*x.e - |e|^2 are true f32 FFMA chains in channel
//   order c = 0..C-1 on the CUDA cores, no TF32. A thread scans its codes
//   upward with a strict '>', and the generic instance combines the partial
//   maxima of its code slices by (greater score, else lower index), so ties
//   go to the first index, as argmax does.
// * Statistics without atomics. The TPU grid runs in order and carries
//   counts/sums across steps. Here each address has one owner and sums in a
//   fixed order: <16, 10> splits the rows of a tile into groups; thread
//   (group g, channel c) adds channel c of its group's rows in row order into
//   the group's partial in shared memory, across all the block's tiles, and
//   the block sums its groups in order g = 0.. into its per-block partial.
//   <0, 0> keeps the block's partial in device memory (K*C floats do not fit
//   beside the codebook): per tile, one warp lists the rows of each code
//   (__match_any_sync), and the thread of channel c adds each list's rows in
//   row order, then the list's sum into the partial. A second kernel sums the
//   per-block partials in a fixed order. Two runs on one input are
//   bit-identical.
// * Ragged N is masked (the last tile takes the remainder rows).
//
// Plain C interface, bound with ctypes: pointers and the stream come in as
// void*, and the launch returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads a block of the assignment kernel
constexpr int kRows = 256;            // <C, K>: rows a tile, one a thread
constexpr int kGenericRows = 32;      // <0, 0>: rows a tile, one a lane of the row lists
constexpr int kSlices = 8;            // <0, 0>: code slices a row, lanes 4 apart
constexpr int kChains = 4;            // <0, 0>: codes a thread scores at once
constexpr int kReduceThreads = 1024;  // reduce: 32 slots, 32 warps
constexpr int kMaxDevices = 64;

// Floats a row takes in shared memory: C rounded up to 16-byte chunks, and
// an odd count of chunks, so that eight consecutive rows start in eight
// different groups of four banks.
__host__ __device__ constexpr int chunks_of(int c) { return (c + 3) / 4; }
__host__ __device__ constexpr int row_stride(int c) { return 4 * (chunks_of(c) | 1); }
__host__ __device__ constexpr int pad4(int k) { return (k + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- <C, K>: compile-time codebook --------------------------------------

template <int C, int K>
struct Fixed {
  static constexpr int kQ = C / 4;              // 16-byte chunks a row
  static constexpr int kS = row_stride(C);      // staged row stride (floats)
  static constexpr int kGroups = kThreads / C;  // row groups of the statistics
  static constexpr int kGroupStride = K * C + 16;  // a group's sums; +16 puts
                                                   // two groups' same code in
                                                   // other banks
  static constexpr int kSlots = K + K * C;
  static constexpr long long kSmem =
      4LL * (2 * kRows * kS + K * C + pad4(K) + kGroups * kGroupStride + kGroups * K) +
      4LL * kRows;
  static_assert(C % 4 == 0 && kThreads % C == 0 && kRows == kThreads, "tile map");
};

template <int C, int K>
__device__ __forceinline__ void assign_fixed(const float* __restrict__ x,
                                             const float* __restrict__ embed, int n,
                                             int32_t* __restrict__ ids,
                                             float* __restrict__ quant,
                                             float* __restrict__ partials, float* smem) {
  using F = Fixed<C, K>;
  constexpr int kQ = F::kQ, kS = F::kS, kG = F::kGroups, kGS = F::kGroupStride;
  float* x_s = smem;                             // [2][kRows][kS], two stages
  float* e_s = x_s + 2 * kRows * kS;             // [K][C]
  float* esq_s = e_s + K * C;                    // [K]
  float* sums_s = esq_s + pad4(K);               // [kG][kGS]
  float* counts_s = sums_s + kG * kGS;           // [kG][K]
  int* ids_s = reinterpret_cast<int*>(counts_s + kG * K);  // [kRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (n + kRows - 1) / kRows;

  // chunk i = tid + kThreads*j of the tile is row i / kQ, chunk i % kQ:
  // consecutive threads copy consecutive 16 bytes
  auto stage = [&](int tile, int buf) {
    const long long row0 = (long long)tile * kRows;
    const int rows = (int)min((long long)kRows, (long long)n - row0);
    const float* src = x + row0 * C;
    float* dst = x_s + buf * kRows * kS;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int i = tid + kThreads * j, r = i / kQ, q = i % kQ;
      if (r < rows) cp_async16(dst + r * kS + 4 * q, src + (size_t)r * C + 4 * q);
    }
  };

  stage(blockIdx.x, 0);
  cp_async_commit();
  for (int i = tid; i < K * C; i += kThreads) e_s[i] = embed[i];
  for (int i = tid; i < kG * kGS; i += kThreads) sums_s[i] = 0.f;
  for (int i = tid; i < kG * K; i += kThreads) counts_s[i] = 0.f;
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < C; ++cc) s = fmaf(e_s[tid * C + cc], e_s[tid * C + cc], s);
    esq_s[tid] = s;
  }

  const int gc = tid % C, gg = tid / C;  // statistics: channel, row group
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const long long row0 = (long long)tile * kRows;
    const int rows = (int)min((long long)kRows, (long long)n - row0);
    const float* xt = x_s + buf * kRows * kS;

    // 1. scores: row tid in registers, code kk as kQ 16-byte broadcasts
    int best_k = 0;
    if (tid < rows) {
      float xr[C];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xt + tid * kS + 4 * q);
        xr[4 * q] = v.x;
        xr[4 * q + 1] = v.y;
        xr[4 * q + 2] = v.z;
        xr[4 * q + 3] = v.w;
      }
      float best = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 e = *reinterpret_cast<const float4*>(e_s + kk * C + 4 * q);
          acc = fmaf(xr[4 * q], e.x, acc);
          acc = fmaf(xr[4 * q + 1], e.y, acc);
          acc = fmaf(xr[4 * q + 2], e.z, acc);
          acc = fmaf(xr[4 * q + 3], e.w, acc);
        }
        const float s = 2.f * acc - esq_s[kk];
        if (s > best) {
          best = s;
          best_k = kk;
        }
      }
      ids[row0 + tid] = best_k;
    }
    ids_s[tid] = best_k;

    // 2. quantized rows: the warp's 32 rows are 32*kQ chunks of contiguous
    //    output; chunk m is row m / kQ, whose id lane m / kQ holds
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int m = 32 * j + lane, r = 32 * warp + m / kQ, q = m % kQ;
      const int id = __shfl_sync(0xffffffffu, best_k, m / kQ);
      if (r < rows)
        *reinterpret_cast<float4*>(quant + (row0 + r) * C + 4 * q) =
            *reinterpret_cast<const float4*>(e_s + id * C + 4 * q);
    }
    __syncthreads();

    // 3. statistics: thread (gg, gc) adds channel gc of rows gg, gg + kG, ...
    //    in row order into its group's partial
    float* sg = sums_s + gg * kGS;
    for (int r = gg; r < rows; r += kG) {
      const int id = ids_s[r];
      sg[id * C + gc] += xt[r * kS + gc];
      if (gc == 0) counts_s[gg * K + id] += 1.f;
    }
    __syncthreads();  // before this stage and ids_s are written again
  }

  // the block's partial: its groups summed in order
  float* pb = partials + (size_t)blockIdx.x * F::kSlots;
  for (int s = tid; s < F::kSlots; s += kThreads) {
    float t = 0.f;
    for (int g = 0; g < kG; ++g) t += s < K ? counts_s[g * K + s] : sums_s[g * kGS + s - K];
    pb[s] = t;
  }
}

// ---- <0, 0>: C and K from the arguments ---------------------------------

long long generic_smem(int c, int k) {
  const long long s = row_stride(c);
  return 4LL * (k * s + pad4(k) + kGenericRows * s) + 4LL * 2 * kGenericRows;
}

__device__ __forceinline__ void assign_generic(const float* __restrict__ x,
                                               const float* __restrict__ embed, int n,
                                               int C, int K, int32_t* __restrict__ ids,
                                               float* __restrict__ quant,
                                               float* __restrict__ partials, float* smem) {
  const int Q = chunks_of(C), S = row_stride(C), slots = K + K * C;
  float* e_s = smem;                   // [K][S], zero in [C, 4Q)
  float* esq_s = e_s + K * S;          // [K]
  float* x_s = esq_s + pad4(K);        // [kGenericRows][S]
  int* ids_s = reinterpret_cast<int*>(x_s + kGenericRows * S);  // [kGenericRows]
  unsigned* lists_s = reinterpret_cast<unsigned*>(ids_s + kGenericRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int ntiles = (n + kGenericRows - 1) / kGenericRows;
  const bool vec = (C & 3) == 0;
  float* pb = partials + (size_t)blockIdx.x * slots;  // this block's partial

  for (int r = warp; r < K; r += kWarps)
    for (int cc = lane; cc < 4 * Q; cc += 32)
      e_s[r * S + cc] = cc < C ? embed[(size_t)r * C + cc] : 0.f;
  for (int s = tid; s < slots; s += kThreads) pb[s] = 0.f;
  __syncthreads();
  for (int kk = tid; kk < K; kk += kThreads) {
    float s = 0.f;
    for (int cc = 0; cc < C; ++cc) s = fmaf(e_s[kk * S + cc], e_s[kk * S + cc], s);
    esq_s[kk] = s;
  }

  // scoring: lane (row lane rl, slice sl) of warp w scores row 4w + rl
  // against codes sl + kSlices*m + 32i; four row lanes read one code (a
  // broadcast), eight slices eight consecutive codes (eight bank groups)
  const int rl = lane & 3, sl = lane >> 2, r_own = 4 * warp + rl;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * kGenericRows;
    const int rows = (int)min((long long)kGenericRows, (long long)n - row0);
    const float* src = x + row0 * C;
    for (int r = warp; r < rows; r += kWarps) {
      if (vec) {
        for (int q = lane; q < Q; q += 32)
          cp_async16(x_s + r * S + 4 * q, src + (size_t)r * C + 4 * q);
      } else {
        for (int cc = lane; cc < 4 * Q; cc += 32)
          x_s[r * S + cc] = cc < C ? src[(size_t)r * C + cc] : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 1. scores, then the slices' maxima combined: (greater, else lower k)
    float best = -INFINITY;
    int best_k = INT_MAX;
    const float* xr = x_s + r_own * S;
    for (int kb = 0; kb < K; kb += kChains * kSlices) {
      int kc[kChains];
      const float* er[kChains];
      float acc[kChains];
#pragma unroll
      for (int m = 0; m < kChains; ++m) {
        kc[m] = kb + sl + kSlices * m;
        er[m] = e_s + min(kc[m], K - 1) * S;
        acc[m] = 0.f;
      }
#pragma unroll 4
      for (int q = 0; q < Q; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * q);
#pragma unroll
        for (int m = 0; m < kChains; ++m) {
          const float4 ev = *reinterpret_cast<const float4*>(er[m] + 4 * q);
          acc[m] = fmaf(xv.x, ev.x, acc[m]);
          acc[m] = fmaf(xv.y, ev.y, acc[m]);
          acc[m] = fmaf(xv.z, ev.z, acc[m]);
          acc[m] = fmaf(xv.w, ev.w, acc[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kChains; ++m) {
        if (kc[m] < K) {
          const float s = 2.f * acc[m] - esq_s[kc[m]];
          if (s > best) {
            best = s;
            best_k = kc[m];
          }
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
      if (ob > best || (ob == best && ok < best_k)) {
        best = ob;
        best_k = ok;
      }
    }
    if (best_k == INT_MAX) best_k = 0;  // no score above -inf: code 0
    if (sl == 0) {
      ids_s[r_own] = best_k;
      if (r_own < rows) ids[row0 + r_own] = best_k;
    }
    __syncthreads();

    // 2. quantized rows: a warp a row, along the channels
    for (int r = warp; r < rows; r += kWarps) {
      const float* er = e_s + ids_s[r] * S;
      float* qr = quant + (row0 + r) * C;
      for (int cc = lane; cc < C; cc += 32) qr[cc] = er[cc];
    }
    // 3. the rows of each code of the tile as a lane mask, led by its
    //    lowest row; the leader adds the count
    if (warp == 0) {
      const int id = lane < rows ? ids_s[lane] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, id);
      const bool lead = id >= 0 && __ffs(same) - 1 == lane;
      lists_s[lane] = lead ? same : 0u;
      if (lead) pb[id] += (float)__popc(same);
    }
    __syncthreads();
    // 4. sums: the thread of channel cc sums each list's rows in row order,
    //    then adds the sum to the partial (all loads issued before the stores)
    for (int cc = tid; cc < C; cc += kThreads) {
      float run[kGenericRows], old[kGenericRows];
#pragma unroll
      for (int r = 0; r < kGenericRows; ++r) {
        unsigned m = lists_s[r];
        float v = 0.f;
        while (m) {
          v += x_s[(__ffs(m) - 1) * S + cc];
          m &= m - 1;
        }
        run[r] = v;
      }
#pragma unroll
      for (int r = 0; r < kGenericRows; ++r)
        old[r] = lists_s[r] ? pb[K + ids_s[r] * C + cc] : 0.f;
#pragma unroll
      for (int r = 0; r < kGenericRows; ++r)
        if (lists_s[r]) pb[K + ids_s[r] * C + cc] = old[r] + run[r];
    }
    __syncthreads();  // before x_s, ids_s and lists_s are written again
  }
}

template <int C, int K>
__global__ void __launch_bounds__(kThreads, C > 0 ? 3 : 1)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ embed, int n, int c,
                 int k, int32_t* __restrict__ ids, float* __restrict__ quant,
                 float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (C > 0)
    assign_fixed<C, K>(x, embed, n, ids, quant, partials, smem);
  else
    assign_generic(x, embed, n, c, k, ids, quant, partials, smem);
}

// Sums the per-block partials in a fixed order: 32 slots a block; warp w
// sums blocks w, w + 32, ... of its lane's slot, then the warps in order.
__global__ void __launch_bounds__(kReduceThreads)
vq_reduce_kernel(const float* __restrict__ partials, int nblocks, int k, int slots,
                 float* __restrict__ counts, float* __restrict__ sums) {
  __shared__ float red[32][33];
  const int sx = threadIdx.x & 31, sy = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + sx;
  float acc = 0.f;
  if (s < slots) {
#pragma unroll 4
    for (int b = sy; b < nblocks; b += 32) acc += partials[(size_t)b * slots + s];
  }
  red[sy][sx] = acc;
  __syncthreads();
  if (sy == 0 && s < slots) {
    float t = red[0][sx];
    for (int l = 1; l < 32; ++l) t += red[l][sx];
    if (s < k)
      counts[s] = t;
    else
      sums[s - k] = t;
  }
}

bool is_c16k10(int c, int k) { return c == 16 && k == 10; }

// Dynamic shared memory each instance has been allowed, per device: the
// attribute is set once per instance and size, not on every launch.
long long g_allowed[kMaxDevices][2];
int g_sms[kMaxDevices];

cudaError_t allow_smem(bool fixed, long long smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  long long& allowed = g_allowed[dev][fixed];
  if (smem <= allowed) return cudaSuccess;
  err = fixed ? cudaFuncSetAttribute(vq_assign_kernel<16, 10>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
              : cudaFuncSetAttribute(vq_assign_kernel<0, 0>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

extern "C" {

// 1 where vq_fused_launch runs the <16, 10> instance, 0 for <0, 0>.
int vq_fused_instance(int c, int k) { return is_c16k10(c, k) ? 1 : 0; }

// Dynamic shared memory one block of the instance needs.
long long vq_fused_smem_bytes(int c, int k) {
  return is_c16k10(c, k) ? Fixed<16, 10>::kSmem : generic_smem(c, k);
}

// Blocks of the persistent grid on the current device: as many as fit at
// once on all SMs, then trimmed so that every block walks the same number
// of tiles (give or take one). Negative on a CUDA error.
int vq_fused_grid(int n, int c, int k) {
  const bool fixed = is_c16k10(c, k);
  const long long smem = vq_fused_smem_bytes(c, k);
  if (allow_smem(fixed, smem) != cudaSuccess) return -1;
  int dev = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (!g_sms[dev] &&
      cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const cudaError_t err =
      fixed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, vq_assign_kernel<16, 10>,
                                                            kThreads, (size_t)smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, vq_assign_kernel<0, 0>,
                                                            kThreads, (size_t)smem);
  if (err != cudaSuccess || occ < 1) return -1;
  const long long rows = fixed ? kRows : kGenericRows;
  const long long tiles = (n + rows - 1) / rows;
  const long long fit = (long long)g_sms[dev] * occ;
  const long long per = (tiles + fit - 1) / fit;
  return (int)((tiles + per - 1) / per);
}

// ids (n,) int32, quant (n, c), counts (k,), sums (k, c); partials
// (grid * (k + k*c)) scratch; grid from vq_fused_grid.
int vq_fused_launch(const void* x, const void* embed, int n, int c, int k, int grid,
                    void* ids, void* quant, void* counts, void* sums, void* partials,
                    void* stream) {
  const bool fixed = is_c16k10(c, k);
  const long long smem = vq_fused_smem_bytes(c, k);
  cudaError_t err = allow_smem(fixed, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(embed);
  int32_t* ip = static_cast<int32_t*>(ids);
  float* qp = static_cast<float*>(quant);
  float* pp = static_cast<float*>(partials);
  if (fixed)
    vq_assign_kernel<16, 10><<<grid, kThreads, (size_t)smem, st>>>(xp, ep, n, c, k, ip, qp, pp);
  else
    vq_assign_kernel<0, 0><<<grid, kThreads, (size_t)smem, st>>>(xp, ep, n, c, k, ip, qp, pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slots = k + k * c;
  vq_reduce_kernel<<<(slots + 31) / 32, kReduceThreads, 0, st>>>(
      pp, grid, k, slots, static_cast<float*>(counts), static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

}  // extern "C"
