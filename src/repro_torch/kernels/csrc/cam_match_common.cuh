// Shared by the CAM-match kernels (cam_match.cu, cam_match_soft.cu): the
// block shape, the launch checks, the per-chunk skeleton both kernels walk
// (their partials, the tile-mask test, the shared-memory staging) and the
// fixed-order reduction of the per-split partials.  The two kernels differ
// only in what a thread accumulates per cell and in the chunk's write-out.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows per chunk: one table row per thread
constexpr int kQueries = 32;   // queries per block
constexpr int kFeat = 32;      // features staged in shared memory at a time

// The checks both C entries make before a launch: shapes that tile, and
// `ws`/`out` given together, with a leaf matrix.
inline bool bad_launch(int B, int R, int F, int C, int r_blk, int f_blk,
                       int rows_per_split, const float* leaf, const float* ws,
                       const float* out) {
  return B <= 0 || R <= 0 || F <= 0 || r_blk <= 0 || f_blk <= 0 ||
         rows_per_split <= 0 || rows_per_split % kThreads != 0 ||
         R % r_blk != 0 || F % f_blk != 0 || (out != nullptr) != (ws != nullptr) ||
         (out != nullptr && (leaf == nullptr || C <= 0));
}

// One block per (32-query tile, row split).
inline dim3 match_grid(int B, int R, int rows_per_split) {
  return dim3((B + kQueries - 1) / kQueries, (R + rows_per_split - 1) / rows_per_split);
}

// This block's slice of the [splits, B, C] workspace, zeroed (null without
// one).  Each output is owned by one thread: no synchronisation.
__device__ __forceinline__ float* zeroed_partials(float* ws, int B, int C,
                                                  int q0, int nq) {
  float* part = ws ? ws + ((size_t)blockIdx.y * B + q0) * C : nullptr;
  if (part) {
    for (int o = threadIdx.x; o < nq * C; o += kThreads) part[o] = 0.f;
  }
  return part;
}

// Whether feature tile k of rows [r0, r0 + nr) must be evaluated: some
// (r_blk, f_blk) tile it covers is marked active in `tile_mask` (every one
// is without a mask).  An inactive one holds only wildcard cells.  The
// same answer in every thread: a branch on it is uniform.
__device__ __forceinline__ bool tile_active(const int32_t* __restrict__ tile_mask,
                                            int r0, int nr, int r_blk,
                                            int n_ftiles, int k) {
  if (tile_mask == nullptr) return true;
  for (int rt = r0 / r_blk; rt <= (r0 + nr - 1) / r_blk; ++rt) {
    if (tile_mask[(size_t)rt * n_ftiles + k] != 0) return true;
  }
  return false;
}

// Stages rows [r0, r0 + nr) x features [f0, f0 + nf) of low/high into
// s_lo/s_hi ([row][feature], row stride kStride) and the block's queries
// into s_q ([feature][query], widened to W, padding lanes 0), all with
// coalesced loads.  Between two barriers: the previous chunk's readers are
// done before it, and every thread sees the whole chunk after it.
template <int kStride, typename T, typename W>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ q,
                                            const T* __restrict__ low,
                                            const T* __restrict__ high,
                                            T* s_lo, T* s_hi, W* s_q, int F,
                                            int r0, int nr, int f0, int nf,
                                            int q0, int nq) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int i = tid; i < kThreads * kFeat; i += kThreads) {
    const int r = i / kFeat, f = i % kFeat;
    if (r < nr && f < nf) {
      const size_t g = (size_t)(r0 + r) * F + f0 + f;
      s_lo[r * kStride + f] = low[g];
      s_hi[r * kStride + f] = high[g];
    }
  }
  for (int i = tid; i < kQueries * kFeat; i += kThreads) {
    const int b = i / kFeat, f = i % kFeat;
    if (f < nf) {
      s_q[f * kQueries + b] = b < nq ? W(q[(size_t)(q0 + b) * F + f0 + f]) : W(0);
    }
  }
  __syncthreads();
}

// out[b, c] = ws[0, b, c] + ws[1, b, c] + ... (+ bias[c]), in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int splits,
                                     int B, int C) {
  const size_t n = (size_t)B * C;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = ws[i];
  for (int s = 1; s < splits; ++s) acc += ws[(size_t)s * n + i];
  if (bias != nullptr) acc += bias[i % C];
  out[i] = acc;
}

inline cudaError_t reduce_splits(const float* ws, const float* bias, float* out,
                                 int R, int rows_per_split, int B, int C,
                                 cudaStream_t stream) {
  const int splits = (R + rows_per_split - 1) / rows_per_split;
  const size_t n = (size_t)B * C;
  const int threads = 256;
  reduce_splits_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         stream>>>(ws, bias, out, splits, B, C);
  return cudaGetLastError();
}

}  // namespace
