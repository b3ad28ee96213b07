// X-TIME soft CAM search + leaf accumulation for Hopper (sm_90a).
//
// Replaces the soft branch of the Pallas TPU kernel `_cam_match_kernel`
// (src/repro/kernels/cam_match.py, mode='soft'), launched by
// `cam_match_pallas`: on float32 soft-encoded tables (half-integer bounds,
// wildcards (-inf, +inf), never-match cells (+inf, -inf))
//
//     ls(q, lo, hi) = log_sigmoid((q - lo) * inv) + log_sigmoid((hi - q) * inv)
//     score[b, r]   = exp(SUM_f ls(q[b, f], low[r, f], high[r, f]))
//     out[b, c]     = SUM_r score[b, r] * leaf[r, c]   (+ bias[c], once)
//
// with inv = float32(1 / tau), tau in bin units; tau = 0 is the exact
// indicator (q > lo && q < hi) -> 0 / -inf.  The engine runs it twice for
// `uncertainty`: over the leaf matrix, and over the (R, 3C) moments matrix
// [leaf, leaf^2, class mass] with no bias.
//
// Design: the structure of the hard kernel (cam_match.cu).  One block owns
// a 32-query tile and a fixed 1024-row split; each thread owns one row of
// the current 128-row chunk and keeps that row's log-score sum for the 32
// queries in 32 float registers (the hard kernel's match bitmask), adding
// features in index order.  Tables and queries are staged in shared memory
// one feature tile at a time; a (row chunk, feature tile) whose mask tiles
// are all 0 holds only (-inf, +inf) cells, whose log-score is exactly 0,
// so skipping it is exact.  Once a chunk is final, expf(sum) goes to shared
// memory (reusing the staged-table buffer) and the block adds score * leaf
// in row order into its slice of the [splits, B, C] workspace; the shared
// reduce kernel sums the splits in index order and adds the bias.  No
// atomics, no tensor cores, no fast-math intrinsics (expf/log1pf, as the
// plain version's exp/log1p): the result is identical run to run.  At
// tau = 0 every score is exactly 0 or 1, so the partial sums are the very
// float adds of the int32 `direct` kernel: the margins are bit-equal.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256, 53.6% of the (256 x 128) tiles active): the ~1.15 GB of active
// float32 tables (0.35 ms at 3.35 TB/s) at B = 1 and at tau = 0; at tau > 0
// and B = 256 the transcendentals the function needs, an ex2 and an lg2
// per finite bound and query (an infinite side's log-sigmoid is exactly
// 0; that table has 7.6 M finite bounds, chip_smoke.py counts them), on
// the SFU at 16 per clock per SM: ~1 ms.  This first version evaluates
// every cell of an active tile, wildcards included, with the accurate
// library expf/log1pf: 4 SFU results per cell and query, ~35 ms of SFU
// time at B = 256.  Skipping wildcard cells one by one and fusing the
// margin and moments passes are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cam_match_common.cuh"  // the block shape and the chunk skeleton

namespace {

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)): exactly 0 at +inf and
// -inf at -inf, never NaN.  The torch version is
// repro_torch/core/precision.py (`_log_sigmoid`).
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <bool kTauZero>
__device__ __forceinline__ float soft_logscore(float q, float lo, float hi,
                                               float inv) {
  if (kTauZero) return (q > lo && q < hi) ? 0.f : -INFINITY;
  // never hi - lo: with infinite bounds that would be inf - inf
  return log_sigmoid((q - lo) * inv) + log_sigmoid((hi - q) * inv);
}

// grid = (ceil(B / 32), splits); block = kThreads.
//   q      (B, F) float32 bins     low, high (R, F) float32 soft bounds
//   leaf   (R, C) float32 or null  tile_mask (R / r_blk, F / f_blk) or null
//   ws     [splits, B, C] partials or null
//   scores (B, R) row scores or null
template <bool kTauZero>
__global__ void __launch_bounds__(kThreads)
cam_match_soft_kernel(const float* __restrict__ q, const float* __restrict__ low,
                      const float* __restrict__ high,
                      const float* __restrict__ leaf,
                      const int32_t* __restrict__ tile_mask, int B, int R, int F,
                      int C, int r_blk, int f_blk, int rows_per_split, float inv,
                      float* __restrict__ ws, float* __restrict__ scores) {
  // odd row strides: the 32 threads of a warp reading their own rows, or
  // writing their own scores, hit 32 banks
  constexpr int kStride = kFeat + 1;
  constexpr int kScoreStride = kQueries + 1;
  static_assert(kThreads * kScoreStride <= kThreads * kStride,
                "the chunk's scores reuse s_lo");
  __shared__ float s_lo[kThreads * kStride];  // then the chunk's scores
  __shared__ float s_hi[kThreads * kStride];
  __shared__ float s_q[kFeat * kQueries];  // [feature][query]: broadcast reads
  float* s_score = s_lo;                   // [row][query]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, B - q0);
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  const int n_ftiles = F / f_blk;
  float* part = zeroed_partials(ws, B, C, q0, nq);

  for (int r0 = row_begin; r0 < row_end; r0 += kThreads) {
    const int nr = min(kThreads, row_end - r0);
    // one sum per query lane; constant indices keep them in registers
    float acc[kQueries];
#pragma unroll
    for (int b = 0; b < kQueries; ++b) acc[b] = 0.f;

    for (int k = 0; k < n_ftiles; ++k) {
      // all (-inf, +inf): log-score exactly 0
      if (!tile_active(tile_mask, r0, nr, r_blk, n_ftiles, k)) continue;
      const int f_end = (k + 1) * f_blk;
      for (int f0 = k * f_blk; f0 < f_end; f0 += kFeat) {
        const int nf = min(kFeat, f_end - f0);
        stage_chunk<kStride>(q, low, high, s_lo, s_hi, s_q, F, r0, nr, f0, nf, q0, nq);
        if (tid < nr) {
          for (int f = 0; f < nf; ++f) {
            const float lo = s_lo[tid * kStride + f];
            const float hi = s_hi[tid * kStride + f];
            const float* qs = s_q + f * kQueries;
#pragma unroll
            for (int b = 0; b < kQueries; ++b) {
              // padding lanes of a ragged tile skip the transcendentals
              // (a block-uniform branch); at tau = 0 they are cheaper to run
              if (kTauZero || b < nq) acc[b] += soft_logscore<kTauZero>(qs[b], lo, hi, inv);
            }
          }
        }
      }
    }

    __syncthreads();  // s_lo's readers (compares, last chunk's products) are done
    if (tid < nr) {
#pragma unroll
      for (int b = 0; b < kQueries; ++b) {
        const float s = expf(acc[b]);
        s_score[tid * kScoreStride + b] = s;
        if (scores != nullptr && b < nq) scores[(size_t)(q0 + b) * R + r0 + tid] = s;
      }
    }
    if (part) {
      __syncthreads();
      for (int o = tid; o < nq * C; o += kThreads) {
        const int b = o / C, c = o % C;
        float s = 0.f;
        for (int r = 0; r < nr; ++r) {
          s += s_score[r * kScoreStride + b] * leaf[(size_t)(r0 + r) * C + c];
        }
        part[o] += s;
      }
    }
  }
}

}  // namespace

// tau_zero: 1 runs the exact tau = 0 indicator, 0 the sigmoid cells with
// `inv` = float32(1 / tau) (computed on the host exactly as the plain
// version computes it).
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `scores`
// set: the (B, R) row scores only (`leaf`, `ws` and `out` null).  Returns
// a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int xtime_cam_match_soft(int tau_zero, float inv, const float* q,
                                    const float* low, const float* high,
                                    const float* leaf, const int32_t* tile_mask,
                                    const float* bias, int B, int R, int F, int C,
                                    int r_blk, int f_blk, int rows_per_split,
                                    float* ws, float* out, float* scores,
                                    void* stream_ptr) {
  if (bad_launch(B, R, F, C, r_blk, f_blk, rows_per_split, leaf, ws, out) ||
      (tau_zero == 0 && !(inv > 0.f && inv < INFINITY))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = match_grid(B, R, rows_per_split);
  if (tau_zero) {
    cam_match_soft_kernel<true><<<grid, kThreads, 0, stream>>>(
        q, low, high, leaf, tile_mask, B, R, F, C, r_blk, f_blk, rows_per_split,
        inv, ws, scores);
  } else {
    cam_match_soft_kernel<false><<<grid, kThreads, 0, stream>>>(
        q, low, high, leaf, tile_mask, B, R, F, C, r_blk, f_blk, rows_per_split,
        inv, ws, scores);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return err;
  return reduce_splits(ws, bias, out, R, rows_per_split, B, C, stream);
}
