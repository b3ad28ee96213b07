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
// a 32-query tile and a fixed row split, stages its queries once and walks
// 128-row chunks; each warp takes one row at a time with a lane per query
// and sums the log-scores of the row's listed cells only (the per-row cell
// list, cam_match_common.cuh), in ascending feature order; a tile of at
// most 8 queries gives each thread a (row, query) pair instead, with the
// same sum.  A wildcard (-inf, +inf) cell's log-score is exactly +0, and an
// infinite side of a listed cell contributes exactly +0 (log_sigmoid(+inf)),
// so the walk leaves both out and gives the float sum of adding every cell
// in order.
// The chunk's scores expf(sum) go to shared memory, its leaf rows are
// staged with coalesced loads, and the block adds score * leaf in row order
// into its slice of the [splits, B, C] workspace; the shared reduce kernel
// sums the splits in index order and adds the bias.  A table wider than the
// staged query window runs the kWide instance, which reads the queries of
// cells past the window from device memory (cam_match_common.cuh).  No
// atomics, no tensor
// cores, no fast-math intrinsics (expf/log1pf, as the plain version's
// exp/log1p): the result is identical run to run.  At tau = 0 every score
// is exactly 0 or 1, so the partial sums are the very float adds of the
// hard kernel's `direct` mode: the margins are bit-equal.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256): at tau > 0 the transcendentals the function needs, an ex2 and an
// lg2 per finite bound and query (7.6 M finite bounds; chip_smoke.py counts
// them), on the SFU at 16 per clock per SM: ~1 ms at B = 256; at tau = 0
// a compare per finite bound and query (~0.12 ms at B = 256); at B = 1 the
// bytes of the cell list and the leaf rows (~0.02 ms).  The accurate
// library expf/log1pf cost ~30 instructions a side beside their SFU op, so
// the issue rate sets this kernel's pace; a cheaper log-sigmoid held to the
// same bound is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cam_match_common.cuh"  // the block shape, the cell list and its walk

namespace {

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)): exactly 0 at +inf and
// -inf at -inf, never NaN.  The torch version is
// repro_torch/core/precision.py (`_log_sigmoid`).
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// One listed cell's log-score.  An infinite side's log-sigmoid is
// exactly +0, so it is not evaluated (a warp-uniform branch when the warp
// walks one row); the sum keeps the lo-side + hi-side grouping.
template <bool kTauZero>
__device__ __forceinline__ float soft_logscore(float q, float lo, float hi,
                                               float inv) {
  if (kTauZero) return (q > lo && q < hi) ? 0.f : -INFINITY;
  // never hi - lo: with infinite bounds that would be inf - inf
  float a = 0.f, b = 0.f;
  if (lo != -INFINITY) a = log_sigmoid((q - lo) * inv);
  if (hi != INFINITY) b = log_sigmoid((hi - q) * inv);
  return a + b;
}

constexpr size_t kScoreBytes = kChunk * kQStride * 4;

// grid = (ceil(B / 32), splits); block = kThreads; dynamic shared memory
// Layout<float>::bytes(F, kScoreBytes); kWide where the query window is
// not the whole width.
//   q      (B, F) float32 bins     cells: the soft table's cell list, (R, K)
//   leaf   (R, C) float32 or null
//   ws     [splits, B, C] partials or null
//   scores (B, R) row scores or null
template <bool kTauZero, bool kWide>
__global__ void __launch_bounds__(kThreads)
cam_match_soft_kernel(const float* __restrict__ q, CellArgs<float> cells,
                      const float* __restrict__ leaf, int B, int R, int F, int C,
                      int rows_per_split, float inv, float* __restrict__ ws,
                      float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  const int Fs = Layout<float>::window(F, kScoreBytes);
  unsigned char* area = smem + Layout<float>::queries(F, kScoreBytes);
  const Staged<float> st(area);
  float* s_leaf = reinterpret_cast<float*>(area);  // after the log-scores
  float* s_score = reinterpret_cast<float*>(area + Layout<float>::chunk);  // [row][query]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, B - q0);
  const bool by_pair = nq <= kPairWalkQueries;  // uniform in the block
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  float* part = zeroed_partials(ws, B, C, q0, nq);
  stage_queries(q, s_q, F, Fs, q0, nq);

  for (int r0 = row_begin; r0 < row_end; r0 += kChunk) {
    const int nr = min(kChunk, row_end - r0);
    __syncthreads();  // the previous chunk's readers are done
    stage_cells(cells, st, r0, nr);
    __syncthreads();

    if (by_pair) {  // a thread per (row, query): rows adjacent across lanes
      for (int p = tid; p < nr * nq; p += kThreads) {
        const int r = p % nr, b = p / nr;
        float acc = 0.f;
        walk_row(cells, st, r0, r, [&](int f, float lo, float hi) {
          acc += soft_logscore<kTauZero>(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, b), lo,
                                         hi, inv);
        });
        const float s = expf(acc);
        s_score[r * kQStride + b] = s;
        if (scores != nullptr) scores[(size_t)(q0 + b) * R + r0 + r] = s;
      }
    } else {  // a warp per row, a lane per query
      for (int r = warp; r < nr; r += kWarps) {
        float acc = 0.f;
        // padding lanes of a ragged tile skip the transcendentals; at
        // tau = 0 they are cheaper to run
        if (kTauZero || lane < nq) {
          walk_row(cells, st, r0, r, [&](int f, float lo, float hi) {
            acc += soft_logscore<kTauZero>(
                query_at<kWide>(s_q, q, F, Fs, q0, nq, f, lane), lo, hi, inv);
          });
        }
        const float s = expf(acc);
        s_score[r * kQStride + lane] = s;
        if (scores != nullptr && lane < nq) scores[(size_t)(q0 + lane) * R + r0 + r] = s;
      }
    }
    if (part == nullptr) continue;

    for (int c0 = 0; c0 < C; c0 += kLeafCols) {
      const int cw = min(kLeafCols, C - c0);
      __syncthreads();  // the cell reads, scores, earlier channels' readers
      stage_leaf(leaf, s_leaf, C, r0, nr, c0, cw, [](int) { return true; });
      __syncthreads();
      for (int o = tid; o < nq * cw; o += kThreads) {
        const int b = o / cw, c = o % cw;
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < nr; ++r) s += s_score[r * kQStride + b] * s_leaf[r * cw + c];
        part[b * C + c0 + c] += s;
      }
    }
  }
}

template <bool kTauZero, bool kWide>
cudaError_t launch_soft_as(const float* q, const CellArgs<float>& cells,
                           const float* leaf, int B, int R, int F, int C,
                           int rows_per_split, float inv, float* ws, float* scores,
                           cudaStream_t stream) {
  const size_t smem = Layout<float>::bytes(F, kScoreBytes);
  cudaError_t err = allow_smem(cam_match_soft_kernel<kTauZero, kWide>, smem);
  if (err != cudaSuccess) return err;
  cam_match_soft_kernel<kTauZero, kWide><<<match_grid(B, R, rows_per_split), kThreads,
                                           smem, stream>>>(q, cells, leaf, B, R, F, C,
                                                           rows_per_split, inv, ws,
                                                           scores);
  return cudaGetLastError();
}

template <bool kTauZero>
cudaError_t launch_soft(const float* q, const CellArgs<float>& cells,
                        const float* leaf, int B, int R, int F, int C,
                        int rows_per_split, float inv, float* ws, float* scores,
                        cudaStream_t stream) {
  if (Layout<float>::window(F, kScoreBytes) < F) {
    return launch_soft_as<kTauZero, true>(q, cells, leaf, B, R, F, C, rows_per_split, inv,
                                          ws, scores, stream);
  }
  return launch_soft_as<kTauZero, false>(q, cells, leaf, B, R, F, C, rows_per_split, inv,
                                         ws, scores, stream);
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
                                    const int32_t* count, const uint16_t* feat,
                                    const float* lo, const float* hi, int K,
                                    const float* leaf, const float* bias, int B,
                                    int R, int F, int C, int rows_per_split,
                                    float* ws, float* out, float* scores,
                                    void* stream_ptr) {
  if (bad_launch(B, R, F, C, K, rows_per_split, leaf, ws, out) ||
      (tau_zero == 0 && !(inv > 0.f && inv < INFINITY))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const CellArgs<float> cells{count, feat, lo, hi, K};
  const cudaError_t err =
      tau_zero ? launch_soft<true>(q, cells, leaf, B, R, F, C, rows_per_split, inv, ws,
                                   scores, stream)
               : launch_soft<false>(q, cells, leaf, B, R, F, C, rows_per_split, inv, ws,
                                    scores, stream);
  if (err != cudaSuccess || out == nullptr) return err;
  return reduce_splits(ws, bias, out, R, rows_per_split, B, C, stream);
}
