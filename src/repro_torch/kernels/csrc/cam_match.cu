// X-TIME CAM search + leaf accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_cam_match_kernel`, launched by
// `cam_match_pallas` (src/repro/kernels/cam_match.py), for the four hard
// cell modes:
//
//     match[b, r] = AND_f cell(q[b, f], low[r, f], high[r, f])
//     out[b, c]   = SUM_r match[b, r] * leaf[r, c]   (+ bias[c], once)
//
// Design.  The TPU kernel walks (row tile, feature tile) in order on one
// core and keeps the running AND in VMEM.  GPU blocks run in no order, so
// here one block owns one 32-query tile and one contiguous range of rows
// (a "split"; its size is a constant, so the split count depends on the
// shapes only).  Inside the block each thread owns one table row of the
// current 128-row chunk and keeps that row's match line for the 32
// queries as one register bitmask; table and query chunks are staged in
// shared memory with coalesced loads, one feature tile at a time, and a
// (row chunk, feature tile) whose `tile_mask` tiles are all 0 (all
// wildcards) skips both its loads and its compares.  Once a chunk's bits
// are final, the block adds `bits * leaf` in row order into its own slice
// of a [splits, B, C] workspace; a second kernel sums the splits in index
// order and adds `bias`.  No float atomics and no tensor cores: every
// term is `leaf` or nothing, so the order is fixed and the result is
// bit-identical run to run, fused bias against bias added afterwards,
// and packed uint8/uint16 tables against int32 ones.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad
// = 256, uint8): the work the function needs is a compare and an AND per
// binding bound (low > 0 or high < n_bins) and query, and that table has
// 5.9 M of them (chip_smoke.py counts them), so B = 256 is bound by the
// ~0.1 ms of active uint8 tiles and leaves, as is B = 1; B = 1024 by the
// ~0.36 ms of compares.  This first version compares every cell of an
// active tile, wildcards included, at about four integer instructions per
// compare, and makes no use of byte-SIMD compares, TMA or wgmma — that is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cam_match_common.cuh"  // the block shape and the chunk skeleton

namespace {

// Compares run on 32-bit values: zero-extended for the unsigned tables
// (so uint8 never sign-extends), signed for int32.
template <typename T> struct Wide;
template <> struct Wide<uint8_t> { using type = uint32_t; };
template <> struct Wide<uint16_t> { using type = uint32_t; };
template <> struct Wide<int32_t> { using type = int32_t; };

// Cell functors: the torch versions are repro_torch/core/precision.py.
struct Direct {
  template <typename W>
  __device__ __forceinline__ static bool match(W q, W lo, W hi) {
    return lo <= q && q < hi;
  }
};

struct Inclusive {
  template <typename W>
  __device__ __forceinline__ static bool match(W q, W lo, W hi) {
    return lo <= q && q <= hi;
  }
};

// Eq. 3 on 4-bit nibbles.  `>>` on int32 is arithmetic, as in the
// reference, so negative bounds of perturbed tables split the same way.
struct MsbLsb {
  __device__ __forceinline__ static bool match(int32_t q, int32_t lo, int32_t hi) {
    const int32_t qm = q >> 4, ql = q & 15;
    const int32_t tlm = lo >> 4, tll = lo & 15;
    const int32_t thm = hi >> 4, thl = hi & 15;
    const bool lower = ((qm >= tlm + 1) || (ql >= tll)) && (qm >= tlm);
    const bool upper = ((qm < thm) || (ql < thl)) && (qm < thm + 1);
    return lower && upper;
  }
};

// Table I: cycle 1 evaluates the OR brackets, cycle 2 the MSB terms; the
// match line only discharges, so the result is the AND of both cycles.
struct TwoCycle {
  __device__ __forceinline__ static bool match(int32_t q, int32_t lo, int32_t hi) {
    const int32_t qm = q >> 4, ql = q & 15;
    const int32_t tlm = lo >> 4, tll = lo & 15;
    const int32_t thm = hi >> 4, thl = hi & 15;
    const bool cycle1 = (((qm - 1) >= tlm) || (ql >= tll)) && ((qm < thm) || (ql < thl));
    const bool cycle2 = (qm >= tlm) && ((qm - 1) < thm);
    return cycle1 && cycle2;
  }
};

// grid = (ceil(B / 32), splits); block = kThreads.
//   q     (B, F)  table dtype        low, high (R, F) table dtype
//   leaf  (R, C)  float32 or null    tile_mask (R / r_blk, F / f_blk) or null
//   ws    [splits, B, C] partials or null
//   bits  [ceil(B / 32), R] match words (bit b = query 32*x + b) or null
template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads)
cam_match_kernel(const T* __restrict__ q, const T* __restrict__ low,
                 const T* __restrict__ high, const float* __restrict__ leaf,
                 const int32_t* __restrict__ tile_mask, int B, int R, int F,
                 int C, int r_blk, int f_blk, int rows_per_split,
                 float* __restrict__ ws, uint32_t* __restrict__ bits) {
  using W = typename Wide<T>::type;
  // row stride of the staged tables: an odd number of 32-bit words, so
  // the 32 threads of a warp reading their own rows hit 32 banks
  constexpr int kStride = kFeat + 4 / sizeof(T);
  __shared__ T s_lo[kThreads * kStride];
  __shared__ T s_hi[kThreads * kStride];
  __shared__ W s_q[kFeat * kQueries];  // [feature][query]: broadcast reads
  __shared__ uint32_t s_match[kThreads];

  const int tid = threadIdx.x;
  const int q_tile = blockIdx.x;
  const int q0 = q_tile * kQueries;
  const int nq = min(kQueries, B - q0);
  const uint32_t valid = nq == kQueries ? 0xffffffffu : ((1u << nq) - 1u);
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  const int n_ftiles = F / f_blk;
  float* part = zeroed_partials(ws, B, C, q0, nq);

  for (int r0 = row_begin; r0 < row_end; r0 += kThreads) {
    const int nr = min(kThreads, row_end - r0);
    uint32_t m = tid < nr ? valid : 0u;

    for (int k = 0; k < n_ftiles; ++k) {
      // all wildcards: every query matches
      if (!tile_active(tile_mask, r0, nr, r_blk, n_ftiles, k)) continue;
      const int f_end = (k + 1) * f_blk;
      for (int f0 = k * f_blk; f0 < f_end; f0 += kFeat) {
        const int nf = min(kFeat, f_end - f0);
        stage_chunk<kStride>(q, low, high, s_lo, s_hi, s_q, F, r0, nr, f0, nf, q0, nq);
        if (tid < nr) {
          for (int f = 0; f < nf; ++f) {
            const W lo = s_lo[tid * kStride + f];
            const W hi = s_hi[tid * kStride + f];
            const W* qs = s_q + f * kQueries;
            uint32_t ok = 0;
            if (nq == kQueries) {
#pragma unroll
              for (int b = 0; b < kQueries; ++b) {
                ok |= uint32_t(Cell::match(qs[b], lo, hi)) << b;
              }
            } else {
              for (int b = 0; b < nq; ++b) {
                ok |= uint32_t(Cell::match(qs[b], lo, hi)) << b;
              }
            }
            m &= ok;
          }
        }
      }
    }

    if (bits != nullptr && tid < nr) bits[(size_t)q_tile * R + r0 + tid] = m;
    if (part) {
      __syncthreads();  // s_match readers of the previous chunk are done
      s_match[tid] = m;
      __syncthreads();
      for (int o = tid; o < nq * C; o += kThreads) {
        const int b = o / C, c = o % C;
        float s = 0.f;
        for (int r = 0; r < nr; ++r) {
          if ((s_match[r] >> b) & 1u) s += leaf[(size_t)(r0 + r) * C + c];
        }
        part[o] += s;
      }
    }
  }
}

template <typename T, typename Cell>
cudaError_t launch(const void* q, const void* low, const void* high,
                   const float* leaf, const int32_t* tile_mask, int B, int R,
                   int F, int C, int r_blk, int f_blk, int rows_per_split,
                   float* ws, uint32_t* bits, cudaStream_t stream) {
  cam_match_kernel<T, Cell><<<match_grid(B, R, rows_per_split), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(low),
      static_cast<const T*>(high), leaf, tile_mask, B, R, F, C, r_blk, f_blk,
      rows_per_split, ws, bits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32.  mode: 0 direct, 1 inclusive,
// 2 msb_lsb, 3 two_cycle (the last two on int32 only).
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `bits`
// set: the match words only (`leaf`, `ws` and `out` null).  Returns a
// cudaError_t; the launch is asynchronous on `stream`.
extern "C" int xtime_cam_match(int dtype, int mode, const void* q,
                               const void* low, const void* high,
                               const float* leaf, const int32_t* tile_mask,
                               const float* bias, int B, int R, int F, int C,
                               int r_blk, int f_blk, int rows_per_split,
                               float* ws, float* out, uint32_t* bits,
                               void* stream_ptr) {
  if (bad_launch(B, R, F, C, r_blk, f_blk, rows_per_split, leaf, ws, out)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
#define XTIME_LAUNCH(T, CELL)                                               \
  launch<T, CELL>(q, low, high, leaf, tile_mask, B, R, F, C, r_blk, f_blk, \
                  rows_per_split, ws, bits, stream)
  if (dtype == 0 && mode == 0) err = XTIME_LAUNCH(uint8_t, Direct);
  if (dtype == 0 && mode == 1) err = XTIME_LAUNCH(uint8_t, Inclusive);
  if (dtype == 1 && mode == 0) err = XTIME_LAUNCH(uint16_t, Direct);
  if (dtype == 1 && mode == 1) err = XTIME_LAUNCH(uint16_t, Inclusive);
  if (dtype == 2 && mode == 0) err = XTIME_LAUNCH(int32_t, Direct);
  if (dtype == 2 && mode == 1) err = XTIME_LAUNCH(int32_t, Inclusive);
  if (dtype == 2 && mode == 2) err = XTIME_LAUNCH(int32_t, MsbLsb);
  if (dtype == 2 && mode == 3) err = XTIME_LAUNCH(int32_t, TwoCycle);
#undef XTIME_LAUNCH
  if (err != cudaSuccess || out == nullptr) return err;
  return reduce_splits(ws, bias, out, R, rows_per_split, B, C, stream);
}

extern "C" const char* xtime_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
