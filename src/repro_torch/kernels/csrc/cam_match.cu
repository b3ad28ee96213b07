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
// shapes only).  The AND runs over a row's non-wildcard cells only, read
// from the per-row cell list (cam_match_common.cuh) instead of the dense
// tables: a wildcard cell matches every query bin, and a compiled depth-8
// table lists 4.4 cells a row on average, at most 8, of its 256 columns
// (a never-match padding row lists one).  The block stages its queries
// [feature][query] once, then walks 128-row chunks: it stages the chunk's
// cell lists with coalesced loads, and each warp takes one row at a time
// with a lane per query — the row's cells are broadcasts, `s_q[f][lane]` is
// conflict-free, the trip count is the row's count — and `__ballot_sync`
// gives the row's 32-query match word.  A tile of at most 8 queries (B = 1,
// a ragged last tile) would leave most lanes idle, so there each thread
// takes a (row, query) pair and sets its bit of the row's word with a
// shared-memory atomicOr.  Then the chunk's matched leaf rows are staged
// and each query's matched rows are added in ascending row order (set bits
// of its row mask, `__ffs`), into the block's own slice of a [splits, B, C]
// workspace; a second kernel sums the splits in index order and adds
// `bias`.  No float atomics and no tensor cores: every term
// is `leaf` or nothing, in one fixed order, so the result is bit-identical
// run to run, fused bias against bias added afterwards, packed uint8/uint16
// tables against int32 ones, and the soft kernel at tau = 0 (the same
// chunks and row order) against the int32 `direct` one.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256, uint8): the bytes of the cell list, the matched leaf rows, the
// queries and the outputs (~0.01 ms), against a compare and an AND per
// binding bound and query (5.9 M of them; chip_smoke.py counts both): bytes
// at B = 1, compares from B ~ 64 on.  The per-row walk costs ~10
// instructions of a warp per cell, so the integer issue rate, not memory,
// sets this kernel's pace; byte-SIMD compares of several queries at once
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cam_match_common.cuh"  // the block shape, the cell list and its walk

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

// grid = (ceil(B / 32), splits); block = kThreads; dynamic shared memory
// Layout<T>::bytes(F, kMatchBytes).
//   q     (B, F) table dtype     cells: the table's cell list, (R, K)
//   leaf  (R, C) float32 or null
//   ws    [splits, B, C] partials or null
//   bits  [ceil(B / 32), R] match words (bit b = query 32*x + b) or null
constexpr size_t kMatchBytes = (kChunk + kQueries * (kChunk / 32) + 4) * 4;

// Blocks an SM holds: eight (all its threads) for packed tables; shared
// memory holds int32 ones to four.  ptxas fits the registers to it.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 8;

template <typename T, typename Cell>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
cam_match_kernel(const T* __restrict__ q, CellArgs<T> cells,
                 const float* __restrict__ leaf, int B, int R, int F, int C,
                 int rows_per_split, float* __restrict__ ws,
                 uint32_t* __restrict__ bits) {
  using W = typename Wide<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  unsigned char* area = smem + Layout<T>::queries(F);
  const Staged<T> st(area);
  float* s_leaf = reinterpret_cast<float*>(area);  // after the compares
  uint32_t* s_match = reinterpret_cast<uint32_t*>(area + Layout<T>::chunk);
  uint32_t* s_rowmask = s_match + kChunk;  // [query][32-row group]
  uint32_t* s_any = s_rowmask + kQueries * (kChunk / 32);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q_tile = blockIdx.x;
  const int q0 = q_tile * kQueries;
  const int nq = min(kQueries, B - q0);
  const bool by_pair = nq <= kPairWalkQueries;  // uniform in the block
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  float* part = zeroed_partials(ws, B, C, q0, nq);
  stage_queries(q, s_q, F, q0, nq);

  for (int r0 = row_begin; r0 < row_end; r0 += kChunk) {
    const int nr = min(kChunk, row_end - r0);
    __syncthreads();  // the previous chunk's readers are done
    stage_cells(cells, st, r0, nr);
    for (int r = tid; r < kChunk; r += kThreads) s_match[r] = 0u;
    if (tid == 0) *s_any = 0;
    __syncthreads();

    if (by_pair) {  // a thread per (row, query): rows adjacent across lanes
      for (int p = tid; p < nr * nq; p += kThreads) {
        const int r = p % nr, b = p / nr;
        bool ok = true;
        walk_row(cells, st, r0, r, [&](int f, T lo, T hi) {
          ok &= Cell::match(W(s_q[f * kQStride + b]), W(lo), W(hi));
        });
        if (ok) {
          atomicOr(&s_match[r], 1u << b);
          *s_any = 1;
        }
      }
    } else {  // a warp per row, a lane per query
      for (int r = warp; r < nr; r += kWarps) {
        bool ok = lane < nq;
        walk_row(cells, st, r0, r, [&](int f, T lo, T hi) {
          ok &= Cell::match(W(s_q[f * kQStride + lane]), W(lo), W(hi));
        });
        const uint32_t word = __ballot_sync(kFull, ok);
        if (lane == 0) {
          s_match[r] = word;
          if (word != 0) *s_any = 1;
        }
      }
    }
    __syncthreads();  // s_match, s_any and the cell reads are done
    if (bits != nullptr) {
      for (int r = tid; r < nr; r += kThreads) bits[(size_t)q_tile * R + r0 + r] = s_match[r];
    }
    if (part == nullptr || *s_any == 0) continue;  // no match: every sum is +0

    // each query's row mask, 32 rows a word: warp g transposes rows
    // [32g, 32g + 32) of the match words with one ballot per query
    if (warp < kChunk / 32) {
      const int r = warp * 32 + lane;
      const uint32_t word = r < nr ? s_match[r] : 0u;
      uint32_t mine = 0;
      if (__any_sync(kFull, word != 0)) {
        for (int b = 0; b < kQueries; ++b) {
          const uint32_t m = __ballot_sync(kFull, (word >> b) & 1u);
          if (lane == b) mine = m;
        }
      }
      s_rowmask[lane * (kChunk / 32) + warp] = mine;
    }
    for (int c0 = 0; c0 < C; c0 += kLeafCols) {
      const int cw = min(kLeafCols, C - c0);
      if (c0 > 0) __syncthreads();  // the previous channels' readers are done
      stage_leaf(leaf, s_leaf, C, r0, nr, c0, cw, [&](int r) { return s_match[r] != 0; });
      __syncthreads();
      for (int o = tid; o < nq * cw; o += kThreads) {
        const int b = o / cw, c = o % cw;
        float s = 0.f;
        for (int g = 0; g < kChunk / 32; ++g) {  // rows ascending
          for (uint32_t m = s_rowmask[b * (kChunk / 32) + g]; m != 0; m &= m - 1) {
            s += s_leaf[(g * 32 + __ffs(m) - 1) * cw + c];
          }
        }
        part[b * C + c0 + c] += s;
      }
    }
  }
}

template <typename T, typename Cell>
cudaError_t launch(const void* q, const int32_t* count, const uint16_t* feat,
                   const void* lo, const void* hi, int K, const float* leaf,
                   int B, int R, int F, int C, int rows_per_split, float* ws,
                   uint32_t* bits, cudaStream_t stream) {
  const size_t smem = Layout<T>::bytes(F, kMatchBytes);
  cudaError_t err = allow_smem(cam_match_kernel<T, Cell>, smem);
  if (err != cudaSuccess) return err;
  const CellArgs<T> cells{count, feat, static_cast<const T*>(lo),
                          static_cast<const T*>(hi), K};
  cam_match_kernel<T, Cell><<<match_grid(B, R, rows_per_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), cells, leaf, B, R, F, C, rows_per_split, ws, bits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32.  mode: 0 direct, 1 inclusive,
// 2 msb_lsb, 3 two_cycle (the last two on int32 only).  count/feat/lo/hi
// are the table's cell list (R rows, K slots; lo/hi in the table dtype).
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `bits`
// set: the match words only (`leaf`, `ws` and `out` null).  Returns a
// cudaError_t; the launch is asynchronous on `stream`.
extern "C" int xtime_cam_match(int dtype, int mode, const void* q,
                               const int32_t* count, const uint16_t* feat,
                               const void* lo, const void* hi, int K,
                               const float* leaf, const float* bias, int B,
                               int R, int F, int C, int rows_per_split,
                               float* ws, float* out, uint32_t* bits,
                               void* stream_ptr) {
  if (bad_launch(B, R, F, C, K, rows_per_split, leaf, ws, out)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
#define XTIME_LAUNCH(T, CELL)                                                \
  launch<T, CELL>(q, count, feat, lo, hi, K, leaf, B, R, F, C, rows_per_split, \
                  ws, bits, stream)
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
