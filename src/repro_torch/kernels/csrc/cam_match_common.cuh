// Shared by the CAM-match kernels (cam_match.cu, cam_match_soft.cu): the
// block shape, the launch checks, the shared-memory layout, the staging of
// the block's queries, of a chunk's cell lists and of its leaf rows, the
// walk over one row's listed cells and the fixed-order reduction of the
// per-split partials.  The uint16/int32 hard kernel and the soft kernel
// differ only in what a lane does per listed cell and in how a chunk's
// leaf product is taken; the uint8 kernel (bit-parallel match words) keeps
// the constants, the launch checks and the reduction, and walks its own
// way (cam_match.cu).  Every kernel adds a chunk's matched rows in
// ascending order from +0 and each chunk once into its split's partial,
// so the reduction below gives the same bits whichever kernel ran.
//
// Tables of any width: a block stages its queries [feature][query] for the
// first `window` features, as many as fit beside the chunk area and the
// kernel's own bytes (all of them up to F_pad = 6,400 uint8, 3,200 uint16,
// 1,536 int32, 1,408 soft).  A wider table launches the kernel's kWide
// instance, which reads a listed cell's query past the window from device
// memory instead (`query_at`), as the walk reads cells past kStagedCells.
// The compare is the same whichever memory the query came from, so the
// results do not depend on the window.
//
// The cell list (kernels/ops.py `binding_cells`) holds each table row's
// non-wildcard cells in ascending feature order, in K slots a row:
//   count (R,) int32, feat (R, K) uint16, lo / hi (R, K) in the table dtype.
// A wildcard cell matches every query bin (hard) or has log-score exactly 0
// (soft), so leaving it out is exact; a never-match padding row is listed as
// its one first cell.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // rows per chunk: the unit of the leaf sum order
constexpr int kQueries = 32;  // queries per block: one per lane
constexpr int kQStride = kQueries + 1;  // staged query row: conflict-free
constexpr int kStagedCells = 8;  // cells of a row staged (depth 8); the rest read from global
constexpr int kCellStride = kStagedCells + 1;  // odd: threads on 32 rows hit 32 banks
static_assert(kThreads % kChunk == 0 && kStagedCells % (kThreads / kChunk) == 0,
              "the staging gives each row the same number of threads and slots");
// A tile of at most this many queries walks (row, query) pairs, a thread
// each, instead of a row a warp with a lane per query: the latter would
// leave most lanes idle (B = 1, a ragged last tile).
constexpr int kPairWalkQueries = 8;
constexpr int kLeafCols = 32;  // leaf channels staged at a time
constexpr int kMaxSmem = 232448;  // bytes a block may use (227 KB)
constexpr unsigned kFull = 0xffffffffu;

// The checks both C entries make before a launch: shapes that tile, and
// `ws`/`out` given together, with a leaf matrix.
inline bool bad_launch(int B, int R, int F, int C, int K, int rows_per_split,
                       const float* leaf, const float* ws, const float* out) {
  return B <= 0 || R <= 0 || F <= 0 || K <= 0 || rows_per_split <= 0 ||
         rows_per_split % kChunk != 0 || (out != nullptr) != (ws != nullptr) ||
         (out != nullptr && (leaf == nullptr || C <= 0));
}

// One block per (32-query tile, row split).
inline dim3 match_grid(int B, int R, int rows_per_split) {
  return dim3((B + kQueries - 1) / kQueries, (R + rows_per_split - 1) / rows_per_split);
}

template <typename T>
struct CellArgs {
  const int32_t* count;
  const uint16_t* feat;
  const T* lo;
  const T* hi;
  int K;
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory of one block, in this order: the queries
// [feature][query] of the first window(F) features (x kQStride of T); one
// area that holds a chunk's staged cell lists and, once its compares are
// done, its staged leaf rows; then `extra` bytes of the kernel's own (match
// words, or scores).  The window is F where F fits, else as many features
// as fill the block's 227 KB.
template <typename T>
struct Layout {
  static constexpr size_t cells =
      align16(kChunk * 4) + align16(kChunk * kCellStride * 2) +
      2 * align16(kChunk * kCellStride * sizeof(T));
  static constexpr size_t leaf = kChunk * kLeafCols * 4;
  static constexpr size_t chunk = cells > leaf ? cells : leaf;
  __host__ __device__ static int window(int F, size_t extra) {
    const size_t room = ((size_t)kMaxSmem - chunk - extra) & ~size_t(15);
    const size_t fit = room / (kQStride * sizeof(T));
    return (size_t)F < fit ? F : (int)fit;
  }
  __host__ __device__ static size_t queries(int F, size_t extra) {
    return align16((size_t)window(F, extra) * kQStride * sizeof(T));
  }
  __host__ __device__ static size_t bytes(int F, size_t extra) {
    return queries(F, extra) + chunk + extra;
  }
};

// A chunk's staged cell lists, carved from the chunk area.
template <typename T>
struct Staged {
  int32_t* cnt;
  uint16_t* feat;
  T* lo;
  T* hi;
  __device__ explicit Staged(unsigned char* p) {
    cnt = reinterpret_cast<int32_t*>(p);
    p += align16(kChunk * 4);
    feat = reinterpret_cast<uint16_t*>(p);
    p += align16(kChunk * kCellStride * 2);
    lo = reinterpret_cast<T*>(p);
    p += align16(kChunk * kCellStride * sizeof(T));
    hi = reinterpret_cast<T*>(p);
  }
};

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

// The block's queries of features [0, Fs) into s_q[f * kQStride + b]
// (padding lanes 0), with coalesced loads.  Readers wait for a later
// barrier.
template <typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, T* s_q,
                                              int F, int Fs, int q0, int nq) {
  for (int i = threadIdx.x; i < kQueries * Fs; i += kThreads) {
    const int b = i / Fs, f = i % Fs;
    s_q[f * kQStride + b] = b < nq ? q[(size_t)(q0 + b) * F + f] : T(0);
  }
}

// Query b of the tile at feature f: staged below the window Fs; past it
// (kWide only) from device memory, 0 for a padding lane.  Without kWide
// the window is the whole width and this is the staged read alone.
template <bool kWide, typename T>
__device__ __forceinline__ T query_at(const T* s_q, const T* __restrict__ q, int F,
                                      int Fs, int q0, int nq, int f, int b) {
  if (!kWide || f < Fs) return s_q[f * kQStride + b];
  return b < nq ? q[(size_t)(q0 + b) * F + f] : T(0);
}

// The counts and first min(K, kStagedCells) cells of rows [r0, r0 + nr):
// thread t copies row t % kChunk's slots t / kChunk, + kThreads / kChunk,
// ... (no division), all its loads issued before its stores: one trip to
// memory.  Between two barriers, as every staging.
template <typename T>
__device__ __forceinline__ void stage_cells(const CellArgs<T>& g, const Staged<T>& s,
                                            int r0, int nr) {
  constexpr int kStep = kThreads / kChunk, kIters = kStagedCells / kStep;
  const int r = threadIdx.x % kChunk, k0 = threadIdx.x / kChunk;
  const int ks = r < nr ? min(g.K, kStagedCells) : 0;
  const size_t row = (size_t)(r0 + r) * g.K;
  uint16_t f[kIters];
  T lo[kIters], hi[kIters];
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int k = k0 + j * kStep;
    if (k < ks) {
      f[j] = g.feat[row + k];
      lo[j] = g.lo[row + k];
      hi[j] = g.hi[row + k];
    }
  }
  const int cnt = (k0 == 0 && r < nr) ? g.count[r0 + r] : 0;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const int k = k0 + j * kStep;
    if (k < ks) {
      s.feat[r * kCellStride + k] = f[j];
      s.lo[r * kCellStride + k] = lo[j];
      s.hi[r * kCellStride + k] = hi[j];
    }
  }
  if (k0 == 0 && r < nr) s.cnt[r] = cnt;
}

// fn(feature, lo, hi) for each listed cell of chunk row r, in ascending
// feature order: the staged ones from shared memory, any beyond
// kStagedCells from the list in device memory.  When every lane of a warp
// walks the same row, each read is a broadcast and the trip count uniform.
template <typename T, typename Fn>
__device__ __forceinline__ void walk_row(const CellArgs<T>& g, const Staged<T>& s,
                                         int r0, int r, Fn&& fn) {
  const int n = s.cnt[r];
  const int ns = min(n, kStagedCells);
  for (int k = 0; k < ns; ++k) {
    const int i = r * kCellStride + k;
    fn(int(s.feat[i]), s.lo[i], s.hi[i]);
  }
  for (int k = kStagedCells; k < n; ++k) {
    const size_t i = (size_t)(r0 + r) * g.K + k;
    fn(int(g.feat[i]), g.lo[i], g.hi[i]);
  }
}

// Channels [c0, c0 + cw) of the chunk's leaf rows into s_leaf[r * cw + c],
// coalesced; only rows with `want(r)`.
template <typename Want>
__device__ __forceinline__ void stage_leaf(const float* __restrict__ leaf, float* s_leaf,
                                           int C, int r0, int nr, int c0, int cw,
                                           Want&& want) {
  for (int i = threadIdx.x; i < nr * cw; i += kThreads) {
    const int r = i / cw, c = i % cw;
    if (want(r)) s_leaf[i] = leaf[(size_t)(r0 + r) * C + c0 + c];
  }
}

// Raises the block's dynamic shared-memory limit where it passes the 48 KB
// default; refuses what no block can have.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// out[b, c] = ws[0, b, c] + ws[1, b, c] + ... (+ bias[c]), in split order.
// One warp an output: lane l loads splits l, l + 32, ..., 256 splits a trip
// to memory, and every lane adds them in split order through shuffles.
// Splits past the last are +0, which leaves the sum as it is: no partial
// is -0 (each starts at +0 and only has terms added).
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads)
reduce_splits_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                     float* __restrict__ out, int splits, int B, int C) {
  constexpr int kGroups = 8;  // groups of 32 splits a trip
  const size_t n = (size_t)B * C;
  const size_t i = ((size_t)blockIdx.x * kReduceThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;  // whole warps
  float acc = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32 * kGroups) {
    float v[kGroups];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int s = s0 + g * 32 + lane;
      v[g] = s < splits ? ws[(size_t)s * n + i] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float x = __shfl_sync(kFull, v[g], k);
        acc = (s0 == 0 && g == 0 && k == 0) ? x : acc + x;  // ws[0] first, as is
      }
    }
  }
  if (bias != nullptr) acc += bias[i % C];
  if (lane == 0) out[i] = acc;
}

inline cudaError_t reduce_splits(const float* ws, const float* bias, float* out,
                                 int R, int rows_per_split, int B, int C,
                                 cudaStream_t stream) {
  const int splits = (R + rows_per_split - 1) / rows_per_split;
  const size_t warps = (size_t)B * C, per_block = kReduceThreads / 32;
  reduce_splits_kernel<<<(unsigned)((warps + per_block - 1) / per_block), kReduceThreads, 0,
                         stream>>>(ws, bias, out, splits, B, C);
  return cudaGetLastError();
}

}  // namespace
