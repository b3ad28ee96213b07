// X-TIME CAM search + leaf accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_cam_match_kernel`, launched by
// `cam_match_pallas` (src/repro/kernels/cam_match.py), for the four hard
// cell modes and for the soft mode's exact tau = 0 limit:
//
//     match[b, r] = AND_f cell(q[b, f], low[r, f], high[r, f])
//     out[b, c]   = SUM_r match[b, r] * leaf[r, c]   (+ bias[c], once)
//
// Every kernel here walks a row's non-wildcard cells only, read from the
// per-row cell list (cam_match_common.cuh) instead of the dense tables: a
// wildcard cell matches every query bin, and a compiled depth-8 table lists
// 4.4 cells a row on average, at most 8, of its 256 columns (a never-match
// padding row lists one).  All keep one float order, which depends on R
// alone: within each 128-row chunk a query's sum starts at +0 and adds its
// matched rows' leaf values in ascending row order; each chunk's sum is
// added once, chunks ascending, to the partial of its 1024-row split (a
// chunk with no match adds +0 and may be skipped); a second kernel sums the
// splits in index order and adds `bias`.  No float atomics and no tensor
// cores: every term is `leaf` or nothing, so the result is bit-identical
// run to run, fused bias against bias added afterwards, B = 1 against a
// row of a batch, packed uint8/uint16 tables against int32 ones, and the
// soft mode at tau = 0 (float32 tables, the indicator q > lo && q < hi)
// against the int32 `direct` mode.
//
// Bit-parallel match words (`cam_match_u8_kernel`, `cam_match_bp_kernel`).
// A block (or a cluster of blocks, below) owns one 32-query tile and
// builds, once, in shared memory, a table per feature the list names
// (`CellList.span` of them) from which
// one thread forms a row's 32-query word: the AND over the row's listed
// cells (f, lo, hi) of GE[f][.] & ~GE[f][.], GE[f][x] being the tile's
// queries at or above x.  Each warp owns whole 1024-row splits (strided
// over the grid's blocks, so every tile's blocks walk the same rows at
// once and share them in L2): a lane forms the words of rows lane, lane +
// 32, lane + 64, lane + 96 of each 128-row chunk, `transpose32` turns the
// four 32-row groups of words into each query's row masks, and lane b adds
// query b's matched leaf rows (set bits, ascending) into registers (its
// split's partials too, up to 8 channels), then into its own slice of the
// [splits, B, C] workspace: no block barrier after the tables are built.
// Each cell is a mode's two halves, lower(q, lo) (monotone non-decreasing
// in q) and upper(q, hi) (non-increasing), and a tile takes one of two
// routes to them, chosen per tile with a block-uniform test:
//   * value route: where every staged query of the tile is an integer bin
//     in [0, 255], GE[f][v] for v in [0, 256] (GE[f][256] = 0), built with
//     __match_any_sync (the lanes of equal bins) and a suffix OR over v.
//     Each half is then one lookup: lower = GE[L], upper = ~GE[H], L and H
//     the bound clamped to the bins (tests/test_torch_rankmatch.py proves
//     each mode's half equal to that lookup, msb_lsb and two_cycle included,
//     on every (q, bound) in [-300, 300]^2 and on random int32s).  uint8
//     lists read one packed word a cell, feat | lo << 16 | hi << 24
//     (`CellList.words`); uint16, int32 and float32 lists one word of the
//     two lookups' offsets in the tables, L + f * kGeStride | (H + f *
//     kGeStride) << 16, packed at bind with the bound clamped (the integer
//     lists' hi + 1, floor(lo) + 1 and ceil(hi) + 1 for float32, so one word
//     serves every mode: an exclusive upper half reads one word below).
//     Two shared loads and a LOP3 a cell and 32 queries, where a lane a
//     query took ~10 warp instructions a cell.
//   * rank route: any other tile (bins past 255, negative or non-integer
//     queries) and lists without words: per feature the tile's distinct
//     query values sorted (padded to 32 with the type's largest value) and
//     GE over their ranks, GE[f][33]; a bound becomes a rank by a binary
//     search of six steps with the mode's own half as the predicate, so no
//     half needs more than its monotonicity (the same test proves it).
// A float32 query that is NaN or infinite in any feature matches no row,
// as in the plain version, where every cell, a wildcard one too, compares
// false against it; a pre-pass (`live_tiles_kernel`) finds such queries
// once a tile, and they are dropped from the tile's words.
//
// Past one block's window (`kMaxWindow` = 223 features of value tables,
// `kRankWindow` = 893 of rank tables, in 227 KB) a thread-block cluster
// serves a tile (the kernels' kCluster instances): n = ceil(span / window)
// blocks along the grid's y, at most `kMaxMembers` = 8 (the portable
// cluster size: 1,784 features of value tables, 7,144 of rank tables).
// Member r builds the tables of features [r * window, (r + 1) * window),
// the cluster syncs, every member's warps walk their own splits as one
// block's do and read a cell's two lookups from the member holding its
// feature through distributed shared memory (`map_shared_rank`; their own
// window's from their own tables), and the cluster syncs again before any
// member exits.  Only where a table word lives changes: the words, the
// transpose and the leaf sums are one block's, so the results are
// bit-identical.  uint8 words carry the feature (member f / 223); the other
// lists carry window words, the offsets within the member and the member
// (`ops.window_words`).  Past eight windows the lane-per-query kernel
// (`cam_match_kernel`) runs: one block per (32-query tile, split) stages
// its queries [feature][query] and walks 128-row chunks, a warp a row and
// a lane a query, `__ballot_sync` giving the row's word (a tile of at most
// 8 queries gives each thread a (row, query) pair instead), then stages
// the chunk's matched leaf rows and adds each query's in ascending order.
// It takes uint8 lists of span over 1,784 and the others of span over
// 7,144 or without words past 1,784 (F_pad 8,064 models), and any list
// with `walk` set; a table wider than its staged query window runs its
// kWide instance, which reads the queries of cells past the window from
// device memory.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256): the bytes of the cell list (the packed words the value route
// reads), the matched leaf rows, the queries and the outputs, against the
// operations the least work needs: the value route's own count — two
// lookups and an AND per listed cell and 32-query tile, the tables (257
// words a listed feature and tile) and one add per matched row and query —
// bytes-bound (~0.008 ms) up to B ~ 512; chip_smoke.py counts it and
// prints beside it the former count, a compare and an AND per binding
// bound and query (0.0898 ms at B = 256), which the words beat 32 to 1.
//
// Measured (chip_smoke.py phase 5, L2 flushed, NVIDIA H100 80GB HBM3,
// 700.00 W): the lane-per-query design took 0.0819 / 1.3146 / 5.0377 ms at
// B = 1 / 256 / 1024 for uint8, bound by its integer issue rate, 1.3830
// (uint16 direct) to 1.9864 ms (int32 two_cycle) at B = 256, and the soft
// kernel's former tau = 0 instance 2.0859; the bit-parallel kernels take
// 0.0456-0.0476 / 0.1480-0.1536 / 0.4579-0.4732 ms for uint8, 0.1370-0.1522
// ms for every uint16/int32 mode and 0.1416 for tau = 0 (its pre-pass
// included) at B = 256 on the value route (~6% of the bytes bound: the
// split walk, not the cells, is what is left), and 0.41-0.52 ms on the rank
// route (the same calls without the words: twelve dependent shared reads a
// cell, random banks) (PERF.md).
// Two of the design's choices came from the card on the way: a branch per listed cell serialised the
// shared-memory lookups, and one warp's split of eight chunks at B = 1
// waits on memory unless the next chunk's cells are loaded before this
// chunk's leaf rows are added.  Past one block's window, comparing the
// features from 223 on against the queries in device memory (a loop over
// the tile's queries a cell) took 0.5560 ms at F_pad 8,064, R = 16,384, B
// = 256 on the same card, against the lane-per-query kernel's 0.2211; the
// cluster holds every feature's tables in its members' shared memory
// instead.  Its remote lookups are what it waits on
// (src/repro_torch/tools/cluster_probe.py): on the 968-feature model at R
// = 1M, B = 256 (uint8) it took 0.8900 ms, the same code with every lookup
// sent to its own rank 0.3708 and to its own shared memory 0.2939, the
// builds alone 0.0508; reading a block's own window's lookups from its own
// tables gained nothing (0.9025) (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cam_match_common.cuh"  // the block shape, the cell list and its walk

namespace {

namespace cg = cooperative_groups;

// Compares run on 32-bit values: zero-extended for the unsigned tables
// (so uint8 never sign-extends), signed for int32, float32 as it is.
template <typename T> struct Wide;
template <> struct Wide<uint8_t> { using type = uint32_t; };
template <> struct Wide<uint16_t> { using type = uint32_t; };
template <> struct Wide<int32_t> { using type = int32_t; };
template <> struct Wide<float> { using type = float; };

// Cell functors, each the AND of its lower half (monotone non-decreasing
// in q) and its upper half (non-increasing); kInclusiveHi: the upper half
// is q <= hi, so the value route reads GE one place higher.  The torch
// versions are repro_torch/core/precision.py.
struct Direct {
  static constexpr bool kInclusiveHi = false;
  template <typename W> __device__ __forceinline__ static bool lower(W q, W lo) { return lo <= q; }
  template <typename W> __device__ __forceinline__ static bool upper(W q, W hi) { return q < hi; }
};

struct Inclusive {
  static constexpr bool kInclusiveHi = true;
  template <typename W> __device__ __forceinline__ static bool lower(W q, W lo) { return lo <= q; }
  template <typename W> __device__ __forceinline__ static bool upper(W q, W hi) { return q <= hi; }
};

// Eq. 3 on 4-bit nibbles.  `>>` on int32 is arithmetic, as in the
// reference, so negative bounds of perturbed tables split the same way.
struct MsbLsb {
  static constexpr bool kInclusiveHi = false;
  __device__ __forceinline__ static bool lower(int32_t q, int32_t lo) {
    const int32_t qm = q >> 4, ql = q & 15, tlm = lo >> 4, tll = lo & 15;
    return ((qm >= tlm + 1) || (ql >= tll)) && (qm >= tlm);
  }
  __device__ __forceinline__ static bool upper(int32_t q, int32_t hi) {
    const int32_t qm = q >> 4, ql = q & 15, thm = hi >> 4, thl = hi & 15;
    return ((qm < thm) || (ql < thl)) && (qm < thm + 1);
  }
};

// Table I: cycle 1 evaluates the OR brackets, cycle 2 the MSB terms; the
// match line only discharges, so the result is the AND of both cycles,
// regrouped here by bound.
struct TwoCycle {
  static constexpr bool kInclusiveHi = false;
  __device__ __forceinline__ static bool lower(int32_t q, int32_t lo) {
    const int32_t qm = q >> 4, ql = q & 15, tlm = lo >> 4, tll = lo & 15;
    return (((qm - 1) >= tlm) || (ql >= tll)) && (qm >= tlm);
  }
  __device__ __forceinline__ static bool upper(int32_t q, int32_t hi) {
    const int32_t qm = q >> 4, ql = q & 15, thm = hi >> 4, thl = hi & 15;
    return ((qm < thm) || (ql < thl)) && ((qm - 1) < thm);
  }
};

// The soft cell's exact tau = 0 limit on float32 tables: inside (lo, hi).
struct Indicator {
  static constexpr bool kInclusiveHi = false;
  __device__ __forceinline__ static bool lower(float q, float lo) { return q > lo; }
  __device__ __forceinline__ static bool upper(float q, float hi) { return q < hi; }
};

template <typename Cell, typename W>
__device__ __forceinline__ bool cell_match(W q, W lo, W hi) {
  return Cell::lower(q, lo) && Cell::upper(q, hi);
}

// Bit b set for each query of the tile below nq.
__device__ __forceinline__ uint32_t valid_queries(int nq) {
  return nq == kQueries ? kFull : (1u << nq) - 1u;
}

// The tile's queries that can match a row: `live` (the float32 tiles'
// words, from live_tiles_kernel) or, without it, those below nq.
__device__ __forceinline__ uint32_t live_queries(const uint32_t* __restrict__ live, int tile,
                                                 int nq) {
  return live != nullptr ? __ldg(live + tile) : valid_queries(nq);
}

// grid = ceil(B / 32); block = kQueries warps, warp b query b.  live[tile]
// = the float32 tile's queries whose every feature is finite (a NaN or
// infinite query compares false against every cell, wildcards included,
// so it matches no row): once a tile, ahead of the match kernel, whose
// every block reads it.  Its loads are what it waits on: a warp a query,
// 16-byte loads, eight in flight a lane.
constexpr int kLiveThreads = kQueries * 32;
__global__ void __launch_bounds__(kLiveThreads)
live_tiles_kernel(const float* __restrict__ q, int B, int F, uint32_t* __restrict__ live) {
  const int lane = threadIdx.x % 32, b = threadIdx.x / 32;
  const int q0 = blockIdx.x * kQueries, nq = min(kQueries, B - q0);
  const bool quads = F % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  bool ok = b < nq;
  if (ok) {
    const float* row = q + (size_t)(q0 + b) * F;
    if (quads) {
#pragma unroll 8
      for (int i = lane; i < F / 4; i += 32) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row) + i);
        ok &= isfinite(v.x) && isfinite(v.y) && isfinite(v.z) && isfinite(v.w);
      }
    } else {
#pragma unroll 8
      for (int f = lane; f < F; f += 32) ok &= isfinite(__ldg(row + f));
    }
  }
  const uint32_t mine = __all_sync(kFull, ok) ? 1u << b : 0u;
  __shared__ uint32_t words[kQueries];
  if (lane == 0) words[b] = mine;
  __syncthreads();
  if (b == 0) {
    const uint32_t w = words[lane];
    const uint32_t all = __reduce_or_sync(kFull, w);
    if (lane == 0) live[blockIdx.x] = all;
  }
}

// -- the lane-per-query kernel: lists past the tables' window ----------------

// grid = (ceil(B / 32), splits); block = kThreads; dynamic shared memory
// Layout<T>::bytes(F, kMatchBytes); kWide where the query window is not
// the whole width.
//   q      (B, F) table dtype     cells: the table's cell list, (R, K)
//   leaf   (R, C) float32 or null
//   ws     [splits, B, C] partials or null
//   bits   [ceil(B / 32), R] match words (bit b = query 32*x + b) or null
//   scores (B, R) float32 0 / 1 (float32 tables) or null
//   live   [ceil(B / 32)] the float32 tiles' live queries, else null
constexpr size_t kMatchBytes = (kChunk + kQueries * (kChunk / 32) + 4) * 4;

// Blocks an SM holds: eight (all its threads) for packed tables; shared
// memory holds int32 and float32 ones to four.  ptxas fits the registers.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 8;

template <typename T, typename Cell, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
cam_match_kernel(const T* __restrict__ q, CellArgs<T> cells,
                 const float* __restrict__ leaf, int B, int R, int F, int C,
                 int rows_per_split, float* __restrict__ ws,
                 uint32_t* __restrict__ bits, float* __restrict__ scores,
                 const uint32_t* __restrict__ live_words) {
  using W = typename Wide<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  const int Fs = Layout<T>::window(F, kMatchBytes);
  unsigned char* area = smem + Layout<T>::queries(F, kMatchBytes);
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
  stage_queries(q, s_q, F, Fs, q0, nq);
  const uint32_t live = live_queries(live_words, q_tile, nq);

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
        bool ok = (live >> b) & 1u;
        walk_row(cells, st, r0, r, [&](int f, T lo, T hi) {
          ok &= cell_match<Cell>(W(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, b)), W(lo), W(hi));
        });
        if (ok) {
          atomicOr(&s_match[r], 1u << b);
          *s_any = 1;
        }
      }
    } else {  // a warp per row, a lane per query
      for (int r = warp; r < nr; r += kWarps) {
        bool ok = (live >> lane) & 1u;
        walk_row(cells, st, r0, r, [&](int f, T lo, T hi) {
          ok &= cell_match<Cell>(W(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, lane)), W(lo),
                                 W(hi));
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
    if (scores != nullptr) {
      for (int p = tid; p < nq * nr; p += kThreads) {
        const int b = p / nr, r = p % nr;
        scores[(size_t)(q0 + b) * R + r0 + r] = (s_match[r] >> b) & 1u ? 1.f : 0.f;
      }
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

// -- bit-parallel match words ------------------------------------------------

constexpr int kBPThreads = 512;  // 16 warps: one block an SM at full width
constexpr int kBPWarps = kBPThreads / 32;
constexpr int kBins = 256;
// Shared memory of a bit-parallel block: kHead words (the last is GE[-1]
// = all ones, the word below feature 0's table), then the tables.  Value
// tables: kGeStride words a feature, GE[0..256] padded so a lane's eight
// words of the suffix pass are two aligned 16-byte loads; word 257 (GE[257]
// = 0) ends an inclusive upper half past the bins and word 259, all ones,
// is GE[-1] of the next feature.  Rank tables: kRankStride words a
// feature, 32 sorted values then GE[0..32].
constexpr int kHead = 4;
constexpr int kGeStride = 260;
constexpr int kMaxWindow = kMaxSmem / (kGeStride * 4);  // 223 features
constexpr int kRankStride = 32 + 33;
constexpr int kRankWindow = (kMaxSmem - kHead * 4) / (kRankStride * 4);  // 893 features
static_assert(kMaxWindow * kGeStride * 4 + kHead * 4 <= kMaxSmem, "the head fits beside");
// A list wider than one block's window runs on a cluster of blocks a tile,
// at most the portable cluster size: member r holds the tables of features
// [r * W, (r + 1) * W), W the route's window, and every member's warps read
// a cell's lookups from the member of its feature (distributed shared
// memory).  Window words (`ops.window_words`, uint16/int32/float32 lists):
// the lower lookup's offset in the member's tables | (H - L + 256) << 16 |
// member << 26.
constexpr int kMaxMembers = 8;
constexpr int kDeltaBias = 256;
static_assert(kMaxMembers <= 8 && (kMaxWindow - 1) * kGeStride + 257 < (1 << 16),
              "a window word holds the member in 3 bits and the offset in 16");

// Where a block's tables come from: one block a tile holds features [0,
// span); member `rank` of a cluster its window [f0, f0 + n) of W features.
struct Window {
  int f0, n;
  uint32_t rank;
};

template <bool kCluster>
__device__ __forceinline__ Window window_of(int span, int W) {
  if constexpr (kCluster) {
    const int r = int(cg::this_cluster().block_rank());
    return Window{r * W, max(0, min(W, span - r * W)), uint32_t(r)};
  } else {
    return Window{0, span, 0u};
  }
}

// Every thread of every member: the tables are built (before the walk),
// or no member reads them any more (before a block exits).
template <bool kCluster>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster) cg::this_cluster().sync();
}

// Member m's copy of `local`, an address in this block's tables, through
// distributed shared memory.
__device__ __forceinline__ const uint32_t* member_tables(const uint32_t* local, int m) {
  return cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(local), m);
}

// Feature f's tables (`stride` words a feature, W features a window): in
// this block's shared memory, or in member f / W's.
template <bool kCluster>
__device__ __forceinline__ const uint32_t* feature_tables(const uint32_t* tab, int f, int W,
                                                          int stride) {
  if constexpr (kCluster) {
    const int m = f / W;
    return member_tables(tab + (f - m * W) * stride, m);
  } else {
    return tab + f * stride;
  }
}

template <typename T>
struct BPArgs {
  const T* q;               // (B, F)
  const int32_t* count;     // (R,)
  const uint16_t* feat;     // (R, K)
  const T* lo;              // (R, K)
  const T* hi;              // (R, K)
  const uint32_t* words;    // (R, K) packed cells (the value route's) or null
  int K;
  const float* leaf;        // (R, C) or null
  int B, R, F, C, rows_per_split;
  int span;                 // features the tables hold: the list's largest + 1
  float* ws;                // [splits, B, C] partials or null
  uint32_t* bits;           // [ceil(B / 32), R] match words or null
  float* scores;            // (B, R) 0 / 1 or null
  const uint32_t* live;     // [ceil(B / 32)] the float32 tiles' live queries, else null
};

// Whether every query of the tile is an integer bin in [0, 255] at the
// features [0, span) the tables cover: the value route's test.  Block-wide.
template <typename T>
__device__ __forceinline__ bool on_bins(const T* __restrict__ q, int F, int span, int q0,
                                        int nq) {
  bool ok = true;
  for (int i = threadIdx.x; i < nq * span; i += blockDim.x) {
    const T x = q[(size_t)(q0 + i / span) * F + i % span];
    if constexpr (std::is_same<T, float>::value) {
      ok &= x >= 0.f && x <= 255.f && x == rintf(x);
    } else if constexpr (std::is_signed<T>::value) {
      ok &= x >= 0 && x <= 255;
    } else {
      ok &= x <= 255u;
    }
  }
  return __syncthreads_and(ok) != 0;
}

// The value tables GE[f][v] (bit b: q[q0 + b][f] >= v) for features [0, W),
// v in [0, 256], into ge[f * kGeStride + v] (GE[f][256..258] = 0, word 259
// and ge[-1] all ones); the tile's queries are bins in [0, 255].
template <typename T>
__device__ __forceinline__ void build_bitmaps(uint32_t* ge, const T* __restrict__ q, int F,
                                              int W, int q0, int nq) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4* ge4 = reinterpret_cast<uint4*>(ge);
  constexpr int kQuads = kGeStride / 4;
  for (int i = threadIdx.x; i < W * kQuads; i += kBPThreads) {
    ge4[i] = make_uint4(0u, 0u, 0u, i % kQuads == kQuads - 1 ? kFull : 0u);
  }
  if (threadIdx.x == 0) ge[-1] = kFull;
  __syncthreads();
  // EQ[f][v]: the lanes of equal bins, one store per bin (padding lanes
  // take a bin of their own and store nothing); eight features' bins are
  // loaded before any is grouped
  for (int f0 = warp; f0 < W; f0 += 8 * kBPWarps) {
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = f0 + i * kBPWarps;
      v[i] = lane < nq && f < W ? int(__ldg(q + (size_t)(q0 + lane) * F + f)) : kBins;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = f0 + i * kBPWarps;
      const uint32_t peers = __match_any_sync(kFull, v[i]);
      if (lane < nq && f < W && lane == __ffs(peers) - 1) ge[f * kGeStride + v[i]] = peers;
    }
  }
  __syncthreads();
  // GE[f][v] = OR of EQ[f][u] over u >= v: lane l holds v in [8l, 8l + 8),
  // ORs them downwards, then takes the OR of every lane above it
  for (int f = warp; f < W; f += kBPWarps) {
    uint4* g = ge4 + f * kQuads + 2 * lane;
    uint4 lo = g[0], hi = g[1];
    hi.z |= hi.w;
    hi.y |= hi.z;
    hi.x |= hi.y;
    lo.w |= hi.x;
    lo.z |= lo.w;
    lo.y |= lo.z;
    lo.x |= lo.y;
    uint32_t from = lo.x;  // OR over lanes >= this one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, from, d);
      if (lane + d < 32) from |= o;
    }
    uint32_t above = __shfl_down_sync(kFull, from, 1);
    if (lane == 31) above = 0u;
    lo.x |= above; lo.y |= above; lo.z |= above; lo.w |= above;
    hi.x |= above; hi.y |= above; hi.z |= above; hi.w |= above;
    g[0] = lo;
    g[1] = hi;
  }
  __syncthreads();
}

template <typename W>
__device__ __forceinline__ uint32_t bits_of(W x) {
  if constexpr (std::is_same<W, float>::value) {
    return __float_as_uint(x);
  } else {
    return uint32_t(x);
  }
}

// The rank tables' pad value, the type's largest: +inf, INT32_MAX, UINT32_MAX.
template <typename V>
__device__ __forceinline__ uint32_t pad_bits() {
  if constexpr (std::is_same<V, float>::value) {
    return 0x7f800000u;
  } else if constexpr (std::is_signed<V>::value) {
    return 0x7fffffffu;
  } else {
    return 0xffffffffu;
  }
}

// The rank tables for features [0, W) into tab[f * kRankStride ...]: the
// distinct values of the `live` queries, ascending, padded to 32 with the
// type's largest value, then GE[j] = the queries at or above the j-th
// value, j in [0, 32] (0 past the distinct count).  A warp a feature.
template <typename T>
__device__ __forceinline__ void build_ranks(uint32_t* tab, const T* __restrict__ q, int F,
                                            int W, int q0, uint32_t live) {
  using V = typename Wide<T>::type;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool in = (live >> lane) & 1u;
  for (int f = warp; f < W; f += kBPWarps) {
    uint32_t* vals = tab + f * kRankStride;
    uint32_t* ge = vals + 32;
    V x = in ? V(__ldg(q + (size_t)(q0 + lane) * F + f)) : V(0);
    if constexpr (std::is_same<V, float>::value) x = x + 0.f;  // -0 -> +0: one value
    const uint32_t peers = __match_any_sync(kFull, bits_of(x)) & live;
    const bool lead = in && lane == __ffs(peers) - 1;
    const uint32_t leads = __ballot_sync(kFull, lead);
    int rank = 0;  // distinct values below this lane's
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const V y = __shfl_sync(kFull, x, l);
      rank += ((leads >> l) & 1u) && y < x ? 1 : 0;
    }
    const int n = __popc(leads);
    if (lead) {
      vals[rank] = bits_of(x);
      ge[rank] = peers;  // EQ, for the suffix OR below
    }
    __syncwarp();
    uint32_t g = lane < n ? ge[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_down_sync(kFull, g, d);
      if (lane + d < 32) g |= o;
    }
    if (lane >= n) vals[lane] = pad_bits<V>();
    ge[lane] = g;
    if (lane == 0) ge[32] = 0u;
  }
  __syncthreads();
}

// The 32-query word of one listed cell through the rank tables: the count
// of values whose lower half fails (GE of that rank: the queries that
// pass it) and of values whose upper half holds (~GE of that rank), each
// by six steps over the 32 sorted values.  A half that holds for the pad
// value holds for every value, so counting the pads changes nothing: GE
// past the distinct count is 0.  `tf`: the feature's kRankStride words.
template <typename T, typename Cell>
__device__ __forceinline__ uint32_t rank_word(const uint32_t* tf, typename Wide<T>::type lo,
                                              typename Wide<T>::type hi) {
  using V = typename Wide<T>::type;
  const V* v = reinterpret_cast<const V*>(tf);
  const uint32_t* ge = tf + 32;
  int jl = 0, ju = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    jl += Cell::lower(v[jl + s - 1], lo) ? 0 : s;
    ju += Cell::upper(v[ju + s - 1], hi) ? s : 0;
  }
  jl += Cell::lower(v[jl], lo) ? 0 : 1;  // 32 where all 32 values fail
  ju += Cell::upper(v[ju], hi) ? 1 : 0;
  return ge[jl] & ~ge[ju];
}

// Value-route cell decoders: the 32-query word of one packed cell, and
// `idle(rank)`, a word whose lookups stay in member `rank`'s own tables
// (read, and dropped, for the slots past a row's count).
// uint8 lists: feat | lo << 16 | hi << 24.
template <bool kInclusive, bool kCluster>
struct U8Cell {
  __device__ __forceinline__ static uint32_t idle(uint32_t rank) {
    return kCluster ? rank * kMaxWindow : 0u;
  }
  __device__ __forceinline__ static uint32_t word(const uint32_t* ge, uint32_t cw) {
    const int f = int(cw & 0xFFFFu), lo = int((cw >> 16) & 0xFFu), hi = int(cw >> 24);
    const uint32_t* g = feature_tables<kCluster>(ge, f, kMaxWindow, kGeStride);
    return g[lo] & ~g[kInclusive ? hi + 1 : hi];
  }
};

// uint16, int32 and float32 lists, the upper lookup an inclusive half's
// (an exclusive one reads one below): one block's value words, lo | hi <<
// 16; a cluster's window words, lo | (hi - lo + kDeltaBias) << 16 | member
// << 26, both offsets in the member's tables.
template <bool kInclusive, bool kCluster>
struct OffsetCell {
  __device__ __forceinline__ static uint32_t idle(uint32_t rank) {
    return kCluster ? rank << 26 | uint32_t(kDeltaBias) << 16 : 0u;
  }
  __device__ __forceinline__ static uint32_t word(const uint32_t* ge, uint32_t cw) {
    const int lo = int(cw & 0xFFFFu);
    if constexpr (kCluster) {
      const uint32_t* g = member_tables(ge, int(cw >> 26));
      return g[lo] & ~g[lo + int((cw >> 16) & 0x3FFu) - kDeltaBias - (kInclusive ? 0 : 1)];
    } else {
      return ge[lo] & ~ge[int(cw >> 16) - (kInclusive ? 0 : 1)];
    }
  }
};

// Channels a lane keeps its split's partials of in registers; wider
// leaf matrices add each chunk into the workspace instead (the same adds).
constexpr int kRegC = 8;
constexpr int kSlots = 8;  // cells of a row loaded at once

// A chunk's rows r0 + 32j + lane: their counts and first kSlots cell
// words, loaded together (no load waits on another).
struct ChunkCells {
  int n[4];
  uint32_t cw[4][kSlots];
};

template <typename T>
__device__ __forceinline__ void load_chunk(const BPArgs<T>& a, int r0, int nr, int lane,
                                           ChunkCells& c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = 32 * j + lane < nr;
    const size_t r = (size_t)r0 + 32 * j + lane;
    c.n[j] = in ? __ldg(a.count + r) : 0;
    const uint32_t* row = a.words + r * a.K;
    if (in && a.K % 4 == 0 && a.K >= kSlots) {  // two aligned 16-byte loads
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row));
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(row) + 1);
      c.cw[j][0] = x.x; c.cw[j][1] = x.y; c.cw[j][2] = x.z; c.cw[j][3] = x.w;
      c.cw[j][4] = y.x; c.cw[j][5] = y.y; c.cw[j][6] = y.z; c.cw[j][7] = y.w;
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) c.cw[j][k] = in && k < a.K ? __ldg(row + k) : 0u;
    }
  }
}

// The value route's rows: each chunk's packed cells, loaded a chunk ahead.
template <typename T, typename Decode>
struct ValueRows {
  const BPArgs<T>& a;
  const uint32_t* ge;
  uint32_t rank;  // this block's in its cluster (0 alone)
  ChunkCells cells;

  __device__ __forceinline__ void load(int r0, int nr, int lane) {
    load_chunk(a, r0, nr, lane, cells);
  }
  // rows r0 + lane + 32j: their words, over their listed cells
  __device__ __forceinline__ void words(int r0, int nr, int lane, uint32_t live,
                                        uint32_t (&w)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = 32 * j + lane < nr ? live : 0u;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {  // no branch: the lookups overlap
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a slot past the count: lookups in this block's own tables, read and dropped
        const uint32_t cw = k < cells.n[j] ? cells.cw[j][k] : Decode::idle(rank);
        const uint32_t m = Decode::word(ge, cw);
        w[j] &= k < cells.n[j] ? m : kFull;
      }
    }
    const int most = max(max(cells.n[0], cells.n[1]), max(cells.n[2], cells.n[3]));
    for (int k = kSlots; k < most; ++k) {  // rows of more cells: from device memory
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k < cells.n[j]) {
          w[j] &= Decode::word(ge, __ldg(a.words + ((size_t)r0 + 32 * j + lane) * a.K + k));
        }
      }
    }
  }
};

// The rank route's rows: each slot's feature and bounds, the four rows'
// searches side by side (a slot past a row's count is searched in this
// block's own tables and dropped).
template <typename T, typename Cell, bool kCluster>
struct RankRows {
  const BPArgs<T>& a;
  const uint32_t* tab;
  uint32_t rank;  // this block's in its cluster (0 alone)

  __device__ __forceinline__ void load(int, int, int) {}
  __device__ __forceinline__ void words(int r0, int nr, int lane, uint32_t live,
                                        uint32_t (&w)[4]) {
    using V = typename Wide<T>::type;
    int n[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = 32 * j + lane < nr;
      n[j] = in ? __ldg(a.count + r0 + 32 * j + lane) : 0;
      w[j] = in ? live : 0u;
    }
    const int most = max(max(n[0], n[1]), max(n[2], n[3]));
    for (int k = 0; k < most; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool use = k < n[j];
        const size_t i = ((size_t)r0 + 32 * j + lane) * a.K + k;
        const int f = use ? int(__ldg(a.feat + i)) : int(rank) * kRankWindow;
        const V lo = use ? V(__ldg(a.lo + i)) : V(0), hi = use ? V(__ldg(a.hi + i)) : V(0);
        const uint32_t m = rank_word<T, Cell>(
            feature_tables<kCluster>(tab, f, kRankWindow, kRankStride), lo, hi);
        w[j] &= use ? m : kFull;
      }
    }
  }
};

// Lane l holds row l's word (bit b: query b); returns query `lane`'s word
// (bit l: row l).  Five rounds of swapping the off-diagonal blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t m = kFull / ((1u << j) + 1u);  // 0x0000FFFF, 0x00FF00FF, ... 0x55555555
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j)) : ((x & m) | ((y & m) << j));
  }
  return x;
}

// s[c] = SUM over the rows of `m`, ascending, of lrow[r * C + c], from +0:
// one query's chunk, C <= kRegC.
__device__ __forceinline__ void chunk_sums(const float* __restrict__ lrow, int C,
                                           const uint32_t (&m)[4], float (&s)[kRegC]) {
#pragma unroll
  for (int c = 0; c < kRegC; ++c) s[c] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    for (uint32_t mm = m[j]; mm != 0u; mm &= mm - 1u) {
      const float* row = lrow + (size_t)(32 * j + __ffs(mm) - 1) * C;
      if (C == kRegC) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row));
        const float4 y = __ldg(reinterpret_cast<const float4*>(row) + 1);
        s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
        s[4] += y.x; s[5] += y.y; s[6] += y.z; s[7] += y.w;
      } else {
#pragma unroll
        for (int c = 0; c < kRegC; ++c) {
          if (c < C) s[c] += __ldg(row + c);
        }
      }
    }
  }
}

// part[c] += (SUM over the rows of `m`, ascending, of lrow[r * C + c]),
// each sum from +0: one query's chunk, any C, in device memory.
__device__ __forceinline__ void add_rows(const float* __restrict__ lrow, int C,
                                         const uint32_t (&m)[4], float* part) {
  for (int c = 0; c < C; ++c) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      for (uint32_t mm = m[j]; mm != 0u; mm &= mm - 1u) {
        s += __ldg(lrow + (size_t)(32 * j + __ffs(mm) - 1) * C + c);
      }
    }
    part[c] += s;
  }
}

// The splits of this block's warps (warp w of block y owns splits y *
// kBPWarps + w, then every gridDim.y * kBPWarps-th after it), each row's
// word from `rows`: the words out, the leaf sums into the workspace.  A
// chunk's cells are loaded before the previous chunk's leaf rows are added.
template <typename T, typename Rows>
__device__ __forceinline__ void walk_splits(const BPArgs<T>& a, int tile, int q0, int nq,
                                            uint32_t live, Rows& rows) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool in_regs = a.C <= kRegC;
  const int splits = (a.R + a.rows_per_split - 1) / a.rows_per_split;
  for (int sp = blockIdx.y * kBPWarps + warp; sp < splits; sp += gridDim.y * kBPWarps) {
    const int row_begin = sp * a.rows_per_split;
    const int row_end = min(a.R, row_begin + a.rows_per_split);
    // query `lane`'s partials (this lane's alone)
    float* part = a.ws ? a.ws + ((size_t)sp * a.B + q0 + lane) * a.C : nullptr;
    float acc[kRegC];
#pragma unroll
    for (int c = 0; c < kRegC; ++c) acc[c] = 0.f;
    if (part != nullptr && !in_regs && lane < nq) {
      for (int c = 0; c < a.C; ++c) part[c] = 0.f;
    }
    rows.load(row_begin, min(kChunk, row_end - row_begin), lane);
    for (int r0 = row_begin; r0 < row_end; r0 += kChunk) {
      const int nr = min(kChunk, row_end - r0);
      __syncwarp();
      uint32_t w[4];  // rows r0 + lane + 32j
      rows.words(r0, nr, lane, live, w);
      if (r0 + kChunk < row_end) rows.load(r0 + kChunk, min(kChunk, row_end - r0 - kChunk), lane);
      if (a.bits != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (32 * j + lane < nr) a.bits[(size_t)tile * a.R + r0 + 32 * j + lane] = w[j];
        }
      }
      if (a.scores != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (32 * j + lane >= nr) continue;
          for (int b = 0; b < nq; ++b) {
            a.scores[(size_t)(q0 + b) * a.R + r0 + 32 * j + lane] = (w[j] >> b) & 1u ? 1.f : 0.f;
          }
        }
      }
      if (part == nullptr) continue;
      uint32_t m[4];  // query `lane`'s matched rows of each 32-row group
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[j] = __any_sync(kFull, w[j] != 0u) ? transpose32(w[j], lane) : 0u;
      }
      if ((m[0] | m[1] | m[2] | m[3]) == 0u) continue;
      const float* lrow = a.leaf + (size_t)r0 * a.C;
      if (in_regs) {
        float s[kRegC];
        chunk_sums(lrow, a.C, m, s);
#pragma unroll
        for (int c = 0; c < kRegC; ++c) acc[c] += s[c];
      } else {
        add_rows(lrow, a.C, m, part);
      }
    }
    if (part != nullptr && in_regs && lane < nq) {
#pragma unroll
      for (int c = 0; c < kRegC; ++c) {
        if (c < a.C) part[c] = acc[c];
      }
    }
  }
}

// grid = (ceil(B / 32), blocks a tile); block = kBPThreads; dynamic shared
// memory kHead + min(span, 223) * kGeStride words.  uint8 lists of span <=
// 223 on one block a tile, and (kCluster) of span <= kMaxMembers * 223 on
// clusters of ceil(span / 223) blocks along y, a cluster a tile.
template <bool kInclusive, bool kCluster>
__global__ void __launch_bounds__(kBPThreads, 1) cam_match_u8_kernel(const BPArgs<uint8_t> a) {
  extern __shared__ __align__(16) uint32_t tables[];
  uint32_t* ge = tables + kHead;
  const int tile = blockIdx.x, q0 = tile * kQueries;
  const int nq = min(kQueries, a.B - q0);
  const Window w = window_of<kCluster>(a.span, kMaxWindow);
  build_bitmaps(ge, a.q + w.f0, a.F, w.n, q0, nq);
  cluster_sync<kCluster>();
  ValueRows<uint8_t, U8Cell<kInclusive, kCluster>> rows{a, ge, w.rank};
  walk_splits(a, tile, q0, nq, valid_queries(nq), rows);
  cluster_sync<kCluster>();
}

// grid = (ceil(B / 32), blocks a tile); block = kBPThreads; dynamic shared
// memory `table_words` + kHead words.  uint16, int32 (every mode) and
// float32 (tau = 0) lists: on one block a tile where the span fits a
// block's window (value tables where a.words, rank tables else), and
// (kCluster) on clusters of ceil(span / window) blocks along y up to
// kMaxMembers, a cluster a tile (a.words: window words).  A value cluster's
// rank tiles hold kRankWindow features a member, so fewer members fill.
template <typename T, typename Cell, bool kCluster>
__global__ void __launch_bounds__(kBPThreads, 1) cam_match_bp_kernel(const BPArgs<T> a) {
  extern __shared__ __align__(16) uint32_t tables[];
  uint32_t* tab = tables + kHead;
  const int tile = blockIdx.x, q0 = tile * kQueries;
  const int nq = min(kQueries, a.B - q0);
  const uint32_t live = live_queries(a.live, tile, nq);
  // uniform in the block, and in the cluster: every member tests the same queries
  if (a.words != nullptr && on_bins(a.q, a.F, a.span, q0, nq)) {
    const Window w = window_of<kCluster>(a.span, kMaxWindow);
    build_bitmaps(tab, a.q + w.f0, a.F, w.n, q0, nq);
    cluster_sync<kCluster>();
    ValueRows<T, OffsetCell<Cell::kInclusiveHi, kCluster>> rows{a, tab, w.rank};
    walk_splits(a, tile, q0, nq, live, rows);
  } else {
    const Window w = window_of<kCluster>(a.span, kRankWindow);
    build_ranks(tab, a.q + w.f0, a.F, w.n, q0, live);
    cluster_sync<kCluster>();
    RankRows<T, Cell, kCluster> rows{a, tab, w.rank};
    walk_splits(a, tile, q0, nq, live, rows);
  }
  cluster_sync<kCluster>();
}

// Table words a block of the bit-parallel kernels holds: the value tables
// of its window and, for uint16/int32/float32 lists, the rank tables of
// its rank window (its tiles off the bins), whichever is larger.
inline int table_words(int span, bool value, bool ranks) {
  const int v = value ? min(span, kMaxWindow) * kGeStride : 0;
  return max(v, ranks ? min(span, kRankWindow) * kRankStride : 0);
}

// Blocks a tile of a list of this span: one a window of W features.
inline int members(int span, int W) { return (span + W - 1) / W; }

// grid = (ceil(B / 32), blocks a tile), one wave: as many blocks a tile as
// fill the card, no more than give each warp a split.  n > 1: clusters of
// n blocks along y (a cluster a tile), as many a tile as the card holds at
// once; a cluster the card cannot hold is refused, and nothing runs.
template <typename Kernel, typename Args>
cudaError_t launch_words(Kernel kernel, const Args& a, int n, size_t smem,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + kQueries - 1) / kQueries;
  const int splits = (a.R + a.rows_per_split - 1) / a.rows_per_split;
  const int most = (splits + kBPWarps - 1) / kBPWarps;  // blocks a tile with a split a warp
  if (n == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBPThreads, smem);
    }
    if (err != cudaSuccess) return err;
    const int fill = max(1, sms * max(1, per_sm) / tiles);
    kernel<<<dim3(tiles, min(fill, most)), kBPThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = n;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, n);
  cfg.blockDim = dim3(kBPThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int held = 0;  // clusters of n the card holds at once
  err = cudaOccupancyMaxActiveClusters(&held, reinterpret_cast<const void*>(kernel), &cfg);
  if (err != cudaSuccess) return err;
  if (held < 1) return cudaErrorLaunchOutOfResources;
  const int per_tile = min(max(1, held / tiles), (most + n - 1) / n);
  cfg.gridDim = dim3(tiles, per_tile * n);
  void* args[] = {const_cast<Args*>(&a)};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
}

// What every launch takes: the C entry's operands.
struct Launch {
  const void* q;
  const int32_t* count;
  const uint16_t* feat;
  const void* lo;
  const void* hi;
  const uint32_t* words;
  int span, K;
  const float* leaf;
  int B, R, F, C, rows_per_split;
  float* ws;
  uint32_t* bits;
  float* scores;
  uint32_t* live;
  bool walk;  // the lane-per-query kernel at any span (timing, tests)
  cudaStream_t stream;
};

template <typename T>
BPArgs<T> bp_args(const Launch& l) {
  return BPArgs<T>{static_cast<const T*>(l.q), l.count, l.feat, static_cast<const T*>(l.lo),
                   static_cast<const T*>(l.hi), l.words, l.K, l.leaf, l.B, l.R, l.F, l.C,
                   l.rows_per_split, max(1, l.span), l.ws, l.bits, l.scores, l.live};
}

// The lane-per-query kernel; its kWide instance where the staged query
// window is not the whole width.
template <typename T, typename Cell>
cudaError_t launch_lanes(const Launch& l) {
  const CellArgs<T> cells{l.count, l.feat, static_cast<const T*>(l.lo),
                          static_cast<const T*>(l.hi), l.K};
  const T* q = static_cast<const T*>(l.q);
  const size_t smem = Layout<T>::bytes(l.F, kMatchBytes);
  const bool wide = Layout<T>::window(l.F, kMatchBytes) < l.F;
  const auto kernel = wide ? cam_match_kernel<T, Cell, true> : cam_match_kernel<T, Cell, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<match_grid(l.B, l.R, l.rows_per_split), kThreads, smem, l.stream>>>(
      q, cells, l.leaf, l.B, l.R, l.F, l.C, l.rows_per_split, l.ws, l.bits, l.scores, l.live);
  return cudaGetLastError();
}

// The routes, by span alone (kernels/cam_match.py `kernel_route` mirrors
// them).  uint8 lists: the value tables on one block a tile where span <=
// kMaxWindow, on a cluster of ceil(span / kMaxWindow) blocks up to
// kMaxMembers, else the lanes.
template <bool kInclusive>
cudaError_t launch_u8(const Launch& l) {
  const BPArgs<uint8_t> a = bp_args<uint8_t>(l);
  const int n = members(a.span, kMaxWindow);
  if (l.walk || n > kMaxMembers) {
    return launch_lanes<uint8_t, std::conditional_t<kInclusive, Inclusive, Direct>>(l);
  }
  const size_t smem = (size_t)(kHead + table_words(a.span, true, false)) * 4;
  if (a.span <= kMaxWindow) {
    return launch_words(cam_match_u8_kernel<kInclusive, false>, a, 1, smem, l.stream);
  }
  return launch_words(cam_match_u8_kernel<kInclusive, true>, a, n, smem, l.stream);
}

// uint16, int32 and float32 lists: with words (value words to kMaxWindow,
// window words to kMaxMembers windows) ceil(span / kMaxWindow) blocks a
// tile; without (NaN bounds, or the span past the window words') ceil(span
// / kRankWindow); one block a tile alone, a cluster up to kMaxMembers, else
// the lanes.
template <typename T, typename Cell>
cudaError_t launch_bp(const Launch& l) {
  BPArgs<T> a = bp_args<T>(l);
  if (a.span > kMaxMembers * kMaxWindow) a.words = nullptr;
  const int n = members(a.span, a.words ? kMaxWindow : kRankWindow);
  if (l.walk || n > kMaxMembers) return launch_lanes<T, Cell>(l);
  const size_t smem = (size_t)(kHead + table_words(a.span, a.words != nullptr, true)) * 4;
  if (n == 1) return launch_words(cam_match_bp_kernel<T, Cell, false>, a, 1, smem, l.stream);
  return launch_words(cam_match_bp_kernel<T, Cell, true>, a, n, smem, l.stream);
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32, 3 float32.  mode: 0 direct,
// 1 inclusive, 2 msb_lsb, 3 two_cycle (the last two on int32 only), 4 the
// soft mode's tau = 0 indicator (float32 only).  count/feat/lo/hi are the
// table's cell list (R rows, K slots; lo/hi in the table dtype); `words`
// its packed cells (`CellList.words`: uint8 feat | lo << 16 | hi << 24,
// required; the other dtypes' value or window words, or null) and `span`
// its largest feature + 1, which alone chooses the kernel (`launch_u8`,
// `launch_bp`); `walk` non-zero runs the lane-per-query kernel at any span
// instead (to time it, and to hold the routes to it).
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `bits`
// set: the match words only; with `scores` (float32 only): the (B, R)
// scores 0 / 1 only (`leaf`, `ws` and `out` null).  float32 takes `live`,
// ceil(B / 32) words of scratch for its tiles' live queries (the other
// dtypes null).  Returns a cudaError_t; the launches are asynchronous on
// `stream`.
extern "C" int xtime_cam_match(int dtype, int mode, const void* q,
                               const int32_t* count, const uint16_t* feat,
                               const void* lo, const void* hi, const uint32_t* words,
                               int span, int K, const float* leaf, const float* bias, int B,
                               int R, int F, int C, int rows_per_split,
                               float* ws, float* out, uint32_t* bits, float* scores,
                               uint32_t* live, int walk, void* stream_ptr) {
  if (bad_launch(B, R, F, C, K, rows_per_split, leaf, ws, out) || span < 0 || span > F ||
      (dtype == 0 && words == nullptr) || ((mode == 4) != (dtype == 3)) ||
      (scores != nullptr && dtype != 3) || (bits != nullptr && dtype == 3) ||
      ((live != nullptr) != (dtype == 3))) {
    return cudaErrorInvalidValue;
  }
  const Launch l{q, count, feat, lo, hi, words, span, K, leaf, B, R, F, C, rows_per_split,
                 ws, bits, scores, live, walk != 0, static_cast<cudaStream_t>(stream_ptr)};
  if (dtype == 3) {
    live_tiles_kernel<<<(B + kQueries - 1) / kQueries, kLiveThreads, 0, l.stream>>>(
        static_cast<const float*>(q), B, F, live);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && mode == 0) err = launch_u8<false>(l);
  if (dtype == 0 && mode == 1) err = launch_u8<true>(l);
  if (dtype == 1 && mode == 0) err = launch_bp<uint16_t, Direct>(l);
  if (dtype == 1 && mode == 1) err = launch_bp<uint16_t, Inclusive>(l);
  if (dtype == 2 && mode == 0) err = launch_bp<int32_t, Direct>(l);
  if (dtype == 2 && mode == 1) err = launch_bp<int32_t, Inclusive>(l);
  if (dtype == 2 && mode == 2) err = launch_bp<int32_t, MsbLsb>(l);
  if (dtype == 2 && mode == 3) err = launch_bp<int32_t, TwoCycle>(l);
  if (dtype == 3 && mode == 4) err = launch_bp<float, Indicator>(l);
  if (err != cudaSuccess || out == nullptr) return err;
  return reduce_splits(ws, bias, out, R, rows_per_split, B, C, l.stream);
}

extern "C" const char* xtime_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
