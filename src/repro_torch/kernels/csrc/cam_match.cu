// X-TIME CAM search + leaf accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_cam_match_kernel`, launched by
// `cam_match_pallas` (src/repro/kernels/cam_match.py), for the four hard
// cell modes:
//
//     match[b, r] = AND_f cell(q[b, f], low[r, f], high[r, f])
//     out[b, c]   = SUM_r match[b, r] * leaf[r, c]   (+ bias[c], once)
//
// Two kernels.  Both walk a row's non-wildcard cells only, read from the
// per-row cell list (cam_match_common.cuh) instead of the dense tables: a
// wildcard cell matches every query bin, and a compiled depth-8 table lists
// 4.4 cells a row on average, at most 8, of its 256 columns (a never-match
// padding row lists one).  Both keep one float order, which depends on R
// alone: within each 128-row chunk a query's sum starts at +0 and adds its
// matched rows' leaf values in ascending row order; each chunk's sum is
// added once, chunks ascending, to the partial of its 1024-row split (a
// chunk with no match adds +0 and may be skipped); a second kernel sums the
// splits in index order and adds `bias`.  No float atomics and no tensor
// cores: every term is `leaf` or nothing, so the result is bit-identical
// run to run, fused bias against bias added afterwards, B = 1 against a
// row of a batch, packed uint8/uint16 tables against int32 ones, and the
// soft kernel at tau = 0 against the int32 `direct` one.
//
// uint8 tables whose list names features below 223 only (`CellList.span`
// <= 223, every compiled table of xtime-tabular's 130 features;
// `cam_match_u8_kernel`, 'inclusive' and 'direct'): bit-parallel match
// words.  A block owns one 32-query tile and builds, once, in shared
// memory, GE[f][v] = the tile's queries with q[f] >= v for v in [0, 256]
// (GE[f][256] = 0) for the W = span features the list names: __match_any_sync
// groups the lanes of equal bins into EQ[f][v], and a suffix OR over v
// (eight words a lane, then shuffles) turns EQ into GE.  A row's word is
// then the AND over its listed cells (f, lo, hi) of GE[f][lo] & ~GE[f][hi
// + 1] ('inclusive'; GE[f][hi] for 'direct'): one thread forms the 32
// queries' word with two shared loads and a LOP3 a cell, where a lane a
// query took ~10 warp instructions a cell.  The cell list is read as one
// 32-bit word a cell (feat:16 | lo:8 | hi:8, `CellList.words`, packed at
// bind).  Each warp owns whole 1024-row splits: a lane forms the words of
// rows lane, lane + 32, lane + 64, lane + 96 of each 128-row chunk (their
// first eight cells loaded
// together, every slot looked up and those past a row's count dropped: no
// branch between the lookups), a shuffle transpose turns the four 32-row
// groups of words into each query's row masks, and lane b adds query b's
// matched leaf rows (set bits, ascending) into registers (its split's
// partials too, up to 8 channels), then into its own slice of the
// [splits, B, C] workspace: no block barrier after the bitmaps are built.
// A block owns many splits (strided over the grid's blocks, so every
// tile's blocks walk the same rows at once and share them in L2) and
// builds its bitmaps once for all of them.
//
// uint16 and int32 tables, all four modes, and uint8 tables whose list
// names a feature of index 223 or more (`cam_match_kernel`): one block
// per (32-query tile, split) stages its queries [feature][query] and walks
// 128-row chunks: it stages the chunk's cell lists, and each warp takes one
// row at a time with a lane per query, `__ballot_sync` giving the row's
// match word (a tile of at most 8 queries gives each thread a (row, query)
// pair instead and sets its bit with a shared atomicOr); then the chunk's
// matched leaf rows are staged and each query's matched rows are added in
// ascending row order.  A table wider than the staged query window runs
// the kWide instance, which reads the queries of cells past the window from
// device memory.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256): the bytes of the cell list, the matched leaf rows, the queries and
// the outputs, against the operations the least work needs.  For uint8 that
// is the bit-parallel design's own count: two lookups and an AND per listed
// cell and 32-query tile, the bitmaps (257 words a listed feature and
// tile) and one add per matched row and query — bytes-bound (~0.008 ms) up
// to B ~ 512; chip_smoke.py counts it and prints beside it the former
// count, a compare and an AND per binding bound and query (0.0898 ms at B
// = 256), which the words beat 32 to 1.  For uint16 and int32 it is that
// former count.
//
// Measured (chip_smoke.py phase 5, L2 flushed, NVIDIA H100 80GB HBM3,
// 700.00 W): the lane-per-query design took 0.0819 / 1.3146 / 5.0377 ms at
// B = 1 / 256 / 1024 for uint8, bound by its integer issue rate; the
// bit-parallel one takes 0.0476 / 0.1480 / 0.4732 ms (PERF.md).  Two of its
// choices came from the card on the way: a branch per listed cell
// serialised the shared-memory lookups, and one warp's split of eight
// chunks at B = 1 waits on memory unless the next chunk's cells are loaded
// before this chunk's leaf rows are added.  The fallback the design
// was held against, byte-SIMD compares of four queries (__vcmpgeu4,
// emulated in several instructions on sm_90), gains at most ~3x on the
// former count and was not built.  The bitmaps do not pay past their
// window: a uint8 table of F_pad 8,064 whose features from 223 on were
// compared against the queries in device memory (a loop over the tile's
// queries a cell) took 0.5560 ms at R = 16,384, B = 256 on the same card,
// against the lane-per-query kernel's 0.2211, so such a list runs that
// kernel.

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
// Layout<T>::bytes(F, kMatchBytes); kWide where the query window is not
// the whole width.
//   q     (B, F) table dtype     cells: the table's cell list, (R, K)
//   leaf  (R, C) float32 or null
//   ws    [splits, B, C] partials or null
//   bits  [ceil(B / 32), R] match words (bit b = query 32*x + b) or null
constexpr size_t kMatchBytes = (kChunk + kQueries * (kChunk / 32) + 4) * 4;

// Blocks an SM holds: eight (all its threads) for packed tables; shared
// memory holds int32 ones to four.  ptxas fits the registers to it.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 8;

template <typename T, typename Cell, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
cam_match_kernel(const T* __restrict__ q, CellArgs<T> cells,
                 const float* __restrict__ leaf, int B, int R, int F, int C,
                 int rows_per_split, float* __restrict__ ws,
                 uint32_t* __restrict__ bits) {
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
          ok &= Cell::match(W(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, b)), W(lo), W(hi));
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
          ok &= Cell::match(W(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, lane)), W(lo),
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

template <typename T, typename Cell, bool kWide>
cudaError_t launch_as(const T* q, const CellArgs<T>& cells, const float* leaf, int B,
                      int R, int F, int C, int rows_per_split, float* ws,
                      uint32_t* bits, cudaStream_t stream) {
  const size_t smem = Layout<T>::bytes(F, kMatchBytes);
  cudaError_t err = allow_smem(cam_match_kernel<T, Cell, kWide>, smem);
  if (err != cudaSuccess) return err;
  cam_match_kernel<T, Cell, kWide><<<match_grid(B, R, rows_per_split), kThreads, smem,
                                     stream>>>(q, cells, leaf, B, R, F, C,
                                               rows_per_split, ws, bits);
  return cudaGetLastError();
}

template <typename T, typename Cell>
cudaError_t launch(const void* q, const int32_t* count, const uint16_t* feat,
                   const void* lo, const void* hi, int K, const float* leaf,
                   int B, int R, int F, int C, int rows_per_split, float* ws,
                   uint32_t* bits, cudaStream_t stream) {
  const CellArgs<T> cells{count, feat, static_cast<const T*>(lo),
                          static_cast<const T*>(hi), K};
  const T* qt = static_cast<const T*>(q);
  if (Layout<T>::window(F, kMatchBytes) < F) {
    return launch_as<T, Cell, true>(qt, cells, leaf, B, R, F, C, rows_per_split, ws,
                                    bits, stream);
  }
  return launch_as<T, Cell, false>(qt, cells, leaf, B, R, F, C, rows_per_split, ws, bits,
                                   stream);
}

// -- uint8 tables: bit-parallel match words ----------------------------------

constexpr int kU8Threads = 512;  // 16 warps: one block an SM at full width
constexpr int kU8Warps = kU8Threads / 32;
constexpr int kBins = 256;
// words of a feature's bitmaps: GE[0..256], padded so a lane's eight
// words of the suffix pass are two aligned 16-byte loads
constexpr int kGeStride = 260;
constexpr int kMaxWindow = kMaxSmem / (kGeStride * 4);  // 223 features

struct U8Args {
  const uint8_t* q;        // (B, F)
  const int32_t* count;    // (R,)
  const uint32_t* words;   // (R, K): feat | lo << 16 | hi << 24
  int K;
  const float* leaf;       // (R, C) or null
  int B, R, F, C, rows_per_split;
  int span;                // the list's largest feature + 1
  int W;                   // features whose bitmaps are in shared memory
  float* ws;               // [splits, B, C] partials or null
  uint32_t* bits;          // [ceil(B / 32), R] match words or null
};

// The tile's bitmaps GE[f][v] (bit b: q[q0 + b][f] >= v) for features
// [0, W), v in [0, 256], into ge[f * kGeStride + v]; GE[f][256] = 0.
__device__ __forceinline__ void build_bitmaps(uint32_t* ge, const U8Args& a, int q0,
                                              int nq) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4* ge4 = reinterpret_cast<uint4*>(ge);
  for (int i = threadIdx.x; i < a.W * kGeStride / 4; i += kU8Threads) {
    ge4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // EQ[f][v]: the lanes of equal bins, one store per bin (padding lanes
  // take a bin of their own and store nothing); eight features' bins are
  // loaded before any is grouped
  for (int f0 = warp; f0 < a.W; f0 += 8 * kU8Warps) {
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = f0 + i * kU8Warps;
      v[i] = lane < nq && f < a.W ? int(__ldg(a.q + (size_t)(q0 + lane) * a.F + f)) : kBins;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = f0 + i * kU8Warps;
      const uint32_t peers = __match_any_sync(kFull, v[i]);
      if (lane < nq && f < a.W && lane == __ffs(peers) - 1) ge[f * kGeStride + v[i]] = peers;
    }
  }
  __syncthreads();
  // GE[f][v] = OR of EQ[f][u] over u >= v: lane l holds v in [8l, 8l + 8),
  // ORs them downwards, then takes the OR of every lane above it
  for (int f = warp; f < a.W; f += kU8Warps) {
    uint4* g = ge4 + f * (kGeStride / 4) + 2 * lane;
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

// The 32-query word of one listed cell (f, lo, hi): two bitmap lookups.
template <bool kInclusive>
__device__ __forceinline__ uint32_t cell_word(const uint32_t* ge, uint32_t cw) {
  const int f = int(cw & 0xFFFFu), lo = int((cw >> 16) & 0xFFu), hi = int(cw >> 24);
  const uint32_t* g = ge + f * kGeStride;
  return g[lo] & ~g[kInclusive ? hi + 1 : hi];
}

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

__device__ __forceinline__ void load_chunk(const U8Args& a, int r0, int nr, int lane,
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

// grid = (ceil(B / 32), blocks a tile); block = kU8Threads; dynamic shared
// memory W * kGeStride words.  Block y's warp w owns splits y * kU8Warps +
// w, then every gridDim.y * kU8Warps-th after it.  A chunk's cell words
// are loaded before the previous chunk's leaf rows are added.
template <bool kInclusive>
__global__ void __launch_bounds__(kU8Threads, 1) cam_match_u8_kernel(const U8Args a) {
  extern __shared__ __align__(16) uint32_t ge[];
  const int tile = blockIdx.x, q0 = tile * kQueries;
  const int nq = min(kQueries, a.B - q0);
  build_bitmaps(ge, a, q0, nq);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t valid = nq == kQueries ? kFull : (1u << nq) - 1u;  // a row of no cells
  const bool in_regs = a.C <= kRegC;
  const int splits = (a.R + a.rows_per_split - 1) / a.rows_per_split;
  for (int sp = blockIdx.y * kU8Warps + warp; sp < splits; sp += gridDim.y * kU8Warps) {
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
    ChunkCells cells;
    load_chunk(a, row_begin, min(kChunk, row_end - row_begin), lane, cells);
    for (int r0 = row_begin; r0 < row_end; r0 += kChunk) {
      const int nr = min(kChunk, row_end - r0);
      __syncwarp();
      // rows r0 + lane + 32j: their words, over their listed cells
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = 32 * j + lane < nr ? valid : 0u;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {  // no branch: the lookups overlap
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t cw = k < cells.n[j] ? cells.cw[j][k] : 0u;  // a slot past the count:
          const uint32_t m = cell_word<kInclusive>(ge, cw);  // feature 0's,
          w[j] &= k < cells.n[j] ? m : kFull;  // read and dropped
        }
      }
      const int most = max(max(cells.n[0], cells.n[1]), max(cells.n[2], cells.n[3]));
      for (int k = kSlots; k < most; ++k) {  // rows of more cells: from device memory
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k < cells.n[j]) {
            const uint32_t cw = __ldg(a.words + ((size_t)r0 + 32 * j + lane) * a.K + k);
            w[j] &= cell_word<kInclusive>(ge, cw);
          }
        }
      }
      if (r0 + kChunk < row_end) {
        load_chunk(a, r0 + kChunk, min(kChunk, row_end - r0 - kChunk), lane, cells);
      }
      if (a.bits != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (32 * j + lane < nr) a.bits[(size_t)tile * a.R + r0 + 32 * j + lane] = w[j];
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

// grid = (ceil(B / 32), blocks a tile), one wave: as many blocks a tile as
// fill the card, no more than give each warp a split.
template <bool kInclusive>
cudaError_t launch_u8(U8Args a, cudaStream_t stream) {
  const auto kernel = cam_match_u8_kernel<kInclusive>;
  a.W = max(1, a.span);
  const size_t smem = (size_t)a.W * kGeStride * 4;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kU8Threads, smem);
  }
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + kQueries - 1) / kQueries;
  const int splits = (a.R + a.rows_per_split - 1) / a.rows_per_split;
  const int fill = max(1, sms * max(1, per_sm) / tiles);
  const int per_tile = min(fill, (splits + kU8Warps - 1) / kU8Warps);
  kernel<<<dim3(tiles, per_tile), kU8Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32.  mode: 0 direct, 1 inclusive,
// 2 msb_lsb, 3 two_cycle (the last two on int32 only).  count/feat/lo/hi
// are the table's cell list (R rows, K slots; lo/hi in the table dtype);
// `words` its packed cells and `span` its largest feature + 1 (uint8 only:
// feat | lo << 16 | hi << 24, (R, K)).
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `bits`
// set: the match words only (`leaf`, `ws` and `out` null).  Returns a
// cudaError_t; the launch is asynchronous on `stream`.
extern "C" int xtime_cam_match(int dtype, int mode, const void* q,
                               const int32_t* count, const uint16_t* feat,
                               const void* lo, const void* hi, const uint32_t* words,
                               int span, int K, const float* leaf, const float* bias, int B,
                               int R, int F, int C, int rows_per_split,
                               float* ws, float* out, uint32_t* bits,
                               void* stream_ptr) {
  if (bad_launch(B, R, F, C, K, rows_per_split, leaf, ws, out) ||
      (dtype == 0 && (words == nullptr || span < 0 || span > F))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  const bool bitmaps = dtype == 0 && span <= kMaxWindow;  // else the lane-per-query kernel
  if (bitmaps && (mode == 0 || mode == 1)) {
    const U8Args a{static_cast<const uint8_t*>(q), count, words, K, leaf, B, R, F, C,
                   rows_per_split, span, 0, ws, bits};
    err = mode == 1 ? launch_u8<true>(a, stream) : launch_u8<false>(a, stream);
  }
#define XTIME_LAUNCH(T, CELL)                                                \
  launch<T, CELL>(q, count, feat, lo, hi, K, leaf, B, R, F, C, rows_per_split, \
                  ws, bits, stream)
  if (dtype == 0 && !bitmaps && mode == 0) err = XTIME_LAUNCH(uint8_t, Direct);
  if (dtype == 0 && !bitmaps && mode == 1) err = XTIME_LAUNCH(uint8_t, Inclusive);
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
