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
// indicator (q > lo && q < hi) -> 0 / -inf.  `uncertainty` runs it over
// the (R, 3C) moments matrix [leaf, leaf^2, class mass] with no bias; its
// first C columns are the margin's, bit for bit (each output's float
// sequence does not depend on C), so the engine takes the margins of
// `predict(return_uncertainty=True)` from that one launch.
//
// Design: the structure of the hard kernel's uint16/int32 path
// (cam_match.cu).  One block owns a 32-query tile and a fixed row split,
// stages its queries once and walks 128-row chunks; each warp takes one row
// at a time with a lane per query and sums the log-scores of the row's
// listed cells only (the per-row cell list, cam_match_common.cuh), in
// ascending feature order; a tile of at most 8 queries gives each thread a
// (row, query) pair instead, with the same sum.  A wildcard (-inf, +inf)
// cell's log-score is exactly +0, and an infinite side of a listed cell
// contributes exactly +0, so the walk leaves both out and gives the float
// sum of adding every cell in order.  The chunk's scores expf(sum) go to
// shared memory, its leaf rows are staged with coalesced loads, and the
// block adds score * leaf (fmaf) in row order into its slice of the
// [splits, B, C] workspace; the shared reduce kernel sums the splits in
// index order and adds the bias.  A table wider than the staged query
// window runs the kWide instance, which reads the queries of cells past the
// window from device memory (cam_match_common.cuh).  No atomics, no tensor
// cores: the result is identical run to run and for B = 1 against a row of
// a batch.
//
// tau = 0 (the kTauZero instances): every score is exactly 0 or 1, so the
// partial sums are the very float adds of the hard kernel's `direct` mode:
// the margins are bit-equal to it.
//
// tau > 0 (the kWide = false / true instances with kTauZero false): the
// log-sigmoids set the pace, so
//   * each is a short sequence around one special-function op
//     (`log_sigmoid`, below), and
//   * a tile whose queries are integers within +-256, on a list whose
//     finite bounds are half-integers within +-256 (`CellList.lattice`: the
//     soft encoding of a table of at most 256 bins), reads them instead
//     from a table of that evaluation over the lattice the two make, T[j] =
//     log_sigmoid((j - 512.5) * inv), 1,026 entries built by each block:
//     q - lo (hi - q) is exactly j - 512.5, so the read is bit for bit the
//     evaluation it replaces; the lattice walk loads a row's staged cells
//     four at a time before it adds any, with no branch per cell;
//   * the leaf product is register-tiled: a thread owns one query x four
//     channels (a score load and a 16-byte leaf load feed four FMAs) where
//     the tile holds more than 8 queries and C is a multiple of 4, each
//     output's FMAs in row order either way;
//   * only the queries of the features the list names (`CellList.span`)
//     are staged.
// log_sigmoid(x) = min(x, 0) - log1p(t), t = exp(-|x|):
//   * a = min(|x|, 88); k = rint(a log2 e) through the 1.5 * 2^23 rounding
//     constant, f = a log2 e - k by two FMAs with log2 e split in a head and
//     a tail (|f| <= 1/2, absolute error <= 2^-25), m = ex2.approx(-f) in
//     [2^-1/2, 2^1/2], t = m * 2^-k with 2^-k built from k's bits: exact
//     down to the subnormals, and exactly +0 for a >= 87.7 (k = 127);
//   * log1p(t) = t * P(t), P a degree-9 minimax polynomial of log1p(t)/t on
//     [0, 1] (relative error 0.09u, u = 2^-24), by Horner's rule in FMAs;
//     the last FMA forms min(x, 0) - t * P(t) with one rounding.
// Thirteen FMAs, one SFU op and five other instructions, where the
// library expf and log1pf cost ~30 each beside their SFU op.  Special
// values: x = +inf gives exactly +0 (t = +0, 0 - 0), x = -inf exactly
// -inf, and nothing gives NaN.
//
// Error, against the budget of ref.soft_score_bound (unchanged): it grants
// each log-score 8u of its magnitude and each row sum the reorder term
// (F - 1)u, per side of the comparison.  At the smallest F the kernel
// accepts (F = 1: one cell, no reorder term) the 8u must hold alone.  Per
// side, with every step but ex2 rounded as the float32 mirror
// (ref.log_sigmoid_f32) rounds it, the relative error is at most 2.85u
// of |ls| (2.8475u at x = 0.2015: tools/log_sigmoid_sweep.py, every
// float32 in [-104, 104] against float64); ex2.approx's relative error (2
// ulp on [1, 2), 4u) passes into t and, since d log1p(t) / log1p(t) <=
// dt / t, into |ls| at most one for one: 6.85u (the same tool with
// --ex2-ulps 2 moves every ex2 2 ulp either way and checks it).  The
// cell's lo + hi add rounds once more (0.5u, both terms <= 0): 7.35u <=
// 8u.  Where |ls| < 2^-126 the result may be flushed to 0 (a >= 87.7);
// such a term moves no score, since exp of a sum that small is 1 either
// way.  The per-row expf is the library's (2 ulp, the bound's own term).
// tests/test_torch_log_sigmoid.py holds the mirror to these figures
// (ref.MIRROR_ULPS, ref.EX2_ULPS) on a dense grid; chip_smoke.py and
// tests/test_torch_gpu.py sweep a one-cell table over x on the card and
// hold its scores to s(8u |ls| + 4u) + 2^-126 against float64.
//
// Bound on an H100 SXM at xtime-tabular's full width (R = 1M rows, F_pad =
// 256): at tau > 0 the lattice design's count — per finite bound and query
// an add forming the index and an add into the sum, and a table read at
// the shared-memory rate (32 words a clock an SM), the longest: ~0.23 ms at
// B = 256 — beside it the former count, an ex2 and an lg2 per finite bound
// and query on the SFU (~1 ms); at tau = 0 a compare per finite bound and
// query (~0.12 ms at B = 256); at B = 1 the bytes of the cell list and the
// leaf rows (~0.02 ms).  chip_smoke.py counts them.  Measured (phase 5, L2
// flushed, NVIDIA H100 80GB HBM3, 700.00 W), tau = 0.1 at B = 256: 5.2585
// ms with the library log-sigmoid (the former design), 3.7080 with the
// short one, 2.9136 with the lattice table; the tau = 0 instance, whose
// code is the first port's, 2.0859: the block's walk, barriers and
// staging, not the log-sigmoids, are what is left (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cam_match_common.cuh"  // the block shape, the cell list and its walk

namespace {

constexpr float kRound = 0x1.8p+23f;  // 1.5 * 2^23: adding it rounds to an integer

// The cell's exact tau = 0 indicator: log-score 0 inside, -inf outside.
__device__ __forceinline__ float indicator_logscore(float q, float lo, float hi) {
  return (q > lo && q < hi) ? 0.f : -INFINITY;
}

// log(sigmoid(x)) = min(x, 0) - log1p(exp(-|x|)), as derived in the header;
// ref.log_sigmoid_f32 is its float32 mirror (the same constants).
__device__ __forceinline__ float log_sigmoid(float x) {
  constexpr float kL2E = 0x1.715476p+0f, kL2ELo = 0x1.4ae0c0p-26f;  // log2 e, head + tail
  const float a = fminf(fabsf(x), 88.f);
  const float kr = fmaf(a, kL2E, kRound);  // k + 1.5 * 2^23, k = rint(a log2 e) <= 127
  const float k = kr - kRound;
  const float f = fmaf(a, kL2ELo, fmaf(a, kL2E, -k));  // a log2 e - k
  float m;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(m) : "f"(-f));
  // 2^-k from k's bits (the low bits of kr): +0 at k = 127
  const float scale =
      __int_as_float(int(0x3f800000u - (uint32_t(__float_as_int(kr)) << 23)));
  const float t = m * scale;  // exp(-a)
  float p = -0x1.b2f586p-9f;  // log1p(t) / t: degree-9 minimax on [0, 1]
  p = fmaf(p, t, 0x1.4b0834p-6f);
  p = fmaf(p, t, -0x1.d86322p-5f);
  p = fmaf(p, t, 0x1.b579c2p-4f);
  p = fmaf(p, t, -0x1.3a7a82p-3f);
  p = fmaf(p, t, 0x1.935ca0p-3f);
  p = fmaf(p, t, -0x1.ff26e2p-3f);
  p = fmaf(p, t, 0x1.554df0p-2f);
  p = fmaf(p, t, -0x1.ffffd2p-2f);
  p = fmaf(p, t, 1.f);
  return fmaf(-t, p, fminf(x, 0.f));
}

// The log-sigmoids of the half-integer lattice: T[j] = log_sigmoid((j -
// 512.5) * inv), j in [0, kLattice).  Compiled soft tables hold half-integer
// bounds and binned queries are integers, so every side's q - lo (or hi -
// q) is such a j - 512.5, exactly; reading T[j] is then bit for bit the
// evaluation it replaces.
constexpr int kLattice = 1026;
constexpr float kLatticeMid = 512.5f;
constexpr float kLatticeMax = 256.f;  // |q|, |bound| at most this on the lattice
constexpr size_t kLatticeBytes = kLattice * 4;

// One listed cell's log-score at tau > 0, evaluated.  An infinite side's
// log-sigmoid is exactly +0, so it is not evaluated (a warp-uniform branch
// when the warp walks one row); the sum keeps the lo-side + hi-side
// grouping.  Never hi - lo: with infinite bounds that would be inf - inf.
__device__ __forceinline__ float sigmoid_logscore(float q, float lo, float hi, float inv) {
  float a = 0.f, b = 0.f;
  if (lo != -INFINITY) a = log_sigmoid((q - lo) * inv);
  if (hi != INFINITY) b = log_sigmoid((hi - q) * inv);
  return a + b;
}

// The cell's log-score from the lattice table, without a branch: a finite
// side reads T at j = q - lo + 512.5 (hi - q + 512.5), formed exactly in
// the integer range of kRound; an infinite side is what log_sigmoid gives
// it (+0 for a wildcard side, -inf for a never-match one), and reads T[0].
__device__ __forceinline__ float lattice_logscore(float q, float lo, float hi,
                                                  const float* lat) {
  const bool lo_fin = fabsf(lo) != INFINITY, hi_fin = fabsf(hi) != INFINITY;
  const float ya = q + ((kLatticeMid - lo) + kRound);
  const float yb = ((hi + kLatticeMid) + kRound) - q;
  const float ta = lat[lo_fin ? __float_as_int(ya) - __float_as_int(kRound) : 0];
  const float tb = lat[hi_fin ? __float_as_int(yb) - __float_as_int(kRound) : 0];
  const float a = lo_fin ? ta : (lo < 0.f ? 0.f : -INFINITY);
  const float b = hi_fin ? tb : (hi > 0.f ? 0.f : -INFINITY);
  return a + b;
}

// The sum of chunk row r's log-scores for query b through the lattice
// table: the staged cells four at a time, their loads before any sum (a
// slot past the count reads as a wildcard and is not added), then any
// cells past the staged ones from device memory; in ascending order, the
// very adds of walk_row + sigmoid_logscore.
__device__ __forceinline__ float lattice_row_sum(const CellArgs<float>& g,
                                                 const Staged<float>& s, int r0, int r,
                                                 const float* s_q, int b, const float* lat) {
  const int n = s.cnt[r];
  const int ns = min(n, kStagedCells);
  float acc = 0.f;
  for (int k0 = 0; k0 < ns; k0 += 4) {
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = r * kCellStride + k0 + i;
      const bool in = k0 + i < ns;
      const int f = in ? int(s.feat[idx]) : 0;
      const float lo = in ? s.lo[idx] : -INFINITY, hi = in ? s.hi[idx] : INFINITY;
      c[i] = lattice_logscore(s_q[f * kQStride + b], lo, hi, lat);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = k0 + i < ns ? acc + c[i] : acc;
  }
  for (int k = kStagedCells; k < n; ++k) {
    const size_t i = (size_t)(r0 + r) * g.K + k;
    acc += lattice_logscore(s_q[int(g.feat[i]) * kQStride + b], g.lo[i], g.hi[i], lat);
  }
  return acc;
}

// Whether every staged query of the tile is an integer within the
// lattice; a block barrier.
__device__ __forceinline__ bool queries_on_lattice(const float* __restrict__ q, int F, int Fs,
                                                   int q0, int nq) {
  bool ok = true;
  for (int i = threadIdx.x; i < nq * Fs; i += kThreads) {
    const float v = q[(size_t)(q0 + i / Fs) * F + i % Fs];
    ok &= v == rintf(v) && fabsf(v) <= kLatticeMax;
  }
  return __syncthreads_and(ok) != 0;
}

constexpr size_t kScoreBytes = kChunk * kQStride * 4;

// The chunk's leaf product for channels [c0, c0 + cw) (staged in s_leaf):
// part[b * C + c0 + c] += SUM_r fmaf(score[r][b], leaf[r][c]) from +0, rows
// ascending.  kTiled: a thread owns one query x four channels (C a multiple
// of 4); else one output.  Both give each output the same float sequence.
// stage_leaf for C a multiple of 4: thread t copies row t % kChunk's
// 16-byte groups t / kChunk, + kThreads / kChunk, ... (no division).
__device__ __forceinline__ void stage_leaf4(const float* __restrict__ leaf, float* s_leaf,
                                            int C, int r0, int nr, int c0, int cw) {
  const int r = threadIdx.x % kChunk;
  if (r >= nr) return;
  const float4* src = reinterpret_cast<const float4*>(leaf + (size_t)(r0 + r) * C + c0);
  float4* dst = reinterpret_cast<float4*>(s_leaf + r * cw);
  for (int g = threadIdx.x / kChunk; g < cw / 4; g += kThreads / kChunk) dst[g] = src[g];
}

template <bool kTiled>
__device__ __forceinline__ void leaf_product(const float* s_score, const float* s_leaf,
                                             float* part, int C, int nq, int nr, int c0,
                                             int cw) {
  if (kTiled) {
    const int groups = cw / 4;
    for (int o = threadIdx.x; o < nq * groups; o += kThreads) {
      const int b = o / groups, c = (o % groups) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float sc = s_score[r * kQStride + b];
        const float4 l = *reinterpret_cast<const float4*>(s_leaf + r * cw + c);
        s.x = fmaf(sc, l.x, s.x);
        s.y = fmaf(sc, l.y, s.y);
        s.z = fmaf(sc, l.z, s.z);
        s.w = fmaf(sc, l.w, s.w);
      }
      float4* p = reinterpret_cast<float4*>(part + b * C + c0 + c);
      float4 v = *p;
      v.x += s.x; v.y += s.y; v.z += s.z; v.w += s.w;
      *p = v;
    }
    return;
  }
  for (int o = threadIdx.x; o < nq * cw; o += kThreads) {
    const int b = o / cw, c = o % cw;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < nr; ++r) s = fmaf(s_score[r * kQStride + b], s_leaf[r * cw + c], s);
    part[b * C + c0 + c] += s;
  }
}

// Bytes of the kernel's own after the chunk area: the scores, and at tau >
// 0 the lattice table.
template <bool kTauZero>
constexpr size_t kSoftBytes = kScoreBytes + (kTauZero ? 0 : kLatticeBytes);

// grid = (ceil(B / 32), splits); block = kThreads; dynamic shared memory
// Layout<float>::bytes(F, kSoftBytes<kTauZero>); kWide where the query
// window is not the whole width.  kTauZero: the indicator (tau = 0, the
// code of the first port, kept as it was); else the sigmoid cells with
// `inv`, through the lattice table where `lattice` (the cell list's bounds
// are on it) and the tile's queries are.
//   q      (B, F) float32 bins     cells: the soft table's cell list, (R, K)
//   leaf   (R, C) float32 or null
//   ws     [splits, B, C] partials or null
//   scores (B, R) row scores or null
template <bool kTauZero, bool kWide>
__global__ void __launch_bounds__(kThreads)
cam_match_soft_kernel(const float* __restrict__ q, CellArgs<float> cells,
                      const float* __restrict__ leaf, int B, int R, int F, int C,
                      int rows_per_split, float inv, int lattice, int span,
                      float* __restrict__ ws, float* __restrict__ scores) {
  constexpr size_t kExtra = kSoftBytes<kTauZero>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  const int Fq = kTauZero ? F : span;  // tau > 0: only the features the list names
  const int Fs = Layout<float>::window(Fq, kExtra);
  unsigned char* area = smem + Layout<float>::queries(Fq, kExtra);
  const Staged<float> st(area);
  float* s_leaf = reinterpret_cast<float*>(area);  // after the log-scores
  float* s_score = reinterpret_cast<float*>(area + Layout<float>::chunk);  // [row][query]
  float* s_lat = s_score + kChunk * kQStride;  // tau > 0: the lattice table

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * kQueries;
  const int nq = min(kQueries, B - q0);
  const bool by_pair = nq <= kPairWalkQueries;  // uniform in the block
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(R, row_begin + rows_per_split);
  float* part = zeroed_partials(ws, B, C, q0, nq);
  stage_queries(q, s_q, F, Fs, q0, nq);
  const float* lat = nullptr;  // the table, where the tile may read it
  if (!kTauZero) {
    for (int j = tid; j < kLattice; j += kThreads) {
      s_lat[j] = log_sigmoid((float(j) - kLatticeMid) * inv);
    }
    // (a wide table's queries past the window are not checked: it computes)
    if (queries_on_lattice(q, F, Fs, q0, nq) && lattice && !kWide) lat = s_lat;
  }
  const auto logscore = [&](float x, float lo, float hi) {
    return kTauZero ? indicator_logscore(x, lo, hi) : sigmoid_logscore(x, lo, hi, inv);
  };
  // the sum of chunk row r's log-scores for query b
  const auto row_sum = [&](int r0, int r, int b) {
    if (!kTauZero && lat != nullptr) return lattice_row_sum(cells, st, r0, r, s_q, b, lat);
    float acc = 0.f;
    walk_row(cells, st, r0, r, [&](int f, float lo, float hi) {
      acc += logscore(query_at<kWide>(s_q, q, F, Fs, q0, nq, f, b), lo, hi);
    });
    return acc;
  };

  for (int r0 = row_begin; r0 < row_end; r0 += kChunk) {
    const int nr = min(kChunk, row_end - r0);
    __syncthreads();  // the previous chunk's readers are done
    stage_cells(cells, st, r0, nr);
    __syncthreads();

    if (by_pair) {  // a thread per (row, query): rows adjacent across lanes
      for (int p = tid; p < nr * nq; p += kThreads) {
        const int r = p % nr, b = p / nr;
        const float s = expf(row_sum(r0, r, b));
        s_score[r * kQStride + b] = s;
        if (scores != nullptr) scores[(size_t)(q0 + b) * R + r0 + r] = s;
      }
    } else {  // a warp per row, a lane per query
      for (int r = warp; r < nr; r += kWarps) {
        float acc = 0.f;
        // padding lanes of a ragged tile skip the transcendentals; at
        // tau = 0 they are cheaper to run
        if (kTauZero || lane < nq) acc = row_sum(r0, r, lane);
        const float s = expf(acc);
        s_score[r * kQStride + lane] = s;
        if (scores != nullptr && lane < nq) scores[(size_t)(q0 + lane) * R + r0 + r] = s;
      }
    }
    if (part == nullptr) continue;

    for (int c0 = 0; c0 < C; c0 += kLeafCols) {
      const int cw = min(kLeafCols, C - c0);
      __syncthreads();  // the cell reads, scores, earlier channels' readers
      if (kTauZero || C % 4 != 0) {
        stage_leaf(leaf, s_leaf, C, r0, nr, c0, cw, [](int) { return true; });
      } else {
        stage_leaf4(leaf, s_leaf, C, r0, nr, c0, cw);
      }
      __syncthreads();
      if (kTauZero || by_pair || C % 4 != 0) {  // a few queries: an output a thread
        leaf_product<false>(s_score, s_leaf, part, C, nq, nr, c0, cw);
      } else {
        leaf_product<true>(s_score, s_leaf, part, C, nq, nr, c0, cw);
      }
    }
  }
}

template <bool kTauZero, bool kWide>
cudaError_t launch_soft_as(const float* q, const CellArgs<float>& cells,
                           const float* leaf, int B, int R, int F, int C,
                           int rows_per_split, float inv, int lattice, int span,
                           float* ws, float* scores, cudaStream_t stream) {
  const size_t smem = Layout<float>::bytes(kTauZero ? F : span, kSoftBytes<kTauZero>);
  cudaError_t err = allow_smem(cam_match_soft_kernel<kTauZero, kWide>, smem);
  if (err != cudaSuccess) return err;
  cam_match_soft_kernel<kTauZero, kWide><<<match_grid(B, R, rows_per_split), kThreads,
                                           smem, stream>>>(q, cells, leaf, B, R, F, C,
                                                           rows_per_split, inv, lattice,
                                                           span, ws, scores);
  return cudaGetLastError();
}

template <bool kTauZero>
cudaError_t launch_soft(const float* q, const CellArgs<float>& cells,
                        const float* leaf, int B, int R, int F, int C,
                        int rows_per_split, float inv, int lattice, int span,
                        float* ws, float* scores, cudaStream_t stream) {
  const int Fq = kTauZero ? F : span;
  if (Layout<float>::window(Fq, kSoftBytes<kTauZero>) < Fq) {
    return launch_soft_as<kTauZero, true>(q, cells, leaf, B, R, F, C, rows_per_split, inv,
                                          lattice, span, ws, scores, stream);
  }
  return launch_soft_as<kTauZero, false>(q, cells, leaf, B, R, F, C, rows_per_split, inv,
                                         lattice, span, ws, scores, stream);
}

}  // namespace

// tau_zero: 1 runs the exact tau = 0 indicator, 0 the sigmoid cells with
// `inv` = float32(1 / tau) (computed on the host exactly as the plain
// version computes it).  lattice: 1 when every finite bound of the list is
// a half-integer of magnitude <= 256 (CellList.lattice); the tiles whose
// queries are integers of magnitude <= 256 then read their log-sigmoids
// from the lattice table.  span: the list's largest feature + 1
// (CellList.span); at tau > 0 only those features' queries are staged.
//
// With `out` set: the margins, through `ws` ([splits, B, C] float32,
// splits = ceil(R / rows_per_split)); `bias` may be null.  With `scores`
// set: the (B, R) row scores only (`leaf`, `ws` and `out` null).  Returns
// a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int xtime_cam_match_soft(int tau_zero, float inv, int lattice, int span,
                                    const float* q,
                                    const int32_t* count, const uint16_t* feat,
                                    const float* lo, const float* hi, int K,
                                    const float* leaf, const float* bias, int B,
                                    int R, int F, int C, int rows_per_split,
                                    float* ws, float* out, float* scores,
                                    void* stream_ptr) {
  if (bad_launch(B, R, F, C, K, rows_per_split, leaf, ws, out) ||
      (tau_zero == 0 && !(inv > 0.f && inv < INFINITY)) || span < 0 || span > F) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const CellArgs<float> cells{count, feat, lo, hi, K};
  const cudaError_t err =
      tau_zero ? launch_soft<true>(q, cells, leaf, B, R, F, C, rows_per_split, inv, 0, F,
                                   ws, scores, stream)
               : launch_soft<false>(q, cells, leaf, B, R, F, C, rows_per_split, inv,
                                    lattice, max(span, 1), ws, scores, stream);
  if (err != cudaSuccess || out == nullptr) return err;
  return reduce_splits(ws, bias, out, R, rows_per_split, B, C, stream);
}
