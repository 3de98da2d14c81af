// The warp-row walk of the Block-Max round (sm_90a): one kernel template
// that P1 (score_kernel.cu, precomputed impacts) and P1-tf
// (tf_range_scores.cu, scores rebuilt from term frequencies) instantiate
// with a per-posting scorer.  For one (query q, candidate range c) row:
//
//     out[q, c, slot] = sum_t sum_{lane < lens[q,t,c],
//                                  post_local[starts[q,t,c] + lane] == slot}
//                       score(starts[q,t,c] + lane)
//
// Design.  Eight warps a block.  A warp works on two (query, range) rows
// at once, sixteen lanes each, and keeps their 256 f32 slot accumulators
// in shared memory (RS <= 256: index/ranges.py caps range-local ids at one
// byte).  The first version of both kernels gave a row a block of RS
// threads and walked its terms one by one: a dependent load of the term's
// start and length, the posting loads, a shared atomic, a block barrier,
// four such chains in series at T = 4, with about 10 of 128 threads active
// (5,103,349 active lanes over 524,288 (row, term) pairs in round 1 at
// Q=4096, C=32).  Now:
//   - a warp walks 32 / T consecutive rows (at most 8), and one load brings
//     the starts and lengths of all of them (lane r * T + t holds term t
//     of row r; they are C apart in [Q, T, C]), and with them whatever the
//     scorer keeps per row and per term; each half-warp reads its row's
//     by shuffle;
//   - a row whose lengths are all 0 writes its zero row with 16-B stores
//     and reads nothing else (most rows of a later round);
//   - window lane `sub` of four terms loads before the first add, so four
//     dependent chains become one; a scorer that gathers per posting (the
//     tf rebuild's fieldnorm) issues the four gathers together too, after
//     the four posting loads and before any arithmetic; lanes past 16 of a
//     long window load three at a time;
//   - the adds run term by term in ascending t, a __syncwarp between terms,
//     as shared-memory atomics (the GPU's native scatter: the TPU kernel
//     built a one-hot matmul for the MXU instead);
//   - a table the scorer reads (the tf rebuild's 1 KB s1 table) is staged
//     in shared memory once a block, not once a row;
//   - the rows leave shared memory in 16-B stores where the output allows.
// The loads wait on latency, not bytes (bf16 impacts take as long as
// f32): sixteen lanes a row cover a typical window (about 10 postings) and
// put twice the rows in flight of a warp a row.  The tf walk takes 80
// registers a thread (three blocks an SM); a launch bound of four blocks
// an SM made its first round 13% faster but left the 21 rounds of a batch
// within 1%, and made P1 4-7% slower, so the walk asks for none.  Eight
// lanes a row, pipelining the next row's loads behind this row's adds,
// eight blocks an SM, and staging a live row's 256 fieldnorms in shared
// memory ahead of the gathers ran slower (PERF.md, section 6).
//
// Lanes at or past a window's length are skipped: in the reference they
// add +0.0 (an impact of 0, or tf = 0), which changes no bit of a
// non-negative sum.
//
// Exactness.  On index data the range-local slots inside one (term,
// range) group are unique (postings are doc-ascending), so no two lanes
// ever add to one slot within a term and each slot sums its terms in
// ascending t from 0.  That is the order of the one-hot matmul (one nonzero
// per slot per term), of the reference's tf-mode scatter and of the plain
// PyTorch versions, so the result is equal bit for bit.  Inputs with
// duplicate slots in one window (random tests) add in atomic order and
// agree to f32 rounding.
//
// A Scorer provides:
//   kRebuilds        true when scores are rebuilt per posting (tf mode):
//                    it then has a per-row base, a per-term factor, a
//                    per-posting gather and a staged table;
//   Shared           what it stages in shared memory; stage(Shared&);
//   row_base(row)    the row's first doc (its candidate range * RS);
//   term(qt)         the factor of term t of query q, qt = q * T + t;
//   value(p)         posting p's stored value (impact, or tf) as f32;
//   gather(b, slot)  the per-posting table entry (b: the row's base);
//   score(v, g, f, shared)  the posting's score from those.

#pragma once

#include "impact.cuh"

namespace bm25 {
namespace range_rows {

constexpr int kMaxRangeSize = 256;
constexpr int kRowWarps = 8;     // warps a block
constexpr int kThreads = kRowWarps * 32;
constexpr int kMaxRowsPerWarp = 8;
constexpr int kTermBatch = 4;    // terms whose first posting loads issue together
constexpr int kRowLanes = 16;    // lanes a row: a warp works on 32 / kRowLanes rows at once
constexpr int kRowsAtOnce = 32 / kRowLanes;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Rows a warp walks: as many as leave one lane for each (row, term) of
// them, so one load brings all their starts and lengths (8 rows at T <= 4).
inline int rows_per_warp(int n_terms) {
  if (n_terms > 32) return 1;
  const int fit = 32 / (n_terms > 1 ? n_terms : 1);
  return fit < kMaxRowsPerWarp ? fit : kMaxRowsPerWarp;
}

template <typename Scorer>
__global__ void __launch_bounds__(kThreads) kernel(
    const Scorer scorer,
    const uint8_t* __restrict__ post_local,  // [P]
    const int32_t* __restrict__ starts,      // [Q, T, C]
    const int32_t* __restrict__ lens,        // [Q, T, C]
    float* __restrict__ out,                 // [Q, *] rows of C * RS
    long long n_rows, int n_terms, int chunk, int rs, long long out_stride,
    int vec_out, int rows_per) {
  __shared__ __align__(16) float acc_all[kRowWarps][kRowsAtOnce][kMaxRangeSize];
  __shared__ typename Scorer::Shared tables;
  if constexpr (Scorer::kRebuilds) {
    scorer.stage(tables);
    __syncthreads();  // the only block barrier: before any warp leaves
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane / kRowLanes;  // this lane's row of those at once
  const int sub = lane % kRowLanes;   // its lane in that row
  const long long first =
      (static_cast<long long>(blockIdx.x) * kRowWarps + warp) * rows_per;
  if (first >= n_rows) return;  // a whole warp
  const long long end = min(first + rows_per, n_rows);
  float* acc = acc_all[warp][half];
  const int group = max(1, min(n_terms, 32));  // terms a meta load covers

  // Lane l holds term l % group of row first + l / group (rows_per * group
  // <= 32), or of the current row's later term groups past 32 terms.
  auto load_meta = [&](long long row, int t, int* start, int* len, float* f) {
    *start = 0;
    *len = 0;
    *f = 0.0f;
    if (row < end && t < n_terms) {
      const long long q = row / chunk;
      const int64_t m = (q * n_terms + t) * chunk + (row - q * chunk);
      *start = starts[m];
      *len = lens[m];
      if constexpr (Scorer::kRebuilds) *f = scorer.term(q * n_terms + t);
    }
  };
  int m_start, m_len;
  float m_term;
  load_meta(lane < rows_per * group ? first + lane / group : end, lane % group,
            &m_start, &m_len, &m_term);
  // Lane r holds row first + r's base.
  int m_base = 0;
  if constexpr (Scorer::kRebuilds) {
    if (lane < rows_per && first + lane < end) m_base = scorer.row_base(first + lane);
  }

  // Window lanes sub, sub + kRowLanes, ... of terms tb .. tb + 3 of this
  // lane's row, whose metadata sits in lanes base + t; the first loads of
  // the four terms issue before any add, and so do their gathers.
  struct Batch {
    float v[kTermBatch], f[kTermBatch];
    int slot[kTermBatch], n[kTermBatch], st[kTermBatch];
  };
  auto load_batch = [&](int base, int tb, int nt, int row_base, Batch& b) {
#pragma unroll
    for (int j = 0; j < kTermBatch; ++j) {
      const int tt = tb + j;
      const int src = (base + tt) & 31;
      const int len = __shfl_sync(kFull, m_len, src);
      b.st[j] = __shfl_sync(kFull, m_start, src);
      if constexpr (Scorer::kRebuilds) b.f[j] = __shfl_sync(kFull, m_term, src);
      b.n[j] = tt < nt ? min(len, rs) : 0;
      b.slot[j] = -1;
      if (sub < b.n[j]) {
        const int64_t p = static_cast<int64_t>(b.st[j]) + sub;
        b.v[j] = scorer.value(p);
        b.slot[j] = post_local[p];
      }
    }
    if constexpr (Scorer::kRebuilds) {
      int g[kTermBatch];
#pragma unroll
      for (int j = 0; j < kTermBatch; ++j) {
        if (b.slot[j] >= 0) g[j] = scorer.gather(row_base, b.slot[j]);
      }
#pragma unroll
      for (int j = 0; j < kTermBatch; ++j) {
        if (b.slot[j] >= 0) b.v[j] = scorer.score(b.v[j], g[j], b.f[j], tables);
      }
    }
  };
  // The adds, term by term in ascending t.
  auto add_batch = [&](const Batch& b, int row_base) {
#pragma unroll
    for (int j = 0; j < kTermBatch; ++j) {
      // A u8 slot stays inside the 256-entry acc.  Slots in [RS, 256)
      // land in entries that are never written out, so they are dropped,
      // as the TPU kernel's one-hot matmul drops them.
      if (b.slot[j] >= 0) atomicAdd(&acc[b.slot[j]], b.v[j]);
      // Longer windows: three loads in flight.
      for (int pos0 = kRowLanes; pos0 < b.n[j]; pos0 += 3 * kRowLanes) {
        float w[3];
        int ws[3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int pos = pos0 + kRowLanes * u + sub;
          ws[u] = -1;
          if (pos < b.n[j]) {
            const int64_t p = static_cast<int64_t>(b.st[j]) + pos;
            w[u] = scorer.value(p);
            ws[u] = post_local[p];
          }
        }
        if constexpr (Scorer::kRebuilds) {
          int g[3];
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            if (ws[u] >= 0) g[u] = scorer.gather(row_base, ws[u]);
          }
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            if (ws[u] >= 0) w[u] = scorer.score(w[u], g[u], b.f[j], tables);
          }
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          if (ws[u] >= 0) atomicAdd(&acc[ws[u]], w[u]);
        }
      }
      __syncwarp();  // term t's adds land before term t + 1's
    }
  };

  // kRowsAtOnce rows at a time, kRowLanes lanes each.
  for (long long pair = first; pair < end; pair += kRowsAtOnce) {
    const long long row = pair + half;
    const int r = static_cast<int>(row - first);
    int row_base = 0;
    if constexpr (Scorer::kRebuilds) row_base = __shfl_sync(kFull, m_base, r & 31);
    bool live = false;
    for (int t0 = 0; t0 < n_terms; t0 += 32) {
      int base = r * group;  // the lane holding term t0 of this row
      if (t0 > 0) {         // rows_per == 1: the next 32 terms, row 0
        load_meta(pair, t0 + lane, &m_start, &m_len, &m_term);
        base = 0;
      }
      const int nt = row < end ? min(32, n_terms - t0) : 0;
      const unsigned any = __ballot_sync(kFull, m_len > 0);
      const unsigned bits = nt == 32 ? kFull : (1u << nt) - 1u;
      const bool act = nt > 0 && ((any >> base) & bits) != 0u;
      if (!__any_sync(kFull, act)) continue;
      if (act && !live) {
        for (int s = sub; s < kMaxRangeSize; s += kRowLanes) acc[s] = 0.0f;
        live = true;
      }
      __syncwarp();
      const int n_batch = __reduce_max_sync(kFull, act ? nt : 0);
      for (int tb = 0; tb < n_batch; tb += kTermBatch) {
        Batch b;
        load_batch(base, tb, act ? nt : 0, row_base, b);
        add_batch(b, row_base);
      }
    }

    if (row < end) {
      const long long q = row / chunk;
      float* dst = out + q * out_stride + (row - q * chunk) * rs;
      if (vec_out) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int s = 4 * sub; s < rs; s += 4 * kRowLanes) {
          reinterpret_cast<float4*>(dst + s)[0] =
              live ? reinterpret_cast<const float4*>(acc + s)[0] : zero;
        }
      } else {
        for (int s = sub; s < rs; s += kRowLanes) dst[s] = live ? acc[s] : 0.0f;
      }
    }
    __syncwarp();  // the rows are read out before the next ones zero acc
  }
}

// Launches the walk over Q * C rows; returns the launch's error.
template <typename Scorer>
cudaError_t launch(const Scorer& scorer, const uint8_t* loc, const int32_t* st,
                   const int32_t* ln, float* o, long long rows, int n_terms,
                   int chunk, int rs, long long out_stride, int vec_out,
                   cudaStream_t s) {
  const int per = rows_per_warp(n_terms);
  const long long rows_a_block = static_cast<long long>(kRowWarps) * per;
  const unsigned grid = static_cast<unsigned>((rows + rows_a_block - 1) / rows_a_block);
  kernel<Scorer><<<grid, kThreads, 0, s>>>(
      scorer, loc, st, ln, o, rows, n_terms, chunk, rs, out_stride, vec_out, per);
  return cudaGetLastError();
}

}  // namespace range_rows
}  // namespace bm25
