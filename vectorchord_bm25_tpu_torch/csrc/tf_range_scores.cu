// In-range score accumulation from term frequencies: the Block-Max
// engine's round in posting_mode="tf" (sm_90a).
//
// Replaces the XLA scatter that vectorchord_bm25_tpu/search/blockmax.py::
// _blockmax_kernel runs in place of the Pallas kernel P1 when postings
// hold term frequencies (:169-182; P1 is forced off at :396-397).  The
// index stores 2 B a posting (u8 tf, or u16 when some tf exceeds 255,
// plus the u8 range-local doc id) and each posting's score is rebuilt the
// reference extension's way (bm25.rs:334-359):
//
//     doc   = min(cand_r[q, c] * RS + local, n_docs)
//     score = (tf * s0[q, t]) / (tf + s1_table[doc_fn[doc]])
//
//     out[q, c, slot] = sum_t sum_{lane < lens[q,t,c], local == slot} score
//
// Design: P1's warp-row walk (range_rows.cuh) instantiated with a scorer
// that rebuilds each score.  Per row it adds one load (the candidate
// range, with the starts and lengths), per (row, term) one (s0), per
// posting a u8 fieldnorm gather over the [N+1] table (L2-resident at the
// engine's sizes), issued for four terms together after their posting
// loads, and an IEEE multiply, add and divide in the reference's order
// (__fmul_rn, __fadd_rn, __fdiv_rn; the library is built without fast
// math), so each score is the reference's f32 expression bit for bit.
// The 1 KB s1 table is staged in shared memory once a block (64 rows at
// T <= 4); the first design copied it once a row, 134 MB of L2 reads in a
// first round (Q=4096, C=32), more than the kernel's whole DRAM bound.

// Lanes at or past a window's length add 0 / s1 = +0.0 (tf = 0) in the
// reference; adding +0.0 to a non-negative sum changes no bit, so the
// kernel skips them.  (With b = 1, s1_table[0] is 0 and such a lane adds
// 0/0 = NaN to whatever slot its stray posting names; the plain version
// reproduces that, the kernel does not.)  Slots inside one (term, range)
// group are unique on index data, so the sums add in ascending t as the
// reference's scatter does: the output equals the plain PyTorch version
// bit for bit.
//
// Bound.  Per active lane 3-4 B of postings and one fieldnorm byte read,
// one divide; the row writes 4*RS B.  Memory traffic bounds it, as P1;
// the divide is far below the card's f32 rate.

#include "range_rows.cuh"

namespace {

namespace rr = bm25::range_rows;
constexpr int kFieldnorms = 256;

// tf * s0 / (tf + s1[fieldnorm of the posting's doc]).
template <typename Tf>
struct TfScorer {
  static constexpr bool kRebuilds = true;
  struct Shared {
    float s1[kFieldnorms];
  };
  const Tf* __restrict__ post_tf;          // [P]
  const uint8_t* __restrict__ doc_fn;      // [N+1]
  const float* __restrict__ s1_table;      // [256]
  const float* __restrict__ q_s0;          // [Q, T]
  const int32_t* __restrict__ cand_r;      // [Q, C] = one entry a row
  int rs, n_docs;

  __device__ void stage(Shared& sh) const {
    for (int i = threadIdx.x; i < kFieldnorms; i += blockDim.x) sh.s1[i] = s1_table[i];
  }
  __device__ int row_base(long long row) const { return cand_r[row] * rs; }
  __device__ float term(int64_t qt) const { return q_s0[qt]; }
  __device__ float value(int64_t p) const { return static_cast<float>(post_tf[p]); }
  __device__ int gather(int base, int slot) const {
    return doc_fn[min(base + slot, n_docs)];
  }
  __device__ float score(float tf, int fn, float s0, const Shared& sh) const {
    return __fdiv_rn(__fmul_rn(tf, s0), __fadd_rn(tf, sh.s1[fn]));
  }
};

template <typename Tf>
cudaError_t launch(const void* post_tf, const uint8_t* loc, const uint8_t* fn,
                   const float* s1, const float* s0, const int32_t* cr,
                   const int32_t* st, const int32_t* ln, float* o,
                   long long rows, int n_terms, int chunk, int rs, int n_docs,
                   cudaStream_t s) {
  const TfScorer<Tf> scorer{static_cast<const Tf*>(post_tf), fn, s1, s0, cr, rs, n_docs};
  const int vec_out = reinterpret_cast<uintptr_t>(o) % 16 == 0 && rs % 4 == 0;
  return rr::launch(scorer, loc, st, ln, o, rows, n_terms, chunk, rs,
                    static_cast<long long>(chunk) * rs, vec_out, s);
}

}  // namespace

// tf_u16 != 0: post_tf holds u16 term frequencies, else u8.
extern "C" int bm25_tf_range_scores(
    const void* post_tf, const void* post_local, const void* doc_fn,
    const void* s1_table, const void* q_s0, const void* cand_r,
    const void* starts, const void* lens, void* out, int n_queries,
    int n_terms, int chunk, int rs, int n_docs, int tf_u16, void* stream) {
  if (rs < 1 || rs > rr::kMaxRangeSize) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_queries) * chunk;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const uint8_t* fn = static_cast<const uint8_t*>(doc_fn);
  const float* s1 = static_cast<const float*>(s1_table);
  const float* s0 = static_cast<const float*>(q_s0);
  const int32_t* cr = static_cast<const int32_t*>(cand_r);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      tf_u16 ? launch<uint16_t>(post_tf, loc, fn, s1, s0, cr, st, ln, o, rows,
                                n_terms, chunk, rs, n_docs, s)
             : launch<uint8_t>(post_tf, loc, fn, s1, s0, cr, st, ln, o, rows,
                               n_terms, chunk, rs, n_docs, s);
  return static_cast<int>(err);
}
