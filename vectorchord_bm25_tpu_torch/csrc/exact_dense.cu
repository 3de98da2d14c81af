// Gather and scatter of the exact engine's dense strategy (sm_90a).
//
// Replaces the gather and the scatter-add of the XLA-lowered reference
// kernel vectorchord_bm25_tpu/search/exact.py::_score_and_topk (:148-182).
// For each window i of one term ordinal (posting row r, live lanes
// [lo, hi), query row q) and each lane l in [lo, hi):
//
//     d = post_docid[r, l]
//     acc[q * stride + d] += float(post_impact[r, l]) * doc_live[d]
//
// with f32 or bf16 impacts.  A launch takes the whole [n_q, P] window matrix
// and one ordinal: a warp whose window has another ordinal (or is a pad,
// ordinal -1) leaves at once, so the host sorts nothing.  Lanes outside [lo, hi) add +0.0 in the
// reference, which changes no bit of a non-negative accumulator, so they
// are skipped here and read nothing.
//
// Design.  The mould of stream_dense.cu without the decode: one warp per
// window, four lanes a thread, the doc ids and impacts of a row read as
// coalesced lines.  A thread loads the accumulator cells of all its live
// lanes before it stores any: the docs of one window are distinct, so the
// four read-add-writes are independent and their loads overlap.
//
// Exactness.  The wrapper launches once per term ordinal, ascending, on the
// windows that carry it.  Inside
// one launch each (query, doc) is hit at most once (a term's postings are
// unique per doc, and a repeated query term gets an ordinal of its own), so
// a plain read-add-write is exact and race-free (a global atomicAdd would
// flush subnormals), and across launches the adds land in the reference's
// window order, which is term order.  `__fmul_rn` and `__fadd_rn` keep the
// compiler from contracting the product into the sum.
//
// Bound.  8 B a live lane read (6 B with bf16), a 4-B doc_live gather from
// a table that stays in L2, and a 4-B random read-modify-write into a
// [q, N+1] accumulator of up to 1 GiB (a 32-B sector each way): bound by
// the latency and sector traffic of the scattered updates, and below the
// accumulator's own zero-fill, which moves all of it.

#include "impact.cuh"

namespace {

template <typename Impact>
__global__ void exact_dense_kernel(
    const int32_t* __restrict__ post_docid,  // [R+1, 128]
    const Impact* __restrict__ post_impact,  // [R+1, 128]
    const float* __restrict__ doc_live,      // [N+1]
    const int32_t* __restrict__ win_row,     // [n_q, P]
    const int32_t* __restrict__ win_lo,      // [n_q, P]
    const int32_t* __restrict__ win_hi,      // [n_q, P]
    const int32_t* __restrict__ win_ord,     // [n_q, P] term ordinal, -1 = pad
    float* __restrict__ acc,                 // [n_q, stride]
    int n_windows, int p_width, int ordinal, int64_t stride, int n_docs,
    int n_rows) {
  const int idx = blockIdx.x * bm25::kExactWarpsPerBlock + (threadIdx.x >> 5);
  // Whole warps leave together: past the matrix, or not this launch's term.
  if (idx >= n_windows || win_ord[idx] != ordinal) return;
  const int q = idx / p_width;
  const int r = win_row[idx];
  if (r < 0 || r >= n_rows) return;
  const int lo = win_lo[idx];
  const int hi = win_hi[idx];
  const int64_t base = static_cast<int64_t>(r) * bm25::kRowLanes;
  float* row = acc + static_cast<int64_t>(q) * stride;
  bool live[bm25::kRowLanesPerThread];
  int doc[bm25::kRowLanesPerThread];
  float sc[bm25::kRowLanesPerThread], old[bm25::kRowLanesPerThread];
#pragma unroll
  for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
    const int lane = bm25::row_lane(j);
    live[j] = lane >= lo && lane < hi;
    if (live[j]) {
      doc[j] = post_docid[base + lane];
      live[j] = doc[j] >= 0 && doc[j] <= n_docs;
    }
    if (live[j]) {
      sc[j] = __fmul_rn(bm25::widen(post_impact[base + lane]), doc_live[doc[j]]);
      old[j] = row[doc[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
    if (live[j]) row[doc[j]] = __fadd_rn(old[j], sc[j]);
  }
}

}  // namespace

// n_windows = n_q * P.  impact_bf16 != 0: post_impact holds bf16, else f32.
// n_rows counts the pad row.  stride: floats between two queries'
// accumulator rows.
extern "C" int bm25_exact_dense_accumulate(
    const void* post_docid, const void* post_impact, const void* doc_live,
    const void* win_row, const void* win_lo, const void* win_hi,
    const void* win_ord, void* acc, int n_windows, int p_width, int ordinal,
    long long stride, int n_docs, int n_rows, int impact_bf16, void* stream) {
  if (n_windows < 0 || p_width < 1 || ordinal < 0 || stride < n_docs + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>(
      (n_windows + bm25::kExactWarpsPerBlock - 1) / bm25::kExactWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pd = static_cast<const int32_t*>(post_docid);
  const float* lv = static_cast<const float*>(doc_live);
  const int32_t* wr = static_cast<const int32_t*>(win_row);
  const int32_t* wl = static_cast<const int32_t*>(win_lo);
  const int32_t* wh = static_cast<const int32_t*>(win_hi);
  const int32_t* wo = static_cast<const int32_t*>(win_ord);
  float* a = static_cast<float*>(acc);
  const int64_t st = static_cast<int64_t>(stride);
  if (impact_bf16) {
    exact_dense_kernel<__nv_bfloat16><<<blocks, bm25::kExactThreads, 0, s>>>(
        pd, static_cast<const __nv_bfloat16*>(post_impact), lv, wr, wl, wh, wo,
        a, n_windows, p_width, ordinal, st, n_docs, n_rows);
  } else {
    exact_dense_kernel<float><<<blocks, bm25::kExactThreads, 0, s>>>(
        pd, static_cast<const float*>(post_impact), lv, wr, wl, wh, wo, a,
        n_windows, p_width, ordinal, st, n_docs, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
