// Lane gather of the exact engine's sparse strategy (sm_90a).
//
// Replaces the gather of the XLA-lowered reference kernel
// vectorchord_bm25_tpu/search/exact.py::_score_and_topk_sparse (:217-225).
// For each window w = (q, p) of a [Q, P] matrix (posting row r, live lanes
// [lo, hi)) and each of its 128 lanes l:
//
//     valid = lo <= l < hi;  d = post_docid[r, l]
//     sc[q, p * 128 + l]  = (valid ? float(post_impact[r, l]) : 0)
//                           * doc_live[d] * filter[d]
//     doc[q, p * 128 + l] = valid ? d : n_docs
//
// the (doc, score) lanes that stream_sparse.cu's decode kernel makes for
// the stream engine, here from uncompressed rows.  The stable sort by doc,
// the run sums (sparse_combine in stream_sparse.cu) and the selection
// follow in ops/stream_sparse.py.
//
// Design.  One warp per window, four lanes a thread, every load and store a
// coalesced line.  A lane outside [lo, hi) is 0 * live * filter = +0.0 in
// the reference (both tables hold 0 or 1), so it is written as 0.0 without
// reading its posting.  bf16 impacts are widened first: both products are
// f32 (`__fmul_rn`, in the reference's order).
//
// Bound.  Per live lane 8 B of posting (6 B with bf16) and two 4-B table
// gathers that stay in L2; per lane 8 B written.  Bound by bytes: the
// output, 1 KiB a window, is most of them.

#include "impact.cuh"

namespace {

template <typename Impact>
__global__ void exact_sparse_kernel(
    const int32_t* __restrict__ post_docid,  // [R+1, 128]
    const Impact* __restrict__ post_impact,  // [R+1, 128]
    const float* __restrict__ doc_live,      // [N+1]
    const float* __restrict__ filter,        // [N+1]
    const int32_t* __restrict__ win_row,     // [Q * P]
    const int32_t* __restrict__ win_lo,      // [Q * P]
    const int32_t* __restrict__ win_hi,      // [Q * P]
    int32_t* __restrict__ doc_out,           // [Q * P * 128]
    float* __restrict__ sc_out,              // [Q * P * 128]
    int n_windows, int n_docs, int n_rows) {
  const int w = blockIdx.x * bm25::kExactWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_windows) return;  // whole warps leave together
  const int r = win_row[w];
  const bool row_ok = r >= 0 && r < n_rows;
  const int lo = win_lo[w];
  const int hi = win_hi[w];
  const int64_t base = static_cast<int64_t>(r) * bm25::kRowLanes;
  const int64_t out = static_cast<int64_t>(w) * bm25::kRowLanes;
#pragma unroll
  for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
    const int lane = bm25::row_lane(j);
    int d = n_docs;
    float sc = 0.0f;
    if (row_ok && lane >= lo && lane < hi) {
      const int got = post_docid[base + lane];
      if (got >= 0 && got <= n_docs) {
        d = got;
        sc = __fmul_rn(
            __fmul_rn(bm25::widen(post_impact[base + lane]), doc_live[d]),
            filter[d]);
      }
    }
    doc_out[out + lane] = d;
    sc_out[out + lane] = sc;
  }
}

}  // namespace

// impact_bf16 != 0: post_impact holds bf16, else f32.  n_rows counts the pad
// row.
extern "C" int bm25_exact_sparse_gather(
    const void* post_docid, const void* post_impact, const void* doc_live,
    const void* filter, const void* win_row, const void* win_lo,
    const void* win_hi, void* doc_out, void* sc_out, int n_windows,
    int n_docs, int n_rows, int impact_bf16, void* stream) {
  if (n_windows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>(
      (n_windows + bm25::kExactWarpsPerBlock - 1) / bm25::kExactWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pd = static_cast<const int32_t*>(post_docid);
  const float* lv = static_cast<const float*>(doc_live);
  const float* fm = static_cast<const float*>(filter);
  const int32_t* wr = static_cast<const int32_t*>(win_row);
  const int32_t* wl = static_cast<const int32_t*>(win_lo);
  const int32_t* wh = static_cast<const int32_t*>(win_hi);
  int32_t* d = static_cast<int32_t*>(doc_out);
  float* sc = static_cast<float*>(sc_out);
  if (impact_bf16) {
    exact_sparse_kernel<__nv_bfloat16><<<blocks, bm25::kExactThreads, 0, s>>>(
        pd, static_cast<const __nv_bfloat16*>(post_impact), lv, fm, wr, wl, wh,
        d, sc, n_windows, n_docs, n_rows);
  } else {
    exact_sparse_kernel<float><<<blocks, bm25::kExactThreads, 0, s>>>(
        pd, static_cast<const float*>(post_impact), lv, fm, wr, wl, wh, d, sc,
        n_windows, n_docs, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
