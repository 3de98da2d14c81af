// Gather and accumulate of the exact engine's dense strategy (sm_90a).
//
// Replaces the gather, the zero-fill and the scatter-add of the
// XLA-lowered reference kernel
// vectorchord_bm25_tpu/search/exact.py::_score_and_topk (:148-182), and the
// filter multiply after it.  For each query row q, each window i of row q
// of the [n_q, P] window matrix whose term ordinal lies in [0, n_ord)
// (posting row r, live lanes [lo, hi)) and each lane l in [lo, hi):
//
//     d = post_docid[r, l]
//     acc[q * stride + d] += float(post_impact[r, l]) * doc_live[d]
//
// into an accumulator that starts at zero, with f32 or bf16 impacts; then,
// where the caller passes a filter, acc[q, d] *= filter[d] for d <= n_docs.
// Lanes outside [lo, hi) add +0.0 in the reference, which changes no bit
// of a non-negative accumulator, so they are skipped and read nothing.
//
// Design.  The doc-tile walk of dense_tiles.cuh: a block owns a tile of one
// query's row in shared memory, takes the windows of each term-ordinal run
// whose docs can fall in it, and writes the row's cells once, the filter
// applied in the write.  A taken window is read by one warp, four lanes a
// thread, each of its loads a coalesced 128-B (64-B for bf16) line; only
// lanes inside the tile gather doc_live and add.  A window's first doc is
// post_docid[r, lo]: a row's lanes hold one term's postings in doc order
// (index/sealed.py), and the planning cuts each term's span into rows in
// order (search/exact.py::_win_lists), ordinal runs with pads last.  The
// first version launched once per ordinal onto a zero-filled accumulator,
// a 4-B read-add-write a lane into device memory, and the engine then
// multiplied the filter in with a pass of its own over the whole
// accumulator (544 MB at [518, 131073]).
//
// Exactness.  As dense_tiles.cuh; `__fmul_rn` and `__fadd_rn` keep the
// compiler from contracting the product into the sum.

#include "dense_tiles.cuh"
#include "impact.cuh"

namespace {

using bm25::tiles::Key;
using bm25::tiles::kPad;

template <typename Impact>
struct RowSrc {
  const int32_t* __restrict__ post_docid;  // [R+1, 128]
  const Impact* __restrict__ post_impact;  // [R+1, 128]
  const float* __restrict__ doc_live;      // [N+1]
  const int32_t* __restrict__ win_row;     // [n_q, P]
  const int32_t* __restrict__ win_lo;      // [n_q, P]
  const int32_t* __restrict__ win_hi;      // [n_q, P]
  const int32_t* __restrict__ win_ord;     // [n_q, P] term ordinal, -1 = pad
  int p_width, n_ord, n_rows;

  __device__ __forceinline__ void span(int q, int& b, int& e) const {
    b = q * p_width;
    e = b + p_width;
  }

  __device__ __forceinline__ int ord(int i) const {
    const int o = win_ord[i];
    return o >= 0 && o < n_ord ? o : kPad;
  }

  __device__ __forceinline__ Key key(int i) const {
    Key k;
    k.ord = ord(i);
    k.first = 0;
    k.bad = 0;
    if (k.ord != kPad) {
      const int r = win_row[i], lo = win_lo[i], hi = win_hi[i];
      k.bad = !(r >= 0 && r < n_rows && lo >= 0 && lo < hi && hi <= bm25::kRowLanes);
      if (!k.bad) k.first = post_docid[static_cast<int64_t>(r) * bm25::kRowLanes + lo];
    }
    return k;
  }

  // The walk hands load() only windows whose row and lanes key() accepted.
  __device__ __forceinline__ void load(int i, int tlo, int thi, int n_docs,
                                       bm25::tiles::Lanes& out) const {
    const int lo = win_lo[i], hi = win_hi[i];
    const int64_t base = static_cast<int64_t>(win_row[i]) * bm25::kRowLanes;
    int doc[bm25::kRowLanesPerThread];
    float imp[bm25::kRowLanesPerThread];
#pragma unroll
    for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
      const int lane = bm25::row_lane(j);
      const bool in_row = lane >= lo && lane < hi;
      doc[j] = in_row ? post_docid[base + lane] : -1;
      imp[j] = in_row ? bm25::widen(post_impact[base + lane]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
      const bool live = doc[j] >= tlo && doc[j] < thi && doc[j] <= n_docs;
      out.cell[j] = live ? doc[j] - tlo : -1;
      if (live) out.sc[j] = __fmul_rn(imp[j], doc_live[doc[j]]);
    }
  }

  // One thread, lane by lane; a row out of range adds nothing, lanes are
  // clamped to the row.
  __device__ __forceinline__ void add_serial(int i, int tlo, int thi, int n_docs, float* tile,
                             int*, float*) const {
    if ((threadIdx.x & 31) != 0) return;
    const int r = win_row[i];
    if (r < 0 || r >= n_rows) return;
    const int64_t base = static_cast<int64_t>(r) * bm25::kRowLanes;
    const int hi = min(win_hi[i], bm25::kRowLanes);
    for (int l = max(win_lo[i], 0); l < hi; ++l) {
      const int d = post_docid[base + l];
      if (d < tlo || d >= thi || d > n_docs) continue;
      const float sc = __fmul_rn(bm25::widen(post_impact[base + l]), doc_live[d]);
      tile[d - tlo] = __fadd_rn(tile[d - tlo], sc);
    }
  }
};

template <typename Impact>
cudaError_t launch(const void* post_docid, const void* post_impact,
                   const void* doc_live, const void* win_row, const void* win_lo,
                   const void* win_hi, const void* win_ord, const void* filter,
                   void* acc, int n_q, int p_width, int n_ord, long long stride,
                   int n_docs, int n_rows, int tile, cudaStream_t s) {
  const RowSrc<Impact> src{
      static_cast<const int32_t*>(post_docid), static_cast<const Impact*>(post_impact),
      static_cast<const float*>(doc_live), static_cast<const int32_t*>(win_row),
      static_cast<const int32_t*>(win_lo), static_cast<const int32_t*>(win_hi),
      static_cast<const int32_t*>(win_ord), p_width, n_ord, n_rows};
  return bm25::tiles::launch_tiles(src, static_cast<float*>(acc),
                                   static_cast<int64_t>(stride), n_docs, n_q, tile,
                                   static_cast<const float*>(filter), s);
}

}  // namespace

// One launch for the whole [n_q, P] matrix (n_q * P < 2^31).  filter: [N+1]
// f32 or null.  impact_bf16 != 0: post_impact holds bf16, else f32.  n_rows
// counts the pad row.  acc: [n_q, stride] f32, rows 16-B aligned, stride a
// multiple of 4 and >= n_docs + 1; every cell is written.  tile: the widest
// doc tile a block owns, in floats (a multiple of 4).
extern "C" int bm25_exact_dense_accumulate(
    const void* post_docid, const void* post_impact, const void* doc_live,
    const void* win_row, const void* win_lo, const void* win_hi,
    const void* win_ord, const void* filter, void* acc, int n_q, int p_width,
    int n_ord, long long stride, int n_docs, int n_rows, int tile,
    int impact_bf16, void* stream) {
  if (n_q < 0 || p_width < 1 || n_ord < 0 ||
      static_cast<long long>(n_q) * p_width > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      impact_bf16
          ? launch<__nv_bfloat16>(post_docid, post_impact, doc_live, win_row, win_lo,
                                  win_hi, win_ord, filter, acc, n_q, p_width, n_ord,
                                  stride, n_docs, n_rows, tile, s)
          : launch<float>(post_docid, post_impact, doc_live, win_row, win_lo, win_hi,
                          win_ord, filter, acc, n_q, p_width, n_ord, stride, n_docs,
                          n_rows, tile, s);
  return static_cast<int>(err);
}
