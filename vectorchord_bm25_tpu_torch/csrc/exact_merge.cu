// SP-exact (sm_90a): the exact engine's sparse strategy in one launch.
//
// Replaces the XLA-lowered reference kernel
// vectorchord_bm25_tpu/search/exact.py::_score_and_topk_sparse (:185-254)
// whole: the masked gather of 128-lane posting-row windows (:217-225), the
// sort by doc, the run sums and the top-k.  The parent's chain for it was
// E2 (exact_sparse.cu, every lane written), torch.sort, a gather, S4 and
// torch.topk; E2 stays for its tests and for chip_smoke.py's comparison,
// off the engine's path.
//
// The window source of sparse_merge.cuh: window qp is posting row
// win_row[qp], lanes [win_lo, win_hi), a warp a window, thread t lanes t +
// 32 j (E2's layout), its first doc post_docid[row, win_lo].  A live lane
// (inside its range, a doc in [0, n_docs)) scores (impact * doc_live[doc])
// * filter[doc] with __fmul_rn in the reference's order, E2's expression
// bit for bit; bf16 impacts are widened first.

#include "impact.cuh"
#include "sparse_merge.cuh"

namespace {

using bm25::merge::Args;

template <typename Impact>
struct RowSource {
  const int32_t* __restrict__ post_docid;  // [R+1, 128]
  const Impact* __restrict__ post_impact;  // [R+1, 128]
  const float* __restrict__ doc_live;      // [N+1]
  const float* __restrict__ filter;        // [N+1]
  const int32_t* __restrict__ win_row;     // [Q, P]
  const int32_t* __restrict__ win_lo;      // [Q, P]
  const int32_t* __restrict__ win_hi;      // [Q, P]
  int n_rows;

  __device__ __forceinline__ int base(long long qp) const {
    const int r = win_row[qp], lo = win_lo[qp];
    if (r < 0 || r >= n_rows || lo < 0 || lo >= win_hi[qp] || lo >= bm25::kRowLanes) {
      return 0x7FFFFFFF;
    }
    return post_docid[static_cast<long long>(r) * bm25::kRowLanes + lo];
  }

  __device__ __forceinline__ void lanes(long long qp, int n_docs, int doc[4], float sc[4],
                                        bool live[4]) const {
    const int r = win_row[qp], lo = win_lo[qp], hi = win_hi[qp];
    const bool row_ok = r >= 0 && r < n_rows;
    const long long row = static_cast<long long>(r) * bm25::kRowLanes;
#pragma unroll
    for (int j = 0; j < bm25::kRowLanesPerThread; ++j) {
      const int lane = bm25::row_lane(j);
      live[j] = false;
      doc[j] = n_docs;
      sc[j] = 0.0f;
      if (row_ok && lane >= lo && lane < hi) {
        const int got = post_docid[row + lane];
        if (got >= 0 && got < n_docs) {
          live[j] = true;
          doc[j] = got;
          sc[j] = __fmul_rn(__fmul_rn(bm25::widen(post_impact[row + lane]), doc_live[got]),
                            filter[got]);
        }
      }
    }
  }
};

template <typename Impact>
int launch_rows(const void* post_docid, const void* post_impact, const void* doc_live,
                const void* filter, const void* win_row, const void* win_lo,
                const void* win_hi, int n_rows, const Args& args, cudaStream_t stream) {
  RowSource<Impact> src{
      static_cast<const int32_t*>(post_docid), static_cast<const Impact*>(post_impact),
      static_cast<const float*>(doc_live), static_cast<const float*>(filter),
      static_cast<const int32_t*>(win_row), static_cast<const int32_t*>(win_lo),
      static_cast<const int32_t*>(win_hi), n_rows};
  return bm25::merge::launch(src, args, stream);
}

}  // namespace

// One launch: out_s / out_i [Q, k] as bm25_stream_sparse_merge's, from
// posting-row windows.  impact_bf16 != 0: post_impact holds bf16, else f32;
// n_rows counts the pad row; filter [N+1] f32 (1 keeps the doc).
extern "C" int bm25_exact_sparse_merge(
    const void* post_docid, const void* post_impact, const void* doc_live,
    const void* filter, const void* win_row, const void* win_lo, const void* win_hi,
    const void* seg_off, const void* plan, void* out_s, void* out_i, void* scratch,
    int n_q, int P, int S, int n_blocks, int n_docs, int n_rows, int impact_bf16, int k,
    int kk, int seg_steps, void* stream) {
  Args args{static_cast<const int32_t*>(seg_off), static_cast<const int32_t*>(plan),
            static_cast<float*>(out_s), static_cast<int32_t*>(out_i),
            static_cast<unsigned char*>(scratch), n_q, P, S, n_blocks, n_docs, k, kk,
            seg_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (impact_bf16) {
    return launch_rows<__nv_bfloat16>(post_docid, post_impact, doc_live, filter, win_row,
                                      win_lo, win_hi, n_rows, args, s);
  }
  return launch_rows<float>(post_docid, post_impact, doc_live, filter, win_row, win_lo,
                            win_hi, n_rows, args, s);
}
