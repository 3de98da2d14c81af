// SP-stream (sm_90a): the stream engine's sparse reduction in one launch.
//
// Replaces the XLA-lowered reference kernel M3
// vectorchord_bm25_tpu/search/stream.py::_stream_sparse (:309-363) whole:
// the decode and score of every window (M1, :171-266, in the sparse layout
// :327-332), the sort by doc, the run sums and the top-k.  The parent's
// chain for it was S3 (stream_sparse.cu, every lane written), torch.sort,
// a gather, S4 and torch.topk; S3 and S4 stay for their tests and for
// chip_smoke.py's comparison, off the engines' path.
//
// The window source of sparse_merge.cuh: window qp is wsrc[qp] of the
// compressed stream, decoded by window_decode.cuh (a warp a window, as S1,
// S3 and S5 do), its first doc w_base[wsrc[qp]].  A live lane (l < len, a
// doc in [0, n_docs)) scores (tf*s0)/(tf + s1_eff[doc]) through
// bm25::posting_score, S3's expression bit for bit; deleted and filtered
// docs score 0.0 through s1_eff = +inf and keep their place in their runs.

#include "sparse_merge.cuh"
#include "window_decode.cuh"

namespace {

using bm25::merge::Args;
using bm25::merge::Layout;

struct StreamSource {
  const uint32_t* __restrict__ words;   // [S]
  const float* __restrict__ s1_eff;     // [N+1]
  const int32_t* __restrict__ w_off;    // [W+1]
  const int32_t* __restrict__ w_base;   // [W+1]
  const uint16_t* __restrict__ w_meta;  // [W+1]
  const float* __restrict__ w_s0;       // [W+1]
  const int32_t* __restrict__ wsrc;     // [Q, P] window ids

  __device__ __forceinline__ int base(long long qp) const { return w_base[wsrc[qp]]; }

  __device__ __forceinline__ void lanes(long long qp, int n_docs, int doc[4], float sc[4],
                                        bool live[4]) const {
    const bm25::Window win = bm25::load_window(w_off, w_base, w_meta, w_s0, wsrc[qp]);
    float tf[bm25::kLanesPerThread], s1[bm25::kLanesPerThread];
    bm25::decode_lanes(words, win, doc, tf);
#pragma unroll
    for (int j = 0; j < bm25::kLanesPerThread; ++j) {
      live[j] = bm25::lane_of(j) < win.len && doc[j] >= 0 && doc[j] < n_docs;
      s1[j] = live[j] ? s1_eff[doc[j]] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < bm25::kLanesPerThread; ++j) {
      sc[j] = live[j] ? bm25::posting_score(tf[j], win.s0, s1[j]) : 0.0f;
    }
  }
};

}  // namespace

// Bytes of device-memory scratch a launch of SP-stream or SP-exact needs
// (ops/stream_sparse.py allocates it).
extern "C" long long bm25_sparse_merge_scratch(int n_q, int n_blocks, int n_s, int kk) {
  return Layout(n_q, n_blocks, n_s, kk).total;
}

// One launch: out_s / out_i [Q, k] (scores desc, ties to the lower doc,
// pads as the reference's).  kk = min(k, P * 128); plan [n_blocks] int32
// lists each row's parts in row order, row << 12 | part << 6 | (parts - 1),
// at most 64 parts a row; scratch: bm25_sparse_merge_scratch(Q,
// n_blocks, S, kk) bytes.
extern "C" int bm25_stream_sparse_merge(
    const void* words, const void* s1_eff, const void* w_off, const void* w_base,
    const void* w_meta, const void* w_s0, const void* wsrc, const void* seg_off,
    const void* plan, void* out_s, void* out_i, void* scratch, int n_q, int P, int S,
    int n_blocks, int n_docs, int k, int kk, int seg_steps, void* stream) {
  StreamSource src{
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(wsrc)};
  Args args{static_cast<const int32_t*>(seg_off), static_cast<const int32_t*>(plan),
            static_cast<float*>(out_s), static_cast<int32_t*>(out_i),
            static_cast<unsigned char*>(scratch), n_q, P, S, n_blocks, n_docs, k, kk,
            seg_steps};
  return bm25::merge::launch(src, args, static_cast<cudaStream_t>(stream));
}

