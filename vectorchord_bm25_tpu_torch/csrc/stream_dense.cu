// Window decompress, score and scatter for the stream engine's dense path
// (sm_90a).
//
// Replaces the XLA-lowered reference kernels M1
// vectorchord_bm25_tpu/search/stream.py::_unpack_and_score (:171-266) and
// the scatter-add of M2 _stream_dense (:296-303).  For each gathered window
// w of one term ordinal it computes, per lane l < len(w),
//
//     doc = w_base[w] + sum_{0 < j <= l} delta_j
//     acc[wq * stride + doc] += (tf_l * s0[w]) / (tf_l + s1_eff[doc])
//
// Design.  One warp per window, four lanes a thread, decoded by
// window_decode.cuh (shared with S3 and S5).  A thread loads the
// accumulator cells of all its live lanes before it stores any: the docs
// of one window are distinct, so the four read-add-writes are independent
// and their loads overlap.  Only live lanes touch memory: the stream's
// 64-word zero tail that the TPU kernel's fixed 32-word gather relied on is
// never needed here.
//
// Exactness.  The wrapper launches once per term ordinal, in ascending
// order.  Inside one launch each (query, doc) is hit at most once (a
// term's postings are unique per doc), so a plain read-add-write is exact
// and race-free, and across launches the adds land in the reference's
// window order.  The score keeps the reference's order of operations and
// the build never passes --use_fast_math, so every lane equals the
// reference's f32 value bit for bit.
//
// Bound.  A 4,096-query batch over 131,072 docs leaves over 5M nonzero
// accumulator cells in each of its two large dispatches: each live lane
// does a 4-B random read-modify-write into a 1.07 GB accumulator (a 32-B
// sector each way) and an s1_eff gather from a 0.5 MB table that stays in
// L2; the stream words are read once and coalesced.  So the kernel is
// bound by the latency and sector traffic of the scattered accumulator
// updates, a few hundred MB per dispatch.  The accumulator's zero-fill and
// the top-k's block-max pass each move the whole 1.07 GB, more than this
// kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void stream_dense_kernel(
    const uint32_t* __restrict__ words,   // [S]
    const float* __restrict__ s1_eff,     // [N+1]
    const int32_t* __restrict__ w_off,    // [W+1]
    const int32_t* __restrict__ w_base,   // [W+1]
    const uint16_t* __restrict__ w_meta,  // [W+1]
    const float* __restrict__ w_s0,       // [W+1]
    const int32_t* __restrict__ wsrc,     // [n_windows] this ordinal's windows
    const int32_t* __restrict__ wq,       // [n_windows] their query rows
    float* __restrict__ acc,              // [n_q, stride]
    int n_windows, int64_t stride, int n_q, int n_docs) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_windows) return;  // whole warps leave together
  const int w = wsrc[i];
  const int q = wq[i];
  const bm25::Window win = bm25::load_window(w_off, w_base, w_meta, w_s0, w);
  int doc[bm25::kLanesPerThread];
  float tf[bm25::kLanesPerThread];
  bm25::decode_lanes(words, win, doc, tf);
  if (q < 0 || q >= n_q) return;
  float* row = acc + static_cast<int64_t>(q) * stride;
  bool live[bm25::kLanesPerThread];
  float sc[bm25::kLanesPerThread], old[bm25::kLanesPerThread];
#pragma unroll
  for (int j = 0; j < bm25::kLanesPerThread; ++j) {
    live[j] = bm25::lane_of(j) < win.len && doc[j] >= 0 && doc[j] <= n_docs;
    if (live[j]) {
      sc[j] = bm25::posting_score(tf[j], win.s0, s1_eff[doc[j]]);
      old[j] = row[doc[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < bm25::kLanesPerThread; ++j) {
    if (live[j]) row[doc[j]] = __fadd_rn(old[j], sc[j]);
  }
}

}  // namespace

extern "C" int bm25_stream_dense_accumulate(
    const void* words, const void* s1_eff, const void* w_off,
    const void* w_base, const void* w_meta, const void* w_s0,
    const void* wsrc, const void* wq, void* acc, int n_windows,
    long long stride, int n_q, int n_docs, void* stream) {
  if (n_windows < 0 || stride < n_docs + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  stream_dense_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(wsrc), static_cast<const int32_t*>(wq),
      static_cast<float*>(acc), n_windows, static_cast<int64_t>(stride), n_q,
      n_docs);
  return static_cast<int>(cudaGetLastError());
}
