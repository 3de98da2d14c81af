// Exact rescore of MaxScore candidates (sm_90a): S5 stream_rescore.
//
// Replaces the XLA-lowered reference kernel M4
// vectorchord_bm25_tpu/search/stream.py::_stream_rescore (:366-431), up to
// its final sort.  For each (query q, candidate c) it writes
//
//     score = sum over terms t, ascending, of the posting of c in term t
//             (0 when t has none), or -inf unless c < n_docs and score > 0.
//
// A term's windows [t_lo, t_hi) are doc-ascending; the window that can hold
// c is the last whose base is <= c (an empty span, or a c below the first
// base, selects none and adds 0, as the reference's pad window does).
//
// Design.  One warp per (q, c).  Per term, every thread runs the same
// binary search on w_base (one broadcast load a step, L2-resident at the
// tables' sizes), the warp decodes that window with window_decode.cuh
// (shared with S1 and S3), the one lane whose doc equals c scores it, and a
// butterfly sum brings it to every thread.  Deleted and filtered docs score
// exactly 0.0 through s1_eff = +inf.
//
// Exactness.  A window holds a doc at most once, so the butterfly adds one
// score to zeros: exact.  The terms add in ascending t from 0.0f with
// __fadd_rn, as the plain version does; the reference's jnp.sum over t
// follows XLA's order, so against the reference the scores agree to a few
// ulps (the repo's tests use rtol 2e-6) and the ids exactly.
//
// Bound.  Latency: per term about log2(span) dependent loads of w_base, then
// one window of words.  The [q, C] output is 4 B a candidate.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "window_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void stream_rescore_kernel(
    const uint32_t* __restrict__ words,   // [S]
    const float* __restrict__ s1_eff,     // [N+1]
    const int32_t* __restrict__ w_off,    // [W+1]
    const int32_t* __restrict__ w_base,   // [W+1]
    const uint16_t* __restrict__ w_meta,  // [W+1]
    const float* __restrict__ w_s0,       // [W+1]
    const int32_t* __restrict__ cand,     // [n_q, n_c] doc ids (pad = n_docs)
    const int32_t* __restrict__ t_lo,     // [n_q, n_t] window spans
    const int32_t* __restrict__ t_hi,     // [n_q, n_t]
    float* __restrict__ out,              // [n_q, n_c]
    int n_q, int n_c, int n_t, int n_docs) {
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= static_cast<int64_t>(n_q) * n_c) return;  // whole warps leave together
  const bool leader = (threadIdx.x & 31u) == 0;
  const int c = cand[g];
  if (c < 0 || c >= n_docs) {
    if (leader) out[g] = -CUDART_INF_F;
    return;
  }
  const int64_t row = (g / n_c) * n_t;
  float sum = 0.0f;
  for (int t = 0; t < n_t; ++t) {
    const int lo = t_lo[row + t];
    int l = lo, r = t_hi[row + t];
    while (l < r) {
      const int m = l + ((r - l) >> 1);
      if (w_base[m] <= c) {
        l = m + 1;
      } else {
        r = m;
      }
    }
    float mine = 0.0f;
    if (l > lo) {  // warp-uniform: every thread ran the same search
      const bm25::Window win =
          bm25::load_window(w_off, w_base, w_meta, w_s0, l - 1);
      int doc[bm25::kLanesPerThread];
      float tf[bm25::kLanesPerThread];
      bm25::decode_lanes(words, win, doc, tf);
#pragma unroll
      for (int j = 0; j < bm25::kLanesPerThread; ++j) {
        if (bm25::lane_of(j) < win.len && doc[j] == c) {
          mine = bm25::posting_score(tf[j], win.s0, s1_eff[c]);
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      mine = __fadd_rn(mine, __shfl_xor_sync(0xFFFFFFFFu, mine, d));
    }
    sum = __fadd_rn(sum, mine);
  }
  if (leader) out[g] = sum > 0.0f ? sum : -CUDART_INF_F;
}

}  // namespace

extern "C" int bm25_stream_rescore(
    const void* words, const void* s1_eff, const void* w_off,
    const void* w_base, const void* w_meta, const void* w_s0,
    const void* cand, const void* t_lo, const void* t_hi, void* out, int n_q,
    int n_c, int n_t, int n_docs, void* stream) {
  if (n_q < 0 || n_c < 0 || n_t < 0 || n_docs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pairs = static_cast<long long>(n_q) * n_c;
  if (pairs == 0) return 0;
  const long long blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  stream_rescore_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(t_lo),
      static_cast<const int32_t*>(t_hi), static_cast<float*>(out), n_q, n_c, n_t,
      n_docs);
  return static_cast<int>(cudaGetLastError());
}
