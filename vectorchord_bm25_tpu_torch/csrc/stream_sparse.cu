// The stream engine's sparse reduction (sm_90a): S3 window decode into
// per-query lanes and S4 run sums into packed selection keys.
//
// Replaces the XLA-lowered reference kernel M3
// vectorchord_bm25_tpu/search/stream.py::_stream_sparse (:309-363), minus
// its sort and its final top-k.  The engine runs, per dispatch of q queries
// padded to P windows each:
//
//   S3  stream_sparse_decode: M1 _unpack_and_score (:171-266) in the sparse
//       layout (:327-332).  For a [q, P] matrix of window ids it writes all
//       [q, P*128] lanes: live lanes get their doc and (tf*s0)/(tf +
//       s1_eff[doc]); dead and pad lanes doc = n_docs and the same
//       expression at tf = 1, which is exactly 0.0 because s1_eff[n_docs] is
//       +inf.  The sort that follows sees every lane, so every lane is
//       written.  One warp per window, decoded by window_decode.cuh (shared
//       with S1 and S5); each of the warp's stores writes 32 neighbouring
//       lanes (128 B).
//   --  torch.sort(doc, stable=True) per row, and the scores gathered along.
//   S4  sparse_combine: the post-sort body (:339-353).  One thread per lane.
//       The last lane of each run of equal docs (doc < n_docs) sums its run
//       and writes the packed key of ops/topk.py::_pack,
//       ((inf_bits - f32 bits(sum)) << 32) | doc, or (inf_bits << 32) | doc
//       when the lane is no candidate (not a run end, a pad doc, or a sum
//       that is not > 0).
//   --  the k smallest keys per row (torch.topk), as lex_topk selects.
//
// Exactness of S4.  The reference sums runs with a Hillis-Steele scan,
// s[j] += (df[j] == df[j - 2^i]) ? s[j - 2^i] : 0 for i < seg_steps, and
// keeps the run's last lane.  Written from the run end j, that value is the
// aligned pairwise tree over x_m = s[j - m], m < 2^seg_steps, where a lane
// outside the run counts as +0.0: a run of 3 (a, b, c) ends as (c+b)+a, a
// run of 4 as (d+c)+(b+a).  S4 builds the same tree with a binary-counter
// stack in registers (depth <= seg_steps + 1); adding +0.0 to a score >= 0
// is exact, and f32 addition is commutative, so the sum is the reference's
// bit for bit.  The stable sort keeps each run in window order, which is
// the order the reference's stable lax.sort leaves it in.
//
// Bound.  A dispatch holds at most 2^26 lanes.  S3 reads each window's
// words once and writes 8 B a lane (512 MB at the cap); S4 reads the
// sorted 8 B a lane and writes an 8-B key.  Both are bound by device-memory
// bytes, well under the sort, which moves the lanes several times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr uint32_t kInfBits = 0x7F800000u;  // bits of +inf in f32
constexpr int kMaxSegSteps = 30;

__global__ void stream_sparse_decode_kernel(
    const uint32_t* __restrict__ words,   // [S]
    const float* __restrict__ s1_eff,     // [N+1]
    const int32_t* __restrict__ w_off,    // [W+1]
    const int32_t* __restrict__ w_base,   // [W+1]
    const uint16_t* __restrict__ w_meta,  // [W+1]
    const float* __restrict__ w_s0,       // [W+1]
    const int32_t* __restrict__ wsrc,     // [n_win] window ids, row-major [q, P]
    int32_t* __restrict__ doc_out,        // [n_win * 128]
    float* __restrict__ sc_out,           // [n_win * 128]
    int n_win, int n_docs) {
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_win) return;  // whole warps leave together
  const bm25::Window win =
      bm25::load_window(w_off, w_base, w_meta, w_s0, wsrc[i]);
  int doc[bm25::kLanesPerThread];
  float tf[bm25::kLanesPerThread];
  bm25::decode_lanes(words, win, doc, tf);
  const int64_t row = static_cast<int64_t>(i) * bm25::kWindowLanes;
#pragma unroll
  for (int j = 0; j < bm25::kLanesPerThread; ++j) {
    const uint32_t l = bm25::lane_of(j);
    const bool live = l < win.len && doc[j] >= 0 && doc[j] < n_docs;
    const int d = live ? doc[j] : n_docs;
    doc_out[row + l] = d;
    sc_out[row + l] = bm25::posting_score(live ? tf[j] : 1.0f, win.s0, s1_eff[d]);
  }
}

__global__ void sparse_combine_kernel(
    const int32_t* __restrict__ df,  // [rows, L] doc ids, each row sorted
    const float* __restrict__ sf,    // [rows, L] their scores
    int64_t* __restrict__ keys,      // [rows, L]
    int64_t total, int L, int n_docs, int seg_steps) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % L);
  const int d = df[idx];
  const bool last = j == L - 1 || df[idx + 1] != d;
  uint32_t hi = kInfBits;
  if (last && d < n_docs) {
    // The run's lanes that the scan reaches, newest first: x_m = sf[idx - m].
    const int reach = min(1 << seg_steps, j + 1);
    int n = 1;
    while (n < reach && df[idx - n] == d) ++n;
    float val[kMaxSegSteps + 2];
    int level[kMaxSegSteps + 2];
    int top = 0;
    for (int m = 0; m < n; ++m) {
      float v = sf[idx - m];
      int lv = 0;
      while (top > 0 && level[top - 1] == lv) {
        v = __fadd_rn(val[--top], v);
        ++lv;
      }
      val[top] = v;
      level[top] = lv;
      ++top;
    }
    // The partial subtrees left on the stack meet zero-padded partners
    // (exact) and then each other, smallest first.
    float s = val[--top];
    while (top > 0) s = __fadd_rn(val[--top], s);
    if (s > 0.0f) hi = kInfBits - __float_as_uint(s);
  }
  keys[idx] = static_cast<int64_t>(
      (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(d));
}

}  // namespace

extern "C" int bm25_stream_sparse_decode(
    const void* words, const void* s1_eff, const void* w_off,
    const void* w_base, const void* w_meta, const void* w_s0,
    const void* wsrc, void* doc_out, void* sc_out, int n_win, int n_docs,
    void* stream) {
  if (n_win < 0 || n_docs < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_win == 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n_win + kWarpsPerBlock - 1) / kWarpsPerBlock);
  stream_sparse_decode_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(wsrc), static_cast<int32_t*>(doc_out),
      static_cast<float*>(sc_out), n_win, n_docs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm25_sparse_combine(
    const void* df, const void* sf, void* keys, long long total, int L,
    int n_docs, int seg_steps, void* stream) {
  if (total < 0 || L <= 0 || total % L || seg_steps < 0 ||
      seg_steps > kMaxSegSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (total == 0) return 0;
  constexpr int kCombineThreads = 256;
  const long long blocks = (total + kCombineThreads - 1) / kCombineThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  sparse_combine_kernel<<<static_cast<unsigned int>(blocks), kCombineThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(df), static_cast<const float*>(sf),
      static_cast<int64_t*>(keys), static_cast<int64_t>(total), L, n_docs,
      seg_steps);
  return static_cast<int>(cudaGetLastError());
}
