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
// Design.  One block of 128 threads per window, one thread per lane.  The
// block reads the window's offset, base, meta and s0 by window id and
// decodes the meta: len = m & 0xFF, dbits = 2 << ((m >> 8) & 3),
// tfbits = tclass ? 1 << tclass : 0 with tclass = (m >> 10) & 7.  Lane l's
// delta sits at bit l * dbits (widths divide 32, so a value never
// straddles two words); the width is read at run time, so one kernel
// serves every width class where the TPU kernel specialised statically.
// Lane 0's delta is forced to 0 and an inclusive scan over the 128 lanes
// (warp shuffles, then the four warp totals through shared memory) plus
// the base gives the doc ids.  The tf words follow the doc words at word
// off + ((len * dbits + 31) >> 5); tfbits = 0 means every tf is 1.  Only
// live lanes touch memory: the stream's 64-word zero tail that the TPU
// kernel's fixed 32-word gather relied on is never needed here.
//
// Exactness.  The wrapper launches once per term ordinal, in ascending
// order.  Inside one launch each (query, doc) is hit at most once (a
// term's postings are unique per doc), so a plain read-add-write is exact
// and race-free, and across launches the adds land in the reference's
// window order.  The score keeps the reference's order of operations, and
// the build never passes --use_fast_math: `/` stays IEEE round-to-nearest
// (-prec-div=true, nvcc's default), so every lane equals the reference's
// f32 value bit for bit.
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

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;

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
    int64_t stride, int n_q, int n_docs) {
  __shared__ uint32_t warp_total[kWarps];
  const int lane = threadIdx.x;
  const int w = wsrc[blockIdx.x];
  const int q = wq[blockIdx.x];
  const uint32_t off = static_cast<uint32_t>(w_off[w]);
  const uint32_t m = w_meta[w];
  const uint32_t len = m & 0xFFu;
  const uint32_t dbits = 2u << ((m >> 8) & 3u);
  const uint32_t tclass = (m >> 10) & 7u;
  const uint32_t tfbits = tclass ? (1u << tclass) : 0u;
  const bool live = static_cast<uint32_t>(lane) < len;

  uint32_t delta = 0;
  if (live && lane > 0) {
    const uint32_t pos = static_cast<uint32_t>(lane) * dbits;
    delta = (words[off + (pos >> 5)] >> (pos & 31u)) & ((1u << dbits) - 1u);
  }

  // Inclusive scan over the 128 lanes.
  uint32_t sum = delta;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, sum, d);
    if ((lane & 31) >= d) sum += up;
  }
  if ((lane & 31) == 31) warp_total[lane >> 5] = sum;
  __syncthreads();
  for (int i = 0; i < (lane >> 5); ++i) sum += warp_total[i];

  if (!live || q < 0 || q >= n_q) return;
  const int doc = w_base[w] + static_cast<int>(sum);
  if (doc < 0 || doc > n_docs) return;

  float tf = 1.0f;
  if (tfbits) {
    const uint32_t toff = off + ((len * dbits + 31u) >> 5);
    const uint32_t pos = static_cast<uint32_t>(lane) * tfbits;
    tf = static_cast<float>(
        (words[toff + (pos >> 5)] >> (pos & 31u)) & ((1u << tfbits) - 1u));
  }
  // Explicit round-to-nearest intrinsics: nothing is contracted or
  // approximated, whatever the flags.
  const float sc = __fdiv_rn(__fmul_rn(tf, w_s0[w]), __fadd_rn(tf, s1_eff[doc]));
  float* slot = acc + static_cast<int64_t>(q) * stride + doc;
  *slot = __fadd_rn(*slot, sc);
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
  stream_dense_kernel<<<static_cast<unsigned int>(n_windows), kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(wsrc), static_cast<const int32_t*>(wq),
      static_cast<float*>(acc), static_cast<int64_t>(stride), n_q, n_docs);
  return static_cast<int>(cudaGetLastError());
}
