// Gather and scatter of the exact engine's compact form (sm_90a).
//
// Replaces the gather and the scatter-add of the XLA-lowered reference
// kernel vectorchord_bm25_tpu/search/exact.py::_score_and_topk_compact
// (:95-145), which reads the range index's 5 B/posting streams (3 B with
// bf16 impacts).  A launch takes the whole [n_q, G] group matrix and one
// term ordinal; a warp whose group has another ordinal (or is a pad,
// ordinal -1) leaves at once.  For each group g of that ordinal, with query
// row q, and each lane l < tr_start[g + 1] - tr_start[g]:
//
//     p   = tr_start[g] + l
//     doc = min(tr_range[g], n_docs / rs + 1) * rs + post_local[p]
//     acc[q * stride + doc] += float(post_impact[p])
//
// The clamp comes before the multiply: the pad group's range is INT_MAX
// (its length is 0, so it adds nothing either way).  Lanes past a group's
// length add +0.0 to the pad doc in the reference; they are skipped here.
// The live mask and the filter are multiplied in after the sum by the
// caller, as the reference does.
//
// Design.  The window addressing of score_kernel.cu (starts, and lengths
// from tr_start diffs, u8 locals), with a scatter into acc[q, doc] in place
// of the per-range slot accumulator.  One warp per group; a group holds at
// most rs <= 256 postings, so a thread takes up to eight lanes (l = t,
// t + 32, ...), each load a coalesced line, and loads the accumulator cells
// of all its lanes before it stores any (the docs of one group are
// distinct).
//
// Exactness.  As exact_dense.cu: one launch per term ordinal, ascending, so
// inside a launch each (query, doc) is hit at most once and a plain
// read-add-write with `__fadd_rn` is exact and race-free; across launches
// the adds land in the reference's group order, which is term order.
//
// Bound.  5 B a lane read (3 B with bf16), 12 B of group metadata a group,
// and a 4-B random read-modify-write into the [q, N+1] accumulator: bound
// by the latency and sector traffic of the scattered updates.

#include "impact.cuh"

namespace {

constexpr int kMaxRangeSize = 256;  // range-local ids are one byte
constexpr int kLanesPerThread = kMaxRangeSize / 32;

template <typename Impact>
__global__ void exact_compact_kernel(
    const Impact* __restrict__ post_impact,  // [P]
    const uint8_t* __restrict__ post_local,  // [P]
    const int32_t* __restrict__ tr_range,    // [M+1]
    const int32_t* __restrict__ tr_start,    // [M+2]
    const int32_t* __restrict__ grp_ids,     // [n_q, G]
    const int32_t* __restrict__ grp_ord,     // [n_q, G] term ordinal, -1 = pad
    float* __restrict__ acc,                 // [n_q, stride]
    int n_groups, int g_width, int ordinal, int64_t stride, int n_docs,
    int rs, int n_slots, int n_postings) {
  const int idx = blockIdx.x * bm25::kExactWarpsPerBlock + (threadIdx.x >> 5);
  // Whole warps leave together: past the matrix, or not this launch's term.
  if (idx >= n_groups || grp_ord[idx] != ordinal) return;
  const int q = idx / g_width;
  const int g = grp_ids[idx];
  if (g < 0 || g >= n_slots) return;
  const int start = tr_start[g];
  int len = tr_start[g + 1] - start;
  len = len < rs ? len : rs;
  if (start < 0 || len <= 0 || start > n_postings - len) return;
  const int cap = n_docs / rs + 1;
  const int range = tr_range[g] < cap ? tr_range[g] : cap;
  const int doc0 = range * rs;
  float* row = acc + static_cast<int64_t>(q) * stride;
  const int t = static_cast<int>(threadIdx.x & 31);
  bool live[kLanesPerThread];
  int doc[kLanesPerThread];
  float sc[kLanesPerThread], old[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int l = j * 32 + t;
    live[j] = l < len;
    if (live[j]) {
      doc[j] = doc0 + post_local[start + l];
      live[j] = doc[j] <= n_docs;
    }
    if (live[j]) {
      sc[j] = bm25::widen(post_impact[start + l]);
      old[j] = row[doc[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    if (live[j]) row[doc[j]] = __fadd_rn(old[j], sc[j]);
  }
}

}  // namespace

// n_groups = n_q * G.  impact_bf16 != 0: post_impact holds bf16, else f32.
// n_slots: entries of tr_range (M + 1, the pad slot included); tr_start has
// one more.
extern "C" int bm25_exact_compact_accumulate(
    const void* post_impact, const void* post_local, const void* tr_range,
    const void* tr_start, const void* grp_ids, const void* grp_ord, void* acc,
    int n_groups, int g_width, int ordinal, long long stride, int n_docs,
    int rs, int n_slots, int n_postings, int impact_bf16, void* stream) {
  if (n_groups < 0 || g_width < 1 || ordinal < 0 || rs < 1 ||
      rs > kMaxRangeSize || stride < n_docs + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_groups == 0) return 0;
  const unsigned int blocks = static_cast<unsigned int>(
      (n_groups + bm25::kExactWarpsPerBlock - 1) / bm25::kExactWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const int32_t* rg = static_cast<const int32_t*>(tr_range);
  const int32_t* st = static_cast<const int32_t*>(tr_start);
  const int32_t* gi = static_cast<const int32_t*>(grp_ids);
  const int32_t* go = static_cast<const int32_t*>(grp_ord);
  float* a = static_cast<float*>(acc);
  const int64_t sd = static_cast<int64_t>(stride);
  if (impact_bf16) {
    exact_compact_kernel<__nv_bfloat16><<<blocks, bm25::kExactThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(post_impact), loc, rg, st, gi, go, a,
        n_groups, g_width, ordinal, sd, n_docs, rs, n_slots, n_postings);
  } else {
    exact_compact_kernel<float><<<blocks, bm25::kExactThreads, 0, s>>>(
        static_cast<const float*>(post_impact), loc, rg, st, gi, go, a,
        n_groups, g_width, ordinal, sd, n_docs, rs, n_slots, n_postings);
  }
  return static_cast<int>(cudaGetLastError());
}
