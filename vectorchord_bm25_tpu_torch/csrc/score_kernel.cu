// Fused in-range score accumulation for the Block-Max engine (sm_90a).
//
// Replaces the TPU kernel vectorchord_bm25_tpu/ops/score_kernel.py::
// accumulate_rows (Pallas body `_kernel`) together with the XLA window
// gather of its wrapper `fused_range_scores`.  For one (query q,
// candidate range c) row it computes
//
//     out[q, c, slot] = sum_t sum_{lane < lens[q,t,c]}
//                       float(post_impact[starts[q,t,c] + lane])
//                       * (post_local[starts[q,t,c] + lane] == slot)
//
// with f32 or bf16 impacts (`impact_dtype="bfloat16"`, the reference's
// widening at score_kernel.py:125; `__bfloat162float` is exact).  Rows are
// written at a caller-given row stride, so the exhaustive range sweep
// (search/blockmax.py::_rangescan_kernel) writes each chunk straight into
// its [Q, n_chunks * C * RS] accumulator.
//
// Design: the warp-row walk of range_rows.cuh (two rows a warp, sixteen
// lanes a row, all the warp's starts and lengths in one load, four terms'
// posting loads before the first add, all-zero rows written straight),
// instantiated with a scorer that reads the stored impact.  P1-tf
// (tf_range_scores.cu) instantiates the same walk with the tf rebuild.
// Mosaic's slice-alignment rule kept the gather out of the Pallas kernel;
// CUDA has no such rule, so the gather and the length mask are fused here.
//
// Bound.  Each active lane reads 5 B (f32 impact + u8 slot; 3 B with bf16),
// each row its 8 * T B of starts and lengths, and writes 4 * RS B; one add a
// posting: bound by memory traffic, far below the card's arithmetic rate.
// On an H100 at 700 W it runs at about 2.7 times that bound in a first
// round (Q=4096, T=4, C=32) and about 1.3 times in a later round, whose
// bound is the zero rows it writes.

#include "range_rows.cuh"

namespace {

namespace rr = bm25::range_rows;

// The stored impact is the posting's score.
template <typename Impact>
struct ImpactScorer {
  static constexpr bool kRebuilds = false;
  struct Shared {
    char unused;
  };
  const Impact* __restrict__ post_impact;  // [P]

  __device__ void stage(Shared&) const {}
  __device__ int row_base(long long) const { return 0; }
  __device__ float term(int64_t) const { return 0.0f; }
  __device__ float value(int64_t p) const { return bm25::widen(post_impact[p]); }
  __device__ int gather(int, int) const { return 0; }
  __device__ float score(float v, int, float, const Shared&) const { return v; }
};

}  // namespace

// impact_bf16 != 0: post_impact holds bf16, else f32.  out_stride: floats
// between the starts of two queries' rows in `out` (C * RS when dense).
extern "C" int bm25_fused_range_scores(
    const void* post_impact, const void* post_local, const void* starts,
    const void* lens, void* out, int n_queries, int n_terms, int chunk,
    int rs, long long out_stride, int impact_bf16, void* stream) {
  if (rs < 1 || rs > rr::kMaxRangeSize) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_queries) * chunk;
  if (rows == 0) return 0;
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      out_stride % 4 == 0 && rs % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      impact_bf16
          ? rr::launch(ImpactScorer<__nv_bfloat16>{
                           static_cast<const __nv_bfloat16*>(post_impact)},
                       loc, st, ln, o, rows, n_terms, chunk, rs, out_stride,
                       vec_out, s)
          : rr::launch(ImpactScorer<float>{static_cast<const float*>(post_impact)},
                       loc, st, ln, o, rows, n_terms, chunk, rs, out_stride,
                       vec_out, s);
  return static_cast<int>(err);
}
