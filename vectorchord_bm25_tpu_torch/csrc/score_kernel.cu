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
// Design.  One block per row, one thread per range slot (RS <= 256,
// index/ranges.py caps range-local ids at one byte), the RS f32
// accumulators in shared memory.  For each term t in ascending order,
// thread `lane` loads its posting (coalesced: neighbouring lanes read
// neighbouring postings) and atomically adds the impact into its slot;
// a barrier separates the terms.  The TPU kernel turned this scatter into
// a one-hot matmul on the MXU because the TPU has no fast scatter; a
// shared-memory atomic is the GPU's native scatter and needs no RS x RS
// one-hot operand.  Mosaic's slice-alignment rule kept the gather out of
// the Pallas kernel; CUDA has no such rule, so the gather and the length
// mask are fused here: masked lanes read nothing, so no padding to 8 rows
// and no out-of-range read is needed.
//
// Exactness.  On index data the range-local slots inside one (term,
// range) group are unique (postings are doc-ascending), so no two threads
// ever add to one slot within a term and each slot sums its terms in
// ascending t.  That is the order of the one-hot matmul (one nonzero per
// slot per term) and of the plain PyTorch version, so the result is equal
// bit for bit.  Inputs with duplicate slots in one window (random tests)
// add in atomic order and agree to f32 rounding.
//
// Bound.  Each active lane reads 5 B (f32 impact + u8 slot; 3 B with bf16)
// and the row writes 4*RS B; there is one add per posting, so the kernel
// is bound by memory traffic (and by the latency of the scattered window
// starts), far below the card's arithmetic rate.

#include "impact.cuh"

namespace {

constexpr int kMaxRangeSize = 256;

template <typename Impact>
__global__ void fused_range_scores_kernel(
    const Impact* __restrict__ post_impact,  // [P]
    const uint8_t* __restrict__ post_local,  // [P]
    const int32_t* __restrict__ starts,      // [Q, T, C]
    const int32_t* __restrict__ lens,        // [Q, T, C]
    float* __restrict__ out,                 // [Q, *] rows of C * RS
    int n_terms, int chunk, int rs, long long out_stride) {
  __shared__ float acc[kMaxRangeSize];
  const int row = blockIdx.x;  // q * C + c
  const int q = row / chunk;
  const int c = row - q * chunk;
  const int lane = threadIdx.x;

  acc[lane] = 0.0f;
  __syncthreads();
  for (int t = 0; t < n_terms; ++t) {
    const int64_t meta = (static_cast<int64_t>(q) * n_terms + t) * chunk + c;
    const int len = lens[meta];
    if (lane < len) {
      const int64_t p = static_cast<int64_t>(starts[meta]) + lane;
      // A u8 slot stays inside the 256-entry acc.  Slots in [RS, 256)
      // land in entries that are never written out, so they are dropped,
      // as the TPU kernel's one-hot matmul drops them.  No bounds branch:
      // one cost 14% of the kernel's time at the slice's shapes on an
      // H100 at 700 W.
      atomicAdd(&acc[post_local[p]], bm25::widen(post_impact[p]));
    }
    __syncthreads();
  }
  out[q * out_stride + static_cast<int64_t>(c) * rs + lane] = acc[lane];
}

}  // namespace

// impact_bf16 != 0: post_impact holds bf16, else f32.  out_stride: floats
// between the starts of two queries' rows in `out` (C * RS when dense).
extern "C" int bm25_fused_range_scores(
    const void* post_impact, const void* post_local, const void* starts,
    const void* lens, void* out, int n_queries, int n_terms, int chunk,
    int rs, long long out_stride, int impact_bf16, void* stream) {
  if (rs < 1 || rs > kMaxRangeSize) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_queries) * chunk;
  if (rows == 0) return 0;
  const dim3 grid(static_cast<unsigned int>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  if (impact_bf16) {
    fused_range_scores_kernel<__nv_bfloat16><<<grid, rs, 0, s>>>(
        static_cast<const __nv_bfloat16*>(post_impact), loc, st, ln, o,
        n_terms, chunk, rs, out_stride);
  } else {
    fused_range_scores_kernel<float><<<grid, rs, 0, s>>>(
        static_cast<const float*>(post_impact), loc, st, ln, o, n_terms,
        chunk, rs, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
