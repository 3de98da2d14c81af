// In-range score accumulation from term frequencies: the Block-Max
// engine's round in posting_mode="tf" (sm_90a).
//
// Replaces the XLA scatter that vectorchord_bm25_tpu/search/blockmax.py::
// _blockmax_kernel runs in place of the Pallas kernel P1 when postings
// hold term frequencies (:169-182; P1 is forced off at :396-397).  The
// index stores 2 B a posting (u8 tf, or u16 when some tf exceeds 255,
// plus the u8 range-local doc id) and each posting's score is rebuilt the
// reference extension's way (bm25.rs:334-359):
//
//     doc   = min(cand_r[q, c] * RS + local, n_docs)
//     score = (tf * s0[q, t]) / (tf + s1_table[doc_fn[doc]])
//
//     out[q, c, slot] = sum_t sum_{lane < lens[q,t,c], local == slot} score
//
// Design: P1's (csrc/score_kernel.cu).  One block per (query, candidate
// range) row, one thread per slot, the RS f32 accumulators and the
// 256-entry s1 table in shared memory; terms in ascending t with a barrier
// between them, a shared-memory atomicAdd as the scatter.  Each lane does
// one u8/u16 load, one u8 slot load, one u8 fieldnorm load (a gather over
// the [N+1] table, L2-resident at the engine's sizes) and an IEEE
// multiply, add and divide in the reference's order (__fmul_rn,
// __fadd_rn, __fdiv_rn; the library is built without fast math), so each
// score is the reference's f32 expression bit for bit.
//
// Lanes at or past a window's length add 0 / s1 = +0.0 (tf = 0) in the
// reference; adding +0.0 to a non-negative sum changes no bit, so the
// kernel skips them.  (With b = 1, s1_table[0] is 0 and such a lane adds
// 0/0 = NaN to whatever slot its stray posting names; the plain version
// reproduces that, the kernel does not.)  Slots inside one (term, range)
// group are unique on index data, so the sums add in ascending t as the
// reference's scatter does: the output equals the plain PyTorch version
// bit for bit.
//
// Bound.  Per active lane 3-4 B of postings and one fieldnorm byte read,
// one divide; the row writes 4*RS B.  Memory traffic bounds it, as P1;
// the divide is far below the card's f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRangeSize = 256;
constexpr int kFieldnorms = 256;

template <typename Tf>
__global__ void tf_range_scores_kernel(
    const Tf* __restrict__ post_tf,          // [P]
    const uint8_t* __restrict__ post_local,  // [P]
    const uint8_t* __restrict__ doc_fn,      // [N+1]
    const float* __restrict__ s1_table,      // [256]
    const float* __restrict__ q_s0,          // [Q, T]
    const int32_t* __restrict__ cand_r,      // [Q, C]
    const int32_t* __restrict__ starts,      // [Q, T, C]
    const int32_t* __restrict__ lens,        // [Q, T, C]
    float* __restrict__ out,                 // [Q, C, RS]
    int n_terms, int chunk, int rs, int n_docs) {
  __shared__ float acc[kMaxRangeSize];
  __shared__ float s1[kFieldnorms];
  const int row = blockIdx.x;  // q * C + c
  const int q = row / chunk;
  const int c = row - q * chunk;
  const int lane = threadIdx.x;

  acc[lane] = 0.0f;
  for (int i = lane; i < kFieldnorms; i += blockDim.x) s1[i] = s1_table[i];
  const int base_doc = cand_r[row] * rs;
  __syncthreads();
  for (int t = 0; t < n_terms; ++t) {
    const int64_t meta = (static_cast<int64_t>(q) * n_terms + t) * chunk + c;
    const int len = lens[meta];
    if (lane < len) {
      const int64_t p = static_cast<int64_t>(starts[meta]) + lane;
      const int local = post_local[p];
      const float tf = static_cast<float>(post_tf[p]);
      const int doc = min(base_doc + local, n_docs);
      const float s0 = q_s0[static_cast<int64_t>(q) * n_terms + t];
      const float score =
          __fdiv_rn(__fmul_rn(tf, s0), __fadd_rn(tf, s1[doc_fn[doc]]));
      // Slots in [RS, 256) are never written out: dropped, as the
      // reference's scatter drops out-of-range slots.
      atomicAdd(&acc[local], score);
    }
    __syncthreads();
  }
  out[static_cast<int64_t>(row) * rs + lane] = acc[lane];
}

}  // namespace

// tf_u16 != 0: post_tf holds u16 term frequencies, else u8.
extern "C" int bm25_tf_range_scores(
    const void* post_tf, const void* post_local, const void* doc_fn,
    const void* s1_table, const void* q_s0, const void* cand_r,
    const void* starts, const void* lens, void* out, int n_queries,
    int n_terms, int chunk, int rs, int n_docs, int tf_u16, void* stream) {
  if (rs < 1 || rs > kMaxRangeSize) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(n_queries) * chunk;
  if (rows == 0) return 0;
  const dim3 grid(static_cast<unsigned int>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const uint8_t* fn = static_cast<const uint8_t*>(doc_fn);
  const float* s1 = static_cast<const float*>(s1_table);
  const float* s0 = static_cast<const float*>(q_s0);
  const int32_t* cr = static_cast<const int32_t*>(cand_r);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  if (tf_u16) {
    tf_range_scores_kernel<uint16_t><<<grid, rs, 0, s>>>(
        static_cast<const uint16_t*>(post_tf), loc, fn, s1, s0, cr, st, ln,
        o, n_terms, chunk, rs, n_docs);
  } else {
    tf_range_scores_kernel<uint8_t><<<grid, rs, 0, s>>>(
        static_cast<const uint8_t*>(post_tf), loc, fn, s1, s0, cr, st, ln, o,
        n_terms, chunk, rs, n_docs);
  }
  return static_cast<int>(cudaGetLastError());
}
