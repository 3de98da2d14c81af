// The sharded index's global statistics step (SH-stats, sm_90a).
//
// Replaces two mesh collectives of the reference:
// - global_stats_step (vectorchord_bm25_tpu/parallel/shard.py:2285-2325):
//   each shard sums FIELDNORM_TO_LENGTH[doc_fn] * doc_live over its
//   [nmax+1] row in f64, and a psum adds the shards' sums and doc counts;
// - device_doc_offsets (parallel/devbuild.py:65-91): the exclusive scan of
//   the shard doc counts (all_gather + cumsum), the doc-id offset rebasing.
//
// One launch, one block a shard (blockIdx.x): the block's threads stride
// its row, each adding table[doc_fn] * live into an f64 register, then a
// shared-memory tree reduction writes the shard's partial sum.  Block 0's
// first thread also writes offsets[0..D]: the exclusive scan of the counts,
// and at offsets[D] their total (the psum of n_local).  The host adds the D
// partial sums; on one card that addition of D numbers is the psum.
//
// Every term is an integer (a decoded length times a 0/1 live flag), and the
// sums stay below 2^53, so the f64 result is exact in any order and equals
// the reference's bit for bit.
//
// Bound: doc_fn (1 B) and doc_live (4 B) of every slot read once; 10.5 MB at
// D = 8, nmax = 262,144, about 3 microseconds of memory time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void shard_stats_kernel(
    const uint8_t* __restrict__ doc_fn,     // [D, M]
    const float* __restrict__ doc_live,     // [D, M]
    const double* __restrict__ table,       // [256] FIELDNORM_TO_LENGTH
    const int64_t* __restrict__ counts,     // [D]
    double* partial,                        // [D]
    int64_t* offsets,                       // [D + 1]
    int n_shards, int64_t n_cols) {
  __shared__ double s_table[256];
  __shared__ double s_sum[kThreads];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const uint8_t* fn = doc_fn + static_cast<int64_t>(d) * n_cols;
  const float* live = doc_live + static_cast<int64_t>(d) * n_cols;
  double acc = 0.0;
  for (int64_t j = tid; j < n_cols; j += blockDim.x) {
    acc += s_table[fn[j]] * static_cast<double>(live[j]);
  }
  s_sum[tid] = acc;
  __syncthreads();
  for (int half = blockDim.x >> 1; half > 0; half >>= 1) {
    if (tid < half) s_sum[tid] += s_sum[tid + half];
    __syncthreads();
  }
  if (tid == 0) partial[d] = s_sum[0];
  if (d == 0 && tid == 0) {
    int64_t run = 0;
    for (int i = 0; i < n_shards; ++i) {
      offsets[i] = run;
      run += counts[i];
    }
    offsets[n_shards] = run;
  }
}

}  // namespace

extern "C" int bm25_shard_stats(
    const void* doc_fn, const void* doc_live, const void* table,
    const void* counts, void* partial, void* offsets, int n_shards,
    long long n_cols, void* stream) {
  if (n_shards < 1 || n_cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  shard_stats_kernel<<<static_cast<unsigned int>(n_shards), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(doc_fn), static_cast<const float*>(doc_live),
      static_cast<const double*>(table), static_cast<const int64_t*>(counts),
      static_cast<double*>(partial), static_cast<int64_t*>(offsets), n_shards,
      n_cols);
  return static_cast<int>(cudaGetLastError());
}
