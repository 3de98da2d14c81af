// The sharded index's global statistics step (SH-stats, sm_90a).
//
// Replaces two mesh collectives of the reference:
// - global_stats_step (vectorchord_bm25_tpu/parallel/shard.py:2285-2325):
//   each shard sums FIELDNORM_TO_LENGTH[doc_fn] * doc_live over its
//   [nmax+1] row in f64, and a psum adds the shards' sums and doc counts;
// - device_doc_offsets (parallel/devbuild.py:65-91): the exclusive scan of
//   the shard doc counts (all_gather + cumsum), the doc-id offset rebasing.
//
// One launch over a 2-D grid: blockIdx.y is the shard, blockIdx.x a slice
// of its row of 4,096 slots, so the card's SMs all read (65 slices a row at
// D = 8, nmax = 262,144: 520 blocks on 132 SMs).  Each block copies the 2 KB length table
// into shared memory; each thread reads four slots at a time, 16 B of
// doc_live and 4 B of doc_fn, where both are aligned (a row of odd width
// starts unaligned, so the up to three slots before the first aligned one
// and the ragged tail go one at a time), adding table[doc_fn] * live into
// an f64 register.  A warp-shuffle reduction, then one across the warps,
// and one f64 atomicAdd a block into partial[d], which the entry point
// zeroes on the same stream first.  Block (0, 0)'s first thread also writes
// offsets[0..D]: the exclusive scan of the counts, and at offsets[D] their
// total (the psum of n_local).  The host adds the D partial sums; on one
// card that addition of D numbers is the psum.
//
// Every term is an integer (a decoded length times a 0/1 live flag), and
// every partial sum stays below 2^53, so each f64 addition is exact: the
// atomics may add in any order and the result equals the reference's bit
// for bit.
//
// Bound: doc_fn (1 B) and doc_live (4 B) of every slot read once; 10.5 MB at
// D = 8, nmax = 262,144, about 3 microseconds of memory time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // four-slot groups a thread, in the grid's stride
constexpr int kMaxBlocksX = 65535;

__global__ void shard_stats_kernel(
    const uint8_t* __restrict__ doc_fn,     // [D, M]
    const float* __restrict__ doc_live,     // [D, M]
    const double* __restrict__ table,       // [256] FIELDNORM_TO_LENGTH
    const int64_t* __restrict__ counts,     // [D]
    double* partial,                        // [D], zeroed
    int64_t* offsets,                       // [D + 1]
    int n_shards, int64_t n_cols) {
  __shared__ double s_table[256];
  __shared__ double s_warp[kThreads / 32];
  const int d = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 256; i += blockDim.x) s_table[i] = table[i];
  if (blockIdx.x == 0 && d == 0 && tid == 0) {
    int64_t run = 0;
    for (int i = 0; i < n_shards; ++i) {
      offsets[i] = run;
      run += counts[i];
    }
    offsets[n_shards] = run;
  }
  __syncthreads();
  const uint8_t* fn = doc_fn + static_cast<int64_t>(d) * n_cols;
  const float* live = doc_live + static_cast<int64_t>(d) * n_cols;
  // Slots before the first one at which both rows are aligned for 4-slot
  // loads; none of the row goes by vectors where the two never align.
  const int mis_live = static_cast<int>((reinterpret_cast<uintptr_t>(live) >> 2) & 3);
  const int mis_fn = static_cast<int>(reinterpret_cast<uintptr_t>(fn) & 3);
  const bool vec = (reinterpret_cast<uintptr_t>(live) & 3) == 0 && mis_live == mis_fn;
  const int64_t lead = (4 - mis_live) & 3;
  const int64_t head = vec && lead < n_cols ? lead : n_cols;
  const int64_t n_vec = (n_cols - head) >> 2;
  const int64_t tail = head + 4 * n_vec;

  double acc = 0.0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + tid;
  const float4* live4 = reinterpret_cast<const float4*>(live + head);
  const uint32_t* fn4 = reinterpret_cast<const uint32_t*>(fn + head);
  for (int64_t v = first; v < n_vec; v += stride) {
    const float4 l = live4[v];
    const uint32_t f = fn4[v];
    acc += s_table[f & 0xFFu] * static_cast<double>(l.x);
    acc += s_table[(f >> 8) & 0xFFu] * static_cast<double>(l.y);
    acc += s_table[(f >> 16) & 0xFFu] * static_cast<double>(l.z);
    acc += s_table[f >> 24] * static_cast<double>(l.w);
  }
  // The unaligned head and the ragged tail (the whole row where the two
  // never align), one slot at a time.
  for (int64_t j = first; j < head; j += stride) {
    acc += s_table[fn[j]] * static_cast<double>(live[j]);
  }
  for (int64_t j = tail + first; j < n_cols; j += stride) {
    acc += s_table[fn[j]] * static_cast<double>(live[j]);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? s_warp[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
    if (lane == 0) atomicAdd(&partial[d], acc);
  }
}

}  // namespace

// grid: two host ints that receive the launch's grid (slices, shards).
extern "C" int bm25_shard_stats(
    const void* doc_fn, const void* doc_live, const void* table,
    const void* counts, void* partial, void* offsets, int n_shards,
    long long n_cols, int* grid, void* stream) {
  if (n_shards < 1 || n_shards > 65535 || n_cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(partial, 0, sizeof(double) * n_shards, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = static_cast<long long>(kThreads) * kVecPerThread * 4;
  long long blocks_x = (n_cols + per_block - 1) / per_block;
  blocks_x = blocks_x < 1 ? 1 : blocks_x > kMaxBlocksX ? kMaxBlocksX : blocks_x;
  shard_stats_kernel<<<dim3(static_cast<unsigned int>(blocks_x),
                            static_cast<unsigned int>(n_shards)),
                       kThreads, 0, s>>>(
      static_cast<const uint8_t*>(doc_fn), static_cast<const float*>(doc_live),
      static_cast<const double*>(table), static_cast<const int64_t*>(counts),
      static_cast<double*>(partial), static_cast<int64_t*>(offsets), n_shards,
      n_cols);
  grid[0] = static_cast<int>(blocks_x);
  grid[1] = n_shards;
  return static_cast<int>(cudaGetLastError());
}
