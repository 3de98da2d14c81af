// The cross-shard top-k merge of every sharded search body (SH-merge,
// sm_90a).
//
// Replaces the collective merge of the reference's sharded bodies
// (vectorchord_bm25_tpu/parallel/shard.py:826-832 stream, :1686-1692
// Block-Max, :1840-1846 compact, :1997-2003 exact): each shard's [Q, kk]
// candidates (score, global id) are all-gathered over the mesh axis and
// lax.sort((-score, id), num_keys=2) keeps the first kk of each query's D*kk.
// On one card the shards' candidates sit stacked in one [D, Q, kk] pair, so
// the all_gather is a read and the sort is this kernel.
//
// One block a query.  Each candidate becomes one u64 key whose ascending
// order is lax.sort's: the high word is -score's f32 bits mapped to IEEE
// total order (XLA's float sort order: -NaN < -inf < ... < -0 < +0 < ... <
// +inf < NaN) and flipped to unsigned, the low word is the id's int32 bits
// flipped to unsigned.  The map is a bijection, so the kept keys decode to
// the exact score and id bits that went in, -inf pads and their ids
// included.  No input order is assumed: the D*kk keys are bitonic-sorted,
// padded with all-ones keys (above every real key) to a power of two m.
//
// The keys sit in shared memory while 8 * m bytes fit a block's
// (m <= 16,384, i.e. D*kk <= 16,384); past that the wrapper hands a
// [Q, m] scratch row in device memory and the same code sorts there.  No k
// the reference serves is refused.
//
// Bound: the [D, Q, kk] inputs read once and the [Q, kk] outputs written
// once; at the served sizes (Q = 512, D = 8, kk = 16) that is well under a
// microsecond of memory time, so a launch's fixed cost sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr long long kMaxDynamicSmem = 224 * 1024;
constexpr int kThreads = 256;
constexpr u64 kPadKey = ~0ull;

// Involution between a float's int32 bits and an int32 whose signed order
// is IEEE total order.
__device__ __forceinline__ int32_t total_order(int32_t x) {
  return x ^ ((x >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ u64 merge_key(float s, int32_t id) {
  const int32_t neg = __float_as_int(s) ^ static_cast<int32_t>(0x80000000u);
  const uint32_t hi = static_cast<uint32_t>(total_order(neg)) ^ 0x80000000u;
  const uint32_t lo = static_cast<uint32_t>(id) ^ 0x80000000u;
  return (static_cast<u64>(hi) << 32) | lo;
}

// Ascending bitonic sort of buf[0, m), m a power of two; ends on a barrier.
__device__ void bitonic_sort(u64* buf, int m, int tid, int nt) {
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (m >> 1); i += nt) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = buf[lo];
        const u64 b = buf[hi];
        if ((a > b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void shard_merge_kernel(
    const float* __restrict__ scores,  // [D, Q, kk]
    const int32_t* __restrict__ ids,   // [D, Q, kk]
    float* out_s,                      // [Q, k_out]
    int32_t* out_i,                    // [Q, k_out]
    u64* scratch,                      // [Q, m] or null (shared memory)
    int n_shards, int n_queries, int kk, int k_out, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  u64* buf = scratch ? scratch + static_cast<int64_t>(q) * m
                     : reinterpret_cast<u64*>(smem_raw);
  const int n = n_shards * kk;
  // Candidate j of the query is shard j / kk's slot j % kk: the
  // moveaxis-and-reshape of the reference, which the sort makes moot.
  for (int j = tid; j < m; j += nt) {
    u64 key = kPadKey;
    if (j < n) {
      const int d = j / kk;
      const int64_t src =
          (static_cast<int64_t>(d) * n_queries + q) * kk + (j - d * kk);
      key = merge_key(scores[src], ids[src]);
    }
    buf[j] = key;
  }
  __syncthreads();
  bitonic_sort(buf, m, tid, nt);
  for (int j = tid; j < k_out; j += nt) {
    const u64 key = buf[j];
    const int32_t neg = total_order(
        static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u));
    const int64_t dst = static_cast<int64_t>(q) * k_out + j;
    out_s[dst] = __int_as_float(neg ^ static_cast<int32_t>(0x80000000u));
    out_i[dst] = static_cast<int32_t>(static_cast<uint32_t>(key) ^ 0x80000000u);
  }
}

}  // namespace

// kk: candidates a shard holds for a query; k_out <= n_shards * kk: the
// candidates kept.  m: keys a query's buffer holds, a power of two >=
// n_shards * kk.
// scratch: a [Q, m] u64 device buffer, or null where 8 * m bytes fit a
// block's shared memory (kMaxDynamicSmem; ops/shard_kernels.py mirrors it).
extern "C" int bm25_shard_merge(
    const void* scores, const void* ids, void* out_s, void* out_i,
    void* scratch, int n_shards, int n_queries, int kk, int k_out, int m,
    void* stream) {
  if (n_shards < 1 || kk < 1 || k_out < 1 || k_out > n_shards * kk ||
      m < n_shards * kk || (m & (m - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0) return 0;
  const long long smem = scratch ? 0 : 8LL * m;
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shard_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  shard_merge_kernel<<<static_cast<unsigned int>(n_queries), kThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int32_t*>(ids),
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i),
      static_cast<u64*>(scratch), n_shards, n_queries, kk, k_out, m);
  return static_cast<int>(cudaGetLastError());
}
