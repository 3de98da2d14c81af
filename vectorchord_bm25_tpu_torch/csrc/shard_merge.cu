// The cross-shard top-k merge of every sharded search body (SH-merge,
// sm_90a).
//
// Replaces the rebase and the collective merge of the reference's sharded
// bodies (vectorchord_bm25_tpu/parallel/shard.py:820-832 stream, :1686-1692
// Block-Max, :1840-1846 compact, :1997-2003 exact): each shard's [Q, kk]
// local top-k becomes global ids, g = isfinite(s) ? id + doc_offset[d] :
// INT_MAX, is all-gathered over the mesh axis, and lax.sort((-score, id),
// num_keys=2) keeps the first kk of each query's D*kk.  On one card the
// shards' local top-ks sit stacked in one [D, Q, W] pair, so the all_gather
// is a read and the rebase and the sort are this kernel.
//
// Each candidate becomes one u64 key whose ascending order is lax.sort's:
// the high word is -score's f32 bits mapped to IEEE total order (XLA's float
// sort order: -NaN < -inf < ... < -0 < +0 < ... < +inf < NaN) and flipped to
// unsigned, the low word is the global id's int32 bits flipped to unsigned.
// The map is a bijection, so a key decodes to the exact score and id bits
// that went in, -inf pads and their INT_MAX ids included.
//
// No sort.  Shard d's run of query q, the first widths[d] slots of row
// [d, q], comes from S2 (dense_topk) or Block-Max's running top-k: already
// in merge order.  The rebase adds one constant to a run's finite entries
// and sends its non-finite ones, which sit at its ends, to INT_MAX, so the
// run stays in order; a run is taken as in order after the rebase, and
// shard_merge_plain (ops/shard_kernels.py) raises where one is not.  A
// candidate x at position p of run d then has the output rank
//   p + sum_{e < d} #{keys of run e <= x} + sum_{e > d} #{keys of run e < x},
// its place in a stable sort of the runs in shard order: distinct ranks,
// equal keys (which decode alike) in shard order.  An entry at position p
// has rank >= p, so only a run's first kk entries can be kept, and counting
// in runs cut to kk keys gives min(count, kk): a rank below kk stays exact.
// A candidate whose rank is below kk writes itself to out[q, rank]; the
// slots past the candidates (fewer than kk in all) get the pad key's
// (-inf, INT_MAX), the reference's padded slots (a run's keys are at most
// the pad key).
//
// A group of 32 to 256 threads a query, 128 or more a block: at the served
// size (D = 8, W = kk = 16: 128 keys a query) a block of 128 threads a
// query, a thread a candidate, 512 queries 512 blocks on 132 SMs.  The
// group stages its query's cut runs into shared memory, a thread a key
// (load, rebase, pack), each run in 2^shift slots padded with all-ones
// keys, then one barrier; each thread then ranks its candidates without
// another.  The counts are D searches of 2^shift slots stepped together, so
// that their loads are in flight at once: branch-free (no length check:
// the pads are above every key), each a compare with one limit a run, x + 1
// for a run before d (keys <= x), x for a run after it, 0 for d's own.
// The work is bound by instruction rate: D searches of log2(kk) + 1 probes
// a candidate.
// Where a query's padded runs do not fit shared memory (more than
// kMaxDynamicSmem / 8 = 28,672 slots) the searches read the runs in device
// memory instead, rebasing as they load, with their lengths: no size the
// reference serves is refused.
//
// Bound: each kept run entry (score and id) read once, the offsets, the
// [2, Q, kk] output written once; at the served size about 0.6 MB, well
// under a microsecond of memory time, so a launch's fixed cost and the
// searches' instructions set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_smem.cuh"

namespace {

typedef unsigned long long u64;

constexpr long long kMaxDynamicSmem = 224 * 1024;
constexpr int kMaxThreads = 256;
constexpr int kMinBlock = 128;
constexpr int kMaxShards = 512;
constexpr int kAtOnce = 8;  // runs whose searches step together
constexpr int32_t kIntMax = 0x7FFFFFFF;
constexpr uint32_t kInfBits = 0x7F800000u;
constexpr int32_t kNegInfBits = static_cast<int32_t>(0xFF800000u);
// A staged run's slots past its keys: above every key (a run's keys are at
// most the pad key's (-inf, INT_MAX)), so no search counts one.
constexpr u64 kSlotPad = ~0ull;

// Each shard's width cut to kk: its run's keys.  Passed by value and read
// in place (__grid_constant__: its address is taken, never copied).
struct Widths {
  int w[kMaxShards];
};

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

// The reference's g_ids: the local id plus the shard's offset (int32
// arithmetic) where the score is finite, INT_MAX elsewhere.
__device__ __forceinline__ u64 rebased_key(float s, int32_t id, long long offset) {
  const bool finite = (__float_as_uint(s) & kInfBits) != kInfBits;
  const int32_t g = finite ? static_cast<int32_t>(static_cast<uint32_t>(id) +
                                                  static_cast<uint32_t>(offset))
                           : kIntMax;
  return merge_key(s, g);
}

// A query's runs where they lie in device memory, rebased as they load.
struct InPlace {
  const float* scores;
  const int32_t* ids;
  const long long* offsets;
  int64_t q;
  int n_queries;
  int width;
  __device__ __forceinline__ u64 at(int e, int i) const {
    const int64_t src = (static_cast<int64_t>(e) * n_queries + q) * width + i;
    return rebased_key(__ldg(scores + src), __ldg(ids + src), __ldg(offsets + e));
  }
};

// The output rank of key x at position p of run d (see the header), or a
// value >= kk once it is known to be one.  A run counts its keys below
// lim: x + 1 for a run before d (keys <= x; x is below the all-ones key),
// x for a run after it, 0 for d's own (its position p counts those).
// Staged (keys != nullptr): every run is 2^shift slots, padded with
// kSlotPad, and searched branch-free, shift steps and a last probe; else
// the runs are read in place with their lengths.
__device__ __forceinline__ int rank_of(const u64* keys, const InPlace& in_place,
                                       const Widths& cut, int n_shards, int shift,
                                       int d, int p, u64 x, int kk) {
  int rank = p;
  if (n_shards == 1) return rank;
  for (int e0 = 0; e0 < n_shards && rank < kk; e0 += kAtOnce) {
    int pos[kAtOnce];
    u64 lim[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      const int e = e0 + u;
      pos[u] = 0;
      lim[u] = e == d ? 0 : e < d ? x + 1 : x;
    }
    if (keys != nullptr) {
      for (int h = (1 << shift) >> 1; h > 0; h >>= 1) {
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u) {
          if (e0 + u < n_shards &&
              keys[((e0 + u) << shift) + pos[u] + h] < lim[u]) {
            pos[u] += h;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        if (e0 + u < n_shards) pos[u] += keys[((e0 + u) << shift) + pos[u]] < lim[u];
      }
    } else {
      int len[kAtOnce];
      int longest = 0;
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        len[u] = e0 + u < n_shards ? cut.w[e0 + u] : 0;
        longest = max(longest, len[u]);
      }
      // Binary lifting: pos[u] grows to the count (a prefix: the run is in
      // order).
      for (int step = longest ? 1 << (31 - __clz(longest)) : 0; step > 0; step >>= 1) {
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u) {
          const int next = pos[u] + step;
          if (next <= len[u] && in_place.at(e0 + u, next - 1) < lim[u]) pos[u] = next;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) rank += pos[u];
  }
  return rank;
}

__device__ __forceinline__ void put(int32_t* out, int64_t plane, int64_t at, u64 key) {
  const int32_t neg = total_order(
      static_cast<int32_t>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u));
  out[at] = neg ^ static_cast<int32_t>(0x80000000u);
  out[plane + at] = static_cast<int32_t>(static_cast<uint32_t>(key) ^ 0x80000000u);
}

// A group of `group` threads a query.  Slot v of a query is position
// v & (2^shift - 1) of run v >> shift.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) shard_merge_kernel(
    const float* __restrict__ scores,       // [D, Q, W]
    const int32_t* __restrict__ ids,        // [D, Q, W] local ids
    const long long* __restrict__ offsets,  // [D]
    int32_t* __restrict__ out,              // [2, Q, kk]: score bits, global ids
    const __grid_constant__ Widths cut, int n_shards, int n_queries, int width, int kk,
    int shift, int n_kept, int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = n_shards << shift;
  const int mask = (1 << shift) - 1;
  const int lane = threadIdx.x & (group - 1);
  const int slot = threadIdx.x / group;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + slot;
  const bool live = q < n_queries;
  const InPlace in_place{scores, ids, offsets, q, n_queries, width};
  u64* keys = nullptr;
  if constexpr (kStaged) {
    keys = reinterpret_cast<u64*>(smem_raw) + static_cast<int64_t>(slot) * slots;
    if (live) {
      for (int v = lane; v < slots; v += group) {
        const int d = v >> shift, p = v & mask;
        keys[v] = p < cut.w[d] ? in_place.at(d, p) : kSlotPad;
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const int64_t plane = static_cast<int64_t>(n_queries) * kk;
  const int64_t row = q * kk;
  for (int v = lane; v < slots; v += group) {
    const int d = v >> shift, p = v & mask;
    if (p >= cut.w[d]) continue;
    const u64 x = kStaged ? keys[v] : in_place.at(d, p);
    const int rank = rank_of(keys, in_place, cut, n_shards, shift, d, p, x, kk);
    if (rank < kk) put(out, plane, row + rank, x);
  }
  for (int r = n_kept + lane; r < kk; r += group) {
    out[row + r] = kNegInfBits;
    out[plane + row + r] = kIntMax;
  }
}

}  // namespace

// scores [D, Q, W] f32 and ids [D, Q, W] int32 local ids: shard d's run of
// query q is the first widths[d] slots of row [d, q], in merge order.
// widths: a host array of n_shards ints in [0, W].  offsets: [D] int64 on
// the device.  out: [2, Q, kk] int32, the scores' bits then the global ids.
extern "C" int bm25_shard_merge(
    const void* scores, const void* ids, const int* widths, const void* offsets,
    void* out, int n_shards, int n_queries, int width, int kk, void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || n_queries < 0 || width < 0 || kk < 1 ||
      widths == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Widths cut;
  int widest = 0;
  long long n_kept = 0;
  for (int d = 0; d < n_shards; ++d) {
    if (widths[d] < 0 || widths[d] > width) return static_cast<int>(cudaErrorInvalidValue);
    cut.w[d] = widths[d] < kk ? widths[d] : kk;
    widest = cut.w[d] > widest ? cut.w[d] : widest;
    n_kept += cut.w[d];
  }
  int shift = 0;
  while ((1 << shift) < widest) ++shift;
  const long long slots = static_cast<long long>(n_shards) << shift;
  if (slots > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return 0;
  int group = 32;
  while (group < kMaxThreads && group < slots) group <<= 1;
  const int threads = group > kMinBlock ? group : kMinBlock;
  const int per_block = threads / group;
  const long long smem = 8LL * per_block * slots;
  const long long blocks = (static_cast<long long>(n_queries) + per_block - 1) / per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  const int32_t* i = static_cast<const int32_t*>(ids);
  const long long* off = static_cast<const long long*>(offsets);
  int32_t* o = static_cast<int32_t*>(out);
  const int kept = static_cast<int>(n_kept < kk ? n_kept : kk);
  if (smem <= kMaxDynamicSmem) {
    const cudaError_t err = bm25::allow_dynamic_smem(shard_merge_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shard_merge_kernel<true><<<static_cast<unsigned int>(blocks), threads,
                               static_cast<size_t>(smem), st>>>(
        s, i, off, o, cut, n_shards, n_queries, width, kk, shift, kept, group);
  } else {
    shard_merge_kernel<false><<<static_cast<unsigned int>(blocks), threads, 0, st>>>(
        s, i, off, o, cut, n_shards, n_queries, width, kk, shift, kept, group);
  }
  return static_cast<int>(cudaGetLastError());
}
