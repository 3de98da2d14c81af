// Exact rescore of MaxScore candidates and their top-k in one launch
// (sm_90a): S5.
//
// Replaces the XLA-lowered reference kernel M4
// vectorchord_bm25_tpu/search/stream.py::_stream_rescore (:366-431), its
// final sort (:421-429) included.  For each (query q, candidate c):
//
//     score = sum over terms t, ascending, of the posting of c in term t
//             (0 when t has none), or -inf unless c < n_docs and score > 0,
//
// then per query the k best (score desc, doc asc), -inf slots carrying id
// 0, and slots past C = min(k, C) candidates padded (-inf, 0).  A term's
// windows [t_lo, t_hi) are doc-ascending; the window that can hold c is the
// last whose base is <= c (an empty span, or a c below the first base,
// selects none and adds 0, as the reference's pad window does).
//
// What bounds it.  Latency, not bytes: a dispatch moves about 6 MB, but
// each (candidate, term) posting is a chain of dependent loads: about
// log2(span) steps of binary search on w_base, the window's table entries,
// its doc words up to the candidate, then its tf.  On the card a chain
// takes about as long with few items in flight as with many, so the time
// is set by a chain's length and by how many chains run side by side.
//
// Design.  A query's candidates go to a cluster of up to 8 blocks on as
// many SMs (Hopper's thread-block clusters), about 128 a block, so a query
// with many live candidates does not hold one SM; block `rank` owns the
// candidates i = rank (mod cluster size).  A block lists its live
// candidates first (on the main path two thirds of the slots are pads,
// which score -inf at once), then scores them in rounds of (candidate,
// term) items, a thread an item, up to eight terms of a candidate in one
// round: more chains in flight than a thread a candidate gives, and a
// warp's items share a term, so its search takes the same steps.  An item:
//   * the binary search, whose last probe at or below c is the window's
//     base, so it is not loaded again;
//   * the walk through the window up to c, 16 B a step: the aligned vector
//     holding the next four doc words, their deltas summed at once (SWAR,
//     then a running sum over the four) and skipped while they fall short
//     of c - base, the word that reaches it walked lane by lane
//     (window_decode.cuh's layout: lane l's delta at bit l * dbits, lane
//     0's counts 0).  Neighbouring threads walk unrelated windows, so every
//     load is a transaction of its own; 16 B a load keeps their number down;
//   * the posting through bm25::posting_score.
// The candidate's owner thread adds its items' postings in ascending t
// from 0.0f with __fadd_rn, the plain version's order and arithmetic.
// The keys (key_select.cuh's packing; a -inf candidate packs as doc 0)
// stay in each block's shared memory at their own i, or in a scratch row
// of device memory where they do not fit (the wrapper states the limit).
// Block 0 of the cluster reads the others' keys through distributed shared
// memory and selects the k smallest with key_select.cuh's pieces, as S2
// does: the k-th smallest minimum of chunks of 16 keys (by counting) bounds
// the k-th key, the few dozen keys under it are sorted by counting; a radix
// select over all keys where the bound lets more than 256 through.  Copies
// of one key (a doc listed twice) give equal outputs, so ties among them
// need no rule.  An optional [Q, C] scores output serves the scores-only
// entry point (k = 0: no selection).
//
// Exactness.  Against the plain version: bit-equal scores and ids.  The
// reference's jnp.sum over t follows XLA's order, so against it the scores
// agree to a few ulps (the repo's tests use rtol 2e-6) and the ids exactly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "key_select.cuh"
#include "launch_smem.cuh"
#include "window_decode.cuh"

namespace {

namespace cg = cooperative_groups;
using bm25::u64;

constexpr int kMaxThreads = 256;
constexpr int kMaxGroup = 8;  // terms of a candidate scored in one round
// Dynamic shared memory a block may ask for: the SM's 227 KB less the
// kernel's static Shared (ops/stream_rescore.py mirrors it as the limit
// past which the keys take a scratch row).
constexpr long long kMaxDynamicSmem = 208 * 1024;

constexpr int kChunkKeys = 16;   // keys a chunk minimum stands for
constexpr int kMaxChunks = 512;  // chunk minima a block ranks in shared memory
constexpr int kBufKeys = bm25::kCountSort;  // keys under the bound it sorts

struct Shared {
  unsigned hist[256];
  unsigned count, digit, below, bin, n_live;
  u64 kth;
  int live_j[kMaxThreads];    // a pass's live candidates: own index j
  int live_c[kMaxThreads];    // and doc id
  float post[kMaxThreads];    // a round's postings, [group][tile]
  u64 ck[kMaxChunks];         // chunk minima
  u64 buf[kBufKeys];          // the keys at or under the bound
};

// Sum of the `bits`-wide fields of w, bits in {2, 4, 8, 16}: neighbouring
// fields add pairwise into slots twice as wide until one slot is left.
__device__ __forceinline__ uint32_t field_sum(uint32_t w, uint32_t bits) {
  if (bits <= 2) w = (w & 0x33333333u) + ((w >> 2) & 0x33333333u);
  if (bits <= 4) w = (w & 0x0F0F0F0Fu) + ((w >> 4) & 0x0F0F0F0Fu);
  if (bits <= 8) w = (w & 0x00FF00FFu) + ((w >> 8) & 0x00FF00FFu);
  return (w & 0xFFFFu) + (w >> 16);
}

// One step of the walk for doc c through a window (len, dbits): q holds
// the four words from the window's word wb (wb < 0: words before the
// window, which count 0), rem = c - (the doc before them) > 0.  Their
// deltas are summed at once (SWAR, then a running sum over the four); if
// they fall short of rem they are skipped (rem shrinks; false unless the
// window ends), else the word that reaches rem is walked lane by lane and
// *lane is c's lane or -1 (true).
__device__ __forceinline__ bool walk_step(
    uint4 q, int wb, uint32_t len, uint32_t dbits, uint32_t* rem, int* lane) {
  const uint32_t per = 32u / dbits;  // lanes a word
  const uint32_t fmask = (1u << dbits) - 1u;
  const int n_words = static_cast<int>((len * dbits + 31u) >> 5);
  const uint32_t four[4] = {q.x, q.y, q.z, q.w};
  uint32_t v[4], run[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int wi = wb + x;
    v[x] = 0u;
    if (wi >= 0 && wi < n_words) {
      v[x] = four[x];
      if (wi == 0) v[x] &= ~fmask;  // lane 0 carries no delta
      const uint32_t live = len - static_cast<uint32_t>(wi) * per;
      if (live < per) v[x] &= (1u << (live * dbits)) - 1u;  // dead lanes add 0
    }
    run[x] = field_sum(v[x], dbits) + (x > 0 ? run[x - 1] : 0u);
  }
  *lane = -1;
  if (run[3] < *rem) {
    *rem -= run[3];
    return wb + 4 >= n_words;
  }
  // The first word whose running sum reaches rem, and the sum before it.
  int xs = 3;
#pragma unroll
  for (int x = 2; x >= 0; --x) {
    if (run[x] >= *rem) xs = x;
  }
  uint32_t word = v[0], r = *rem;
#pragma unroll
  for (int x = 1; x < 4; ++x) {
    if (x == xs) {
      word = v[x];
      r = *rem - run[x - 1];
    }
  }
  for (uint32_t j = 0; j < per; ++j) {
    const uint32_t d = (word >> (j * dbits)) & fmask;
    if (d >= r) {
      if (d == r) *lane = static_cast<int>(static_cast<uint32_t>(wb + xs) * per + j);
      break;
    }
    r -= d;
  }
  return true;
}

// The posting of doc c (0 <= c < n_docs, s1 = s1_eff[c]) in the term
// whose doc-ascending windows are [lo, hi): its score, or 0.0f if c is not
// there.  The walk's aligned vectors reach at most 3 words either side of
// a window: the same allocation, since allocations start 16-B aligned and
// the stream ends in 64 zero words.
__device__ float posting_of(
    const uint32_t* __restrict__ words, float s1, const int32_t* __restrict__ w_off,
    const int32_t* __restrict__ w_base, const uint16_t* __restrict__ w_meta,
    const float* __restrict__ w_s0, int lo, int hi, int c) {
  int l = lo, r = hi, base = 0;
  while (l < r) {
    const int m = l + ((r - l) >> 1);
    const int v = w_base[m];
    if (v <= c) {
      base = v;
      l = m + 1;
    } else {
      r = m;
    }
  }
  if (l == lo) return 0.0f;  // an empty span, or c before the first window
  const uint32_t off = static_cast<uint32_t>(w_off[l - 1]);
  const uint32_t meta = w_meta[l - 1];
  const float s0 = w_s0[l - 1];
  const uint32_t len = meta & 0xFFu;
  const uint32_t dbits = 2u << ((meta >> 8) & 3u);
  const uint32_t tclass = (meta >> 10) & 7u;
  if (len == 0) return 0.0f;
  int lane = 0;
  if (c != base) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(words + off);
    const uint4* vec = reinterpret_cast<const uint4*>(at & ~static_cast<uintptr_t>(15));
    int wb = -static_cast<int>((at & 15u) >> 2);
    uint32_t rem = static_cast<uint32_t>(c - base);
    while (!walk_step(*vec, wb, len, dbits, &rem, &lane)) {
      ++vec;
      wb += 4;
    }
    if (lane < 0) return 0.0f;
  }
  float tf = 1.0f;
  if (tclass) {
    const uint32_t bits = 1u << tclass;
    const uint32_t pos = static_cast<uint32_t>(lane) * bits;
    const uint32_t word = words[off + ((len * dbits + 31u) >> 5) + (pos >> 5)];
    tf = static_cast<float>((word >> (pos & 31u)) & ((1u << bits) - 1u));
  }
  return bm25::posting_score(tf, s0, s1);
}

__global__ void __launch_bounds__(kMaxThreads, 8) stream_rescore_kernel(
    const uint32_t* __restrict__ words,   // [S]
    const float* __restrict__ s1_eff,     // [N+1]
    const int32_t* __restrict__ w_off,    // [W+1]
    const int32_t* __restrict__ w_base,   // [W+1]
    const uint16_t* __restrict__ w_meta,  // [W+1]
    const float* __restrict__ w_s0,       // [W+1]
    const int32_t* __restrict__ cand,     // [n_q, n_c] doc ids (pad = n_docs)
    const int32_t* __restrict__ t_lo,     // [n_q, n_t] window spans
    const int32_t* __restrict__ t_hi,     // [n_q, n_t]
    float* __restrict__ scores,           // [n_q, n_c] or null
    float* __restrict__ out_s,            // [n_q, k] (k > 0)
    int32_t* __restrict__ out_i,          // [n_q, k] (k > 0)
    u64* scratch,                         // [n_q, room] or null: shared memory
    int n_c, int n_t, int n_docs, int k, long long room) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared s;
  // A cluster of blocks a query: block `rank` owns the candidates
  // i = rank + n_rank * j, j < n_mine, each block's keys at their own i.
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t q = blockIdx.x / n_rank;
  const int32_t* my_cand = cand + q * n_c;
  const int32_t* lo_row = t_lo + q * n_t;
  const int32_t* hi_row = t_hi + q * n_t;
  u64* keys = nullptr;
  if (k > 0) keys = scratch != nullptr ? scratch + q * room : reinterpret_cast<u64*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_mine = n_c > rank ? (n_c - rank + n_rank - 1) / n_rank : 0;

  // A pass takes blockDim candidates: the pads and out-of-range ids score
  // -inf at once, the live ones are listed in shared memory, and rounds of
  // (live candidate, term) items, a thread each, score them: `group` terms
  // of `tile` candidates, term-major, so a warp's items share a term and
  // its search takes the same steps.  The candidate's owner (tid < tile)
  // adds the round's postings in ascending t, from 0.0f with __fadd_rn: the
  // plain version's order and arithmetic.
  const int group = n_t < kMaxGroup ? (n_t > 0 ? n_t : 1) : kMaxGroup;
  const int tile = static_cast<int>(blockDim.x) / group;
  const int tl = tid / tile, cl = tid - tl * tile;
  for (int j0 = 0; j0 < n_mine; j0 += blockDim.x) {
    if (tid == 0) s.n_live = 0;
    __syncthreads();
    const int j = j0 + tid;
    const int c = j < n_mine ? my_cand[rank + n_rank * j] : -1;
    const bool live = c >= 0 && c < n_docs;
    if (j < n_mine && !live) {
      const int i = rank + n_rank * j;
      if (scores != nullptr) scores[q * n_c + i] = -CUDART_INF_F;
      if (keys != nullptr) keys[i] = bm25::pack_key(0.0f, 0);
    }
    const unsigned ballot = __ballot_sync(bm25::kFull, live);
    unsigned at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&s.n_live, __popc(ballot));
    at = __shfl_sync(bm25::kFull, at, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (live) {
      s.live_j[at] = j;
      s.live_c[at] = c;
    }
    __syncthreads();
    const int n_live = static_cast<int>(s.n_live);
    for (int l0 = 0; l0 < n_live; l0 += tile) {
      const bool mine = tl < group && l0 + cl < n_live;
      const int cm = mine ? s.live_c[l0 + cl] : 0;
      const float s1 = mine ? s1_eff[cm] : 0.0f;
      float sum = 0.0f;
      for (int t0 = 0; t0 < n_t; t0 += group) {
        float p = 0.0f;
        if (mine && t0 + tl < n_t) {
          p = posting_of(words, s1, w_off, w_base, w_meta, w_s0, lo_row[t0 + tl],
                         hi_row[t0 + tl], cm);
        }
        if (tl < group) s.post[tl * tile + cl] = p;
        __syncthreads();
        if (tid < tile) {
          for (int g = 0; g < group && t0 + g < n_t; ++g) sum = __fadd_rn(sum, s.post[g * tile + tid]);
        }
        __syncthreads();
      }
      if (tid < tile && l0 + tid < n_live) {
        const int i = rank + n_rank * s.live_j[l0 + tid];
        const int co = s.live_c[l0 + tid];
        if (scores != nullptr) scores[q * n_c + i] = sum > 0.0f ? sum : -CUDART_INF_F;
        if (keys != nullptr) keys[i] = bm25::pack_key(sum, sum > 0.0f ? co : 0);
      }
    }
    __syncthreads();  // s.live_* are rewritten by the next pass
  }
  if (k == 0) return;

  // Block 0 of the cluster selects: it reads the others' keys out of their
  // shared memory (or finds them in the scratch row), and they stay until
  // it has.
  if (scratch != nullptr) __threadfence();
  cluster.sync();
  if (rank == 0 && scratch == nullptr && n_rank > 1) {
    for (int i = threadIdx.x; i < n_c; i += blockDim.x) {
      if (i % n_rank != 0) keys[i] = cluster.map_shared_rank(keys, i % n_rank)[i];
    }
  }
  cluster.sync();
  if (rank != 0) return;

  float* os = out_s + q * k;
  int32_t* oi = out_i + q * k;
  const int kk = min(k, n_c);
  for (int i = kk + threadIdx.x; i < k; i += blockDim.x) {
    os[i] = -CUDART_INF_F;
    oi[i] = 0;
  }
  if (kk == 0) return;
  __syncthreads();
  if (kk == n_c) {
    bm25::sort_and_write(keys, kk, kk, os, oi);
    return;
  }
  // S2's bound first: the kk-th smallest of the minima of chunks of
  // kChunkKeys keys (kk chunks hold a key at or under it, so the kk-th
  // smallest key is too), and the keys at or under it, usually a few dozen,
  // sorted by counting.  Where there are too few chunks, or too many keys
  // under the bound (ties), a radix select over all of them.
  const int n_ck = (n_c + kChunkKeys - 1) / kChunkKeys;
  if (n_ck >= kk && n_ck <= kMaxChunks) {
    for (int ch = tid; ch < n_ck; ch += blockDim.x) {
      u64 m = ~0ull;
      for (int x = ch * kChunkKeys; x < min(n_c, (ch + 1) * kChunkKeys); ++x) m = min(m, keys[x]);
      s.ck[ch] = m;
    }
    __syncthreads();
    bm25::kth_by_rank(s, s.ck, n_ck, kk);
    const u64 bound = s.kth;
    if (tid == 0) s.count = 0;
    __syncthreads();
    for (int i = tid; i < n_c; i += blockDim.x) {
      const u64 key = keys[i];
      if (key <= bound) {
        const unsigned at = atomicAdd(&s.count, 1u);
        if (at < static_cast<unsigned>(kBufKeys)) s.buf[at] = key;
      }
    }
    __syncthreads();
    const unsigned n_buf = s.count;
    if (n_buf <= static_cast<unsigned>(kBufKeys)) {  // the same in every thread
      bm25::sort_and_write(s.buf, static_cast<int>(n_buf), kk, os, oi);
      return;
    }
  }
  // The kk smallest keys go behind the row: those below the selected
  // prefix, then as many at it as are still needed.
  u64 prefix, mask;
  bm25::radix_select(
      s, n_c, static_cast<unsigned>(kk),
      [&](int i, u64* key) {
        *key = keys[i];
        return true;
      },
      &prefix, &mask);
  u64* sel = keys + n_c;
  if (tid == 0) s.count = 0;
  __syncthreads();
  for (int i = tid; i < n_c; i += blockDim.x) {
    const u64 key = keys[i];
    if ((key & mask) < prefix) sel[atomicAdd(&s.count, 1u)] = key;
  }
  __syncthreads();
  for (int i = tid; i < n_c; i += blockDim.x) {
    const u64 key = keys[i];
    if ((key & mask) == prefix) {
      const unsigned at = atomicAdd(&s.count, 1u);
      if (at < static_cast<unsigned>(kk)) sel[at] = key;
    }
  }
  __syncthreads();
  bm25::sort_and_write(sel, kk, kk, os, oi);
}

// Keys a block holds for the selection: the C keys and, behind them, room
// to sort the k selected (a power of two), or, when every key is selected,
// room to sort all C in place.  ops/stream_rescore.py mirrors it.
long long select_room(int n_c, int k) {
  const long long kk = k < n_c ? k : n_c;
  if (kk <= 0) return 0;
  long long p = 1;
  while (p < kk) p <<= 1;
  return (kk < n_c ? n_c : 0) + p;
}

}  // namespace

// One launch: scores [Q, C] (or null) and, for k > 0, the top-k out_s /
// out_i [Q, k].  scratch: a [Q, room] u64 row a query, or null to keep the
// keys in shared memory (8 * room bytes, at most kMaxDynamicSmem).
extern "C" int bm25_stream_rescore_topk(
    const void* words, const void* s1_eff, const void* w_off,
    const void* w_base, const void* w_meta, const void* w_s0,
    const void* cand, const void* t_lo, const void* t_hi, void* scores,
    void* out_s, void* out_i, void* scratch, int n_q, int n_c, int n_t,
    int n_docs, int k, void* stream) {
  if (n_q < 0 || n_c < 0 || n_t < 0 || n_docs < 0 || k < 0 ||
      (k > 0 && (out_s == nullptr || out_i == nullptr)) ||
      (k == 0 && scores == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0 || (k == 0 && n_c == 0)) return 0;
  const long long room = select_room(n_c, k);
  const long long smem = scratch == nullptr ? 8 * room : 0;
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  // The default limit (48 KB) holds the static Shared too: past it with
  // both, the launch needs the larger dynamic limit.
  const cudaError_t smem_err = bm25::allow_dynamic_smem(stream_rescore_kernel, smem);
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  // A query's candidates over a cluster of up to 8 blocks on as many SMs,
  // about 128 a block, and a thread a (candidate, term) item: a query with
  // many live candidates does not hold one SM for the whole launch, and
  // enough items are in flight to hide their chains of dependent loads.
  const int n_rank = n_c <= 128 ? 1 : n_c >= 8 * 128 ? 8 : (n_c + 127) / 128;
  const long long per = (static_cast<long long>(n_c) + n_rank - 1) / n_rank;
  // Two threads a candidate: a pass's live candidates (a third of the
  // slots on the main path: the rest are pads) take one round of their
  // (candidate, term) items.
  const int threads = static_cast<int>(
      per >= kMaxThreads / 2 ? kMaxThreads : per <= 16 ? 32 : (2 * per + 31) / 32 * 32);
  const long long blocks = static_cast<long long>(n_q) * n_rank;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned int>(n_rank);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(blocks));
  config.blockDim = dim3(static_cast<unsigned int>(threads));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, stream_rescore_kernel, static_cast<const uint32_t*>(words),
      static_cast<const float*>(s1_eff), static_cast<const int32_t*>(w_off),
      static_cast<const int32_t*>(w_base), static_cast<const uint16_t*>(w_meta),
      static_cast<const float*>(w_s0), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(t_lo), static_cast<const int32_t*>(t_hi),
      static_cast<float*>(scores), static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), static_cast<u64*>(scratch), n_c, n_t, n_docs, k,
      room);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
