// Exact top-k of a dense accumulator, selected inside the kernels (sm_90a).
//
// Replaces the XLA-lowered reference op vectorchord_bm25_tpu/ops/topk.py::
// dense_topk (:31-91): per row the k best of where(acc > 0, acc, -inf) in
// the order (score desc, doc asc), hierarchical from 2^17 docs with at
// least max(2k, 8) blocks (:53), else one masked top-k over the first
// n_docs columns.  Every comparison runs on a packed 64-bit key whose
// ascending order is that order:
//
//     key = (score > 0 ? 0x7F800000 - f32_bits(score) : 0x7F800000) << 32 | doc
//
// (NaN, +-0 and negatives share the top half 0x7F800000, the "pad" half).
// Keys are distinct (docs are), so "the k smallest keys" is one set.
//
// block_max_keys (pass 1, hierarchical branch).  One warp per (query,
// 1024-doc block): 16-B streaming loads (__ldcs), the score > 0 mask fused
// into the max, one key per block with the block id as its low half.  It
// reads the whole [Q, M] accumulator once (1.07 GB for a [2048, 131073]
// dispatch) and is bound by device-memory bytes; the 16-B loads need rows
// that start 16-B aligned, which the wrapper checks.
//
// select (pass 2).  One block of 256 threads per query does the rest in
// shared memory, where the first version of this op wrote [Q, k * 1024 +
// tail] int64 keys (268 MB at [2048, 131073]) for two library selections:
//   1. the k best block keys: each of the [T] keys (T <= 1,024, in shared
//      memory) ranked by counting the keys below it, one barrier (past
//      1,024 blocks a radix select over the row of keys), then an ordered
//      compaction of the chosen block ids, which therefore come out
//      ascending, as the reference sorts them;
//   2. a threshold: every chosen block holds a doc whose key is at most
//      the k-th block key, so the k-th best candidate is no worse and a
//      candidate whose key's top half lies above that key's cannot enter
//      (ties enter: "<=").  The non-hierarchical branch takes the same
//      threshold from maxima of 128-doc chunks (at most 1,024 chunks, of
//      a multiple of 128 docs) it computes itself in a first read of the
//      row;
//   3. one read of the k chosen blocks and the ragged tail (the tail masked
//      to docs < n_docs), four 16-B loads a thread in flight: positive keys
//      under the threshold go to a 2,048-key buffer in shared memory;
//   4. if the buffer overflows (equal scores are common: BM25 on quantised
//      field norms ties often, and a median row of the 131,072-doc corpus
//      has some 260 docs at or above the threshold), the k-th smallest
//      buffered key bounds the k-th smallest of all, and the row is read
//      again keeping only keys at or below it, until they fit;
//   5. if fewer than k docs are positive, the row pads: its positives,
//      sorted, then the first (k - P) non-positive candidates in position
//      order, which is doc order, so their ids are the plain version's
//      (the lowest doc ids among the chosen blocks and the tail);
//   6. otherwise the k smallest buffered keys are found by a radix select
//      in shared memory (8-bit digits, a warp's equal digits added once,
//      leaving as soon as a bin holds exactly the keys still needed),
//      ranked by counting and written.  For k > 1,024 a radix select over
//      the row re-read from device memory takes the place of step 4.
// Past 2,048 selected keys (k > 2,048 with as many positives) a row's
// selected keys go to a scratch row instead; sort_chunks sorts it in
// 2,048-key chunks and rank_merge writes each key at its rank (its rank in
// its chunk plus, by binary search, the keys below it in the other chunks).
// No library selection runs on any path.  The packing, the radix select,
// the k-th key by counting and the sort live in key_select.cuh, which S5
// (stream_rescore.cu) shares.
//
// Bound.  Pass 1 reads the accumulator's T * 1024 columns once; pass 2
// reads the k chosen blocks and the tail (64 KB a row at k = 16) and writes
// [Q, k] scores and ids.  Both are bound by bytes.  On an H100 at 700 W the
// pair runs at about 1.3 times the bound of one read of the accumulator at
// [2048, 131073], k=16 (pass 1 is most of it), and the flat branch at about
// 2 times at [4096, 16385]; PERF.md has the times.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_select.cuh"

namespace {

using namespace bm25;  // pack_key, radix_select, sort_and_write, ...

constexpr int kWarpsPerBlock = 8;
constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kCap = 2048;        // selected keys a block keeps in shared memory
constexpr int kMaxChunks = 1024;  // chunk keys a block keeps in shared memory

__device__ __forceinline__ float masked(float v) {
  return v > 0.0f ? v : -__int_as_float(0x7F800000);
}

__global__ void block_max_keys_kernel(const float* __restrict__ acc,
                                      u64* __restrict__ bkeys, int n_q,
                                      int n_blocks, int64_t stride, int block) {
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_q) * n_blocks) return;
  const int q = static_cast<int>(warp / n_blocks);
  const int b = static_cast<int>(warp - static_cast<int64_t>(q) * n_blocks);
  const float4* row = reinterpret_cast<const float4*>(
      acc + static_cast<int64_t>(q) * stride + static_cast<int64_t>(b) * block);
  float best = masked(0.0f);
  for (int i = lane; i < block / 4; i += 32) {
    const float4 v = __ldcs(row + i);  // streamed once: evict first
    best = fmaxf(best, fmaxf(fmaxf(masked(v.x), masked(v.y)),
                             fmaxf(masked(v.z), masked(v.w))));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(kFull, best, d));
  }
  if (lane == 0) bkeys[warp] = pack_key(best, b);
}

struct SelShared {
  u64 buf[kCap];
  u64 ck[kMaxChunks];
  int bi[kMaxChunks];
  unsigned hist[256];
  unsigned warp_cnt[kSelWarps];
  unsigned count;
  unsigned digit, below, bin;
  u64 kth;
};

// The candidates of one row: positions [0, kb * block) walk the chosen
// blocks in ascending id order, the rest the tail [tail_start, tail_start +
// tail_len), whose docs at or past n_docs read as 0.
struct Row {
  const float* row;
  const int* bi;
  int kb, block, tail_start, tail_len, n_docs;

  __device__ int n() const { return kb * block + tail_len; }
  __device__ void at(int pos, int* doc, float* v) const {
    const int head = kb * block;
    if (pos < head) {
      const int j = pos / block;
      *doc = bi[j] * block + (pos - j * block);
      *v = row[*doc];
    } else {
      *doc = tail_start + (pos - head);
      *v = *doc < n_docs ? row[*doc] : 0.0f;
    }
  }
};

// Ordered compaction: emit(rank, i) for the first `limit` i < n, in
// ascending i, with pred(i) true.  Every thread of the block calls it.
template <typename Pred, typename Emit>
__device__ void ordered_collect(SelShared& s, int n, unsigned limit, Pred pred,
                                Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned base = 0;
  for (int t0 = 0; t0 < n && base < limit; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const bool f = i < n && pred(i);
    const unsigned b = __ballot_sync(kFull, f);
    if (lane == 0) s.warp_cnt[warp] = __popc(b);
    __syncthreads();
    unsigned before = base, total = 0;
    for (int w = 0; w < kSelWarps; ++w) {
      const unsigned c = s.warp_cnt[w];
      if (w < warp) before += c;
      total += c;
    }
    before += __popc(b & ((1u << lane) - 1u));
    if (f && before < limit) emit(before, i);
    base += total;
    __syncthreads();
  }
}

// Appends key to the row's selected keys: shared memory while they fit,
// else (spill != nullptr) the scratch row.
__device__ __forceinline__ void keep(SelShared& s, u64 key, u64* spill) {
  const unsigned idx = atomicAdd(&s.count, 1u);
  if (spill != nullptr) {
    spill[idx] = key;
  } else if (idx < kCap) {
    s.buf[idx] = key;
  }
}

__global__ void __launch_bounds__(kSelThreads) dense_topk_select_kernel(
    const float* __restrict__ acc, const u64* bkeys, int* bi_scratch,
    u64* sel_scratch, int* nsel, float* __restrict__ out_s,
    int32_t* __restrict__ out_i, int n_blocks, int kb, int block,
    int tail_start, int tail_len, int n_docs, int chunk, int k,
    int64_t stride) {
  __shared__ SelShared s;
  const int q = blockIdx.x;
  const float* row = acc + static_cast<int64_t>(q) * stride;
  float* os = out_s + static_cast<int64_t>(q) * k;
  int32_t* oi = out_i + static_cast<int64_t>(q) * k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. The chunk keys: pass 1's block keys, or chunk maxima of the row.
  const u64* ck = s.ck;
  int n_ck;
  if (kb > 0) {
    n_ck = n_blocks;
    const u64* src = bkeys + static_cast<int64_t>(q) * n_blocks;
    if (n_blocks <= kMaxChunks) {
      for (int i = threadIdx.x; i < n_blocks; i += blockDim.x) s.ck[i] = src[i];
    } else {
      ck = src;
    }
  } else {
    n_ck = (n_docs + chunk - 1) / chunk;
    if (chunk == 128) {
      // A warp's 32 float4 loads are one chunk: four chunks in flight.
      const int n4 = (n_docs + 3) / 4;
      constexpr int kUnroll = 4;
      for (int f0 = threadIdx.x; f0 - lane < n4; f0 += kUnroll * kSelThreads) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int f = f0 + u * kSelThreads;
          if (f < n4) v[u] = *reinterpret_cast<const float4*>(row + 4 * f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int f = f0 + u * kSelThreads;
          const int d = 4 * f;
          float best = masked(0.0f);
          if (f < n4) {
            best = masked(v[u].x);
            if (d + 1 < n_docs) best = fmaxf(best, masked(v[u].y));
            if (d + 2 < n_docs) best = fmaxf(best, masked(v[u].z));
            if (d + 3 < n_docs) best = fmaxf(best, masked(v[u].w));
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
          }
          const int c = (f - lane) / 32;
          if (lane == 0 && f < n4) s.ck[c] = pack_key(best, c);
        }
      }
    } else {
      for (int c = warp; c < n_ck; c += kSelWarps) {
        float best = masked(0.0f);
        const int lo = c * chunk;
        const int hi = min(lo + chunk, n_docs);
        for (int d = lo + 4 * lane; d < hi; d += 128) {
          const float4 v = *reinterpret_cast<const float4*>(row + d);
          best = fmaxf(best, masked(v.x));
          if (d + 1 < hi) best = fmaxf(best, masked(v.y));
          if (d + 2 < hi) best = fmaxf(best, masked(v.z));
          if (d + 3 < hi) best = fmaxf(best, masked(v.w));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
        }
        if (lane == 0) s.ck[c] = pack_key(best, c);
      }
    }
  }
  __syncthreads();

  // 2. The threshold (and, hierarchical, the chosen blocks in id order).
  uint32_t hi_tau = kInfBits;
  int* bi = bi_scratch != nullptr ? bi_scratch + static_cast<int64_t>(q) * kb : s.bi;
  if (n_ck >= k) {
    u64 prefix = 0, mask = ~0ull;
    if (ck == s.ck) {
      kth_by_rank(s, s.ck, n_ck, k);
      prefix = s.kth;
    } else {
      radix_select(
          s, n_ck, static_cast<unsigned>(k),
          [&](int i, u64* key) {
            *key = ck[i];
            return true;
          },
          &prefix, &mask);
    }
    hi_tau = static_cast<uint32_t>((prefix | ~mask) >> 32);
    if (kb > 0) {
      ordered_collect(
          s, n_ck, static_cast<unsigned>(kb),
          [&](int i) { return (ck[i] & mask) <= prefix; },
          [&](unsigned r, int i) { bi[r] = i; });
    }
  }
  const Row cand{row, bi, kb, block, tail_start, tail_len, n_docs};
  const int n_cand = cand.n();
  auto survivor = [&](int pos, u64* key) {
    int doc;
    float v;
    cand.at(pos, &doc, &v);
    *key = pack_key(v, doc);
    return v > 0.0f && static_cast<uint32_t>(*key >> 32) <= hi_tau;
  };

  // 3. One read of the candidates: positive keys under the threshold (and
  // at most `limit`, once a pass has tightened it).
  auto scan = [&](u64 limit, u64* spill) {
    if (threadIdx.x == 0) s.count = 0;
    __syncthreads();
    // Float4 f < n4h walks the chosen blocks, the rest the tail.
    const int per = block / 4;
    const int n4h = kb * per;
    const int n4 = n4h + (tail_len + 3) / 4;
    const int tail_lim = min(tail_start + tail_len, n_docs);
    constexpr int kUnroll = 4;
    for (int f0 = threadIdx.x; f0 < n4; f0 += kUnroll * kSelThreads) {
      float4 v[kUnroll];
      int doc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int f = f0 + u * kSelThreads;
        doc[u] = -1;
        if (f < n4h) {
          const int j = f / per;
          doc[u] = bi[j] * block + 4 * (f - j * per);
        } else if (f < n4) {
          doc[u] = tail_start + 4 * (f - n4h);
        }
        if (doc[u] >= 0) v[u] = *reinterpret_cast<const float4*>(row + doc[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (doc[u] < 0) continue;
        const int lim = f0 + u * kSelThreads < n4h ? doc[u] + 4 : tail_lim;
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const u64 key = pack_key(e[x], doc[u] + x);
          if (doc[u] + x < lim && e[x] > 0.0f &&
              static_cast<uint32_t>(key >> 32) <= hi_tau && key <= limit) {
            keep(s, key, spill);
          }
        }
      }
    }
    __syncthreads();
    const unsigned n = s.count;
    __syncthreads();  // every thread has read it before s.count is reused
    return n;
  };
  auto in_buffer = [&](int i, u64* key) {
    *key = s.buf[i];
    return true;
  };
  unsigned n_pos = scan(~0ull, nullptr);
  const unsigned uk = static_cast<unsigned>(k);

  // 4. Too many for the buffer: the k-th smallest buffered key bounds the
  // k-th smallest of all (the buffer holds k of them at or below it), so
  // the row is read again keeping only keys at or below it; the bound
  // falls every time, as the buffer holds more than k keys below it.
  while (n_pos > kCap && 2 * k <= kCap) {
    u64 prefix, mask;
    radix_select(s, kCap, uk, in_buffer, &prefix, &mask);
    n_pos = scan(prefix | ~mask, nullptr);
  }
  const unsigned n_sel = min(n_pos, uk);
  u64* spill = n_sel > kCap ? sel_scratch + static_cast<int64_t>(q) * k : nullptr;
  if (nsel != nullptr && threadIdx.x == 0) nsel[q] = spill != nullptr ? n_sel : 0;
  unsigned held = min(n_pos, static_cast<unsigned>(kCap));
  if (n_pos > kCap) {
    // k > kCap / 2: select over the row, then collect exactly n_sel keys
    // (all positives under the threshold when they are fewer than k).
    u64 prefix = ~0ull, mask = ~0ull;
    if (n_pos > uk) {
      radix_select(s, n_cand, uk, survivor, &prefix, &mask);
    }
    if (threadIdx.x == 0) s.count = 0;
    __syncthreads();
    for (int pos = threadIdx.x; pos < n_cand; pos += blockDim.x) {
      u64 key;
      if (survivor(pos, &key) && (key & mask) <= prefix) keep(s, key, spill);
    }
    __syncthreads();
    held = n_sel;
  }

  // 5. The selected keys, in order.
  if (spill == nullptr) {
    if (held > kCountSort && n_sel <= kCountSort) {
      // Select the n_sel smallest in the buffer, move them to s.ck, rank them.
      u64 prefix, mask;
      radix_select(s, static_cast<int>(held), n_sel, in_buffer, &prefix, &mask);
      if (threadIdx.x == 0) s.count = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < static_cast<int>(held); i += blockDim.x) {
        const u64 key = s.buf[i];
        if ((key & mask) <= prefix) s.ck[atomicAdd(&s.count, 1u)] = key;
      }
      __syncthreads();
      sort_and_write(s.ck, static_cast<int>(n_sel), static_cast<int>(n_sel), os, oi);
    } else {
      sort_and_write(s.buf, static_cast<int>(held), static_cast<int>(n_sel), os, oi);
    }
  }
  if (n_pos < uk) {
    // Pads: the first k - n_pos non-positive candidates, in doc order.
    ordered_collect(
        s, n_cand, uk - n_pos,
        [&](int pos) {
          int doc;
          float v;
          cand.at(pos, &doc, &v);
          return !(v > 0.0f);
        },
        [&](unsigned r, int pos) {
          int doc;
          float v;
          cand.at(pos, &doc, &v);
          os[n_pos + r] = -__int_as_float(0x7F800000);
          oi[n_pos + r] = doc;
        });
  }
}

// Rows whose selected keys spilled (nsel[q] > kCap): sort each kCap-key
// chunk of the scratch row in shared memory, in place.
__global__ void __launch_bounds__(kSelThreads) sort_chunks_kernel(
    u64* sel_scratch, const int* nsel, int k) {
  __shared__ u64 buf[kCap];
  const int q = blockIdx.y;
  const int n = nsel[q];
  const int c0 = blockIdx.x * kCap;
  if (n <= kCap || c0 >= n) return;
  const int len = min(kCap, n - c0);
  u64* src = sel_scratch + static_cast<int64_t>(q) * k + c0;
  int np = 1;
  while (np < len) np <<= 1;
  for (int i = threadIdx.x; i < np; i += blockDim.x) buf[i] = i < len ? src[i] : ~0ull;
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int half = size >> 1; half > 0; half >>= 1) {
      for (int i = threadIdx.x; i < np / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (half - 1));
        const int hi = lo + half;
        const u64 a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) src[i] = buf[i];
}

// Each spilled key goes to its rank: its place in its sorted chunk plus
// the keys below it in every other chunk (binary search; keys distinct).
__global__ void __launch_bounds__(kSelThreads) rank_merge_kernel(
    const u64* __restrict__ sel_scratch, const int* __restrict__ nsel,
    float* __restrict__ out_s, int32_t* __restrict__ out_i, int k) {
  const int q = blockIdx.y;
  const int n = nsel[q];
  const int c0 = blockIdx.x * kCap;
  if (n <= kCap || c0 >= n) return;
  const u64* keys = sel_scratch + static_cast<int64_t>(q) * k;
  const int len = min(kCap, n - c0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const u64 key = keys[c0 + i];
    int rank = i;
    for (int o = 0; o < n; o += kCap) {
      if (o == c0) continue;
      int lo = 0, hi = min(kCap, n - o);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[o + mid] < key) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    unpack_to(key, out_s + static_cast<int64_t>(q) * k + rank,
              out_i + static_cast<int64_t>(q) * k + rank);
  }
}

}  // namespace

// One call computes dense_topk on a CUDA accumulator.  hier != 0: the
// hierarchical branch (pass 1 into bkeys [Q, M / block]); else the masked
// top-k over the first n_docs columns.  bi_scratch [Q, k] (hierarchical
// with k > 1,024) and sel_scratch [Q, k] with nsel [Q] (k > 2,048) may be
// null otherwise.  Writes out_s [Q, k] f32 and out_i [Q, k] i32.
extern "C" int bm25_dense_topk(const void* acc, void* bkeys, void* bi_scratch,
                               void* sel_scratch, void* nsel, void* out_s,
                               void* out_i, int n_q, int m, int n_docs, int k,
                               int block, long long stride, int hier,
                               void* stream) {
  if (block <= 0 || block % 128 || stride % 4 || k < 1 || n_docs < 0 ||
      n_docs > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = hier ? m / block : 0;
  const int kb = hier ? k : 0;
  const int tail_start = t * block;
  const int tail_len = (hier ? m : n_docs) - tail_start;
  if (static_cast<long long>(kb) * block + tail_len < k || (hier && t < k) ||
      (kb > kMaxChunks && bi_scratch == nullptr) ||
      (k > kCap && (sel_scratch == nullptr || nsel == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0) return 0;
  if (hier) {
    const long long warps = static_cast<long long>(n_q) * t;
    const long long grid = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    block_max_keys_kernel<<<static_cast<unsigned int>(grid), kWarpsPerBlock * 32,
                            0, st>>>(static_cast<const float*>(acc),
                                     static_cast<u64*>(bkeys), n_q, t,
                                     static_cast<int64_t>(stride), block);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Non-hierarchical chunks: a multiple of 128 docs, at most kMaxChunks.
  const int chunk = 128 * max(1, (n_docs + 128 * kMaxChunks - 1) / (128 * kMaxChunks));
  int* sel_n = static_cast<int*>(nsel);
  dense_topk_select_kernel<<<n_q, kSelThreads, 0, st>>>(
      static_cast<const float*>(acc), static_cast<const u64*>(bkeys),
      kb > kMaxChunks ? static_cast<int*>(bi_scratch) : nullptr,
      static_cast<u64*>(sel_scratch), k > kCap ? sel_n : nullptr,
      static_cast<float*>(out_s), static_cast<int32_t*>(out_i), t, kb, block,
      tail_start, tail_len, n_docs, chunk, k, static_cast<int64_t>(stride));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || k <= kCap) return static_cast<int>(err);
  const dim3 grid((k + kCap - 1) / kCap, n_q);
  sort_chunks_kernel<<<grid, kSelThreads, 0, st>>>(static_cast<u64*>(sel_scratch),
                                                  sel_n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_merge_kernel<<<grid, kSelThreads, 0, st>>>(
      static_cast<const u64*>(sel_scratch), sel_n, static_cast<float*>(out_s),
      static_cast<int32_t*>(out_i), k);
  return static_cast<int>(cudaGetLastError());
}
