// In-block selection on packed 64-bit keys, shared by S2 (dense_topk.cu)
// and S5 (stream_rescore.cu).
//
// A key orders (score desc, doc asc) as one unsigned integer, the packing
// of ops/topk.py:
//
//     key = (score > 0 ? 0x7F800000 - f32_bits(score) : 0x7F800000) << 32 | doc
//
// (NaN, +-0, negatives and -inf share the top half 0x7F800000, the "pad"
// half, which unpacks to -inf).  radix_select finds the k smallest of a
// block's keys by 8-bit digits from the top, in shared or device memory;
// kth_by_rank finds the k-th smallest of a few hundred keys by counting
// (S2 and S5 take it over the minima of chunks of keys: a bound on the
// k-th smallest of all, past which no key can enter); sort_and_write
// orders up to a few thousand keys and writes them as (score, id).  Every
// thread of the block calls each of them.

#pragma once

#include <stdint.h>

namespace bm25 {

using u64 = unsigned long long;

constexpr uint32_t kInfBits = 0x7F800000u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kCountSort = 256;  // up to this many keys, rank by counting

__device__ __forceinline__ u64 pack_key(float v, int doc) {
  const uint32_t hi = v > 0.0f ? kInfBits - __float_as_uint(v) : kInfBits;
  return (static_cast<u64>(hi) << 32) | static_cast<uint32_t>(doc);
}

__device__ __forceinline__ void unpack_to(u64 key, float* s, int32_t* id) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  *s = hi == kInfBits ? -__int_as_float(0x7F800000) : __uint_as_float(kInfBits - hi);
  *id = static_cast<int32_t>(static_cast<uint32_t>(key));
}

// The shared state of radix_select, as a member set of the caller's shared
// struct S: unsigned hist[256]; unsigned digit, below, bin.

// Warp 0: the bin of the 256 in s.hist that holds the need-th key
// (1-based), the keys in lower bins, and the bin's count.
template <typename S>
__device__ void find_bin(S& s, unsigned need) {
  const int lane = threadIdx.x & 31;
  unsigned c[8];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = s.hist[lane * 8 + j];
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  unsigned below = incl - sum;
  if (below < need && need <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (below + c[j] >= need) {
        s.digit = lane * 8 + j;
        s.below = below;
        s.bin = c[j];
        break;
      }
      below += c[j];
    }
  }
}

// Radix select over the valid keys get(i, &key), i < n (need <= the valid
// count).  On return (key & *mask) < *prefix holds for fewer than `need`
// of them and (key & *mask) <= *prefix for at least `need`: exactly
// `need` where it stopped early, when the chosen bin held exactly the keys
// still needed; else *mask is every bit, *prefix the need-th smallest key,
// and only copies of it go past `need`.  8-bit digits from the top.
template <typename S, typename Get>
__device__ void radix_select(S& s, int n, unsigned need, Get get,
                             u64* prefix_out, u64* mask_out) {
  u64 prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s.hist[i] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int b = threadIdx.x - lane; b < n; b += blockDim.x) {
      // Lanes with the same digit add once: the keys of a row crowd into
      // few bins (equal scores), and same-address atomics serialise.
      u64 key;
      const bool hit = b + lane < n && get(b + lane, &key) && (key & mask) == prefix;
      const unsigned bin = hit ? static_cast<unsigned>(key >> shift) & 255u : 256u + lane;
      const unsigned peers = __match_any_sync(kFull, bin);
      if (hit && lane == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) find_bin(s, need);
    __syncthreads();
    prefix |= static_cast<u64>(s.digit) << shift;
    mask |= static_cast<u64>(255) << shift;
    need -= s.below;
    const bool done = s.bin == need;
    __syncthreads();  // s.digit is rewritten by the next pass
    if (done) break;
  }
  *prefix_out = prefix;
  *mask_out = mask;
}

// The k-th smallest (1-based, counted with multiplicity) of n keys in
// shared memory, by counting: the key with fewer than k keys below it and
// at least k at or below it goes to s.kth (a member u64 kth of S).  n at
// most a few thousand: every thread compares its keys with all n.  One
// barrier.
template <typename S>
__device__ void kth_by_rank(S& s, const u64* keys, int n, int k) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const u64 key = keys[i];
    int lt = 0, le = 0;
    for (int j = 0; j < n; ++j) {
      lt += keys[j] < key;
      le += keys[j] <= key;
    }
    if (lt < k && k <= le) s.kth = key;
  }
  __syncthreads();
}

// Sorts buf[0, n) ascending (pow2(n) entries of room, in shared or device
// memory) and writes its first m keys as (score, id).  Equal keys take
// neighbouring ranks.
__device__ inline void sort_and_write(u64* buf, int n, int m, float* out_s, int32_t* out_i) {
  if (n <= kCountSort) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const u64 key = buf[i];
      int r = 0;
      for (int j = 0; j < n; ++j) r += buf[j] < key || (buf[j] == key && j < i);
      if (r < m) unpack_to(key, out_s + r, out_i + r);
    }
    __syncthreads();
    return;
  }
  int np = 1;
  while (np < n) np <<= 1;
  for (int i = n + threadIdx.x; i < np; i += blockDim.x) buf[i] = ~0ull;
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
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    unpack_to(buf[i], out_s + i, out_i + i);
  }
  __syncthreads();
}

}  // namespace bm25
