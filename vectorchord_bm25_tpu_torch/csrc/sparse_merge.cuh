// The sparse reduction in one launch (sm_90a), shared by SP-stream
// (sparse_merge.cu) and SP-exact (exact_merge.cu).
//
// Computes, for each row q of a [Q, P] window matrix, what the reference's
// _stream_sparse (vectorchord_bm25_tpu/search/stream.py:309-363) and
// _score_and_topk_sparse (search/exact.py:185-254) compute after their
// gather: every lane as (doc, score), the lanes sorted by doc, each doc's
// run summed by the Hillis-Steele scan, and the k best run sums (score
// desc, doc asc) by lax.top_k over the sorted row.  No lane is written to
// device memory and nothing is sorted there.
//
// The row's layout.  seg_off[q] (S + 1 offsets) splits the row's first
// seg_off[q][S] windows into S segments, one a (query, term occurrence) in
// term order; the windows after them are pads.  Inside a segment the
// windows are doc-ascending and hold each doc at most once, so after the
// reference's stable sort a doc's run lists its lanes in segment order,
// and where a window sits inside its segment changes nothing.  The run's
// value is therefore the scan's tree over the doc's postings taken in
// segment order, its last segment's first (stream_sparse.cu, "Exactness of
// S4"): x_m is the posting of the m-th last segment holding the doc, m <
// 2^seg_steps, and filtered or deleted postings (score 0.0) keep their
// place.  Lanes that are dead or past the row's segments sort last as
// n_docs and are never candidates.
//
// Design.  The host plans the blocks: a row's doc axis is cut into up to
// 64 parts, more for rows with more windows, a block a part.  A block loads
// the row's window bases (their first docs) into shared memory and finds
// its part by binary search on the doc, so that the row's parts hold about
// as many windows each however its docs cluster; then each segment's
// windows that reach the part.  It walks the part in tiles of docs [a,
// b): a tile takes, in every segment, the windows whose base is below b
// from the one that holds a on.  Its lanes in [a, b) are estimated from
// the bases (a window's 128 spread up to the next window's base) and the
// width shrinks until the estimate fits kLanes; a tile that still
// overflows is cut in half and decoded again.  Its warps decode all of those
// windows at once, each lane with a doc in [a, b) going to the tile's lane
// arrays with its segment; a lane of another tile is dropped (its
// straddling window is decoded again there).  Each lane then finds its
// doc's slot in an open-addressing table (kSlots = 2 kLanes slots) and
// links itself into the slot's list; the lane that found the list empty
// owns the run: it walks the list, takes its lanes by descending segment
// and builds the scan's tree with S4's binary-counter stack (__fadd_rn, no
// atomics, no contraction), so the sum is the reference's bit for bit.  A
// one-doc tile holds a lane a segment that has the doc, so it overflows
// only where more than kLanes segments do (a query of more than kLanes term
// occurrences): its run is then summed in chunks of kLanes segments, the
// last first, the chunks' lanes decoded again and one thread carrying the
// stack from chunk to chunk, so no segment count is refused.  A tile's
// next start skips to the first doc that any window still holds.
//
// Selection.  Keys are key_select.cuh's packing.  A block keeps its
// candidates in a buffer (2 kSmallTop keys in shared memory for kk = min(k,
// P * 128) <= kSmallTop, else kk plus four tiles' worth in device memory)
// behind a threshold: a tile's candidates under it join; where they would
// overflow the buffer, the kk best of both stay (ranked by counting when
// few, else by a radix select) and the threshold drops to the kk-th.  The
// pad ids follow lax.top_k over the sorted row: after the candidates come
// the docs of the non-candidate lanes in doc order (a run's other lanes,
// and a run whose sum is not > 0), then n_docs for the dead lanes, then
// (-inf, 0) past kk.  A block needs at most kk minus its candidates of
// them, so it keeps the lowest docs of its non-candidate lanes up to that
// count (a radix select on the doc in the tile that crosses it).  The last
// block of a row to finish (a device-memory counter, zeroed by the launch)
// merges the row, sorting in shared memory up to kk = kSmemSort / 2: the
// kk best of the parts' keys, sorted, or all of them and the pads of the
// first parts in order where the row has fewer than kk.
//
// Bound.  Each window's table entries and words are read once (once more
// where a tile boundary cuts it), each live lane's s1_eff or impact and
// filter entries once, and [Q, k] is written: no per-lane device memory
// traffic.  Latency, not bytes, limits it, as in S5: a tile's decode is a
// chain of dependent loads, issued for all its windows together.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "key_select.cuh"
#include "launch_smem.cuh"

namespace bm25 {
namespace merge {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWinLanes = 128;
constexpr int kLanes = 2048;      // lanes a tile holds
constexpr int kSlots = 2 * kLanes;  // the doc table's slots (a power of two)
constexpr int kTarget = kLanes * 3 / 4;  // lanes a tile is sized for
constexpr int kBaseCache = 8192;  // window bases of a row in shared memory
constexpr int kSmemSegs = 256;    // segment cursors in shared memory
constexpr int kSmallTop = 256;    // kk up to this keeps a block's keys in shared memory
// Keys the merge sorts in shared memory (the tile arrays it no longer needs:
// the slots and the base cache), past which a row sorts in device memory.
constexpr int kSmemSort = (2 * kSlots * 4 + kBaseCache * 4) / 8;
constexpr int kMaxSegSteps = 30;
constexpr int kOwner = -1;  // seg mark of a run's owner lane, its sum in sc

// A block's counts, as the merge reads them.
enum Meta { kCand = 0, kNonCand, kTop, kPad, kMetaInts = 4 };

// Offsets (bytes) of the launch's device-memory scratch: the rows' done
// counters, each block's counts, keys and pad docs, a row's sort buffer
// for the merge, and the segment cursors where S > kSmemSegs.
struct Layout {
  long long counter, meta, tops, pads, rowbuf, segs, total, seg_room;
  int buf_room, top_room, row_room;

  __host__ __device__ static long long align(long long x) { return (x + 15) & ~15LL; }
  __host__ __device__ static int pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
  }
  __host__ __device__ Layout(int n_q, int n_blocks, int n_s, int kk) {
    // A block's candidate buffer: kSmallTop pairs in shared memory, else
    // kk and room for 4 tiles or kk more in device memory, with kk behind
    // it for a selection's output.
    buf_room = kk <= kSmallTop ? 2 * kSmallTop : kk + (kk > 4 * kLanes ? kk : 4 * kLanes);
    top_room = kk <= kSmallTop ? kk : buf_room + kk;
    row_room = pow2(2 * kk) > kCountSort ? pow2(2 * kk) : kCountSort;
    const int row_dev = row_room > kSmemSort ? row_room : 0;
    seg_room = n_s > kSmemSegs ? 5LL * n_s + 2 : 0;
    const long long blocks = n_blocks;
    counter = 0;
    meta = align(4LL * n_q);
    tops = align(meta + 4LL * kMetaInts * blocks);
    pads = align(tops + 8LL * blocks * top_room);
    rowbuf = align(pads + 4LL * blocks * kk);
    segs = align(rowbuf + 8LL * n_q * row_dev);
    total = align(segs + 4LL * blocks * seg_room);
  }
};

struct Shared {
  int doc[kLanes];
  float sc[kLanes];
  int seg[kLanes];
  int16_t nxt[kLanes];
  int key[kSlots];
  int head[kSlots];
  int base[kBaseCache];
  u64 top[2 * kSmallTop];
  u64 ubuf[kCountSort];
  int cur[kSmemSegs], end[kSmemSegs], send[kSmemSegs], cnt[kSmemSegs], pre[kSmemSegs + 2];
  int split[2];
  unsigned hist[256];
  unsigned digit, below, bin, count;
  u64 kth, thr_max;
  int n_lanes, overflow, next_a, total, est, c_tile, c_pass, last, more;
};

static_assert(offsetof(Shared, head) == offsetof(Shared, key) + 4 * kSlots &&
                  offsetof(Shared, base) == offsetof(Shared, head) + 4 * kSlots &&
                  offsetof(Shared, key) % 8 == 0,
              "the merge sorts in key, head and base as one array");

__device__ __forceinline__ unsigned slot_of(int d) {
  return (static_cast<unsigned>(d) * 2654435761u) >> 20;  // 12 bits: kSlots
}
static_assert(kSlots == 1 << 12, "slot_of yields 12 bits");

// First index in [l, r) whose base(i) >= v (ge) or > v (!ge).
template <typename F>
__device__ __forceinline__ int search(int l, int r, int v, bool ge, F base) {
  while (l < r) {
    const int m = l + ((r - l) >> 1);
    const int b = base(m);
    if (ge ? b < v : b <= v) {
      l = m + 1;
    } else {
      r = m;
    }
  }
  return l;
}

// The estimated lanes of window w (its segment's windows end at w_end) with
// a doc in [a, b): its 128 spread evenly from its base to the next
// window's (the last window of a segment: over as many docs as the one
// before it spans, or to n_docs' end of the axis when alone).
template <typename F>
__device__ __forceinline__ int in_range(int w, int a, int b, int w_end, F base) {
  const long long lo = base(w);
  long long hi;
  if (w + 1 < w_end) {
    hi = base(w + 1);
  } else {
    hi = w > 0 ? lo + max(1LL, lo - base(w - 1)) : lo + 1;
  }
  hi = max(hi, lo + 1);
  const long long in = min(hi, static_cast<long long>(b)) - max(lo, static_cast<long long>(a));
  return in <= 0 ? 0 : static_cast<int>((kWinLanes * in + (hi - lo) - 1) / (hi - lo));
}

// Block-wide exclusive scan of cnt[0, n) into pre[0, n] (warp 0, a lane a
// chunk of consecutive entries).
__device__ __forceinline__ void scan_counts(const int* cnt, int* pre, int n) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (n + 31) / 32;
    const int l0 = min(n, lane * per), l1 = min(n, l0 + per);
    int sum = 0;
    for (int i = l0; i < l1; ++i) sum += cnt[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    int run = incl - sum;
    for (int i = l0; i < l1; ++i) {
      pre[i] = run;
      run += cnt[i];
    }
    if (lane == 31) pre[n] = incl;
  }
  __syncthreads();
}

// The block's max of keys[i], i < n (every thread calls it).
template <typename Get>
__device__ u64 block_max(Shared& s, int n, Get get) {
  if (threadIdx.x == 0) s.thr_max = 0;
  __syncthreads();
  u64 m = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) m = max(m, get(i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(kFull, m, o));
  if ((threadIdx.x & 31) == 0) atomicMax(&s.thr_max, m);
  __syncthreads();
  return s.thr_max;
}

constexpr int kWide = 4;  // keys a thread loads before it uses the first

// For each i < n whose get(i, &key) holds, put(at, key) at consecutive
// positions from s.count (which the caller sets): a warp's takers reserve
// their slots with one atomic, and a thread loads kWide keys before it
// uses them.  Every thread calls it; ends with a barrier.
template <typename Get, typename Put>
__device__ void append_if(Shared& s, int n, Get get, Put put) {
  const int lane = threadIdx.x & 31;
  for (int i0 = threadIdx.x - lane; i0 < n; i0 += kWide * kThreads) {
    u64 key[kWide];
    bool take[kWide];
#pragma unroll
    for (int x = 0; x < kWide; ++x) {
      const int i = i0 + x * kThreads + lane;
      key[x] = 0;
      take[x] = i < n && get(i, &key[x]);
    }
#pragma unroll
    for (int x = 0; x < kWide; ++x) {
      const unsigned bal = __ballot_sync(kFull, take[x]);
      unsigned at = 0;
      if (lane == 0 && bal) at = atomicAdd(&s.count, static_cast<unsigned>(__popc(bal)));
      at = __shfl_sync(kFull, at, 0) + __popc(bal & ((1u << lane) - 1u));
      if (take[x]) put(at, key[x]);
    }
  }
  __syncthreads();
}

// key_select.cuh's radix_select with kWide keys loaded a thread before the
// first is binned: the keys here often lie in device memory.
template <typename Get>
__device__ void radix_select_wide(Shared& s, int n, unsigned need, Get get, u64* prefix_out,
                                  u64* mask_out) {
  u64 prefix = 0, mask = 0;
  const int lane = threadIdx.x & 31;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) s.hist[i] = 0;
    __syncthreads();
    for (int i0 = threadIdx.x - lane; i0 < n; i0 += kWide * kThreads) {
      u64 key[kWide];
      bool hit[kWide];
#pragma unroll
      for (int x = 0; x < kWide; ++x) {
        const int i = i0 + x * kThreads + lane;
        key[x] = 0;
        hit[x] = i < n && get(i, &key[x]) && (key[x] & mask) == prefix;
      }
#pragma unroll
      for (int x = 0; x < kWide; ++x) {
        // Lanes with the same digit add once, as in radix_select.
        const unsigned bin =
            hit[x] ? static_cast<unsigned>(key[x] >> shift) & 255u : 256u + lane;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (hit[x] && lane == __ffs(peers) - 1) atomicAdd(&s.hist[bin], __popc(peers));
      }
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

// The `need` smallest of the valid keys get(i), i < n (at least `need`
// valid), each handed to put(at, key), at < need, in no order: a radix
// select, then the keys under its prefix and as many copies of it as are
// still needed.
template <typename Get, typename Put>
__device__ void select_into(Shared& s, int n, unsigned need, Get get, Put put) {
  u64 prefix, mask;
  radix_select_wide(s, n, need, get, &prefix, &mask);
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  append_if(s, n, [&](int i, u64* key) { return get(i, key) && (*key & mask) < prefix; }, put);
  append_if(s, n, [&](int i, u64* key) { return get(i, key) && (*key & mask) == prefix; },
            [&](unsigned at, u64 key) {
              if (at < need) put(at, key);
            });
}


struct Args {
  const int32_t* seg_off;  // [Q, S + 1]
  const int32_t* plan;     // [n_blocks]: row << 12 | part << 6 | (parts - 1)
  float* out_s;            // [Q, k]
  int32_t* out_i;          // [Q, k]
  unsigned char* scratch;  // Layout(Q, n_blocks, S, kk)
  int n_q, P, S, n_blocks, n_docs, k, kk, seg_steps;
};

// Src: the window source (sparse_merge.cu, exact_merge.cu) with
//   int base(long long qp)  the first doc of window qp = q * P + p;
//   void lanes(long long qp, int n_docs, int doc[4], float sc[4], bool live[4])
//     a warp's decode of window qp, thread t lanes t + 32 j: live lanes
//     are those with a doc in [0, n_docs) and their score.
template <typename Src>
__global__ void __launch_bounds__(kThreads, 2) sparse_merge_kernel(Src src, Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  const Layout lay(args.n_q, args.n_blocks, args.S, args.kk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = args.S, P = args.P, kk = args.kk, n_docs = args.n_docs;
  const int pl = args.plan[blockIdx.x];
  const int q = pl >> 12, part = (pl >> 6) & 63, B = (pl & 63) + 1;
  const long long first_block = static_cast<long long>(blockIdx.x) - part;
  const int32_t* so = args.seg_off + static_cast<long long>(q) * (S + 1);
  const long long qp0 = static_cast<long long>(q) * P;
  unsigned char* scr = args.scratch;
  int* meta = reinterpret_cast<int*>(scr + lay.meta) + static_cast<long long>(blockIdx.x) * kMetaInts;
  u64* gtop = reinterpret_cast<u64*>(scr + lay.tops) + static_cast<long long>(blockIdx.x) * lay.top_room;
  int* gpad = reinterpret_cast<int*>(scr + lay.pads) + static_cast<long long>(blockIdx.x) * kk;
  // The candidate buffer and a selection's output.
  u64* tb = kk <= kSmallTop ? s.top : gtop;
  u64* sel = kk <= kSmallTop ? s.ubuf : gtop + lay.buf_room;
  int *cur = s.cur, *end = s.end, *send = s.send, *cnt = s.cnt, *pre = s.pre;
  if (S > kSmemSegs) {
    int* g = reinterpret_cast<int*>(scr + lay.segs) + static_cast<long long>(blockIdx.x) * lay.seg_room;
    cur = g;
    end = g + S;
    send = g + 2 * S;
    cnt = g + 3 * S;
    pre = g + 4 * S;
  }

  for (int i = tid; i < kSlots; i += kThreads) {
    s.key[i] = -1;
    s.head[i] = -1;
  }
  const int n_win = min(max(so[S], 0), P);
  const bool cached = n_win <= kBaseCache;
  if (cached) {
    for (int p = tid; p < n_win; p += kThreads) s.base[p] = src.base(qp0 + p);
  }
  for (int j = tid; j < S; j += kThreads) {
    const int w0 = min(max(so[j], 0), n_win);
    cur[j] = w0;
    send[j] = min(max(so[j + 1], w0), n_win);
  }
  __syncthreads();
  auto base_of = [&](int p) { return cached ? s.base[p] : src.base(qp0 + p); };

  // The block's part of the doc axis: the row's windows cut into B parts
  // of about as many windows each (a binary search on the doc, warp 0 for
  // the part's start and warp 1 for its end), so a row's blocks take about
  // as many lanes each however its docs cluster.
  if (warp < 2) {
    const int i = part + warp;
    int l = 0, r = n_docs;
    if (i == 0) r = 0;
    if (i == B) l = n_docs;
    long long want = -1;
    if (l < r) {
      int n_all = 0;
      for (int j = lane; j < S; j += 32) n_all += send[j] - cur[j];
      n_all = __reduce_add_sync(kFull, n_all);
      want = static_cast<long long>(i) * n_all;
    }
    while (l < r) {
      const int m = l + ((r - l) >> 1);
      int c = 0;
      for (int j = lane; j < S; j += 32) c += search(cur[j], send[j], m, true, base_of) - cur[j];
      c = __reduce_add_sync(kFull, c);
      if (static_cast<long long>(c) * B >= want) {
        r = m;
      } else {
        l = m + 1;
      }
    }
    if (lane == 0) s.split[warp] = l;
  }
  __syncthreads();
  const int lo_b = s.split[0], hi_b = max(s.split[0], s.split[1]);
  if (tid == 0) s.total = 0;
  __syncthreads();

  // Each segment's windows that can hold a doc of [lo_b, hi_b): from the
  // last whose base is <= lo_b to the last whose base is < hi_b.
  for (int j = tid; j < S; j += kThreads) {
    const int w0 = cur[j], w1 = send[j];
    const int e = search(w0, w1, hi_b, true, base_of);
    const int c = search(w0, e, lo_b, false, base_of) - 1;
    cur[j] = max(c, w0);
    end[j] = e;
    atomicAdd(&s.total, e - max(c, w0));
  }
  __syncthreads();
  const long long width = hi_b - lo_b;
  long long D = s.total * kWinLanes <= kLanes
                    ? width
                    : max(1LL, width * kTarget / (static_cast<long long>(s.total) * kWinLanes));
  __syncthreads();

  int c_b = 0, nc_b = 0, n_top = 0, np_b = 0;
  u64 thr = ~0ull;  // keys at or past it cannot enter the block's kk
  int a = lo_b;
  while (a < hi_b) {
    int b = static_cast<int>(min(static_cast<long long>(hi_b), a + D));
    // The tile's windows: in each segment, from the last whose base is <=
    // a to the last whose base is < b.  Their lanes in [a, b) are
    // estimated from the bases (a window's lanes spread over the docs up
    // to the next window's base); the width shrinks in proportion until
    // the estimate fits, and a tile that still overflows is cut below.
    int est = 0;
    for (;;) {
      if (tid == 0) {
        s.total = 0;
        s.est = 0;
      }
      __syncthreads();
      for (int j = tid; j < S; j += kThreads) {
        const int c0 = cur[j], e = end[j];
        const int c = max(c0, search(c0, e, a, false, base_of) - 1);
        const int n = search(c, e, b, true, base_of) - c;
        cur[j] = c;
        cnt[j] = n;
        if (n > 0) {
          atomicAdd(&s.total, n);
          atomicAdd(&s.est, kWinLanes * (n - 2) + in_range(c, a, b, send[j], base_of) +
                                (n > 1 ? in_range(c + n - 1, a, b, send[j], base_of)
                                       : kWinLanes));
        }
      }
      __syncthreads();
      est = s.est;
      const int total = s.total;
      __syncthreads();
      if (est <= kLanes - kLanes / 8 || b - a <= 1 || total == 0) break;
      b = a + static_cast<int>(max(1LL, static_cast<long long>(b - a) * kTarget / est));
    }
    const int total = s.total;
    if (total == 0) {
      // Nothing below b: the next tile starts at the next window's base.
      if (tid == 0) s.next_a = hi_b;
      __syncthreads();
      for (int j = tid; j < S; j += kThreads) {
        if (cur[j] < end[j]) atomicMin(&s.next_a, base_of(cur[j]));
      }
      __syncthreads();
      a = max(b, s.next_a);
      __syncthreads();
      continue;
    }
    scan_counts(cnt, pre, S);
    if (tid == 0) {
      s.n_lanes = 0;
      s.overflow = 0;
      s.next_a = hi_b;
    }
    __syncthreads();
    // The first doc past the tile: the next window of each segment, or a
    // lane of a decoded window.
    for (int j = tid; j < S; j += kThreads) {
      const int nx = cur[j] + cnt[j];
      if (nx < end[j]) atomicMin(&s.next_a, base_of(nx));
    }
    for (int t = warp; t < total; t += kWarps) {
      const int j = search(0, S, t, false, [&](int i) { return pre[i + 1]; });
      const int w = cur[j] + (t - pre[j]);
      int d[4];
      float v[4];
      bool live[4];
      src.lanes(qp0 + w, n_docs, d, v, live);
      int beyond = hi_b;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bool keep = live[g] && d[g] >= a && d[g] < b;
        if (live[g] && d[g] >= b) beyond = min(beyond, d[g]);
        const unsigned bal = __ballot_sync(kFull, keep);
        int at = 0;
        if (lane == 0 && bal) at = atomicAdd(&s.n_lanes, __popc(bal));
        at = __shfl_sync(kFull, at, 0) + __popc(bal & ((1u << lane) - 1u));
        if (keep) {
          if (at < kLanes) {
            s.doc[at] = d[g];
            s.sc[at] = v[g];
            s.seg[at] = j;
          } else {
            s.overflow = 1;
          }
        }
      }
      beyond = __reduce_min_sync(kFull, beyond);
      if (lane == 0 && beyond < hi_b) atomicMin(&s.next_a, beyond);
    }
    __syncthreads();
    const bool one_doc = s.overflow && b - a <= 1;
    if (s.overflow && !one_doc) {
      // More lanes than the tile holds: cut it again (nothing was kept).
      D = max(1, (b - a) / 2);  // the estimate missed: halve
      __syncthreads();
      continue;
    }
    const int n_dec = s.n_lanes;  // the tile's lanes, kept or not
    int n = n_dec;
    const int reach = args.seg_steps >= 30 ? (1 << 30) : (1 << args.seg_steps);
    if (one_doc) {
      // Doc a in more segments than a tile has lanes: its run in chunks of
      // kLanes segments from the last, each chunk's lanes of a decoded
      // again into a slot a segment (doc[] flags it, sc[] holds it), thread
      // 0 pushing them on the scan's stack by descending segment.  The
      // tile is then the run's owner lane alone.
      float val[kMaxSegSteps + 2];
      int level[kMaxSegSteps + 2];
      int top = 0, m = 0;
      for (int j1 = S; j1 > 0; j1 -= kLanes) {
        const int j0 = max(0, j1 - kLanes);
        for (int i = tid; i < j1 - j0; i += kThreads) s.doc[i] = 0;
        __syncthreads();
        for (int t = pre[j0] + warp; t < pre[j1]; t += kWarps) {
          const int j = search(j0, j1, t, false, [&](int i) { return pre[i + 1]; });
          int d[4];
          float v[4];
          bool live[4];
          src.lanes(qp0 + cur[j] + (t - pre[j]), n_docs, d, v, live);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (live[g] && d[g] == a) {
              s.doc[j - j0] = 1;
              s.sc[j - j0] = v[g];
            }
          }
        }
        __syncthreads();
        if (tid == 0) {
          for (int j = j1 - 1; j >= j0 && m < reach; --j) {
            if (!s.doc[j - j0]) continue;
            float x = s.sc[j - j0];
            int lv = 0;
            while (top > 0 && level[top - 1] == lv) {
              x = __fadd_rn(val[--top], x);
              ++lv;
            }
            val[top] = x;
            level[top] = lv;
            ++top;
            ++m;
          }
          s.more = m < reach;
        }
        __syncthreads();
        if (!s.more) break;
      }
      if (tid == 0) {
        float sum = val[--top];
        while (top > 0) sum = __fadd_rn(val[--top], sum);
        s.doc[0] = a;
        s.sc[0] = sum;
        s.seg[0] = kOwner;
        s.nxt[0] = static_cast<int16_t>(slot_of(a));  // a free slot: nothing was linked
        s.c_tile = sum > 0.0f;
        s.c_pass = sum > 0.0f && pack_key(sum, a) < thr;
        s.count = n_top;
      }
      __syncthreads();
      n = 1;
    } else {
      // Each lane joins its doc's list; the lane that found it empty owns
      // the run.
      for (int i = tid; i < n; i += kThreads) {
        const int dd = s.doc[i];
        unsigned h = slot_of(dd);
        for (;;) {
          const int k0 = atomicCAS(&s.key[h], -1, dd);
          if (k0 == -1 || k0 == dd) break;
          h = (h + 1) & (kSlots - 1);
        }
        s.nxt[i] = static_cast<int16_t>(atomicExch(&s.head[h], i));
      }
      if (tid == 0) {
        s.c_tile = 0;
        s.c_pass = 0;
        s.count = n_top;  // where the tile's passing keys append
      }
      __syncthreads();
      int mine_c = 0, mine_p = 0;
      for (int i = tid; i < n; i += kThreads) {
        if (s.nxt[i] != -1) continue;
        const int dd = s.doc[i];
        unsigned h = slot_of(dd);
        while (s.key[h] != dd) h = (h + 1) & (kSlots - 1);
        const int first = s.head[h];
        float sum;
        if (first == i) {
          sum = s.sc[i];  // a run of one lane
        } else {
          int len = 0;
          for (int l = first; l != -1; l = s.nxt[l]) ++len;
          const int m_end = min(len, reach);
          float val[kMaxSegSteps + 2];
          int level[kMaxSegSteps + 2];
          int top = 0;
          int prev = 0x7FFFFFFF;
          for (int m = 0; m < m_end; ++m) {
            // x_m: the lane of the m-th last segment.
            int best = -1, bseg = -1;
            for (int l = first; l != -1; l = s.nxt[l]) {
              const int sg = s.seg[l];
              if (sg < prev && sg > bseg) {
                bseg = sg;
                best = l;
              }
            }
            prev = bseg;
            float x = s.sc[best];
            int lv = 0;
            while (top > 0 && level[top - 1] == lv) {
              x = __fadd_rn(val[--top], x);
              ++lv;
            }
            val[top] = x;
            level[top] = lv;
            ++top;
          }
          sum = val[--top];
          while (top > 0) sum = __fadd_rn(val[--top], sum);
        }
        // The owner's own entries are read by its walk alone.
        s.sc[i] = sum;
        s.seg[i] = kOwner;
        s.nxt[i] = static_cast<int16_t>(h);
        mine_c += sum > 0.0f;
        mine_p += sum > 0.0f && pack_key(sum, dd) < thr;
      }
      mine_c = __reduce_add_sync(kFull, mine_c);
      mine_p = __reduce_add_sync(kFull, mine_p);
      if (lane == 0 && mine_c) atomicAdd(&s.c_tile, mine_c);
      if (lane == 0 && mine_p) atomicAdd(&s.c_pass, mine_p);
      __syncthreads();
    }
    auto cand_key = [&](int i, u64* key) {
      if (s.seg[i] != kOwner || !(s.sc[i] > 0.0f)) return false;
      *key = pack_key(s.sc[i], s.doc[i]);
      return *key < thr;
    };
    const int c_tile = s.c_tile;
    c_b += c_tile;
    const int nc_tile = n_dec - c_tile;
    nc_b += nc_tile;

    // The block's candidates: its buffer takes the tile's keys under the
    // threshold; where they would overflow it, the kk best of both stay
    // (ranked by counting when few, else a radix select) and the threshold
    // drops to the kk-th.
    const int n_pass = s.c_pass;
    if (n_pass > 0) {
      if (n_top + n_pass <= lay.buf_room) {
        append_if(s, n, cand_key, [&](unsigned at, u64 key) { tb[at] = key; });
        n_top += n_pass;
      } else {
        auto get = [&](int i, u64* key) {
          if (i < n_top) {
            *key = tb[i];
            return true;
          }
          return cand_key(i - n_top, key);
        };
        if (n_top + n_pass <= kCountSort) {
          if (tid == 0) s.count = 0;
          __syncthreads();
          append_if(s, n_top + n, get, [&](unsigned at, u64 key) { s.ubuf[at] = key; });
          const int n_u = n_top + n_pass;
          for (int i = tid; i < n_u; i += kThreads) {
            const u64 key = s.ubuf[i];
            int r = 0;
            for (int x = 0; x < n_u; ++x) r += s.ubuf[x] < key;
            if (r < kk) tb[r] = key;
            if (r == kk - 1) s.kth = key;
          }
          __syncthreads();
          thr = s.kth;
        } else {
          select_into(s, n_top + n, static_cast<unsigned>(kk), get,
                      [&](unsigned at, u64 key) { sel[at] = key; });
          for (int i = tid; i < kk; i += kThreads) tb[i] = sel[i];
          __syncthreads();
          thr = block_max(s, kk, [&](int i) { return tb[i]; });
        }
        n_top = kk;
      }
    }

    // The pad docs: the lowest of the non-candidate lanes, as many as the
    // row can need of this block (kk less its candidates).
    const int cap = kk - c_b - np_b;
    if (cap > 0 && nc_tile > 0) {
      auto pad_key = [&](int i, u64* key) {
        if (s.seg[i] == kOwner && s.sc[i] > 0.0f) return false;
        *key = static_cast<u64>(static_cast<uint32_t>(s.doc[i]));
        return true;
      };
      auto put_pad = [&](unsigned at, u64 key) { gpad[np_b + at] = static_cast<int>(key); };
      if (one_doc) {
        // Every lane of a one-doc tile is a's.
        const int m = min(cap, nc_tile);
        for (int i = tid; i < m; i += kThreads) gpad[np_b + i] = a;
        np_b += m;
      } else if (nc_tile <= cap) {
        if (tid == 0) s.count = 0;
        __syncthreads();
        append_if(s, n, pad_key, put_pad);
        np_b += nc_tile;
      } else {
        select_into(s, n, static_cast<unsigned>(cap), pad_key, put_pad);
        np_b += cap;
      }
    }

    // Free the tile's slots; the next tile starts at the first doc left.
    for (int i = tid; i < n; i += kThreads) {
      if (s.seg[i] == kOwner) {
        s.key[s.nxt[i]] = -1;
        s.head[s.nxt[i]] = -1;
      }
    }
    D = max(1LL, static_cast<long long>(b - a) * kTarget / max(est, kTarget / 8));
    a = max(b, s.next_a);
    __syncthreads();
  }

  // Hand the block's counts and kk best keys to the row's merge.
  if (n_top > kk) {
    select_into(s, n_top, static_cast<unsigned>(kk),
                [&](int i, u64* key) {
                  *key = tb[i];
                  return true;
                },
                [&](unsigned at, u64 key) { sel[at] = key; });
    for (int i = tid; i < kk; i += kThreads) tb[i] = sel[i];
    n_top = kk;
  }
  if (tb != gtop) {
    for (int i = tid; i < n_top; i += kThreads) gtop[i] = tb[i];
  }
  if (tid == 0) {
    meta[kCand] = c_b;
    meta[kNonCand] = nc_b;
    meta[kTop] = n_top;
    meta[kPad] = np_b;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = reinterpret_cast<int*>(scr + lay.counter) + q;
    s.last = atomicAdd(counter, 1) == B - 1;
  }
  __syncthreads();
  if (!s.last) return;
  __threadfence();

  // The row's merge, by the last of its blocks.
  const int* rmeta = reinterpret_cast<const int*>(scr + lay.meta) + first_block * kMetaInts;
  const u64* rtop = reinterpret_cast<const u64*>(scr + lay.tops) + first_block * lay.top_room;
  const int* rpad = reinterpret_cast<const int*>(scr + lay.pads) + first_block * kk;
  u64* buf = lay.row_room <= kSmemSort
                 ? reinterpret_cast<u64*>(s.key)
                 : reinterpret_cast<u64*>(scr + lay.rowbuf) + static_cast<long long>(q) * lay.row_room;
  float* os = args.out_s + static_cast<long long>(q) * args.k;
  int32_t* oi = args.out_i + static_cast<long long>(q) * args.k;
  for (int i = kk + tid; i < args.k; i += kThreads) {
    os[i] = -CUDART_INF_F;
    oi[i] = 0;
  }
  long long c_row = 0;
  for (int x = 0; x < B; ++x) c_row += __ldcg(rmeta + x * kMetaInts + kCand);
  auto top_key = [&](int i, u64* key) {
    const int x = i / kk, j = i - x * kk;
    if (j >= __ldcg(rmeta + x * kMetaInts + kTop)) return false;
    *key = __ldcg(rtop + static_cast<long long>(x) * lay.top_room + j);
    return true;
  };
  const int n_all = B * kk;
  if (tid == 0) s.count = 0;
  __syncthreads();
  if (c_row >= kk) {
    // The kk best of the blocks' keys.
    int n_keys = 0;
    for (int x = 0; x < B; ++x) n_keys += __ldcg(rmeta + x * kMetaInts + kTop);
    if (n_keys <= kCountSort) {
      append_if(s, n_all, top_key, [&](unsigned at, u64 key) { buf[at] = key; });
      sort_and_write(buf, n_keys, kk, os, oi);
    } else {
      select_into(s, n_all, static_cast<unsigned>(kk), top_key,
                  [&](unsigned at, u64 key) { buf[at] = key; });
      sort_and_write(buf, kk, kk, os, oi);
    }
    return;
  }
  // Fewer candidates than kk: all of them, sorted, then the pads.
  const int c = static_cast<int>(c_row);
  append_if(s, n_all, top_key, [&](unsigned at, u64 key) { buf[at] = key; });
  if (c > 0) sort_and_write(buf, c, c, os, oi);
  // The first parts' pad docs, in part order, until the row needs no more:
  // a part whose non-candidates are all needed kept all of them, and the
  // last part the lowest of its own.
  const int need = kk - c;
  int left = need, n_pad = 0, taken = 0;
  if (tid == 0) s.count = 0;
  __syncthreads();
  for (int x = 0; x < B && left > 0; ++x) {
    const int np = __ldcg(rmeta + x * kMetaInts + kPad);
    const int nc = __ldcg(rmeta + x * kMetaInts + kNonCand);
    for (int i = tid; i < np; i += kThreads) {
      buf[n_pad + i] = (static_cast<u64>(kInfBits) << 32) |
                       static_cast<uint32_t>(__ldcg(rpad + static_cast<long long>(x) * kk + i));
    }
    n_pad += np;
    taken += min(nc, left);
    left -= min(nc, left);
  }
  __syncthreads();
  if (taken > 0) sort_and_write(buf, n_pad, taken, os + c, oi + c);
  // The dead lanes' pads.
  for (int i = c + taken + tid; i < kk; i += kThreads) {
    os[i] = -CUDART_INF_F;
    oi[i] = n_docs;
  }
}

// Checks the arguments, zeroes the rows' counters and makes the launch:
// n_blocks blocks (each row's parts, as the plan lists them) of kThreads,
// sizeof(Shared) bytes of shared memory each.
template <typename Src>
int launch(const Src& src, const Args& args, cudaStream_t stream) {
  if (args.n_q < 0 || args.n_q >= (1 << 19) || args.P <= 0 || args.S < 0 ||
      args.n_blocks < args.n_q || args.plan == nullptr || args.n_docs < 0 || args.k < 1 ||
      args.kk < 1 ||
      args.kk > args.k || args.kk > static_cast<long long>(args.P) * kWinLanes ||
      args.kk > (1 << 28) || args.seg_steps < 0 || args.seg_steps > kMaxSegSteps ||
      args.scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args.n_q == 0) return 0;
  const long long blocks = args.n_blocks;
  const Layout lay(args.n_q, args.n_blocks, args.S, args.kk);
  cudaError_t err = cudaMemsetAsync(args.scratch + lay.counter, 0, 4LL * args.n_q, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_dynamic_smem(sparse_merge_kernel<Src>, static_cast<long long>(sizeof(Shared)));
  if (err != cudaSuccess) return static_cast<int>(err);
  // All of the SM's unified memory as shared memory: two blocks an SM.
  err = cudaFuncSetAttribute(sparse_merge_kernel<Src>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_merge_kernel<Src><<<static_cast<unsigned int>(blocks), kThreads, sizeof(Shared),
                             stream>>>(src, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace merge
}  // namespace bm25
