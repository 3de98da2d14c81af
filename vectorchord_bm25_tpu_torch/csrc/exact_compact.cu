// Gather and scatter of the exact engine's compact form (sm_90a).
//
// Replaces the gather and the scatter-add of the XLA-lowered reference
// kernel vectorchord_bm25_tpu/search/exact.py::_score_and_topk_compact
// (:95-145), which reads the range index's 5 B/posting streams (3 B with
// bf16 impacts).  One launch takes the whole [n_q, G] group matrix.  For
// each group g of row q whose term ordinal o lies in [0, n_ord), in
// ascending o, and each lane l < min(tr_start[g + 1] - tr_start[g], rs):
//
//     p   = tr_start[g] + l
//     doc = min(tr_range[g], n_docs / rs + 1) * rs + post_local[p]
//     acc[q * stride + doc] += float(post_impact[p])
//
// The clamp comes before the multiply: the pad group's range is INT_MAX
// (its length is 0, so it adds nothing either way).  Lanes past a group's
// length add +0.0 to the pad doc in the reference; they are skipped here.
// The live mask and the filter are multiplied in after the sum by the
// caller, as the reference does.
//
// What the kernel relies on.  The layout of a row, as the planning writes
// it (search/exact.py::_assemble_compact, parallel/shard.py::
// _prepare_compact; pinned by tests/test_torch_exact.py and
// tests/test_torch_sharded.py):
//   (L1) the groups whose ordinal lies in [0, n_ord) come first, in
//        non-decreasing ordinal order; everything after them is a pad
//        (ordinal -1 in the planning; any ordinal outside [0, n_ord));
//   (L2) inside one ordinal the clamped ranges strictly rise (a term's
//        groups are numbered in range order, index/ranges.py);
// and the range index's own invariant:
//   (I)  a group's locals are distinct and below rs (its postings are
//        distinct docs of its range).
// Every block checks L1 and L2 on its whole row before it adds anything.
// A row that breaks them is served by one thread of each block in the
// reference's order (ordinal by ordinal, group by group, lane by lane):
// slow, and exact.
//
// Design.  The first version launched once per term ordinal over the whole
// matrix with one warp a group: at [256, 2048] and T = 4, 4 x 131,072
// blocks, three warps in four leaving at once for another ordinal or a
// pad, and a matching warp using about 1.6 of its 32 lanes.  Now a block
// owns one query row's slice [r_lo, r_hi) of the clamped-range axis, and
// by (I) the docs [r_lo * rs, r_hi * rs) with it: no other block touches
// them, so the block walks the ordinals in ascending order with a block
// barrier between them and a plain read-add-write is exact, with no
// atomics.  A row gets as many slices as make about 1,056 blocks (eight of
// 256 threads on each of 132 SMs), each at least 8 ranges wide, so one
// query spreads over up to a hundred and more blocks.  A block:
//   - reads its row in tiles of 2,048 entries, eight consecutive ones a
//     thread: ordinal, group id and the group's clamped range (gathered
//     from tr_range), and checks L1 and L2 (a tile boundary included);
//   - keeps the groups of its slice: their starts and lengths
//     (tr_start), then one block scan of (groups, lanes) compacts them in
//     row order, which is ordinal order, into shared memory with the
//     first lane of each;
//   - maps threads to postings, not to groups: lane j of the tile belongs
//     to the group a binary search of the lane prefix finds, and a thread
//     loads the locals and impacts of four lanes (1,024 a pass) before any
//     add;
//   - adds ordinal by ordinal: a pass walks the distinct ordinals its
//     lanes hold, in ascending order, a barrier after each.
// A group of another slice costs its row entry and one range gather; a
// pad costs its ordinal.  Its time goes to the scattered read-add-writes
// (about two million at phase (p)'s [256, 2048], 13 times the bound).
// Summing each slice in shared memory and writing whole 32-B sectors,
// which reads the accumulator nowhere, ran slower (more passes over the
// row, fewer blocks an SM), and eight lanes a thread no faster (PERF.md,
// section 6).
//
// Exactness.  Inside one ordinal a row's docs are distinct (one term,
// distinct ranges by L2, distinct locals by I), so the adds of one
// ordinal never meet; across ordinals a doc's adds land in ascending
// ordinal order, the reference's group order.  `__fadd_rn` is the add of
// the reference's f32 scatter (a global atomicAdd would flush
// subnormals): kernel, plain version and reference agree bit for bit.
//
// Bound.  5 B a lane read (3 B with bf16), 8 B a row entry, 12 B a group
// of the row (range, two starts), and a 4-B random read-modify-write into
// the [q, N+1] accumulator: bound by the latency and sector traffic of
// the scattered updates, far below the accumulator's own zero-fill, which
// writes all of it.

#include <climits>

#include "impact.cuh"

namespace {

constexpr int kMaxRangeSize = 256;  // range-local ids are one byte
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;                    // row entries a thread a tile
constexpr int kTile = kThreads * kPerThread;     // 2,048 entries
constexpr int kLanesPerThread = 4;
constexpr int kPass = kThreads * kLanesPerThread;  // lanes loaded before their adds
constexpr int kTargetBlocks = 8 * 132;
constexpr int kMinSliceRanges = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPadOrd = INT_MAX;  // a pad's ordering key
constexpr int kRowStart = -1;     // the key before a row's first entry

template <typename Impact>
struct Args {
  const Impact* __restrict__ post_impact;  // [P]
  const uint8_t* __restrict__ post_local;  // [P]
  const int32_t* __restrict__ tr_range;    // [M+1]
  const int32_t* __restrict__ tr_start;    // [M+2]
  const int32_t* __restrict__ grp_ids;     // [n_q, G]
  const int32_t* __restrict__ grp_ord;     // [n_q, G] term ordinal, -1 = pad
  float* acc;                              // [n_q, stride]
  int64_t stride;
  int g_width, n_ord, n_docs, rs, n_slots, n_postings, n_slices, slice_ranges;
};

// A thread's eight row entries of a tile.
struct Tile {
  int ord[kPerThread];  // kPadOrd: a pad, or past the row
  int grp[kPerThread];
  int rng[kPerThread];  // clamped range; -1: a group the kernel skips
};

// Entry `cur` may follow `prev` in a row (L1, L2).
__device__ __forceinline__ bool in_order(int2 prev, int2 cur) {
  if (cur.x == kPadOrd) return true;
  if (prev.x == kPadOrd) return false;
  return prev.x < cur.x || (prev.x == cur.x && prev.y < cur.y);
}

template <typename Impact>
__global__ void __launch_bounds__(kThreads) exact_compact_kernel(const Args<Impact> a) {
  __shared__ int s_ord[kTile];
  __shared__ int s_doc0[kTile];
  __shared__ int s_start[kTile];
  __shared__ int s_pre[kTile + 1];  // first lane of each kept group; the total
  __shared__ int2 s_last[kThreads];
  __shared__ int s_scan[kWarps][2];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int q = blockIdx.x / a.n_slices;
  const int r_lo = (blockIdx.x - q * a.n_slices) * a.slice_ranges;
  const int r_hi = r_lo + a.slice_ranges;
  const int cap = a.n_docs / a.rs + 1;
  const int32_t* ords = a.grp_ord + static_cast<int64_t>(q) * a.g_width;
  const int32_t* ids = a.grp_ids + static_cast<int64_t>(q) * a.g_width;
  float* row = a.acc + static_cast<int64_t>(q) * a.stride;

  auto load_tile = [&](int tile0, Tile& tl) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tile0 + t * kPerThread + k;
      tl.ord[k] = kPadOrd;
      tl.grp[k] = -1;
      tl.rng[k] = -1;
      if (i < a.g_width) {
        const int o = ords[i];
        if (o >= 0 && o < a.n_ord) {
          tl.ord[k] = o;
          tl.grp[k] = ids[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int g = tl.grp[k];
      if (tl.ord[k] != kPadOrd && g >= 0 && g < a.n_slots) {
        const int r = a.tr_range[g];
        tl.rng[k] = r < 0 ? -1 : min(r, cap);
      }
    }
  };

  // Whether the tile keeps L1 and L2, its first entry against the last
  // one before it (`carry`, updated); the same answer in every thread.
  auto tile_breaks = [&](const Tile& tl, int2& carry) {
    s_last[t] = make_int2(tl.ord[kPerThread - 1], tl.rng[kPerThread - 1]);
    __syncthreads();
    int2 prev = t ? s_last[t - 1] : carry;
    carry = s_last[kThreads - 1];
    bool broken = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int2 cur = make_int2(tl.ord[k], tl.rng[k]);
      broken |= !in_order(prev, cur);
      prev = cur;
    }
    return __syncthreads_or(broken) != 0;
  };

  // Exclusive block scan of (x, y); (tx, ty) the totals.
  auto block_scan = [&](int x, int y, int& ex, int& ey, int& tx, int& ty) {
    int ix = x, iy = y;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ux = __shfl_up_sync(kFull, ix, d);
      const int uy = __shfl_up_sync(kFull, iy, d);
      if (lane >= d) {
        ix += ux;
        iy += uy;
      }
    }
    if (lane == 31) {
      s_scan[warp][0] = ix;
      s_scan[warp][1] = iy;
    }
    __syncthreads();
    int ox = 0, oy = 0;
    tx = ty = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int vx = s_scan[w][0], vy = s_scan[w][1];
      if (w < warp) {
        ox += vx;
        oy += vy;
      }
      tx += vx;
      ty += vy;
    }
    ex = ox + ix - x;
    ey = oy + iy - y;
  };

  // The tile's groups in this slice, compacted; then their lanes,
  // ordinal by ordinal.
  auto scatter_tile = [&](const Tile& tl) {
    int st[kPerThread], en[kPerThread], len[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      len[k] = tl.rng[k] >= r_lo && tl.rng[k] < r_hi;
      if (len[k]) {
        st[k] = a.tr_start[tl.grp[k]];
        en[k] = a.tr_start[tl.grp[k] + 1];
      }
    }
    int n_grp = 0, n_lane = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (len[k]) {
        const int n = min(en[k] - st[k], a.rs);
        len[k] = st[k] < 0 || n <= 0 || st[k] > a.n_postings - n ? 0 : n;
      }
      n_grp += len[k] > 0;
      n_lane += len[k];
    }
    int c0, l0, nc, nl;
    block_scan(n_grp, n_lane, c0, l0, nc, nl);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (len[k] > 0) {
        s_ord[c0] = tl.ord[k];
        s_doc0[c0] = tl.rng[k] * a.rs;
        s_start[c0] = st[k];
        s_pre[c0] = l0;
        ++c0;
        l0 += len[k];
      }
    }
    if (t == 0) s_pre[nc] = nl;
    __syncthreads();

    // The kept group holding lane j: the last c with s_pre[c] <= j.
    auto group_of = [&](int j) {
      int lo = 0, hi = nc;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_pre[mid] <= j) lo = mid; else hi = mid;
      }
      return lo;
    };
    for (int pass0 = 0; pass0 < nl; pass0 += kPass) {
      const int pass_end = min(pass0 + kPass, nl);
      int o_of[kLanesPerThread], doc[kLanesPerThread];
      float v[kLanesPerThread];
#pragma unroll
      for (int u = 0; u < kLanesPerThread; ++u) {
        const int j = pass0 + u * kThreads + t;
        o_of[u] = -1;
        if (j < pass_end) {
          const int c = group_of(j);
          const int64_t p = static_cast<int64_t>(s_start[c]) + (j - s_pre[c]);
          const int local = a.post_local[p];
          v[u] = bm25::widen(a.post_impact[p]);
          doc[u] = s_doc0[c] + local;
          if (doc[u] <= a.n_docs) o_of[u] = s_ord[c];
        }
      }
      // The distinct ordinals of this pass, ascending.
      int c = group_of(pass0);
      while (true) {
        const int o = s_ord[c];
        float old[kLanesPerThread];
#pragma unroll
        for (int u = 0; u < kLanesPerThread; ++u) {
          if (o_of[u] == o) old[u] = row[doc[u]];
        }
#pragma unroll
        for (int u = 0; u < kLanesPerThread; ++u) {
          if (o_of[u] == o) row[doc[u]] = __fadd_rn(old[u], v[u]);
        }
        __syncthreads();  // ordinal o's adds land before a later one reads
        int lo = c + 1, hi = nc;  // the first kept group past ordinal o
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_ord[mid] <= o) lo = mid + 1; else hi = mid;
        }
        c = lo;
        if (c >= nc || s_pre[c] >= pass_end) break;
      }
    }
  };

  const int n_tiles = (a.g_width + kTile - 1) / kTile;
  bool broken = false;
  int2 carry = make_int2(kRowStart, 0);
  Tile tl;
  if (n_tiles > 1) {  // check the whole row before the first add
    for (int tile = 0; tile < n_tiles && !broken; ++tile) {
      load_tile(tile * kTile, tl);
      broken = tile_breaks(tl, carry);
    }
  }
  carry = make_int2(kRowStart, 0);
  for (int tile = 0; tile < n_tiles && !broken; ++tile) {
    load_tile(tile * kTile, tl);
    if (n_tiles == 1) broken = tile_breaks(tl, carry);
    if (!broken) scatter_tile(tl);
  }
  if (!broken || t != 0) return;

  // A row off the planning's layout: the reference's order, one thread.
  for (int o = 0; o < a.n_ord; ++o) {
    for (int i = 0; i < a.g_width; ++i) {
      const int g = ids[i];
      if (ords[i] != o || g < 0 || g >= a.n_slots || a.tr_range[g] < 0) continue;
      const int r = min(a.tr_range[g], cap);
      if (r < r_lo || r >= r_hi) continue;
      const int s = a.tr_start[g];
      const int n = min(a.tr_start[g + 1] - s, a.rs);
      if (s < 0 || n <= 0 || s > a.n_postings - n) continue;
      for (int l = 0; l < n; ++l) {
        const int d = r * a.rs + a.post_local[s + l];
        if (d <= a.n_docs) row[d] = __fadd_rn(row[d], bm25::widen(a.post_impact[s + l]));
      }
    }
  }
}

template <typename Impact>
cudaError_t launch(Args<Impact> a, int n_q, cudaStream_t s) {
  // Slices of the clamped-range axis [0, cap]: enough for the card, at
  // least kMinSliceRanges ranges each.
  const long long values = static_cast<long long>(a.n_docs / a.rs) + 2;
  const long long most = (values + kMinSliceRanges - 1) / kMinSliceRanges;
  long long slices = (kTargetBlocks + n_q - 1) / n_q;
  slices = slices < most ? slices : most;
  const long long width = (values + slices - 1) / slices;
  slices = (values + width - 1) / width;
  const long long blocks = static_cast<long long>(n_q) * slices;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  a.n_slices = static_cast<int>(slices);
  a.slice_ranges = static_cast<int>(width);
  exact_compact_kernel<Impact><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch for the whole [n_q, G] matrix and its n_ord ordinals.
// impact_bf16 != 0: post_impact holds bf16, else f32.  n_slots: entries of
// tr_range (M + 1, the pad slot included); tr_start has one more.
extern "C" int bm25_exact_compact_accumulate(
    const void* post_impact, const void* post_local, const void* tr_range,
    const void* tr_start, const void* grp_ids, const void* grp_ord, void* acc,
    int n_q, int g_width, int n_ord, long long stride, int n_docs, int rs,
    int n_slots, int n_postings, int impact_bf16, void* stream) {
  if (n_q < 0 || g_width < 1 || n_ord < 0 || rs < 1 || rs > kMaxRangeSize ||
      n_docs < 0 || stride < n_docs + 1LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_q == 0 || n_ord == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* loc = static_cast<const uint8_t*>(post_local);
  const int32_t* rg = static_cast<const int32_t*>(tr_range);
  const int32_t* st = static_cast<const int32_t*>(tr_start);
  const int32_t* gi = static_cast<const int32_t*>(grp_ids);
  const int32_t* go = static_cast<const int32_t*>(grp_ord);
  float* out = static_cast<float*>(acc);
  const int64_t sd = static_cast<int64_t>(stride);
  const cudaError_t err =
      impact_bf16
          ? launch(Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(post_impact),
                                       loc, rg, st, gi, go, out, sd, g_width, n_ord,
                                       n_docs, rs, n_slots, n_postings, 0, 0},
                   n_q, s)
          : launch(Args<float>{static_cast<const float*>(post_impact), loc, rg, st,
                               gi, go, out, sd, g_width, n_ord, n_docs, rs, n_slots,
                               n_postings, 0, 0},
                   n_q, s);
  return static_cast<int>(err);
}
