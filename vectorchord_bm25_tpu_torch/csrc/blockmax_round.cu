// The Block-Max round outside the scoring kernel (sm_90a): range bounds,
// the round's top-C select with locate, and the mask-and-merge.
//
// Replaces the XLA-lowered device code of the reference's
// vectorchord_bm25_tpu/search/blockmax.py::_blockmax_kernel around its
// Pallas call: phase 1 (:82-107), the round's top_k, mask, cand_ok and
// locate (:114-150) and its live/filter mask, score > 0 rule and
// lexicographic merge (:194-215).  The reference runs the whole round as one
// device program; with these three kernels and P1 (score_kernel.cu) or P1-tf
// (tf_range_scores.cu) between select and merge, so does the port.
//
// All three run one block a query: each is a per-query selection with
// data-dependent control flow, and a query's state (its [R] bound row, its
// C candidates, its C*RS + k merge keys) fits one block's shared memory at
// the sizes the engine serves.  Where it does not, the same code works on
// device memory instead (the bound row in place, the merge keys in a scratch
// row the wrapper allocates): no size the reference serves is refused.
//
// range_bounds.  ub_work[q, r] = (sum_t tr_ub[g(t, r)]) * scale.  One block
// a query, sized to its groups rather than to R (128 threads up to 2,048
// ranges: a first round's query at R = 1,024 has a few hundred groups), so
// that more queries are in flight.  Four terms at a time: their ids and
// CSR spans of (range, ub) groups are read in one step, then every thread
// issues the (tr_range, tr_ub) loads of its groups in all four terms
// (two a term, 256 groups a term at 128 threads) before its first add; a
// longer term's rest follows in chunks before the next term's adds.  A
// term has at most one group a range, so no two threads of one term meet
// and no atomic is needed, and the barrier between terms keeps each
// range's sum in ascending t: the order of the reference's flat scatter.
// Then one __fmul_rn by the f32 scale, written with 16-B stores.  The row
// lives in shared memory, or past kMaxDynamicSmem in device memory.  Bound
// by bytes: the [Q, R] row written once dominates; what keeps a block from
// it is its chain of dependent loads (term ids, spans, groups), which the
// four terms share and enough blocks in flight hide.
//
// round_select.  thresh = max(topk_s[q, k-1], 0).  The C highest bounds of
// the row, ties to the lower range (lax.top_k's rule), by a radix select
// rather than C arg-max rounds.  Bounds are >= +0 or -inf, so u = bits ^
// 0x80000000 orders them as unsigned 32-bit keys.
//   1. Load: the row is read once from device memory into shared memory
//      (up to 57,344 ranges; a longer row stays in device memory and is read
//      there), with its maximum and the histogram of u's top byte.  A query
//      whose maximum is not above its threshold is inactive: it writes
//      cand_r = 0 and length = 0 everywhere, leaves its row alone (a
//      threshold only rises, so the row is never read again with another
//      outcome) and returns.  An active query raises the one device flag the
//      host loop reads.
//   2. Select: four passes of 8 bits find u*, the C-th largest key, and
//      need, how many keys equal to u* are taken (C minus the keys above
//      u*).  A pass counts the keys that match the digits found so far into
//      a 256-bin shared histogram (lanes with one digit add once, by
//      __match_any_sync); one warp scans the bins from the top to find the
//      next digit.
//   3. Collect: each warp owns a contiguous run of ranges and walks it in
//      order, 32 at a time, placing keys by ballot and popcount after a scan
//      of the warps' counts.  Every key above u* goes to a buffer; the first
//      `need` keys equal to u* in range order are the last candidates,
//      written straight to cand_r[above ..]: that is lax.top_k's tie rule,
//      and it refills a row short of live bounds with its lowest -inf
//      ranges.
//   4. Order: the keys above u* become (u << 32) | ~range, unique, and each
//      one's place in cand_r is the number of those keys larger than it:
//      descending bound, the lower range first.  That costs above^2 / nt
//      compares a thread and one barrier: quadratic in C, where steps 1-3
//      read 5R / nt keys a thread from shared memory.  It is the smaller
//      part while C^2 < 5R, as at the three shapes chip_smoke.py times
//      (C = 32, 128, 256 at R = 1,024, 8,192, 16,384).  A chunk in the
//      thousands makes it the kernel's largest cost (C = R = 30,000 at 512
//      threads: about 1.7M compares a thread).  Candidates come out in
//      descending bound order, so cand_ok = bound > thresh holds for a
//      prefix of n_ok candidates.
//   5. Finish: the taken ranges become -inf in the row, then locate: for
//      each (t, c) a binary search of the term's ascending range list
//      tr_range[base, base + count) gives the group's posting span, or
//      (0, 0) where the term has no group in the range or the candidate is
//      not ok.
// Twelve barriers a query whatever C and R: one to clear the histograms,
// one after the load, two a radix pass (the first pass's counting is the
// load's), two in the collect, one after the order.  Each range's key is
// read once from device memory and five times from shared memory.  Bound by
// bytes where C^2 < 5R (step 4): the row read once, the C taken ranges and
// the spans written.
// Rows of up to 1,024 ranges take 128 threads a block, so that 4,096 short
// rows fill the card 16 blocks an SM; longer rows take 256 or 512.

// round_merge.  s = (acc * live[d]) * filter[d] with d = min(doc, N), two
// __fmul_rn in the reference's order; a candidate is kept where s > 0 and
// doc < N.  Kept candidates and the running top-k become the packed keys of
// ops/topk.py, (0x7F800000 - f32 bits) << 32 | doc, whose ascending order is
// (score desc, doc asc) and which are distinct among live entries, so the k
// smallest are the reference's lax.sort(num_keys=2)[:k], in whatever order
// the candidates are met.
//   Test before the gathers.  A lane whose acc is +-0 or NaN cannot give
//   s > 0 whatever live and filter hold (0 * x is +-0 or NaN, NaN stays
//   NaN), so it skips both gathers.  A pass of the row with no other lane
//   (a block-wide vote) does nothing more.
//   A query all of whose lanes are such lanes (every inactive query of a
//   later round, P1-tf's NaN lanes) leaves without reading or writing its
//   top-k: a previous merge left it in its final order, which a merge of
//   nothing keeps.
//   k <= 32: one block a query, the top-k in warp 0's registers (its 32
//   best keys sorted across its lanes).  The block reads the row 4,096
//   slots a pass (four 16-B loads a thread), each thread issuing all the
//   pass's loads (scores, their cand_r entries, then their live and filter
//   entries) before it uses any.  The pass bounds itself first: each
//   thread's least key, each warp's ceil(k / 8) least of those, the largest
//   of these over the block; at least k distinct keys lie at or below it.
//   Each warp puts the keys at or below min(that bound, the running k-th
//   key, warp 0's k-th key after the last pass) into a shared buffer (one
//   shared add a warp a batch of 32); only such a key can reach the top k,
//   and a first round's pass buffers a few dozen keys of its thousand.
//   Warp 0 then takes the buffer 32
//   at a time against its own threshold, which tightens as it goes: when
//   more than kInsertMax keys pass, the batch is sorted by a shuffle
//   bitonic network and merged in (min against the list reversed, then
//   five half-cleaner steps); fewer are inserted one at a time (a ballot
//   gives each one's place).  At the end the list is merged with the
//   running top-k the same way and lanes < k write it back.  One list a
//   query, fed only what can enter it: lists of their own in each warp
//   would each sort their first batches to fill their k before any
//   threshold helps, and one warp taking every key of a first round
//   serialises a thousand of them.  The whole block reads and filters, so
//   a later round's query, whose keys fall short of its threshold, costs
//   its reads alone.  Registers are capped at 64 (four blocks an SM): a
//   round whose queries are nearly all zero is a few waves of blocks that
//   each wait for one load, so blocks in flight set its time; fewer
//   registers than that spill.
//   k > 32: one block a query and a key buffer of S keys (shared memory, or
//   a scratch row where S keys do not fit).  Only a candidate below the running k-th key can
//   enter, so each warp places those by ballot and popcount after one
//   shared atomic add, and the block bitonic-sorts just that many, padded
//   to a power of two.  Candidates go through it in tiles of S - k, the k
//   best staying at its head.
// Bound by bytes: the [Q, C, RS] scores read once (the kernel must read a
// lane to know it is zero), plus the live and filter entries of the lanes
// that scored.

// No fast math: a subnormal bound or score stays what it is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_smem.cuh"

namespace {

typedef unsigned long long u64;

constexpr uint32_t kInfBits = 0x7F800000u;
constexpr uint32_t kNegInfBits = 0xFF800000u;
constexpr int kIntMax = 0x7FFFFFFF;
constexpr u64 kPadKey = (static_cast<u64>(kInfBits) << 32) | 0x7FFFFFFFull;
// Dynamic shared memory a block may ask for (of the SM's 227 KB, leaving
// room for the kernels' small static arrays; ops/blockmax_round.py mirrors
// it).
constexpr long long kMaxDynamicSmem = 224 * 1024;
constexpr int kMergeThreads = 256;

// range_bounds: the terms whose spans are read in one step and whose first
// chunks load together, and each thread's groups of a term in one chunk.
constexpr int kBoundTerms = 4;
constexpr int kBoundPer = 2;

__device__ __forceinline__ void add_bound(float* row, int r, float u, int n_ranges) {
  if (r >= 0 && r < n_ranges) row[r] = __fadd_rn(row[r], u);
}

__global__ void __launch_bounds__(1024) range_bounds_kernel(
    const int32_t* __restrict__ token_tr_start,  // [V+2]
    const int32_t* __restrict__ tr_range,        // [M+1]
    const float* __restrict__ tr_ub,             // [M+1]
    const int32_t* __restrict__ q_tid,           // [Q, T]
    float* ub_work,                              // [Q, R]
    int n_terms, int n_ranges, float scale, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lo[kBoundTerms], s_cnt[kBoundTerms];
  const int64_t q = blockIdx.x;
  const int tt = threadIdx.x, nt = blockDim.x;
  float* out = ub_work + q * n_ranges;
  float* row = use_smem ? reinterpret_cast<float*>(smem_raw) : out;
  const bool vec = (n_ranges & 3) == 0;  // rows 16-B aligned: 16-B stores
  if (vec) {
    for (int r = tt; r < n_ranges / 4; r += nt) {
      reinterpret_cast<float4*>(row)[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int r = tt; r < n_ranges; r += nt) row[r] = 0.0f;
  }
  const int chunk = kBoundPer * nt;  // a term's groups a pass
  for (int t0 = 0; t0 < n_terms; t0 += kBoundTerms) {
    const int n_here = min(kBoundTerms, n_terms - t0);
    if (tt < n_here) {
      const int term = q_tid[q * n_terms + t0 + tt];
      const int a = token_tr_start[term];
      s_lo[tt] = a;
      s_cnt[tt] = token_tr_start[term + 1] - a;
    }
    __syncthreads();  // the spans, and the row zeroed, before any add
    int r[kBoundTerms][kBoundPer];
    float u[kBoundTerms][kBoundPer];
#pragma unroll
    for (int j = 0; j < kBoundTerms; ++j) {
      const int lo = j < n_here ? s_lo[j] : 0;
      const int cnt = j < n_here ? s_cnt[j] : 0;
#pragma unroll
      for (int i = 0; i < kBoundPer; ++i) {
        const int idx = i * nt + tt;
        r[j][i] = -1;
        u[j][i] = 0.0f;
        if (idx < cnt) {
          r[j][i] = tr_range[lo + idx];
          u[j][i] = tr_ub[lo + idx];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBoundTerms; ++j) {
      if (j < n_here) {  // the same in every thread
#pragma unroll
        for (int i = 0; i < kBoundPer; ++i) add_bound(row, r[j][i], u[j][i], n_ranges);
        // The rest of a term longer than a chunk, before the next term.
        const int lo = s_lo[j], cnt = s_cnt[j];
        for (int c0 = chunk; c0 < cnt; c0 += chunk) {
          int rr[kBoundPer];
          float uu[kBoundPer];
#pragma unroll
          for (int i = 0; i < kBoundPer; ++i) {
            const int idx = c0 + i * nt + tt;
            rr[i] = -1;
            uu[i] = 0.0f;
            if (idx < cnt) {
              rr[i] = tr_range[lo + idx];
              uu[i] = tr_ub[lo + idx];
            }
          }
#pragma unroll
          for (int i = 0; i < kBoundPer; ++i) add_bound(row, rr[i], uu[i], n_ranges);
        }
        __syncthreads();  // this term's adds before the next term's
      }
    }
  }
  if (vec) {
    for (int r = tt; r < n_ranges / 4; r += nt) {
      const float4 v = reinterpret_cast<const float4*>(row)[r];
      reinterpret_cast<float4*>(out)[r] = make_float4(
          __fmul_rn(v.x, scale), __fmul_rn(v.y, scale), __fmul_rn(v.z, scale),
          __fmul_rn(v.w, scale));
    }
  } else {
    for (int r = tt; r < n_ranges; r += nt) out[r] = __fmul_rn(row[r], scale);
  }
}

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBins = 256;
constexpr int kBatch = 8;  // row reads a thread issues before using them

// Lanes with `m` set add one to hist[digit]: one shared atomic a distinct
// digit of the warp, and no __match_any_sync where the warp's digits are
// all one (a run of equal bounds).  Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(int* hist, bool m, uint32_t digit, int lane) {
  const unsigned act = __ballot_sync(kFull, m);
  if (act == 0) return;
  const int first = __ffs(act) - 1;
  const uint32_t lead = __shfl_sync(kFull, digit, first);
  if (__all_sync(kFull, !m || digit == lead)) {
    if (lane == first) atomicAdd(&hist[lead], __popc(act));
    return;
  }
  if (m) {
    const unsigned peers = __match_any_sync(act, digit);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
  }
}

// One warp: the digit at which the kk-th largest of the keys counted in
// hist lies.  Lane l holds bins 255 - 8l down to 248 - 8l; an inclusive
// scan over the lanes finds the lane, which walks its own bins, appends the
// digit to *prefix at `shift` and leaves in *kk the rank left within it.
__device__ __forceinline__ void find_digit(const int* hist, int shift, uint32_t* prefix,
                                           int* kk, int lane) {
  const uint32_t pre = *prefix;
  const int want = *kk;
  int h[8];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = hist[kBins - 1 - 8 * lane - j];
    sum += h[j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - sum;
  const unsigned hit = __ballot_sync(kFull, excl < want && want <= incl);
  if (lane == __ffs(hit) - 1) {
    int run = excl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (run + h[j] >= want) {
        *prefix = pre | (static_cast<uint32_t>(kBins - 1 - 8 * lane - j) << shift);
        *kk = want - run;
        break;
      }
      run += h[j];
    }
  }
}

__global__ void round_select_kernel(
    float* ub_work,                              // [Q, R], masked in place
    const float* __restrict__ topk_s,            // [Q, k]
    const int32_t* __restrict__ tr_range,        // [M+1]
    const int32_t* __restrict__ tr_start,        // [M+2]
    const int32_t* __restrict__ token_tr_start,  // [V+2]
    const int32_t* __restrict__ q_tid,           // [Q, T]
    int32_t* cand_r,                             // [Q, C]
    int32_t* __restrict__ start,                 // [Q, T, C]
    int32_t* __restrict__ length,                // [Q, T, C]
    int32_t* __restrict__ flag,                  // [1]
    u64* scratch,                                // [Q, C]
    int n_terms, int n_ranges, int chunk, int k, int use_smem, int keys_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_hist[2][kBins];
  __shared__ uint32_t s_wmax[32];
  __shared__ int s_wcount[32][2];
  __shared__ uint32_t s_prefix;
  __shared__ int s_kk, s_nok;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  uint32_t* grow =
      reinterpret_cast<uint32_t*>(ub_work + static_cast<int64_t>(q) * n_ranges);
  u64* keys = keys_smem ? reinterpret_cast<u64*>(smem_raw)
                        : scratch + static_cast<int64_t>(q) * chunk;
  uint32_t* row = use_smem ? reinterpret_cast<uint32_t*>(
                                 smem_raw + (keys_smem ? 8LL * chunk : 0))
                           : grow;
  int32_t* my_cand = cand_r + static_cast<int64_t>(q) * chunk;
  const int64_t tc = static_cast<int64_t>(n_terms) * chunk;
  int32_t* my_start = start + static_cast<int64_t>(q) * tc;
  int32_t* my_length = length + static_cast<int64_t>(q) * tc;
  const float thresh =
      fmaxf(topk_s[static_cast<int64_t>(q) * k + (k - 1)], 0.0f);
  // Every lane of a warp runs the same number of iterations (ballots).
  const int n_iter = (n_ranges + nt - 1) / nt;

  for (int i = tid; i < 2 * kBins; i += nt) (&s_hist[0][0])[i] = 0;
  if (tid == 0) {
    s_prefix = 0;
    s_kk = chunk;
    s_nok = 0;
  }
  __syncthreads();

  // 1. Load, the maximum, the top byte's histogram.
  uint32_t best = 0;
  for (int it0 = 0; it0 < n_iter; it0 += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = (it0 + j) * nt + tid;
      v[j] = r < n_ranges ? grow[r] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = (it0 + j) * nt + tid;
      const bool in = r < n_ranges;
      const uint32_t u = v[j] ^ 0x80000000u;
      if (in) {
        if (use_smem) row[r] = v[j];
        best = best > u ? best : u;
      }
      hist_add(s_hist[0], in, u >> 24, lane);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const uint32_t o = __shfl_xor_sync(kFull, best, d);
    best = best > o ? best : o;
  }
  if (lane == 0) s_wmax[warp] = best;
  __syncthreads();
  uint32_t top = 0;
  for (int w = 0; w < n_warps; ++w) top = top > s_wmax[w] ? top : s_wmax[w];
  if (!(__uint_as_float(top ^ 0x80000000u) > thresh)) {
    // Inactive query (the same `top` in every thread, so all leave).
    for (int i = tid; i < chunk; i += nt) my_cand[i] = 0;
    for (int64_t i = tid; i < tc; i += nt) {
      my_start[i] = 0;
      my_length[i] = 0;
    }
    return;
  }

  // 2. Select: u*, the C-th largest key, and how many of its ties to take.
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* hist = s_hist[pass & 1];
    if (pass > 0) {
      if (pass < 3) {
        int* next = s_hist[(pass + 1) & 1];
        for (int i = tid; i < kBins; i += nt) next[i] = 0;
      }
      const uint32_t prefix = s_prefix;
      const uint32_t mask = 0xFFFFFFFFu << (shift + 8);
      for (int it0 = 0; it0 < n_iter; it0 += kBatch) {
        uint32_t v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = (it0 + j) * nt + tid;
          v[j] = r < n_ranges ? row[r] ^ 0x80000000u : 0u;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = (it0 + j) * nt + tid;
          hist_add(hist, r < n_ranges && (v[j] & mask) == prefix, (v[j] >> shift) & 0xFFu,
                   lane);
        }
      }
      __syncthreads();
    }
    if (warp == 0) find_digit(hist, shift, &s_prefix, &s_kk, lane);
    __syncthreads();
  }
  const uint32_t ustar = s_prefix;
  const int need = s_kk;
  const int above = chunk - need;

  // 3. Collect, each warp its run of ranges in order.
  const int per_warp = (((n_ranges + n_warps - 1) / n_warps) + 31) & ~31;
  const int lo = min(warp * per_warp, n_ranges);
  const int hi = min(lo + per_warp, n_ranges);
  int n_above = 0, n_tie = 0;
  for (int base = lo; base < hi; base += 32) {
    const int r = base + lane;
    const uint32_t u = r < hi ? row[r] ^ 0x80000000u : 0u;
    n_above += __popc(__ballot_sync(kFull, r < hi && u > ustar));
    n_tie += __popc(__ballot_sync(kFull, r < hi && u == ustar));
  }
  if (lane == 0) {
    s_wcount[warp][0] = n_above;
    s_wcount[warp][1] = n_tie;
  }
  __syncthreads();
  int a_at = 0, t_at = 0;
  for (int w = 0; w < warp; ++w) {
    a_at += s_wcount[w][0];
    t_at += s_wcount[w][1];
  }
  const unsigned lower = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int r = base + lane;
    const uint32_t u = r < hi ? row[r] ^ 0x80000000u : 0u;
    const bool is_above = r < hi && u > ustar;
    const bool is_tie = r < hi && u == ustar;
    const unsigned ba = __ballot_sync(kFull, is_above);
    const unsigned bt = __ballot_sync(kFull, is_tie);
    if (is_above) {
      keys[a_at + __popc(ba & lower)] =
          (static_cast<u64>(u) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(r));
    }
    if (is_tie) {
      const int rank = t_at + __popc(bt & lower);
      if (rank < need) my_cand[above + rank] = r;
    }
    a_at += __popc(ba);
    t_at += __popc(bt);
  }
  __syncthreads();

  // 4. Order the keys above u*: g threads a key, g a power of two <= 32.
  int g = 1;
  while (g < 32 && 2 * g * above <= nt) g <<= 1;
  const int sub = tid & (g - 1);
  for (int e0 = 0; e0 < above; e0 += nt / g) {
    const int e = e0 + tid / g;
    const u64 me = e < above ? keys[e] : 0;
    int larger = 0;
    if (e < above) {
#pragma unroll 4
      for (int j = sub; j < above; j += g) larger += keys[j] > me;
    }
    for (int d = g >> 1; d > 0; d >>= 1) larger += __shfl_xor_sync(kFull, larger, d);
    if (e < above && sub == 0) {
      my_cand[larger] = static_cast<int32_t>(~static_cast<uint32_t>(me & 0xFFFFFFFFull));
      if (__uint_as_float(static_cast<uint32_t>(me >> 32) ^ 0x80000000u) > thresh) {
        atomicAdd(&s_nok, 1);
      }
    }
  }
  __syncthreads();  // my_cand is complete and visible
  const int n_ok =
      __uint_as_float(ustar ^ 0x80000000u) > thresh ? chunk : s_nok;

  // 5. Finish.
  if (tid == 0) *flag = 1;
  for (int c = tid; c < chunk; c += nt) grow[my_cand[c]] = kNegInfBits;
  for (int64_t i = tid; i < tc; i += nt) {
    const int t = static_cast<int>(i / chunk);
    const int c = static_cast<int>(i - static_cast<int64_t>(t) * chunk);
    int st = 0, ln = 0;
    if (c < n_ok) {
      const int term = q_tid[static_cast<int64_t>(q) * n_terms + t];
      const int base = token_tr_start[term];
      const int end = token_tr_start[term + 1];
      const int r = my_cand[c];
      int lo2 = base, hi2 = end;
      while (lo2 < hi2) {
        const int mid = lo2 + ((hi2 - lo2) >> 1);
        if (tr_range[mid] < r) {
          lo2 = mid + 1;
        } else {
          hi2 = mid;
        }
      }
      if (lo2 < end && tr_range[lo2] == r) {
        st = tr_start[lo2];
        ln = tr_start[lo2 + 1] - st;
      }
    }
    my_start[i] = st;
    my_length[i] = ln;
  }
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

// A lane that may score: acc is neither +-0 nor NaN.
__device__ __forceinline__ bool may_score(float a) { return a != 0.0f && a == a; }

// The packed key of lane i of a query's [C * RS] row, or kPadKey where the
// lane is not kept: s = (acc * live[d]) * filter[d], kept where s > 0 and
// doc < N.  Called for lanes that may score only.
__device__ __forceinline__ u64 lane_key(float a, int i, int rs, const int32_t* my_cand,
                                        const float* __restrict__ doc_live,
                                        const float* __restrict__ filter_mask, int n_docs) {
  const int c = i / rs;
  const int doc = my_cand[c] * rs + (i - c * rs);
  const int dc = doc < n_docs ? doc : n_docs;
  const float s = __fmul_rn(__fmul_rn(a, doc_live[dc]), filter_mask[dc]);
  if (!(s > 0.0f) || doc >= n_docs) return kPadKey;
  return (static_cast<u64>(kInfBits - __float_as_uint(s)) << 32) | static_cast<uint32_t>(doc);
}

// The running top-k entry as a packed key: a pad where the score is not > 0.
__device__ __forceinline__ u64 entry_key(float s, int32_t d) {
  return s > 0.0f ? (static_cast<u64>(kInfBits - __float_as_uint(s)) << 32) |
                        static_cast<uint32_t>(d)
                  : kPadKey;
}

__device__ __forceinline__ void store_entry(float* my_s, int32_t* my_d, int i, u64 key) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const bool pad = hi == kInfBits;
  my_s[i] = pad ? __uint_as_float(kNegInfBits) : __uint_as_float(kInfBits - hi);
  my_d[i] = pad ? kIntMax : static_cast<int32_t>(key & 0xFFFFFFFFull);
}

__device__ __forceinline__ u64 min_u64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 max_u64(u64 a, u64 b) { return a < b ? b : a; }

// The warp's 32 keys, one a lane, sorted ascending across the lanes.
__device__ __forceinline__ u64 warp_sort(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 y = __shfl_xor_sync(kFull, x, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      x = low == up ? min_u64(x, y) : max_u64(x, y);
    }
  }
  return x;
}

// The 32 smallest of two ascending warp lists, ascending: the minimum
// against the second list reversed is bitonic, then five half-cleaners.
__device__ __forceinline__ u64 warp_merge(u64 a, u64 b, int lane) {
  u64 x = min_u64(a, __shfl_sync(kFull, b, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 y = __shfl_xor_sync(kFull, x, stride);
    x = (lane & stride) == 0 ? min_u64(x, y) : max_u64(x, y);
  }
  return x;
}

constexpr int kRegK = 32;      // k up to this keeps the top-k in registers
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kLoads = 4;      // 16-B score loads a thread a block pass
constexpr int kPassLanes = kMergeThreads * 4 * kLoads;  // 4,096 slots a block pass
constexpr int kInsertMax = 4;  // passing keys a batch inserts one by one

// A thread's 16 scores of a block pass starting at `base`: slots
// base + 4 * (j * kMergeThreads + tid) + e for load j and element e.  Slots
// past the row read as 0.
__device__ __forceinline__ void load_pass(const float* my_acc, int n_cand, int base, bool vec,
                                          int tid, float (&v)[kLoads][4]) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = base + 4 * (j * kMergeThreads + tid);
    if (vec && i < n_cand) {
      const float4 f = *reinterpret_cast<const float4*>(my_acc + i);
      v[j][0] = f.x;
      v[j][1] = f.y;
      v[j][2] = f.z;
      v[j][3] = f.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = i + e < n_cand ? my_acc[i + e] : 0.0f;
    }
  }
}

// k <= 32: the block filters, warp 0 keeps the top-k in registers.
// kRange4: the range size is a multiple of 4, so the four slots of a 16-B
// load share one candidate range and one doc base (fewer registers).
template <bool kRange4>
__global__ void __launch_bounds__(kMergeThreads, 4) round_merge_reg_kernel(
    const float* __restrict__ acc,          // [Q, C, RS]
    const int32_t* __restrict__ cand_r,     // [Q, C]
    const float* __restrict__ doc_live,     // [N+1]
    const float* __restrict__ filter_mask,  // [N+1]
    float* topk_s,                          // [Q, k], merged in place
    int32_t* topk_d,                        // [Q, k]
    int chunk, int rs, int k, int n_docs, int vec) {
  __shared__ u64 s_buf[kPassLanes];  // a pass's keys below the threshold
  __shared__ u64 s_thr;              // warp 0's threshold after a pass
  __shared__ u64 s_bound;            // the pass's own bound
  __shared__ int s_n;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_cand = chunk * rs;
  const float* my_acc = acc + static_cast<int64_t>(q) * n_cand;
  const int32_t* my_cand = cand_r + static_cast<int64_t>(q) * chunk;
  float* my_s = topk_s + static_cast<int64_t>(q) * k;
  int32_t* my_d = topk_d + static_cast<int64_t>(q) * k;
  const unsigned lower = (1u << lane) - 1u;
  const int per_warp = (k + kMergeWarps - 1) / kMergeWarps;

  if (tid == 0) {
    s_thr = kPadKey;
    s_bound = 0;
    s_n = 0;
  }
  u64 list = kPadKey;  // warp 0: the best keys so far, ascending across lanes
  u64 thr = kPadKey;   // keys below it may reach the top k
  bool seen = false;   // some pass had a slot that may score
  for (int base = 0; base < n_cand; base += kPassLanes) {
    float v[kLoads][4];
    load_pass(my_acc, n_cand, base, vec != 0, tid, v);
    unsigned may = 0;  // bit 4j + e: slot (j, e) may score
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) may |= static_cast<unsigned>(may_score(v[j][e])) << (4 * j + e);
    }
    if (!__syncthreads_or(may != 0)) continue;  // the same in every thread
    if (!seen) {
      seen = true;
      thr = entry_key(my_s[k - 1], my_d[k - 1]);  // the running k-th key
    }
    thr = min_u64(thr, s_thr);
    // Every load of the pass in flight before any is used: the slots'
    // docs, then their live and filter entries; v becomes the score.
    int dref[kLoads][kRange4 ? 1 : 4];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i0 = base + 4 * (j * kMergeThreads + tid);
      if constexpr (kRange4) {
        const int c = i0 / rs;
        dref[j][0] = (may >> (4 * j)) & 0xFu ? __ldg(my_cand + c) * rs + (i0 - c * rs) : 0;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (i0 + e) / rs;
          dref[j][e] = (may >> (4 * j + e)) & 1u ? __ldg(my_cand + c) * rs + (i0 + e - c * rs) : 0;
        }
      }
    }
    auto doc_at = [&](int j, int e) {
      if constexpr (kRange4) {
        return dref[j][0] + e;
      } else {
        return dref[j][e];
      }
    };
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((may >> (4 * j + e)) & 1u) {
          const int dc = doc_at(j, e) < n_docs ? doc_at(j, e) : n_docs;
          v[j][e] = __fmul_rn(__fmul_rn(v[j][e], __ldg(doc_live + dc)), __ldg(filter_mask + dc));
        }
      }
    }
    auto key_at = [&](int j, int e) {
      const int d = doc_at(j, e);
      const bool kept = ((may >> (4 * j + e)) & 1u) && v[j][e] > 0.0f && d < n_docs;
      return kept ? (static_cast<u64>(kInfBits - __float_as_uint(v[j][e])) << 32) |
                        static_cast<uint32_t>(d)
                  : kPadKey;
    };
    if (thr == kPadKey) {  // the same in every thread: no k keys known yet
      // A bound from the pass itself: each warp's per_warp least thread
      // minima, and the largest of those over the block: 8 * per_warp >= k
      // distinct keys lie at or below it, so no key above it is in the top k.
      u64 mine = kPadKey;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine = min_u64(mine, key_at(j, e));
      }
      u64 bound_w = kPadKey;
      for (int r = 0; r < per_warp; ++r) {
        u64 m = mine;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) m = min_u64(m, __shfl_xor_sync(kFull, m, d));
        bound_w = m;
        if (mine == m) mine = kPadKey;  // keys are distinct, pads all one
      }
      if (lane == 0) atomicMax(&s_bound, bound_w);
      __syncthreads();
      // s_bound itself is in no list yet and may be the k-th key: keep it.
      thr = s_bound == kPadKey ? kPadKey : s_bound + 1;
    }
    // Keys below the threshold to the buffer: a shared add a warp a batch.
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const u64 key = key_at(j, e);
        const bool take = key < thr;
        const unsigned b = __ballot_sync(kFull, take);
        if (b == 0) continue;  // the same in every lane
        const int first = __ffs(b) - 1;
        int at = 0;
        if (lane == first) at = atomicAdd(&s_n, __popc(b));
        at = __shfl_sync(kFull, at, first);
        if (take) s_buf[at + __popc(b & lower)] = key;
      }
    }
    __syncthreads();
    if (tid < 32) {
      const int n = s_n;
      for (int b0 = 0; b0 < n; b0 += 32) {
        const u64 key = b0 + lane < n ? s_buf[b0 + lane] : kPadKey;
        unsigned pass = __ballot_sync(kFull, key < thr);
        if (pass == 0) continue;  // the same in every lane
        if (__popc(pass) > kInsertMax) {
          list = warp_merge(list, warp_sort(key, lane), lane);
        } else {
          do {
            const u64 kk = __shfl_sync(kFull, key, __ffs(pass) - 1);
            const int at = __popc(__ballot_sync(kFull, list < kk));
            const u64 up = __shfl_up_sync(kFull, list, 1);
            list = lane < at ? list : lane == at ? kk : up;
            pass &= pass - 1;
          } while (pass);
        }
        thr = min_u64(thr, __shfl_sync(kFull, list, k - 1));
      }
      if (lane == 0) {
        s_thr = thr;
        s_n = 0;
        s_bound = 0;
      }
    }
    if (base + kPassLanes < n_cand) __syncthreads();  // buffer free, threshold published
  }
  if (!seen || tid >= 32) return;  // no slot could score: the top-k stays
  u64 top = lane < k ? entry_key(my_s[lane], my_d[lane]) : kPadKey;
  if (__any_sync(kFull, list < __shfl_sync(kFull, top, k - 1))) top = warp_merge(top, list, lane);
  if (lane < k) store_entry(my_s, my_d, lane, top);
}

// k > 32: the key buffer.
__global__ void __launch_bounds__(kMergeThreads) round_merge_kernel(
    const float* __restrict__ acc,          // [Q, C, RS]
    const int32_t* __restrict__ cand_r,     // [Q, C]
    const float* __restrict__ doc_live,     // [N+1]
    const float* __restrict__ filter_mask,  // [N+1]
    float* topk_s,                          // [Q, k], merged in place
    int32_t* topk_d,                        // [Q, k]
    u64* scratch,                           // [Q, S] or null (shared memory)
    int chunk, int rs, int k, int n_docs, int buf_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_n;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  u64* buf = scratch ? scratch + static_cast<int64_t>(q) * buf_keys
                     : reinterpret_cast<u64*>(smem_raw);
  float* my_s = topk_s + static_cast<int64_t>(q) * k;
  int32_t* my_d = topk_d + static_cast<int64_t>(q) * k;
  const int n_cand = chunk * rs;
  const float* my_acc = acc + static_cast<int64_t>(q) * n_cand;
  const int32_t* my_cand = cand_r + static_cast<int64_t>(q) * chunk;
  const int tile = buf_keys - k;

  bool mine = false;
  for (int i = tid; i < n_cand; i += nt) mine |= may_score(my_acc[i]);
  if (!__syncthreads_or(mine)) return;  // no lane could score
  for (int i = tid; i < k; i += nt) buf[i] = entry_key(my_s[i], my_d[i]);
  if (tid == 0) s_n = k;
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < n_cand; base += tile) {
    const u64 kth = buf[k - 1];
    const int end = base + tile < n_cand ? base + tile : n_cand;
    for (int i0 = base; i0 < end; i0 += nt) {  // the same trip count in every lane
      const int i = i0 + tid;
      const float a = i < end ? my_acc[i] : 0.0f;
      u64 key = kPadKey;
      if (may_score(a)) key = lane_key(a, i, rs, my_cand, doc_live, filter_mask, n_docs);
      const bool take = key < kth;
      const unsigned b = __ballot_sync(kFull, take);
      if (b == 0) continue;
      const int first = __ffs(b) - 1;
      int at = 0;
      if (lane == first) at = atomicAdd(&s_n, __popc(b));
      at = __shfl_sync(kFull, at, first);
      if (take) buf[at + __popc(b & lower)] = key;
    }
    __syncthreads();
    const int n = s_n;
    if (n > k) {  // the same n in every thread
      int m = 2;
      while (m < n) m <<= 1;
      for (int i = n + tid; i < m; i += nt) buf[i] = kPadKey;
      __syncthreads();
      bitonic_sort(buf, m, tid, nt);
    }
    __syncthreads();  // every thread has read s_n
    if (tid == 0) s_n = k;
    __syncthreads();
  }
  for (int i = tid; i < k; i += nt) store_entry(my_s, my_d, i, buf[i]);
}

// range_bounds: a block a query, sized to its groups (a first round's query
// at R = 1,024 has a few hundred) rather than to R, so that more queries
// are in flight.
int bound_threads(int n_ranges) {
  return n_ranges <= 2048 ? 128 : n_ranges <= 4096 ? 256 : 1024;
}
int select_threads(int n_ranges) {
  return n_ranges <= 1024 ? 128 : n_ranges <= 8192 ? 256 : 512;
}

}  // namespace

extern "C" int bm25_range_bounds(
    const void* token_tr_start, const void* tr_range, const void* tr_ub,
    const void* q_tid, void* ub_work, int n_queries, int n_terms, int n_ranges,
    float scale, void* stream) {
  if (n_queries < 0 || n_terms < 0 || n_ranges < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0 || n_ranges == 0) return 0;
  long long smem = 4LL * ((n_ranges + 3LL) & ~3LL);
  const int use_smem = smem <= kMaxDynamicSmem;
  if (!use_smem) smem = 0;
  cudaError_t err = bm25::allow_dynamic_smem(range_bounds_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  range_bounds_kernel<<<static_cast<unsigned int>(n_queries),
                        bound_threads(n_ranges), static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(token_tr_start),
      static_cast<const int32_t*>(tr_range), static_cast<const float*>(tr_ub),
      static_cast<const int32_t*>(q_tid), static_cast<float*>(ub_work), n_terms,
      n_ranges, scale, use_smem);
  return static_cast<int>(cudaGetLastError());
}

// scratch: a [Q, C] u64 device buffer for the keys above u*, used where
// their 8 * C bytes do not fit shared memory beside the row (the row takes
// it first: 4 * R bytes where that fits kMaxDynamicSmem).
extern "C" int bm25_round_select(
    void* ub_work, const void* topk_s, const void* tr_range,
    const void* tr_start, const void* token_tr_start, const void* q_tid,
    void* cand_r, void* start, void* length, void* flag, void* scratch,
    int n_queries, int n_terms, int n_ranges, int chunk, int k, void* stream) {
  if (chunk < 1 || chunk > n_ranges || k < 1 || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0) return 0;
  const int use_smem = 4LL * n_ranges <= kMaxDynamicSmem;
  const long long row_smem = use_smem ? 4LL * n_ranges : 0;
  const int keys_smem = row_smem + 8LL * chunk <= kMaxDynamicSmem;
  const long long smem = row_smem + (keys_smem ? 8LL * chunk : 0);
  cudaError_t err = bm25::allow_dynamic_smem(round_select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_select_kernel<<<static_cast<unsigned int>(n_queries),
                        select_threads(n_ranges), static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(ub_work), static_cast<const float*>(topk_s),
      static_cast<const int32_t*>(tr_range),
      static_cast<const int32_t*>(tr_start),
      static_cast<const int32_t*>(token_tr_start),
      static_cast<const int32_t*>(q_tid), static_cast<int32_t*>(cand_r),
      static_cast<int32_t*>(start), static_cast<int32_t*>(length),
      static_cast<int32_t*>(flag), static_cast<u64*>(scratch), n_terms,
      n_ranges, chunk, k, use_smem, keys_smem);
  return static_cast<int>(cudaGetLastError());
}

// k <= 32 keeps the top-k in registers and uses neither buffer.  Else
// buf_keys: keys the merge buffer holds, a power of two >= 2 * k; scratch:
// a [Q, buf_keys] u64 device buffer, or null where 8 * buf_keys bytes fit a
// block's shared memory (kMaxDynamicSmem; ops/blockmax_round.py mirrors it).
extern "C" int bm25_round_merge(
    const void* acc, const void* cand_r, const void* doc_live,
    const void* filter_mask, void* topk_s, void* topk_d, void* scratch,
    int n_queries, int chunk, int rs, int k, int n_docs, int buf_keys,
    void* stream) {
  if (k < 1 || chunk < 1 || rs < 1 || static_cast<long long>(chunk) * rs > kIntMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kRegK) {
    // 16-B loads where every query's row starts 16-B aligned.
    const int vec = (chunk * rs) % 4 == 0 && (reinterpret_cast<uintptr_t>(acc) & 15) == 0;
    auto kernel = rs % 4 == 0 ? round_merge_reg_kernel<true> : round_merge_reg_kernel<false>;
    kernel<<<static_cast<unsigned int>(n_queries), kMergeThreads, 0, st>>>(
        static_cast<const float*>(acc), static_cast<const int32_t*>(cand_r),
        static_cast<const float*>(doc_live), static_cast<const float*>(filter_mask),
        static_cast<float*>(topk_s), static_cast<int32_t*>(topk_d), chunk, rs, k, n_docs, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (buf_keys < 2 * k || (buf_keys & (buf_keys - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long smem = scratch ? 0 : 8LL * buf_keys;
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = bm25::allow_dynamic_smem(round_merge_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_merge_kernel<<<static_cast<unsigned int>(n_queries), kMergeThreads,
                       static_cast<size_t>(smem), st>>>(
      static_cast<const float*>(acc), static_cast<const int32_t*>(cand_r),
      static_cast<const float*>(doc_live),
      static_cast<const float*>(filter_mask), static_cast<float*>(topk_s),
      static_cast<int32_t*>(topk_d), static_cast<u64*>(scratch), chunk, rs, k,
      n_docs, buf_keys);
  return static_cast<int>(cudaGetLastError());
}
