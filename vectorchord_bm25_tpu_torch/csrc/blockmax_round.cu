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
// range_bounds.  ub_work[q, r] = (sum_t tr_ub[g(t, r)]) * scale.  For each
// term in ascending t the block's threads walk the term's CSR span of
// (range, ub) groups and add into the row; a term has at most one group a
// range, so no two threads of one term meet and no atomic is needed, and the
// barrier between terms keeps each range's sum in ascending t: the order of
// the reference's flat scatter.  Then one __fmul_rn by the f32 scale.  Bound
// by bytes: the [Q, R] row written once dominates.
//
// round_select.  thresh = max(topk_s[q, k-1], 0).  The C highest bounds of
// the row, ties to the lower range (lax.top_k's rule), by C arg-max rounds:
// bounds are >= +0 or -inf, so their f32 bits order like the values as
// signed integers, and (bits ^ 0x80000000) << 32 | ~range is one u64 whose
// maximum is the winner.  Every thread keeps the best of its own strided
// elements in a register; a round is one shuffle reduction, one barrier and
// a rescan by the winner's owner only.  A taken range is marked with the bit
// pattern 0x80000000 (below -inf in that order, never a bound) so a row with
// fewer than C live bounds refills with distinct -inf ranges, lowest first,
// as top_k does; at the end every taken range is written back as -inf.
// Candidates come out in descending bound order, so cand_ok = bound > thresh
// holds for a prefix of n_ok candidates.  A query whose maximum is not above
// its threshold is inactive: it writes cand_r = 0 and length = 0 everywhere,
// leaves its row alone (a threshold only rises, so the row is never read
// again with another outcome) and returns after one round.  An active query
// raises the one device flag the host loop reads.  locate: for each (t, c) a
// binary search of the term's ascending range list tr_range[base, base +
// count) gives the group's posting span, or (0, 0) where the term has no
// group in the range or the candidate is not ok.  Bound by bytes: the row
// read and written once.
//
// round_merge.  s = (acc * live[d]) * filter[d] with d = min(doc, N), two
// __fmul_rn in the reference's order; a candidate is kept where s > 0 and
// doc < N.  Kept candidates and the running top-k become the packed keys of
// ops/topk.py, (0x7F800000 - f32 bits) << 32 | doc, whose ascending order is
// (score desc, doc asc) and which are distinct among live entries, so the k
// smallest are the reference's lax.sort(num_keys=2)[:k].  Only a candidate
// below the running kth key can enter the top-k, so the block compacts
// those into its key buffer (a shared atomic counter; their order there does
// not matter, the sort fixes it) and bitonic-sorts just that many, padded to
// a power of two.  The buffer holds S keys; candidates go through it in
// tiles of S - k, the k best staying at its head.  Bound by bytes: the
// [Q, C, RS] scores read once.
//
// No fast math: a subnormal bound or score stays what it is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr uint32_t kInfBits = 0x7F800000u;
constexpr uint32_t kNegInfBits = 0xFF800000u;
constexpr uint32_t kTakenBits = 0x80000000u;
constexpr int kIntMax = 0x7FFFFFFF;
constexpr u64 kPadKey = (static_cast<u64>(kInfBits) << 32) | 0x7FFFFFFFull;
// Dynamic shared memory a block may ask for (of the SM's 227 KB, leaving
// room for the kernels' small static arrays).
constexpr long long kMaxDynamicSmem = 224 * 1024;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

__global__ void range_bounds_kernel(
    const int32_t* __restrict__ token_tr_start,  // [V+2]
    const int32_t* __restrict__ tr_range,        // [M+1]
    const float* __restrict__ tr_ub,             // [M+1]
    const int32_t* __restrict__ q_tid,           // [Q, T]
    float* ub_work,                              // [Q, R]
    int n_terms, int n_ranges, float scale, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x;
  float* out = ub_work + static_cast<int64_t>(q) * n_ranges;
  float* row = use_smem ? reinterpret_cast<float*>(smem_raw) : out;
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) row[r] = 0.0f;
  __syncthreads();
  for (int t = 0; t < n_terms; ++t) {
    const int term = q_tid[static_cast<int64_t>(q) * n_terms + t];
    const int lo = token_tr_start[term];
    const int hi = token_tr_start[term + 1];
    for (int g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const int r = tr_range[g];
      if (r >= 0 && r < n_ranges) row[r] = __fadd_rn(row[r], tr_ub[g]);
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < n_ranges; r += blockDim.x) {
    out[r] = __fmul_rn(row[r], scale);
  }
}

__device__ __forceinline__ u64 bound_key(uint32_t bits, int r) {
  return (static_cast<u64>(bits ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(r));
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
    int n_terms, int n_ranges, int chunk, int k, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ u64 warp_best[2][32];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = (nt + 31) >> 5;
  uint32_t* grow =
      reinterpret_cast<uint32_t*>(ub_work + static_cast<int64_t>(q) * n_ranges);
  uint32_t* row = use_smem ? reinterpret_cast<uint32_t*>(smem_raw) : grow;
  int32_t* my_cand = cand_r + static_cast<int64_t>(q) * chunk;
  const int64_t tc = static_cast<int64_t>(n_terms) * chunk;
  int32_t* my_start = start + static_cast<int64_t>(q) * tc;
  int32_t* my_length = length + static_cast<int64_t>(q) * tc;
  const float thresh =
      fmaxf(topk_s[static_cast<int64_t>(q) * k + (k - 1)], 0.0f);

  // Each thread owns the elements tid, tid + nt, ...: it alone reads and
  // marks them, so the row needs no barrier of its own.
  u64 best = 0;
  for (int r = tid; r < n_ranges; r += nt) {
    const uint32_t bits = grow[r];
    if (use_smem) row[r] = bits;
    best = umax64(best, bound_key(bits, r));
  }
  int n_ok = 0;
  for (int c = 0; c < chunk; ++c) {
    u64 w = best;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      w = umax64(w, __shfl_xor_sync(0xFFFFFFFFu, w, d));
    }
    if (lane == 0) warp_best[c & 1][warp] = w;
    __syncthreads();
    u64 win = 0;
    for (int i = 0; i < n_warps; ++i) win = umax64(win, warp_best[c & 1][i]);
    const int r = static_cast<int>(~static_cast<uint32_t>(win & 0xFFFFFFFFull));
    const float ub =
        __uint_as_float(static_cast<uint32_t>(win >> 32) ^ 0x80000000u);
    const bool ok = ub > thresh;
    if (c == 0 && !ok) {
      // Inactive query (the same `win` in every thread, so all leave).
      for (int i = tid; i < chunk; i += nt) my_cand[i] = 0;
      for (int64_t i = tid; i < tc; i += nt) {
        my_start[i] = 0;
        my_length[i] = 0;
      }
      return;
    }
    if (ok) n_ok = c + 1;
    if (tid == 0) my_cand[c] = r;
    if (r % nt == tid) {
      row[r] = kTakenBits;
      best = 0;
      for (int j = tid; j < n_ranges; j += nt) {
        best = umax64(best, bound_key(row[j], j));
      }
    }
  }
  if (tid == 0) *flag = 1;
  __syncthreads();  // my_cand is complete and visible
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
      int lo = base, hi = end;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (tr_range[mid] < r) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      if (lo < end && tr_range[lo] == r) {
        st = tr_start[lo];
        ln = tr_start[lo + 1] - st;
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

__global__ void round_merge_kernel(
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
  const int nt = blockDim.x;
  u64* buf = scratch ? scratch + static_cast<int64_t>(q) * buf_keys
                     : reinterpret_cast<u64*>(smem_raw);
  float* my_s = topk_s + static_cast<int64_t>(q) * k;
  int32_t* my_d = topk_d + static_cast<int64_t>(q) * k;
  const int64_t n_cand = static_cast<int64_t>(chunk) * rs;
  const float* my_acc = acc + static_cast<int64_t>(q) * n_cand;
  const int32_t* my_cand = cand_r + static_cast<int64_t>(q) * chunk;
  const int tile = buf_keys - k;

  for (int i = tid; i < k; i += nt) {
    const float s = my_s[i];
    buf[i] = s > 0.0f ? (static_cast<u64>(kInfBits - __float_as_uint(s)) << 32) |
                            static_cast<uint32_t>(my_d[i])
                      : kPadKey;
  }
  if (tid == 0) s_n = k;
  __syncthreads();
  for (int64_t base = 0; base < n_cand; base += tile) {
    const u64 kth = buf[k - 1];
    const int64_t end = base + tile < n_cand ? base + tile : n_cand;
    for (int64_t i = base + tid; i < end; i += nt) {
      const int c = static_cast<int>(i / rs);
      const int slot = static_cast<int>(i - static_cast<int64_t>(c) * rs);
      const int doc = my_cand[c] * rs + slot;
      const int dc = doc < n_docs ? doc : n_docs;
      const float s =
          __fmul_rn(__fmul_rn(my_acc[i], doc_live[dc]), filter_mask[dc]);
      if (s > 0.0f && doc < n_docs) {
        const u64 key = (static_cast<u64>(kInfBits - __float_as_uint(s)) << 32) |
                        static_cast<uint32_t>(doc);
        if (key < kth) buf[atomicAdd(&s_n, 1)] = key;
      }
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
  for (int i = tid; i < k; i += nt) {
    const u64 key = buf[i];
    const uint32_t hi = static_cast<uint32_t>(key >> 32);
    const bool pad = hi == kInfBits;
    my_s[i] = pad ? __uint_as_float(kNegInfBits) : __uint_as_float(kInfBits - hi);
    my_d[i] = pad ? kIntMax : static_cast<int32_t>(key & 0xFFFFFFFFull);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Threads of a block that walks an [R] row.
int row_threads(int n_ranges) { return n_ranges <= 4096 ? 256 : 1024; }

}  // namespace

extern "C" int bm25_range_bounds(
    const void* token_tr_start, const void* tr_range, const void* tr_ub,
    const void* q_tid, void* ub_work, int n_queries, int n_terms, int n_ranges,
    float scale, void* stream) {
  if (n_queries == 0 || n_ranges == 0) return 0;
  long long smem = 4LL * n_ranges;
  const int use_smem = smem <= kMaxDynamicSmem;
  if (!use_smem) smem = 0;
  cudaError_t err = allow_smem(range_bounds_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  range_bounds_kernel<<<static_cast<unsigned int>(n_queries),
                        row_threads(n_ranges), static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(token_tr_start),
      static_cast<const int32_t*>(tr_range), static_cast<const float*>(tr_ub),
      static_cast<const int32_t*>(q_tid), static_cast<float*>(ub_work), n_terms,
      n_ranges, scale, use_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm25_round_select(
    void* ub_work, const void* topk_s, const void* tr_range,
    const void* tr_start, const void* token_tr_start, const void* q_tid,
    void* cand_r, void* start, void* length, void* flag, int n_queries,
    int n_terms, int n_ranges, int chunk, int k, void* stream) {
  if (chunk < 1 || chunk > n_ranges || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0) return 0;
  long long smem = 4LL * n_ranges;
  const int use_smem = smem <= kMaxDynamicSmem;
  if (!use_smem) smem = 0;
  cudaError_t err = allow_smem(round_select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_select_kernel<<<static_cast<unsigned int>(n_queries),
                        row_threads(n_ranges), static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(ub_work), static_cast<const float*>(topk_s),
      static_cast<const int32_t*>(tr_range),
      static_cast<const int32_t*>(tr_start),
      static_cast<const int32_t*>(token_tr_start),
      static_cast<const int32_t*>(q_tid), static_cast<int32_t*>(cand_r),
      static_cast<int32_t*>(start), static_cast<int32_t*>(length),
      static_cast<int32_t*>(flag), n_terms, n_ranges, chunk, k, use_smem);
  return static_cast<int>(cudaGetLastError());
}

// buf_keys: keys the merge buffer holds, a power of two >= 2 * k.  scratch:
// a [Q, buf_keys] u64 device buffer, or null where 8 * buf_keys bytes fit a
// block's shared memory (kMaxDynamicSmem; ops/blockmax_round.py mirrors it).
extern "C" int bm25_round_merge(
    const void* acc, const void* cand_r, const void* doc_live,
    const void* filter_mask, void* topk_s, void* topk_d, void* scratch,
    int n_queries, int chunk, int rs, int k, int n_docs, int buf_keys,
    void* stream) {
  if (k < 1 || buf_keys < 2 * k || (buf_keys & (buf_keys - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_queries == 0) return 0;
  long long smem = scratch ? 0 : 8LL * buf_keys;
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(round_merge_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_merge_kernel<<<static_cast<unsigned int>(n_queries), kMergeThreads,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const int32_t*>(cand_r),
      static_cast<const float*>(doc_live),
      static_cast<const float*>(filter_mask), static_cast<float*>(topk_s),
      static_cast<int32_t*>(topk_d), static_cast<u64*>(scratch), chunk, rs, k,
      n_docs, buf_keys);
  return static_cast<int>(cudaGetLastError());
}
