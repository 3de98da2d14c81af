// The device build's per-shard posting sort (D1-sort, sm_90a).
//
// Replaces the reference's lax.sort((k0, k1, k2, k3, doc, tf), num_keys=5)
// inside shard_map (vectorchord_bm25_tpu/parallel/devbuild.py:244-258):
// every shard's postings sorted ascending by the four u32 words of the
// 16-byte term key, then the shard-local doc id as a signed int32, with the
// term frequency carried.  On one card the shards are the rows of six
// [D, P] columns and each row is sorted on its own, the row in blockIdx.y.
//
// A stable LSD radix sort in 8-bit digits: the least significant key first
// (doc with its sign bit flipped, then k3, k2, k1, k0), four passes a word,
// each pass moving all six columns from one column set to the other (the
// caller's and a scratch set the wrapper allocates).  A stable pass keeps
// the order of the passes before it among equal digits, so after the last
// pass the rows are in (key, doc) order, equal (key, doc) pairs in their
// input order: the order of the plain version's five stable sorts.
//
// Census (one launch, before any pass).  Each row's OR and OR-of-complement
// of every key word, which name the bits that vary within the row, and
// whether the row's doc column is non-decreasing.  The host reads it once
// a sort (ops/shard_kernels.py plans the passes from it) and skips:
//   - a pass whose digit has one value in every row (no varying bit in its
//     byte): its histogram has a single non-empty bin, so a stable pass
//     would leave every row as it is;
//   - the four doc passes where every row's doc column is non-decreasing:
//     a stable sort by doc is then the identity, so the key passes alone
//     give exactly the (key, doc) order.  The device build stages rows like
//     that (postings doc-grouped in ascending shard-local doc, the pads at
//     the tail with doc INT_MAX: parallel/devbuild.py), so its sort runs 16
//     passes, not 20.
// An odd number of passes leaves the rows in the scratch set; six copies
// bring them back.
//
// A pass is three launches over tiles of kTileP = 4,096 postings of a row:
//   1. count: each tile's histogram of the pass's digit (the one key word
//      read, 4 B a posting), written digit-major, [D][256][tiles];
//   2. scan: per (row, digit) the exclusive scan over the tiles, in place,
//      and the digit's row total;
//   3. scatter: each tile ranks its postings stably (each warp owns a
//      contiguous run of 512 and walks it 32 at a time in order; peers of
//      equal digit by __match_any_sync, a warp-private counter a digit),
//      stages all six columns in shared memory in digit order (96 KB), and
//      writes each digit's run to its place in the row: the row's exclusive
//      scan of the digit totals plus the tile's offset within the digit.
//      Consecutive threads write consecutive postings of one run.
// What bounds it: bytes.  A pass reads the sorted word twice (count and
// scatter) and every other column once and writes all six once: 52 B a
// posting against the 48 B of one read and one write.  The scans move the
// [D][256][tiles] counts (32 MB at [8, 2^24]).  The census reads the five
// key words once.  The lower bound of the sort as a whole is the six
// columns read once and written once; a pass costs about that much, so the
// pass count is the lever, and the skips are what cut it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_smem.cuh"

namespace {

constexpr int kCols = 6;    // k0, k1, k2, k3, doc, tf
constexpr int kWords = 5;   // the key words k0 .. k3, doc
constexpr int kDocWord = 4;
constexpr int kCensus = 2 * kWords + 1;  // OR of ~word, OR of word, unsorted
constexpr int kThreads = 256;  // count and scatter blocks; one thread a bin
constexpr int kItems = 16;
constexpr int kTileP = kThreads * kItems;  // postings a tile
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kTileP / kWarps;  // a warp's run of the tile
constexpr int kBins = 256;
constexpr int kScanThreads = 512;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Cols {
  uint32_t* c[kCols];
};

__device__ __forceinline__ uint32_t digit_of(uint32_t word, int shift, uint32_t flip) {
  return ((word ^ flip) >> shift) & 0xFFu;
}

// Exclusive scan of one int a thread over a block of blockDim.x threads
// (a multiple of 32); every thread calls it.  s_warp: blockDim.x / 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();  // s_warp may be written again
  return before + incl - v;
}

// census[row][w] |= ~word, census[row][kWords + w] |= word for the five key
// words, census[row][2 * kWords] = 1 where some doc[i] > doc[i + 1].
__global__ void census_kernel(Cols cols, int64_t n_cols, uint32_t* census) {
  const int64_t row_off = static_cast<int64_t>(blockIdx.y) * n_cols;
  uint32_t not_and[kWords] = {0, 0, 0, 0, 0};
  uint32_t any_or[kWords] = {0, 0, 0, 0, 0};
  bool unsorted = false;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_cols;
       i += stride) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t v = cols.c[w][row_off + i];
      not_and[w] |= ~v;
      any_or[w] |= v;
    }
    if (i + 1 < n_cols) {
      unsorted |= static_cast<int32_t>(cols.c[kDocWord][row_off + i]) >
                  static_cast<int32_t>(cols.c[kDocWord][row_off + i + 1]);
    }
  }
  uint32_t* out = census + static_cast<int64_t>(blockIdx.y) * kCensus;
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const uint32_t a = __reduce_or_sync(kFull, not_and[w]);
    const uint32_t b = __reduce_or_sync(kFull, any_or[w]);
    if (lead && a) atomicOr(&out[w], a);
    if (lead && b) atomicOr(&out[kWords + w], b);
  }
  if (__any_sync(kFull, unsorted) && lead) atomicOr(&out[2 * kWords], 1u);
}

// 1. Each tile's histogram of the digit, to counts[row][digit][tile].
__global__ void __launch_bounds__(kThreads) count_kernel(
    const uint32_t* __restrict__ word, int64_t n_cols, int shift, uint32_t flip,
    int n_tiles, int* __restrict__ counts) {
  __shared__ int hist[kBins];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t tile_off = static_cast<int64_t>(blockIdx.x) * kTileP;
  const int64_t left = n_cols - tile_off;
  const int n_in = left < kTileP ? static_cast<int>(left) : kTileP;
  const uint32_t* src = word + static_cast<int64_t>(blockIdx.y) * n_cols + tile_off;
  hist[tid] = 0;
  uint32_t v[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    v[j] = i < n_in ? src[i] : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = j * kThreads + tid < n_in;
    const uint32_t d = digit_of(v[j], shift, flip);
    const unsigned act = __ballot_sync(kFull, in);
    if (act == 0) continue;  // the same in every lane
    const int first = __ffs(act) - 1;
    const uint32_t lead = __shfl_sync(kFull, d, first);
    // A run of equal digits (pads, one term's postings) adds once.
    if (__all_sync(kFull, !in || d == lead)) {
      if (lane == first) atomicAdd(&hist[lead], __popc(act));
    } else if (in) {
      atomicAdd(&hist[d], 1);
    }
  }
  __syncthreads();
  counts[(static_cast<int64_t>(blockIdx.y) * kBins + tid) * n_tiles + blockIdx.x] = hist[tid];
}

// 2. Per (row, digit): the exclusive scan of the tiles' counts in place, and
// the digit's total in the row.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    int* __restrict__ counts, int* __restrict__ totals, int n_tiles) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int key = blockIdx.y * kBins + blockIdx.x;
  int* c = counts + static_cast<int64_t>(key) * n_tiles;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int base = 0; base < n_tiles; base += kScanThreads * 4) {
    const int i0 = base + threadIdx.x * 4;
    int v[4];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = i0 + j < n_tiles ? c[i0 + j] : 0;
      sum += v[j];
    }
    int run = s_carry + block_exclusive_scan(sum, s_warp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < n_tiles) c[i0 + j] = run;
      run += v[j];
    }
    __syncthreads();  // every thread has read s_carry
    if (threadIdx.x == kScanThreads - 1) s_carry = run;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[key] = s_carry;
}

// 3. One tile ranked stably by the digit and moved, all six columns, from
// src to dst.  Dynamic shared memory: the six staged columns.
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    Cols src, Cols dst, int64_t n_cols, int word, int shift, uint32_t flip, int n_tiles,
    const int* __restrict__ counts, const int* __restrict__ totals) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s_val = reinterpret_cast<uint32_t*>(smem_raw);  // [kCols][kTileP]
  __shared__ uint8_t s_dig[kTileP];  // the digit of each sorted slot
  __shared__ int s_wh[kWarps][kBins];
  __shared__ int s_start[kBins];  // the digit's first slot in the tile
  __shared__ int s_dest[kBins];   // the digit's first place in the row
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.y;
  const int64_t row_off = static_cast<int64_t>(row) * n_cols;
  const int64_t tile_off = static_cast<int64_t>(blockIdx.x) * kTileP;
  const int64_t left = n_cols - tile_off;
  const int n_in = left < kTileP ? static_cast<int>(left) : kTileP;

  for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_wh[0][0])[i] = 0;
  // The row's exclusive scan of the digit totals, plus this tile's offset
  // within each digit (the scan launch's output).
  const int row_start = block_exclusive_scan(totals[row * kBins + tid], s_warp);
  s_dest[tid] = row_start +
                counts[(static_cast<int64_t>(row) * kBins + tid) * n_tiles + blockIdx.x];

  // Rank: warp w owns slots [w * kPerWarp, (w + 1) * kPerWarp), 32 a round
  // in order; a posting's rank counts the warp's earlier postings of its
  // digit.
  const uint32_t* wsrc = src.c[word] + row_off + tile_off;
  const int first = warp * kPerWarp + lane;
  uint32_t key[kItems];
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + 32 * j;
    key[j] = i < n_in ? wsrc[i] : 0u;
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool in = first + 32 * j < n_in;
    const uint32_t d = in ? digit_of(key[j], shift, flip) : kBins;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = __popc(peers & lower);
    const int base = in ? s_wh[warp][d] : 0;
    __syncwarp();
    if (in && before == 0) s_wh[warp][d] = base + __popc(peers);
    __syncwarp();
    rank[j] = base + before;
  }
  __syncthreads();
  // Each digit: its warps' exclusive offsets, then the tile's exclusive
  // scan over the digits.
  int in_tile = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_wh[w][tid];
    s_wh[w][tid] = in_tile;
    in_tile += t;
  }
  s_start[tid] = block_exclusive_scan(in_tile, s_warp);
  __syncthreads();

  // Stage every column in digit order.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + 32 * j < n_in) {
      const uint32_t d = digit_of(key[j], shift, flip);
      rank[j] += s_start[d] + s_wh[warp][d];
      s_dig[rank[j]] = static_cast<uint8_t>(d);
      s_val[word * kTileP + rank[j]] = key[j];
    }
  }
#pragma unroll 1
  for (int c = 0; c < kCols; ++c) {
    if (c == word) continue;
    const uint32_t* col = src.c[c] + row_off + tile_off;
    uint32_t v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + 32 * j;
      v[j] = i < n_in ? col[i] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + 32 * j < n_in) s_val[c * kTileP + rank[j]] = v[j];
    }
  }
  __syncthreads();

  // Write each digit's run to its place: slot i of digit d goes to
  // s_dest[d] + (i - s_start[d]).
  for (int i = tid; i < n_in; i += kThreads) {
    const int d = s_dig[i];
    const int64_t at = row_off + s_dest[d] + (i - s_start[d]);
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst.c[c][at] = s_val[c * kTileP + i];
  }
}

constexpr int kScatterSmem = kCols * kTileP * 4;

Cols cols_of(void* k0, void* k1, void* k2, void* k3, void* doc, void* tf) {
  return Cols{{static_cast<uint32_t*>(k0), static_cast<uint32_t*>(k1),
               static_cast<uint32_t*>(k2), static_cast<uint32_t*>(k3),
               static_cast<uint32_t*>(doc), static_cast<uint32_t*>(tf)}};
}

bool bad_shape(int n_rows, long long n_cols) {
  return n_rows < 1 || n_rows > 65535 || n_cols < 2 || n_cols > (1LL << 30) ||
         (n_cols & (n_cols - 1));
}

}  // namespace

// The census of the six [n_rows, n_cols] columns into census [n_rows, 11]
// u32 (zeroed here): per key word the OR of its complement and its OR, then
// 1 where the row's doc column is not non-decreasing.
extern "C" int bm25_posting_sort_census(
    void* k0, void* k1, void* k2, void* k3, void* doc, void* tf, int n_rows,
    long long n_cols, void* census, void* stream) {
  if (bad_shape(n_rows, n_cols)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(census, 0, sizeof(uint32_t) * kCensus * n_rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n_cols + kThreads * 16LL - 1) / (kThreads * 16LL);
  if (blocks > 1024) blocks = 1024;
  census_kernel<<<dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(n_rows)),
                  kThreads, 0, st>>>(cols_of(k0, k1, k2, k3, doc, tf), n_cols,
                                     static_cast<uint32_t*>(census));
  return static_cast<int>(cudaGetLastError());
}

// The radix passes plan[0 .. n_passes) (pairs of key word 0-4 and digit
// shift 0, 8, 16, 24, least significant first), each from one column set
// to the other; the sorted rows end in the caller's columns.  scratch: six
// more [n_rows, n_cols] u32 columns, one after the other; counts: n_rows *
// 256 * ceil(n_cols / 4096) ints; totals: n_rows * 256 ints.
extern "C" int bm25_posting_sort_passes(
    void* k0, void* k1, void* k2, void* k3, void* doc, void* tf, void* scratch,
    void* counts, void* totals, const void* plan, int n_passes, int n_rows,
    long long n_cols, void* stream) {
  if (bad_shape(n_rows, n_cols) || n_passes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_passes == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bm25::allow_dynamic_smem(scatter_kernel, kScatterSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cols caller = cols_of(k0, k1, k2, k3, doc, tf);
  Cols other;
  for (int c = 0; c < kCols; ++c) {
    other.c[c] = static_cast<uint32_t*>(scratch) + static_cast<int64_t>(c) * n_rows * n_cols;
  }
  const int n_tiles = static_cast<int>((n_cols + kTileP - 1) / kTileP);
  const dim3 tiles(static_cast<unsigned int>(n_tiles), static_cast<unsigned int>(n_rows));
  const dim3 bins(kBins, static_cast<unsigned int>(n_rows));
  int* cnt = static_cast<int*>(counts);
  int* tot = static_cast<int*>(totals);
  const int* steps = static_cast<const int*>(plan);
  Cols from = caller, to = other;
  for (int p = 0; p < n_passes; ++p) {
    const int word = steps[2 * p];
    const int shift = steps[2 * p + 1];
    if (word < 0 || word >= kWords || shift < 0 || shift > 24 || (shift & 7)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const uint32_t flip = word == kDocWord ? 0x80000000u : 0u;
    count_kernel<<<tiles, kThreads, 0, st>>>(from.c[word], n_cols, shift, flip, n_tiles, cnt);
    scan_kernel<<<bins, kScanThreads, 0, st>>>(cnt, tot, n_tiles);
    scatter_kernel<<<tiles, kThreads, kScatterSmem, st>>>(
        from, to, n_cols, word, shift, flip, n_tiles, cnt, tot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const Cols t = from;
    from = to;
    to = t;
  }
  if (n_passes & 1) {  // the rows are in the scratch set
    const size_t bytes = sizeof(uint32_t) * static_cast<size_t>(n_rows) * n_cols;
    for (int c = 0; c < kCols; ++c) {
      err = cudaMemcpyAsync(caller.c[c], from.c[c], bytes, cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
