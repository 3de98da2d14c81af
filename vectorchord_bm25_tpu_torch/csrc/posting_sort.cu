// The device build's per-shard posting sort (D1-sort, sm_90a).
//
// Replaces the reference's lax.sort((k0, k1, k2, k3, doc, tf), num_keys=5)
// inside shard_map (vectorchord_bm25_tpu/parallel/devbuild.py:244-258):
// every shard's postings sorted ascending by the four u32 words of the
// 16-byte term key, then the shard-local doc id, with the term frequency
// carried.  On one card the shards are the rows of six [D, P] columns and
// each row is sorted on its own, the shard in blockIdx.y.
//
// (key, doc) pairs are unique and P is a power of two, so a bitonic network
// gives the one right order with no stability needed.  Compare: (k0, k1)
// and (k2, k3) as two u64 words, then doc as int32.  Pads carry all-ones
// keys and doc INT_MAX, so they go last.
//
// The network runs in tiles of kTile postings in shared memory (24 B a
// posting: 48 KB a tile) wherever its stride is below kTile: one launch
// sorts every tile (sizes 2 .. kTile), and for each larger size one launch
// finishes the strides below kTile after a global-memory launch for each
// stride at or above it.  At P = 2^24 (tile 2^11) that is 105 launches,
// each reading and writing every column once: about 0.68 TB of traffic for
// 3.2 GB of columns at D = 8.  A simple network: its bound is the columns
// read and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 2048;  // postings a shared-memory tile holds

struct Cols {
  uint32_t* k0;
  uint32_t* k1;
  uint32_t* k2;
  uint32_t* k3;
  int32_t* doc;
  uint32_t* tf;
};

struct Posting {
  u64 hi;
  u64 lo;
  int32_t doc;
  uint32_t tf;
};

__device__ __forceinline__ bool less(const Posting& a, const Posting& b) {
  if (a.hi != b.hi) return a.hi < b.hi;
  if (a.lo != b.lo) return a.lo < b.lo;
  return a.doc < b.doc;
}

__device__ __forceinline__ Posting load(const Cols& c, int64_t i) {
  Posting p;
  p.hi = (static_cast<u64>(c.k0[i]) << 32) | c.k1[i];
  p.lo = (static_cast<u64>(c.k2[i]) << 32) | c.k3[i];
  p.doc = c.doc[i];
  p.tf = c.tf[i];
  return p;
}

__device__ __forceinline__ void store(const Cols& c, int64_t i, const Posting& p) {
  c.k0[i] = static_cast<uint32_t>(p.hi >> 32);
  c.k1[i] = static_cast<uint32_t>(p.hi);
  c.k2[i] = static_cast<uint32_t>(p.lo >> 32);
  c.k3[i] = static_cast<uint32_t>(p.lo);
  c.doc[i] = p.doc;
  c.tf[i] = p.tf;
}

__device__ __forceinline__ Cols row_of(Cols c, int64_t row_start) {
  c.k0 += row_start;
  c.k1 += row_start;
  c.k2 += row_start;
  c.k3 += row_start;
  c.doc += row_start;
  c.tf += row_start;
  return c;
}

// Sizes [size_lo, size_hi] of the network, strides below min(size, tile)
// each, over one tile of `tile` postings (blockIdx.x) of row blockIdx.y.
__global__ void tile_kernel(Cols cols, int64_t n_cols, int tile, int size_lo,
                            int64_t size_hi) {
  __shared__ Posting s[kTile];
  const Cols c = row_of(cols, static_cast<int64_t>(blockIdx.y) * n_cols);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = load(c, base + i);
  __syncthreads();
  for (int64_t size = size_lo; size <= size_hi; size <<= 1) {
    const int top = size < tile ? static_cast<int>(size >> 1) : tile >> 1;
    for (int stride = top; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (tile >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = ((base + lo) & size) == 0;
        const Posting a = s[lo];
        const Posting b = s[hi];
        if (less(b, a) == up) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) store(c, base + i, s[i]);
}

// One compare-exchange step (size, stride) of the network in device memory,
// one pair a thread.
__global__ void global_step_kernel(Cols cols, int64_t n_cols, int64_t size,
                                   int64_t stride) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pair >= (n_cols >> 1)) return;
  const Cols c = row_of(cols, static_cast<int64_t>(blockIdx.y) * n_cols);
  const int64_t lo = 2 * pair - (pair & (stride - 1));
  const int64_t hi = lo + stride;
  const bool up = (lo & size) == 0;
  const Posting a = load(c, lo);
  const Posting b = load(c, hi);
  if (less(b, a) == up) {
    store(c, lo, b);
    store(c, hi, a);
  }
}

}  // namespace

// Sorts each of the n_rows rows of the six [n_rows, n_cols] columns in
// place; n_cols a power of two >= 2.
extern "C" int bm25_posting_sort(
    void* k0, void* k1, void* k2, void* k3, void* doc, void* tf, int n_rows,
    long long n_cols, void* stream) {
  if (n_rows < 1 || n_cols < 2 || (n_cols & (n_cols - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cols cols{static_cast<uint32_t*>(k0), static_cast<uint32_t*>(k1),
                  static_cast<uint32_t*>(k2), static_cast<uint32_t*>(k3),
                  static_cast<int32_t*>(doc), static_cast<uint32_t*>(tf)};
  const int tile = n_cols < kTile ? static_cast<int>(n_cols) : kTile;
  const int threads = tile / 2 < 1024 ? tile / 2 : 1024;
  const dim3 tiles(static_cast<unsigned int>(n_cols / tile),
                   static_cast<unsigned int>(n_rows));
  // Every tile sorted by sizes 2 .. tile.
  tile_kernel<<<tiles, threads, 0, st>>>(cols, n_cols, tile, 2, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int step_threads = 256;
  const dim3 pairs(
      static_cast<unsigned int>((n_cols / 2 + step_threads - 1) / step_threads),
      static_cast<unsigned int>(n_rows));
  for (long long size = 2LL * tile; size <= n_cols; size <<= 1) {
    for (long long stride = size >> 1; stride >= tile; stride >>= 1) {
      global_step_kernel<<<pairs, step_threads, 0, st>>>(cols, n_cols, size, stride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    tile_kernel<<<tiles, threads, 0, st>>>(cols, n_cols, tile, size, size);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
