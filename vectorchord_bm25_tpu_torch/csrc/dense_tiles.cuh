// The doc-tile walk S1 (stream_dense.cu) and E1 (exact_dense.cu) share
// (sm_90a): a dense [n_q, stride] f32 accumulator written once, a doc tile
// of one query row at a time, summed in shared memory.
//
// Each block owns the cells [tlo, thi) of one query row q.  It
//   1. zeroes its tile in shared memory;
//   2. walks q's windows, a chunk of kThreads entries at a time, and takes
//      the windows whose docs can fall inside the tile; it adds their lanes
//      inside the tile one term-ordinal run at a time, in ascending order,
//      with a block barrier between runs;
//   3. writes the whole tile once, coalesced, 16 B a thread a store, times
//      the filter where the caller passes one.
// So every cell of the accumulator is written by exactly one block, zeros,
// the pad column n_docs, the stride padding up to a multiple of 4 and rows
// without a window included: the caller allocates it uninitialised, and no
// cell is read from device memory.  The reference's accumulator is zeroed
// and then scattered into; the tile is its zero-fill and its scatter in one
// pass.
//
// What the walk relies on.  The layout of a query's list of windows, as
// the planning writes it (search/stream.py::_dispatches,
// search/exact.py::_assemble_windows, parallel/shard.py; pinned by
// tests/test_torch_dense_tiles.py and checked here, by every block on its
// whole list before it adds anything):
//   (L1) the real windows come first, in non-decreasing ordinal order;
//        every entry after them is a pad (an ordinal the source calls one);
//   (L2) inside one ordinal the windows' first docs strictly rise;
// and what the index and the planning give a run:
//   (I)  a run is one term's posting list cut into windows in doc order, so
//        every doc of a window lies in [its first doc, the first doc of the
//        next window of its run), and a window's docs are distinct.
// So the windows whose docs can meet the tile [tlo, thi) are the last one
// of each run whose first doc is <= tlo and the ones whose first doc lies
// inside the tile: window i is taken iff its first doc is < thi and the
// next window of its run (if any) starts after tlo.  That is the binary
// search on first docs evaluated by every entry at once
// (ops/dense_tiles.py::taken_windows states it), and costs one pass over
// the list, which the layout check reads anyway.  A block whose list
// breaks L1 or L2, or holds a real window its source cannot place (E1: no
// lanes, or a row out of range), zeroes its tile again and adds every
// window in the reference's order, one lane at a time by one thread:
// ordinal by ordinal, window by window, lane by lane.  Slow, and exact.
//
// Exactness.  Inside one run the docs of a query are distinct (I), so the
// warps of a block add one run's windows into the tile at once with a
// plain read-add-write, race-free, and across runs the adds land in
// ascending ordinal order, the reference's window order: no atomics (a
// global atomicAdd would flush subnormals).  Each cell starts at +0.0 and
// takes its terms' scores by `__fadd_rn`, lanes of other docs and dead
// lanes add nothing (the reference adds +0.0 there, which changes no bit
// of a non-negative sum), and the filter is one `__fmul_rn` of the sum, as
// the reference's `acc * filter`: kernel, plain version and reference agree
// bit for bit.
//
// Design.  A block is kThreads threads; its tile is `tile_w` floats of
// dynamic shared memory (above 48 KB by cudaFuncSetAttribute), a multiple
// of 4, the row split into n_tiles equal tiles no wider than the caller's
// `tile` (ops/dense_tiles.py::tile_split mirrors the split; 8,192 cells
// measured fastest, PERF.md).  Blocks are numbered query-major, so the
// tiles of one query run together and share its windows' metadata and
// stream words in L2.  Past the write, a block's time is the latency of
// its dependent loads (the list, then each window's metadata, lanes and
// per-doc table), so they are kept in flight together: the taken windows
// go kWarps at a time, one a warp, every warp loads and scores its
// window's lanes into registers first, and only the adds into the tile
// wait for the run before them (loading each run only after the one
// before it had added ran slower, PERF.md).  A window that straddles
// tiles is decoded by each block that takes it; a rare term's window can
// span every tile.
//
// Bound.  The accumulator written once, 4 B a cell (1.07 GB at [2048,
// 131073], 0.32 ms at 3.35 TB/s), plus each window's words or lanes read
// once: bound by bytes, by the write.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_smem.cuh"

namespace bm25 {
namespace tiles {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = INT_MAX;  // the ordering key of a pad
constexpr unsigned kFull = 0xFFFFFFFFu;

// One window's lanes as a thread holds them: the tile cell of each of its
// four lanes (-1: a lane outside the tile or dead) and its score.
struct Lanes {
  int cell[4];
  float sc[4];
};

// One entry of a query's list as the walk orders it.
struct Key {
  int ord;    // term ordinal; kPad: a pad, which adds nothing
  int first;  // the window's first doc (real windows)
  int bad;    // a real window the source cannot place
};

struct Scratch {
  Key keys[kThreads];     // the chunk's entries
  int sel[kThreads];      // the chunk's taken windows, in list order
  int sel_ord[kThreads];  // and their ordinals
  int counts[kWarps];
  int serial_doc[128];    // one window's lanes for the one-thread walk
  float serial_sc[128];
};

// A Src provides, for the block's query q and entry i of its list:
//   span(q, b, e)   the list's entries [b, e);
//   ord(i)          its ordinal, kPad for a pad;
//   key(i)          its Key;
//   load(i, tlo, thi, n_docs, lanes)
//                   warp-collective: the lanes of window i (four a thread,
//                   lane t + 32 j in slot j) with a doc in [tlo, thi) and
//                   <= n_docs, their cells doc - tlo and scores;
//   add_serial(i, tlo, thi, n_docs, tile, doc, sc)
//                   warp-collective: add them into the tile lane by lane,
//                   in lane order, by one thread (doc, sc: 128 entries of
//                   staging).
template <class Src>
__global__ void __launch_bounds__(kThreads) dense_tiles_kernel(
    const Src src, float* __restrict__ acc, int64_t stride, int n_docs,
    int tile_w, int n_tiles, const float* __restrict__ filter) {
  extern __shared__ float4 s_tile4[];
  float* s_tile = reinterpret_cast<float*>(s_tile4);
  __shared__ Scratch s;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int q = blockIdx.x / n_tiles;
  const int tlo = (blockIdx.x - q * n_tiles) * tile_w;
  const int64_t end = static_cast<int64_t>(tlo) + tile_w;
  const int thi = static_cast<int>(end < stride ? end : stride);
  const int n4 = (thi - tlo) >> 2;
  const Key pad = {kPad, 0, 0};

  auto zero_tile = [&]() {
    for (int c = t; c < n4; c += kThreads) s_tile4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  zero_tile();
  int b, e;
  src.span(q, b, e);
  __syncthreads();

  Key carry = {-1, 0, 0};  // before the list: any ordinal may follow
  bool broken = false;
  for (int c0 = b; c0 < e; c0 += kThreads) {
    const int i = c0 + t;
    const Key cur = i < e ? src.key(i) : pad;
    s.keys[t] = cur;
    __syncthreads();
    const Key prev = t ? s.keys[t - 1] : carry;
    const Key next = t + 1 < kThreads ? s.keys[t + 1] : (i + 1 < e ? src.key(i + 1) : pad);
    carry = s.keys[kThreads - 1];
    const bool real = cur.ord != kPad;
    const bool bad =
        real && (cur.bad || prev.ord == kPad || prev.ord > cur.ord ||
                 (prev.ord == cur.ord && prev.first >= cur.first));
    if (__syncthreads_or(bad)) {
      broken = true;
      break;
    }
    // The last window of its run starting at or before tlo, and the ones
    // starting inside the tile.
    const bool take =
        real && cur.first < thi && (next.ord != cur.ord || next.first > tlo);
    const unsigned m = __ballot_sync(kFull, take);
    if (lane == 0) s.counts[warp] = __popc(m);
    __syncthreads();
    int off = 0, n_sel = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s.counts[w];
      off += w < warp ? v : 0;
      n_sel += v;
    }
    if (take) {
      const int p = off + __popc(m & ((1u << lane) - 1u));
      s.sel[p] = i;
      s.sel_ord[p] = cur.ord;
    }
    __syncthreads();
    // kWarps taken windows at a time, one a warp: every warp loads its
    // window's lanes first (their loads in flight together, whatever the
    // runs), then the runs among them add in ascending ordinal order.
    for (int r0 = 0; r0 < n_sel; r0 += kWarps) {
      const int r1 = min(r0 + kWarps, n_sel);
      const int j = r0 + warp;
      Lanes ln;
      int mine = kPad;
      if (j < r1) {
        src.load(s.sel[j], tlo, thi, n_docs, ln);
        mine = s.sel_ord[j];
      }
      for (int g = r0; g < r1;) {
        const int o = s.sel_ord[g];
        if (mine == o) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (ln.cell[k] >= 0) s_tile[ln.cell[k]] = __fadd_rn(s_tile[ln.cell[k]], ln.sc[k]);
          }
        }
        __syncthreads();  // run o's adds land before a later run reads
        while (g < r1 && s.sel_ord[g] == o) ++g;
      }
    }
  }

  if (broken) {
    // Off the layout: the reference's order, one lane at a time.
    zero_tile();
    __syncthreads();
    if (warp == 0) {
      int o = -1;
      while (true) {
        int lowest = kPad;  // the next ordinal above o
        for (int i = b + lane; i < e; i += 32) {
          const int k = src.ord(i);
          if (k != kPad && k > o && k < lowest) lowest = k;
        }
#pragma unroll
        for (int d = 16; d; d >>= 1) lowest = min(lowest, __shfl_xor_sync(kFull, lowest, d));
        if (lowest == kPad) break;
        o = lowest;
        for (int i = b; i < e; ++i) {
          if (src.ord(i) == o) {
            src.add_serial(i, tlo, thi, n_docs, s_tile, s.serial_doc, s.serial_sc);
          }
        }
      }
    }
    __syncthreads();
  }

  float4* row = reinterpret_cast<float4*>(acc + static_cast<int64_t>(q) * stride + tlo);
  for (int c = t; c < n4; c += kThreads) {
    float4 v = s_tile4[c];
    if (filter != nullptr) {
      const int d = tlo + 4 * c;
      if (d <= n_docs) v.x = __fmul_rn(v.x, filter[d]);
      if (d + 1 <= n_docs) v.y = __fmul_rn(v.y, filter[d + 1]);
      if (d + 2 <= n_docs) v.z = __fmul_rn(v.z, filter[d + 2]);
      if (d + 3 <= n_docs) v.w = __fmul_rn(v.w, filter[d + 3]);
    }
    row[c] = v;
  }
}

// One launch for n_q rows of `stride` floats (a multiple of 4, rows 16-B
// aligned), tiles no wider than `tile` floats (a multiple of 4).
template <class Src>
cudaError_t launch_tiles(const Src& src, float* acc, int64_t stride, int n_docs,
                         int n_q, int tile, const float* filter, cudaStream_t s) {
  if (n_q < 0 || n_docs < 0 || stride < n_docs + 1LL || stride % 4 != 0 ||
      tile < 4 || tile % 4 != 0 || (reinterpret_cast<uintptr_t>(acc) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0) return cudaSuccess;
  // n_tiles equal tiles, each a multiple of 4 wide; no tile is empty.
  int64_t n_tiles = (stride + tile - 1) / tile;
  const int64_t tile_w = ((stride + n_tiles - 1) / n_tiles + 3) & ~int64_t{3};
  n_tiles = (stride + tile_w - 1) / tile_w;
  const int64_t blocks = static_cast<int64_t>(n_q) * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int bytes = static_cast<int>(tile_w * sizeof(float));
  // Beside the static Scratch: past 48 KB with it, the launch needs the
  // larger dynamic limit.
  const cudaError_t err = allow_dynamic_smem(dense_tiles_kernel<Src>, bytes);
  if (err != cudaSuccess) return err;
  dense_tiles_kernel<Src><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      src, acc, stride, n_docs, static_cast<int>(tile_w), static_cast<int>(n_tiles),
      filter);
  return cudaGetLastError();
}

}  // namespace tiles
}  // namespace bm25
