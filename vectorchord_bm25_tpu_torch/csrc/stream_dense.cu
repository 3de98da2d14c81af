// Window decompress, score and accumulate for the stream engine's dense
// path (sm_90a).
//
// Replaces the XLA-lowered reference kernels M1
// vectorchord_bm25_tpu/search/stream.py::_unpack_and_score (:171-266) and
// the zero-fill and scatter-add of M2 _stream_dense (:296-303).  For each
// query row q, each window w of q's span [q_start[q], q_start[q + 1]) of
// the window list, and each lane l < len(w),
//
//     doc = w_base[w] + sum_{0 < j <= l} delta_j
//     acc[q * stride + doc] += (tf_l * s0[w]) / (tf_l + s1_eff[doc])
//
// into an accumulator that starts at zero; windows outside every span (the
// bucket's pad windows) add nothing.
//
// Design.  The doc-tile walk of dense_tiles.cuh: a block owns a tile of one
// query's row in shared memory, takes the windows of each term-ordinal run
// whose docs can fall in it, and writes the row's cells once.  A taken
// window is decoded by one warp, four lanes a thread (window_decode.cuh,
// shared with S3 and S5), and only its lanes inside the tile gather their
// s1_eff entry and add.  The list is the planning's own, query-major and
// term-major (search/stream.py::_layout, window_ordinals): each run is
// one term's windows, consecutive in the stream and doc-ascending, so a
// window's first doc is w_base[w] and the host sorts nothing.  The first
// version launched once per ordinal onto a zero-filled accumulator, one
// warp a window and a 4-B read-add-write a lane into device memory: the
// fill alone (0.33 ms of 0.78 at [2048, 131073]) cost its whole bound.
//
// Exactness.  As dense_tiles.cuh: ascending ordinals, plain read-add-
// writes in shared memory, `posting_score`'s explicit round-to-nearest
// arithmetic and no --use_fast_math, so every cell equals the reference's
// f32 sum bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tiles.cuh"
#include "window_decode.cuh"

namespace {

using bm25::tiles::Key;
using bm25::tiles::kPad;

struct StreamSrc {
  const uint32_t* __restrict__ words;   // [S]
  const float* __restrict__ s1_eff;     // [N+1]
  const int32_t* __restrict__ w_off;    // [W+1]
  const int32_t* __restrict__ w_base;   // [W+1]
  const uint16_t* __restrict__ w_meta;  // [W+1]
  const float* __restrict__ w_s0;       // [W+1]
  const int32_t* __restrict__ wsrc;     // [T] window ids
  const int32_t* __restrict__ q_start;  // [n_q + 1] each query's span of wsrc
  const int32_t* __restrict__ w_ord;    // [T] term ordinal, < 0: a pad
  int n_list;                           // T

  __device__ __forceinline__ void span(int q, int& b, int& e) const {
    b = min(max(q_start[q], 0), n_list);
    e = min(max(q_start[q + 1], b), n_list);
  }

  __device__ __forceinline__ int ord(int i) const {
    const int o = w_ord[i];
    return o < 0 ? kPad : o;
  }

  __device__ __forceinline__ Key key(int i) const {
    Key k;
    k.ord = ord(i);
    k.first = k.ord == kPad ? 0 : w_base[wsrc[i]];
    k.bad = 0;
    return k;
  }

  // Decodes window i: its lanes inside [tlo, thi) and <= n_docs.
  __device__ __forceinline__ void load(int i, int tlo, int thi, int n_docs,
                                       bm25::tiles::Lanes& out) const {
    const bm25::Window win = bm25::load_window(w_off, w_base, w_meta, w_s0, wsrc[i]);
    int doc[bm25::kLanesPerThread];
    float tf[bm25::kLanesPerThread];
    bm25::decode_lanes(words, win, doc, tf);
    float s1[bm25::kLanesPerThread];
#pragma unroll
    for (int j = 0; j < bm25::kLanesPerThread; ++j) {
      const bool live = bm25::lane_of(j) < win.len && doc[j] >= tlo && doc[j] < thi &&
                        doc[j] <= n_docs;
      out.cell[j] = live ? doc[j] - tlo : -1;
      if (live) s1[j] = s1_eff[doc[j]];
    }
#pragma unroll
    for (int j = 0; j < bm25::kLanesPerThread; ++j) {
      if (out.cell[j] >= 0) out.sc[j] = bm25::posting_score(tf[j], win.s0, s1[j]);
    }
  }

  __device__ __forceinline__ void add_serial(int i, int tlo, int thi, int n_docs,
                                             float* tile, int* s_doc, float* s_sc) const {
    bm25::tiles::Lanes ln;
    load(i, tlo, thi, n_docs, ln);
#pragma unroll
    for (int j = 0; j < bm25::kLanesPerThread; ++j) {
      s_doc[bm25::lane_of(j)] = ln.cell[j];
      s_sc[bm25::lane_of(j)] = ln.cell[j] >= 0 ? ln.sc[j] : 0.0f;
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      for (int l = 0; l < bm25::kWindowLanes; ++l) {
        if (s_doc[l] >= 0) tile[s_doc[l]] = __fadd_rn(tile[s_doc[l]], s_sc[l]);
      }
    }
    __syncwarp();
  }
};

}  // namespace

// acc: [n_q, stride] f32, rows 16-B aligned, stride a multiple of 4 and
// >= n_docs + 1; every cell is written.  tile: the widest doc tile a block
// owns, in floats (a multiple of 4).
extern "C" int bm25_stream_dense_accumulate(
    const void* words, const void* s1_eff, const void* w_off,
    const void* w_base, const void* w_meta, const void* w_s0,
    const void* wsrc, const void* q_start, const void* w_ord, void* acc,
    int n_list, long long stride, int n_q, int n_docs, int tile, void* stream) {
  if (n_list < 0) return static_cast<int>(cudaErrorInvalidValue);
  const StreamSrc src{
      static_cast<const uint32_t*>(words), static_cast<const float*>(s1_eff),
      static_cast<const int32_t*>(w_off), static_cast<const int32_t*>(w_base),
      static_cast<const uint16_t*>(w_meta), static_cast<const float*>(w_s0),
      static_cast<const int32_t*>(wsrc), static_cast<const int32_t*>(q_start),
      static_cast<const int32_t*>(w_ord), n_list};
  return static_cast<int>(bm25::tiles::launch_tiles(
      src, static_cast<float*>(acc), static_cast<int64_t>(stride), n_docs, n_q,
      tile, nullptr, static_cast<cudaStream_t>(stream)));
}
