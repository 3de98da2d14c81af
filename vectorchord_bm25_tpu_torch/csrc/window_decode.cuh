// Window decode and posting score shared by the stream kernels (sm_90a):
// S1 stream_dense.cu, S3 stream_sparse.cu, S5 stream_rescore.cu and
// SP-stream sparse_merge.cu.
//
// The device half of the reference's M1
// vectorchord_bm25_tpu/search/stream.py::_unpack_and_score (:171-266).  A
// window of the compressed stream (index/stream.py) holds up to 128
// postings: meta m gives len = m & 0xFF, dbits = 2 << ((m >> 8) & 3) and
// tfbits = tclass ? 1 << tclass : 0 with tclass = (m >> 10) & 7.  Lane l's
// doc delta sits at bit l * dbits of the window's words (widths divide 32,
// so a value never straddles two words); lane 0's delta is 0 and
//
//     doc_l = base + sum_{0 < j <= l} delta_j.
//
// The tf words follow the doc words at word off + ((len * dbits + 31) >> 5);
// tfbits = 0 means every tf is 1.  Widths are read at run time, so one
// kernel serves every width class where the TPU kernel specialised
// statically.
//
// One warp decodes one window: thread t holds lanes t, t+32, t+64 and t+96,
// so each of the warp's loads and stores covers 32 neighbouring lanes (the
// stream words they read are contiguous, the docs they touch close
// together).  Per group of 32 lanes a warp-shuffle inclusive scan of the
// deltas, plus the running total of the groups before it, gives the doc
// ids.  Integer adds, so the order is moot.  Only live lanes touch the
// stream words.

#pragma once

#include <stdint.h>

namespace bm25 {

constexpr int kWindowLanes = 128;
constexpr int kLanesPerThread = kWindowLanes / 32;

struct Window {
  uint32_t off;     // first doc word
  uint32_t len;     // live lanes
  uint32_t dbits;   // doc delta width
  uint32_t tfbits;  // tf width, 0 = every tf is 1
  int base;         // doc id of lane 0
  float s0;         // the term's score numerator factor
};

__device__ __forceinline__ Window load_window(
    const int32_t* __restrict__ w_off, const int32_t* __restrict__ w_base,
    const uint16_t* __restrict__ w_meta, const float* __restrict__ w_s0,
    int w) {
  const uint32_t m = w_meta[w];
  const uint32_t tclass = (m >> 10) & 7u;
  Window win;
  win.off = static_cast<uint32_t>(w_off[w]);
  win.len = m & 0xFFu;
  win.dbits = 2u << ((m >> 8) & 3u);
  win.tfbits = tclass ? (1u << tclass) : 0u;
  win.base = w_base[w];
  win.s0 = w_s0[w];
  return win;
}

__device__ __forceinline__ uint32_t lane_bits(
    const uint32_t* __restrict__ words, uint32_t first_word, uint32_t lane,
    uint32_t bits) {
  const uint32_t pos = lane * bits;
  return (words[first_word + (pos >> 5)] >> (pos & 31u)) & ((1u << bits) - 1u);
}

// The lane that thread t (= threadIdx.x & 31) holds in group j.
__device__ __forceinline__ uint32_t lane_of(int j) {
  return (threadIdx.x & 31u) + 32u * j;
}

// Decodes lanes lane_of(0..3) of `win`.  Every thread of the warp must call
// it (the scans shuffle across the warp).  Dead lanes (>= len) get doc =
// base + the live prefix's sum and tf = 1: callers test
// `lane_of(j) < win.len` themselves.
__device__ __forceinline__ void decode_lanes(
    const uint32_t* __restrict__ words, const Window& win, int doc[4],
    float tf[4]) {
  const uint32_t t = threadIdx.x & 31u;
  const uint32_t toff = win.off + ((win.len * win.dbits + 31u) >> 5);
  uint32_t before = 0;  // the deltas of the groups before this one
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const uint32_t l = lane_of(j);
    uint32_t sum = (l > 0 && l < win.len) ? lane_bits(words, win.off, l, win.dbits) : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, sum, d);
      if (t >= static_cast<uint32_t>(d)) sum += up;
    }
    doc[j] = win.base + static_cast<int>(before + sum);
    before += __shfl_sync(0xFFFFFFFFu, sum, 31);
    tf[j] = (win.tfbits && l < win.len)
                ? static_cast<float>(lane_bits(words, toff, l, win.tfbits))
                : 1.0f;
  }
}

// (tf * s0) / (tf + s1) with explicit round-to-nearest intrinsics: nothing
// is contracted or approximated, whatever the flags, so every posting
// equals the reference's f32 value bit for bit.  s1 = +inf (deleted,
// filtered, pad) gives exactly 0.0.
__device__ __forceinline__ float posting_score(float tf, float s0, float s1) {
  return __fdiv_rn(__fmul_rn(tf, s0), __fadd_rn(tf, s1));
}

}  // namespace bm25
