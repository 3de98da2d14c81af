// Block-max pass and candidate gather of the hierarchical dense top-k
// (sm_90a).
//
// Replaces the XLA-lowered reference op vectorchord_bm25_tpu/ops/topk.py::
// dense_topk (:31-91), hierarchical from 2^17 docs (:53).  Both kernels
// write packed int64 keys whose ascending order is (score desc, id asc):
//
//     key = (score > 0 ? 0x7F800000 - f32_bits(score) : 0x7F800000) << 32 | id
//
// (the f32 bits of a positive score order like the score).  The two small
// selections between and after them run as torch.topk on these keys in the
// wrapper (ops/topk.py), as the reference runs its selections outside any
// Pallas kernel; distinct keys make the selection order-exact, which
// torch.topk on the scores alone would not be.
//
// block_max_keys (pass 1).  One warp per (query, 1024-doc block): 16-B
// loads, neighbouring lanes on neighbouring addresses, the score > 0 mask
// fused into the max, a shuffle reduction, one key per block with the block
// id as its low half.  It reads the whole [Q, M] accumulator once (1.07 GB
// for a [2048, 131073] dispatch) for one compare and one max a value, so it
// is bound by device-memory bandwidth; the 16-B loads need rows that start
// 16-B aligned, which the wrapper checks (the accumulator's row stride is
// padded to a multiple of 4 floats).
//
// gather_keys (pass 3).  One thread per output key of the flattened
// [Q, width] keys: the first kb * block keys of a row come from the kb
// chosen blocks (ascending block ids, so positions follow doc order), the
// rest from the ragged tail [tail_start,
// tail_start + tail_len), which alone is also masked to docs < n_docs, as in
// the reference.  With kb = 0 and tail_start = 0 it builds the keys of the
// reference's small-corpus branch (one masked top-k over the first n_docs
// columns).  Reads kb * block + tail_len floats a row and writes twice that
// in keys: bandwidth-bound too, at about 1/8 of pass 1's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInfBits = 0x7F800000u;
constexpr int kWarpsPerBlock = 8;
constexpr int kGatherThreads = 256;

__device__ __forceinline__ long long pack_key(float v, long long id) {
  const uint32_t hi = v > 0.0f ? kInfBits - __float_as_uint(v) : kInfBits;
  return (static_cast<long long>(hi) << 32) | id;
}

__device__ __forceinline__ float masked(float v) {
  return v > 0.0f ? v : -__int_as_float(0x7F800000);
}

__global__ void block_max_keys_kernel(const float* __restrict__ acc,
                                      long long* __restrict__ bkeys,
                                      int n_q, int n_blocks, int64_t stride,
                                      int block) {
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(n_q) * n_blocks) return;
  const int q = static_cast<int>(warp / n_blocks);
  const int b = static_cast<int>(warp - static_cast<int64_t>(q) * n_blocks);
  const float4* row = reinterpret_cast<const float4*>(
      acc + static_cast<int64_t>(q) * stride + static_cast<int64_t>(b) * block);
  float best = masked(0.0f);
  for (int i = lane; i < block / 4; i += 32) {
    const float4 v = __ldcs(row + i);  // streamed once: evict first
    best = fmaxf(best, fmaxf(fmaxf(masked(v.x), masked(v.y)),
                             fmaxf(masked(v.z), masked(v.w))));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(0xFFFFFFFFu, best, d));
  }
  if (lane == 0) bkeys[warp] = pack_key(best, b);
}

__global__ void gather_keys_kernel(const float* __restrict__ acc,
                                   const int32_t* __restrict__ bi,
                                   long long* __restrict__ keys, int64_t total,
                                   int kb, int block, int tail_start,
                                   int tail_len, int n_docs, int64_t stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= total) return;
  const int width = kb * block + tail_len;
  const int q = static_cast<int>(i / width);
  const int pos = static_cast<int>(i - static_cast<int64_t>(q) * width);
  int doc;
  bool ok = true;
  if (pos < kb * block) {
    const int j = pos / block;
    doc = bi[static_cast<int64_t>(q) * kb + j] * block + (pos - j * block);
  } else {
    doc = tail_start + (pos - kb * block);
    ok = doc < n_docs;
  }
  const float v = acc[static_cast<int64_t>(q) * stride + doc];
  keys[i] = pack_key(ok ? v : 0.0f, doc);
}

}  // namespace

extern "C" int bm25_block_max_keys(const void* acc, void* bkeys, int n_q,
                                   int n_blocks, long long stride, int block,
                                   void* stream) {
  if (block <= 0 || block % 128 || stride % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long warps = static_cast<long long>(n_q) * n_blocks;
  if (warps == 0) return 0;
  const long long grid = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  block_max_keys_kernel<<<static_cast<unsigned int>(grid), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<long long*>(bkeys), n_q,
      n_blocks, static_cast<int64_t>(stride), block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm25_gather_keys(const void* acc, const void* bi, void* keys,
                                int n_q, int kb, int block, int tail_start,
                                int tail_len, int n_docs, long long stride,
                                void* stream) {
  if (kb < 0 || block <= 0 || tail_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total =
      static_cast<long long>(n_q) * (static_cast<long long>(kb) * block + tail_len);
  if (total == 0) return 0;
  const long long grid = (total + kGatherThreads - 1) / kGatherThreads;
  gather_keys_kernel<<<static_cast<unsigned int>(grid), kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const int32_t*>(bi),
      static_cast<long long*>(keys), static_cast<int64_t>(total), kb, block,
      tail_start, tail_len, n_docs, static_cast<int64_t>(stride));
  return static_cast<int>(cudaGetLastError());
}
