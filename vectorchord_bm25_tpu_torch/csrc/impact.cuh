// Posting impacts as the kernels over precomputed scores read them (sm_90a;
// score_kernel.cu and the exact engine's three): f32, or bf16 widened to f32
// (`impact_dtype="bfloat16"`; `__bfloat162float` is exact, as the
// reference's `.astype(jnp.float32)` is).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bm25 {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Posting rows are 128 lanes wide (index/sealed.py BLOCK); a warp takes one
// row window, thread t the lanes t, t + 32, t + 64 and t + 96, so each of
// its four loads is one coalesced 128-B (64-B for bf16) line.
constexpr int kRowLanes = 128;
constexpr int kRowLanesPerThread = kRowLanes / 32;
constexpr int kExactThreads = 128;
constexpr int kExactWarpsPerBlock = kExactThreads / 32;

__device__ __forceinline__ int row_lane(int j) {
  return j * 32 + static_cast<int>(threadIdx.x & 31);
}

}  // namespace bm25
