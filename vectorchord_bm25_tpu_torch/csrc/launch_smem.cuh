// The dynamic shared-memory limit of a launch (sm_90a).
//
// A block may use 48 KB of shared memory, static and dynamic together,
// unless its kernel's dynamic limit is raised with
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes).  A kernel with static __shared__ arrays therefore needs the raise
// as soon as its dynamic bytes plus its static bytes pass 48 KB, not only
// when the dynamic bytes alone do: a launch whose dynamic bytes alone fit
// is otherwise refused (cudaErrorInvalidValue) in a process that has not
// raised the limit before.  Every launch of the port that takes dynamic
// shared memory calls allow_dynamic_smem first.
#pragma once

#include <cuda_runtime.h>

namespace bm25 {

// The default limit of a block's shared memory, static and dynamic together.
constexpr long long kDefaultSmemLimit = 48 * 1024;

// Lets `kernel` launch with `dynamic_bytes` of dynamic shared memory: reads
// its static bytes (cudaFuncGetAttributes' sharedSizeBytes) and, where the
// two pass 48 KB and the kernel's current limit is below `dynamic_bytes`,
// raises the limit to all that the device grants a block beside the static
// bytes.  The raised limit is the same whatever the launch asks, so calls
// from several host threads never lower it under one another.  Returns the
// CUDA error (cudaErrorInvalidValue where the device cannot grant the
// bytes); it never swallows one.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, long long dynamic_bytes) {
  if (dynamic_bytes <= 0) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long static_bytes = static_cast<long long>(attr.sharedSizeBytes);
  if (dynamic_bytes + static_bytes <= kDefaultSmemLimit) return cudaSuccess;
  // Raised before (by this function: past the default, whatever the default
  // counts) and high enough.
  if (attr.maxDynamicSharedSizeBytes > kDefaultSmemLimit &&
      dynamic_bytes <= attr.maxDynamicSharedSizeBytes) {
    return cudaSuccess;
  }
  int device = 0;
  int optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const long long limit = optin - static_bytes;
  if (dynamic_bytes > limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(limit));
}

}  // namespace bm25
