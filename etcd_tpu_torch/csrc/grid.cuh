// The persistent grid of a kernel of the port: how many blocks of it the
// current device holds at once, SMs x the blocks an SM fits at the given
// dynamic shared memory.  The device queries, the kernel's shared-memory
// limit (raised to the device's opt-in maximum, the same for every size)
// and the occupancy query run once per (kernel, device, bytes); later
// launches read the count from a cache.  Included by raw_crc.cu and
// planes_crc.cu; crc_cuda.library_path hashes it into every build.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                            int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple((const void*)kernel, dev, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, optin = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.emplace(key, sms * per_sm);
  *blocks = sms * per_sm;
  return cudaSuccess;
}

}  // namespace
