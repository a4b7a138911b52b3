// resident_grid: the grid of a persistent kernel, as many blocks as the
// card's SMs hold, and allow_smem, a kernel's dynamic shared-memory limit;
// shared by the kernels' plain C entry points.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int SMEM_LIMIT = 232448;  // bytes a block can use on sm_90

// The launch set-up of one kernel, made once: its shared-memory attributes
// on each device, and the blocks the card holds at each (threads, bytes) it
// was launched with.  Guarded by a mutex: ctypes calls run without the GIL.
struct LaunchCache {
  std::mutex m;
  uint64_t ready = 0;  // bit d: attributes set on device d
  int n = 0;
  int dev[32], threads[32], smem[32], resident[32];
};

// Blocks for `work` items of a persistent kernel: as many as the SMs hold.
// The kernel may take up to SMEM_LIMIT bytes of dynamic shared memory, and
// asks for the SM's largest shared-memory share, so that as many blocks as
// fit are resident.
template <typename Kern>
cudaError_t allow_smem_locked(Kern kern, LaunchCache& c, int dev) {
  if (dev < 64 && (c.ready >> dev & 1)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) c.ready |= uint64_t{1} << dev;
  return err;
}

// Let `kern` take up to SMEM_LIMIT bytes of dynamic shared memory on the
// current device (once per device).
template <typename Kern>
cudaError_t allow_smem(Kern kern, LaunchCache& c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(c.m);
  return allow_smem_locked(kern, c, dev);
}

template <typename Kern>
cudaError_t resident_grid(Kern kern, LaunchCache& c, int threads, int smem, int64_t work, int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(c.m);
  err = allow_smem_locked(kern, c, dev);
  if (err != cudaSuccess) return err;
  int resident = 0;
  for (int i = 0; i < c.n && !resident; ++i)
    if (c.dev[i] == dev && c.threads[i] == threads && c.smem[i] == smem) resident = c.resident[i];
  if (!resident) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident = (per_sm < 1 ? 1 : per_sm) * sms;
    if (c.n < 32) {
      c.dev[c.n] = dev, c.threads[c.n] = threads, c.smem[c.n] = smem, c.resident[c.n] = resident;
      ++c.n;
    }
  }
  grid = static_cast<int>(work < resident ? work : resident);
  return cudaSuccess;
}

}  // namespace
