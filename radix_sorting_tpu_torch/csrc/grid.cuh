// The launch shape of the histogram kernels (hist.cu, whist.cu).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace rst {

// One wave of `kernel`'s blocks of `threads` threads and `smem` bytes of
// dynamic shared memory: the SMs times the blocks that fit one. The first
// call for a (device, kernel, threads, smem) raises the kernel's dynamic
// shared-memory limit to the device's most, so that no launch lowers it
// under another's shape, and asks the occupancy API; later calls read the
// answer kept then, since the query costs host time that a call of a few
// tens of microseconds feels.
inline cudaError_t wave_of(const void* kernel, int threads, int smem, long long* wave) {
  struct Wave {
    int dev;
    const void* kernel;
    int threads, smem;
    long long wave;
  };
  static Wave kept[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Wave& w = kept[i];
    if (w.dev == dev && w.kernel == kernel && w.threads == threads && w.smem == smem) {
      *wave = w.wave;
      return cudaSuccess;
    }
  }
  int sms = 0, most = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = static_cast<long long>(sms) * per_sm;
  if (used < 64) kept[used++] = Wave{dev, kernel, threads, smem, *wave};
  return cudaSuccess;
}

// One wave of blocks shared among `ranges` grid rows (counter ranges), and
// no more blocks in a row than there are chunks of `chunk` keys in `n` (a
// chunk: the keys one block reads in one step).
template <class Kernel>
cudaError_t wave_grid(Kernel kernel, int threads, int smem, long long n, long long chunk,
                      int ranges, dim3* grid) {
  long long wave = 0;
  const cudaError_t err = wave_of(reinterpret_cast<const void*>(kernel), threads, smem, &wave);
  if (err != cudaSuccess) return err;
  const long long want = (n + chunk - 1) / chunk;
  *grid = dim3(static_cast<unsigned>(std::max(1LL, std::min(want, wave / ranges))),
               static_cast<unsigned>(ranges));
  return cudaSuccess;
}

}  // namespace rst
