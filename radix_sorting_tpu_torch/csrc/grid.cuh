// The launch shape of the histogram kernels (hist.cu, whist.cu).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace rst {

// Sets `smem` bytes of dynamic shared memory for `kernel` and gives it one
// wave of `threads`-thread blocks shared among `ranges` grid rows (counter
// ranges), and no more blocks in a row than there are 16-byte loads of `n`
// keys to give one to each thread.
template <class Kernel>
cudaError_t wave_grid(Kernel kernel, int threads, int smem, long long n, int ranges,
                      dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long wave = static_cast<long long>(sms) * std::max(per_sm, 1);
  const long long want = (n + 4LL * threads - 1) / (4LL * threads);
  *grid = dim3(static_cast<unsigned>(std::max(1LL, std::min(want, wave / ranges))),
               static_cast<unsigned>(ranges));
  return cudaSuccess;
}

}  // namespace rst
