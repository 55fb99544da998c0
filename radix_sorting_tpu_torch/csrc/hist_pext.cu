// K2 and K3: histogram of the PEXT-compacted live bits of one- or two-plane
// keys.
//
// Replaces, with one kernel, radix_sorting_tpu/ops/pallas_kernels.py::
//   _hist_pext_kernel   (K2, histogram_pext_tpu: one u32 plane) and
//   _hist_pext2_kernel  (K3, histogram_pext2_tpu: 64-bit keys as hi, lo).
// Contract: planes (n,) u32; masks with nbits set bits in all (1 to 17);
// out (2^nbits,) int32 with out[v] = #{i : value(i) == v}, where
//   value(i) = (pext(hi[i], mask_hi) << popcount(mask_lo)) | pext(lo[i], mask_lo)
// (K2 is the case mask_hi = 0 with the keys as lo). Either mask may be 0;
// a plane whose mask is 0 is not read.
//
// Bound on the H100: one 4-byte read per key and live plane and no write per
// key, so the floor is n * 4 bytes per live plane (8 for two) over
// device-memory bandwidth. The TPU kernel's factored one-hot matmul existed
// because a TPU vector unit has no scatter; here a counter increment is one
// shared-memory atomic. Design:
//   * each block keeps a private histogram of at most 2^15 int32 counters
//     (128 KB of the 227 KB a block may hold) in shared memory, counts its
//     share of the keys with a grid-stride loop of 16-byte loads of each
//     live plane, then adds its non-zero counters into the output with
//     global atomics;
//   * 2^16 and 2^17 bins (256 KB and 512 KB of counters) do not fit one
//     block, so the bins are cut into 2^15-bin ranges, one per grid row
//     (blockIdx.y): every row reads all keys and counts only those in its
//     range. The keys are read 2 or 4 times, at full bandwidth, instead of
//     paying one global atomic per key.
// The output is zeroed on the stream before the launch.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bit_runs.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLocalMaxBits = 15;

struct PextPlanes {
  rst::BitRuns hi;  // runs of mask_hi; none: the hi plane is not read
  rst::BitRuns lo;  // runs of mask_lo; none: the lo plane is not read
  int nb_lo;        // popcount(mask_lo): the shift of hi's live bits
};

template <bool kTwo>
__device__ __forceinline__ void count_key(uint32_t h, uint32_t l,
                                          const PextPlanes& p, int local_bits,
                                          uint32_t range, int* local) {
  uint32_t v = rst::pext(l, p.lo);
  if (kTwo) v |= rst::pext(h, p.hi) << p.nb_lo;
  if ((v >> local_bits) == range) {
    atomicAdd(local + (v & ((1u << local_bits) - 1u)), 1);
  }
}

// kTwo = false: one plane (K2), read as lo; hi is not read
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
hist_pext_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
                 long long n, PextPlanes p, int local_bits, int* __restrict__ hist) {
  extern __shared__ int local[];
  const int local_bins = 1 << local_bits;
  const uint32_t range = blockIdx.y;
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) local[b] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool read_hi = kTwo && p.hi.count > 0;
  const bool read_lo = !kTwo || p.lo.count > 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo)) & 15u) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const uint4* hi4 = reinterpret_cast<const uint4*>(hi);
  const uint4* lo4 = reinterpret_cast<const uint4*>(lo);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = first; i < n4; i += stride) {
    const uint4 h = read_hi ? __ldg(hi4 + i) : zero;
    const uint4 l = read_lo ? __ldg(lo4 + i) : zero;
    count_key<kTwo>(h.x, l.x, p, local_bits, range, local);
    count_key<kTwo>(h.y, l.y, p, local_bits, range, local);
    count_key<kTwo>(h.z, l.z, p, local_bits, range, local);
    count_key<kTwo>(h.w, l.w, p, local_bits, range, local);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    count_key<kTwo>(read_hi ? __ldg(hi + i) : 0u, read_lo ? __ldg(lo + i) : 0u, p,
              local_bits, range, local);
  }
  __syncthreads();
  int* out = hist + static_cast<long long>(range) * local_bins;
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) {
    const int c = local[b];
    if (c) atomicAdd(out + b, c);
  }
}

template <bool kTwo>
int launch_hist(const void* hi, const void* lo, long long n,
                unsigned int mask_hi, unsigned int mask_lo, void* hist,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb_lo = __builtin_popcount(mask_lo);
  const int nbits = __builtin_popcount(mask_hi) + nb_lo;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) << nbits, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const PextPlanes planes = {rst::make_runs(mask_hi), rst::make_runs(mask_lo), nb_lo};
  const int local_bits = std::min(nbits, kLocalMaxBits);
  const int ranges = 1 << (nbits - local_bits);
  const int smem = static_cast<int>(sizeof(int)) << local_bits;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(hist_pext_kernel<kTwo>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_pext_kernel<kTwo>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of blocks shared among the ranges; no more blocks than there
  // are 16-byte loads to give one to each thread
  const long long wave = static_cast<long long>(sms) * std::max(per_sm, 1);
  const long long want = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  const dim3 grid(static_cast<unsigned>(std::max(1LL, std::min(want, wave / ranges))),
                  static_cast<unsigned>(ranges));
  hist_pext_kernel<kTwo><<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n,
      planes, local_bits, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: one plane (the keys), read as the lo plane.
extern "C" int rst_hist_pext(const void* keys, long long n, unsigned int mask,
                             void* hist, void* stream) {
  return launch_hist<false>(keys, keys, n, 0u, mask, hist, stream);
}

// K3: two planes; either mask may be 0.
extern "C" int rst_hist_pext2(const void* hi, const void* lo, long long n,
                              unsigned int mask_hi, unsigned int mask_lo,
                              void* hist, void* stream) {
  return launch_hist<true>(mask_hi ? hi : lo, mask_lo ? lo : hi, n, mask_hi,
                           mask_lo, hist, stream);
}

// Shared by every kernel of the library: the text of a returned error code.
extern "C" const char* rst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
