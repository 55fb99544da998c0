// K10 and K11: weighted histograms of u32 keys, the dense group-by tier.
//
// Replaces radix_sorting_tpu/ops/pallas_kernels.py::
//   _whist_kernel      (K10, weighted_histogram_tpu: counts and the sums of
//                       integer values) and
//   _whist_f32_kernel  (K11, weighted_histogram_f32_tpu: f32 sums, and
//                       weighted_histogram_f32_counts_tpu: counts and f32 sums
//                       from the same read).
// Contracts (keys (n,) u32, bins = 2^bits with bits in 2..17, keys >= drop_ge
// counted nowhere, drop_ge <= bins, so every key that is not dropped is a bin):
//   K10: values (n,) u32, the values' u32 conversion; counts (bins,) int32 and
//        sums (bins,) u32 with sums[b] = sum of the values of key b mod 2^32;
//   K11: weights (n,) f32; sums (bins,) f32 and, when asked for, counts
//        (bins,) int32.
//
// Bound on the H100: one read of keys and values (8 bytes a row) and no write
// per row, so the floor is n * 8 bytes over device-memory bandwidth. The TPU
// kernels summed one-hot matrix products on the MXU: K10 split the values
// into byte planes so that each product's f32 partials stayed below 2^24, and
// K11 split each weight into two bf16 halves. Here a row is two shared-memory
// atomics, and neither split is needed: integer atomics wrap mod 2^32 as the
// contract does, and f32 atomics add the f32 weight itself. Design (K1's,
// csrc/hist.cu):
//   * each block keeps a private table of sums and counts (4 + 4 bytes a bin,
//     4 without counts) in shared memory, adds its share of the rows with a
//     grid-stride loop of 16-byte loads of keys and values, then adds its
//     non-empty bins into the output with global atomics;
//   * a table past 128 KB (more than 2^14 bins with counts, 2^15 without)
//     is cut into ranges of bins, one per grid row (blockIdx.y): every row
//     reads all rows and adds only the keys in its range, so the rows are read
//     once per range (four times at 2^16 bins with counts).
// Float atomics add in an order that changes from run to run, so K11's sums
// are not bitwise repeatable; its counts, and K10's counts and sums, are.
// A non-finite weight makes only its own bin non-finite (the TPU kernel's
// products spread it to every bin). The outputs are zeroed on the stream
// before the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTableBytes = 1 << 17;   // the shared table of one block

template <class T>
struct Vec4;
template <>
struct Vec4<unsigned int> { using type = uint4; };
template <>
struct Vec4<float> { using type = float4; };

// Sum: unsigned int (K10) or float (K11); kCounts: also count the rows.
template <class Sum, bool kCounts>
__global__ void __launch_bounds__(kThreads)
whist_kernel(const uint32_t* __restrict__ keys, const Sum* __restrict__ vals,
             long long n, uint32_t drop_ge, int local_bits, int bins,
             int* __restrict__ counts, Sum* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned char table[];
  Sum* lsum = reinterpret_cast<Sum*>(table);
  int* lcnt = reinterpret_cast<int*>(lsum + (1 << local_bits));
  const uint32_t range = blockIdx.y;
  const int first_bin = static_cast<int>(range) << local_bits;
  const int local_bins = min(1 << local_bits, bins - first_bin);
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) {
    lsum[b] = Sum(0);
    if (kCounts) lcnt[b] = 0;
  }
  __syncthreads();
  const uint32_t local_mask = (1u << local_bits) - 1u;
  auto add = [&](uint32_t k, Sum v) {
    if (k >= drop_ge || (k >> local_bits) != range) return;
    atomicAdd(lsum + (k & local_mask), v);
    if (kCounts) atomicAdd(lcnt + (k & local_mask), 1);
  };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(vals)) & 15u) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  using V4 = typename Vec4<Sum>::type;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  const V4* vals4 = reinterpret_cast<const V4*>(vals);
  for (long long i = first; i < n4; i += stride) {
    const uint4 k = __ldg(keys4 + i);
    const V4 v = __ldg(vals4 + i);
    add(k.x, v.x);
    add(k.y, v.y);
    add(k.z, v.z);
    add(k.w, v.w);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) add(__ldg(keys + i), __ldg(vals + i));
  __syncthreads();
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) {
    const Sum s = lsum[b];
    if (kCounts) {
      const int c = lcnt[b];
      if (c == 0) continue;
      atomicAdd(counts + first_bin + b, c);
    }
    if (s != Sum(0)) atomicAdd(sums + first_bin + b, s);   // NaN != 0 too
  }
}

template <class Sum, bool kCounts>
int launch_whist(const void* keys, const void* vals, long long n, int bits,
                 unsigned int drop_ge, void* counts, void* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bins = 1 << bits;
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(Sum) * static_cast<size_t>(bins), s);
  if (err == cudaSuccess && kCounts) {
    err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(bins), s);
  }
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  constexpr int kBinBytes = sizeof(Sum) + (kCounts ? sizeof(int) : 0);
  int local_bits = bits;
  while ((kBinBytes << local_bits) > kTableBytes) --local_bits;
  const int ranges = bins >> local_bits;
  const int smem = kBinBytes << local_bits;
  dim3 grid;
  err = rst::wave_grid(whist_kernel<Sum, kCounts>, kThreads, smem, n, 4LL * kThreads, ranges,
                       &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  whist_kernel<Sum, kCounts><<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(keys), static_cast<const Sum*>(vals), n, drop_ge,
      local_bits, bins, static_cast<int*>(counts), static_cast<Sum*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10: counts and u32 sums of 2^bits bins.
extern "C" int rst_whist(const void* keys, const void* values, long long n, int bits,
                         unsigned int drop_ge, void* counts, void* sums, void* stream) {
  return launch_whist<unsigned int, true>(keys, values, n, bits, drop_ge, counts, sums,
                                          stream);
}

// K11: f32 sums of 2^bits bins, and counts unless `counts` is null.
extern "C" int rst_whist_f32(const void* keys, const void* weights, long long n, int bits,
                             unsigned int drop_ge, void* counts, void* sums, void* stream) {
  if (counts) {
    return launch_whist<float, true>(keys, weights, n, bits, drop_ge, counts, sums, stream);
  }
  return launch_whist<float, false>(keys, weights, n, bits, drop_ge, nullptr, sums, stream);
}
