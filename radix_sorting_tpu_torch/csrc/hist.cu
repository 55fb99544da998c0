// K1, K2 and K3: histograms of one- or two-plane keys in one read.
//
// Replaces, with one kernel, radix_sorting_tpu/ops/pallas_kernels.py::
//   _hist_kernel        (K1, histogram_tpu and multi_digit_histogram_tpu:
//                        digit histograms of u32 keys, P passes in one read),
//   _hist_pext_kernel   (K2, histogram_pext_tpu: one u32 plane) and
//   _hist_pext2_kernel  (K3, histogram_pext2_tpu: 64-bit keys as hi, lo).
// Contracts (planes (n,) u32, out int32):
//   K2/K3: masks with nbits set bits in all (1 to 17); out (2^nbits,) with
//     out[v] = #{i : value(i) == v}, where
//     value(i) = (pext(hi[i], mask_hi) << popcount(mask_lo)) | pext(lo[i], mask_lo)
//     (K2 is the case mask_hi = 0 with the keys as lo). Either mask may be 0;
//     a plane whose mask is 0 is not read.
//   K1: r-bit digits (r in 1..18), P passes from bit `shift` on (P * 2^r
//     <= 2^19, shift + (P - 1) * r < 32); with u(i) = keys[i] - offset
//     (mod 2^32), keys with u(i) >= drop_ge counted in no pass (drop_ge up
//     to 2^32: none dropped); out (P, 2^r) with
//     out[p][d] = #{i : u(i) < drop_ge and (u(i) >> (shift + p * r)) & (2^r - 1) == d}.
//     offset is the dense range probe's minimum, subtracted on the read so
//     that `keys - min` is never written out.
//
// Bound on the H100: one 4-byte read per key and live plane and no write per
// key, so the floor is n * 4 bytes per live plane (8 for two) over
// device-memory bandwidth. The TPU kernels' factored one-hot matmul existed
// because a TPU vector unit has no scatter; here a counter increment is one
// shared-memory atomic. Design:
//   * each block keeps a private histogram of at most 2^15 int32 counters
//     (128 KB of the 227 KB a block may hold) in shared memory, counts its
//     share of the keys with a grid-stride loop of 16-byte loads of each
//     live plane, then adds its non-zero counters into the output with
//     global atomics;
//   * more counters than that (K2/K3 at 2^16 and 2^17 bins, K1 at 16 to 18
//     bits or P * 2^r > 2^15) do not fit one block, so the counters are cut
//     into 2^15-counter ranges, one per grid row (blockIdx.y): every row
//     reads all keys and counts only those in its range. The keys are read
//     once per range (8 times at 2^18 bins), at full bandwidth, instead of
//     paying one global atomic per key;
//   * K1's P passes are P counters per key into P consecutive histograms of
//     the same shared array (the fused first pass of radix_sort_u32.c:24-37).
// Keys that all fall in one bin put every increment of a warp on one shared
// address; chip_smoke.py times such a case (90% of the keys one value) beside
// the uniform one. The output is zeroed on the stream before the launch.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bit_runs.cuh"
#include "grid.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLocalMaxBits = 15;

// K2 (kTwo = false: one plane, read as lo) and K3: one counter per key, the
// PEXT-compacted live bits.
template <bool kTwo>
struct PextCount {
  rst::BitRuns hi;  // runs of mask_hi; none: the hi plane is not read
  rst::BitRuns lo;  // runs of mask_lo; none: the lo plane is not read
  int nb_lo;        // popcount(mask_lo): the shift of hi's live bits

  __device__ __forceinline__ bool reads_hi() const { return kTwo && hi.count > 0; }
  __device__ __forceinline__ bool reads_lo() const { return !kTwo || lo.count > 0; }
  template <class Add>
  __device__ __forceinline__ void operator()(uint32_t h, uint32_t l, Add add) const {
    uint32_t v = rst::pext(l, lo);
    if (kTwo) v |= rst::pext(h, hi) << nb_lo;
    add(v);
  }
};

// K1: P digit counters per key (one plane, read as lo), into P consecutive
// 2^bits-counter histograms.
struct DigitCount {
  uint32_t offset;             // subtracted from every key
  unsigned long long drop_ge;  // keys - offset >= this count nowhere
  int shift;                   // bit of the first pass's digit
  int bits;                    // digit width r
  int passes;                  // P
  uint32_t digit_mask;         // 2^r - 1

  __device__ __forceinline__ bool reads_hi() const { return false; }
  __device__ __forceinline__ bool reads_lo() const { return true; }
  template <class Add>
  __device__ __forceinline__ void operator()(uint32_t, uint32_t w, Add add) const {
    const uint32_t u = w - offset;
    if (u >= drop_ge) return;
    for (int p = 0; p < passes; ++p) {
      add((static_cast<uint32_t>(p) << bits) | ((u >> (shift + p * bits)) & digit_mask));
    }
  }
};

// total counters, cut into ranges of 2^local_bits (the last may be short)
template <class Count>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
            long long n, Count count, int local_bits, int total, int* __restrict__ hist) {
  extern __shared__ int local[];
  const uint32_t range = blockIdx.y;
  const int first_counter = static_cast<int>(range) << local_bits;
  const int local_bins = min(1 << local_bits, total - first_counter);
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) local[b] = 0;
  __syncthreads();
  const uint32_t local_mask = (1u << local_bits) - 1u;
  auto add = [&](uint32_t c) {
    if ((c >> local_bits) == range) atomicAdd(local + (c & local_mask), 1);
  };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool read_hi = count.reads_hi();
  const bool read_lo = count.reads_lo();
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(hi) | reinterpret_cast<uintptr_t>(lo)) & 15u) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const uint4* hi4 = reinterpret_cast<const uint4*>(hi);
  const uint4* lo4 = reinterpret_cast<const uint4*>(lo);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = first; i < n4; i += stride) {
    const uint4 h = read_hi ? __ldg(hi4 + i) : zero;
    const uint4 l = read_lo ? __ldg(lo4 + i) : zero;
    count(h.x, l.x, add);
    count(h.y, l.y, add);
    count(h.z, l.z, add);
    count(h.w, l.w, add);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    count(read_hi ? __ldg(hi + i) : 0u, read_lo ? __ldg(lo + i) : 0u, add);
  }
  __syncthreads();
  int* out = hist + first_counter;
  for (int b = threadIdx.x; b < local_bins; b += blockDim.x) {
    const int c = local[b];
    if (c) atomicAdd(out + b, c);
  }
}

template <class Count>
int launch_hist(const void* hi, const void* lo, long long n, const Count& count,
                int total, void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * static_cast<size_t>(total), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  int total_bits = 0;
  while ((1 << total_bits) < total) ++total_bits;
  const int local_bits = std::min(total_bits, kLocalMaxBits);
  const int ranges = (total + (1 << local_bits) - 1) >> local_bits;
  const int smem = static_cast<int>(sizeof(int)) << local_bits;
  dim3 grid;
  err = rst::wave_grid(hist_kernel<Count>, kThreads, smem, n, ranges, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_kernel<Count><<<grid, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n, count,
      local_bits, total, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: `passes` digit histograms of the keys, (passes, 2^bits) int32.
extern "C" int rst_hist(const void* keys, long long n, unsigned int offset, int shift,
                        int bits, int passes, unsigned long long drop_ge, void* hist,
                        void* stream) {
  const DigitCount count = {offset, drop_ge, shift, bits, passes, (1u << bits) - 1u};
  return launch_hist(keys, keys, n, count, passes << bits, hist, stream);
}

// K2: one plane (the keys), read as the lo plane.
extern "C" int rst_hist_pext(const void* keys, long long n, unsigned int mask,
                             void* hist, void* stream) {
  const PextCount<false> count = {rst::make_runs(0u), rst::make_runs(mask), 0};
  return launch_hist(keys, keys, n, count, 1 << __builtin_popcount(mask), hist, stream);
}

// K3: two planes; either mask may be 0.
extern "C" int rst_hist_pext2(const void* hi, const void* lo, long long n,
                              unsigned int mask_hi, unsigned int mask_lo,
                              void* hist, void* stream) {
  const int nb_lo = __builtin_popcount(mask_lo);
  const PextCount<true> count = {rst::make_runs(mask_hi), rst::make_runs(mask_lo), nb_lo};
  return launch_hist(mask_hi ? hi : lo, mask_lo ? lo : hi, n, count,
                     1 << (__builtin_popcount(mask_hi) + nb_lo), hist, stream);
}

// Shared by every kernel of the library: the text of a returned error code.
extern "C" const char* rst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
