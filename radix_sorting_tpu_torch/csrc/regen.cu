// K4 to K9: rewrite the sorted keys from their cumulative histogram, as dense
// values or as masked keys in one plane or two.
//
// Replaces, with one kernel, radix_sorting_tpu/ops/pallas_kernels.py::
//   _regen_kernel            (K4, regenerate_tpu, 4 to 2^10 bins),
//   _regen_win_kernel        (K7, regenerate_windowed_tpu, 2^11 to 2^17),
//   _regen_pdep_kernel       (K5, regenerate_pdep_tpu, 4 to 2^10 bins),
//   _regen_pdep_win_kernel   (K8, regenerate_pdep_windowed_tpu, 2^11 to 2^17),
//   _regen_pdep2_kernel      (K6, regenerate_pdep2_tpu: K5 into hi, lo) and
//   _regen_pdep2_win_kernel  (K9, regenerate_pdep2_windowed_tpu: K8 into two).
// Contract: cum (bins,) int32, the inclusive prefix sum of the histogram of
// the compacted keys (non-decreasing, cum[bins-1] == n); with
// v(j) = #{b : cum[b] <= j}, out (n,) u32 per plane:
//   dense (K4, K7): out[j]    = v(j) + offset (mod 2^32; offset is the dense
//                               range probe's minimum, added on the store);
//   one plane:      out[j]    = pdep(v(j), mask) | (plane[0] & ~mask);
//   two planes:     out_lo[j] = pdep(v(j) & ((1 << nb_lo) - 1), mask_lo) | (lo[0] & ~mask_lo),
//                   out_hi[j] = pdep(v(j) >> nb_lo, mask_hi)            | (hi[0] & ~mask_hi),
// with nb_lo = popcount(mask_lo); plane[0] is any key: the bits outside the
// mask are the same in all.
//
// Bound on the H100: one 4-byte write per key and plane and nothing read
// per key but the cum vector (at most 512 KB, resident in L2), so the floor
// is n * 4 bytes per plane over device-memory bandwidth. The TPU kernels
// compared every position with every bin (K4, K5, K6) or with a fixed VMEM
// window of bins (K7, K8, K9, with a sorter fallback when a block's bins
// overran the window). Here v(j) is an upper-bound binary search over cum.
// A block covers kTile consecutive positions; two threads find the bins of
// its first and last position (two searches of log2(bins) dependent loads,
// amortised over the tile), and every thread then searches only between
// them, a handful of bins for uniform keys. No window has to fit, so every
// distribution is served and the fallback is gone. A thread writes kSteps
// groups of four consecutive positions per plane, each as one 16-byte
// store; a warp's stores of one step are contiguous. The dense form is the
// PDEP form with the identity for PDEP and no dead bits, compiled apart.
#include <cuda_runtime.h>

#include <cstdint>

#include "bit_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;       // consecutive positions per 16-byte store
constexpr int kSteps = 4;     // stores per thread and plane
constexpr int kTile = kThreads * kVec * kSteps;

enum class Out { kDense, kPdep, kPdep2 };

struct RegenPlanes {
  rst::BitRuns hi;   // runs of mask_hi (two-plane keys only)
  rst::BitRuns lo;   // runs of mask_lo, or of the one plane's mask
  int nb_lo;         // popcount(mask_lo): v >> nb_lo goes to the hi plane
  uint32_t dead_hi;  // ~mask_hi
  uint32_t dead_lo;  // ~mask_lo
  uint32_t offset;   // dense values only: added to v
};

// first index in [lo, hi) whose cum exceeds j, or hi if none does
__device__ __forceinline__ int first_above(const int* __restrict__ cum, int lo,
                                           int hi, int j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cum + mid) <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ out, long long j0,
                                       int n, bool aligned, const uint32_t* o) {
  if (aligned && j0 + kVec <= n) {
    *reinterpret_cast<uint4*>(out + j0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (j0 + k < n) out[j0 + k] = o[k];
    }
  }
}

// kDense and kPdep write out_lo only; the hi pointers (and, dense, the
// plane pointers) are not used
template <Out kOut>
__global__ void __launch_bounds__(kThreads)
regen_kernel(const int* __restrict__ cum, int bins, int n, RegenPlanes p,
             const uint32_t* __restrict__ plane_hi,
             const uint32_t* __restrict__ plane_lo,
             uint32_t* __restrict__ out_hi, uint32_t* __restrict__ out_lo) {
  constexpr bool kTwo = kOut == Out::kPdep2;
  __shared__ int bounds[2];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int last = static_cast<int>(min(base + kTile, static_cast<long long>(n)) - 1);
  if (threadIdx.x == 0) bounds[0] = first_above(cum, 0, bins, static_cast<int>(base));
  if (threadIdx.x == 32) bounds[1] = min(first_above(cum, 0, bins, last) + 1, bins);
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  const uint32_t dead_lo = kOut == Out::kDense ? 0u : __ldg(plane_lo) & p.dead_lo;
  const uint32_t dead_hi = kTwo ? __ldg(plane_hi) & p.dead_hi : 0u;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out_lo) |
        (kTwo ? reinterpret_cast<uintptr_t>(out_hi) : 0u)) & 15u) == 0;
  int v = lo;
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const long long j0 = base + (static_cast<long long>(step) * kThreads + threadIdx.x) * kVec;
    if (j0 >= n) break;
    v = first_above(cum, v, hi, static_cast<int>(j0));
    uint32_t o_lo[kVec], o_hi[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long j = j0 + k;
      while (v < hi && __ldg(cum + v) <= j) ++v;
      if constexpr (kOut == Out::kDense) {
        o_lo[k] = static_cast<uint32_t>(v) + p.offset;
      } else {
        o_lo[k] = rst::pdep(static_cast<uint32_t>(v), p.lo) | dead_lo;
        if constexpr (kTwo) {
          o_hi[k] = rst::pdep(static_cast<uint32_t>(v) >> p.nb_lo, p.hi) | dead_hi;
        }
      }
    }
    store4(out_lo, j0, n, aligned, o_lo);
    if constexpr (kTwo) store4(out_hi, j0, n, aligned, o_hi);
  }
}

template <Out kOut>
int launch_regen(const void* cum, int bins, int n, unsigned int mask_hi,
                 unsigned int mask_lo, unsigned int offset, const void* plane_hi,
                 const void* plane_lo, void* out_hi, void* out_lo, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RegenPlanes planes = {rst::make_runs(mask_hi), rst::make_runs(mask_lo),
                              __builtin_popcount(mask_lo), ~mask_hi, ~mask_lo, offset};
  const int grid = static_cast<int>((static_cast<long long>(n) + kTile - 1) / kTile);
  regen_kernel<kOut><<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(cum), bins, n, planes,
      static_cast<const uint32_t*>(plane_hi), static_cast<const uint32_t*>(plane_lo),
      static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 / K7: dense values plus an offset.
extern "C" int rst_regen(const void* cum, int bins, int n, unsigned int offset,
                         void* out, void* stream) {
  return launch_regen<Out::kDense>(cum, bins, n, 0u, 0u, offset, nullptr, nullptr,
                                   nullptr, out, stream);
}

// K5 / K8: one plane.
extern "C" int rst_regen_pdep(const void* cum, int bins, int n,
                              unsigned int mask, const void* plane, void* out,
                              void* stream) {
  return launch_regen<Out::kPdep>(cum, bins, n, 0u, mask, 0u, nullptr, plane,
                                  nullptr, out, stream);
}

// K6 / K9: two planes; either mask may be 0.
extern "C" int rst_regen_pdep2(const void* cum, int bins, int n,
                               unsigned int mask_hi, unsigned int mask_lo,
                               const void* plane_hi, const void* plane_lo,
                               void* out_hi, void* out_lo, void* stream) {
  return launch_regen<Out::kPdep2>(cum, bins, n, mask_hi, mask_lo, 0u, plane_hi,
                                   plane_lo, out_hi, out_lo, stream);
}
