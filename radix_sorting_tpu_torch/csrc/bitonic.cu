// K12: bitonic sort of a few word planes by the first num_keys of them.
//
// Replaces radix_sorting_tpu/ops/vmem_sort.py::_bitonic_kernel (K12,
// sort_planes_vmem): the whole network inside one Pallas invocation, every
// plane resident in VMEM, partners fetched with lane and row rolls.
// Contract: planes (n,) u32 (int32 carriers), at most 32 of them; the first
// `keys` are compared lexicographically as unsigned words, most significant
// first, and every plane moves with its key. The network is that of
// N = max(1024, next power of two >= n) elements, the elements from n on being
// all-ones keys (the JAX package's padding):
//   for k = 1 .. log2(N), size = 2^k:
//     one step of pairs (i, i ^ (size - 1)) within each block of `size`
//     (the block's mirror), then steps of pairs (i, i + s), i & s == 0, for
//     s = size / 4 .. 1;
//   each pair (lo, hi), lo < hi, swaps its records iff key(lo) > key(hi).
// Every compare-exchange is ascending and swaps only a pair that is out of
// order, so the records are always a permutation of the input (the TPU
// kernel gives both partners of equal key tuples the lower one's record:
// ROADMAP.md, R1), and a padding key, the largest, never moves. So the kernel
// holds no padding: it skips the pairs whose hi is >= n and never touches
// memory past n. ops/cuda_kernels.bitonic_plain runs the same pairs with the
// padding in place and agrees bit for bit, ties included.
//
// Bound on the H100: each plane read once and written once. A padded plane
// of 2^17 keys is 512 KB, more than a block's shared memory, so:
//   * tiles of T keys (the largest power of two with planes * T * 4 bytes
//     <= 64 KB, at most N, and cut down to 1,024 keys while there are fewer
//     than 32 tiles: one SM alone runs a tile, at the pace of its shared
//     memory) run every step whose pairs lie inside a tile in
//     shared memory, one block per tile, all planes resident: all of the
//     sizes up to T in the first launch (reading the input, writing the
//     output), then, for each larger size, the steps of s < T in one launch
//     on the output in place;
//   * the steps of larger strides, and the mirror steps of sizes past T, go
//     through device memory, one launch each, one thread per pair.
// For n <= T the whole network is one launch. The launches of one sort run
// on the caller's stream in order; the function returns after enqueueing
// them.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kTileBytes = 64 * 1024;
constexpr int kStepThreads = 256;
constexpr int kMinTiles = 32;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

// key(a) > key(b) over the first `keys` planes of a plane-major array with
// `stride` elements between planes
__device__ __forceinline__ bool key_gt(const uint32_t* x, long long stride, int keys,
                                       long long a, long long b) {
  for (int p = 0; p < keys; ++p) {
    const uint32_t u = x[p * stride + a], v = x[p * stride + b];
    if (u != v) return u > v;
  }
  return false;
}

__device__ __forceinline__ void exchange(uint32_t* x, long long stride, int planes, int keys,
                                         long long lo, long long hi) {
  if (!key_gt(x, stride, keys, lo, hi)) return;
  for (int p = 0; p < planes; ++p) {
    const uint32_t t = x[p * stride + lo];
    x[p * stride + lo] = x[p * stride + hi];
    x[p * stride + hi] = t;
  }
}

// the q-th pair of a step inside a block of 2^k (mirror) or at stride 2^j
__device__ __forceinline__ void mirror_pair(long long q, int k, long long* lo, long long* hi) {
  const long long half = 1LL << (k - 1);
  const long long block = (q >> (k - 1)) << k;
  const long long off = q & (half - 1);
  *lo = block + off;
  *hi = block + (2 * half - 1) - off;
}

__device__ __forceinline__ void stride_pair(long long q, int j, long long* lo, long long* hi) {
  *lo = ((q >> j) << (j + 1)) | (q & ((1LL << j) - 1));
  *hi = *lo + (1LL << j);
}

// The steps at strides 2^top .. 1 on a tile of T keys in shared memory, of
// which the first `valid` are keys.
__device__ void tile_strides(uint32_t* s, int T, int valid, int nplanes, int keys, int top) {
  for (int j = top; j >= 0; --j) {
    for (int q = threadIdx.x; q < T / 2; q += blockDim.x) {
      long long lo, hi;
      stride_pair(q, j, &lo, &hi);
      if (hi < valid) exchange(s, T, nplanes, keys, lo, hi);
    }
    __syncthreads();
  }
}

// One block per tile of T = 2^log_t keys. full: every size up to T; else the
// steps of strides T / 2 .. 1 (the tail of a larger size's merge).
__global__ void bitonic_tile_kernel(Planes planes, int nplanes, int keys, long long n,
                                    int log_t, bool full) {
  extern __shared__ uint32_t s[];
  const int T = 1 << log_t;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int valid = static_cast<int>(min(static_cast<long long>(T), n - base));
  for (int p = 0; p < nplanes; ++p) {
    for (int i = threadIdx.x; i < valid; i += blockDim.x) s[p * T + i] = planes.in[p][base + i];
  }
  __syncthreads();
  if (full) {
    for (int k = 1; k <= log_t; ++k) {
      for (int q = threadIdx.x; q < T / 2; q += blockDim.x) {
        long long lo, hi;
        mirror_pair(q, k, &lo, &hi);
        if (hi < valid) exchange(s, T, nplanes, keys, lo, hi);
      }
      __syncthreads();
      tile_strides(s, T, valid, nplanes, keys, k - 2);
    }
  } else {
    tile_strides(s, T, valid, nplanes, keys, log_t - 1);
  }
  for (int p = 0; p < nplanes; ++p) {
    for (int i = threadIdx.x; i < valid; i += blockDim.x) planes.out[p][base + i] = s[p * T + i];
  }
}

// One step through device memory on the output planes: the mirror step of
// size 2^k (mirror) or the step at stride 2^k.
__global__ void __launch_bounds__(kStepThreads)
bitonic_step_kernel(Planes planes, int nplanes, int keys, long long n, long long pairs, int k,
                    bool mirror) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < pairs; q += step) {
    long long lo, hi;
    if (mirror) {
      mirror_pair(q, k, &lo, &hi);
    } else {
      stride_pair(q, k, &lo, &hi);
    }
    if (hi >= n) continue;
    bool gt = false;
    for (int p = 0; p < keys; ++p) {
      const uint32_t u = planes.out[p][lo], v = planes.out[p][hi];
      if (u != v) {
        gt = u > v;
        break;
      }
    }
    if (!gt) continue;
    for (int p = 0; p < nplanes; ++p) {
      const uint32_t t = planes.out[p][lo];
      planes.out[p][lo] = planes.out[p][hi];
      planes.out[p][hi] = t;
    }
  }
}

}  // namespace

// K12: sort `nplanes` planes of n keys by the first `keys`, from `in` into
// `out` (separate buffers).
extern "C" int rst_bitonic(const void* const* in, void* const* out, int nplanes, int keys,
                           long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || nplanes > kMaxPlanes || keys < 1 || keys > nplanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int log_n = 10;  // N >= 1024, as the JAX package pads
  while ((1LL << log_n) < n) ++log_n;
  int log_t = log_n;
  while (log_t > 1 && (static_cast<long long>(nplanes) * 4) << log_t > kTileBytes) --log_t;
  while (log_t > 10 && (1LL << (log_n - log_t)) < kMinTiles) --log_t;
  Planes p{};
  for (int i = 0; i < nplanes; ++i) {
    p.in[i] = static_cast<const uint32_t*>(in[i]);
    p.out[i] = static_cast<uint32_t*>(out[i]);
  }
  Planes inplace = p;
  for (int i = 0; i < nplanes; ++i) inplace.in[i] = inplace.out[i];
  const int T = 1 << log_t;
  const int smem = nplanes * T * static_cast<int>(sizeof(uint32_t));
  const int threads = std::min(1024, T / 2);
  const unsigned tiles = static_cast<unsigned>((n + T - 1) / T);
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_tile_kernel<<<tiles, threads, smem, st>>>(p, nplanes, keys, n, log_t, true);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = 1LL << (log_n - 1);
  const unsigned grid = static_cast<unsigned>(
      std::max(1LL, std::min((pairs + kStepThreads - 1) / kStepThreads, 8LL * sms)));
  for (int k = log_t + 1; k <= log_n; ++k) {
    bitonic_step_kernel<<<grid, kStepThreads, 0, st>>>(p, nplanes, keys, n, pairs, k, true);
    for (int j = k - 2; j >= log_t; --j) {
      bitonic_step_kernel<<<grid, kStepThreads, 0, st>>>(p, nplanes, keys, n, pairs, j, false);
    }
    bitonic_tile_kernel<<<tiles, threads, smem, st>>>(inplace, nplanes, keys, n, log_t, false);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
