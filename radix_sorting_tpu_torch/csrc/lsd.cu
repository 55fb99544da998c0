// L1 and L2: the two kernels of one pass of the LSD radix sort (Strategy.LSD).
//
// No TPU kernel: the JAX package's LSD engine
// (radix_sorting_tpu/ops/lsd_engine.py:63, _sort_padded) is jitted XLA. Its
// per-tile rank is a (tile x bins) one-hot and an exclusive cumsum down the
// tile (lsd_engine.py:45-59), about 10^10 int32 per pass at 40M keys, which
// a card cannot hold. These kernels are the first piece of K0, the
// hand-written Hopper sorter.
// Contracts (planes (n,) u32 carried as int32; digit d(i) = (w[i] >> shift) &
// (2^bits - 1), bits in 1..16, shift < 32; tile t holds the keys
// [t * tile, min(n, (t + 1) * tile)), tiles = ceil(n / tile), the last one
// short):
//   L1 rst_lsd_hist:    hist (tiles, 2^bits) int32,
//                       hist[t][b] = #{i in tile t : d(i) == b};
//   L2 rst_lsd_scatter: for every key i of tile t and every plane p,
//                       out_p[bases[t][d(i)] + r(i)] = in_p[i], where the rank
//                       r(i) = #{j in tile t : j < i and d(j) == d(i)}.
//     With bases from scan.scatter_bases this is one stable pass: within a
//     tile the j-th key of a digit takes the j-th slot the bases give it.
//
// Bound on the H100: a pass must read each plane once and write it once;
// L1 reads the digit plane once more. Design, simple first:
//   * L1: one block of 256 threads per tile, a private histogram in shared
//     memory (shared atomics) written out whole, zeros included. At 2^16
//     bins the 256 KB table does not fit a block: the block adds into its
//     own row of the output with global atomics (zeroed before the launch).
//   * L2, staged (digits of up to 11 bits, tiles of up to 8,192 keys): one
//     block of W warps per tile (W = 8 up to 2^8 bins, else 4), each warp
//     taking a contiguous W-th of the tile. The warps count their digits
//     (shared atomics into a row of their own), one scan turns the counts
//     into each warp's first slot per digit in the tile sorted by digit,
//     and each warp then walks its keys in input order, 32 at a time:
//     __match_any_sync on the digit gives the lanes of the same digit, a
//     lane's rank among them is the popcount of the lower lanes, and the
//     lowest lane moves the warp's running slot on by the group's size. The
//     keys land in shared memory in the tile's stable digit order, and the
//     block writes them out in that order: slot j of digit d goes to
//     bases[t][d] + j - (the tile's first slot of d), so neighbouring
//     threads write runs of one digit. Every other plane takes the same
//     slots through the same buffer. The first version wrote each key
//     straight to its slot from the warp step, 32 digits a store; on the
//     H100 those scattered 4-byte writes ran at about 16 G a second
//     (PERF.md, section 6), a tenth of the bound.
//   * L2, direct (wider digits or longer tiles): that first version, one
//     warp per tile, its running counters the tile's base row in shared
//     memory up to 2^12 bins, else in a global-memory copy of the row.
//     Uncoalesced 4-byte writes. Both forms take at most 32 planes a launch.
//   * The tile bounds the histogram: tiles * 2^bits int32 are written, scanned
//     and read once per pass, so the caller takes tiles of at least 2^bits
//     keys.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kHistThreads = 256;
constexpr int kHistSharedMaxBits = 15;     // 128 KB of counters in one block
constexpr int kScatterSharedMaxBits = 12;  // 16 KB of counters per warp
constexpr int kStageMaxBits = 11;          // staged L2: W * bins <= 8,192 counters
constexpr int kStageMaxTile = 8192;        // staged L2: the tile in shared memory
constexpr int kMaxPlanes = 32;
constexpr int kUnroll = 4;                 // key loads in flight per lane

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int count;
  int digit;  // the index of the digit plane among them, or -1
};

__global__ void __launch_bounds__(kHistThreads)
lsd_hist_kernel(const uint32_t* __restrict__ w, long long n, int shift, int bits,
                long long tile, int* __restrict__ hist) {
  extern __shared__ int local[];
  const int bins = 1 << bits;
  const uint32_t digit_mask = static_cast<uint32_t>(bins) - 1u;
  const bool in_shared = bits <= kHistSharedMaxBits;
  int* row = hist + static_cast<long long>(blockIdx.x) * bins;
  int* counters = in_shared ? local : row;
  if (in_shared) {
    for (int b = threadIdx.x; b < bins; b += blockDim.x) local[b] = 0;
    __syncthreads();
  }
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const long long end = min(n, first + tile);
  for (long long i = first + threadIdx.x; i < end; i += blockDim.x) {
    atomicAdd(counters + ((__ldg(w + i) >> shift) & digit_mask), 1);
  }
  if (in_shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += blockDim.x) row[b] = local[b];
  }
}

__global__ void __launch_bounds__(32)
lsd_scatter_kernel(const uint32_t* __restrict__ w, Planes planes, long long n, int shift,
                   int bits, long long tile, const int* __restrict__ bases,
                   int* __restrict__ global_counters) {
  extern __shared__ int local[];
  const int bins = 1 << bits;
  const uint32_t digit_mask = static_cast<uint32_t>(bins) - 1u;
  const int lane = threadIdx.x;
  const long long t = blockIdx.x;
  int* counters;
  if (global_counters != nullptr) {
    counters = global_counters + t * bins;   // the caller's copy of the bases
  } else {
    counters = local;
    for (int b = lane; b < bins; b += 32) local[b] = bases[t * bins + b];
    __syncwarp();
  }
  const unsigned below = (1u << lane) - 1u;
  const long long first = t * tile;
  const long long end = min(n, first + tile);
  for (long long chunk = first; chunk < end; chunk += 32 * kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = chunk + u * 32 + lane;
      v[u] = i < end ? __ldg(w + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = chunk + u * 32 + lane;
      const bool valid = i < end;
      // past the tile's end: a digit no key has (bins <= 2^16), so those
      // lanes group only with each other and take no counter
      const uint32_t d = valid ? (v[u] >> shift) & digit_mask : 0xFFFFFFFFu;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
      const int leader = __ffs(peers) - 1;
      int start = 0;
      if (lane == leader && valid) start = counters[d];
      start = __shfl_sync(0xFFFFFFFFu, start, leader);
      if (lane == leader && valid) counters[d] = start + __popc(peers);
      __syncwarp();  // the next step's leaders see the moved counters
      if (valid) {
        const long long pos = start + __popc(peers & below);
        for (int p = 0; p < planes.count; ++p) {
          planes.out[p][pos] = p == planes.digit ? v[u] : __ldg(planes.in[p] + i);
        }
      }
    }
  }
}

// Exclusive sum of x over the block (threads in order); warp_sums holds 32
// ints of shared memory.
__device__ int block_exclusive_sum(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int v = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < warps ? warp_sums[lane] : 0;
    int u = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, u, o);
      if (lane >= o) u += y;
    }
    if (lane < warps) warp_sums[lane] = u - own;
  }
  __syncthreads();
  return v - x + warp_sums[warp];
}

// Staged L2: one block of blockDim / 32 warps per tile; shared memory (ints):
// per-warp counters (warps * bins), each digit's destination offset (bins),
// 32 warp sums, then the tile's slots (tile words), each input key's slot and
// each slot's digit (tile 16-bit words each).
__global__ void lsd_scatter_staged_kernel(const uint32_t* __restrict__ w, Planes planes,
                                          long long n, int shift, int bits, int tile,
                                          const int* __restrict__ bases) {
  extern __shared__ int smem[];
  const int bins = 1 << bits;
  const uint32_t digit_mask = static_cast<uint32_t>(bins) - 1u;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* counters = smem;                      // [warps][bins]
  int* dest = counters + warps * bins;       // [bins]
  int* warp_sums = dest + bins;              // [32]
  uint32_t* slots = reinterpret_cast<uint32_t*>(warp_sums + 32);
  uint16_t* slot_of = reinterpret_cast<uint16_t*>(slots + tile);
  uint16_t* digit_of = slot_of + tile;
  const long long t = blockIdx.x;
  const long long first = t * tile;
  const int valid = static_cast<int>(min(static_cast<long long>(tile), n - first));
  const int span = ((tile + warps - 1) / warps + 31) & ~31;
  const int lo = min(valid, warp * span), hi = min(valid, lo + span);

  for (int c = threadIdx.x; c < warps * bins; c += blockDim.x) counters[c] = 0;
  __syncthreads();
  int* own = counters + warp * bins;
  for (int i = lo + lane; i < hi; i += 32) {
    atomicAdd(own + ((__ldg(w + first + i) >> shift) & digit_mask), 1);
  }
  __syncthreads();
  // each warp's first slot per digit: the tile's first slot of the digit
  // plus the digit's keys in the earlier warps
  const int per = (bins + blockDim.x - 1) / blockDim.x;
  const int d0 = min(bins, threadIdx.x * per), d1 = min(bins, d0 + per);
  int sum = 0;
  for (int d = d0; d < d1; ++d) {
    int running = 0;
    for (int v = 0; v < warps; ++v) {
      const int c = counters[v * bins + d];
      counters[v * bins + d] = running;
      running += c;
    }
    dest[d] = running;
    sum += running;
  }
  int start = block_exclusive_sum(sum, warp_sums);
  for (int d = d0; d < d1; ++d) {
    const int count = dest[d];
    dest[d] = bases[t * bins + d] - start;
    for (int v = 0; v < warps; ++v) counters[v * bins + d] += start;
    start += count;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const bool ok = i < hi;
    const uint32_t v = ok ? __ldg(w + first + i) : 0u;
    const uint32_t d = ok ? (v >> shift) & digit_mask : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (lane == leader && ok) slot = own[d];
    slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
    if (lane == leader && ok) own[d] = slot + __popc(peers);
    __syncwarp();
    if (ok) {
      slot += __popc(peers & below);
      slots[slot] = v;
      digit_of[slot] = static_cast<uint16_t>(d);
      slot_of[i] = static_cast<uint16_t>(slot);
    }
  }
  __syncthreads();
  for (int p = 0; p < planes.count; ++p) {
    if (p != planes.digit) {
      __syncthreads();   // the last plane's slots are written out
      for (int i = threadIdx.x; i < valid; i += blockDim.x) {
        slots[slot_of[i]] = __ldg(planes.in[p] + first + i);
      }
      __syncthreads();
    }
    uint32_t* out = planes.out[p];
    for (int j = threadIdx.x; j < valid; j += blockDim.x) out[dest[digit_of[j]] + j] = slots[j];
  }
}

}  // namespace

// L1: (tiles, 2^bits) int32 per-tile histograms of one digit.
extern "C" int rst_lsd_hist(const void* keys, long long n, int shift, int bits,
                            long long tile, void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + tile - 1) / tile;
  if (tiles == 0) return 0;
  const size_t bins = size_t{1} << bits;
  int smem = 0;
  cudaError_t err = cudaSuccess;
  if (bits <= kHistSharedMaxBits) {
    smem = static_cast<int>(sizeof(int) * bins);
    err = cudaFuncSetAttribute(lsd_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  } else {
    err = cudaMemsetAsync(hist, 0, sizeof(int) * bins * static_cast<size_t>(tiles), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  lsd_hist_kernel<<<static_cast<unsigned>(tiles), kHistThreads, smem, s>>>(
      static_cast<const uint32_t*>(keys), n, shift, bits, tile, static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// L2: the stable scatter of `planes` planes (at most 32) by one digit of
// `keys`. `counters` is scratch of tiles * 2^bits int32 when bits > 12 (the
// bases are copied into it), else null.
extern "C" int rst_lsd_scatter(const void* keys, const void* const* in, void* const* out,
                               int planes, long long n, int shift, int bits, long long tile,
                               const void* bases, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || planes > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  if (tiles == 0) return 0;
  Planes p{};
  p.count = planes;
  p.digit = -1;
  for (int i = 0; i < planes; ++i) {
    p.in[i] = static_cast<const uint32_t*>(in[i]);
    p.out[i] = static_cast<uint32_t*>(out[i]);
    if (in[i] == keys) p.digit = i;
  }
  const size_t bins = size_t{1} << bits;
  int smem = 0;
  int* global_counters = nullptr;
  cudaError_t err = cudaSuccess;
  if (bits <= kStageMaxBits && tile <= kStageMaxTile) {
    // the slots hold the keys' own plane first: put it first
    if (p.digit > 0) {
      std::swap(p.in[0], p.in[p.digit]);
      std::swap(p.out[0], p.out[p.digit]);
      p.digit = 0;
    }
    const int warps = bits <= 8 ? 8 : 4;
    smem = static_cast<int>(sizeof(int) * ((warps + 1) * bins + 32) +
                            static_cast<size_t>(tile) * (sizeof(uint32_t) + 2 * sizeof(uint16_t)));
    err = cudaFuncSetAttribute(lsd_scatter_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lsd_scatter_staged_kernel<<<static_cast<unsigned>(tiles), 32 * warps, smem, s>>>(
        static_cast<const uint32_t*>(keys), p, n, shift, bits, static_cast<int>(tile),
        static_cast<const int*>(bases));
    return static_cast<int>(cudaGetLastError());
  }
  if (bits <= kScatterSharedMaxBits) {
    smem = static_cast<int>(sizeof(int) * bins);
  } else {
    if (counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    global_counters = static_cast<int*>(counters);
    err = cudaMemcpyAsync(counters, bases, sizeof(int) * bins * static_cast<size_t>(tiles),
                          cudaMemcpyDeviceToDevice, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  lsd_scatter_kernel<<<static_cast<unsigned>(tiles), 32, smem, s>>>(
      static_cast<const uint32_t*>(keys), p, n, shift, bits, tile,
      static_cast<const int*>(bases), global_counters);
  return static_cast<int>(cudaGetLastError());
}
