// K1, K2 and K3: histograms of one- or two-plane keys in one launch.
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
// device-memory bandwidth: 0.0478 ms at 40M keys and 3.35 TB/s. The TPU
// kernels' factored one-hot matmul existed because a TPU vector unit has no
// scatter; here a counter increment is one shared-memory atomic.
//
// What held the first version back: a block held at most 2^15 32-bit
// counters, so wider histograms were cut into 2^15-counter ranges, one grid
// row each, and every row read and evaluated every key (twice at 2^16
// counters, eight times at 2^18); one 16-byte load in flight a thread; K1's
// digit loop over a runtime pass count with a 64-bit drop compare. Now the
// launch shape comes from the host (cuda_kernels.hist_shape; the entry
// refuses a shape that does not give every counter exactly one owner or does
// not fit a block), and:
//   * each block reads only its share of the keys: 16-byte loads, four in
//     flight a thread (two a plane for two planes), in chunks of unroll *
//     threads groups dealt to the blocks of a grid row in turn; a head of up
//     to 3 words brings the read onto the 16-byte grid, a tail of up to 3
//     words ends it;
//   * up to 2^15 counters, 32-bit counters in `copies` sub-histograms a
//     block (warp w adds into copy w % copies), summed at the flush;
//   * more, 16-bit counters, two a word, so a block holds 2^16 (128 KB): a
//     key is read once up to 2^16 counters; past that the grid has
//     ceil(total / 2^16) rows, each counting one range and reading every
//     key (2 at 2^17, 4 at 2^18), since both forms below that read a key
//     once were slower; a counter that reaches 2^15 hands 2^15 to the
//     output (add_half), so none overflows;
//   * with 16-bit counters, a warp in which at least 4 lanes find their
//     chunk's first two keys on one counter (a ballot a chunk) has each
//     thread add a run of equal counters of a pass once, so keys of which
//     90% are one value do not serialize on one counter (an atomic that
//     returns its old value), and uniform keys pay one ballot a chunk;
//   * K1's passes are unrolled at compile time for P = 1 to 4 (the
//     wrappers' hist and hist_multi at r >= 8), and its drop test is one
//     32-bit compare, compiled out when nothing is dropped;
//   * each block adds its non-zero counters into the output, zeroed on the
//     stream first, with global reductions.
// Measured on the H100 (scripts/hist_shapes.py, 40M keys, wall ms; trial
// builds not kept; the runs are named in PERF.md):
//   * one cluster holding the whole histogram in distributed shared memory,
//     each key added at its owner block with red.shared::cluster, read each
//     key once but took 0.2068 at 2^16 counters and 0.3971 at 2^18 (run
//     BB): about one remote add a clock an SM;
//   * a cluster sharing each key tile by a TMA multicast copy, every block
//     counting its 2^16 16-bit counters, read device memory once but
//     evaluated every key in every block of the cluster: 0.2249 at 2^17
//     and 0.3673 at 2^18 (BF);
//   * against these, the kept form: 0.0762 at 2^16 (one block), 0.1345 at
//     2^17 and 0.2052 at 2^18 (grid rows; BI). Every form moves about 3.4
//     keys a clock an SM, whether it reads a key once or four times; what
//     sets that is not measured yet;
//   * the flush as rows of a (blocks, total) scratch summed by a second
//     launch, with no memset and no global atomics, cost 0.017 to 0.019 ms
//     more a call than the reductions (a trial build without the key loop,
//     BB);
//   * a warp ballot of lane 0's counter cost 17% (one digit) to 100% (four
//     digits) on uniform keys (BE) and paid only for 16-bit counters, where
//     runs pay more.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bit_runs.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLocalBits = 15;       // a block's 32-bit counters: 2^15 (128 KB)
constexpr int kBlockSmemMax = 232448;   // a block's shared memory on the H100
constexpr uint32_t kNone = 0xFFFFFFFFu; // no counter (a dropped key)

// K2 (kTwo = false: one plane, read as lo) and K3: one counter per key, the
// PEXT-compacted live bits.
template <bool kTwo>
struct PextCount {
  static constexpr bool two = kTwo;
  static constexpr int runs = 1;
  static constexpr int unroll = kTwo ? 2 : 4;   // 16-byte loads a thread and plane a step
  rst::BitRuns hi;  // runs of mask_hi (kTwo only)
  rst::BitRuns lo;  // runs of mask_lo
  int nb_lo;        // popcount(mask_lo): the shift of hi's live bits

  template <class Add>
  __device__ __forceinline__ void operator()(uint32_t h, uint32_t l, Add& add) const {
    uint32_t v = rst::pext(l, lo);
    if (kTwo) v |= rst::pext(h, hi) << nb_lo;
    add(v, 0);
  }
};

// K1: P digit counters per key (one plane, read as lo), into P consecutive
// 2^bits-counter histograms; kP = 0: P = `passes`, known at run time.
template <int kP, bool kDrop>
struct DigitCount {
  static constexpr bool two = false;
  static constexpr int runs = kP > 0 ? kP : 1;   // run registers a thread keeps
  static constexpr int unroll = 4;
  uint32_t offset;      // subtracted from every key
  uint32_t drop_ge;     // kDrop: keys - offset >= this count nowhere
  int shift;            // bit of the first pass's digit
  int bits;             // digit width r
  int passes;           // P
  uint32_t digit_mask;  // 2^r - 1

  template <class Add>
  __device__ __forceinline__ void operator()(uint32_t, uint32_t w, Add& add) const {
    const uint32_t u = w - offset;
    const bool ok = !kDrop || u < drop_ge;
    if (kP > 0) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        add(ok ? (static_cast<uint32_t>(p) << bits) | ((u >> (shift + p * bits)) & digit_mask)
               : kNone, p);
      }
    } else {
      for (int p = 0; p < passes; ++p) {
        add(ok ? (static_cast<uint32_t>(p) << bits) | ((u >> (shift + p * bits)) & digit_mask)
               : kNone, 0);
      }
    }
  }
};

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// One launch shape (cuda_kernels.HistShape).
struct Shape {
  int threads;     // a block's threads
  int local_bits;  // grid row y owns counters [y << local_bits, (y + 1) << local_bits)
  int ranges;      // grid rows (16-bit counters), each reading every key
  int copies;      // sub-histograms of 32-bit counters a block
  int half;        // 16-bit counters, two a word
};

// A 16-bit counter hands 2^15 to the output whenever an add lifts it from
// below 2^15 to 2^15 or past: that thread takes 2^15 back off with its next
// atomic on the same word. Only one hand-off of a counter is pending at a
// time, since the next needs the counter below 2^15 again. A counter carries
// into its neighbour only if the block's other threads add 2^16 - (2^15 +
// 15) = 32,753 or more to it while the hand-off is pending. A thread adds at
// most 16 to one counter a chunk (its 16 keys), so in the rest of their
// chunk and the next the 1,023 other threads add about 32,736 at most: every
// one of them would have to load a third chunk from device memory and count
// into it while the handing thread goes from one atomic to the next. The
// bound rests on that timing, which CUDA's scheduler does not promise; the
// card tests and chip_smoke.py hold the hand-off against the plain version
// with every block crossing 2^15 several times (16M and 40M keys of one
// value).
__device__ __forceinline__ void add_half(unsigned* words, uint32_t at, uint32_t v, int* out) {
  const uint32_t sh = (at & 1u) << 4;
  const uint32_t old = (atomicAdd(words + (at >> 1), v << sh) >> sh) & 0xFFFFu;
  if (old < 0x8000u && old + v >= 0x8000u) {
    atomicSub(words + (at >> 1), 0x8000u << sh);
    atomicAdd(out + at, 0x8000);
  }
}

// A thread's runs: for each pass, the last counter it met and how many times
// in a row; a run is added once.
template <int kRuns>
struct Runs {
  uint32_t last[kRuns], run[kRuns];
  __device__ __forceinline__ Runs() {
#pragma unroll
    for (int p = 0; p < kRuns; ++p) run[p] = 0;
  }
  template <class Add>
  __device__ __forceinline__ void push(uint32_t c, int p, Add& add) {
    if (run[p] != 0 && c == last[p]) {
      ++run[p];
      return;
    }
    if (run[p] != 0) add(last[p], run[p]);
    last[p] = c;
    run[p] = 1;
  }
  template <class Add>
  __device__ __forceinline__ void flush(Add& add) {
#pragma unroll
    for (int p = 0; p < kRuns; ++p) {
      if (run[p] != 0) add(last[p], run[p]);
      run[p] = 0;
    }
  }
};

// 32-bit counters (up to 2^15): each block counts every counter into its own
// `copies` sub-histograms. 16-bit counters (kHalf, up to 2^16 a block): grid
// row y counts range y, and a warp whose chunk repeats counters adds a
// thread's runs (flushed each chunk, so a run is at most 16).
template <class Count, bool kHalf>
__global__ void __launch_bounds__(kMaxThreads)
hist_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo, long long n,
            Count count, int total, int local_bits, int copies, int* __restrict__ out) {
  extern __shared__ int local[];
  unsigned* words = reinterpret_cast<unsigned*>(local);
  const int range = static_cast<int>(blockIdx.y);
  const int stride = min(1 << local_bits, total);       // counters of one copy
  const int first_counter = range << local_bits;
  const int owned = min(stride, total - first_counter);
  const int zeroed = kHalf ? (stride + 1) >> 1 : copies * stride;
  for (int b = threadIdx.x; b < zeroed; b += blockDim.x) local[b] = 0;
  __syncthreads();

  int* mine = local + ((threadIdx.x >> 5) % copies) * stride;
  int* out_block = out + first_counter;
  auto count_at = [&](uint32_t c, uint32_t v) {
    if (kHalf) {
      if (static_cast<int>(c >> local_bits) != range) return;
      add_half(words, c & ((1u << local_bits) - 1u), v, out_block);
    } else {
      atomicAdd(mine + c, static_cast<int>(v));
    }
  };
  Runs<Count::runs> runs;
  auto add = [&](uint32_t c, int p) {
    if (c != kNone) count_at(c, 1u);
  };
  auto add_runs = [&](uint32_t c, int p) {
    if (c != kNone) runs.push(c, p, count_at);
  };
  uint32_t probe = kNone;              // the first pass's counter of a key
  auto record = [&](uint32_t c, int p) {
    if (p == 0) probe = c;
  };

  // the keys: a head of `lead` words to the 16-byte grid, `quads` 16-byte
  // groups in chunks of unroll * threads dealt to the row's blocks in turn,
  // a tail of up to 3 words; the lo plane sets the grid, and hi is read in
  // 16-byte groups only when it lies the same way
  const uint32_t lo_words = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(lo) >> 2) & 3u;
  const long long lead = min(static_cast<long long>((4u - lo_words) & 3u), n);
  const long long quads = (n - lead) >> 2;
  const bool hi_vec =
      Count::two && ((static_cast<uint32_t>(reinterpret_cast<uintptr_t>(hi) >> 2) & 3u) == lo_words);
  const uint4* lo4 = reinterpret_cast<const uint4*>(lo + lead);
  const uint4* hi4 = reinterpret_cast<const uint4*>(hi + lead);
  constexpr int kUnroll = Count::unroll;
  const long long chunk = static_cast<long long>(kUnroll) * blockDim.x;
  const long long whole = quads / chunk;
  for (long long j = blockIdx.x; j < whole; j += gridDim.x) {
    const long long q0 = j * chunk + threadIdx.x;
    uint4 l[kUnroll], h[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + static_cast<long long>(u) * blockDim.x;
      l[u] = __ldg(lo4 + q);
      h[u] = !Count::two ? l[u] : hi_vec ? __ldg(hi4 + q) : load4(hi + lead + 4 * q);
    }
    // 16-bit counters: a warp whose lanes often meet a repeated counter in
    // their first two keys takes runs for the chunk, else adds key by key
    bool repeats = false;
    if (kHalf) {
      count(h[0].x, l[0].x, record);
      const uint32_t first = probe;
      count(h[0].y, l[0].y, record);
      repeats = __popc(__ballot_sync(0xFFFFFFFFu, first == probe && first != kNone)) >= 4;
    }
    if (repeats) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count(h[u].x, l[u].x, add_runs);
        count(h[u].y, l[u].y, add_runs);
        count(h[u].z, l[u].z, add_runs);
        count(h[u].w, l[u].w, add_runs);
      }
      runs.flush(count_at);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count(h[u].x, l[u].x, add);
        count(h[u].y, l[u].y, add);
        count(h[u].z, l[u].z, add);
        count(h[u].w, l[u].w, add);
      }
    }
  }
  if (static_cast<long long>(blockIdx.x) == whole % gridDim.x) {   // the last, short chunk
    for (long long q = whole * chunk + threadIdx.x; q < quads; q += blockDim.x) {
      const uint4 l = __ldg(lo4 + q);
      const uint4 h = Count::two ? (hi_vec ? __ldg(hi4 + q) : load4(hi + lead + 4 * q)) : l;
      count(h.x, l.x, add);
      count(h.y, l.y, add);
      count(h.z, l.z, add);
      count(h.w, l.w, add);
    }
  }
  if (blockIdx.x == 0) {                                           // head and tail
    const long long tail = lead + 4 * quads;
    if (threadIdx.x < lead) {
      count(Count::two ? __ldg(hi + threadIdx.x) : 0u, __ldg(lo + threadIdx.x), add);
    }
    if (threadIdx.x < n - tail) {
      const long long i = tail + threadIdx.x;
      count(Count::two ? __ldg(hi + i) : 0u, __ldg(lo + i), add);
    }
  }

  __syncthreads();
  for (int b = threadIdx.x; b < owned; b += blockDim.x) {
    int sum = 0;
    if (kHalf) {
      sum = static_cast<int>((words[b >> 1] >> ((b & 1) << 4)) & 0xFFFFu);
    } else {
      for (int c = 0; c < copies; ++c) sum += local[c * stride + b];
    }
    if (sum) atomicAdd(out_block + b, sum);
  }
}

int smem_bytes(const Shape& sh, int total) {
  const int stride = std::min(1 << sh.local_bits, total);
  return sh.half ? 4 * ((stride + 1) >> 1) : 4 * sh.copies * stride;
}

// The shape's checks: every counter of [0, total) has exactly one owner, no
// row owns none, the block fits; 32-bit counters in one row, 16-bit
// counters in one copy.
bool shape_ok(const Shape& sh, int total) {
  if (sh.threads != 256 && sh.threads != 512 && sh.threads != 1024) return false;
  if (sh.half < 0 || sh.half > 1 || sh.ranges < 1 || sh.copies < 1) return false;
  if (sh.half ? sh.copies != 1 : sh.ranges != 1) return false;
  if (sh.local_bits < 1 || sh.local_bits > kMaxLocalBits + sh.half) return false;
  const long long per_row = 1LL << sh.local_bits;
  if (sh.ranges * per_row < total || (sh.ranges - 1) * per_row >= total) return false;
  return smem_bytes(sh, total) <= kBlockSmemMax;
}

template <class Count, bool kHalf>
cudaError_t launch_shape(const uint32_t* hi, const uint32_t* lo, long long n, const Count& count,
                         int total, const Shape& sh, int* out, cudaStream_t s) {
  auto kernel = hist_kernel<Count, kHalf>;
  const int smem = smem_bytes(sh, total);
  dim3 grid;                 // one wave of blocks, shared among the ranges
  cudaError_t err = rst::wave_grid(kernel, sh.threads, smem, n, 4LL * Count::unroll * sh.threads,
                                   sh.ranges, &grid);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(total), s);
  if (err != cudaSuccess) return err;
  kernel<<<grid, sh.threads, smem, s>>>(hi, lo, n, count, total, sh.local_bits, sh.copies, out);
  return cudaGetLastError();
}

template <class Count>
int launch_hist(const void* hi, const void* lo, long long n, const Count& count, int total,
                const Shape& sh, void* hist, void* stream) {
  if (!shape_ok(sh, total)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(hist);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(total), s));
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* l = static_cast<const uint32_t*>(lo);
  return static_cast<int>(sh.half ? launch_shape<Count, true>(h, l, n, count, total, sh, out, s)
                                  : launch_shape<Count, false>(h, l, n, count, total, sh, out, s));
}

template <int kP, bool kDrop>
int launch_digits(const void* keys, long long n, uint32_t offset, int shift, int bits,
                  int passes, uint32_t drop_ge, const Shape& sh, void* hist, void* stream) {
  const DigitCount<kP, kDrop> count = {offset, drop_ge, shift, bits, passes, (1u << bits) - 1u};
  return launch_hist(keys, keys, n, count, passes << bits, sh, hist, stream);
}

}  // namespace

// The launch shape's fields, in the order of cuda_kernels.HistShape.
#define RST_HIST_SHAPE_PARAMS int threads, int local_bits, int ranges, int copies, int half
#define RST_HIST_SHAPE Shape{threads, local_bits, ranges, copies, half}

// K1: `passes` digit histograms of the keys, (passes, 2^bits) int32.
extern "C" int rst_hist(const void* keys, long long n, unsigned int offset, int shift,
                        int bits, int passes, unsigned long long drop_ge, void* hist,
                        RST_HIST_SHAPE_PARAMS, void* stream) {
  if (bits < 1 || bits > 18 || passes < 1 || (static_cast<long long>(passes) << bits) > (1 << 19) ||
      shift < 0 || shift + (passes - 1) * bits >= 32 || drop_ge > (1ULL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = RST_HIST_SHAPE;
  const uint32_t d = static_cast<uint32_t>(drop_ge);
  if (drop_ge < (1ULL << 32)) {   // the wrappers drop in one pass; more take the run-time loop
    return passes == 1 ? launch_digits<1, true>(keys, n, offset, shift, bits, 1, d, sh, hist, stream)
                       : launch_digits<0, true>(keys, n, offset, shift, bits, passes, d, sh, hist,
                                                stream);
  }
  switch (passes) {
    case 1: return launch_digits<1, false>(keys, n, offset, shift, bits, 1, 0, sh, hist, stream);
    case 2: return launch_digits<2, false>(keys, n, offset, shift, bits, 2, 0, sh, hist, stream);
    case 3: return launch_digits<3, false>(keys, n, offset, shift, bits, 3, 0, sh, hist, stream);
    case 4: return launch_digits<4, false>(keys, n, offset, shift, bits, 4, 0, sh, hist, stream);
    default: return launch_digits<0, false>(keys, n, offset, shift, bits, passes, 0, sh, hist,
                                            stream);
  }
}

// K2: one plane (the keys), read as the lo plane.
extern "C" int rst_hist_pext(const void* keys, long long n, unsigned int mask, void* hist,
                             RST_HIST_SHAPE_PARAMS, void* stream) {
  const int nbits = __builtin_popcount(mask);
  if (nbits < 1 || nbits > 17) return static_cast<int>(cudaErrorInvalidValue);
  const PextCount<false> count = {rst::make_runs(0u), rst::make_runs(mask), 0};
  return launch_hist(keys, keys, n, count, 1 << nbits, RST_HIST_SHAPE, hist, stream);
}

// K3: two planes; either mask may be 0, and then the other plane alone is
// read, as K2 reads it (its values are the same).
extern "C" int rst_hist_pext2(const void* hi, const void* lo, long long n,
                              unsigned int mask_hi, unsigned int mask_lo, void* hist,
                              RST_HIST_SHAPE_PARAMS, void* stream) {
  const int nb_lo = __builtin_popcount(mask_lo);
  const int nbits = __builtin_popcount(mask_hi) + nb_lo;
  if (nbits < 1 || nbits > 17) return static_cast<int>(cudaErrorInvalidValue);
  if (mask_hi == 0 || mask_lo == 0) {
    const PextCount<false> count = {rst::make_runs(0u), rst::make_runs(mask_hi | mask_lo), 0};
    const void* plane = mask_hi ? hi : lo;
    return launch_hist(plane, plane, n, count, 1 << nbits, RST_HIST_SHAPE, hist, stream);
  }
  const PextCount<true> count = {rst::make_runs(mask_hi), rst::make_runs(mask_lo), nb_lo};
  return launch_hist(hi, lo, n, count, 1 << nbits, RST_HIST_SHAPE, hist, stream);
}

// Shared by every kernel of the library: the text of a returned error code.
extern "C" const char* rst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
