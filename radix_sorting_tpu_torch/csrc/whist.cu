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
// contract does, and f32 atomics add the f32 weight itself.
//
// What held the first version back: a table of 8 bytes a bin (a 32-bit count
// and sum) capped at 128 KB, so past 2^14 bins the grid was cut into rows of
// bins and every row read every key and value (four times at 2^16 bins, eight
// at 2^17); 4-byte loads of both planes whenever either lay off the 16-byte
// grid; one 16-byte load of each plane in flight a thread; rows of one group
// added one at a time. Now the launch shape comes from the host
// (cuda_kernels.whist_shape; the entries refuse a shape that does not give
// every bin exactly one owner or does not fit a block), and:
//   * each block keeps a private table in shared memory: while 8 bytes a bin
//     fit a block (up to 2^14 bins with counts), 32-bit counts and sums; past
//     that, 16-bit counts two to a word beside 32-bit sums, 6 bytes a bin, so
//     a block holds 2^15 bins (192 KB) and the grid has bins / 2^15 rows (2 at
//     2^16, 4 at 2^17), each counting one range of bins and reading every row;
//     K11 without counts keeps 4 bytes a bin (2^15 a block);
//   * a 16-bit count that reaches 2^15 hands 2^15 to the output
//     (rst::add_half, half_counter.cuh); the block counts in rounds of one
//     chunk with a barrier after each, which bounds what can land while a
//     hand-off is pending (the proof is in half_counter.cuh), and each
//     thread's next chunk is loaded before it counts this one, so its loads
//     are in flight across the barrier;
//   * the read: 16-byte loads of keys and values, `unroll` of each plane a
//     thread a chunk (two; four for K11's sums alone past 2^15 bins, where
//     they were faster), chunks of unroll * threads 16-byte groups dealt to the
//     blocks of a grid row in turn; a head of up to 3 rows brings the keys
//     onto the 16-byte grid and a tail of up to 3 ends them; the values are
//     read in 16-byte groups when they lie the same way as the keys, else
//     word by word;
//   * a warp in which at least 4 lanes find their chunk's first two rows in
//     one bin (a ballot a chunk) takes the first such lane's bin as its
//     candidate: each thread sums its rows of that bin in registers and lane
//     0 adds the warp's count and sum once (u32 sums wrap the same way; the
//     f32 sum of at most 32 * 4 * unroll weights in a fixed tree stays far
//     inside the stated bound), so a group that holds most rows does not
//     serialize on one bin's atomics;
//   * each block adds its non-zero bins into the outputs, zeroed on the
//     stream first, with global atomics.
// Measured on the H100 (scripts/whist_shapes.py, 40M rows, wall ms; trial
// builds not kept; the runs are named in PERF.md):
//   * this form against the first one: 65,536 bins 0.2270 -> 0.1664,
//     131,072 bins 0.4052 -> 0.2886, 90% of the rows in one group at 1,024
//     bins 0.1815 -> 0.1175; K11 on such rows 6.4 to 49.7 ms -> 0.12 to
//     0.35, since f32 atomics on one address serialize (BT);
//   * each thread adding its runs of a group in place of the warp's
//     candidate: K11 with 90% of the rows in one group 0.80 ms (BO);
//   * 8 bytes a bin in rows of 2^14 with this read: 0.1991 at 65,536 bins
//     (four rows), 0.3679 at 131,072 (eight; BT);
//   * rounds of four chunks: no faster (BP); 512 threads: 7% faster for
//     K11 at 1,024 bins, 44 to 54% slower where the table fills the SM;
//     four loads of each plane a chunk: slower with counts (register
//     spills); for K11's sums alone past 2^15 bins 6 to 12% faster, but
//     for 90% of the rows in one group at 2^16 4 to 5% slower (BT, BV), so
//     those take four;
//     an L2 prefetch of the chunk after next: slower (BS);
//   * not tried: a cluster of two blocks, each owning 2^15 bins, fed by one
//     TMA multicast of each tile. It saves bytes, and the rows form is bound
//     by evaluating rows, not by bytes (65,536 bins move 640 MB in 0.166 ms,
//     past the device's rate, so L2 serves the second row); both blocks
//     would still evaluate every row, the form hist.cu measured slower.
// Float atomics add in an order that changes from run to run, so K11's sums
// are not bitwise repeatable; its counts, and K10's counts and sums, are.
// A non-finite weight makes only its own bin non-finite (the TPU kernel's
// products spread it to every bin).
#include <cuda_runtime.h>

#include <cstdint>

#include "grid.cuh"
#include "half_counter.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockSmemMax = 232448;   // a block's shared memory on the H100
constexpr int kMaxBits = 17;
constexpr uint32_t kNone = 0xFFFFFFFFu; // no bin of this row (a dropped key)

// The counts a table keeps.
enum Counts { kNoCounts = 0, kWordCounts = 1, kHalfCounts = 2 };

// One launch shape (cuda_kernels.WhistShape).
struct Shape {
  int threads;     // a block's threads
  int local_bits;  // grid row y owns bins [y << local_bits, (y + 1) << local_bits)
  int ranges;      // grid rows, each reading every row of the input
  int half;        // 16-bit counts, two a word
  int unroll;      // 16-byte loads of each plane a thread a chunk
};

template <class T>
struct Vec4;
template <>
struct Vec4<unsigned int> { using type = uint4; };
template <>
struct Vec4<float> { using type = float4; };

template <class Sum>
__device__ __forceinline__ typename Vec4<Sum>::type load4(const Sum* p) {
  typename Vec4<Sum>::type r;
  r.x = __ldg(p);
  r.y = __ldg(p + 1);
  r.z = __ldg(p + 2);
  r.w = __ldg(p + 3);
  return r;
}

// The sum over the warp's 32 lanes, every lane taking part.
__device__ __forceinline__ unsigned int warp_sum(unsigned int x) {
  return __reduce_add_sync(0xFFFFFFFFu, x);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, d);
  return x;
}

// Sum: unsigned int (K10) or float (K11); kCounts: the counts' table.
template <class Sum, int kCounts, int kUnroll>
__global__ void __launch_bounds__(kMaxThreads)
whist_kernel(const uint32_t* __restrict__ keys, const Sum* __restrict__ vals, long long n,
             uint32_t drop_ge, int local_bits, int* __restrict__ counts, Sum* __restrict__ sums) {
  constexpr bool kHalf = kCounts == kHalfCounts;
  // 16-bit counts count in rounds (half_counter.cuh) of one chunk, and a
  // last round of the short chunk with the head and the tail: a thread
  // reads at most 4 * unroll + 2 rows a round
  static_assert(!kHalf || rst::half_round_ok(kMaxThreads, 4 * kUnroll + 2),
                "a hand-off could carry into the neighbouring count");
  extern __shared__ __align__(16) unsigned char table[];
  const int per_row = 1 << local_bits;
  Sum* lsum = reinterpret_cast<Sum*>(table);
  unsigned* lcnt = reinterpret_cast<unsigned*>(lsum + per_row);
  const uint32_t range = blockIdx.y;
  const int first_bin = static_cast<int>(range) << local_bits;
  const int count_words = kHalf ? (per_row + 1) >> 1 : kCounts == kWordCounts ? per_row : 0;
  for (int b = threadIdx.x; b < per_row; b += blockDim.x) lsum[b] = Sum(0);
  for (int b = threadIdx.x; b < count_words; b += blockDim.x) lcnt[b] = 0u;
  __syncthreads();

  int* out_counts = kCounts == kNoCounts ? nullptr : counts + first_bin;
  const uint32_t local_mask = static_cast<uint32_t>(per_row) - 1u;
  // a key's bin in this grid row's range, kNone when dropped or elsewhere
  auto bin_of = [&](uint32_t k) {
    return k < drop_ge && (k >> local_bits) == range ? k & local_mask : kNone;
  };
  // c rows of bin b whose values sum to s
  auto add = [&](uint32_t b, Sum s, uint32_t c) {
    atomicAdd(lsum + b, s);
    if (kCounts == kWordCounts) atomicAdd(lcnt + b, c);
    if (kHalf) rst::add_half(lcnt, b, c, out_counts);
  };
  auto add_row = [&](uint32_t k, Sum v) {
    const uint32_t b = bin_of(k);
    if (b != kNone) add(b, v, 1u);
  };

  // the rows: a head of `lead` to the keys' 16-byte grid, `quads` 16-byte
  // groups in chunks of unroll * threads dealt to the row's blocks in turn,
  // a tail of up to 3
  using V4 = typename Vec4<Sum>::type;
  const uint32_t key_words = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(keys) >> 2) & 3u;
  const long long lead = min(static_cast<long long>((4u - key_words) & 3u), n);
  const long long quads = (n - lead) >> 2;
  const bool vals_vec =
      (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(vals) >> 2) & 3u) == key_words;
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys + lead);
  const V4* vals4 = reinterpret_cast<const V4*>(vals + lead);
  const long long chunk = static_cast<long long>(kUnroll) * blockDim.x;
  const long long whole = quads / chunk;
  auto load = [&](long long j, uint4* k, V4* v) {
    const long long q0 = j * chunk + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + static_cast<long long>(u) * blockDim.x;
      k[u] = __ldg(keys4 + q);
      v[u] = vals_vec ? __ldg(vals4 + q) : load4(vals + lead + 4 * q);
    }
  };
  uint4 k[kUnroll];
  V4 v[kUnroll];
  if (kHalf && blockIdx.x < whole) load(blockIdx.x, k, v);
  for (long long j = blockIdx.x; j < whole; j += gridDim.x) {
    // 16-bit counts: the next chunk's loads go out before this one is
    // counted, so that they are in flight across the barrier ending a round
    uint4 kn[kUnroll];
    V4 vn[kUnroll];
    if (!kHalf) {
      load(j, k, v);
    } else if (j + gridDim.x < whole) {
      load(j + gridDim.x, kn, vn);
    }
    // a warp in which at least 4 lanes find their first two rows in one bin
    // takes the first such lane's bin as its candidate: each thread sums its
    // rows of the candidate in registers, lane 0 adds the warp's rows and
    // sum once; the other rows are added one by one
    const uint32_t first = bin_of(k[0].x);
    const unsigned rep = __ballot_sync(0xFFFFFFFFu, first != kNone && first == bin_of(k[0].y));
    if (__popc(rep) >= 4) {
      const uint32_t cand = __shfl_sync(0xFFFFFFFFu, first, __ffs(rep) - 1);
      uint32_t rows = 0;
      Sum sum = Sum(0);
      auto push_row = [&](uint32_t key, Sum val) {
        const uint32_t b = bin_of(key);
        if (b == cand) {
          ++rows;
          sum += val;
        } else if (b != kNone) {
          add(b, val, 1u);
        }
      };
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        push_row(k[u].x, v[u].x);
        push_row(k[u].y, v[u].y);
        push_row(k[u].z, v[u].z);
        push_row(k[u].w, v[u].w);
      }
      rows = warp_sum(rows);
      sum = warp_sum(sum);
      if ((threadIdx.x & 31) == 0) add(cand, sum, rows);   // rows >= 2: the first lane's two
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add_row(k[u].x, v[u].x);
        add_row(k[u].y, v[u].y);
        add_row(k[u].z, v[u].z);
        add_row(k[u].w, v[u].w);
      }
    }
    if (kHalf) {
      __syncthreads();      // the round ends: every hand-off of it has landed
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = kn[u];
        v[u] = vn[u];
      }
    }
  }
  if (static_cast<long long>(blockIdx.x) == whole % gridDim.x) {   // the last, short chunk
    for (long long q = whole * chunk + threadIdx.x; q < quads; q += blockDim.x) {
      const uint4 kk = __ldg(keys4 + q);
      const V4 vv = vals_vec ? __ldg(vals4 + q) : load4(vals + lead + 4 * q);
      add_row(kk.x, vv.x);
      add_row(kk.y, vv.y);
      add_row(kk.z, vv.z);
      add_row(kk.w, vv.w);
    }
  }
  if (blockIdx.x == 0) {                                           // head and tail
    const long long tail = lead + 4 * quads;
    if (threadIdx.x < lead) add_row(__ldg(keys + threadIdx.x), __ldg(vals + threadIdx.x));
    if (threadIdx.x < n - tail) {
      const long long i = tail + threadIdx.x;
      add_row(__ldg(keys + i), __ldg(vals + i));
    }
  }

  __syncthreads();
  for (int b = threadIdx.x; b < per_row; b += blockDim.x) {
    if (kCounts == kWordCounts) {
      const int c = static_cast<int>(lcnt[b]);
      if (c == 0) continue;                  // no row, so no sum either
      atomicAdd(out_counts + b, c);
    }
    if (kHalf) {
      const int c = rst::half_at(lcnt, b);   // what is left after the hand-offs
      if (c != 0) atomicAdd(out_counts + b, c);
    }
    const Sum s = lsum[b];
    if (s != Sum(0)) atomicAdd(sums + first_bin + b, s);   // NaN != 0 too
  }
}

int smem_bytes(const Shape& sh, bool counts) {
  const int per_row = 1 << sh.local_bits;
  const int count_bytes = !counts ? 0 : sh.half ? 4 * ((per_row + 1) >> 1) : 4 * per_row;
  return 4 * per_row + count_bytes;
}

// The shape's checks: every bin of [0, 2^bits) has exactly one owner, the
// block fits; 16-bit counts only beside counts; four loads of each plane a
// chunk only for sums alone (the kernel's static_assert holds the hand-off's
// bound for every shape).
bool shape_ok(const Shape& sh, int bits, bool counts) {
  if (sh.threads != 256 && sh.threads != 512 && sh.threads != 1024) return false;
  if (sh.unroll != 2 && (sh.unroll != 4 || counts)) return false;
  if (sh.half < 0 || sh.half > 1 || (sh.half && !counts)) return false;
  if (sh.local_bits < 1 || sh.local_bits > bits || sh.ranges != 1 << (bits - sh.local_bits)) {
    return false;
  }
  return smem_bytes(sh, counts) <= kBlockSmemMax;
}

template <class Sum, int kCounts, int kUnroll>
cudaError_t launch_shape(const uint32_t* keys, const Sum* vals, long long n, uint32_t drop_ge,
                         const Shape& sh, int* counts, Sum* sums, cudaStream_t s) {
  auto kernel = whist_kernel<Sum, kCounts, kUnroll>;
  const int smem = smem_bytes(sh, kCounts != kNoCounts);
  dim3 grid;                 // one wave of blocks, shared among the ranges
  cudaError_t err = rst::wave_grid(kernel, sh.threads, smem, n, 4LL * kUnroll * sh.threads,
                                   sh.ranges, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, sh.threads, smem, s>>>(keys, vals, n, drop_ge, sh.local_bits, counts, sums);
  return cudaGetLastError();
}

// Check the call, zero the outputs, launch; counts null: sums alone (K11,
// kSumsAlone).
template <class Sum, bool kSumsAlone>
int launch_whist(const void* keys, const void* vals, long long n, int bits, unsigned int drop_ge,
                 void* counts, void* sums, const Shape& sh, void* stream) {
  if (bits < 2 || bits > kMaxBits || drop_ge > (1u << bits) || (!counts && !kSumsAlone) ||
      !shape_ok(sh, bits, counts != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bins = size_t{1} << bits;
  cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(Sum) * bins, s);
  if (err == cudaSuccess && counts) err = cudaMemsetAsync(counts, 0, sizeof(int) * bins, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const auto* k = static_cast<const uint32_t*>(keys);
  const auto* v = static_cast<const Sum*>(vals);
  auto* c = static_cast<int*>(counts);
  auto* o = static_cast<Sum*>(sums);
  if constexpr (kSumsAlone) {
    if (!counts) {
      return static_cast<int>(
          sh.unroll == 4 ? launch_shape<Sum, kNoCounts, 4>(k, v, n, drop_ge, sh, c, o, s)
                         : launch_shape<Sum, kNoCounts, 2>(k, v, n, drop_ge, sh, c, o, s));
    }
  }
  return static_cast<int>(sh.half ? launch_shape<Sum, kHalfCounts, 2>(k, v, n, drop_ge, sh, c, o, s)
                                  : launch_shape<Sum, kWordCounts, 2>(k, v, n, drop_ge, sh, c, o, s));
}

}  // namespace

// The launch shape's fields, in the order of cuda_kernels.WhistShape.
#define RST_WHIST_SHAPE_PARAMS int threads, int local_bits, int ranges, int half, int unroll
#define RST_WHIST_SHAPE Shape{threads, local_bits, ranges, half, unroll}

// K10: counts and u32 sums of 2^bits bins.
extern "C" int rst_whist(const void* keys, const void* values, long long n, int bits,
                         unsigned int drop_ge, void* counts, void* sums, RST_WHIST_SHAPE_PARAMS,
                         void* stream) {
  return launch_whist<unsigned int, false>(keys, values, n, bits, drop_ge, counts, sums,
                                    RST_WHIST_SHAPE, stream);
}

// K11: f32 sums of 2^bits bins, and counts unless `counts` is null.
extern "C" int rst_whist_f32(const void* keys, const void* weights, long long n, int bits,
                             unsigned int drop_ge, void* counts, void* sums,
                             RST_WHIST_SHAPE_PARAMS, void* stream) {
  return launch_whist<float, true>(keys, weights, n, bits, drop_ge, counts, sums, RST_WHIST_SHAPE,
                             stream);
}
