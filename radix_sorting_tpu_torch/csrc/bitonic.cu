// K12: bitonic sort of a few word planes by the first num_keys of them.
//
// Replaces radix_sorting_tpu/ops/vmem_sort.py::_bitonic_kernel (K12,
// sort_planes_vmem): the whole network inside one Pallas invocation, every
// plane resident in VMEM, partners fetched with lane and row rolls.
// Contract: P planes of n u32 keys (int32 carriers) in one plane-major (P, n)
// array, for any P whose tile of two keys fits a block's shared memory (the
// wrapper stacks the planes; the JAX package's gate admits up to 1,536 planes
// at 1,024 keys, and the kernel takes them in one launch with no table of
// plane pointers; two or more payload planes reach it as one index plane,
// the wrapper gathering them after the network); the first `keys` are
// compared lexicographically as unsigned words, most significant first, and
// every plane moves with its key.
// The network is that of N = max(1024, next power of two >= n) elements, the
// elements from n on being all-ones keys (the JAX package's padding):
//   for k = 1 .. log2(N), size = 2^k:
//     one step of pairs (i, i ^ (size - 1)) within each block of `size`
//     (the block's mirror), then steps of pairs (i, i + s), i & s == 0, for
//     s = size / 4 .. 1;
//   each pair (lo, hi), lo < hi, swaps its records iff key(lo) > key(hi).
// Every compare-exchange is ascending and swaps only a pair that is out of
// order, so the records are always a permutation of the input (the TPU
// kernel gives both partners of equal key tuples the lower one's record:
// ROADMAP.md, R1), and a padding key, the largest, never moves: a pair whose
// hi is >= n is a no-op. The tile route skips those pairs and never touches
// memory past n; the resident route holds the padding in shared memory and
// runs them. ops/cuda_kernels.bitonic_plain runs the same pairs with the
// padding in place and agrees bit for bit, ties included.
//
// Bound on the H100: each plane read once and written once (0.00031 ms at
// 2^17 keys), so the time is latency: steps, barriers and launches. Routes,
// chosen by the wrapper from the shape alone (cuda_kernels.bitonic_route):
//   * resident (one launch): up to 4 planes, padded to N <= 2^17, live in
//     shared memory, N / C records of each plane a block, C = 8 blocks of
//     one thread-block cluster when N >= 8 x 1,024, else one block; it
//     needs planes * N / C * 4 bytes <= 227 KB (3 planes at 2^17). A block
//     loads its slice once (padding keys all-ones, so the pairs past n are
//     no-ops and need no test) and stores it once. The network runs in
//     trips (cuda_kernels.bitonic_trips, 2 + log2 N words each, so N <=
//     2^17): up to D consecutive steps whose masks are independent over
//     GF(2); a thread loads a coset of 2^D records closed under them into
//     registers (the key words and payloads of every plane; 32-bit codes
//     for addresses), runs the trip's steps there with the exchange
//     specialised for (planes, keys) (each trip shape the schedules make is
//     one case of straight-line code, so registers are renamed across its
//     steps; a table with another shape is refused before the launch), and
//     stores them. D = 5 for one plane at 2^14 records a block (34 trips at
//     2^17 for the network's 153 steps), else 4 (40 trips at 2^17); each
//     trip ends in a block barrier. Records live at a swizzled word
//     (bitonic_swizzle) so a warp's loads of one register fall in 32 banks.
//     A trip whose cosets span blocks (3 at 2^17) reads and writes the
//     others' shared memory (distributed shared memory: mapa,
//     ld/st.shared::cluster), cluster barriers around it; its lanes lie on
//     bits 0-4, so a warp's remote access is 128 contiguous bytes (lanes 8
//     words apart made such a trip several times slower on the H100). 512
//     threads a block: the exchanges bound the time on the cluster's 8 SMs
//     (a trial build without the shared-memory traffic ran as long), and
//     256 threads with more registers ran slower. More planes take tiles:
//     a step-by-step form of this route, one pair a thread, took as much
//     device time as they at 1,024 keys and 1.9 to 2.7 times theirs at
//     4,096 keys x 14 planes and 2^16 keys x 5 or 7 planes
//     (scripts/k12_routes.py on the H100);
//   * tiles (past that: more planes, or past 2^17 keys, up to the gate's
//     6 MB of planes):
//     tiles of T keys (the largest power of two with planes * T * 4 bytes
//     <= 64 KB, at most N, halved down to 256 keys while there are fewer
//     tiles than SMs) run every step whose pairs lie inside a tile in shared
//     memory, one block per tile: all of the sizes up to T in the first
//     launch (reading the input, writing the output), then, for each larger
//     size, the steps of s < T in one launch on the output in place; the
//     steps of larger strides, and the mirror steps of sizes past T, go
//     through device memory, one launch each, one thread per pair.
// The launches of one sort run on the caller's stream in order; the function
// returns after enqueueing them. A refused launch (a cluster the card cannot
// place) returns its error, and the wrapper raises.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <iterator>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileBytes = 64 * 1024;
constexpr int kMaxSharedBytes = 227 * 1024;   // a block's shared memory on the H100
constexpr int kStepThreads = 256;
constexpr int kMinTileLog = 8;           // tiles are halved to fill the SMs, not below 256 keys
constexpr int kResidentThreads = 512;
constexpr int kTripWords = 19;           // cuda_kernels.BITONIC_TRIP_WORDS
constexpr int kMaxTrips = 48;            // 40 at 2^17, the largest size (2 + 17 words a trip)
constexpr int kMaxRegisterPlanes = 4;    // the resident route's planes

// The trips of the resident route (cuda_kernels.bitonic_trips), passed by
// value: every thread reads the same word, from the constant bank.
struct Trips {
  int count;
  uint32_t w[kMaxTrips * kTripWords];
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

// One block per tile of T = 2^log_t keys of the (nplanes, n) arrays. full:
// every size up to T; else the steps of strides T / 2 .. 1 (the tail of a
// larger size's merge). `in` may be `out`: a block reads and writes its tile.
__global__ void bitonic_tile_kernel(const uint32_t* in, uint32_t* out, int nplanes, int keys,
                                    long long n, int log_t, bool full) {
  extern __shared__ uint32_t s[];
  const int T = 1 << log_t;
  const long long base = static_cast<long long>(blockIdx.x) * T;
  const int valid = static_cast<int>(min(static_cast<long long>(T), n - base));
  for (int p = 0; p < nplanes; ++p) {
    for (int i = threadIdx.x; i < valid; i += blockDim.x) s[p * T + i] = in[p * n + base + i];
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
    for (int i = threadIdx.x; i < valid; i += blockDim.x) out[p * n + base + i] = s[p * T + i];
  }
}

// One step through device memory on the (nplanes, n) output in place: the
// mirror step of size 2^k (mirror) or the step at stride 2^k.
__global__ void __launch_bounds__(kStepThreads)
bitonic_step_kernel(uint32_t* x, int nplanes, int keys, long long n, long long pairs, int k,
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
    if (hi < n) exchange(x, n, nplanes, keys, lo, hi);
  }
}


// ---------------------------------------------------------------------------
// The resident route: every plane of the (padded) network in the shared
// memory of one block or of a cluster's blocks.

__device__ __forceinline__ uint32_t swizzle(uint32_t i) {
  return i ^ ((i >> 5) & 31) ^ ((i >> 10) & 31);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A record of code c (block << 16 | swizzled word) of plane p, at its
// shared::cluster address: this block's own (local) or the one c names.
template <bool CROSS>
__device__ __forceinline__ uint32_t record_at(uint32_t s, uint32_t code) {
  const uint32_t local = s + 4 * (code & 0xFFFF);
  if (!CROSS) return local;
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(code >> 16));
  return remote;
}

template <bool CROSS>
__device__ __forceinline__ uint32_t load_record(uint32_t addr) {
  uint32_t v;
  if (CROSS) {
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  } else {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  }
  return v;
}

template <bool CROSS>
__device__ __forceinline__ void store_record(uint32_t addr, uint32_t v) {
  if (CROSS) {
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
  } else {
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
  }
}

__device__ __forceinline__ void barrier(bool cluster_wide) {
  if (cluster_wide) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One compare-exchange of records e < f of a thread's coset: swap iff
// key(e) > key(f), unsigned and lexicographic over the first K planes.
template <int P, int K, int R>
__device__ __forceinline__ void exchange_regs(uint32_t (&x)[P][R], int e, int f) {
  if constexpr (P == 1) {
    const uint32_t a = x[0][e], b = x[0][f];
    x[0][e] = min(a, b);
    x[0][f] = max(a, b);
  } else {
    bool gt = false, eq = true;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      gt |= eq & (x[p][e] > x[p][f]);
      eq &= x[p][e] == x[p][f];
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t a = x[p][e], b = x[p][f];
      x[p][e] = gt ? b : a;
      x[p][f] = gt ? a : b;
    }
  }
}

// A step in a coset's coordinates: a stride pairs (e, e ^ 2^B), a mirror
// (e, e ^ (2^(B+1) - 1)); lo is the record with bit B clear.
template <int P, int K, int R, bool MIRROR, int B>
__device__ __forceinline__ void trip_step(uint32_t (&x)[P][R]) {
  if constexpr ((1 << B) < R) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      if ((e >> B) & 1) continue;
      exchange_regs<P, K, R>(x, e, MIRROR ? e ^ ((2 << B) - 1) : e ^ (1 << B));
    }
  }
}

// A trip of known shape (its step fields F, first step first; a field is
// 1 | mirror << 1 | B << 2) as straight-line code: the compiler renames
// registers across its steps.
template <int P, int K, int R, int... F>
__device__ __forceinline__ void fixed_steps(uint32_t (&x)[P][R]) {
  (trip_step<P, K, R, ((F >> 1) & 1) != 0, (F >> 2)>(x), ...);
}

template <int... F>
__host__ __device__ constexpr uint32_t head_of() {
  uint32_t head = 0;
  int s = 0;
  ((head |= static_cast<uint32_t>(F) << (5 * s++)), ...);
  return head;
}

// The trip shapes cuda_kernels.bitonic_trips makes at the resident route's
// sizes (stride sB = 1 + 4B, mirror mB = 3 + 4B), each one case of
// run_steps; resident_route refuses a table that holds any other.
#define RST_TRIP_SHAPES(X)                                                          \
  X(1) X(5, 1) X(3, 7) X(9, 5, 1) X(1, 11, 5) X(13, 9, 5, 1) X(15, 9, 5, 1)         \
  X(1, 15, 9, 5) X(5, 1, 15, 9) X(9, 5, 1, 15) X(17, 13, 9, 5, 1) X(19, 13, 9, 5, 1) \
  X(1, 19, 13, 9, 5) X(5, 1, 19, 13, 9) X(13, 9, 5, 1, 19)

#define RST_TRIP_HEAD(...) head_of<__VA_ARGS__>(),
constexpr uint32_t kTripHeads[] = {RST_TRIP_SHAPES(RST_TRIP_HEAD)};
#undef RST_TRIP_HEAD
constexpr uint32_t kHeadSteps = 0x1FFFFFFu;   // the five step fields of a head

// The steps of a trip, by its head's shape.
template <int P, int K, int R>
__device__ __forceinline__ void run_steps(uint32_t (&x)[P][R], uint32_t head) {
#define RST_TRIP_CASE(...) \
  case head_of<__VA_ARGS__>(): fixed_steps<P, K, R, __VA_ARGS__>(x); break;
  switch (head & kHeadSteps) {
    RST_TRIP_SHAPES(RST_TRIP_CASE)
    default: break;
  }
#undef RST_TRIP_CASE
}

__host__ __device__ constexpr int lowest_bit(int g) { return (g & 1) ? 0 : 1 + lowest_bit(g >> 1); }

// One trip over the cosets [first, last), blockDim.x (a power of two) at a
// time: each thread loads a coset's 2^D records of every plane (record e =
// gray code g; consecutive gray codes differ by one basis vector, so a
// record's code is one xor from the last), runs the steps, stores the
// records where it found them. A coset's code is the xor of its bits'
// codes: the thread index's bits once a trip, the rest (uniform) a coset.
template <int P, int K, int D, bool CROSS>
__device__ __forceinline__ void run_trip(uint32_t s, int S, const uint32_t* t, int first,
                                         int last) {
  constexpr int R = 1 << D;
  const uint32_t head = t[0];
  const int bits = static_cast<int>(t[1]);
  const uint32_t* codes = t + 2 + D;
  const int tbits = __ffs(blockDim.x) - 1;
  uint32_t basis[D];
#pragma unroll
  for (int b = 0; b < D; ++b) basis[b] = t[2 + b];
  uint32_t mine = 0;
  for (int b = 0; b < tbits; ++b) mine ^= (0u - ((threadIdx.x >> b) & 1u)) & codes[b];
  for (int c = first; c < last; c += blockDim.x) {
    uint32_t code = mine;
    for (int b = tbits; b < bits; ++b) {
      if ((c >> b) & 1) code ^= codes[b];
    }
    uint32_t x[P][R];
    uint32_t at = code;
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (g) at ^= basis[lowest_bit(g)];
      const uint32_t r = record_at<CROSS>(s, at);
#pragma unroll
      for (int p = 0; p < P; ++p) x[p][g ^ (g >> 1)] = load_record<CROSS>(r + 4 * p * S);
    }
    run_steps<P, K, R>(x, head);
    at = code;
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (g) at ^= basis[lowest_bit(g)];
      const uint32_t r = record_at<CROSS>(s, at);
#pragma unroll
      for (int p = 0; p < P; ++p) store_record<CROSS>(r + 4 * p * S, x[p][g ^ (g >> 1)]);
    }
  }
}

// The whole network of N = 2^log_n records on P planes (K keys) in (P, n)
// arrays, one slice of S = 2^log_s records a block (a cluster of N / S
// blocks), in trips of D dimensions.
template <int P, int K, int D>
__global__ void __launch_bounds__(kResidentThreads)
bitonic_resident_kernel(const uint32_t* in, uint32_t* out, long long n, int log_n, int log_s,
                        const __grid_constant__ Trips trips) {
  extern __shared__ uint32_t s[];
  const uint32_t s_addr = shared_addr(s);
  const int S = 1 << log_s;
  const int rank = static_cast<int>(blockIdx.x);   // the grid is one cluster
  const bool clustered = log_s < log_n;
  const long long base = static_cast<long long>(rank) * S;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const long long g = base + i;
      s[p * S + swizzle(i)] = g < n ? in[p * n + g] : (p < K ? 0xFFFFFFFFu : 0u);
    }
  }
  const int cosets = S >> D;
  barrier(clustered && (trips.w[0] >> 31));
  for (int i = 0; i < trips.count; ++i) {
    const uint32_t* t = trips.w + i * kTripWords;
    const bool cross = t[0] >> 31;
    if (cross) {
      run_trip<P, K, D, true>(s_addr, S, t, rank * cosets, (rank + 1) * cosets);
    } else {
      run_trip<P, K, D, false>(s_addr, S, t, rank * cosets, (rank + 1) * cosets);
    }
    barrier(clustered && (cross || (i + 1 < trips.count && (t[kTripWords] >> 31))));
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const long long g = base + i;
      if (g < n) out[p * n + g] = s[p * S + swizzle(i)];
    }
  }
}

using ResidentKernel = void (*)(const uint32_t*, uint32_t*, long long, int, int, const Trips);

// The instantiation for (planes, keys, trip dimensions), up to
// kMaxRegisterPlanes planes (5 dimensions only for one plane).
ResidentKernel resident_kernel(int nplanes, int keys, int dims, int* id) {
  static const ResidentKernel table[] = {
      bitonic_resident_kernel<1, 1, 4>, bitonic_resident_kernel<2, 1, 4>,
      bitonic_resident_kernel<2, 2, 4>, bitonic_resident_kernel<3, 1, 4>,
      bitonic_resident_kernel<3, 2, 4>, bitonic_resident_kernel<3, 3, 4>,
      bitonic_resident_kernel<4, 1, 4>, bitonic_resident_kernel<4, 2, 4>,
      bitonic_resident_kernel<4, 3, 4>, bitonic_resident_kernel<4, 4, 4>,
      bitonic_resident_kernel<1, 1, 5>};
  *id = dims == 5 ? 10 : (nplanes - 1) * nplanes / 2 + keys - 1;
  return table[*id];
}

}  // namespace

namespace {

// The max dynamic shared memory set on each resident instantiation, per
// device (set once, raised when a larger slice comes).
int g_resident_smem[16][11];

int resident_route(const uint32_t* src, uint32_t* dst, int nplanes, int keys, long long n,
                   int log_n, int blocks, const int* trip_words, int nwords, cudaStream_t st) {
  int log_c = 0;
  while ((1 << log_c) < blocks) ++log_c;
  const int log_s = log_n - log_c;
  if ((1 << log_c) != blocks || blocks > 8 || log_s < 10 || log_n > kTripWords - 2 ||
      nplanes > kMaxRegisterPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = 4LL * nplanes << log_s;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  Trips trips;
  trips.count = nwords / kTripWords;
  if (trip_words == nullptr || nwords % kTripWords || trips.count < 1 ||
      trips.count > kMaxTrips) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims = log_n - trip_words[1];   // log_n less the coset bits of the first trip
  if (dims != 4 && !(dims == 5 && nplanes == 1)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < trips.count; ++i) {   // every trip a shape run_steps knows
    const uint32_t head = static_cast<uint32_t>(trip_words[i * kTripWords]);
    const uint32_t* known = std::find(std::begin(kTripHeads), std::end(kTripHeads), head & kHeadSteps);
    if ((head & ~(kHeadSteps | 1u << 31)) || known == std::end(kTripHeads)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  std::memcpy(trips.w, trip_words, sizeof(uint32_t) * nwords);
  int id = 0;
  const ResidentKernel kernel = resident_kernel(nplanes, keys, dims, &id);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16 || g_resident_smem[dev][id] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) g_resident_smem[dev][id] = static_cast<int>(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(std::min(kResidentThreads, (1 << log_s) >> dims));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = blocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, src, dst, n, log_n, log_s, trips);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int tile_route(const uint32_t* src, uint32_t* dst, int nplanes, int keys, long long n, int log_n,
               cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int log_t = log_n;
  while (log_t > 1 && (static_cast<long long>(nplanes) * 4) << log_t > kTileBytes) --log_t;
  while (log_t > kMinTileLog && (n + (1LL << log_t) - 1) >> log_t < sms) --log_t;
  const int T = 1 << log_t;
  if (4LL * nplanes * T > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * nplanes * T;
  const int threads = std::min(1024, T / 2);
  const unsigned tiles = static_cast<unsigned>((n + T - 1) / T);
  err = cudaFuncSetAttribute(bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitonic_tile_kernel<<<tiles, threads, smem, st>>>(src, dst, nplanes, keys, n, log_t, true);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = 1LL << (log_n - 1);
  const unsigned grid = static_cast<unsigned>(
      std::max(1LL, std::min((pairs + kStepThreads - 1) / kStepThreads, 8LL * sms)));
  for (int k = log_t + 1; k <= log_n; ++k) {
    bitonic_step_kernel<<<grid, kStepThreads, 0, st>>>(dst, nplanes, keys, n, pairs, k, true);
    for (int j = k - 2; j >= log_t; --j) {
      bitonic_step_kernel<<<grid, kStepThreads, 0, st>>>(dst, nplanes, keys, n, pairs, j, false);
    }
    bitonic_tile_kernel<<<tiles, threads, smem, st>>>(dst, dst, nplanes, keys, n, log_t, false);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// K12: sort the (nplanes, n) planes `in` by the first `keys` into `out` (a
// separate buffer). blocks: the route the wrapper chose from the shape
// (cuda_kernels.bitonic_route): 1 or 8, resident in one block or one
// cluster, with the trips of cuda_kernels.bitonic_trips (`nwords` int32
// words); 0, tiles and steps through device memory.
extern "C" int rst_bitonic(const void* in, void* out, int nplanes, int keys, long long n,
                           int blocks, const int* trip_words, int nwords, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nplanes < 1 || keys < 1 || keys > nplanes) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int log_n = 10;  // N >= 1024, as the JAX package pads
  while ((1LL << log_n) < n) ++log_n;
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (blocks > 0) {
    return resident_route(src, dst, nplanes, keys, n, log_n, blocks, trip_words, nwords, st);
  }
  return tile_route(src, dst, nplanes, keys, n, log_n, st);
}
