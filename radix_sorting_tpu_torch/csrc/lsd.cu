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
// Bound on the H100: bytes. A pass must read each plane once and write it
// once; L1 reads the digit plane once more and writes tiles * 2^bits
// counters. Neither does arithmetic worth counting.
//
// L1 (per-tile histogram). One block of 256 threads per (tile, counter
// range). What held the first version back: one scalar load a thread a
// step, every thread of the block adding into one shared table, and past
// 2^15 bins a cudaMemsetAsync of the whole (tiles x 2^16) output followed
// by one global atomic a key. Now:
//   * the tile is read in 16-byte loads, four in flight a thread (a head of
//     up to 3 words brings the read onto the 16-byte grid, whatever the
//     tile's start; a tail of up to 3 words ends it);
//   * counters in shared memory only: 2^bits of them, or ranges of 2^14
//     (64 KB) when 2^bits is larger, one grid block per (tile, range), the
//     ranges of a tile neighbours in the grid so that their re-reads of the
//     tile (256 KB at 16 bits) come from the L2 cache;
//   * while copies x range <= 8,192 counters, each warp (or group of warps)
//     adds into a sub-histogram of its own (8 at r = 8, 4 at r = 11), and
//     the copies are summed as the row is written;
//   * the block writes its whole row (or range of it), zeros included: no
//     memset and no global atomic at any digit width.
//
// L2 (stable scatter), staged form (digits of up to 12 bits, any tile). What
// held the first staged version back: the key plane read from device memory
// twice (count, then rank), every other plane read one scalar word a thread,
// one key a lane per rank step, 8 warps and 74 KB of shared memory a block,
// 4 warps at r = 11, and the rank's __match_any_sync, which takes a pass per
// distinct digit. Now one block per tile, in stages of S = threads x
// keys-a-thread keys (the host picks the shape, cuda_kernels.
// lsd_scatter_shape; the entry refuses any other):
//   * a thread loads its K keys of the stage into registers once (warp w
//     holds stage positions [w * 32K, (w + 1) * 32K), lane l the positions
//     w * 32K + k * 32 + l: coalesced words at any alignment, K loads in
//     flight), and the first payload plane's K words right after them, so
//     that they land while the keys are ranked;
//   * count and rank in one pass over the keys in registers (Onesweep's
//     block rank, Adinets & Merrill 2022, without its look-back): for k in
//     order, one ballot a digit bit gives the lanes of the same digit
//     (peers_of; unrolled for the engine's 8- and 11-bit digits), a lane's
//     rank among them the popcount of the lower lanes, and the group's
//     highest lane moves the warp's counter of the digit on; one scan over
//     (digit, warp), digit-major, then gives each key its slot in the
//     stage's stable digit order. Every step is whole: a short stage is
//     filled with kSentinel, so no step votes or branches on its valid
//     lanes and the unrolled steps are straight-line code;
//   * the keys land in shared memory at their slots and the block writes
//     them out in slot order, so that neighbouring threads write runs of one
//     digit: slot j of digit d goes to run[d] + j - first[d], where run[d]
//     is bases[t][d] plus the keys of d in the tile's earlier stages
//     (kept in shared memory across the stages of a long tile);
//   * each write-out thread keeps its K destinations in registers, and
//     every payload plane goes through the same slots: its words (loaded
//     while the previous plane was written) to the slots, one barrier, out
//     to the destinations. Each plane of a tile is read from device memory
//     once; a group of planes without the digit plane still reads the keys
//     once, for the digits, and does not write them;
//   * the slots' indices are kept two to a register, 16 bits each, so a
//     stage holds at most 65,536 keys.
// What bounds it: the SM's issue and shared-memory pipes, not device memory
// (trial builds of L2's first staged form: with the pass's reads or writes
// taken out no faster). L2 and K0's sweep share the rank, ballots; at 11
// and 12 bits a shared-memory match table would be 8 warps x 2^12 words,
// 128 KB a block, and the sweep's own did not pay (below). Tried and
// dropped: a block-local LSD sort of the stage in 4- to 6-bit passes with
// per-thread counters (no votes, but about four times the shared-memory
// traffic: slower); a returning shared atomic in place of the leader's
// update; folding the digits' first slots into the per-warp counters;
// issuing the payload loads after the rank; staging the first payload plane
// in a second row of slots beside the keys.
// L2, direct form (digits of 13 to 16 bits): one warp per tile walks the
// tile in input order, 32 keys a step, peers_of on the digit, and
// stores each key and payload word straight to its destination; the
// running counters are a device-memory copy of the bases (cudaMemcpyAsync),
// a tile's row (256 KB at 16 bits) staying in the L2 cache.
// At 16 bits and 40M keys a (tile, digit) run averages about one key, so the
// pass is a scatter of 4-byte words whatever its form: the bytes bound is
// out of reach there. Both forms take at most 32 planes a launch.
//
// The tile bounds the histogram: tiles * 2^bits int32 are written, scanned
// and read once per pass, so the caller takes tiles of at least 2^bits keys.
//
// K0's sweep (rst_k0_sweep): one launch a live digit of K0, the port's
// sorter of one plane (ops/hw_engine.py). It replaces no Pallas kernel but
// XLA's lax.sort (radix_sorting_tpu/ops/hw_engine.py:56, and :75 for the
// argsort with the index as a last key). Contract: for 8-bit digits and
// tiles of 8,192 keys, out_p[starts[d(i)] + #{j < i : d(j) == d(i)}] =
// in_p[i], with starts the exclusive scan of the digit's global histogram
// (K0 reads every digit's in one K1 live_digits); a null in_p is the
// position i, and a wide out_p takes i's word zero-extended to 8 bytes.
// What it removes from K0's L1 + scan + L2 pass (Onesweep, Adinets &
// Merrill 2022): L1's second read of the keys, the (tiles, 256) counts
// written and read, the scan's two transposes and cumsum; and for the
// argsort the index plane's generic fill and first read (the first live
// pass takes the position) and the int64 cast (the last live pass writes
// the asked width).
//   * The body is L2's staged form at (256 threads, 32 keys): one stage a
//     tile, a digit a thread. The block takes its tile from a ticket
//     (atomicAdd on a device counter), not blockIdx, so every tile it waits
//     on belongs to a block already running.
//   * The rank is L2's: eight ballots a step, every step whole (kSentinel
//     past the end of the pass's last tile).
//   * Once the tile's counts are known, each thread publishes its digit's
//     count in the tile's status word (tile 0: as inclusive). After the
//     keys are staged in their slots, it looks back over the earlier
//     tiles' words, summing counts to the first inclusive one, and
//     publishes the tile's inclusive prefix; the wait overlaps the block's
//     own scan and staging. Then the write-out as L2's.
//   * Status words are 64 bits: (tag << 32) | count, so counts of up to
//     n < 2^31 keys need no bits of their own. The tag carries the pass's
//     epoch (2e aggregate, 2e + 1 inclusive), so one buffer of (tiles, 256)
//     words and the ticket counter serve every pass of a call, zeroed once
//     a call; pass e's tickets run from (e - 1) * tiles. Stores and loads
//     are relaxed at GPU scope: the word itself is the only datum.
//   * A look-back that polls one word 2^24 times traps (a failed launch,
//     never a hung card); so does a ticket outside the pass.
// Bound on the H100: bytes, each plane read once and written once a pass
// (the index written alone by the first pass, 8 bytes a key by a wide last
// pass), 2 KB of status words a tile. What bounds it now is none of its
// parts alone: at 40M keys, trial builds (scratch copies, not kept) with the
// look-back's waits, the leader's counter or the key writes taken out each
// ran 7 to 11% faster; two blocks an SM (128 registers a thread, spills
// included) leave each block's barrier-separated phases little to overlap.
// Tried and dropped for the rank, each checked bit for bit and timed in
// turns at 40M keys (a keys-only pass, against the whole-step ballots or
// the ballots of the same build): a shared-memory OR of the lane's bit
// into a per-warp digit word, read back as the peers (CUB's
// WARP_MATCH_ATOMIC_OR), with one table and
// three __syncwarp a step (+6 to +10%) or three tables and one (+8%; with
// whole steps +1% on uniform keys and +29% where a third of the keys share
// a digit: the lanes of one word serialize their atomics);
// __match_any_sync (+59%); each lane's id stored at its digit and the five
// ballots of the id read back (-1.5%; with whole steps, no faster than the
// whole-step ballots); every lane reading the counter in place of the
// leader's shuffle (spills: +13%, the argsort's passes +24 to +28%);
// staging the sentinels too, without the bound test (spills: the argsort's
// passes +14%).
// The pair (kPairIn, kPairOut): K0's two key planes as the halves of one
// dense 64-bit buffer, so that an ascending u64 key needs no split before
// K0 and no join after it. The first live pass reads the caller's words
// where they lie, one 8-byte load a key giving both planes' words; the last
// live pass stages each key with its pair's other word in 8-byte slots (64
// KB a block: still two blocks an SM) and writes both in one 8-byte store
// into one fresh buffer. Timed at 40M uniform keys on the H100 (CUDA
// events, in turns, run DX): the pair-in first pass 0.3525 ms, the pair-out
// last pass 0.3034, both in one launch 0.3388, against a dense two-plane
// pass's 0.3633 / 0.3642. Dropped: 4-byte accesses to each half, 8 bytes
// apart (the second half's loads from the first's sectors): in 0.3564, out
// 0.5331 and both 0.5406, the scattered 4-byte stores of the two halves
// each writing half a sector.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kBlockSmemMax = 232448;       // a block's shared memory on the H100

// L1
constexpr int kHistThreads = 256;
constexpr int kHistRangeMaxBits = 14;       // 2^14 int32 counters (64 KB) a block
constexpr int kHistCopyCounters = 8192;     // sub-histograms while copies x range fit
constexpr int kHistUnroll = 4;              // 16-byte loads in flight a thread

// L2
constexpr int kStageMaxBits = 12;           // staged form: digits of up to 12 bits; direct past
constexpr int kUnroll = 4;                  // direct form: key loads in flight a lane

// The staged L2's shapes (threads, keys a thread); cuda_kernels.py
// LSD_STAGE_SHAPES lists the same.
#define RST_LSD_SHAPES(X) X(256, 8) X(256, 16) X(256, 32)

struct Planes {
  const uint32_t* in[kMaxPlanes];   // K0's sweep: null for the index as each key's position
  uint32_t* out[kMaxPlanes];
  int count;
  int digit;      // the index of the digit plane among them, or -1
  unsigned wide;  // K0's sweep: bit p set where out[p] takes 8-byte words (zero-extended)
};

// Shared-memory bytes of a staged L2 block: per-warp counters, the digits'
// first slots, destination offsets and running bases, 32 warp sums, and the
// stage's slots.
constexpr long long stage_smem(int threads, int keys, int bits) {
  return 4LL * ((threads / 32 + 3) * (1LL << bits) + 32 + static_cast<long long>(threads) * keys);
}

__global__ void __launch_bounds__(kHistThreads)
lsd_hist_kernel(const uint32_t* __restrict__ w, long long n, int shift, int bits,
                long long tile, int range_bits, int copies, int* __restrict__ hist) {
  extern __shared__ int local[];
  const int ranges = 1 << (bits - range_bits);
  const long long t = blockIdx.x / ranges;
  const uint32_t range = blockIdx.x % ranges;
  const int size = 1 << range_bits;
  const uint32_t digit_mask = (1u << bits) - 1u;
  int4* local4 = reinterpret_cast<int4*>(local);
  for (int c = threadIdx.x; c < (copies * size) / 4; c += blockDim.x) {
    local4[c] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  int* mine = local + ((threadIdx.x >> 5) % copies) * size;
  auto add = [&](uint32_t v) {
    const uint32_t d = (v >> shift) & digit_mask;
    if ((d >> range_bits) == range) atomicAdd(mine + (d & (size - 1)), 1);
  };
  const long long first = t * tile;
  const long long end = min(n, first + tile);
  const long long lead = (4 - ((reinterpret_cast<uintptr_t>(w + first) >> 2) & 3)) & 3;
  const long long body = min(end, first + lead);
  for (long long i = first + threadIdx.x; i < body; i += blockDim.x) add(__ldg(w + i));
  const long long quads = (end - body) >> 2;
  const uint4* w4 = reinterpret_cast<const uint4*>(w + body);
  for (long long q0 = threadIdx.x; q0 < quads; q0 += kHistUnroll * blockDim.x) {
    uint4 v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const long long q = q0 + u * blockDim.x;
      if (q < quads) v[u] = __ldg(w4 + q);
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      if (q0 + u * blockDim.x < quads) {
        add(v[u].x);
        add(v[u].y);
        add(v[u].z);
        add(v[u].w);
      }
    }
  }
  for (long long i = body + 4 * quads + threadIdx.x; i < end; i += blockDim.x) {
    add(__ldg(w + i));
  }
  __syncthreads();
  int* row = hist + (t << bits) + (static_cast<long long>(range) << range_bits);
  for (int b = threadIdx.x; b < size; b += blockDim.x) {
    int sum = 0;
    for (int c = 0; c < copies; ++c) sum += local[c * size + b];
    row[b] = sum;
  }
}

// The lanes of the warp whose bit b of `label` equals this lane's: one
// ballot (CUB's MatchAny, bit by bit).
__device__ __forceinline__ unsigned same_bit(uint32_t label, int b) {
  unsigned mask;
  asm("{\n .reg .pred p;\n and.b32 %0, %1, %2;\n setp.ne.u32 p, %0, 0;\n"
      " vote.ballot.sync.b32 %0, p, 0xffffffff;\n @!p not.b32 %0, %0;\n}\n"
      : "=r"(mask) : "r"(label), "r"(1u << b));
  return mask;
}

// The lanes of the warp whose digit d (its low `bits` bits; B > 0: B bits
// known when compiled, the ballots unrolled) equals this lane's, from one
// ballot a digit bit: the native __match_any_sync takes a pass per distinct
// value, and at 2^8 bins and more a warp's 32 digits are nearly all distinct
// (the first L2 spent most of its time there). Lanes with ok false group
// only with each other; every lane of the warp calls it.
template <int B>
__device__ __forceinline__ unsigned peers_of(uint32_t d, int bits, bool ok, bool all_ok) {
  unsigned peers = 0xFFFFFFFFu;
  if (!all_ok) {
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, ok);
    peers = ok ? vote : ~vote;
  }
  if (B > 0) {
#pragma unroll
    for (int b = 0; b < B; ++b) peers &= same_bit(d, b);
  } else {
    for (int b = 0; b < bits; ++b) peers &= same_bit(d, b);
  }
  return peers;
}

__global__ void __launch_bounds__(32)
lsd_scatter_kernel(const uint32_t* __restrict__ w, Planes planes, long long n, int shift,
                   int bits, long long tile, int* __restrict__ counters_all) {
  const int bins = 1 << bits;
  const uint32_t digit_mask = static_cast<uint32_t>(bins) - 1u;
  const int lane = threadIdx.x;
  const long long t = blockIdx.x;
  int* counters = counters_all + t * bins;   // the tile's row of the caller's copy of the bases
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
      // lanes past the tile's end group only with each other and take no
      // counter
      const uint32_t d = (v[u] >> shift) & digit_mask;
      const unsigned peers = peers_of<0>(d, bits, valid, chunk + 32 * (u + 1) <= end);
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

// K 16-bit values, two to a register; k is a compile-time index once the
// loops that use it are unrolled.
template <int K>
struct Halves {
  uint32_t word[(K + 1) / 2];
  __device__ __forceinline__ uint32_t get(int k) const {
    return (word[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu;
  }
  __device__ __forceinline__ void set(int k, uint32_t v) {
    const int s = (k & 1) * 16;
    word[k >> 1] = (word[k >> 1] & ~(0xFFFFu << s)) | (v << s);
  }
};

// The staged L2's rank: for each of a thread's K keys (stage position
// own_first + 32k) its rank among the earlier keys of its digit in its warp
// (input order: step k, then the lanes), the warp's counters `own` moved on
// by each step's group. The group is one ballot a digit bit (peers_of<B>; B
// = 0: the width at run time); its highest lane moves the counter on. Every
// step is whole: a short stage's keys past the end are kSentinel.
template <int B, int K>
__device__ __forceinline__ void warp_rank(const uint32_t (&key)[K], Halves<K>& rank, int* own,
                                          int shift, int bits) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t digit_mask = (1u << bits) - 1u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t d = (key[k] >> shift) & digit_mask;
    const unsigned peers = peers_of<B>(d, bits, true, true);
    const int leader = 31 - __clz(peers);
    int start = 0;
    if (lane == leader) {
      start = own[d];
      own[d] = start + __popc(peers);
    }
    start = __shfl_sync(0xFFFFFFFFu, start, leader);
    rank.set(k, static_cast<uint32_t>(start + __popc(peers & below)));
    __syncwarp();  // the next step's leaders see the moved counters
  }
}

// The first plane after p that is not the digit plane (planes.count: none).
__device__ __forceinline__ int next_payload(const Planes& planes, int p) {
  ++p;
  return p == planes.digit ? p + 1 : p;
}

// The key past the end of a short stage (a tile's last), so that the rank
// takes whole steps. Its digit, (~0u >> shift) & (2^bits - 1), is the
// largest any key has at that shift, and the sentinels stand after every key
// of the stage: they rank after every key of their digit and take the slots
// [valid, stage), which are never written. The counts they add are read by
// no later stage or tile: the tile's `run`, and the sweep's published count
// of the last tile.
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// A thread's K words of the plane `in` at the stage positions own_first +
// 32k of the stage that starts at key s0 (kSentinel past `valid`); with
// kPosition, a null plane gives each key's position.
template <bool kPosition, int K>
__device__ __forceinline__ void load_stage(const uint32_t* in, long long s0, int own_first,
                                           int valid, uint32_t (&v)[K]) {
  if (kPosition && in == nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = static_cast<uint32_t>(s0 + own_first + k * 32);
    return;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = own_first + k * 32;
    v[k] = p < valid ? __ldg(in + s0 + p) : kSentinel;
  }
}

// K0's pair layout: planes 0 (hi) and 1 (lo) are the odd and even words of
// one dense 64-bit buffer, in[0] == in[1] + 1 (kPairIn) or out[0] == out[1]
// + 1 (kPairOut), and the digit plane is one of them.
constexpr int kPairIn = 1, kPairOut = 2;

// Blocks an SM the registers allow: a thread holds 3K words (its keys or
// destinations, the carried plane, its slots two to a word) and about 32
// more.
template <int T, int K>
constexpr int stage_blocks_per_sm() {
  return 65536 / (T * (3 * K + 32));
}

// Where a staged block finds its tile and its digits' bases.
// L2: tile blockIdx.x, the caller's (tiles, 2^bits) table of bases.
struct TableBases {
  static constexpr bool kLookBack = false;
  const int* table;
};

// K0's sweep: the tile is a ticket, and a digit's base is its start (the
// exclusive scan of the digit's global histogram) plus the keys of the
// digit in earlier tiles, found by the decoupled look-back over `status`.
// A status word is (tag << 32) | count: tag 2 * epoch for the tile's own
// count (aggregate), 2 * epoch + 1 for its inclusive prefix; any smaller
// tag is an earlier pass's word or the zero fill, not yet published.
struct LookBack {
  static constexpr bool kLookBack = true;
  const int* starts;             // [2^bits]
  unsigned long long* status;    // [tiles][2^bits], then the ticket counter
  long long tiles;
  unsigned epoch;                // the pass's number in the call, from 1
};

// Polls of one status word before a look-back gives up and traps: a launch
// that fails, where a lost predecessor would otherwise hang the card.
constexpr unsigned kSpinLimit = 1u << 24;

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned tag, unsigned count) {
  return (static_cast<unsigned long long>(tag) << 32) | count;
}

// The keys of digit d in the tiles before t: the predecessors' words summed
// back to the first inclusive one; then t's own inclusive prefix is
// published. Tile 0 published its inclusive count with its aggregate.
__device__ unsigned look_back(const LookBack& lb, long long t, int d, int bins, int count) {
  const unsigned aggregate = 2u * lb.epoch, inclusive = aggregate + 1u;
  if (t == 0) return 0u;
  unsigned prefix = 0u, spins = 0u;
  for (long long j = t - 1;;) {
    const unsigned long long s = load_relaxed(lb.status + j * bins + d);
    const unsigned tag = static_cast<unsigned>(s >> 32);
    if (tag < aggregate) {
      if (++spins == kSpinLimit) __trap();
      continue;
    }
    prefix += static_cast<unsigned>(s);
    if (tag == inclusive) break;
    --j;
  }
  store_relaxed(lb.status + t * bins + d, status_word(inclusive, prefix + count));
  return prefix;
}

// The staged form, one block of T threads per tile, the tile in stages of
// T * K keys; shared memory (ints): counters [T / 32][bins], first [bins],
// dest_off [bins], run [bins], 32 warp sums, slots [T * K] (kPairOut:
// 8-byte slots). With LookBack the tile is one stage (the entry refuses any
// other) and `run` holds the tile's count of each digit until the
// look-back. kPair (K0): the pair is read (kPairIn) or written (kPairOut)
// with one 8-byte access a key, its two words together.
template <int T, int K, class Bases, int kPair = 0>
__device__ __forceinline__ void staged_scatter(const uint32_t* __restrict__ w, Planes planes,
                                               long long n, int shift, int bits, long long tile,
                                               const Bases& bases) {
  constexpr int kWarps = T / 32;
  constexpr int kStage = T * K;
  constexpr bool kIn = (kPair & kPairIn) != 0, kOut = (kPair & kPairOut) != 0;
  extern __shared__ int smem[];
  const int bins = 1 << bits;
  const uint32_t digit_mask = static_cast<uint32_t>(bins) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* counters = smem;                       // [kWarps][bins]
  int* first = counters + kWarps * bins;      // [bins]: the stage's counts, then first slots
  int* dest_off = first + bins;               // [bins]: destination of slot j is dest_off + j
  int* run = dest_off + bins;                 // [bins]: the tile's bases past earlier stages
  int* warp_sums = run + bins;                // [32]
  uint32_t* slots = reinterpret_cast<uint32_t*>(warp_sums + 32);  // [kStage]
  uint2* slots8 = reinterpret_cast<uint2*>(slots);                 // kOut: [kStage]
  long long t = blockIdx.x;
  const int* base_row = nullptr;
  if constexpr (Bases::kLookBack) {
    // a ticket, not blockIdx: every tile this block waits on belongs to a
    // block that took its ticket first, so is running or done
    __shared__ long long ticket;
    if (threadIdx.x == 0) {
      const long long got =
          static_cast<long long>(atomicAdd(bases.status + bases.tiles * bins, 1ull)) -
          static_cast<long long>(bases.epoch - 1) * bases.tiles;
      if (got < 0 || got >= bases.tiles) __trap();  // status not zeroed, or a pass skipped
      ticket = got;
    }
    __syncthreads();
    t = ticket;
  } else {
    base_row = bases.table + t * bins;
  }
  const long long tile_first = t * tile;
  const long long tile_end = min(n, tile_first + tile);
  const bool staged_run = !Bases::kLookBack && tile_end - tile_first > kStage;
  if (staged_run) {
    for (int d = threadIdx.x; d < bins; d += T) run[d] = base_row[d];
  }
  const int own_first = warp * 32 * K + lane;  // the thread's first stage position
  int* own = counters + warp * bins;
  const int payload0 = next_payload(planes, -1);   // a pair: its other half
  uint32_t* key_out = planes.digit >= 0 ? planes.out[planes.digit] : nullptr;
  const bool lo_digit = planes.digit == 1;          // a pair: the digit in lo
  for (long long s0 = tile_first; s0 < tile_end; s0 += kStage) {
    const int valid = static_cast<int>(min(static_cast<long long>(kStage), tile_end - s0));
    uint32_t key[K], carried[K];
    if constexpr (kIn) {            // a key's two words in one load, lo first
      const uint2* in8 = reinterpret_cast<const uint2*>(planes.in[1]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int p = own_first + k * 32;
        const uint2 v = p < valid ? __ldg(in8 + s0 + p) : make_uint2(kSentinel, kSentinel);
        key[k] = lo_digit ? v.x : v.y;
        carried[k] = lo_digit ? v.y : v.x;
      }
    } else {
      load_stage<false>(w, s0, own_first, valid, key);
      if (payload0 < planes.count) {
        load_stage<Bases::kLookBack>(planes.in[payload0], s0, own_first, valid, carried);
      }
    }
    int4* counters4 = reinterpret_cast<int4*>(counters);
    for (int c = threadIdx.x; c < kWarps * bins / 4; c += T) counters4[c] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // each key's rank among the earlier keys of its digit in its warp; the
    // engine's digit widths with their ballots unrolled
    Halves<K> slot;
#pragma unroll
    for (int k = 0; k < K; ++k) slot.word[k >> 1] = 0u;
    switch (bits) {
      case 8: warp_rank<8>(key, slot, own, shift, bits); break;
      case 11: warp_rank<11>(key, slot, own, shift, bits); break;
      default: warp_rank<0>(key, slot, own, shift, bits); break;
    }
    __syncthreads();

    // per digit: each warp's first rank within the digit, and its count;
    // the destination base of the digit (LookBack: the count published, the
    // base found after the staging)
    for (int d = threadIdx.x; d < bins; d += T) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c = counters[v * bins + d];
        counters[v * bins + d] = sum;
        sum += c;
      }
      first[d] = sum;
      if constexpr (Bases::kLookBack) {
        run[d] = sum;
        const unsigned tag = 2u * bases.epoch + (t == 0 ? 1u : 0u);
        store_relaxed(bases.status + t * bins + d, status_word(tag, sum));
      } else {
        dest_off[d] = staged_run ? run[d] : base_row[d];
      }
    }
    __syncthreads();
    // the digits' first slots: an exclusive scan of the counts, a run of
    // digits a thread
    {
      const int per = (bins + T - 1) / T;
      const int d0 = min(bins, static_cast<int>(threadIdx.x) * per);
      const int d1 = min(bins, d0 + per);
      int sum = 0;
      for (int d = d0; d < d1; ++d) sum += first[d];
      int start = block_exclusive_sum(sum, warp_sums);
      for (int d = d0; d < d1; ++d) {
        const int count = first[d];
        const int base = Bases::kLookBack ? 0 : dest_off[d];
        first[d] = start;
        dest_off[d] = base - start;
        if (staged_run) run[d] = base + count;
        start += count;
      }
    }
    __syncthreads();

    // the keys to their slots: the stage in stable digit order
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (own_first + k * 32 < valid) {
        const uint32_t d = (key[k] >> shift) & digit_mask;
        const uint32_t s = static_cast<uint32_t>(first[d] + own[d]) + slot.get(k);
        slot.set(k, s);
        if constexpr (kOut) {       // staged with the other half of its pair
          slots8[s] = make_uint2(key[k], carried[k]);
        } else {
          slots[s] = key[k];
        }
      }
    }
    if constexpr (Bases::kLookBack) {
      for (int d = threadIdx.x; d < bins; d += T) {
        dest_off[d] += bases.starts[d] + static_cast<int>(look_back(bases, t, d, bins, run[d]));
      }
    }
    __syncthreads();
    // out in slot order, so that neighbouring threads write runs of one
    // digit; each slot's destination kept
    int dest[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int j = m * T + threadIdx.x;
      dest[m] = 0;
      if (j < valid) {
        if constexpr (kOut) {       // both words of the pair in one store, lo first
          const uint2 v = slots8[j];
          dest[m] = dest_off[(v.x >> shift) & digit_mask] + j;
          reinterpret_cast<uint2*>(planes.out[1])[dest[m]] = lo_digit ? v : make_uint2(v.y, v.x);
        } else {
          const uint32_t v = slots[j];
          dest[m] = dest_off[(v >> shift) & digit_mask] + j;
          if (key_out != nullptr) key_out[dest[m]] = v;
        }
      }
    }
    // every other plane through the same slots, the next one's loads in
    // flight while this one is written (kOut: the pair's other half is
    // written, the next plane loaded now)
    int p = payload0;
    if constexpr (kOut) {
      p = next_payload(planes, payload0);
      if (p < planes.count) {
        load_stage<Bases::kLookBack>(planes.in[p], s0, own_first, valid, carried);
      }
    }
    while (p < planes.count) {
      __syncthreads();  // the slots' last readers are done
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (own_first + k * 32 < valid) slots[slot.get(k)] = carried[k];
      }
      const int after = next_payload(planes, p);
      if (after < planes.count) {
        load_stage<Bases::kLookBack>(planes.in[after], s0, own_first, valid, carried);
      }
      __syncthreads();
      if (Bases::kLookBack && ((planes.wide >> p) & 1u)) {
        unsigned long long* out = reinterpret_cast<unsigned long long*>(planes.out[p]);
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const int j = m * T + threadIdx.x;
          if (j < valid) out[dest[m]] = slots[j];
        }
      } else {
        uint32_t* out = planes.out[p];
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const int j = m * T + threadIdx.x;
          if (j < valid) out[dest[m]] = slots[j];
        }
      }
      p = after;
    }
    __syncthreads();  // before the next stage reuses the counters and slots
  }
}

// Staged L2.
template <int T, int K>
__global__ void __launch_bounds__(T, stage_blocks_per_sm<T, K>())
lsd_scatter_staged_kernel(const uint32_t* __restrict__ w, Planes planes, long long n,
                          int shift, int bits, long long tile, const int* __restrict__ bases) {
  staged_scatter<T, K>(w, planes, n, shift, bits, tile, TableBases{bases});
}

// K0's sweep: L2's staged form at one stage a tile, with the look-back.
constexpr int kSweepThreads = 256, kSweepKeys = 32;
constexpr int kSweepBits = 8;                                  // a digit a thread
constexpr long long kSweepTile = kSweepThreads * kSweepKeys;   // 8,192 keys

template <int kPair>
__global__ void __launch_bounds__(kSweepThreads, stage_blocks_per_sm<kSweepThreads, kSweepKeys>())
k0_sweep_kernel(const uint32_t* __restrict__ w, Planes planes, long long n, int shift,
                LookBack lb) {
  staged_scatter<kSweepThreads, kSweepKeys, LookBack, kPair>(w, planes, n, shift, kSweepBits,
                                                             kSweepTile, lb);
}

// One sweep launch; kPair & kPairOut: 8-byte slots, 64 KB, still two blocks
// an SM.
template <int kPair>
cudaError_t launch_sweep(const uint32_t* keys, const Planes& p, long long n, int shift,
                         const LookBack& lb, cudaStream_t s) {
  auto kernel = k0_sweep_kernel<kPair>;
  constexpr int slots8 = (kPair & kPairOut) ? 4 * kSweepThreads * kSweepKeys : 0;
  constexpr int smem =
      static_cast<int>(stage_smem(kSweepThreads, kSweepKeys, kSweepBits)) + slots8;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(lb.tiles), kSweepThreads, smem, s>>>(keys, p, n, shift, lb);
  return cudaGetLastError();
}

template <int T, int K>
cudaError_t launch_staged(const uint32_t* keys, const Planes& p, long long n, int shift,
                          int bits, long long tile, long long tiles, const int* bases,
                          int smem, cudaStream_t s) {
  auto kernel = lsd_scatter_staged_kernel<T, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), T, smem, s>>>(keys, p, n, shift, bits, tile, bases);
  return cudaGetLastError();
}

}  // namespace

// L1: (tiles, 2^bits) int32 per-tile histograms of one digit.
extern "C" int rst_lsd_hist(const void* keys, long long n, int shift, int bits,
                            long long tile, void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits < 1 || bits > 16 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n + tile - 1) / tile;
  if (tiles == 0) return 0;
  const int range_bits = bits < kHistRangeMaxBits ? bits : kHistRangeMaxBits;
  const long long blocks = tiles << (bits - range_bits);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int per_copy = kHistCopyCounters >> range_bits;
  const int copies = per_copy < 1 ? 1 : (per_copy > kHistThreads / 32 ? kHistThreads / 32
                                                                       : per_copy);
  const int smem = static_cast<int>(sizeof(int)) * (copies << range_bits);
  cudaError_t err = cudaFuncSetAttribute(lsd_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lsd_hist_kernel<<<static_cast<unsigned>(blocks), kHistThreads, smem, s>>>(
      static_cast<const uint32_t*>(keys), n, shift, bits, tile, range_bits, copies,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// L2: the stable scatter of `planes` planes (at most 32) by one digit of
// `keys`. Digits of up to 12 bits take the staged form, with
// (threads, keys_per_thread) one of RST_LSD_SHAPES and `smem` its
// shared-memory bytes; digits of 13 to 16 bits the direct form, with
// threads = 0 and `counters` scratch of tiles * 2^bits int32 (the bases are
// copied into it). Any other shape is refused before the launch.
extern "C" int rst_lsd_scatter(const void* keys, const void* const* in, void* const* out,
                               int planes, long long n, int shift, int bits, long long tile,
                               const void* bases, void* counters, int threads,
                               int keys_per_thread, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || planes > kMaxPlanes || bits < 1 || bits > 16 || tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n + tile - 1) / tile;
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  Planes p{};
  p.count = planes;
  p.digit = -1;
  for (int i = 0; i < planes; ++i) {
    p.in[i] = static_cast<const uint32_t*>(in[i]);
    p.out[i] = static_cast<uint32_t*>(out[i]);
    if (in[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (in[i] == keys) p.digit = i;
  }
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const int* b = static_cast<const int*>(bases);
  if (bits <= kStageMaxBits) {
    if (smem > kBlockSmemMax || smem != stage_smem(threads, keys_per_thread, bits)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define RST_LSD_LAUNCH(T, K)                                                              \
  if (threads == T && keys_per_thread == K) {                                             \
    return static_cast<int>(launch_staged<T, K>(k, p, n, shift, bits, tile, tiles, b, smem, s)); \
  }
    RST_LSD_SHAPES(RST_LSD_LAUNCH)
#undef RST_LSD_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (threads != 0 || counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bins = size_t{1} << bits;
  const cudaError_t err = cudaMemcpyAsync(counters, bases,
                                          sizeof(int) * bins * static_cast<size_t>(tiles),
                                          cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  lsd_scatter_kernel<<<static_cast<unsigned>(tiles), 32, 0, s>>>(
      k, p, n, shift, bits, tile, static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// K0's sweep: one stable pass of the 8-bit digit at `shift` over tiles of
// 8,192 keys, `planes` planes (at most 32) in one launch. `starts` holds the
// digit's 256 global starts, `status` the call's zeroed (tiles x 256) status
// words and ticket counter, `epoch` the pass's number in the call (1, 2, ...
// on one status buffer). A null in[p] is the index as each key's position;
// bit p of `wide` writes out[p] in 8-byte words. `pair` bit 0: in[0] and
// in[1] are a pair (in[0] == in[1] + 1, in[1] 8-byte aligned), read where
// they lie; bit 1: out[0] and out[1] are one, both written into it; either
// way the digit plane is plane 0 or 1. Anything else is refused.
extern "C" int rst_k0_sweep(const void* keys, const void* const* in, void* const* out,
                            int planes, unsigned wide, long long n, int shift, int bits,
                            long long tile, const void* starts, void* status, int epoch,
                            int pair, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes < 1 || planes > kMaxPlanes || bits != kSweepBits || tile != kSweepTile ||
      shift < 0 || shift >= 32 || epoch < 1 || n < 0 || n >= (1LL << 31) || keys == nullptr ||
      starts == nullptr || status == nullptr || (planes < 32 && (wide >> planes) != 0u) ||
      pair < 0 || pair > 3 || (pair != 0 && planes < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto halves = [](const void* hi, const void* lo) {
    return reinterpret_cast<uintptr_t>(lo) % 8 == 0 &&
           static_cast<const uint32_t*>(hi) == static_cast<const uint32_t*>(lo) + 1;
  };
  if (((pair & kPairIn) && !halves(in[0], in[1])) ||
      ((pair & kPairOut) && (!halves(out[0], out[1]) || (wide & 3u) != 0u))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n + tile - 1) / tile;
  if (tiles == 0) return 0;
  Planes p{};
  p.count = planes;
  p.digit = -1;
  p.wide = wide;
  for (int i = 0; i < planes; ++i) {
    p.in[i] = static_cast<const uint32_t*>(in[i]);
    p.out[i] = static_cast<uint32_t*>(out[i]);
    if (out[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (in[i] == keys) p.digit = i;
  }
  if (p.digit >= 0 && ((wide >> p.digit) & 1u)) return static_cast<int>(cudaErrorInvalidValue);
  if (pair != 0 && (p.digit < 0 || p.digit > 1)) return static_cast<int>(cudaErrorInvalidValue);
  const LookBack lb{static_cast<const int*>(starts), static_cast<unsigned long long*>(status),
                    tiles, static_cast<unsigned>(epoch)};
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  cudaError_t err = cudaSuccess;
  switch (pair) {
    case 0: err = launch_sweep<0>(k, p, n, shift, lb, s); break;
    case kPairIn: err = launch_sweep<kPairIn>(k, p, n, shift, lb, s); break;
    case kPairOut: err = launch_sweep<kPairOut>(k, p, n, shift, lb, s); break;
    default: err = launch_sweep<kPairIn | kPairOut>(k, p, n, shift, lb, s); break;
  }
  return static_cast<int>(err);
}
