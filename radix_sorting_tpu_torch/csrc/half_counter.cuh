// 16-bit counters in shared memory, two to a 32-bit word, and their hand-off
// to the output: the wide histograms of hist.cu (K1 / K2 / K3 past 2^15
// counters) and the counts of whist.cu (K10 / K11 past 2^14 bins).
//
// A counter that an add lifts from below 2^15 to 2^15 or past hands 2^15 to
// its output (a global add), and the thread that saw it takes 2^15 back off
// the word with a second shared atomic. The two atomics are not one, so other
// threads may add to the counter between them; it would carry into its
// neighbour if it reached 2^16 before the subtract landed. Why it cannot, by
// count, for a block of T threads:
//   * the kernels add to the counters in rounds with a __syncthreads()
//     between rounds, and the handing thread issues the subtract before it
//     reaches the barrier that ends the round of its crossing add. No thread
//     passes that barrier before the subtract is visible, and every add of an
//     earlier round was visible before the crossing add, so the adds that can
//     land between the two atomics are adds of the same round;
//   * every add carries keys that the block read in that round (one key, or
//     the keys of one counter that a warp summed), and a thread reads at most
//     A keys a round, so a round's adds to one counter total at most T * A;
//   * just before the crossing add of v the counter held at most 2^15 - 1,
//     and the rest of the round adds at most T * A - v: while the hand-off is
//     pending the counter stays at or below 2^15 - 1 + T * A, below 2^16 while
//     T * A <= 2^15 (half_round_ok). At T = 1,024 that is A <= 32; the
//     kernels' rounds are two chunks of one plane (A = 32, hist.cu) or one
//     of two (A = 8: hist.cu's two planes, whist.cu's keys and values), and
//     a last round of the short chunk, the head and the tail (A <= 18);
//   * one hand-off of a counter is pending at a time: the next needs an add
//     that starts below 2^15, and the counter stays at 2^15 or more until the
//     subtract lands, which therefore never borrows from the neighbour.
// Each kernel static_asserts half_round_ok for its rounds.
//
// The other form that needs no bound: fold the subtract into the add, one
// compare-and-swap loop a key that takes 2^15 off in the same step whenever
// the add reaches it, so that no counter ever holds 2^15 and no barrier is
// needed. Built as a trial (not kept) and timed on the H100 against the
// rounds (scripts/hist_shapes.py --parent, 40M keys, wall ms; run BV in
// PERF.md): K1 at 2^16 counters 0.2989 against 0.0785, at 2^18 1.1078
// against 0.2207, K2 at 2^17 0.9477 against 0.1352, K10 at 65,536 bins
// 0.5621 against 0.1676 (scripts/whist_shapes.py --parent): every add
// becomes a load and a compare-and-swap, retried under contention. The
// barriers of the rounds cost at most 4% (K1 at 2^18, run BT).
#pragma once

#include <cstdint>

namespace rst {

constexpr uint32_t kHalfHandOff = 0x8000u;   // what a hand-off moves to the output

// The bound above: T threads that read at most A keys a round.
__host__ __device__ constexpr bool half_round_ok(int threads, int keys_a_round) {
  return keys_a_round >= 1 && static_cast<long long>(threads) * keys_a_round <= kHalfHandOff;
}

// Add v keys of the round to 16-bit counter `at` of `words`; out[at] takes
// each 2^15 the counter hands off.
__device__ __forceinline__ void add_half(unsigned* words, uint32_t at, uint32_t v, int* out) {
  const uint32_t sh = (at & 1u) << 4;
  const uint32_t old = (atomicAdd(words + (at >> 1), v << sh) >> sh) & 0xFFFFu;
  if (old < kHalfHandOff && old + v >= kHalfHandOff) {
    atomicSub(words + (at >> 1), kHalfHandOff << sh);
    atomicAdd(out + at, static_cast<int>(kHalfHandOff));
  }
}

// What counter `at` holds (after the block's last barrier).
__device__ __forceinline__ int half_at(const unsigned* words, int at) {
  return static_cast<int>((words[at >> 1] >> ((at & 1) << 4)) & 0xFFFFu);
}

}  // namespace rst
