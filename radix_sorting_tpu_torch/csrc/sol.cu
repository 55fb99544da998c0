// E1 and E2: the kernels of the speed-of-light measurement scripts.
//
// E1 dma_copy replaces scripts/exp_sol_probe.py::probe_dma's `kernel`: a
// manual DMA round trip, device memory -> on-chip memory -> device memory, one
// grid step per chunk of 2^17 u32 (512 KB a leg), on a grid that the TPU runs
// in order. Contract: out = in, n u32 words (int32 carriers), any n.
// Bound on the H100: 8 bytes a word (one read, one write); 2^24 words in
// 0.040 ms at 3.35 TB/s. Design: a 512 KB chunk is past a block's 227 KB of
// shared memory, so a block stages a chunk of 2^13 words (32 KB) instead, one
// block per chunk and several blocks to an SM, so that the loads of some
// blocks overlap the stores of others. Each thread issues its eight 16-byte
// loads into shared memory back to back, the block syncs, and the eight
// 16-byte stores follow. The last, short chunk, and every chunk when either
// pointer is not 16 bytes aligned, is copied word by word. A TMA bulk copy
// (`cp.async.bulk` with an mbarrier) is the closer counterpart of the TPU's
// DMA and is left for a later change.
//
// E2 msd_spread replaces scripts/exp_sol_round2.py::build_msd's
// `spread_kernel`: the spread step of the two-level MSD sort. Contract:
// xp (R, W, 128) u32 holds R row-sorted rows of m keys, padded; s128 (R, K)
// int32 is the first 128-key row of each row's bucket; out (K, R, capr, 128)
// u32, where cell (k, r) is the window xp[r, s128[r, k] : + capr, :] with
// each key w at position pos = row * 128 + lane kept where
// (w >> (32 - d)) == k and 0 <= pos < m, and 0xFFFFFFFF elsewhere (rows before
// 0 or past W give 0xFFFFFFFF too; the TPU kernel leaves them undefined).
// Bound on the H100: xp read once and out written once; at 40M keys (R = K =
// 128, capr = 24, m = 312,500, W = 2,466) 161.6 MB + 201.3 MB in 0.108 ms at
// 3.35 TB/s. Design: one block per cell, as the TPU's grid has one step per
// (r, k); the threads walk the window's capr * 128 words in order, so reads
// and writes are coalesced, and the windows of one row's buckets, read by
// neighbouring blocks, overlap in L2 (each key is read about capr * 128 * K /
// m times, ~1.3 at 40M, mostly from L2). The TPU kernel's scalar prefetch of
// s128 is one load per block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCopyChunk = 1 << 13;            // words a block stages: 32 KB
constexpr int kCopyThreads = 256;
constexpr int kCopyVectors = kCopyChunk / 4 / kCopyThreads;   // 16-byte loads a thread
constexpr int kSpreadThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kCopyThreads)
dma_copy_kernel(const uint32_t* in, uint32_t* out, long long n, bool aligned) {
  __shared__ uint4 stage[kCopyChunk / 4];
  const long long base = static_cast<long long>(blockIdx.x) * kCopyChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kCopyChunk), n - base));
  if (aligned && len == kCopyChunk) {
    const uint4* src = reinterpret_cast<const uint4*>(in + base);
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int j = 0; j < kCopyVectors; ++j) {
      const int i = threadIdx.x + j * kCopyThreads;
      stage[i] = src[i];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCopyVectors; ++j) {
      const int i = threadIdx.x + j * kCopyThreads;
      dst[i] = stage[i];
    }
    return;
  }
  uint32_t* words = reinterpret_cast<uint32_t*>(stage);
  for (int i = threadIdx.x; i < len; i += kCopyThreads) words[i] = in[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kCopyThreads) out[base + i] = words[i];
}

// One block per cell (r, k), block index r * K + k.
__global__ void __launch_bounds__(kSpreadThreads)
msd_spread_kernel(const int* s128, const uint32_t* xp, uint32_t* out, int R, int K, int W,
                  long long m, int d, int capr) {
  const int r = static_cast<int>(blockIdx.x / K);
  const int k = static_cast<int>(blockIdx.x % K);
  const long long s = s128[blockIdx.x];
  const uint32_t* row = xp + static_cast<long long>(r) * W * 128;
  uint32_t* cell = out + (static_cast<long long>(k) * R + r) * capr * 128;
  const int shift = 32 - d;
  for (int i = threadIdx.x; i < capr * 128; i += kSpreadThreads) {
    const long long sub = s + i / 128;
    const long long pos = sub * 128 + i % 128;
    uint32_t v = kSentinel;
    if (sub >= 0 && pos < m) {               // m <= W * 128: inside the row
      const uint32_t w = row[pos];
      if ((w >> shift) == static_cast<uint32_t>(k)) v = w;
    }
    cell[i] = v;
  }
}

}  // namespace

// E1: copy n words from `in` to `out` (separate buffers).
extern "C" int rst_dma_copy(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long blocks = (n + kCopyChunk - 1) / kCopyChunk;
  dma_copy_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n, aligned);
  return static_cast<int>(cudaGetLastError());
}

// E2: spread the (R, W, 128) rows `xp` into the (K, R, capr, 128) cells `out`.
extern "C" int rst_msd_spread(const void* s128, const void* xp, void* out, int R, int K, int W,
                              long long m, int d, int capr, void* stream) {
  if (d < 1 || d > 32 || capr < 1 || m < 0 || m > static_cast<long long>(W) * 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cells = static_cast<long long>(R) * K;
  if (cells == 0) return 0;
  msd_spread_kernel<<<static_cast<unsigned>(cells), kSpreadThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s128), static_cast<const uint32_t*>(xp),
      static_cast<uint32_t*>(out), R, K, W, m, d, capr);
  return static_cast<int>(cudaGetLastError());
}
