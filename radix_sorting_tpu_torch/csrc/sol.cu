// E1 and E2: the kernels of the speed-of-light measurement scripts.
//
// E1 dma_copy replaces scripts/exp_sol_probe.py::probe_dma's `kernel`: a
// manual DMA round trip, device memory -> on-chip memory -> device memory, one
// grid step per chunk of 2^17 u32 (512 KB a leg), on a grid that the TPU runs
// in order. Contract: out = in, n u32 words (int32 carriers), any n.
// Bound on the H100: 8 bytes a word (one read, one write); 2^24 words in
// 0.040 ms at 3.35 TB/s. Design: the TMA bulk copy, the closer counterpart
// of the TPU's DMA. A persistent grid of one block per SM (a 512 KB chunk is
// past a block's 227 KB of shared memory, so chunks are 16 KB) walks the
// chunks blockIdx.x, + gridDim.x, ...; a ring of 12 stages (192 KB of
// dynamic shared memory, one mbarrier a stage) keeps up to 4 stores and 7
// loads in flight. One thread issues everything: a load is
// cp.async.bulk.shared::cluster.global with mbarrier.arrive.expect_tx (and
// an L2 evict-first hint: the source is read once), a store of a stage that
// has arrived is cp.async.bulk.global.shared::cta in a bulk group, and
// before it refills a stage it waits (cp.async.bulk.wait_group.read 4)
// until the store that last read that stage has read it; it ends on
// wait_group 0. No thread touches the data. One store in flight (wait 1)
// without the hint ran slower than copy_ on the H100; chunk sizes from 4 to
// 32 KB, and two blocks an SM, made no difference.
// The route is chosen from the alignment before the launch: a pointer that
// is not 16 bytes aligned takes the word-by-word kernel (one block per 32 KB
// chunk, each thread a word at a time through shared memory), and the last
// n mod 4 words of an aligned copy, past the last 16-byte vector, are
// copied word by word by the first block's issuing thread.
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

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kCopyChunk = 1 << 13;            // words a block stages: 32 KB
constexpr int kCopyThreads = 256;
constexpr int kBulkChunk = 16 * 1024;          // bytes a bulk copy moves
constexpr int kBulkStages = 12;
constexpr int kBulkSmem = kBulkChunk * kBulkStages;
constexpr int kStoreLag = 4;                   // stores in flight before a stage is refilled
constexpr int kSpreadThreads = 256;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// A pointer that is not 16 bytes aligned: one block per chunk, a word at a
// time through shared memory.
__global__ void __launch_bounds__(kCopyThreads)
dma_copy_words_kernel(const uint32_t* in, uint32_t* out, long long n) {
  __shared__ uint32_t stage[kCopyChunk];
  const long long base = static_cast<long long>(blockIdx.x) * kCopyChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kCopyChunk), n - base));
  for (int i = threadIdx.x; i < len; i += kCopyThreads) stage[i] = in[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kCopyThreads) out[base + i] = stage[i];
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t"
      "}" ::"r"(bar), "r"(parity) : "memory");
}

// 16-byte aligned pointers: the bulk-copy ring, one issuing thread a block.
__global__ void __launch_bounds__(32) dma_bulk_kernel(const uint32_t* in, uint32_t* out,
                                                      long long n) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kBulkStages];
  if (threadIdx.x != 0) return;
  const long long bytes = (n >> 2) << 4;        // whole 16-byte vectors
  if (blockIdx.x == 0) {
    for (long long i = bytes >> 2; i < n; ++i) out[i] = in[i];
  }
  const long long chunks = (bytes + kBulkChunk - 1) / kBulkChunk;
  const long long mine =
      chunks > blockIdx.x ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (mine == 0) return;
  for (int s = 0; s < kBulkStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(&full[s]))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  uint64_t evict_first;   // the source is read once: keep L2 for the stores
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(evict_first));
  const char* src = reinterpret_cast<const char*>(in);
  char* dst = reinterpret_cast<char*>(out);
  auto chunk_at = [&](long long j) { return (blockIdx.x + j * gridDim.x) * kBulkChunk; };
  auto chunk_len = [&](long long off) {
    return static_cast<uint32_t>(min(static_cast<long long>(kBulkChunk), bytes - off));
  };
  auto load = [&](long long j) {
    const int s = static_cast<int>(j % kBulkStages);
    const long long off = chunk_at(j);
    const uint32_t len = chunk_len(off);
    const uint32_t bar = shared_addr(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(len)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;"
        ::"r"(shared_addr(ring + s * kBulkChunk)), "l"(src + off), "r"(len), "r"(bar),
        "l"(evict_first)
        : "memory");
  };
  for (long long j = 0; j < min(mine, static_cast<long long>(kBulkStages)); ++j) load(j);
  for (long long j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % kBulkStages);
    wait_parity(shared_addr(&full[s]), static_cast<uint32_t>((j / kBulkStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const long long off = chunk_at(j);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + off), "r"(shared_addr(ring + s * kBulkChunk)), "r"(chunk_len(off))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // once the store of chunk j - lag has read its stage, refill that stage
    if (j >= kStoreLag && j - kStoreLag + kBulkStages < mine) {
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kStoreLag) : "memory");
      load(j - kStoreLag + kBulkStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

// E1: copy n words from `in` to `out` (separate buffers); the route by the
// pointers' alignment.
extern "C" int rst_dma_copy(const void* in, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15) {
    const long long blocks = (n + kCopyChunk - 1) / kCopyChunk;
    dma_copy_words_kernel<<<static_cast<unsigned>(blocks), kCopyThreads, 0, st>>>(src, dst, n);
    return static_cast<int>(cudaGetLastError());
  }
  static int configured[16];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && (dev >= 16 || !configured[dev])) {
    err = cudaFuncSetAttribute(dma_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBulkSmem);
    if (err == cudaSuccess && dev < 16) configured[dev] = 1;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (((n >> 2) << 4) + kBulkChunk - 1) / kBulkChunk;
  const unsigned grid = static_cast<unsigned>(std::max(1LL, std::min(chunks, 1LL * sms)));
  dma_bulk_kernel<<<grid, 32, kBulkSmem, st>>>(src, dst, n);
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
