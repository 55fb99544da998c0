// K13 rdma_exchange: the all-to-all of the distributed tier, one launch a rank.
//
// Replaces radix_sorting_tpu/parallel/rdma.py::_exchange_kernel. Contract:
// every rank d of a D-rank mesh holds x_d of shape (D, m); afterwards rank
// d's output row s equals x_s's row d (lax.all_to_all along the mesh axis,
// tiled). The kernel is dtype-blind: a row is row_bytes bytes.
//
// The TPU kernel runs on every chip at once: a barrier semaphore round, a
// local DMA of the own row, then a ring of remote DMAs, step k pushing row
// (d + k) % D into peer (d + k) % D's row d, two sends in flight, one
// receive semaphore a step. Here the launch for rank d gets its input's
// base, row_bytes, its rank, and a table of the D ranks' output bases
// (passed by value, so it lives in the kernel's parameter space on the
// device; no allocation and no host-to-device copy a call). Block (x, k)
// copies chunk x of ring step k: source row (d + k) % D to destination
// table[(d + k) % D] + d * row_bytes. k = 0 is the own row. The ring order
// is kept: with real peers it means that at each step no two senders write
// into the same receiver; with every rank on one card it changes nothing.
//
// Synchronisation is outside the kernel, the counterpart of the TPU
// kernel's barrier and receive semaphores. One process driving every rank:
// before rank d's launch its stream waits on an event from every peer's
// stream (no write lands in a buffer its owner still uses), and after the
// launches every receiver's stream waits on every sender's completion event
// before anything reads its output. There is no spin-wait in the kernel, so
// no forward-progress hazard when several ranks share one card.
//
// A group of processes (parallel/rdma.py, IpcPeers): each rank's receive
// buffer is memory of its own (rst_ipc_alloc below, a cudaMalloc outside
// PyTorch's caching allocator, so a handle names the buffer's base and
// nothing else), exported once as a CUDA IPC handle; the handles cross the
// group once, and each process opens its peers' buffers once
// (rst_ipc_open), so the table holds the D receive buffers, the peers' as
// opened pointers. The buffers persist with the mesh and grow when a call
// needs more; closing the mesh closes the opened handles on every process,
// meets the group, then frees. Events do not cross processes, so each call
// is: the streams synchronise, the group meets, the launches, the streams
// synchronise, the group meets, then every receiver copies its buffer into
// a fresh output. No flag is spun on in the kernel: several processes on
// one card without MPS time-slice their contexts, and a kernel waiting on a
// flag of another context would progress only when the card switches
// contexts.
//
// Between distinct cards the destinations are peer pointers: the wrapper
// enables peer access (rst_enable_peer_access), or the IPC open enables it
// lazily, and raises where a pair cannot reach each other; it never stages
// through the host.
//
// Bound on the H100: each rank reads D * row_bytes and writes D * row_bytes,
// so with every rank on one card the launch set moves 2 * D^2 * row_bytes
// through device memory at 3.35 TB/s (2 * 4 * 10 MB = 80 MB a rank at D = 4
// and 2.5M u32 a row: 0.024 ms a rank). Between cards the (D - 1) * row_bytes
// a rank that leave it go over NVLink at 450 GB/s each way. Design: plain
// grid-stride copies, 16-byte loads and stores where source and destination
// share their address mod 16 (a head and a tail of bytes around them), 4-byte
// words where they share it mod 4, and bytes otherwise; neighbouring threads
// on neighbouring addresses.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxRanks = 128;          // 1 KB of pointers in the parameters
constexpr int kThreads = 256;
constexpr long long kBytesPerBlock = 1 << 15;   // 32 KB of a row a block

struct PeerTable {
  unsigned char* dst[kMaxRanks];
};

// Copy len bytes from s to t with the blocks of one grid row.
__device__ void copy_row(const unsigned char* s, unsigned char* t, long long len) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s), ta = reinterpret_cast<uintptr_t>(t);
  int width = 1;
  if (((sa ^ ta) & 15) == 0) {
    width = 16;
  } else if (((sa ^ ta) & 3) == 0) {
    width = 4;
  }
  long long head = 0, body = 0;
  if (width > 1) {
    head = min(len, static_cast<long long>((width - (sa & (width - 1))) & (width - 1)));
    body = (len - head) / width;
  }
  if (width == 16) {
    const uint4* sv = reinterpret_cast<const uint4*>(s + head);
    uint4* tv = reinterpret_cast<uint4*>(t + head);
    for (long long i = tid; i < body; i += stride) tv[i] = sv[i];
  } else if (width == 4) {
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s + head);
    uint32_t* tw = reinterpret_cast<uint32_t*>(t + head);
    for (long long i = tid; i < body; i += stride) tw[i] = sw[i];
  } else {
    for (long long i = tid; i < len; i += stride) t[i] = s[i];
    return;
  }
  // the head and the tail: fewer than `width` bytes each
  const long long tail = head + body * width;
  if (tid < head) t[tid] = s[tid];
  if (tid < len - tail) t[tail + tid] = s[tail + tid];
}

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const unsigned char* src, long long row_bytes, PeerTable table, int D,
                int rank) {
  const int peer = (rank + static_cast<int>(blockIdx.y)) % D;   // ring step k = blockIdx.y
  copy_row(src + static_cast<long long>(peer) * row_bytes,
           table.dst[peer] + static_cast<long long>(rank) * row_bytes, row_bytes);
}

}  // namespace

// K13: rank `rank`'s launch. `src` is its (D, row_bytes) input; `dst` a host
// array of the D ranks' (D, row_bytes) output bases.
extern "C" int rst_rdma_exchange(const void* src, long long row_bytes, void* const* dst, int D,
                                 int rank, void* stream) {
  if (D < 1 || D > kMaxRanks || rank < 0 || rank >= D || row_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (row_bytes == 0) return 0;
  PeerTable table;
  for (int i = 0; i < D; ++i) table.dst[i] = static_cast<unsigned char*>(dst[i]);
  const long long blocks = std::min((row_bytes + kBytesPerBlock - 1) / kBytesPerBlock, 65535LL);
  exchange_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(D)), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), row_bytes, table, D, rank);
  return static_cast<int>(cudaGetLastError());
}

// Let `device` write into `peer`'s memory. Enabling twice is no error. The
// caller's current device is kept.
extern "C" int rst_enable_peer_access(int device, int peer) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();      // clear the error it recorded
      err = cudaSuccess;
    }
  }
  const cudaError_t restore = cudaSetDevice(current);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

// Device memory of `bytes` bytes on the current device, and its CUDA IPC
// handle (64 bytes, written to `handle`). Freed by rst_ipc_free only.
extern "C" int rst_ipc_alloc(long long bytes, void** ptr, void* handle) {
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(err);
}

// Another process's buffer, from its handle, mapped into this process
// (peer access enabled where the buffer lies on another card).
extern "C" int rst_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  *ptr = nullptr;
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int rst_ipc_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

extern "C" int rst_ipc_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

extern "C" int rst_ipc_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }
