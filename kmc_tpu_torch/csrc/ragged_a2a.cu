// Owner exchange for Hopper (sm_90a): the ragged all-to-all that moves the
// sharded store's rows to their bin owners at finalize, one launch a card.
//
// Replaces the TPU kernels kmc_tpu/parallel/pallas_a2a.py::
// pallas_ragged_all_to_all (kernel body _ragged_a2a_kernel) and, as its dense
// entry (every segment full), pallas_all_to_all (_a2a_kernel).
//
// Contract.  D senders each hold x_j = u32[D, cap, C]: segment r (rows of C
// interleaved words) is meant for owner r, and only its first n[j][r] rows
// are live.  The exchange writes out_r = u32[D, cap, C] for every owner r
// with out_r[j, :n[j][r]] = x_j[r, :n[j][r]] for every sender j.  Rows of
// out_r[j] past n[j][r] are left untouched: the JAX contract calls them
// undefined, and the port's consumers read only the first recv_rows[r][j] =
// n[j][r] rows, as kmc_tpu/parallel/multihost.py:306-311 masks by them.
//
// Design.  There is no remote DMA: a kernel writes the other cards' buffers
// directly through peer access (NVLink), or through CUDA IPC when they
// belong to another process.  One launch a card covers every (owner,
// sender) pair whose sender lives on the card, every owner: the card pushes
// its senders' rows into the owners' outputs, wherever they are (stores to
// a peer are posted: no round trip over NVLink, where a pull's loads wait
// for one; pushing measured faster than pulling on four cards, PERF.md).
// The launch gets every shard's sender and output pointer as this card
// sees them (a kernel parameter) and a tile list, int32[n_tiles, 4] of
// (owner, sender, row0, rows): rows [row0, row0 + rows) of sender's segment
// owner go to rows [row0, row0 + rows) of owner's block sender.  The host
// builds the list (exchange_kernel.py::tile_list, 64 KB a tile) with the
// pairs' tiles interleaved round-robin over the owners, so the resident
// blocks write the local device memory and every peer link at once, and
// uploads it once for each set of counts.  A grid of BLOCKS_PER_SM blocks
// an SM claims tiles from a counter in device memory (set to 0 before the
// launch), so the blocks finish together whatever the tiles' lengths.  A
// tile's rows are one contiguous byte range at both ends: the block copies
// a head of words up to the destination's 16-byte boundary, then 16-byte
// vectors with UNROLL loads in flight a thread before their stores, then a
// tail of at most 3 words.  When the source sits at another offset modulo
// 16 (C = 3 with an odd cap puts the segments there) the block reads
// aligned vectors and shifts each by the words it needs, taking the next
// vector from the next lane.  The kernel allocates nothing and does not
// synchronise.
//
// Across processes.  When the shards belong to several processes (one
// torch.distributed group on one node), each process allocates its senders'
// buffers here (kmc_ipc_alloc: one cudaMalloc each, exported with
// cudaIpcGetMemHandle, so a handle names the buffer's own base and no offset
// inside a caching allocator's block is needed), and so are the outputs of
// owners that another process's launch writes.  The lowest rank holding a
// shard on a card launches that card's kernel: it opens the other
// processes' buffers it reads or writes (kmc_ipc_open:
// cudaIpcOpenMemHandle with cudaIpcMemLazyEnablePeerAccess) and passes the
// opened pointers; a process never opens its own handles.  The caller
// orders it: senders synchronise, the handles cross the group, launchers
// open them, the group meets, launchers launch and synchronise, opened
// buffers are closed (kmc_ipc_close), the group meets again, owners read
// their outputs, senders free (kmc_ipc_free).
//
// Bound.  Bytes: every delivered row read once and written once,
// 2 * 4 B * C * sum(n); over 3.35 TB/s on one card, or, for rows that cross
// cards, the busiest card's NVLink direction over 450 GB/s.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;         // 16-byte accesses in flight a thread
constexpr int BLOCKS_PER_SM = 2;  // 64 KB in flight an SM
constexpr int MAX_DEV = 128;      // shards an exchange may have
constexpr unsigned FULL = 0xffffffffu;

// The four words at src word offset R from an aligned vector a, the next
// aligned vector b supplying the rest.
template <int R>
__device__ __forceinline__ uint4 shifted(const uint4& a, const uint4& b) {
  if (R == 0) return a;
  if (R == 1) return make_uint4(a.y, a.z, a.w, b.x);
  if (R == 2) return make_uint4(a.z, a.w, b.x, b.y);
  return make_uint4(a.w, b.x, b.y, b.z);
}

// d4[i] = the four words at sa + R words + 4 i, for i < n4; d4 and sa are
// 16-byte aligned.  With R > 0 a lane takes the vector after its own from
// the next lane (a shuffle) and loads it itself only as the warp's last
// lane or for the last vector; the aligned vector after the last one
// shares its 16 bytes with live words, so it never leaves the buffer.
template <int R>
__device__ __forceinline__ void copy_vectors(const uint4* __restrict__ sa,
                                             uint4* __restrict__ d4,
                                             long long n4) {
  const int lane = threadIdx.x & 31;
  for (long long w = threadIdx.x - lane; w < n4;
       w += (long long)THREADS * UNROLL) {
    uint4 a[UNROLL], e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = w + (long long)u * THREADS + lane;
      a[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n4) a[u] = sa[i];
      if (R != 0 && i < n4 && (lane == 31 || i + 1 >= n4)) e[u] = sa[i + 1];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = w + (long long)u * THREADS + lane;
      uint4 v = a[u];
      if (R != 0) {
        uint4 b;
        b.x = __shfl_down_sync(FULL, a[u].x, 1);
        b.y = __shfl_down_sync(FULL, a[u].y, 1);
        b.z = __shfl_down_sync(FULL, a[u].z, 1);
        b.w = __shfl_down_sync(FULL, a[u].w, 1);
        if (lane == 31 || i + 1 >= n4) b = e[u];
        v = shifted<R>(a[u], b);
      }
      if (i < n4) d4[i] = v;
    }
  }
}

// Copy `words` u32 from src to dst with the whole block: a head of words
// up to dst's 16-byte boundary, 16-byte vectors (shifted when src sits at
// another offset modulo 16), a tail of at most 3 words.
__device__ __forceinline__ void copy_words(const uint32_t* __restrict__ src,
                                           uint32_t* __restrict__ dst,
                                           long long words) {
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst);
  long long head = (long long)(((16u - (da & 15u)) & 15u) >> 2);
  if (head > words) head = words;
  if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  const uint32_t* s = src + head;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const long long n4 = (words - head) >> 2;
  const int r = (int)((reinterpret_cast<uintptr_t>(s) & 15u) >> 2);
  const uint4* sa = reinterpret_cast<const uint4*>(s - r);
  switch (r) {
    case 0: copy_vectors<0>(sa, d4, n4); break;
    case 1: copy_vectors<1>(sa, d4, n4); break;
    case 2: copy_vectors<2>(sa, d4, n4); break;
    default: copy_vectors<3>(sa, d4, n4); break;
  }
  const long long done = head + (n4 << 2);
  if (done + threadIdx.x < words)
    dst[done + threadIdx.x] = src[done + threadIdx.x];
}

// Every shard's buffers as the launching card sees them (a kernel
// parameter, read through the constant bank).
struct Buffers {
  const uint32_t* src[MAX_DEV];  // senders
  uint32_t* dst[MAX_DEV];        // owners' outputs
};

// Each block claims tiles from the counter (0 at launch), the next claim
// in flight while it copies the current tile.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
exchange_tiles(const __grid_constant__ Buffers bufs,
               const int4* __restrict__ tiles, long long n_tiles,
               long long cap, int n_words_row,
               unsigned long long* __restrict__ counter) {
  __shared__ long long next;
  if (threadIdx.x == 0) next = (long long)atomicAdd(counter, 1ull);
  __syncthreads();
  long long t = next;
  while (t < n_tiles) {
    __syncthreads();  // every thread has read next
    if (threadIdx.x == 0) next = (long long)atomicAdd(counter, 1ull);
    const int4 tile = tiles[t];  // owner, sender, row0, rows
    const uint32_t* src = bufs.src[tile.y] +
                          ((long long)tile.x * cap + tile.z) * n_words_row;
    uint32_t* dst = bufs.dst[tile.x] +
                    ((long long)tile.y * cap + tile.z) * n_words_row;
    copy_words(src, dst, (long long)tile.w * n_words_row);
    __syncthreads();  // next holds the block's next tile
    t = next;
  }
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Let `device` read and write memory of `peer` (cudaDeviceEnablePeerAccess).
// Returns cudaErrorPeerAccessUnsupported when the pair cannot, 0 when access
// is on (already on counts as on).  The caller's current device is kept.
int kmc_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it recorded
    err = cudaSuccess;
  }
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

// The PCI bus id of `device` ("0000:18:00.0"), which names a card the same
// way in every process whatever its CUDA_VISIBLE_DEVICES.
int kmc_pci_bus_id(int device, char* buf, int len) {
  if (buf == nullptr || len < 13) return (int)cudaErrorInvalidValue;
  return (int)cudaDeviceGetPCIBusId(buf, len, device);
}

// Load the kernel's module on `device` (CUDA loads modules lazily, at a
// kernel's first launch), so that no exchange pays for it inside its
// launch.  The caller's current device is kept.
int kmc_exchange_load(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, exchange_tiles);
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

// One card's launch of the exchange (see the header).  ptrs: host int64
// [2 * n_dev], the senders' then the owners' output pointers as `device`
// sees them (0 where the launch does not touch the shard); tiles: device
// int32[n_tiles, 4] on `device`, 16-byte aligned; counter: 8 bytes of
// device memory on `device`, set to 0 on `stream` before the launch.
// Launches on `stream` (a stream of `device`) a grid of min(n_tiles,
// BLOCKS_PER_SM * SMs) blocks; nothing when n_tiles is 0.  Returns the
// first error.
int kmc_exchange_tiles(int device, const long long* ptrs, const void* tiles,
                       long long n_tiles, int n_dev, long long cap,
                       int n_words_row, void* counter, void* stream) {
  if (n_dev < 1 || n_dev > MAX_DEV || ptrs == nullptr || cap < 0 ||
      n_words_row < 1 || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  Buffers bufs;
  for (int g = 0; g < MAX_DEV; ++g) {
    bufs.src[g] = g < n_dev ? reinterpret_cast<const uint32_t*>(ptrs[g])
                            : nullptr;
    bufs.dst[g] = g < n_dev ? reinterpret_cast<uint32_t*>(ptrs[n_dev + g])
                            : nullptr;
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned long long),
                          (cudaStream_t)stream);
  if (err == cudaSuccess) {
    long long grid = (long long)BLOCKS_PER_SM * sms;
    if (grid > n_tiles) grid = n_tiles;
    exchange_tiles<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
        bufs, (const int4*)tiles, n_tiles, cap, n_words_row,
        (unsigned long long*)counter);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

// Allocate `bytes` of device memory on `device` for a sender's buffer and
// export it: *ptr gets the buffer, handle (64 bytes, cudaIpcMemHandle_t) its
// handle for the other processes of the group.  The caller's current device
// is kept.
int kmc_ipc_alloc(int device, long long bytes, void** ptr, void* handle) {
  if (bytes < 1 || ptr == nullptr || handle == nullptr)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  *ptr = nullptr;
  err = cudaMalloc(ptr, (size_t)bytes);
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
    if (err != cudaSuccess) {
      cudaFree(*ptr);
      *ptr = nullptr;
    }
  }
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

// Free a buffer of kmc_ipc_alloc, once every process has closed it.
int kmc_ipc_free(int device, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaFree(ptr);
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

// Open another process's buffer (its 64-byte handle) for kernels on
// `device`; *ptr gets its address there.  Peer access to the buffer's card
// is enabled as needed (cudaIpcMemLazyEnablePeerAccess).
int kmc_ipc_open(int device, const void* handle, void** ptr) {
  if (handle == nullptr || ptr == nullptr) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  *ptr = nullptr;
  err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

// Close a buffer of kmc_ipc_open.
int kmc_ipc_close(int device, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaIpcCloseMemHandle(ptr);
  cudaError_t err2 = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : err2);
}

}  // extern "C"
