// Owner exchange for Hopper (sm_90a): the ragged all-to-all that moves the
// sharded store's rows to their bin owners at finalize, one launch per owner.
//
// Replaces the TPU kernels kmc_tpu/parallel/pallas_a2a.py::
// pallas_ragged_all_to_all (kernel body _ragged_a2a_kernel) and, as its dense
// entry (every segment full), pallas_all_to_all (_a2a_kernel).
//
// Contract.  D senders each hold x_j = u32[D, cap, C]: segment r (rows of C
// interleaved words) is meant for owner r, and only its first n[j][r] rows
// are live.  The launch for owner r writes out_r = u32[D, cap, C] with
// out_r[j, :n[j][r]] = x_j[r, :n[j][r]] for every sender j.  Rows of out_r[j]
// past n[j][r] are left untouched: the JAX contract calls them undefined,
// and the port's consumers read only the first recv_rows[r][j] = n[j][r]
// rows, as kmc_tpu/parallel/multihost.py:306-311 masks by them.
//
// Design.  One process drives every shard, so there is no remote DMA: the
// owner's kernel reads the senders' buffers directly.  The launch gets a
// device-resident table of int64: the D senders' base pointers, then the D*D
// counts row-major (n[j][r] at D + j*D + r).  The grid runs over (chunk,
// sender): block (c, j) copies rows [c*ci, min((c+1)*ci, n)) of sender j's
// segment r and exits at once when c*ci >= n.  A run of rows is one
// contiguous byte range in both x_j and out_r, so the block copies it with
// 16-byte vector loads and stores, four loads in flight per thread before
// their stores, when both ends are 16-byte aligned (the case whenever cap*C
// and ci*C are multiples of 4), else word by word.  Senders on other cards
// are read over NVLink after the wrapper has enabled peer access for the
// pair; on one card this is a device-to-device copy.  The kernel allocates
// nothing and does not synchronise.
//
// Bound.  Bytes: every delivered row read once and written once,
// 2 * 4 B * C * sum(n); over 3.35 TB/s on one card, or, for rows that cross
// cards, over NVLink's 450 GB/s each way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // a 2048-row chunk of 2 words is 4 loads a thread

__global__ void __launch_bounds__(THREADS)
ragged_a2a_owner(const long long* __restrict__ table, int n_dev, int owner,
                 long long cap, int n_words_row, long long chunk_rows,
                 uint32_t* __restrict__ out) {
  const int j = blockIdx.y;
  const long long n = table[n_dev + (long long)j * n_dev + owner];
  const long long row0 = (long long)blockIdx.x * chunk_rows;
  if (row0 >= n) return;
  const long long rows = min(chunk_rows, n - row0);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(table[j]) +
                        ((long long)owner * cap + row0) * n_words_row;
  uint32_t* dst = out + ((long long)j * cap + row0) * n_words_row;
  const long long words = rows * n_words_row;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15u) == 0;
  long long done = 0;
  if (vec) {
    // UNROLL loads in flight per thread before their stores
    const long long n4 = words >> 2;
    const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst);
    for (long long base = threadIdx.x; base < n4; base += THREADS * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + (long long)u * THREADS;
        if (i < n4) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long i = base + (long long)u * THREADS;
        if (i < n4) d4[i] = v[u];
      }
    }
    done = n4 << 2;
  }
  for (long long i = done + threadIdx.x; i < words; i += THREADS)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Let `device` read memory of `peer` (cudaDeviceEnablePeerAccess).  Returns
// cudaErrorPeerAccessUnsupported when the pair cannot, 0 when access is on
// (already on counts as on).  The caller's current device is kept.
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

// One owner's share of the exchange (see the header).  table: device int64
// [n_dev + n_dev * n_dev] on `device`; out: u32[n_dev, cap, n_words_row] on
// `device`; n_chunks: grid width, ceil(max_j n[j][owner] / chunk_rows).
// Launches on `stream` (a stream of `device`); returns cudaGetLastError().
int kmc_ragged_a2a_owner(int device, const void* table, int n_dev, int owner,
                         long long cap, int n_words_row, long long chunk_rows,
                         long long n_chunks, void* out, void* stream) {
  if (n_dev < 1 || owner < 0 || owner >= n_dev || n_dev > 65535 ||
      cap < 0 || n_words_row < 1 || chunk_rows < 1 || n_chunks < 0 ||
      n_chunks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  dim3 grid((unsigned)n_chunks, (unsigned)n_dev);
  ragged_a2a_owner<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)table, n_dev, owner, cap, n_words_row, chunk_rows,
      (uint32_t*)out);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
