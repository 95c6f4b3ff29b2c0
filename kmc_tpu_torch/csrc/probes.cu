// Three memory probes for Hopper (sm_90a), the port of the `pallas`
// section of tools/microbench_sort.py (sec_pallas).  Each replaces one of
// the section's Pallas kernels, over u32[R, 1024] (R = N / 1024 rows):
//
//   kmc_probe_add1          copy_kernel (:127):    o = x + 1;
//   kmc_probe_gather_rows   gather_kernel (:145):  per block of 1024 rows,
//                           o[r, :] = x[idx[r], :] (one shared
//                           1024-permutation; take along sublanes on the TPU);
//   kmc_probe_gather_lanes  gatherl_kernel (:169): o[r, c] = x[r, idxl[c]]
//                           (take along lanes on the TPU).
//
// On the TPU the probes asked whether Mosaic lowers a block copy and the two
// in-VMEM gathers at all.  Here the questions are how close each comes to
// the memory rate.  Every probe reads each input word once and writes each
// output word once, so bytes bound all three: 2 x 4 B x N over 3.35 TB/s
// (0.641 ms at N = 2^28); the integer work is one add or one index per word.
//
// Design.  add1 gives each thread one 16-byte vector, over a grid of
// every vector: the card keeps its SMs full from one wave to the next, so
// no grid-stride loop leaves a last wave's tail (the old grid of 16 blocks
// an SM, twice what an SM holds at once, did), and the plain loads and
// stores measured no slower than streaming cache hints.
// gather_rows gives each block whole rows: the source row is one contiguous
// 4 KB run that 256 threads move as 16-byte vectors, so the gather costs no
// more than a copy.  gather_lanes stages one row in shared memory with
// coalesced 16-byte loads, then each thread writes four consecutive columns
// (one 16-byte store) from the staged row through the permutation it holds
// in registers, so global memory only ever sees contiguous traffic.
// Indices are read mod 1024, so a read never leaves its block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 1024;      // u32 words per row
constexpr int THREADS = 256;   // ROW / 4: one 16-byte vector per thread

__global__ void __launch_bounds__(THREADS)
add1_kernel(const uint4* __restrict__ x, uint4* __restrict__ o,
            long long n_vec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n_vec) {
    uint4 v = x[i];
    o[i] = make_uint4(v.x + 1u, v.y + 1u, v.z + 1u, v.w + 1u);
  }
}

__global__ void add1_tail_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ o, long long lo,
                                 long long n) {
  long long i = lo + threadIdx.x;
  if (i < n) o[i] = x[i] + 1u;
}

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                   uint4* __restrict__ o, long long n_rows) {
  for (long long r = blockIdx.x; r < n_rows; r += gridDim.x) {
    long long blk = r / ROW * ROW;
    long long src = blk + (idx[r % ROW] & (ROW - 1));
    o[r * THREADS + threadIdx.x] = x[src * THREADS + threadIdx.x];
  }
}

__global__ void __launch_bounds__(THREADS)
gather_lanes_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                    uint4* __restrict__ o, long long n_rows) {
  __shared__ uint32_t row[ROW];
  const int t = threadIdx.x;
  // this thread writes columns 4t .. 4t+3 of every row it sees
  const int c0 = idx[4 * t] & (ROW - 1), c1 = idx[4 * t + 1] & (ROW - 1);
  const int c2 = idx[4 * t + 2] & (ROW - 1), c3 = idx[4 * t + 3] & (ROW - 1);
  for (long long r = blockIdx.x; r < n_rows; r += gridDim.x) {
    reinterpret_cast<uint4*>(row)[t] = x[r * THREADS + t];
    __syncthreads();
    o[r * THREADS + t] = make_uint4(row[c0], row[c1], row[c2], row[c3]);
    __syncthreads();
  }
}

int grid_for(long long units, int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long cap = (long long)sms * per_sm;
  return (int)(units < cap ? (units > 0 ? units : 1) : cap);
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, o: u32[n] device, 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError().
int kmc_probe_add1(const void* x, void* o, long long n, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long n_vec = n / 4;
  if (n_vec)
    add1_kernel<<<(unsigned)((n_vec + THREADS - 1) / THREADS), THREADS, 0,
                  st>>>((const uint4*)x, (uint4*)o, n_vec);
  if (n % 4)
    add1_tail_kernel<<<1, 4, 0, st>>>((const uint32_t*)x, (uint32_t*)o,
                                      n_vec * 4, n);
  return (int)cudaGetLastError();
}

// x, o: u32[n_rows, 1024] device, 16-byte aligned, n_rows % 1024 == 0;
// idx: int32[1024] device.  o[r, :] = x[r - r % 1024 + idx[r % 1024], :].
int kmc_probe_gather_rows(const void* x, const void* idx, void* o,
                          long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_rows % ROW || (((uintptr_t)x | (uintptr_t)o) & 15))
    return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<grid_for(n_rows, 8), THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const uint4*)x, (const int*)idx, (uint4*)o, n_rows);
  return (int)cudaGetLastError();
}

// x, o: u32[n_rows, 1024] device, 16-byte aligned; idx: int32[1024]
// device.  o[r, c] = x[r, idx[c]].
int kmc_probe_gather_lanes(const void* x, const void* idx, void* o,
                           long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if (((uintptr_t)x | (uintptr_t)o) & 15) return (int)cudaErrorInvalidValue;
  gather_lanes_kernel<<<grid_for(n_rows, 8), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint4*)x, (const int*)idx, (uint4*)o, n_rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
