// Splitter scan for Hopper (sm_90a): per start position, the signature and
// the canonical k-mer lanes.
//
// Replaces the TPU kernels kmc_tpu/ops/pallas_extract.py::pallas_extract2d
// (kernel body _kernel2d; C entry kmc_splitter_scan) and ::pallas_extract
// (the 1-D tile layout, kernel body _kernel; C entry kmc_splitter_scan_1d).
// Both compute one function; the TPU's 1-D / 2-D split is a matter of
// Mosaic's vector layouts, so both entries launch the same kernel here.
// The 2-D entry's contract, in position order, with no alignment rule: for
// each start i < s,
//   sig[i]      = min over the window's k-m+1 m-mers of the canonical m-mer
//                 norm (4^m where no m-mer is allowed), or 0xFFFFFFFF when a
//                 code in [i, i+k) is >= 4;
//   lanes[t][i] = lane t (most significant first, right-aligned) of the
//                 smaller of the forward and reverse-complement k-mer, or
//                 0xFFFFFFFF for an invalid window.
//
// Design.  A block owns TILE consecutive positions.  It stages the codes of
// [base, base + TILE + k + 16) in shared memory, builds the packed 16-base
// windows P[j] (forward) and Q[j] (reverse complement) once per code, and
// gives every m-mer one key: 0 if a code of the m-mer is a sentinel, else
// 0x80000000 | norm.  A window is invalid iff one of its m-mers holds a
// sentinel, so ONE sliding minimum over the keys (log-step doubling in
// shared memory, ceil(log2(k-m+1)) steps) yields validity and signature
// together.  Each k-mer lane is then a single shared-memory read of P or Q
// at a fixed offset; outputs are written by consecutive threads at
// consecutive positions (coalesced).
//
// The 1-D entry keeps pallas_extract's contract: codes hold s + HALO codes
// (HALO = 2048, the tile's lookahead block), s is a multiple of the TPU's
// 65536-position tile and k + 16 <= HALO.  It checks that contract and
// reads no code past batch_len(s, k) = s + roundup8(k + 16), the live
// codes every output depends on; the rest of the halo is never touched.
//
// Bound.  Bytes: (s + k + 16) codes read plus 4 * (1 + W) * s bytes written;
// at s = 2^22, k = 27 (W = 2) that is ~54.5 MB, ~16 us at 3.35 TB/s.  The
// integer work per position is O(W + log k) plus O(16 + m) per staged code,
// far below the card's integer rate, so bytes bound it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;      // positions per block
constexpr int THREADS = 256;
constexpr int MAX_K = 256;
constexpr int NPQ = TILE + MAX_K;          // packed windows per block
constexpr int NCODES = TILE + MAX_K + 16;  // staged codes per block

__device__ __forceinline__ bool is_allowed(uint32_t m, int sig_len) {
  // CMmer::is_allowed (KMC mmer.h:40-63), as kmc_tpu/ops/extract.py does it
  uint32_t lo = m & 0x3Fu;
  if (lo == 0x3Fu || lo == 0x3Bu || (m & 0x3Cu) == 0x3Cu) return false;
  uint32_t x = m;
  for (int i = 0; i < sig_len - 3; ++i) {
    if ((x & 0xFu) == 0) return false;
    x >>= 2;
  }
  return x != 0 && x != 0x04u && (x & 0xFu) != 0;
}

__global__ void __launch_bounds__(THREADS)
splitter_scan_kernel(const uint8_t* __restrict__ codes, long long n_codes,
                     uint32_t* __restrict__ sig, uint32_t* __restrict__ lanes,
                     long long s, int k, int sig_len, int both_strands) {
  __shared__ uint8_t c[NCODES];
  __shared__ uint32_t P[NPQ];
  __shared__ uint32_t Q[NPQ];
  __shared__ uint32_t A[NPQ];
  __shared__ uint32_t B[NPQ];

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TILE;
  const int nc = TILE + k + 16;
  for (int j = tid; j < nc; j += THREADS) {
    long long g = base + j;
    c[j] = g < n_codes ? codes[g] : (uint8_t)4;
  }
  __syncthreads();

  const int npq = TILE + k;
  for (int j = tid; j < npq; j += THREADS) {
    uint32_t p = 0, q = 0;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uint32_t cc = min((uint32_t)c[j + t], 3u);
      p |= cc << (2 * (15 - t));
      q |= (3u - cc) << (2 * t);
    }
    P[j] = p;
    Q[j] = q;
  }
  __syncthreads();

  // m-mer keys over [0, TILE + k - m): positions i < TILE need m-mers
  // i .. i + k - m
  const int nm = TILE + k - sig_len;
  const uint32_t special = 1u << (2 * sig_len);
  const uint32_t mmask = special - 1u;
  for (int j = tid; j < nm; j += THREADS) {
    bool bad = false;
    for (int t = 0; t < sig_len; ++t) bad |= c[j + t] >= 4;
    uint32_t f = P[j] >> (2 * (16 - sig_len));
    uint32_t r = Q[j] & mmask;
    uint32_t fv = is_allowed(f, sig_len) ? f : special;
    uint32_t rv = is_allowed(r, sig_len) ? r : special;
    A[j] = bad ? 0u : (0x80000000u | min(fv, rv));
  }
  __syncthreads();

  // sliding minimum over w = k - m + 1 keys (extract._sliding_min's
  // doubling, ping-ponged between A and B)
  const int w = k - sig_len + 1;
  uint32_t* cur = A;
  uint32_t* nxt = B;
  int n = nm;
  int covered = 1;
  while (covered < w) {
    int step = min(covered, w - covered);
    for (int j = tid; j < n - step; j += THREADS)
      nxt[j] = min(cur[j], cur[j + step]);
    n -= step;
    covered += step;
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    __syncthreads();
  }

  const int W = (k + 15) / 16;
  const int r0 = k - 16 * (W - 1);
  const uint32_t m0 = r0 < 16 ? (1u << (2 * r0)) - 1u : 0xFFFFFFFFu;
  for (int i = tid; i < TILE; i += THREADS) {
    long long g = base + i;
    if (g >= s) break;
    uint32_t key = cur[i];
    bool valid = key != 0u;
    sig[g] = valid ? (key & 0x7FFFFFFFu) : 0xFFFFFFFFu;
    bool use_rc = false;
    if (valid && both_strands) {
      for (int t = 0; t < W; ++t) {
        uint32_t f = t == 0 ? (r0 < 16 ? P[i] >> (2 * (16 - r0)) : P[i])
                            : P[i + r0 + 16 * (t - 1)];
        uint32_t r = t == 0 ? (Q[i + k - r0] & m0) : Q[i + k - r0 - 16 * t];
        if (r != f) {
          use_rc = r < f;
          break;
        }
      }
    }
    for (int t = 0; t < W; ++t) {
      uint32_t v = 0xFFFFFFFFu;
      if (valid) {
        if (use_rc)
          v = t == 0 ? (Q[i + k - r0] & m0) : Q[i + k - r0 - 16 * t];
        else
          v = t == 0 ? (r0 < 16 ? P[i] >> (2 * (16 - r0)) : P[i])
                     : P[i + r0 + 16 * (t - 1)];
      }
      lanes[(long long)t * s + g] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes: u8[n_codes] device; sig: u32[s]; lanes: u32[W * s] (lane t at
// t * s).  Launches on `stream`; returns cudaGetLastError().
int kmc_splitter_scan(const void* codes, long long n_codes, void* sig,
                      void* lanes, long long s, int k, int sig_len,
                      int both_strands, void* stream) {
  if (s <= 0) return 0;
  if (k > MAX_K || sig_len < 5 || sig_len > 11 || k < sig_len)
    return (int)cudaErrorInvalidValue;
  long long blocks = (s + TILE - 1) / TILE;
  splitter_scan_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n_codes, (uint32_t*)sig, (uint32_t*)lanes, s, k,
      sig_len, both_strands);
  return (int)cudaGetLastError();
}

// pallas_extract's contract: codes: u8[n_codes] with n_codes >= s + 2048,
// s % 65536 == 0, k + 16 <= 2048; sig: u32[s]; lanes: u32[W * s] (lane t at
// t * s).  Reads codes [0, batch_len(s, k)) only.  Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue when the contract
// does not hold.
int kmc_splitter_scan_1d(const void* codes, long long n_codes, void* sig,
                         void* lanes, long long s, int k, int sig_len,
                         int both_strands, void* stream) {
  constexpr long long HALO = 2048, TILE_1D = 65536, TAIL = 16;
  if (s <= 0 || s % TILE_1D != 0 || k + TAIL > HALO || n_codes < s + HALO)
    return (int)cudaErrorInvalidValue;
  long long live = s + ((k + TAIL + 7) / 8) * 8;  // batch_len(s, k)
  return kmc_splitter_scan(codes, live, sig, lanes, s, k, sig_len,
                           both_strands, stream);
}

}  // extern "C"
