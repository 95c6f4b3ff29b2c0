// Splitter scan and fused ingest for Hopper (sm_90a).
//
// Replaces the TPU kernels kmc_tpu/ops/pallas_extract.py::pallas_extract2d
// (kernel body _kernel2d; C entry kmc_splitter_scan) and ::pallas_extract
// (the 1-D tile layout, kernel body _kernel; C entry kmc_splitter_scan_1d),
// and, around the same core, the whole per-batch executable that kmc_tpu
// builds with XLA from them: kmc_tpu/ops/store.py::_ingest_prefix_bounds
// and ::_ingest_prefix_fused (feed decode, splitter scan, signature -> bin,
// key columns, append; C entries kmc_ingest_bounds and kmc_ingest_mask).
//
// The scan's contract, in position order: for each start i < s,
//   sig[i]      = min over the window's k-m+1 m-mers of the canonical m-mer
//                 norm (4^m where no m-mer is allowed), or 0xFFFFFFFF when a
//                 code in [i, i+k) is a sentinel;
//   lane t of i = lane t (most significant first, right-aligned) of the
//                 smaller of the forward and reverse-complement k-mer, or
//                 0xFFFFFFFF for an invalid window.
// The ingest writes, at store rows n_used + i, the prefix policy's key
// columns: bin = sig >> (2m - prefix_bits) in lane 0's spare top bits
// (fused layout) or in a column of its own, then the lanes; all-ones for a
// dead row; 1 in the counts column when there is one.  It adds the valid
// windows to occ and the valid windows whose signature differs from their
// predecessor's to skm (64-bit, on the device), reads the predecessor of
// position 0 from prev_in and writes sig[s - 1] to prev_out (two buffers:
// block 0 reads while the last block writes).
//
// Design.  A block owns TILE positions and stages, in shared memory, the
// codes they read as 2-bit words (16 codes per u32, first code in the top
// bits: one big-endian load of the packed feed) and the sentinels as a
// bitmap (32 positions per u32, MSB first: the mask feed's own bits; or
// the boundary-delta list, whose prefix sum one short single-block launch
// turns into positions plus each tile's first slot; or, for the scan
// entries, 16 u8 codes per 16-byte load packed in registers).  Every
// 16-base window P is then one funnel shift of two staged words, its
// reverse complement Q the bit reversal of ~P with each bit pair swapped;
// both are kept per position, so each k-mer lane is one shared-memory
// read.  Each m-mer gets one key: 0 if the bitmap holds a sentinel in its
// m bits, else 0x80000000 | min(forward, reverse) after is_allowed, which
// is branch-free bit arithmetic.  A window is invalid iff one of its
// m-mers holds a sentinel, so ONE sliding minimum over the keys yields
// validity and signature together; it runs van Herk / Gil-Werman style,
// one thread per run of w = k-m+1 keys (suffix minima of its run, then
// prefix minima of the next), about three mins per key whatever w, with no
// barrier in between.  The tile computes one extra position in front (its
// predecessor) for the super-k-mer count.  The outputs take one position
// per thread, so each warp writes 128 contiguous bytes of a column (a
// design that gave each thread four rows for 16-byte stores issued about
// four times the instructions per position); occ and skm are reduced in
// the block and added with one 64-bit atomic each.
//
// Bound.  Bytes: the feed read once (L/4 + 2 L/64 for the boundary-delta
// feed, L/4 + L/8 for packed+mask, L codes for the scan entries; L =
// batch_len(s, k)) plus 4 B per row and output column: at s = 2^22,
// k = 27, ~34.7 MB for the fused ingest (0.0104 ms at 3.35 TB/s) and
// ~54.5 MB for the scan (0.0163 ms): the kernel's bound.  What holds this
// design above it is its own instruction count: chip_smoke.py reads about
// 344 integer instructions a position at k = 27 from the SASS (about 60 for
// the m-mer key, 70 for the sliding minimum, 170 for the strand choice and
// the stores; branches counted whole, so it errs high), 0.043 ms at 132
// SMs x 4 warp instructions a clock, against 0.055 ms measured for the
// scan (H100 SXM, chip_smoke.py phase 2).  The delta prefix sum is one
// block over L/64 slots: 0.021 ms at s = 2^22 on the same card, a quarter
// of the boundary-delta ingest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // positions per block
constexpr int THREADS = 256;
constexpr int MAX_K = 256;
constexpr int MIN_SIG = 5;
constexpr int MAX_SIG = 11;
constexpr int MAX_W = MAX_K - MIN_SIG + 1;  // keys in one window
// Local coordinates: x = position - base + 1 (x = 0 is the predecessor of
// the tile's first position); staged code c sits at position base - 32 + c,
// so position base - 1 + x is staged code x + ORG.
constexpr int ORG = 31;
constexpr int NKEY = TILE + 1 + 2 * MAX_W;  // >= (ceil((TILE+1)/w) + 1) w
constexpr int CHUNK = 8;  // keys a thread takes in the sliding minimum
// chunks of CHUNK keys in the runs of w keys: at most
// (TILE + 2w)(w + CHUNK - 1) / (CHUNK w), largest at the smallest w
constexpr int MIN_W = 14 - MAX_SIG + 1;
constexpr int NCHUNK =
    (TILE + 2 * MIN_W) * (MIN_W + CHUNK - 1) / (CHUNK * MIN_W) + 1;
constexpr int NCODE = ((NKEY + ORG + 48 + 31) / 32) * 32;
constexpr int NBW = NCODE / 32 + 1;  // bitmap words
constexpr int NPW = 2 * NBW;         // 2-bit code words
constexpr int MAX_COLS = 18;
constexpr int SCAN_THREADS = 1024;  // the delta prefix sum's one block
constexpr int SCAN_ITEMS = 8;       // consecutive deltas a thread scans

static_assert(4 * (NPW + NBW + 4 * NKEY + 2 * NCHUNK + 2 * THREADS / 32) <=
                  48 * 1024,
              "the scan kernel's static shared memory");

enum Feed { CODES = 0, MASK = 1, BOUNDS = 2 };
enum Col0 { COL0_SIG = 0, COL0_BIN = 1, COL0_FUSED = 2 };

struct Params {
  const uint8_t* feed;  // u8 codes (CODES) or the packed 2-bit codes
  long long n_feed;     // CODES: codes that may be read; else L
  const uint16_t* deltas;  // BOUNDS: the delta list
  const int* tile_lo;   // BOUNDS: first slot at or past each tile's base
  const int* tile_prev;  // BOUNDS: the position of the slot before it
  long long tail_start;  // BOUNDS: positions >= tail_start are sentinels
  long long s;
  int k, m, both, col0, shift, r0, W, n_cols;
  uint32_t* cols[MAX_COLS];  // col0's column, then the lanes' columns
  long long n_used;          // destination row of position 0
  uint32_t* counts;          // or null
  unsigned long long* occ;   // or null (scan entries)
  unsigned long long* skm;
  const uint32_t* prev_in;
  uint32_t* prev_out;
};

__device__ __forceinline__ uint32_t be32(const uint8_t* b, long long off,
                                         long long n) {
  // big-endian u32 of bytes b[off .. off+3]; bytes outside [0, n) are 0
  if (off >= 0 && off + 4 <= n && (((uintptr_t)(b + off)) & 3) == 0)
    return __byte_perm(*(const uint32_t*)(b + off), 0, 0x0123);
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    long long o = off + j;
    v = (v << 8) | (o >= 0 && o < n ? (uint32_t)b[o] : 0u);
  }
  return v;
}

// 4 u8 codes (little-endian word, first code in the low byte) -> their
// 2-bit packing (first code in the top bits) and their sentinel nibble
// (code >= 4, first code in bit 3).
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return ((w & 0x03030303u) * 0x40100401u) >> 24;
}
__device__ __forceinline__ uint32_t bad4(uint32_t w) {
  return ((__vcmpgtu4(w, 0x03030303u) & 0x01020408u) * 0x01010101u) >> 24;
}

// all-ones bits for positions p0 + b (b in 0..31, MSB first) outside
// [0, limit)
__device__ __forceinline__ uint32_t outside_bits(long long p0,
                                                 long long limit) {
  long long a = p0 < 0 ? -p0 : 0;
  long long c = limit - p0 < 32 ? limit - p0 : 32;
  if (c <= a) return 0xFFFFFFFFu;
  uint32_t keep = 0xFFFFFFFFu >> a;
  if (c < 32) keep &= ~(0xFFFFFFFFu >> c);
  return ~keep;
}

template <int F>
__device__ __forceinline__ void stage(const Params& p, long long base,
                                      uint32_t* PW, uint32_t* BW) {
  const long long org = base - 32;  // position of staged code 0
  const int tid = threadIdx.x;
  if (F == CODES) {
    for (int i = tid; i < NBW; i += THREADS) {
      const long long p0 = org + 32LL * i;
      uint32_t w[8];
      const uint8_t* src = p.feed + p0;
      if (p0 >= 0 && p0 + 32 <= p.n_feed && ((uintptr_t)src & 15) == 0) {
        uint4 a = *(const uint4*)src;
        uint4 b = *(const uint4*)(src + 16);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t v = 0;
#pragma unroll
          for (int b = 3; b >= 0; --b) {
            long long q = p0 + 4 * j + b;
            v = (v << 8) | (q >= 0 && q < p.n_feed ? (uint32_t)src[4 * j + b]
                                                   : 4u);
          }
          w[j] = v;
        }
      }
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) bits = (bits << 4) | bad4(w[j]);
      BW[i] = bits;
      PW[2 * i] = pack4(w[0]) << 24 | pack4(w[1]) << 16 | pack4(w[2]) << 8 |
                  pack4(w[3]);
      PW[2 * i + 1] = pack4(w[4]) << 24 | pack4(w[5]) << 16 |
                      pack4(w[6]) << 8 | pack4(w[7]);
    }
    return;
  }
  const long long L = p.n_feed;
  for (int i = tid; i < NPW; i += THREADS)
    PW[i] = be32(p.feed, org / 4 + 4LL * i, L / 4);
  if (F == MASK) {
    for (int i = tid; i < NBW; i += THREADS)
      BW[i] = ~be32(p.feed + L / 4, org / 8 + 4LL * i, L / 8);
    return;
  }
  for (int i = tid; i < NBW; i += THREADS)
    BW[i] = outside_bits(org + 32LL * i, p.tail_start);
  __syncthreads();
  // the listed sentinels of [org, org + NCODE): the slots from the tile
  // before this one to the tile after the next, their positions summed up
  // by one warp from the position before the first
  const long long t = base / TILE;
  if (tid < 32) {
    const int lo = t > 0 ? p.tile_lo[t - 1] : 0;
    const int hi = p.tile_lo[t + 2];
    int run = t > 0 ? p.tile_prev[t - 1] : -1;
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + tid;
      const int d = j < hi ? (int)p.deltas[j] : 0;
      int incl = d;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (tid >= o) incl += y;
      }
      const long long c = (long long)(run + incl) - org;
      if (d && c >= 0 && c < NCODE)  // a zero delta repeats a position
        atomicOr(&BW[c >> 5], 0x80000000u >> (c & 31));
      run += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
  }
}

__device__ __forceinline__ uint32_t window16(const uint32_t* PW, int c) {
  // the 16 codes from staged code c, first in the top bits
  return __funnelshift_l(PW[(c >> 4) + 1], PW[c >> 4], 2 * (c & 15));
}

__device__ __forceinline__ uint32_t bits32(const uint32_t* BW, int c) {
  // the sentinel bits of staged codes c .. c+31, first in the top bit
  return __funnelshift_l(BW[(c >> 5) + 1], BW[c >> 5], c & 31);
}

__device__ __forceinline__ uint32_t revcomp16(uint32_t p) {
  uint32_t r = __brev(~p);  // reverses the bases and each base's two bits
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

__device__ __forceinline__ bool is_allowed(uint32_t v, int m) {
  // CMmer::is_allowed (KMC mmer.h:40-63) as bit arithmetic: no "AA" pair
  // at bases (i, i+1) for i <= m-3 (base 0 the last), none of the endings
  // TTT, TGT, TT? and no prefix ACA.  z has bit 2b set iff base b is A.
  uint32_t z = ~(v | (v >> 1)) & 0x55555555u;
  uint32_t pairs = ((1u << (2 * (m - 2))) - 1u) & 0x55555555u;
  uint32_t lo = v & 0x3Fu;
  return !((z & (z >> 2) & pairs) | (lo == 0x3Fu) | (lo == 0x3Bu) |
           ((v & 0x3Cu) == 0x3Cu) | ((v >> (2 * m - 6)) == 4u));
}

__device__ __forceinline__ uint32_t sig_of(uint32_t key) {
  return key ? key & 0x7FFFFFFFu : 0xFFFFFFFFu;
}

template <int F>
__global__ void __launch_bounds__(THREADS) scan_kernel(Params p) {
  __shared__ uint32_t PW[NPW];
  __shared__ uint32_t BW[NBW];
  __shared__ uint32_t A[NKEY];   // m-mer keys
  __shared__ uint32_t B[NKEY];   // window minima
  __shared__ uint32_t PA[NKEY];  // 16-base windows P from each x
  __shared__ uint32_t QA[NKEY];  // their reverse complements Q
  __shared__ uint32_t CS[NCHUNK];  // minima of the later chunks of a run
  __shared__ uint32_t CP[NCHUNK];  // minima of the earlier chunks of a run
  __shared__ unsigned red[2][THREADS / 32];

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TILE;
  stage<F>(p, base, PW, BW);
  __syncthreads();

  const int k = p.k, m = p.m, w = k - m + 1;
  const int nseg = (TILE + w) / w;  // runs of w keys covering x in [0, TILE]
  // keys for the minimum (runs 0 .. nseg), windows for the lanes (x + k - 1
  // at most)
  const int nkey = max((nseg + 1) * w, TILE + k);
  const uint32_t special = 1u << (2 * m);
  for (int x = tid; x < nkey; x += THREADS) {
    const int c = x + ORG;
    const uint32_t win = window16(PW, c);
    const uint32_t rc = revcomp16(win);
    PA[x] = win;
    QA[x] = rc;
    uint32_t key = 0u;
    if (!(bits32(BW, c) >> (32 - m))) {
      const uint32_t f = win >> (32 - 2 * m);
      const uint32_t r = rc & (special - 1u);
      key = 0x80000000u | min(is_allowed(f, m) ? f : special,
                              is_allowed(r, m) ? r : special);
    }
    A[x] = key;
  }
  __syncthreads();

  // B[x] = min(A[x .. x+w-1]), van Herk / Gil-Werman: runs of w keys from
  // x = 0; the window at x = q w + r is the suffix of run q from r and the
  // prefix of run q + 1 up to r - 1.  Each run is cut into chunks of CHUNK
  // keys: one thread per chunk takes the chunk's own suffix minima (into B)
  // and prefix minima (over A, in place) and its minimum; one thread per
  // run combines the chunk minima; then one thread per x reads two of each.
  const int nsub = (w + CHUNK - 1) / CHUNK;
  for (int i = tid; i < (nseg + 1) * nsub; i += THREADS) {
    const int q = i / nsub, u = i - q * nsub;
    const int lo = q * w + u * CHUNK;
    const int len = min(CHUNK, w - u * CHUNK);
    uint32_t v[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) v[j] = j < len ? A[lo + j] : 0xFFFFFFFFu;
    uint32_t h = 0xFFFFFFFFu;
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      h = min(h, v[j]);
      if (j < len) B[lo + j] = h;
    }
    uint32_t g = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      g = min(g, v[j]);
      if (j < len) A[lo + j] = g;
    }
    CS[i] = h;  // the chunk's minimum, for now
  }
  __syncthreads();
  for (int q = tid; q <= nseg; q += THREADS) {
    uint32_t run = 0xFFFFFFFFu;
    for (int u = 0; u < nsub; ++u) {
      CP[q * nsub + u] = run;
      run = min(run, CS[q * nsub + u]);
    }
    run = 0xFFFFFFFFu;
    for (int u = nsub - 1; u >= 0; --u) {
      const uint32_t c = CS[q * nsub + u];
      CS[q * nsub + u] = run;
      run = min(run, c);
    }
  }
  __syncthreads();
  {
    int q = tid / w, r = tid - q * w;
    const int dq = THREADS / w, dr = THREADS - dq * w;
    for (int x = tid; x <= TILE; x += THREADS) {
      uint32_t mn = min(B[x], CS[q * nsub + r / CHUNK]);
      if (r) {
        const int e = (q + 1) * w + r - 1;
        mn = min(mn, min(A[e], CP[(q + 1) * nsub + (r - 1) / CHUNK]));
      }
      B[x] = mn;
      q += dq;
      r += dr;
      if (r >= w) {
        r -= w;
        ++q;
      }
    }
  }
  __syncthreads();

  // one position per thread: consecutive threads write consecutive rows
  const int tlen = (int)(p.s - base < TILE ? p.s - base : TILE);
  const int r0 = p.r0, W = p.W;
  const uint32_t m0 = r0 < 16 ? (1u << (2 * r0)) - 1u : 0xFFFFFFFFu;
  const int lane_col = p.col0 == COL0_FUSED ? 0 : 1;  // column of lane 0
  const long long row0 = p.n_used + base;  // the tile's first row
  uint32_t* const col0 = p.cols[0] + row0;
  uint32_t* const col1 = lane_col ? p.cols[1] + row0 : nullptr;
  uint32_t* const counts = p.counts ? p.counts + row0 : nullptr;
  const long long last = p.s - 1 - base;  // the tile's index of s - 1
  unsigned occ = 0, skm = 0;
  for (int pl = tid; pl < tlen; pl += THREADS) {
    const int x = pl + 1;
    const uint32_t key = B[x];
    const uint32_t dead = key ? 0u : 0xFFFFFFFFu;  // all-ones when invalid
    const uint32_t sig = key & 0x7FFFFFFFu;
    if (p.occ && key) {
      ++occ;
      const uint32_t prev = base == 0 && pl == 0 ? *p.prev_in
                                                 : sig_of(B[x - 1]);
      skm += sig != prev;
    }
    if (pl == last && p.prev_out) *p.prev_out = sig_of(key);
    // lane t: forward P[x + r0 + 16 (t-1)] (lane 0: P[x] >> (32 - 2 r0)),
    // reverse complement Q[x + k - r0 - 16 t] (lane 0 masked to r0 bases)
    const uint32_t f0 = r0 < 16 ? PA[x] >> (32 - 2 * r0) : PA[x];
    const uint32_t q0 = QA[x + k - r0] & m0;
    bool use_rc = false;
    if (p.both) {
      use_rc = q0 < f0;
      for (int t = 1; t < W && q0 == f0 && !use_rc; ++t) {
        const uint32_t f = PA[x + r0 + 16 * (t - 1)];
        const uint32_t r = QA[x + k - r0 - 16 * t];
        if (r != f) {
          use_rc = r < f;
          break;
        }
      }
    }
    const uint32_t lane0 = use_rc ? q0 : f0;
    uint32_t v0;
    if (p.col0 == COL0_FUSED)
      v0 = ((sig >> p.shift) << (2 * r0)) | lane0;
    else
      v0 = p.col0 == COL0_SIG ? sig : sig >> p.shift;
    col0[pl] = v0 | dead;
    if (col1) col1[pl] = lane0 | dead;
    for (int t = 1; t < W; ++t) {
      const uint32_t lane = use_rc ? QA[x + k - r0 - 16 * t]
                                   : PA[x + r0 + 16 * (t - 1)];
      p.cols[t + lane_col][row0 + pl] = lane | dead;
    }
    if (counts) counts[pl] = 1u;
  }
  if (p.occ) {
    occ = __reduce_add_sync(0xFFFFFFFFu, occ);
    skm = __reduce_add_sync(0xFFFFFFFFu, skm);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = occ;
      red[1][tid >> 5] = skm;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long o = 0, sk = 0;
      for (int i = 0; i < THREADS / 32; ++i) {
        o += red[0][i];
        sk += red[1][i];
      }
      atomicAdd(p.occ, o);
      atomicAdd(p.skm, sk);
    }
  }
}

// The boundary-delta list (little-endian u16 deltas; slot i lists the
// sentinel at pos[i] = (sum of deltas [0, i]) - 1) -> for each tile t,
// tile_lo[t] = the first slot i < n_real with pos[i] >= t * TILE (else
// n_real; n_real: slots up to the last non-zero delta, the zero deltas
// after it being padding) and tile_prev[t] = pos[tile_lo[t] - 1] (-1
// before slot 0), from which a tile sums its own slots' positions.  One
// block takes chunks of SCAN_THREADS * SCAN_ITEMS slots, staged in shared
// memory by coalesced loads; each thread scans SCAN_ITEMS consecutive
// slots around one block-wide scan of the thread sums, and fills the
// tiles its slots start.  It writes 2 ints a tile and nothing per slot.
__global__ void __launch_bounds__(SCAN_THREADS)
delta_scan_kernel(const uint16_t* __restrict__ d, int nb,
                  int* __restrict__ tile_lo, int* __restrict__ tile_prev,
                  int n_lo) {
  constexpr int CH = SCAN_THREADS * SCAN_ITEMS;
  __shared__ uint16_t dv[CH];
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ unsigned long long last_s;  // (slot + 1) << 32 | its position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) last_s = 0;
  __syncthreads();
  int carry = 0;
  unsigned long long last = 0;
  for (int c0 = 0; c0 < nb; c0 += CH) {
    __syncthreads();  // dv and warp_sums of the chunk before are read
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int i = c0 + j * SCAN_THREADS + tid;
      dv[j * SCAN_THREADS + tid] = i < nb ? d[i] : (uint16_t)0;
    }
    __syncthreads();
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = dv[tid * SCAN_ITEMS + j];
      sum += v[j];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int ws = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, ws, o);
      if (lane >= o) ws += y;
    }
    const int before = __shfl_sync(0xFFFFFFFFu, ws, (warp + 31) & 31);
    const int total = __shfl_sync(0xFFFFFFFFu, ws, 31);
    int p = carry + (warp ? before : 0) + incl - sum - 1;
    const int i0 = c0 + tid * SCAN_ITEMS;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int prev = p;
      p += v[j];
      if (v[j]) {  // a listed sentinel: it starts the tiles in (prev, p]
        last = (unsigned long long)(i0 + j + 1) << 32 | (unsigned)p;
        const int t_hi = min(p / TILE, n_lo - 1);
        for (int t = (prev + TILE) / TILE; t <= t_hi; ++t) {
          tile_lo[t] = i0 + j;
          tile_prev[t] = prev;
        }
      }
    }
    carry += total;
  }
  atomicMax(&last_s, last);
  __syncthreads();
  const int n_real = (int)(last_s >> 32);
  const int last_pos = n_real ? (int)(unsigned)last_s : -1;
  for (int t = (last_pos + TILE) / TILE + tid; t < n_lo; t += SCAN_THREADS)
    tile_lo[t] = n_real;
}

int launch_scan(const Params& p, int feed, cudaStream_t st) {
  const unsigned blocks = (unsigned)((p.s + TILE - 1) / TILE);
  if (feed == CODES)
    scan_kernel<CODES><<<blocks, THREADS, 0, st>>>(p);
  else if (feed == MASK)
    scan_kernel<MASK><<<blocks, THREADS, 0, st>>>(p);
  else
    scan_kernel<BOUNDS><<<blocks, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

bool bad_shape(long long s, int k, int sig_len) {
  return s <= 0 || s % 8 || k > MAX_K || k < 14 || sig_len < MIN_SIG ||
         sig_len > MAX_SIG;
}

Params scan_params(int k, int sig_len, int both, long long s) {
  Params p = {};
  p.s = s;
  p.k = k;
  p.m = sig_len;
  p.both = both;
  p.W = (k + 15) / 16;
  p.r0 = k - 16 * (p.W - 1);
  return p;
}

int ingest(int device, int feed, const void* buf, long long n_buf,
           long long tail_start, void* scratch, void* const* cols, int n_cols,
           long long n_used, void* counts, void* occ, void* skm,
           const void* prev_in, void* prev_out, long long s, int k,
           int sig_len, int both, int prefix_bits, int fuse, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(s, k, sig_len)) return (int)cudaErrorInvalidValue;
  Params p = scan_params(k, sig_len, both, s);
  const long long L = s + ((k + 16 + 7) / 8) * 8;  // batch_len(s, k)
  if (n_cols != p.W + (fuse ? 0 : 1) || n_cols > MAX_COLS ||
      prefix_bits < 0 || prefix_bits > 2 * sig_len ||
      (fuse && 2 * p.r0 + prefix_bits + 1 > 32))
    return (int)cudaErrorInvalidValue;
  p.feed = (const uint8_t*)buf;
  p.n_feed = L;
  p.col0 = fuse ? COL0_FUSED : COL0_BIN;
  p.shift = 2 * sig_len - prefix_bits;
  p.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) p.cols[c] = (uint32_t*)cols[c];
  p.n_used = n_used;
  p.counts = (uint32_t*)counts;
  p.occ = (unsigned long long*)occ;
  p.skm = (unsigned long long*)skm;
  p.prev_in = (const uint32_t*)prev_in;
  p.prev_out = (uint32_t*)prev_out;
  p.tail_start = tail_start;
  cudaStream_t st = (cudaStream_t)stream;
  if (feed == BOUNDS) {
    const long long nb = (n_buf - L / 4) / 2;
    const long long n_tiles = (s + TILE - 1) / TILE;
    int* tile_lo = (int*)scratch;
    int* tile_prev = tile_lo + n_tiles + 2;
    const uint8_t* deltas = (const uint8_t*)buf + L / 4;
    if ((uintptr_t)deltas & 1) return (int)cudaErrorInvalidValue;
    delta_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
        (const uint16_t*)deltas, (int)nb, tile_lo, tile_prev,
        (int)n_tiles + 2);
    p.deltas = (const uint16_t*)deltas;
    p.tile_lo = tile_lo;
    p.tile_prev = tile_prev;
  }
  return launch_scan(p, feed, st);
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes: u8[n_codes] device (a code >= 4 is a sentinel; codes past n_codes
// read as sentinels); sig: u32[s]; lanes: u32[W * s] (lane t at t * s);
// s % 8 == 0.  Sets `device`, launches on `stream`; returns
// cudaGetLastError().
int kmc_splitter_scan(int device, const void* codes, long long n_codes,
                      void* sig, void* lanes, long long s, int k, int sig_len,
                      int both_strands, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(s, k, sig_len)) return (int)cudaErrorInvalidValue;
  Params p = scan_params(k, sig_len, both_strands, s);
  p.feed = (const uint8_t*)codes;
  p.n_feed = n_codes;
  p.col0 = COL0_SIG;
  p.n_cols = 1 + p.W;
  p.cols[0] = (uint32_t*)sig;
  for (int t = 0; t < p.W; ++t) p.cols[1 + t] = (uint32_t*)lanes + t * s;
  return launch_scan(p, CODES, (cudaStream_t)stream);
}

// pallas_extract's contract: codes: u8[n_codes] with n_codes >= s + 2048,
// s % 65536 == 0, k + 16 <= 2048; sig: u32[s]; lanes: u32[W * s] (lane t at
// t * s).  Reads codes [0, batch_len(s, k)) only.  Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue when the contract
// does not hold.
int kmc_splitter_scan_1d(int device, const void* codes, long long n_codes,
                         void* sig, void* lanes, long long s, int k,
                         int sig_len, int both_strands, void* stream) {
  constexpr long long HALO = 2048, TILE_1D = 65536, TAIL = 16;
  if (s <= 0 || s % TILE_1D != 0 || k + TAIL > HALO || n_codes < s + HALO)
    return (int)cudaErrorInvalidValue;
  long long live = s + ((k + TAIL + 7) / 8) * 8;  // batch_len(s, k)
  return kmc_splitter_scan(device, codes, live, sig, lanes, s, k, sig_len,
                           both_strands, stream);
}

// The fused ingest of one boundary-delta batch (io/native.py::
// pack_codes_boundaries): buf u8[n_buf] = L/4 packed bytes ++ LE u16
// deltas; positions >= tail_start are sentinels.  scratch: int32[2 *
// (ceil(s / 1024) + 2)].  cols: n_cols u32 columns
// written at rows [n_used, n_used + s); counts: u32 column
// or null; occ, skm: u64 accumulators; prev_in, prev_out: u32[1], distinct.
// Sets `device`, launches the delta scan and the ingest on `stream`;
// returns cudaGetLastError() or cudaErrorInvalidValue.
int kmc_ingest_bounds(int device, const void* buf, long long n_buf,
                      long long tail_start, void* scratch, void* const* cols,
                      int n_cols, long long n_used, void* counts, void* occ,
                      void* skm, const void* prev_in, void* prev_out,
                      long long s, int k, int sig_len, int both_strands,
                      int prefix_bits, int fuse, void* stream) {
  return ingest(device, BOUNDS, buf, n_buf, tail_start, scratch, cols, n_cols,
                n_used, counts, occ, skm, prev_in, prev_out, s, k, sig_len,
                both_strands, prefix_bits, fuse, stream);
}

// The same for one packed+mask batch (io/native.py::pack_codes_fused):
// buf u8[L/4 + L/8], mask bit 1 = a base, MSB first.
int kmc_ingest_mask(int device, const void* buf, long long n_buf,
                    void* const* cols, int n_cols, long long n_used,
                    void* counts, void* occ, void* skm, const void* prev_in,
                    void* prev_out, long long s, int k, int sig_len,
                    int both_strands, int prefix_bits, int fuse,
                    void* stream) {
  return ingest(device, MASK, buf, n_buf, 0, nullptr, cols, n_cols, n_used,
                counts, occ, skm, prev_in, prev_out, s, k, sig_len,
                both_strands, prefix_bits, fuse, stream);
}

}  // extern "C"
