// Grouping sort for Hopper (sm_90a): rows of u32 columns sorted ascending by
// their first n_keys columns, compared lexicographically as unsigned; the
// other columns (the store's counts, the senders' payloads) move with their
// rows.  Stable, any length below 2^32, no padding, launched on the caller's
// stream with no host synchronisation.
//
// Replaces the TPU kernel kmc_tpu/ops/pallas_sort.py::pallas_bitonic_sort
// (pallas_sort.py:170, kernel body _ladder_kernel), behind the contract of
// kmc_tpu/ops/store.py:726 _grouping_sort.
//
// Bound.  Every column read once and written once, what any sort of these
// rows must move: at 2^26 rows with 2 keys + counts, 2 x 3 x 4 B x 2^26 =
// 1.61 GB, 0.481 ms at 3.35 TB/s.
//
// Design: a one-sweep LSD radix sort (Adinets & Merrill, "Onesweep: A Faster
// Least Significant Digit Radix Sort for GPUs", 2022) with 8-bit digits.
//   * The pass plan (ops/sort_kernel.py::sort_plan) lists the digit passes
//     as (column, shift, width): the key columns from the last to the
//     first, each byte from the least significant up, width 8 always.
//   * digit_histograms reads each key column once and builds the 256-bin
//     histograms of all four of its bytes at once (per-block histograms in
//     shared memory, each thread adding runs of equal digits, summed into a
//     global table).  make_plan turns them into every pass's exclusive
//     digit bases and marks a pass dead when one digit holds all n rows: a
//     pass over a constant digit moves nothing.  It also gives each live
//     pass its source and destination buffer and their layouts, so that
//     the last live pass writes the output; nothing returns to the host.
//   * onesweep_pass, one launch per planned pass (a dead pass returns at
//     once), takes tiles of 6144 rows in the order of an atomic tile
//     counter (so look-back never waits on a tile that has not started),
//     stages each tile in shared memory with 16-byte cp.async copies,
//     ranks its digits there (warp-private counters; the lanes that share
//     a digit found by 8 ballots, one per digit bit; then a block scan: a
//     row's slot keeps input order among equal digits, so every pass is
//     stable), and gets each digit's offset in the output from decoupled
//     look-back over a (tile, digit) status word: 2 flag bits, the pass's
//     epoch and a 32-bit count.  The epoch lets every pass reuse one
//     status array that is zeroed once per sort.  The tile is then written
//     from shared memory in digit order:
//     consecutive threads write consecutive rows inside each digit's run.
//   * Layouts.  The first live pass reads the caller's columns; the last
//     writes the output columns.  The passes between keep the rows
//     interleaved (row-major, n_carried words a row) in the two ping-pong
//     buffers, so a pass writes 256 runs of whole rows rather than 256 runs
//     per column: fewer, longer runs, fewer partly written sectors.
//   * Rows mode (at most ROWS_MAX_COLS = 3 columns, every main-path shape:
//     2 keys + counts, the unit compaction's 2 keys, the senders' 1 key + 2
//     payloads): every pass carries the whole row, so no column is ever
//     gathered.  The ping-pong buffers are the output's storage and a
//     scratch block of the same size.  Per pass a row moves 4 B x n_cols
//     read and the same written: 24 B at 3 columns, so 8 passes of 2^26
//     rows move 12.9 GB (3.85 ms at 3.35 TB/s) plus the histogram's read
//     of the keys (0.54 GB).
//   * Index mode (4 columns or more: k >= 33 with counts, up to 18 columns
//     at k = 256): a pass carries (key word, row index), 16 B a row; the
//     first live pass on a key column gathers that column through the
//     index, and finish_index gathers every column once at the end.  At 18
//     columns a pass of whole rows would move 144 B a row against 16; the
//     cut at 4 columns also keeps the scratch within the old kernel's
//     4 x n x 4 B: rows mode takes n_cols <= 3 columns of scratch, index
//     mode 2 (its other pair of buffers is the output's first two columns,
//     which the final gather overwrites after reading the index they hold).
//   * What this does about the old kernel's three faults: one pass kernel
//     in place of histogram + scan + scatter, and one histogram read for
//     all passes; the scatter writes digit runs from shared memory instead
//     of single words with three barriers per 256 rows; whole rows ride in
//     the passes, so the main path does no random gather.
//   * Choices, each timed against its alternative on an H100 while the
//     kernel was written: tiles of 6144 rows beat 2048 and 4096 (longer
//     digit runs, fewer tiles to look back over; two blocks fit an SM);
//     row-major passes between the first and the last beat column-major
//     ones; 8 ballots beat __match_any_sync for the peers of a digit (by
//     most with one column).  Dropped: publishing a tile's counts before
//     it ranks (no change) and 512 threads on the same tile (slower).
//     What is left: without its stores a pass still takes most of its
//     time, so a tile's serial chain (stage, rank, scan, look-back, write)
//     with two blocks on an SM bounds it, not the memory; prefetching the
//     next tile while one is ranked is the next step.  Digit width:
//     8 bits.  11-bit digits (6 passes for 64 key bits) would need 2048
//     counters per warp and per tile status word and digits across the
//     32-bit column boundary; not tried.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 24;               // rows a thread ranks per tile
constexpr int TILE = THREADS * ITEMS;   // 6144 rows
constexpr int CHUNK = TILE / WARPS;     // rows a warp ranks
constexpr int RADIX = 256;
constexpr int MAX_COLS = 32;
constexpr int MAX_PASSES = 4 * MAX_COLS;
constexpr int ROWS_MAX_COLS = 3;
constexpr uint32_t FULL = 0xFFFFFFFFu;

// status word: flag (2 bits) | epoch (30 bits) | count (32 bits)
constexpr unsigned long long FLAG_AGG = 1ull << 62;
constexpr unsigned long long FLAG_INCL = 2ull << 62;
constexpr unsigned long long COUNT_BITS = 0xFFFFFFFFull;

// plan entry flags (int4.w)
constexpr int GATHER = 1;  // index mode: gather a new key column
constexpr int DST_ROW_MAJOR = 2;

struct Cols {
  const uint32_t* p[MAX_COLS];
};

struct PassArgs {
  Cols in;            // the caller's columns
  uint32_t* buf[3];   // [1]: the output's storage, [2]: scratch; each holds
                      // n_carried columns of `stride` words, or rows
  long long stride;   // words between columns of buf[1] and buf[2]
  int n_cols;
  int in_vec;         // every input column is 16-byte aligned
  long long n;
  int n_passes;
  const int4* plan;   // per pass {live, src, dst, flags}; [n_passes].x:
                      // the number of live passes
  const uint32_t* bases;       // per pass, 256 exclusive digit bases
  uint32_t* counters;          // per pass, the tile counter
  unsigned long long* status;  // per (tile, digit)
};

struct PlanArgs {
  unsigned char hslot[MAX_PASSES];  // histogram of a pass: col * 4 + shift / 8
  unsigned char col[MAX_PASSES];
};

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread across the block (THREADS).
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t ws = lane < WARPS ? warp_sums[lane] : 0u;
    ws = warp_inclusive_scan(ws);
    if (lane < WARPS) warp_sums[lane] = ws;
  }
  __syncthreads();
  uint32_t before = warp > 0 ? warp_sums[warp - 1] : 0u;
  __syncthreads();  // warp_sums may be reused right after
  return before + incl - v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy words [0, count) of src into sm: 16-byte asynchronous copies when
// `vec` (src 16-byte aligned, count a multiple of 4; visible after
// cp_async_wait and a barrier), plain loads and stores otherwise.
__device__ __forceinline__ void stage_words(uint32_t* sm, const uint32_t* src,
                                           int count, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < count / 4; q += THREADS)
      cp_async16(sm + 4 * q, src + 4 * q);
  } else {
    for (int i = threadIdx.x; i < count; i += THREADS) sm[i] = src[i];
  }
}

__device__ __forceinline__ void hist_add(uint32_t x, uint32_t (&cd)[4],
                                         uint32_t (&cc)[4],
                                         uint32_t (*h)[RADIX]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t d = (x >> (8 * b)) & 0xFFu;
    if (d == cd[b]) {
      ++cc[b];
    } else {
      if (cc[b]) atomicAdd(&h[b][cd[b]], cc[b]);
      cd[b] = d;
      cc[b] = 1;
    }
  }
}

// hist[(col * 4 + byte) * 256 + digit] += count, for key column blockIdx.y.
__global__ void __launch_bounds__(THREADS)
digit_histograms(Cols in, long long n, int vec, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[4][RADIX];
  for (int i = threadIdx.x; i < 4 * RADIX; i += THREADS) (&h[0][0])[i] = 0;
  __syncthreads();
  const int col = blockIdx.y;
  const uint32_t* src = in.p[col];
  uint32_t cd[4] = {0, 0, 0, 0};
  uint32_t cc[4] = {0, 0, 0, 0};
  const long long n_quads = vec ? n / 4 : 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long q = (long long)blockIdx.x * THREADS + threadIdx.x;
       q < n_quads; q += stride) {
    uint4 x = reinterpret_cast<const uint4*>(src)[q];
    hist_add(x.x, cd, cc, h);
    hist_add(x.y, cd, cc, h);
    hist_add(x.z, cd, cc, h);
    hist_add(x.w, cd, cc, h);
  }
  for (long long i = 4 * n_quads + (long long)blockIdx.x * THREADS +
                     threadIdx.x;
       i < n; i += stride)
    hist_add(src[i], cd, cc, h);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (cc[b]) atomicAdd(&h[b][cd[b]], cc[b]);
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * RADIX; i += THREADS) {
    const uint32_t c = (&h[0][0])[i];
    if (c) atomicAdd(&hist[(col * 4 + i / RADIX) * RADIX + i % RADIX], c);
  }
}

// One block of 256 threads (one per digit): exclusive digit bases of every
// pass, its liveness and its buffers.  Live pass r of P reads buffer src
// (0 = the caller's columns for r = 0, else the previous live pass's
// destination, row-major) and writes buffer 1 (the output) when P - 1 - r
// is even, else buffer 2, row-major except for the last, so the last live
// pass writes the output's columns.  In index mode the first live pass on
// a key column, other than the first live pass of all, gathers that column
// through the carried row index.
__global__ void __launch_bounds__(THREADS)
make_plan(const uint32_t* __restrict__ hist, PlanArgs pa, int n_passes,
          long long n, int index_mode, uint32_t* __restrict__ bases,
          int4* __restrict__ plan) {
  __shared__ uint32_t warp_sums[WARPS];
  __shared__ int live[MAX_PASSES];
  const int d = threadIdx.x;
  for (int p = 0; p < n_passes; ++p) {
    const uint32_t c = hist[pa.hslot[p] * RADIX + d];
    const int all_one = __syncthreads_or((long long)c == n);
    bases[p * RADIX + d] = block_exclusive_scan(c, warp_sums);
    if (d == 0) live[p] = !all_one;
  }
  __syncthreads();
  if (d == 0) {
    int n_live = 0;
    for (int p = 0; p < n_passes; ++p) n_live += live[p];
    int r = 0, prev_dst = 0, prev_col = -1;
    for (int p = 0; p < n_passes; ++p) {
      if (!live[p]) {
        plan[p] = make_int4(0, 0, 0, 0);
        continue;
      }
      const int dst = ((n_live - 1 - r) & 1) == 0 ? 1 : 2;
      const int flags = (index_mode && r > 0 && pa.col[p] != prev_col
                             ? GATHER : 0) |
                        (r < n_live - 1 ? DST_ROW_MAJOR : 0);
      plan[p] = make_int4(1, r == 0 ? 0 : prev_dst, dst, flags);
      prev_dst = dst;
      prev_col = pa.col[p];
      ++r;
    }
    plan[n_passes] = make_int4(n_live, 0, 0, 0);
  }
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// One stable pass over digit (key >> shift) & 255 of key column `col`.
// Rows mode carries every column (NC of them); index mode carries
// (key, row index), NC = 2.  Dynamic shared memory: the staged tile
// (NC x TILE words, column-major for the first live pass, else row-major),
// then the slot -> row map and the slot -> digit map.
template <int NC, bool INDEX>
__global__ void __launch_bounds__(THREADS)
onesweep_pass(PassArgs a, int p, int col, int shift) {
  const int4 pl = a.plan[p];
  if (!pl.x) return;
  extern __shared__ __align__(16) uint32_t stage[];
  unsigned short* row_at = (unsigned short*)(stage + NC * TILE);
  unsigned char* digit_at = (unsigned char*)(row_at + TILE);
  __shared__ uint32_t wcnt[WARPS][RADIX];
  __shared__ uint32_t local_base[RADIX];
  __shared__ long long out_base[RADIX];
  __shared__ uint32_t warp_sums[WARPS];
  __shared__ uint32_t tile_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(&a.counters[p], 1u);
  for (int w = 0; w < WARPS; ++w) wcnt[w][tid] = 0;
  __syncthreads();
  const uint32_t tile = tile_s;
  const long long base = (long long)tile * TILE;
  const int count = (int)min((long long)TILE, a.n - base);

  // 1. stage the tile.  From the caller's columns: the digit column first
  // (group 0), the others after (group 1), whose copies stay in flight
  // while the tile ranks.  From a ping-pong buffer: the rows in one piece.
  const bool first = pl.y == 0;
  const int sr = first ? 1 : NC;     // stage[r * sr + c * sc]: row r, column c
  const int sc = first ? TILE : 1;
  const int kc = INDEX ? 0 : col;    // the staged column holding the digit
  const bool in_vec = a.in_vec && count == TILE;
  if (first) {
    stage_words(stage + kc * TILE, a.in.p[col] + base, count, in_vec);
    cp_async_commit();
    if constexpr (INDEX) {
      for (int i = tid; i < count; i += THREADS)
        stage[TILE + i] = (uint32_t)(base + i);
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c != col)
          stage_words(stage + c * TILE, a.in.p[c] + base, count, in_vec);
    }
    cp_async_commit();
  } else {
    stage_words(stage, a.buf[pl.y] + base * NC, count * NC, count == TILE);
    cp_async_commit();
    if (INDEX && (pl.w & GATHER)) {  // a new key column, through the index
      cp_async_wait<0>();
      __syncthreads();
      const uint32_t* c = a.in.p[col];
      for (int i = tid; i < count; i += THREADS)
        stage[2 * i] = c[stage[2 * i + 1]];
    }
    cp_async_commit();  // group 1: empty
  }
  cp_async_wait<1>();
  __syncthreads();

  // 2. rank: warp w owns rows [w * CHUNK, (w + 1) * CHUNK), 32 at a time;
  // a row's rank counts the rows of its digit before it in its warp
  const unsigned lt_mask = (1u << lane) - 1u;
  uint32_t packed[ITEMS];  // digit << 16 | rank among equal digits of the warp
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = warp * CHUNK + j * 32 + lane;
    const uint32_t d = r < count ? (stage[r * sr + kc * sc] >> shift) & 0xFFu
                                 : (uint32_t)RADIX;
    // the lanes whose digit equals this lane's: one ballot per digit bit,
    // and one that parts the rows past the tile's end from the rest
    unsigned peers = __ballot_sync(FULL, d < RADIX) ^ (d < RADIX ? 0u : FULL);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned m = __ballot_sync(FULL, (d >> b) & 1u);
      peers &= ((d >> b) & 1u) ? m : ~m;
    }
    const uint32_t lower = __popc(peers & lt_mask);
    const uint32_t before = d < RADIX ? wcnt[warp][d] : 0u;
    __syncwarp();
    if (d < RADIX && lower == 0) wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
    packed[j] = (d << 16) | (before + lower);
  }
  __syncthreads();

  // 3. per digit (thread tid = digit): the warps' exclusive offsets and the
  // tile total, published at once as this tile's aggregate; the tile's
  // digit bases; each row's slot
  const unsigned long long epoch = (unsigned long long)(p + 1) << 32;
  unsigned long long* st = a.status + (long long)tile * RADIX + tid;
  uint32_t total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint32_t c = wcnt[w][tid];
    wcnt[w][tid] = total;
    total += c;
  }
  store_status(st, (tile == 0 ? FLAG_INCL : FLAG_AGG) | epoch | total);
  local_base[tid] = block_exclusive_scan(total, warp_sums);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const uint32_t d = packed[j] >> 16;
    if (d < RADIX) {
      const uint32_t s = local_base[d] + wcnt[warp][d] + (packed[j] & 0xFFFFu);
      row_at[s] = (unsigned short)(warp * CHUNK + j * 32 + lane);
      digit_at[s] = (unsigned char)d;
    }
  }

  // 4. decoupled look-back (thread tid = digit): the count of this digit in
  // earlier tiles, from their aggregates back to the first inclusive
  // prefix; then this tile's inclusive prefix
  uint32_t prefix = 0;
  if (tile != 0) {
    const unsigned long long* q = st - RADIX;
    while (true) {
      const unsigned long long w = load_status(q);
      if ((w & ~(3ull << 62) & ~COUNT_BITS) != epoch || !(w >> 62))
        continue;  // not yet published in this pass
      prefix += (uint32_t)w;
      if ((w >> 62) == 2) break;
      q -= RADIX;
    }
    store_status(st, FLAG_INCL | epoch | (uint32_t)(prefix + total));
  }
  out_base[tid] = (long long)a.bases[p * RADIX + tid] + prefix - local_base[tid];
  cp_async_wait<0>();
  __syncthreads();

  // 5. write the tile in digit order: slot s goes to row out_base[digit] + s
  uint32_t* o = a.buf[pl.z];
  if (pl.w & DST_ROW_MAJOR) {
    for (int s = tid; s < count; s += THREADS) {
      uint32_t* dst = o + (out_base[digit_at[s]] + s) * NC;
      const int r = row_at[s];
#pragma unroll
      for (int c = 0; c < NC; ++c) dst[c] = stage[r * sr + c * sc];
    }
  } else {
    for (int s = tid; s < count; s += THREADS) {
      const long long g = out_base[digit_at[s]] + s;
      const int r = row_at[s];
#pragma unroll
      for (int c = 0; c < NC; ++c) o[c * a.stride + g] = stage[r * sr + c * sc];
    }
  }
}

constexpr int pass_smem(int nc) { return nc * TILE * 4 + TILE * 2 + TILE; }

template <int NC, bool INDEX>
void launch_pass(const PassArgs& a, long long n_tiles, int p, int col,
                 int shift, cudaStream_t st) {
  onesweep_pass<NC, INDEX><<<(unsigned)n_tiles, THREADS, pass_smem(NC), st>>>(
      a, p, col, shift);
}

template <int NC, bool INDEX>
cudaError_t allow_pass_smem() {
  return cudaFuncSetAttribute(onesweep_pass<NC, INDEX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              pass_smem(NC));
}

// Rows mode: with no live pass the input is already in order; copy it.
__global__ void finish_rows(PassArgs a) {
  if (a.plan[a.n_passes].x != 0) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int c = 0; c < a.n_cols; ++c) {
    const uint32_t* s = a.in.p[c];
    uint32_t* o = a.buf[1] + c * a.stride;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < a.n; i += stride)
      o[i] = s[i];
  }
}

// Index mode: every column gathered through the final row index, which the
// last live pass left in the output's column 1 (identity when no pass was
// live).  Each thread reads its index before it overwrites that column at
// the same row.
__global__ void finish_index(PassArgs a) {
  const bool any = a.plan[a.n_passes].x != 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint32_t* o = a.buf[1];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    const long long id = any ? (long long)o[a.stride + i] : i;
    for (int c = 0; c < a.n_cols; ++c) o[c * a.stride + i] = a.in.p[c][id];
  }
}

long long align256(long long b) { return (b + 255) & ~255ll; }

struct Work {
  unsigned long long* status;
  uint32_t* hist;
  uint32_t* counters;
  uint32_t* bases;
  int4* plan;
  long long zeroed_bytes;  // status, hist and counters: zeroed per sort
  long long bytes;
};

// Must agree with ops/sort_kernel.py::work_bytes.
Work layout(void* work, long long n, int n_keys, int n_passes) {
  Work w;
  const long long n_tiles = (n + TILE - 1) / TILE;
  char* b = (char*)work;
  long long off = 0;
  w.status = (unsigned long long*)(b + off);
  off += align256(n_tiles * RADIX * 8);
  w.hist = (uint32_t*)(b + off);
  off += align256((long long)n_keys * 4 * RADIX * 4);
  w.counters = (uint32_t*)(b + off);
  off += align256((long long)n_passes * 4);
  w.zeroed_bytes = off;
  w.bases = (uint32_t*)(b + off);
  off += align256((long long)n_passes * RADIX * 4);
  w.plan = (int4*)(b + off);
  off += align256((long long)(n_passes + 1) * 16);
  w.bytes = off;
  return w;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Checks the arguments and enqueues the sort; with `ev` non-null, records
// ev[0] first, ev[1] after the histogram and plan, ev[2 + p] after pass p
// and ev[n_passes + 2] after the finish.
int run_sort(int device, const void* const* cols, void* out, void* scratch,
             long long stride, int n_cols, int n_keys, long long n,
             const int* passes, int n_passes, int rows_mode, void* work,
             long long work_bytes, cudaStream_t st, cudaEvent_t* ev) {
  if (n_cols < 1 || n_cols > MAX_COLS || n_keys < 1 || n_keys > n_cols ||
      n < 0 || n > 0xFFFFFFFFLL || stride < n || stride % 4 ||
      n_passes < 1 || n_passes > 4 * n_keys ||
      (rows_mode ? n_cols > ROWS_MAX_COLS : n_cols < 2))
    return (int)cudaErrorInvalidValue;
  PlanArgs pa;
  for (int p = 0; p < n_passes; ++p) {
    const int c = passes[3 * p], sh = passes[3 * p + 1], wd = passes[3 * p + 2];
    if (c < 0 || c >= n_keys || sh < 0 || sh > 24 || sh % 8 || wd != 8)
      return (int)cudaErrorInvalidValue;
    pa.col[p] = (unsigned char)c;
    pa.hslot[p] = (unsigned char)(c * 4 + sh / 8);
  }
  const Work w = layout(work, n, n_keys, n_passes);
  if (work_bytes < w.bytes || !aligned16(work) || !aligned16(out) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  // shared memory above 48 KB is granted per kernel and per device
  if ((err = allow_pass_smem<1, false>()) != cudaSuccess ||
      (err = allow_pass_smem<2, false>()) != cudaSuccess ||
      (err = allow_pass_smem<3, false>()) != cudaSuccess ||
      (err = allow_pass_smem<2, true>()) != cudaSuccess)
    return (int)err;

  PassArgs a;
  bool in_vec = true;
  for (int c = 0; c < n_cols; ++c) {
    a.in.p[c] = (const uint32_t*)cols[c];
    in_vec = in_vec && aligned16(cols[c]);
  }
  a.buf[0] = nullptr;
  a.buf[1] = (uint32_t*)out;
  a.buf[2] = (uint32_t*)scratch;
  a.stride = stride;
  a.n_cols = n_cols;
  a.in_vec = in_vec;
  a.n = n;
  a.n_passes = n_passes;
  a.plan = w.plan;
  a.bases = w.bases;
  a.counters = w.counters;
  a.status = w.status;

  if (ev) cudaEventRecord(ev[0], st);
  err = cudaMemsetAsync(work, 0, w.zeroed_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + TILE - 1) / TILE;
  const unsigned hist_blocks =
      (unsigned)min((n + 4LL * THREADS * 8 - 1) / (4LL * THREADS * 8), 528LL);
  digit_histograms<<<dim3(hist_blocks, n_keys), THREADS, 0, st>>>(
      a.in, n, in_vec, w.hist);
  make_plan<<<1, THREADS, 0, st>>>(w.hist, pa, n_passes, n, !rows_mode,
                                   w.bases, w.plan);
  if (ev) cudaEventRecord(ev[1], st);
  for (int p = 0; p < n_passes; ++p) {
    const int col = passes[3 * p], shift = passes[3 * p + 1];
    if (!rows_mode)
      launch_pass<2, true>(a, n_tiles, p, col, shift, st);
    else if (n_cols == 1)
      launch_pass<1, false>(a, n_tiles, p, col, shift, st);
    else if (n_cols == 2)
      launch_pass<2, false>(a, n_tiles, p, col, shift, st);
    else
      launch_pass<3, false>(a, n_tiles, p, col, shift, st);
    if (ev) cudaEventRecord(ev[2 + p], st);
  }
  const unsigned fin_blocks = (unsigned)min((n + 255) / 256, 4096LL);
  if (rows_mode)
    finish_rows<<<fin_blocks, 256, 0, st>>>(a);
  else
    finish_index<<<fin_blocks, 256, 0, st>>>(a);
  if (ev) cudaEventRecord(ev[n_passes + 2], st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// device: the CUDA device of every pointer (set first: this library has its
// own runtime).  cols: host array of n_cols device pointers to u32[n]; the
// first n_keys columns are the keys.  out: the sorted columns, n_cols
// columns of `stride` words (stride >= n, a multiple of 4), also a
// ping-pong buffer.  scratch: the other, n_cols columns (rows_mode) or 2
// (index mode) of `stride` words.  passes: host int32 [n_passes][3]
// (column, shift, width) in LSD order.  rows_mode: carry whole rows
// (n_cols <= 3) or (key, row index).  work: device bytes laid out by
// `layout`, at least work_bytes long.  Launches on `stream`; returns
// cudaGetLastError().
int kmc_radix_sort_columns(int device, const void* const* cols, void* out,
                           void* scratch, long long stride, int n_cols,
                           int n_keys, long long n, const int* passes,
                           int n_passes, int rows_mode, void* work,
                           long long work_bytes, void* stream) {
  return run_sort(device, cols, out, scratch, stride, n_cols, n_keys, n,
                  passes, n_passes, rows_mode, work, work_bytes,
                  (cudaStream_t)stream, nullptr);
}

// The same sort with CUDA events between its stages; waits for it and
// writes n_passes + 2 times in ms to stage_ms: the memset, histogram and
// plan, each pass (a dead pass only launches and returns), the finish.
// For measurement only.
int kmc_radix_sort_stage_ms(int device, const void* const* cols, void* out,
                            void* scratch, long long stride, int n_cols,
                            int n_keys, long long n, const int* passes,
                            int n_passes, int rows_mode, void* work,
                            long long work_bytes, void* stream,
                            float* stage_ms) {
  if (n_passes < 1 || n_passes > MAX_PASSES) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaEvent_t ev[MAX_PASSES + 3];
  const int n_ev = n_passes + 3;
  for (int i = 0; i < n_ev; ++i) cudaEventCreate(&ev[i]);
  int rc = run_sort(device, cols, out, scratch, stride, n_cols, n_keys, n,
                    passes, n_passes, rows_mode, work, work_bytes,
                    (cudaStream_t)stream, ev);
  if (rc == 0) rc = (int)cudaEventSynchronize(ev[n_ev - 1]);
  for (int i = 0; rc == 0 && i + 1 < n_ev; ++i)
    rc = (int)cudaEventElapsedTime(&stage_ms[i], ev[i], ev[i + 1]);
  for (int i = 0; i < n_ev; ++i) cudaEventDestroy(ev[i]);
  return rc;
}

}  // extern "C"
