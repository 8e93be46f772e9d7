// K8 inner_join_planes: the unique-key inner broadcast hash join, and
// K9 probe_codes: the generic join probe (at the end of this file).
//
// K8:
// Replaces blaze_tpu/ops/joins/bhj.py:_inner_fast_kernel (with its probe,
// keymap.py:canon_word_traced and sorted_probe_traced): for one probe
// batch against a build side whose keys are unique (a dimension table),
//   w    = canonical int64 word of the probe key (integers widen with
//          their sign; floats fold -0.0 into +0.0 and every NaN into the
//          quiet NaN, then f64 is its int64 bits and f32 its int32 bits
//          sign-extended),
//   idx  = lower bound of w in the sorted unique build words uniq[0, nk),
//          compared as signed int64 (the order np.unique gave the build),
//   cidx = clip(idx, 0, max(nk - 1, 0)),
//   hit  = key valid & row < num_rows & idx < nk & uniq[cidx] == w;
// hit rows move to the front in probe order with every probe plane, each
// beside build row clip(cidx, 0, cap_b - 1) of every build plane (code c
// owns build row c: null-keyed build rows sort to the tail). Rows past
// the hit count are padding (data 0, validity False). The count is the
// caller's one sync per batch.
//
// Bound on the H100: bytes. Every output plane is written over the probe
// capacity (hit rows, then padding), the probe keys of the live rows are
// read, the other probe planes and the build rows only where a row hits.
// At q96's first probe (262,144 rows, 232,116 live, 4,851 hitting 1,800
// time_dim keys; 6 planes a side) that is ~16 MB, ~4.9 us at 3.35 TB/s;
// at its later probes the output's padding is most of it (98% of the
// batch).
//
// One launch a probe batch, no memset, no host table per call:
//   - blocks take tickets (an atomic counter, reset by the last ticket),
//     so a block only ever waits on blocks that started before it. The
//     first ntiles tickets are 1024-row tiles, two rows a thread in
//     512-thread blocks, both rows' loads issued before either is used
//     (with four rows a thread in 256-thread blocks the dependent loads
//     made the tile phase several times longer; 1,024-thread blocks
//     leave no room beside the tiles for the zeroing blocks, which then
//     run after them); a warp ballot and a one-warp scan of the 32 (row,
//     warp) counts rank the tile's hit rows in row order; the tile's output
//     offset comes from a decoupled look-back over the earlier tiles'
//     counts, block-wide (common.cuh blz_block_look_back: the tiles of a
//     batch run at once, so each round reads 512 earlier tiles' words at
//     a time), with the words tagged by the launch so the scratch is
//     never zeroed; then every plane's hit rows go to offset + rank,
//     probe planes from the row, build planes from its build row. The
//     last tile writes the count.
//   - the other tickets zero the padding, 2048 rows each, with 16-byte
//     stores: rows at or past num_rows at once, the rows below it once
//     the last tile's inclusive word gives the count (every tile has
//     started by then, and none waits on them). Hit rows sit below the
//     count, so nothing orders the two. Against the alternatives: a
//     memset of the outputs writes the hit rows twice and needs one
//     allocation for all planes; a grid barrier needs a cooperative,
//     co-resident grid.
//   - the search: when the build words are dense (nk == uniq[nk-1] -
//     uniq[0] + 1, decided once a build map on the host), the rank is
//     w - uniq[0] behind a range check, with no load. Otherwise each
//     block stages every step-th word (at most 4,096, 32 KB of dynamic
//     shared memory) and searches them there, finishing the lower bound
//     in the step words between two samples from L2; at most 4,096 words
//     the whole search is in shared memory.
// The planes go by value in the kernel's parameters (at most 128 planes,
// the 4 KB a launch passes); the wrapper packs the build planes, sizes
// and the search once a build map (core/kernels.py JoinPack) and writes
// only the probe's and the outputs' pointers a batch. A wider join is a
// launch for each 128 planes: each is a whole pass (probe, look-back, the
// scatter and padding of its own planes) under a tag of its own, and each
// writes the same count.
#include "common.cuh"

#define BLZ_J_THREADS 512
#define BLZ_J_WARPS (BLZ_J_THREADS / 32)
#define BLZ_J_ITEMS 2
#define BLZ_J_TILE (BLZ_J_THREADS * BLZ_J_ITEMS)  // 1024 rows a tile
#define BLZ_J_ZTILE 2048                           // padding rows a zeroing block
#define BLZ_J_TOP 4096                             // words of the staged search top
#define BLZ_J_MAX_PLANES 128

// key kinds (core/kernels.py _JOIN_KEY_*)
#define BLZ_JOIN_KEY_INT 0
#define BLZ_JOIN_KEY_FLOAT 1

__device__ __forceinline__ int64_t blz_canon_word(const void* key, int size,
                                                  int kind, int64_t i) {
  if (kind == BLZ_JOIN_KEY_FLOAT) {
    if (size == 4) {
      uint32_t b = ((const uint32_t*)key)[i];
      const uint32_t mag = b & 0x7fffffffu;
      if (mag == 0u) b = 0u;                        // -0.0 -> +0.0
      else if (mag > 0x7f800000u) b = 0x7fc00000u;  // any NaN -> quiet NaN
      return (int64_t)(int32_t)b;
    }
    unsigned long long b = ((const unsigned long long*)key)[i];
    const unsigned long long mag = b & 0x7fffffffffffffffull;
    if (mag == 0ull) b = 0ull;
    else if (mag > 0x7ff0000000000000ull) b = 0x7ff8000000000000ull;
    return (int64_t)b;
  }
  switch (size) {
    case 1: return (int64_t)((const int8_t*)key)[i];
    case 2: return (int64_t)((const int16_t*)key)[i];
    case 4: return (int64_t)((const int32_t*)key)[i];
    default: return ((const int64_t*)key)[i];
  }
}

// Lower bound of w in uniq[0, nk), signed order; nk when every word is
// smaller.
__device__ __forceinline__ int64_t blz_lower_bound(const int64_t* uniq,
                                                   int64_t nk, int64_t w) {
  int64_t lo = 0, hi = nk;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(&uniq[mid]) < w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct JoinArgs {
  const int64_t* uniq;     // max(nk, 1) sorted unique words
  int64_t nk, lo, hi;      // dense: the words are lo..hi
  int dense, top, step;    // search: top words, uniq[j * step] for j < top
  const void* key;
  int key_size, key_kind;
  const uint8_t* key_valid;
  int64_t num_rows, cap_p, cap_b, ntiles;
  unsigned int* ticket;            // the tickets' counter
  unsigned long long* status;      // ntiles look-back words
  unsigned long long tag;          // this launch's look-back tag
  int64_t* count;
  int n, nprobe;                   // planes; the first nprobe read probe row i
  const void* src[BLZ_J_MAX_PLANES];
  void* dst[BLZ_J_MAX_PLANES];
  unsigned char size[BLZ_J_MAX_PLANES];
};

// Lower bound of w in the sorted unique words, by the staged top: the
// first sample at or above w, then the words between it and the sample
// before it.
__device__ __forceinline__ int64_t blz_join_search(const JoinArgs& a, const int64_t* top,
                                                   int64_t w) {
  int lo = 0, hi = a.top;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (top[mid] < w) lo = mid + 1; else hi = mid;
  }
  if (a.step == 1 || lo == 0) return lo;
  const int64_t first = (int64_t)(lo - 1) * a.step + 1;
  const int64_t last = (int64_t)lo * a.step < a.nk ? (int64_t)lo * a.step : a.nk;
  return first + blz_lower_bound(a.uniq + first, last - first, w);
}

template <typename T>
__device__ __forceinline__ void blz_join_scatter(const T* src, T* dst, bool from_probe,
                                                 const bool* hit, const int64_t* row,
                                                 const int32_t* brow, const int64_t* pos) {
#pragma unroll
  for (int j = 0; j < BLZ_J_ITEMS; ++j)
    if (hit[j]) dst[pos[j]] = src[from_probe ? row[j] : (int64_t)brow[j]];
}

__device__ __forceinline__ void blz_join_zero_rows(const JoinArgs& a, int64_t from,
                                                   int64_t to) {
  if (from >= to) return;
  for (int p = 0; p < a.n; ++p)
    blz_zero_bytes((uint8_t*)a.dst[p], from * a.size[p], to * a.size[p]);
}

// __grid_constant__: the planes' table is indexed by a loop variable, read
// in place from the parameter space rather than copied to local memory
__global__ void __launch_bounds__(BLZ_J_THREADS)
    blz_inner_join_kernel(const __grid_constant__ JoinArgs a) {
  extern __shared__ int64_t s_top[];                 // the search top, a.top words
  __shared__ int s_cnt[BLZ_J_ITEMS * BLZ_J_WARPS];   // (row group, warp) counts, then offsets
  __shared__ int s_red[2 * BLZ_J_WARPS];
  __shared__ unsigned int s_ticket, s_total;
  __shared__ int64_t s_base;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const unsigned int t = atomicAdd(a.ticket, 1u);
    // every other block has its ticket by now: the counter starts the
    // next launch at 0
    if (t == gridDim.x - 1) atomicExch(a.ticket, 0u);
    s_ticket = t;
  }
  __syncthreads();
  const int64_t t = s_ticket;

  if (t >= a.ntiles) {  // a zeroing block: [count, cap) of its rows, every plane
    const int64_t z0 = (t - a.ntiles) * BLZ_J_ZTILE;
    const int64_t z1 = z0 + BLZ_J_ZTILE < a.cap_p ? z0 + BLZ_J_ZTILE : a.cap_p;
    // rows at or past num_rows are padding whatever the count
    blz_join_zero_rows(a, z0 > a.num_rows ? z0 : a.num_rows, z1);
    if (z0 >= a.num_rows) return;
    if (threadIdx.x == 0) {  // the count: the last tile's inclusive word
      const volatile unsigned long long* last = a.status + (a.ntiles - 1);
      unsigned long long v = *last;
      while ((v >> 34) != a.tag || ((v >> 32) & 3ull) != BLZ_LB_INCL) {
        __nanosleep(128);
        v = *last;
      }
      s_base = (int64_t)(v & 0xffffffffull);
    }
    __syncthreads();
    const int64_t to = z1 < a.num_rows ? z1 : a.num_rows;
    blz_join_zero_rows(a, z0 > s_base ? z0 : s_base, to);
    return;
  }

  // -- a tile: probe, rank, look back, scatter
  if (!a.dense) {
    for (int j = threadIdx.x; j < a.top; j += BLZ_J_THREADS)
      s_top[j] = __ldg(&a.uniq[(int64_t)j * a.step]);
    __syncthreads();
  }
  int64_t row[BLZ_J_ITEMS], pos[BLZ_J_ITEMS];
  int32_t brow[BLZ_J_ITEMS];
  bool hit[BLZ_J_ITEMS];
  const int64_t base = t * BLZ_J_TILE;
  // every load of the tile first, independent of each other, so they are
  // in flight together (rows past num_rows read nothing)
  bool valid[BLZ_J_ITEMS];
  int64_t word[BLZ_J_ITEMS];
#pragma unroll
  for (int j = 0; j < BLZ_J_ITEMS; ++j) {
    row[j] = base + j * BLZ_J_THREADS + threadIdx.x;
    valid[j] = row[j] < a.num_rows && a.key_valid[row[j]] != 0;  // num_rows <= cap_p
    word[j] = row[j] < a.num_rows ? blz_canon_word(a.key, a.key_size, a.key_kind, row[j]) : 0;
  }
#pragma unroll
  for (int j = 0; j < BLZ_J_ITEMS; ++j) {
    hit[j] = false;
    brow[j] = 0;
    if (valid[j]) {
      const int64_t w = word[j];
      int64_t idx;
      if (a.dense) {
        hit[j] = w >= a.lo && w <= a.hi;
        idx = hit[j] ? w - a.lo : 0;
      } else {
        idx = blz_join_search(a, s_top, w);
        const int64_t cidx = idx < a.nk - 1 ? idx : (a.nk > 0 ? a.nk - 1 : 0);
        hit[j] = idx < a.nk && (a.step == 1 ? s_top[cidx] : __ldg(&a.uniq[cidx])) == w;
        idx = cidx;
      }
      brow[j] = (int32_t)(idx < a.cap_b - 1 ? idx : a.cap_b - 1);
    }
  }
  // ranks in row order: row group j of warp w precedes group j of warp w + 1
  unsigned ballot[BLZ_J_ITEMS];
#pragma unroll
  for (int j = 0; j < BLZ_J_ITEMS; ++j) {
    ballot[j] = __ballot_sync(BLZ_FULL, hit[j]);
    if (lane == 0) s_cnt[j * BLZ_J_WARPS + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 32 counts, one a lane
    const int c = s_cnt[lane];
    int x = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(BLZ_FULL, x, off);
      if ((int)lane >= off) x += y;
    }
    s_cnt[lane] = x - c;
    if (lane == 31) s_total = (unsigned int)x;
  }
  __syncthreads();
  const unsigned int total = s_total;
  const unsigned int excl =
      blz_block_look_back<BLZ_J_THREADS>(a.status, t, a.tag, total, s_red);
  if (threadIdx.x == 0 && t == a.ntiles - 1) *a.count = (int64_t)excl + total;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < BLZ_J_ITEMS; ++j)
    pos[j] = (int64_t)excl + s_cnt[j * BLZ_J_WARPS + warp] + __popc(ballot[j] & below);
  if (total == 0) return;
  for (int p = 0; p < a.n; ++p) {
    const bool probe = p < a.nprobe;
    switch (a.size[p]) {
      case 1:
        blz_join_scatter((const uint8_t*)a.src[p], (uint8_t*)a.dst[p], probe, hit, row, brow,
                         pos);
        break;
      case 2:
        blz_join_scatter((const uint16_t*)a.src[p], (uint16_t*)a.dst[p], probe, hit, row,
                         brow, pos);
        break;
      case 4:
        blz_join_scatter((const uint32_t*)a.src[p], (uint32_t*)a.dst[p], probe, hit, row,
                         brow, pos);
        break;
      default:
        blz_join_scatter((const unsigned long long*)a.src[p], (unsigned long long*)a.dst[p],
                         probe, hit, row, brow, pos);
        break;
    }
  }
}

// The argument words (int64; core/kernels.py _JW_*):
//   [0] nk  [1] lo  [2] hi  [3] dense  [4] top  [5] step  [6] uniq
//   [7] key  [8] key size  [9] key kind  [10] key validity  [11] num_rows
//   [12] cap_p  [13] cap_b  [14] scratch (int64 words: the tickets'
//   counter, then one look-back word a tile)  [15] scratch tiles
//   [16] tag  [17] count (one int64)  [18] stream  [19] nprobe  [20] nplanes,
//   then per plane (src, dst, size) from [24].
BLZ_EXPORT int blz_inner_join(const long long* w) {
  JoinArgs a;
  a.nk = w[0];
  a.lo = w[1];
  a.hi = w[2];
  a.dense = (int)w[3];
  a.top = (int)w[4];
  a.step = (int)w[5];
  a.uniq = (const int64_t*)w[6];
  a.key = (const void*)w[7];
  a.key_size = (int)w[8];
  a.key_kind = (int)w[9];
  a.key_valid = (const uint8_t*)w[10];
  a.num_rows = w[11];
  a.cap_p = w[12];
  a.cap_b = w[13];
  a.ntiles = (a.cap_p + BLZ_J_TILE - 1) / BLZ_J_TILE;
  a.ticket = (unsigned int*)w[14];
  a.status = (unsigned long long*)w[14] + 1;
  a.tag = (unsigned long long)w[16];
  a.count = (int64_t*)w[17];
  cudaStream_t stream = (cudaStream_t)w[18];
  a.nprobe = (int)w[19];
  a.n = (int)w[20];
  if (a.cap_p <= 0 || a.cap_b <= 0 || a.cap_b > 0x7fffffffLL || a.cap_p > 0x7fffffffLL ||
      a.nk < 0 || a.num_rows < 0 || a.num_rows > a.cap_p || a.nprobe < 0 ||
      a.nprobe > a.n || a.n > BLZ_J_MAX_PLANES || a.ntiles > w[15] || a.tag == 0 ||
      a.tag >= (1ull << 30) || (!a.dense && (a.top < 1 || a.top > BLZ_J_TOP || a.step < 1)))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < a.n; ++p) {
    a.src[p] = (const void*)w[24 + 3 * p];
    a.dst[p] = (void*)w[25 + 3 * p];
    a.size[p] = (unsigned char)w[26 + 3 * p];
  }
  const int64_t nzero = (a.cap_p + BLZ_J_ZTILE - 1) / BLZ_J_ZTILE;
  const size_t smem = a.dense ? 0 : (size_t)a.top * sizeof(int64_t);
  blz_inner_join_kernel<<<(unsigned int)(a.ntiles + nzero), BLZ_J_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// K9 probe_codes: the generic join probe.
//
// Replaces blaze_tpu/ops/joins/keymap.py:_probe_fn (with
// sorted_probe_traced and canon_word_traced): for each of the cap rows of
// a probe key plane,
//   code = idx  if the key is valid and idx < nk and uniq[idx] == w,
//          -1   otherwise,
// with w the canonical word and idx its lower bound in the sorted unique
// build words uniq[0, nk), as K8's probe computes them. The reference
// writes clip(idx, 0, nk - 1) on a hit, which is idx itself. Rows past
// the batch's live rows are padding (validity False) and give -1. The
// codes go to the host, where the CSR pair expansion of the build map
// (ops/joins/keymap.py JoinHashMap.probe) and the outer, semi, anti and
// existence emission run, as in the reference.
//
// Bound on the H100: bytes. Each row reads its key (up to 8 bytes) and
// validity byte and writes an 8-byte code; the sorted keys are read once
// (q69's store window: ~470,000 words, 3.8 MB, L2-resident). At a
// 262,144-row batch that is ~8.3 MB, ~2.5 us at 3.35 TB/s. One thread
// per row runs a plain binary search (~19 dependent L2 loads at 470,000
// keys), which is what bounds it in practice; a shared-memory top of the
// tree is later work, as for K8.
__global__ void blz_probe_codes_kernel(const int64_t* uniq, int64_t nk,
                                       const void* key, int key_size,
                                       int key_kind, const uint8_t* key_valid,
                                       int64_t cap, int64_t* codes) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  int64_t code = -1;
  if (key_valid[i] != 0) {
    const int64_t w = blz_canon_word(key, key_size, key_kind, i);
    const int64_t idx = blz_lower_bound(uniq, nk, w);
    if (idx < nk && __ldg(&uniq[idx]) == w) code = idx;
  }
  codes[i] = code;
}

// uniq: max(nk, 1) sorted int64 words; key/key_valid: the probe key's
// data (key_size bytes, key_kind) and validity planes, cap rows; codes:
// cap int64 outputs.
BLZ_EXPORT int blz_probe_codes(const int64_t* uniq, int64_t nk,
                               const void* key, int key_size, int key_kind,
                               const uint8_t* key_valid, int64_t cap,
                               int64_t* codes, cudaStream_t stream) {
  if (cap <= 0 || nk < 0) return (int)cudaErrorInvalidValue;
  blz_probe_codes_kernel<<<blz_blocks(cap), BLZ_THREADS, 0, stream>>>(
      uniq, nk, key, key_size, key_kind, key_valid, cap, codes);
  return (int)cudaGetLastError();
}
