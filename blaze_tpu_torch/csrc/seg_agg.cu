// K10 seg_agg: the sort route of the grouped aggregation -- segments of
// sorted rows, then the slot program's ops over each segment.
//
// Replaces blaze_tpu/ops/agg_device.py:_partial_kernel (raw rows ->
// partial states) and :_merge_kernel (partial states -> merged states),
// which the reference runs for every aggregation on a TPU: _segmentation
// sorts the rows so that equal keys are adjacent and cuts them where a key
// changes, _reduce_aggs / _merge_reduce reduce each segment, and the
// segments are compacted. Here K5 (sort.cu) does the sort; this file does
// the rest in two exported calls:
//   blz_segment_keys: one launch over the sorted positions: a segment
//     starts where any key's validity differs from the previous row's,
//     or both are valid and the values differ (IEEE compare: -0.0 equals
//     0.0, a NaN equals nothing -- the reference compares its canonical
//     keys the same way, so every NaN row is a segment of its own); each
//     start goes to its rank (starts[s] is where segment s begins,
//     num_rows past the count), and the segment's keys from its first row
//     order[starts[s]] go to row s of the key outputs (the take
//     _partial_kernel makes with first_idx). Segment ids are dense by
//     construction, so the reference's cumsum-and-scatter compaction is
//     the identity here.
//   blz_segment_reduce: the ops (ADD / COUNT / MIN / MAX over int64 or
//     float64 sources, each gated by up to three validity planes) over
//     each segment's rows in sorted order, then the emits (RAW, NONZERO,
//     WHERE) and the segment's first row; zeros past the count. A float
//     ADD is a left fold from +0.0 in sorted (= stable input) order, bit
//     for bit the reference's scatter-add on the CPU; a float MIN/MAX
//     orders -0.0 below 0.0 and gives NaN when a NaN takes part, as XLA's
//     scatter min/max propagate NaN. A float result that is NaN is the
//     quiet NaN 0x7FF8..., so the card and the host agree to the bit.
//     Integer ops wrap as int64.
//
// The wide-decimal (limb) kinds of _reduce_aggs (:1173-1219) and
// _merge_reduce (:1339-1381), with _segment_lex3 (:1136):
//   ADD_LO32 / ADD_HI32 add the low 32 bits / the arithmetic >> 32 of an
//     int64 source (sum2/avg2's split); a three-limb sum (sum3/avg3) adds
//     its limbs with ADD. The emits renormalise the carries at the end
//     (LO32, CARRY, MID, TOP: _limb_renorm and _limb3_renorm). A segment's
//     l0/l1 sums stay below 2^55 even at q67_sort's ~6.2M state rows a
//     reducer (each addend < 2^32), so no carry is lost before the emit;
//     l2 wraps mod 2^64 as in the reference, which is exact for totals
//     within decimal(38).
//   LEXMIN / LEXMAX with the LEXLO op after it: the segment's extreme
//     (l2, l1, l0) as one tuple comparison a row: l2 signed, then the low
//     word (l1 << 32) | l0 unsigned (l1 and l0 are non-negative 32-bit
//     chunks, so this orders as the reference's cascade does); WORD_HI and
//     WORD_LO emit the word's chunks, 0 where the segment's count is 0.
//
// Bound on the H100: bytes. The segmentation reads each key plane and the
// permutation once (the key loads are gathers through the permutation,
// served by L2 at a 262,144-row batch) and writes the starts and the key
// outputs over the capacity; the reduction reads each state source and validity plane
// once through the permutation and writes each output once. The gathers
// fetch a 32-byte sector for each 8-byte value where the rows of a segment
// lie apart (a merge of millions of rows), so there the sectors bound it.
//
// The reduction's design fills the card whatever the segments' lengths:
//   - pass 1, one thread a segment (blocks of 256): a segment of at most
//     64 rows is folded by its thread alone, in order; a longer one is
//     listed for pass 2 (warp-aggregated appends), as one item when it
//     holds at most 256 rows, else as one item a piece of 256 rows (more
//     past 256 pieces, so that one warp merges at most 256);
//   - pass 2, persistent warps over the list (a grid sized to the card):
//     a warp folds an item with its lanes striding the rows, so the
//     permutation loads coalesce. Every op but the float ADD is order-free
//     and exact: integer sums wrap, MIN/MAX and the LEX pair are extremes,
//     and a float MIN/MAX folds its order words, a NaN as the word that
//     wins. So the lanes' accumulators merge by a shuffle butterfly, and a
//     piece's accumulators go to scratch; the warp that folds a segment's
//     last piece (an atomic count a segment) merges its pieces'
//     accumulators. A float ADD is then folded over the whole segment by
//     one warp: 32 rows loaded at once, added one by one in sorted order,
//     every lane holding the same left fold (__dadd_rn, bit-equal to pass
//     1's);
//   - a thread folds four rows at a time op by op, every load of an op
//     (validity planes and sources of the four rows) issued before the
//     first is used: the gathers overlap, one load latency an op.
#include "common.cuh"

#define BLZ_MAX_SEG_KEYS 16
#define BLZ_MAX_SEG_OPS 24
#define BLZ_MAX_SEG_EMITS 24

enum { BLZ_SEG_ADD = 0, BLZ_SEG_COUNT = 1, BLZ_SEG_MIN = 2, BLZ_SEG_MAX = 3,
       BLZ_SEG_ADD_LO32 = 4, BLZ_SEG_ADD_HI32 = 5, BLZ_SEG_LEXMIN = 6, BLZ_SEG_LEXMAX = 7,
       BLZ_SEG_LEXLO = 8 };

#define BLZ_QNAN_BITS 0x7FF8000000000000LL

struct SegOp {
  int kind;
  int is_float;
  int nvalid;
  const void* src;  // int64 or float64 rows; unused by COUNT
  const long long* src0;  // LEXLO: l0 (src is l1)
  const uint8_t* valid[3];
  long long mult;
  long long init;  // the table's first value (a float's bits)
};

struct SegOpSet {
  int n;
  SegOp op[BLZ_MAX_SEG_OPS];
};

struct SegEmit {
  int kind;
  int table;
  int aux;
  int aux2;
  void* out;  // 64-bit words, bool bytes for NONZERO
};

struct SegEmitSet {
  int n;
  SegEmit col[BLZ_MAX_SEG_EMITS];
};

// -- the segmentation (blz_segment_keys) ------------------------------------------
//
// One launch, no memset, no host table a call:
//   - blocks take tickets (an atomic counter, reset by the last ticket), so
//     a block only waits on blocks that started before it. The first
//     ntiles tickets are tiles of sorted positions, ITEMS consecutive
//     positions a thread in 512-thread blocks: the thread loads their
//     order entries (16-byte vectors where ITEMS is even), then gathers
//     each key's rows for all of them, BLZ_SK_CHUNK keys at a time with
//     every load of the chunk issued before the first compare, and
//     compares each position with the one before it in registers: the
//     previous thread's last row comes by a shuffle, and only a warp's
//     first lane loads the row before its positions itself. So each key
//     row is gathered once, where a thread a position reading order[p] and
//     order[p - 1] gathers it twice.
//   - the tile ranks its starts (a shuffle scan of the threads' counts and
//     a one-warp scan of the warps'), takes its offset from the
//     block-wide decoupled look-back (common.cuh blz_block_look_back, its
//     words tagged by the launch so the scratch is never zeroed), writes
//     each start's position to starts[rank] and the emitted key planes'
//     rows order[p] to row rank: where those planes are the compared ones
//     (up to BLZ_SK_CHUNK keys, not the direct mode's plane) from the rows
//     the compare loaded, else gathered again (every load of a chunk of
//     planes before its stores). The last tile writes the count.
//   - the other tickets fill the tail, BLZ_SK_ZTILE rows each: starts[r] =
//     num_rows and the key outputs' rows zeroed (data 0, validity False)
//     for r at or past num_rows at once, and for r at or past the count
//     once the last tile's inclusive word gives it (every tile has its
//     ticket by then, and none waits on these blocks).
#define BLZ_SK_THREADS 512
#define BLZ_SK_WARPS (BLZ_SK_THREADS / 32)
#define BLZ_SK_ZTILE 4096                            // tail rows a filling block
// From BLZ_SK_BIG positions on a thread takes four consecutive positions
// (2,048-position tiles, 110 registers); below, one (512-position tiles,
// 54 registers, so two blocks an SM). Measured on an H100 (700 W), device
// time a call on the main path's inputs (one against four): q89's
// partial batches (about 800 live rows in 262,144: the tail's fill is
// the work) 0.011 against 0.014; q17_sort's and cust_spend_noskip's
// batches (262,144 rows) 0.020 and 0.019 against 0.017; a q67_sort batch
// 0.021 against 0.022; a q67_sort reducer's merge (6.2M positions) 0.41
// against 0.29.
#define BLZ_SK_BIG (1 << 17)
#define BLZ_SK_CHUNK 4                               // keys (planes) loaded together

struct SegKeyArgs {
  int k;  // compared planes
  const void* data[BLZ_MAX_SEG_KEYS];
  const uint8_t* valid[BLZ_MAX_SEG_KEYS];
  unsigned char size[BLZ_MAX_SEG_KEYS];
  unsigned char is_float[BLZ_MAX_SEG_KEYS];
  int m;  // emitted key planes: (data, validity) read at the segment's first row
  int reuse;  // they are the compared planes, m == k <= BLZ_SK_CHUNK
  const void* src[BLZ_MAX_SEG_KEYS];
  const uint8_t* src_valid[BLZ_MAX_SEG_KEYS];
  void* dst[BLZ_MAX_SEG_KEYS];
  uint8_t* dst_valid[BLZ_MAX_SEG_KEYS];
  unsigned char out_size[BLZ_MAX_SEG_KEYS];
  const int64_t* order;
  int64_t n, cap, ntiles;
  int64_t* starts;  // cap + 1
  int64_t* count;   // one int64
  unsigned int* ticket;
  unsigned long long* status;  // ntiles look-back words
  unsigned long long tag;
};

// A plane's row as its raw bits, zero-extended.
__device__ __forceinline__ unsigned long long blz_sk_raw(const void* p, int size, int64_t i) {
  switch (size) {
    case 1: return __ldg((const unsigned char*)p + i);
    case 2: return __ldg((const unsigned short*)p + i);
    case 4: return __ldg((const unsigned int*)p + i);
    default: return __ldg((const unsigned long long*)p + i);
  }
}

__device__ __forceinline__ void blz_sk_store(void* p, int size, int64_t i,
                                             unsigned long long x) {
  switch (size) {
    case 1: ((unsigned char*)p)[i] = (unsigned char)x; break;
    case 2: ((unsigned short*)p)[i] = (unsigned short)x; break;
    case 4: ((unsigned int*)p)[i] = (unsigned int)x; break;
    default: ((unsigned long long*)p)[i] = x; break;
  }
}

// A key row's compare state: 0 null, 1 a value (``word``: the raw bits,
// a float's -0.0 folded into +0.0), 2 a NaN (it differs from every row).
__device__ __forceinline__ int blz_sk_state(unsigned long long& word, int size, int is_float,
                                            bool valid) {
  if (!valid) return 0;
  if (is_float) {
    const unsigned long long mag =
        size == 4 ? (word & 0x7fffffffull) : (word & 0x7fffffffffffffffull);
    const unsigned long long inf = size == 4 ? 0x7f800000ull : 0x7ff0000000000000ull;
    if (mag > inf) return 2;
    if (mag == 0ull) word = 0ull;
  }
  return 1;
}

__device__ __forceinline__ bool blz_sk_differs(int sa, unsigned long long wa, int sb,
                                               unsigned long long wb) {
  return sa != sb || sa == 2 || (sa == 1 && wa != wb);
}

// The tail from row ``from`` up to this block's end: starts = num_rows,
// key outputs zero.
__device__ __forceinline__ void blz_sk_fill(const SegKeyArgs& a, int64_t z0, int64_t z1,
                                            int64_t from) {
  const int64_t lo = from > z0 ? from : z0;
  for (int64_t r = lo + threadIdx.x; r < z1; r += BLZ_SK_THREADS) a.starts[r] = a.n;
  const int64_t hi = z1 < a.cap ? z1 : a.cap;  // the key outputs hold cap rows
  if (lo >= hi) return;
  for (int o = 0; o < a.m; ++o) {
    blz_zero_bytes((uint8_t*)a.dst[o], lo * a.out_size[o], hi * a.out_size[o]);
    blz_zero_bytes(a.dst_valid[o], lo, hi);
  }
}

// __grid_constant__: the planes' tables are indexed by loop variables,
// read in place from the parameter space
template <int ITEMS>
__global__ void __launch_bounds__(BLZ_SK_THREADS)
    blz_segment_keys_kernel(const __grid_constant__ SegKeyArgs a) {
  __shared__ int s_warp[BLZ_SK_WARPS];
  __shared__ int s_red[2 * BLZ_SK_WARPS];
  __shared__ unsigned int s_ticket;
  __shared__ int64_t s_count;
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

  if (t >= a.ntiles) {  // a filling block: rows [z0, z1) of the cap + 1 starts
    const int64_t z0 = (t - a.ntiles) * BLZ_SK_ZTILE;
    int64_t z1 = z0 + BLZ_SK_ZTILE;
    z1 = z1 < a.cap + 1 ? z1 : a.cap + 1;
    if (a.ntiles == 0 && z0 == 0 && threadIdx.x == 0) *a.count = 0;
    blz_sk_fill(a, z0, z1, a.n);  // rows at or past num_rows whatever the count
    if (z0 >= a.n) return;
    if (threadIdx.x == 0) {  // the count: the last tile's inclusive word
      const volatile unsigned long long* last = a.status + (a.ntiles - 1);
      unsigned long long v = *last;
      while ((v >> 34) != a.tag || ((v >> 32) & 3ull) != BLZ_LB_INCL) {
        __nanosleep(128);
        v = *last;
      }
      s_count = (int64_t)(v & 0xffffffffull);
    }
    __syncthreads();
    blz_sk_fill(a, z0, z1 < a.n ? z1 : a.n, s_count);
    return;
  }

  // -- a tile: the order entries of its positions
  const int64_t p0 = t * (BLZ_SK_THREADS * ITEMS) + (int64_t)threadIdx.x * ITEMS;
  int64_t row[ITEMS];
  if (ITEMS % 2 == 0 && p0 + ITEMS <= a.n && (((uintptr_t)(a.order + p0)) & 15u) == 0u) {
#pragma unroll
    for (int i = 0; i + 1 < ITEMS; i += 2) {
      const longlong2 x = __ldg((const longlong2*)(a.order + p0 + i));
      row[i] = x.x;
      row[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) row[i] = p0 + i < a.n ? __ldg(a.order + p0 + i) : 0;
  }
  // the row before this thread's first position, for a warp's first lane
  // (the other lanes take it from the lane before them)
  const bool own_prev = lane == 0 && p0 > 0 && p0 < a.n;
  const int64_t prev_row = own_prev ? __ldg(a.order + p0 - 1) : 0;
  bool fresh[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) fresh[i] = p0 + i == 0;
  // the last chunk's key rows as loaded (every key's when a.k <= CHUNK)
  unsigned long long raw[BLZ_SK_CHUNK][ITEMS];
  bool rv[BLZ_SK_CHUNK][ITEMS];
  for (int c0 = 0; c0 < a.k; c0 += BLZ_SK_CHUNK) {
    unsigned long long wp[BLZ_SK_CHUNK];
    bool vp[BLZ_SK_CHUNK];
    // every load of the chunk first, independent of each other
#pragma unroll
    for (int q = 0; q < BLZ_SK_CHUNK; ++q) {
      const int j = c0 + q < a.k ? c0 + q : a.k - 1;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const bool in = c0 + q < a.k && p0 + i < a.n;
        rv[q][i] = in && __ldg(a.valid[j] + row[i]) != 0;
        raw[q][i] = in ? blz_sk_raw(a.data[j], a.size[j], row[i]) : 0ull;
      }
      const bool in = c0 + q < a.k && own_prev;
      vp[q] = in && __ldg(a.valid[j] + prev_row) != 0;
      wp[q] = in ? blz_sk_raw(a.data[j], a.size[j], prev_row) : 0ull;
    }
#pragma unroll
    for (int q = 0; q < BLZ_SK_CHUNK; ++q) {
      const int j = c0 + q < a.k ? c0 + q : a.k - 1;
      const int size = a.size[j], is_float = a.is_float[j];
      int st[ITEMS];
      unsigned long long w[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        w[i] = raw[q][i];
        st[i] = blz_sk_state(w[i], size, is_float, rv[q][i]);
      }
      int sp = blz_sk_state(wp[q], size, is_float, vp[q]);
      // the previous thread's last row
      const int up_s = __shfl_up_sync(BLZ_FULL, st[ITEMS - 1], 1);
      const unsigned long long up_w = __shfl_up_sync(BLZ_FULL, w[ITEMS - 1], 1);
      unsigned long long pw = wp[q];
      if (lane > 0) {
        sp = up_s;
        pw = up_w;
      }
      if (c0 + q >= a.k) continue;
      fresh[0] |= p0 < a.n && blz_sk_differs(st[0], w[0], sp, pw);
#pragma unroll
      for (int i = 1; i < ITEMS; ++i)
        fresh[i] |= p0 + i < a.n && blz_sk_differs(st[i], w[i], st[i - 1], w[i - 1]);
    }
  }
  // ranks in position order: a shuffle scan of the threads' counts, a
  // one-warp scan of the warps'
  int mine = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) mine += fresh[i];
  int incl = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(BLZ_FULL, incl, off);
    if ((int)lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < BLZ_SK_WARPS ? s_warp[lane] : 0;
    int x = c;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(BLZ_FULL, x, off);
      if ((int)lane >= off) x += y;
    }
    if (lane < BLZ_SK_WARPS) s_warp[lane] = x - c;
    if (lane == BLZ_SK_WARPS - 1) s_red[0] = x;  // the tile's total
  }
  __syncthreads();
  const unsigned int total = (unsigned int)s_red[0];
  const int below = s_warp[warp] + incl - mine;
  __syncthreads();  // s_red is the look-back's scratch from here
  const unsigned int excl =
      blz_block_look_back<BLZ_SK_THREADS>(a.status, t, a.tag, total, s_red);
  if (threadIdx.x == 0 && t == a.ntiles - 1) *a.count = (int64_t)excl + total;
  if (mine == 0) return;
  int64_t pos[ITEMS];
  int r = (int)excl + below;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    pos[i] = r;
    r += fresh[i];
    if (fresh[i]) a.starts[pos[i]] = p0 + i;
  }
  if (a.reuse) {  // the emitted planes are the compared ones, all loaded above
#pragma unroll
    for (int q = 0; q < BLZ_SK_CHUNK; ++q) {
      if (q >= a.m) continue;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (!fresh[i]) continue;
        blz_sk_store(a.dst[q], a.out_size[q], pos[i], raw[q][i]);
        a.dst_valid[q][pos[i]] = rv[q][i];
      }
    }
    return;
  }
  // the segments' keys from their first rows, a chunk of planes' loads
  // before its stores
  for (int o0 = 0; o0 < a.m; o0 += BLZ_SK_CHUNK) {
    unsigned long long w[BLZ_SK_CHUNK][ITEMS];
    unsigned char v[BLZ_SK_CHUNK][ITEMS];
#pragma unroll
    for (int q = 0; q < BLZ_SK_CHUNK; ++q) {
      const int o = o0 + q < a.m ? o0 + q : a.m - 1;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const bool on = o0 + q < a.m && fresh[i];
        w[q][i] = on ? blz_sk_raw(a.src[o], a.out_size[o], row[i]) : 0ull;
        v[q][i] = on ? __ldg(a.src_valid[o] + row[i]) : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < BLZ_SK_CHUNK; ++q) {
      if (o0 + q >= a.m) continue;
      const int o = o0 + q;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (!fresh[i]) continue;
        blz_sk_store(a.dst[o], a.out_size[o], pos[i], w[q][i]);
        a.dst_valid[o][pos[i]] = v[q][i];
      }
    }
  }
}

// The argument words (int64; core/kernels.py _SW_*):
//   [0] k  [1] m  [2] order  [3] num_rows  [4] cap  [5] starts (cap + 1)
//   [6] count (one int64)  [7] scratch (int64 words: the tickets' counter,
//   then one look-back word a tile)  [8] scratch tiles  [9] tag
//   [10] stream  [11] reuse (the emitted planes are the compared ones, at
//   most BLZ_SK_CHUNK), then from [12] per compared plane (data,
//   validity, size, is_float), then per emitted plane (src, src validity,
//   dst, dst validity, size).
BLZ_EXPORT int blz_segment_keys(const long long* w) {
  SegKeyArgs a;
  a.k = (int)w[0];
  a.m = (int)w[1];
  a.order = (const int64_t*)w[2];
  a.n = w[3];
  a.cap = w[4];
  a.starts = (int64_t*)w[5];
  a.count = (int64_t*)w[6];
  a.ticket = (unsigned int*)w[7];
  a.status = (unsigned long long*)w[7] + 1;
  const bool big = a.n >= BLZ_SK_BIG;
  const int64_t tile = BLZ_SK_THREADS * (big ? 4 : 1);
  a.ntiles = (a.n + tile - 1) / tile;
  a.tag = (unsigned long long)w[9];
  cudaStream_t stream = (cudaStream_t)w[10];
  a.reuse = (int)w[11];
  if (a.reuse && (a.m != a.k || a.k > BLZ_SK_CHUNK)) return (int)cudaErrorInvalidValue;
  if (a.k <= 0 || a.k > BLZ_MAX_SEG_KEYS || a.m < 0 || a.m > BLZ_MAX_SEG_KEYS ||
      a.cap <= 0 || a.cap >= 0x7fffffffLL || a.n < 0 || a.n > a.cap || a.ntiles > w[8] ||
      a.tag == 0 || a.tag >= (1ull << 30))
    return (int)cudaErrorInvalidValue;
  const long long* kw = w + 12;
  for (int j = 0; j < a.k; ++j, kw += 4) {
    a.data[j] = (const void*)kw[0];
    a.valid[j] = (const uint8_t*)kw[1];
    a.size[j] = (unsigned char)kw[2];
    a.is_float[j] = (unsigned char)kw[3];
    if (kw[2] != 1 && kw[2] != 2 && kw[2] != 4 && kw[2] != 8) return (int)cudaErrorInvalidValue;
  }
  for (int o = 0; o < a.m; ++o, kw += 5) {
    a.src[o] = (const void*)kw[0];
    a.src_valid[o] = (const uint8_t*)kw[1];
    a.dst[o] = (void*)kw[2];
    a.dst_valid[o] = (uint8_t*)kw[3];
    a.out_size[o] = (unsigned char)kw[4];
    if (kw[4] != 1 && kw[4] != 2 && kw[4] != 4 && kw[4] != 8) return (int)cudaErrorInvalidValue;
  }
  const unsigned int grid = (unsigned int)(a.ntiles + (a.cap + BLZ_SK_ZTILE) / BLZ_SK_ZTILE);
  if (big)
    blz_segment_keys_kernel<4><<<grid, BLZ_SK_THREADS, 0, stream>>>(a);
  else
    blz_segment_keys_kernel<1><<<grid, BLZ_SK_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

#define BLZ_SEG_THREADS 256
#define BLZ_SEG_SHORT 64      // a segment of at most this many rows: one thread
#define BLZ_SEG_PIECE 256     // rows a warp folds of a longer segment, at least
#define BLZ_SEG_MAX_PIECES 256  // pieces of a segment, at most (longer pieces past it)
#define BLZ_SEG_ROWS 4        // rows a lane of a warp has in flight
#define BLZ_SEG_LANE_ROWS 4   // rows a thread folding a segment alone has in flight
#define BLZ_SEG_LANE_BLOCKS 4  // pass 1's blocks an SM at least (launch bounds)

__device__ __forceinline__ long long blz_seg_order_word(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

// How an op folds: a wrapping integer sum, an extreme (integers by value,
// floats by order word), the float left fold, the LEX pair (folded at its
// LEXMIN/LEXMAX op), or nothing (the LEXLO op).
enum { BLZ_FOLD_SUM, BLZ_FOLD_MIN, BLZ_FOLD_MAX, BLZ_FOLD_FADD, BLZ_FOLD_LEX, BLZ_FOLD_NONE };

__device__ __forceinline__ int blz_seg_fold(const SegOp& op) {
  switch (op.kind) {
    case BLZ_SEG_COUNT:
    case BLZ_SEG_ADD_LO32:
    case BLZ_SEG_ADD_HI32: return BLZ_FOLD_SUM;
    case BLZ_SEG_ADD: return op.is_float ? BLZ_FOLD_FADD : BLZ_FOLD_SUM;
    case BLZ_SEG_MIN: return BLZ_FOLD_MIN;
    case BLZ_SEG_MAX: return BLZ_FOLD_MAX;
    case BLZ_SEG_LEXMIN:
    case BLZ_SEG_LEXMAX: return BLZ_FOLD_LEX;
    default: return BLZ_FOLD_NONE;
  }
}

// A float MIN/MAX folds the order words of its rows, a NaN as the word
// that wins every comparison (both such words encode NaNs), so the fold is
// an integer extreme: exact, order-free, NaN wherever a NaN took part.
__device__ __forceinline__ long long blz_seg_fword(double x, int fold) {
  if (isnan(x)) return fold == BLZ_FOLD_MIN ? (long long)0x8000000000000000ULL
                                            : 0x7FFFFFFFFFFFFFFFLL;
  return blz_seg_order_word(x);
}

// Every op's identity: 0 for a sum (its init is added at the end), the
// init for an extreme (as an order word for a float), the init's bits for
// a float ADD (the left fold starts there).
__device__ __forceinline__ void blz_seg_init(const SegOpSet& ops, long long* acc) {
  for (int o = 0; o < ops.n; ++o) {
    const SegOp& op = ops.op[o];
    const int f = blz_seg_fold(op);
    acc[o] = f == BLZ_FOLD_SUM ? 0
             : (op.is_float && (f == BLZ_FOLD_MIN || f == BLZ_FOLD_MAX))
                 ? blz_seg_fword(__longlong_as_double(op.init), f)
                 : op.init;
  }
}

// The sorted rows r[0..U) (those with bit u of ``in``) into the
// accumulators, op by op: every load of an op (its validity planes and
// sources, for all the rows) is issued before the first is used, so a
// thread waits one load latency an op, not two a row and op. The float
// ADD ops only where ``fadd`` (a thread folding a segment alone, in order).
template <int U>
__device__ __forceinline__ void blz_seg_fold_rows(const SegOpSet& ops, long long* acc,
                                                  const int64_t* r, unsigned in, bool fadd) {
  for (int o = 0; o < ops.n; ++o) {
    const SegOp& op = ops.op[o];
    const int f = blz_seg_fold(op);
    if (f == BLZ_FOLD_NONE || (f == BLZ_FOLD_FADD && !fadd)) continue;
    const bool lex = f == BLZ_FOLD_LEX;
    const long long* y = lex ? (const long long*)ops.op[o + 1].src : nullptr;
    const long long* z = lex ? ops.op[o + 1].src0 : nullptr;
    long long xv[U], yv[U], zv[U];
    uint8_t g0[U], g1[U], g2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ru = r[u];
      const bool use = (in >> u) & 1u;
      g0[u] = use && op.nvalid > 0 ? op.valid[0][ru] : 1;
      g1[u] = use && op.nvalid > 1 ? op.valid[1][ru] : 1;
      g2[u] = use && op.nvalid > 2 ? op.valid[2][ru] : 1;
      xv[u] = use && op.src != nullptr ? ((const long long*)op.src)[ru] : 0;
      yv[u] = use && lex ? y[ru] : 0;
      zv[u] = use && lex ? z[ru] : 0;
    }
    long long a = acc[o];
    long long b = lex ? acc[o + 1] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!((in >> u) & 1u)) continue;
      const bool ok = g0[u] != 0 && g1[u] != 0 && g2[u] != 0;
      const long long x = xv[u];
      if (f == BLZ_FOLD_FADD) {
        a = __double_as_longlong(
            __dadd_rn(__longlong_as_double(a), ok ? __longlong_as_double(x) : 0.0));
      } else if (!ok) {
      } else if (op.kind == BLZ_SEG_COUNT) {
        a = (long long)((unsigned long long)a + 1ull);
      } else if (lex) {
        const unsigned long long w = ((unsigned long long)yv[u] << 32) | (unsigned long long)zv[u];
        const bool better = op.kind == BLZ_SEG_LEXMAX
                                ? (x > a || (x == a && w > (unsigned long long)b))
                                : (x < a || (x == a && w < (unsigned long long)b));
        if (better) {
          a = x;
          b = (long long)w;
        }
      } else if (op.is_float) {
        const long long w = blz_seg_fword(__longlong_as_double(x), f);
        a = f == BLZ_FOLD_MIN ? (w < a ? w : a) : (w > a ? w : a);
      } else if (f == BLZ_FOLD_SUM) {
        const unsigned long long add =
            op.kind == BLZ_SEG_ADD ? (unsigned long long)x * (unsigned long long)op.mult
            : op.kind == BLZ_SEG_ADD_LO32 ? (unsigned long long)(x & 0xFFFFFFFFLL)
                                          : (unsigned long long)(x >> 32);
        a = (long long)((unsigned long long)a + add);
      } else {
        a = f == BLZ_FOLD_MIN ? (x < a ? x : a) : (x > a ? x : a);
      }
    }
    acc[o] = a;
    if (lex) acc[o + 1] = b;
  }
}

// Op o's accumulator (and for the LEX pair the low word after it) merged
// with b's: sums add, extremes compare (the float ADD left alone).
__device__ __forceinline__ void blz_seg_merge(const SegOp& op, long long* a, long long* a1,
                                              long long b, long long b1) {
  const int f = blz_seg_fold(op);
  if (f == BLZ_FOLD_SUM) {
    *a = (long long)((unsigned long long)*a + (unsigned long long)b);
  } else if (f == BLZ_FOLD_MIN) {
    *a = b < *a ? b : *a;
  } else if (f == BLZ_FOLD_MAX) {
    *a = b > *a ? b : *a;
  } else if (f == BLZ_FOLD_LEX) {
    const bool better =
        op.kind == BLZ_SEG_LEXMAX
            ? (b > *a || (b == *a && (unsigned long long)b1 > (unsigned long long)*a1))
            : (b < *a || (b == *a && (unsigned long long)b1 < (unsigned long long)*a1));
    if (better) {
      *a = b;
      *a1 = b1;
    }
  }
}

// Every lane of the warp ends with the merge of all 32 lanes' accumulators.
__device__ __forceinline__ void blz_seg_warp_combine(const SegOpSet& ops, long long* acc) {
  for (int o = 0; o < ops.n; ++o) {
    const SegOp& op = ops.op[o];
    const int f = blz_seg_fold(op);
    if (f == BLZ_FOLD_NONE || f == BLZ_FOLD_FADD) continue;
    const bool lex = f == BLZ_FOLD_LEX;
    long long a = acc[o];
    long long a1 = lex ? acc[o + 1] : 0;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const long long b = __shfl_xor_sync(BLZ_FULL, a, m);
      const long long b1 = __shfl_xor_sync(BLZ_FULL, a1, m);
      blz_seg_merge(op, &a, &a1, b, b1);
    }
    acc[o] = a;
    if (lex) acc[o + 1] = a1;
  }
}

// The warp's lanes fold the sorted rows [lo, hi), lane l taking l, l + 32,
// ..., BLZ_SEG_ROWS rows in flight (float ADD ops left out).
__device__ __forceinline__ void blz_seg_warp_fold(const SegOpSet& ops, const int64_t* order,
                                                  int64_t lo, int64_t hi, long long* acc) {
  const int lane = threadIdx.x & 31;
  for (int64_t base = lo; base < hi; base += 32 * BLZ_SEG_ROWS) {
    int64_t r[BLZ_SEG_ROWS];
    unsigned in = 0;
#pragma unroll
    for (int u = 0; u < BLZ_SEG_ROWS; ++u) {
      const int64_t p = base + u * 32 + lane;
      r[u] = p < hi ? order[p] : 0;
      in |= (unsigned)(p < hi) << u;
    }
    blz_seg_fold_rows<BLZ_SEG_ROWS>(ops, acc, r, in, false);
  }
}

// One float ADD op's left fold over the sorted rows [lo, hi) by the whole
// warp: 32 rows loaded at once, then added one by one in order; every lane
// computes the same sum.
__device__ __noinline__ long long blz_seg_warp_fadd(const SegOp op, const int64_t* order,
                                                    int64_t lo, int64_t hi) {
  const int lane = threadIdx.x & 31;
  double a = __longlong_as_double(op.init);
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t p = base + lane;
    const int64_t r = order[p < hi ? p : lo];
    bool ok = true;
    for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][r] != 0;
    const double v = ok ? ((const double*)op.src)[r] : 0.0;
    const int m = hi - base < 32 ? (int)(hi - base) : 32;
    for (int j = 0; j < m; ++j) a = __dadd_rn(a, __shfl_sync(BLZ_FULL, v, j));
  }
  return __double_as_longlong(a);
}

// A sum gets its init; a float extreme's order word becomes its value (the
// map is its own inverse; the NaN word the quiet NaN); every float result
// that is NaN becomes the quiet NaN, one NaN on every device.
__device__ __forceinline__ void blz_seg_finish(const SegOpSet& ops, long long* acc) {
  for (int o = 0; o < ops.n; ++o) {
    const SegOp& op = ops.op[o];
    const int f = blz_seg_fold(op);
    if (f == BLZ_FOLD_SUM) {
      acc[o] = (long long)((unsigned long long)acc[o] + (unsigned long long)op.init);
    } else if (op.is_float && (f == BLZ_FOLD_MIN || f == BLZ_FOLD_MAX)) {
      const long long w = acc[o];
      acc[o] = w == blz_seg_fword(__longlong_as_double(BLZ_QNAN_BITS), f)
                   ? BLZ_QNAN_BITS
                   : blz_seg_order_word(__longlong_as_double(w));
    }
    if (op.is_float && isnan(__longlong_as_double(acc[o]))) acc[o] = BLZ_QNAN_BITS;
  }
}

__device__ __forceinline__ void blz_seg_write(const SegEmitSet& es, const long long* acc,
                                              int64_t s) {
  for (int c = 0; c < es.n; ++c) {
    const SegEmit& e = es.col[c];
    const long long v = blz_emit_value(
        e.kind, [&](int w) { return acc[w == 0 ? e.table : w == 1 ? e.aux : e.aux2]; });
    if (e.kind == BLZ_EMIT_NONZERO)
      ((uint8_t*)e.out)[s] = (uint8_t)v;
    else
      ((long long*)e.out)[s] = v;
  }
}

// The rows of each piece of a segment of len rows: BLZ_SEG_PIECE, or more
// (a multiple of a warp's 32 * BLZ_SEG_ROWS) where that would make more
// than BLZ_SEG_MAX_PIECES pieces, whose accumulators one warp merges.
__device__ __forceinline__ int64_t blz_seg_piece_rows(int64_t len) {
  const int64_t step = 32 * BLZ_SEG_ROWS;
  const int64_t rows = (len + BLZ_SEG_MAX_PIECES - 1) / BLZ_SEG_MAX_PIECES;
  const int64_t even = (rows + step - 1) / step * step;
  return even > BLZ_SEG_PIECE ? even : BLZ_SEG_PIECE;
}

__device__ __forceinline__ int64_t blz_seg_pieces(int64_t len) {
  const int64_t rows = blz_seg_piece_rows(len);
  return (len + rows - 1) / rows;
}

// Pass 2's work list (scratch; see blz_segment_reduce_scratch).
struct SegWork {
  unsigned long long* counts;  // [0] segments listed whole, [1] pieces listed
  int64_t* list;               // segments of SHORT + 1 .. BLZ_SEG_PIECE rows
  int64_t* piece_seg;          // a piece's segment
  int64_t* piece_base;         // the index of its segment's first piece
  unsigned long long* done;    // at a segment's first piece: its pieces folded
  long long* partial;          // a piece's accumulators, nops words each
  int nops;
};

// Pass 1: thread s takes segment s.
__global__ void __launch_bounds__(BLZ_SEG_THREADS, BLZ_SEG_LANE_BLOCKS) blz_seg_reduce_lane_kernel(
    const int64_t* starts, const int64_t* order, const int64_t* count_ptr, int64_t cap,
    SegOpSet ops, SegEmitSet es, int64_t* first, SegWork w) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t count = *count_ptr;
  const unsigned lane = threadIdx.x & 31u;
  bool whole = false, pieces = false;
  int64_t len = 0;
  if (s < cap && s >= count) {
    for (int c = 0; c < es.n; ++c) {
      if (es.col[c].kind == BLZ_EMIT_NONZERO)
        ((uint8_t*)es.col[c].out)[s] = 0;
      else
        ((long long*)es.col[c].out)[s] = 0;
    }
    first[s] = 0;
  } else if (s < cap) {
    const int64_t lo = starts[s];
    const int64_t hi = starts[s + 1];
    len = hi - lo;
    if (len <= BLZ_SEG_SHORT) {
      long long acc[BLZ_MAX_SEG_OPS];
      blz_seg_init(ops, acc);
      for (int64_t base = lo; base < hi; base += BLZ_SEG_LANE_ROWS) {
        int64_t r[BLZ_SEG_LANE_ROWS];
        unsigned in = 0;
#pragma unroll
        for (int u = 0; u < BLZ_SEG_LANE_ROWS; ++u) {
          r[u] = base + u < hi ? order[base + u] : 0;
          in |= (unsigned)(base + u < hi) << u;
        }
        blz_seg_fold_rows<BLZ_SEG_LANE_ROWS>(ops, acc, r, in, true);
      }
      blz_seg_finish(ops, acc);
      blz_seg_write(es, acc, s);
      first[s] = order[lo];
    } else {
      whole = len <= BLZ_SEG_PIECE;
      pieces = !whole;
    }
  }
  // the longer segments onto pass 2's list: one atomic a warp for each kind
  const unsigned below = (1u << lane) - 1u;
  const unsigned wb = __ballot_sync(BLZ_FULL, whole);
  if (wb) {
    const int leader = __ffs(wb) - 1;
    unsigned long long base = 0;
    if ((int)lane == leader) base = atomicAdd(&w.counts[0], (unsigned long long)__popc(wb));
    base = __shfl_sync(BLZ_FULL, base, leader);
    if (whole) w.list[base + __popc(wb & below)] = s;
  }
  if (__ballot_sync(BLZ_FULL, pieces)) {
    const long long np = pieces ? blz_seg_pieces(len) : 0;
    long long incl = np;
    for (int off = 1; off < 32; off <<= 1) {
      const long long t = __shfl_up_sync(BLZ_FULL, incl, off);
      if ((int)lane >= off) incl += t;
    }
    unsigned long long base = 0;
    if (lane == 31) base = atomicAdd(&w.counts[1], (unsigned long long)incl);
    base = __shfl_sync(BLZ_FULL, base, 31);
    if (pieces) {
      const long long b = (long long)base + incl - np;
      for (long long k = 0; k < np; ++k) {
        w.piece_seg[b + k] = s;
        w.piece_base[b + k] = b;
      }
      w.done[b] = 0;
    }
  }
}

// Pass 2: each warp takes list items j, j + warps, ...: first the whole
// segments, then the pieces.
__global__ void __launch_bounds__(BLZ_SEG_THREADS) blz_seg_reduce_warp_kernel(
    const int64_t* starts, const int64_t* order, SegOpSet ops, SegEmitSet es,
    int64_t* first, SegWork w) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long n1 = (long long)w.counts[0];
  const long long n2 = (long long)w.counts[1];
  for (long long j = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; j < n1 + n2;
       j += warps) {
    long long acc[BLZ_MAX_SEG_OPS];
    blz_seg_init(ops, acc);
    int64_t s, lo, hi;
    if (j < n1) {
      s = w.list[j];
      lo = starts[s];
      hi = starts[s + 1];
      blz_seg_warp_fold(ops, order, lo, hi, acc);
      blz_seg_warp_combine(ops, acc);
    } else {
      const long long q = j - n1;
      s = w.piece_seg[q];
      const long long b = w.piece_base[q];
      lo = starts[s];
      hi = starts[s + 1];
      const long long np = blz_seg_pieces(hi - lo);
      const int64_t step = blz_seg_piece_rows(hi - lo);
      const int64_t plo = lo + (q - b) * step;
      const int64_t phi = hi - plo < step ? hi : plo + step;
      blz_seg_warp_fold(ops, order, plo, phi, acc);
      blz_seg_warp_combine(ops, acc);
      int last = 0;
      if (lane == 0) {
        for (int o = 0; o < ops.n; ++o) w.partial[q * w.nops + o] = acc[o];
        __threadfence();
        last = atomicAdd(&w.done[b], 1ull) == (unsigned long long)(np - 1);
      }
      if (!__shfl_sync(BLZ_FULL, last, 0)) continue;
      // the segment's last piece: merge every piece's accumulators
      __threadfence();
      blz_seg_init(ops, acc);
      for (long long p = lane; p < np; p += 32) {
        const long long* part = w.partial + (b + p) * w.nops;
        for (int o = 0; o < ops.n; ++o)
          blz_seg_merge(ops.op[o], &acc[o], &acc[o + 1 < ops.n ? o + 1 : o], __ldcg(part + o),
                        __ldcg(part + (o + 1 < ops.n ? o + 1 : o)));
      }
      blz_seg_warp_combine(ops, acc);
    }
    for (int o = 0; o < ops.n; ++o)
      if (blz_seg_fold(ops.op[o]) == BLZ_FOLD_FADD)
        acc[o] = blz_seg_warp_fadd(ops.op[o], order, lo, hi);
    blz_seg_finish(ops, acc);
    if (lane == 0) {
      blz_seg_write(es, acc, s);
      first[s] = order[lo];
    }
  }
}

static inline int64_t blz_seg_list_cap(int64_t cap) { return cap / (BLZ_SEG_SHORT + 1) + 1; }

// a segment past BLZ_SEG_PIECE rows has at most 2 * rows / BLZ_SEG_PIECE pieces
// (each but its last holds BLZ_SEG_PIECE rows or more)
static inline int64_t blz_seg_piece_cap(int64_t cap) { return 2 * (cap / BLZ_SEG_PIECE) + 2; }

// The int64 words of scratch blz_segment_reduce takes for cap rows and
// nops ops.
BLZ_EXPORT int64_t blz_segment_reduce_scratch(int64_t cap, int nops) {
  return 2 + blz_seg_list_cap(cap) + blz_seg_piece_cap(cap) * (3 + (nops > 0 ? nops : 1));
}

static int blz_seg_warp_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, blz_seg_reduce_warp_kernel,
                                                  BLZ_SEG_THREADS, 0);
    blocks = (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  }
  return blocks;
}

// starts: cap + 1 int64 (blz_segment_keys); order: cap int64; count: the
// device segment count. Per op o: kind, is_float, source (int64 or float64
// rows; null for COUNT), op_nvalid[o] bool planes at op_valid[3*o + q],
// mult (integer ADD), init (the table's first value as 64 bits). Per emit
// c: kind, table, aux (WHERE, CARRY, MID, TOP, WORD_*), aux2 (TOP), out
// (cap 64-bit words, or cap bytes for NONZERO). first: cap int64, each
// segment's first row. A LEXMIN/LEXMAX op must be followed by its LEXLO op
// (src l1, src0 l0). scratch: blz_segment_reduce_scratch(cap, nops) int64.
BLZ_EXPORT int blz_segment_reduce(
    const int64_t* starts, const int64_t* order, const int64_t* count,
    int64_t cap, int nops, const int* op_kind, const int* op_float,
    const void* const* op_src, const void* const* op_src0, const int* op_nvalid,
    const uint8_t* const* op_valid, const long long* op_mult,
    const long long* op_init, int nemit, const int* emit_kind,
    const int* emit_table, const int* emit_aux, const int* emit_aux2,
    void* const* emit_out, int64_t* first, int64_t* scratch, int64_t scratch_words,
    cudaStream_t stream) {
  if (nops > BLZ_MAX_SEG_OPS || nemit > BLZ_MAX_SEG_EMITS || cap <= 0 || scratch == nullptr ||
      scratch_words < blz_segment_reduce_scratch(cap, nops))
    return (int)cudaErrorInvalidValue;
  SegOpSet ops;
  ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    ops.op[o].kind = op_kind[o];
    ops.op[o].is_float = op_float[o];
    ops.op[o].nvalid = op_nvalid[o];
    ops.op[o].src = op_src[o];
    ops.op[o].src0 = (const long long*)op_src0[o];
    for (int q = 0; q < 3; ++q) ops.op[o].valid[q] = op_valid[3 * o + q];
    ops.op[o].mult = op_mult[o];
    ops.op[o].init = op_init[o];
  }
  // a LEXMIN/LEXMAX op reads the op after it (core/kernels.py
  // check_limb_program holds the pairing); here only that its planes exist
  for (int o = 0; o < nops; ++o)
    if ((op_kind[o] == BLZ_SEG_LEXMIN || op_kind[o] == BLZ_SEG_LEXMAX) &&
        (o + 1 >= nops || op_src[o + 1] == nullptr || op_src0[o + 1] == nullptr))
      return (int)cudaErrorInvalidValue;
  SegEmitSet es;
  es.n = nemit;
  for (int c = 0; c < nemit; ++c) {
    const int k = emit_kind[c];
    const bool uses_aux = k == BLZ_EMIT_WHERE || k >= BLZ_EMIT_CARRY;
    if (emit_table[c] < 0 || emit_table[c] >= nops ||
        (uses_aux && (emit_aux[c] < 0 || emit_aux[c] >= nops)) ||
        (k == BLZ_EMIT_TOP && (emit_aux2[c] < 0 || emit_aux2[c] >= nops)))
      return (int)cudaErrorInvalidValue;
    es.col[c].kind = k;
    es.col[c].table = emit_table[c];
    es.col[c].aux = emit_aux[c];
    es.col[c].aux2 = emit_aux2[c];
    es.col[c].out = emit_out[c];
  }
  const int64_t lcap = blz_seg_list_cap(cap);
  const int64_t pcap = blz_seg_piece_cap(cap);
  SegWork w;
  w.counts = (unsigned long long*)scratch;
  w.list = scratch + 2;
  w.piece_seg = w.list + lcap;
  w.piece_base = w.piece_seg + pcap;
  w.done = (unsigned long long*)(w.piece_base + pcap);
  w.partial = (long long*)(w.piece_base + 2 * pcap);
  w.nops = nops > 0 ? nops : 1;
  // no segment of a batch of at most BLZ_SEG_SHORT rows reaches pass 2
  const bool pass2 = cap > BLZ_SEG_SHORT;
  cudaError_t err;
  if (pass2) {
    err = cudaMemsetAsync(w.counts, 0, 2 * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
  }
  blz_seg_reduce_lane_kernel<<<(unsigned)((cap + BLZ_SEG_THREADS - 1) / BLZ_SEG_THREADS),
                               BLZ_SEG_THREADS, 0, stream>>>(starts, order, count, cap, ops,
                                                             es, first, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || !pass2) return (int)err;
  const int64_t most = (lcap + pcap + BLZ_SEG_THREADS / 32 - 1) / (BLZ_SEG_THREADS / 32);
  const int grid = blz_seg_warp_grid();
  blz_seg_reduce_warp_kernel<<<(unsigned)(most < grid ? most : grid), BLZ_SEG_THREADS, 0,
                               stream>>>(starts, order, ops, es, first, w);
  return (int)cudaGetLastError();
}
