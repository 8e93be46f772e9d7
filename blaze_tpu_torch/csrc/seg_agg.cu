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
//   blz_segment_starts: (1) one thread per sorted position flags a new
//     segment where any key's validity differs from the previous row's,
//     or both are valid and the values differ (IEEE compare: -0.0 equals
//     0.0, a NaN equals nothing -- the reference compares its canonical
//     keys the same way, so every NaN row is a segment of its own);
//     (2) block counts and one-block scan of the flags (compact.cu);
//     (3) a stable scatter of each flagged position to its rank (warp
//     ballot + shared scan, no atomics): starts[s] is where segment s
//     begins, num_rows past the count. Segment ids are dense by
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
// served by L2 at a 262,144-row batch) and writes a flag byte and a start
// per segment; the reduction reads each state source and validity plane
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

struct SegKeys {
  int k;
  const void* data[BLZ_MAX_SEG_KEYS];
  const uint8_t* valid[BLZ_MAX_SEG_KEYS];
  int size[BLZ_MAX_SEG_KEYS];
  int is_float[BLZ_MAX_SEG_KEYS];
};

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

__device__ __forceinline__ long long blz_seg_load_int(const void* p, int size,
                                                      int64_t i) {
  switch (size) {
    case 1: return ((const int8_t*)p)[i];
    case 2: return ((const int16_t*)p)[i];
    case 4: return ((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ bool blz_seg_key_differs(const SegKeys& ks, int j,
                                                    int64_t a, int64_t b) {
  const bool va = ks.valid[j][a] != 0;
  const bool vb = ks.valid[j][b] != 0;
  if (va != vb) return true;
  if (!va) return false;
  if (ks.is_float[j]) {
    const double x = ks.size[j] == 4 ? (double)((const float*)ks.data[j])[a]
                                     : ((const double*)ks.data[j])[a];
    const double y = ks.size[j] == 4 ? (double)((const float*)ks.data[j])[b]
                                     : ((const double*)ks.data[j])[b];
    return x != y;
  }
  return blz_seg_load_int(ks.data[j], ks.size[j], a) !=
         blz_seg_load_int(ks.data[j], ks.size[j], b);
}

__global__ void blz_seg_flags_kernel(SegKeys ks, const int64_t* order,
                                     int64_t n, uint8_t* flags) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  bool fresh = p == 0;
  if (!fresh) {
    const int64_t a = order[p];
    const int64_t b = order[p - 1];
    for (int j = 0; j < ks.k && !fresh; ++j) fresh = blz_seg_key_differs(ks, j, a, b);
  }
  flags[p] = fresh;
}

__global__ void blz_seg_starts_kernel(const uint8_t* flags, int64_t n,
                                      const int64_t* offs, unsigned int nb_n,
                                      int64_t cap, int64_t* starts) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool f = p < n && flags[p] != 0;
  const int r = blz_block_rank(f, warp_sums);
  const int64_t total = offs[nb_n];
  if (f) starts[offs[blockIdx.x] + r] = p;
  if (p >= total && p <= cap) starts[p] = n;
}

// k key planes of cap rows (element sizes 1/2/4/8; is_float for f32/f64)
// with bool validity; order: cap int64, the sorted permutation whose first
// n positions are the existing rows; flags: n bytes; offs: blz_blocks(n)
// + 1 int64, offs[blz_blocks(n)] receives the segment count; starts: cap
// + 1 int64.
BLZ_EXPORT int blz_segment_starts(int k, const void* const* datas,
                                  const uint8_t* const* valids,
                                  const int* sizes, const int* is_float,
                                  const int64_t* order, int64_t n, int64_t cap,
                                  uint8_t* flags, int64_t* offs,
                                  int64_t* starts, cudaStream_t stream) {
  if (k <= 0 || k > BLZ_MAX_SEG_KEYS || n <= 0 || n > cap)
    return (int)cudaErrorInvalidValue;
  SegKeys ks;
  ks.k = k;
  for (int j = 0; j < k; ++j) {
    ks.data[j] = datas[j];
    ks.valid[j] = valids[j];
    ks.size[j] = sizes[j];
    ks.is_float[j] = is_float[j];
  }
  blz_seg_flags_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(ks, order, n,
                                                                  flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = blz_flag_offsets(flags, n, offs, stream);
  if (err != cudaSuccess) return (int)err;
  blz_seg_starts_kernel<<<blz_blocks(cap + 1), BLZ_THREADS, 0, stream>>>(
      flags, n, offs, blz_blocks(n), cap, starts);
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

// starts: cap + 1 int64 (blz_segment_starts); order: cap int64; count: the
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
