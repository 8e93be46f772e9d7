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
//   blz_segment_reduce: one thread per segment folds its rows in sorted
//     order through the ops (ADD / COUNT / MIN / MAX over int64 or
//     float64 sources, each gated by up to three validity planes) and
//     writes the emits (RAW, NONZERO, WHERE) and the segment's first row;
//     zeros past the count. A float ADD is a left fold from +0.0 in
//     sorted (= stable input) order, bit for bit the reference's
//     scatter-add on the CPU; a float MIN/MAX orders -0.0 below 0.0 and
//     gives NaN when a NaN takes part, as XLA's scatter min/max propagate
//     NaN. A float result that is NaN is the quiet NaN 0x7FF8..., so the
//     card and the host agree to the bit. Integer ops wrap as int64.
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
// once through the permutation and writes each output once. One thread
// per segment is the simple design: it keeps the float fold sequential
// without a segmented scan, and costs parallelism only where few segments
// hold many rows (a segmented warp scan is the next step there).
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

__device__ __forceinline__ long long blz_seg_order_word(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

__global__ void blz_seg_reduce_kernel(const int64_t* starts,
                                      const int64_t* order,
                                      const int64_t* count_ptr, int64_t cap,
                                      SegOpSet ops, SegEmitSet es,
                                      int64_t* first) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  if (s >= *count_ptr) {
    for (int c = 0; c < es.n; ++c) {
      if (es.col[c].kind == BLZ_EMIT_NONZERO)
        ((uint8_t*)es.col[c].out)[s] = 0;
      else
        ((long long*)es.col[c].out)[s] = 0;
    }
    first[s] = 0;
    return;
  }
  const int64_t lo = starts[s];
  const int64_t hi = starts[s + 1];
  long long acc[BLZ_MAX_SEG_OPS];
  for (int o = 0; o < ops.n; ++o) acc[o] = ops.op[o].init;
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t r = order[p];
    for (int o = 0; o < ops.n; ++o) {
      const SegOp& op = ops.op[o];
      bool ok = true;
      for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][r] != 0;
      if (op.kind == BLZ_SEG_COUNT) {
        acc[o] += ok ? 1 : 0;
      } else if (op.kind == BLZ_SEG_LEXMIN || op.kind == BLZ_SEG_LEXMAX) {
        // the pair (acc[o], acc[o + 1]) holds the extreme; LEXLO is op o + 1
        if (ok) {
          const SegOp& lo = ops.op[o + 1];
          const long long x2 = ((const long long*)op.src)[r];
          const unsigned long long xw =
              ((unsigned long long)((const long long*)lo.src)[r] << 32) |
              (unsigned long long)lo.src0[r];
          const unsigned long long aw = (unsigned long long)acc[o + 1];
          const bool better = op.kind == BLZ_SEG_LEXMAX
                                  ? (x2 > acc[o] || (x2 == acc[o] && xw > aw))
                                  : (x2 < acc[o] || (x2 == acc[o] && xw < aw));
          if (better) {
            acc[o] = x2;
            acc[o + 1] = (long long)xw;
          }
        }
      } else if (op.kind == BLZ_SEG_LEXLO) {
        // folded with the op before it
      } else if (op.is_float) {
        const double x = ((const double*)op.src)[r];
        double a = __longlong_as_double(acc[o]);
        if (op.kind == BLZ_SEG_ADD) {
          a = __dadd_rn(a, ok ? x : 0.0);
        } else if (ok && !isnan(a)) {
          if (isnan(x))
            a = __longlong_as_double(BLZ_QNAN_BITS);
          else if (op.kind == BLZ_SEG_MIN ? blz_seg_order_word(x) < blz_seg_order_word(a)
                                          : blz_seg_order_word(x) > blz_seg_order_word(a))
            a = x;
        }
        acc[o] = __double_as_longlong(a);
      } else {
        const long long x = ((const long long*)op.src)[r];
        if (op.kind == BLZ_SEG_ADD) {
          if (ok)
            acc[o] = (long long)((unsigned long long)acc[o] +
                                 (unsigned long long)x * (unsigned long long)op.mult);
        } else if (op.kind == BLZ_SEG_ADD_LO32 || op.kind == BLZ_SEG_ADD_HI32) {
          if (ok)
            acc[o] = (long long)((unsigned long long)acc[o] +
                                 (unsigned long long)(op.kind == BLZ_SEG_ADD_LO32
                                                          ? (x & 0xFFFFFFFFLL)
                                                          : (x >> 32)));
        } else if (ok) {
          acc[o] = op.kind == BLZ_SEG_MIN ? (x < acc[o] ? x : acc[o])
                                          : (x > acc[o] ? x : acc[o]);
        }
      }
    }
  }
  for (int o = 0; o < ops.n; ++o)  // one NaN on every device
    if (ops.op[o].is_float && isnan(__longlong_as_double(acc[o]))) acc[o] = BLZ_QNAN_BITS;
  for (int c = 0; c < es.n; ++c) {
    const SegEmit& e = es.col[c];
    const long long v = blz_emit_value(
        e.kind, [&](int w) { return acc[w == 0 ? e.table : w == 1 ? e.aux : e.aux2]; });
    if (e.kind == BLZ_EMIT_NONZERO)
      ((uint8_t*)e.out)[s] = (uint8_t)v;
    else
      ((long long*)e.out)[s] = v;
  }
  first[s] = order[lo];
}

// starts: cap + 1 int64 (blz_segment_starts); order: cap int64; count: the
// device segment count. Per op o: kind, is_float, source (int64 or float64
// rows; null for COUNT), op_nvalid[o] bool planes at op_valid[3*o + q],
// mult (integer ADD), init (the table's first value as 64 bits). Per emit
// c: kind, table, aux (WHERE, CARRY, MID, TOP, WORD_*), aux2 (TOP), out
// (cap 64-bit words, or cap bytes for NONZERO). first: cap int64, each
// segment's first row. A LEXMIN/LEXMAX op must be followed by its LEXLO op
// (src l1, src0 l0).
BLZ_EXPORT int blz_segment_reduce(
    const int64_t* starts, const int64_t* order, const int64_t* count,
    int64_t cap, int nops, const int* op_kind, const int* op_float,
    const void* const* op_src, const void* const* op_src0, const int* op_nvalid,
    const uint8_t* const* op_valid, const long long* op_mult,
    const long long* op_init, int nemit, const int* emit_kind,
    const int* emit_table, const int* emit_aux, const int* emit_aux2,
    void* const* emit_out, int64_t* first, cudaStream_t stream) {
  if (nops > BLZ_MAX_SEG_OPS || nemit > BLZ_MAX_SEG_EMITS || cap <= 0)
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
  blz_seg_reduce_kernel<<<blz_blocks(cap), BLZ_THREADS, 0, stream>>>(
      starts, order, count, cap, ops, es, first);
  return (int)cudaGetLastError();
}
