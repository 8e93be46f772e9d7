// K19 passthrough_states: the partial states of a skipped partial
// aggregate, every existing row its own group.
//
// Replaces blaze_tpu/ops/agg_device.py:1710 _passthrough_kernel (driven by
// DevicePartialAgger.passthrough, :933): ``_reduce_aggs`` (:1165) with
// seg = where(exists, iota, capacity), so each aggregate's state is built
// from its row alone. It runs the program of K3 and K10 (core/kernels.py
// AggOp / AggEmit, as ops/agg_device.py ``_partial_program`` spells the
// aggregates with them): per op the table value a one-row segment ends
// with, the op's identity (``init``) where the row does not exist or its
// gate fails, then the emits over those values (common.cuh
// blz_emit_value, the limb emits included):
//   ADD        init + src * mult (int64, wrapping: a decimal rescale); a
//              float ADD is init (+0.0) + x, so -0.0 sums to +0.0 and a
//              null row to +0.0, as a scatter-add onto zeros does;
//   ADD_LO32 / ADD_HI32  init + (src & 0xFFFFFFFF) / (src >> 32);
//   COUNT      init + 1 where the gate holds;
//   MIN / MAX / LEXMIN / LEXMAX  the row's value, else init; LEXLO the
//              low word (l1 << 32) | l0, else init;
// a float value that is NaN becomes the quiet NaN 0x7FF8... (K10's rule).
// Each emit is written in its column's own type: bool bytes for NONZERO,
// 1/2/4/8-byte integers, float64 bits, or float32 narrowed from the
// float64 value (NaN as 0x7FC00000). Keys are copied in their own width,
// 0 where null; their validity and the row mask are the caller's planes,
// returned as they are (the key validity masked with the row mask, so a
// row past num_rows has key 0).
//
// No atomics, no slot table, no compaction and no group-count sync (the
// group count is the batch's row count). The launch follows the rows:
// its first blocks give a thread a row below num_rows; the blocks after
// them write the padding rows' constants (each emit's value from the ops'
// inits, key 0), 16 rows a thread. A thread's first two keys load before
// its emits' planes, so it waits on device memory once; an emit computes
// the (up to three) op values it reads from their planes, so no table of
// op values lives in local memory. (Two or four rows a thread, in one
// access of up to 16 bytes a plane where aligned, measured no faster on
// the H100.) Bound on the H100: bytes; each key, source and validity
// plane is read once and each output written once (cust_spend's batch: a
// 4-byte key, an int64 argument, ~35 bytes a row).
//
// Arguments come as one int64 word array (core/kernels.py PassthroughPack
// keeps it between a task's batches and writes only the planes'
// pointers): a header (BLZ_PASS_W_*), BLZ_PASS_KEY_WORDS words a key
// slot, BLZ_PASS_OP_WORDS an op slot, BLZ_PASS_EMIT_WORDS an emit slot.
#include "common.cuh"

#define BLZ_MAX_PASS_KEYS 16
#define BLZ_MAX_PASS_OPS 24
#define BLZ_MAX_PASS_EMITS 24
#define BLZ_PASS_THREADS 512
#define BLZ_PASS_FILL 16     // rows a thread of the padding blocks writes

// core/kernels.py OP_*, the same numbers as slot_agg.cu's and seg_agg.cu's
enum { BLZ_PASS_ADD = 0, BLZ_PASS_COUNT = 1, BLZ_PASS_MIN = 2, BLZ_PASS_MAX = 3,
       BLZ_PASS_ADD_LO32 = 4, BLZ_PASS_ADD_HI32 = 5, BLZ_PASS_LEXMIN = 6,
       BLZ_PASS_LEXMAX = 7, BLZ_PASS_LEXLO = 8 };

// the argument words (core/kernels.py _PW_*)
enum { BLZ_PASS_W_K = 0, BLZ_PASS_W_ROWS = 1, BLZ_PASS_W_CAP = 2, BLZ_PASS_W_NOPS = 3,
       BLZ_PASS_W_NEMIT = 4, BLZ_PASS_W_STREAM = 5, BLZ_PASS_HEAD = 8,
       BLZ_PASS_KEY_WORDS = 4,  // data, validity, out, size
       BLZ_PASS_OP_WORDS = 10,  // kind, is_float, nvalid, src, src0, valid x 3, mult, init
       BLZ_PASS_EMIT_WORDS = 7, // kind, table, aux, aux2, size, is_float, out
       BLZ_PASS_OPS_AT = BLZ_PASS_HEAD + BLZ_MAX_PASS_KEYS * BLZ_PASS_KEY_WORDS,
       BLZ_PASS_EMITS_AT = BLZ_PASS_OPS_AT + BLZ_MAX_PASS_OPS * BLZ_PASS_OP_WORDS };

#define BLZ_PASS_QNAN64 0x7FF8000000000000LL
#define BLZ_PASS_QNAN32 0x7FC00000u

struct PassKeys {
  int k;
  const void* data[BLZ_MAX_PASS_KEYS];
  const uint8_t* valid[BLZ_MAX_PASS_KEYS];
  void* out[BLZ_MAX_PASS_KEYS];
  int size[BLZ_MAX_PASS_KEYS];
};

struct PassOp {
  int kind;
  int is_float;
  int nvalid;
  const void* src;        // int64 or float64 rows; unused by COUNT
  const long long* src0;  // LEXLO: l0 (src is l1)
  const uint8_t* valid[3];
  long long mult;
  long long init;  // the table's first value (a float's bits)
};

struct PassOps {
  int n;
  PassOp op[BLZ_MAX_PASS_OPS];
};

struct PassEmit {
  int kind;
  int table;
  int aux;
  int aux2;
  int size;      // bytes of the output type
  int is_float;  // float32 / float64 output
  void* out;
};

struct PassEmits {
  int n;
  PassEmit col[BLZ_MAX_PASS_EMITS];
};

// Row i of a plane of ``size``-byte values, as its bits.
__device__ __forceinline__ long long blz_pass_load(const void* p, int size, int64_t i) {
  switch (size) {
    case 1: return ((const uint8_t*)p)[i];
    case 2: return ((const uint16_t*)p)[i];
    case 4: return ((const uint32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

// Row i of an output plane of ``size``-byte values: the low bytes of v.
__device__ __forceinline__ void blz_pass_store(void* p, int size, int64_t i, long long v) {
  switch (size) {
    case 1: ((uint8_t*)p)[i] = (uint8_t)v; break;
    case 2: ((uint16_t*)p)[i] = (uint16_t)v; break;
    case 4: ((uint32_t*)p)[i] = (uint32_t)v; break;
    default: ((long long*)p)[i] = v; break;
  }
}

// The table value a one-row segment ends with: ``ok`` the row exists and
// its gate holds, x the source's bits, x0 the second source's.
__device__ __forceinline__ long long blz_pass_value(const PassOp& op, bool ok, long long x,
                                                    long long x0) {
  const unsigned long long init = (unsigned long long)op.init;
  if (op.kind == BLZ_PASS_COUNT) return (long long)(init + (ok ? 1ull : 0ull));
  if (op.is_float) {
    const double d = ok ? __longlong_as_double(x) : 0.0;
    long long w = op.init;
    if (op.kind == BLZ_PASS_ADD)
      w = __double_as_longlong(__dadd_rn(__longlong_as_double(op.init), d));
    else if (ok)
      w = x;
    return isnan(__longlong_as_double(w)) ? BLZ_PASS_QNAN64 : w;  // one NaN on every device
  }
  if (!ok) return op.init;
  switch (op.kind) {
    case BLZ_PASS_ADD:
      return (long long)(init + (unsigned long long)x * (unsigned long long)op.mult);
    case BLZ_PASS_ADD_LO32: return (long long)(init + (unsigned long long)(x & 0xFFFFFFFFLL));
    case BLZ_PASS_ADD_HI32: return (long long)(init + (unsigned long long)(x >> 32));
    case BLZ_PASS_LEXLO:
      return (long long)(((unsigned long long)x << 32) | (unsigned long long)x0);
    default: return x;  // MIN, MAX, LEXMIN, LEXMAX: the row's own value
  }
}

// An op's value at row i (a row at or past num_rows does not exist).
__device__ __forceinline__ long long blz_pass_op(const PassOp& op, int64_t i, int64_t num_rows) {
  bool ok = i < num_rows;
  for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][i] != 0;
  const long long x = op.kind != BLZ_PASS_COUNT ? ((const long long*)op.src)[i] : 0;
  const long long x0 = op.kind == BLZ_PASS_LEXLO ? op.src0[i] : 0;
  return blz_pass_value(op, ok, x, x0);
}

// An emit's value as its output's bits (a float32 output narrowed).
__device__ __forceinline__ long long blz_pass_bits(const PassEmit& e, long long v) {
  if (!(e.is_float && e.size == 4)) return v;
  const double d = __longlong_as_double(v);
  return isnan(d) ? (long long)BLZ_PASS_QNAN32 : (long long)__float_as_uint((float)d);
}

__global__ void __launch_bounds__(BLZ_PASS_THREADS) blz_passthrough_kernel(
    PassKeys ks, PassOps ops, PassEmits es, int64_t num_rows, int64_t cap,
    unsigned live_blocks, int64_t pad_from) {
  if (blockIdx.x < live_blocks) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= num_rows) return;
    // the first two keys' loads go out before the emits' own, so a thread
    // waits on device memory once for both (the stores come last)
    long long kd[2] = {0, 0};
    bool kv[2] = {false, false};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= ks.k) break;
      kd[j] = blz_pass_load(ks.data[j], ks.size[j], i);
      kv[j] = ks.valid[j][i] != 0;
    }
    for (int c = 0; c < es.n; ++c) {
      const PassEmit& e = es.col[c];
      const bool aux = e.kind == BLZ_EMIT_WHERE || e.kind >= BLZ_EMIT_CARRY;
      const long long t0 = blz_pass_op(ops.op[e.table], i, num_rows);
      const long long t1 = aux ? blz_pass_op(ops.op[e.aux], i, num_rows) : 0;
      const long long t2 = e.kind == BLZ_EMIT_TOP ? blz_pass_op(ops.op[e.aux2], i, num_rows) : 0;
      blz_pass_store(e.out, e.size, i, blz_pass_bits(e, blz_emit_value(e.kind, [&](int q) {
                       return q == 0 ? t0 : q == 1 ? t1 : t2;
                     })));
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= ks.k) break;
      blz_pass_store(ks.out[j], ks.size[j], i, kv[j] ? kd[j] : 0);
    }
    for (int j = 2; j < ks.k; ++j)
      blz_pass_store(ks.out[j], ks.size[j], i,
                     ks.valid[j][i] != 0 ? blz_pass_load(ks.data[j], ks.size[j], i) : 0);
    return;
  }
  // the padding rows [pad_from, cap): every key 0, every emit its constant
  const int64_t stride = (int64_t)(gridDim.x - live_blocks) * blockDim.x;
  const int64_t first = pad_from + (int64_t)(blockIdx.x - live_blocks) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < cap; i += stride)
    for (int j = 0; j < ks.k; ++j) blz_pass_store(ks.out[j], ks.size[j], i, 0);
  for (int c = 0; c < es.n; ++c) {
    const PassEmit& e = es.col[c];
    const long long t0 = blz_pass_value(ops.op[e.table], false, 0, 0);
    const long long t1 = blz_pass_value(ops.op[e.aux < 0 ? e.table : e.aux], false, 0, 0);
    const long long t2 = blz_pass_value(ops.op[e.aux2 < 0 ? e.table : e.aux2], false, 0, 0);
    const long long v = blz_pass_bits(e, blz_emit_value(e.kind, [&](int q) {
      return q == 0 ? t0 : q == 1 ? t1 : t2;
    }));
    for (int64_t i = first; i < cap; i += stride) blz_pass_store(e.out, e.size, i, v);
  }
}

// w: the argument words. Per key slot j < k: a plane of cap rows (its
// size in bytes a value: 1, 2, 4 or 8; bool and float keys by their
// bytes), its validity bytes (already masked with the row mask) and an
// output plane of the same size. Rows at or past num_rows do not exist.
// Per op o: kind, is_float, nvalid, source (int64 or float64 rows; 0 for
// COUNT), source0 (LEXLO's l0), nvalid bool planes, mult (integer ADD),
// init (the table's first value as 64 bits). Per emit c: kind, table, aux
// (WHERE, CARRY, MID, TOP, WORD_*), aux2 (TOP), the output's size in bytes
// and whether it is a float, out (cap values). A LEXMIN/LEXMAX op is
// followed by its LEXLO op.
BLZ_EXPORT int blz_passthrough(const long long* w) {
  const int k = (int)w[BLZ_PASS_W_K];
  const int64_t num_rows = w[BLZ_PASS_W_ROWS];
  const int64_t cap = w[BLZ_PASS_W_CAP];
  const int nops = (int)w[BLZ_PASS_W_NOPS];
  const int nemit = (int)w[BLZ_PASS_W_NEMIT];
  const cudaStream_t stream = (cudaStream_t)w[BLZ_PASS_W_STREAM];
  if (k < 0 || k > BLZ_MAX_PASS_KEYS || nops < 0 || nops > BLZ_MAX_PASS_OPS || nemit < 0 ||
      nemit > BLZ_MAX_PASS_EMITS || cap <= 0 || num_rows < 0 || num_rows > cap)
    return (int)cudaErrorInvalidValue;
  PassKeys ks;
  ks.k = k;
  for (int j = 0; j < k; ++j) {
    const long long* kw = w + BLZ_PASS_HEAD + j * BLZ_PASS_KEY_WORDS;
    const int s = (int)kw[3];
    if (s != 1 && s != 2 && s != 4 && s != 8) return (int)cudaErrorInvalidValue;
    ks.data[j] = (const void*)kw[0];
    ks.valid[j] = (const uint8_t*)kw[1];
    ks.out[j] = (void*)kw[2];
    ks.size[j] = s;
  }
  PassOps ops;
  ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    const long long* ow = w + BLZ_PASS_OPS_AT + o * BLZ_PASS_OP_WORDS;
    const int kd = (int)ow[0];
    // a LEXMIN/LEXMAX op's partner is the op after it (core/kernels.py
    // check_limb_program holds the pairing); here only that its planes exist
    if ((kd == BLZ_PASS_LEXMIN || kd == BLZ_PASS_LEXMAX) &&
        (o + 1 >= nops || ow[BLZ_PASS_OP_WORDS + 3] == 0 || ow[BLZ_PASS_OP_WORDS + 4] == 0))
      return (int)cudaErrorInvalidValue;
    if ((kd != BLZ_PASS_COUNT && ow[3] == 0) || (kd == BLZ_PASS_LEXLO && ow[4] == 0) ||
        ow[2] < 0 || ow[2] > 3)
      return (int)cudaErrorInvalidValue;
    PassOp& op = ops.op[o];
    op.kind = kd;
    op.is_float = (int)ow[1];
    op.nvalid = (int)ow[2];
    op.src = (const void*)ow[3];
    op.src0 = (const long long*)ow[4];
    for (int q = 0; q < 3; ++q) op.valid[q] = (const uint8_t*)ow[5 + q];
    op.mult = ow[8];
    op.init = ow[9];
  }
  PassEmits es;
  es.n = nemit;
  for (int c = 0; c < nemit; ++c) {
    const long long* ew = w + BLZ_PASS_EMITS_AT + c * BLZ_PASS_EMIT_WORDS;
    const int kd = (int)ew[0];
    const bool uses_aux = kd == BLZ_EMIT_WHERE || kd >= BLZ_EMIT_CARRY;
    const int s = (int)ew[4];
    if (ew[1] < 0 || ew[1] >= nops || (uses_aux && (ew[2] < 0 || ew[2] >= nops)) ||
        (kd == BLZ_EMIT_TOP && (ew[3] < 0 || ew[3] >= nops)) ||
        (s != 1 && s != 2 && s != 4 && s != 8) || (ew[5] && s < 4) || ew[6] == 0)
      return (int)cudaErrorInvalidValue;
    PassEmit& e = es.col[c];
    e.kind = kd;
    e.table = (int)ew[1];
    e.aux = uses_aux ? (int)ew[2] : -1;
    e.aux2 = kd == BLZ_EMIT_TOP ? (int)ew[3] : -1;
    e.size = s;
    e.is_float = (int)ew[5];
    e.out = (void*)ew[6];
  }
  // the live rows, a thread each; then the padding rows
  const int64_t live = (num_rows + BLZ_PASS_THREADS - 1) / BLZ_PASS_THREADS;
  const int64_t pad_from = num_rows;
  const int64_t pad_rows = cap - pad_from;
  const int64_t per_block = (int64_t)BLZ_PASS_THREADS * BLZ_PASS_FILL;
  const int64_t pad = (pad_rows + per_block - 1) / per_block;
  if (live + pad == 0) return (int)cudaSuccess;
  blz_passthrough_kernel<<<(unsigned)(live + pad), BLZ_PASS_THREADS, 0, stream>>>(
      ks, ops, es, num_rows, cap, (unsigned)live, pad_from);
  return (int)cudaGetLastError();
}
