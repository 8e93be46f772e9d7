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
// returned as they are.
//
// One thread a row over a grid-stride loop of the capacity: no atomics,
// no slot table, no compaction and no group-count sync (the group count is
// the batch's row count). Bound on the H100: bytes; each key, source and
// validity plane is read once and each output written once (cust_spend's
// batch: a 4-byte key, an int64 argument, ~35 bytes a row), so the kernel
// is a copy at HBM speed once launched; the table values live in
// registers (local memory past the register file for wide programs).
#include "common.cuh"

#define BLZ_MAX_PASS_KEYS 16
#define BLZ_MAX_PASS_OPS 24
#define BLZ_MAX_PASS_EMITS 24
#define BLZ_PASS_THREADS 256
#define BLZ_PASS_MAX_BLOCKS 4096

// core/kernels.py OP_*, the same numbers as slot_agg.cu's and seg_agg.cu's
enum { BLZ_PASS_ADD = 0, BLZ_PASS_COUNT = 1, BLZ_PASS_MIN = 2, BLZ_PASS_MAX = 3,
       BLZ_PASS_ADD_LO32 = 4, BLZ_PASS_ADD_HI32 = 5, BLZ_PASS_LEXMIN = 6,
       BLZ_PASS_LEXMAX = 7, BLZ_PASS_LEXLO = 8 };

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

__device__ __forceinline__ void blz_pass_store(void* out, int size, int64_t i,
                                               long long v) {
  switch (size) {
    case 1: ((uint8_t*)out)[i] = (uint8_t)v; break;
    case 2: ((int16_t*)out)[i] = (int16_t)v; break;
    case 4: ((int32_t*)out)[i] = (int32_t)v; break;
    default: ((long long*)out)[i] = v; break;
  }
}

__global__ void blz_passthrough_kernel(PassKeys ks, PassOps ops, PassEmits es,
                                       int64_t num_rows, int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cap; i += stride) {
    const bool exists = i < num_rows;
    for (int j = 0; j < ks.k; ++j) {
      const bool v = ks.valid[j][i] != 0;
      blz_pass_store(ks.out[j], ks.size[j], i,
                     v ? blz_load_int(ks.data[j], ks.size[j], i) : 0);
    }
    long long t[BLZ_MAX_PASS_OPS];
    for (int o = 0; o < ops.n; ++o) {
      const PassOp& op = ops.op[o];
      bool ok = exists;
      for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][i] != 0;
      const unsigned long long init = (unsigned long long)op.init;
      long long w = op.init;
      if (op.kind == BLZ_PASS_COUNT) {
        w = (long long)(init + (ok ? 1ull : 0ull));
      } else if (op.is_float) {
        const double x = ok ? ((const double*)op.src)[i] : 0.0;
        if (op.kind == BLZ_PASS_ADD)
          w = __double_as_longlong(__dadd_rn(__longlong_as_double(op.init), x));
        else if (ok)
          w = __double_as_longlong(x);
        if (isnan(__longlong_as_double(w))) w = BLZ_PASS_QNAN64;  // one NaN on every device
      } else if (ok) {
        const long long x = ((const long long*)op.src)[i];
        switch (op.kind) {
          case BLZ_PASS_ADD:
            w = (long long)(init + (unsigned long long)x * (unsigned long long)op.mult);
            break;
          case BLZ_PASS_ADD_LO32:
            w = (long long)(init + (unsigned long long)(x & 0xFFFFFFFFLL));
            break;
          case BLZ_PASS_ADD_HI32:
            w = (long long)(init + (unsigned long long)(x >> 32));
            break;
          case BLZ_PASS_LEXLO:
            w = (long long)(((unsigned long long)x << 32) | (unsigned long long)op.src0[i]);
            break;
          default:  // MIN, MAX, LEXMIN, LEXMAX: the row's own value
            w = x;
            break;
        }
      }
      t[o] = w;
    }
    for (int c = 0; c < es.n; ++c) {
      const PassEmit& e = es.col[c];
      const long long v = blz_emit_value(
          e.kind, [&](int q) { return t[q == 0 ? e.table : q == 1 ? e.aux : e.aux2]; });
      if (e.is_float && e.size == 4) {
        const double d = __longlong_as_double(v);
        const float f = (float)d;
        ((uint32_t*)e.out)[i] = isnan(d) ? BLZ_PASS_QNAN32 : __float_as_uint(f);
      } else {
        blz_pass_store(e.out, e.size, i, v);
      }
    }
  }
}

// keys: k planes of cap rows (key_size bytes a value: 1, 2, 4 or 8; bool
// and float keys by their bytes), kvalids their validity bytes (already
// masked with the row mask), key_out k planes of the same sizes. Rows at
// or past num_rows do not exist. Per op o: kind, is_float, source (int64
// or float64 rows; null for COUNT), source0 (LEXLO's l0), op_nvalid[o]
// bool planes at op_valid[3*o + q], mult (integer ADD), init (the
// table's first value as 64 bits). Per emit c: kind, table, aux (WHERE,
// CARRY, MID, TOP, WORD_*), aux2 (TOP), the output's size in bytes and
// whether it is a float, out (cap values). A LEXMIN/LEXMAX op is followed
// by its LEXLO op.
BLZ_EXPORT int blz_passthrough(
    int k, const void* const* keys, const uint8_t* const* kvalids, const int* key_size,
    void* const* key_out, int64_t num_rows, int64_t cap, int nops, const int* op_kind,
    const int* op_float, const void* const* op_src, const void* const* op_src0,
    const int* op_nvalid, const uint8_t* const* op_valid, const long long* op_mult,
    const long long* op_init, int nemit, const int* emit_kind, const int* emit_table,
    const int* emit_aux, const int* emit_aux2, const int* emit_size,
    const int* emit_float, void* const* emit_out, cudaStream_t stream) {
  if (k > BLZ_MAX_PASS_KEYS || nops > BLZ_MAX_PASS_OPS || nemit > BLZ_MAX_PASS_EMITS ||
      cap <= 0 || num_rows < 0 || num_rows > cap)
    return (int)cudaErrorInvalidValue;
  PassKeys ks;
  ks.k = k;
  for (int j = 0; j < k; ++j) {
    const int s = key_size[j];
    if (s != 1 && s != 2 && s != 4 && s != 8) return (int)cudaErrorInvalidValue;
    ks.data[j] = keys[j];
    ks.valid[j] = kvalids[j];
    ks.out[j] = key_out[j];
    ks.size[j] = s;
  }
  PassOps ops;
  ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    const int kd = op_kind[o];
    // a LEXMIN/LEXMAX op's partner is the op after it (core/kernels.py
    // check_limb_program holds the pairing); here only that its planes exist
    if ((kd == BLZ_PASS_LEXMIN || kd == BLZ_PASS_LEXMAX) &&
        (o + 1 >= nops || op_src[o + 1] == nullptr || op_src0[o + 1] == nullptr))
      return (int)cudaErrorInvalidValue;
    if (kd != BLZ_PASS_COUNT && op_src[o] == nullptr) return (int)cudaErrorInvalidValue;
    ops.op[o].kind = kd;
    ops.op[o].is_float = op_float[o];
    ops.op[o].nvalid = op_nvalid[o];
    ops.op[o].src = op_src[o];
    ops.op[o].src0 = (const long long*)op_src0[o];
    for (int q = 0; q < 3; ++q) ops.op[o].valid[q] = op_valid[3 * o + q];
    ops.op[o].mult = op_mult[o];
    ops.op[o].init = op_init[o];
  }
  PassEmits es;
  es.n = nemit;
  for (int c = 0; c < nemit; ++c) {
    const int kd = emit_kind[c];
    const bool uses_aux = kd == BLZ_EMIT_WHERE || kd >= BLZ_EMIT_CARRY;
    const int s = emit_size[c];
    if (emit_table[c] < 0 || emit_table[c] >= nops ||
        (uses_aux && (emit_aux[c] < 0 || emit_aux[c] >= nops)) ||
        (kd == BLZ_EMIT_TOP && (emit_aux2[c] < 0 || emit_aux2[c] >= nops)) ||
        (s != 1 && s != 2 && s != 4 && s != 8) || (emit_float[c] && s < 4))
      return (int)cudaErrorInvalidValue;
    es.col[c].kind = kd;
    es.col[c].table = emit_table[c];
    es.col[c].aux = emit_aux[c];
    es.col[c].aux2 = emit_aux2[c];
    es.col[c].size = s;
    es.col[c].is_float = emit_float[c];
    es.col[c].out = emit_out[c];
  }
  int64_t blocks = (cap + BLZ_PASS_THREADS - 1) / BLZ_PASS_THREADS;
  if (blocks > BLZ_PASS_MAX_BLOCKS) blocks = BLZ_PASS_MAX_BLOCKS;
  blz_passthrough_kernel<<<(unsigned int)blocks, BLZ_PASS_THREADS, 0, stream>>>(
      ks, ops, es, num_rows, cap);
  return (int)cudaGetLastError();
}
