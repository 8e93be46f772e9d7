// K12 slot_update: the host aggregation table's per-batch update of its
// persistent slot tables.
//
// Replaces the eager scatters of blaze_tpu/ops/aggfns.py that the host
// AggTable (blaze_tpu/ops/agg.py:545) runs once per batch and aggregate:
// SumAgg.update/merge (.at[].add / .at[].max, :320, :362), CountAgg
// (:442, :455), AvgAgg (:524, :557), MinMaxAgg (.at[].min/max, :724,
// :763) and FirstAgg (.at[].min of the row order, then _scatter_where's
// .at[].set, :857, :882, :941). The host interns the keys: each row comes
// with its slot id (the table capacity for a padding row, so it drops)
// and the row-exists mask; the Python wrapper describes the aggregates as
// a list of ops into tables of the table capacity, updated in place:
//   ADD    table[slot] += src          (int64: SUM, AVG sum, merged counts;
//                                        no src: += 1, i.e. COUNT)
//          table[slot] += src          (float64: SUM, AVG sum)
//   MIN / MAX  table[slot] = min/max(table[slot], src)   (int64, float64)
//   FLAG   table[slot] = true          (the "has" flags: bool bytes)
//   FIRST  the row of least order wins: order_table[slot] = that order,
//          table[slot] = its value (1, 2, 4 or 8 bytes), valid_table[slot]
//          = the AND of its written-validity planes
// each applied where the row exists and all of the op's (up to three)
// validity planes hold.
//
// Two kernels, each one launch for all of a batch's ops of its kind:
//   blz_upd_atomic_kernel, one thread per row: integer ADD with 64-bit
//     atomics (exact in any order; int64 wraps as XLA's scatter-add does),
//     MIN / MAX of int64 with atomicMin/atomicMax and of float64 with a
//     CAS loop on the value (-0.0 below 0.0 by the order-preserving word,
//     a NaN on either side gives the quiet NaN 0x7FF8...: a commutative,
//     associative rule, so any order gives the same bits), FLAG with a
//     plain byte store (every writer stores 1);
//   blz_upd_fold_kernel, one thread per run of a slot in the rows sorted
//     stably by slot (K5's radix sort over the slot words): float ADD is a
//     left fold in row order that starts from the slot's current value, bit
//     for bit XLA's scatter-add on the CPU across batches; FIRST takes the
//     least order of the run and, of the rows tied on it, the last in row
//     order, and writes where that order is at most the slot's: the
//     reference's min scatter then set scatter, whose last writer wins on
//     tied orders (partial states of different map tasks share orders).
//     No atomics: their order changes from run to run.
// A touched float slot that holds a NaN ends as the quiet NaN, so the
// card and the host agree to the bit.
//
// Bound on the H100: bytes. Each row's slot, mask, sources and validity
// planes are read once, each touched slot's table words read and written
// once. Atomics into few slots (a global aggregate: every row into slot 0)
// serialise in L2, so contention bounds those; a block-level
// pre-reduction is the next step there. The fold is one thread per run,
// sequential by design, and costs parallelism where few slots hold many
// rows.
#include "common.cuh"

#define BLZ_MAX_UPD_OPS 24
#define BLZ_QNAN_BITS 0x7FF8000000000000LL
#define BLZ_I64_MAX 0x7FFFFFFFFFFFFFFFLL

enum { BLZ_UPD_ADD = 0, BLZ_UPD_MIN = 1, BLZ_UPD_MAX = 2, BLZ_UPD_FLAG = 3,
       BLZ_UPD_FIRST = 4 };

struct UpdOp {
  int kind;
  int is_float;
  int nvalid;
  int nwvalid;
  int esize;
  const void* src;
  const uint8_t* valid[3];
  const uint8_t* wvalid[3];
  const long long* order;
  void* table;
  uint8_t* valid_table;
  long long* order_table;
};

struct UpdOpSet {
  int n;
  UpdOp op[BLZ_MAX_UPD_OPS];
};

__device__ __forceinline__ bool blz_upd_ok(const UpdOp& op, int64_t r) {
  bool ok = true;
  for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][r] != 0;
  return ok;
}

__device__ __forceinline__ long long blz_upd_order_word(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

// table[slot] = min/max(table[slot], x) under XLA's float rule, by CAS.
__device__ void blz_upd_float_extreme(unsigned long long* addr, double x,
                                      bool is_min) {
  unsigned long long old = *(volatile unsigned long long*)addr;
  while (true) {
    const double a = __longlong_as_double((long long)old);
    unsigned long long want;
    if (isnan(a) || isnan(x)) {
      want = (unsigned long long)BLZ_QNAN_BITS;
    } else {
      const bool take = is_min ? blz_upd_order_word(x) < blz_upd_order_word(a)
                               : blz_upd_order_word(x) > blz_upd_order_word(a);
      want = take ? (unsigned long long)__double_as_longlong(x) : old;
    }
    if (want == old) return;
    const unsigned long long seen = atomicCAS(addr, old, want);
    if (seen == old) return;
    old = seen;
  }
}

__global__ void blz_upd_atomic_kernel(const int64_t* slots, const uint8_t* mask,
                                      int64_t n, int64_t cap, UpdOpSet ops) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int64_t s = slots[i];
  if (s < 0 || s >= cap) return;
  for (int o = 0; o < ops.n; ++o) {
    const UpdOp& op = ops.op[o];
    if (!blz_upd_ok(op, i)) continue;
    switch (op.kind) {
      case BLZ_UPD_ADD: {
        const unsigned long long x =
            op.src ? (unsigned long long)((const long long*)op.src)[i] : 1ull;
        atomicAdd((unsigned long long*)op.table + s, x);
        break;
      }
      case BLZ_UPD_FLAG:
        ((uint8_t*)op.table)[s] = 1;
        break;
      default:
        if (op.is_float) {
          blz_upd_float_extreme((unsigned long long*)op.table + s,
                                ((const double*)op.src)[i], op.kind == BLZ_UPD_MIN);
        } else if (op.kind == BLZ_UPD_MIN) {
          atomicMin((long long*)op.table + s, ((const long long*)op.src)[i]);
        } else {
          atomicMax((long long*)op.table + s, ((const long long*)op.src)[i]);
        }
        break;
    }
  }
}

__device__ __forceinline__ void blz_upd_copy(void* dst, int64_t s, const void* src,
                                             int64_t r, int esize) {
  switch (esize) {
    case 1: ((uint8_t*)dst)[s] = ((const uint8_t*)src)[r]; break;
    case 2: ((uint16_t*)dst)[s] = ((const uint16_t*)src)[r]; break;
    case 4: ((uint32_t*)dst)[s] = ((const uint32_t*)src)[r]; break;
    default: ((uint64_t*)dst)[s] = ((const uint64_t*)src)[r]; break;
  }
}

__global__ void blz_upd_fold_kernel(const int64_t* slots, const uint8_t* mask,
                                    const int64_t* perm, int64_t n, int64_t cap,
                                    UpdOpSet ops) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t s = slots[perm[p]];
  if (s < 0 || s >= cap) return;
  if (p > 0 && slots[perm[p - 1]] == s) return;  // not the head of its run
  int64_t end = p + 1;
  while (end < n && slots[perm[end]] == s) ++end;
  for (int o = 0; o < ops.n; ++o) {
    const UpdOp& op = ops.op[o];
    if (op.kind == BLZ_UPD_ADD) {
      double a = ((const double*)op.table)[s];
      bool touched = false;
      for (int64_t q = p; q < end; ++q) {
        const int64_t r = perm[q];
        if (mask[r] && blz_upd_ok(op, r)) {
          a = __dadd_rn(a, ((const double*)op.src)[r]);
          touched = true;
        }
      }
      if (touched)
        ((long long*)op.table)[s] = isnan(a) ? BLZ_QNAN_BITS : __double_as_longlong(a);
    } else {  // FIRST
      long long best = BLZ_I64_MAX;
      int64_t last = -1;
      for (int64_t q = p; q < end; ++q) {
        const int64_t r = perm[q];
        if (!mask[r] || !blz_upd_ok(op, r)) continue;
        const long long ord = op.order[r];
        if (ord < best) {
          best = ord;
          last = r;
        } else if (ord == best) {
          last = r;
        }
      }
      if (last < 0 || best > op.order_table[s]) continue;
      op.order_table[s] = best;
      blz_upd_copy(op.table, s, op.src, last, op.esize);
      bool w = true;
      for (int q = 0; q < op.nwvalid; ++q) w = w && op.wvalid[q][last] != 0;
      op.valid_table[s] = w;
    }
  }
}

// slots: n int64 slot ids (ids outside [0, cap) drop); mask: n bool bytes,
// the row-exists mask; perm: n int64, the rows sorted stably by slot
// (needed when any op folds: a float ADD or a FIRST; else null). Per op o:
// kind, is_float (ADD / MIN / MAX over float64), source (n values; null for
// a counting ADD; FIRST: esize-byte values), op_nvalid[o] bool planes at
// op_valid[3*o + q], table (cap values), and for FIRST
// the esize, the order plane (n int64), op_nwvalid[o] written-validity
// planes at op_wvalid[3*o + q], the valid table (cap bool bytes) and the
// order table (cap int64).
BLZ_EXPORT int blz_slot_update(
    const int64_t* slots, const uint8_t* mask, int64_t n, int64_t cap,
    const int64_t* perm, int nops, const int* op_kind, const int* op_float,
    const void* const* op_src, const int* op_nvalid,
    const uint8_t* const* op_valid, void* const* op_table,
    const int* op_esize,
    const long long* const* op_order, const int* op_nwvalid,
    const uint8_t* const* op_wvalid, uint8_t* const* op_valid_table,
    long long* const* op_order_table, cudaStream_t stream) {
  if (nops > BLZ_MAX_UPD_OPS || n < 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  UpdOpSet atomic_ops, fold_ops;
  atomic_ops.n = fold_ops.n = 0;
  for (int o = 0; o < nops; ++o) {
    UpdOp op;
    op.kind = op_kind[o];
    op.is_float = op_float[o];
    op.nvalid = op_nvalid[o];
    op.nwvalid = op_nwvalid[o];
    op.esize = op_esize[o];
    op.src = op_src[o];
    for (int q = 0; q < 3; ++q) {
      op.valid[q] = op_valid[3 * o + q];
      op.wvalid[q] = op_wvalid[3 * o + q];
    }
    op.order = op_order[o];
    op.table = op_table[o];
    op.valid_table = op_valid_table[o];
    op.order_table = op_order_table[o];
    if (op.kind < BLZ_UPD_ADD || op.kind > BLZ_UPD_FIRST || op.nvalid > 3 ||
        op.nwvalid > 3 || op.table == nullptr)
      return (int)cudaErrorInvalidValue;
    const bool folds = op.kind == BLZ_UPD_FIRST || (op.kind == BLZ_UPD_ADD && op.is_float);
    if (folds) {
      if (perm == nullptr || op.src == nullptr) return (int)cudaErrorInvalidValue;
      if (op.kind == BLZ_UPD_FIRST &&
          (op.order == nullptr || op.valid_table == nullptr || op.order_table == nullptr ||
           !(op.esize == 1 || op.esize == 2 || op.esize == 4 || op.esize == 8)))
        return (int)cudaErrorInvalidValue;
      fold_ops.op[fold_ops.n++] = op;
    } else {
      if ((op.kind == BLZ_UPD_MIN || op.kind == BLZ_UPD_MAX) && op.src == nullptr)
        return (int)cudaErrorInvalidValue;
      atomic_ops.op[atomic_ops.n++] = op;
    }
  }
  if (n == 0) return (int)cudaSuccess;
  if (atomic_ops.n) {
    blz_upd_atomic_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
        slots, mask, n, cap, atomic_ops);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (fold_ops.n) {
    blz_upd_fold_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
        slots, mask, perm, n, cap, fold_ops);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}
