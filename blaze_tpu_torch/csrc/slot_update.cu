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
// and the limb ops of a wide-decimal state (the limb branches of
// SumAgg/AvgAgg.update/merge, :320-377, :524-557, and MinMaxAgg's
// _lex_scatter_minmax, :161, :728, :767):
//   ADD_LO32 / ADD_HI32  table[slot] += src & 0xFFFFFFFF / src >> 32
//          (arithmetic): the two-limb split of an int64 source
//   RENORM the carry renormalisation of a limb sum (table = l0, limb
//          tables l1 and, for three limbs, l2) at the rows' slots
//          (_limb_renorm / _limb3_renorm)
//   LEXMIN / LEXMAX  the extreme (l2, l1, l0) of the slot's rows (src =
//          l2, limb sources l1, l0) replaces the state (table = s2, limb
//          tables s1, s0) where it wins or has (valid_table) is false
// each applied where the row exists and all of the op's (up to three)
// validity planes hold.
//
// Every op but the float ADD is order-free, and runs as passes of
// atomics; one call makes at most five launches, all on the caller's
// stream:
//   - pass 1, the atoms: integer ADD, ADD_LO32/HI32 (64-bit adds, exact in
//     any order; int64 wraps as XLA's scatter-add does), MIN / MAX of
//     int64, MIN / MAX of float64 by the order-preserving word (-0.0 below
//     0.0; a NaN on either side gives the quiet NaN 0x7FF8...: a
//     commutative, associative rule, so any order gives the same bits),
//     FLAG, FIRST's least order (a MIN into the order table), the LEX
//     pair's best l2 (signed) into scratch, and a mark a slot for RENORM
//     and LEX. The lanes of a warp that hit one slot (__match_any_sync)
//     fold their values by shuffles (common.cuh blz_reduce_peers) and
//     one lane applies them with one global atomic (a warp with no two
//     neighbouring lanes on one slot skips the match): a global aggregate
//     costs one atomic a warp;
//   - pass 2 (FIRST, LEX): over the rows tied on the slot's pass-1 word,
//     the tiebreak: the last row in row order for FIRST, the best
//     unsigned low word (l1 << 32) | l0 for LEX (l1 and l0 are
//     non-negative 32-bit chunks, so this is the reference's cascade);
//   - pass 3, a thread a slot: RENORM of each marked slot once, after
//     the batch's adds (a batch's LO32/HI32 parts on a renormalised limb
//     stay exact in int64: 262,144 rows x 2^32 < 2^51); FIRST writes its
//     row's value and the AND of its written-validity planes where a row
//     won (its order at most the slot's: the reference's min scatter then
//     set scatter, whose last writer wins on tied orders); LEX compares the batch's
//     best with the state and writes where it wins or the slot has none;
//   - the fold, float ADD only: a left fold in row order that starts from
//     the slot's current value, bit for bit XLA's scatter-add on the CPU
//     across batches, over the rows sorted stably by slot (K5's radix
//     sort, launched by the wrapper), in two launches: a thread folds a
//     run that ends in its warp; then a run that crosses its warp's end
//     is folded by that warp (its end found by a warp-wide galloping
//     search), the lanes loading the next 512 rows while the current ones,
//     staged in shared memory, are added in order (__dadd_rn; every lane
//     repeats the adds; a row that does not take part adds -0.0, the exact
//     identity). A touched float slot that holds a NaN ends as the quiet
//     NaN, so the card and the host agree to the bit.
//
// The scratch (the wrapper's, kept by its pack): a word a slot for
// FIRST's winning row + 1, two for LEX's best l2 and low word (as
// unsigned keys, the better larger) and a byte a slot for the marks of
// RENORM and LEX; all zero at the start of a call and zero again at its
// end, since the pass that reads a word clears it (no memset a call).
//
// Arguments come as one int64 word array (core/kernels.py
// SlotUpdatePack keeps it between calls and writes only the rows'
// pointers): a header (BLZ_UPD_W_*), then BLZ_UPD_OP_WORDS words an op
// (BLZ_UPD_O_*).
//
// Bound on the H100: bytes. Each row's slot, mask, sources and validity
// planes are read once, each touched slot's table words read and written
// once. The warp aggregation takes most of the contention of few slots
// off L2; the float fold is a chain of dependent adds where one slot
// holds many rows.
#include "common.cuh"

#define BLZ_MAX_UPD_OPS 24
#define BLZ_MAX_UPD_ATOMS (2 * BLZ_MAX_UPD_OPS)
#define BLZ_QNAN_BITS 0x7FF8000000000000LL
#define BLZ_I64_MAX 0x7FFFFFFFFFFFFFFFLL
#define BLZ_I64_MIN (-BLZ_I64_MAX - 1)
#define BLZ_SIGN 0x8000000000000000ull
#define BLZ_LO32 0xFFFFFFFFLL
#define BLZ_UPD_THREADS 256
#define BLZ_FOLD_THREADS 256
#define BLZ_FOLD_AHEAD 16              // rows a lane of a warp fold loads ahead (x 32)
#define BLZ_FOLD_WARPS (BLZ_FOLD_THREADS / 32)

enum { BLZ_UPD_ADD = 0, BLZ_UPD_MIN = 1, BLZ_UPD_MAX = 2, BLZ_UPD_FLAG = 3,
       BLZ_UPD_FIRST = 4, BLZ_UPD_ADD_LO32 = 5, BLZ_UPD_ADD_HI32 = 6, BLZ_UPD_RENORM = 7,
       BLZ_UPD_LEXMIN = 8, BLZ_UPD_LEXMAX = 9 };

// the argument words (core/kernels.py _UW_* / _UO_*)
enum { BLZ_UPD_W_N = 0, BLZ_UPD_W_CAP = 1, BLZ_UPD_W_NOPS = 2, BLZ_UPD_W_SLOTS = 3,
       BLZ_UPD_W_MASK = 4, BLZ_UPD_W_PERM = 5, BLZ_UPD_W_SCRATCH = 6,
       BLZ_UPD_W_SCRATCH_BYTES = 7, BLZ_UPD_W_STREAM = 8, BLZ_UPD_HEAD = 16 };
enum { BLZ_UPD_O_KIND = 0, BLZ_UPD_O_FLOAT = 1, BLZ_UPD_O_ESIZE = 2, BLZ_UPD_O_NVALID = 3,
       BLZ_UPD_O_NWVALID = 4, BLZ_UPD_O_SRC = 5, BLZ_UPD_O_VALID = 6, BLZ_UPD_O_WVALID = 9,
       BLZ_UPD_O_ORDER = 12, BLZ_UPD_O_TABLE = 13, BLZ_UPD_O_VALID_TABLE = 14,
       BLZ_UPD_O_ORDER_TABLE = 15, BLZ_UPD_O_LIMB_SRC = 16, BLZ_UPD_O_LIMB_TABLE = 18,
       BLZ_UPD_OP_WORDS = 20 };

// how an atom's values combine (identity: SUM, UMAX, FLAG 0; MIN, FMIN
// the int64 max; MAX, FMAX the int64 min)
enum { BLZ_RED_SUM = 0, BLZ_RED_MIN = 1, BLZ_RED_MAX = 2, BLZ_RED_UMAX = 3, BLZ_RED_FLAG = 4,
       BLZ_RED_FMIN = 5, BLZ_RED_FMAX = 6 };
// what an atom takes from a row
enum { BLZ_VAL_SRC = 0, BLZ_VAL_LO32 = 1, BLZ_VAL_HI32 = 2, BLZ_VAL_ONE = 3,
       BLZ_VAL_FWORD = 4, BLZ_VAL_ORDER = 5, BLZ_VAL_KEY2 = 6, BLZ_VAL_ROW = 7,
       BLZ_VAL_KEYW = 8 };

// One atomic reduction a row of an op's rows into a slot table, with the
// row planes it reads (held in the atom itself, so that a thread's first
// loads wait on one read of the kernel's parameters, not two).
struct UpdAtom {
  int red;
  int val;
  int nvalid;
  int is_max;               // KEY2, KEYW
  void* target;             // int64 words, bool bytes (FLAG) or float64 (FMIN/FMAX)
  const long long* cmp;     // ROW / KEYW: the slot's word the row must equal
  const void* src;          // the rows' values: int64 / float64 (null: a count), the
                            // order (ORDER, ROW) or l2 (KEY2, KEYW)
  const uint8_t* valid[3];
  const long long* l1;      // KEYW
  const long long* l0;
};

struct UpdAtoms {
  int n;
  UpdAtom a[BLZ_MAX_UPD_ATOMS];
};

// Pass 3: an op's work at each slot.
struct UpdSlotOp {
  int kind;
  int esize;
  int nwvalid;
  int is_max;
  long long* t[3];          // RENORM: l0, l1, l2 (or null); LEX: s2, s1, s0
  void* table;              // FIRST: values
  uint8_t* valid_table;     // FIRST: valid; LEX: has
  const void* src;          // FIRST: the rows' values
  const uint8_t* wvalid[3];
  uint8_t* mark;            // RENORM, LEX
  long long* w0;            // FIRST: the winning row + 1; LEX: the best l2's key
  long long* w1;            // LEX: the best low word's key
};

struct UpdSlotOps {
  int n;
  UpdSlotOp op[BLZ_MAX_UPD_OPS];
};

// The fold: a float ADD op.
struct UpdFoldOp {
  int nvalid;
  const double* src;
  const uint8_t* valid[3];
  long long* table;
};

struct UpdFolds {
  int n;
  UpdFoldOp op[BLZ_MAX_UPD_OPS];
};

__device__ __forceinline__ long long blz_upd_order_word(double x) {
  const long long b = __double_as_longlong(x);
  return b ^ ((b >> 63) & BLZ_I64_MAX);
}

__device__ __forceinline__ long long blz_upd_identity(int red) {
  switch (red) {
    case BLZ_RED_MIN: case BLZ_RED_FMIN: return BLZ_I64_MAX;
    case BLZ_RED_MAX: case BLZ_RED_FMAX: return BLZ_I64_MIN;
    default: return 0;
  }
}

__device__ __forceinline__ long long blz_upd_merge(int red, long long a, long long b) {
  switch (red) {
    case BLZ_RED_SUM: return (long long)((unsigned long long)a + (unsigned long long)b);
    case BLZ_RED_MIN: case BLZ_RED_FMIN: return b < a ? b : a;
    case BLZ_RED_UMAX: return (unsigned long long)b > (unsigned long long)a ? b : a;
    default: return b > a ? b : a;  // MAX, FMAX, FLAG
  }
}

// A LEX row's keys: the better value the larger unsigned word.
__device__ __forceinline__ long long blz_upd_key2(long long l2, int is_max) {
  const unsigned long long k = (unsigned long long)l2 ^ BLZ_SIGN;
  return (long long)(is_max ? k : ~k);
}

__device__ __forceinline__ long long blz_upd_keyw(long long l1, long long l0, int is_max) {
  const unsigned long long w = ((unsigned long long)l1 << 32) | (unsigned long long)l0;
  return (long long)(is_max ? w : ~w);
}

// table[slot] = min/max(table[slot], x) under XLA's float rule, by CAS.
__device__ void blz_upd_float_extreme(unsigned long long* addr, double x, bool is_min) {
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

// An atom's combined value v (not its identity) into the global table.
// An extreme reads the slot first and skips its atomic where v cannot win
// (the slot only moves towards its extreme, so an older word is no
// better than the current one): the rows of a slot mostly lose once its
// extreme is in, and their atomics would serialise on its address.
__device__ __forceinline__ void blz_upd_apply(const UpdAtom& a, int64_t s, long long v) {
  long long* t = (long long*)a.target + s;
  switch (a.red) {
    case BLZ_RED_SUM: atomicAdd((unsigned long long*)t, (unsigned long long)v); break;
    case BLZ_RED_MIN:
      if (v < __ldcg(t)) atomicMin(t, v);
      break;
    case BLZ_RED_MAX:
      if (v > __ldcg(t)) atomicMax(t, v);
      break;
    case BLZ_RED_UMAX:
      if ((unsigned long long)v > (unsigned long long)__ldcg(t))
        atomicMax((unsigned long long*)t, (unsigned long long)v);
      break;
    case BLZ_RED_FLAG: ((uint8_t*)a.target)[s] = 1; break;
    default: {  // the order word back to its value (the map is its own inverse)
      const bool is_min = a.red == BLZ_RED_FMIN;
      const double x = v == (is_min ? BLZ_I64_MIN : BLZ_I64_MAX)
                           ? __longlong_as_double(BLZ_QNAN_BITS)
                           : __longlong_as_double(v ^ ((v >> 63) & BLZ_I64_MAX));
      blz_upd_float_extreme((unsigned long long*)t, x, is_min);
      break;
    }
  }
}

// An atom's loads for row i at slot s, issued before any is used.
struct UpdLoad {
  uint8_t g0, g1, g2;
  long long x, y, z, c;
};

__device__ __forceinline__ UpdLoad blz_upd_load(const UpdAtom& a, int64_t i, int64_t s,
                                                bool live) {
  UpdLoad d;
  d.g0 = live ? 1 : 0;
  d.g1 = d.g2 = 1;
  d.x = d.y = d.z = d.c = 0;
  if (!live) return d;
  if (a.nvalid > 0) d.g0 = a.valid[0][i];
  if (a.nvalid > 1) d.g1 = a.valid[1][i];
  if (a.nvalid > 2) d.g2 = a.valid[2][i];
  switch (a.val) {
    case BLZ_VAL_SRC: d.x = a.src != nullptr ? ((const long long*)a.src)[i] : 1; break;
    case BLZ_VAL_ONE: break;
    case BLZ_VAL_ROW:
      d.x = ((const long long*)a.src)[i];
      d.c = a.cmp[s];
      break;
    case BLZ_VAL_KEYW:
      d.x = ((const long long*)a.src)[i];
      d.y = a.l1[i];
      d.z = a.l0[i];
      d.c = a.cmp[s];
      break;
    default: d.x = ((const long long*)a.src)[i]; break;  // LO32, HI32, FWORD, ORDER, KEY2
  }
  return d;
}

// What row i gives the atom (its identity where the row does not take part).
__device__ __forceinline__ long long blz_upd_value(const UpdAtom& a, const UpdLoad& d,
                                                   int64_t i) {
  const long long id = blz_upd_identity(a.red);
  if (d.g0 == 0 || d.g1 == 0 || d.g2 == 0) return id;
  switch (a.val) {
    case BLZ_VAL_LO32: return d.x & BLZ_LO32;
    case BLZ_VAL_HI32: return d.x >> 32;
    case BLZ_VAL_ONE: return 1;
    case BLZ_VAL_FWORD: {
      const double f = __longlong_as_double(d.x);
      if (isnan(f)) return a.red == BLZ_RED_FMIN ? BLZ_I64_MIN : BLZ_I64_MAX;  // NaN wins
      return blz_upd_order_word(f);
    }
    case BLZ_VAL_KEY2: return blz_upd_key2(d.x, a.is_max);
    case BLZ_VAL_ROW: return d.x == d.c ? i + 1 : id;
    case BLZ_VAL_KEYW: return blz_upd_key2(d.x, a.is_max) == d.c ? blz_upd_keyw(d.y, d.z, a.is_max)
                                                                 : id;
    default: return d.x;  // SRC, ORDER
  }
}

// The carry renormalisation of slot s's limb sum (l2 null: two limbs).
__device__ __forceinline__ void blz_upd_renorm(long long* l0, long long* l1, long long* l2,
                                               int64_t s) {
  const long long v0 = __ldcg(l0 + s);
  const long long v1 = (long long)((unsigned long long)__ldcg(l1 + s) +
                                   (unsigned long long)(v0 >> 32));
  l0[s] = v0 & BLZ_LO32;
  if (l2 == nullptr) {
    l1[s] = v1;
  } else {
    l1[s] = v1 & BLZ_LO32;
    l2[s] = (long long)((unsigned long long)__ldcg(l2 + s) + (unsigned long long)(v1 >> 32));
  }
}

// A pass of atoms over the rows, a row a thread, applied to the global
// tables.
__global__ void __launch_bounds__(BLZ_UPD_THREADS) blz_upd_atoms_kernel(
    const int64_t* slots, const uint8_t* mask, int64_t n, int64_t cap, UpdAtoms set) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u;
  const bool in = i < n;
  const uint8_t m = in ? mask[i] : 0;
  const int64_t s0 = in ? slots[i] : -1;
  const bool live = m != 0 && s0 >= 0 && s0 < cap;
  if (!__any_sync(BLZ_FULL, live)) return;  // the whole warp's rows are dead
  const int64_t s = live ? s0 : 0;
  // slots are below 2^31; a dead lane is a group of its own. A warp with
  // no two neighbouring lanes on one slot (scattered slots) skips the
  // match: its lanes apply alone
  const unsigned key = live ? (unsigned)s0 : 0x80000000u | lane;
  const unsigned up = __shfl_up_sync(BLZ_FULL, key, 1);
  const bool dup = __any_sync(BLZ_FULL, lane > 0 && live && up == key);
  const unsigned peers = dup ? __match_any_sync(BLZ_FULL, key) : 1u << lane;
  const bool leader = live && (int)lane == __ffs(peers) - 1;
  // atom k + 1's loads go out before atom k's warp fold waits on shuffles
  UpdLoad next = blz_upd_load(set.a[0], i, s, live);
  for (int k = 0; k < set.n; ++k) {
    const UpdAtom& a = set.a[k];
    const UpdLoad d = next;
    if (k + 1 < set.n) next = blz_upd_load(set.a[k + 1], i, s, live);
    const long long v = blz_reduce_peers(
        peers, blz_upd_value(a, d, i),
        [&](long long x, long long y) { return blz_upd_merge(a.red, x, y); });
    if (leader && v != blz_upd_identity(a.red)) blz_upd_apply(a, s, v);
  }
}

// (a2, aw) beats (b2, bw): l2 signed first, then the low word unsigned.
__device__ __forceinline__ bool blz_lex_better(long long a2, unsigned long long aw,
                                               long long b2, unsigned long long bw,
                                               bool is_max) {
  return is_max ? (a2 > b2 || (a2 == b2 && aw > bw)) : (a2 < b2 || (a2 == b2 && aw < bw));
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

// Pass 3: thread s takes slot s.
__global__ void blz_upd_slots_kernel(int64_t cap, UpdSlotOps ops) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  for (int o = 0; o < ops.n; ++o) {
    const UpdSlotOp& op = ops.op[o];
    if (op.kind == BLZ_UPD_RENORM) {
      if (!op.mark[s]) continue;
      op.mark[s] = 0;
      blz_upd_renorm(op.t[0], op.t[1], op.t[2], s);
    } else if (op.kind == BLZ_UPD_FIRST) {
      const long long r1 = op.w0[s];
      if (r1 <= 0) continue;
      op.w0[s] = 0;
      const int64_t r = r1 - 1;
      blz_upd_copy(op.table, s, op.src, r, op.esize);
      bool w = true;
      for (int q = 0; q < op.nwvalid; ++q) w = w && op.wvalid[q][r] != 0;
      op.valid_table[s] = w;
    } else {  // LEXMIN / LEXMAX
      if (!op.mark[s]) continue;
      const unsigned long long k2 = (unsigned long long)op.w0[s];
      const unsigned long long kw = (unsigned long long)op.w1[s];
      op.mark[s] = 0;
      op.w0[s] = op.w1[s] = 0;
      const long long b2 = (long long)((op.is_max ? k2 : ~k2) ^ BLZ_SIGN);
      const unsigned long long bw = op.is_max ? kw : ~kw;
      const unsigned long long sw =
          ((unsigned long long)op.t[1][s] << 32) | (unsigned long long)op.t[2][s];
      if (op.valid_table[s] && !blz_lex_better(b2, bw, op.t[0][s], sw, op.is_max)) continue;
      op.t[0][s] = b2;
      op.t[1][s] = (long long)(bw >> 32);
      op.t[2][s] = (long long)(bw & 0xFFFFFFFFull);
      op.valid_table[s] = 1;
    }
  }
}

__device__ __forceinline__ bool blz_upd_fold_ok(const UpdFoldOp& op, const uint8_t* mask,
                                                int64_t r) {
  const uint8_t m = mask[r];
  const uint8_t g0 = op.nvalid > 0 ? op.valid[0][r] : 1;
  const uint8_t g1 = op.nvalid > 1 ? op.valid[1][r] : 1;
  const uint8_t g2 = op.nvalid > 2 ? op.valid[2][r] : 1;
  return m != 0 && g0 != 0 && g1 != 0 && g2 != 0;
}

// The first sorted position past ``base`` whose slot is not s (n if
// none), where positions up to base hold s: the warp's lanes probe 32
// positions a step, the steps growing 32-fold until a probe leaves the
// run, then narrowing 32-fold. Every lane of the warp calls it.
__device__ int64_t blz_upd_run_end(const int64_t* slots, const int64_t* perm, int64_t n,
                                   int64_t base, int64_t s) {
  const int lane = threadIdx.x & 31;
  int64_t step = 1;
  while (true) {
    const int64_t q = base + step * (lane + 1);
    const bool out = q >= n || slots[perm[q]] != s;
    const unsigned b = __ballot_sync(BLZ_FULL, out);
    if (b == 0) {  // all 32 probes in the run (only while growing)
      base += step * 32;
      step *= 32;
      continue;
    }
    base += step * (__ffs(b) - 1);  // the last probe in the run (or base)
    if (step == 1) return base + 1;
    step /= 32;
  }
}

// Rows [base, base + 32 * AHEAD) of a fold, lane-strided: each row's value
// where it takes part, else -0.0; bit u of *ok for this lane's row u.
__device__ __forceinline__ void blz_upd_fold_load(const UpdFoldOp& op, const int64_t* perm,
                                                  const uint8_t* mask, int64_t base, int64_t hi,
                                                  double* v, unsigned* ok) {
  const int lane = threadIdx.x & 31;
  int64_t r[BLZ_FOLD_AHEAD];
#pragma unroll
  for (int u = 0; u < BLZ_FOLD_AHEAD; ++u) {
    const int64_t q = base + u * 32 + lane;
    r[u] = q < hi ? perm[q] : -1;
  }
  *ok = 0;
#pragma unroll
  for (int u = 0; u < BLZ_FOLD_AHEAD; ++u) {
    const bool take = r[u] >= 0 && blz_upd_fold_ok(op, mask, r[u]);
    v[u] = take ? op.src[r[u]] : -0.0;
    *ok |= (unsigned)take << u;
  }
}

// One float ADD's left fold of the sorted rows [lo, hi) of slot s by the
// whole warp: the next 512 rows load while the current ones, staged in
// shared memory (``buf``, 512 doubles), are added one by one in order;
// every lane reads each value (a broadcast) and computes the same sum.
__device__ void blz_upd_warp_fadd(const UpdFoldOp& op, const int64_t* perm, const uint8_t* mask,
                                  int64_t lo, int64_t hi, int64_t s, double* buf) {
  const int lane = threadIdx.x & 31;
  double nxt[BLZ_FOLD_AHEAD];
  unsigned ok = 0;
  blz_upd_fold_load(op, perm, mask, lo, hi, nxt, &ok);
  double a = __longlong_as_double(op.table[s]);
  bool touched = false;
  for (int64_t base = lo; base < hi; base += 32 * BLZ_FOLD_AHEAD) {
#pragma unroll
    for (int u = 0; u < BLZ_FOLD_AHEAD; ++u) buf[u * 32 + lane] = nxt[u];
    const bool any = __any_sync(BLZ_FULL, ok != 0);
    touched = touched || any;
    __syncwarp();
    const int64_t next = base + 32 * BLZ_FOLD_AHEAD;
    if (next < hi) blz_upd_fold_load(op, perm, mask, next, hi, nxt, &ok);
    const double2* b2 = (const double2*)buf;
#pragma unroll 16
    for (int q = 0; q < 16 * BLZ_FOLD_AHEAD; ++q) {
      const double2 v = b2[q];
      a = __dadd_rn(a, v.x);
      a = __dadd_rn(a, v.y);
    }
    __syncwarp();
  }
  if (touched && lane == 0) op.table[s] = isnan(a) ? BLZ_QNAN_BITS : __double_as_longlong(a);
}

// Sorted position p's place in its run: its slot (-1 where out of range or
// past n), whether it heads the run, and the lanes of its warp at or after
// it that end a run. Every lane of the warp calls it.
__device__ __forceinline__ int64_t blz_upd_run_at(const int64_t* slots, const int64_t* perm,
                                                  int64_t n, int64_t cap, int64_t p, bool* head,
                                                  unsigned* after) {
  const int lane = threadIdx.x & 31;
  int64_t s = -1;
  bool tail = false;
  *head = false;
  if (p < n) {
    const int64_t v = slots[perm[p]];
    const int64_t prev = p > 0 ? slots[perm[p - 1]] : 0;
    const int64_t next = p + 1 < n ? slots[perm[p + 1]] : 0;
    if (v >= 0 && v < cap) {
      s = v;
      *head = p == 0 || prev != s;
      tail = p + 1 == n || next != s;
    }
  }
  *after = __ballot_sync(BLZ_FULL, tail) & (BLZ_FULL << lane);
  return s;
}

// The fold's short runs: thread p takes sorted position p, and a run's
// head folds it alone where the run ends in its warp.
__global__ void __launch_bounds__(BLZ_FOLD_THREADS) blz_upd_fold_kernel(
    const int64_t* slots, const uint8_t* mask, const int64_t* perm, int64_t n, int64_t cap,
    UpdFolds f) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool head;
  unsigned after;
  const int64_t s = blz_upd_run_at(slots, perm, n, cap, p, &head, &after);
  if (!head || !after) return;
  const int64_t end = p - (threadIdx.x & 31) + __ffs(after);  // one past the run's tail
  for (int o = 0; o < f.n; ++o) {
    const UpdFoldOp& op = f.op[o];
    double a = __longlong_as_double(op.table[s]);
    bool touched = false;
    for (int64_t q = p; q < end; ++q) {
      const int64_t r = perm[q];
      if (blz_upd_fold_ok(op, mask, r)) {
        a = __dadd_rn(a, op.src[r]);
        touched = true;
      }
    }
    if (touched) op.table[s] = isnan(a) ? BLZ_QNAN_BITS : __double_as_longlong(a);
  }
}

// The fold's long runs: each warp takes its 32 sorted positions and folds
// the run that crosses their end (at most one: their last), found by a
// warp-wide galloping search; the other warps only look.
__global__ void __launch_bounds__(BLZ_FOLD_THREADS) blz_upd_fold_long_kernel(
    const int64_t* slots, const uint8_t* mask, const int64_t* perm, int64_t n, int64_t cap,
    UpdFolds f) {
  __shared__ __align__(16) double buf[BLZ_FOLD_WARPS][32 * BLZ_FOLD_AHEAD];
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool head;
  unsigned after;
  const int64_t s = blz_upd_run_at(slots, perm, n, cap, p, &head, &after);
  const unsigned crossing = __ballot_sync(BLZ_FULL, head && !after);
  if (!crossing) return;
  const int src = __ffs(crossing) - 1;
  const int64_t lo = __shfl_sync(BLZ_FULL, p, src);
  const int64_t rs = __shfl_sync(BLZ_FULL, s, src);
  const int64_t hi = blz_upd_run_end(slots, perm, n, lo + (31 - src), rs);
  for (int o = 0; o < f.n; ++o)
    blz_upd_warp_fadd(f.op[o], perm, mask, lo, hi, rs, buf[threadIdx.x >> 5]);
}

static inline int64_t blz_upd_cap_bytes(int64_t cap) { return (cap + 7) & ~(int64_t)7; }

// The scratch an op takes: int64 words a slot, bytes a slot.
static inline void blz_upd_op_scratch(int kind, int* words, int* bytes) {
  *words = kind == BLZ_UPD_FIRST ? 1 : (kind == BLZ_UPD_LEXMIN || kind == BLZ_UPD_LEXMAX) ? 2 : 0;
  *bytes = (kind == BLZ_UPD_RENORM || kind == BLZ_UPD_LEXMIN || kind == BLZ_UPD_LEXMAX) ? 1 : 0;
}

// The scratch bytes blz_slot_update takes for the words' ops and capacity:
// the word tables, then the byte tables (core/kernels.py SlotUpdatePack
// sizes it by the same rule).
static int64_t blz_slot_update_scratch(const long long* w) {
  const int64_t cap = w[BLZ_UPD_W_CAP];
  const int nops = (int)w[BLZ_UPD_W_NOPS];
  int64_t words = 0, bytes = 0;
  for (int o = 0; o < nops && o < BLZ_MAX_UPD_OPS; ++o) {
    int wd, by;
    blz_upd_op_scratch((int)w[BLZ_UPD_HEAD + o * BLZ_UPD_OP_WORDS + BLZ_UPD_O_KIND], &wd, &by);
    words += wd;
    bytes += by;
  }
  return words * cap * 8 + bytes * blz_upd_cap_bytes(cap);
}

// One pass of atoms, a thread a row.
static cudaError_t blz_upd_atoms(const int64_t* slots, const uint8_t* mask, int64_t n,
                                 int64_t cap, const UpdAtoms& set, cudaStream_t stream) {
  blz_upd_atoms_kernel<<<(unsigned)((n + BLZ_UPD_THREADS - 1) / BLZ_UPD_THREADS), BLZ_UPD_THREADS,
                         0, stream>>>(slots, mask, n, cap, set);
  return cudaGetLastError();
}

// w: the argument words (header and ops; see the BLZ_UPD_W_* and
// BLZ_UPD_O_* indices). slots: n int64 slot ids (ids outside [0, cap)
// drop); mask: n bool bytes, the row-exists mask; perm: n int64, the rows
// sorted stably by slot (needed when an op is a float ADD; else 0). Per
// op: kind, is_float (ADD / MIN / MAX over float64), esize (FIRST's value
// bytes), the counts of validity and written-validity planes, the source
// (n values; 0 for a counting ADD; FIRST: esize-byte values; LEX: l2),
// the validity planes, the written-validity planes (FIRST), the order
// plane (FIRST, n int64), the table (cap values), the valid table (FIRST,
// LEX: has; cap bool bytes), the order table (FIRST, cap int64), two limb
// sources (LEX: l1, l0) and two limb tables (RENORM: l1 and l2 or 0; LEX:
// s1, s0). The scratch: blz_slot_update_scratch's bytes at least.
BLZ_EXPORT int blz_slot_update(const long long* w) {
  const int64_t n = w[BLZ_UPD_W_N];
  const int64_t cap = w[BLZ_UPD_W_CAP];
  const int nops = (int)w[BLZ_UPD_W_NOPS];
  const int64_t* slots = (const int64_t*)w[BLZ_UPD_W_SLOTS];
  const uint8_t* mask = (const uint8_t*)w[BLZ_UPD_W_MASK];
  const int64_t* perm = (const int64_t*)w[BLZ_UPD_W_PERM];
  uint8_t* scratch = (uint8_t*)w[BLZ_UPD_W_SCRATCH];
  const cudaStream_t stream = (cudaStream_t)w[BLZ_UPD_W_STREAM];
  if (nops < 0 || nops > BLZ_MAX_UPD_OPS || n < 0 || cap <= 0 || cap > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int64_t need = blz_slot_update_scratch(w);
  if ((need > 0 && scratch == nullptr) || w[BLZ_UPD_W_SCRATCH_BYTES] < need)
    return (int)cudaErrorInvalidValue;
  UpdAtoms p1, p2;
  UpdSlotOps p3;
  UpdFolds fold;
  p1.n = p2.n = p3.n = fold.n = 0;
  int64_t words = 0;  // the scratch's word tables so far
  int64_t nbytes = 0;
  int64_t total_words = 0;
  for (int o = 0; o < nops; ++o) {
    int wd, by;
    blz_upd_op_scratch((int)w[BLZ_UPD_HEAD + o * BLZ_UPD_OP_WORDS + BLZ_UPD_O_KIND], &wd, &by);
    total_words += wd;
  }
  long long* word_tables = (long long*)scratch;
  uint8_t* byte_tables = scratch + total_words * cap * 8;
  for (int o = 0; o < nops; ++o) {
    const long long* ow = w + BLZ_UPD_HEAD + o * BLZ_UPD_OP_WORDS;
    const int kind = (int)ow[BLZ_UPD_O_KIND];
    const bool is_float = ow[BLZ_UPD_O_FLOAT] != 0;
    const int nvalid = (int)ow[BLZ_UPD_O_NVALID];
    const int nwvalid = (int)ow[BLZ_UPD_O_NWVALID];
    const int esize = (int)ow[BLZ_UPD_O_ESIZE];
    const void* src = (const void*)ow[BLZ_UPD_O_SRC];
    void* table = (void*)ow[BLZ_UPD_O_TABLE];
    uint8_t* valid_table = (uint8_t*)ow[BLZ_UPD_O_VALID_TABLE];
    long long* order_table = (long long*)ow[BLZ_UPD_O_ORDER_TABLE];
    const long long* order = (const long long*)ow[BLZ_UPD_O_ORDER];
    const long long* limb_src0 = (const long long*)ow[BLZ_UPD_O_LIMB_SRC];
    const long long* limb_src1 = (const long long*)ow[BLZ_UPD_O_LIMB_SRC + 1];
    long long* limb_t0 = (long long*)ow[BLZ_UPD_O_LIMB_TABLE];
    long long* limb_t1 = (long long*)ow[BLZ_UPD_O_LIMB_TABLE + 1];
    const bool lex = kind == BLZ_UPD_LEXMIN || kind == BLZ_UPD_LEXMAX;
    if (kind < BLZ_UPD_ADD || kind > BLZ_UPD_LEXMAX || nvalid < 0 || nvalid > 3 ||
        nwvalid < 0 || nwvalid > 3 || table == nullptr)
      return (int)cudaErrorInvalidValue;
    if (lex && (src == nullptr || limb_src0 == nullptr || limb_src1 == nullptr ||
                limb_t0 == nullptr || limb_t1 == nullptr || valid_table == nullptr))
      return (int)cudaErrorInvalidValue;
    if (kind == BLZ_UPD_RENORM && limb_t0 == nullptr) return (int)cudaErrorInvalidValue;
    if (kind == BLZ_UPD_FIRST &&
        (src == nullptr || order == nullptr || valid_table == nullptr ||
         order_table == nullptr || !(esize == 1 || esize == 2 || esize == 4 || esize == 8)))
      return (int)cudaErrorInvalidValue;
    if ((kind == BLZ_UPD_MIN || kind == BLZ_UPD_MAX || kind == BLZ_UPD_ADD_LO32 ||
         kind == BLZ_UPD_ADD_HI32 || (kind == BLZ_UPD_ADD && is_float)) && src == nullptr)
      return (int)cudaErrorInvalidValue;
    if (kind == BLZ_UPD_ADD && is_float) {
      if (perm == nullptr) return (int)cudaErrorInvalidValue;
      UpdFoldOp& f = fold.op[fold.n++];
      f.nvalid = nvalid;
      f.src = (const double*)src;
      for (int q = 0; q < 3; ++q) f.valid[q] = (const uint8_t*)ow[BLZ_UPD_O_VALID + q];
      f.table = (long long*)table;
      continue;
    }
    int wd, by;
    blz_upd_op_scratch(kind, &wd, &by);
    long long* w0 = word_tables + words * cap;
    long long* w1 = word_tables + (words + 1) * cap;
    uint8_t* mark = byte_tables + nbytes * blz_upd_cap_bytes(cap);
    words += wd;
    nbytes += by;
    auto atom = [&](UpdAtoms& set, int red, int val, void* target, const long long* cmp) {
      UpdAtom& a = set.a[set.n++];
      a.red = red;
      a.val = val;
      a.nvalid = nvalid;
      a.is_max = kind == BLZ_UPD_LEXMAX;
      a.target = target;
      a.cmp = cmp;
      a.src = (val == BLZ_VAL_ORDER || val == BLZ_VAL_ROW) ? (const void*)order : src;
      for (int q = 0; q < 3; ++q) a.valid[q] = (const uint8_t*)ow[BLZ_UPD_O_VALID + q];
      a.l1 = limb_src0;
      a.l0 = limb_src1;
    };
    UpdSlotOp sop;
    sop.kind = kind;
    sop.esize = esize;
    sop.nwvalid = nwvalid;
    sop.is_max = kind == BLZ_UPD_LEXMAX;
    sop.t[0] = sop.t[1] = sop.t[2] = nullptr;
    sop.table = table;
    sop.valid_table = valid_table;
    sop.src = src;
    for (int q = 0; q < 3; ++q) sop.wvalid[q] = (const uint8_t*)ow[BLZ_UPD_O_WVALID + q];
    sop.mark = mark;
    sop.w0 = w0;
    sop.w1 = w1;
    switch (kind) {
      case BLZ_UPD_ADD: atom(p1, BLZ_RED_SUM, BLZ_VAL_SRC, table, nullptr); break;
      case BLZ_UPD_ADD_LO32: atom(p1, BLZ_RED_SUM, BLZ_VAL_LO32, table, nullptr); break;
      case BLZ_UPD_ADD_HI32: atom(p1, BLZ_RED_SUM, BLZ_VAL_HI32, table, nullptr); break;
      case BLZ_UPD_FLAG: atom(p1, BLZ_RED_FLAG, BLZ_VAL_ONE, table, nullptr); break;
      case BLZ_UPD_MIN:
      case BLZ_UPD_MAX:
        if (is_float)
          atom(p1, kind == BLZ_UPD_MIN ? BLZ_RED_FMIN : BLZ_RED_FMAX, BLZ_VAL_FWORD, table,
               nullptr);
        else
          atom(p1, kind == BLZ_UPD_MIN ? BLZ_RED_MIN : BLZ_RED_MAX, BLZ_VAL_SRC, table, nullptr);
        break;
      case BLZ_UPD_RENORM:
        atom(p1, BLZ_RED_FLAG, BLZ_VAL_ONE, mark, nullptr);
        sop.t[0] = (long long*)table;
        sop.t[1] = limb_t0;
        sop.t[2] = limb_t1;
        p3.op[p3.n++] = sop;
        break;
      case BLZ_UPD_FIRST:
        atom(p1, BLZ_RED_MIN, BLZ_VAL_ORDER, order_table, nullptr);
        atom(p2, BLZ_RED_UMAX, BLZ_VAL_ROW, w0, order_table);
        p3.op[p3.n++] = sop;
        break;
      default:  // LEXMIN / LEXMAX
        atom(p1, BLZ_RED_UMAX, BLZ_VAL_KEY2, w0, nullptr);
        atom(p1, BLZ_RED_FLAG, BLZ_VAL_ONE, mark, nullptr);
        atom(p2, BLZ_RED_UMAX, BLZ_VAL_KEYW, w1, w0);
        sop.t[0] = (long long*)table;
        sop.t[1] = limb_t0;
        sop.t[2] = limb_t1;
        p3.op[p3.n++] = sop;
        break;
    }
  }
  if (n == 0) return (int)cudaSuccess;
  cudaError_t err;
  if (p1.n) {
    err = blz_upd_atoms(slots, mask, n, cap, p1, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (p2.n) {
    err = blz_upd_atoms(slots, mask, n, cap, p2, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (p3.n) {
    blz_upd_slots_kernel<<<blz_blocks(cap), BLZ_THREADS, 0, stream>>>(cap, p3);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (fold.n) {
    const unsigned grid = (unsigned)((n + BLZ_FOLD_THREADS - 1) / BLZ_FOLD_THREADS);
    blz_upd_fold_kernel<<<grid, BLZ_FOLD_THREADS, 0, stream>>>(slots, mask, perm, n, cap, fold);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    blz_upd_fold_long_kernel<<<grid, BLZ_FOLD_THREADS, 0, stream>>>(slots, mask, perm, n, cap,
                                                                  fold);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}
