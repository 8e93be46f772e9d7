// K3 slot_agg_partial and K4 slot_agg_merge: grouped aggregation of
// integer keys into a direct-indexed slot table.
//
// K3 replaces blaze_tpu/ops/agg_device.py:_dense_partial_kernel (with
// blaze_tpu/core/kernels.py:radix_pack and radix_histogram): raw rows ->
// partial states. K4 replaces blaze_tpu/ops/agg_device.py:
// _radix_merge_kernel (with _merge_reduce): partial states -> merged
// states. Both are one program here; the Python wrapper describes the
// aggregates as a list of scatter ops and a list of emitted columns:
//   ops:   ADD   table[slot] += src * mult        (SUM, AVG sum, merged counts)
//          COUNT table[slot] += 1                  (COUNT, "has" flags)
//          MIN / MAX table[slot] = min/max(table[slot], src)
//          each applied only where the row exists and all of its (up to
//          three) validity planes hold;
//   emits: RAW table value, NONZERO (table != 0 as bool), WHERE (table
//          value where a companion count is nonzero, else 0),
// so SUM/COUNT/AVG/MIN/MAX in partial and merge mode are all spelled with
// them (ops/agg_device.py builds the lists). The wide-decimal (limb) kinds
// of _dense_partial_kernel (:1288) and _radix_merge_kernel (with
// _merge_reduce's :1339-1381) add:
//   ops:   ADD_LO32 / ADD_HI32  table[slot] += src & 0xFFFFFFFF / src >> 32
//          (arithmetic; sum2/avg2's split of an int64 source; sum3/avg3
//          add their three limbs with ADD);
//          LEXMIN / LEXMAX  the extreme l2 (signed atomicMin/atomicMax),
//          with the LEXLO op after it: the extreme low word (l1 << 32) |
//          l0 (unsigned: l1, l0 are non-negative 32-bit chunks) over the
//          rows whose l2 equals the slot's, in a second pass once every
//          l2 has landed. The reference's cascade (l2, then l1, then l0)
//          with its last two levels folded into one word; exact and
//          order-free, as every atomic here;
//   emits: LO32 / CARRY / MID / TOP, the carry renormalisation of a limb
//          sum (_limb_renorm, _limb3_renorm), and WORD_HI / WORD_LO, the
//          extreme's l1 and l0 (0 where the count is 0). Limb sums are
//          64-bit atomics (exact in any order); l0/l1 sums stay below 2^55
//          at any batch (each addend < 2^32) and l2 wraps mod 2^64 as in
//          the reference.
//
// Two designs, chosen on the host from S, the op count and the rows (no
// sync):
//   - small tables (S * ops * 8 bytes, the histogram and the present
//     flags within 96 KB of shared memory, opted in past 48 KB): each
//     block of 1,024 threads keeps private tables in shared memory,
//     starting at each op's identity, and walks its rows, every load of a
//     row issued before the row's first atomic; the lanes of a warp that
//     hit one slot (__match_any_sync) fold their values by shuffles, and
//     their lowest lane applies them with one shared-memory atomic a slot
//     an op. Then either
//       * one block (at most 65,536 row-ops: K4's merge of a few thousand
//         state rows) is the whole table: it runs the LEX second pass
//         over its rows, ranks the present slots with a block scan and
//         writes the groups, all in one launch with no global table and
//         no compaction pass; or
//       * many blocks (where the rows number 16 a slot or more: one a
//         2,048 row-ops, but a row a slot at least, at most the card's
//         fill) flush each touched slot to global tables, initialised by
//         a first launch, with one atomic a slot an op a block; the last
//         block to finish (an atomic count) ranks and writes the groups.
//         With a LEX pair a third launch makes the second pass (a private
//         low-word table a block over the rows whose l2 equals the slot's
//         final l2), and its last block writes the groups;
//   - large tables (the radix plans, up to 2^22 slots), and fewer than 16
//     rows a slot past one block's share (K4's merge of a task's ~14,000
//     state rows into 1,024 slots): global tables filled with each op's
//     identity, one thread a row applying its ops with global 64-bit
//     atomics, the LEX second pass, count + scan of the present flags
//     (compact.cu), one thread a slot writing its group.
// Integer atomics are exact in any order, so every design gives the same
// groups bit for bit, in slot order. Keys and emits are written in their
// own types (a key narrowed as a cast would, a bool emit as value != 0),
// and a validity byte for each output row.
//
// Bound on the H100: with few groups (q06: 10 categories) the rows hitting
// one slot serialise; the warp aggregation and the private tables leave
// one shared atomic a distinct slot a warp and one global atomic a slot a
// block. With many slots (radix plans) the table fill and the slot scan
// move S * 8 bytes a table.
#include "common.cuh"

// -- the flag offsets of the present slots' compaction ------------------------------
//
// blz_flag_offsets: block_offsets[b] = the set flags before block b (blocks
// of BLZ_THREADS), block_offsets[nblocks] = the total; block_offsets holds
// blz_blocks(n) + 1 int64 values.

__global__ void blz_flag_count_kernel(const uint8_t* flags, int64_t n,
                                      int64_t* block_counts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = __syncthreads_count(i < n && flags[i] != 0);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// In-place exclusive scan of offs[0, nblocks) by one block, total to
// offs[nblocks].
__global__ void blz_offsets_scan_kernel(int64_t* offs, int64_t nblocks) {
  __shared__ long long warp_sums[BLZ_WARPS];
  __shared__ long long carry;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nblocks; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < nblocks ? (long long)offs[i] : 0;
    long long incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, incl, off);
      if ((int)lane >= off) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const long long t = __shfl_up_sync(0xffffffffu, w, off);
        if ((int)lane >= off) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    incl += warp ? warp_sums[warp - 1] : 0;
    if (i < nblocks) offs[i] = (int64_t)(carry + incl - v);
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) offs[nblocks] = (int64_t)carry;
}

static cudaError_t blz_scan_block_counts(int64_t* block_offsets, int64_t nblocks,
                                         cudaStream_t stream) {
  blz_offsets_scan_kernel<<<1, BLZ_THREADS, 0, stream>>>(block_offsets,
                                                         nblocks);
  return cudaGetLastError();
}

static cudaError_t blz_flag_offsets(const uint8_t* flags, int64_t n,
                                    int64_t* block_offsets, cudaStream_t stream) {
  const unsigned int nb = blz_blocks(n);
  blz_flag_count_kernel<<<nb, BLZ_THREADS, 0, stream>>>(flags, n,
                                                         block_offsets);
  return blz_scan_block_counts(block_offsets, nb, stream);
}


#define BLZ_MAX_SLOT_KEYS 8
#define BLZ_MAX_OPS 24
#define BLZ_MAX_EMITS 24
#define BLZ_MAX_BUCKETS BLZ_THREADS
#define BLZ_SLOT_THREADS 1024
#define BLZ_SLOT_SMEM (96 * 1024)       // a block's shared tables at most (bytes)
#define BLZ_SLOT_ONE_BLOCK_WORK 65536   // rows x ops one block takes alone (K4)
#define BLZ_SLOT_BLOCK_WORK 2048        // rows x ops a block of many takes
#define BLZ_SLOT_SHARED_ROWS 16         // rows a slot at least for many private tables

enum { BLZ_OP_ADD = 0, BLZ_OP_COUNT = 1, BLZ_OP_MIN = 2, BLZ_OP_MAX = 3,
       BLZ_OP_ADD_LO32 = 4, BLZ_OP_ADD_HI32 = 5, BLZ_OP_LEXMIN = 6, BLZ_OP_LEXMAX = 7,
       BLZ_OP_LEXLO = 8 };

// the host's choice of design
enum { BLZ_SLOT_GLOBAL = 0, BLZ_SLOT_SHARED = 1, BLZ_SLOT_ONE_BLOCK = 2 };

struct SlotPlan {
  int k;
  const void* key[BLZ_MAX_SLOT_KEYS];
  const uint8_t* kvalid[BLZ_MAX_SLOT_KEYS];
  int ksize[BLZ_MAX_SLOT_KEYS];
  long long base[BLZ_MAX_SLOT_KEYS];
  long long size[BLZ_MAX_SLOT_KEYS];
  long long stride[BLZ_MAX_SLOT_KEYS];
};

struct SlotOp {
  int kind;
  int nvalid;
  const long long* src;
  const long long* src0;  // LEXLO: l0 (src is l1)
  const uint8_t* valid[3];
  long long mult;
  long long init;
};

struct OpSet {
  int n;
  SlotOp op[BLZ_MAX_OPS];
};

struct EmitCol {
  int kind;
  int table;  // op indices
  int aux;
  int aux2;
  int size;   // 0: bool (value != 0), else bytes of the integer
  void* out;
};

struct EmitSet {
  int n;
  EmitCol col[BLZ_MAX_EMITS];
};

// The outputs: key planes in their sizes with validity bytes, each row's
// validity (a group), the emits, and meta = [group count or -1 on
// overflow, group count, rows a bucket (nb), groups a bucket (nb)].
struct SlotOut {
  void* key[BLZ_MAX_SLOT_KEYS];
  int ksize[BLZ_MAX_SLOT_KEYS];
  uint8_t* kvalid[BLZ_MAX_SLOT_KEYS];
  uint8_t* valid;
  long long* meta;
  int64_t out_cap;
};

// Global scratch of the designs with more than one block: ops * S tables,
// S present bytes, flags = [overflow, blocks done].
struct SlotGlobal {
  long long* tables;
  uint8_t* present;
  int* flags;
};

__device__ __forceinline__ bool blz_slot_sum(int kind) {
  return kind == BLZ_OP_ADD || kind == BLZ_OP_COUNT || kind == BLZ_OP_ADD_LO32 ||
         kind == BLZ_OP_ADD_HI32;
}

__device__ __forceinline__ void blz_slot_store(void* p, int size, int64_t i, long long v) {
  switch (size) {
    case 0: ((uint8_t*)p)[i] = v != 0; break;
    case 1: ((int8_t*)p)[i] = (int8_t)v; break;
    case 2: ((int16_t*)p)[i] = (int16_t)v; break;
    case 4: ((int32_t*)p)[i] = (int32_t)v; break;
    default: ((long long*)p)[i] = v; break;
  }
}

__global__ void blz_slot_init_kernel(OpSet ops, int64_t S, long long* tables,
                                     uint8_t* present, int* flags, long long* meta, int nb) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) {
    present[s] = 0;
    for (int o = 0; o < ops.n; ++o) tables[o * S + s] = ops.op[o].init;
  }
  if (s < 2 * nb) meta[2 + s] = 0;
  if (s < 2) flags[s] = 0;
}

// Row i's slot (radix_pack's code; *fits false when a valid key lies
// outside the plan).
__device__ __forceinline__ long long blz_slot_of(const SlotPlan& plan, int64_t i,
                                                 bool* fits) {
  long long seg = 0;
  *fits = true;
#pragma unroll
  for (int j = 0; j < BLZ_MAX_SLOT_KEYS; ++j) {
    if (j >= plan.k) break;
    const long long d = blz_load_int(plan.key[j], plan.ksize[j], i);
    const bool v = plan.kvalid[j][i] != 0;
    const long long base = plan.base[j];
    const long long size = plan.size[j];
    // wrapping int64 arithmetic, as radix_pack's jnp int64 ops
    const unsigned long long du = (unsigned long long)d - (unsigned long long)base;
    const long long diff = (long long)du;
    long long code = v ? (long long)(du + 1ull) : 0;
    const bool infit = d >= base && diff >= 0 && diff < size - 1;
    if (v && !infit) *fits = false;
    code = code < 0 ? 0 : (code > size - 1 ? size - 1 : code);
    seg += code * plan.stride[j];
  }
  return seg;
}

__device__ __forceinline__ bool blz_slot_ok(const SlotOp& op, int64_t i) {
  bool ok = true;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (q < op.nvalid) ok = ok && op.valid[q][i] != 0;
  return ok;
}

// An op's loads for row i (its validity planes and source), issued before
// any is used so that they overlap.
struct SlotLoad {
  uint8_t g0, g1, g2;
  long long x;
};

__device__ __forceinline__ SlotLoad blz_slot_load(const SlotOp& op, int64_t i) {
  SlotLoad d;
  d.g0 = op.nvalid > 0 ? op.valid[0][i] : 1;
  d.g1 = op.nvalid > 1 ? op.valid[1][i] : 1;
  d.g2 = op.nvalid > 2 ? op.valid[2][i] : 1;
  d.x = op.kind != BLZ_OP_COUNT && op.src != nullptr ? op.src[i] : 0;
  return d;
}

// What a row adds to its slot's table of op (the op's identity where the
// row does not take part).
__device__ __forceinline__ long long blz_slot_contrib(const SlotOp& op, const SlotLoad& d,
                                                      bool live) {
  const bool ok = live && d.g0 != 0 && d.g1 != 0 && d.g2 != 0;
  switch (op.kind) {
    case BLZ_OP_ADD:
      return ok ? (long long)((unsigned long long)d.x * (unsigned long long)op.mult) : 0;
    case BLZ_OP_ADD_LO32: return ok ? d.x & 0xFFFFFFFFLL : 0;
    case BLZ_OP_ADD_HI32: return ok ? d.x >> 32 : 0;
    case BLZ_OP_COUNT: return ok ? 1 : 0;
    default: return ok ? d.x : op.init;  // MIN, MAX, LEXMIN, LEXMAX
  }
}

__device__ __forceinline__ long long blz_slot_merge(int kind, long long a, long long b) {
  if (blz_slot_sum(kind)) return (long long)((unsigned long long)a + (unsigned long long)b);
  if (kind == BLZ_OP_MIN || kind == BLZ_OP_LEXMIN) return b < a ? b : a;
  return b > a ? b : a;
}

__device__ __forceinline__ void blz_slot_apply(int kind, long long* t, long long v) {
  if (blz_slot_sum(kind))
    atomicAdd((unsigned long long*)t, (unsigned long long)v);
  else if (kind == BLZ_OP_MIN || kind == BLZ_OP_LEXMIN)
    atomicMin(t, v);
  else
    atomicMax(t, v);
}

__global__ void blz_slot_scatter_kernel(SlotPlan plan, OpSet ops, int64_t S,
                                        long long* tables, int64_t num_rows,
                                        const uint8_t* exists, uint8_t* present, int* flags,
                                        long long* brows, int shift, int nb) {
  __shared__ unsigned int hist[BLZ_MAX_BUCKETS];
  if (nb > 0) {
    for (int j = threadIdx.x; j < nb; j += blockDim.x) hist[j] = 0;
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < num_rows && (exists == nullptr || exists[i] != 0)) {
    bool fits;
    const long long seg = blz_slot_of(plan, i, &fits);
    if (!fits) flags[0] = 1;
    present[seg] = 1;
    for (int o = 0; o < ops.n; ++o) {
      const SlotOp& op = ops.op[o];
      if (op.kind == BLZ_OP_LEXLO) continue;
      const SlotLoad d = blz_slot_load(op, i);
      if (d.g0 != 0 && d.g1 != 0 && d.g2 != 0)
        blz_slot_apply(op.kind, &tables[o * S + seg], blz_slot_contrib(op, d, true));
    }
    if (nb > 0) atomicAdd(&hist[seg >> shift], 1u);
  }
  if (nb > 0) {
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      if (hist[j]) atomicAdd((unsigned long long*)&brows[j], (unsigned long long)hist[j]);
  }
}

// Second pass of a wide extreme for row i of ``slot``: the LEXLO op after
// each LEXMIN/LEXMAX op takes the extreme low word, in ``lo(o)`` (op o's
// table at the slot), of the rows whose l2 equals the slot's extreme l2,
// ``l2(o)``.
template <class L2, class Lo>
__device__ __forceinline__ void blz_slot_lex_row(const OpSet& ops, int64_t i, L2 l2, Lo lo) {
  for (int o = 0; o + 1 < ops.n; ++o) {
    const SlotOp& hi = ops.op[o];
    if (hi.kind != BLZ_OP_LEXMIN && hi.kind != BLZ_OP_LEXMAX) continue;
    const SlotOp& op = ops.op[o + 1];
    if (!blz_slot_ok(op, i) || hi.src[i] != l2(o)) continue;
    const unsigned long long w =
        ((unsigned long long)op.src[i] << 32) | (unsigned long long)op.src0[i];
    unsigned long long* t = (unsigned long long*)lo(o + 1);
    if (hi.kind == BLZ_OP_LEXMAX)
      atomicMax(t, w);
    else
      atomicMin(t, w);
  }
}

__global__ void blz_slot_lex_kernel(SlotPlan plan, OpSet ops, int64_t S, long long* tables,
                                    int64_t num_rows, const uint8_t* exists) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rows || (exists != nullptr && exists[i] == 0)) return;
  bool fits;
  const long long seg = blz_slot_of(plan, i, &fits);
  blz_slot_lex_row(ops, i, [&](int o) { return tables[o * S + seg]; },
                   [&](int o) { return &tables[o * S + seg]; });
}

// Slot s's group at output row pos: its keys rebuilt from the slot index,
// its emits from the tables (``table(o, s)``), its validity.
template <class Table>
__device__ __forceinline__ void blz_slot_write_group(const SlotPlan& plan, const SlotOut& out,
                                                     const EmitSet& es, int64_t s, int64_t pos,
                                                     Table table) {
  for (int j = 0; j < plan.k; ++j) {
    const long long code = (s / plan.stride[j]) % plan.size[j];
    blz_slot_store(out.key[j], out.ksize[j], pos,
                   (long long)((unsigned long long)plan.base[j] + (unsigned long long)code - 1ull));
    out.kvalid[j][pos] = code > 0;
  }
  for (int c = 0; c < es.n; ++c) {
    const EmitCol& e = es.col[c];
    const long long v = blz_emit_value(
        e.kind, [&](int w) { return table(w == 0 ? e.table : w == 1 ? e.aux : e.aux2, s); });
    blz_slot_store(e.out, e.size, pos, v);
  }
  out.valid[pos] = 1;
}

// Output row pos past the groups: zeros.
__device__ __forceinline__ void blz_slot_write_pad(const SlotPlan& plan, const SlotOut& out,
                                                   const EmitSet& es, int64_t pos) {
  for (int j = 0; j < plan.k; ++j) {
    blz_slot_store(out.key[j], out.ksize[j], pos, 0);
    out.kvalid[j][pos] = 0;
  }
  for (int c = 0; c < es.n; ++c) blz_slot_store(es.col[c].out, es.col[c].size, pos, 0);
  out.valid[pos] = 0;
}

__global__ void blz_slot_emit_kernel(SlotPlan plan, SlotOut out, EmitSet es, int64_t S,
                                     const long long* tables, const uint8_t* present,
                                     const int64_t* offs, unsigned int nb_s, const int* flags,
                                     int shift, int nb) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool p = s < S && present[s] != 0;
  const int r = blz_block_rank(p, warp_sums);
  const int64_t total = offs[nb_s];
  if (p) {
    blz_slot_write_group(plan, out, es, s, offs[blockIdx.x] + r,
                         [&](int o, int64_t t) { return tables[o * S + t]; });
    if (nb > 0) atomicAdd((unsigned long long*)&out.meta[2 + nb + (s >> shift)], 1ull);
  }
  if (s >= total && s < out.out_cap) blz_slot_write_pad(plan, out, es, s);
  if (s == 0) {
    out.meta[0] = flags[0] ? -1 : total;
    out.meta[1] = total;
  }
}

// The shared-memory designs' private tables: ops * S words, then the
// histogram's rows and groups (nb each) and the present bytes.
extern __shared__ long long blz_slot_sm[];

struct SlotSmem {
  long long* tab;
  unsigned* hrows;
  unsigned* hgroups;
  uint8_t* present;
};

__device__ __forceinline__ SlotSmem blz_slot_smem(int64_t S, int nops, int nb) {
  SlotSmem m;
  m.tab = blz_slot_sm;
  m.hrows = (unsigned*)(blz_slot_sm + (int64_t)nops * S);
  m.hgroups = m.hrows + nb;
  m.present = (uint8_t*)(m.hgroups + nb);
  return m;
}

// Every op's shared table at its start (sums from 0 where the block's
// tables are added into global ones, else each op's init; only the LEXLO
// tables where ``lexlo_only``), the histogram at 0, no slot present.
__device__ __forceinline__ void blz_slot_smem_init(const OpSet& ops, const SlotSmem& m,
                                                   int64_t S, int nb, bool sums_from_zero,
                                                   bool lexlo_only) {
  for (int o = 0; o < ops.n; ++o) {
    const SlotOp& op = ops.op[o];
    if (lexlo_only && op.kind != BLZ_OP_LEXLO) continue;
    const long long v = sums_from_zero && blz_slot_sum(op.kind) ? 0 : op.init;
    for (int64_t s = threadIdx.x; s < S; s += blockDim.x) m.tab[o * S + s] = v;
  }
  for (int j = threadIdx.x; j < 2 * nb; j += blockDim.x) m.hrows[j] = 0;
  for (int64_t s = threadIdx.x; s < S; s += blockDim.x) m.present[s] = 0;
}

// The LEX second pass over the block's rows into the shared low-word
// tables: ``l2(o, slot)`` is the slot's final l2 of the pair at op o.
template <class L2>
__device__ __forceinline__ void blz_slot_lex_rows(const SlotPlan& plan, const OpSet& ops,
                                                  const SlotSmem& m, int64_t S,
                                                  int64_t num_rows, const uint8_t* exists,
                                                  bool mark, L2 l2) {
  BLZ_GRID_ROWS(i, num_rows) {
    if (i >= num_rows || (exists != nullptr && exists[i] == 0)) continue;
    bool fits;
    const long long slot = blz_slot_of(plan, i, &fits);
    if (mark) m.present[slot] = 1;
    blz_slot_lex_row(ops, i, [&](int o) { return l2(o, slot); },
                     [&](int o) { return &m.tab[o * S + slot]; });
  }
}

// One block ranks the present slots (a block scan a chunk of slots) and
// writes every group, the padding, the count and the histogram's groups
// (and its rows where ``own_rows``, the one-block design's own).
template <class Table, class Present>
__device__ __forceinline__ void blz_slot_emit_block(const SlotPlan& plan, const SlotOut& out,
                                                    const EmitSet& es, int64_t S,
                                                    const SlotSmem& m, int shift, int nb,
                                                    bool overflow, bool own_rows, Table table,
                                                    Present present) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int nwarps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < nb; j += blockDim.x) m.hgroups[j] = 0;
  __syncthreads();
  int64_t total = 0;
  for (int64_t chunk = 0; chunk < S; chunk += blockDim.x) {
    const int64_t s = chunk + threadIdx.x;
    const bool p = s < S && present(s);
    const int r = blz_block_rank(p, warp_sums);
    if (p) {
      blz_slot_write_group(plan, out, es, s, total + r, table);
      if (nb > 0) atomicAdd(&m.hgroups[s >> shift], 1u);
    }
    total += warp_sums[nwarps - 1];
    __syncthreads();
  }
  for (int64_t pos = total + threadIdx.x; pos < out.out_cap; pos += blockDim.x)
    blz_slot_write_pad(plan, out, es, pos);
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    if (own_rows) out.meta[2 + j] = m.hrows[j];
    out.meta[2 + nb + j] = m.hgroups[j];
  }
  if (threadIdx.x == 0) {
    out.meta[0] = overflow ? -1 : total;
    out.meta[1] = total;
  }
}

// The shared-memory designs' first pass: private tables over the block's
// rows, lanes of a slot folded in the warp; then the one-block design
// finishes (LEX pass, emit), the other flushes its tables into g and the
// last block emits unless a LEX pass follows (blz_slot_lex_shared_kernel).
__global__ void __launch_bounds__(BLZ_SLOT_THREADS) blz_slot_shared_kernel(
    SlotPlan plan, OpSet ops, EmitSet es, SlotOut out, int64_t S, int64_t num_rows,
    const uint8_t* exists, int shift, int nb, int lex, SlotGlobal g) {
  __shared__ int overflow;
  const bool one = g.tables == nullptr;
  const SlotSmem m = blz_slot_smem(S, ops.n, nb);
  if (threadIdx.x == 0) overflow = 0;
  blz_slot_smem_init(ops, m, S, nb, !one, false);
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  BLZ_GRID_ROWS(i, num_rows) {
    const bool live = i < num_rows && (exists == nullptr || exists[i] != 0);
    const int64_t row = live ? i : 0;  // every load below is of a row that exists
    bool fits;
    const long long at = blz_slot_of(plan, row, &fits);
    // op o + 1's loads go out before op o's warp fold waits on shuffles
    SlotLoad next = ops.n > 0 ? blz_slot_load(ops.op[0], row) : SlotLoad();
    const long long slot = live ? at : -1;
    if (live) {
      if (!fits) overflow = 1;
      m.present[slot] = 1;
    }
    const unsigned peers = __match_any_sync(BLZ_FULL, slot);
    const bool leader = live && (int)lane == __ffs(peers) - 1;
    for (int o = 0; o < ops.n; ++o) {
      const SlotOp& op = ops.op[o];
      const SlotLoad d = next;
      if (o + 1 < ops.n) next = blz_slot_load(ops.op[o + 1], row);
      if (op.kind == BLZ_OP_LEXLO) continue;
      const long long v =
          blz_reduce_peers(peers, blz_slot_contrib(op, d, live),
                           [&](long long a, long long b) { return blz_slot_merge(op.kind, a, b); });
      if (leader) blz_slot_apply(op.kind, &m.tab[o * S + slot], v);
    }
    if (nb > 0 && leader) atomicAdd(&m.hrows[slot >> shift], (unsigned)__popc(peers));
  }
  __syncthreads();
  if (one) {
    if (lex) {
      blz_slot_lex_rows(plan, ops, m, S, num_rows, exists, false,
                        [&](int o, long long slot) { return m.tab[o * S + slot]; });
      __syncthreads();
    }
    blz_slot_emit_block(plan, out, es, S, m, shift, nb, overflow != 0, true,
                        [&](int o, int64_t s) { return m.tab[o * S + s]; },
                        [&](int64_t s) { return m.present[s] != 0; });
    return;
  }
  for (int64_t s = threadIdx.x; s < S; s += blockDim.x) {
    if (!m.present[s]) continue;
    g.present[s] = 1;
    for (int o = 0; o < ops.n; ++o) {
      const SlotOp& op = ops.op[o];
      const long long v = m.tab[o * S + s];
      if (op.kind != BLZ_OP_LEXLO && v != (blz_slot_sum(op.kind) ? 0 : op.init))
        blz_slot_apply(op.kind, &g.tables[o * S + s], v);
    }
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x)
    if (m.hrows[j]) atomicAdd((unsigned long long*)&out.meta[2 + j], (unsigned long long)m.hrows[j]);
  if (threadIdx.x == 0 && overflow) atomicOr(&g.flags[0], 1);
  if (lex || !blz_last_block(&g.flags[1])) return;
  blz_slot_emit_block(plan, out, es, S, m, shift, nb, __ldcg(&g.flags[0]) != 0, false,
                      [&](int o, int64_t s) { return __ldcg(&g.tables[o * S + s]); },
                      [&](int64_t s) { return __ldcg(&g.present[s]) != 0; });
}

// The LEX second pass of the many-block shared design: private low-word
// tables over the rows whose l2 equals the slot's final l2 in g, flushed
// a touched slot a block; the last block writes the groups.
__global__ void __launch_bounds__(BLZ_SLOT_THREADS) blz_slot_lex_shared_kernel(
    SlotPlan plan, OpSet ops, EmitSet es, SlotOut out, int64_t S, int64_t num_rows,
    const uint8_t* exists, int shift, int nb, SlotGlobal g) {
  const SlotSmem m = blz_slot_smem(S, ops.n, nb);
  blz_slot_smem_init(ops, m, S, nb, false, true);
  __syncthreads();
  blz_slot_lex_rows(plan, ops, m, S, num_rows, exists, true,
                    [&](int o, long long slot) { return g.tables[o * S + slot]; });
  __syncthreads();
  for (int64_t s = threadIdx.x; s < S; s += blockDim.x) {
    if (!m.present[s]) continue;
    for (int o = 1; o < ops.n; ++o) {
      const SlotOp& op = ops.op[o];
      if (op.kind != BLZ_OP_LEXLO || m.tab[o * S + s] == op.init) continue;
      unsigned long long* t = (unsigned long long*)&g.tables[o * S + s];
      if (ops.op[o - 1].kind == BLZ_OP_LEXMAX)
        atomicMax(t, (unsigned long long)m.tab[o * S + s]);
      else
        atomicMin(t, (unsigned long long)m.tab[o * S + s]);
    }
  }
  if (!blz_last_block(&g.flags[1])) return;
  blz_slot_emit_block(plan, out, es, S, m, shift, nb, __ldcg(&g.flags[0]) != 0, false,
                      [&](int o, int64_t s) { return __ldcg(&g.tables[o * S + s]); },
                      [&](int64_t s) { return __ldcg(&g.present[s]) != 0; });
}

static inline int64_t blz_slot_smem_bytes(int64_t S, int nops, int nb) {
  return S * nops * 8 + 8 * (int64_t)nb + ((S + 7) & ~(int64_t)7);
}

// Private tables in shared memory where they fit: one block for a few
// thousand row-ops, many where the rows outnumber the slots enough that a
// block's flush (an atomic a slot an op) costs less than its rows' own
// atomics would; global tables otherwise.
static int blz_slot_design(int64_t S, int nops, int64_t num_rows, int nb) {
  if (blz_slot_smem_bytes(S, nops, nb) > BLZ_SLOT_SMEM) return BLZ_SLOT_GLOBAL;
  if (num_rows * (nops > 0 ? nops : 1) <= BLZ_SLOT_ONE_BLOCK_WORK) return BLZ_SLOT_ONE_BLOCK;
  return num_rows >= BLZ_SLOT_SHARED_ROWS * S ? BLZ_SLOT_SHARED : BLZ_SLOT_GLOBAL;
}

// The int64 words of scratch blz_slot_agg takes (0: none).
BLZ_EXPORT int64_t blz_slot_agg_scratch(int64_t S, int nops, int64_t num_rows, int nb) {
  const int design = blz_slot_design(S, nops, num_rows, nb);
  if (design == BLZ_SLOT_ONE_BLOCK) return 0;
  const int64_t words = nops * S + (S + 7) / 8 + 1;
  return design == BLZ_SLOT_GLOBAL ? words + blz_blocks(S) + 1 : words;
}

// The blocks of the many-block shared design: one a BLZ_SLOT_BLOCK_WORK
// row-ops, but a row a slot at least each (a block's flush is an atomic a
// slot an op), at most as many as the card holds.
static unsigned blz_slot_shared_grid(int64_t num_rows, int64_t S, int nops, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, blz_slot_shared_kernel,
                                                BLZ_SLOT_THREADS, smem);
  const int64_t most = (int64_t)(sms > 0 ? sms : 1) * (per > 0 ? per : 1);
  const int64_t work = num_rows * (nops > 0 ? nops : 1);
  int64_t want = (work + BLZ_SLOT_BLOCK_WORK - 1) / BLZ_SLOT_BLOCK_WORK;
  if (want > num_rows / S) want = num_rows / S;
  return (unsigned)(want < 1 ? 1 : want < most ? want : most);
}

// keys/kvalids: k planes of >= num_rows rows (key_size bytes a key:
// 1/2/4/8 signed; bool bytes) ; rows at or past num_rows do not exist,
// nor, where ``exists`` is given (bool bytes, K18's live mask of a fused
// aggregate), rows whose byte is 0: they mark no slot, apply no op and
// count in no radix bucket. bases/sizes/strides: the slot plan (sizes
// powers of two, S = prod(sizes)). Per op o: kind, source plane (unused by
// COUNT), second source (LEXLO's l0, else null), op_nvalid[o] validity
// planes at op_valid[3*o + q], mult, init; a LEXMIN/LEXMAX op is followed
// by its LEXLO op. Per emit c: kind, table, aux (WHERE, CARRY, MID, TOP,
// WORD_*) and aux2 (TOP) as op indices, its size (0 bool, else bytes) and
// out (out_cap values). key_out: k planes of out_cap keys of out_ksize
// bytes; kvalid_out: k planes of out_cap bytes; valid_out: out_cap bytes,
// 1 for a group; meta: 2 + 2 * nb int64: the group count (-1 when a key
// fell outside the plan), the group count regardless, then rows and
// groups a radix bucket (nb of them, or none). scratch: the words
// blz_slot_agg_scratch gives (may be null when it gives 0).
BLZ_EXPORT int blz_slot_agg(
    int k, const void* const* keys, const uint8_t* const* kvalids, const int* key_size,
    const long long* bases, const long long* sizes, const long long* strides,
    int64_t num_rows, const uint8_t* exists, int nops, const int* op_kind,
    const long long* const* op_src, const long long* const* op_src0,
    const int* op_nvalid, const uint8_t* const* op_valid,
    const long long* op_mult, const long long* op_init, int nemit,
    const int* emit_kind, const int* emit_table, const int* emit_aux, const int* emit_aux2,
    const int* emit_size, void* const* emit_out, int64_t S, int64_t out_cap,
    void* const* key_out, const int* out_ksize, uint8_t* const* kvalid_out,
    uint8_t* valid_out, int64_t* meta, int shift, int nb, int64_t* scratch,
    int64_t scratch_words, cudaStream_t stream) {
  if (k > BLZ_MAX_SLOT_KEYS || nops < 0 || nops > BLZ_MAX_OPS || nemit > BLZ_MAX_EMITS ||
      S <= 0 || out_cap <= 0 || nb > BLZ_MAX_BUCKETS || nb < 0)
    return (int)cudaErrorInvalidValue;
  const int design = blz_slot_design(S, nops, num_rows, nb);
  const int64_t need = blz_slot_agg_scratch(S, nops, num_rows, nb);
  if (need > 0 && (scratch == nullptr || scratch_words < need))
    return (int)cudaErrorInvalidValue;
  SlotPlan plan;
  SlotOut out;
  plan.k = k;
  for (int j = 0; j < k; ++j) {
    plan.key[j] = keys[j];
    plan.kvalid[j] = kvalids[j];
    plan.ksize[j] = key_size[j];
    plan.base[j] = bases[j];
    plan.size[j] = sizes[j];
    plan.stride[j] = strides[j];
    out.key[j] = key_out[j];
    out.ksize[j] = out_ksize[j];
    out.kvalid[j] = kvalid_out[j];
  }
  out.valid = valid_out;
  out.meta = (long long*)meta;
  out.out_cap = out_cap;
  OpSet ops;
  ops.n = nops;
  bool lex = false;
  for (int o = 0; o < nops; ++o) {
    const int kd = op_kind[o];
    // a LEXMIN/LEXMAX op reads the op after it (core/kernels.py
    // check_limb_program holds the pairing); here only that its planes exist
    if (kd == BLZ_OP_LEXMIN || kd == BLZ_OP_LEXMAX) {
      if (o + 1 >= nops || op_src[o + 1] == nullptr || op_src0[o + 1] == nullptr)
        return (int)cudaErrorInvalidValue;
      lex = true;
    }
    ops.op[o].kind = kd;
    ops.op[o].nvalid = op_nvalid[o];
    ops.op[o].src = op_src[o];
    ops.op[o].src0 = op_src0[o];
    for (int q = 0; q < 3; ++q) ops.op[o].valid[q] = op_valid[3 * o + q];
    ops.op[o].mult = op_mult[o];
    ops.op[o].init = op_init[o];
  }
  EmitSet es;
  es.n = nemit;
  for (int c = 0; c < nemit; ++c) {
    const int kd = emit_kind[c];
    const bool uses_aux = kd == BLZ_EMIT_WHERE || kd >= BLZ_EMIT_CARRY;
    if (emit_table[c] < 0 || emit_table[c] >= nops ||
        (uses_aux && (emit_aux[c] < 0 || emit_aux[c] >= nops)) ||
        (kd == BLZ_EMIT_TOP && (emit_aux2[c] < 0 || emit_aux2[c] >= nops)))
      return (int)cudaErrorInvalidValue;
    es.col[c].kind = kd;
    es.col[c].table = emit_table[c];
    es.col[c].aux = emit_aux[c];
    es.col[c].aux2 = emit_aux2[c];
    es.col[c].size = emit_size[c];
    es.col[c].out = emit_out[c];
  }
  SlotGlobal g;
  g.tables = (long long*)scratch;
  g.present = (uint8_t*)(scratch + nops * S);
  g.flags = (int*)(scratch + nops * S + (S + 7) / 8);
  cudaError_t err;
  if (design != BLZ_SLOT_GLOBAL) {
    const int smem = (int)blz_slot_smem_bytes(S, nops, nb);
    if (smem > 48 * 1024) {
      static bool opted = false;  // once a process: the budget, not this call's bytes
      if (!opted) {
        err = cudaFuncSetAttribute(blz_slot_shared_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, BLZ_SLOT_SMEM);
        if (err == cudaSuccess)
          err = cudaFuncSetAttribute(blz_slot_lex_shared_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, BLZ_SLOT_SMEM);
        if (err != cudaSuccess) return (int)err;
        opted = true;
      }
    }
    if (design == BLZ_SLOT_ONE_BLOCK) {
      g.tables = nullptr;
      blz_slot_shared_kernel<<<1, BLZ_SLOT_THREADS, smem, stream>>>(
          plan, ops, es, out, S, num_rows, exists, shift, nb, lex, g);
      return (int)cudaGetLastError();
    }
    blz_slot_init_kernel<<<blz_blocks(S > 2 * nb ? S : 2 * nb), BLZ_THREADS, 0, stream>>>(
        ops, S, g.tables, g.present, g.flags, out.meta, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = blz_slot_shared_grid(num_rows, S, nops, smem);
    blz_slot_shared_kernel<<<grid, BLZ_SLOT_THREADS, smem, stream>>>(
        plan, ops, es, out, S, num_rows, exists, shift, nb, lex, g);
    err = cudaGetLastError();
    if (err != cudaSuccess || !lex) return (int)err;
    blz_slot_lex_shared_kernel<<<grid, BLZ_SLOT_THREADS, smem, stream>>>(
        plan, ops, es, out, S, num_rows, exists, shift, nb, g);
    return (int)cudaGetLastError();
  }
  int64_t* offs = scratch + nops * S + (S + 7) / 8 + 1;
  blz_slot_init_kernel<<<blz_blocks(S > 2 * nb ? S : 2 * nb), BLZ_THREADS, 0, stream>>>(
      ops, S, g.tables, g.present, g.flags, out.meta, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (num_rows > 0) {
    blz_slot_scatter_kernel<<<blz_blocks(num_rows), BLZ_THREADS, 0, stream>>>(
        plan, ops, S, g.tables, num_rows, exists, g.present, g.flags, out.meta + 2, shift, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (lex) {
      blz_slot_lex_kernel<<<blz_blocks(num_rows), BLZ_THREADS, 0, stream>>>(
          plan, ops, S, g.tables, num_rows, exists);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  err = blz_flag_offsets(g.present, S, offs, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t emit_n = S > out_cap ? S : out_cap;
  blz_slot_emit_kernel<<<blz_blocks(emit_n), BLZ_THREADS, 0, stream>>>(
      plan, out, es, S, g.tables, g.present, offs, blz_blocks(S), g.flags, shift, nb);
  return (int)cudaGetLastError();
}
