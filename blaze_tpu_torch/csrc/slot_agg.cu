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
// them (ops/agg_device.py builds the lists).
//
// Passes: (1) fill the slot tables with each op's identity; (2) one thread
// per row packs the slot (slot 0 of a key is its null; the overflow rule
// of radix_pack raises a flag the host re-plans on), marks the slot
// present and applies the ops with global 64-bit atomics — integer
// atomics are exact in any order, so the result does not depend on the
// schedule; (3) count + scan of the present flags (compact.cu); (4) one
// thread per slot writes its group to its rank: keys rebuilt from the slot
// index, states from the tables, zeros past the group count.
//
// Bound on the H100: with few groups (q01: 400 stores) the atomics of
// rows hitting the same slot serialise in L2, so contention, not bytes,
// bounds pass (2); with many slots (radix plan, up to 4M) the table fill
// and the slot scan move S * 8 bytes per table. Simple first: shared-
// memory per-block tables (privatisation) are the next step for the
// few-groups case.
#include "common.cuh"

#define BLZ_MAX_SLOT_KEYS 8
#define BLZ_MAX_OPS 24
#define BLZ_MAX_EMITS 24
#define BLZ_MAX_BUCKETS BLZ_THREADS

enum { BLZ_OP_ADD = 0, BLZ_OP_COUNT = 1, BLZ_OP_MIN = 2, BLZ_OP_MAX = 3 };
enum { BLZ_EMIT_RAW = 0, BLZ_EMIT_NONZERO = 1, BLZ_EMIT_WHERE = 2 };

struct SlotPlan {
  int k;
  const long long* key[BLZ_MAX_SLOT_KEYS];
  const uint8_t* kvalid[BLZ_MAX_SLOT_KEYS];
  long long base[BLZ_MAX_SLOT_KEYS];
  long long size[BLZ_MAX_SLOT_KEYS];
  long long stride[BLZ_MAX_SLOT_KEYS];
};

struct SlotOp {
  int kind;
  int nvalid;
  const long long* src;
  const uint8_t* valid[3];
  long long* table;
  long long mult;
  long long init;
};

struct OpSet {
  int n;
  SlotOp op[BLZ_MAX_OPS];
};

struct EmitCol {
  int kind;
  const long long* table;
  const long long* aux;
  void* out;  // int64 for RAW / WHERE, bool bytes for NONZERO
};

struct EmitSet {
  int n;
  EmitCol col[BLZ_MAX_EMITS];
};

struct KeyOut {
  long long* data[BLZ_MAX_SLOT_KEYS];
  uint8_t* valid[BLZ_MAX_SLOT_KEYS];
};

__global__ void blz_slot_init_kernel(OpSet ops, int64_t S, uint8_t* present,
                                     int* overflow, long long* brows,
                                     long long* bgroups, int nb) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) {
    present[s] = 0;
    for (int o = 0; o < ops.n; ++o) ops.op[o].table[s] = ops.op[o].init;
  }
  if (brows != nullptr && s < nb) {
    brows[s] = 0;
    bgroups[s] = 0;
  }
  if (s == 0) *overflow = 0;
}

__global__ void blz_slot_scatter_kernel(SlotPlan plan, OpSet ops,
                                        int64_t num_rows, uint8_t* present,
                                        int* overflow, long long* brows,
                                        int shift, int nb) {
  __shared__ unsigned int hist[BLZ_MAX_BUCKETS];
  if (brows != nullptr) {
    for (int j = threadIdx.x; j < nb; j += blockDim.x) hist[j] = 0;
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < num_rows) {
    long long seg = 0;
    bool fits = true;
    for (int j = 0; j < plan.k; ++j) {
      const long long d = plan.key[j][i];
      const bool v = plan.kvalid[j][i] != 0;
      const long long base = plan.base[j];
      const long long size = plan.size[j];
      // wrapping int64 arithmetic, as radix_pack's jnp int64 ops
      const unsigned long long du = (unsigned long long)d - (unsigned long long)base;
      const long long diff = (long long)du;
      long long code = v ? (long long)(du + 1ull) : 0;
      const bool infit = d >= base && diff >= 0 && diff < size - 1;
      if (v && !infit) fits = false;
      code = code < 0 ? 0 : (code > size - 1 ? size - 1 : code);
      seg += code * plan.stride[j];
    }
    if (!fits) *overflow = 1;
    present[seg] = 1;
    for (int o = 0; o < ops.n; ++o) {
      const SlotOp& op = ops.op[o];
      bool ok = true;
      for (int q = 0; q < op.nvalid; ++q) ok = ok && op.valid[q][i] != 0;
      if (!ok) continue;
      switch (op.kind) {
        case BLZ_OP_ADD:
          atomicAdd((unsigned long long*)&op.table[seg],
                    (unsigned long long)op.src[i] * (unsigned long long)op.mult);
          break;
        case BLZ_OP_COUNT:
          atomicAdd((unsigned long long*)&op.table[seg], 1ull);
          break;
        case BLZ_OP_MIN:
          atomicMin(&op.table[seg], op.src[i]);
          break;
        default:
          atomicMax(&op.table[seg], op.src[i]);
          break;
      }
    }
    if (brows != nullptr) atomicAdd(&hist[seg >> shift], 1u);
  }
  if (brows != nullptr) {
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      if (hist[j]) atomicAdd((unsigned long long*)&brows[j], (unsigned long long)hist[j]);
  }
}

__global__ void blz_slot_emit_kernel(SlotPlan plan, KeyOut ko, EmitSet es,
                                     const uint8_t* present, int64_t S,
                                     const int64_t* offs, unsigned int nb_s,
                                     int64_t out_cap, const int* overflow,
                                     int64_t* count_out, long long* bgroups,
                                     int shift) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool p = s < S && present[s] != 0;
  const int r = blz_block_rank(p, warp_sums);
  const int64_t total = offs[nb_s];
  if (p) {
    const int64_t pos = offs[blockIdx.x] + r;
    for (int j = 0; j < plan.k; ++j) {
      const long long code = (s / plan.stride[j]) % plan.size[j];
      ko.data[j][pos] = (long long)((unsigned long long)plan.base[j] +
                                    (unsigned long long)code - 1ull);
      ko.valid[j][pos] = code > 0;
    }
    for (int c = 0; c < es.n; ++c) {
      const EmitCol& e = es.col[c];
      const long long v = e.table[s];
      if (e.kind == BLZ_EMIT_NONZERO)
        ((uint8_t*)e.out)[pos] = v != 0;
      else if (e.kind == BLZ_EMIT_WHERE)
        ((long long*)e.out)[pos] = e.aux[s] != 0 ? v : 0;
      else
        ((long long*)e.out)[pos] = v;
    }
    if (bgroups != nullptr) atomicAdd((unsigned long long*)&bgroups[s >> shift], 1ull);
  }
  if (s >= total && s < out_cap) {
    for (int j = 0; j < plan.k; ++j) {
      ko.data[j][s] = 0;
      ko.valid[j][s] = 0;
    }
    for (int c = 0; c < es.n; ++c) {
      if (es.col[c].kind == BLZ_EMIT_NONZERO)
        ((uint8_t*)es.col[c].out)[s] = 0;
      else
        ((long long*)es.col[c].out)[s] = 0;
    }
  }
  if (s == 0) {
    count_out[0] = *overflow ? -1 : total;
    count_out[1] = total;
  }
}

// keys/kvalids: k planes of >= num_rows rows (int64 / bool bytes); rows
// at or past num_rows do not exist. bases/sizes/strides: the slot plan
// (sizes powers of two, S = prod(sizes)). Per op o: kind, source plane
// (unused by COUNT), op_nvalid[o] validity planes at op_valid[3*o + q],
// table (S int64 scratch), mult, init. Per emit c: kind, table, aux
// (WHERE only), out (out_cap values). present: S bytes; offs:
// blz_blocks(S) + 1 int64; overflow: 1 int; key_out/kvalid_out: k planes
// of out_cap; count_out: 2 int64, the group count (-1 when a key fell
// outside the plan) and the group count regardless.
// brows/bgroups: nb int64 each, or null for no histogram.
BLZ_EXPORT int blz_slot_agg(
    int k, const long long* const* keys, const uint8_t* const* kvalids,
    const long long* bases, const long long* sizes, const long long* strides,
    int64_t num_rows, int nops, const int* op_kind,
    const long long* const* op_src, const int* op_nvalid,
    const uint8_t* const* op_valid, long long* const* op_table,
    const long long* op_mult, const long long* op_init, int nemit,
    const int* emit_kind, const long long* const* emit_table,
    const long long* const* emit_aux, void* const* emit_out, int64_t S,
    uint8_t* present, int64_t* offs, int* overflow, int64_t out_cap,
    long long* const* key_out, uint8_t* const* kvalid_out,
    int64_t* count_out, long long* brows, long long* bgroups, int shift,
    int nb, cudaStream_t stream) {
  if (k > BLZ_MAX_SLOT_KEYS || nops > BLZ_MAX_OPS || nemit > BLZ_MAX_EMITS ||
      S <= 0 || out_cap <= 0 || nb > BLZ_MAX_BUCKETS)
    return (int)cudaErrorInvalidValue;
  SlotPlan plan;
  KeyOut ko;
  plan.k = k;
  for (int j = 0; j < k; ++j) {
    plan.key[j] = keys[j];
    plan.kvalid[j] = kvalids[j];
    plan.base[j] = bases[j];
    plan.size[j] = sizes[j];
    plan.stride[j] = strides[j];
    ko.data[j] = key_out[j];
    ko.valid[j] = kvalid_out[j];
  }
  OpSet ops;
  ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    ops.op[o].kind = op_kind[o];
    ops.op[o].nvalid = op_nvalid[o];
    ops.op[o].src = op_src[o];
    for (int q = 0; q < 3; ++q) ops.op[o].valid[q] = op_valid[3 * o + q];
    ops.op[o].table = op_table[o];
    ops.op[o].mult = op_mult[o];
    ops.op[o].init = op_init[o];
  }
  EmitSet es;
  es.n = nemit;
  for (int c = 0; c < nemit; ++c) {
    es.col[c].kind = emit_kind[c];
    es.col[c].table = emit_table[c];
    es.col[c].aux = emit_aux[c];
    es.col[c].out = emit_out[c];
  }
  const int64_t init_n = S > nb ? S : nb;
  blz_slot_init_kernel<<<blz_blocks(init_n), BLZ_THREADS, 0, stream>>>(
      ops, S, present, overflow, brows, bgroups, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (num_rows > 0) {
    blz_slot_scatter_kernel<<<blz_blocks(num_rows), BLZ_THREADS, 0, stream>>>(
        plan, ops, num_rows, present, overflow, brows, shift, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = blz_flag_offsets(present, S, offs, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t emit_n = S > out_cap ? S : out_cap;
  blz_slot_emit_kernel<<<blz_blocks(emit_n), BLZ_THREADS, 0, stream>>>(
      plan, ko, es, present, S, offs, blz_blocks(S), out_cap, overflow,
      count_out, bgroups, shift);
  return (int)cudaGetLastError();
}
