// K14 range_partition_ids: the range exchange's partition id of every row.
//
// Replaces blaze_tpu/core/kernels.py:_range_pids (with _lex_le_count :305
// and the key pass _key_ops_traced :255), which RangePartitioner.bucketize
// (blaze_tpu/ops/shuffle/repartitioner.py:290) runs once per map-side
// split; _range_order's stable sort by id is K5's (core/kernels.py
// range_partition_order).
//
// A row's id is the number of bound rows whose key tuple is <= its own
// (bisect_right over the B = num_partitions - 1 sampled bounds), both
// compared as K5's key pass normalises them: per key a u8 rank (0 null
// first, 1 NaN under DESC, 2 valid, 3 NaN under ASC, 4 null last) and the
// direction-adjusted value (~x for a DESC integer, 1 - x for a DESC bool,
// -x for a DESC float, 0 where the rank decides), compared with < and ==
// in the value's own type: -0.0 equals 0.0, and no value is NaN (NaN
// lives in the rank). Padding rows get B + 1.
//
// Bound on the H100: bytes. A row reads each key's data and validity and
// the exists byte once and writes a 4-byte id: 23 bytes a row for the
// sort10M map batch's two int64 keys, 0.0018 ms for its 262,144 rows. At
// that size one round of memory latency and the launch are most of the
// call, so the design keeps the row loads in flight and each compare of a
// row with a bound to a few instructions and conflict-free reads:
// - The bounds come normalised once an exchange (core/kernels.py
//   RangePack: K5's key pass and sort, then range_bound_words): one int64
//   word and one rank byte a key of a bound, key-major, in the search's
//   order (the implicit search tree level by level: node e of level L
//   holds the sorted bound at p * 2^(d-L) + 2^(d-1-L) - 1, p = e - 2^L +
//   1, d = ceil(log2(B + 1)); nodes past the B bounds have rank 5, above
//   every row). A float's word is its double's order-preserving integer
//   (-0.0 as 0.0), so every key compares as a signed int64 and == is
//   IEEE's ==. A block's staging of the table into shared memory is a
//   straight copy (each word's sign bit flipped: unsigned order).
// - A thread takes four consecutive rows and issues their loads (each
//   key's four values as 16-byte words through common.cuh's blz_load_col,
//   validity and exists as 4-byte words) before the block stages the
//   table and waits on its barrier; up to four keys are normalised after
//   it, in registers. The key count is a template parameter (1, 2, a
//   bound of 4, and the general form up to 16 keys, which normalises each
//   key as it loads it) and the table of planes travels by value
//   (__grid_constant__), so the row's words are registers with no runtime
//   index.
// - A row and a bound compare as one unsigned number, a 32-bit rank and a
//   64-bit word a key: bound <= row is the borrow out of row - bound, one
//   sub.cc/subc chain (keys past k are 0 on both sides).
// - Up to RANGE_COUNT_MAX_BOUNDS bounds (the caller's route) every row
//   counts the nodes <= it, as the reference's _lex_le_count does: no
//   branch, and every lane of a warp reads the same node (a shared-memory
//   broadcast). Past it a search of d fixed steps down the tree, the four
//   rows' searches side by side: at level L every lane reads one of the
//   level's 2^L adjacent nodes, so the reads of a level spread over the
//   banks instead of striding onto one. Over bounds in ascending order
//   the bounds <= a row are a prefix, so both give the reference's count.
//   The crossover (core/kernels.py RANGE_COUNT_MAX_BOUNDS) is 3 bounds:
//   chip_smoke.py's timing of both routes on the H100 (PERF.md row 12)
//   has the count ahead at 3 bounds on hash_sample's 102-row store
//   exchange, level at 3 on sort10M's 262,144-row batch and behind from 7
//   on, where a row's compares against every bound cost more than the
//   search's levels.
// - Past the caller's limit (core/kernels.py RANGE_SMEM_BYTES: 9 bytes a
//   key of a node) the search reads the table in global memory.
// - Ids of four full rows leave as one 16-byte store; a plane whose
//   address is not aligned to its four rows' width, and the tail of fewer
//   than four rows, take scalar loads and stores inside the same kernel.
#include "common.cuh"

#define BLZ_MAX_RANGE_KEYS 16

// the routes of a launch: count over staged bounds, search over staged
// bounds, search over the bounds in global memory
enum { BLZ_RANGE_COUNT = 0, BLZ_RANGE_SEARCH = 1, BLZ_RANGE_GLOBAL = 2 };

struct RangeKeys {
  HashCols cols;  // the key planes, each with its validity
  int kind[BLZ_MAX_RANGE_KEYS];  // BLZ_KEY_*
  int asc[BLZ_MAX_RANGE_KEYS];
  int nulls_first[BLZ_MAX_RANGE_KEYS];
};

#define BLZ_RANGE_SIGN 0x8000000000000000ull

// The order-preserving int64 of a double that is not NaN: -0.0 as 0.0,
// then a negative value's magnitude bits flipped, so that signed order is
// the double's order and equality IEEE's (core/kernels.py _range_words).
__device__ __forceinline__ long long blz_range_ordered(double d) {
  long long b = __double_as_longlong(d);
  if (b == (long long)BLZ_RANGE_SIGN) b = 0;
  return b < 0 ? b ^ 0x7FFFFFFFFFFFFFFFll : b;
}

// A row's or a node's keys as the compare takes them: each key's rank and
// its word in unsigned order (the sign bit flipped); keys past k are 0.
template <int KMAX>
struct RangeTuple {
  uint32_t rank[KMAX];
  unsigned long long word[KMAX];
};

// Key c of one existing row from its loaded lo/hi words (blz_load_col) and
// validity, as K5's key pass normalises it: rank (0 null first, 1 NaN under
// DESC, 2 valid, 3 NaN under ASC, 4 null last) and word, the word's sign
// bit flipped (unsigned order).
__device__ __forceinline__ void blz_range_key(const RangeKeys& ks, int c, uint32_t lo,
                                              uint32_t hi, bool valid, uint32_t& rank,
                                              unsigned long long& word) {
  const bool asc = ks.asc[c] != 0;
  const unsigned long long x = (unsigned long long)hi << 32 | lo;
  long long w;
  rank = 2;
  if (ks.kind[c] == BLZ_KEY_FLOAT) {
    const double d = ks.cols.size[c] == 8 ? __longlong_as_double((long long)x)
                                          : (double)__int_as_float((int)lo);
    const bool nan = d != d;
    double v = (nan || !valid) ? 0.0 : d;
    if (!asc) v = -v;
    w = blz_range_ordered(v);
    if (nan) rank = asc ? 3 : 1;
  } else if (ks.kind[c] == BLZ_KEY_BOOL) {
    const long long v = asc ? (long long)lo : 1ll - (long long)lo;
    w = valid ? v : 0;
  } else {
    long long v = ks.cols.size[c] == 8 ? (long long)x : (long long)(int32_t)lo;
    if (!asc) v = ~v;
    w = valid ? v : 0;
  }
  if (!valid) rank = ks.nulls_first[c] ? 0 : 4;
  word = (unsigned long long)w ^ BLZ_RANGE_SIGN;
}

// bound <= row: the two tuples compared as unsigned numbers, key 0's rank
// most significant, then its word, then key 1's rank...; no borrow out of
// row - bound. On the card one sub.cc/subc chain from the least
// significant word (a rank a 32-bit step, a word a 64-bit one; up to four
// keys); else word by word.
template <int KMAX>
__device__ __forceinline__ bool blz_bound_le(const RangeTuple<KMAX>& b,
                                             const RangeTuple<KMAX>& r) {
#if defined(__CUDA_ARCH__)
  uint32_t borrow;
  if constexpr (KMAX == 1) {
    asm("{\n\t.reg .u64 t;\n\t.reg .u32 s, z;\n\tmov.u32 z, 0;\n\t"
        "sub.cc.u64 t, %1, %2;\n\tsubc.cc.u32 s, %3, %4;\n\t"
        "subc.u32 %0, z, z;\n\t}"
        : "=r"(borrow)
        : "l"(r.word[0]), "l"(b.word[0]), "r"(r.rank[0]), "r"(b.rank[0]));
    return borrow == 0;
  } else if constexpr (KMAX == 2) {
    asm("{\n\t.reg .u64 t;\n\t.reg .u32 s, z;\n\tmov.u32 z, 0;\n\t"
        "sub.cc.u64 t, %1, %2;\n\tsubc.cc.u32 s, %3, %4;\n\t"
        "subc.cc.u64 t, %5, %6;\n\tsubc.cc.u32 s, %7, %8;\n\t"
        "subc.u32 %0, z, z;\n\t}"
        : "=r"(borrow)
        : "l"(r.word[1]), "l"(b.word[1]), "r"(r.rank[1]), "r"(b.rank[1]), "l"(r.word[0]),
          "l"(b.word[0]), "r"(r.rank[0]), "r"(b.rank[0]));
    return borrow == 0;
  } else if constexpr (KMAX == 4) {
    asm("{\n\t.reg .u64 t;\n\t.reg .u32 s, z;\n\tmov.u32 z, 0;\n\t"
        "sub.cc.u64 t, %1, %2;\n\tsubc.cc.u32 s, %3, %4;\n\t"
        "subc.cc.u64 t, %5, %6;\n\tsubc.cc.u32 s, %7, %8;\n\t"
        "subc.cc.u64 t, %9, %10;\n\tsubc.cc.u32 s, %11, %12;\n\t"
        "subc.cc.u64 t, %13, %14;\n\tsubc.cc.u32 s, %15, %16;\n\t"
        "subc.u32 %0, z, z;\n\t}"
        : "=r"(borrow)
        : "l"(r.word[3]), "l"(b.word[3]), "r"(r.rank[3]), "r"(b.rank[3]), "l"(r.word[2]),
          "l"(b.word[2]), "r"(r.rank[2]), "r"(b.rank[2]), "l"(r.word[1]), "l"(b.word[1]),
          "r"(r.rank[1]), "r"(b.rank[1]), "l"(r.word[0]), "l"(b.word[0]), "r"(r.rank[0]),
          "r"(b.rank[0]));
    return borrow == 0;
  }
#endif
  bool le = true;
#pragma unroll
  for (int c = KMAX - 1; c >= 0; --c) {
    le = r.word[c] > b.word[c] || (r.word[c] == b.word[c] && le);
    le = r.rank[c] > b.rank[c] || (r.rank[c] == b.rank[c] && le);
  }
  return le;
}

// Node e of the table as the compare takes it (keys past k: 0). ``bw``:
// words in unsigned order (the staged table), or the signed words of
// global memory (``FLIP``).
template <int KMAX, bool FLIP>
__device__ __forceinline__ void blz_range_node(const long long* bw, const uint8_t* br, int ne,
                                               int k, int e, RangeTuple<KMAX>& b) {
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    const bool in = c < k;
    b.rank[c] = in ? br[c * ne + e] : 0u;
    const unsigned long long w = in ? (unsigned long long)bw[c * ne + e] : 0ull;
    b.word[c] = FLIP && in ? w ^ BLZ_RANGE_SIGN : w;
  }
}

// KMAX: the keys' bound, known at compile time (1, 2, 4, or
// BLZ_MAX_RANGE_KEYS); ROUTE: BLZ_RANGE_*. ne = 2^d - 1 nodes, d levels.
template <int KMAX, int ROUTE>
__global__ void __launch_bounds__(BLZ_H_THREADS)
    blz_range_partition_kernel(const __grid_constant__ RangeKeys ks, const uint8_t* exists,
                               int64_t n, int nb, int d, const long long* bwords,
                               const uint8_t* branks, int32_t* out) {
  extern __shared__ long long smem[];
  const int k = KMAX <= 2 ? KMAX : ks.cols.k;
  const int ne = (1 << d) - 1;
  const int64_t r0 = ((int64_t)blockIdx.x * BLZ_H_THREADS + threadIdx.x) * BLZ_H_ROWS;
  const bool live = r0 < n;
  const bool full = r0 + BLZ_H_ROWS <= n;
  // up to four keys: the loads stay in flight over the staging below and
  // are normalised after it; the general form normalises each key as it
  // loads it
  constexpr bool kLate = KMAX <= 4;
  constexpr int kL = kLate ? KMAX : 1;
  uint32_t lo[kL][BLZ_H_ROWS], hi[kL][BLZ_H_ROWS], vb[kL];
  RangeTuple<KMAX> row[BLZ_H_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i)
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      row[i].rank[c] = 0u;
      row[i].word[c] = 0ull;
    }
  uint32_t ex = 0u;
  if (live) {
    ex = blz_load_flags(exists, r0, n, full);
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c >= k) break;
      if (kLate) {
        blz_load_col(ks.cols, c, r0, n, full, lo[c < kL ? c : 0], hi[c < kL ? c : 0],
                     vb[c < kL ? c : 0]);
      } else {
        blz_load_col(ks.cols, c, r0, n, full, lo[0], hi[0], vb[0]);
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i)
          blz_range_key(ks, c, lo[0][i], hi[0][i], (vb[0] >> i) & 1u, row[i].rank[c],
                        row[i].word[c]);
      }
    }
  }
  const long long* bw = bwords;
  const uint8_t* br = branks;
  if (ROUTE != BLZ_RANGE_GLOBAL) {
    long long* sw = smem;
    uint8_t* sr = (uint8_t*)(smem + (int64_t)ne * k);
    for (int t = threadIdx.x; t < ne * k; t += BLZ_H_THREADS) {
      sw[t] = (long long)((unsigned long long)bwords[t] ^ BLZ_RANGE_SIGN);
      sr[t] = branks[t];
    }
    __syncthreads();
    bw = sw;
    br = sr;
  }
  if (!live) return;
  if (kLate) {
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c >= k) break;
#pragma unroll
      for (int i = 0; i < BLZ_H_ROWS; ++i)
        blz_range_key(ks, c, lo[c < kL ? c : 0][i], hi[c < kL ? c : 0][i],
                      (vb[c < kL ? c : 0] >> i) & 1u, row[i].rank[c], row[i].word[c]);
    }
  }
  int pos[BLZ_H_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i) pos[i] = 0;
  if (ROUTE == BLZ_RANGE_COUNT) {
    for (int e = 0; e < ne; ++e) {
      RangeTuple<KMAX> b;
      blz_range_node<KMAX, false>(bw, br, ne, k, e, b);
#pragma unroll
      for (int i = 0; i < BLZ_H_ROWS; ++i) pos[i] += blz_bound_le<KMAX>(b, row[i]);
    }
  } else {
    // level L: node 2^L - 1 + (pos >> (d - L)); a bound <= the row adds
    // 2^(d-1-L) to its count
    for (int L = 0; L < d; ++L) {
#pragma unroll
      for (int i = 0; i < BLZ_H_ROWS; ++i) {
        RangeTuple<KMAX> b;
        blz_range_node<KMAX, ROUTE == BLZ_RANGE_GLOBAL>(bw, br, ne, k,
                                                        (1 << L) - 1 + (pos[i] >> (d - L)), b);
        pos[i] += (int)blz_bound_le<KMAX>(b, row[i]) << (d - 1 - L);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i) pos[i] = (ex >> i) & 1u ? pos[i] : nb + 1;
  if (full) {
    *(int4*)(out + r0) = make_int4(pos[0], pos[1], pos[2], pos[3]);
  } else {
#pragma unroll
    for (int i = 0; i < BLZ_H_ROWS; ++i)
      if (r0 + i < n) out[r0 + i] = pos[i];
  }
}

template <int KMAX>
static void blz_range_launch(int route, const RangeKeys& ks, const uint8_t* exists,
                             int64_t n, int nb, int d, const long long* bwords,
                             const uint8_t* branks, int32_t* out, cudaStream_t stream) {
  const unsigned int blocks =
      (unsigned int)((n + BLZ_H_THREADS * BLZ_H_ROWS - 1) / (BLZ_H_THREADS * BLZ_H_ROWS));
  const size_t smem =
      route == BLZ_RANGE_GLOBAL ? 0 : (size_t)ks.cols.k * (((size_t)1 << d) - 1) * 9;
  if (route == BLZ_RANGE_COUNT)
    blz_range_partition_kernel<KMAX, BLZ_RANGE_COUNT><<<blocks, BLZ_H_THREADS, smem, stream>>>(
        ks, exists, n, nb, d, bwords, branks, out);
  else if (route == BLZ_RANGE_SEARCH)
    blz_range_partition_kernel<KMAX, BLZ_RANGE_SEARCH><<<blocks, BLZ_H_THREADS, smem, stream>>>(
        ks, exists, n, nb, d, bwords, branks, out);
  else
    blz_range_partition_kernel<KMAX, BLZ_RANGE_GLOBAL><<<blocks, BLZ_H_THREADS, 0, stream>>>(
        ks, exists, n, nb, d, bwords, branks, out);
}

// w: int64 words [k, nb, n, exists, out, stream, table words, table ranks,
// route, then per key (data, validity, element bytes, kind BLZ_KEY_*, asc,
// nulls_first)]. The table (core/kernels.py range_bound_words): k * (2^d -
// 1) words and ranks, d = ceil(log2(nb + 1)), key-major in the search
// tree's level order; route BLZ_RANGE_* (the staged routes take k *
// (2^d - 1) * 9 bytes of shared memory). out: n int32 ids, 16-byte
// aligned.
BLZ_EXPORT int blz_range_partition_ids(const long long* w) {
  const int k = (int)w[0];
  const int64_t nb = w[1], n = w[2];
  const uint8_t* exists = (const uint8_t*)w[3];
  int32_t* out = (int32_t*)w[4];
  cudaStream_t stream = (cudaStream_t)w[5];
  const int route = (int)w[8];
  if (k <= 0 || k > BLZ_MAX_RANGE_KEYS || n <= 0 || nb < 0 || nb >= (1 << 26) ||
      exists == nullptr || out == nullptr || ((uintptr_t)out & 15u) != 0 ||
      (nb > 0 && (w[6] == 0 || w[7] == 0)) || route < BLZ_RANGE_COUNT ||
      route > BLZ_RANGE_GLOBAL)
    return (int)cudaErrorInvalidValue;
  RangeKeys ks;
  if (!blz_hash_cols(w + 9, k, 6, ks.cols)) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < k; ++c) {
    const long long* e = w + 9 + 6 * c;
    if (e[1] == 0 || e[3] < BLZ_KEY_BOOL || e[3] > BLZ_KEY_FLOAT) return (int)cudaErrorInvalidValue;
    ks.kind[c] = (int)e[3];
    ks.asc[c] = (int)e[4];
    ks.nulls_first[c] = (int)e[5];
  }
  int d = 0;
  while (((int64_t)1 << d) - 1 < nb) ++d;
  const long long* bwords = (const long long*)w[6];
  const uint8_t* branks = (const uint8_t*)w[7];
  if (k == 1)
    blz_range_launch<1>(route, ks, exists, n, (int)nb, d, bwords, branks, out, stream);
  else if (k == 2)
    blz_range_launch<2>(route, ks, exists, n, (int)nb, d, bwords, branks, out, stream);
  else if (k <= 4)
    blz_range_launch<4>(route, ks, exists, n, (int)nb, d, bwords, branks, out, stream);
  else
    blz_range_launch<BLZ_MAX_RANGE_KEYS>(route, ks, exists, n, (int)nb, d, bwords, branks, out,
                                         stream);
  return (int)cudaGetLastError();
}
