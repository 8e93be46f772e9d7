// K5 key sort: the key-operand pass and a stable LSD radix sort that
// returns the permutation.
//
// Replaces blaze_tpu/core/kernels.py:_key_ops (body _key_ops_traced) and
// blaze_tpu/ops/sort.py:_device_sort_indices (a stable multi-operand
// lax.sort over the operands with an iota payload).
//
// 1. blz_sort_key_operands: one thread per row writes, per sort key, the
//    u8 rank (0 null first, 1 NaN under DESC, 2 valid, 3 NaN under ASC,
//    4 null last, 6 padding row) and the direction-adjusted value (~x for
//    a DESC integer, 1 - x for a DESC bool, -x for a DESC float; 0 where
//    the rank already decides), bit for bit as the reference does.
// 2. blz_sort_bits: per operand the AND and the OR of its order-preserving
//    word over the rows to sort, so the host can skip every 8-bit digit
//    that is the same in all of them (a digit whose histogram puts every
//    row in one bucket orders nothing).
// 3. blz_radix_sort: one stable counting pass per remaining digit, least
//    significant digit of the last operand first. Each pass is a
//    per-tile digit histogram, one (digit, tile)-major exclusive scan,
//    and a scatter in which a row's place among the rows of its tile with
//    the same digit comes from __match_any_sync per warp and a per-digit
//    scan over the warps in order -- so the order within a digit is the
//    input order and the sort is stable (no atomic ever hands out an
//    output slot).
//
// Order-preserving words: an unsigned operand is its own word; a signed
// one flips its sign bit; a float folds -0.0 into +0.0 (lax.sort and
// torch.sort both treat them as equal and keep input order; raw IEEE bits
// would put -0.0 first), flips all bits of a negative value and sets the
// sign bit of a positive one, and maps every NaN to the largest word
// (torch.sort puts NaNs last, in input order). The key-operand pass never
// hands a NaN to the sort: it folds NaN into the rank.
//
// Bound on the H100: bytes. A pass reads the current permutation (4 bytes
// a row, coalesced), the operand at the permuted row (a gather, served by
// L2 at the sizes of the main path: 1M rows x 8 bytes), and writes the
// next permutation; the histogram pass re-reads the first two. Skipping
// constant digits is what keeps q67's full sort (item ASC, qty DESC over
// ~800k groups) to four passes instead of eighteen.
#include "common.cuh"

#define BLZ_MAX_SORT_KEYS 16
#define BLZ_MAX_SORT_OPS (2 * BLZ_MAX_SORT_KEYS)
#define BLZ_RADIX 256
#define BLZ_SORT_ITEMS 4
#define BLZ_SORT_TILE (BLZ_THREADS * BLZ_SORT_ITEMS)

enum { BLZ_WORD_UNSIGNED = 0, BLZ_WORD_SIGNED = 1, BLZ_WORD_FLOAT = 2 };

// -- 1. key operands ------------------------------------------------------------

struct SortKeySet {
  int k;
  const void* data[BLZ_MAX_SORT_KEYS];
  const uint8_t* valid[BLZ_MAX_SORT_KEYS];
  uint8_t* rank[BLZ_MAX_SORT_KEYS];
  void* val[BLZ_MAX_SORT_KEYS];
  int size[BLZ_MAX_SORT_KEYS];   // bytes of data (and of val; bool -> 1)
  int kind[BLZ_MAX_SORT_KEYS];   // BLZ_KEY_*
  int asc[BLZ_MAX_SORT_KEYS];
  int nulls_first[BLZ_MAX_SORT_KEYS];
};

__device__ __forceinline__ void blz_store_int(void* p, int size, int64_t i,
                                              long long v) {
  switch (size) {
    case 1: ((int8_t*)p)[i] = (int8_t)v; break;
    case 2: ((int16_t*)p)[i] = (int16_t)v; break;
    case 4: ((int32_t*)p)[i] = (int32_t)v; break;
    default: ((long long*)p)[i] = v; break;
  }
}

__global__ void blz_sort_key_operands_kernel(SortKeySet ks, const uint8_t* exists,
                                             int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool ex = exists[i] != 0;
  for (int c = 0; c < ks.k; ++c) {
    const bool valid = ex && ks.valid[c][i] != 0;
    int rank = 2;
    if (ks.kind[c] == BLZ_KEY_FLOAT) {
      if (ks.size[c] == 8) {
        const double d = ((const double*)ks.data[c])[i];
        const bool nan = d != d;
        double v = (nan || !valid) ? 0.0 : d;
        if (!ks.asc[c]) v = -v;
        ((double*)ks.val[c])[i] = v;
        if (nan) rank = ks.asc[c] ? 3 : 1;
      } else {
        const float d = ((const float*)ks.data[c])[i];
        const bool nan = d != d;
        float v = (nan || !valid) ? 0.0f : d;
        if (!ks.asc[c]) v = -v;
        ((float*)ks.val[c])[i] = v;
        if (nan) rank = ks.asc[c] ? 3 : 1;
      }
    } else if (ks.kind[c] == BLZ_KEY_BOOL) {
      uint8_t v = ((const uint8_t*)ks.data[c])[i];
      if (!ks.asc[c]) v = (uint8_t)(1 - v);
      ((uint8_t*)ks.val[c])[i] = valid ? v : 0;
    } else {
      long long v = blz_load_int(ks.data[c], ks.size[c], i);
      if (!ks.asc[c]) v = ~v;
      blz_store_int(ks.val[c], ks.size[c], i, valid ? v : 0);
    }
    if (!valid) rank = ks.nulls_first[c] ? 0 : 4;
    if (!ex) rank = 6;
    ks.rank[c][i] = (uint8_t)rank;
  }
}

// -- order-preserving words -----------------------------------------------------

struct SortOperands {
  int n;
  const void* data[BLZ_MAX_SORT_OPS];
  int size[BLZ_MAX_SORT_OPS];  // 1, 2, 4 or 8 bytes
  int kind[BLZ_MAX_SORT_OPS];  // BLZ_WORD_*
};

__device__ __forceinline__ unsigned long long blz_sort_word(const void* p,
                                                            int size, int kind,
                                                            int64_t row) {
  unsigned long long w;
  switch (size) {
    case 1: w = ((const uint8_t*)p)[row]; break;
    case 2: w = ((const uint16_t*)p)[row]; break;
    case 4: w = ((const uint32_t*)p)[row]; break;
    default: w = ((const unsigned long long*)p)[row]; break;
  }
  const unsigned long long sign = 1ull << (8 * size - 1);
  if (kind == BLZ_WORD_SIGNED) return w ^ sign;
  if (kind == BLZ_WORD_FLOAT) {
    const unsigned long long all = size == 8 ? ~0ull : (1ull << (8 * size)) - 1;
    const unsigned long long inf = size == 8 ? 0x7ff0000000000000ull : 0x7f800000ull;
    if ((w & ~sign) > inf) return all;  // NaN: last, ties in input order
    if (w == sign) w = 0;               // -0.0 sorts as +0.0
    return (w & sign) ? (~w & all) : (w | sign);
  }
  return w;
}

// -- 2. constant digits ---------------------------------------------------------

// andor[2*o] &= word, andor[2*o+1] |= word over rows [0, n) of every operand.
__global__ void blz_sort_bits_kernel(SortOperands ops, int64_t n,
                                     unsigned long long* andor) {
  const unsigned lane = threadIdx.x & 31u;
  for (int o = 0; o < ops.n; ++o) {
    unsigned long long a = ~0ull, b = 0ull;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
      const unsigned long long w = blz_sort_word(ops.data[o], ops.size[o],
                                                 ops.kind[o], i);
      a &= w;
      b |= w;
    }
    for (int off = 16; off > 0; off >>= 1) {
      a &= __shfl_xor_sync(0xffffffffu, a, off);
      b |= __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      atomicAnd(&andor[2 * o], a);
      atomicOr(&andor[2 * o + 1], b);
    }
  }
}

// -- 3. radix passes --------------------------------------------------------------

__device__ __forceinline__ int blz_pass_digit(const SortOperands& ops, int op,
                                              int shift, int64_t row) {
  return (int)((blz_sort_word(ops.data[op], ops.size[op], ops.kind[op], row) >>
                shift) & 0xffull);
}

// counts[tile * 256 + d] = rows of this tile (in the current order) whose
// digit is d. idx_in == nullptr means the identity order.
__global__ void blz_radix_hist_kernel(SortOperands ops, int op, int shift,
                                      const int32_t* idx_in, int64_t n,
                                      int32_t* counts) {
  __shared__ int hist[BLZ_RADIX];
  if (threadIdx.x < BLZ_RADIX) hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * BLZ_SORT_TILE;
  for (int j = 0; j < BLZ_SORT_ITEMS; ++j) {
    const int64_t p = base + (int64_t)j * BLZ_THREADS + threadIdx.x;
    if (p < n) {
      const int64_t row = idx_in ? idx_in[p] : p;
      atomicAdd(&hist[blz_pass_digit(ops, op, shift, row)], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < BLZ_RADIX)
    counts[(int64_t)blockIdx.x * BLZ_RADIX + threadIdx.x] = hist[threadIdx.x];
}

// In place: counts[t * 256 + d] becomes the number of rows with a smaller
// digit, plus the rows of digit d in tiles before t -- the exclusive scan
// in (digit, tile)-major order. One block of 256 threads, thread d walks
// digit d's column (coalesced across the warp at each tile).
__global__ void blz_radix_scan_kernel(int32_t* counts, int ntiles) {
  __shared__ int totals[BLZ_RADIX];
  const int d = threadIdx.x;
  int sum = 0;
  for (int t = 0; t < ntiles; ++t) sum += counts[(int64_t)t * BLZ_RADIX + d];
  totals[d] = sum;
  __syncthreads();
  if (d == 0) {
    int run = 0;
    for (int x = 0; x < BLZ_RADIX; ++x) {
      const int c = totals[x];
      totals[x] = run;
      run += c;
    }
  }
  __syncthreads();
  int run = totals[d];
  for (int t = 0; t < ntiles; ++t) {
    const int64_t at = (int64_t)t * BLZ_RADIX + d;
    const int c = counts[at];
    counts[at] = run;
    run += c;
  }
}

// Stable scatter of one digit pass: idx_out[offset of (digit, tile) + the
// row's rank among the tile's rows with that digit] = row.
__global__ void blz_radix_scatter_kernel(SortOperands ops, int op, int shift,
                                         const int32_t* idx_in, int64_t n,
                                         const int32_t* offsets,
                                         int32_t* idx_out) {
  __shared__ int warp_hist[BLZ_WARPS][BLZ_RADIX];
  __shared__ int running[BLZ_RADIX];
  __shared__ int chunk_total[BLZ_RADIX];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  if (threadIdx.x < BLZ_RADIX)
    running[threadIdx.x] = offsets[(int64_t)blockIdx.x * BLZ_RADIX + threadIdx.x];
  const int64_t base = (int64_t)blockIdx.x * BLZ_SORT_TILE;
  for (int j = 0; j < BLZ_SORT_ITEMS; ++j) {
    for (int x = threadIdx.x; x < BLZ_WARPS * BLZ_RADIX; x += BLZ_THREADS)
      (&warp_hist[0][0])[x] = 0;
    __syncthreads();
    const int64_t p = base + (int64_t)j * BLZ_THREADS + threadIdx.x;
    const bool live = p < n;
    const int32_t row = live ? (idx_in ? idx_in[p] : (int32_t)p) : 0;
    // rows past n take digit 256: a group of their own, never counted
    const int digit = live ? blz_pass_digit(ops, op, shift, row) : BLZ_RADIX;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int lane_rank = __popc(peers & lanes_below);
    if (live && lane_rank == 0) warp_hist[warp][digit] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < BLZ_RADIX) {
      int run = 0;
      for (int w = 0; w < BLZ_WARPS; ++w) {
        const int c = warp_hist[w][threadIdx.x];
        warp_hist[w][threadIdx.x] = run;
        run += c;
      }
      chunk_total[threadIdx.x] = run;
    }
    __syncthreads();
    if (live) idx_out[running[digit] + warp_hist[warp][digit] + lane_rank] = row;
    __syncthreads();
    if (threadIdx.x < BLZ_RADIX) running[threadIdx.x] += chunk_total[threadIdx.x];
  }
}

// out[p] = the sorted row at p for p < n_sort, p itself past it (rows the
// caller left out of the sort keep their place at the end).
__global__ void blz_sort_finish_kernel(const int32_t* idx, int64_t n_sort,
                                       int64_t n_total, int64_t* out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_total) return;
  out[p] = (p < n_sort && idx != nullptr) ? (int64_t)idx[p] : p;
}

static SortOperands blz_make_operands(int nops, const void* const* datas,
                                      const int* sizes, const int* kinds) {
  SortOperands ops;
  ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    ops.data[o] = datas[o];
    ops.size[o] = sizes[o];
    ops.kind[o] = kinds[o];
  }
  return ops;
}

// k sort keys of n rows: data planes (sizes[c] bytes, kinds[c] BLZ_KEY_*),
// bool validity planes, the bool row-exists plane; writes rank_out[c]
// (n bytes) and val_out[c] (n elements of sizes[c] bytes).
BLZ_EXPORT int blz_sort_key_operands(int k, const void* const* datas,
                                     const uint8_t* const* valids,
                                     const int* sizes, const int* kinds,
                                     const int* asc, const int* nulls_first,
                                     const uint8_t* exists, int64_t n,
                                     uint8_t* const* rank_out,
                                     void* const* val_out, cudaStream_t stream) {
  if (k <= 0 || k > BLZ_MAX_SORT_KEYS || n <= 0) return (int)cudaErrorInvalidValue;
  SortKeySet ks;
  ks.k = k;
  for (int c = 0; c < k; ++c) {
    ks.data[c] = datas[c];
    ks.valid[c] = valids[c];
    ks.rank[c] = rank_out[c];
    ks.val[c] = val_out[c];
    ks.size[c] = sizes[c];
    ks.kind[c] = kinds[c];
    ks.asc[c] = asc[c];
    ks.nulls_first[c] = nulls_first[c];
  }
  blz_sort_key_operands_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
      ks, exists, n);
  return (int)cudaGetLastError();
}

// andor: 2 * nops unsigned 64-bit words, (AND, OR) per operand over rows
// [0, n).
BLZ_EXPORT int blz_sort_bits(int nops, const void* const* datas,
                             const int* sizes, const int* kinds, int64_t n,
                             unsigned long long* andor, cudaStream_t stream) {
  if (nops <= 0 || nops > BLZ_MAX_SORT_OPS || n <= 0)
    return (int)cudaErrorInvalidValue;
  const SortOperands ops = blz_make_operands(nops, datas, sizes, kinds);
  for (int o = 0; o < nops; ++o) {
    cudaError_t err = cudaMemsetAsync(andor + 2 * o, 0xff, 8, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(andor + 2 * o + 1, 0, 8, stream);
    if (err != cudaSuccess) return (int)err;
  }
  unsigned int grid = blz_blocks(n);
  if (grid > 264) grid = 264;  // two waves of 132 SMs; threads loop over the rest
  blz_sort_bits_kernel<<<grid, BLZ_THREADS, 0, stream>>>(ops, n, andor);
  return (int)cudaGetLastError();
}

// Stable LSD radix sort of rows [0, n_sort) by the operands, then rows
// [n_sort, n_total) in place. npasses digit passes, pass_op[i] /
// pass_shift[i] in the order they run (least significant first).
// Scratch: idx_a, idx_b (n_sort int32 each), counts (ntiles * 256 int32,
// ntiles = ceil(n_sort / BLZ_SORT_TILE)). out: n_total int64.
BLZ_EXPORT int blz_radix_sort(int nops, const void* const* datas,
                              const int* sizes, const int* kinds,
                              int64_t n_sort, int64_t n_total, int npasses,
                              const int* pass_op, const int* pass_shift,
                              int32_t* idx_a, int32_t* idx_b, int32_t* counts,
                              int64_t* out, cudaStream_t stream) {
  if (nops <= 0 || nops > BLZ_MAX_SORT_OPS || n_sort < 0 || n_total < n_sort ||
      n_total <= 0 || n_sort > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const SortOperands ops = blz_make_operands(nops, datas, sizes, kinds);
  const int ntiles = (int)((n_sort + BLZ_SORT_TILE - 1) / BLZ_SORT_TILE);
  const int32_t* cur = nullptr;  // identity order before the first pass
  int32_t* bufs[2] = {idx_a, idx_b};
  for (int i = 0; i < npasses && n_sort > 0; ++i) {
    const int op = pass_op[i];
    const int shift = pass_shift[i];
    if (op < 0 || op >= nops || shift < 0 || shift > 56 || shift % 8 != 0 ||
        shift >= 8 * sizes[op])
      return (int)cudaErrorInvalidValue;
    int32_t* next = bufs[i & 1];
    blz_radix_hist_kernel<<<ntiles, BLZ_THREADS, 0, stream>>>(ops, op, shift, cur,
                                                             n_sort, counts);
    blz_radix_scan_kernel<<<1, BLZ_RADIX, 0, stream>>>(counts, ntiles);
    blz_radix_scatter_kernel<<<ntiles, BLZ_THREADS, 0, stream>>>(
        ops, op, shift, cur, n_sort, counts, next);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = next;
  }
  blz_sort_finish_kernel<<<blz_blocks(n_total), BLZ_THREADS, 0, stream>>>(
      cur, n_sort, n_total, out);
  return (int)cudaGetLastError();
}
