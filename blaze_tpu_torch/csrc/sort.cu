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
// 2. blz_radix_sort: one cooperative launch does the whole sort (see
//    blz_radix_sort_kernel): every digit's histogram up front, the passes
//    chosen on the device (a digit that puts every row in one bucket
//    orders nothing), then one stable counting pass per chosen digit,
//    least significant digit of the last operand first, each a decoupled
//    look-back scan over 2048-row tiles and a scatter in which a row's
//    place among its tile's rows of the same digit comes from
//    __match_any_sync and warp-private counts, in row order -- so the
//    sort is stable (no atomic ever hands out an output slot). No host
//    synchronisation: the wrapper passes the digits that may vary (an
//    operand's known width), the kernel drops the constant ones. Where
//    the caller says the first operand is the key pass's rank plane, rows
//    of rank 6 (padding, or a fused aggregate's dead rows) go to the end
//    in row order and take no part in the later passes.
//
// Order-preserving words: an unsigned operand is its own word; a signed
// one flips its sign bit; a float folds -0.0 into +0.0 (lax.sort and
// torch.sort both treat them as equal and keep input order; raw IEEE bits
// would put -0.0 first), flips all bits of a negative value and sets the
// sign bit of a positive one, and maps every NaN to the largest word
// (torch.sort puts NaNs last, in input order). The key-operand pass never
// hands a NaN to the sort: it folds NaN into the rank.
//
// Bound on the H100: bytes. The histogram sweep reads every operand once;
// a pass reads the permutation and the operand through it and writes the
// next permutation. Skipping constant digits is what keeps q67's full
// sort (item ASC, qty DESC over ~800k groups) to four passes instead of
// eighteen.
#include "common.cuh"

#define BLZ_MAX_SORT_KEYS 16
#define BLZ_MAX_SORT_OPS (2 * BLZ_MAX_SORT_KEYS)

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

// -- 2. the radix sort: one persistent launch -----------------------------------

#define BLZ_RS_THREADS 256
#define BLZ_RS_WARPS (BLZ_RS_THREADS / 32)
#define BLZ_RS_ITEMS 8
#define BLZ_RS_TILE (BLZ_RS_THREADS * BLZ_RS_ITEMS)  // 2048 rows a tile
#define BLZ_RS_BINS 257                              // 256 digits + the dead rows
#define BLZ_RS_DEAD 256
#define BLZ_RS_NONE 257                              // a lane past the rows
#define BLZ_RS_MAX_DIGITS (BLZ_MAX_SORT_OPS * 8)
#define BLZ_RS_CHUNK 32                              // digits a histogram sweep

struct RadixArgs {
  SortOperands ops;
  int ndigits;                                 // digits that may vary, LSD first
  unsigned char dop[BLZ_RS_MAX_DIGITS];        // digit i's operand
  unsigned char dshift[BLZ_RS_MAX_DIGITS];     // and its bit shift
  int dead_last;                               // rank 6 in operand 0: the tail
  int64_t n_sort, n_total;
  int32_t* idx[2];                             // the permutation, ping-pong
  unsigned long long* status;                  // look-back words, ntiles x 257
  unsigned int* bar;                           // the grid barrier's arrivals
  unsigned int* ctrl;                          // dead rows, then the histograms
  int64_t* out;
  int64_t* hist_out;                           // digit 0's 256 counts, or null
  unsigned long long* trace;                   // phase stamps of block 0, or null
};

// %globaltimer (ns) into a.trace[i] from block 0's thread 0, and into
// a.trace[32 + i] from the last block's: where the launch's time goes
// (measurement only). i: 0 start, 12 look-back words zeroed, 13 rows
// histogrammed, 1 histograms flushed, 2 past the first barrier; pass 0's
// tile ranked 14 and looked back 15; pass r's tiles scattered 4 + 2r and
// past its barrier 5 + 2r; 3 every pass done; 31 (last block) or 63 end.
__device__ __forceinline__ void blz_rs_stamp(const RadixArgs& a, int i) {
  // block 0 at i, the last block at 32 + i
  const bool last = blockIdx.x == gridDim.x - 1 && gridDim.x > 1;
  if (last) i += 32;
  if (a.trace != nullptr && (blockIdx.x == 0 || last) && threadIdx.x == 0 && i < 64) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    a.trace[i] = ns;
  }
}

__device__ __forceinline__ unsigned long long blz_op_word(const SortOperands& ops,
                                                          int o, int64_t row) {
  return blz_sort_word(ops.data[o], ops.size[o], ops.kind[o], row);
}

// Every block of the (cooperatively launched, so co-resident) grid waits
// here until all have arrived; ``target`` counts the arrivals so far.
__device__ __forceinline__ void blz_grid_sync(unsigned int* bar, unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*(volatile unsigned int*)bar < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// Stable LSD radix sort of rows [0, n_sort), 8-bit digits, in one launch:
//  0. the look-back words are zeroed, and one sweep over the rows builds
//     the histogram of every digit that may vary (and counts the dead
//     rows: rank 6 in the first operand, when ``dead_last``). A warp
//     reads its 256 rows' words of an operand at once; a digit that all
//     its live rows share is one atomic, the others a __match_any_sync;
//  1. each block reads the histograms and keeps the digits whose rows do
//     not all fall in one bin -- the passes, decided on the device;
//  2. each pass walks 2048-row tiles. A warp ranks its 256 contiguous rows
//     among their digit with __match_any_sync and a warp-private count, so
//     the block synchronises twice a tile; the tile's offset for each
//     digit comes from a decoupled look-back over the earlier tiles'
//     published counts (Merrill and Garland's single-pass scan, as
//     onesweep uses it; 4 tiles' words a round, independent loads)
//     added to the digit's base from step 0's histogram. The first pass
//     reads rows in order and sends dead rows to a 257th bucket after
//     every live row; later passes sort only the live rows, each reading
//     its operand through the permutation;
//  3. the int64 permutation: the sorted live rows, the dead rows in row
//     order, then rows [n_sort, n_total) in place.
// A grid barrier separates the steps and the passes. The look-back words,
// the histograms and the dead-row count live in ``out`` until step 3
// overwrites it, so the scratch is the two int32 permutations and the
// barrier's word (the caller's three allocations).
__global__ void __launch_bounds__(BLZ_RS_THREADS)
blz_radix_sort_kernel(RadixArgs a) {
  __shared__ unsigned int smem[BLZ_RS_CHUNK * 256];  // step 0's histograms, then whist
  __shared__ int s_base[BLZ_RS_BINS];
  __shared__ int s_off[BLZ_RS_BINS];
  __shared__ int s_wsum[BLZ_RS_WARPS];
  __shared__ unsigned char s_trivial[BLZ_RS_MAX_DIGITS];
  __shared__ short s_run[BLZ_RS_MAX_DIGITS];
  __shared__ int s_nrun;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t m = a.n_sort;
  const int64_t stride = (int64_t)gridDim.x * BLZ_RS_THREADS;
  const int64_t gtid = (int64_t)blockIdx.x * BLZ_RS_THREADS + threadIdx.x;
  unsigned int* bar = a.bar;
  unsigned int* hist = a.ctrl + 1;
  unsigned int target = 0;
  const uint8_t* rank0 = (const uint8_t*)a.ops.data[0];

  blz_rs_stamp(a, 0);
  // -- 0. zero the look-back words; every digit's histogram; the dead rows
  const int64_t ntiles_all = (m + BLZ_RS_TILE - 1) / BLZ_RS_TILE;
  for (int64_t i = gtid; i < ntiles_all * BLZ_RS_BINS; i += stride) a.status[i] = 0ull;
  blz_rs_stamp(a, 12);
  unsigned dead_warp = 0;
  for (int c0 = 0; c0 < a.ndigits; c0 += BLZ_RS_CHUNK) {
    const int nc = a.ndigits - c0 < BLZ_RS_CHUNK ? a.ndigits - c0 : BLZ_RS_CHUNK;
    for (int x = threadIdx.x; x < nc * 256; x += BLZ_RS_THREADS) smem[x] = 0;
    __syncthreads();
    for (int64_t t = blockIdx.x; t < ntiles_all; t += gridDim.x) {
      const int64_t base = t * BLZ_RS_TILE + (int64_t)warp * (32 * BLZ_RS_ITEMS);
      bool livek[BLZ_RS_ITEMS];
      unsigned nlive = 0;
#pragma unroll
      for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
        const int64_t row = base + j * 32 + lane;
        const bool ok = row < m;
        const bool dead = ok && a.dead_last && rank0[row] == 6;
        livek[j] = ok && !dead;
        nlive += __popc(__ballot_sync(BLZ_FULL, livek[j]));
        if (c0 == 0) dead_warp += __popc(__ballot_sync(BLZ_FULL, dead));
      }
      if (nlive == 0) continue;  // uniform over the warp
      int wo = -1;
      unsigned long long wk[BLZ_RS_ITEMS], all_and = 0ull, differ = 0ull;
      for (int c = 0; c < nc; ++c) {
        const int d = c0 + c;
        const int o = a.dop[d];
        if (o != wo) {  // the operand's words of the warp's rows, loaded together
          wo = o;
#pragma unroll
          for (int j = 0; j < BLZ_RS_ITEMS; ++j)
            wk[j] = livek[j] ? blz_op_word(a.ops, o, base + j * 32 + lane) : 0ull;
          unsigned long long w_and = ~0ull, w_or = 0ull;
#pragma unroll
          for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
            if (livek[j]) {
              w_and &= wk[j];
              w_or |= wk[j];
            }
          }
          const unsigned lo_and = __reduce_and_sync(BLZ_FULL, (unsigned)w_and);
          const unsigned hi_and = __reduce_and_sync(BLZ_FULL, (unsigned)(w_and >> 32));
          const unsigned lo_or = __reduce_or_sync(BLZ_FULL, (unsigned)w_or);
          const unsigned hi_or = __reduce_or_sync(BLZ_FULL, (unsigned)(w_or >> 32));
          all_and = ((unsigned long long)hi_and << 32) | lo_and;
          differ = all_and ^ (((unsigned long long)hi_or << 32) | lo_or);
        }
        const int shift = a.dshift[d];
        if (((differ >> shift) & 0xffull) == 0ull) {  // one bin for the warp's rows
          if (lane == 0) atomicAdd(&smem[c * 256 + (int)((all_and >> shift) & 0xffull)], nlive);
          continue;
        }
#pragma unroll
        for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
          const int b = livek[j] ? (int)((wk[j] >> shift) & 0xffull) : BLZ_RS_NONE;
          const unsigned peers = __match_any_sync(BLZ_FULL, b);
          if (b != BLZ_RS_NONE && (peers & below) == 0)
            atomicAdd(&smem[c * 256 + b], (unsigned)__popc(peers));
        }
      }
    }
    __syncthreads();
    blz_rs_stamp(a, 13);
    for (int x = threadIdx.x; x < nc * 256; x += BLZ_RS_THREADS)
      if (smem[x]) atomicAdd(&hist[c0 * 256 + x], smem[x]);
    __syncthreads();
  }
  if (lane == 0 && dead_warp) atomicAdd(&a.ctrl[0], dead_warp);
  blz_rs_stamp(a, 1);
  blz_grid_sync(bar, target);
  blz_rs_stamp(a, 2);

  // -- 1. the passes: digits whose live rows do not all share one bin
  const int64_t live = m - (int64_t)__ldcg(&a.ctrl[0]);
  for (int d = warp; d < a.ndigits; d += BLZ_RS_WARPS) {
    bool full = live == 0;
    for (int b = lane; b < 256; b += 32) full |= (int64_t)__ldcg(&hist[d * 256 + b]) == live;
    full = __any_sync(BLZ_FULL, full);
    if (lane == 0) s_trivial[d] = full;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nrun = 0;
    for (int d = 0; d < a.ndigits; ++d)
      if (!s_trivial[d]) s_run[nrun++] = (short)d;
    // dead rows among live ones: the first pass is also the compaction
    if (nrun == 0 && live > 0 && live < m && a.ndigits > 0) s_run[nrun++] = 0;
    s_nrun = nrun;
  }
  __syncthreads();
  const int nrun = s_nrun;
  if (a.hist_out != nullptr && blockIdx.x == 0)
    for (int b = threadIdx.x; b < 256; b += BLZ_RS_THREADS)
      a.hist_out[b] = a.ndigits > 0 ? (int64_t)__ldcg(&hist[b]) : (b == 0 ? live : 0);

  // -- 2. the digit passes
  int* whist = (int*)smem;  // [BLZ_RS_WARPS][BLZ_RS_BINS]
  for (int r = 0; r < nrun; ++r) {
    const int d = s_run[r];
    const int o = a.dop[d];
    const int shift = a.dshift[d];
    const bool first = r == 0;
    const int64_t n_in = first ? m : live;
    const int32_t* in_idx = a.idx[r & 1];
    int32_t* out_idx = a.idx[(r + 1) & 1];
    const unsigned long long tag = (unsigned long long)(r + 1);
    {  // the digit's base: an exclusive scan of its histogram, dead rows last
      const int v = (int)__ldcg(&hist[d * 256 + threadIdx.x]);
      int x = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(BLZ_FULL, x, off);
        if ((int)lane >= off) x += y;
      }
      if (lane == 31) s_wsum[warp] = x;
      __syncthreads();
      int before = 0;
      for (unsigned w = 0; w < warp; ++w) before += s_wsum[w];
      s_base[threadIdx.x] = before + x - v;
      if (threadIdx.x == 0) s_base[BLZ_RS_DEAD] = (int)live;
    }
    const int64_t ntiles = (n_in + BLZ_RS_TILE - 1) / BLZ_RS_TILE;
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      __syncthreads();
      for (int x = threadIdx.x; x < BLZ_RS_WARPS * BLZ_RS_BINS; x += BLZ_RS_THREADS)
        whist[x] = 0;
      __syncthreads();
      int rk[BLZ_RS_ITEMS], bk[BLZ_RS_ITEMS];
      int32_t rowk[BLZ_RS_ITEMS];
      unsigned long long wk[BLZ_RS_ITEMS];
      bool deadk[BLZ_RS_ITEMS];
      const int64_t base = t * BLZ_RS_TILE + (int64_t)warp * (32 * BLZ_RS_ITEMS);
      // every load of the tile first, so they are in flight together: the
      // permutation, then the words it points at
#pragma unroll
      for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
        const int64_t p = base + j * 32 + lane;
        rowk[j] = p < n_in ? (first ? (int32_t)p : __ldcg(&in_idx[p])) : 0;
      }
#pragma unroll
      for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
        const bool ok = base + j * 32 + lane < n_in;
        deadk[j] = ok && first && a.dead_last && rank0[rowk[j]] == 6;
        wk[j] = ok && !deadk[j] ? blz_op_word(a.ops, o, rowk[j]) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
        const bool ok = base + j * 32 + lane < n_in;
        const int b = !ok ? BLZ_RS_NONE
                          : (deadk[j] ? BLZ_RS_DEAD : (int)((wk[j] >> shift) & 0xffull));
        const unsigned peers = __match_any_sync(BLZ_FULL, b);
        const int seen = b != BLZ_RS_NONE ? whist[warp * BLZ_RS_BINS + b] : 0;
        __syncwarp();
        if (b != BLZ_RS_NONE && (peers & below) == 0)
          whist[warp * BLZ_RS_BINS + b] = seen + __popc(peers);
        __syncwarp();
        rk[j] = seen + __popc(peers & below);
        bk[j] = b;
      }
      __syncthreads();
      if (r == 0) blz_rs_stamp(a, 14);
      for (int b = threadIdx.x; b < BLZ_RS_BINS; b += BLZ_RS_THREADS) {
        int run = 0;
        for (int w = 0; w < BLZ_RS_WARPS; ++w) {
          const int c = whist[w * BLZ_RS_BINS + b];
          whist[w * BLZ_RS_BINS + b] = run;
          run += c;
        }
        // look back over the earlier tiles' counts of this bin (common.cuh)
        const unsigned int excl =
            blz_look_back(a.status + b, BLZ_RS_BINS, t, tag, (unsigned int)run);
        s_off[b] = s_base[b] + (int)excl;
      }
      __syncthreads();
      if (r == 0) blz_rs_stamp(a, 15);
#pragma unroll
      for (int j = 0; j < BLZ_RS_ITEMS; ++j) {
        const int b = bk[j];
        if (b == BLZ_RS_NONE) continue;
        out_idx[(int64_t)s_off[b] + whist[warp * BLZ_RS_BINS + b] + rk[j]] = rowk[j];
      }
    }
    blz_rs_stamp(a, 4 + 2 * r);
    blz_grid_sync(bar, target);
    blz_rs_stamp(a, 5 + 2 * r);
  }
  // the look-back and control words may live in ``out``: no block writes
  // it before every block is past its last read of them
  if (nrun == 0) blz_grid_sync(bar, target);
  blz_rs_stamp(a, 3);

  // -- 3. the int64 permutation (over the look-back and control words)
  const int32_t* fin = a.idx[nrun & 1];
  const int32_t* tail = a.idx[1];  // the first pass's output holds the dead rows
  for (int64_t p = gtid; p < a.n_total; p += stride) {
    int64_t v = p;
    if (nrun > 0 && p < m) v = p < live ? (int64_t)__ldcg(&fin[p]) : (int64_t)__ldcg(&tail[p]);
    a.out[p] = v;
  }
  blz_rs_stamp(a, 63);
}

static int64_t blz_align256(int64_t bytes) { return (bytes + 255) / 256 * 256; }

// Bytes of the look-back words and the control words (dead rows, one
// 256-bin histogram a digit) of a sort of n_sort rows.
static int64_t blz_rs_side_bytes(int64_t n_sort, int ndigits) {
  const int64_t ntiles = (n_sort + BLZ_RS_TILE - 1) / BLZ_RS_TILE;
  return blz_align256(8 * (ntiles > 0 ? ntiles : 1) * BLZ_RS_BINS) +
         4 * (1 + 256 * (int64_t)ndigits);
}

// Bytes of blz_radix_sort's side scratch for n_sort of n_total rows and
// ndigits digits: the look-back and control words where ``out`` (n_total
// int64) cannot hold them, else 0.
BLZ_EXPORT int64_t blz_radix_sort_scratch(int64_t n_sort, int64_t n_total, int ndigits) {
  const int64_t side = blz_rs_side_bytes(n_sort, ndigits);
  return side <= 8 * n_total ? 0 : side;
}

static int blz_rs_grid(int64_t n_sort) {
  static int per_sm[16], sms[16];
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev & 15;
  if (sms[slot] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[slot], blz_radix_sort_kernel,
                                                  BLZ_RS_THREADS, 0);
    cudaDeviceGetAttribute(&sms[slot], cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t most = (int64_t)(per_sm[slot] > 0 ? per_sm[slot] : 1) * sms[slot];
  const int64_t tiles = (n_sort + BLZ_RS_TILE - 1) / BLZ_RS_TILE;
  return (int)(tiles < 1 ? 1 : (tiles < most ? tiles : most));
}

// The argument words (int64):
//   [0] nops  [1] n_sort  [2] n_total  [3] dead_last  [4] out (n_total int64)
//   [5] hist_out (256 int64, or 0)  [6] side scratch (blz_radix_sort_scratch
//   bytes, or 0)  [7] ndigits  [8] trace (64 uint64 phase stamps, or 0)
//   [9] idx_a, [10] idx_b (n_sort int32 each)  [11] the barrier's word
//   (uint32), then per operand (data, size, kind) from [12], then per
//   digit (operand, shift), least significant first.
// The digits are those the caller lets vary (an operand's known width);
// the kernel skips those that do not vary over the rows, so the wrapper
// needs nothing from the device.
BLZ_EXPORT int blz_radix_sort(const long long* w, cudaStream_t stream) {
  RadixArgs a;
  const int nops = (int)w[0];
  a.n_sort = w[1];
  a.n_total = w[2];
  a.dead_last = (int)w[3];
  a.out = (int64_t*)w[4];
  a.hist_out = (int64_t*)w[5];
  char* scratch = (char*)w[6];
  a.ndigits = (int)w[7];
  a.trace = (unsigned long long*)w[8];
  if (nops <= 0 || nops > BLZ_MAX_SORT_OPS || a.n_sort < 0 || a.n_total < a.n_sort ||
      a.n_total <= 0 || a.n_sort > 0x3fffffff || a.ndigits < 0 ||
      a.ndigits > BLZ_RS_MAX_DIGITS)
    return (int)cudaErrorInvalidValue;
  a.ops.n = nops;
  for (int o = 0; o < nops; ++o) {
    a.ops.data[o] = (const void*)w[12 + 3 * o];
    a.ops.size[o] = (int)w[13 + 3 * o];
    a.ops.kind[o] = (int)w[14 + 3 * o];
  }
  if (a.dead_last && a.ops.size[0] != 1) return (int)cudaErrorInvalidValue;
  const long long* dw = w + 12 + 3 * nops;
  for (int i = 0; i < a.ndigits; ++i) {
    const int op = (int)dw[2 * i], shift = (int)dw[2 * i + 1];
    if (op < 0 || op >= nops || shift < 0 || shift % 8 != 0 || shift >= 8 * a.ops.size[op])
      return (int)cudaErrorInvalidValue;
    a.dop[i] = (unsigned char)op;
    a.dshift[i] = (unsigned char)shift;
  }
  const int64_t ntiles = (a.n_sort + BLZ_RS_TILE - 1) / BLZ_RS_TILE;
  a.idx[0] = (int32_t*)w[9];
  a.idx[1] = (int32_t*)w[10];
  a.bar = (unsigned int*)w[11];
  char* side = blz_rs_side_bytes(a.n_sort, a.ndigits) <= 8 * a.n_total ? (char*)a.out
                                                                        : scratch;
  if (side == nullptr) return (int)cudaErrorInvalidValue;
  a.status = (unsigned long long*)side;
  a.ctrl = (unsigned int*)(side + blz_align256(8 * (ntiles > 0 ? ntiles : 1) * BLZ_RS_BINS));
  cudaError_t err = cudaMemsetAsync(a.bar, 0, 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(a.ctrl, 0, 4 * (1 + 256 * (size_t)a.ndigits), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)blz_radix_sort_kernel,
                                    dim3(blz_rs_grid(a.n_sort)), dim3(BLZ_RS_THREADS), args,
                                    0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
