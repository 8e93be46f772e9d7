// Shared pieces of the port's hand-written Hopper kernels: the plain C
// export macro, the pinned staging of host tables (gather.cu, mesh.cu),
// launch geometry, the column table and four-row loads of the row hashes
// and the range partition (murmur3.cu, xxhash64.cu, range_part.cu), the
// murmur3 rounds (murmur3.cu, bloom.cu),
// the key kinds and integer load of the key passes (sort.cu,
// range_part.cu), the block-level stable rank of slot_agg.cu's
// compaction of the present slots, the decoupled look-back
// of the single-pass kernels (sort.cu, join.cu, seg_agg.cu, compact.cu),
// a block's zeroing of a plane's rows, the warp
// aggregation of the slot kernels' atomics (slot_agg.cu, slot_update.cu),
// and the emit arithmetic of the aggregate kernels (slot_agg.cu,
// seg_agg.cu, passthrough.cu).
//
// Every exported function takes the caller's CUDA stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BLZ_EXPORT extern "C" __attribute__((visibility("default")))

// One thread per row (or slot). 1024 threads = 32 warps, so the per-warp
// totals of a block fit one warp for the second level of the scan.
#define BLZ_THREADS 1024
#define BLZ_WARPS (BLZ_THREADS / 32)

static inline unsigned int blz_blocks(int64_t n) {
  return (unsigned int)((n + BLZ_THREADS - 1) / BLZ_THREADS);
}

#define BLZ_FULL 0xffffffffu

// The merge of x over the lanes of ``peers`` (the lanes whose slot is this
// lane's, from __match_any_sync), in the group's lowest lane: a tree over
// the group, one shuffle a level (E. Westphal's reduce_peers). ``merge``
// is associative and commutative. Every lane of the warp calls it.
template <class Merge>
__device__ __forceinline__ long long blz_reduce_peers(unsigned peers, long long x,
                                                      Merge merge) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rel = __popc(peers & ((1u << lane) - 1u));  // my rank in the group
  unsigned above = peers & (0xfffffffeu << lane);       // the group's lanes above me
  while (__any_sync(BLZ_FULL, above != 0)) {
    const int next = __ffs(above);
    const long long t = __shfl_sync(BLZ_FULL, x, next > 0 ? next - 1 : 0);
    if ((rel & 1u) == 0 && above != 0) x = merge(x, t);
    above &= __ballot_sync(BLZ_FULL, (rel & 1u) == 0);
    rel >>= 1;
  }
  return x;
}

// Whether this block is the last of the grid to get here (its writes and
// every other block's made visible first); ``done`` counts the blocks.
__device__ __forceinline__ bool blz_last_block(int* done) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The rows of a block that walks a grid-stride over ``num_rows``: base,
// base + gridDim.x * blockDim.x, ... Every thread of the block takes as
// many turns, so the warps stay converged for the warp aggregation.
#define BLZ_GRID_ROWS(i, num_rows)                                                      \
  for (int64_t blz_base = (int64_t)blockIdx.x * blockDim.x; blz_base < (num_rows);      \
       blz_base += (int64_t)gridDim.x * blockDim.x)                                     \
    for (int64_t i = blz_base + threadIdx.x, blz_once = 0; blz_once < 1; ++blz_once)

// The columns of a row-hash launch (K2 murmur3.cu, K15 xxhash64.cu) and
// the keys of K14's range partition (range_part.cu), passed to the kernel
// by value (__grid_constant__, so a runtime column index reads the
// parameter bank and nothing is copied to local memory): k planes of 1, 2,
// 4 or 8-byte values, each with its validity bytes (null: every row
// valid). A thread of these kernels takes BLZ_H_ROWS consecutive rows and
// issues the loads of BLZ_H_GROUP columns before it computes on them.
#define BLZ_MAX_KEYS 32
#define BLZ_H_THREADS 256
#define BLZ_H_ROWS 4
#define BLZ_H_GROUP 8

struct HashCols {
  int k;
  const void* data[BLZ_MAX_KEYS];
  const uint8_t* valid[BLZ_MAX_KEYS];
  int size[BLZ_MAX_KEYS];
};

// Fills ``ks`` with k columns from the argument words ``e``: (data,
// validity (or 0), element bytes) at e[c * stride]. False on a null data
// pointer or an element size other than 1, 2, 4 or 8.
static inline bool blz_hash_cols(const long long* e, int k, int stride, HashCols& ks) {
  ks.k = k;
  for (int c = 0; c < k; ++c, e += stride) {
    const int size = (int)e[2];
    if (e[0] == 0 || (size != 1 && size != 2 && size != 4 && size != 8)) return false;
    ks.data[c] = (const void*)e[0];
    ks.valid[c] = (const uint8_t*)e[1];
    ks.size[c] = size;
  }
  return true;
}

// Four flag bytes from row r0 (a validity or exists plane; null: all set)
// as bits 0..3: one 4-byte load when ``full`` (all four rows below n) and
// the plane is 4-byte aligned, else a byte a row below n.
__device__ __forceinline__ uint32_t blz_load_flags(const uint8_t* p, int64_t r0, int64_t n,
                                                   bool full) {
  if (p == nullptr) return 0xFu;
  if (full && (((uintptr_t)p & 3u) == 0)) {
    const uint32_t w = __ldg((const unsigned int*)(p + r0));
    return ((w & 0xFFu) != 0) | (((w >> 8) & 0xFFu) != 0) << 1 |
           (((w >> 16) & 0xFFu) != 0) << 2 | ((w >> 24) != 0) << 3;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i)
    if (r0 + i < n && __ldg(p + r0 + i) != 0) bits |= 1u << i;
  return bits;
}

// Column c's four values from row r0 (lo: the low 32 bits, sign-extended
// from a narrower plane, a bool's 0 / 1; hi: the high word of an 8-byte
// value) and their validity as bits 0..3. ``full``: all four rows are
// below n. A plane whose address is not aligned to its four rows' width
// (a view at an odd offset), and rows past n, take scalar loads.
__device__ __forceinline__ void blz_load_col(const HashCols& ks, int c, int64_t r0, int64_t n,
                                             bool full, uint32_t lo[BLZ_H_ROWS],
                                             uint32_t hi[BLZ_H_ROWS], uint32_t& vbits) {
  vbits = blz_load_flags(ks.valid[c], r0, n, full);
  const void* p = ks.data[c];
  const uintptr_t a = (uintptr_t)p;
  switch (ks.size[c]) {
    case 8: {
      const unsigned long long* q = (const unsigned long long*)p + r0;
      if (full && (a & 15u) == 0) {
        const uint4 x = __ldg((const uint4*)q);
        const uint4 y = __ldg((const uint4*)q + 1);
        lo[0] = x.x; hi[0] = x.y; lo[1] = x.z; hi[1] = x.w;
        lo[2] = y.x; hi[2] = y.y; lo[3] = y.z; hi[3] = y.w;
      } else {
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i) {
          const unsigned long long v = r0 + i < n ? __ldg(q + i) : 0ull;
          lo[i] = (uint32_t)v;
          hi[i] = (uint32_t)(v >> 32);
        }
      }
      break;
    }
    case 4: {
      const unsigned int* q = (const unsigned int*)p + r0;
      if (full && (a & 15u) == 0) {
        const uint4 x = __ldg((const uint4*)q);
        lo[0] = x.x; lo[1] = x.y; lo[2] = x.z; lo[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i) lo[i] = r0 + i < n ? __ldg(q + i) : 0u;
      }
      break;
    }
    case 2: {
      const short* q = (const short*)p + r0;
      if (full && (a & 7u) == 0) {
        const uint2 x = __ldg((const uint2*)q);
        lo[0] = (uint32_t)(int32_t)(short)(x.x & 0xFFFFu);
        lo[1] = (uint32_t)(int32_t)(short)(x.x >> 16);
        lo[2] = (uint32_t)(int32_t)(short)(x.y & 0xFFFFu);
        lo[3] = (uint32_t)(int32_t)(short)(x.y >> 16);
      } else {
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i)
          lo[i] = r0 + i < n ? (uint32_t)(int32_t)__ldg(q + i) : 0u;
      }
      break;
    }
    default: {  // 1 byte: int8, or a bool's 0 / 1
      const signed char* q = (const signed char*)p + r0;
      if (full && (a & 3u) == 0) {
        const uint32_t x = __ldg((const unsigned int*)q);
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i)
          lo[i] = (uint32_t)(int32_t)(signed char)((x >> (8 * i)) & 0xFFu);
      } else {
#pragma unroll
        for (int i = 0; i < BLZ_H_ROWS; ++i)
          lo[i] = r0 + i < n ? (uint32_t)(int32_t)__ldg(q + i) : 0u;
      }
      break;
    }
  }
}

// Copies ``bytes`` of host memory to ``dev`` on ``stream`` through the
// library's reused pinned buffers (a ring of four, gather.cu):
// asynchronous, and a buffer is refilled only after its previous copy has
// finished. For the tables past a kernel's parameter limit (K7) and K17's
// count matrix.
int blz_stage(const void* src, size_t bytes, void* dev, cudaStream_t stream);

// Murmur3_x86_32's rounds, as Spark's Murmur3_x86_32 takes them: the
// row hash K2 (murmur3.cu) and the bloom probe K16's hashLong (bloom.cu).
__device__ __forceinline__ uint32_t blz_rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t blz_mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = blz_rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

__device__ __forceinline__ uint32_t blz_mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = blz_rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t blz_fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  h1 ^= h1 >> 16;
  return h1;
}

// The key kinds of the sort and range-partition key passes (sort.cu,
// range_part.cu; core/kernels.py _KEY_*).
enum { BLZ_KEY_BOOL = 0, BLZ_KEY_INT = 1, BLZ_KEY_FLOAT = 2 };

// A signed integer plane's row i, sign-extended from its ``size`` bytes.
__device__ __forceinline__ long long blz_load_int(const void* p, int size,
                                                  int64_t i) {
  switch (size) {
    case 1: return ((const int8_t*)p)[i];
    case 2: return ((const int16_t*)p)[i];
    case 4: return ((const int32_t*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

// Exclusive rank of this thread's flag among the flagged threads of its
// block, in thread order (so a scatter by rank is stable). Every thread of
// the block must call it. ``warp_sums`` is __shared__ int[BLZ_WARPS].
__device__ __forceinline__ int blz_block_rank(bool flag, int* warp_sums) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, off);
      if ((int)lane >= off) v += t;
    }
    warp_sums[lane] = v;  // inclusive per-warp prefix
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + lane_rank;
}

// Decoupled look-back (Merrill and Garland's single-pass scan, as onesweep
// uses it): the exclusive prefix of tile t's ``count`` over the tiles
// before it, for the radix sort's passes (sort.cu, a word per tile and
// digit) and the join's compaction (join.cu, a word per tile). Tile k's
// word sits at status[k * stride]: (tag << 34) | (flag << 32) | count,
// flag BLZ_LB_AGG for the tile's own count, BLZ_LB_INCL for its inclusive
// prefix; a word of another tag is not yet published in this pass or
// launch, so the words need no zeroing between passes that change the
// tag. Tile t publishes its count, sums the earlier tiles' words back to
// the nearest inclusive one (BLZ_LB_LOOK tiles a round, independent
// loads, not a chain), publishes its inclusive prefix and returns the
// exclusive one. One thread a word calls it; the words are read and
// written volatile (the counts are the only data they carry).
#define BLZ_LB_AGG 1ull
#define BLZ_LB_INCL 2ull
#define BLZ_LB_LOOK 4

__device__ __forceinline__ unsigned long long blz_lb_word(unsigned long long tag,
                                                          unsigned long long flag,
                                                          unsigned int count) {
  return (tag << 34) | (flag << 32) | count;
}

__device__ __forceinline__ unsigned int blz_look_back(unsigned long long* status,
                                                      int64_t stride, int64_t t,
                                                      unsigned long long tag,
                                                      unsigned int count) {
  unsigned long long* st = status + t * stride;
  unsigned int excl = 0;
  if (t > 0) {
    *(volatile unsigned long long*)st = blz_lb_word(tag, BLZ_LB_AGG, count);
    for (int64_t k = t - 1; k >= 0;) {
      unsigned long long v[BLZ_LB_LOOK];
#pragma unroll
      for (int i = 0; i < BLZ_LB_LOOK; ++i)
        v[i] = k - i >= 0 ? *(volatile unsigned long long*)(status + (k - i) * stride) : 0ull;
      int step = 0;  // tiles summed this round before a stop
      bool done = false, stop = false;
#pragma unroll
      for (int i = 0; i < BLZ_LB_LOOK; ++i) {
        if (stop || done || k - i < 0) continue;
        if ((v[i] >> 34) != tag) {  // tile k - i has not published yet
          stop = true;
          continue;
        }
        excl += (unsigned int)(v[i] & 0xffffffffull);
        ++step;
        done = ((v[i] >> 32) & 3ull) == BLZ_LB_INCL;
      }
      if (done) break;
      k -= step;
    }
  }
  *(volatile unsigned long long*)st = blz_lb_word(tag, BLZ_LB_INCL, excl + count);
  return excl;
}

// The block-wide form (join.cu, seg_agg.cu, compact.cu), for grids whose tiles run at once rather
// than in turn: each round every thread of the block reads one earlier
// tile's word (THREADS tiles a round), waits until that tile has
// published its count (a tile publishes it before it looks back, so the
// wait is short and never circular), and the block sums the words back to
// the nearest inclusive one; a tile a few hundred tiles into the grid so
// sums its prefix in one round, where a window of BLZ_LB_LOOK tiles would
// walk back tile group by tile group behind tiles that are still looking
// back themselves. Every thread of the block calls it with the tile's
// count; all get the exclusive prefix. ``s_red``: __shared__ int[2 *
// warps] scratch. Tile k's word at status[k].
template <int THREADS>
__device__ __forceinline__ unsigned int blz_block_look_back(unsigned long long* status,
                                                            int64_t t,
                                                            unsigned long long tag,
                                                            unsigned int count, int* s_red) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  if (threadIdx.x == 0 && t > 0)
    *(volatile unsigned long long*)(status + t) = blz_lb_word(tag, BLZ_LB_AGG, count);
  unsigned int excl = 0;
  for (int64_t hi = t - 1; hi >= 0; hi -= THREADS) {
    const int64_t k = hi - threadIdx.x;
    unsigned long long v = 0ull;
    if (k >= 0) {
      v = *(volatile unsigned long long*)(status + k);
      while ((v >> 34) != tag) {
        __nanosleep(32);
        v = *(volatile unsigned long long*)(status + k);
      }
    }
    const bool incl = k >= 0 && ((v >> 32) & 3ull) == BLZ_LB_INCL;
    // the nearest inclusive word: the least thread index holding one
    const int w_first = (int)__reduce_min_sync(BLZ_FULL, incl ? threadIdx.x : THREADS);
    if (lane == 0) s_red[warp] = w_first;
    __syncthreads();
    int first = THREADS;
    for (int w = 0; w < THREADS / 32; ++w) first = s_red[w] < first ? s_red[w] : first;
    const unsigned int c =
        k >= 0 && (int)threadIdx.x <= first ? (unsigned int)(v & 0xffffffffull) : 0u;
    const unsigned int w_sum = __reduce_add_sync(BLZ_FULL, c);
    if (lane == 0) s_red[THREADS / 32 + warp] = (int)w_sum;
    __syncthreads();
    for (int w = 0; w < THREADS / 32; ++w) excl += (unsigned int)s_red[THREADS / 32 + w];
    __syncthreads();  // s_red is read by every thread before the next round
    if (first < THREADS) break;
  }
  if (threadIdx.x == 0)
    *(volatile unsigned long long*)(status + t) = blz_lb_word(tag, BLZ_LB_INCL, excl + count);
  return excl;
}

// Zero bytes [from, to) of a plane by the block (join.cu's, seg_agg.cu's
// and compact.cu's padding, gather.cu's padding blocks): 16-byte stores over
// the aligned middle, single bytes at the two ends.
__device__ __forceinline__ void blz_zero_bytes(uint8_t* base, int64_t from, int64_t to) {
  int64_t a = (from + 15) & ~(int64_t)15;
  a = a < to ? a : to;
  int64_t b = to & ~(int64_t)15;
  b = b > a ? b : a;
  for (int64_t i = from + threadIdx.x; i < a; i += blockDim.x) base[i] = 0;
  for (int64_t i = b + threadIdx.x; i < to; i += blockDim.x) base[i] = 0;
  uint4* v = (uint4*)(base + a);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = threadIdx.x; i < (b - a) >> 4; i += blockDim.x) v[i] = zero;
}

// The aggregate kernels' emit kinds (core/kernels.py EMIT_*).
enum { BLZ_EMIT_RAW = 0, BLZ_EMIT_NONZERO = 1, BLZ_EMIT_WHERE = 2, BLZ_EMIT_LO32 = 3,
       BLZ_EMIT_CARRY = 4, BLZ_EMIT_MID = 5, BLZ_EMIT_TOP = 6, BLZ_EMIT_WORD_HI = 7,
       BLZ_EMIT_WORD_LO = 8 };

// One emitted value of a group from its final tables: word(0) is the
// emit's table, word(1) its aux table and word(2) its aux2 table, each read
// only where the kind uses it. Limb arithmetic wraps as unsigned 64-bit
// words; shifts of signed words are arithmetic.
template <class Word>
__device__ __forceinline__ long long blz_emit_value(int kind, Word word) {
  const long long t = word(0);
  switch (kind) {
    case BLZ_EMIT_NONZERO: return t != 0;
    case BLZ_EMIT_WHERE: return word(1) != 0 ? t : 0;
    case BLZ_EMIT_LO32: return t & 0xFFFFFFFFLL;
    case BLZ_EMIT_CARRY:
      return (long long)((unsigned long long)t + (unsigned long long)(word(1) >> 32));
    case BLZ_EMIT_MID:
      return (long long)((unsigned long long)t + (unsigned long long)(word(1) >> 32)) &
             0xFFFFFFFFLL;
    case BLZ_EMIT_TOP: {
      const long long mid =
          (long long)((unsigned long long)word(1) + (unsigned long long)(word(2) >> 32));
      return (long long)((unsigned long long)t + (unsigned long long)(mid >> 32));
    }
    case BLZ_EMIT_WORD_HI:
      return word(1) != 0 ? (long long)((unsigned long long)t >> 32) : 0;
    case BLZ_EMIT_WORD_LO: return word(1) != 0 ? (t & 0xFFFFFFFFLL) : 0;
    default: return t;
  }
}
