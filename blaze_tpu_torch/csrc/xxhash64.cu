// K15 xxhash64: Spark's XXH64 row hash (seed 42) folded over k device
// columns -> one int64 a row.
//
// Replaces blaze_tpu/exprs/spark_hash.py:230 xxhash64_update_column as
// :429 _hash_device_run folds it (the 4-byte lane :218 xxhash64_int32, the
// 8-byte lane :205 xxhash64_int64), which the xxhash64 SQL function
// (blaze_tpu/exprs/functions.py:401) reaches. Bit-exact with Spark: a
// column of 1, 2 or 4 bytes (bool, int8, int16, int32, date, float32
// bits) takes XXH64's 4-byte round on its value sign-extended to 32 bits
// (a bool is 0 or 1), as Spark's XxHash64 hashInt does; an 8-byte one
// (int64, timestamp, decimal(p<=18) unscaled, float64 bits) its 8-byte
// round (hashLong), then the avalanche; each row's running hash seeds the
// next column, and a null value leaves it unchanged. Planes are read at
// their own width: nothing is widened before the launch. Rows in [n, cap)
// get 0, the padding contract, written by the same launch.
//
// Bound on the H100: bytes. Per row it reads each column's bytes and one
// validity byte once and writes 8 bytes; the ~15 64-bit integer
// multiplies, rotates and xors of a column are far below the card's
// integer rate. At the main path's shapes (a 262,144-row batch, one or
// two columns: a few MB) what bounds the call in practice is one round of
// memory latency, so the design is K2's (murmur3.cu): a thread takes four
// consecutive rows, reads each column's four values as 16-byte words (two
// for 8-byte columns, 8 and 4 bytes for 2- and 1-byte ones) and their
// validity as one 4-byte word through common.cuh's blz_load_col, issues
// the loads of every column (eight columns at a time) before the XXH64
// chains start, runs the four rows' chains side by side and stores the
// four hashes (or the padding's zeros) as two 16-byte words. A plane
// whose address is not aligned to its four rows' width, and the tail of
// fewer than four rows below n or cap, take scalar loads and stores
// inside the same kernel. The column table travels by value
// (__grid_constant__); the column count is a template parameter for 1 and
// 2 columns and a bound of 8 for 3..8, so those loops unroll with no
// runtime index; past 8 columns a loop over groups of 8. Blocks of 128
// threads, not K2's 256: measured faster at hash_sample's batch, where the
// XXH64 rounds then add little to the loads' own time
// (scripts/kernel_variants.py; PERF.md row 2b).
#include "common.cuh"

#define BLZ_XXH_THREADS 128

#define BLZ_XXH_P1 0x9E3779B185EBCA87ull
#define BLZ_XXH_P2 0xC2B2AE3D27D4EB4Full
#define BLZ_XXH_P3 0x165667B19E3779F9ull
#define BLZ_XXH_P4 0x85EBCA77C2B2AE63ull
#define BLZ_XXH_P5 0x27D4EB2F165667C5ull

__device__ __forceinline__ unsigned long long blz_rotl64(unsigned long long x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ unsigned long long blz_xxh_avalanche(unsigned long long acc) {
  acc = (acc ^ (acc >> 33)) * BLZ_XXH_P2;
  acc = (acc ^ (acc >> 29)) * BLZ_XXH_P3;
  return acc ^ (acc >> 32);
}

// xxhash64_int64: the 8 little-endian bytes of v
__device__ __forceinline__ unsigned long long blz_xxh_long(unsigned long long v,
                                                          unsigned long long seed) {
  unsigned long long acc = seed + BLZ_XXH_P5 + 8ull;
  const unsigned long long k1 = blz_rotl64(v * BLZ_XXH_P2, 31) * BLZ_XXH_P1;
  acc ^= k1;
  acc = blz_rotl64(acc, 27) * BLZ_XXH_P1 + BLZ_XXH_P4;
  return blz_xxh_avalanche(acc);
}

// xxhash64_int32: the 4 little-endian bytes of v (zero-extended)
__device__ __forceinline__ unsigned long long blz_xxh_int(unsigned long long v,
                                                         unsigned long long seed) {
  unsigned long long acc = seed + BLZ_XXH_P5 + 4ull;
  acc ^= v * BLZ_XXH_P1;
  acc = blz_rotl64(acc, 23) * BLZ_XXH_P2 + BLZ_XXH_P3;
  return blz_xxh_avalanche(acc);
}

// KMAX: the columns' bound, known at compile time (1, 2, 8, or
// BLZ_MAX_KEYS for the loop over groups of 8).
template <int KMAX>
__global__ void __launch_bounds__(BLZ_XXH_THREADS)
    blz_xxhash64_kernel(const __grid_constant__ HashCols ks, int64_t n, int64_t cap,
                        unsigned long long seed, long long* out) {
  const int64_t r0 = ((int64_t)blockIdx.x * BLZ_XXH_THREADS + threadIdx.x) * BLZ_H_ROWS;
  if (r0 >= cap) return;
  unsigned long long h[BLZ_H_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i) h[i] = seed;
  if (r0 < n) {
    const bool full = r0 + BLZ_H_ROWS <= n;
    constexpr int kGroup = KMAX < BLZ_H_GROUP ? KMAX : BLZ_H_GROUP;
    const int k = KMAX <= BLZ_H_GROUP ? KMAX : ks.k;
    for (int c0 = 0; c0 < k; c0 += kGroup) {
      uint32_t lo[kGroup][BLZ_H_ROWS], hi[kGroup][BLZ_H_ROWS], vb[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (c0 + q < ks.k) blz_load_col(ks, c0 + q, r0, n, full, lo[q], hi[q], vb[q]);
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (c0 + q >= ks.k) break;
        if (ks.size[c0 + q] == 8) {  // the same for every thread: no divergence
#pragma unroll
          for (int i = 0; i < BLZ_H_ROWS; ++i) {
            const unsigned long long x =
                blz_xxh_long((unsigned long long)hi[q][i] << 32 | lo[q][i], h[i]);
            h[i] = (vb[q] >> i) & 1u ? x : h[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < BLZ_H_ROWS; ++i) {
            const unsigned long long x = blz_xxh_int(lo[q][i], h[i]);
            h[i] = (vb[q] >> i) & 1u ? x : h[i];
          }
        }
      }
    }
  }
  long long o[BLZ_H_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i) o[i] = r0 + i < n ? (long long)h[i] : 0ll;
  if (r0 + BLZ_H_ROWS <= cap) {
    *(longlong2*)(out + r0) = make_longlong2(o[0], o[1]);
    *(longlong2*)(out + r0 + 2) = make_longlong2(o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < BLZ_H_ROWS; ++i)
      if (r0 + i < cap) out[r0 + i] = o[i];
  }
}

// w: int64 words [k, n, cap, seed, out, stream, then per column (data,
// validity (or 0), element bytes)]. out: cap int64, 16-byte aligned, rows
// past n set to 0. 0 <= n <= cap, cap > 0.
BLZ_EXPORT int blz_xxhash64(const long long* w) {
  const int k = (int)w[0];
  const int64_t n = w[1], cap = w[2];
  long long* out = (long long*)w[4];
  cudaStream_t stream = (cudaStream_t)w[5];
  if (k <= 0 || k > BLZ_MAX_KEYS || n < 0 || cap <= 0 || n > cap || out == nullptr ||
      ((uintptr_t)out & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  HashCols ks;
  if (!blz_hash_cols(w + 6, k, 3, ks)) return (int)cudaErrorInvalidValue;
  const unsigned long long seed = (unsigned long long)w[3];
  const unsigned int blocks =
      (unsigned int)((cap + BLZ_XXH_THREADS * BLZ_H_ROWS - 1) / (BLZ_XXH_THREADS * BLZ_H_ROWS));
  if (k == 1)
    blz_xxhash64_kernel<1><<<blocks, BLZ_XXH_THREADS, 0, stream>>>(ks, n, cap, seed, out);
  else if (k == 2)
    blz_xxhash64_kernel<2><<<blocks, BLZ_XXH_THREADS, 0, stream>>>(ks, n, cap, seed, out);
  else if (k <= BLZ_H_GROUP)
    blz_xxhash64_kernel<BLZ_H_GROUP><<<blocks, BLZ_XXH_THREADS, 0, stream>>>(ks, n, cap, seed,
                                                                           out);
  else
    blz_xxhash64_kernel<BLZ_MAX_KEYS><<<blocks, BLZ_XXH_THREADS, 0, stream>>>(ks, n, cap, seed,
                                                                            out);
  return (int)cudaGetLastError();
}
