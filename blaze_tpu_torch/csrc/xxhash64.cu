// K15 xxhash64: Spark's XXH64 row hash (seed 42) folded over k device
// columns -> one int64 a row.
//
// Replaces blaze_tpu/exprs/spark_hash.py:230 xxhash64_update_column as
// :429 _hash_device_run folds it (the 4-byte lane :218 xxhash64_int32, the
// 8-byte lane :205 xxhash64_int64), which the xxhash64 SQL function
// (blaze_tpu/exprs/functions.py:401) reaches. Bit-exact with Spark: a
// 4-byte word (int8/16/32, date and bool widened to int32, float32 bits)
// takes XXH64's 4-byte round, an 8-byte word (int64, timestamp,
// decimal(p<=18) unscaled, float64 bits) its 8-byte round, then the
// avalanche; each row's running hash seeds the next column, and a null
// value leaves it unchanged. Rows in [n, cap) get 0, the padding contract.
//
// Bound on the H100: bytes. Per row it reads each column's word (4 or 8
// bytes) and validity byte once and writes 8 bytes; the ~15 64-bit integer
// multiplies, rotates and xors a column are far below the card's integer
// rate, so one thread a row with coalesced loads and the column table
// passed by value (KeySet, common.cuh) is enough: nothing is reused
// between rows, so there is nothing to stage in shared memory.
#include "common.cuh"

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

__global__ void blz_xxhash64_kernel(KeySet ks, int64_t n, int64_t cap,
                                    unsigned long long seed, long long* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  if (i >= n) {
    out[i] = 0;
    return;
  }
  unsigned long long h = seed;
  for (int c = 0; c < ks.k; ++c) {
    if (ks.valid[c] != nullptr && ks.valid[c][i] == 0) continue;
    if (ks.wide[c]) {
      h = blz_xxh_long(((const unsigned long long*)ks.data[c])[i], h);
    } else {
      h = blz_xxh_int((unsigned long long)((const uint32_t*)ks.data[c])[i], h);
    }
  }
  out[i] = (long long)h;
}

// datas/valids/wide: k column planes of at least n rows (valid may hold
// null entries for all-valid columns); out: cap int64, rows past n set to
// 0. 0 <= n <= cap, cap > 0.
BLZ_EXPORT int blz_xxhash64(int k, const void* const* datas, const uint8_t* const* valids,
                            const int* wide, int64_t n, int64_t cap,
                            unsigned long long seed, long long* out,
                            cudaStream_t stream) {
  if (k <= 0 || k > BLZ_MAX_KEYS || n < 0 || cap <= 0 || n > cap)
    return (int)cudaErrorInvalidValue;
  const KeySet ks = blz_key_set(k, datas, valids, wide);
  blz_xxhash64_kernel<<<blz_blocks(cap), BLZ_THREADS, 0, stream>>>(ks, n, cap, seed, out);
  return (int)cudaGetLastError();
}
