// K2 murmur3_pmod: Spark's Murmur3_x86_32 row hash (seed 42) folded over
// k key columns, then pmod n -> int32 partition id.
//
// Replaces blaze_tpu/exprs/spark_hash.py:_hash_device_run with
// murmur3_update_column (the per-column fold) and the pmod of
// blaze_tpu/ops/shuffle/repartitioner.py:HashPartitioner. Bit-exact with
// Spark: a column of 1, 2 or 4 bytes (bool, int8, int16, int32, date,
// float32 bits) hashes as hashInt of its value sign-extended to 32 bits (a
// bool is 0 or 1), an 8-byte one (int64, timestamp, decimal(p<=18)
// unscaled, float64 bits) as hashLong (low word, then high word); a null
// value leaves the running hash unchanged. Planes are read at their own
// width: nothing is widened before the launch.
//
// Bound on the H100: bytes. Per row it reads each key column's bytes and
// one validity byte and writes one int32 (two with the hash); ~20 integer
// operations per word are far below the card's integer rate. At the
// exchange's shapes (a few hundred to 262,144 rows, one or two keys) the
// whole call is a few MB, so what bounds it in practice is one round of
// memory latency. The design keeps every load in flight at once: a thread
// takes four consecutive rows, reads each column's four values as one
// 16-byte word (two for 8-byte keys, 8 and 4 bytes for 2- and 1-byte
// keys) and their validity as one 4-byte word, issues the loads of every
// column (eight columns at a time) before the hash chains start, runs the
// four rows' chains side by side and stores four pids (and hashes) as one
// 16-byte word. A plane whose address is not aligned to its four rows'
// width, and the last thread's tail of fewer than four rows, take scalar
// loads inside the same kernel. The column table travels by value
// (__grid_constant__, so a runtime column index reads the parameter bank
// and nothing is copied to local memory); the column count is a template
// parameter for 1 and 2 columns and a bound of 8 for 3..8, so those loops
// unroll with no runtime index; past 8 columns a loop over groups of 8.
// The pmod is Spark's: a 32-bit % and a fix-up of a negative residue (a
// reciprocal multiply was not measured faster: the kernel sits at the
// card's launch floor at these shapes). The column table and its
// four-row loader (HashCols, blz_load_col) are common.cuh's, shared with
// K15 (xxhash64.cu) and K14 (range_part.cu); the murmur3 rounds
// (blz_mix_k1, blz_mix_h1, blz_fmix) too, shared with K16's hashLong
// (bloom.cu).
#include "common.cuh"

// Spark's pmod of the int32 hash: ((h % n) + n) % n for n > 0.
__device__ __forceinline__ int32_t blz_pmod(uint32_t h, int32_t n) {
  const int32_t m = (int32_t)h % n;
  return m < 0 ? m + n : m;
}

// KMAX: the columns' bound, known at compile time (1, 2, 8, or
// BLZ_MAX_KEYS for the loop over groups of 8).
template <int KMAX>
__global__ void __launch_bounds__(BLZ_H_THREADS)
    blz_murmur3_kernel(const __grid_constant__ HashCols ks, int64_t n, uint32_t seed,
                       int32_t nparts, int32_t* hash_out, int32_t* pid_out) {
  const int64_t r0 = ((int64_t)blockIdx.x * BLZ_H_THREADS + threadIdx.x) * BLZ_H_ROWS;
  if (r0 >= n) return;
  const bool full = r0 + BLZ_H_ROWS <= n;
  constexpr int kGroup = KMAX < BLZ_H_GROUP ? KMAX : BLZ_H_GROUP;
  const int k = KMAX <= BLZ_H_GROUP ? KMAX : ks.k;
  uint32_t h[BLZ_H_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_H_ROWS; ++i) h[i] = seed;
  for (int c0 = 0; c0 < k; c0 += kGroup) {
    uint32_t lo[kGroup][BLZ_H_ROWS], hi[kGroup][BLZ_H_ROWS], vb[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (c0 + q < ks.k) blz_load_col(ks, c0 + q, r0, n, full, lo[q], hi[q], vb[q]);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (c0 + q >= ks.k) break;
      const bool wide = ks.size[c0 + q] == 8;
#pragma unroll
      for (int i = 0; i < BLZ_H_ROWS; ++i) {
        uint32_t x = blz_mix_h1(h[i], blz_mix_k1(lo[q][i]));
        x = wide ? blz_fmix(blz_mix_h1(x, blz_mix_k1(hi[q][i])), 8u) : blz_fmix(x, 4u);
        h[i] = (vb[q] >> i) & 1u ? x : h[i];
      }
    }
  }
  if (full) {
    if (hash_out != nullptr)
      *(int4*)(hash_out + r0) = make_int4((int)h[0], (int)h[1], (int)h[2], (int)h[3]);
    if (pid_out != nullptr)
      *(int4*)(pid_out + r0) =
          make_int4(blz_pmod(h[0], nparts), blz_pmod(h[1], nparts), blz_pmod(h[2], nparts),
                    blz_pmod(h[3], nparts));
  } else {
#pragma unroll
    for (int i = 0; i < BLZ_H_ROWS; ++i) {
      if (r0 + i >= n) break;
      if (hash_out != nullptr) hash_out[r0 + i] = (int32_t)h[i];
      if (pid_out != nullptr) pid_out[r0 + i] = blz_pmod(h[i], nparts);
    }
  }
}

// w: int64 words [k, n, seed, nparts, hash_out (or 0), pid_out (or 0),
// stream, then per column (data, validity (or 0), element bytes)]. The
// outputs are n int32 each, 16-byte aligned; nparts > 0 when pid_out is
// given.
BLZ_EXPORT int blz_murmur3_pmod(const long long* w) {
  const int k = (int)w[0];
  const int64_t n = w[1];
  const int64_t nparts = w[3];
  int32_t* hash_out = (int32_t*)w[4];
  int32_t* pid_out = (int32_t*)w[5];
  cudaStream_t stream = (cudaStream_t)w[6];
  if (k <= 0 || k > BLZ_MAX_KEYS || n <= 0 || (pid_out == nullptr && hash_out == nullptr) ||
      (pid_out != nullptr && (nparts <= 0 || nparts > 0x7FFFFFFF)) ||
      (((uintptr_t)hash_out | (uintptr_t)pid_out) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  HashCols ks;
  if (!blz_hash_cols(w + 7, k, 3, ks)) return (int)cudaErrorInvalidValue;
  const int32_t np = pid_out != nullptr ? (int32_t)nparts : 1;
  const uint32_t seed = (uint32_t)w[2];
  const unsigned int blocks =
      (unsigned int)((n + BLZ_H_THREADS * BLZ_H_ROWS - 1) / (BLZ_H_THREADS * BLZ_H_ROWS));
  if (k == 1)
    blz_murmur3_kernel<1><<<blocks, BLZ_H_THREADS, 0, stream>>>(ks, n, seed, np, hash_out,
                                                                 pid_out);
  else if (k == 2)
    blz_murmur3_kernel<2><<<blocks, BLZ_H_THREADS, 0, stream>>>(ks, n, seed, np, hash_out,
                                                                 pid_out);
  else if (k <= BLZ_H_GROUP)
    blz_murmur3_kernel<BLZ_H_GROUP><<<blocks, BLZ_H_THREADS, 0, stream>>>(
        ks, n, seed, np, hash_out, pid_out);
  else
    blz_murmur3_kernel<BLZ_MAX_KEYS><<<blocks, BLZ_H_THREADS, 0, stream>>>(
        ks, n, seed, np, hash_out, pid_out);
  return (int)cudaGetLastError();
}
