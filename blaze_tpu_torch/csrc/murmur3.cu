// K2 murmur3_pmod: Spark's Murmur3_x86_32 row hash (seed 42) folded over
// k key columns, then pmod n -> int32 partition id.
//
// Replaces blaze_tpu/exprs/spark_hash.py:_hash_device_run with
// murmur3_update_column (the per-column fold) and the pmod of
// blaze_tpu/ops/shuffle/repartitioner.py:HashPartitioner. Bit-exact with
// Spark: a 4-byte column (int8/16/32, date, bool, float32 bits) hashes as
// hashInt, an 8-byte one (int64, timestamp, decimal(p<=18) unscaled,
// float64 bits) as hashLong (low word, then high word); a null value
// leaves the running hash unchanged.
//
// Bound on the H100: bytes. Per row it reads 4 or 8 bytes and one
// validity byte per key column and writes one int32 (plus the hash when
// asked); the ~20 integer operations per word are far below the card's
// integer rate. One thread per row, the column table passed by value,
// coalesced loads; nothing else is needed at this intensity. The murmur3
// rounds (blz_mix_k1, blz_mix_h1, blz_fmix) are common.cuh's, shared with
// K16's hashLong (bloom.cu).
#include "common.cuh"

__global__ void blz_murmur3_pmod_kernel(KeySet ks, int64_t n, uint32_t seed,
                                        int32_t nparts, int32_t* hash_out,
                                        int32_t* pid_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = seed;
  for (int c = 0; c < ks.k; ++c) {
    if (ks.valid[c] != nullptr && ks.valid[c][i] == 0) continue;
    if (ks.wide[c]) {
      const uint64_t v = ((const uint64_t*)ks.data[c])[i];
      uint32_t h1 = blz_mix_h1(h, blz_mix_k1((uint32_t)(v & 0xffffffffu)));
      h1 = blz_mix_h1(h1, blz_mix_k1((uint32_t)(v >> 32)));
      h = blz_fmix(h1, 8u);
    } else {
      const uint32_t w = ((const uint32_t*)ks.data[c])[i];
      h = blz_fmix(blz_mix_h1(h, blz_mix_k1(w)), 4u);
    }
  }
  if (hash_out != nullptr) hash_out[i] = (int32_t)h;
  if (pid_out != nullptr) {
    const int32_t m = (int32_t)h % nparts;
    pid_out[i] = m < 0 ? m + nparts : m;
  }
}

// datas/valids/wide: k key planes of n rows (valid may hold null entries
// for all-valid columns); hash_out / pid_out: n int32 each, either may be
// null. nparts > 0 when pid_out is given.
BLZ_EXPORT int blz_murmur3_pmod(int k, const void* const* datas,
                                const uint8_t* const* valids, const int* wide,
                                int64_t n, uint32_t seed, int32_t nparts,
                                int32_t* hash_out, int32_t* pid_out,
                                cudaStream_t stream) {
  if (k > BLZ_MAX_KEYS || n <= 0 || (pid_out != nullptr && nparts <= 0))
    return (int)cudaErrorInvalidValue;
  const KeySet ks = blz_key_set(k, datas, valids, wide);
  blz_murmur3_pmod_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
      ks, n, seed, nparts, hash_out, pid_out);
  return (int)cudaGetLastError();
}
