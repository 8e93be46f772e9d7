// K16 bloom_probe: Spark's BloomFilterImpl.mightContainLong over a column
// of int64 values against one bitmap -> one bool a row.
//
// Replaces blaze_tpu/ops/bloom.py:93 SparkBloomFilter.might_contain_long
// (with blaze_tpu/exprs/spark_hash.py:76 murmur3_int64), which the
// BloomFilterMightContain expression (blaze_tpu/exprs/compiler.py:823)
// reaches. Bit-exact with Spark: h1 = hashLong(v, 0), h2 = hashLong(v,
// h1 as uint32) (Murmur3_x86_32 of the 8 little-endian bytes); for
// i = 1..k the combined hash h1 + i * h2 wraps as an int32, is flipped
// with ~ where negative, and indexes bit (combined mod bit_size) of the
// bitmap, LSB first within each 64-bit word; the row is a hit when all k
// bits are set. The wrap is computed in uint32 (signed overflow is
// undefined in C++), and the flip tests the uint32's sign bit. Every row
// of the capacity is probed, padding included, as the reference probes
// the whole plane; the validity plane passes through in the wrapper.
//
// Bound on the H100: bytes. Per row it reads 8 bytes and writes 1; the
// bitmap (1 MiB at Spark's default 8,388,608 bits) is read once from
// device memory and then stays in the 50 MB L2, so its k random word
// reads a row cost L2 latency, not HBM bytes. It does not fit the 227 KB
// of shared memory a block can use, so the words are read through the
// read-only path (__ldg). One thread a row; the loop stops at the first
// zero bit, as Spark's mightContainLong does (the AND of the k bits is
// the same), so a filter that keeps few rows reads about one word a row.
#include "common.cuh"

__device__ __forceinline__ uint32_t blz_hash_long(unsigned long long v, uint32_t seed) {
  uint32_t h = blz_mix_h1(seed, blz_mix_k1((uint32_t)(v & 0xffffffffull)));
  h = blz_mix_h1(h, blz_mix_k1((uint32_t)(v >> 32)));
  return blz_fmix(h, 8u);
}

__global__ void blz_bloom_probe_kernel(const long long* __restrict__ values, int64_t n,
                                       const unsigned long long* __restrict__ words,
                                       int k, int64_t bit_size, uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long v = (unsigned long long)values[i];
  const uint32_t h1 = blz_hash_long(v, 0u);
  const uint32_t h2 = blz_hash_long(v, h1);
  uint8_t hit = 1;
  for (int j = 1; j <= k; ++j) {
    uint32_t c = h1 + (uint32_t)j * h2;
    if (c & 0x80000000u) c = ~c;
    const int64_t idx = (int64_t)c % bit_size;
    const unsigned long long w = __ldg(words + (idx >> 6));
    if (((w >> (idx & 63)) & 1ull) == 0ull) {
      hit = 0;
      break;
    }
  }
  out[i] = hit;
}

// values: n int64; words: the bitmap's bit_size / 64 words (bit_size a
// multiple of 64, 0 < bit_size < 2^31); k >= 1; out: n bytes (0 or 1).
// n > 0.
BLZ_EXPORT int blz_bloom_probe(const long long* values, int64_t n,
                               const unsigned long long* words, int k, int64_t bit_size,
                               uint8_t* out, cudaStream_t stream) {
  if (n <= 0 || k < 1 || bit_size <= 0 || bit_size >= (1ll << 31) || (bit_size & 63))
    return (int)cudaErrorInvalidValue;
  blz_bloom_probe_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(values, n, words, k,
                                                                    bit_size, out);
  return (int)cudaGetLastError();
}
