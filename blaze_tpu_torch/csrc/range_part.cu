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
// first, 1 NaN under DESC, 2 valid, 3 NaN under ASC, 4 null last, 6
// padding) and the direction-adjusted value (~x for a DESC integer, 1 - x
// for a DESC bool, -x for a DESC float, 0 where the rank decides),
// compared with < and == in the value's own type: -0.0 equals 0.0, and no
// value is NaN (NaN lives in the rank). Padding rows get B + 1.
//
// Design: one thread per row normalises its keys in registers as K5's key
// pass does (no operand planes are written), then binary-searches the
// bound rows, which the caller hands over in ascending order
// (range_bound_operands: K5's key pass and sort over the bounds). The
// reference counts over a (rows x B) broadcast compare; over sorted
// bounds the bounds <= a row are a prefix, so the search finds the same
// count in log2(B + 1) steps. Each block first stages the bounds'
// (value, rank) pairs in shared memory as 64-bit words (a float as its
// double, an integer sign-extended, a bool 0/1) and bytes, 9 bytes a key
// of a bound; past the caller's limit (core/kernels.py RANGE_SMEM_BYTES)
// the search reads the bound planes in global memory instead.
//
// Bound on the H100: bytes. A row reads each key's data and validity and
// the exists byte once and writes a 4-byte id: 23 bytes a row for the
// sort10M map batch's two int64 keys. The bound rows are a few KB, read
// once a block. Each search step touches one bound row for all threads
// of a warp at nearly the same place, served from shared memory.
#include "common.cuh"

#define BLZ_MAX_RANGE_KEYS 16

struct RangeKeySet {
  int k;
  int nb;                                  // bound rows
  const void* data[BLZ_MAX_RANGE_KEYS];
  const uint8_t* valid[BLZ_MAX_RANGE_KEYS];
  const uint8_t* brank[BLZ_MAX_RANGE_KEYS];  // bound ranks, nb each
  const void* bval[BLZ_MAX_RANGE_KEYS];      // bound values, nb each
  int size[BLZ_MAX_RANGE_KEYS];  // bytes of data and of bval (bool: 1)
  int kind[BLZ_MAX_RANGE_KEYS];  // BLZ_KEY_*
  int asc[BLZ_MAX_RANGE_KEYS];
  int nulls_first[BLZ_MAX_RANGE_KEYS];
};

// A normalised value as the 64-bit word it is compared as.
__device__ __forceinline__ long long blz_range_word(const void* p, int size,
                                                   int kind, int64_t i) {
  if (kind == BLZ_KEY_FLOAT)
    return __double_as_longlong(size == 8 ? ((const double*)p)[i]
                                          : (double)((const float*)p)[i]);
  if (kind == BLZ_KEY_BOOL) return ((const uint8_t*)p)[i];
  return blz_load_int(p, size, i);
}

template <bool STAGED>
__global__ void blz_range_partition_kernel(RangeKeySet ks, const uint8_t* exists,
                                           int64_t n, int32_t* out) {
  extern __shared__ long long smem[];
  long long* sw = smem;                                   // k * nb words
  uint8_t* sr = (uint8_t*)(smem + (int64_t)ks.k * ks.nb);  // k * nb ranks
  const int nb = ks.nb;
  if (STAGED) {
    for (int t = threadIdx.x; t < ks.k * nb; t += blockDim.x) {
      const int c = t / nb, j = t - c * nb;
      sw[t] = blz_range_word(ks.bval[c], ks.size[c], ks.kind[c], j);
      sr[t] = ks.brank[c][j];
    }
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!exists[i]) {
    out[i] = nb + 1;
    return;
  }
  // the row's normalised keys (K5's key pass on an existing row)
  long long rw[BLZ_MAX_RANGE_KEYS];
  uint8_t rr[BLZ_MAX_RANGE_KEYS];
  for (int c = 0; c < ks.k; ++c) {
    const bool valid = ks.valid[c][i] != 0;
    int rank = 2;
    long long w;
    if (ks.kind[c] == BLZ_KEY_FLOAT) {
      const double d = ks.size[c] == 8 ? ((const double*)ks.data[c])[i]
                                       : (double)((const float*)ks.data[c])[i];
      const bool nan = d != d;
      double v = (nan || !valid) ? 0.0 : d;
      if (!ks.asc[c]) v = -v;
      w = __double_as_longlong(v);
      if (nan) rank = ks.asc[c] ? 3 : 1;
    } else if (ks.kind[c] == BLZ_KEY_BOOL) {
      uint8_t v = ((const uint8_t*)ks.data[c])[i];
      if (!ks.asc[c]) v = (uint8_t)(1 - v);
      w = valid ? v : 0;
    } else {
      long long v = blz_load_int(ks.data[c], ks.size[c], i);
      if (!ks.asc[c]) v = ~v;
      w = valid ? v : 0;
    }
    if (!valid) rank = ks.nulls_first[c] ? 0 : 4;
    rw[c] = w;
    rr[c] = (uint8_t)rank;
  }
  // bisect_right: the first bound row that is > the row
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    bool le = true;  // bound row mid <= the row (all keys equal: <=)
    for (int c = 0; c < ks.k; ++c) {
      const int at = c * nb + mid;
      const int br = STAGED ? sr[at] : ks.brank[c][mid];
      if (br != rr[c]) {
        le = br < rr[c];
        break;
      }
      const long long bw =
          STAGED ? sw[at] : blz_range_word(ks.bval[c], ks.size[c], ks.kind[c], mid);
      if (ks.kind[c] == BLZ_KEY_FLOAT) {
        const double a = __longlong_as_double(bw), b = __longlong_as_double(rw[c]);
        if (a < b) break;
        if (!(a == b)) {
          le = false;
          break;
        }
      } else if (bw != rw[c]) {
        le = bw < rw[c];
        break;
      }
    }
    if (le) lo = mid + 1;
    else hi = mid;
  }
  out[i] = lo;
}

// k keys of n rows (data planes of sizes[c] bytes, kinds[c] BLZ_KEY_*, bool
// validity, exists), nb bound rows in ascending order as K5's key pass
// normalises them (brank u8, bval of the key's size; a bool key's bval is
// u8); staged: stage the bounds in shared memory (k * nb * 9 bytes).
// out: int32 ids, n of them.
BLZ_EXPORT int blz_range_partition_ids(int k, const void* const* datas,
                                       const uint8_t* const* valids,
                                       const int* sizes, const int* kinds,
                                       const int* asc, const int* nulls_first,
                                       const uint8_t* exists, int64_t n,
                                       const uint8_t* const* brank,
                                       const void* const* bval, int nb, int staged,
                                       int32_t* out, cudaStream_t stream) {
  if (k <= 0 || k > BLZ_MAX_RANGE_KEYS || n <= 0 || nb < 0)
    return (int)cudaErrorInvalidValue;
  RangeKeySet ks;
  ks.k = k;
  ks.nb = nb;
  for (int c = 0; c < k; ++c) {
    ks.data[c] = datas[c];
    ks.valid[c] = valids[c];
    ks.brank[c] = brank[c];
    ks.bval[c] = bval[c];
    ks.size[c] = sizes[c];
    ks.kind[c] = kinds[c];
    ks.asc[c] = asc[c];
    ks.nulls_first[c] = nulls_first[c];
  }
  if (staged) {
    const size_t smem = (size_t)k * nb * 9;
    blz_range_partition_kernel<true><<<blz_blocks(n), BLZ_THREADS, smem, stream>>>(
        ks, exists, n, out);
  } else {
    blz_range_partition_kernel<false><<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
        ks, exists, n, out);
  }
  return (int)cudaGetLastError();
}
