// K6 gather_planes and K7 slice / concat: the batch plumbing's row moves.
//
// K6 replaces blaze_tpu/core/kernels.py:_gather_n and _gather: every
// (data, validity) plane of a batch gathered by one int64 index vector in
// one launch. Output row r is live when r < n_out and, in the masked form
// (outer-join null extension, `_gather`), live[r] holds; a live row reads
// row clip(idx[r], 0, capacity - 1) of each plane (planes of one batch
// may have different capacities), every other row is data 0 / validity
// False -- the padding contract.
//
// K7 replaces blaze_tpu/core/kernels.py:_dyn_slice and _concat_gather:
// output row r of k sources with live counts c_b maps to source b (the
// last b with prefix[b] <= r, prefix = exclusive sum of the c_b) and its
// row start[b] + r - prefix[b], clipped to that source's capacity. A
// slice is k = 1 with a start offset and c_0 its (already cut) length, so
// an offset past the end yields an empty window, never a clamped one; a
// concat has every start at 0. Rows past the total are zeroed.
//
// Bound on the H100: bytes -- each output element is one read and one
// write, the index (K6) or the prefix search (K7, log2 k steps over a
// table that stays in L1) is all the arithmetic. One thread per output
// row, every plane of the row in the same thread; planes of 1, 2, 4 or 8
// bytes. K6 takes its plane table by value (32 planes a launch); K7 reads
// a table the wrapper uploads, since k sources times the planes can be
// any size.
#include "common.cuh"

#define BLZ_MAX_GATHER_PLANES 32

struct GatherSet {
  int n;
  const void* src[BLZ_MAX_GATHER_PLANES];
  void* dst[BLZ_MAX_GATHER_PLANES];
  long long cap[BLZ_MAX_GATHER_PLANES];
  int size[BLZ_MAX_GATHER_PLANES];
};

__device__ __forceinline__ void blz_move(const void* src, void* dst, int size,
                                         int64_t from, int64_t to, bool on) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = on ? ((const uint8_t*)src)[from] : 0; break;
    case 2: ((uint16_t*)dst)[to] = on ? ((const uint16_t*)src)[from] : 0; break;
    case 4: ((uint32_t*)dst)[to] = on ? ((const uint32_t*)src)[from] : 0u; break;
    default:
      ((unsigned long long*)dst)[to] =
          on ? ((const unsigned long long*)src)[from] : 0ull;
      break;
  }
}

__device__ __forceinline__ int64_t blz_clip(int64_t i, int64_t cap) {
  return i < 0 ? 0 : (i >= cap ? cap - 1 : i);
}

__global__ void blz_gather_kernel(const int64_t* idx, int64_t n_out,
                                  const uint8_t* live, int64_t out_cap,
                                  GatherSet gs) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= out_cap) return;
  const bool on = r < n_out && (live == nullptr || live[r] != 0);
  const int64_t j = on ? idx[r] : 0;
  for (int p = 0; p < gs.n; ++p)
    blz_move(gs.src[p], gs.dst[p], gs.size[p], blz_clip(j, gs.cap[p]), r, on);
}

// idx: n_out int64 row indices; live: n_out bytes or null; srcs/dsts:
// nplanes planes (caps[p] rows of sizes[p] bytes in, out_cap rows out).
BLZ_EXPORT int blz_gather_planes(const int64_t* idx, int64_t n_out,
                                 const uint8_t* live, int64_t out_cap,
                                 int nplanes, const void* const* srcs,
                                 void* const* dsts, const long long* caps,
                                 const int* sizes, cudaStream_t stream) {
  if (out_cap <= 0 || n_out < 0 || n_out > out_cap) return (int)cudaErrorInvalidValue;
  for (int p0 = 0; p0 < nplanes; p0 += BLZ_MAX_GATHER_PLANES) {
    GatherSet gs;
    gs.n = nplanes - p0 < BLZ_MAX_GATHER_PLANES ? nplanes - p0 : BLZ_MAX_GATHER_PLANES;
    for (int p = 0; p < gs.n; ++p) {
      gs.src[p] = srcs[p0 + p];
      gs.dst[p] = dsts[p0 + p];
      gs.cap[p] = caps[p0 + p];
      gs.size[p] = sizes[p0 + p];
      if (gs.cap[p] <= 0) return (int)cudaErrorInvalidValue;
    }
    blz_gather_kernel<<<blz_blocks(out_cap), BLZ_THREADS, 0, stream>>>(
        idx, n_out, live, out_cap, gs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The K7 table (int64 words, built by the wrapper): for k sources and np
// planes,
//   prefix[k + 1]          output row where source b starts; prefix[k] = total
//   start[k]               first source row of source b
//   dst[np], size[np]      output plane pointers and element bytes
//   src[np * k], cap[np * k]  plane p of source b at p * k + b
__global__ void blz_concat_kernel(const long long* table, int k, int np,
                                  int64_t out_cap) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= out_cap) return;
  const long long* prefix = table;
  const long long* start = prefix + k + 1;
  const long long* dst = start + k;
  const long long* size = dst + np;
  const long long* src = size + np;
  const long long* cap = src + (int64_t)np * k;
  const bool on = r < __ldg(&prefix[k]);
  int b = 0;
  if (on) {  // last b with prefix[b] <= r (empty sources are skipped over)
    int lo = 0, hi = k - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(&prefix[mid]) <= r) lo = mid; else hi = mid - 1;
    }
    b = lo;
  }
  const int64_t row = on ? __ldg(&start[b]) + r - __ldg(&prefix[b]) : 0;
  for (int p = 0; p < np; ++p) {
    const int64_t at = (int64_t)p * k + b;
    blz_move((const void*)__ldg(&src[at]), (void*)__ldg(&dst[p]),
             (int)__ldg(&size[p]), blz_clip(row, __ldg(&cap[at])), r, on);
  }
}

// table: device int64 words laid out as above.
BLZ_EXPORT int blz_concat_planes(const long long* table, int k, int nplanes,
                                 int64_t out_cap, cudaStream_t stream) {
  if (k <= 0 || nplanes <= 0 || out_cap <= 0) return (int)cudaErrorInvalidValue;
  blz_concat_kernel<<<blz_blocks(out_cap), BLZ_THREADS, 0, stream>>>(
      table, k, nplanes, out_cap);
  return (int)cudaGetLastError();
}
