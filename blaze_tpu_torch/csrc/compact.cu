// K1 compact_planes: stable stream compaction of a batch's planes.
//
// Replaces blaze_tpu/core/kernels.py:_compact (FilterExec's compaction):
// keep the rows where ``mask`` holds, in input order, across every
// (data, validity) plane of the batch, and zero the padding past the
// live count (data 0, validity False — the batch padding contract).
//
// Bound on the H100: bytes. Each live row is read once and written once
// per plane, the mask is read twice (count, then scatter), and the padding
// tail is written once; there is no arithmetic to speak of. The design
// therefore spends one thread per row and three short kernels:
//   1. per-block flag counts (__syncthreads_count),
//   2. one block scanning the block counts into offsets (a few hundred
//      values at 262144-row batches),
//   3. a stable scatter: a warp ballot plus a 32-entry shared-memory scan
//      ranks the live rows of a block, so no sort and no global atomics
//      are needed, and the output order is the input order bit for bit.
// Planes of any element size up to 8 bytes go through one launch as a
// by-value parameter table (no device-side pointer array to upload).
// Not yet done: vector (16-byte) loads and fusing the count into the
// predicate kernel.
#include "common.cuh"

#define BLZ_MAX_PLANES 32

struct PlaneSet {
  int n;
  const void* src[BLZ_MAX_PLANES];
  void* dst[BLZ_MAX_PLANES];
  int size[BLZ_MAX_PLANES];
};

__global__ void blz_flag_count_kernel(const uint8_t* flags, int64_t n,
                                      int64_t* block_counts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int c = __syncthreads_count(i < n && flags[i] != 0);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// In-place exclusive scan of offs[0, nblocks) by one block, total to
// offs[nblocks].
__global__ void blz_offsets_scan_kernel(int64_t* offs, int64_t nblocks) {
  __shared__ long long warp_sums[BLZ_WARPS];
  __shared__ long long carry;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nblocks; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < nblocks ? (long long)offs[i] : 0;
    long long incl = v;
    for (int off = 1; off < 32; off <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, incl, off);
      if ((int)lane >= off) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const long long t = __shfl_up_sync(0xffffffffu, w, off);
        if ((int)lane >= off) w += t;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    incl += warp ? warp_sums[warp - 1] : 0;
    if (i < nblocks) offs[i] = (int64_t)(carry + incl - v);
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) offs[nblocks] = (int64_t)carry;
}

cudaError_t blz_flag_offsets(const uint8_t* flags, int64_t n,
                             int64_t* block_offsets, cudaStream_t stream) {
  const unsigned int nb = blz_blocks(n);
  blz_flag_count_kernel<<<nb, BLZ_THREADS, 0, stream>>>(flags, n,
                                                         block_offsets);
  blz_offsets_scan_kernel<<<1, BLZ_THREADS, 0, stream>>>(block_offsets, nb);
  return cudaGetLastError();
}

__device__ __forceinline__ void blz_copy_elem(const void* src, void* dst,
                                              int size, int64_t from,
                                              int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from]; break;
    case 2: ((uint16_t*)dst)[to] = ((const uint16_t*)src)[from]; break;
    case 4: ((uint32_t*)dst)[to] = ((const uint32_t*)src)[from]; break;
    default: ((uint64_t*)dst)[to] = ((const uint64_t*)src)[from]; break;
  }
}

__device__ __forceinline__ void blz_zero_elem(void* dst, int size, int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = 0; break;
    case 2: ((uint16_t*)dst)[to] = 0; break;
    case 4: ((uint32_t*)dst)[to] = 0; break;
    default: ((uint64_t*)dst)[to] = 0; break;
  }
}

__global__ void blz_compact_scatter_kernel(const uint8_t* mask, int64_t n,
                                           const int64_t* offs, PlaneSet ps) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && mask[i] != 0;
  const int r = blz_block_rank(live, warp_sums);
  const int64_t total = offs[gridDim.x];
  if (live) {
    const int64_t to = offs[blockIdx.x] + r;
    for (int p = 0; p < ps.n; ++p) blz_copy_elem(ps.src[p], ps.dst[p], ps.size[p], i, to);
  }
  if (i < n && i >= total) {
    for (int p = 0; p < ps.n; ++p) blz_zero_elem(ps.dst[p], ps.size[p], i);
  }
}

// mask: n bytes (torch.bool); srcs/dsts: nplanes pointers of n elements of
// sizes[p] bytes (1, 2, 4 or 8); scratch: blz_blocks(n) + 1 int64 values,
// scratch[blz_blocks(n)] receives the live count.
BLZ_EXPORT int blz_compact_planes(const uint8_t* mask, int64_t n, int nplanes,
                                  const void* const* srcs, void* const* dsts,
                                  const int* sizes, int64_t* scratch,
                                  cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = blz_flag_offsets(mask, n, scratch, stream);
  if (err != cudaSuccess) return (int)err;
  for (int p0 = 0; p0 < nplanes; p0 += BLZ_MAX_PLANES) {
    PlaneSet ps;
    ps.n = nplanes - p0 < BLZ_MAX_PLANES ? nplanes - p0 : BLZ_MAX_PLANES;
    for (int p = 0; p < ps.n; ++p) {
      ps.src[p] = srcs[p0 + p];
      ps.dst[p] = dsts[p0 + p];
      ps.size[p] = sizes[p0 + p];
    }
    blz_compact_scatter_kernel<<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
        mask, n, scratch, ps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
