// Shared pieces of the port's hand-written Hopper kernels: the plain C
// export macro, launch geometry, and the block-level stable rank that the
// compaction kernels (compact.cu, slot_agg.cu) are built on.
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

// Stable compaction offsets over a byte flag array (compact.cu):
// block_offsets[b] = number of set flags before block b (blocks of
// BLZ_THREADS), block_offsets[nblocks] = total. block_offsets holds
// blz_blocks(n) + 1 int64 values.
cudaError_t blz_flag_offsets(const uint8_t* flags, int64_t n,
                             int64_t* block_offsets, cudaStream_t stream);
