// K1 compact_planes: stable stream compaction of a batch's planes.
//
// Replaces blaze_tpu/core/kernels.py:_compact (FilterExec's compaction):
// keep the rows where ``mask`` holds, in input order, across every
// (data, validity) plane of the batch, and zero the padding past the
// live count (data 0, validity False -- the batch padding contract).
//
// Bound on the H100: bytes. The mask is read once, each kept row of each
// plane is read once (a dropped row need not be: at the card's 32-byte
// sectors, the sectors that hold a kept row) and written once, and the
// padding tail is written once; there is no arithmetic to speak of. At
// hash_sample's batch (262,144 rows, ~10% kept, 4 int32 + 1 int64 planes
// and their 5 validity planes) that is ~12.2 MB: the mask 0.26 MB, the
// outputs written whole 7.6 MB, the kept rows' sectors ~4.4 MB; ~3.7 us
// at 3.35 TB/s (chip_smoke.py k1_bytes).
//
// One launch a call, no memset, no host table per plane:
//   - blocks take tickets (an atomic counter, reset by the last ticket),
//     so a block only ever waits on blocks that started before it. Each
//     ticket is a 1,024-row tile, four rows a thread in
//     256-thread blocks, 256 rows apart, so that each warp's rows of one
//     step are 32 consecutive rows: their ranks come from a ballot, their
//     loads and stores coalesce across the warp. The tile's mask is read
//     once as 16-byte words into shared memory; a warp ballot a step and
//     a one-warp scan of the 32 (step, warp) counts rank the live rows in
//     row order, and the tile's output offset comes from the block-wide
//     decoupled look-back (common.cuh blz_block_look_back) over the
//     earlier tiles' counts, in a scratch buffer whose words carry the
//     launch's tag, so it is never zeroed. The last tile writes the count.
//   - the planes are grouped by element size (8, 4, 2, 1 bytes) when the
//     host packs the table, so each size has a loop of its own with no
//     branch on the size inside; for each plane, every live row's load is
//     issued before the stores, and a row that is not live reads nothing.
//   - each tile zeroes its share of the padding once its look-back is
//     done, with 16-byte stores: the kept rows up to the tile plus the
//     rows after it bound the count, and the tile's dropped rows are what
//     it takes off that bound, so the tiles' shares tile [count, n) from
//     the end down and no tile's share holds a kept row. The padding is
//     written beside the tiles' moves, with no block waiting for the
//     count. (On an H100, in separate runs of chip_ab.py: zeroing blocks
//     of their own that waited for the last tile's count ran within 3% of
//     this at hash_sample's batch and 6-8% slower at q69_bloom's and
//     q96_mesh's; ones that zeroed as each tile's count allowed ran 2-12x
//     slower, a dependent read and two barriers a tile in turn.)
// The shape is a measured choice (an H100, hash_sample's, q69_bloom's and
// q96_mesh's batches, the padding then in blocks of its own): of 128-512
// threads and 4-16 rows a thread, four rows a thread were the fastest at
// the first two and level at the third; eight rows a thread took 80
// registers a thread to four's 46.
// The table goes by value in the kernel's parameters up to 128 planes;
// past that the wrapper hands it over in device memory, still one launch.
#include "common.cuh"

#ifndef BLZ_C_THREADS
#define BLZ_C_THREADS 256
#endif
#ifndef BLZ_C_ITEMS
#define BLZ_C_ITEMS 4                                // rows a thread, THREADS apart
#endif
#define BLZ_C_WARPS (BLZ_C_THREADS / 32)
#define BLZ_C_TILE (BLZ_C_THREADS * BLZ_C_ITEMS)     // 1,024 rows a tile
#define BLZ_C_COUNTS (BLZ_C_ITEMS * BLZ_C_WARPS)     // (step, warp) counts a tile
#define BLZ_C_PER ((BLZ_C_COUNTS + 31) / 32)         // of them a lane of the scan
#define BLZ_C_MAX_PLANES 128                         // planes by value

struct PlaneRef {
  const void* src;
  void* dst;
};

struct CompactArgs {
  const uint8_t* mask;
  int64_t n, ntiles;
  unsigned int* ticket;            // the tickets' counter
  unsigned long long* status;      // ntiles look-back words
  unsigned long long tag;          // this launch's look-back tag
  int64_t* count;
  int vec_mask;                    // the mask is 16-byte aligned
  int np;                          // planes: sizes 8, 4, 2, 1 in that order
  int end[4];                      // the end of each size's planes in the table
  const PlaneRef* table;           // past BLZ_C_MAX_PLANES: the table in device memory
  PlaneRef planes[BLZ_C_MAX_PLANES];
};

template <typename T>
__device__ __forceinline__ void blz_c_move(const PlaneRef& p, int64_t base, unsigned live,
                                           const int64_t* pos) {
  const T* __restrict__ src = (const T*)p.src;
  T* __restrict__ dst = (T*)p.dst;
  T v[BLZ_C_ITEMS];
#pragma unroll
  for (int j = 0; j < BLZ_C_ITEMS; ++j)
    if ((live >> j) & 1u) v[j] = __ldg(&src[base + j * BLZ_C_THREADS + threadIdx.x]);
#pragma unroll
  for (int j = 0; j < BLZ_C_ITEMS; ++j)
    if ((live >> j) & 1u) dst[pos[j]] = v[j];
}

// __grid_constant__: the planes' table is indexed by a loop variable, read
// in place from the parameter space rather than copied to local memory
__global__ void __launch_bounds__(BLZ_C_THREADS)
    blz_compact_kernel(const __grid_constant__ CompactArgs a) {
  __shared__ __align__(16) uint8_t s_mask[BLZ_C_TILE];
  __shared__ int s_cnt[BLZ_C_COUNTS];  // (step, warp) counts, then offsets
  __shared__ int s_red[2 * BLZ_C_WARPS];
  __shared__ unsigned int s_ticket, s_total;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const PlaneRef* planes = a.table != nullptr ? a.table : a.planes;
  if (threadIdx.x == 0) {
    const unsigned int t = atomicAdd(a.ticket, 1u);
    // every other block has its ticket by now: the counter starts the
    // next launch at 0
    if (t == gridDim.x - 1) atomicExch(a.ticket, 0u);
    s_ticket = t;
  }
  __syncthreads();
  const int64_t t = s_ticket;

  // the mask once, as 16-byte words where it is aligned and whole
  const int64_t base = t * BLZ_C_TILE;
  const int64_t rows = a.n - base < BLZ_C_TILE ? a.n - base : BLZ_C_TILE;
  if (a.vec_mask && rows == BLZ_C_TILE) {
    for (int i = threadIdx.x; i < BLZ_C_TILE / 16; i += BLZ_C_THREADS)
      ((uint4*)s_mask)[i] = __ldg((const uint4*)(a.mask + base) + i);
  } else {
    for (int i = threadIdx.x; i < BLZ_C_TILE; i += BLZ_C_THREADS)
      s_mask[i] = i < rows ? a.mask[base + i] : 0;
  }
  __syncthreads();
  // ranks in row order: step j of warp w precedes step j of warp w + 1
  unsigned live = 0, ballot[BLZ_C_ITEMS];
#pragma unroll
  for (int j = 0; j < BLZ_C_ITEMS; ++j) {
    const bool on = s_mask[j * BLZ_C_THREADS + threadIdx.x] != 0;
    live |= (unsigned)on << j;
    ballot[j] = __ballot_sync(BLZ_FULL, on);
    if (lane == 0) s_cnt[j * BLZ_C_WARPS + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the counts, BLZ_C_PER consecutive ones a lane
    int c[BLZ_C_PER], x = 0;
#pragma unroll
    for (int k = 0; k < BLZ_C_PER; ++k) {
      const int i = lane * BLZ_C_PER + k;
      c[k] = i < BLZ_C_COUNTS ? s_cnt[i] : 0;
      x += c[k];
    }
    const int sum = x;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(BLZ_FULL, x, off);
      if ((int)lane >= off) x += y;
    }
    int run = x - sum;
#pragma unroll
    for (int k = 0; k < BLZ_C_PER; ++k) {
      const int i = lane * BLZ_C_PER + k;
      if (i < BLZ_C_COUNTS) s_cnt[i] = run;
      run += c[k];
    }
    if (lane == 31) s_total = (unsigned int)x;
  }
  __syncthreads();
  const unsigned int total = s_total;
  const unsigned int excl =
      blz_block_look_back<BLZ_C_THREADS>(a.status, t, a.tag, total, s_red);
  if (threadIdx.x == 0 && t == a.ntiles - 1) *a.count = (int64_t)excl + total;
  if (total > 0) {
    const unsigned below = (1u << lane) - 1u;
    int64_t pos[BLZ_C_ITEMS];
#pragma unroll
    for (int j = 0; j < BLZ_C_ITEMS; ++j)
      pos[j] = (int64_t)excl + s_cnt[j * BLZ_C_WARPS + warp] + __popc(ballot[j] & below);
    int p = 0;
    for (; p < a.end[0]; ++p) blz_c_move<unsigned long long>(planes[p], base, live, pos);
    for (; p < a.end[1]; ++p) blz_c_move<uint32_t>(planes[p], base, live, pos);
    for (; p < a.end[2]; ++p) blz_c_move<uint16_t>(planes[p], base, live, pos);
    for (; p < a.end[3]; ++p) blz_c_move<uint8_t>(planes[p], base, live, pos);
  }
  // the tile's share of the padding: the count is at most the kept rows so
  // far plus the rows after, a bound that falls by the tile's dropped rows
  const int64_t pad_hi = (int64_t)excl + (a.n - base);
  const int64_t pad_lo = (int64_t)excl + total + (a.n - base - rows);
  if (pad_lo >= pad_hi) return;
  int p = 0;
  for (int g = 0, size = 8; g < 4; ++g, size >>= 1)
    for (; p < a.end[g]; ++p)
      blz_zero_bytes((uint8_t*)planes[p].dst, pad_lo * size, pad_hi * size);
}

// The argument words (int64; core/kernels.py _CW_*):
//   [0] n  [1] mask  [2] scratch (int64 words: the tickets' counter, then
//   one look-back word a tile)  [3] scratch tiles  [4] tag  [5] count (one
//   int64)  [6] stream  [7] planes  [8..11] the end of the 8-, 4-, 2- and
//   1-byte planes  [12] the table in device memory (0: by value), then
//   per plane (src, dst) from [16], sizes in that order.
BLZ_EXPORT int blz_compact_planes(const long long* w) {
  CompactArgs a;
  a.n = w[0];
  a.mask = (const uint8_t*)w[1];
  a.ntiles = (a.n + BLZ_C_TILE - 1) / BLZ_C_TILE;
  a.ticket = (unsigned int*)w[2];
  a.status = (unsigned long long*)w[2] + 1;
  a.tag = (unsigned long long)w[4];
  a.count = (int64_t*)w[5];
  cudaStream_t stream = (cudaStream_t)w[6];
  a.np = (int)w[7];
  for (int g = 0; g < 4; ++g) a.end[g] = (int)w[8 + g];
  a.table = (const PlaneRef*)w[12];
  a.vec_mask = (w[1] & 15) == 0;
  if (a.n <= 0 || a.n > 0x7fffffffLL || a.ntiles > w[3] || a.tag == 0 ||
      a.tag >= (1ull << 30) || a.np < 0 || a.end[3] != a.np ||
      (a.table == nullptr && a.np > BLZ_C_MAX_PLANES))
    return (int)cudaErrorInvalidValue;
  for (int g = 1; g < 4; ++g)
    if (a.end[g] < a.end[g - 1] || a.end[0] < 0) return (int)cudaErrorInvalidValue;
  if (a.table == nullptr)
    for (int p = 0; p < a.np; ++p) {
      a.planes[p].src = (const void*)w[16 + 2 * p];
      a.planes[p].dst = (void*)w[17 + 2 * p];
    }
  blz_compact_kernel<<<(unsigned int)a.ntiles, BLZ_C_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
