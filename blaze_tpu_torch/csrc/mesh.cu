// K17 mesh_all_to_all: the device mesh's all-to-all of compacted segments.
//
// Replaces blaze_tpu/parallel/mesh.py:215 _exchange_compact_step together
// with the pack in MeshBatchExchange.run (:474-493) that feeds it: there
// each source slot s gathers, per plane, the rows it routes to every
// reducer into a (n * chunk,) send buffer (``jnp.take(plane, sidx)``,
// ``where(live, ..., 0)``) and ``lax.all_to_all`` hands peer chunk d to
// slot d. One launch here does both for every plane of every slot: for
// destination slot d, source slot s and position q of the chunk s sends to
// d, the output position is d * n * chunk + s * chunk + q (slot d's receive
// buffer, s-th peer chunk).
//
// Exchange mode (tile = 0), one round t of segments of ``scap`` rows: with
// r = d * G + q / scap (the reducer of the position; G reducers a slot) and
// k = t * scap + q % scap, the position is live when k < counts[s][r], and
// it then holds row route_s[starts[s][r] + k] of slot s, where route_s is
// slot s's stable order of its rows by reducer id (K5b) and starts the
// exclusive prefix of counts: a segment keeps its rows in the slot's row
// order, so the reducer's rows are the same at every slot count. The
// counts come from the host (the driver pulls the (n, Rpad) count matrix
// once: it sets scap and the number of rounds), so no atomic places a row,
// and slot d's receive count is written, not accumulated:
// sum over s and g < G of clip(counts[s][d * G + g] - t * scap, 0, scap).
//
// Tile mode (tile = 1) is exchange_and_aggregate's (n, capacity) masked
// tiles (:91-101): chunk is the slots' common capacity, route_s holds slot
// s's int64 reducer id per row (n where the row goes nowhere), and the
// position is live when route_s[q] == d, holding row q; the receive counts
// (zeroed by the caller) gain one warp-aggregated atomic add per run of
// lanes with the same destination.
//
// A live position copies each plane's bytes of its row (planes of 1, 2, 4
// or 8 bytes: data and validity alike); a dead one writes 0 to every plane
// (data 0, validity False) and live_out[pos] is the live flag (the
// reference's live plane).
//
// Bound on the H100: bytes. Every output position is written once per
// plane and the live plane once; every live row of every plane is read
// once, through its 8-byte route entry. A live row's gather is random
// within its slot (a reducer's rows are one in G * n of the slot's), so
// each takes a 32-byte sector for a 1- to 8-byte value: gathers, not the
// stores, bound it. The exchange kernel's design:
// - a block owns at most 1,024 consecutive positions of one segment (one
//   (d, s, g)); it reads the segment's count and start, the slot's route
//   and the plane pointers once into shared memory, and computes its
//   segment with 32-bit divisions once a block;
// - the live rows go part-major: with P = ceil(scap / 992), block b <
//   P * n * n * G takes part p = b / (n * n * G) of segment b % (n * n *
//   G), the rows [L * p / P, L * (p + 1) / P) of its live length L (inner
//   bounds rounded down to 32 positions, so each part fits 1,024). A
//   reducer's rows are spread over its slot, so part p of every segment
//   reads about the p-th P-th of each slot's rows whatever the reducers'
//   sizes (range partitions are uneven): the blocks in flight together
//   gather from one window of each slot, and the sectors one reducer's
//   gathers fetch are in L2 for the others' (tiles at a fixed k lose that
//   reuse as soon as the reducers' sizes differ);
// - a thread takes four positions 256 apart (stores coalesce across the
//   warp), loads their route entries, then the planes by element size
//   (the host groups them: 8, 4, 2, 1 bytes), eight planes' gathers on the
//   read-only path before their streaming stores;
// - the dead tails [L, scap) go to ceil(scap / 1,024) * n * n * G blocks
//   after those, 1,024 positions a block, which load nothing and zero
//   every plane with 16-byte stores;
// - block 0 also writes the receive counts (no memset, no atomics).
// The route and plane pointers travel by value (__grid_constant__) while n
// <= 64, n * planes <= 256 and planes <= 64; past that, after the count
// matrix and its prefix, in the table staged through the library's pinned
// buffer (common.cuh blz_stage), as the count matrix always is.
#include <string.h>

#include <vector>

#include "common.cuh"

#define BLZ_M_THREADS 256
#define BLZ_M_ROWS 4                              // positions a thread, THREADS apart
#define BLZ_M_TILE (BLZ_M_THREADS * BLZ_M_ROWS)   // 1,024 positions a block
#define BLZ_M_BATCH 8                             // planes whose gathers go out together
#define BLZ_M_MAX_SLOTS 64                        // the by-value pointer table
#define BLZ_M_MAX_SRC 256
#define BLZ_M_MAX_PLANES 64
#define BLZ_M_SMEM_PLANES 256                     // planes a launch

struct MeshArgs {
  int n, np;               // slots, planes a slot
  int n8, n4, n2, n1;      // planes of 8, 4, 2 and 1 bytes, in that order
  int by_value;            // route/src/dst below; else in the table after the counts
  int64_t G, scap, first, chunk, rpad;
  int64_t parts, tiles;    // a segment's live parts and dead-tail tiles
  // counts[n * rpad], starts[n * rpad] (exchange mode; rpad = 0 in tile
  // mode), then, when not by value, route[n], src[n * np], dst[np]
  const long long* table;
  uint8_t* live_out;
  unsigned long long* live_counts;
  const long long* route[BLZ_M_MAX_SLOTS];
  const void* src[BLZ_M_MAX_SRC];        // slot s's plane p at s * np + p
  void* dst[BLZ_M_MAX_PLANES];
};

__device__ __forceinline__ const long long* blz_mesh_ptrs(const MeshArgs& a) {
  return a.table + 2 * (int64_t)a.n * a.rpad;
}

__device__ __forceinline__ const long long* blz_mesh_route(const MeshArgs& a, int s) {
  return a.by_value ? a.route[s] : (const long long*)blz_mesh_ptrs(a)[s];
}

__device__ __forceinline__ const void* blz_mesh_src(const MeshArgs& a, int s, int p) {
  return a.by_value ? a.src[s * a.np + p]
                    : (const void*)blz_mesh_ptrs(a)[a.n + (int64_t)s * a.np + p];
}

__device__ __forceinline__ void* blz_mesh_dst(const MeshArgs& a, int p) {
  return a.by_value ? a.dst[p]
                    : (void*)blz_mesh_ptrs(a)[a.n + (int64_t)a.n * a.np + p];
}

__device__ __forceinline__ int blz_mesh_size(const MeshArgs& a, int p) {
  return p < a.n8 ? 8 : p < a.n8 + a.n4 ? 4 : p < a.n8 + a.n4 + a.n2 ? 2 : 1;
}

// The planes [first, first + count) of one element type: BLZ_M_BATCH
// planes' gathers for the thread's positions, then their stores
// (streaming: the receive buffers are not read again by this launch, and
// the gathered planes keep L2). ``on``: the position is live; ``in``: it
// is inside the tile's part of the segment.
template <typename T>
__device__ __forceinline__ void blz_mesh_rows(const void* const* src, void* const* dst,
                                              int first, int count, const int64_t* row,
                                              const bool* on, const bool* in, int64_t pos0) {
  for (int p = first; p < first + count; p += BLZ_M_BATCH) {
    T v[BLZ_M_BATCH][BLZ_M_ROWS];
#pragma unroll
    for (int q = 0; q < BLZ_M_BATCH; ++q) {
      const bool here = p + q < first + count;
      const T* __restrict__ s = (const T*)src[here ? p + q : p];
#pragma unroll
      for (int i = 0; i < BLZ_M_ROWS; ++i) v[q][i] = here && on[i] ? __ldg(s + row[i]) : (T)0;
    }
#pragma unroll
    for (int q = 0; q < BLZ_M_BATCH; ++q) {
      if (p + q >= first + count) break;
      T* __restrict__ d = (T*)dst[p + q];
#pragma unroll
      for (int i = 0; i < BLZ_M_ROWS; ++i)
        if (in[i]) __stcs(d + pos0 + (int64_t)i * BLZ_M_THREADS, v[q][i]);
    }
  }
}

__global__ void __launch_bounds__(BLZ_M_THREADS)
    blz_mesh_exchange_kernel(const __grid_constant__ MeshArgs a) {
  __shared__ const void* s_src[BLZ_M_SMEM_PLANES];
  __shared__ void* s_dst[BLZ_M_SMEM_PLANES];
  __shared__ const long long* s_route;
  __shared__ long long s_len, s_row0;
  const unsigned n = (unsigned)a.n, G = (unsigned)a.G;
  const unsigned nseg = n * n * G;
  const unsigned P = (unsigned)a.parts;
  // blocks [0, P * nseg): part p of every segment's live rows; then
  // [P * nseg, (P + tiles) * nseg): tile t of every segment's dead tail
  const bool live_part = blockIdx.x < P * nseg;
  const unsigned b = live_part ? blockIdx.x : blockIdx.x - P * nseg;
  const unsigned t = b / nseg;
  const unsigned seg = b - t * nseg;  // (d * n + s) * G + g
  const unsigned g = seg % G, s = (seg / G) % n, d = seg / G / n;
  const int64_t rpad = a.rpad, scap = a.scap;
  if (blockIdx.x == 0) {  // the receive counts of this round, written
    for (unsigned dd = threadIdx.x; dd < n; dd += BLZ_M_THREADS) {
      long long sum = 0;
      for (unsigned ss = 0; ss < n; ++ss) {
        if (blz_mesh_route(a, (int)ss) == nullptr) continue;
        for (unsigned gg = 0; gg < G; ++gg) {
          long long c = a.table[(int64_t)ss * rpad + (int64_t)dd * G + gg] - a.first;
          sum += c < 0 ? 0 : (c > scap ? scap : c);
        }
      }
      a.live_counts[dd] = (unsigned long long)sum;
    }
  }
  const int np = a.np;
  for (int p = threadIdx.x; p < np; p += BLZ_M_THREADS) {
    if (live_part) s_src[p] = blz_mesh_src(a, (int)s, p);
    s_dst[p] = blz_mesh_dst(a, p);
  }
  if (threadIdx.x == 0) {
    const long long* rt = blz_mesh_route(a, (int)s);
    const int64_t at = (int64_t)s * rpad + (int64_t)d * G + g;
    long long len = rt != nullptr ? a.table[at] - a.first : 0;
    s_len = len < 0 ? 0 : (len > scap ? scap : len);
    s_row0 = rt != nullptr && live_part ? a.table[(int64_t)n * rpad + at] + a.first : 0;
    s_route = rt;
  }
  __syncthreads();
  const int64_t base = (int64_t)seg * scap;  // the segment's first position
  const int64_t len = s_len;
  if (!live_part) {  // the dead tail's tile t: zeros, 16 bytes a store
    const int64_t lo = len > (int64_t)t * BLZ_M_TILE ? len : (int64_t)t * BLZ_M_TILE;
    const int64_t hi = (int64_t)(t + 1) * BLZ_M_TILE < scap ? (int64_t)(t + 1) * BLZ_M_TILE
                                                            : scap;
    if (lo >= hi) return;
    for (int p = 0; p < np; ++p) {
      const int size = blz_mesh_size(a, p);
      blz_zero_bytes((uint8_t*)s_dst[p], (base + lo) * size, (base + hi) * size);
    }
    blz_zero_bytes(a.live_out, base + lo, base + hi);
    return;
  }
  // part t of the live rows: the same share of every segment, so the
  // blocks in flight together read about the same rows of each slot
  // whatever the reducers' sizes; inner bounds rounded down to 32
  // positions, so a warp's stores start on a sector
  const int64_t lo = t == 0 ? 0 : (len * t / P) & ~(int64_t)31;
  const int64_t hi = t + 1 == P ? len : (len * (t + 1) / P) & ~(int64_t)31;
  if (lo >= hi) return;
  const long long* __restrict__ route = s_route + s_row0;
  int64_t row[BLZ_M_ROWS];
  bool on[BLZ_M_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_M_ROWS; ++i) {
    const int64_t j = lo + threadIdx.x + (int64_t)i * BLZ_M_THREADS;
    on[i] = j < hi;
    row[i] = on[i] ? __ldcs(route + j) : 0;
  }
  const int64_t pos0 = base + lo + threadIdx.x;
#pragma unroll
  for (int i = 0; i < BLZ_M_ROWS; ++i)
    if (on[i]) a.live_out[pos0 + (int64_t)i * BLZ_M_THREADS] = 1;
  blz_mesh_rows<unsigned long long>(s_src, s_dst, 0, a.n8, row, on, on, pos0);
  blz_mesh_rows<unsigned int>(s_src, s_dst, a.n8, a.n4, row, on, on, pos0);
  blz_mesh_rows<unsigned short>(s_src, s_dst, a.n8 + a.n4, a.n2, row, on, on, pos0);
  blz_mesh_rows<unsigned char>(s_src, s_dst, a.n8 + a.n4 + a.n2, a.n1, row, on, on, pos0);
}

__device__ __forceinline__ void blz_mesh_move(const void* src, void* dst, int size,
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

// Tile mode, on no path (exchange_and_aggregate's demo): one thread a
// position, the receive counts by warp-aggregated atomics.
__global__ void blz_mesh_tile_kernel(const __grid_constant__ MeshArgs a, int64_t total) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = pos < total;
  const int64_t seg_len = (int64_t)a.n * a.chunk;
  int d = a.n;  // lanes past the end count for no slot
  int s = 0;
  bool live = false;
  int64_t row = 0;
  if (in) {
    d = (int)(pos / seg_len);
    const int64_t rem = pos - (int64_t)d * seg_len;
    s = (int)(rem / a.chunk);
    const int64_t q = rem - (int64_t)s * a.chunk;
    const long long* rt = blz_mesh_route(a, s);
    live = rt != nullptr && __ldg(&rt[q]) == (long long)d;
    row = q;
  }
  const unsigned lane = threadIdx.x & 31u;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const unsigned same = __match_any_sync(0xffffffffu, d);
  if (in && lane == (unsigned)(__ffs(same) - 1)) {
    const int c = __popc(ballot & same);
    if (c) atomicAdd(&a.live_counts[d], (unsigned long long)c);
  }
  if (!in) return;
  a.live_out[pos] = live ? 1 : 0;
  for (int p = 0; p < a.np; ++p)
    blz_mesh_move(blz_mesh_src(a, s, p), blz_mesh_dst(a, p), blz_mesh_size(a, p), row, pos,
                  live);
}

// w: int64 words [n, np, n8, n4, n2, n1, G, scap, round, tile, chunk,
// live_out, live_counts, dev_table, host_table (or 0), stream, then
// route[n], src[n * np] (slot s's planes at s * np, grouped by size as
// n8..n1 say; 0 for an empty slot), dst[np]]. Exchange mode: host_table
// holds counts[n * rpad] and their exclusive row prefix starts[n * rpad]
// (rpad = n * G), staged to dev_table; the pointers follow them there
// when they do not fit the parameters (the caller sizes dev_table so).
// live_out: n * n * chunk bytes; live_counts: n words (zeroed by the
// caller in tile mode only).
BLZ_EXPORT int blz_mesh_all_to_all(const long long* w) {
  const int n = (int)w[0], np = (int)w[1];
  const int64_t G = w[6], scap = w[7], round = w[8], chunk = w[10];
  const int tile = (int)w[9];
  cudaStream_t stream = (cudaStream_t)w[15];
  if (n <= 0 || np < 0 || np > BLZ_M_SMEM_PLANES || chunk <= 0 || round < 0 ||
      w[2] + w[3] + w[4] + w[5] != np)
    return (int)cudaErrorInvalidValue;
  if (!tile && (G <= 0 || scap <= 0 || chunk != G * scap ||
                3 * ((scap + BLZ_M_TILE - 1) / BLZ_M_TILE) * n * n * G > 0x7FFFFFFF))
    return (int)cudaErrorInvalidValue;
  MeshArgs a;
  a.n = n;
  a.np = np;
  a.n8 = (int)w[2];
  a.n4 = (int)w[3];
  a.n2 = (int)w[4];
  a.n1 = (int)w[5];
  a.G = tile ? 1 : G;
  a.scap = tile ? 1 : scap;
  a.first = tile ? 0 : round * scap;
  a.chunk = chunk;
  a.rpad = tile ? 0 : n * G;
  // parts of at most TILE - 32 rows before their bounds are rounded
  // down to 32: each fits a block's TILE positions
  a.parts = tile ? 0 : (scap + BLZ_M_TILE - 33) / (BLZ_M_TILE - 32);
  a.tiles = tile ? 0 : (scap + BLZ_M_TILE - 1) / BLZ_M_TILE;
  a.table = (const long long*)w[13];
  a.live_out = (uint8_t*)w[11];
  a.live_counts = (unsigned long long*)w[12];
  a.by_value = n <= BLZ_M_MAX_SLOTS && (int64_t)n * np <= BLZ_M_MAX_SRC &&
               np <= BLZ_M_MAX_PLANES;
  const long long* ptrs = w + 16;  // route[n], src[n * np], dst[np]
  const int64_t nptrs = n + (int64_t)n * np + np;
  const int64_t ncount = 2 * (int64_t)n * a.rpad;
  if (a.by_value) {
    for (int s = 0; s < n; ++s) a.route[s] = (const long long*)ptrs[s];
    for (int64_t i = 0; i < (int64_t)n * np; ++i) a.src[i] = (const void*)ptrs[n + i];
    for (int p = 0; p < np; ++p) a.dst[p] = (void*)ptrs[n + (int64_t)n * np + p];
    if (ncount > 0) {
      const int err = blz_stage((const void*)w[14], ncount * 8, (void*)w[13], stream);
      if (err != 0) return err;
    }
  } else {
    std::vector<long long> tab(ncount + nptrs);
    if (ncount > 0) memcpy(tab.data(), (const void*)w[14], ncount * 8);
    memcpy(tab.data() + ncount, ptrs, nptrs * 8);
    const int err = blz_stage(tab.data(), tab.size() * 8, (void*)w[13], stream);
    if (err != 0) return err;
  }
  if (tile) {
    const int64_t total = (int64_t)n * n * chunk;
    blz_mesh_tile_kernel<<<blz_blocks(total), BLZ_THREADS, 0, stream>>>(a, total);
  } else {
    blz_mesh_exchange_kernel<<<(unsigned int)((a.parts + a.tiles) * n * n * G),
                               BLZ_M_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
