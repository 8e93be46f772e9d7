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
// K7's split form replaces the exchange's bucketize (a take by the
// partition order, _gather_n, then a _dyn_slice per partition) with one
// launch: output row i of partition p reads source row order[pre[p] + i],
// i < count[p], into p's own planes; the rest of those planes is padding.
// Each element is read once and written once.
//
// Bound on the H100: bytes -- each output element is one read and one
// write, the index (K6) or the prefix search (K7, log2 k steps over a
// table in the kernel's parameters) is all the arithmetic. K7: one thread
// per output row, every plane of the row in the same thread (consecutive
// threads write consecutive rows of a plane); planes of 1, 2, 4 or 8
// bytes. Tables go by value as kernel parameters (under 4 KB); a table
// past that (many sources or partitions) is staged through the library's
// reused pinned host buffers, never uploaded from pageable memory.
//
// K6's design (blz_gather_planes): random gathers bound it (a 32-byte
// sector a row and plane), so it keeps many in flight and keeps the
// gathered planes in L2. The host groups the planes by element size when
// it packs the table, so each size has a loop of its own with no branch on
// the size inside. A thread takes four output rows 256 apart, so every
// index load, gather and store coalesces across the warp (four
// consecutive rows a thread with one vector store a plane measured
// 10-15% slower on an H100); every gather of a batch of eight planes for the four rows is
// issued on the read-only path before the first store; the index is read
// and the outputs written with the streaming hints (evict first). The
// padding rows past the live blocks go to blocks of their own that only
// store zeros (16-byte stores). The table travels by value; past 32 planes
// it is a launch for each 32. The output planes are 16-byte aligned views
// of one allocation (core/kernels.py).
#include "common.cuh"

#define BLZ_MAX_GATHER_PLANES 32
#define BLZ_G_THREADS 256
#define BLZ_G_ROWS 4                               // output rows a thread, THREADS apart
#define BLZ_G_TILE (BLZ_G_THREADS * BLZ_G_ROWS)    // 1,024 rows a live block
#define BLZ_G_ZTILE 4096                           // padding rows a zeroing block
#define BLZ_G_BATCH 8                              // planes whose gathers go out together

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

// One launch's planes, grouped by element size: n8 planes of 8 bytes,
// then n4 of 4, n2 of 2 and n1 of 1.
struct GatherSet {
  int n8, n4, n2, n1;
  const int64_t* idx;
  const uint8_t* live;       // null: every row below n_out is live
  int64_t n_out, out_cap;
  int64_t nlive, live_end;   // blocks of live rows, and the first row past them
  const void* src[BLZ_MAX_GATHER_PLANES];
  void* dst[BLZ_MAX_GATHER_PLANES];
  long long cap[BLZ_MAX_GATHER_PLANES];
};

// The planes [first, first + np) of one element type: BLZ_G_BATCH planes'
// gathers for the thread's rows, then their stores (streaming: the output
// is not read again by this launch, and the gathered planes keep L2).
template <typename T>
__device__ __forceinline__ void blz_gather_rows(const GatherSet& g, int first, int np,
                                                const int64_t* j, const bool* on, int64_t r0) {
  for (int p = first; p < first + np; p += BLZ_G_BATCH) {
    T v[BLZ_G_BATCH][BLZ_G_ROWS];
#pragma unroll
    for (int q = 0; q < BLZ_G_BATCH; ++q) {
      const bool here = p + q < first + np;
      const int pl = here ? p + q : p;
      const T* src = (const T*)g.src[pl];
      const long long cap = g.cap[pl];
#pragma unroll
      for (int i = 0; i < BLZ_G_ROWS; ++i)
        v[q][i] = here && on[i] ? __ldg(src + blz_clip(j[i], cap)) : (T)0;
    }
#pragma unroll
    for (int q = 0; q < BLZ_G_BATCH; ++q) {
      if (p + q >= first + np) break;
      T* dst = (T*)g.dst[p + q];
#pragma unroll
      for (int i = 0; i < BLZ_G_ROWS; ++i) {
        const int64_t r = r0 + (int64_t)i * BLZ_G_THREADS;
        if (r < g.out_cap) __stcs(dst + r, v[q][i]);
      }
    }
  }
}

__global__ void __launch_bounds__(BLZ_G_THREADS)
    blz_gather_kernel(const __grid_constant__ GatherSet g) {
  if (blockIdx.x >= g.nlive) {  // a padding block: zeros over its rows of every plane
    const int64_t from = g.live_end + (int64_t)(blockIdx.x - g.nlive) * BLZ_G_ZTILE;
    const int64_t to = from + BLZ_G_ZTILE < g.out_cap ? from + BLZ_G_ZTILE : g.out_cap;
    const int n = g.n8 + g.n4 + g.n2 + g.n1;
    for (int p = 0; p < n; ++p) {
      const int size = p < g.n8 ? 8 : p < g.n8 + g.n4 ? 4 : p < g.n8 + g.n4 + g.n2 ? 2 : 1;
      blz_zero_bytes((uint8_t*)g.dst[p], from * size, to * size);
    }
    return;
  }
  // rows r0 + i * THREADS: each load and store coalesces across the warp
  const int64_t r0 = (int64_t)blockIdx.x * BLZ_G_TILE + threadIdx.x;
  int64_t j[BLZ_G_ROWS];
  bool on[BLZ_G_ROWS];
#pragma unroll
  for (int i = 0; i < BLZ_G_ROWS; ++i) {
    const int64_t r = r0 + (int64_t)i * BLZ_G_THREADS;
    on[i] = r < g.n_out;
    j[i] = on[i] ? __ldcs((const long long*)g.idx + r) : 0;
  }
  if (g.live != nullptr) {
#pragma unroll
    for (int i = 0; i < BLZ_G_ROWS; ++i)
      on[i] = on[i] && __ldg(g.live + r0 + (int64_t)i * BLZ_G_THREADS) != 0;
  }
  blz_gather_rows<unsigned long long>(g, 0, g.n8, j, on, r0);
  blz_gather_rows<unsigned int>(g, g.n8, g.n4, j, on, r0);
  blz_gather_rows<unsigned short>(g, g.n8 + g.n4, g.n2, j, on, r0);
  blz_gather_rows<unsigned char>(g, g.n8 + g.n4 + g.n2, g.n1, j, on, r0);
}

// w: int64 words [n_out, out_cap, idx (n_out int64), live (n_out bytes, or
// 0), stream, nplanes, then per plane (src, dst, src rows, element
// bytes)]. Every dst is a 16-byte aligned plane of out_cap rows. The
// planes go grouped by size, 32 a launch.
BLZ_EXPORT int blz_gather_planes(const long long* w) {
  const int64_t n_out = w[0], out_cap = w[1];
  const int nplanes = (int)w[5];
  cudaStream_t stream = (cudaStream_t)w[4];
  if (out_cap <= 0 || n_out < 0 || n_out > out_cap || nplanes < 0)
    return (int)cudaErrorInvalidValue;
  const long long* pw = w + 6;
  for (int p = 0; p < nplanes; ++p) {
    const long long* e = pw + 4 * (int64_t)p;
    if (e[2] <= 0 || (e[1] & 15) != 0 || (e[3] != 1 && e[3] != 2 && e[3] != 4 && e[3] != 8))
      return (int)cudaErrorInvalidValue;
  }
  GatherSet g;
  g.idx = (const int64_t*)w[2];
  g.live = (const uint8_t*)w[3];
  g.n_out = n_out;
  g.out_cap = out_cap;
  g.nlive = (n_out + BLZ_G_TILE - 1) / BLZ_G_TILE;
  g.live_end = g.nlive * BLZ_G_TILE < out_cap ? g.nlive * BLZ_G_TILE : out_cap;
  const int64_t nzero = (out_cap - g.live_end + BLZ_G_ZTILE - 1) / BLZ_G_ZTILE;
  int counts[4] = {0, 0, 0, 0};
  int taken = 0;
  auto launch = [&]() -> int {
    g.n8 = counts[0];
    g.n4 = counts[1];
    g.n2 = counts[2];
    g.n1 = counts[3];
    blz_gather_kernel<<<(unsigned int)(g.nlive + nzero), BLZ_G_THREADS, 0, stream>>>(g);
    counts[0] = counts[1] = counts[2] = counts[3] = 0;
    taken = 0;
    return (int)cudaGetLastError();
  };
  // the planes size by size (8, 4, 2, 1 bytes), each size in plane order;
  // a launch for every 32 of them
  static const long long kSizes[4] = {8, 4, 2, 1};
  for (int c = 0; c < 4; ++c)
    for (int p = 0; p < nplanes; ++p) {
      const long long* e = pw + 4 * (int64_t)p;
      if (e[3] != kSizes[c]) continue;
      g.src[taken] = (const void*)e[0];
      g.dst[taken] = (void*)e[1];
      g.cap[taken] = e[2];
      ++counts[c];
      if (++taken == BLZ_MAX_GATHER_PLANES) {
        const int err = launch();
        if (err != 0) return err;
      }
    }
  return taken > 0 ? launch() : 0;
}

// -- pinned staging of a table past the parameter limits ----------------------

#include <mutex>
#include <string.h>

namespace {
// A ring of pinned buffers, each refilled only after its last copy has
// finished: a caller waits on the copy BLZ_PINNED_RING stagings back,
// not on the one just before (which runs behind the previous kernel).
#define BLZ_PINNED_RING 4
struct BlzPinned {
  void* host = nullptr;
  size_t cap = 0;
  cudaEvent_t done = nullptr;
  bool pending = false;
};
std::mutex g_pinned_mu;
BlzPinned g_pinned[BLZ_PINNED_RING];
int g_pinned_next = 0;
}  // namespace

// Copies ``bytes`` of ``src`` (host) to ``dev`` on ``stream`` through the
// next pinned buffer of the ring: the copy is asynchronous, and a buffer
// is refilled only after its previous copy has finished (common.cuh; K7's
// tables here, K17's in mesh.cu).
int blz_stage(const void* src, size_t bytes, void* dev, cudaStream_t stream) {
  std::lock_guard<std::mutex> guard(g_pinned_mu);
  BlzPinned& b = g_pinned[g_pinned_next];
  g_pinned_next = (g_pinned_next + 1) % BLZ_PINNED_RING;
  cudaError_t err = cudaSuccess;
  if (b.done == nullptr) {
    err = cudaEventCreateWithFlags(&b.done, cudaEventDisableTiming);
    if (err != cudaSuccess) return (int)err;
  }
  if (b.pending) {
    err = cudaEventSynchronize(b.done);
    if (err != cudaSuccess) return (int)err;
    b.pending = false;
  }
  if (bytes > b.cap) {
    if (b.host != nullptr) cudaFreeHost(b.host);
    b.host = nullptr;
    b.cap = 0;
    const size_t want = bytes < (size_t)65536 ? (size_t)65536 : 2 * bytes;
    err = cudaHostAlloc(&b.host, want, cudaHostAllocDefault);
    if (err != cudaSuccess) return (int)err;
    b.cap = want;
  }
  memcpy(b.host, src, bytes);
  err = cudaMemcpyAsync(dev, b.host, bytes, cudaMemcpyHostToDevice, stream);
  if (err == cudaSuccess) err = cudaEventRecord(b.done, stream);
  if (err != cudaSuccess) return (int)err;
  b.pending = true;
  return 0;
}

// -- K7 slice and concat -----------------------------------------------------------

// The by-value table: k <= 8 sources, np <= 32 planes, np * k <= 128.
#define BLZ_CAT_MAX_SRC 8
#define BLZ_CAT_MAX_PLANES 32
#define BLZ_CAT_MAX_REFS 128

struct CatTable {
  int k, np;
  long long prefix[BLZ_CAT_MAX_SRC + 1];      // output row where source b starts
  long long start[BLZ_CAT_MAX_SRC];           // its first source row
  unsigned long long dst[BLZ_CAT_MAX_PLANES];
  int size[BLZ_CAT_MAX_PLANES];
  unsigned long long src[BLZ_CAT_MAX_REFS];   // plane p of source b at p * k + b
  long long cap[BLZ_CAT_MAX_REFS];
};

// One thread an output row, every plane of it: the row's source from the
// by-value table (a linear search over at most 8 sources), 0 past the
// total. (16-byte vector loads and stores, one thread a 16-byte chunk of
// a plane, measured slower at the main path's shapes.)
__global__ void blz_concat_row_kernel(CatTable t, int64_t out_cap) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= out_cap) return;
  const bool on = r < t.prefix[t.k];
  int b = 0;
  if (on)
    while (b + 1 < t.k && t.prefix[b + 1] <= r) ++b;
  const int64_t row = on ? t.start[b] + r - t.prefix[b] : 0;
  for (int p = 0; p < t.np; ++p) {
    const int at = p * t.k + b;
    blz_move((const void*)t.src[at], (void*)t.dst[p], t.size[p], blz_clip(row, t.cap[at]),
             r, on);
  }
}

// The staged table (int64 words) of any size: for k sources and np planes,
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

// w: int64 words [k, np, out_cap, then the staged table's layout above].
// Tables within CatTable's limits go by value; larger ones are staged
// into ``dev_table`` (the table's words, on the card) through the pinned
// buffer.
BLZ_EXPORT int blz_concat_planes(const long long* w, long long* dev_table,
                                 cudaStream_t stream) {
  const int k = (int)w[0], np = (int)w[1];
  const int64_t out_cap = w[2];
  if (k <= 0 || np <= 0 || out_cap <= 0) return (int)cudaErrorInvalidValue;
  const long long* tab = w + 3;
  const long long* prefix = tab;
  const long long* start = prefix + k + 1;
  const long long* dst = start + k;
  const long long* size = dst + np;
  const long long* src = size + np;
  const long long* cap = src + (int64_t)np * k;
  for (int p = 0; p < np; ++p)
    if (size[p] != 1 && size[p] != 2 && size[p] != 4 && size[p] != 8)
      return (int)cudaErrorInvalidValue;
  if (k <= BLZ_CAT_MAX_SRC && np <= BLZ_CAT_MAX_PLANES && np * k <= BLZ_CAT_MAX_REFS) {
    CatTable t;
    t.k = k;
    t.np = np;
    for (int b = 0; b <= k; ++b) t.prefix[b] = prefix[b];
    for (int b = 0; b < k; ++b) t.start[b] = start[b];
    for (int p = 0; p < np; ++p) {
      t.dst[p] = (unsigned long long)dst[p];
      t.size[p] = (int)size[p];
    }
    for (int i = 0; i < np * k; ++i) {
      t.src[i] = (unsigned long long)src[i];
      t.cap[i] = cap[i];
      if (cap[i] <= 0) return (int)cudaErrorInvalidValue;
    }
    blz_concat_row_kernel<<<blz_blocks(out_cap), BLZ_THREADS, 0, stream>>>(t, out_cap);
    return (int)cudaGetLastError();
  }
  if (dev_table == nullptr) return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)(2 * k + 1 + 2 * np + 2 * (int64_t)np * k);
  const int err = blz_stage(tab, words * 8, dev_table, stream);
  if (err != 0) return err;
  blz_concat_kernel<<<blz_blocks(out_cap), BLZ_THREADS, 0, stream>>>(
      dev_table, k, np, out_cap);
  return (int)cudaGetLastError();
}

// -- K7 split: the exchange's bucketize in one launch -------------------------------

#define BLZ_SPLIT_MAX_PLANES 32
#define BLZ_SPLIT_MAX_PARTS 64
#define BLZ_SPLIT_MAX_DSTS 256

struct SplitPlanes {
  int np, j0, np_all;                    // this launch's planes, the first, all
  unsigned long long src[BLZ_SPLIT_MAX_PLANES];
  long long cap[BLZ_SPLIT_MAX_PLANES];   // source rows of the plane
  int size[BLZ_SPLIT_MAX_PLANES];
};

// Per partition, by value up to 64 partitions and 256 output planes:
// where its rows start in the output's row space (the sum of the earlier
// partitions' capacities), where they start in the order, and its
// output planes (partition p's plane j at p * np_all + j).
struct SplitParts {
  long long rowpre[BLZ_SPLIT_MAX_PARTS + 1];
  long long pre[BLZ_SPLIT_MAX_PARTS + 1];
  unsigned long long dst[BLZ_SPLIT_MAX_DSTS];
};

// One thread an output row of one partition (the partitions' capacities
// laid end to end), every plane of it. ``parts`` null: the by-value table
// ``pv``; else the staged words [rowpre P+1][pre P+1][dst P * np_all].
__global__ void blz_split_kernel(const int64_t* order, SplitPlanes pl,
                                 const __grid_constant__ SplitParts pv,
                                 const long long* parts, int nparts) {
  const long long* rowpre = parts ? parts : pv.rowpre;
  const long long* pre = parts ? parts + nparts + 1 : pv.pre;
  const unsigned long long* dst =
      parts ? (const unsigned long long*)(parts + 2 * (nparts + 1)) : pv.dst;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rowpre[nparts]) return;
  int lo = 0, hi = nparts - 1;  // last p with rowpre[p] <= r
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rowpre[mid] <= r) lo = mid; else hi = mid - 1;
  }
  const int p = lo;
  const int64_t i = r - rowpre[p];
  const bool on = i < pre[p + 1] - pre[p];
  const int64_t row = on ? order[pre[p] + i] : 0;
  const unsigned long long* out = dst + (int64_t)p * pl.np_all + pl.j0;
  for (int j = 0; j < pl.np; ++j)
    blz_move((const void*)pl.src[j], (void*)out[j], pl.size[j], blz_clip(row, pl.cap[j]),
             i, on);
}

// w: int64 words [np, nparts, order, then per plane (src, cap, size), then
// rowpre[P + 1], pre[P + 1], dst[P * np]]. Tables within SplitParts go by
// value; larger ones are staged into ``dev_parts`` (the words from
// rowpre on, on the card) through the pinned buffer. Planes go 32 a
// launch.
BLZ_EXPORT int blz_split_planes(const long long* w, long long* dev_parts,
                                cudaStream_t stream) {
  const int np = (int)w[0], nparts = (int)w[1];
  const int64_t* order = (const int64_t*)w[2];
  if (np <= 0 || nparts <= 0) return (int)cudaErrorInvalidValue;
  const long long* pw = w + 3;
  const long long* pt = pw + 3 * (int64_t)np;
  const long long* rowpre = pt;
  const long long* pre = pt + nparts + 1;
  const long long* dsts = pt + 2 * (nparts + 1);
  const int64_t rows = rowpre[nparts];
  if (rows <= 0) return 0;
  SplitParts pv;
  memset(&pv, 0, sizeof pv);
  const long long* parts = nullptr;
  if (nparts <= BLZ_SPLIT_MAX_PARTS && (int64_t)nparts * np <= BLZ_SPLIT_MAX_DSTS) {
    for (int q = 0; q <= nparts; ++q) {
      pv.rowpre[q] = rowpre[q];
      pv.pre[q] = pre[q];
    }
    for (int i = 0; i < nparts * np; ++i) pv.dst[i] = (unsigned long long)dsts[i];
  } else {
    if (dev_parts == nullptr) return (int)cudaErrorInvalidValue;
    const size_t words = (size_t)(2 * (nparts + 1)) + (size_t)nparts * np;
    const int err = blz_stage(pt, words * 8, dev_parts, stream);
    if (err != 0) return err;
    parts = dev_parts;
  }
  for (int j0 = 0; j0 < np; j0 += BLZ_SPLIT_MAX_PLANES) {
    SplitPlanes pl;
    pl.np = np - j0 < BLZ_SPLIT_MAX_PLANES ? np - j0 : BLZ_SPLIT_MAX_PLANES;
    pl.j0 = j0;
    pl.np_all = np;
    for (int j = 0; j < pl.np; ++j) {
      const long long* e = pw + 3 * (int64_t)(j0 + j);
      pl.src[j] = (unsigned long long)e[0];
      pl.cap[j] = e[1];
      pl.size[j] = (int)e[2];
      if (pl.cap[j] <= 0 || (pl.size[j] != 1 && pl.size[j] != 2 && pl.size[j] != 4 &&
                             pl.size[j] != 8))
        return (int)cudaErrorInvalidValue;
    }
    blz_split_kernel<<<blz_blocks(rows), BLZ_THREADS, 0, stream>>>(order, pl, pv, parts,
                                                                    nparts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
