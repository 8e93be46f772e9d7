// K8 inner_join_planes: the unique-key inner broadcast hash join, and
// K9 probe_codes: the generic join probe (at the end of this file).
//
// K8:
// Replaces blaze_tpu/ops/joins/bhj.py:_inner_fast_kernel (with its probe,
// keymap.py:canon_word_traced and sorted_probe_traced): for one probe
// batch against a build side whose keys are unique (a dimension table),
//   w    = canonical int64 word of the probe key (integers widen with
//          their sign; floats fold -0.0 into +0.0 and every NaN into the
//          quiet NaN, then f64 is its int64 bits and f32 its int32 bits
//          sign-extended),
//   idx  = lower bound of w in the sorted unique build words uniq[0, nk),
//          compared as signed int64 (the order np.unique gave the build),
//   cidx = clip(idx, 0, max(nk - 1, 0)),
//   hit  = key valid & row < num_rows & idx < nk & uniq[cidx] == w;
// hit rows move to the front in probe order with every probe plane, each
// beside build row clip(cidx, 0, cap_b - 1) of every build plane (code c
// owns build row c: null-keyed build rows sort to the tail). Rows past
// the hit count are padding (data 0, validity False). The count is the
// caller's one sync per batch.
//
// Bound on the H100: bytes. At q06's shape (262,144 probe rows, all
// hitting, 4 columns a side) the probe planes are read once (9.4 MB),
// the build rows they hit are gathered (at most the 102,000-row build,
// 3.7 MB, read once), the sorted keys once (816 KB), and 2 x 4 columns
// of 262,144 rows written (18.9 MB): about 33 MB, ~10 us at 3.35 TB/s.
// The design follows K1 (compact.cu): no atomic hands out an output slot.
//   1. probe: one thread per row, a plain binary search over uniq in
//      device memory (~17 steps at 102,000 keys, served by L2: 816 KB is
//      past a block's 227 KB of shared memory and well inside the 50 MB
//      L2); it writes the row's build row (or -1) and its block's hit
//      count (__syncthreads_count);
//   2. one block scans the block counts into offsets (common.cuh);
//   3. a stable scatter: a warp ballot plus a 32-entry shared-memory scan
//      ranks the hit rows of a block; each hit row writes its probe planes
//      and its build row's planes; rows past the count are zeroed.
// Planes of 1, 2, 4 or 8 bytes go by value in a table of 32 a launch;
// more planes take more scatter launches over the same probe.
// Not done yet: a shared-memory top of the search tree (the first ~14
// levels, 16K keys, fit a block), a direct index when the build keys
// are dense (i_item_sk is 1..N), and vector loads.
#include "common.cuh"

#define BLZ_MAX_JOIN_PLANES 32

// key kinds (core/kernels.py _JOIN_KEY_*)
#define BLZ_JOIN_KEY_INT 0
#define BLZ_JOIN_KEY_FLOAT 1

struct JoinPlanes {
  int n;       // planes in this launch
  int nprobe;  // the first nprobe read probe row i, the rest build row code
  const void* src[BLZ_MAX_JOIN_PLANES];
  void* dst[BLZ_MAX_JOIN_PLANES];
  int size[BLZ_MAX_JOIN_PLANES];
};

__device__ __forceinline__ int64_t blz_canon_word(const void* key, int size,
                                                  int kind, int64_t i) {
  if (kind == BLZ_JOIN_KEY_FLOAT) {
    if (size == 4) {
      uint32_t b = ((const uint32_t*)key)[i];
      const uint32_t mag = b & 0x7fffffffu;
      if (mag == 0u) b = 0u;                        // -0.0 -> +0.0
      else if (mag > 0x7f800000u) b = 0x7fc00000u;  // any NaN -> quiet NaN
      return (int64_t)(int32_t)b;
    }
    unsigned long long b = ((const unsigned long long*)key)[i];
    const unsigned long long mag = b & 0x7fffffffffffffffull;
    if (mag == 0ull) b = 0ull;
    else if (mag > 0x7ff0000000000000ull) b = 0x7ff8000000000000ull;
    return (int64_t)b;
  }
  switch (size) {
    case 1: return (int64_t)((const int8_t*)key)[i];
    case 2: return (int64_t)((const int16_t*)key)[i];
    case 4: return (int64_t)((const int32_t*)key)[i];
    default: return ((const int64_t*)key)[i];
  }
}

// Lower bound of w in uniq[0, nk), signed order; nk when every word is
// smaller.
__device__ __forceinline__ int64_t blz_lower_bound(const int64_t* uniq,
                                                   int64_t nk, int64_t w) {
  int64_t lo = 0, hi = nk;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(&uniq[mid]) < w) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void blz_join_probe_kernel(const int64_t* uniq, int64_t nk,
                                      int64_t num_rows, const void* key,
                                      int key_size, int key_kind,
                                      const uint8_t* key_valid, int64_t cap_p,
                                      int64_t cap_b, int32_t* codes,
                                      int64_t* block_counts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  int64_t row = 0;
  if (i < cap_p && i < num_rows && key_valid[i] != 0) {
    const int64_t w = blz_canon_word(key, key_size, key_kind, i);
    const int64_t idx = blz_lower_bound(uniq, nk, w);
    const int64_t cidx = idx < nk - 1 ? idx : (nk > 0 ? nk - 1 : 0);
    hit = idx < nk && __ldg(&uniq[cidx]) == w;
    row = cidx < cap_b - 1 ? cidx : cap_b - 1;
  }
  if (i < cap_p) codes[i] = hit ? (int32_t)row : -1;
  const int c = __syncthreads_count(hit);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__device__ __forceinline__ void blz_join_copy(const void* src, void* dst,
                                              int size, int64_t from,
                                              int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = ((const uint8_t*)src)[from]; break;
    case 2: ((uint16_t*)dst)[to] = ((const uint16_t*)src)[from]; break;
    case 4: ((uint32_t*)dst)[to] = ((const uint32_t*)src)[from]; break;
    default:
      ((unsigned long long*)dst)[to] = ((const unsigned long long*)src)[from];
      break;
  }
}

__device__ __forceinline__ void blz_join_zero(void* dst, int size, int64_t to) {
  switch (size) {
    case 1: ((uint8_t*)dst)[to] = 0; break;
    case 2: ((uint16_t*)dst)[to] = 0; break;
    case 4: ((uint32_t*)dst)[to] = 0u; break;
    default: ((unsigned long long*)dst)[to] = 0ull; break;
  }
}

__global__ void blz_join_scatter_kernel(const int32_t* codes, int64_t cap_p,
                                        const int64_t* offs, JoinPlanes jp) {
  __shared__ int warp_sums[BLZ_WARPS];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t code = i < cap_p ? codes[i] : -1;
  const bool live = code >= 0;
  const int r = blz_block_rank(live, warp_sums);
  const int64_t total = offs[gridDim.x];
  if (live) {
    const int64_t to = offs[blockIdx.x] + r;
    for (int p = 0; p < jp.n; ++p)
      blz_join_copy(jp.src[p], jp.dst[p], jp.size[p],
                    p < jp.nprobe ? i : (int64_t)code, to);
  }
  if (i < cap_p && i >= total) {
    for (int p = 0; p < jp.n; ++p) blz_join_zero(jp.dst[p], jp.size[p], i);
  }
}

// uniq: max(nk, 1) sorted int64 words; key/key_valid: the probe key's
// data (key_size bytes, key_kind) and validity planes, cap_p rows;
// srcs/dsts/sizes: nplanes planes, the first nprobe of the probe batch
// (cap_p rows), the rest of the build batch (cap_b rows), each written
// to a cap_p-row output; codes: cap_p int32 scratch; offs:
// blz_blocks(cap_p) + 1 int64, offs[blz_blocks(cap_p)] receives the
// count.
BLZ_EXPORT int blz_inner_join(const int64_t* uniq, int64_t nk,
                              int64_t num_rows, const void* key, int key_size,
                              int key_kind, const uint8_t* key_valid,
                              int64_t cap_p, int64_t cap_b, int nprobe,
                              int nplanes, const void* const* srcs,
                              void* const* dsts, const int* sizes,
                              int32_t* codes, int64_t* offs,
                              cudaStream_t stream) {
  if (cap_p <= 0 || cap_b <= 0 || cap_b > 0x7fffffffLL || nk < 0 ||
      nprobe < 0 || nprobe > nplanes)
    return (int)cudaErrorInvalidValue;
  const unsigned int nb = blz_blocks(cap_p);
  blz_join_probe_kernel<<<nb, BLZ_THREADS, 0, stream>>>(
      uniq, nk, num_rows, key, key_size, key_kind, key_valid, cap_p, cap_b,
      codes, offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = blz_scan_block_counts(offs, nb, stream);
  if (err != cudaSuccess) return (int)err;
  for (int p0 = 0; p0 < nplanes; p0 += BLZ_MAX_JOIN_PLANES) {
    JoinPlanes jp;
    jp.n = nplanes - p0 < BLZ_MAX_JOIN_PLANES ? nplanes - p0 : BLZ_MAX_JOIN_PLANES;
    jp.nprobe = nprobe - p0 < 0 ? 0 : (nprobe - p0 < jp.n ? nprobe - p0 : jp.n);
    for (int p = 0; p < jp.n; ++p) {
      jp.src[p] = srcs[p0 + p];
      jp.dst[p] = dsts[p0 + p];
      jp.size[p] = sizes[p0 + p];
    }
    blz_join_scatter_kernel<<<nb, BLZ_THREADS, 0, stream>>>(codes, cap_p,
                                                            offs, jp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// K9 probe_codes: the generic join probe.
//
// Replaces blaze_tpu/ops/joins/keymap.py:_probe_fn (with
// sorted_probe_traced and canon_word_traced): for each of the cap rows of
// a probe key plane,
//   code = idx  if the key is valid and idx < nk and uniq[idx] == w,
//          -1   otherwise,
// with w the canonical word and idx its lower bound in the sorted unique
// build words uniq[0, nk), as K8's probe computes them. The reference
// writes clip(idx, 0, nk - 1) on a hit, which is idx itself. Rows past
// the batch's live rows are padding (validity False) and give -1. The
// codes go to the host, where the CSR pair expansion of the build map
// (ops/joins/keymap.py JoinHashMap.probe) and the outer, semi, anti and
// existence emission run, as in the reference.
//
// Bound on the H100: bytes. Each row reads its key (up to 8 bytes) and
// validity byte and writes an 8-byte code; the sorted keys are read once
// (q69's store window: ~470,000 words, 3.8 MB, L2-resident). At a
// 262,144-row batch that is ~8.3 MB, ~2.5 us at 3.35 TB/s. One thread
// per row runs a plain binary search (~19 dependent L2 loads at 470,000
// keys), which is what bounds it in practice; a shared-memory top of the
// tree is later work, as for K8.
__global__ void blz_probe_codes_kernel(const int64_t* uniq, int64_t nk,
                                       const void* key, int key_size,
                                       int key_kind, const uint8_t* key_valid,
                                       int64_t cap, int64_t* codes) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  int64_t code = -1;
  if (key_valid[i] != 0) {
    const int64_t w = blz_canon_word(key, key_size, key_kind, i);
    const int64_t idx = blz_lower_bound(uniq, nk, w);
    if (idx < nk && __ldg(&uniq[idx]) == w) code = idx;
  }
  codes[i] = code;
}

// uniq: max(nk, 1) sorted int64 words; key/key_valid: the probe key's
// data (key_size bytes, key_kind) and validity planes, cap rows; codes:
// cap int64 outputs.
BLZ_EXPORT int blz_probe_codes(const int64_t* uniq, int64_t nk,
                               const void* key, int key_size, int key_kind,
                               const uint8_t* key_valid, int64_t cap,
                               int64_t* codes, cudaStream_t stream) {
  if (cap <= 0 || nk < 0) return (int)cudaErrorInvalidValue;
  blz_probe_codes_kernel<<<blz_blocks(cap), BLZ_THREADS, 0, stream>>>(
      uniq, nk, key, key_size, key_kind, key_valid, cap, codes);
  return (int)cudaGetLastError();
}
