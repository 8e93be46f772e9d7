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
// once: it sets scap and the number of rounds), so no atomic places a row.
//
// Tile mode (tile = 1) is exchange_and_aggregate's (n, capacity) masked
// tiles (:91-101): chunk is the slots' common capacity, route_s holds slot
// s's int64 reducer id per row (n where the row goes nowhere), and the
// position is live when route_s[q] == d, holding row q.
//
// A live position copies each plane's bytes of its row (planes of 1, 2, 4
// or 8 bytes: data and validity alike); a dead one writes 0 to every plane
// (data 0, validity False) and live_out[pos] is the live flag (the
// reference's live plane). live_counts[d] (zeroed by the caller) gains the
// live positions slot d receives: one warp-aggregated atomic add per run of
// lanes with the same destination.
//
// Bound on the H100: bytes. Every output position is written once per
// plane and the live plane once; every live row of every plane is read
// once, through its 8-byte route entry; the counts and starts (2 n Rpad
// words) stay in L1/L2. One thread per output position: writes are
// coalesced, reads are gathers within a segment (rows of one reducer,
// ascending), which is what bounds it in practice.
#include "common.cuh"

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

// The table (int64 words, built and uploaded by the wrapper), for n slots,
// np planes a slot and rpad = n * G reducer slots:
//   counts[n * rpad], starts[n * rpad]   exchange mode only (else absent)
//   route[n]                             per source slot (0: an empty slot)
//   src[n * np]                          plane p of slot s at s * np + p
//   dst[np], size[np]                    output planes, element bytes
__global__ void blz_mesh_a2a_kernel(const long long* __restrict__ table, int n, int np,
                                    int64_t rpad, int64_t G, int64_t scap,
                                    int64_t first, int tile, int64_t chunk,
                                    int64_t total, uint8_t* live_out,
                                    unsigned long long* live_counts) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = pos < total;
  const int64_t seg_len = (int64_t)n * chunk;
  const long long* counts = table;
  const long long* starts = counts + (tile ? 0 : (int64_t)n * rpad);
  const long long* route = starts + (tile ? 0 : (int64_t)n * rpad);
  const long long* src = route + n;
  const long long* dst = src + (int64_t)n * np;
  const long long* size = dst + np;
  int d = n;  // lanes past the end count for no slot
  int s = 0;
  bool live = false;
  int64_t row = 0;
  if (in) {
    d = (int)(pos / seg_len);
    const int64_t rem = pos - (int64_t)d * seg_len;
    s = (int)(rem / chunk);
    const int64_t q = rem - (int64_t)s * chunk;
    const long long* rt = (const long long*)__ldg(&route[s]);
    if (rt != nullptr) {
      if (tile) {
        live = __ldg(&rt[q]) == (long long)d;
        row = q;
      } else {
        const int64_t seg = q / scap;
        const int64_t k = first + (q - seg * scap);
        const int64_t at = (int64_t)s * rpad + (int64_t)d * G + seg;
        if (k < __ldg(&counts[at])) {
          live = true;
          row = __ldg(&rt[__ldg(&starts[at]) + k]);
        }
      }
    }
  }
  const unsigned lane = threadIdx.x & 31u;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const unsigned same = __match_any_sync(0xffffffffu, d);
  if (in && lane == (unsigned)(__ffs(same) - 1)) {
    const int c = __popc(ballot & same);
    if (c) atomicAdd(&live_counts[d], (unsigned long long)c);
  }
  if (!in) return;
  live_out[pos] = live ? 1 : 0;
  for (int p = 0; p < np; ++p) {
    const int64_t at = (int64_t)s * np + p;
    blz_mesh_move((const void*)__ldg(&src[at]), (void*)__ldg(&dst[p]),
                  (int)__ldg(&size[p]), row, pos, live);
  }
}

// table: device int64 words laid out as above; chunk: rows a slot sends to
// each slot (G * scap, or the capacity in tile mode); round: the round t;
// live_out: n * n * chunk bytes; live_counts: n zeroed words.
BLZ_EXPORT int blz_mesh_all_to_all(const long long* table, int n, int nplanes,
                                   int64_t rpad, int64_t G, int64_t scap, int64_t round,
                                   int tile, int64_t chunk, uint8_t* live_out,
                                   long long* live_counts, cudaStream_t stream) {
  if (n <= 0 || nplanes < 0 || chunk <= 0 || round < 0) return (int)cudaErrorInvalidValue;
  if (!tile && (G <= 0 || scap <= 0 || rpad != (int64_t)n * G || chunk != G * scap))
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * n * chunk;
  blz_mesh_a2a_kernel<<<blz_blocks(total), BLZ_THREADS, 0, stream>>>(
      table, n, nplanes, rpad, G, scap, round * scap, tile, chunk, total, live_out,
      (unsigned long long*)live_counts);
  return (int)cudaGetLastError();
}
