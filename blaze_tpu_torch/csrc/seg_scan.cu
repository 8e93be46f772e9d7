// K13 segment_scan: the window aggregates' segmented (sum, count) prefix
// scan with a carry.
//
// Replaces blaze_tpu/core/kernels.py:_seg_scan (driven by
// segment_scan_planes, :490), which WindowExec._seg_agg_scan
// (blaze_tpu/ops/window.py:394) runs once per batch and SUM/AVG/COUNT
// window aggregate over a device column. Over the batch's capacity-long
// planes it computes, per row i,
//   si    = the last index <= i where seg_start holds (-1 if none),
//   cs    = inclusive prefix sum of data where validity & exists (else 0),
//   cc    = inclusive prefix count of validity & exists,
//   out_s = cs[i] - (si >= 1 ? cs[si - 1] : 0) + (si < 0 ? carry_sum : 0),
//   out_c = cc[i] - (si >= 1 ? cc[si - 1] : 0) + (si < 0 ? carry_cnt : 0),
// integer data summed in int64 (wrapping), float32 and float64 in their
// own type. The "+ 0" on rows past the first start is kept, as XLA keeps
// it (it turns -0.0 into +0.0).
//
// Float sums must be bit-equal to the reference, so the prefix follows
// the order XLA on the CPU gives jnp.cumsum: sequential inclusive
// prefixes inside 16-row blocks (the plane zero-padded to a multiple of
// 16, and the padding added too), the block totals scanned the same way,
// recursively, and each block's exclusive prefix (0 for the first block)
// added to its rows wherever a level has more than one block. The
// design is that order, level by level:
//   up:    one thread per 16-element block of a level: its sequential
//          prefix (in place above level 0) and its total into the next
//          level; 262,144 rows give levels of 16,384, 1,024, 64, 4 and 1;
//   down:  from the top, each level with more than one block adds the
//          finished level above's exclusive prefix to its elements;
//   rows:  one thread per row adds level 1's prefix to its own and to its
//          segment base's in-block prefix on the fly, then subtracts and
//          adds the carry.
// The count and the start index (a max-scan of i where seg_start holds,
// -1 elsewhere) ride in the same passes; both are exact in any order.
// Every float add and subtract is __dadd_rn / __fadd_rn / __dsub_rn /
// __fsub_rn, so no FMA contraction or reassociation creeps in.
//
// Bound on the H100: bytes. A row reads data (up to 8 bytes), validity,
// exists and seg_start once and writes an 8-byte sum and an 8-byte count:
// 27 bytes a float64 row. This simple version also writes and rereads
// the row-level prefixes (24 bytes a row), and level 0's threads each read
// 16 consecutive rows, so neighbouring threads do not touch neighbouring
// words; a warp-cooperative level 0 is the next step.
#include "common.cuh"

enum { BLZ_SCAN_I64 = 0, BLZ_SCAN_I32 = 1, BLZ_SCAN_I16 = 2, BLZ_SCAN_I8 = 3,
       BLZ_SCAN_F32 = 4, BLZ_SCAN_F64 = 5 };

#define BLZ_SCAN_BLOCK 16

__device__ __forceinline__ double blz_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float blz_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ long long blz_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ double blz_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float blz_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ long long blz_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

// One thread's 16-element block of a level: the sequential inclusive
// prefix of (sum, count, start index) over the elements ``load(i, &v, &c,
// &t)`` gives, stored to ps, pc, pt, and, when there is a level above, the
// block's totals to up_s, up_c, up_t. Elements past ``m`` add 0 (and -1),
// as XLA's zero padding does. Both kernels below run this one loop, so
// the float association is written once.
template <typename Acc, typename Load>
__device__ __forceinline__ void blz_scan_block(int64_t b, int64_t m, Load load, Acc* ps,
                                               long long* pc, long long* pt, Acc* up_s,
                                               long long* up_c, long long* up_t,
                                               int write_up) {
  Acc s = Acc(0);
  long long c = 0, t = -1;
  for (int j = 0; j < BLZ_SCAN_BLOCK; ++j) {
    const int64_t i = b * BLZ_SCAN_BLOCK + j;
    Acc v = Acc(0);
    long long vc = 0, vt = -1;
    if (i < m) load(i, &v, &vc, &vt);
    s = j == 0 ? v : blz_add(s, v);
    c += vc;
    t = vt > t ? vt : t;
    if (i < m) {
      ps[i] = s;
      pc[i] = c;
      pt[i] = t;
    }
  }
  if (write_up) {
    up_s[b] = s;
    up_c[b] = c;
    up_t[b] = t;
  }
}

// Level 0: each thread scans one 16-row block of the masked data, the
// validity count and the start index, writes the in-block prefixes of its
// live rows and, when there is a level above, the block's totals.
template <typename In, typename Acc>
__global__ void blz_scan_rows_kernel(const In* data, const bool* validity,
                                     const bool* exists, const bool* seg_start,
                                     int64_t n, Acc* cs, long long* cc,
                                     long long* st, Acc* up_s, long long* up_c,
                                     long long* up_t, int write_up) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (n + BLZ_SCAN_BLOCK - 1) / BLZ_SCAN_BLOCK) return;
  blz_scan_block<Acc>(
      b, n,
      [=](int64_t i, Acc* v, long long* vc, long long* vt) {
        if (validity[i] && exists[i]) {
          *v = (Acc)data[i];
          *vc = 1;
        }
        if (seg_start[i]) *vt = i;
      },
      cs, cc, st, up_s, up_c, up_t, write_up);
}

// A level above the rows: the same scan, in place over ``m`` totals.
template <typename Acc>
__global__ void blz_scan_level_kernel(Acc* ls, long long* lc, long long* lt,
                                      int64_t m, Acc* up_s, long long* up_c,
                                      long long* up_t, int write_up) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (m + BLZ_SCAN_BLOCK - 1) / BLZ_SCAN_BLOCK) return;
  blz_scan_block<Acc>(
      b, m,
      [=](int64_t i, Acc* v, long long* vc, long long* vt) {
        *v = ls[i];
        *vc = lc[i];
        *vt = lt[i];
      },
      ls, lc, lt, up_s, up_c, up_t, write_up);
}

// Down-sweep of a level with more than one block: every element adds the
// finished level above's exclusive prefix (0, and -1 for the start index,
// in the first block).
template <typename Acc>
__global__ void blz_scan_down_kernel(Acc* ls, long long* lc, long long* lt,
                                     int64_t m, const Acc* up_s,
                                     const long long* up_c, const long long* up_t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t b = i / BLZ_SCAN_BLOCK;
  const Acc es = b ? up_s[b - 1] : Acc(0);
  const long long ec = b ? up_c[b - 1] : 0;
  const long long et = b ? up_t[b - 1] : -1;
  ls[i] = blz_add(ls[i], es);
  lc[i] += ec;
  lt[i] = et > lt[i] ? et : lt[i];
}

// The finished row-level prefixes of row i: level 0's in-block prefix
// plus level 1's exclusive prefix, when level 0 has more than one block.
template <typename Acc>
__device__ __forceinline__ void blz_row_prefix(int64_t i, const Acc* cs,
                                               const long long* cc,
                                               const long long* st,
                                               const Acc* l1s, const long long* l1c,
                                               const long long* l1t, int multi,
                                               Acc* s, long long* c, long long* t) {
  *s = cs[i];
  *c = cc[i];
  *t = st[i];
  if (multi) {
    const int64_t b = i / BLZ_SCAN_BLOCK;
    *s = blz_add(*s, b ? l1s[b - 1] : Acc(0));
    *c += b ? l1c[b - 1] : 0;
    const long long et = b ? l1t[b - 1] : -1;
    *t = et > *t ? et : *t;
  }
}

template <typename Acc>
__global__ void blz_scan_out_kernel(const Acc* cs, const long long* cc,
                                    const long long* st, const Acc* l1s,
                                    const long long* l1c, const long long* l1t,
                                    int multi, int64_t n, Acc carry_s,
                                    long long carry_c, Acc* out_s,
                                    long long* out_c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Acc s;
  long long c, si;
  blz_row_prefix(i, cs, cc, st, l1s, l1c, l1t, multi, &s, &c, &si);
  Acc base_s = Acc(0);
  long long base_c = 0;
  if (si >= 1) {
    long long unused;
    blz_row_prefix(si - 1, cs, cc, st, l1s, l1c, l1t, multi, &base_s, &base_c, &unused);
  }
  const bool head = si < 0;
  out_s[i] = blz_add(blz_sub(s, base_s), head ? carry_s : Acc(0));
  out_c[i] = c - base_c + (head ? carry_c : 0);
}

template <typename In, typename Acc>
static int blz_segment_scan_run(const In* data, const bool* validity,
                                const bool* exists, const bool* seg_start,
                                int64_t n, Acc carry_s, long long carry_c,
                                long long* rows, long long* levels,
                                Acc* out_s, long long* out_c,
                                cudaStream_t stream) {
  // level sizes: m[0] = n rows, m[k + 1] = ceil(m[k] / 16), until 1
  int64_t m[24];
  int64_t off[24];
  int nlev = 1;
  m[0] = n;
  int64_t words = 0;
  while (m[nlev - 1] > 1) {
    if (nlev >= 24) return (int)cudaErrorInvalidValue;
    m[nlev] = (m[nlev - 1] + BLZ_SCAN_BLOCK - 1) / BLZ_SCAN_BLOCK;
    off[nlev] = words;
    words += m[nlev];
    ++nlev;
  }
  if (words < 1) words = 1;
  // rows: cs, cc, st over n words each; levels: sums, counts, starts over
  // ``words`` words each (a float level uses the first half of its words)
  Acc* cs = reinterpret_cast<Acc*>(rows);
  long long* cc = rows + n;
  long long* st = rows + 2 * n;
  Acc* ls = reinterpret_cast<Acc*>(levels);
  long long* lc = levels + words;
  long long* lt = levels + 2 * words;
  const int threads = 256;
  const int has_up = nlev > 1;
  {
    const int64_t nblk = (n + BLZ_SCAN_BLOCK - 1) / BLZ_SCAN_BLOCK;
    blz_scan_rows_kernel<In, Acc><<<(unsigned)((nblk + threads - 1) / threads), threads, 0,
                                    stream>>>(
        data, validity, exists, seg_start, n, cs, cc, st,
        has_up ? ls + off[1] : nullptr, has_up ? lc + off[1] : nullptr,
        has_up ? lt + off[1] : nullptr, has_up);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  for (int k = 1; k < nlev; ++k) {
    const int up = k + 1 < nlev;
    const int64_t nblk = (m[k] + BLZ_SCAN_BLOCK - 1) / BLZ_SCAN_BLOCK;
    blz_scan_level_kernel<Acc><<<(unsigned)((nblk + threads - 1) / threads), threads, 0,
                                 stream>>>(
        ls + off[k], lc + off[k], lt + off[k], m[k], up ? ls + off[k + 1] : nullptr,
        up ? lc + off[k + 1] : nullptr, up ? lt + off[k + 1] : nullptr, up);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // levels with more than one block, from the top down (level 0 is
  // finished on the fly by the row kernel)
  for (int k = nlev - 2; k >= 1; --k) {
    if (m[k + 1] <= 1) continue;
    blz_scan_down_kernel<Acc><<<(unsigned)((m[k] + threads - 1) / threads), threads, 0,
                                stream>>>(ls + off[k], lc + off[k], lt + off[k], m[k],
                                          ls + off[k + 1], lc + off[k + 1],
                                          lt + off[k + 1]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int multi = nlev > 1 && m[1] > 1;
  blz_scan_out_kernel<Acc><<<blz_blocks(n), BLZ_THREADS, 0, stream>>>(
      cs, cc, st, has_up ? ls + off[1] : nullptr, has_up ? lc + off[1] : nullptr,
      has_up ? lt + off[1] : nullptr, multi, n, carry_s, carry_c, out_s, out_c);
  return (int)cudaGetLastError();
}

// data: ``kind`` (BLZ_SCAN_*) over n rows; validity, exists, seg_start:
// bool planes of n rows; carry_f is the carried sum of a float plane,
// carry_i of an integer one; rows: 3 * n int64 words of scratch; levels:
// 3 * W int64 words, W = the level totals' count (n/16 + n/256 + ... + 1,
// each rounded up; at least 1); out_s: n sums (int64 for integer kinds,
// else the data's type); out_c: n int64 counts.
BLZ_EXPORT int blz_segment_scan(const void* data, int kind, const bool* validity,
                                const bool* exists, const bool* seg_start, int64_t n,
                                double carry_f, long long carry_i, long long carry_c,
                                long long* rows, long long* levels, void* out_s,
                                long long* out_c, cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case BLZ_SCAN_I64:
      return blz_segment_scan_run<long long, long long>(
          (const long long*)data, validity, exists, seg_start, n, carry_i, carry_c, rows,
          levels, (long long*)out_s, out_c, stream);
    case BLZ_SCAN_I32:
      return blz_segment_scan_run<int, long long>(
          (const int*)data, validity, exists, seg_start, n, carry_i, carry_c, rows, levels,
          (long long*)out_s, out_c, stream);
    case BLZ_SCAN_I16:
      return blz_segment_scan_run<short, long long>(
          (const short*)data, validity, exists, seg_start, n, carry_i, carry_c, rows,
          levels, (long long*)out_s, out_c, stream);
    case BLZ_SCAN_I8:
      return blz_segment_scan_run<signed char, long long>(
          (const signed char*)data, validity, exists, seg_start, n, carry_i, carry_c, rows,
          levels, (long long*)out_s, out_c, stream);
    case BLZ_SCAN_F32:
      return blz_segment_scan_run<float, float>(
          (const float*)data, validity, exists, seg_start, n, (float)carry_f, carry_c, rows,
          levels, (float*)out_s, out_c, stream);
    case BLZ_SCAN_F64:
      return blz_segment_scan_run<double, double>(
          (const double*)data, validity, exists, seg_start, n, carry_f, carry_c, rows,
          levels, (double*)out_s, out_c, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
