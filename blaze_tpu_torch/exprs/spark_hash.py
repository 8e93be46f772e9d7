"""Spark-exact row hashing: Murmur3_x86_32 (seed 42) with pmod routing
(K2) and XXH64 (seed 42, K15).

``murmur3_pmod`` launches the hand-written kernel (csrc/murmur3.cu) on a
CUDA tensor and runs ``murmur3_pmod_plain`` on a CPU tensor;
``xxhash64_rows`` does the same with csrc/xxhash64.cu and
``xxhash64_rows_plain``. Semantics, as blaze_tpu/exprs/spark_hash.py
(``murmur3_update_column`` / ``xxhash64_update_column`` folded by
``_hash_device_run``) and the pmod of ``HashPartitioner``:

- multi-column hashing chains: each row's running hash is the seed for the
  next column; a NULL value leaves the hash unchanged;
- int8/16/32, date and bool hash as a 4-byte int (hashInt of the value
  sign-extended; a bool is 0 or 1), float32 as its 4-byte bit pattern;
  int64, timestamp, decimal(p<=18) (unscaled) hash as 8 bytes (hashLong:
  low word, then high word), float64 as its bit pattern. K2 and its twin
  read bool, int8 and int16 planes at their own width (``hash_words``);
  K15 takes them widened to int32;
- partition id = ((int32) hash mod n + n) mod n;
- XXH64 hashes a 4-byte word with XXH64's 4-byte tail round and an
  8-byte word with its 8-byte round, then the avalanche; floats hash as
  their raw bits (no -0.0 or NaN normalisation, as the reference).

The plain versions compute in int64 with ``& 0xFFFFFFFF`` masks: PyTorch
on the CPU has no uint32 or uint64 shift or add, and signed int64
overflow is not relied on, so XXH64's 64-bit words are (hi, lo) pairs of
32-bit halves.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import torch

from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.utils import cuda_lib

SEED = 42
_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def hash_kind(dt: T.DataType) -> str:
    """"i64" for 8-byte words (int64, timestamp, decimal<=18, float64),
    "i32" for 4-byte ones."""
    if isinstance(dt, (T.Int64Type, T.TimestampType, T.DecimalType, T.Float64Type)):
        return "i64"
    return "i32"


def hash_words(data: torch.Tensor, kind: str) -> torch.Tensor:
    """The column's hash words at their own width: a bool, int8, int16 or
    int32 plane as it is (K2 and its twin sign-extend to 32 bits; a bool is
    0 or 1), float32 bit-cast to int32, float64 to int64, an "i64" integer
    plane as int64."""
    if kind == "i64":
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data if data.dtype == torch.int64 else data.to(torch.int64)
    if data.dtype == torch.float32:
        return data.view(torch.int32)
    return data


def xxhash_words(words: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``hash_words``' planes as K15 takes them: a bool, int8 or int16
    plane widened to int32 (the same hashInt words)."""
    return [w.to(torch.int32) if w.element_size() < 4 else w for w in words]


# -- plain version (int64 arithmetic on 32-bit lanes) --------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    # exact low 32 bits of a * c for a, c < 2^32: split c so every partial
    # product stays below 2^63
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    return _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def murmur3_int64(values: torch.Tensor, seeds) -> torch.Tensor:
    """Spark's hashLong (Murmur3_x86_32 of the 8 little-endian bytes: the
    low word, then the high word, then ``fmix(h, 8)``) of int64 ``values``
    under per-row (or one) uint32 ``seeds``: uint32 values in int64 lanes."""
    v = values.to(torch.int64)
    h = _mix_h1(seeds, _mix_k1(v & _M32))
    return _fmix(_mix_h1(h, _mix_k1((v >> 32) & _M32)), 8)


def _hash_plain(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                kinds: Sequence[str], n: int, device) -> torch.Tensor:
    h = torch.full((n,), SEED, dtype=torch.int64, device=device)
    for w, v, kind in zip(words, valids, kinds):
        w = w[:n].to(torch.int64) & (-1 if kind == "i64" else _M32)
        if kind == "i64":
            lo, hi = w & _M32, (w >> 32) & _M32
            new = _fmix(_mix_h1(_mix_h1(h, _mix_k1(lo)), _mix_k1(hi)), 8)
        else:
            new = _fmix(_mix_h1(h, _mix_k1(w)), 4)
        h = torch.where(v[:n], new, h)
    return h  # uint32 values in int64 lanes


def murmur3_pmod_plain(words: Sequence[torch.Tensor],
                       valids: Sequence[torch.Tensor], kinds: Sequence[str],
                       n: int, nparts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K2: (hash int32, partition id int32) of the
    first ``n`` rows."""
    device = valids[0].device
    h = _hash_plain(words, valids, kinds, n, device)
    signed = torch.where(h >= 1 << 31, h - (1 << 32), h)
    pid = torch.remainder(signed, nparts)
    return signed.to(torch.int32), pid.to(torch.int32)


# -- K2 on the card ------------------------------------------------------------

# csrc/murmur3.cu blz_murmur3_pmod's argument words: the header, then
# (data, validity, element bytes) a column from _HW_COLS
_HW_K, _HW_N, _HW_SEED, _HW_NPARTS, _HW_HASH, _HW_PID, _HW_STREAM, _HW_COLS = range(8)
# csrc/common.cuh BLZ_MAX_KEYS
_MAX_KEYS = 32
# the plane dtypes each kind hashes: "i32" as hashInt of the value
# sign-extended to 32 bits (a bool is 0 or 1), "i64" as hashLong
_KIND_DTYPES = {"i32": (torch.bool, torch.int8, torch.int16, torch.int32),
                "i64": (torch.int64,)}


class Murmur3Pack:
    """K2's argument words for one key signature (the device, nparts,
    whether the hash is written too, each column's kind and word dtype),
    checked and packed once; each call then checks its planes' device,
    shape and validity dtype, writes only the row count, the planes' and
    outputs' pointers and the stream into the words in place, and allocates
    one output (the pids, or the hash and the pids as the two rows of one
    allocation). Packs live per thread, one a signature
    (``murmur3_pmod_cuda``)."""

    def __init__(self, index: int, words: Sequence[torch.Tensor],
                 valids: Sequence[torch.Tensor], kinds: Sequence[str], nparts: int,
                 with_hash: bool):
        k = len(words)
        if index < 0:
            raise ValueError("murmur3_pmod: planes off the card, expected CUDA")
        if not 0 < k <= _MAX_KEYS or len(valids) != k or len(kinds) != k:
            raise ValueError(f"murmur3_pmod: {k} words, {len(valids)} validities, "
                             f"{len(kinds)} kinds (1..{_MAX_KEYS} columns)")
        for w, kind in zip(words, kinds):
            if w.dtype not in _KIND_DTYPES.get(kind, ()):
                raise TypeError(f"murmur3_pmod: word {w.dtype}/{kind}")
        if nparts <= 0 or nparts >= 2 ** 31:
            raise ValueError(f"murmur3_pmod: nparts={nparts}")
        self.index, self.with_hash = index, with_hash
        self.device = torch.device("cuda", index)
        self.fn = cuda_lib.library().blz_murmur3_pmod
        self.words = (cuda_lib.ctypes.c_longlong * (_HW_COLS + 3 * k))()
        self.words[_HW_K], self.words[_HW_SEED], self.words[_HW_NPARTS] = k, SEED, nparts
        for c, w in enumerate(words):
            self.words[_HW_COLS + 3 * c + 2] = w.element_size()

    def launch(self, words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor], n: int):
        """(hash or None, pids) of the first ``n`` rows: one K2 launch."""
        if n <= 0:
            raise ValueError(f"murmur3_pmod: n={n}")
        w, index, at = self.words, self.index, _HW_COLS
        for d, v in zip(words, valids):
            # get_device() is -1 off the card: one check for the device and CUDA
            if d.get_device() != index or v.get_device() != index or \
                    v.dtype is not torch.bool or d.dim() != 1 or v.dim() != 1 or \
                    not d.is_contiguous() or not v.is_contiguous() or \
                    d.numel() < n or v.numel() < n:
                raise ValueError(f"murmur3_pmod: planes {d.dtype}{tuple(d.shape)} on "
                                 f"{d.device} and {v.dtype}{tuple(v.shape)} on {v.device}, "
                                 f"expected contiguous CUDA planes on cuda:{index} of "
                                 f">= {n} rows")
            w[at], w[at + 1] = d.data_ptr(), v.data_ptr()
            at += 3
        if self.with_hash:
            out = torch.empty((2, (n + 3) // 4 * 4), dtype=torch.int32, device=self.device)
            hash_out, pid_out = out[0, :n], out[1, :n]
            w[_HW_HASH] = out.data_ptr()
            w[_HW_PID] = w[_HW_HASH] + out.shape[1] * 4
        else:
            hash_out = None
            pid_out = torch.empty(n, dtype=torch.int32, device=self.device)
            w[_HW_HASH], w[_HW_PID] = 0, pid_out.data_ptr()
        w[_HW_N] = n
        w[_HW_STREAM] = cuda_lib.stream_handle(index)
        cuda_lib.check(self.fn(w), "murmur3_pmod")
        cuda_lib.LAUNCHES["murmur3_pmod"] += 1
        return hash_out, pid_out


_PACKS = threading.local()


def murmur3_pmod_cuda(words: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor], kinds: Sequence[str],
                      n: int, nparts: int, with_hash: bool = True):
    """K2 (csrc/murmur3.cu): same contract as :func:`murmur3_pmod_plain`
    (the hash output is None when ``with_hash`` is False). ``words`` are
    ``hash_words``' planes at their own width; the signature's checks and
    argument words are kept in a :class:`Murmur3Pack`."""
    packs = getattr(_PACKS, "by_sig", None)
    if packs is None:
        packs = _PACKS.by_sig = {}
    index = valids[0].get_device() if valids else -1
    sig = (index, nparts, with_hash, *kinds, *[w.dtype for w in words])
    pack = packs.get(sig)
    if pack is None:
        if len(packs) >= 64:
            packs.clear()
        pack = packs[sig] = Murmur3Pack(index, words, valids, kinds, nparts, with_hash)
    return pack.launch(words, valids, n)


def murmur3_hashes(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                   kinds: Sequence[str], n: int) -> torch.Tensor:
    """Spark's murmur3 row hash (int32) of the first ``n`` rows: K2's hash
    output on CUDA tensors, the plain version on CPU tensors."""
    if valids[0].is_cuda:
        return murmur3_pmod_cuda(words, valids, kinds, n, 1, with_hash=True)[0]
    return murmur3_pmod_plain(words, valids, kinds, n, 1)[0]


def murmur3_pmod(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                 kinds: Sequence[str], n: int, nparts: int) -> torch.Tensor:
    """Partition ids of the first ``n`` rows: K2 on CUDA tensors, the plain
    version on CPU tensors."""
    if valids[0].is_cuda:
        return murmur3_pmod_cuda(words, valids, kinds, n, nparts, with_hash=False)[1]
    return murmur3_pmod_plain(words, valids, kinds, n, nparts)[1]


def partition_ids(columns: List, n: int, nparts: int) -> torch.Tensor:
    """Spark HashPartitioning ids of a batch's evaluated key columns
    (DeviceColumns)."""
    kinds = [hash_kind(c.dtype) for c in columns]
    words = [hash_words(c.data, k) for c, k in zip(columns, kinds)]
    return murmur3_pmod(words, [c.validity for c in columns], kinds, n, nparts)


# -- XXH64 (row 2b): the plain version ----------------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _c64(c: int):
    return c >> 32, c & _M32


def _addc64(a, c: int):
    ch, cl = _c64(c)
    lo = a[1] + cl
    return (a[0] + ch + (lo >> 32)) & _M32, lo & _M32


def _mul64(a, c: int):
    """Low 64 bits of a * c, both unsigned: c in 16-bit pieces against
    the 32-bit halves, so that no partial product reaches 2^63."""
    ah, al = a
    ch, cl = _c64(c)
    p0 = al * (cl & 0xFFFF)
    p1 = al * (cl >> 16)
    s = (p0 & _M32) + ((p1 & 0xFFFF) << 16)
    hi = (p0 >> 32) + (p1 >> 16) + (s >> 32)   # the high half of al * cl
    hi = hi + _mul32(ah, cl) + _mul32(al, ch)
    return hi & _M32, s & _M32


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _rotl64(a, r: int):
    ah, al = a if r < 32 else (a[1], a[0])
    r %= 32
    if r == 0:
        return ah, al
    return (((ah << r) | (al >> (32 - r))) & _M32,
            ((al << r) | (ah >> (32 - r))) & _M32)


def _shr64(a, r: int):
    ah, al = a
    if r >= 32:
        return torch.zeros_like(ah), ah >> (r - 32)
    return ah >> r, ((al >> r) | (ah << (32 - r))) & _M32


def _avalanche64(acc):
    acc = _mul64(_xor64(acc, _shr64(acc, 33)), _P2)
    acc = _mul64(_xor64(acc, _shr64(acc, 29)), _P3)
    return _xor64(acc, _shr64(acc, 32))


def _xxh64_long(v, seed):
    """XXH64 of one 8-byte word (XXH64's 8-byte round), per-row seeds."""
    acc = _addc64(seed, _P5 + 8)
    k1 = _mul64(_rotl64(_mul64(v, _P2), 31), _P1)
    acc = _addc64(_mul64(_rotl64(_xor64(acc, k1), 27), _P1), _P4)
    return _avalanche64(acc)


def _xxh64_int(v, seed):
    """XXH64 of one 4-byte word (its 4-byte tail round), per-row seeds."""
    acc = _addc64(seed, _P5 + 4)
    acc = _xor64(acc, _mul64(v, _P1))
    acc = _addc64(_mul64(_rotl64(acc, 23), _P2), _P3)
    return _avalanche64(acc)


def _halves(w: torch.Tensor, kind: str):
    w = w.to(torch.int64)
    if kind == "i64":
        return (w >> 32) & _M32, w & _M32
    return torch.zeros_like(w), w & _M32


def _to_int64(a) -> torch.Tensor:
    hi = torch.where(a[0] >= 1 << 31, a[0] - (1 << 32), a[0])
    return hi * (1 << 32) + a[1]  # exact: |hi * 2^32| <= 2^63


def xxhash64_rows_plain(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                        kinds: Sequence[str], n: int, cap: int) -> torch.Tensor:
    """Plain PyTorch twin of K15: Spark's XXH64 row hash (seed 42) of the
    first ``n`` rows, the columns folded in order (a null value leaves the
    running hash unchanged), as int64 of ``cap`` rows, 0 past ``n``.
    ``words``/``kinds`` as ``hash_words``/``hash_kind`` give them."""
    device = valids[0].device if valids else torch.device("cpu")
    zero = torch.zeros(n, dtype=torch.int64, device=device)
    h = (zero, zero + SEED)
    for w, v, kind in zip(words, valids, kinds):
        word = _halves(w[:n], kind)
        new = _xxh64_long(word, h) if kind == "i64" else _xxh64_int(word, h)
        keep = v[:n]
        h = (torch.where(keep, new[0], h[0]), torch.where(keep, new[1], h[1]))
    out = torch.zeros(cap, dtype=torch.int64, device=device)
    out[:n] = _to_int64(h)
    return out


# -- K15 on the card -------------------------------------------------------------------


def xxhash64_rows_cuda(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                       kinds: Sequence[str], n: int, cap: int) -> torch.Tensor:
    """K15 (csrc/xxhash64.cu): same contract as :func:`xxhash64_rows_plain`."""
    cuda_lib.require_cuda("xxhash64", *words, *valids)
    if not words or len(words) != len(valids) or len(words) != len(kinds):
        raise ValueError(f"xxhash64: {len(words)} words, {len(valids)} validities, "
                         f"{len(kinds)} kinds")
    if not 0 <= n <= cap:
        raise ValueError(f"xxhash64: n={n}, cap={cap}")
    for w, v, kind in zip(words, valids, kinds):
        want = torch.int64 if kind == "i64" else torch.int32
        if w.dtype != want or v.dtype != torch.bool or w.shape[0] < n \
                or v.shape[0] < n:
            raise TypeError(f"xxhash64: word {w.dtype}/{kind}, validity "
                            f"{v.dtype}, rows {w.shape[0]} for n={n}")
    device = valids[0].device
    out = torch.empty(cap, dtype=torch.int64, device=device)
    if cap == 0:
        return out
    lib = cuda_lib.library()
    datas, _k1 = cuda_lib.ptr_array(words)
    vptrs, _k2 = cuda_lib.ptr_array(valids)
    wide, _k3 = cuda_lib.int_array([1 if k == "i64" else 0 for k in kinds])
    err = lib.blz_xxhash64(len(words), datas, vptrs, wide, n, cap, SEED,
                           out.data_ptr(), cuda_lib.stream_of(device))
    cuda_lib.check(err, "xxhash64")
    cuda_lib.LAUNCHES["xxhash64"] += 1
    return out


def xxhash64_rows(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                  kinds: Sequence[str], n: int, cap: int) -> torch.Tensor:
    """XXH64 row hashes: K15 on CUDA tensors, the plain version on CPU
    tensors."""
    if valids[0].is_cuda:
        return xxhash64_rows_cuda(words, valids, kinds, n, cap)
    return xxhash64_rows_plain(words, valids, kinds, n, cap)
