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
  low word, then high word), float64 as its bit pattern. Both kernels
  and their twins read bool, int8 and int16 planes at their own width
  (``hash_words``): nothing is widened before a launch;
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
    plane as int64. K2, K15 and their twins take these planes."""
    if kind == "i64":
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data if data.dtype == torch.int64 else data.to(torch.int64)
    if data.dtype == torch.float32:
        return data.view(torch.int32)
    return data


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


# -- the row hashes' packs (K2, K15) ----------------------------------------------

# csrc/common.cuh BLZ_MAX_KEYS
_MAX_KEYS = 32
# the plane dtypes each kind hashes: "i32" as hashInt of the value
# sign-extended to 32 bits (a bool is 0 or 1), "i64" as hashLong
_KIND_DTYPES = {"i32": (torch.bool, torch.int8, torch.int16, torch.int32),
                "i64": (torch.int64,)}


class _HashPack:
    """A row hash's argument words for one column signature (the device,
    each column's kind and word dtype), checked and packed once: a header
    of ``cols`` words, then (data, validity, element bytes) a column from
    word ``cols``. ``planes`` checks a call's planes' device, shape and
    validity dtype and writes their pointers into the words in place."""

    def __init__(self, name: str, index: int, words: Sequence[torch.Tensor],
                 valids: Sequence[torch.Tensor], kinds: Sequence[str], cols: int):
        k = len(words)
        if index < 0:
            raise ValueError(f"{name}: planes off the card, expected CUDA")
        if not 0 < k <= _MAX_KEYS or len(valids) != k or len(kinds) != k:
            raise ValueError(f"{name}: {k} words, {len(valids)} validities, "
                             f"{len(kinds)} kinds (1..{_MAX_KEYS} columns)")
        for w, kind in zip(words, kinds):
            if w.dtype not in _KIND_DTYPES.get(kind, ()):
                raise TypeError(f"{name}: word {w.dtype}/{kind}")
        self.name, self.index, self.cols = name, index, cols
        self.device = torch.device("cuda", index)
        self.words = (cuda_lib.ctypes.c_longlong * (cols + 3 * k))()
        self.words[0] = k
        for c, w in enumerate(words):
            self.words[cols + 3 * c + 2] = w.element_size()

    def planes(self, words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor], n: int):
        w, index, at = self.words, self.index, self.cols
        for d, v in zip(words, valids):
            # get_device() is -1 off the card: one check for the device and CUDA
            if d.get_device() != index or v.get_device() != index or \
                    v.dtype is not torch.bool or d.dim() != 1 or v.dim() != 1 or \
                    not d.is_contiguous() or not v.is_contiguous() or \
                    d.numel() < n or v.numel() < n:
                raise ValueError(f"{self.name}: planes {d.dtype}{tuple(d.shape)} on "
                                 f"{d.device} and {v.dtype}{tuple(v.shape)} on {v.device}, "
                                 f"expected contiguous CUDA planes on cuda:{index} of "
                                 f">= {n} rows")
            w[at], w[at + 1] = d.data_ptr(), v.data_ptr()
            at += 3


_PACKS = threading.local()


def _pack(cls, sig, *args):
    """The per-thread pack of ``cls`` for signature ``sig`` (at most 64
    kept a class)."""
    by_sig = getattr(_PACKS, cls.__name__, None)
    if by_sig is None:
        by_sig = {}
        setattr(_PACKS, cls.__name__, by_sig)
    pack = by_sig.get(sig)
    if pack is None:
        if len(by_sig) >= 64:
            by_sig.clear()
        pack = by_sig[sig] = cls(*args)
    return pack


# -- K2 on the card ------------------------------------------------------------

# csrc/murmur3.cu blz_murmur3_pmod's argument words: the header, then
# (data, validity, element bytes) a column from _HW_COLS
_HW_K, _HW_N, _HW_SEED, _HW_NPARTS, _HW_HASH, _HW_PID, _HW_STREAM, _HW_COLS = range(8)


class Murmur3Pack(_HashPack):
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
        super().__init__("murmur3_pmod", index, words, valids, kinds, _HW_COLS)
        if nparts <= 0 or nparts >= 2 ** 31:
            raise ValueError(f"murmur3_pmod: nparts={nparts}")
        self.with_hash = with_hash
        self.fn = cuda_lib.library().blz_murmur3_pmod
        self.words[_HW_SEED], self.words[_HW_NPARTS] = SEED, nparts

    def launch(self, words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor], n: int):
        """(hash or None, pids) of the first ``n`` rows: one K2 launch."""
        if n <= 0:
            raise ValueError(f"murmur3_pmod: n={n}")
        self.planes(words, valids, n)
        w = self.words
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
        w[_HW_STREAM] = cuda_lib.stream_handle(self.index)
        cuda_lib.check(self.fn(w), "murmur3_pmod")
        cuda_lib.LAUNCHES["murmur3_pmod"] += 1
        return hash_out, pid_out


def murmur3_pmod_cuda(words: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor], kinds: Sequence[str],
                      n: int, nparts: int, with_hash: bool = True):
    """K2 (csrc/murmur3.cu): same contract as :func:`murmur3_pmod_plain`
    (the hash output is None when ``with_hash`` is False). ``words`` are
    ``hash_words``' planes at their own width; the signature's checks and
    argument words are kept in a :class:`Murmur3Pack`."""
    index = valids[0].get_device() if valids else -1
    sig = (index, nparts, with_hash, *kinds, *[w.dtype for w in words])
    return _pack(Murmur3Pack, sig, index, words, valids, kinds, nparts,
                 with_hash).launch(words, valids, n)


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
                        kinds: Sequence[str], n: int, cap: int,
                        seed: int = SEED) -> torch.Tensor:
    """Plain PyTorch twin of K15: Spark's XXH64 row hash of the first ``n``
    rows, the columns folded in order from ``seed`` (42, the SQL function's;
    a null value leaves the running hash unchanged), as int64 of ``cap``
    rows, 0 past ``n``. ``words``/``kinds`` as ``hash_words``/``hash_kind``
    give them: a bool, int8 or int16 plane takes the 4-byte round of its
    value sign-extended to 32 bits."""
    device = valids[0].device if valids else torch.device("cpu")
    zero = torch.zeros(n, dtype=torch.int64, device=device)
    seed &= (1 << 64) - 1
    h = (zero + (seed >> 32), zero + (seed & _M32))
    for w, v, kind in zip(words, valids, kinds):
        word = _halves(w[:n], kind)
        new = _xxh64_long(word, h) if kind == "i64" else _xxh64_int(word, h)
        keep = v[:n]
        h = (torch.where(keep, new[0], h[0]), torch.where(keep, new[1], h[1]))
    out = torch.zeros(cap, dtype=torch.int64, device=device)
    out[:n] = _to_int64(h)
    return out


# -- K15 on the card -------------------------------------------------------------------

# csrc/xxhash64.cu blz_xxhash64's argument words: the header, then (data,
# validity, element bytes) a column from _XW_COLS
_XW_K, _XW_N, _XW_CAP, _XW_SEED, _XW_OUT, _XW_STREAM, _XW_COLS = range(7)


class Xxh64Pack(_HashPack):
    """K15's argument words for one column signature (the device, each
    column's kind and word dtype), checked and packed once; each call then
    checks its planes' device, shape and validity dtype, writes only the
    row count, the capacity, the seed, the planes' and the output's
    pointers and the stream into the words in place, and allocates the
    output. Packs live per thread, one a signature (``xxhash64_rows_cuda``)."""

    def __init__(self, index: int, words: Sequence[torch.Tensor],
                 valids: Sequence[torch.Tensor], kinds: Sequence[str]):
        super().__init__("xxhash64", index, words, valids, kinds, _XW_COLS)
        self.fn = cuda_lib.library().blz_xxhash64

    def launch(self, words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor], n: int,
               cap: int, seed: int = SEED) -> torch.Tensor:
        """The int64 hashes of ``cap`` rows, 0 past ``n``: one K15 launch."""
        if not 0 <= n <= cap:
            raise ValueError(f"xxhash64: n={n}, cap={cap}")
        self.planes(words, valids, n)
        out = torch.empty(cap, dtype=torch.int64, device=self.device)
        if cap == 0:
            return out
        w = self.words
        w[_XW_N], w[_XW_CAP], w[_XW_OUT] = n, cap, out.data_ptr()
        w[_XW_SEED] = (seed + (1 << 63)) % (1 << 64) - (1 << 63)  # as a signed word
        w[_XW_STREAM] = cuda_lib.stream_handle(self.index)
        cuda_lib.check(self.fn(w), "xxhash64")
        cuda_lib.LAUNCHES["xxhash64"] += 1
        return out


def xxhash64_rows_cuda(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                       kinds: Sequence[str], n: int, cap: int,
                       seed: int = SEED) -> torch.Tensor:
    """K15 (csrc/xxhash64.cu): same contract as :func:`xxhash64_rows_plain`.
    ``words`` are ``hash_words``' planes at their own width; the
    signature's checks and argument words are kept in an
    :class:`Xxh64Pack`."""
    index = valids[0].get_device() if valids else -1
    sig = (index, *kinds, *[w.dtype for w in words])
    return _pack(Xxh64Pack, sig, index, words, valids, kinds).launch(words, valids, n, cap,
                                                                     seed)


def xxhash64_rows(words: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                  kinds: Sequence[str], n: int, cap: int) -> torch.Tensor:
    """XXH64 row hashes: K15 on CUDA tensors, the plain version on CPU
    tensors."""
    if valids[0].is_cuda:
        return xxhash64_rows_cuda(words, valids, kinds, n, cap)
    return xxhash64_rows_plain(words, valids, kinds, n, cap)
