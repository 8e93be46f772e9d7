"""Spark-exact Murmur3_x86_32 (seed 42) row hashing and pmod routing (K2).

``murmur3_pmod`` launches the hand-written kernel (csrc/murmur3.cu) on a
CUDA tensor and runs ``murmur3_pmod_plain`` on a CPU tensor. Semantics, as
blaze_tpu/exprs/spark_hash.py (``murmur3_update_column``,
``_hash_device_run``) and the pmod of ``HashPartitioner``:

- multi-column hashing chains: each row's running hash is the seed for the
  next column; a NULL value leaves the hash unchanged;
- int8/16/32, date and bool hash as a 4-byte int (hashInt), float32 as its
  4-byte bit pattern; int64, timestamp, decimal(p<=18) (unscaled) hash as
  8 bytes (hashLong: low word, then high word), float64 as its bit pattern;
- partition id = ((int32) hash mod n + n) mod n.

The plain version computes in int64 with ``& 0xFFFFFFFF`` masks: PyTorch
on the CPU has no uint32 shift or add.
"""

from __future__ import annotations

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
    """The column's hash words: int32 for "i32" (narrow ints and bools
    widened, float32 bit-cast), int64 for "i64" (float64 bit-cast)."""
    if kind == "i64":
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data.to(torch.int64)
    if data.dtype == torch.float32:
        return data.view(torch.int32)
    return data.to(torch.int32)


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


def murmur3_pmod_cuda(words: Sequence[torch.Tensor],
                      valids: Sequence[torch.Tensor], kinds: Sequence[str],
                      n: int, nparts: int, with_hash: bool = True):
    """K2 (csrc/murmur3.cu): same contract as :func:`murmur3_pmod_plain`
    (the hash output is skipped when ``with_hash`` is False)."""
    cuda_lib.require_cuda("murmur3_pmod", *words, *valids)
    for w, v, kind in zip(words, valids, kinds):
        want = torch.int64 if kind == "i64" else torch.int32
        if w.dtype != want or v.dtype != torch.bool or w.shape[0] < n \
                or v.shape[0] < n:
            raise TypeError(f"murmur3_pmod: word {w.dtype}/{kind}, validity "
                            f"{v.dtype}, rows {w.shape[0]} for n={n}")
    if n <= 0 or nparts <= 0:
        raise ValueError(f"murmur3_pmod: n={n}, nparts={nparts}")
    lib = cuda_lib.library()
    device = valids[0].device
    hash_out = torch.empty(n, dtype=torch.int32, device=device) if with_hash else None
    pid_out = torch.empty(n, dtype=torch.int32, device=device)
    datas, _k1 = cuda_lib.ptr_array(words)
    vptrs, _k2 = cuda_lib.ptr_array(valids)
    wide, _k3 = cuda_lib.int_array([1 if k == "i64" else 0 for k in kinds])
    err = lib.blz_murmur3_pmod(
        len(words), datas, vptrs, wide, n, SEED, nparts,
        hash_out.data_ptr() if hash_out is not None else None,
        pid_out.data_ptr(), cuda_lib.stream_of(device))
    cuda_lib.check(err, "murmur3_pmod")
    cuda_lib.LAUNCHES["murmur3_pmod"] += 1
    return hash_out, pid_out


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
