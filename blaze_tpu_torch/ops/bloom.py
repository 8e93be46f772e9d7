"""Spark-compatible bloom filter: the runtime filter's build and probe.

The port of blaze_tpu/ops/bloom.py (Spark's BloomFilterImpl; reference:
``datafusion-ext-commons/src/spark_bloom_filter.rs`` and
``spark_bit_array.rs``). Wire format, big-endian: [version=1 i32,
num_hash_functions i32, word_count i32, words i64...]. Per item the two
base hashes are hashLong(v, 0) and hashLong(v, h1) (Murmur3_x86_32 of the
long's 8 little-endian bytes), combined as ``h1 + i*h2`` for i = 1..k
(int32 wraparound), flipped with ``~`` when negative, modulo the bit size;
bit b lives in word b >> 6 at bit b & 63.

One torch function, ``bit_indices``, spells the bit positions for both
sides. The put (``put_longs``) stays on the host, as the reference's
does: ``bit_indices`` on a CPU tensor, then ``np.bitwise_or.at``. The
probe of a device column, ``might_contain_long``, launches K16
(csrc/bloom.cu) on a CUDA tensor and runs ``might_contain_long_plain``
on a CPU tensor; the bitmap is uploaded once per filter and device and
stays there.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np
import torch

from blaze_tpu_torch.exprs.spark_hash import murmur3_int64
from blaze_tpu_torch.utils import cuda_lib

_M32 = 0xFFFFFFFF

# Spark's bloom_filter_agg defaults (spark.sql.optimizer.runtime.bloomFilter.
# expectedNumItems and .numBits), which the JAX package's aggregate takes
DEFAULT_EXPECTED_ITEMS = 1_000_000
DEFAULT_NUM_BITS = 8_388_608


class SparkBloomFilter:
    def __init__(self, words: np.ndarray, num_hash_functions: int):
        self.words = words  # uint64 array
        self.num_hash_functions = num_hash_functions
        if self.bit_size >= 1 << 31:
            # the reference indexes bits as int32 (np.int32(bit_size));
            # Spark's largest filter is 67,108,864 bits
            raise ValueError(f"bloom filter of {self.bit_size} bits: at most 2^31 - 64")
        self._dev_words: Dict[torch.device, torch.Tensor] = {}

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(expected_items: int, num_bits: int) -> "SparkBloomFilter":
        num_bits = max(64, num_bits)
        k = max(1, round(num_bits / max(expected_items, 1) * np.log(2.0)))
        return SparkBloomFilter(np.zeros((num_bits + 63) // 64, dtype=np.uint64), k)

    @property
    def bit_size(self) -> int:
        return len(self.words) * 64

    # -- spark wire format ----------------------------------------------------

    def serialize(self) -> bytes:
        return struct.pack(">iii", 1, self.num_hash_functions, len(self.words)) + \
            self.words.astype(">u8").tobytes()

    @staticmethod
    def deserialize(blob: bytes) -> "SparkBloomFilter":
        version, k, nwords = struct.unpack_from(">iii", blob, 0)
        if version != 1:
            raise ValueError(f"unsupported bloom filter version {version}")
        words = np.frombuffer(blob, dtype=">u8", count=nwords, offset=12)
        return SparkBloomFilter(words.astype(np.uint64), k)

    # -- mutation (host) ------------------------------------------------------

    def put_longs(self, values: np.ndarray) -> None:
        if len(values) == 0:
            return
        idx = bit_indices(torch.from_numpy(np.array(values, dtype=np.int64)),
                          self.num_hash_functions, self.bit_size).numpy().ravel()
        np.bitwise_or.at(self.words, idx >> 6, np.uint64(1) << (idx & 63).astype(np.uint64))
        self._dev_words.clear()

    # -- probing --------------------------------------------------------------

    def device_words(self, device: torch.device) -> torch.Tensor:
        """The bitmap as int64 words on ``device``, uploaded once."""
        words = self._dev_words.get(device)
        if words is None:
            words = torch.from_numpy(self.words.view(np.int64).copy()).to(device)
            self._dev_words[device] = words
        return words

    def might_contain_long(self, values: torch.Tensor) -> torch.Tensor:
        """Probe of an int64 column ((n,) -> (n,) bool): K16 on a CUDA
        tensor, the plain version on a CPU tensor."""
        words = self.device_words(values.device)
        if values.is_cuda:
            return bloom_probe_cuda(values, words, self.num_hash_functions, self.bit_size)
        return might_contain_long_plain(values, words, self.num_hash_functions,
                                        self.bit_size)


# -- the plain version -------------------------------------------------------------


def bit_indices(values: torch.Tensor, k: int, bit_size: int) -> torch.Tensor:
    """(n, k) int64 bit positions of int64 ``values``: the hashes are
    uint32 values in int64 lanes, so the int32 wrap of ``h1 + i*h2`` is a
    32-bit mask and ``~c`` of a negative int32 is ``c ^ 0xFFFFFFFF``."""
    v = values.to(torch.int64)
    h1 = murmur3_int64(v, 0)
    h2 = murmur3_int64(v, h1)
    i = torch.arange(1, k + 1, dtype=torch.int64, device=v.device)
    c = (h1[:, None] + i * h2[:, None]) & _M32
    c = torch.where(c >= 1 << 31, c ^ _M32, c)
    return c % bit_size


def might_contain_long_plain(values: torch.Tensor, words: torch.Tensor, k: int,
                             bit_size: int) -> torch.Tensor:
    """Plain PyTorch twin of K16: ``values`` (n,) int64, ``words`` the
    bitmap as int64 (an arithmetic shift then ``& 1`` reads any bit of a
    signed word)."""
    idx = bit_indices(values, k, bit_size)
    return ((words[idx >> 6] >> (idx & 63)) & 1).to(torch.bool).all(dim=1)


# -- K16 on the card -------------------------------------------------------------


def bloom_probe_cuda(values: torch.Tensor, words: torch.Tensor, k: int,
                     bit_size: int) -> torch.Tensor:
    """K16 (csrc/bloom.cu): same contract as :func:`might_contain_long_plain`."""
    cuda_lib.require_cuda("bloom_probe", values, words)
    if values.dtype != torch.int64 or words.dtype != torch.int64 or values.dim() != 1:
        raise TypeError(f"bloom_probe: values {values.dtype}/{values.dim()}-d, "
                        f"words {words.dtype}")
    if k < 1 or not 0 < bit_size < 1 << 31 or bit_size % 64 or \
            words.shape[0] * 64 != bit_size:
        raise ValueError(f"bloom_probe: k={k}, bit_size={bit_size}, "
                         f"{words.shape[0]} words")
    n = values.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=values.device)
    if n == 0:
        return out
    err = cuda_lib.library().blz_bloom_probe(
        values.data_ptr(), n, words.data_ptr(), k, bit_size, out.data_ptr(),
        cuda_lib.stream_of(values.device))
    cuda_lib.check(err, "bloom_probe")
    cuda_lib.LAUNCHES["bloom_probe"] += 1
    return out
