"""Join-key canonicalization, the build-side map of the broadcast join,
and the carryable per-row key encoding of the window.

Copies of blaze_tpu/ops/joins/keymap.py, host numpy as they are there:

- ``_canon_words``, ``key_rows`` and ``RunningKeyCodes``: the window
  operator finds its partition and peer boundaries with them;
- ``JoinHashMap`` with ``build``/``_build_sorted``/``_from_codes``,
  ``num_codes``, ``unique_single_key`` and the device-resident sorted-key
  cell: the build side of the unique-key inner broadcast join
  (ops/joins/bhj.py), whose probe is K8 (core/kernels.py
  ``inner_join_planes``; the probe's canonical word is ``canon_words``
  there, the device twin of ``_canon_words``).

Not ported yet (NotImplementedError naming ROADMAP.md): the host-interned
multi-key build (``key_codes``), the generic probe (``probe_codes`` and
the CSR pair expansion ``probe``; the reference's ``_probe_fn``),
duplicate build keys, and the broadcast serialization. The port has device columns
only, so the reference's host-column (python tuple) branches have no
counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T

_GENERIC_PROBE = ("the generic join probe (ROADMAP.md Queue 1 item 9, "
                  "PERF.md kernel table row 14)")


def key_codes(*_args, **_kwargs):
    """The host-interned multi-key codes of the reference: not ported."""
    raise NotImplementedError(
        "multi-key join maps (host key interning) are not ported to the "
        f"PyTorch package yet: {_GENERIC_PROBE}")


def _canon_words(data: np.ndarray) -> np.ndarray:
    """Numpy values -> canonical int64 key words (floats: -0.0 folded,
    NaN payloads unified -- Spark float equality)."""
    if data.dtype == np.float64:
        d = np.where(data == 0.0, 0.0, data)
        d = np.where(np.isnan(d), np.float64(np.nan), d)
        return d.view(np.int64)
    if data.dtype == np.float32:
        d = np.where(data == np.float32(0), np.float32(0), data)
        d = np.where(np.isnan(d), np.float32(np.nan), d)
        return d.view(np.int32).astype(np.int64)
    return data.astype(np.int64)


def key_rows(batch: ColumnarBatch, cols: List[DeviceColumn]) -> np.ndarray:
    """Canonical per-row key representation for sorted-adjacent consumers
    (window partition/peer boundaries): an (n, 2k) int64 matrix of
    (canonical word, null flag) pairs. Nulls are grouped as values (null ==
    null, Spark grouping semantics), and one row is O(1) to carry across a
    batch boundary."""
    n = batch.num_rows
    mats = []
    for c in cols:
        data = c.data[:n].cpu().numpy()
        valid = c.validity[:n].cpu().numpy()
        mats.append(_canon_words(np.where(valid, data, data.dtype.type(0))))
        mats.append((~valid).astype(np.int64))
    return np.column_stack(mats)


class RunningKeyCodes:
    """Run-boundary detector over batches whose rows arrive sorted by the
    key (window input): O(1) carried state (the last row's canonical key),
    so partitions spanning batches are recognised as continuations."""

    def __init__(self):
        self.last: Optional[np.ndarray] = None  # canonical last key row seen

    def push_rows(self, rows: np.ndarray) -> np.ndarray:
        """Consume precomputed ``key_rows`` output; returns the (n,) bool
        run-start mask (True where the row differs from its predecessor,
        including across the batch boundary)."""
        n = rows.shape[0]
        if n == 0:
            return np.zeros(0, dtype=bool)
        ch = np.zeros(n, dtype=bool)
        ch[1:] = (rows[1:] != rows[:-1]).any(axis=1)
        ch[0] = self.last is None or not np.array_equal(rows[0], self.last)
        self.last = rows[-1].copy()
        return ch

    def change_mask(self, batch: ColumnarBatch,
                    cols: List[DeviceColumn]) -> np.ndarray:
        return self.push_rows(key_rows(batch, cols))


class JoinHashMap:
    """Build-side map: key code -> contiguous range of build rows (CSR over
    the concatenated, code-sorted build batch).

    The port keeps the reference's device-probe form only: one fixed-width
    key, codes are ranks in the sorted unique canonical words
    (``sorted_keys``), and every key owns exactly one build row (the
    dimension-table case), so code c is build row c. The outer joins'
    ``matched`` flags belong to the generic probe and are not kept.
    """

    def __init__(self, batch: ColumnarBatch, key_map, offsets: np.ndarray,
                 schema: T.Schema, sorted_keys: Optional[np.ndarray] = None):
        self.batch = batch          # build rows sorted by key code
        self.key_map = key_map
        self.offsets = offsets      # (num_codes + 1,) row ranges
        self.schema = schema
        self.sorted_keys = sorted_keys
        # one-element cell: every task of a query that shares this map
        # shares one upload of the sorted keys to the device
        self._dev_cell: List[Optional[torch.Tensor]] = [None]

    @property
    def num_codes(self) -> int:
        return len(self.offsets) - 1

    @property
    def unique_single_key(self) -> bool:
        """Device-probe map whose every key maps to exactly one build row:
        code c's rows are [c, c + 1), so the code is the build-row index
        (K8's build gather)."""
        return self.sorted_keys is not None and bool(
            np.all(np.diff(self.offsets) == 1))

    def device_keys(self, device: torch.device) -> torch.Tensor:
        """The sorted unique words on the device (length max(nk, 1)),
        uploaded once per map."""
        if self._dev_cell[0] is None:
            keys = self.sorted_keys if len(self.sorted_keys) \
                else np.zeros(1, np.int64)
            self._dev_cell[0] = torch.from_numpy(
                np.ascontiguousarray(keys, dtype=np.int64)).to(device)
        return self._dev_cell[0]

    @staticmethod
    def build(batches: List[ColumnarBatch], key_exprs: List[E.Expr],
              schema: T.Schema, device: torch.device,
              conf: Optional[Config] = None) -> "JoinHashMap":
        if len(key_exprs) != 1:
            key_codes()
        key_cols = []
        kept = []
        for b in batches:
            if b.num_rows == 0:
                continue
            ev = ExprEvaluator(key_exprs, b.schema)
            key_cols.append(ev.evaluate(b))
            kept.append(b)
        if not kept:
            # the reference builds an empty generic map here, whose inner
            # probe emits nothing; an empty sorted map (nk = 0) does the same
            empty = ColumnarBatch.from_numpy(
                schema, {f.name: np.zeros(0, np.int64) for f in schema.fields},
                device, conf=conf)
            return JoinHashMap(empty, None, np.zeros(1, np.int64), schema,
                               np.zeros(0, np.int64))
        return JoinHashMap._build_sorted(kept, key_cols, schema, conf)

    @staticmethod
    def _build_sorted(kept, key_cols, schema, conf) -> "JoinHashMap":
        """Single fixed-width key: codes are ranks in the sorted unique-key
        array (canonical int64 words), for the device probe. The key
        plane is pulled to the host once, as the reference's
        ``pull_columns`` does."""
        words = []
        valids = []
        for b, cols in zip(kept, key_cols):
            n = b.num_rows
            words.append(_canon_words(cols[0].data[:n].cpu().numpy()))
            valids.append(cols[0].validity[:n].cpu().numpy())
        big = ColumnarBatch.concat(kept, schema, conf)
        w = np.concatenate(words)
        v = np.concatenate(valids)
        uniq = np.unique(w[v])
        codes = np.searchsorted(uniq, w)
        codes = np.where(v & (codes < len(uniq)) &
                         (uniq[np.clip(codes, 0, max(len(uniq) - 1, 0))] == w),
                         codes, -1) if len(uniq) else np.full(len(w), -1)
        return JoinHashMap._from_codes(big, codes, len(uniq), None, uniq,
                                       schema, conf)

    @staticmethod
    def _from_codes(big, codes, ncodes, key_map, sorted_keys, schema,
                    conf=None) -> "JoinHashMap":
        # null-keyed build rows (-1) can never match: give them code
        # num_codes so they sort to the tail outside every CSR range
        codes = np.where(codes < 0, ncodes, codes)
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        big = big.take(torch.from_numpy(order).to(big.device), conf)
        counts = np.bincount(sorted_codes, minlength=ncodes + 1)[: ncodes + 1]
        offsets = np.zeros(ncodes + 1, dtype=np.int64)
        np.cumsum(counts[:ncodes], out=offsets[1:])
        m = JoinHashMap(big, key_map, offsets, schema, sorted_keys)
        if not m.unique_single_key:
            raise NotImplementedError(
                "duplicate build keys in a broadcast join are not ported to "
                f"the PyTorch package yet: {_GENERIC_PROBE}")
        return m

    def probe_codes(self, *_args, **_kwargs):
        raise NotImplementedError(
            f"JoinHashMap.probe_codes is not ported yet: {_GENERIC_PROBE}")

    def probe(self, *_args, **_kwargs):
        raise NotImplementedError(
            f"JoinHashMap.probe (CSR pair expansion) is not ported yet: "
            f"{_GENERIC_PROBE}")

    def serialize(self) -> bytes:
        raise NotImplementedError(
            "JoinHashMap broadcast serialization is not ported yet "
            "(ROADMAP.md Queue 1 items 9 and 12)")

    @staticmethod
    def deserialize(blob: bytes, schema):
        raise NotImplementedError(
            "JoinHashMap broadcast serialization is not ported yet "
            "(ROADMAP.md Queue 1 items 9 and 12)")
