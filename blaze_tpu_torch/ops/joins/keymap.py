"""Carryable per-row key encoding for rows sorted by the key.

A copy of the window's part of blaze_tpu/ops/joins/keymap.py
(``_canon_words``, ``key_rows``, ``RunningKeyCodes``), host numpy as it is
there: the window operator finds its partition and peer boundaries with
it. The join key map and its device probe are not ported yet (ROADMAP.md
Queue 1 item 9). The port has device columns only, so the reference's
host-column (python tuple) branch has no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn


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
