"""Join-key canonicalization, the build-side map of the hash joins, and
the carryable per-row key encoding of the window.

Copies of blaze_tpu/ops/joins/keymap.py, host numpy as they are there:

- ``_canon_words``, ``key_rows`` and ``RunningKeyCodes``: the window
  operator finds its partition and peer boundaries with them;
- ``canon_words`` and ``sorted_probe``: the canonical word of a device
  key and the sorted-key probe that K8, K9 and K18 share;
  ``dense_key_words``: K8's search route, decided once a build map;
  ``rank_route`` and ``JoinRank``: K18's (dense, bitmap or search), with
  ``rank_probe_plain`` the kernel's rank arithmetic in PyTorch;
- ``key_codes``: the host interning of multi-column keys;
- ``JoinHashMap``: the build side of every hash join (ops/joins/bhj.py),
  a CSR layout of the code-sorted build rows. A single fixed-width key
  gets codes that are ranks in its sorted unique canonical words, probed
  on the device by K9 (core/kernels.py ``probe_codes``; the reference's
  ``_probe_fn``) or, for a unique-key inner join, by K8
  (``inner_join_planes_cuda``); several key columns are interned on the host.
  The codes come to the host, where ``probe`` expands the matching
  (probe row, build row) pairs, as in the reference.

The port has device columns only, so the reference's host-column
branches (python tuples in ``key_codes``, the numpy searchsorted probe of
a host key column in ``probe_codes``) have no counterpart here. The
broadcast serialization waits for ``io/batch_serde.py`` (NotImplementedError
naming ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn, column_planes
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T


def key_codes(batch: ColumnarBatch, cols: List[DeviceColumn], key_map: Dict,
              insert: bool) -> np.ndarray:
    """Map each row's key tuple to an integer code. ``insert`` adds unseen
    keys (build side); otherwise unseen -> -1 (probe side). Rows with any
    null key always get -1. The key planes are pulled to the host and
    deduplicated there with ``np.unique``, as the reference does."""
    n = batch.num_rows
    if n == 0:
        return np.empty(0, dtype=np.int64)
    mats = []
    null_any = np.zeros(n, dtype=bool)
    for c in cols:
        data = c.data[:n].cpu().numpy()
        valid = c.validity[:n].cpu().numpy()
        null_any |= ~valid
        if data.dtype in (np.float64, np.float32):
            d64 = _canon_words(np.where(valid, data, data.dtype.type(0)))
        else:
            d64 = np.where(valid, data, 0).astype(np.int64)
        mats.append(d64)
    mat = np.column_stack(mats)
    view = np.ascontiguousarray(mat).view(
        np.dtype((np.void, mat.dtype.itemsize * mat.shape[1]))).ravel()
    uniq, inverse = np.unique(view, return_inverse=True)
    lut = np.empty(len(uniq), dtype=np.int64)
    for i, u in enumerate(uniq):
        kb = u.tobytes()
        code = key_map.get(kb)
        if code is None:
            if insert:
                code = len(key_map)
                key_map[kb] = code
            else:
                code = -1
        lut[i] = code
    codes = lut[inverse]
    codes[null_any] = -1
    return codes


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


def canon_words(data: torch.Tensor) -> torch.Tensor:
    """Canonical int64 join words of a device key plane, the same function
    as blaze_tpu/ops/joins/keymap.py:195 canon_word_traced and the one
    authority for the key encoding of every device probe (K8, K9, K18):
    integers (and bools) widen with their sign; floats fold -0.0 into
    +0.0 and every NaN payload into the quiet NaN, then f64 words are the
    int64 bits and f32 words the int32 bits sign-extended. K8 and K9
    compute the same word in csrc/join.cu (blz_canon_word), K18 in its
    generated probe (exprs/fused_triton.py)."""
    if data.is_floating_point():
        d = torch.where(data != 0, data, torch.zeros((), dtype=data.dtype,
                                                     device=data.device))
        d = torch.where(torch.isnan(d),
                        torch.full((), float("nan"), dtype=d.dtype, device=d.device), d)
        if d.dtype == torch.float32:
            return d.view(torch.int32).to(torch.int64)
        return d.view(torch.int64)
    return data.to(torch.int64)


def dense_key_words(words: np.ndarray) -> bool:
    """Whether a build's sorted unique canonical words are one run of
    consecutive integers (nk == words[-1] - words[0] + 1): K8 then ranks a
    probe word by a subtraction behind a range check (csrc/join.cu's dense
    route), with no search. Decided once a build map, on the host, in
    Python integers (no int64 wrap)."""
    n = len(words)
    return n > 0 and int(words[-1]) - int(words[0]) + 1 == n


# K18's rank routes (exprs/fused_triton.py), decided once a build map
RANK_DENSE, RANK_BITMAP, RANK_SEARCH = "dense", "bitmap", "search"
# the bitmap route's limits: a word range of at most 256 words a key, and a
# table (16 bytes a 64-word block) of at most 16 MiB
BITMAP_SPAN_PER_KEY = 256
BITMAP_MAX_BYTES = 16 << 20


def rank_route(words: np.ndarray) -> str:
    """K18's route to a probe word's rank in a build's sorted unique
    canonical words, a function of the words alone (Python integers, no
    int64 wrap): ``dense`` when they are one run of consecutive integers
    (the rank is w - lo), ``bitmap`` when their range is at most 256 words
    a key and its table at most 16 MiB (one 16-byte load a row), else
    ``search`` (the binary search; float words, wide ranges and nk = 0)."""
    n = len(words)
    if dense_key_words(words):
        return RANK_DENSE
    if n == 0:
        return RANK_SEARCH
    span = int(words[-1]) - int(words[0]) + 1
    if span <= BITMAP_SPAN_PER_KEY * n and 16 * (-(-span // 64)) <= BITMAP_MAX_BYTES:
        return RANK_BITMAP
    return RANK_SEARCH


def bitmap_table(words: np.ndarray) -> np.ndarray:
    """The bitmap route's table of sorted unique words lo..hi: per 64-word
    block b (words lo + 64b .. lo + 64b + 63), its int64 bit mask (bit k:
    word lo + 64b + k is a key) and the count of keys in the blocks before
    it, interleaved (mask, count) so that one 16-byte load reads both."""
    d = np.asarray(words, dtype=np.int64) - np.int64(words[0])  # < span: no wrap
    nblocks = int(d[-1]) // 64 + 1
    blk = d >> 6
    bits = np.left_shift(np.uint64(1), (d & 63).astype(np.uint64))
    starts = np.flatnonzero(np.r_[True, blk[1:] != blk[:-1]])
    table = np.zeros((nblocks, 2), dtype=np.int64)
    table[blk[starts], 0] = np.bitwise_or.reduceat(bits, starts).view(np.int64)
    counts = np.bincount(blk, minlength=nblocks)
    table[:, 1] = np.cumsum(counts) - counts
    return table.reshape(-1)


class JoinRank:
    """K18's rank route for one build map (``rank_route`` of its ``words``,
    the sorted unique canonical words): the route, the words' ends lo and
    hi, nk, and for the bitmap route its table, uploaded once a device.
    ``ints`` are the launch's integers (lo, hi, nk, nk - 1, max(nk, 1))."""

    def __init__(self, words: np.ndarray):
        self.nk = len(words)
        self.route = rank_route(words)
        self.lo = int(words[0]) if self.nk else 0
        self.hi = int(words[-1]) if self.nk else 0
        self.ints = (self.lo, self.hi, self.nk, max(self.nk - 1, 0), max(self.nk, 1))
        self._table = bitmap_table(words) if self.route == RANK_BITMAP else None
        self._on: Dict[tuple, torch.Tensor] = {}

    def table(self, device: torch.device) -> Optional[torch.Tensor]:
        """The bitmap table on ``device`` (None on the other routes)."""
        if self._table is None:
            return None
        key = (device.type, device.index)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.from_numpy(self._table).to(device)
        return t


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (a SWAR count; the masks keep the
    arithmetic shifts' sign bits out)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x + (x >> 32)) & 0x7F


def rank_probe_plain(rank: JoinRank, uniq: torch.Tensor,
                     words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K18's rank of canonical ``words`` on ``rank``'s route, in the
    kernel's arithmetic: (clip(searchsorted-left, 0, nk - 1), whether the
    word is a key). The range check comes before the subtraction, so a word
    range past 2^63 does not wrap. ``uniq``: the sorted words on the device
    (length max(nk, 1)), which the search reads."""
    nkm = rank.ints[3]
    if rank.route == RANK_SEARCH:
        idx = torch.searchsorted(uniq, words)
        cidx = idx.clamp(max=nkm)
        return cidx, (idx < rank.nk) & (uniq[cidx] == words)
    inr = (words >= rank.lo) & (words <= rank.hi)
    d = torch.where(inr, words, rank.lo) - rank.lo
    outside = torch.where(words > rank.hi, nkm, 0)
    if rank.route == RANK_DENSE:
        return torch.where(inr, d, outside), inr
    table = rank.table(words.device)
    mask, before = table[2 * (d >> 6)], table[2 * (d >> 6) + 1]
    bit = d & 63
    below = mask & ~(torch.full_like(bit, -1) << bit)
    return (torch.where(inr, before + _popcount64(below), outside),
            inr & (((mask >> bit) & 1) != 0))


def sorted_probe(uniq: torch.Tensor, data: torch.Tensor, valid: torch.Tensor,
                 nk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The membership probe against the build's sorted unique words
    (blaze_tpu/ops/joins/keymap.py:211 sorted_probe_traced): ``uniq`` has
    length max(nk, 1); returns each row's rank clip(searchsorted-left, 0,
    nk - 1) and its hit mask (valid, rank < nk and the word found)."""
    w = canon_words(data)
    idx = torch.searchsorted(uniq, w)
    cidx = idx.clamp(0, max(nk - 1, 0))
    return cidx, valid & (idx < nk) & (uniq[cidx] == w)


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

    Two code assignments share the CSR layout: a single fixed-width key
    has codes that are ranks in the sorted unique canonical words
    (``sorted_keys``), probed on the device (K9); several key columns are
    interned on the host (``key_map``). ``matched`` flags the build rows a
    task has matched (outer, semi and anti joins on the build side,
    existence): each task gets its own flags (``for_task``).
    """

    def __init__(self, batch: ColumnarBatch, key_map: Optional[Dict],
                 offsets: np.ndarray, schema: T.Schema,
                 sorted_keys: Optional[np.ndarray] = None):
        self.batch = batch          # build rows sorted by key code
        self.key_map = key_map
        self.offsets = offsets      # (num_codes + 1,) row ranges
        self.schema = schema
        self.sorted_keys = sorted_keys
        # one-element cell: every task of a query that shares this map
        # shares one upload of the sorted keys to the device, and K8's
        # argument words (``join_pack``) a device
        self._dev_cell: List[Optional[torch.Tensor]] = [None]
        self._packs: Dict[str, "kernels.JoinPack"] = {}
        # K18's rank route (``join_rank``), shared by the tasks as the upload is
        self._rank_cell: List[Optional[JoinRank]] = [None]
        self.matched = np.zeros(batch.num_rows, dtype=bool)

    def for_task(self) -> "JoinHashMap":
        """This map with fresh ``matched`` flags, sharing the build batch,
        the CSR and the device key upload: a cached map is shared by the
        tasks of every partition, and one task's matches must not leak
        into another's build tail."""
        m = JoinHashMap(self.batch, self.key_map, self.offsets, self.schema,
                        self.sorted_keys)
        m._dev_cell = self._dev_cell
        m._packs = self._packs
        m._rank_cell = self._rank_cell
        return m

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

    def join_pack(self, device: torch.device) -> "kernels.JoinPack":
        """K8's argument words for this map's build planes on ``device``
        (made once a query and device, shared by its tasks), its search
        route decided once, from the sorted words (``dense_key_words``)."""
        key = str(device)
        pack = self._packs.get(key)
        if pack is None:
            pack = self._packs[key] = kernels.JoinPack(
                self.device_keys(device), self.sorted_keys,
                *column_planes(self.batch.columns))
        return pack

    def join_rank(self) -> JoinRank:
        """K18's rank route for this map's sorted words (``JoinRank``),
        decided once a map, beside K8's pack; its bitmap table goes to each
        device once."""
        if self._rank_cell[0] is None:
            self._rank_cell[0] = JoinRank(self.sorted_keys)
        return self._rank_cell[0]

    @staticmethod
    def build(batches: List[ColumnarBatch], key_exprs: List[E.Expr],
              schema: T.Schema, device: torch.device,
              conf: Optional[Config] = None) -> "JoinHashMap":
        key_cols = []
        kept = []
        for b in batches:
            if b.num_rows == 0:
                continue
            ev = ExprEvaluator(key_exprs, b.schema)
            key_cols.append(ev.evaluate(b))
            kept.append(b)
        single = len(key_exprs) == 1
        if not kept:
            # the reference builds an empty interned map here, whose probe
            # indexes past its one offset; an empty map of the same kind as
            # a full one (nk = 0, or no interned key) probes to no match
            return JoinHashMap(ColumnarBatch.empty(schema, device, conf=conf),
                               None if single else {}, np.zeros(1, np.int64),
                               schema, np.zeros(0, np.int64) if single else None)
        if single:
            return JoinHashMap._build_sorted(kept, key_cols, schema, conf)
        key_map: Dict = {}
        code_arrays = [key_codes(b, cols, key_map, insert=True)
                       for b, cols in zip(kept, key_cols)]
        big = ColumnarBatch.concat(kept, schema, conf)
        return JoinHashMap._from_codes(big, np.concatenate(code_arrays),
                                       len(key_map), key_map, None, schema, conf)

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
        return JoinHashMap(big, key_map, offsets, schema, sorted_keys)

    def probe_codes(self, batch: ColumnarBatch,
                    cols: List[DeviceColumn]) -> np.ndarray:
        """Row key -> code for this map (-1: no match), on the host."""
        if self.sorted_keys is not None and len(cols) == 1:
            return self._device_probe(batch, cols[0])
        return key_codes(batch, cols, self.key_map, insert=False)

    def _device_probe(self, batch: ColumnarBatch, col: DeviceColumn) -> np.ndarray:
        """K9 over the key plane; the live rows' codes come to the host."""
        codes = kernels.probe_codes(self.device_keys(batch.device),
                                    len(self.sorted_keys), col.data, col.validity)
        return codes[: batch.num_rows].cpu().numpy()

    def probe(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """codes (n,) -> (probe_idx, build_idx, match_counts): all matching
        row pairs, in probe-row order, each probe row's build rows in CSR
        order."""
        valid = (codes >= 0) & (codes < self.num_codes)
        if self.num_codes == 0:
            # an empty build: no code is valid (the reference would index
            # past its one offset below)
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.zeros(len(codes), np.int64))
        safe = np.where(valid, codes, 0)
        starts = self.offsets[safe]
        ends = self.offsets[safe + 1]
        counts = np.where(valid, ends - starts, 0)
        total = int(counts.sum())
        if total == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64), counts)
        probe_idx = np.repeat(np.arange(len(codes)), counts)
        base = np.repeat(np.cumsum(counts) - counts, counts)
        build_idx = np.repeat(starts, counts) + (np.arange(total) - base)
        return probe_idx, build_idx, counts

    def serialize(self) -> bytes:
        raise NotImplementedError(
            "JoinHashMap broadcast serialization is not ported yet "
            "(ROADMAP.md Queue 1 item 8)")

    @staticmethod
    def deserialize(blob: bytes, schema):
        raise NotImplementedError(
            "JoinHashMap broadcast serialization is not ported yet "
            "(ROADMAP.md Queue 1 item 8)")
