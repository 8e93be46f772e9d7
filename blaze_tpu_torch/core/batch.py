"""Columnar batch representation — the unit of data flow between operators.

A batch is a struct of arrays: each fixed-width column is a dense
``torch.Tensor`` on the session's device, padded to a power-of-two
*capacity bucket* (``Config.capacity_for``), with an explicit ``num_rows``
and a bool validity tensor. Decimals of precision <= 18 carry their
unscaled value as int64. A decimal(19..38) is a ``WideColumn``: three
int64 planes ``l0``, ``l1`` (the non-negative 32-bit chunks of the low
64 bits) and ``l2`` (the signed high 64 bits), value = (l2 << 64) +
(l1 << 32) + l0, with one validity plane (the JAX package keeps such a
column on the host and reads the same limbs from its decimal128 buffer,
blaze_tpu/ops/agg_device.py ``_host_wide_planes``). It is a class of its
own, so code that reads one ``.data`` plane fails on it instead of
reading a wrong axis; the plane movers (K1, K6, K7) take it as three data
planes (``column_planes`` / ``columns_from_planes``).

Padding discipline (the JAX package's contract, compared bit for bit by
the tests): rows in ``[num_rows, capacity)`` have ``validity == False`` and
``data == 0`` (every plane of a wide column). ``validity`` means "row
exists AND value is non-null"; "row exists" alone is ``arange(capacity) <
num_rows``.

Var-width and nested columns (host-resident in the JAX package) are not
ported yet: building a batch with one raises NotImplementedError
(ROADMAP.md Queue 1 item 6b). The one exception is ``BytesColumn``, the
smallest host column a BINARY result needs (the bloom_filter aggregate's
serialized filter): Python ``bytes`` a row on the host, read by
``to_numpy``/``to_pydict`` and by nothing else; every plane mover refuses
it (``column_planes``), as do expressions and exchanges.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.ir import types as T

_IOTA: Dict[Tuple[int, str], torch.Tensor] = {}


def iota(capacity: int, device: torch.device) -> torch.Tensor:
    """Cached ``arange(capacity)`` (int64) per (capacity bucket, device)."""
    key = (capacity, str(device))
    t = _IOTA.get(key)
    if t is None:
        t = torch.arange(capacity, dtype=torch.int64, device=device)
        if len(_IOTA) < 64:
            _IOTA[key] = t
    return t


def row_mask(capacity: int, n: int, device: torch.device) -> torch.Tensor:
    return iota(capacity, device) < n


def _require_device_type(dt: T.DataType, name: str = "") -> torch.dtype:
    """The plane dtype of a column type: a wide decimal's limbs are int64."""
    if T.is_wide_decimal(dt):
        return torch.int64
    tdt = T.torch_dtype(dt)
    if tdt is None:
        raise NotImplementedError(
            f"column {name!r} of type {dt!r} has no device plane in the "
            "PyTorch port yet (strings, binary and nested types: ROADMAP.md "
            "Queue 1 item 6b)")
    return tdt


_LO32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1


def wide_words(values, valid=None) -> np.ndarray:
    """Python ints (unscaled decimals within 128 bits) -> ``(n, 2)`` int64
    words ``(lo_raw, hi)``, decimal128's buffer layout: lo_raw the low 64
    bits (bit 63 may be set), hi the signed high 64 bits. Null rows
    (``valid`` False) are 0."""
    out = np.zeros((len(values), 2), dtype=np.int64)
    for i, v in enumerate(values):
        if valid is not None and not valid[i]:
            continue
        v = int(v)
        lo = v & _U64
        out[i, 0] = lo - (1 << 64) if lo >> 63 else lo
        out[i, 1] = v >> 64
    return out


def wide_ints(l0: np.ndarray, l1: np.ndarray, l2: np.ndarray) -> np.ndarray:
    """Limb planes -> an object array of the exact Python ints."""
    return ((l2.astype(object) << 64) + (l1.astype(object) << 32)
            + l0.astype(object))


@dataclasses.dataclass
class WideColumn:
    """decimal(19..38): three int64 limb planes padded to capacity and one
    validity plane. ``l0``, ``l1`` in [0, 2^32), ``l2`` signed; value =
    (l2 << 64) + (l1 << 32) + l0 (blaze_tpu/ops/agg_device.py
    ``_WideLimbCol``)."""

    dtype: T.DecimalType
    l0: torch.Tensor
    l1: torch.Tensor
    l2: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    def planes(self) -> List[torch.Tensor]:
        return [self.l0, self.l1, self.l2]

    def nbytes(self) -> int:
        return 3 * 8 * self.capacity + self.validity.numel()

    @staticmethod
    def from_numpy(dt: T.DecimalType, words: np.ndarray,
                   validity: Optional[np.ndarray], capacity: int,
                   device: torch.device) -> "WideColumn":
        """From ``(n, 2)`` int64 ``(lo_raw, hi)`` words (``wide_words``;
        decimal128's buffer, as blaze_tpu/core/batch.py
        ``decimal128_limbs`` reads it)."""
        words = np.asarray(words, dtype=np.int64).reshape(-1, 2)
        n = len(words)
        vbuf = np.zeros(capacity, dtype=bool)
        vbuf[:n] = True if validity is None else np.asarray(validity, dtype=bool)
        lo = np.where(vbuf[:n], words[:, 0], 0)
        planes = []
        for x in (lo & _LO32, (lo >> 32) & _LO32, np.where(vbuf[:n], words[:, 1], 0)):
            buf = np.zeros(capacity, dtype=np.int64)
            buf[:n] = x
            planes.append(torch.from_numpy(buf).to(device))
        return WideColumn(dt, *planes, torch.from_numpy(vbuf).to(device))

    @staticmethod
    def from_ints(dt: T.DecimalType, values, valid: np.ndarray, capacity: int,
                  device: torch.device) -> "WideColumn":
        """From exact Python ints (null rows where ``valid`` is False)."""
        return WideColumn.from_numpy(dt, wide_words(values, valid), valid,
                                     capacity, device)

    def words(self, n: int) -> np.ndarray:
        """The first ``n`` rows as ``(n, 2)`` int64 ``(lo_raw, hi)`` words;
        one pull of the three planes."""
        p = torch.stack([x[:n] for x in self.planes()]).cpu().numpy()
        out = np.empty((n, 2), dtype=np.int64)
        out[:, 0] = (p[1] << 32) | p[0]
        out[:, 1] = p[2]
        return out


@dataclasses.dataclass
class BytesColumn:
    """A BINARY column on the host: one Python ``bytes`` (None where null)
    a row and a numpy validity, both of ``capacity`` rows (padding rows
    None and invalid). It has no device planes; it is not the string
    plane (ROADMAP.md Queue 1 item 6b)."""

    dtype: T.DataType
    values: List[Optional[bytes]]
    validity: np.ndarray

    @property
    def capacity(self) -> int:
        return len(self.values)

    def nbytes(self) -> int:
        return sum(len(v) for v in self.values if v is not None) + self.capacity

    @staticmethod
    def from_values(dt: T.DataType, values: List[Optional[bytes]],
                    capacity: int) -> "BytesColumn":
        vals = list(values) + [None] * (capacity - len(values))
        return BytesColumn(dt, vals, np.array([v is not None for v in vals], dtype=bool))

    def slice(self, offset: int, length: int, capacity: int) -> "BytesColumn":
        return BytesColumn.from_values(self.dtype, self.values[offset:offset + length],
                                       capacity)


def host_column_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of a BINARY host column (no device planes: the string and "
        "binary plane is ROADMAP.md Queue 1 item 6b)")


Column = Union["DeviceColumn", WideColumn, BytesColumn]


def plane_count(dt: T.DataType) -> int:
    return 3 if T.is_wide_decimal(dt) else 1


def column_planes(columns) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(datas, valids) of columns as the plane movers take them: one plane
    a column, three for a wide column, each beside the column's validity."""
    datas, valids = [], []
    for c in columns:
        if isinstance(c, BytesColumn):
            raise host_column_error("moving the planes")
        if isinstance(c, WideColumn):
            datas += c.planes()
            valids += [c.validity] * 3
        else:
            datas.append(c.data)
            valids.append(c.validity)
    return datas, valids


def columns_from_planes(dtypes, datas, valids) -> List[Column]:
    """The inverse of ``column_planes`` for columns of ``dtypes``: a wide
    column takes its three planes and the first one's validity."""
    cols, i = [], 0
    for dt in dtypes:
        if T.is_wide_decimal(dt):
            cols.append(WideColumn(dt, datas[i], datas[i + 1], datas[i + 2], valids[i]))
            i += 3
        else:
            cols.append(DeviceColumn(dt, datas[i], valids[i]))
            i += 1
    return cols


@dataclasses.dataclass
class DeviceColumn:
    """Fixed-width column: dense data padded to capacity + validity mask."""

    dtype: T.DataType
    data: torch.Tensor      # (capacity,), T.torch_dtype(dtype)
    validity: torch.Tensor  # (capacity,), bool

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.validity.numel())

    @staticmethod
    def from_numpy(dt: T.DataType, data: np.ndarray,
                   validity: Optional[np.ndarray], capacity: int,
                   device: torch.device) -> "DeviceColumn":
        tdt = _require_device_type(dt)
        n = len(data)
        npdt = np.dtype(np.int64) if isinstance(dt, T.DecimalType) \
            else dt.np_dtype
        buf = np.zeros(capacity, dtype=npdt)
        vbuf = np.zeros(capacity, dtype=bool)
        if validity is None:
            np.copyto(buf[:n], data, casting="unsafe")
            vbuf[:n] = True
        else:
            validity = np.asarray(validity, dtype=bool)
            np.copyto(buf[:n], np.where(validity, data, np.zeros((), npdt)),
                      casting="unsafe")
            vbuf[:n] = validity
        return DeviceColumn(
            dt, torch.from_numpy(buf).to(device=device, dtype=tdt),
            torch.from_numpy(vbuf).to(device))


@dataclasses.dataclass
class ColumnarBatch:
    schema: T.Schema
    columns: List[Column]
    num_rows: int

    def __post_init__(self):
        assert len(self.columns) == len(self.schema), (
            len(self.columns), len(self.schema))

    # --- constructors --------------------------------------------------------

    @staticmethod
    def from_numpy(schema: T.Schema,
                   cols: Mapping[str, Union[np.ndarray,
                                            Tuple[np.ndarray, Optional[np.ndarray]]]],
                   device: torch.device, capacity: Optional[int] = None,
                   conf: Optional[Config] = None) -> "ColumnarBatch":
        """Batch from numpy planes per schema field: ``cols[name]`` is the
        data array, or a ``(data, validity-or-None)`` pair. Decimals are
        given unscaled: int64 for precision <= 18, and for decimal(19..38)
        an ``(n, 2)`` int64 array of ``(lo_raw, hi)`` words, decimal128's
        buffer layout (``wide_words`` makes one from Python ints)."""
        planes = []
        n = None
        for f in schema.fields:
            v = cols[f.name]
            data, validity = v if isinstance(v, tuple) else (v, None)
            data = np.asarray(data)
            if n is None:
                n = len(data)
            elif len(data) != n:
                raise ValueError(f"column {f.name!r} has {len(data)} rows, "
                                 f"expected {n}")
            _require_device_type(f.dtype, f.name)
            planes.append((f.dtype, data, validity))
        n = n or 0
        cap = capacity or (conf or Config()).capacity_for(n)
        return ColumnarBatch(schema, [
            (WideColumn if T.is_wide_decimal(dt) else DeviceColumn).from_numpy(
                dt, d, v, cap, device)
            for dt, d, v in planes], n)

    @staticmethod
    def empty(schema: T.Schema, device: torch.device,
              conf: Optional[Config] = None) -> "ColumnarBatch":
        """A batch of no rows: zero planes of ``min_capacity`` rows, so a
        masked gather from it yields null rows."""
        cap = (conf or Config()).min_capacity
        datas, valids = [], []
        for f in schema.fields:
            tdt = _require_device_type(f.dtype, f.name)
            for _ in range(plane_count(f.dtype)):
                datas.append(torch.zeros(cap, dtype=tdt, device=device))
                valids.append(torch.zeros(cap, dtype=torch.bool, device=device))
        return ColumnarBatch(schema, columns_from_planes(schema.types, datas, valids), 0)

    # --- properties ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 256

    @property
    def device(self) -> torch.device:
        for c in self.columns:
            if not isinstance(c, BytesColumn):
                return c.validity.device
        return torch.device("cpu")

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def logical_nbytes(self) -> int:
        """Bytes of the live rows' planes (data + one validity byte per row
        per column): the size the JAX package's shuffle staging books for
        the same rows, which its AQE reducer coalescing sizes on."""
        return sum(c.nbytes() if isinstance(c, BytesColumn) else
                   self.num_rows * ((16 if isinstance(c, WideColumn)
                                     else c.data.element_size()) + 1)
                   for c in self.columns)

    def row_exists_mask(self) -> torch.Tensor:
        return row_mask(self.capacity, self.num_rows, self.device)

    # --- transforms ----------------------------------------------------------

    def take(self, indices: torch.Tensor,
             conf: Optional[Config] = None) -> "ColumnarBatch":
        """Row gather by device indices (all < num_rows)."""
        from blaze_tpu_torch.core import kernels

        n = int(indices.shape[0])
        cap = (conf or Config()).capacity_for(n)
        datas, valids = kernels.gather_planes(*column_planes(self.columns),
                                              indices, cap, n)
        return ColumnarBatch(self.schema, self._rebuild(datas, valids), n)

    def _rebuild(self, datas, valids) -> List[Column]:
        return columns_from_planes([c.dtype for c in self.columns], datas, valids)

    def take_nullable(self, indices: np.ndarray,
                      conf: Optional[Config] = None) -> "ColumnarBatch":
        """Row gather by host indices where -1 yields an all-null row (the
        outer joins' null extension): K6's masked form. With any null row
        the schema's fields become nullable, as in the JAX package."""
        from blaze_tpu_torch.core import kernels

        indices = np.asarray(indices, dtype=np.int64)
        n = len(indices)
        null_mask = indices < 0
        cap = (conf or Config()).capacity_for(n)
        dev = self.device
        datas, valids = kernels.gather_planes(
            *column_planes(self.columns),
            torch.from_numpy(np.where(null_mask, 0, indices)).to(dev), cap, n,
            live=torch.from_numpy(~null_mask).to(dev))
        cols = self._rebuild(datas, valids)
        schema = T.Schema(tuple(T.StructField(f.name, f.dtype, True)
                                for f in self.schema.fields)) \
            if null_mask.any() else self.schema
        return ColumnarBatch(schema, cols, n)

    def slice(self, offset: int, length: int,
              conf: Optional[Config] = None) -> "ColumnarBatch":
        from blaze_tpu_torch.core import kernels

        length = max(0, min(length, self.num_rows - offset))
        cap = (conf or Config()).capacity_for(length)
        datas, valids = kernels.slice_planes(*column_planes(self.columns),
                                             offset, length, cap)
        return ColumnarBatch(self.schema, self._rebuild(datas, valids), length)

    @staticmethod
    def concat(batches: List["ColumnarBatch"], schema: Optional[T.Schema] = None,
               conf: Optional[Config] = None) -> "ColumnarBatch":
        """Concatenate batches' live rows into one batch (capacity bucket of
        the total)."""
        from blaze_tpu_torch.core import kernels

        if not batches:
            raise ValueError("concat of zero batches")
        batches = [b for b in batches if b.num_rows > 0] or batches[:1]
        if len(batches) == 1:
            return batches[0]
        schema = schema or batches[0].schema
        total = sum(b.num_rows for b in batches)
        cap = (conf or Config()).capacity_for(total)
        per_batch = [column_planes(b.columns) for b in batches]
        nplanes = len(per_batch[0][0])
        datas, valids = kernels.concat_planes(
            [[d[i] for d, _ in per_batch] for i in range(nplanes)],
            [[v[i] for _, v in per_batch] for i in range(nplanes)],
            [b.num_rows for b in batches], cap)
        return ColumnarBatch(schema, batches[0]._rebuild(datas, valids), total)

    # --- host boundary -------------------------------------------------------

    def to_numpy(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """``{name: (data, validity)}`` numpy planes of the live rows; a
        wide column's data is its ``(n, 2)`` ``(lo_raw, hi)`` words, a
        BINARY host column's an object array of ``bytes``."""
        n = self.num_rows
        out = {}
        for f, c in zip(self.schema.fields, self.columns):
            if isinstance(c, BytesColumn):
                data = np.empty(n, dtype=object)
                data[:] = c.values[:n]
                out[f.name] = (data, c.validity[:n].copy())
            else:
                out[f.name] = (c.words(n) if isinstance(c, WideColumn)
                               else c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
        return out

    def to_pydict(self) -> Dict[str, list]:
        """Python values per column, in the shape the JAX package's
        ``to_pydict`` returns them: ints, floats, bools, ``decimal.Decimal``
        for decimals, ``datetime.date`` / ``datetime.datetime`` for dates
        and timestamps, ``bytes`` for binary, ``None`` for nulls."""
        out = {}
        for f, (data, valid) in zip(self.schema.fields, self.to_numpy().values()):
            if T.is_wide_decimal(f.dtype):
                lo = data[:, 0]
                data = wide_ints(lo & _LO32, (lo >> 32) & _LO32, data[:, 1])
            out[f.name] = [_py_value(f.dtype, v) if ok else None
                           for v, ok in zip(data.tolist(), valid.tolist())]
        return out

    def __repr__(self):
        return f"ColumnarBatch({self.num_rows} rows, schema={self.schema.names})"


_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)


# wide enough that a 38-digit unscaled value scales without rounding
_EXACT = decimal.Context(prec=80)


def _py_value(dt: T.DataType, v):
    if isinstance(dt, T.DecimalType):
        return decimal.Decimal(int(v)).scaleb(-dt.scale, _EXACT)
    if isinstance(dt, T.DateType):
        return _EPOCH_DATE + datetime.timedelta(days=int(v))
    if isinstance(dt, T.TimestampType):
        return _EPOCH_TS + datetime.timedelta(microseconds=int(v))
    return v
