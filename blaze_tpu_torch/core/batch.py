"""Columnar batch representation — the unit of data flow between operators.

A batch is a struct of arrays: each fixed-width column is a dense
``torch.Tensor`` on the session's device, padded to a power-of-two
*capacity bucket* (``Config.capacity_for``), with an explicit ``num_rows``
and a bool validity tensor. Decimals of precision <= 18 carry their
unscaled value as int64.

Padding discipline (the JAX package's contract, compared bit for bit by
the tests): rows in ``[num_rows, capacity)`` have ``validity == False`` and
``data == 0``. ``validity`` means "row exists AND value is non-null"; "row
exists" alone is ``arange(capacity) < num_rows``.

Var-width and nested columns (host-resident in the JAX package) are not
ported yet: building a batch with one raises NotImplementedError
(ROADMAP.md Queue 1).
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
    tdt = T.torch_dtype(dt)
    if tdt is None:
        raise NotImplementedError(
            f"column {name!r} of type {dt!r} has no device plane in the "
            "PyTorch port yet (strings, binary, nested and decimals wider "
            "than 18 digits: ROADMAP.md Queue 1 items 2 and 11)")
    return tdt


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
    columns: List[DeviceColumn]
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
        given unscaled (int64)."""
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
            DeviceColumn.from_numpy(dt, d, v, cap, device)
            for dt, d, v in planes], n)

    @staticmethod
    def empty(schema: T.Schema, device: torch.device,
              conf: Optional[Config] = None) -> "ColumnarBatch":
        """A batch of no rows: zero planes of ``min_capacity`` rows, so a
        masked gather from it yields null rows."""
        cap = (conf or Config()).min_capacity
        cols = [DeviceColumn(f.dtype,
                             torch.zeros(cap, dtype=_require_device_type(f.dtype, f.name),
                                         device=device),
                             torch.zeros(cap, dtype=torch.bool, device=device))
                for f in schema.fields]
        return ColumnarBatch(schema, cols, 0)

    # --- properties ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 256

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device if self.columns \
            else torch.device("cpu")

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def logical_nbytes(self) -> int:
        """Bytes of the live rows' planes (data + one validity byte per row
        per column): the size the JAX package's shuffle staging books for
        the same rows, which its AQE reducer coalescing sizes on."""
        return sum(self.num_rows * (c.data.element_size() + 1)
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
        datas, valids = kernels.gather_planes(
            [c.data for c in self.columns], [c.validity for c in self.columns],
            indices, cap, n)
        cols = [DeviceColumn(c.dtype, d, v)
                for c, d, v in zip(self.columns, datas, valids)]
        return ColumnarBatch(self.schema, cols, n)

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
            [c.data for c in self.columns], [c.validity for c in self.columns],
            torch.from_numpy(np.where(null_mask, 0, indices)).to(dev), cap, n,
            live=torch.from_numpy(~null_mask).to(dev))
        cols = [DeviceColumn(c.dtype, d, v)
                for c, d, v in zip(self.columns, datas, valids)]
        schema = T.Schema(tuple(T.StructField(f.name, f.dtype, True)
                                for f in self.schema.fields)) \
            if null_mask.any() else self.schema
        return ColumnarBatch(schema, cols, n)

    def slice(self, offset: int, length: int,
              conf: Optional[Config] = None) -> "ColumnarBatch":
        from blaze_tpu_torch.core import kernels

        length = max(0, min(length, self.num_rows - offset))
        cap = (conf or Config()).capacity_for(length)
        datas, valids = kernels.slice_planes(
            [c.data for c in self.columns], [c.validity for c in self.columns],
            offset, length, cap)
        cols = [DeviceColumn(c.dtype, d, v)
                for c, d, v in zip(self.columns, datas, valids)]
        return ColumnarBatch(self.schema, cols, length)

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
        ncols = len(batches[0].columns)
        datas, valids = kernels.concat_planes(
            [[b.columns[i].data for b in batches] for i in range(ncols)],
            [[b.columns[i].validity for b in batches] for i in range(ncols)],
            [b.num_rows for b in batches], cap)
        cols = [DeviceColumn(batches[0].columns[i].dtype, datas[i], valids[i])
                for i in range(ncols)]
        return ColumnarBatch(schema, cols, total)

    # --- host boundary -------------------------------------------------------

    def to_numpy(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """``{name: (data, validity)}`` numpy planes of the live rows."""
        n = self.num_rows
        return {f.name: (c.data[:n].cpu().numpy(), c.validity[:n].cpu().numpy())
                for f, c in zip(self.schema.fields, self.columns)}

    def to_pydict(self) -> Dict[str, list]:
        """Python values per column, in the shape the JAX package's
        ``to_pydict`` returns them: ints, floats, bools, ``decimal.Decimal``
        for decimals, ``datetime.date`` / ``datetime.datetime`` for dates
        and timestamps, ``None`` for nulls."""
        out = {}
        for f, (data, valid) in zip(self.schema.fields, self.to_numpy().values()):
            out[f.name] = [_py_value(f.dtype, v) if ok else None
                           for v, ok in zip(data.tolist(), valid.tolist())]
        return out

    def __repr__(self):
        return f"ColumnarBatch({self.num_rows} rows, schema={self.schema.names})"


_EPOCH_DATE = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)


def _py_value(dt: T.DataType, v):
    if isinstance(dt, T.DecimalType):
        return decimal.Decimal(int(v)).scaleb(-dt.scale)
    if isinstance(dt, T.DateType):
        return _EPOCH_DATE + datetime.timedelta(days=int(v))
    if isinstance(dt, T.TimestampType):
        return _EPOCH_TS + datetime.timedelta(microseconds=int(v))
    return v
