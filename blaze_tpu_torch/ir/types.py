"""Logical data types of the plan IR.

Covers the type subset the reference wire IR supports
(``auron.proto:860-896``: null/bool/ints/floats/utf8/binary/date32/
timestamp-micros/decimal128/list/map/struct) with Spark semantics.

Physical mapping (see core/batch.py): fixed-width types are dense torch
tensors on the session's device plus a bool validity tensor;
decimal(p<=18) is the unscaled int64; decimal(19..38) is three int64
planes (``is_wide_decimal``, core/batch.py ``WideColumn``), which only
aggregates and the plane movers read. Var-width and nested types are not
on this package's device path yet (``torch_dtype`` returns None for them
and for wide decimals; ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class DataType:
    """Base class. Concrete types are frozen dataclasses; simple types are
    singletons by construction equality."""

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return type(self).__name__.replace("Type", "").lower()

    # --- physical properties -------------------------------------------------

    @property
    def is_fixed_width(self) -> bool:
        return self.np_dtype is not None

    @property
    def np_dtype(self) -> Optional[np.dtype]:
        """numpy dtype of the dense device representation, or None if the
        type is host-resident (strings, binary, nested)."""
        return _NP_DTYPES.get(type(self))

    @property
    def byte_width(self) -> int:
        dt = self.np_dtype
        return 0 if dt is None else dt.itemsize


class NullType(DataType):
    pass


class BooleanType(DataType):
    pass


class Int8Type(DataType):
    pass


class Int16Type(DataType):
    pass


class Int32Type(DataType):
    pass


class Int64Type(DataType):
    pass


class Float32Type(DataType):
    pass


class Float64Type(DataType):
    pass


class StringType(DataType):
    pass


class BinaryType(DataType):
    pass


class DateType(DataType):
    """Days since the unix epoch, int32 (Arrow date32, Spark DateType)."""


class TimestampType(DataType):
    """Microseconds since the unix epoch, int64 (Spark TimestampType)."""


@dataclasses.dataclass(frozen=True, eq=False)
class DecimalType(DataType):
    """Spark decimal(precision, scale). precision<=18 is carried as a scaled
    int64 on device; larger precisions as three int64 limbs (a WideColumn)."""

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_INT64_PRECISION = 18

    def __eq__(self, other):
        return (
            isinstance(other, DecimalType)
            and self.precision == other.precision
            and self.scale == other.scale
        )

    def __hash__(self):
        return hash((DecimalType, self.precision, self.scale))

    def __repr__(self):
        return f"decimal({self.precision},{self.scale})"

    @property
    def np_dtype(self):
        return np.dtype(np.int64)

    @property
    def fits_int64(self) -> bool:
        return self.precision <= self.MAX_INT64_PRECISION


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayType(DataType):
    element_type: DataType = None
    contains_null: bool = True

    def __eq__(self, other):
        return isinstance(other, ArrayType) and self.element_type == other.element_type

    def __hash__(self):
        return hash((ArrayType, self.element_type))

    def __repr__(self):
        return f"array<{self.element_type!r}>"


@dataclasses.dataclass(frozen=True, eq=False)
class MapType(DataType):
    key_type: DataType = None
    value_type: DataType = None
    value_contains_null: bool = True

    def __eq__(self, other):
        return (
            isinstance(other, MapType)
            and self.key_type == other.key_type
            and self.value_type == other.value_type
        )

    def __hash__(self):
        return hash((MapType, self.key_type, self.value_type))

    def __repr__(self):
        return f"map<{self.key_type!r},{self.value_type!r}>"


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dtype: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class StructType(DataType):
    fields: Tuple[StructField, ...] = ()

    def __eq__(self, other):
        return isinstance(other, StructType) and self.fields == other.fields

    def __hash__(self):
        return hash((StructType, self.fields))

    def __repr__(self):
        inner = ",".join(f"{f.name}:{f.dtype!r}" for f in self.fields)
        return f"struct<{inner}>"


_NP_DTYPES = {
    BooleanType: np.dtype(np.bool_),
    Int8Type: np.dtype(np.int8),
    Int16Type: np.dtype(np.int16),
    Int32Type: np.dtype(np.int32),
    Int64Type: np.dtype(np.int64),
    Float32Type: np.dtype(np.float32),
    Float64Type: np.dtype(np.float64),
    DateType: np.dtype(np.int32),
    TimestampType: np.dtype(np.int64),
}

# Convenience singletons
NULL = NullType()
BOOL = BooleanType()
I8 = Int8Type()
I16 = Int16Type()
I32 = Int32Type()
I64 = Int64Type()
F32 = Float32Type()
F64 = Float64Type()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()


@dataclasses.dataclass(frozen=True)
class Schema:
    """Named, typed, nullable columns — the schema of every batch and every
    plan node's output (reference: arrow ``Schema`` via ``auron.proto:841-858``)."""

    fields: Tuple[StructField, ...]

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @staticmethod
    def of(*cols) -> "Schema":
        """Schema.of(("a", I64), ("b", STRING, False), StructField(...))"""
        fields = []
        for c in cols:
            if isinstance(c, StructField):
                fields.append(c)
            else:
                name, dtype, *rest = c
                fields.append(StructField(name, dtype, rest[0] if rest else True))
        return Schema(tuple(fields))

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def types(self):
        return [f.dtype for f in self.fields]

    def __len__(self):
        return len(self.fields)

    def __getitem__(self, i) -> StructField:
        if isinstance(i, str):
            return self.fields[self.index_of(i)]
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"column {name!r} not in schema {self.names}")

    def select(self, indices) -> "Schema":
        return Schema(tuple(self.fields[i] for i in indices))

    def rename(self, names) -> "Schema":
        assert len(names) == len(self.fields)
        return Schema(
            tuple(
                StructField(n, f.dtype, f.nullable)
                for n, f in zip(names, self.fields)
            )
        )

    def __add__(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)


def is_wide_decimal(dt: DataType) -> bool:
    """decimal(19..38): a value too wide for one int64, carried as three
    int64 limb planes (blaze_tpu/ops/agg_device.py ``_is_wide_dec``)."""
    return isinstance(dt, DecimalType) and not dt.fits_int64 and dt.precision <= 38


def torch_dtype(dt: DataType) -> Optional[torch.dtype]:
    """torch dtype of a fixed-width type's device plane, or None when the
    type has no dense plane (strings, binary, nested) or is a decimal too
    wide for one int64 (p > 18)."""
    if isinstance(dt, DecimalType):
        return torch.int64 if dt.fits_int64 else None
    npdt = dt.np_dtype
    return None if npdt is None else _TORCH_OF_NP[npdt.name]


_TORCH_OF_NP = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}

