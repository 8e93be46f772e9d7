"""Tagged-JSON encoding of expressions (the expression half of
blaze_tpu/ir/serde.py).

``expr_to_json`` gives the same text as the JAX package's for the same
expression tree: the whole-stage fusion pass fingerprints a chain with it
(``ir/fusion.py:fused_fingerprint``). Decoding, and the plan half with its
proto wire format, are not ported yet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import base64
import dataclasses
import decimal
import enum
import json
from typing import Any

from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T

_SIMPLE_NAMES = {
    T.NullType: "null", T.BooleanType: "bool", T.Int8Type: "i8", T.Int16Type: "i16",
    T.Int32Type: "i32", T.Int64Type: "i64", T.Float32Type: "f32", T.Float64Type: "f64",
    T.StringType: "string", T.BinaryType: "binary", T.DateType: "date",
    T.TimestampType: "timestamp",
}


def type_to_json(dt: T.DataType) -> Any:
    cls = type(dt)
    if cls in _SIMPLE_NAMES:
        return _SIMPLE_NAMES[cls]
    if isinstance(dt, T.DecimalType):
        return {"t": "decimal", "precision": dt.precision, "scale": dt.scale}
    if isinstance(dt, T.ArrayType):
        return {"t": "array", "element": type_to_json(dt.element_type)}
    if isinstance(dt, T.MapType):
        return {"t": "map", "key": type_to_json(dt.key_type),
                "value": type_to_json(dt.value_type)}
    if isinstance(dt, T.StructType):
        return {"t": "struct", "fields": [
            {"name": f.name, "type": type_to_json(f.dtype), "nullable": f.nullable}
            for f in dt.fields]}
    raise NotImplementedError(f"serde for {dt!r}")


def schema_to_json(s: T.Schema) -> Any:
    return [{"name": f.name, "type": type_to_json(f.dtype), "nullable": f.nullable}
            for f in s.fields]


_EXPR_CLASSES = {c.__name__ for c in vars(E).values()
                 if isinstance(c, type) and issubclass(c, E.Expr) and c is not E.Expr}
_NODE_CLASSES = {c.__name__ for c in vars(N).values()
                 if isinstance(c, type) and issubclass(c, N.PlanNode) and c is not N.PlanNode}
_AUX_CLASSES = {c.__name__ for c in (
    N.SinglePartitioning, N.HashPartitioning, N.RoundRobinPartitioning,
    N.RangePartitioning, N.FileRange, N.PartitionedFile, N.FileGroup,
    N.FileScanConf, N.AggColumn, N.WindowExpr,
)}


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, decimal.Decimal):
        return {"__decimal__": str(obj)}
    if isinstance(obj, bytes):
        return {"__bytes__": base64.b64encode(obj).decode()}
    if isinstance(obj, enum.Enum):
        return {"__enum__": type(obj).__name__, "v": obj.name}
    if isinstance(obj, T.DataType):
        return {"__type__": type_to_json(obj)}
    if isinstance(obj, T.Schema):
        return {"__schema__": schema_to_json(obj)}
    if isinstance(obj, (list, tuple)):
        return [_encode(x) for x in obj]
    if isinstance(obj, dict):
        return {"__dict__": {k: _encode(v) for k, v in obj.items()}}
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        if name not in _EXPR_CLASSES and name not in _NODE_CLASSES \
                and name not in _AUX_CLASSES:
            raise NotImplementedError(f"serde for dataclass {name}")
        out = {"__cls__": name}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if callable(v) and not isinstance(v, (E.Expr, N.PlanNode)):
                out[f.name] = {"__callable__": f"{v.__module__}:{v.__qualname__}"}
            else:
                out[f.name] = _encode(v)
        return out
    if isinstance(obj, T.StructField):
        return {"__field__": [obj.name, type_to_json(obj.dtype), obj.nullable]}
    raise NotImplementedError(f"serde for {type(obj)}")


def expr_to_json(expr: E.Expr) -> str:
    return json.dumps(_encode(expr))
