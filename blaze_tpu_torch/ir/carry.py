"""State carried across from another package: plans and data.

A query engine's "weights" are its plan and its data. ``from_foreign``
rebuilds a plan, expression or type tree built with another package's IR
classes (for instance the JAX package's ``blaze_tpu.ir``, whose IR this
package copies) into this package's classes, matching by class name and
dataclass field names; it imports nothing of the other package.
``columns_from_numpy`` turns numpy (data, validity) planes — for example
``np.asarray(col.data)`` and ``np.asarray(col.validity)`` of another
engine's device column — into a batch of this package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch

from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T

_MODULES = (T, E, N)


def _port_class(name: str):
    for mod in _MODULES:
        cls = getattr(mod, name, None)
        if isinstance(cls, type):
            return cls
    raise TypeError(f"no IR class named {name!r} in blaze_tpu_torch.ir")


def from_foreign(obj):
    """Rebuild ``obj`` (a plan node, expression, data type, schema, enum,
    or a list/tuple/dict of them) with this package's IR classes."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_foreign(x) for x in obj)
    if isinstance(obj, dict):
        return {from_foreign(k): from_foreign(v) for k, v in obj.items()}
    cls_name = type(obj).__name__
    if isinstance(obj, enum.Enum):
        return _port_class(cls_name)(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _port_class(cls_name)
        kwargs = {f.name: from_foreign(getattr(obj, f.name))
                  for f in dataclasses.fields(obj) if f.init}
        return cls(**kwargs)
    if type(obj).__module__.endswith(".ir.types") and cls_name.endswith("Type"):
        return _port_class(cls_name)()  # field-less singleton types
    return obj  # opaque payloads (literal values, UDF objects)


Planes = Union[np.ndarray, Tuple[np.ndarray, Optional[np.ndarray]]]


def columns_from_numpy(schema: T.Schema, cols: Mapping[str, Planes],
                       device: Union[str, torch.device] = "cpu",
                       capacity: Optional[int] = None):
    """A ColumnarBatch of ``schema`` from ``{name: data or (data,
    validity)}`` numpy planes; a foreign schema is converted first.
    Planes longer than the live rows (padded device planes) are taken
    whole: pass ``capacity`` and slice to the live rows beforehand when
    only those are wanted."""
    from blaze_tpu_torch.core.batch import ColumnarBatch

    if not isinstance(schema, T.Schema):
        schema = from_foreign(schema)
    return ColumnarBatch.from_numpy(schema, cols, torch.device(device),
                                    capacity=capacity)
