"""Sort-key normalisation and the window's peer keys.

As blaze_tpu/ops/sort_keys.py ``key_operands``: every sort key becomes a
(u8 rank, native value) operand pair, direction-adjusted, with nulls,
NaNs and padding rows folded into the rank (K5's key pass,
core/kernels.py ``sort_key_operands``). ``peer_key_rows`` is the
window's order-key encoding (ops/joins/keymap.py). ``host_key_part`` is
the host sort key of one Python value (blaze_tpu/ops/sort_keys.py
``_host_key_part``); the range exchange's bound sampling sorts by
``spark_key_part``, the same key with floats in Spark's order
(runtime/session.py). Keys must be device (fixed-width) values, a
decimal(19..38) its three limb planes; the host path for var-width keys
is not ported (ROADMAP.md Queue 1 items 6b and 3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast
from blaze_tpu_torch.ir import exprs as E


def key_spec(sort_orders: List[E.SortOrder]) -> tuple:
    return tuple((so.ascending, so.nulls_first) for so in sort_orders)


def key_operands(batch: ColumnarBatch,
                 sort_orders: List[E.SortOrder]) -> List[torch.Tensor]:
    """[rank0, val0, rank1, val1, ...]; padding rows sort last. A
    decimal(19..38) key sorts as its limbs (l2 signed, then the 32-bit
    chunks l1 and l0), each in the key's direction with its validity: the
    numeric order of the value."""
    ev = ExprEvaluator([so.child for so in sort_orders], batch.schema)
    datas, valids, spec = [], [], []
    for so, dirs in zip(sort_orders, key_spec(sort_orders)):
        d, v = broadcast(ev.eval(so.child, batch), batch)
        planes = d[::-1] if isinstance(d, tuple) else (d,)
        datas += planes
        valids += [v] * len(planes)
        spec += [dirs] * len(planes)
    return K.sort_key_operands(datas, valids, batch.row_exists_mask(), tuple(spec))


def peer_key_rows(batch: ColumnarBatch, sort_orders: List[E.SortOrder],
                  evaluator: Optional[ExprEvaluator] = None) -> np.ndarray:
    """Canonical per-row ORDER-key rows for window peer-boundary detection
    (keymap.key_rows), so peer equality matches partition-key equality:
    floats folded (-0.0 == 0.0, one NaN payload), nulls grouped as values.
    Sort direction is irrelevant here: peers are equal-key runs of input
    that is already sorted."""
    from blaze_tpu_torch.ops.joins.keymap import key_rows

    ev = evaluator or ExprEvaluator([so.child for so in sort_orders],
                                    batch.schema)
    return key_rows(batch, ev.evaluate(batch))


class _Rev:
    """Reverses comparison order for descending host keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def spark_key_part(v, so: E.SortOrder):
    """``host_key_part`` in Spark's order of floats (its RangePartitioner's
    ordering): NaN above every value (so first under DESC), -0.0 equal to
    0.0. The range exchange sorts its samples by it; the JAX package sorts
    a float NaN with ``<``, which leaves its bounds out of order."""
    if isinstance(v, float):
        v = (1, 0.0) if v != v else (0, v + 0.0)
    return host_key_part(v, so)


def host_key_part(v, so: E.SortOrder):
    """One Python value's host sort key: (null rank, value), the value
    reversed under DESC; nulls before (rank 0) or after (rank 2) every
    value (rank 1)."""
    null_rank = (0 if so.nulls_first else 2) if v is None else 1
    if v is None:
        return (null_rank, 0)
    return (null_rank, _Rev(v) if not so.ascending else v)
