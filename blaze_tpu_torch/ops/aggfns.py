"""Aggregate functions of the slice: state layout and finalisation.

The counterparts of SumAgg, CountAgg, AvgAgg and MinMaxAgg in
blaze_tpu/ops/aggfns.py, reduced to what the device slot aggregation
(ops/agg_device.py) needs: each function's partial-state fields, the
columns a merged state becomes (PARTIAL_MERGE) and its final value
(FINAL). Accumulation itself happens in kernels K3/K4.

Only integer-valued states are on this slice: SUM/AVG of integers or
decimals whose sum fits int64 (decimal p <= 18), MIN/MAX of integer,
decimal(p <= 18), date and timestamp values, COUNT of anything. A float
SUM/AVG/MIN/MAX, a wide-decimal (limb) state or any other aggregate raises
NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from blaze_tpu_torch.core.batch import DeviceColumn
from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.aggstate import avg_sum_type

_INT_TYPES = (T.Int8Type, T.Int16Type, T.Int32Type, T.Int64Type, T.DateType,
              T.TimestampType)


def _int_valued(dt: T.DataType) -> bool:
    return isinstance(dt, _INT_TYPES) or (
        isinstance(dt, T.DecimalType) and dt.fits_int64)


def is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.Float32Type, T.Float64Type))


def _not_ported(what: str, item: str = "Queue 2 item 6"):
    raise NotImplementedError(
        f"{what} is not on the PyTorch port's slice yet (ROADMAP.md {item})")


def _ones(capacity: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(capacity, dtype=torch.bool, device=like.device)


class AggFunction:
    """One aggregate over one arg; state is passed explicitly."""

    kind = ""

    def __init__(self, agg: E.AggExpr, arg_type: T.DataType,
                 result_type: T.DataType):
        self.agg = agg
        self.arg_type = arg_type
        self.result_type = result_type

    def state_fields(self) -> List[Tuple[str, T.DataType]]:
        raise NotImplementedError

    def state_columns(self, state, num_slots: int, capacity: int) -> List[DeviceColumn]:
        raise NotImplementedError

    def final_column(self, state, num_slots: int, capacity: int) -> DeviceColumn:
        raise NotImplementedError


class SumAgg(AggFunction):
    kind = "sum"

    def __init__(self, agg, arg_type, result_type):
        super().__init__(agg, arg_type, result_type)
        float_sum = isinstance(result_type, T.Float64Type) and (
            is_float(arg_type) or isinstance(arg_type, _INT_TYPES))
        if not (float_sum or (_int_valued(result_type) and _int_valued(arg_type))):
            _not_ported(f"SUM of {arg_type!r} into {result_type!r} (a "
                        "wide-decimal sum, or a decimal summed into a float)")

    def state_fields(self):
        return [("sum", self.result_type), ("has", T.BOOL)]

    def state_columns(self, state, num_slots, capacity):
        acc, has = state
        return [DeviceColumn(self.result_type, acc, has),
                DeviceColumn(T.BOOL, has, _ones(capacity, has))]

    def final_column(self, state, num_slots, capacity):
        acc, has = state
        if isinstance(self.result_type, T.DecimalType):
            acc, has = dec.check_overflow(acc, has, self.result_type.precision)
        return DeviceColumn(self.result_type, acc, has)


class CountAgg(AggFunction):
    kind = "count"

    def state_fields(self):
        return [("count", T.I64)]

    def state_columns(self, state, num_slots, capacity):
        (acc,) = state
        return [DeviceColumn(T.I64, acc, _ones(capacity, acc))]

    def final_column(self, state, num_slots, capacity):
        (acc,) = state
        return DeviceColumn(T.I64, acc, _ones(capacity, acc))


class AvgAgg(AggFunction):
    """State [sum (sum type), count]; the final value divides with Spark's
    HALF_UP decimal rules."""

    kind = "avg"

    def __init__(self, agg, arg_type, result_type):
        super().__init__(agg, arg_type, result_type)
        self.sum_type = avg_sum_type(arg_type)
        decimal_avg = (isinstance(self.sum_type, T.DecimalType)
                       and self.sum_type.fits_int64
                       and isinstance(result_type, T.DecimalType)
                       and result_type.fits_int64)
        float_avg = isinstance(self.sum_type, T.Float64Type) and \
            isinstance(result_type, T.Float64Type)
        if not (decimal_avg or float_avg):
            _not_ported(f"AVG of {arg_type!r} into {result_type!r} (a "
                        "wide-decimal average)")

    def state_fields(self):
        return [("sum", self.sum_type), ("count", T.I64)]

    def state_columns(self, state, num_slots, capacity):
        s, c = state
        return [DeviceColumn(self.sum_type, s, c > 0),
                DeviceColumn(T.I64, c, _ones(capacity, c))]

    def final_column(self, state, num_slots, capacity):
        s, c = state
        has = c > 0
        cnz = torch.where(has, c, torch.ones_like(c))
        if isinstance(self.result_type, T.Float64Type):
            return DeviceColumn(T.F64, s.to(torch.float64) / cnz.to(torch.float64), has)
        scale_adjust = self.result_type.scale - self.sum_type.scale
        out, validity = dec.div(s, has, cnz, has, scale_adjust)
        out, validity = dec.check_overflow(out, validity, self.result_type.precision)
        return DeviceColumn(self.result_type, out, validity)


class MinMaxAgg(AggFunction):
    def __init__(self, agg, arg_type, result_type, which: str):
        super().__init__(agg, arg_type, result_type)
        self.kind = which
        if not (_int_valued(arg_type) or is_float(arg_type)):
            _not_ported(f"{which.upper()} of {arg_type!r} (bool, string or "
                        "wide-decimal extremes)")

    def state_fields(self):
        return [("val", self.result_type), ("has", T.BOOL)]

    def state_columns(self, state, num_slots, capacity):
        val, has = state
        val = torch.where(has, val, torch.zeros_like(val))
        return [DeviceColumn(self.result_type, val, has),
                DeviceColumn(T.BOOL, has, _ones(capacity, has))]

    def final_column(self, state, num_slots, capacity):
        return self.state_columns(state, num_slots, capacity)[0]


def create_agg_function(agg: E.AggExpr, input_schema: T.Schema) -> AggFunction:
    arg_t = E.infer_type(agg.args[0], input_schema) if agg.args else T.NULL
    result_t = agg.return_type or E.agg_result_type(agg.fn, arg_t)
    F = E.AggFunction
    if agg.fn == F.SUM:
        return SumAgg(agg, arg_t, result_t)
    if agg.fn == F.COUNT:
        return CountAgg(agg, arg_t, T.I64)
    if agg.fn == F.AVG:
        return AvgAgg(agg, arg_t, result_t)
    if agg.fn == F.MIN:
        return MinMaxAgg(agg, arg_t, result_t, "min")
    if agg.fn == F.MAX:
        return MinMaxAgg(agg, arg_t, result_t, "max")
    _not_ported(f"aggregate function {agg.fn.value}", "Queue 2 item 17")
