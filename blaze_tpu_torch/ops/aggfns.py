"""Aggregate functions: state layout, the host table's state life cycle,
and finalisation.

The counterparts of SumAgg, CountAgg, AvgAgg, MinMaxAgg and FirstAgg in
blaze_tpu/ops/aggfns.py. Each function describes

- its partial-state fields, the columns a merged state becomes
  (PARTIAL_MERGE) and its final value (FINAL), which the device routes
  (ops/agg_device.py: K3/K4 and K10) and the host table share;
- for the host table (ops/agg.py ``AggTable``) its persistent slot tables
  on the device: ``init_state`` (identity fill), ``grow`` (doubling,
  identity fill) and the ops of one batch's ``update`` (raw rows) and
  ``merge`` (partial states). The table sends every
  aggregate's ops of a batch to K12 (core/kernels.py ``slot_update``) in
  one call, the counterpart of the reference's ``.at[slots]`` scatters.

Table layouts follow the reference's, widened where K12 takes 64-bit
words: MIN/MAX keep an integer extreme as int64 and a float32 one as
float64, narrowed back when emitted (exact: an extreme is one of its
values; a NaN narrows to the quiet NaN).

States on this slice: SUM/AVG of integers or decimals whose sum fits int64
(decimal p <= 18) and of floats (float64 sums), MIN/MAX of integer,
decimal(p <= 18), date, timestamp and float values, COUNT of anything,
FIRST / FIRST_IGNORES_NULL of any device type. Wide-decimal (limb)
states, MIN/MAX of bools and strings, and the host-object aggregates
(collect, combine-unique, bloom filter, UDAF) raise NotImplementedError
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from blaze_tpu_torch.core import kernels as K
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not on the PyTorch port's slice yet (ROADMAP.md {item})")


def _ones(capacity: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(capacity, dtype=torch.bool, device=like.device)


def _state_dtype(dt: T.DataType) -> torch.dtype:
    return torch.int64 if isinstance(dt, T.DecimalType) else T.torch_dtype(dt)


def _grow(t: torch.Tensor, capacity: int, fill=0) -> torch.Tensor:
    if t.shape[0] >= capacity:
        return t
    out = torch.full((capacity,), fill, dtype=t.dtype, device=t.device)
    out[:t.shape[0]] = t
    return out


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A widened table plane as the state's dtype (no-op when it is one)."""
    if x.dtype == dtype:
        return x
    return K.narrow_float(x, dtype) if x.is_floating_point() else x.to(dtype)


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

    # -- the host table's life cycle -------------------------------------------

    def init_state(self, capacity: int, device: torch.device) -> List[torch.Tensor]:
        raise NotImplementedError

    def grow(self, state, capacity: int) -> List[torch.Tensor]:
        return [_grow(s, capacity) for s in state]

    def update_ops(self, state, value, validity, order=None) -> List[K.SlotUpdate]:
        """The reference's ``update`` of one batch of raw rows as K12 ops:
        ``value``/``validity`` the argument's planes (None for COUNT(*)),
        ``order`` each row's global row order (FIRST)."""
        raise NotImplementedError

    def merge_ops(self, state, partial_cols: List[DeviceColumn]) -> List[K.SlotUpdate]:
        """The reference's ``merge`` of one batch of partial-state rows as
        K12 ops."""
        raise NotImplementedError


class SumAgg(AggFunction):
    kind = "sum"

    def __init__(self, agg, arg_type, result_type):
        super().__init__(agg, arg_type, result_type)
        float_sum = isinstance(result_type, T.Float64Type) and (
            is_float(arg_type) or isinstance(arg_type, _INT_TYPES))
        if not (float_sum or (_int_valued(result_type) and _int_valued(arg_type))):
            _not_ported(f"SUM of {arg_type!r} into {result_type!r} (a "
                        "wide-decimal sum, or a decimal summed into a float)",
                        "Queue 1 item 2")

    def state_fields(self):
        return [("sum", self.result_type), ("has", T.BOOL)]

    def init_state(self, capacity, device):
        return [torch.zeros(capacity, dtype=_state_dtype(self.result_type), device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device)]

    def _arg(self, value, validity):
        """The argument as the sum's dtype, rescaled to its decimal scale
        (``SumAgg._rescale_arg``; the validity the rescale computes is
        dropped there too)."""
        v = value.to(_state_dtype(self.result_type))
        if isinstance(self.arg_type, T.DecimalType) and \
                isinstance(self.result_type, T.DecimalType) and \
                self.result_type.scale != self.arg_type.scale:
            v, _ = dec.rescale(v, validity, self.arg_type.scale,
                               self.result_type.scale, 19)
        return v.contiguous()

    def update_ops(self, state, value, validity, order=None):
        acc, has = state
        return [K.SlotUpdate(K.UPD_ADD, acc, self._arg(value, validity), [validity]),
                K.SlotUpdate(K.UPD_FLAG, has, valids=[validity])]

    def merge_ops(self, state, partial_cols):
        acc, has = state
        psum, phas = partial_cols
        gate = [phas.data, phas.validity]
        return [K.SlotUpdate(K.UPD_ADD, acc, psum.data.to(acc.dtype).contiguous(), gate),
                K.SlotUpdate(K.UPD_FLAG, has, valids=gate)]

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

    def init_state(self, capacity, device):
        return [torch.zeros(capacity, dtype=torch.int64, device=device)]

    def update_ops(self, state, value, validity, order=None):
        (acc,) = state
        return [K.SlotUpdate(K.UPD_ADD, acc, valids=[] if value is None else [validity])]

    def merge_ops(self, state, partial_cols):
        (acc,) = state
        (pcol,) = partial_cols
        return [K.SlotUpdate(K.UPD_ADD, acc, pcol.data.to(torch.int64).contiguous(),
                             [pcol.validity])]

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
                        "wide-decimal average)", "Queue 1 item 2")
        self._sum = SumAgg(agg, arg_type, self.sum_type)

    def state_fields(self):
        return [("sum", self.sum_type), ("count", T.I64)]

    def init_state(self, capacity, device):
        return [torch.zeros(capacity, dtype=_state_dtype(self.sum_type), device=device),
                torch.zeros(capacity, dtype=torch.int64, device=device)]

    def update_ops(self, state, value, validity, order=None):
        s, c = state
        return [K.SlotUpdate(K.UPD_ADD, s, self._sum._arg(value, validity), [validity]),
                K.SlotUpdate(K.UPD_ADD, c, valids=[validity])]

    def merge_ops(self, state, partial_cols):
        s, c = state
        psum, pcnt = partial_cols
        return [K.SlotUpdate(K.UPD_ADD, s, psum.data.to(s.dtype).contiguous(),
                             [psum.validity]),
                K.SlotUpdate(K.UPD_ADD, c, pcnt.data.to(torch.int64).contiguous(),
                             [pcnt.validity])]

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
                        "wide-decimal extremes)", "Queue 1 items 2 and 6")

    def state_fields(self):
        return [("val", self.result_type), ("has", T.BOOL)]

    def _sentinel(self, dtype: torch.dtype):
        """The reference's ``_sentinel_np`` in the table's dtype."""
        if dtype.is_floating_point:
            return float("inf") if self.kind == "min" else float("-inf")
        info = torch.iinfo(_state_dtype(self.result_type))
        return info.max if self.kind == "min" else info.min

    def init_state(self, capacity, device):
        wide = torch.float64 if is_float(self.result_type) else torch.int64
        return [torch.full((capacity,), self._sentinel(wide), dtype=wide, device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device)]

    def grow(self, state, capacity):
        val, has = state
        return [_grow(val, capacity, self._sentinel(val.dtype)), _grow(has, capacity)]

    def _ops(self, state, data, gate):
        val, has = state
        kind = K.UPD_MIN if self.kind == "min" else K.UPD_MAX
        return [K.SlotUpdate(kind, val, data.to(val.dtype).contiguous(), gate),
                K.SlotUpdate(K.UPD_FLAG, has, valids=gate)]

    def update_ops(self, state, value, validity, order=None):
        return self._ops(state, value, [validity])

    def merge_ops(self, state, partial_cols):
        pval, phas = partial_cols
        return self._ops(state, pval.data, [phas.data, phas.validity])

    def state_columns(self, state, num_slots, capacity):
        val, has = state
        val = _narrow(val, _state_dtype(self.result_type))
        val = torch.where(has, val, torch.zeros_like(val))
        return [DeviceColumn(self.result_type, val, has),
                DeviceColumn(T.BOOL, has, _ones(capacity, has))]

    def final_column(self, state, num_slots, capacity):
        return self.state_columns(state, num_slots, capacity)[0]


class FirstAgg(AggFunction):
    """FIRST / FIRST_IGNORES_NULL: the winner is the row of least global row
    order (one K12 op: the reference's order min, then conditional value
    write)."""

    kind = "first"

    def __init__(self, agg, arg_type, result_type, ignores_null: bool):
        super().__init__(agg, arg_type, result_type)
        self.ignores_null = ignores_null
        if T.torch_dtype(result_type) is None:
            _not_ported(f"FIRST of {result_type!r} (a host-resident value)",
                        "Queue 1 items 2 and 6")

    def state_fields(self):
        return [("val", self.result_type), ("valid", T.BOOL), ("order", T.I64)]

    def init_state(self, capacity, device):
        return [torch.zeros(capacity, dtype=_state_dtype(self.result_type), device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device),
                torch.full((capacity,), K.I64_MAX, dtype=torch.int64, device=device)]

    def grow(self, state, capacity):
        val, valid, best = state
        return [_grow(val, capacity), _grow(valid, capacity),
                _grow(best, capacity, K.I64_MAX)]

    def update_ops(self, state, value, validity, order=None):
        val, valid, best = state
        return [K.SlotUpdate(K.UPD_FIRST, val, value.to(val.dtype).contiguous(),
                             [validity] if self.ignores_null else [], order=order,
                             wvalids=[validity], valid_table=valid, order_table=best)]

    def merge_ops(self, state, partial_cols):
        val, valid, best = state
        pval, pvalid, porder = partial_cols
        return [K.SlotUpdate(K.UPD_FIRST, val, pval.data.to(val.dtype).contiguous(),
                             [porder.data != K.I64_MAX], order=porder.data.contiguous(),
                             wvalids=[pval.validity, pvalid.data, pvalid.validity],
                             valid_table=valid, order_table=best)]

    def state_columns(self, state, num_slots, capacity):
        val, valid, best = state
        ones = _ones(capacity, valid)
        return [DeviceColumn(self.result_type, val, valid),
                DeviceColumn(T.BOOL, valid, ones),
                DeviceColumn(T.I64, best, ones)]

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
    if agg.fn == F.FIRST:
        return FirstAgg(agg, arg_t, result_t, ignores_null=False)
    if agg.fn == F.FIRST_IGNORES_NULL:
        return FirstAgg(agg, arg_t, result_t, ignores_null=True)
    if agg.fn == F.BLOOM_FILTER:
        _not_ported("the bloom_filter aggregate", "Queue 1 item 7")
    _not_ported(f"aggregate function {agg.fn.value} (host-object states: "
                "collect, combine-unique, UDAF)", "Queue 1 item 3")
