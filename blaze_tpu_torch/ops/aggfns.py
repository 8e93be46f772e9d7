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
FIRST / FIRST_IGNORES_NULL of any one-plane device type, and the
wide-decimal (limb) states that ir/aggstate.py ``state_mode`` picks:
SUM/AVG of a decimal(9..18) into decimal(19..28) as two int64 limbs
(``limbs == "2"``), SUM/AVG of a decimal(19..38) as three (``"3"``), and
MIN/MAX of a decimal(19..38) as three value limbs compared
lexicographically (``"w"``). A merge reads the limb decision from the
partial state's field names, never deriving it again. A limb state's
final value comes to the host in one pull, is combined into exact Python
ints (AVG divides HALF_UP into its result scale), nulled past the result
precision (Spark's check_overflow), and goes back to the device as a
wide (or, for a narrow AVG result, one-plane) decimal column.

``BloomFilterAgg`` (``bloom_filter``, the runtime filter's build) is a
host aggregate: its state is one ``SparkBloomFilter`` on the host, each
batch's argument plane and validity come to the host in one pull and go
to ``put_longs``, and its final value is one row of a BINARY host column
(``BytesColumn``) holding the serialized filter. The host table takes it
in COMPLETE mode without grouping keys (``ops/agg.py``).

A decimal SUM whose scale changes (the reference's host object sum),
MIN/MAX of bools and strings, and the other host-object aggregates
(collect, combine-unique, UDAF) raise NotImplementedError naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import decimal
from typing import List, Tuple

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import BytesColumn, DeviceColumn, WideColumn, wide_ints
from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.aggstate import (avg_sum_type, limb3_tag, limb_tag, state_mode,
                                         wide_val_tag)

# the device routes' names of the limb layouts (ops/agg_device.py)
LIMB_KINDS = ("sum2", "avg2", "sum3", "avg3", "minw", "maxw")

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


def _limb_mode(fn: E.AggFunction, arg_type, result_type, limbs):
    """``limbs`` None derives the layout (ir/aggstate.py ``state_mode``); a
    merge passes the one its partial state names."""
    return state_mode(fn, arg_type, result_type) if limbs is None else (limbs or False)


def _pull(planes: List[torch.Tensor], num_slots: int) -> np.ndarray:
    """The first ``num_slots`` values of int64/bool planes in one pull."""
    return torch.stack([p[:num_slots].to(torch.int64) for p in planes]).cpu().numpy()


def decimal_column(dt: T.DecimalType, totals, valid: np.ndarray, capacity: int,
                   device: torch.device):
    """Exact unscaled Python ints -> a decimal column of ``capacity`` rows,
    null where not ``valid`` or past the precision (Spark's check_overflow,
    as ``_host_col_out`` nulls them): a WideColumn for decimal(19..38),
    else int64 planes."""
    bound = 10 ** dt.precision
    n = len(totals)
    ok = np.zeros(capacity, dtype=bool)
    ok[:n] = [bool(v) and -bound < int(t) < bound for t, v in zip(totals, valid)]
    if T.is_wide_decimal(dt):
        return WideColumn.from_ints(dt, list(totals), ok[:n], capacity, device)
    data = np.zeros(capacity, dtype=np.int64)
    data[:n] = [int(t) if v else 0 for t, v in zip(totals, ok[:n])]
    return DeviceColumn(dt, torch.from_numpy(data).to(device), torch.from_numpy(ok).to(device))


def _limb_totals(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """A two-limb sum's exact totals (``_limb_final_column``)."""
    return (hi.astype(object) << 32) + lo.astype(object)


def _limb_ops(state, data, gate) -> List[K.SlotUpdate]:
    """K12's adds of one batch into a limb sum's tables, then their carry
    renormalisation: limb planes (a list) added as they are, or an int64
    source split into the two limbs."""
    if isinstance(data, (list, tuple)):
        tables = state[:len(data)]
        ops = [K.SlotUpdate(K.UPD_ADD, t, d.contiguous(), gate) for t, d in zip(tables, data)]
    else:
        tables = state[:2]
        src = data.to(torch.int64).contiguous()
        ops = [K.SlotUpdate(K.UPD_ADD_LO32, tables[0], src, gate),
               K.SlotUpdate(K.UPD_ADD_HI32, tables[1], src, gate)]
    return ops + [K.SlotUpdate(K.UPD_RENORM, tables[0], valids=gate, tables=tables[1:])]


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A widened table plane as the state's dtype (no-op when it is one)."""
    if x.dtype == dtype:
        return x
    return K.narrow_float(x, dtype) if x.is_floating_point() else x.to(dtype)


class AggFunction:
    """One aggregate over one arg; state is passed explicitly."""

    kind = ""
    limbs = False
    host = False  # a host aggregate (update_host), not K12 ops

    def __init__(self, agg: E.AggExpr, arg_type: T.DataType,
                 result_type: T.DataType):
        self.agg = agg
        self.arg_type = arg_type
        self.result_type = result_type

    @property
    def device_kind(self) -> str:
        """The device routes' kind: sum2/avg2/sum3/avg3/minw/maxw for a limb
        layout, else ``kind``."""
        if not self.limbs:
            return self.kind
        return self.kind + ("w" if self.limbs == "w" else self.limbs)

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

    def __init__(self, agg, arg_type, result_type, limbs=None):
        super().__init__(agg, arg_type, result_type)
        self.limbs = _limb_mode(E.AggFunction.SUM, arg_type, result_type, limbs)
        if self.limbs:
            return
        float_sum = isinstance(result_type, T.Float64Type) and (
            is_float(arg_type) or isinstance(arg_type, _INT_TYPES))
        if isinstance(arg_type, T.DecimalType) and isinstance(result_type, T.DecimalType) \
                and not result_type.fits_int64:
            _not_ported(f"SUM of {arg_type!r} into {result_type!r} (a decimal sum "
                        "whose scale changes: the JAX package's host object sum)",
                        "Queue 1 item 3")
        if not (float_sum or (_int_valued(result_type) and _int_valued(arg_type))):
            _not_ported(f"SUM of {arg_type!r} into {result_type!r} (a decimal summed "
                        "into a float: the JAX package adds the unscaled values; Spark "
                        "casts the argument, SUM(CAST(x AS DOUBLE)), which the port runs)",
                        "Queue 3")

    def state_fields(self):
        if self.limbs == "2":
            return [(limb_tag(self.result_type), T.I64), ("sum_hi", T.I64), ("has", T.BOOL)]
        if self.limbs == "3":
            return [(limb3_tag(self.result_type, self.arg_type), T.I64), ("sum_l1", T.I64),
                    ("sum_l2", T.I64), ("has", T.BOOL)]
        return [("sum", self.result_type), ("has", T.BOOL)]

    def init_state(self, capacity, device):
        if self.limbs:
            return [torch.zeros(capacity, dtype=torch.int64, device=device)
                    for _ in range(int(self.limbs))] + \
                [torch.zeros(capacity, dtype=torch.bool, device=device)]
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
        if self.limbs:
            return _limb_ops(state, value, [validity]) + \
                [K.SlotUpdate(K.UPD_FLAG, state[-1], valids=[validity])]
        acc, has = state
        return [K.SlotUpdate(K.UPD_ADD, acc, self._arg(value, validity), [validity]),
                K.SlotUpdate(K.UPD_FLAG, has, valids=[validity])]

    def merge_ops(self, state, partial_cols):
        *parts, phas = partial_cols
        gate = [phas.data, phas.validity]
        if self.limbs:
            return _limb_ops(state, [c.data for c in parts], gate) + \
                [K.SlotUpdate(K.UPD_FLAG, state[-1], valids=gate)]
        acc, has = state
        (psum,) = parts
        return [K.SlotUpdate(K.UPD_ADD, acc, psum.data.to(acc.dtype).contiguous(), gate),
                K.SlotUpdate(K.UPD_FLAG, has, valids=gate)]

    def state_columns(self, state, num_slots, capacity):
        if self.limbs:
            return _limb_state_columns(state, capacity)
        acc, has = state
        return [DeviceColumn(self.result_type, acc, has),
                DeviceColumn(T.BOOL, has, _ones(capacity, has))]

    def final_column(self, state, num_slots, capacity):
        if self.limbs:
            p = _pull(state, num_slots)
            totals = _limb_totals(p[0], p[1]) if self.limbs == "2" else \
                wide_ints(p[0], p[1], p[2])
            return decimal_column(self.result_type, totals, p[-1] != 0, capacity,
                                  state[0].device)
        acc, has = state
        if isinstance(self.result_type, T.DecimalType):
            acc, has = dec.check_overflow(acc, has, self.result_type.precision)
        return DeviceColumn(self.result_type, acc, has)


def _limb_state_columns(state, capacity: int) -> List[DeviceColumn]:
    """A limb state's columns: int64 planes (bool for a has flag), every
    row valid (``state_columns``' limb branches)."""
    ones = _ones(capacity, state[0])
    return [DeviceColumn(T.BOOL if s.dtype == torch.bool else T.I64, s, ones)
            for s in state]


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

    def __init__(self, agg, arg_type, result_type, limbs=None):
        super().__init__(agg, arg_type, result_type)
        self.sum_type = avg_sum_type(arg_type)
        self.limbs = _limb_mode(E.AggFunction.AVG, arg_type, result_type, limbs)
        if self.limbs:
            return
        decimal_avg = (isinstance(self.sum_type, T.DecimalType)
                       and self.sum_type.fits_int64
                       and isinstance(result_type, T.DecimalType)
                       and result_type.fits_int64)
        float_avg = isinstance(self.sum_type, T.Float64Type) and \
            isinstance(result_type, T.Float64Type)
        if not (decimal_avg or float_avg):
            _not_ported(f"AVG of {arg_type!r} into {result_type!r} (the JAX package's "
                        "host object average)", "Queue 1 item 3")
        self._sum = SumAgg(agg, arg_type, self.sum_type)

    def state_fields(self):
        if self.limbs == "2":
            return [(limb_tag(self.sum_type), T.I64), ("sum_hi", T.I64), ("count", T.I64)]
        if self.limbs == "3":
            return [(limb3_tag(self.sum_type, self.arg_type), T.I64), ("sum_l1", T.I64),
                    ("sum_l2", T.I64), ("count", T.I64)]
        return [("sum", self.sum_type), ("count", T.I64)]

    def init_state(self, capacity, device):
        if self.limbs:
            return [torch.zeros(capacity, dtype=torch.int64, device=device)
                    for _ in range(int(self.limbs) + 1)]
        return [torch.zeros(capacity, dtype=_state_dtype(self.sum_type), device=device),
                torch.zeros(capacity, dtype=torch.int64, device=device)]

    def update_ops(self, state, value, validity, order=None):
        if self.limbs:
            return _limb_ops(state, value, [validity]) + \
                [K.SlotUpdate(K.UPD_ADD, state[-1], valids=[validity])]
        s, c = state
        return [K.SlotUpdate(K.UPD_ADD, s, self._sum._arg(value, validity), [validity]),
                K.SlotUpdate(K.UPD_ADD, c, valids=[validity])]

    def merge_ops(self, state, partial_cols):
        if self.limbs:
            *parts, pcnt = partial_cols
            gate = [pcnt.data != 0, pcnt.validity]
            return _limb_ops(state, [c.data for c in parts], gate) + \
                [K.SlotUpdate(K.UPD_ADD, state[-1], pcnt.data.contiguous(), gate)]
        s, c = state
        psum, pcnt = partial_cols
        return [K.SlotUpdate(K.UPD_ADD, s, psum.data.to(s.dtype).contiguous(),
                             [psum.validity]),
                K.SlotUpdate(K.UPD_ADD, c, pcnt.data.to(torch.int64).contiguous(),
                             [pcnt.validity])]

    def state_columns(self, state, num_slots, capacity):
        if self.limbs:
            return _limb_state_columns(state, capacity)
        s, c = state
        return [DeviceColumn(self.sum_type, s, c > 0),
                DeviceColumn(T.I64, c, _ones(capacity, c))]

    def _decimal_divide(self, totals, counts, capacity: int, device):
        """Exact Decimal sum / count, HALF_UP into the result scale, under
        a context wide enough for 38-digit sums; null for no rows or past
        the result precision."""
        rt = self.result_type
        q = decimal.Decimal(1).scaleb(-rt.scale)
        out, ok = [], []
        with decimal.localcontext() as ctx:
            ctx.prec = 80
            for t, c in zip(totals, counts):
                if not c:
                    out.append(0)
                    ok.append(False)
                    continue
                v = (decimal.Decimal(int(t)).scaleb(-self.sum_type.scale)
                     / decimal.Decimal(int(c))).quantize(q, rounding=decimal.ROUND_HALF_UP)
                out.append(int(v.scaleb(rt.scale)))
                ok.append(True)
        return decimal_column(rt, out, np.array(ok, dtype=bool), capacity, device)

    def final_column(self, state, num_slots, capacity):
        if self.limbs:
            p = _pull(state, num_slots)
            totals = _limb_totals(p[0], p[1]) if self.limbs == "2" else \
                wide_ints(p[0], p[1], p[2])
            return self._decimal_divide(totals, p[-1], capacity, state[0].device)
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
    def __init__(self, agg, arg_type, result_type, which: str, limbs=None):
        super().__init__(agg, arg_type, result_type)
        self.kind = which
        fn = E.AggFunction.MIN if which == "min" else E.AggFunction.MAX
        self.limbs = _limb_mode(fn, arg_type, result_type, limbs)
        if not (self.limbs or _int_valued(arg_type) or is_float(arg_type)):
            _not_ported(f"{which.upper()} of {arg_type!r} (bool and string "
                        "extremes)", "Queue 1 item 6b")

    def state_fields(self):
        if self.limbs:
            return [(wide_val_tag(self.result_type), T.I64), ("val_l1", T.I64),
                    ("val_l2", T.I64), ("has", T.BOOL)]
        return [("val", self.result_type), ("has", T.BOOL)]

    def _sentinel(self, dtype: torch.dtype):
        """The reference's ``_sentinel_np`` in the table's dtype."""
        if dtype.is_floating_point:
            return float("inf") if self.kind == "min" else float("-inf")
        info = torch.iinfo(_state_dtype(self.result_type))
        return info.max if self.kind == "min" else info.min

    def init_state(self, capacity, device):
        if self.limbs:  # s0, s1, s2, has: zeros, as the reference's
            return [torch.zeros(capacity, dtype=torch.int64, device=device)
                    for _ in range(3)] + [torch.zeros(capacity, dtype=torch.bool, device=device)]
        wide = torch.float64 if is_float(self.result_type) else torch.int64
        return [torch.full((capacity,), self._sentinel(wide), dtype=wide, device=device),
                torch.zeros(capacity, dtype=torch.bool, device=device)]

    def grow(self, state, capacity):
        if self.limbs:
            return super().grow(state, capacity)
        val, has = state
        return [_grow(val, capacity, self._sentinel(val.dtype)), _grow(has, capacity)]

    def _ops(self, state, data, gate):
        if self.limbs:
            s0, s1, s2, has = state
            l0, l1, l2 = (d.contiguous() for d in data)
            kind = K.UPD_LEXMIN if self.kind == "min" else K.UPD_LEXMAX
            return [K.SlotUpdate(kind, s2, l2, gate, valid_table=has, srcs=[l1, l0],
                                 tables=[s1, s0])]
        val, has = state
        kind = K.UPD_MIN if self.kind == "min" else K.UPD_MAX
        return [K.SlotUpdate(kind, val, data.to(val.dtype).contiguous(), gate),
                K.SlotUpdate(K.UPD_FLAG, has, valids=gate)]

    def update_ops(self, state, value, validity, order=None):
        return self._ops(state, value, [validity])

    def merge_ops(self, state, partial_cols):
        *pvals, phas = partial_cols
        data = [c.data for c in pvals] if self.limbs else pvals[0].data
        return self._ops(state, data, [phas.data, phas.validity])

    def state_columns(self, state, num_slots, capacity):
        if self.limbs:
            return _limb_state_columns(state, capacity)
        val, has = state
        val = _narrow(val, _state_dtype(self.result_type))
        val = torch.where(has, val, torch.zeros_like(val))
        return [DeviceColumn(self.result_type, val, has),
                DeviceColumn(T.BOOL, has, _ones(capacity, has))]

    def final_column(self, state, num_slots, capacity):
        if self.limbs:
            p = _pull(state, num_slots)
            return decimal_column(self.result_type, wide_ints(p[0], p[1], p[2]), p[3] != 0,
                                  capacity, state[0].device)
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
            _not_ported(f"FIRST of {result_type!r} (a host-resident value in the JAX "
                        "package)", "Queue 1 item 6b")

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


class BloomFilterAgg(AggFunction):
    """bloom_filter over int64 values (blaze_tpu/ops/aggfns.py:1024, with
    Spark's defaults of 1,000,000 expected items and 8,388,608 bits): a
    host aggregate. An empty input gives the empty filter, as the
    reference does (Spark gives null)."""

    kind = "bloom_filter"
    host = True

    def __init__(self, agg, arg_type, result_type):
        from blaze_tpu_torch.ops.bloom import DEFAULT_EXPECTED_ITEMS, DEFAULT_NUM_BITS

        super().__init__(agg, arg_type, T.BINARY)
        self.expected_items = DEFAULT_EXPECTED_ITEMS
        self.num_bits = DEFAULT_NUM_BITS

    def state_fields(self):
        return [("bloom", T.BINARY)]

    def init_state(self, capacity, device):
        from blaze_tpu_torch.ops.bloom import SparkBloomFilter

        return [SparkBloomFilter.create(self.expected_items, self.num_bits)]

    def grow(self, state, capacity):
        return state

    def update_host(self, state, value: torch.Tensor, keep: torch.Tensor, n: int) -> None:
        """Put the first ``n`` rows' values where ``keep`` (valid and live):
        one pull of the value plane and the mask."""
        pulled = torch.stack([value[:n].to(torch.int64), keep[:n].to(torch.int64)]).cpu()
        vals, m = pulled.numpy()
        state[0].put_longs(vals[m != 0])

    def final_column(self, state, num_slots, capacity):
        return BytesColumn.from_values(T.BINARY, [state[0].serialize()] * num_slots,
                                       capacity)


def create_agg_function(agg: E.AggExpr, input_schema: T.Schema,
                        limbs=None) -> AggFunction:
    """``limbs``: the limb layout read from a partial state's field names
    (merge mode: ir/aggstate.py ``parse_state_mode``); None derives it."""
    arg_t = E.infer_type(agg.args[0], input_schema) if agg.args else T.NULL
    result_t = agg.return_type or E.agg_result_type(agg.fn, arg_t)
    F = E.AggFunction
    if agg.fn == F.SUM:
        return SumAgg(agg, arg_t, result_t, limbs)
    if agg.fn == F.COUNT:
        return CountAgg(agg, arg_t, T.I64)
    if agg.fn == F.AVG:
        return AvgAgg(agg, arg_t, result_t, limbs)
    if agg.fn == F.MIN:
        return MinMaxAgg(agg, arg_t, result_t, "min", limbs)
    if agg.fn == F.MAX:
        return MinMaxAgg(agg, arg_t, result_t, "max", limbs)
    if agg.fn == F.FIRST:
        return FirstAgg(agg, arg_t, result_t, ignores_null=False)
    if agg.fn == F.FIRST_IGNORES_NULL:
        return FirstAgg(agg, arg_t, result_t, ignores_null=True)
    if agg.fn == F.BLOOM_FILTER:
        return BloomFilterAgg(agg, arg_t, result_t)
    _not_ported(f"aggregate function {agg.fn.value} (host-object states: "
                "collect, combine-unique, UDAF)", "Queue 1 item 3")
