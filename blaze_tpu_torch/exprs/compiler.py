"""Expression evaluator: IR expressions -> device values over a batch.

The PyTorch counterpart of the device path of blaze_tpu/exprs/compiler.py
(``ExprEvaluator._binary_dev``, ``_decimal_arith``): every value is a
``DevVal`` of torch tensors on the batch's device, a literal a 0-d tensor
that broadcasts. Null semantics are Spark's: validity propagates through
arithmetic, comparisons use two-valued logic with null poisoning, AND/OR
use Kleene logic, division/modulo by zero yield NULL (non-ANSI).

Ported: Column, BoundReference, Literal (decimal literals rescaled to
their type), comparison/arithmetic/bitwise/logical BinaryExpr, IsNull,
IsNotNull, Not. Anything else raises NotImplementedError naming the
ROADMAP item that ports it; there is no host fallback.
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, List, Optional

import torch

from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T


@dataclasses.dataclass
class DevVal:
    """Device value: data + validity (capacity-long, or 0-d for a
    literal), plus its logical type."""

    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor


class ExprError(Exception):
    pass


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.Float32Type, T.Float64Type))


_COMPARE = {
    E.BinaryOp.EQ: torch.eq, E.BinaryOp.NEQ: torch.ne, E.BinaryOp.LT: torch.lt,
    E.BinaryOp.LTEQ: torch.le, E.BinaryOp.GT: torch.gt, E.BinaryOp.GTEQ: torch.ge,
}


class ExprEvaluator:
    """Evaluates a fixed list of expressions against batches of one schema."""

    def __init__(self, exprs: List[E.Expr], input_schema: T.Schema):
        self.exprs = exprs
        self.input_schema = input_schema

    # -- public API -----------------------------------------------------------

    def evaluate(self, batch: ColumnarBatch) -> List[DeviceColumn]:
        return [self._to_column(self.eval(e, batch), batch) for e in self.exprs]

    def evaluate_predicate(self, batch: ColumnarBatch) -> torch.Tensor:
        """Conjunction of all exprs as a device keep-mask (null -> drop)."""
        mask = None
        for expr in self.exprs:
            dv = self.eval(expr, batch)
            keep = dv.data.to(torch.bool) & dv.validity
            mask = keep if mask is None else (mask & keep)
        return mask & batch.row_exists_mask()

    def eval(self, expr: E.Expr, batch: ColumnarBatch) -> DevVal:
        method = getattr(self, "_eval_" + type(expr).__name__, None)
        if method is None:
            raise NotImplementedError(
                f"expression {type(expr).__name__} is not ported to the "
                "PyTorch package yet (ROADMAP.md Queue 1 item 4)")
        return method(expr, batch)

    # -- value conversions ----------------------------------------------------

    @staticmethod
    def _to_column(val: DevVal, batch: ColumnarBatch) -> DeviceColumn:
        data, validity = broadcast(val, batch)
        return DeviceColumn(val.dtype, data, validity & batch.row_exists_mask())

    # -- leaves ---------------------------------------------------------------

    def _eval_Column(self, expr: E.Column, batch: ColumnarBatch) -> DevVal:
        return self._eval_BoundReference(
            E.BoundReference(batch.schema.index_of(expr.name)), batch)

    def _eval_BoundReference(self, expr: E.BoundReference,
                             batch: ColumnarBatch) -> DevVal:
        col = batch.columns[expr.index]
        return DevVal(batch.schema[expr.index].dtype, col.data, col.validity)

    def _eval_Literal(self, expr: E.Literal, batch: ColumnarBatch) -> DevVal:
        return make_literal(expr.value, expr.dtype, batch.device)

    def _eval_SortOrder(self, expr: E.SortOrder, batch) -> DevVal:
        return self.eval(expr.child, batch)

    # -- binary ---------------------------------------------------------------

    def _eval_BinaryExpr(self, expr: E.BinaryExpr, batch: ColumnarBatch) -> DevVal:
        return self._binary(expr.op, expr, self.eval(expr.left, batch),
                            self.eval(expr.right, batch))

    def _binary(self, op: E.BinaryOp, expr: E.BinaryExpr, l: DevVal,
                r: DevVal) -> DevVal:
        B = E.BinaryOp
        if op in (B.AND, B.OR):
            lv, ld = l.validity, l.data.to(torch.bool)
            rv, rd = r.validity, r.data.to(torch.bool)
            if op == B.AND:
                dfalse = (lv & ~ld) | (rv & ~rd)
                dtrue = lv & ld & rv & rd
            else:
                dtrue = (lv & ld) | (rv & rd)
                dfalse = lv & ~ld & rv & ~rd
            return DevVal(T.BOOL, dtrue, dtrue | dfalse)

        ldt, rdt = l.dtype, r.dtype
        if op in _COMPARE:
            ld, rd = self._numeric_align(l, r)
            return DevVal(T.BOOL, _COMPARE[op](ld, rd), l.validity & r.validity)

        res_t = expr.result_type or E.infer_type(
            E.BinaryExpr(op, E.Literal(None, ldt), E.Literal(None, rdt)),
            T.Schema(()))
        validity = l.validity & r.validity
        if isinstance(res_t, T.DecimalType):
            if not res_t.fits_int64:
                raise NotImplementedError(
                    f"decimal arithmetic into {res_t!r} (wider than 18 digits) "
                    "is not ported yet (ROADMAP.md Queue 1 item 4)")
            if _is_float(ldt) or _is_float(rdt):
                out = _float_op(op, self._decimal_to_f64(l), self._decimal_to_f64(r))
                scaled = out * float(10 ** res_t.scale)
                rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                      torch.ceil(scaled - 0.5))
                ok = torch.isfinite(scaled) & (torch.abs(rounded) < float(2 ** 62))
                data = torch.where(ok, rounded, 0.0).to(torch.int64)
                data, validity = dec.check_overflow(data, validity & ok,
                                                    res_t.precision)
                return DevVal(res_t, data, validity)
            return self._decimal_arith(op, self._coerce_decimal(l),
                                       self._coerce_decimal(r), res_t)
        ld, rd = self._numeric_align(l, r, res_t)
        if op == B.ADD:
            out = ld + rd
        elif op == B.SUB:
            out = ld - rd
        elif op == B.MUL:
            out = ld * rd
        elif op in (B.DIV, B.MOD):
            zero = rd == 0
            validity = validity & ~zero
            den = torch.where(zero, torch.ones_like(rd), rd)
            if ld.is_floating_point():
                out = ld / den if op == B.DIV else ld - torch.trunc(ld / den) * den
            else:
                q = _java_int_div(ld, den)
                out = q if op == B.DIV else ld - q * den
        elif op == B.BIT_AND:
            out = ld & rd
        elif op == B.BIT_OR:
            out = ld | rd
        elif op == B.BIT_XOR:
            out = ld ^ rd
        elif op in (B.SHIFT_LEFT, B.SHIFT_RIGHT):
            sh = torch.remainder(rd, ld.element_size() * 8)
            out = ld << sh if op == B.SHIFT_LEFT else ld >> sh
        else:
            raise ExprError(f"unsupported device binary op {op}")
        return DevVal(res_t, out, validity)

    def _decimal_arith(self, op: E.BinaryOp, l: DevVal, r: DevVal,
                       res_t: T.DecimalType) -> DevVal:
        B = E.BinaryOp
        ls, rs = l.dtype.scale, r.dtype.scale
        if op in (B.ADD, B.SUB, B.MOD):
            s = max(ls, rs)
            ld, lv = dec.rescale(l.data, l.validity, ls, s, 19)
            rd, rv = dec.rescale(r.data, r.validity, rs, s, 19)
            if op == B.MOD:
                zero = rd == 0
                den = torch.where(zero, torch.ones_like(rd), rd)
                out = ld - _java_int_div(ld, den) * den
                validity = lv & rv & ~zero
            else:
                fn = dec.add if op == B.ADD else dec.sub
                out, validity = fn(ld, lv, rd, rv)
            out, validity = dec.rescale(out, validity, s, res_t.scale,
                                        res_t.precision)
        elif op == B.MUL:
            rescale_down = ls + rs - res_t.scale
            out, validity = dec.mul(l.data, l.validity, r.data, r.validity,
                                    rescale_down=max(rescale_down, 0))
            out, validity = dec.check_overflow(out, validity, res_t.precision)
        elif op == B.DIV:
            out, validity = dec.div(l.data, l.validity, r.data, r.validity,
                                    res_t.scale - ls + rs)
            out, validity = dec.check_overflow(out, validity, res_t.precision)
        else:
            raise ExprError(f"unsupported decimal op {op}")
        return DevVal(res_t, out, validity)

    @staticmethod
    def _coerce_decimal(v: DevVal) -> DevVal:
        """Treat an integer operand as decimal(18, 0) for decimal arithmetic."""
        if isinstance(v.dtype, T.DecimalType):
            return v
        return DevVal(T.DecimalType(18, 0), v.data.to(torch.int64), v.validity)

    def _numeric_align(self, l: DevVal, r: DevVal,
                       res_t: Optional[T.DataType] = None):
        """Promote both sides to one dtype (decimals: align scales;
        decimal against int/float: compare as float64)."""
        if isinstance(l.dtype, T.DecimalType) and isinstance(r.dtype, T.DecimalType):
            s = max(l.dtype.scale, r.dtype.scale)
            ld, _ = dec.rescale(l.data, l.validity, l.dtype.scale, s, 19)
            rd, _ = dec.rescale(r.data, r.validity, r.dtype.scale, s, 19)
            return ld, rd
        if isinstance(l.dtype, T.DecimalType) or isinstance(r.dtype, T.DecimalType):
            return self._decimal_to_f64(l), self._decimal_to_f64(r)
        tdt = T.torch_dtype(res_t) if res_t is not None else None
        if tdt is None:
            tdt = torch.promote_types(l.data.dtype, r.data.dtype)
        return l.data.to(tdt), r.data.to(tdt)

    @staticmethod
    def _decimal_to_f64(v: DevVal) -> torch.Tensor:
        if isinstance(v.dtype, T.DecimalType):
            return v.data.to(torch.float64) / float(10 ** v.dtype.scale)
        return v.data.to(torch.float64)

    # -- unary ----------------------------------------------------------------

    def _eval_IsNull(self, expr: E.IsNull, batch) -> DevVal:
        validity = broadcast(self.eval(expr.child, batch), batch)[1]
        return DevVal(T.BOOL, ~validity, _ones(batch))

    def _eval_IsNotNull(self, expr: E.IsNotNull, batch) -> DevVal:
        validity = broadcast(self.eval(expr.child, batch), batch)[1]
        return DevVal(T.BOOL, validity, _ones(batch))

    def _eval_Not(self, expr: E.Not, batch) -> DevVal:
        v = self.eval(expr.child, batch)
        return DevVal(T.BOOL, ~v.data.to(torch.bool), v.validity)


def _ones(batch: ColumnarBatch) -> torch.Tensor:
    return torch.ones(batch.capacity, dtype=torch.bool, device=batch.device)


def broadcast(v: DevVal, batch: ColumnarBatch):
    """(data, validity) of a value, 0-d literals expanded to the batch."""
    data, validity = v.data, v.validity
    if data.ndim == 0:
        data = data.expand(batch.capacity).contiguous()
    if validity.ndim == 0:
        validity = validity.expand(batch.capacity).contiguous()
    return data, validity


def _float_op(op: E.BinaryOp, ld, rd):
    B = E.BinaryOp
    if op == B.ADD:
        return ld + rd
    if op == B.SUB:
        return ld - rd
    if op == B.MUL:
        return ld * rd
    zero = rd == 0
    den = torch.where(zero, 1.0, rd)
    if op == B.DIV:
        return torch.where(zero, float("nan"), ld / den)
    if op == B.MOD:
        return torch.where(zero, float("nan"), ld - torch.trunc(ld / den) * rd)
    raise ExprError(f"unsupported float/decimal op {op}")


def _java_int_div(a, b):
    """Java-style truncating integer division."""
    q = dec.floordiv(a, b)
    r = a - q * b
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return torch.where(adjust, q + 1, q)


def make_literal(value: Any, dtype: T.DataType, device: torch.device) -> DevVal:
    """A 0-d DevVal for a python literal (decimals given as their value,
    e.g. "500.00", stored unscaled)."""
    tdt = T.torch_dtype(dtype)
    if tdt is None:
        raise NotImplementedError(
            f"literal of type {dtype!r} has no device plane in the PyTorch "
            "port yet (ROADMAP.md Queue 1 item 4)")
    if value is None:
        return DevVal(dtype, torch.zeros((), dtype=tdt, device=device),
                      torch.zeros((), dtype=torch.bool, device=device))
    v = value
    if isinstance(dtype, T.DecimalType):
        v = int(Decimal(str(value)).scaleb(dtype.scale).to_integral_value())
    elif isinstance(dtype, (T.DateType, T.TimestampType)) and \
            not isinstance(value, int):
        raise NotImplementedError(
            "date/timestamp literals from non-integer values are not ported "
            "yet (ROADMAP.md Queue 1 item 4)")
    return DevVal(dtype, torch.tensor(v, dtype=tdt, device=device),
                  torch.ones((), dtype=torch.bool, device=device))
