"""Expression evaluator: IR expressions -> device values over a batch.

The PyTorch counterpart of the device path of blaze_tpu/exprs/compiler.py
(``ExprEvaluator._binary_dev``, ``_decimal_arith``): every value is a
``DevVal`` of torch tensors on the batch's device, a literal a 0-d tensor
that broadcasts. Null semantics are Spark's: validity propagates through
arithmetic, comparisons use two-valued logic with null poisoning, AND/OR
use Kleene logic, division/modulo by zero yield NULL (non-ANSI).

Ported: Column, BoundReference, Literal (decimal literals rescaled to
their type), comparison/arithmetic/bitwise/logical BinaryExpr, IsNull,
IsNotNull, Not, InList, Case (the device branch of the JAX package's
``_eval_Case``), Cast and TryCast (``exprs/cast.py cast_dev``) and
ScalarFunction (the device functions of ``exprs/functions.py``, XXH64
through K15), ScalarSubquery (a device-typed value, as a literal) and
BloomFilterMightContain (the runtime filter's probe: the filter is a
BINARY literal or scalar subquery read on the host, deserialized and
uploaded once per evaluator; the probe is K16, ``ops/bloom.py``). A bare
reference to a decimal(19..38) column evaluates to its three limb planes
(a ``DevVal`` whose data is the ``(l0, l1, l2)`` tuple), which only
aggregates and the plane movers read; any other expression over such a
column raises (ROADMAP.md Queue 1 item 18). Strings, binary columns,
nested values, UDFs and casts from or to them raise NotImplementedError
naming item 6b; there is no host fallback.

Whole-stage fusion reads this module too: ``fusable_expr`` is the JAX
package's whitelist of expressions a fused chain may hold,
``fused_chain_schemas`` and ``fused_group_flags`` describe a chain, and
``LiveBatch`` is the batch a fused chain's expressions see (its rows are
a live mask, not a count). K11 (``exprs/fused_triton.py``) generates the
same semantics as device code.
"""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import Any, Dict, List, Optional, Tuple

import torch

from blaze_tpu_torch.core.batch import (BytesColumn, ColumnarBatch, DeviceColumn, WideColumn,
                                        host_column_error)
from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.exprs.cast import cast_dev, decimal_to_f64, host_cast_error
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T


@dataclasses.dataclass
class DevVal:
    """Device value: data + validity (capacity-long, or 0-d for a
    literal), plus its logical type. A wide decimal's data is its
    ``(l0, l1, l2)`` plane tuple."""

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
        for e in exprs:  # a bare wide column is its planes; nothing else reads one
            if _hashes_wide(e, input_schema):
                raise NotImplementedError(
                    "a row hash of a decimal wider than 18 digits (hashed as its "
                    "BigInteger bytes on the host in the JAX package) is not ported to "
                    "the PyTorch package yet (ROADMAP.md Queue 1 item 6b)")
            if not isinstance(e, (E.Column, E.BoundReference)) and \
                    touches_wide(e, input_schema):
                raise NotImplementedError(
                    f"expression {type(e).__name__} over a decimal wider than 18 digits "
                    "is not ported to the PyTorch package yet (ROADMAP.md Queue 1 item 18)")
        # each bloom probe's filter, deserialized and on the device once:
        # id(expr) -> (expr, filter)
        self._blooms: Dict[int, Tuple[E.Expr, Any]] = {}

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
            raise not_ported(expr)
        return method(expr, batch)

    # -- value conversions ----------------------------------------------------

    @staticmethod
    def _to_column(val: DevVal, batch: ColumnarBatch):
        exists = batch.row_exists_mask()
        if isinstance(val.data, tuple):
            return WideColumn(val.dtype, *val.data, val.validity & exists)
        data, validity = broadcast(val, batch)
        return DeviceColumn(val.dtype, data, validity & exists)

    # -- leaves ---------------------------------------------------------------

    def _eval_Column(self, expr: E.Column, batch: ColumnarBatch) -> DevVal:
        return self._eval_BoundReference(
            E.BoundReference(batch.schema.index_of(expr.name)), batch)

    def _eval_BoundReference(self, expr: E.BoundReference,
                             batch: ColumnarBatch) -> DevVal:
        col = batch.columns[expr.index]
        if isinstance(col, BytesColumn):
            raise host_column_error("an expression")
        if isinstance(col, WideColumn):
            return DevVal(col.dtype, tuple(col.planes()), col.validity)
        return DevVal(batch.schema[expr.index].dtype, col.data, col.validity)

    def _eval_Literal(self, expr: E.Literal, batch: ColumnarBatch) -> DevVal:
        return make_literal(expr.value, expr.dtype, batch.device)

    def _eval_ScalarSubquery(self, expr: E.ScalarSubquery, batch) -> DevVal:
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
                    "is not ported yet (ROADMAP.md Queue 1 item 18)")
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
        """A value as float64; a decimal's is unscaled / 10^scale, divided as
        IEEE divides (``cast.decimal_to_f64``: a device-tensor divisor)."""
        if isinstance(v.dtype, T.DecimalType):
            return decimal_to_f64(v.data, v.dtype.scale)
        return v.data.to(torch.float64)

    @staticmethod
    def _host_scalar(v: DevVal):
        """A literal argument's Python value (None when null): one host read
        of a 0-d tensor, as the JAX package's ``_host_scalar``."""
        if v.data.dim() != 0:
            raise ExprError("expected a literal argument")
        return v.data.item() if bool(v.validity) else None

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

    def _eval_InList(self, expr: E.InList, batch) -> DevVal:
        """``child [NOT] IN (values)``, the device half of the JAX
        package's ``_eval_InList``: each value compares as ``_numeric_align``
        aligns it; a null literal among the values turns every miss null
        (found without a host sync); ``negated`` flips the data only."""
        v = self.eval(expr.child, batch)
        eq_any = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
        has_null_item = torch.zeros((), dtype=torch.bool, device=batch.device)
        for item in expr.values:
            x = self.eval(item, batch)
            if x.data.dim() == 0:
                has_null_item = has_null_item | ~x.validity
            xd, xv = broadcast(x, batch)
            ld, rd = self._numeric_align(v, DevVal(x.dtype, xd, xv))
            eq_any = eq_any | (torch.eq(ld, rd) & xv)
        validity = v.validity & (eq_any | ~has_null_item)
        return DevVal(T.BOOL, ~eq_any if expr.negated else eq_any, validity)

    # -- CASE, casts and functions ---------------------------------------------

    def _eval_Case(self, expr: E.Case, batch) -> DevVal:
        """The device branch of the JAX package's ``_eval_Case``: the first
        definitely-true condition picks its branch (a null or false one
        falls through); the result type is the first branch's, and later
        branches and ELSE are converted to its plane type as they are (no
        decimal rescale); without ELSE the rows no branch took are NULL."""
        taken = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
        out_data = out_valid = res_dtype = None
        conds = [self.eval(c, batch) for c, _ in expr.branches]
        vals = [self.eval(v, batch) for _, v in expr.branches]
        else_v = self.eval(expr.else_expr, batch) if expr.else_expr is not None else None
        for cv, vv in zip(conds, vals):
            cmask = cv.data.to(torch.bool) & cv.validity & ~taken
            vdata, vvalid = broadcast(vv, batch)
            if out_data is None:
                res_dtype = vv.dtype
                out_data = torch.where(cmask, vdata, torch.zeros((), dtype=vdata.dtype,
                                                                 device=vdata.device))
                out_valid = cmask & vvalid
            else:
                out_data = torch.where(cmask, vdata.to(out_data.dtype), out_data)
                out_valid = torch.where(cmask, vvalid, out_valid)
            taken = taken | cmask
        if else_v is not None:
            edata, evalid = broadcast(else_v, batch)
            out_data = torch.where(taken, out_data, edata.to(out_data.dtype))
            out_valid = torch.where(taken, out_valid, evalid)
        else:
            out_valid = out_valid & taken
        return DevVal(res_dtype, out_data, out_valid)

    def _eval_Cast(self, expr: E.Cast, batch) -> DevVal:
        return self._cast(self.eval(expr.child, batch), expr.dtype)

    def _eval_TryCast(self, expr: E.TryCast, batch) -> DevVal:
        # on the device a failed conversion is NULL in both (non-ANSI)
        return self._cast(self.eval(expr.child, batch), expr.dtype)

    @staticmethod
    def _cast(v: DevVal, to: T.DataType) -> DevVal:
        if v.dtype == to:
            return v
        if _is_device_type(to) and _is_device_type(v.dtype):
            data, validity = cast_dev(v.data, v.validity, v.dtype, to)
            return DevVal(to, data, validity)
        raise host_cast_error(v.dtype, to)

    def _eval_ScalarFunction(self, expr: E.ScalarFunction, batch) -> DevVal:
        from blaze_tpu_torch.exprs.functions import dispatch_function

        args = [self.eval(a, batch) for a in expr.args]
        return dispatch_function(expr.name, args, self, batch)

    # -- the runtime filter's probe ----------------------------------------------

    def _eval_BloomFilterMightContain(self, expr: E.BloomFilterMightContain,
                                      batch) -> DevVal:
        """``might_contain(filter, value)`` (blaze_tpu/exprs/compiler.py:823):
        a null filter gives a null BOOL; otherwise the value as int64 is
        probed (K16 on the card) and keeps its validity. The reference
        deserializes the filter on every batch; here it is deserialized and
        uploaded once per evaluator, which changes no answer."""
        from blaze_tpu_torch.ops.bloom import SparkBloomFilter

        arg = expr.bloom_filter
        if not isinstance(arg, (E.Literal, E.ScalarSubquery)) or \
                not isinstance(arg.dtype, T.BinaryType):
            raise NotImplementedError(
                f"a bloom filter given as {type(arg).__name__} (a BINARY column read on "
                "the host in the JAX package) is not ported to the PyTorch package yet; "
                "a BINARY Literal or ScalarSubquery is (ROADMAP.md Queue 1 item 6b)")
        if arg.value is None:
            return make_literal(None, T.BOOL, batch.device)
        cached = self._blooms.get(id(expr))
        if cached is None or cached[0] is not expr:
            cached = (expr, SparkBloomFilter.deserialize(bytes(arg.value)))
            self._blooms[id(expr)] = cached
        data, validity = broadcast(self.eval(expr.value, batch), batch)
        hit = cached[1].might_contain_long(data.to(torch.int64).contiguous())
        return DevVal(T.BOOL, hit, validity)


def _hashes_wide(expr: E.Expr, schema: T.Schema) -> bool:
    """Does the expression hash a decimal(19..38) column (an argument of
    xxhash64 or murmur3_hash)?"""
    if isinstance(expr, E.ScalarFunction) and \
            expr.name.lower() in ("xxhash64", "murmur3_hash") and \
            any(touches_wide(a, schema) for a in expr.args):
        return True
    return any(_hashes_wide(c, schema) for c in expr.children())


def not_ported(expr: E.Expr) -> NotImplementedError:
    return NotImplementedError(
        f"expression {type(expr).__name__} is not ported to the PyTorch package "
        "yet (ROADMAP.md Queue 1 item 6b)")


def _ones(batch: ColumnarBatch) -> torch.Tensor:
    return torch.ones(batch.capacity, dtype=torch.bool, device=batch.device)


def broadcast(v: DevVal, batch: ColumnarBatch):
    """(data, validity) of a value, 0-d literals expanded to the batch (a
    wide value's plane tuple is never a literal)."""
    data, validity = v.data, v.validity
    if isinstance(data, tuple):
        return data, validity
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
        item = "18" if T.is_wide_decimal(dtype) else "6b"
        raise NotImplementedError(
            f"literal of type {dtype!r} has no device plane in the PyTorch "
            f"port yet (ROADMAP.md Queue 1 item {item})")
    if value is None:
        return DevVal(dtype, torch.zeros((), dtype=tdt, device=device),
                      torch.zeros((), dtype=torch.bool, device=device))
    v = value
    if isinstance(dtype, T.DecimalType):
        v = int(Decimal(str(value)).scaleb(dtype.scale).to_integral_value())
    elif isinstance(dtype, (T.DateType, T.TimestampType)) and \
            not isinstance(value, int):
        raise NotImplementedError(
            "date/timestamp literals from non-integer values (parsed on the host) "
            "are not ported yet (ROADMAP.md Queue 1 item 6b)")
    return DevVal(dtype, torch.tensor(v, dtype=tdt, device=device),
                  torch.ones((), dtype=torch.bool, device=device))


# -- whole-stage fusion ------------------------------------------------------------


class LiveBatch:
    """One batch's planes as a fused chain's expressions see them: the rows
    that exist are a live mask (narrowed by the chain's filters), not a
    count, so ``num_rows`` is undefined (blaze_tpu/exprs/compiler.py
    TraceBatch)."""

    def __init__(self, schema: T.Schema, columns: List[DeviceColumn],
                 live: torch.Tensor):
        self.schema = schema
        self.columns = columns
        self.live = live

    @property
    def capacity(self) -> int:
        return int(self.live.shape[0])

    @property
    def device(self) -> torch.device:
        return self.live.device

    def row_exists_mask(self) -> torch.Tensor:
        return self.live

    @property
    def num_rows(self):
        raise ExprError("num_rows is not defined inside a fused chain")


def _is_device_type(dt: T.DataType) -> bool:
    return T.torch_dtype(dt) is not None


def touches_wide(expr: E.Expr, schema: T.Schema) -> bool:
    """Does the expression read a decimal(19..38) column of ``schema``, by
    name or by index (blaze_tpu/ops/agg_device.py ``_touches_wide``)?"""
    if isinstance(expr, E.Column):
        try:
            return T.is_wide_decimal(schema[schema.index_of(expr.name)].dtype)
        except (KeyError, ValueError):
            return False
    if isinstance(expr, E.BoundReference):
        return 0 <= expr.index < len(schema) and \
            T.is_wide_decimal(schema[expr.index].dtype)
    return any(touches_wide(c, schema) for c in expr.children())


def require_narrow_key(dt: T.DataType, what: str) -> None:
    """A group, join, sort or partition key must have one device plane;
    the reference keeps a wide-decimal key on host columns."""
    if T.is_wide_decimal(dt):
        raise NotImplementedError(
            f"a {what} of type {dt!r} (a decimal wider than 18 digits, a host "
            "column in the JAX package) is not ported to the PyTorch package yet "
            "(ROADMAP.md Queue 1 item 6b)")


def fusable_expr(expr: E.Expr, schema: T.Schema) -> bool:
    """The JAX package's whitelist of expressions a fused chain may hold
    (blaze_tpu/exprs/compiler.py:967): pure device expressions whose
    result lives on the device, reading no wide-decimal column (a fused
    chain traces no limb plane). A ScalarFunction is never fused."""
    try:
        return not touches_wide(expr, schema) and _fusable(expr, schema) and \
            _is_device_type(E.infer_type(expr, schema))
    except Exception:
        return False


def _fusable(expr: E.Expr, schema: T.Schema) -> bool:
    if isinstance(expr, E.BoundReference):
        return _is_device_type(schema[expr.index].dtype)
    if isinstance(expr, E.Column):
        return _is_device_type(schema[schema.index_of(expr.name)].dtype)
    if isinstance(expr, (E.Literal, E.ScalarSubquery)):
        return _is_device_type(expr.dtype)
    if isinstance(expr, E.BinaryExpr):
        return _fusable(expr.left, schema) and _fusable(expr.right, schema)
    if isinstance(expr, (E.Not, E.IsNull, E.IsNotNull)):
        return _fusable(expr.child, schema)
    if isinstance(expr, E.Case):
        parts = [p for branch in expr.branches for p in branch]
        if expr.else_expr is not None:
            parts.append(expr.else_expr)
        return all(_fusable(p, schema) for p in parts)
    if isinstance(expr, E.InList):
        return _fusable(expr.child, schema) and \
            all(_fusable(v, schema) for v in expr.values)
    if isinstance(expr, (E.Cast, E.TryCast)):
        return _fusable(expr.child, schema) and _is_device_type(expr.dtype) \
            and _is_device_type(E.infer_type(expr.child, schema))
    if isinstance(expr, E.SortOrder):
        return _fusable(expr.child, schema)
    return False


def fused_chain_schemas(input_schema: T.Schema, steps) -> List[T.Schema]:
    """The schema each step of a fused chain sees (index i: steps[i]'s
    input; the last entry: the chain's output). Expand declares one schema
    for all its projections."""
    schemas = [input_schema]
    s = input_schema
    for st in steps:
        kind = st[0]
        if kind == "project":
            s = T.Schema(tuple(T.StructField(n, E.infer_type(e, s))
                               for n, e in zip(st[2], st[1])))
        elif kind == "rename":
            s = s.rename(list(st[1]))
        elif kind == "expand":
            s = st[2]
        schemas.append(s)
    return schemas


def fused_group_flags(steps) -> List[bool]:
    """Per output group: was it filtered? An unfiltered group keeps the
    batch's row count and needs no compaction and no count sync."""
    flags = [False]
    for st in steps:
        if st[0] == "filter":
            flags = [True] * len(flags)
        elif st[0] == "expand":
            flags = [f for f in flags for _ in range(len(st[1]))]
    return flags
