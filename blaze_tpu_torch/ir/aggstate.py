"""Partial-aggregate state-field layout — pure IR-level helper.

Single source of truth for the typed columnar state each aggregate carries in
partial output (see ops/aggfns.py). Used by both the plan IR
(``nodes.Agg.output_schema``) and the operator layer, keeping IR free of
operator imports.
"""

from __future__ import annotations

from typing import List, Tuple

from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T


def avg_sum_type(arg_t: T.DataType) -> T.DataType:
    if isinstance(arg_t, T.DecimalType):
        return T.DecimalType(min(arg_t.precision + 10, 38), arg_t.scale)
    return T.F64


def limb_layout(result_t: T.DataType) -> bool:
    """Result types representable as two int64 limbs (see limb_state)."""
    return (isinstance(result_t, T.DecimalType) and not result_t.fits_int64
            and result_t.precision <= 28)


def limb_state(arg_t: T.DataType, result_t: T.DataType) -> bool:
    """Should a SUM carry its state as two int64 limbs on device?

    A sum into decimal(19..28) overflows one int64 but its total is < 2^95,
    so it splits exactly into ``lo`` (32 low bits, kept in [0, 2^32)) and
    ``hi`` (the remaining signed high part): both limbs and every partial
    limb-sum fit int64, segment-summing on TPU without 128-bit arithmetic.

    THE single eligibility predicate — wire schema (agg_state_fields) and
    operator state (SumAgg) both call it. Requires: a decimal arg that fits
    int64 (a wider arg is host-resident; its sum keeps the exact host
    object path) and matching scales (Spark's SUM keeps the arg scale; a
    mismatched hand-built plan rescales exactly on host instead).

    The decision is made ONCE, on the raw-input side; merge/final-mode
    consumers must NOT re-derive it — they read it from the wire schema
    (parse_limb_tag on the first state field's name)."""
    return (limb_layout(result_t)
            and isinstance(arg_t, T.DecimalType) and arg_t.fits_int64
            and arg_t.scale == result_t.scale)


def limb3_state(arg_t: T.DataType, result_t: T.DataType) -> bool:
    """Should a SUM over a WIDE decimal arg carry three int64 limbs on
    device? A decimal(19..38) arg does not fit int64 planes, but its
    unscaled value splits exactly into two 32-bit limbs plus a signed
    high limb (l0, l1 in [0, 2^32); l2 = value >> 64): segment-sums of
    l0/l1 stay under int64 for any real batch, and l2 accumulates mod
    2^64 — exact for totals within decimal(38) (the same wrapping-i128
    semantics the reference's sums have). Scales must match (Spark's SUM
    keeps the arg scale)."""
    return (isinstance(result_t, T.DecimalType)
            and isinstance(arg_t, T.DecimalType)
            and not arg_t.fits_int64 and arg_t.precision <= 38
            and result_t.precision <= 38
            and arg_t.scale == result_t.scale)


def wide_minmax_state(arg_t: T.DataType) -> bool:
    """MIN/MAX over a wide decimal keeps the running extreme as the same
    three int64 value limbs, compared lexicographically (l2, l1, l0)."""
    return (isinstance(arg_t, T.DecimalType) and not arg_t.fits_int64
            and arg_t.precision <= 38)


def state_mode(fn: E.AggFunction, arg_t: T.DataType,
               result_t: T.DataType):
    """Device limb layout for this aggregate: '2' (two-limb sum, arg fits
    int64), '3' (three-limb wide sum), 'w' (wide min/max), or False."""
    F = E.AggFunction
    if fn == F.SUM:
        if limb_state(arg_t, result_t):
            return "2"
        if limb3_state(arg_t, result_t):
            return "3"
    elif fn == F.AVG:
        sum_t = avg_sum_type(arg_t)
        if isinstance(sum_t, T.DecimalType):
            if limb_state(arg_t, sum_t):
                return "2"
            if limb3_state(arg_t, sum_t):
                return "3"
    elif fn in (F.MIN, F.MAX) and wide_minmax_state(arg_t):
        return "w"
    return False


def limb_tag(result_t: T.DecimalType) -> str:
    """State-field name for the low limb, carrying the decimal params so a
    FINAL-mode consumer can reconstruct types from the wire schema alone."""
    return f"sum_lo@{result_t.precision}.{result_t.scale}"


def limb3_tag(result_t: T.DecimalType, arg_t: T.DecimalType) -> str:
    """Carries BOTH the sum/result params and the ARG precision: the sum
    precision saturates at 38, so P-10 cannot reconstruct a 29..38-digit
    arg — and AVG's result type derives from the ARG (min(p+4, 38)), which
    would silently narrow without it."""
    return f"sum_l0@{result_t.precision}.{result_t.scale}a{arg_t.precision}"


def wide_val_tag(result_t: T.DecimalType) -> str:
    return f"val_l0@{result_t.precision}.{result_t.scale}"


def _parse_tag(field_name: str, marker: str):
    i = field_name.find(marker)
    if i < 0:
        return None
    try:
        p, s = field_name[i + len(marker):].split(".")
        arg_p = None
        if "a" in s:
            s, a = s.split("a")
            arg_p = int(a)
        t = T.DecimalType(int(p), int(s))
        t_arg = T.DecimalType(arg_p, int(s)) if arg_p is not None else None
        return t, t_arg
    except (ValueError, TypeError):
        return None


def parse_limb_tag(field_name: str):
    """'<agg>#sum_lo@P.S' -> DecimalType(P, S) or None."""
    t = _parse_tag(field_name, "#sum_lo@")
    return t[0] if t is not None else None


def parse_state_mode(field_name: str):
    """First-state-field name -> (mode, DecimalType) or None. THE wire
    authority for the partial producer's limb decision; merge/final
    consumers read it here instead of re-deriving."""
    for marker, mode in (("#sum_lo@", "2"), ("#sum_l0@", "3"),
                         ("#val_l0@", "w")):
        t = _parse_tag(field_name, marker)
        if t is not None:
            return mode, t[0], t[1]
    return None


def agg_state_fields(fn: E.AggFunction, arg_t: T.DataType,
                     result_t: T.DataType,
                     limbs: "bool | None" = None) -> List[Tuple[str, T.DataType]]:
    """State layout per aggregate. ``limbs``: None derives the wide-decimal
    SUM limb decision from (arg_t, result_t); merge/final-mode callers MUST
    pass the decision read from the wire schema instead (parse_limb_tag),
    since arg reconstruction cannot recover a partial side that declined
    limbs (e.g. a scale-mismatched plan)."""
    F = E.AggFunction
    mode = state_mode(fn, arg_t, result_t) if limbs is None else \
        ("2" if limbs is True else limbs)
    if fn == F.SUM:
        if mode == "2":
            return [(limb_tag(result_t), T.I64), ("sum_hi", T.I64),
                    ("has", T.BOOL)]
        if mode == "3":
            return [(limb3_tag(result_t, arg_t), T.I64), ("sum_l1", T.I64),
                    ("sum_l2", T.I64), ("has", T.BOOL)]
        return [("sum", result_t), ("has", T.BOOL)]
    if fn == F.COUNT:
        return [("count", T.I64)]
    if fn == F.AVG:
        sum_t = avg_sum_type(arg_t)
        # wide-decimal AVG rides the same limb layouts as SUM: two limbs
        # when the SUM TYPE fits (arg <= 18 digits), three when the arg
        # itself is wide
        if mode == "2":
            return [(limb_tag(sum_t), T.I64), ("sum_hi", T.I64),
                    ("count", T.I64)]
        if mode == "3":
            return [(limb3_tag(sum_t, arg_t), T.I64), ("sum_l1", T.I64),
                    ("sum_l2", T.I64), ("count", T.I64)]
        return [("sum", sum_t), ("count", T.I64)]
    if fn in (F.MIN, F.MAX):
        if mode == "w":
            return [(wide_val_tag(result_t), T.I64), ("val_l1", T.I64),
                    ("val_l2", T.I64), ("has", T.BOOL)]
        return [("val", result_t), ("has", T.BOOL)]
    if fn in (F.FIRST, F.FIRST_IGNORES_NULL):
        return [("val", result_t), ("valid", T.BOOL), ("order", T.I64)]
    if fn in (F.COLLECT_LIST, F.COLLECT_SET, F.BRICKHOUSE_COLLECT):
        return [("items", T.ArrayType(arg_t))]
    if fn == F.BRICKHOUSE_COMBINE_UNIQUE:
        # arg is already an array; state unions its elements
        elem = arg_t.element_type if isinstance(arg_t, T.ArrayType) else arg_t
        return [("items", T.ArrayType(elem))]
    if fn == F.BLOOM_FILTER:
        return [("bloom", T.BINARY)]
    if fn == F.UDAF:
        return [("acc", T.BINARY)]
    raise NotImplementedError(f"agg function {fn}")


def agg_output_schema(child_schema: T.Schema, groupings, aggs,
                      input_is_partial: bool, is_partial_output: bool) -> T.Schema:
    """Output schema of an Agg node (groupings + state fields or final values)."""
    if input_is_partial:
        gfields = [
            T.StructField(n, child_schema[i].dtype)
            for i, (n, _) in enumerate(groupings)
        ]
    else:
        gfields = [
            T.StructField(n, E.infer_type(e, child_schema)) for n, e in groupings
        ]
    out = list(gfields)
    pos = len(groupings)
    for a in aggs:
        agg = a.agg
        limbs = None
        if input_is_partial:
            arg_t = _arg_type_from_state(agg, child_schema, pos)
            # layout decided by the partial producer; read it from the wire
            m = parse_state_mode(child_schema[pos].name)
            limbs = m[0] if m is not None else False
        else:
            arg_t = E.infer_type(agg.args[0], child_schema) if agg.args else T.NULL
        result_t = agg.return_type or E.agg_result_type(agg.fn, arg_t)
        if agg.fn == E.AggFunction.COUNT:
            result_t = T.I64
        elif agg.fn == E.AggFunction.BLOOM_FILTER:
            result_t = T.BINARY
        fields = agg_state_fields(agg.fn, arg_t, result_t, limbs=limbs)
        if is_partial_output:
            out.extend(T.StructField(f"{a.name}#{s}", dt) for s, dt in fields)
        else:
            out.append(T.StructField(a.name, result_t))
        pos += len(fields)
    return T.Schema(tuple(out))


def _arg_type_from_state(agg: E.AggExpr, child_schema: T.Schema, pos: int) -> T.DataType:
    """Reconstruct the argument type from the value-typed first state field
    (partial input has no raw arg columns)."""
    m = parse_state_mode(child_schema[pos].name)
    if m is not None:
        mode, tag_t, tag_arg = m
        if mode == "w":
            return tag_t  # MIN/MAX keep the arg type exactly
        if agg.fn in (E.AggFunction.SUM, E.AggFunction.AVG):
            if tag_arg is not None:
                # three-limb tags carry the exact arg precision (the sum
                # precision saturates at 38 and AVG's result type derives
                # from the ARG)
                return tag_arg
            # SUM result / AVG sum type is arg precision + 10 (Spark
            # promotion)
            return T.DecimalType(max(tag_t.precision - 10, 1), tag_t.scale)
    dt = child_schema[pos].dtype
    if isinstance(dt, T.DecimalType) and agg.fn in (E.AggFunction.SUM, E.AggFunction.AVG):
        return T.DecimalType(max(dt.precision - 10, 1), dt.scale)
    if agg.fn == E.AggFunction.AVG and isinstance(dt, T.Float64Type):
        return T.F64
    if isinstance(dt, T.ArrayType):
        return dt.element_type
    return dt
