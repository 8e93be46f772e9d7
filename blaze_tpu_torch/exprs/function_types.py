"""Result types of the scalar functions (device-free).

The port's own copy of the type rules of blaze_tpu/exprs/functions.py
(``_TYPE_RULES``, ``infer_function_type``): ``ir/exprs.py infer_type``
reads them for a ``ScalarFunction`` without a return type, so they live
apart from the functions' torch implementations (exprs/functions.py).
A rule is a type, or a function of the argument types; names are matched
as given, as the reference matches them.
"""

from __future__ import annotations

from blaze_tpu_torch.ir import types as T

_TYPE_RULES = {}


def infer_function_type(name: str, arg_types) -> T.DataType:
    rule = _TYPE_RULES.get(name)
    if rule is None:
        raise NotImplementedError(f"unknown scalar function {name!r}")
    return rule(arg_types) if callable(rule) else rule


def register_type_rule(name: str, rule):
    _TYPE_RULES[name] = rule


def _first_non_null(ts):
    return next((t for t in ts if not isinstance(t, T.NullType)), T.NULL)


def _array_union_type_rule(ts):
    for t in ts:
        if isinstance(t, T.ArrayType) and not isinstance(t.element_type, T.NullType):
            return t
    return T.ArrayType(T.NULL)


for _n in ("year", "month", "day", "dayofmonth", "quarter", "datediff"):
    register_type_rule(_n, T.I32)
for _n in ("length", "char_length", "instr"):
    register_type_rule(_n, T.I32)
for _n in ("upper", "lower", "trim", "ltrim", "rtrim", "substring", "substr",
           "concat", "concat_ws", "replace", "repeat", "space", "lpad", "rpad",
           "reverse", "sha2", "md5", "hex"):
    register_type_rule(_n, T.STRING)
for _n in ("sqrt", "exp", "ln", "log", "log2", "log10", "pow", "power",
           "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "cbrt",
           "signum", "rint"):
    register_type_rule(_n, T.F64)
register_type_rule("murmur3_hash", T.I32)
register_type_rule("xxhash64", T.I64)
register_type_rule("crc32", T.I64)
for _n in ("abs", "negative", "positive", "coalesce", "nullif", "nvl", "ifnull",
           "greatest", "least", "normalize_nan_and_zero", "round"):
    register_type_rule(_n, _first_non_null)
register_type_rule("if", lambda ts: ts[1])
register_type_rule("ceil", T.I64)
register_type_rule("floor", T.I64)
register_type_rule("date_add", T.DATE)
register_type_rule("date_sub", T.DATE)
register_type_rule("split", T.ArrayType(T.STRING))
register_type_rule("make_array", lambda ts: T.ArrayType(ts[0] if ts else T.NULL))
register_type_rule("array_union", _array_union_type_rule)
register_type_rule("unscaled_value", T.I64)
register_type_rule("make_decimal", lambda ts: T.DecimalType(38, 18))
register_type_rule("check_overflow", lambda ts: ts[0])
register_type_rule("get_json_object", T.STRING)
register_type_rule("string_space", T.STRING)
register_type_rule("starts_with", T.BOOL)
register_type_rule("ends_with", T.BOOL)
register_type_rule("contains", T.BOOL)
register_type_rule("isnan", T.BOOL)
