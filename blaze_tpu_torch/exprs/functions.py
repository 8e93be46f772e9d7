"""Scalar functions with Spark semantics, on device columns (PyTorch).

The device half of blaze_tpu/exprs/functions.py (``_FUNCTIONS``), each
function op for op as there: the date parts and date arithmetic (civil
calendar in integer math), the math functions, abs/negative/round/ceil/
floor, coalesce/nullif/nvl/if/greatest/least, isnan,
normalize_nan_and_zero, the decimal helpers, and the two row hashes:
``murmur3_hash`` through K2's hash output and ``xxhash64`` through K15
(exprs/spark_hash.py). The hashes stay on the device (the JAX package
pulls them to the host and uploads them again): int64 or int32 data,
validity = the batch's row mask, data 0 on padding rows.

Where the reference differs from Spark and the port follows it:
``signum``, ``greatest``/``least`` order -0.0 below 0.0 as XLA does;
``ceil``/``floor`` of a double convert as the device converts (undefined
for NaN, infinities and values past int64). The math functions are
torch's (libm on the CPU, CUDA's on the card), which may differ from
XLA's in the last bits.

The string and host functions (``upper`` ... ``array_union``) read the
string plane, which the port does not have yet: they raise naming
ROADMAP.md Queue 1 item 6b.
"""

from __future__ import annotations

from typing import List

import torch

from blaze_tpu_torch.exprs import decimal as dec
from blaze_tpu_torch.exprs import spark_hash as H
from blaze_tpu_torch.exprs.cast import US_PER_DAY
from blaze_tpu_torch.exprs.compiler import DevVal, broadcast
from blaze_tpu_torch.ir import types as T

_HOST_FUNCTIONS = frozenset((
    "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "substring", "substr",
    "length", "char_length", "concat", "concat_ws", "replace", "split", "repeat",
    "space", "string_space", "lpad", "rpad", "instr", "sha2", "md5",
    "get_json_object", "make_array", "array_union"))


def _host_only(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} reads or builds string or host columns, which the PyTorch package "
        "has no plane for yet (ROADMAP.md Queue 1 item 6b)")


def dispatch_function(name: str, args: List, evaluator, batch):
    """``args`` are the evaluated arguments (DevVals); returns a DevVal."""
    name = name.lower()
    fn = _FUNCTIONS.get(name)
    if fn is None:
        if name in _HOST_FUNCTIONS:
            raise _host_only(f"scalar function {name!r}")
        raise NotImplementedError(f"scalar function {name!r} not implemented")
    return fn(args, evaluator, batch)


# -- civil calendar (Howard Hinnant's algorithms, integer only) -------------------


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """date32 days since the epoch -> (year, month, day), int32 each."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> date32 days since the epoch."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = (m + torch.where(m > 2, -3, 9)).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


# -- dates ---------------------------------------------------------------------


def _fn_date_part(part):
    def impl(args, ev, batch):
        (a,) = args
        days = _fdiv(a.data, US_PER_DAY) if isinstance(a.dtype, T.TimestampType) else a.data
        y, m, d = civil_from_days(days)
        out = {"year": y, "month": m, "day": d,
               "quarter": _fdiv(m + 2, 3).to(torch.int32)}[part]
        return DevVal(T.I32, out, a.validity)

    return impl


def _fn_date_arith(sign):
    def impl(args, ev, batch):
        a, b = args
        out = a.data.to(torch.int32) + sign * b.data.to(torch.int32)
        return DevVal(T.DATE, out, a.validity & b.validity)

    return impl


def _fn_datediff(args, ev, batch):
    a, b = args
    return DevVal(T.I32, a.data.to(torch.int32) - b.data.to(torch.int32),
                a.validity & b.validity)


# -- math ----------------------------------------------------------------------


def _cbrt(x):
    # XLA's cbrt: sign(x) * |x|^(1/3), zeros and NaN as they are
    root = torch.pow(torch.abs(x), 1.0 / 3.0)
    return torch.where(x == 0, x, torch.where(x < 0, -root, root))


def _signum(x):
    # jnp.sign: NaN and +-0.0 as they are
    return torch.where(x > 0, torch.ones_like(x), torch.where(x < 0, -torch.ones_like(x), x))


def _unary_math(fn):
    def impl(args, ev, batch):
        (a,) = args
        return DevVal(T.F64, fn(ev._decimal_to_f64(a)), a.validity)

    return impl


def _fn_pow(args, ev, batch):
    a, b = args
    return DevVal(T.F64, torch.pow(a.data.to(torch.float64), b.data.to(torch.float64)),
                a.validity & b.validity)


def _fn_atan2(args, ev, batch):
    a, b = args
    return DevVal(T.F64, torch.atan2(a.data.to(torch.float64), b.data.to(torch.float64)),
                a.validity & b.validity)


def _fn_abs(args, ev, batch):
    (a,) = args
    if T.torch_dtype(a.dtype) is None:
        raise _host_only(f"abs of {a.dtype!r}")
    if a.data.dtype == torch.bool:
        return a
    return DevVal(a.dtype, torch.abs(a.data), a.validity)


def _fn_negative(args, ev, batch):
    (a,) = args
    return DevVal(a.dtype, -a.data, a.validity)


def _fn_round(args, ev, batch):
    a = args[0]
    scale = (ev._host_scalar(args[1]) or 0) if len(args) > 1 else 0
    if isinstance(a.dtype, T.DecimalType):
        out, validity = dec.rescale(a.data, a.validity, a.dtype.scale, scale, 19)
        out, validity = dec.rescale(out, validity, scale, a.dtype.scale, a.dtype.precision)
        return DevVal(a.dtype, out, validity)
    if not a.data.is_floating_point():
        if scale >= 0:
            return a
        # negative scale: HALF_UP at the 10^-scale digit, in integer math
        m = 10 ** (-scale)
        av = a.data.to(torch.int64)
        q = dec.floordiv(av, m)
        r = av - q * m
        q = torch.where((av < 0) & (r != 0), q + 1, q)
        r = av - q * m
        bump = (2 * torch.abs(r)) >= m
        q = torch.where(bump, q + torch.where(av < 0, -1, 1), q)
        return DevVal(a.dtype, (q * m).to(a.data.dtype), a.validity)
    # Spark's HALF_UP for floats; the divisor is a device tensor so that
    # CUDA divides as IEEE does (it multiplies by a Python scalar's reciprocal)
    m = torch.full((), 10.0 ** scale, dtype=torch.float64, device=a.data.device)
    x = a.data.to(torch.float64) * m
    out = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)) / m
    return DevVal(a.dtype, out.to(a.data.dtype), a.validity)


def _fn_ceil_floor(which):
    def impl(args, ev, batch):
        (a,) = args
        if isinstance(a.dtype, T.DecimalType):
            m = 10 ** a.dtype.scale
            out = -dec.floordiv(-a.data, m) if which == "ceil" else dec.floordiv(a.data, m)
            return DevVal(T.I64, out, a.validity)
        if not a.data.is_floating_point():
            return DevVal(T.I64, a.data.to(torch.int64), a.validity)
        fn = torch.ceil if which == "ceil" else torch.floor
        return DevVal(T.I64, fn(a.data.to(torch.float64)).to(torch.int64), a.validity)

    return impl


# -- conditionals ------------------------------------------------------------------


def _fn_coalesce(args, ev, batch):
    data, validity = broadcast(args[0], batch)
    for a in args[1:]:
        d2, v2 = broadcast(a, batch)
        data = torch.where(validity, data, d2.to(data.dtype))
        validity = validity | v2
    return DevVal(args[0].dtype, data, validity)


def _fn_nullif(args, ev, batch):
    a, b = args
    ld, rd = ev._numeric_align(a, b)
    eq = torch.eq(ld, rd) & a.validity & b.validity
    return DevVal(a.dtype, a.data, a.validity & ~eq)


def _fn_if(args, ev, batch):
    c, a, b = args
    cm = c.data.to(torch.bool) & c.validity
    ad, av = broadcast(a, batch)
    bd, bv = broadcast(b, batch)
    return DevVal(a.dtype, torch.where(cm, ad, bd.to(ad.dtype)), torch.where(cm, av, bv))


def _maximum(a, b):
    # jnp.maximum: NaN propagates, -0.0 orders below 0.0
    if not a.is_floating_point():
        return torch.maximum(a, b)
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(torch.signbit(a), b, a), torch.maximum(a, b))


def _minimum(a, b):
    if not a.is_floating_point():
        return torch.minimum(a, b)
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(torch.signbit(a), a, b), torch.minimum(a, b))


def _fn_greatest_least(fn):
    def impl(args, ev, batch):
        data, validity = broadcast(args[0], batch)
        # Spark: nulls are skipped; NULL only when every argument is
        has = validity
        for a in args[1:]:
            d2, v2 = broadcast(a, batch)
            d2 = d2.to(data.dtype)
            both = has & v2
            data = torch.where(both, fn(data, d2), torch.where(v2, d2, data))
            has = has | v2
        return DevVal(args[0].dtype, data, has)

    return impl


def _fn_isnan(args, ev, batch):
    (a,) = args
    return DevVal(T.BOOL, torch.isnan(a.data.to(torch.float64)) & a.validity,
                torch.ones_like(a.validity))


def _fn_normalize_nan_and_zero(args, ev, batch):
    (a,) = args
    x = a.data
    x = torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=x.dtype,
                                               device=x.device), x)
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return DevVal(a.dtype, x, a.validity)


# -- decimal helpers (spark_unscaled_value / spark_make_decimal) -------------------


def _fn_unscaled_value(args, ev, batch):
    (a,) = args
    if not isinstance(a.dtype, T.DecimalType):
        raise TypeError(f"unscaled_value of {a.dtype!r}")
    return DevVal(T.I64, a.data, a.validity)


def _fn_make_decimal(args, ev, batch):
    a = args[0]
    precision = ev._host_scalar(args[1]) if len(args) > 1 else 38
    scale = ev._host_scalar(args[2]) if len(args) > 2 else 18
    if precision > 18:
        raise NotImplementedError(
            f"make_decimal into decimal({precision},{scale}) (wider than 18 digits) is "
            "not ported yet (ROADMAP.md Queue 1 item 18)")
    data, validity = dec.check_overflow(a.data, a.validity, precision)
    return DevVal(T.DecimalType(precision, scale), data, validity)


def _fn_check_overflow(args, ev, batch):
    a = args[0]
    if not isinstance(a.dtype, T.DecimalType):
        raise TypeError(f"check_overflow of {a.dtype!r}")
    data, validity = dec.check_overflow(a.data, a.validity, a.dtype.precision)
    return DevVal(a.dtype, data, validity)


# -- row hashes --------------------------------------------------------------------


def _hash_planes(args, ev, batch):
    """The arguments as hash words: (words, validities, kinds)."""
    words, valids, kinds = [], [], []
    for a in args:
        if isinstance(a.data, tuple) or T.torch_dtype(a.dtype) is None:
            raise _host_only(f"a {a.dtype!r} hash argument (hashed as bytes on the host)")
        col = ev._to_column(a, batch)
        kind = H.hash_kind(col.dtype)
        words.append(H.hash_words(col.data, kind))
        valids.append(col.validity)
        kinds.append(kind)
    return words, valids, kinds


def _fn_murmur3(args, ev, batch):
    words, valids, kinds = _hash_planes(args, ev, batch)
    n = batch.num_rows
    out = torch.zeros(batch.capacity, dtype=torch.int32, device=batch.device)
    if n > 0:
        out[:n] = H.murmur3_hashes(words, valids, kinds, n)
    return DevVal(T.I32, out, batch.row_exists_mask())


def _fn_xxhash64(args, ev, batch):
    words, valids, kinds = _hash_planes(args, ev, batch)
    out = H.xxhash64_rows(words, valids, kinds, batch.num_rows, batch.capacity)
    return DevVal(T.I64, out, batch.row_exists_mask())


_FUNCTIONS = {
    "year": _fn_date_part("year"),
    "month": _fn_date_part("month"),
    "day": _fn_date_part("day"),
    "dayofmonth": _fn_date_part("day"),
    "quarter": _fn_date_part("quarter"),
    "date_add": _fn_date_arith(1),
    "date_sub": _fn_date_arith(-1),
    "datediff": _fn_datediff,
    "sqrt": _unary_math(torch.sqrt),
    "exp": _unary_math(torch.exp),
    "ln": _unary_math(torch.log),
    "log": _unary_math(torch.log),
    "log2": _unary_math(torch.log2),
    "log10": _unary_math(torch.log10),
    "sin": _unary_math(torch.sin),
    "cos": _unary_math(torch.cos),
    "tan": _unary_math(torch.tan),
    "asin": _unary_math(torch.asin),
    "acos": _unary_math(torch.acos),
    "atan": _unary_math(torch.atan),
    "cbrt": _unary_math(_cbrt),
    "signum": _unary_math(_signum),
    "rint": _unary_math(torch.round),
    "pow": _fn_pow,
    "power": _fn_pow,
    "atan2": _fn_atan2,
    "abs": _fn_abs,
    "negative": _fn_negative,
    "round": _fn_round,
    "ceil": _fn_ceil_floor("ceil"),
    "floor": _fn_ceil_floor("floor"),
    "coalesce": _fn_coalesce,
    "nullif": _fn_nullif,
    "nvl": _fn_coalesce,
    "ifnull": _fn_coalesce,
    "if": _fn_if,
    "greatest": _fn_greatest_least(_maximum),
    "least": _fn_greatest_least(_minimum),
    "isnan": _fn_isnan,
    "normalize_nan_and_zero": _fn_normalize_nan_and_zero,
    "unscaled_value": _fn_unscaled_value,
    "make_decimal": _fn_make_decimal,
    "check_overflow": _fn_check_overflow,
    "murmur3_hash": _fn_murmur3,
    "xxhash64": _fn_xxhash64,
}
