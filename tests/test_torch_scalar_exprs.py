"""CASE, casts, the device scalar functions and the XXH64 row hash in the
port against the JAX package.

- Case: tests/test_exprs.py's test_case_when and
  test_case_no_else_gives_null on the port, then null and false
  conditions, literal, column, decimal, bool and narrow-int branches,
  nested, with and without ELSE, against the JAX package's
  ``ExprEvaluator``.
- Casts: every device source/target pair of ``cast_dev`` (the pairs the
  JAX package refuses raise in both), test_exprs.py's Java float -> int
  cases at NaN, +-inf, +-2^31 and +-2^63, and TryCast.
- Every device function of ``exprs/functions.py`` against the JAX
  package's ``dispatch_function`` (test_exprs.py's test_coalesce too),
  the function type rules, and the raises naming ROADMAP.md item 6b.
- K15's plain twin against ``xxhash64_int64``/``xxhash64_int32`` and
  ``hash_batch(..., algo="xxhash64")`` on chip_smoke.py's K15 battery
  (the numeric half of test_spark_hash.py's xxhash64 chaining; every
  lane at its own width, 1 to 32 columns, views at odd offsets), and
  test_spark_hash.py's golden longs and Spark's documented
  xxhash64('Spark', array(123), 2) with a byte and a short; the
  xxhash64 function hands K15 its bool, int8 and int16 planes unwidened.
- hash_sample (chip_smoke.py) at 6,000 rows in both packages and against
  its numpy oracle, order included.

Tolerance: exact (values where valid, validity everywhere; floats bit for
bit, NaN equal to NaN), except the transcendental functions (sqrt, exp,
ln, log, log2, log10, sin, cos, tan, asin, acos, atan, cbrt, pow, power,
atan2): their results may be at most 2 ulp apart, because XLA on the CPU
and torch (libm here, CUDA's library on the card) round them in the last
bits differently; subnormal results are left out there (the JAX package
flushes them to zero on the CPU). The inputs hold no subnormals.
"""

import dataclasses
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core import ColumnarBatch as JPyBatch
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.exprs import functions as JF
from blaze_tpu.exprs import spark_hash as JH
from blaze_tpu.exprs.compiler import ExprEvaluator as JEvaluator
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs import functions as F
from blaze_tpu_torch.exprs import spark_hash as H
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import from_foreign
from chip_smoke import XXH_CASES, XXH_SPARK_DOC, hash_sample_host, hash_sample_oracle, \
    hash_sample_plan, hash_sample_schema, xxh64_bytes, xxh_case, xxh_lane_type, xxh_spark_doc

torch.set_num_threads(1)

CAP, N = 1024, 1000
B = JE.BinaryOp
D72, D180, D94 = JT.DecimalType(7, 2), JT.DecimalType(18, 0), JT.DecimalType(9, 4)
SCHEMA = JT.Schema.of(
    ("i8", JT.I8), ("i16", JT.I16), ("i32", JT.I32), ("i64", JT.I64), ("f32", JT.F32),
    ("f64", JT.F64), ("b", JT.BOOL), ("dt", JT.DATE), ("ts", JT.TIMESTAMP), ("d72", D72),
    ("d180", D180), ("d94", D94), ("fin", JT.F64), ("c1", JT.BOOL), ("c2", JT.BOOL))
FLOATS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 0.5, -0.5, 1.5, 2.5, -2.5, 0.1, 0.35,
                   2.0 ** 31, -2.0 ** 31, 2.0 ** 31 - 1, 2.0 ** 63, -2.0 ** 63,
                   9.223372036854774784e18, 1e300, -1e300, 127.9, -128.9, 1e30, -1e30])


def _columns(seed):
    rng = np.random.default_rng(seed)

    def ints(dt):
        info = np.iinfo(dt)
        d = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
        small = rng.random(N) < 0.5
        d[small] = rng.integers(-300, 300, int(small.sum())).astype(dt)
        pick = rng.random(N) < 0.1
        d[pick] = np.array([info.min, info.max, -1, 0, 1], dt)[rng.integers(0, 5, int(pick.sum()))]
        return d

    def floats(dt):
        d = np.where(rng.random(N) < 0.4, FLOATS[rng.integers(0, len(FLOATS), N)],
                     rng.standard_normal(N) * 1e3)
        with np.errstate(over="ignore"):  # +-1e300 is +-inf in float32
            return d.astype(dt)

    def dec(bound, special):
        d = rng.integers(-bound + 1, bound, N)
        small = rng.random(N) < 0.3
        d[small] = rng.integers(-100_000, 100_000, int(small.sum()))
        pick = rng.random(N) < 0.1
        d[pick] = np.array(special)[rng.integers(0, len(special), int(pick.sum()))]
        return d

    cols = {
        "i8": ints(np.int8), "i16": ints(np.int16), "i32": ints(np.int32),
        "i64": ints(np.int64), "f32": floats(np.float32), "f64": floats(np.float64),
        "b": rng.random(N) < 0.5,
        "dt": rng.integers(-200_000, 200_000, N).astype(np.int32),
        "ts": np.where(rng.random(N) < 0.5, rng.integers(-10 ** 16, 10 ** 16, N),
                       rng.integers(-10 ** 9, 10 ** 9, N)),
        "d72": dec(10 ** 7, [0, 35, 150, -150, 9_999_999, -9_999_999, 5, -5, 49, -51]),
        "d180": dec(10 ** 18, [0, 10 ** 18 - 1, -(10 ** 18 - 1), 12_345, 2 ** 31, -2 ** 31]),
        "d94": dec(10 ** 9, [0, 5_000, -5_000, 999_999_999, 12_345]),
        "fin": rng.uniform(-1e4, 1e4, N),
        "c1": rng.random(N) < 0.5, "c2": rng.random(N) < 0.5,
    }
    out = {}
    for name, d in cols.items():
        v = rng.random(N) >= 0.15
        out[name] = (np.where(v, d, np.zeros((), d.dtype)), v)
    return out


def _eval_both(exprs, cols=None, schema=SCHEMA):
    """(reference columns, port columns) of ``exprs`` over one batch."""
    cols = cols if cols is not None else _columns(7)
    jcols = [JDeviceColumn.from_numpy(f.dtype, *cols[f.name], CAP) for f in schema.fields]
    jout = JEvaluator(list(exprs), schema).evaluate(JBatch(schema, jcols, N))
    tb = ColumnarBatch.from_numpy(from_foreign(schema), cols, torch.device("cpu"),
                                  capacity=CAP)
    tout = ExprEvaluator([from_foreign(e) for e in exprs], tb.schema).evaluate(tb)
    return jout, tout


def _same(jcol, tcol, ulps=0):
    """Equal type and validity; equal data where valid (floats bit for bit,
    NaN equal to NaN; ``ulps`` > 0: normal results at most that far apart)."""
    assert repr(from_foreign(jcol.dtype)) == repr(tcol.dtype)
    jv = np.asarray(jcol.validity)
    np.testing.assert_array_equal(jv, tcol.validity.numpy())
    jd, td = np.asarray(jcol.data), tcol.data.numpy()
    assert jd.dtype == td.dtype, (jd.dtype, td.dtype)
    jd, td = jd[jv], td[jv]
    if jd.dtype.kind != "f":
        np.testing.assert_array_equal(jd, td)
        return
    bits = {4: np.int32, 8: np.int64}[jd.itemsize]
    jb, tb = jd.view(bits).astype(np.int64), td.view(bits).astype(np.int64)
    ok = (np.isnan(jd) & np.isnan(td)) | (jb == tb)
    if ulps:
        tiny = np.finfo(jd.dtype).tiny
        sub = ((np.abs(jd) < tiny) & (jd != 0)) | ((np.abs(td) < tiny) & (td != 0))
        same_sign = np.signbit(jd) == np.signbit(td)
        ok |= sub | (same_sign & ~np.isnan(jd) & ~np.isnan(td) & (np.abs(jb - tb) <= ulps))
    bad = np.nonzero(~ok)[0]
    assert not len(bad), (jd[bad[:5]], td[bad[:5]])


def _check(expr, ulps=0, cols=None, schema=SCHEMA):
    (j,), (t,) = _eval_both([expr], cols, schema)
    _same(j, t, ulps)


def _c(n):
    return JE.Column(n)


def _lit(v, dt):
    return JE.Literal(v, dt)


def _f(name, *args):
    return JE.ScalarFunction(name, list(args))


# -- Case ---------------------------------------------------------------------------


def _port_pydict(exprs, schema, cols, n):
    """Run ``exprs`` on the port over numpy columns; the result as pydict."""
    tb = ColumnarBatch.from_numpy(from_foreign(schema), cols, torch.device("cpu"))
    tout = ExprEvaluator([from_foreign(e) for e in exprs], tb.schema).evaluate(tb)
    return [ColumnarBatch(T.Schema.of(("c", c.dtype)), [c], n).to_pydict()["c"] for c in tout]


def test_case_when():
    """tests/test_exprs.py:75 on the port: null comparisons are not true,
    so a null row takes ELSE."""
    expr = JE.Case([(JE.BinaryExpr(B.LT, _c("a"), _lit(0, JT.I64)), _lit(-1, JT.I64)),
                    (JE.BinaryExpr(B.EQ, _c("a"), _lit(0, JT.I64)), _lit(0, JT.I64))],
                   _lit(1, JT.I64))
    schema = JT.Schema.of(("a", JT.I64))
    cols = {"a": (np.array([-5, 0, 7, 0]), np.array([True, True, True, False]))}
    assert _port_pydict([expr], schema, cols, 4) == [[-1, 0, 1, 1]]
    jb = JPyBatch.from_pydict({"a": pa.array([-5, 0, 7, None], type=pa.int64())})
    (jcol,) = JEvaluator([expr], jb.schema).evaluate(jb)
    assert JPyBatch(JT.Schema.of(("c", jcol.dtype)), [jcol], 4).to_pydict()["c"] == \
        [-1, 0, 1, 1]


def test_case_no_else_gives_null():
    """tests/test_exprs.py:87 on the port."""
    expr = JE.Case([(JE.BinaryExpr(B.LT, _c("a"), _lit(0, JT.I64)), _lit(-1, JT.I64))])
    schema = JT.Schema.of(("a", JT.I64))
    cols = {"a": (np.array([-5, 5]), np.array([True, True]))}
    assert _port_pydict([expr], schema, cols, 2) == [[-1, None]]


CASES = {
    "null_conditions": JE.Case([(_c("c1"), _c("i64")), (_c("c2"), _c("i32"))], _c("i16")),
    "no_else": JE.Case([(_c("c1"), _c("i64")), (JE.Not(_c("c2")), _lit(3, JT.I64))]),
    "literal_branches": JE.Case(
        [(JE.BinaryExpr(B.GT, _c("f64"), _lit(0.0, JT.F64)), _lit(1.0, JT.F64)),
         (JE.BinaryExpr(B.LT, _c("f64"), _lit(0.0, JT.F64)), _lit(-1.0, JT.F64))],
        _lit(None, JT.F64)),
    "column_branches": JE.Case([(_c("c1"), _c("f64")), (_c("c2"), _c("f32"))], _c("fin")),
    "decimal_branch": JE.Case([(_c("c1"), _c("d72")), (_c("c2"), _c("d94"))], _c("d180")),
    "bool_result": JE.Case([(_c("c1"), _c("c2"))], _c("b")),
    "narrow_result": JE.Case([(_c("c1"), _c("i8")), (_c("c2"), _c("i16"))]),
    "false_and_null_literal_conditions": JE.Case(
        [(_lit(False, JT.BOOL), _c("i32")), (_lit(None, JT.BOOL), _c("i32"))], _c("i32")),
    "nested": JE.Case([(JE.Case([(_c("c1"), _c("c2"))], _c("b")), _c("dt"))],
                      JE.Case([(_c("b"), _lit(5, JT.DATE))])),
    "q89_filter": JE.BinaryExpr(B.GT, JE.Case(
        [(JE.Not(JE.BinaryExpr(B.EQ, _c("fin"), _lit(0.0, JT.F64))),
          JE.BinaryExpr(B.DIV, _f("abs", JE.BinaryExpr(B.SUB, JE.Cast(_c("i64"), JT.F64),
                                                       _c("fin"))), _c("fin")))],
        _lit(None, JT.F64)), _lit(0.1, JT.F64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_jax(name):
    _check(CASES[name])


# -- casts --------------------------------------------------------------------------

SOURCES = ("i8", "i16", "i32", "i64", "f32", "f64", "b", "dt", "ts", "d72", "d180")
TARGETS = {"bool": JT.BOOL, "i8": JT.I8, "i16": JT.I16, "i32": JT.I32, "i64": JT.I64,
           "f32": JT.F32, "f64": JT.F64, "date": JT.DATE, "ts": JT.TIMESTAMP,
           "d7_2": D72, "d18_0": D180, "d12_4": JT.DecimalType(12, 4),
           "d5_1": JT.DecimalType(5, 1), "d18_6": JT.DecimalType(18, 6)}


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("source", SOURCES)
def test_cast_matrix_matches_jax(source, target):
    """Cast(source column -> target) in both packages. A float into a date
    or timestamp converts as the device does (undefined past the target's
    range, in both), so it reads the finite column; a pair the JAX package
    refuses raises NotImplementedError in the port too."""
    to = TARGETS[target]
    col = "fin" if source in ("f32", "f64") and target in ("date", "ts") else source
    expr = JE.Cast(_c(col), to)
    try:
        _eval_jax = _eval_both([expr])
    except NotImplementedError:
        tb = ColumnarBatch.from_numpy(from_foreign(SCHEMA), _columns(7), torch.device("cpu"),
                                      capacity=CAP)
        with pytest.raises(NotImplementedError):
            ExprEvaluator([from_foreign(expr)], tb.schema).evaluate(tb)
        return
    (j,), (t,) = _eval_jax
    _same(j, t)


def test_cast_float_to_int_java_semantics():
    """tests/test_exprs.py:95 on the port, and the int64 and int32 bounds:
    NaN -> 0, saturation at +-inf and past the bounds, truncation inside."""
    vals = np.array([3.9, -3.9, np.nan, 1e30, -1e30, np.inf, -np.inf, 2.0 ** 31,
                     -2.0 ** 31, 2.0 ** 31 - 1, 2.0 ** 63, -2.0 ** 63, 9.223372036854774784e18])
    schema = JT.Schema.of(("f", JT.F64))
    cols = {"f": (vals, np.ones(len(vals), bool))}
    i32, i64 = _port_pydict([JE.Cast(_c("f"), JT.I32), JE.Cast(_c("f"), JT.I64)], schema,
                            cols, len(vals))
    m32, m64 = 2 ** 31 - 1, 2 ** 63 - 1
    assert i32 == [3, -3, 0, m32, -m32 - 1, m32, -m32 - 1, m32, -m32 - 1, m32, m32, -m32 - 1,
                   m32]
    assert i64 == [3, -3, 0, m64, -m64 - 1, m64, -m64 - 1, 2 ** 31, -2 ** 31, 2 ** 31 - 1,
                   m64, -m64 - 1, 9223372036854774784]
    for to in (JT.I8, JT.I16, JT.I32, JT.I64):
        _check(JE.Cast(_c("f"), to), cols={"f": cols["f"]}, schema=schema)


@pytest.mark.parametrize("pair", ["f64>i32", "f32>i64", "d180>d5_1", "i64>i8", "d72>f64",
                                  "f64>d7_2", "ts>date"])
def test_try_cast_matches_jax(pair):
    src, to = pair.split(">")
    target = {"i32": JT.I32, "i64": JT.I64, "d5_1": JT.DecimalType(5, 1), "i8": JT.I8,
              "f64": JT.F64, "d7_2": D72, "date": JT.DATE}[to]
    _check(JE.TryCast(_c(src), target))


def test_decimal_to_double_divides():
    """0.35 as decimal(7,2) is 0.35 as a double (an IEEE divide, not a
    multiply by 0.01) and so equal to the double literal 0.35."""
    expr = JE.BinaryExpr(B.EQ, JE.Cast(_c("d72"), JT.F64), _lit(0.35, JT.F64))
    schema = JT.Schema.of(("d72", D72))
    cols = {"d72": (np.array([35, 36]), np.array([True, True]))}
    assert _port_pydict([expr], schema, cols, 2) == [[True, False]]


# -- functions ----------------------------------------------------------------------

FUNCTIONS = {
    "year": _f("year", _c("dt")), "month": _f("month", _c("dt")), "day": _f("day", _c("dt")),
    "dayofmonth": _f("dayofmonth", _c("ts")), "quarter": _f("quarter", _c("dt")),
    "year_ts": _f("year", _c("ts")), "month_ts": _f("month", _c("ts")),
    "date_add": _f("date_add", _c("dt"), _c("i16")),
    "date_sub": _f("date_sub", _c("dt"), _lit(40, JT.I32)),
    "datediff": _f("datediff", _c("dt"), _lit(11_000, JT.DATE)),
    "signum": _f("signum", _c("f64")), "rint": _f("rint", _c("f64")),
    "abs_i8": _f("abs", _c("i8")), "abs_i64": _f("abs", _c("i64")),
    "abs_f64": _f("abs", _c("f64")), "abs_d72": _f("abs", _c("d72")),
    "abs_bool": _f("abs", _c("b")), "negative_i32": _f("negative", _c("i32")),
    "negative_f64": _f("negative", _c("f64")), "negative_d94": _f("negative", _c("d94")),
    "round_f64": _f("round", _c("f64")), "round_f64_2": _f("round", _c("fin"), _lit(2, JT.I32)),
    "round_f32_1": _f("round", _c("f32"), _lit(1, JT.I32)),
    "round_d72_1": _f("round", _c("d72"), _lit(1, JT.I32)),
    "round_d94_2": _f("round", _c("d94"), _lit(2, JT.I32)),
    "round_d72_up": _f("round", _c("d72"), _lit(3, JT.I32)),
    "round_i64_neg": _f("round", _c("i64"), _lit(-2, JT.I32)),
    "round_i8_neg": _f("round", _c("i8"), _lit(-1, JT.I32)),
    "round_i32": _f("round", _c("i32"), _lit(0, JT.I32)),
    "ceil_fin": _f("ceil", _c("fin")), "floor_fin": _f("floor", _c("fin")),
    "ceil_d72": _f("ceil", _c("d72")), "floor_d94": _f("floor", _c("d94")),
    "ceil_i32": _f("ceil", _c("i32")),
    "coalesce_f": _f("coalesce", _c("f64"), _c("fin"), _lit(0.0, JT.F64)),
    "coalesce_i": _f("coalesce", _c("i64"), _c("i32"), _lit(0, JT.I64)),
    "nullif_i": _f("nullif", _c("i32"), _c("i64")),
    "nullif_d": _f("nullif", _c("d72"), _lit("1.50", D72)),
    "nullif_f": _f("nullif", _c("f64"), _lit(0.5, JT.F64)),
    "nvl": _f("nvl", _c("i64"), _lit(7, JT.I64)), "ifnull": _f("ifnull", _c("d72"), _c("d94")),
    "if": _f("if", _c("c1"), _c("i64"), _c("i32")),
    "if_null_branch": _f("if", _c("c1"), _c("f64"), _lit(None, JT.F64)),
    "greatest_f": _f("greatest", _c("f64"), _c("fin"), _lit(0.0, JT.F64)),
    "least_f": _f("least", _c("f64"), _lit(-1.5, JT.F64), _c("fin")),
    "greatest_i": _f("greatest", _c("i32"), _c("i16"), _c("i8")),
    "least_i": _f("least", _c("i64"), _c("i32")),
    "isnan": _f("isnan", _c("f64")), "isnan_f32": _f("isnan", _c("f32")),
    "normalize_nan_and_zero": _f("normalize_nan_and_zero", _c("f64")),
    "normalize_f32": _f("normalize_nan_and_zero", _c("f32")),
    "unscaled_value": _f("unscaled_value", _c("d94")),
    "make_decimal": _f("make_decimal", _c("i64"), _lit(12, JT.I32), _lit(2, JT.I32)),
    "check_overflow": _f("check_overflow", _c("d94")),
    "murmur3_hash": _f("murmur3_hash", _c("i32"), _c("i64"), _c("f64"), _c("d72"), _c("b"),
                       _c("dt"), _c("ts")),
    "murmur3_hash_narrow": _f("murmur3_hash", _c("f32"), _c("i8"), _c("i16"), _c("d180")),
    "xxhash64": _f("xxhash64", _c("i32"), _c("i64"), _c("f64"), _c("d72"), _c("b"),
                   _c("dt"), _c("ts")),
    "xxhash64_narrow": _f("xxhash64", _c("f32"), _c("i8"), _c("i16"), _c("d180")),
    "xxhash64_literal": _f("xxhash64", _c("i32"), _lit(7, JT.I64), _lit(None, JT.I32)),
}
TRANSCENDENTAL = {
    "sqrt": _f("sqrt", _c("f64")), "sqrt_d72": _f("sqrt", _c("d72")),
    "exp": _f("exp", JE.BinaryExpr(B.DIV, _c("fin"), _lit(10.0, JT.F64))),
    "exp_edges": _f("exp", _c("f64")), "ln": _f("ln", _c("f64")), "log": _f("log", _c("fin")),
    "log2": _f("log2", _c("f64")), "log10": _f("log10", _c("f64")),
    "sin": _f("sin", _c("f64")), "cos": _f("cos", _c("fin")), "tan": _f("tan", _c("f64")),
    "asin": _f("asin", JE.BinaryExpr(B.DIV, _c("fin"), _lit(1e4, JT.F64))),
    "acos": _f("acos", JE.BinaryExpr(B.DIV, _c("fin"), _lit(1e4, JT.F64))),
    "atan": _f("atan", _c("f64")), "cbrt": _f("cbrt", _c("f64")),
    "cbrt_i32": _f("cbrt", _c("i32")),
    "pow": _f("pow", _f("abs", _c("fin")), JE.BinaryExpr(B.DIV, _c("f64"), _lit(100.0, JT.F64))),
    "power": _f("power", _c("i8"), _lit(3.0, JT.F64)),
    "atan2": _f("atan2", _c("f64"), _c("fin")),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_matches_jax(name):
    _check(FUNCTIONS[name])


@pytest.mark.parametrize("name", sorted(TRANSCENDENTAL))
def test_transcendental_function_within_2_ulp(name):
    _check(TRANSCENDENTAL[name], ulps=2)


def test_coalesce():
    """tests/test_exprs.py:211 on the port."""
    expr = _f("coalesce", _c("a"), _c("b"), _lit(0, JT.I64))
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I64))
    cols = {"a": (np.array([1, 0, 0]), np.array([True, False, False])),
            "b": (np.array([0, 5, 0]), np.array([False, True, False]))}
    assert _port_pydict([expr], schema, cols, 3) == [[1, 5, 0]]


def test_civil_calendar_matches_jax():
    days = np.arange(-800_000, 800_000, 37, dtype=np.int32)
    jy, jm, jd = (np.asarray(x) for x in JF.civil_from_days(days))
    ty, tm, td = F.civil_from_days(torch.from_numpy(days))
    for j, t in ((jy, ty), (jm, tm), (jd, td)):
        np.testing.assert_array_equal(j, t.numpy())
    back = F.days_from_civil(ty, tm, td).numpy()
    np.testing.assert_array_equal(back, days)
    np.testing.assert_array_equal(back, np.asarray(JF.days_from_civil(jy, jm, jd)))


@pytest.mark.parametrize("name", sorted(n for n in JF._TYPE_RULES))
def test_function_types_match_jax(name):
    """A ScalarFunction without a return type types as in the JAX package."""
    args = [_c("i32"), _c("d72"), _c("f64")]
    expr = JE.ScalarFunction(name, args)
    try:
        want = JE.infer_type(expr, SCHEMA)
    except Exception as exc:  # a rule that reads more arguments than given
        with pytest.raises(type(exc)):
            E.infer_type(from_foreign(expr), from_foreign(SCHEMA))
        return
    assert repr(E.infer_type(from_foreign(expr), from_foreign(SCHEMA))) == repr(from_foreign(want))


@pytest.mark.parametrize("expr", [
    JE.Cast(_c("i64"), JT.STRING), JE.TryCast(_c("f64"), JT.STRING),
    _f("upper", _c("i32")), _f("concat", _c("i32"), _c("i64")),
    JE.Like(_c("i32"), "1%")], ids=["cast_to_string", "try_cast_to_string", "upper",
                                    "concat", "like"])
def test_string_and_host_expressions_raise_naming_6b(expr):
    tb = ColumnarBatch.from_numpy(from_foreign(SCHEMA), _columns(3), torch.device("cpu"),
                                  capacity=CAP)
    with pytest.raises(NotImplementedError, match="item 6b"):
        ExprEvaluator([from_foreign(expr)], tb.schema).evaluate(tb)


def test_wide_decimal_hash_argument_raises_naming_6b():
    schema = JT.Schema.of(("w", JT.DecimalType(25, 2)), ("i", JT.I32))
    for name in ("xxhash64", "murmur3_hash"):
        expr = from_foreign(_f(name, _c("i"), _c("w")))
        with pytest.raises(NotImplementedError, match="item 6b"):
            ExprEvaluator([expr], from_foreign(schema))


# -- XXH64: K15's plain twin ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["i64", "i32"])
def test_xxhash64_twin_matches_the_reference_lanes(kind):
    """One column folded from seed 42 is ``xxhash64_int64`` /
    ``xxhash64_int32`` of the reference; a null row keeps the seed; rows
    past n are 0."""
    rng = np.random.default_rng(11)
    if kind == "i64":
        vals = rng.integers(-2 ** 63, 2 ** 63 - 1, 4096, dtype=np.int64, endpoint=True)
        want = np.asarray(JH.xxhash64_int64(vals, np.full(4096, 42, np.uint64)))
    else:
        vals = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
        want = np.asarray(JH.xxhash64_int32(vals, np.full(4096, 42, np.uint64)))
    valid = rng.random(4096) >= 0.2
    got = H.xxhash64_rows_plain([torch.from_numpy(vals)], [torch.from_numpy(valid)], [kind],
                                4000, 4096).numpy()
    np.testing.assert_array_equal(got[:4000], np.where(valid, want.view(np.int64), 42)[:4000])
    assert not got[4000:].any()


def test_xxhash64_i64_golden():
    """tests/test_spark_hash.py:133 on K15's twin."""
    vals = torch.tensor([1, 0, -1, 2 ** 63 - 1, -(2 ** 63)], dtype=torch.int64)
    out = H.xxhash64_rows_plain([vals], [torch.ones(5, dtype=torch.bool)], ["i64"], 5, 5)
    assert out.tolist() == [-7001672635703045582, -5252525462095825812, 3858142552250413010,
                            -3246596055638297850, -8619748838626508300]


def test_xxhash64_spark_documented_example_with_a_byte_and_a_short():
    """Spark's SQL reference: xxhash64('Spark', array(123), 2) =
    5602566077635097486. The reference's byte hash of 'Spark' equals
    chip_smoke.py's ``xxh64_bytes``; from it, the reference's hashInt
    chain and K15's twin over the row [123, 2] as int8 + int16, int32 +
    int16 and int8 + int32 planes give Spark's value."""
    text, vals, want = XXH_SPARK_DOC
    seed = xxh64_bytes(text, 42)
    off = np.array([0, len(text)], np.int64)
    ref = JH.xxhash64_bytes_np(off, np.frombuffer(text, np.uint8), np.full(1, 42, np.uint64))
    assert int(ref[0]) == seed
    h = np.full(1, seed, np.uint64)
    for v in vals:
        h = JH.xxhash64_int32_np(np.array([v], np.int8 if v < 128 else np.int32), h)
    assert int(h[0]) == want
    assert len(xxh_spark_doc(H.xxhash64_rows_plain, torch.device("cpu"))) == 3


def test_xxhash64_function_hands_k15_planes_unwidened(monkeypatch):
    """The xxhash64 function passes ``hash_words``' planes as they are: a
    bool, int8 and int16 column reach K15 (here its twin) at their own
    width, with no widening copy, and hash as the reference does."""
    seen = []
    fn = H.xxhash64_rows

    def spy(words, valids, kinds, n, cap):
        seen.append([w.dtype for w in words])
        return fn(words, valids, kinds, n, cap)

    monkeypatch.setattr(H, "xxhash64_rows", spy)
    _check(_f("xxhash64", _c("b"), _c("i8"), _c("i16"), _c("f32"), _c("i64")))
    assert seen == [[torch.bool, torch.int8, torch.int16, torch.int32, torch.int64]]


@pytest.mark.parametrize("case", XXH_CASES, ids=[c[0] for c in XXH_CASES])
def test_xxhash64_twin_matches_hash_batch(case):
    """chip_smoke.py's K15 battery: the twin against the reference's
    ``hash_batch(..., algo="xxhash64")`` over the same typed columns
    (every lane, nulls, padding)."""
    rng = np.random.default_rng(XXH_CASES.index(case))
    words, valids, kinds, n, cap = xxh_case(case, rng, torch.device("cpu"))
    got = H.xxhash64_rows_plain(words, valids, kinds, n, cap).numpy()
    assert not got[n:].any()
    if n == 0:
        return
    rng = np.random.default_rng(XXH_CASES.index(case))  # the same draw, typed
    jcols = []
    for lane in case[1]:
        from chip_smoke import xxh_values

        vals = xxh_values(lane, cap, rng)
        v = rng.random(cap) >= case[4]
        v[n:] = False
        vals[~v] = 0
        jcols.append(JDeviceColumn.from_numpy(xxh_lane_type(JT, lane), vals, v, cap))
    want = JH.hash_batch(jcols, n, cap, seed=42, algo="xxhash64")
    np.testing.assert_array_equal(got[:n], want)


# -- hash_sample ----------------------------------------------------------------------------


def test_hash_sample_matches_jax_and_the_oracle(tmp_path):
    """chip_smoke.py's hash_sample plan over 6,000 store_sales rows (600
    tickets) in 4 partitions of 512-row batches: the filter through
    xxhash64, abs and %, the two-stage aggregate and the range exchange
    with sampled bounds; both packages equal to the numpy oracle, order
    included. The reference runs with ``fused_filter_agg=False``: its
    filter -> agg fusion (taken only on a CPU backend) traces the filter,
    and its xxhash64 reads the hashes on the host, which a trace refuses."""
    cols, valids = hash_sample_host(rows=6_000)
    want, info = hash_sample_oracle((cols, valids))
    assert info["groups"] == 103 and 400 < info["kept_rows"] < 800
    schema = hash_sample_schema(JT)
    cuts = [0, 1_500, 3_000, 4_500, 6_000]

    def batches(p, arrow):
        out = []
        for s in range(cuts[p], cuts[p + 1], 512):
            e = min(s + 512, cuts[p + 1])
            planes = {f.name: (c[s:e], np.ones(e - s, bool) if v is None else v[s:e])
                      for f, c, v in zip(schema.fields, cols, valids)}
            if arrow:
                arrs = []
                for f in schema.fields:
                    d, v = planes[f.name]
                    if isinstance(f.dtype, JT.DecimalType):
                        arrs.append(pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in d],
                                             type=pa.decimal128(7, 2), mask=~v))
                    else:
                        arrs.append(pa.array(d, mask=~v))
                out.append(pa.record_batch(arrs, names=schema.names))
            else:
                out.append(planes)
        return out

    plan = hash_sample_plan(schema, JE, JN, JT)
    with JaxSession(conf=dataclasses.replace(JaxConfig(batch_size=512),
                                             fused_filter_agg=False,
                                             shm_dir=str(tmp_path))) as s:
        s.resources["store_sales"] = lambda p: batches(p, True)
        jax_out = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=512), device="cpu")
    port.resources["store_sales"] = lambda p: batches(p, False)
    got = port.execute_to_pydict(from_foreign(plan))
    assert got == want
    assert jax_out == want
