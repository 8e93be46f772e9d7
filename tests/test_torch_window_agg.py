"""The port's window aggregates (slice 8) against the JAX package: K13's
plain twin, the host scans, and ``WindowExec`` with SUM, AVG, COUNT, MIN
and MAX over default, ROWS and RANGE frames, and q89.

- Kernel level: chip_smoke.py's K13 battery (``SCAN_CASES``: int64,
  int32, float64 and float32 planes, magnitudes 1e-5..1e16 with +-inf,
  -0.0 and NaN, nulls, padding, capacities 16 to 262,144, carries, segments
  of one row, of ~4 rows, one spanning the batch and none) goes through the
  reference's ``segment_scan_planes`` (its jitted ``_seg_scan`` on the
  CPU) and the port's ``segment_scan_planes`` (the twin). This is also
  the pin on the float order: XLA's ``cumsum`` on the CPU is a blocked
  scan of 16-row blocks, which the twin and K13 follow; if a jax upgrade
  changes that order, this test shows it.
- The host scans (``segment_cumsum``, ``segment_running_reduce``) on
  numeric and ``Decimal`` planes against the reference's.
- Plan level: plans built with ``blaze_tpu.ir`` and carried across with
  ``from_foreign`` run through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")`` over the same batches; the
  ``execute_to_pydict`` results must be equal, order included, and the
  port must call K13's entry point exactly as often as the reference
  calls ``_seg_scan``'s.

Tolerance: none. Planes are compared by their bytes, except that any NaN
equals any NaN (a NaN's payload is the hardware's); plan results compare
floats by ``repr``.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core import kernels as JK
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins.bhj import clear_build_cache
from blaze_tpu.runtime.session import Session as JaxSession
from blaze_tpu.utils.device import supports_f64

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.ir.carry import from_foreign
from chip_smoke import SCAN_CASES, scan_case

torch.set_num_threads(1)
# the reference's float64 probe must run outside a trace, or its fused
# closures take f64 literals down its host path
supports_f64()

F = JE.AggFunction
C = JE.Column
B = JE.BinaryOp


def _same(j, t):
    """Equal planes: dtype, shape, values; floats by their bits, NaN = NaN."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    if j.dtype.kind == "f":
        bits = {4: np.int32, 8: np.int64}[j.dtype.itemsize]
        ok = (np.isnan(j) & np.isnan(t)) | (j.view(bits) == t.view(bits))
        assert ok.all(), (np.nonzero(~ok)[0][:8], j[~ok][:8], t[~ok][:8])
    else:
        np.testing.assert_array_equal(j, t)


# -- K13: the twin against the reference's _seg_scan ------------------------------


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_segment_scan_plain_matches_reference(case):
    data = scan_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    args = [data[k] for k in ("data", "validity", "exists")]
    js, jc = JK.segment_scan_planes(*[jnp.asarray(a) for a in args], data["seg_start"],
                                    data["carry_sum"], data["carry_cnt"])
    ts, tc = K.segment_scan_planes(*[torch.from_numpy(a) for a in args], data["seg_start"],
                                   data["carry_sum"], data["carry_cnt"])
    _same(js, ts)
    _same(jc, tc)


def test_blocked_order_is_not_a_sequential_cumsum():
    """The pin's other half: on these float64 rows the reference's prefix
    (16-row blocks) differs from numpy's sequential one, and the twin
    follows the reference."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal(4096) * 10.0 ** rng.uniform(-5, 8, 4096)
    ones = np.ones(4096, bool)
    seg = np.zeros(4096, bool)
    js, _ = JK.segment_scan_planes(jnp.asarray(x), jnp.asarray(ones), jnp.asarray(ones),
                                   seg, 0.0, 0)
    ts, _ = K.segment_scan_planes(torch.from_numpy(x), torch.from_numpy(ones),
                                  torch.from_numpy(ones), seg, 0.0, 0)
    _same(js, ts)
    assert (np.cumsum(x) != js).mean() > 0.5


# -- the host scans --------------------------------------------------------------------


def _host_planes(kind, rng, n=300):
    valid = rng.random(n) >= 0.1
    if kind == "dec":
        vals = np.array([decimal.Decimal(int(u)).scaleb(-2) if ok else decimal.Decimal(0)
                         for u, ok in zip(rng.integers(-10 ** 6, 10 ** 6, n), valid)],
                        dtype=object)
    elif kind == "f64":
        vals = rng.standard_normal(n) * 1e3
        vals[rng.random(n) < 0.03] = np.nan
    elif kind == "f32":
        vals = (rng.standard_normal(n) * 1e3).astype(np.float32)
    else:
        vals = rng.integers(-1000, 1000, n).astype({"i64": np.int64, "i32": np.int32}[kind])
    if vals.dtype != object:
        vals = np.where(valid, vals, 0)
    seg = rng.random(n) < 0.05
    return vals, valid, seg


@pytest.mark.parametrize("kind", ["i64", "i32", "f64", "f32", "dec"])
def test_host_scans_match_reference(kind):
    rng = np.random.default_rng(len(kind) * 7 + ord(kind[0]))
    vals, valid, seg = _host_planes(kind, rng)
    carry = vals[3] if kind != "dec" else decimal.Decimal("1.25")
    for args in ((), (carry, 4)):
        want = JK.segment_cumsum(vals, valid, seg, *args)
        got = K.segment_cumsum(vals, valid, seg, *args)
        for w, g in zip(want, got):
            if w.dtype == object:
                assert list(w) == list(g)
            else:
                _same(w, g)
    for is_min in (True, False):
        for c in (None, carry):
            want = JK.segment_running_reduce(vals, valid, seg, is_min, c)
            got = K.segment_running_reduce(vals, valid, seg, is_min, c)
            if want.dtype == object:
                assert list(want) == list(got)
            else:
                _same(want, got)


# -- plan level ----------------------------------------------------------------------


def _arrow_col(dt, data, valid):
    if isinstance(dt, JT.DecimalType):
        vals = [decimal.Decimal(int(x)).scaleb(-dt.scale) for x in data]
        return pa.array(vals, type=pa.decimal128(dt.precision, dt.scale), mask=~valid)
    return pa.array(data, mask=~valid)


def _canon(d):
    """Floats by repr (-0.0 and nan spelled out), everything else as is."""
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _scan_calls(monkeypatch):
    """Calls of each package's device scan entry point."""
    calls = {"jax": 0, "port": 0}
    for mod, key in ((JK, "jax"), (K, "port")):
        orig = mod.segment_scan_planes

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, "segment_scan_planes", counted)
    return calls


def _run_both(plan, schemas, parts, tmp_path, batch_size=8192):
    """The plan's result in both packages over the same batches: ``parts``
    maps a resource to its partitions, each a list of {column: (data,
    validity)} batches; ``schemas`` maps it to its reference schema."""
    clear_build_cache()
    with JaxSession(conf=JaxConfig(batch_size=batch_size, shm_dir=str(tmp_path))) as s:
        for rid, plist in parts.items():
            sch = schemas[rid]
            s.resources[rid] = lambda p, _pl=plist, _s=sch: [
                pa.record_batch([_arrow_col(f.dtype, *b[f.name]) for f in _s.fields],
                                names=_s.names) for b in _pl[p]]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=batch_size), device="cpu")
    for rid, plist in parts.items():
        port.resources[rid] = lambda p, _pl=plist: _pl[p]
    got = port.execute_to_pydict(from_foreign(plan))
    return _canon(want), _canon(got)


def _batches(cols, cuts):
    """{column: data or (data, validity)} split at ``cuts`` into batches."""
    planes = {}
    for k, v in cols.items():
        d, valid = v if isinstance(v, tuple) else (np.asarray(v), None)
        d = np.asarray(d)
        valid = np.ones(len(d), bool) if valid is None else np.asarray(valid, bool)
        zero = np.zeros((), d.dtype)
        planes[k] = (np.where(valid, d, zero), valid)
    n = len(next(iter(planes.values()))[0])
    edges = [0] + list(cuts) + [n]
    return [{k: (d[a:b], v[a:b]) for k, (d, v) in planes.items()}
            for a, b in zip(edges, edges[1:]) if b > a]


def _window(schema, wexprs, pkeys, okeys=(), group_limit=None, desc=False):
    order = [JE.SortOrder(C(k), ascending=not desc) for k in okeys]
    return JN.Window(JN.FFIReader(schema, "src", 1), wexprs, [C(k) for k in pkeys], order,
                     group_limit=group_limit)


def _agg(name, fn, arg=None, frame=None, dt=None):
    return JN.WindowExpr("agg", name, JE.AggExpr(fn, [] if arg is None else [arg], dt),
                         frame=frame)


def _check(plan, schema, cols, cuts, tmp_path, monkeypatch, scans=None):
    """Run ``plan`` over ``cols`` split at ``cuts`` in both packages: equal
    results, order included, and the same device-scan calls (``scans``:
    whether there must be any)."""
    calls = _scan_calls(monkeypatch)
    want, got = _run_both(plan, {"src": schema}, {"src": [_batches(cols, cuts)]}, tmp_path)
    assert got == want
    assert calls["port"] == calls["jax"], calls
    if scans is not None:
        assert (calls["port"] > 0) == scans, calls
    return got


_GOV = JT.Schema.of(("g", JT.I64), ("o", JT.I64), ("v", JT.F64))
_DATA = {"g": [1, 1, 1, 2, 2, 3], "o": [10, 20, 20, 5, 6, 9],
         "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])}
_INT = JT.Schema.of(("g", JT.I64), ("o", JT.I64), ("v", JT.I64))


def _running(fn, name="a"):
    return [_agg(name, fn, C("v"))]


# test_window_generate.py:30-66 and :122-157
_GENERATE = {
    "counters_and_running_sum": (
        _GOV, _DATA, (3,), ["g"], ["o"],
        [JN.WindowExpr("row_number", "rn"), JN.WindowExpr("rank", "rk"),
         JN.WindowExpr("dense_rank", "dr"), _agg("rsum", F.SUM, C("v"))], None, True),
    "group_limit_with_aggregates": (
        _GOV, _DATA, (3,), ["g"], ["o"],
        [JN.WindowExpr("row_number", "rn"), _agg("rsum", F.SUM, C("v")),
         _agg("ravg", F.AVG, C("v"))], 2, True),
    "partition_spans_batches": (
        _INT, {"g": [1] * 10 + [2] * 6, "o": list(range(10)) + list(range(6)),
               "v": list(range(16))}, (4, 8, 12), ["g"], ["o"],
        [JN.WindowExpr("row_number", "rn"), _agg("rs", F.SUM, C("v"))], None, True),
    "peers_span_batches": (
        _GOV, {"g": [1, 1, 1, 1], "o": [10, 20, 20, 20], "v": np.array([1.0, 2.0, 3.0, 4.0])},
        (2,), ["g"], ["o"], [_agg("rsum", F.SUM, C("v"))], None, True),
    "whole_partition_spans_batches": (
        _GOV, {"g": [1, 1, 1, 1, 2], "o": [0] * 5, "v": np.array([1.0, 2.0, 3.0, 4.0, 9.0])},
        (3,), ["g"], [], [_agg("tot", F.SUM, C("v")), _agg("mx", F.MAX, C("v"))], None, True),
    "running_min_with_nulls": (
        _GOV, {"g": [1, 1, 1], "o": [1, 2, 3],
               "v": (np.array([0.0, 5.0, 3.0]), np.array([False, True, True]))},
        (), ["g"], ["o"], [_agg("rmin", F.MIN, C("v")), _agg("rcnt", F.COUNT, C("v"))],
        None, True),
    # a batch with no boundary (the middle one) and a boundary at row 0
    "no_boundary_and_boundary_at_row_0": (
        _GOV, {"g": [1] * 3 + [2] * 9 + [3] * 2, "o": [0] * 14,
               "v": np.arange(14, dtype=np.float64) * 1.1},
        (3, 6, 9), ["g"], [],
        [_agg("s", F.SUM, C("v")), _agg("a", F.AVG, C("v")), _agg("c", F.COUNT, C("v")),
         _agg("mn", F.MIN, C("v"))], None, True),
    "no_partition_spec": (
        _GOV, _DATA, (2, 4), [], ["o"],
        [_agg("s", F.SUM, C("v")), JN.WindowExpr("rank", "rk")], None, True),
    "count_star_and_min_max_only": (
        _GOV, _DATA, (2,), ["g"], ["o"],
        [_agg("n", F.COUNT), _agg("mn", F.MIN, C("v")), _agg("mx", F.MAX, C("v"))], None,
        False),
}


@pytest.mark.parametrize("name", sorted(_GENERATE))
def test_default_frames_match_reference(name, tmp_path, monkeypatch):
    schema, cols, cuts, pkeys, okeys, wexprs, limit, scans = _GENERATE[name]
    _check(_window(schema, wexprs, pkeys, okeys, limit), schema, cols, cuts, tmp_path,
           monkeypatch, scans)


# test_window_generate.py:172-206 and :282-379: explicit frames
_FRAMES = {
    "rows_sliding_sum": (
        {"g": [1] * 6, "o": list(range(6)), "v": [1, 2, 3, 4, 5, 6]}, False,
        [_agg("s", F.SUM, C("v"), ("rows", -2, 0))]),
    "rows_min_max_following": (
        {"g": [1] * 5 + [2] * 3, "o": list(range(5)) + list(range(3)),
         "v": [5, 1, 4, 2, 3, 9, 7, 8]}, False,
        [_agg("mn", F.MIN, C("v"), ("rows", -1, 1)),
         _agg("mx", F.MAX, C("v"), ("rows", 0, None)),
         _agg("av", F.AVG, C("v"), ("rows", None, 0)),
         _agg("ct", F.COUNT, C("v"), ("rows", -3, -1))]),
    "range_value_windows": (
        {"g": [1] * 6, "o": [1, 2, 2, 5, 6, 10], "v": [1, 10, 100, 1000, 10000, 100000]},
        False, [_agg("s", F.SUM, C("v"), ("range", -2, 1))]),
    "range_nulls": (
        {"g": [1] * 5, "o": ([0, 1, 2, 5, 6], [False, True, True, True, True]),
         "v": [7, 1, 10, 100, 1000]}, False,
        [_agg("s", F.SUM, C("v"), ("range", -1, 0))]),
    "range_descending": (
        {"g": [1] * 3, "o": [6, 5, 1], "v": [1000, 100, 1]}, True,
        [_agg("s", F.SUM, C("v"), ("range", -1, 0))]),
    "range_minmax_peers": (
        {"g": [1, 1, 1], "o": [1, 2, 2], "v": [5, 1, 3]}, False,
        [_agg("mn", F.MIN, C("v"), ("range", 0, 0))]),
    "range_all_null_keys": (
        {"g": [1, 1], "o": ([0, 0], [False, False]), "v": [4, 9]}, False,
        [_agg("s", F.SUM, C("v"), ("range", -1, 0))]),
    "range_unbounded_includes_null_run": (
        {"g": [1, 1, 1], "o": ([0, 1, 2], [False, True, True]), "v": [7, 1, 10]}, False,
        [_agg("s", F.SUM, C("v"), ("range", None, 1)),
         _agg("mx", F.MAX, C("v"), ("range", None, 1))]),
    "rows_partitions_span_batches_with_counters": (
        {"g": [1] * 7 + [2] * 5 + [3] * 4, "o": list(range(16)),
         "v": ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3], [True] * 15 + [False])},
        False, [JN.WindowExpr("row_number", "rn"), JN.WindowExpr("dense_rank", "dr"),
                _agg("s", F.SUM, C("v"), ("rows", -1, 1)),
                _agg("a", F.AVG, C("v"), ("rows", -2, 2))]),
}


@pytest.mark.parametrize("name", sorted(_FRAMES))
def test_explicit_frames_match_reference(name, tmp_path, monkeypatch):
    cols, desc, wexprs = _FRAMES[name]
    cuts = (6, 11) if name == "rows_partitions_span_batches_with_counters" else ()
    _check(_window(_INT, wexprs, ["g"], ["o"], desc=desc), _INT, cols, cuts, tmp_path,
           monkeypatch, False)


def test_explicit_frame_with_group_limit_and_floats(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    n = 300
    g = np.sort(rng.integers(0, 12, n))
    o = np.concatenate([np.sort(rng.integers(0, 40, c)) for c in np.bincount(g, minlength=12)])
    v = (rng.standard_normal(n) * 100, rng.random(n) >= 0.1)
    wexprs = [JN.WindowExpr("row_number", "rn"),
              _agg("s", F.SUM, C("v"), ("rows", -3, 0)),
              _agg("mx", F.MAX, C("v"), ("range", -5, 5)),
              _agg("mn", F.MIN, C("v"), ("rows", None, None))]
    _check(_window(_GOV, wexprs, ["g"], ["o"], group_limit=10), _GOV,
           {"g": g, "o": o, "v": v}, (70, 150, 151, 260), tmp_path, monkeypatch, False)


# test_segmented_window.py:224-327


def test_cross_batch_partitions(tmp_path, monkeypatch):
    """700 rows of 9 groups over 7 batches: counters + RANGE-default SUM,
    AVG and COUNT of a nullable float column."""
    rng = np.random.default_rng(23)
    n = 700
    g = np.sort(rng.integers(0, 9, n))
    o = np.concatenate([np.sort(rng.integers(0, 12, c)) for c in np.bincount(g, minlength=9)])
    v = (rng.integers(1, 100, n).astype(np.float64), rng.random(n) >= 0.1)
    wexprs = [JN.WindowExpr("row_number", "rn"), JN.WindowExpr("rank", "rk"),
              JN.WindowExpr("dense_rank", "dr"), _agg("rsum", F.SUM, C("v")),
              _agg("ravg", F.AVG, C("v")), _agg("rcnt", F.COUNT, C("v"))]
    _check(_window(_GOV, wexprs, ["g"], ["o"]), _GOV, {"g": g, "o": o, "v": v},
           list(range(100, 700, 100)), tmp_path, monkeypatch, True)


def test_null_partition_keys_are_distinct_partitions(tmp_path, monkeypatch):
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I64), ("o", JT.I64))
    cols = {"a": ([1, 1, 2, 2, 0], [True, True, True, True, False]),
            "b": ([0] * 5, [False] * 5), "o": [1, 2, 1, 2, 1]}
    wexprs = [JN.WindowExpr("row_number", "rn"), _agg("s", F.SUM, C("o")),
              _agg("mx", F.MAX, C("o"))]
    got = _check(_window(schema, wexprs, ["a", "b"], ["o"]), schema, cols, (2,), tmp_path,
                 monkeypatch, True)
    assert got["rn"] == [1, 2, 1, 2, 1]


def test_many_small_partitions(tmp_path, monkeypatch):
    """The q47/q89-class shape: thousands of 4-row partitions, rank and a
    running integer SUM and a whole-partition AVG."""
    groups, per = 5000, 4
    n = groups * per
    rng = np.random.default_rng(5)
    cols = {"g": np.repeat(np.arange(groups), per), "o": np.tile([1, 2, 2, 3], groups),
            "v": rng.integers(1, 1000, n)}
    plan = _window(_INT, [JN.WindowExpr("rank", "rk"), _agg("rsum", F.SUM, C("v"))],
                   ["g"], ["o"])
    got = _check(plan, _INT, cols, (7001, 14002), tmp_path, monkeypatch, True)
    sums = cols["v"].reshape(groups, per).cumsum(axis=1)
    assert got["rsum"] == sums[:, [0, 2, 2, 3]].reshape(-1).tolist()
    plan = _window(_INT, [_agg("avg", F.AVG, C("v"))], ["g"])
    _check(plan, _INT, cols, (7001, 14002), tmp_path, monkeypatch, True)


@pytest.mark.parametrize("kind", ["rank", "dense_rank", "row_number"])
def test_group_limit_trims_before_emit(kind, tmp_path, monkeypatch):
    cols = {"g": [1, 1, 1, 1, 2, 2, 2], "o": [1, 2, 2, 3, 5, 5, 6], "v": [1, 2, 3, 4, 5, 6, 7]}
    wexprs = [JN.WindowExpr(kind, "rk"), _agg("s", F.SUM, C("v")), _agg("a", F.AVG, C("v"))]
    _check(_window(_INT, wexprs, ["g"], ["o"], group_limit=2), _INT, cols, (2, 5), tmp_path,
           monkeypatch, True)


# argument types and routes

_TYPED = JT.Schema.of(("g", JT.I64), ("o", JT.I64), ("i", JT.I32), ("f", JT.F32),
                      ("d", JT.F64), ("m", JT.DecimalType(7, 2)))


def _typed_cols(rng, n=400):
    g = np.sort(rng.integers(0, 15, n))
    d = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 6, n)
    d[rng.random(n) < 0.02] = np.nan
    return {"g": g, "o": np.concatenate([np.sort(rng.integers(0, 9, c))
                                         for c in np.bincount(g, minlength=15)]),
            "i": (rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32), rng.random(n) >= 0.1),
            "f": ((rng.standard_normal(n) * 1e4).astype(np.float32), rng.random(n) >= 0.1),
            "d": (d, rng.random(n) >= 0.1),
            "m": (rng.integers(-10 ** 6, 10 ** 6, n), rng.random(n) >= 0.1)}


_ROUTES = {
    # argument -> whether the reference (and so the port) scans on the device
    "int32": (C("i"), True),
    "float32": (C("f"), True),
    "float64_nan": (C("d"), True),
    "decimal": (C("m"), False),
    "literal": (JE.Literal(1.5, JT.F64), True),
    "computed": (JE.BinaryExpr(B.MUL, C("d"), JE.Literal(2.0, JT.F64)), True),
}


@pytest.mark.parametrize("ordered", [False, True], ids=["whole", "running"])
@pytest.mark.parametrize("arg", sorted(_ROUTES))
def test_argument_types_and_routes(arg, ordered, tmp_path, monkeypatch):
    expr, device = _ROUTES[arg]
    fns = [(F.SUM, "s"), (F.AVG, "a"), (F.COUNT, "c"), (F.MIN, "mn"), (F.MAX, "mx")]
    if arg == "literal":
        fns = fns[:3]
    wexprs = [JN.WindowExpr("agg", n, JE.AggExpr(fn, [expr])) for fn, n in fns]
    cols = _typed_cols(np.random.default_rng(len(arg) + 31 * ordered))
    _check(_window(_TYPED, wexprs, ["g"], ["o"] if ordered else []), _TYPED, cols,
           (100, 101, 333), tmp_path, monkeypatch, device)


def test_decimal_sum_and_avg_fit_18_digits(tmp_path, monkeypatch):
    """decimal(7,2): SUM is decimal(17,2), AVG decimal(11,6), both exact
    Decimal arithmetic on the host, AVG divided under the default context
    and quantized half-up, over default and ROWS frames."""
    rng = np.random.default_rng(72)
    cols = _typed_cols(rng)
    wexprs = [_agg("s", F.SUM, C("m")), _agg("a", F.AVG, C("m")),
              _agg("ra", F.AVG, C("m"), ("rows", -2, 1)), _agg("mx", F.MAX, C("m"))]
    got = _check(_window(_TYPED, wexprs, ["g"], ["o"]), _TYPED, cols, (150,), tmp_path,
                 monkeypatch, False)
    assert any(isinstance(x, decimal.Decimal) and x.as_tuple().exponent == -6
               for x in got["a"])


def test_wide_decimal_result_raises_naming_roadmap():
    schema = JT.Schema.of(("g", JT.I64), ("m", JT.DecimalType(12, 2)))
    plan = _window(schema, [_agg("s", F.SUM, C("m"))], ["g"])
    port = blaze_tpu_torch.Session(device="cpu")
    port.resources["src"] = lambda p: [{"g": np.array([1]), "m": np.array([5])}]
    with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
        port.execute_to_pydict(from_foreign(plan))


# the reference's float sums that Spark would give otherwise (ROADMAP.md
# Queue 3, "mirrors on purpose"): each partition's sum is a difference of
# global prefixes, in the argument's float type


@pytest.mark.parametrize("case", ["cancellation_after_1e16", "nan_after_inf",
                                  "float32_sums"])
def test_mirrored_float_sums(case, tmp_path, monkeypatch):
    if case == "float32_sums":
        schema = JT.Schema.of(("g", JT.I64), ("v", JT.F32))
        v = np.array([16777216.0, 1.0, 1.0, 2.0], np.float32)
        spark = [16777218.0] * 3 + [2.0]
    else:
        schema = JT.Schema.of(("g", JT.I64), ("v", JT.F64))
        big = 1e16 if case == "cancellation_after_1e16" else np.inf
        v = np.array([big, 1.0, 2.0, 3.0])
        spark = [big, 6.0, 6.0, 6.0]
    g = [1, 1, 1, 2] if case == "float32_sums" else [1, 2, 2, 2]
    got = _check(_window(schema, [_agg("s", F.SUM, C("v"))], ["g"]), schema,
                 {"g": g, "v": v}, (), tmp_path, monkeypatch, True)
    assert got["s"] != [repr(float(x)) for x in spark]
    if case == "cancellation_after_1e16":
        assert got["s"][1:] == ["4.0"] * 3
    elif case == "nan_after_inf":
        assert got["s"][1:] == ["nan"] * 3


# -- q89 -------------------------------------------------------------------------------

Q89_SMALL = {"store_sales": 200_000, "item": 2_000, "date_dim": 73_049, "store": 102}


def _q89_parts(host, schemas, parts, batch):
    out = {}
    for name, (cols, valids) in host.items():
        valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
        planes = {f.name: (c, v) for f, c, v in zip(schemas[name].fields, cols, valids)}
        n = len(cols[0])
        cuts = [n * p // parts for p in range(parts + 1)] if name == "store_sales" else [0, n]
        out[name] = [[{k: (d[s:min(s + batch, b)], v[s:min(s + batch, b)])
                       for k, (d, v) in planes.items()} for s in range(a, b, batch)]
                     for a, b in zip(cuts, cuts[1:])]
    return out


def _q89_filter_case(a, s):
    """q89's filter as Spark writes it: CASE WHEN avg <> 0 THEN abs(sum -
    avg) / avg ELSE null END > 0.1."""
    ratio = JE.BinaryExpr(B.DIV, JE.ScalarFunction("abs", [JE.BinaryExpr(B.SUB, s, a)],
                                                   JT.F64), a)
    case = JE.Case([(JE.Not(JE.BinaryExpr(B.EQ, a, JE.Literal(0.0, JT.F64))), ratio)],
                   JE.Literal(None, JT.F64))
    return JE.BinaryExpr(B.GT, case, JE.Literal(0.1, JT.F64))


def _q89_filter_or(a, s):
    """q89's filter as chip_smoke.py's q89_plan wrote it before the port
    evaluated CASE: (sum - avg) / avg > 0.1 OR (avg - sum) / avg > 0.1."""
    def over(x, y):
        return JE.BinaryExpr(B.GT, JE.BinaryExpr(B.DIV, JE.BinaryExpr(B.SUB, x, y), a),
                             JE.Literal(0.1, JT.F64))

    return JE.BinaryExpr(B.OR, over(s, a), over(a, s))


def test_q89_matches_jax_and_numpy(tmp_path, monkeypatch):
    """chip_smoke.py's q89 plan and data at 200,000 store_sales rows and
    2,000 items: three broadcast joins, the six-key two-stage SUM, the
    window AVG over four partition keys (through K13's entry point),
    Spark's CASE ... abs filter and the top 100; equal to the reference,
    order included, and to the numpy oracle, the window's every row too."""
    from blaze_tpu_torch.ops import window as W
    from chip_smoke import q89_host, q89_oracle, q89_plan, q89_schemas, q89_window_check

    host = q89_host(Q89_SMALL)
    check, info, window = q89_oracle(host)
    schemas = q89_schemas(JT)
    plan = q89_plan(schemas, JE, JN, JT, parts=4)
    calls = _scan_calls(monkeypatch)
    want, got = _run_both(plan, schemas, _q89_parts(host, schemas, 4, 8192), tmp_path)
    assert got == want
    assert calls["port"] == calls["jax"] >= 1
    assert info["window_rows"] > 500 and info["kept_rows"] > 100
    port = blaze_tpu_torch.Session(conf=Config(batch_size=8192), device="cpu")
    for rid, plist in _q89_parts(host, schemas, 4, 8192).items():
        port.resources[rid] = lambda p, _pl=plist: _pl[p]
    emitted = []
    segmented = W.WindowExec._execute_segmented

    def recorded(self, partition, ctx):
        for b in segmented(self, partition, ctx):
            emitted.append(b)
            yield b

    monkeypatch.setattr(W.WindowExec, "_execute_segmented", recorded)
    check(port.execute_to_pydict(from_foreign(plan)))
    q89_window_check(emitted, window)


def test_q89_filter_rewrite_keeps_the_reference_rows(tmp_path):
    """The reference gives the same rows under the plan's filter (Spark's
    CASE ... abs form, as chip_smoke.py's q89_plan carries it) and under
    the rewrite (sum - avg) / avg > 0.1 OR (avg - sum) / avg > 0.1 that
    the plan carried before, zero averages included (both NULL, so the
    row drops)."""
    from chip_smoke import q89_host, q89_plan, q89_schemas

    host = q89_host(Q89_SMALL)
    schemas = q89_schemas(JT)
    plan = q89_plan(schemas, JE, JN, JT, parts=4)
    kept = plan.child.child
    assert isinstance(kept.predicates[0].left, JE.Case)
    rewrite = JN.Filter(kept.child, [_q89_filter_or(C("avg_monthly_sales"), C("sum_sales"))])
    spark_plan = JN.Sort(plan.child, plan.sort_orders, fetch_limit=None)
    ours_plan = JN.Sort(JN.ShuffleExchange(rewrite, JN.SinglePartitioning(1)),
                        plan.sort_orders, fetch_limit=None)
    parts = _q89_parts(host, schemas, 4, 8192)
    outs = []
    for p in (spark_plan, ours_plan):
        clear_build_cache()
        with JaxSession(conf=JaxConfig(batch_size=8192, shm_dir=str(tmp_path))) as s:
            for rid, plist in parts.items():
                sch = schemas[rid]
                s.resources[rid] = lambda q, _pl=plist, _s=sch: [
                    pa.record_batch([_arrow_col(f.dtype, *b[f.name]) for f in _s.fields],
                                    names=_s.names) for b in _pl[q]]
            out = s.execute_to_pydict(p)
        outs.append(sorted(zip(*out.values())))
    assert outs[0] == outs[1] and len(outs[0]) > 100
    # a zero average: both forms are NULL there
    zero = JT.Schema.of(("s", JT.I64), ("a", JT.F64))
    src = JN.FFIReader(zero, "z", 1)
    rows = {"s": np.array([0, 5, 3]), "a": np.array([0.0, 0.0, 1.0])}
    for pred in (_q89_filter_case(C("a"), C("s")), _q89_filter_or(C("a"), C("s"))):
        with JaxSession(conf=JaxConfig(shm_dir=str(tmp_path))) as s:
            s.resources["z"] = lambda q: [pa.record_batch(
                [pa.array(rows["s"]), pa.array(rows["a"])], names=["s", "a"])]
            assert s.execute_to_pydict(JN.Filter(src, [pred]))["s"] == [3]


def test_window_count_of_a_bool_argument(tmp_path):
    """A reference fault the port does not mirror (ROADMAP.md Queue 3): the
    reference sends a bool argument down its numpy scans, whose
    ``fill_null(0)`` refuses a bool array; the port counts it."""
    schema = JT.Schema.of(("g", JT.I64), ("v", JT.F64))
    plan = _window(schema, [_agg("c", F.COUNT, JE.IsNotNull(C("v")))], ["g"])
    cols = {"g": [1, 1, 2], "v": (np.array([1.0, 0.0, 2.0]), np.array([True, False, True]))}
    with pytest.raises(pa.ArrowInvalid):
        _run_both(plan, {"src": schema}, {"src": [_batches(cols, ())]}, tmp_path)
    port = blaze_tpu_torch.Session(device="cpu")
    port.resources["src"] = lambda p: _batches(cols, ())
    assert port.execute_to_pydict(from_foreign(plan))["c"] == [2, 2, 1]
