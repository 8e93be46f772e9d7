"""Filter -> agg and join -> agg fusion (row 10) against the JAX package:
K18's plain version (``core/kernels.fused_agg_input_plain``) composed
with K3 and K10 over its live mask, and the plans whose partial aggregate
absorbs a Filter, a fused stage or unique-key inner broadcast joins.

- The fused partial aggregate, batch by batch: chip_smoke.py's K18 battery
  (``K18_CASES``: one to three chained joins, int64/int32/f32/f64 keys with
  +-0.0 and NaN payloads, null and padding probe rows, an empty build, one
  build key, the build on the left, predicates over the joined schema,
  absorbed steps, q01's decimal predicate, every row filtered, an empty
  batch, q17's wide-decimal argument) through the reference's
  ``DevicePartialAgger`` with ``fused_join``/``fused_predicates``/
  ``fused_steps`` (its ``_probe_fn``, ``_dense_call`` and ``_fused_fn``
  on the CPU) and through the port's, on the dense, radix and sort
  routes, with sum2, sum3, minw and maxw limb arguments; and one stream
  whose batches walk the routes (dense, a range overflow and its re-plan,
  a batch whose kept rows hold no valid key, the radix table, then a
  plan past every table).
- Plans through both Sessions, order included: q01, q06, q47, q17 on its
  three routes, q89 and q98 at small sizes, with ``fused_filter_agg``
  None, True and False on the port against the reference under each.
- The JAX package's tests/test_fused_join_agg.py (all seven cases, over
  FFIReader sources: the port has no parquet) and test_agg.py's
  test_fused_filter_agg_matches_unfused, on the port.
- A ScalarFunction predicate leaves the aggregate unfused (same values);
  a duplicate-key build declines and its probe reuses the loaded map;
  every generated K18 source parses.

Tolerance: none. Every value is an integer, a decimal, or a float
compared by its repr (-0.0 and NaN spelled out).
"""

import ast
import dataclasses
import decimal
import itertools
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops import agg as JAGG
from blaze_tpu.ops import agg_device as JAD
from blaze_tpu.ops.base import Operator as JOperator
from blaze_tpu.ops.joins.bhj import clear_build_cache
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs import fused_triton as FT
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ops import agg as AGG
from blaze_tpu_torch.ops import agg_device as AD
from blaze_tpu_torch.ops.joins import keymap as KM
from chip_smoke import K18_CASES, k18_case, k18_spec, k18_torch

ROUTES = (KM.RANK_DENSE, KM.RANK_BITMAP, KM.RANK_SEARCH)
from tests.test_torch_joins import BATCH, SALES17, SCHEMAS, _q06, _q17, _q47, _slices, \
    _tables, _tables_wcost
from tests.test_torch_slice import SCHEMA as Q01_SCHEMA
from tests.test_torch_slice import _data as q01_data
from tests.test_torch_slice import _q01
from tests.test_torch_window_agg import _canon, _q89_parts

torch.set_num_threads(1)

F = JE.AggFunction
C = JE.Column
MODES = (None, True, False)
_EXACT = decimal.Context(prec=80)


# -- both packages over the same batches ---------------------------------------------


def _arrow_col(dt, data, valid):
    """A pyarrow column of a batch's (data, valid) planes: a decimal(19..38)
    from its (lo_raw, hi) words or its int64 values, a decimal from its
    unscaled ints, anything else as numpy gives it."""
    if isinstance(dt, JT.DecimalType):
        if data.ndim == 2:
            ints = [(int(hi) << 64) + (int(lo) & ((1 << 64) - 1)) for lo, hi in data]
        else:
            ints = [int(x) for x in data]
        return pa.array([_EXACT.scaleb(decimal.Decimal(x), -dt.scale) if ok else None
                         for x, ok in zip(ints, valid)],
                        type=pa.decimal128(dt.precision, dt.scale))
    return pa.array(data, mask=~np.asarray(valid, bool))


def _record(schema, cols):
    return pa.record_batch([_arrow_col(f.dtype, *cols[f.name]) for f in schema.fields],
                           names=schema.names)


def _reference(plan, schemas, parts, tmp_path, mode, batch, **conf):
    """The plan on the reference under ``fused_filter_agg=mode``: (result,
    its fused_join_stages)."""
    clear_build_cache()
    jconf = JaxConfig(batch_size=batch, shm_dir=str(tmp_path), fused_filter_agg=mode, **conf)
    with JaxSession(conf=jconf) as s:
        for rid, plist in parts.items():
            s.resources[rid] = lambda p, _pl=plist, _s=schemas[rid]: [
                _record(_s, b) for b in _pl[p]]
        return s.execute_to_pydict(plan), s.metrics.total("fused_join_stages")


def _port(plan, parts, batch, mode, **conf):
    """The plan on the port's CPU Session: (result, its counters, the
    number of fused aggregate inputs it computed)."""
    calls = [0]
    fn = K.fused_agg_input_plain

    def counted(*a):
        calls[0] += 1
        return fn(*a)

    K.fused_agg_input_plain = counted
    try:
        s = blaze_tpu_torch.Session(conf=Config(batch_size=batch, fused_filter_agg=mode, **conf),
                                    device="cpu")
        for rid, plist in parts.items():
            s.resources[rid] = lambda p, _pl=plist: _pl[p]
        return s.execute_to_pydict(from_foreign(plan)), dict(s.counters), calls[0]
    finally:
        K.fused_agg_input_plain = fn


def _sliced(tables, batch):
    return {rid: [_slices(part, batch) for part in parts] for rid, parts in tables.items()}


# -- the paths -----------------------------------------------------------------------

SMALL = {"q89": {"store_sales": 40_000, "item": 2_000, "date_dim": 73_049, "store": 102},
         "q98": {"store_sales": 40_000, "item": 2_000, "date_dim": 73_049}}


def _path(query):
    """(plan, schemas, partitions of batches, batch size, extra config, the
    number of joins its partial aggregate absorbs)."""
    if query == "q01":
        parts = {"store_returns": [_slices(p, 1000) for p in q01_data(seed=1, nulls=0.05)]}
        return _q01(), {"store_returns": Q01_SCHEMA}, parts, 1024, {}, 0
    if query in ("q06", "q47"):
        plan = {"q06": _q06, "q47": _q47}[query]()
        tables = _tables(seed=len(query), qty_hi=4 if query == "q47" else 100)
        return plan, SCHEMAS, _sliced(tables, BATCH), BATCH, {}, 1
    if query.startswith("q17"):
        conf = {"q17": {}, "q17_sort": dict(dense_agg=False, radix_agg=False),
                "q17_table": dict(device_merge_max_bytes=1)}[query]
        return _q17(), dict(SCHEMAS, store_sales=SALES17), \
            _sliced(_tables_wcost(seed=17), BATCH), BATCH, conf, 2
    import chip_smoke as CS

    if query == "q89":
        host = CS.q89_host(SMALL["q89"])
        schemas = CS.q89_schemas(JT)
        return CS.q89_plan(schemas, JE, JN, JT, parts=4), schemas, \
            _q89_parts(host, schemas, 4, 4096), 4096, {}, 3
    host = CS.q98_host(SMALL["q98"])
    schemas = CS.q98_schemas(JT)
    return CS.q98_plan(schemas, JE, JN, JT, parts=4), schemas, \
        _q89_parts(host, schemas, 4, 4096), 4096, dict(dense_agg=False, radix_agg=False), 2


PATHS = ("q01", "q06", "q47", "q17", "q17_sort", "q17_table", "q89", "q98")
_REFS = {}


@pytest.mark.parametrize("mode", MODES, ids=["default", "on", "off"])
@pytest.mark.parametrize("query", PATHS)
def test_paths_match_jax(query, mode, tmp_path):
    """Each path on the port under ``fused_filter_agg`` None, True and
    False equals the reference's result under each of the three, order
    included; the reference fuses its joins under None and True. The port
    computes one fused input a batch in its fused modes and none under
    False, and counts the absorbed joins."""
    plan, schemas, parts, batch, conf, njoins = _path(query)
    if query not in _REFS:
        _REFS[query] = {m: _reference(plan, schemas, parts, tmp_path, m, batch, **conf)
                        for m in MODES}
    got, counters, calls = _port(plan, parts, batch, mode, **conf)
    for m, (want, ref_fused) in _REFS[query].items():
        assert _canon(got) == _canon(want), f"reference fused_filter_agg={m}"
        assert (ref_fused > 0) == (njoins > 0 and m is not False)
    assert len(next(iter(got.values()))) > 0
    if mode is False:
        assert calls == 0 and not counters.get("fused_join_stages")
    else:
        fact = parts["store_sales" if njoins else "store_returns"]
        assert calls == sum(len(p) for p in fact)
        assert counters.get("fused_join_stages", 0) == njoins * len(fact)
    for kernel in FT._AGG_KERNELS.values():  # every K18 generated so far parses,
        for routes in itertools.product(ROUTES, repeat=len(kernel.spec.joins)):  # any routes
            ast.parse(kernel.source_for(routes))


# -- batch by batch: the fused partial aggregate of both packages ----------------------


class _JSource(JOperator):
    def __init__(self, schema):
        super().__init__(schema, [])


def _fn(name):
    return {"count": F.COUNT, "sum": F.SUM, "min": F.MIN, "max": F.MAX}[name]


def _aggs(d, E_, N_, T_):
    """The case's aggregates as PARTIAL AggColumns, plus a two-limb SUM
    (sum2) of a decimal(7,2) argument into decimal(27,2) and the wide
    extremes (minw, maxw) where the case has such arguments."""
    out = []
    for i, (fn, arg) in enumerate(d["aggs"]):
        args = [] if arg is None else [arg]
        out.append(N_.AggColumn(E_.AggExpr(getattr(E_.AggFunction, fn.upper()), args),
                                E_.AggMode.PARTIAL, f"a{i}"))
        if arg is None:
            continue
        at = E_.infer_type(arg, d["child"])
        if isinstance(at, T_.DecimalType) and at.precision <= 18:
            out.append(N_.AggColumn(E_.AggExpr(E_.AggFunction.SUM, args,
                                               T_.DecimalType(27, at.scale)),
                                    E_.AggMode.PARTIAL, f"a{i}_sum2"))
        if isinstance(at, T_.DecimalType) and at.precision > 18:
            for fn2 in ("MIN", "MAX"):
                out.append(N_.AggColumn(E_.AggExpr(getattr(E_.AggFunction, fn2), args),
                                        E_.AggMode.PARTIAL, f"a{i}_{fn2.lower()}w"))
    return out


def _jax_batch(schema, cols, n, cap):
    return JBatch.from_arrow(_record(schema, {f.name: (c[0][:n], c[1][:n])
                                              for f, c in zip(schema.fields, cols)}),
                             schema, capacity=cap)


def _jax_agger(d, cap, **conf):
    """The reference's DevicePartialAgger of a battery case, its joins' maps
    as the build map gives them (sorted unique words, code c at row c)."""
    groupings = [(f"k{i}", e) for i, e in enumerate(d["groupings"])]
    op = JAGG.AggExec(_JSource(d["child"]), JE.AggExecMode.HASH_AGG, groupings,
                      _aggs(d, JE, JN, JT))
    specs = []
    for (key, left, probe, build), (uniq, nk, bcols) in zip(d["joins"], d["builds"]):
        rows = min(nk + 1, len(bcols[0][0]))
        bmap = types.SimpleNamespace(
            sorted_keys=uniq[:nk], _dev_cell=[None],
            batch=_jax_batch(build, bcols, rows, len(bcols[0][0])))
        specs.append(JAD.FusedJoinSpec(None, bmap, key, left, probe, build))
    return JAD.DevicePartialAgger(
        op, d["child"], fused_predicates=list(d["preds"]) or None,
        conf=JaxConfig(**conf), fused_join=specs or None,
        fused_steps=d["steps"] or None, fused_input_schema=d["input"] if d["steps"] else None)


def _port_agger(d, **conf):
    spec, _cols, _n, joins = k18_torch(d, "cpu")
    groupings = [(f"k{i}", e) for i, e in enumerate(spec.groupings)]
    op = AGG.AggExec(AGG._SchemaSource(spec.child_schema), E.AggExecMode.HASH_AGG, groupings,
                     from_foreign(_aggs(d, JE, JN, JT)))
    fused = []
    for j, (uniq, nk, bcols, rank) in zip(spec.joins, joins):
        bmap = types.SimpleNamespace(sorted_keys=uniq[:nk].numpy(),
                                     device_keys=lambda dev, _u=uniq: _u,
                                     join_rank=lambda _r=rank: _r,
                                     batch=types.SimpleNamespace(columns=bcols))
        fused.append((j, bmap))
    return AD.DevicePartialAgger(op, spec.child_schema, Config(**conf),
                                 spec.predicates or None, fused, spec.steps or None,
                                 spec.input_schema if spec.steps else None)


def _outputs(jout, pout):
    if jout is None or pout is None:
        assert jout is None and pout is None, (jout, pout)
        return 0
    want, got = jout.to_pydict(), pout.to_pydict()
    assert _canon(got) == _canon(want)
    return len(next(iter(got.values())))


ROUTES = {"dense": dict(dense_agg=True, radix_agg=True),
          "radix": dict(dense_agg=False, radix_agg=True),
          "sort": dict(dense_agg=False, radix_agg=False)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", K18_CASES[:-1], ids=[c[0] for c in K18_CASES[:-1]])
def test_fused_partial_matches_jax(case, route):
    """One battery batch through both packages' fused partial aggregates
    (the reference's ``_probe_fn`` + ``_dense_call`` on the slot routes,
    ``_fused_fn`` on the sort route; the port's K18 plain version, then
    K3 or K10 over its live mask): the same partial states, in the same
    group order."""
    rng = np.random.default_rng(sum(map(ord, case[0])))
    d = k18_case(case, rng, JE, JT)
    cap = len(d["cols"][0][0])
    jagger = _jax_agger(d, cap, **ROUTES[route])
    pagger = _port_agger(d, **ROUTES[route])
    jb = _jax_batch(d["input"], d["cols"], d["n"], cap)
    _spec, cols, n, _joins = k18_torch(d, "cpu")
    groups = _outputs(jagger.process(jb), pagger.process(ColumnarBatch(
        from_foreign(d["input"]), cols, n)))
    kept = int(K.fused_agg_input_plain(*k18_torch(d, "cpu"))[2].sum())
    assert (groups > 0) == (kept > 0)


def test_route_changes_match_jax():
    """One stream through both packages' fused aggregates, grouped by a
    probe column behind the join, with small tables (64 dense buckets,
    4,096 radix slots): a first batch whose kept rows have no valid key
    (no plan: the sort route for it), the dense table, a key past it (a
    re-plan, still dense), a range only the radix table holds (a re-plan),
    a range past every table (the sort route for the rest of the stream),
    then a narrow range that stays there. Every batch's partial states and
    the plan each package holds after it are equal."""
    rng = np.random.default_rng(77)
    d = k18_case(("stream", 2048, 2000, "join"), rng, JE, JT)
    d["groupings"] = (C("v"),)
    d["aggs"] = (("count", None), ("sum", C("d_a1")))
    conf = dict(dense_agg_max_buckets=64, radix_agg_max_slots=4096)
    jagger = _jax_agger(d, 2048, **conf)
    pagger = _port_agger(d, **conf)
    live = np.arange(2048) < d["n"]
    states = []
    for hi, null in ((20, True), (20, False), (50, False), (3000, False), (1 << 40, False),
                     (10, False)):
        valid = live & (not null)
        d["cols"][1] = (np.where(valid, rng.integers(0, hi, 2048), 0), valid)
        _spec, cols, n, _joins = k18_torch(d, "cpu")
        _outputs(jagger.process(_jax_batch(d["input"], d["cols"], n, 2048)),
                 pagger.process(ColumnarBatch(from_foreign(d["input"]), cols, n)))
        assert jagger._bucket_state == pagger._bucket_state
        # the reference decides the radix switch only once the dense table
        # fails; the port decides both at the first batch
        assert jagger._dense_ok == pagger._dense_ok
        states.append(None if pagger._bucket_state is None else pagger._bucket_state[0])
    assert states == [None, "dense", "dense", "radix", None, None]
    assert pagger._dense_ok is False


# -- tests/test_fused_join_agg.py and test_agg.py, on the port ------------------------

FACT = JT.Schema.of(("fk", JT.I64), ("v", JT.I64))
DIM = JT.Schema.of(("pk", JT.I64), ("attr", JT.I64))


def _fact(rng, n, null_every=0):
    fk = rng.integers(1, 50, n)
    valid = np.ones(n, bool)
    if null_every:
        valid[::null_every] = False
    return {"fk": (np.where(valid, fk, 0), valid),
            "v": (rng.integers(-100, 100, n), np.ones(n, bool))}


def _dim(rng, dup=False):
    pks = list(range(1, 60)) + ([7, 7] if dup else [])
    return {"pk": (np.array(pks), np.ones(len(pks), bool)),
            "attr": (rng.integers(0, 5, len(pks)), np.ones(len(pks), bool))}


def _fja_plan(predicates=None, tag="fja_dim", fact=FACT):
    join = JN.BroadcastJoin(JN.FFIReader(fact, "fact", 2), JN.BroadcastExchange(
        JN.FFIReader(DIM, "dim", 1)), [(C("fk"), C("pk"))], JN.JoinType.INNER,
        JN.JoinSide.RIGHT, tag)
    src = JN.Filter(join, predicates) if predicates else join
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, []))]
    partial = JN.Agg(src, JE.AggExecMode.HASH_AGG, [("attr", C("attr"))],
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, n) for n, a in aggs])
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([C("attr")], 2))
    final = JN.Agg(ex, JE.AggExecMode.HASH_AGG, [("attr", C("attr"))],
                   [JN.AggColumn(a, JE.AggMode.FINAL, n) for n, a in aggs])
    return JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                   [JE.SortOrder(C("attr"))])


def _fja_parts(fact, dim, batch=4096):
    n = len(fact["fk"][0])
    halves = [{k: (d[a:b], v[a:b]) for k, (d, v) in fact.items()}
              for a, b in ((0, n // 2), (n // 2, n))]
    return {"fact": [_slices(h, batch) for h in halves], "dim": [[dim]]}


def _fja_oracle(fact, dim, keep=None):
    """SUM(v), COUNT(*) by attr over the inner join (each fact row once
    per matching dim row), ``keep`` a predicate on (v, attr)."""
    sums, counts = {}, {}
    rows = {}
    for pk, a in zip(dim["pk"][0].tolist(), dim["attr"][0].tolist()):
        rows.setdefault(pk, []).append(a)
    (fk, fv), (v, _) = fact["fk"], fact["v"]
    for k, ok, x in zip(fk.tolist(), fv.tolist(), v.tolist()):
        for a in rows.get(k, []) if ok else []:
            if keep is None or keep(x, a):
                sums[a] = sums.get(a, 0) + x
                counts[a] = counts.get(a, 0) + 1
    keys = sorted(sums)
    return {"attr": keys, "s": [sums[k] for k in keys], "c": [counts[k] for k in keys]}


def _fja_run(plan, parts, mode=None):
    got, counters, calls = _port(plan, parts, 4096, mode)
    return got, counters.get("fused_join_stages", 0), calls


def test_fused_join_agg_matches_oracle():
    rng = np.random.default_rng(7)
    fact, dim = _fact(rng, 20_000), _dim(rng)
    got, fused, _ = _fja_run(_fja_plan(tag="fja_t1"), _fja_parts(fact, dim))
    assert fused >= 1, "join fusion must engage on all-int star join"
    assert got == _fja_oracle(fact, dim)


def test_fused_join_agg_null_probe_keys():
    rng = np.random.default_rng(8)
    fact, dim = _fact(rng, 10_000, null_every=7), _dim(rng)
    got, fused, _ = _fja_run(_fja_plan(tag="fja_t2"), _fja_parts(fact, dim))
    assert fused >= 1
    assert got == _fja_oracle(fact, dim)


def test_fused_join_agg_with_filter_above_join():
    rng = np.random.default_rng(9)
    fact, dim = _fact(rng, 20_000), _dim(rng)
    preds = [JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(0, JT.I64))]
    got, fused, calls = _fja_run(_fja_plan(preds, tag="fja_t3"), _fja_parts(fact, dim))
    assert fused >= 1 and calls > 0, "filter + join fuse together"
    assert got == _fja_oracle(fact, dim, keep=lambda v, a: v > 0)


def test_duplicate_build_keys_fall_back_correctly(monkeypatch, tmp_path):
    """A duplicate-key build is statically eligible, loads, and declines at
    run time: nothing fuses, the unfused probe (the generic one: K9's
    plain version) reuses the map the aggregate loaded, built once for the
    query, and the result is the reference's and the oracle's."""
    rng = np.random.default_rng(10)
    fact, dim = _fact(rng, 5_000), _dim(rng, dup=True)
    builds = [0]
    build = KM.JoinHashMap.build

    def counted(*a, **k):
        builds[0] += 1
        return build(*a, **k)

    monkeypatch.setattr(KM.JoinHashMap, "build", staticmethod(counted))
    parts = _fja_parts(fact, dim)
    got, fused, calls = _fja_run(_fja_plan(tag="fja_t4"), parts)
    assert fused == 0 and calls == 0, "non-unique build keys must not fuse"
    assert builds[0] == 1
    assert got == _fja_oracle(fact, dim)
    want, ref_fused = _reference(_fja_plan(tag="fja_t4"), {"fact": FACT, "dim": DIM}, parts,
                                 tmp_path, None, 4096)
    assert got == want and ref_fused == 0


def test_non_device_probe_column_falls_back():
    """The reference's case puts a string column in the probe schema; the
    port has no string plane (Queue 1 item 6b), so a decimal(38,2) column,
    the probe side's other non-plane type, stands in: a wide probe column
    is allowed (its limbs pass through), the join fuses, and the result is
    the oracle's. A key over it could not fuse, nor run (item 6b)."""
    rng = np.random.default_rng(11)
    n = 5_000
    fact = _fact(rng, n)
    fact["tag"] = (np.stack([np.arange(n), np.zeros(n, np.int64)], 1), np.ones(n, bool))
    schema = JT.Schema.of(("fk", JT.I64), ("v", JT.I64), ("tag", JT.DecimalType(38, 2)))
    dim = _dim(rng)
    got, fused, _ = _fja_run(_fja_plan(tag="fja_dim2", fact=schema), _fja_parts(fact, dim))
    assert fused >= 1
    assert got == _fja_oracle(fact, dim)


def test_chained_star_joins_fuse(tmp_path):
    """Two stacked dimension joins fuse into one aggregate input (q17's
    star shape), with a decimal(38,2) SUM riding as limb planes; equal to
    the reference and to an exact oracle."""
    rng = np.random.default_rng(23)
    n = 30_000
    w = rng.integers(10 ** 17, 9 * 10 ** 17, n)
    fact = {"f1": (rng.integers(1, 40, n), np.ones(n, bool)),
            "f2": (rng.integers(1, 20, n), np.ones(n, bool)),
            "v": (rng.integers(-50, 50, n), np.ones(n, bool)),
            "w": (np.stack([w, np.zeros(n, np.int64)], 1), np.ones(n, bool))}
    dim1 = {"pk1": (np.arange(1, 40), np.ones(39, bool)),
            "a1": (rng.integers(0, 4, 39), np.ones(39, bool))}
    dim2 = {"pk2": (np.arange(1, 20), np.ones(19, bool)),
            "a2": (rng.integers(0, 3, 19), np.ones(19, bool))}
    fs = JT.Schema.of(("f1", JT.I64), ("f2", JT.I64), ("v", JT.I64),
                      ("w", JT.DecimalType(38, 2)))
    d1 = JT.Schema.of(("pk1", JT.I64), ("a1", JT.I64))
    d2 = JT.Schema.of(("pk2", JT.I64), ("a2", JT.I64))
    j1 = JN.BroadcastJoin(JN.FFIReader(fs, "fact", 2), JN.BroadcastExchange(
        JN.FFIReader(d1, "dim1", 1)), [(C("f1"), C("pk1"))], JN.JoinType.INNER,
        JN.JoinSide.RIGHT, "chain_d1")
    j2 = JN.BroadcastJoin(j1, JN.BroadcastExchange(JN.FFIReader(d2, "dim2", 1)),
                          [(C("f2"), C("pk2"))], JN.JoinType.INNER, JN.JoinSide.RIGHT,
                          "chain_d2")
    keys = [("a1", C("a1")), ("a2", C("a2"))]
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")])), ("ws", JE.AggExpr(F.SUM, [C("w")]))]
    partial = JN.Agg(j2, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, nm) for nm, a in aggs])
    final = JN.Agg(JN.ShuffleExchange(partial, JN.HashPartitioning([C("a1")], 2)),
                   JE.AggExecMode.HASH_AGG, keys,
                   [JN.AggColumn(a, JE.AggMode.FINAL, nm) for nm, a in aggs])
    plan = JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                   [JE.SortOrder(C("a1")), JE.SortOrder(C("a2"))])
    halves = [{k: (x[a:b], v[a:b]) for k, (x, v) in fact.items()}
              for a, b in ((0, n // 2), (n // 2, n))]
    parts = {"fact": [_slices(h, 4096) for h in halves], "dim1": [[dim1]], "dim2": [[dim2]]}
    got, counters, _ = _port(plan, parts, 4096, None)
    assert counters["fused_join_stages"] >= 4, "both joins should fuse on both partitions"
    want, _ = _reference(plan, {"fact": fs, "dim1": d1, "dim2": d2}, parts, tmp_path, None,
                         4096)
    assert got == want
    a1 = dim1["a1"][0][fact["f1"][0] - 1]
    a2 = dim2["a2"][0][fact["f2"][0] - 1]
    oracle = {}
    for x, y, v, wv in zip(a1.tolist(), a2.tolist(), fact["v"][0].tolist(), w.tolist()):
        s, t = oracle.get((x, y), (0, 0))
        oracle[(x, y)] = (s + v, t + wv)
    keys_ = sorted(oracle)
    assert got == {"a1": [k[0] for k in keys_], "a2": [k[1] for k in keys_],
                   "s": [oracle[k][0] for k in keys_],
                   "ws": [_EXACT.scaleb(decimal.Decimal(oracle[k][1]), -2) for k in keys_]}


def test_expression_over_wide_column_blocks_fusion():
    """A device-typed expression over a decimal(38,2) column (a CAST) keeps
    the aggregate unfused in the reference; in the port such an expression
    is not ported (Queue 1 item 18) and raises naming it, fused or not."""
    rng = np.random.default_rng(29)
    n = 4000
    w = rng.integers(10 ** 17, 2 * 10 ** 17, n)
    fact = {"fk": (rng.integers(1, 40, n), np.ones(n, bool)),
            "w": (np.stack([w, np.zeros(n, np.int64)], 1), np.ones(n, bool))}
    dim = {"pk": (np.arange(1, 40), np.ones(39, bool)),
           "attr": (rng.integers(0, 4, 39), np.ones(39, bool))}
    fs = JT.Schema.of(("fk", JT.I64), ("w", JT.DecimalType(38, 2)))
    join = JN.BroadcastJoin(JN.FFIReader(fs, "fact", 2), JN.BroadcastExchange(
        JN.FFIReader(DIM, "dim", 1)), [(C("fk"), C("pk"))],
        JN.JoinType.INNER, JN.JoinSide.RIGHT, "fja_wexpr")
    partial = JN.Agg(join, JE.AggExecMode.HASH_AGG, [("attr", C("attr"))], [
        JN.AggColumn(JE.AggExpr(F.SUM, [JE.Cast(C("w"), JT.F64)]), JE.AggMode.PARTIAL, "s")])
    parts = {"fact": [[{k: (x[:n // 2], v[:n // 2]) for k, (x, v) in fact.items()}],
                      [{k: (x[n // 2:], v[n // 2:]) for k, (x, v) in fact.items()}]],
             "dim": [[dim]]}
    assert not AD.fusable_aggregate(
        types.SimpleNamespace(aggs=from_foreign(partial.aggs),
                              groupings=from_foreign(partial.groupings)),
        from_foreign(join.output_schema))
    for mode in MODES:
        with pytest.raises(NotImplementedError, match="item 18"):
            _port(partial, parts, 4096, mode)


def test_fused_filter_agg_matches_unfused():
    """test_agg.py's case: filter -> partial agg fused and unfused give the
    same result, null keys, null arguments and a rejecting predicate
    included, and the non-null groups equal an oracle."""
    rng = np.random.default_rng(11)
    n = 4000
    keys = rng.integers(0, 37, n)
    vals = rng.integers(-1000, 1000, n)
    kv = np.arange(n) % 13 != 0
    vv = np.arange(n) % 7 != 0
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    cols = {"k": (np.where(kv, keys, 0), kv), "v": (np.where(vv, vals, 0), vv)}
    parts = {"src": [[{c: (x[a:b], v[a:b]) for c, (x, v) in cols.items()}
                      for a, b in ((0, 1500), (1500, 3000), (3000, n))]]}
    filt = JN.Filter(JN.FFIReader(schema, "src", 1),
                     [JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(-500, JT.I64))])
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, [])),
            ("mn", JE.AggExpr(F.MIN, [C("v")]))]
    partial = JN.Agg(filt, JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, nm) for nm, a in aggs])
    final = JN.Agg(partial, JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                   [JN.AggColumn(a, JE.AggMode.FINAL, nm) for nm, a in aggs])
    plan = JN.Sort(final, [JE.SortOrder(C("k"))])
    outs = {}
    for mode in (True, False):
        outs[mode], _, calls = _port(plan, parts, 4096, mode)
        assert (calls > 0) == mode
    assert outs[True] == outs[False]
    keep = vv & (vals > -500)
    for i, k in enumerate(outs[True]["k"]):
        if k is None:
            continue
        rows = keep & kv & (keys == k)
        assert outs[True]["s"][i] == int(vals[rows].sum())
        assert outs[True]["c"][i] == int(rows.sum())
        assert outs[True]["mn"][i] == int(vals[rows].min())
    assert sorted(k for k in outs[True]["k"] if k is not None) == \
        sorted(set(keys[keep & kv].tolist()))


# -- what stays unfused, and the generated sources ------------------------------------


def test_scalar_function_predicate_stays_unfused(tmp_path):
    """A predicate K18 cannot generate (a ScalarFunction) leaves the
    aggregate unfused: no fused input, the Filter compacts (K1's plain
    version), the same values as the reference under both its modes."""
    rng = np.random.default_rng(5)
    n = 6000
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    cols = {"k": (rng.integers(0, 20, n), np.ones(n, bool)),
            "v": (rng.integers(-100, 100, n), np.ones(n, bool))}
    parts = {"src": [[{c: (x[a:a + 1000], v[a:a + 1000]) for c, (x, v) in cols.items()}
                      for a in range(0, n, 1000)]]}
    pred = JE.BinaryExpr(JE.BinaryOp.GT, JE.ScalarFunction("abs", [C("v")], JT.I64),
                         JE.Literal(10, JT.I64))
    partial = JN.Agg(JN.Filter(JN.FFIReader(schema, "src", 1), [pred]),
                     JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                     [JN.AggColumn(JE.AggExpr(F.SUM, [C("v")]), JE.AggMode.PARTIAL, "s")])
    plan = JN.Sort(JN.Agg(partial, JE.AggExecMode.HASH_AGG, [("k", C("k"))], [
        JN.AggColumn(JE.AggExpr(F.SUM, [C("v")]), JE.AggMode.FINAL, "s")]),
        [JE.SortOrder(C("k"))])
    assert not AD.supports_fused_filter(
        types.SimpleNamespace(predicates=[from_foreign(pred)]), from_foreign(schema))
    got, _, calls = _port(plan, parts, 1024, None)
    assert calls == 0
    for mode in (None, False):
        want, _ = _reference(plan, {"src": schema}, parts, tmp_path, mode, 1024)
        assert got == want
    v = cols["v"][0]
    assert got["s"] == [int(v[(cols["k"][0] == k) & (np.abs(v) > 10)].sum()) for k in got["k"]]


def test_absorbed_fused_stage_counts_and_matches_jax(tmp_path):
    """A projection over a filter under the partial aggregate becomes a
    fused stage of one segment, which the aggregate absorbs (its steps run
    in K18): fused_stages and fused_ops count on the session, and the
    result equals the reference's and the unfused port's."""
    rng = np.random.default_rng(3)
    n = 8000
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    cols = {"k": (rng.integers(0, 50, n), rng.random(n) >= 0.05),
            "v": (rng.integers(-100, 100, n), rng.random(n) >= 0.05)}
    cols = {c: (np.where(v, x, 0), v) for c, (x, v) in cols.items()}
    parts = {"src": [[{c: (x[a:a + 2000], v[a:a + 2000]) for c, (x, v) in cols.items()}
                      for a in range(p * 4000, (p + 1) * 4000, 2000)] for p in range(2)]}
    twice = JE.BinaryExpr(JE.BinaryOp.MUL, C("v"), JE.Literal(2, JT.I64))
    proj = JN.Projection(JN.Filter(JN.FFIReader(schema, "src", 2), [
        JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(-20, JT.I64))]),
        [C("k"), twice], ["k", "w"])
    agg = [("s", JE.AggExpr(F.SUM, [C("w")])), ("c", JE.AggExpr(F.COUNT, []))]
    partial = JN.Agg(proj, JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, nm) for nm, a in agg])
    final = JN.Agg(JN.ShuffleExchange(partial, JN.HashPartitioning([C("k")], 2)),
                   JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                   [JN.AggColumn(a, JE.AggMode.FINAL, nm) for nm, a in agg])
    plan = JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)), [JE.SortOrder(C("k"))])
    got, counters, calls = _port(plan, parts, 2048, None)
    assert counters["fused_stages"] == 2 and counters["fused_ops"] == 4 and calls == 4
    unfused, counters_off, _ = _port(plan, parts, 2048, False)
    assert got == unfused and not counters_off
    for mode in (None, False):
        want, _ = _reference(plan, {"src": schema}, parts, tmp_path, mode, 2048)
        assert got == want


def test_empty_dimension_fused_and_unfused():
    """An empty item table: the fused aggregate's probe (nk = 0, the
    one-word placeholder) hits nothing, as the unfused K8 path does: no
    rows either way."""
    tables = _tables(seed=9)
    tables["item"] = [{k: (d[:0], v[:0]) for k, (d, v) in tables["item"][0].items()}]
    parts = _sliced(tables, BATCH)
    for mode in MODES:
        got, counters, calls = _port(_q06(), parts, BATCH, mode)
        assert got == {"i_category_id": [], "qty": [], "revenue": []}
        assert (calls > 0) == (mode is not False)


@pytest.mark.parametrize("case", K18_CASES, ids=[c[0] for c in K18_CASES])
def test_generated_source_parses(case):
    """Every K18 of the battery generates Python that parses, with one
    load per input plane it reads and one gather per build plane a later
    expression reads; the kernel cache returns one kernel per spec."""
    spec, _cols, _n, joins = k18_torch(k18_case(case, np.random.default_rng(1), E, T), "cpu")
    kernel = FT.fused_agg_kernel(spec)
    assert FT.fused_agg_kernel(dataclasses.replace(spec)) is kernel
    source = kernel.source_for(tuple(j[3].route for j in joins))  # the routes its builds take
    tree = ast.parse(source)
    fn = [n for n in tree.body if isinstance(n, ast.FunctionDef) and
          n.name == "fused_agg_input"]
    assert len(fn) == 1
    gen = kernel.gen
    for j, used in enumerate(gen.join_used):
        for c in used:
            assert f"b{j}_{c}_ptr" in source or f"bv{j}_{c}_ptr" in source
    assert source.count("tl.store(") == len(gen.stores)
    for refused in ("source", "path"):  # no source without its joins' routes
        with pytest.raises(TypeError):
            getattr(kernel, refused)
    with pytest.raises(TypeError):
        kernel.compiled()
