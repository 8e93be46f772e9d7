"""The port's third slice against the JAX package: the unique-key inner
broadcast join (K8), its build map, and the q06, q47 and q17-join-chain
paths (fact scan -> broadcast join -> two-stage agg -> sort, and for q47
the rank window and its filter).

The same numpy inputs, drawn from a seed, go through the JAX function
(on the CPU, as the JAX package's own tests run it) and the port's plain
PyTorch twin; the plans go through ``blaze_tpu.Session`` — with its
default config, which fuses the join into the partial agg on the CPU,
and with ``fused_filter_agg=False``, its accelerator path through
``_inner_fast_kernel`` — and ``blaze_tpu_torch.Session(device="cpu")``.

Tolerance: none. Every plane is an integer, bool or float compared by
its bytes, and the plan results must be equal, order included. The JAX
package keeps its build-map cache process-wide, so every reference run
starts with ``clear_build_cache()``.
"""

import dataclasses
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins import bhj as JBHJ
from blaze_tpu.ops.joins import keymap as JKM
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import wide_words
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir.carry import columns_from_numpy, from_foreign
from blaze_tpu_torch.ops.joins import keymap as KM

torch.set_num_threads(1)

_SHM = {}


@pytest.fixture(autouse=True)
def _shm_in_tmp_path(tmp_path):
    """Each reference session's shm root goes under the test's tmp_path, not
    /dev/shm, where tests/test_zero_copy.py's glob would see it."""
    _SHM["dir"] = str(tmp_path)
    yield
    del _SHM["dir"]


def _jax_conf(conf=None):
    """A reference config with its shm root in the test's tmp_path."""
    return dataclasses.replace(conf or JaxConfig(), shm_dir=_SHM["dir"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bytes(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


# -- K8: the unique-key inner join ------------------------------------------------

_NP = {"i64": np.int64, "i32": np.int32, "f32": np.float32, "f64": np.float64}


def _bits(kind, words):
    """Float values from raw bit patterns (NaN payloads, -0.0)."""
    if kind == "f64":
        return np.array(words, np.uint64).view(np.float64)
    return np.array(words, np.uint32).view(np.float32)


def _float_pool(kind):
    """Values whose canonical words collide: +-0.0, NaN payloads of both
    signs (quiet and signalling), +-inf, ordinary values."""
    if kind == "f64":
        nans = _bits("f64", [0x7FF8000000000000, 0xFFF8000000000000,
                             0x7FF8000000000123, 0x7FF0000000000001])
    else:
        nans = _bits("f32", [0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001])
    vals = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.25, -1e30, 7.0, 3.0],
                    _NP[kind])
    return np.concatenate([vals, nans])


def _join_inputs(kind, cap_p, n, nk, cap_b, nulls, seed):
    """Sorted unique build words of ``nk`` keys (rank c = build row c),
    a build batch of capacity ``cap_b`` (rows past nk: one null-keyed
    row, then padding) and a probe batch of capacity ``cap_p`` with
    ``n`` live rows, about a third missing, some null."""
    rng = np.random.default_rng(seed)
    if kind in ("f32", "f64"):
        pool = _float_pool(kind)
        words = JKM._canon_words(pool)
        _, first = np.unique(words, return_index=True)
        distinct = pool[np.sort(first)]
        bvals = distinct[rng.permutation(len(distinct))[:nk]]
        misses = np.array([5.0, -7.5, 1e-3], _NP[kind])
        probe_pool = np.concatenate([pool, misses])  # every NaN payload, -0.0
    else:
        bvals = rng.choice(np.arange(-5000, 5000), nk, replace=False).astype(_NP[kind])
        if nk:
            bvals[0] = np.iinfo(_NP[kind]).min
        misses = rng.integers(-5000, 5000, 64).astype(_NP[kind])
        probe_pool = np.concatenate([np.tile(bvals, max(1, 64 // max(nk, 1))), misses])
    uniq = np.unique(JKM._canon_words(bvals)) if nk else np.zeros(0, np.int64)
    order = np.argsort(JKM._canon_words(bvals), kind="stable")
    bkey = np.zeros(cap_b, _NP[kind])
    bkey_v = np.zeros(cap_b, bool)
    bkey[:nk] = bvals[order]
    bkey_v[:nk] = True
    bpay = np.zeros(cap_b, np.int64)
    bpay_v = np.zeros(cap_b, bool)
    nb = min(nk + 1, cap_b)  # a null-keyed build row at the tail
    bpay[:nb] = rng.integers(-10**12, 10**12, nb)
    bpay_v[:nb] = rng.random(nb) >= 0.2
    bpay[~bpay_v] = 0
    bflag = np.zeros(cap_b, bool)
    bflag[:nb] = rng.random(nb) < 0.5
    build = [(bkey, bkey_v), (bpay, bpay_v), (bflag, np.arange(cap_b) < nb)]

    pk = np.zeros(cap_p, _NP[kind])
    pk_v = np.zeros(cap_p, bool)
    if len(probe_pool):
        pk[:n] = probe_pool[rng.integers(0, len(probe_pool), n)]
    pk_v[:n] = rng.random(n) >= nulls
    pk[~pk_v] = 0
    pi32 = np.where(np.arange(cap_p) < n, rng.integers(-99, 99, cap_p), 0).astype(np.int32)
    pdec = np.where(np.arange(cap_p) < n, rng.integers(0, 10**6, cap_p), 0)
    pdec_v = (rng.random(cap_p) >= 0.1) & (np.arange(cap_p) < n)
    pdec[~pdec_v] = 0
    pbool = (rng.random(cap_p) < 0.5) & (np.arange(cap_p) < n)
    live = np.arange(cap_p) < n
    probe = [(pk, pk_v), (pi32, live), (pdec, pdec_v), (pbool, live)]
    return uniq, build, probe


def _run_k8(uniq, nk, n, key, probe, build, key_kind):
    cap_p, cap_b = len(probe[0][0]), len(build[0][0])
    jker = JBHJ._inner_fast_kernel(
        np.dtype(_NP[key_kind]).name, tuple(str(d.dtype) for d, _ in probe),
        tuple(str(d.dtype) for d, _ in build), cap_p, cap_b, nk)
    flat = [jnp.asarray(x) for pair in probe + build for x in pair]
    juniq = jnp.asarray(uniq if nk else np.zeros(1, np.int64))
    jouts = jker(juniq, jnp.int64(n), jnp.asarray(key[0]), jnp.asarray(key[1]), *flat)
    count, pd, pv, bd, bv = K.inner_join_planes_plain(
        _t(uniq if nk else np.zeros(1, np.int64)), nk, n, _t(key[0]), _t(key[1]),
        [_t(d) for d, _ in probe], [_t(v) for _, v in probe],
        [_t(d) for d, _ in build], [_t(v) for _, v in build])
    assert int(jouts[0]) == int(count)
    mine = [x for pair in zip(pd, pv) for x in pair] + \
        [x for pair in zip(bd, bv) for x in pair]
    assert len(mine) == len(jouts) - 1
    for a, b in zip(jouts[1:], mine):
        _same_bytes(a, b)
    return int(count)


@pytest.mark.parametrize("kind,cap_p,n,nk,cap_b,nulls", [
    ("i64", 256, 200, 60, 256, 0.0),      # misses, padding rows, int64 min key
    ("i64", 256, 256, 60, 64, 0.2),       # null probe keys, full batch
    ("i64", 4096, 3000, 700, 1024, 0.05),
    ("i64", 256, 180, 0, 256, 0.0),       # empty build (nk = 0)
    ("i64", 256, 200, 1, 256, 0.1),       # nk = 1
    ("i64", 256, 200, 40, 41, 0.0),       # cap_b > nk, null-keyed row last
    ("i32", 4096, 4000, 300, 512, 0.1),
    ("f32", 256, 250, 8, 256, 0.1),       # +-0.0, NaN payloads, +-inf
    ("f64", 4096, 3500, 10, 256, 0.1),
])
def test_inner_join_kernel_matches_jax(kind, cap_p, n, nk, cap_b, nulls):
    uniq, build, probe = _join_inputs(kind, cap_p, n, nk, cap_b, nulls,
                                      seed=cap_p + n + nk)
    assert len(uniq) == nk
    count = _run_k8(uniq, nk, n, probe[0], probe, build, kind)
    if nk:
        assert 0 < count < n  # both hits and misses


def test_inner_join_kernel_ignores_rows_past_num_rows():
    """A key marked valid past ``num_rows`` never hits: the row-exists
    term of the probe, not the validity plane, bounds the batch."""
    uniq, build, probe = _join_inputs("i64", 256, 256, 50, 256, 0.0, seed=3)
    assert _run_k8(uniq, 50, 100, probe[0], probe, build, "i64") < 100


def test_canon_words_match_jax():
    for kind in ("f32", "f64"):
        pool = _float_pool(kind)
        want = np.asarray(JKM.canon_word_traced(jnp.asarray(pool)))
        np.testing.assert_array_equal(KM.canon_words(_t(pool)).numpy(), want)
        np.testing.assert_array_equal(JKM._canon_words(pool), want)
    for dt in (np.int8, np.int16, np.int32, np.int64, np.bool_):
        x = np.array([0, 1, -1, 7, -128, 127], np.int64).astype(dt)
        np.testing.assert_array_equal(KM.canon_words(_t(x)).numpy(),
                                      np.asarray(JKM.canon_word_traced(jnp.asarray(x))))


# -- the build map ----------------------------------------------------------------


def _build_batches(keys, key_valid, pay, split):
    schema = JT.Schema.of(("k", JT.I64), ("pay", JT.I64))
    jbs, tbs = [], []
    for s, e in zip([0] + split, split + [len(keys)]):
        cols = {"k": (keys[s:e], key_valid[s:e]), "pay": (pay[s:e], np.ones(e - s, bool))}
        jbs.append(JBatch.from_arrow(pa.record_batch(
            [pa.array(d, type=pa.int64(), mask=~v) for d, v in cols.values()],
            names=["k", "pay"])))
        tbs.append(columns_from_numpy(schema, cols))
    return schema, jbs, tbs


@pytest.mark.parametrize("split", [[], [37, 90]])
def test_build_map_matches_jax(split):
    """Sorted unique words, CSR offsets, the unique flag and the build
    batch re-ordered by code (null-keyed rows at the tail), over one batch
    and over three."""
    rng = np.random.default_rng(len(split))
    n = 150
    keys = rng.permutation(np.arange(-400, 400))[:n]
    valid = rng.random(n) >= 0.1
    keys = np.where(valid, keys, 0)
    pay = rng.integers(-10**9, 10**9, n)
    schema, jbs, tbs = _build_batches(keys, valid, pay, split)
    ref = JKM.JoinHashMap.build(jbs, [JE.Column("k")], schema)
    port = KM.JoinHashMap.build(tbs, [E.Column("k")], from_foreign(schema),
                                torch.device("cpu"))
    np.testing.assert_array_equal(port.sorted_keys, ref.sorted_keys)
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    assert port.num_codes == ref.num_codes == valid.sum()
    assert port.unique_single_key and ref.unique_single_key
    assert port.batch.num_rows == ref.batch.num_rows == n
    for jc, tc in zip(ref.batch.columns, port.batch.columns):
        _same_bytes(np.asarray(jc.data)[:n], tc.data[:n])
        _same_bytes(np.asarray(jc.validity)[:n], tc.validity[:n])
    np.testing.assert_array_equal(port.device_keys(torch.device("cpu")).numpy(),
                                  ref.sorted_keys)


def test_build_map_duplicate_keys_raise():
    """Duplicate build keys and a two-column key no longer raise: the map
    is the generic CSR map (not unique, so the join takes the generic
    probe rather than K8), equal to the reference's; only the broadcast
    serialization still raises, naming ROADMAP.md."""
    keys = np.array([3, 1, 3, 2])
    schema, jbs, tbs = _build_batches(keys, np.ones(4, bool), keys * 10, [])
    for key_exprs in ([JE.Column("k")], [JE.Column("k"), JE.Column("pay")]):
        ref = JKM.JoinHashMap.build(jbs, key_exprs, schema)
        port = KM.JoinHashMap.build(tbs, [from_foreign(e) for e in key_exprs],
                                    from_foreign(schema), torch.device("cpu"))
        assert not ref.unique_single_key and not port.unique_single_key
        np.testing.assert_array_equal(port.offsets, ref.offsets)
        assert port.key_map == ref.key_map
        for jc, tc in zip(ref.batch.columns, port.batch.columns):
            _same_bytes(np.asarray(jc.data)[:4], tc.data[:4])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.serialize()


# -- q06, q47 and q17's join chain -------------------------------------------------

PARTS = 3
ROWS_PER_PART = 3000
N_ITEMS = 300
N_STORES = 40
BATCH = 1024
F = JE.AggFunction
PRICE = JT.DecimalType(7, 2)
SALES = JT.Schema.of(("ss_item_sk", JT.I64), ("ss_store_sk", JT.I64),
                     ("ss_quantity", JT.I64), ("ss_sales_price", PRICE))
ITEM = JT.Schema.of(("i_item_sk", JT.I64), ("i_category_id", JT.I64),
                    ("i_brand_id", JT.I64), ("i_current_price", PRICE))
STORE = JT.Schema.of(("s_store_sk", JT.I64), ("s_state_id", JT.I64))
SCHEMAS = {"store_sales": SALES, "item": ITEM, "store": STORE}


def _tables(seed, qty_hi=100, nulls=0.03, n_items=N_ITEMS):
    """store_sales in PARTS partitions as bench.py:make_data draws it, with
    item keys past the dimension ([1, n_items + 30)) and some nulls;
    item and store dimensions with unique keys 1..N."""
    rng = np.random.default_rng(seed)
    sales = []
    for _ in range(PARTS):
        cols = {"ss_item_sk": rng.integers(1, n_items + 30, ROWS_PER_PART),
                "ss_store_sk": rng.integers(1, N_STORES + 3, ROWS_PER_PART),
                "ss_quantity": rng.integers(1, qty_hi, ROWS_PER_PART),
                "ss_sales_price": rng.integers(0, 500_00, ROWS_PER_PART)}
        part = {}
        for name, d in cols.items():
            v = rng.random(ROWS_PER_PART) >= nulls
            part[name] = (np.where(v, d, 0), v)
        sales.append(part)
    ones = np.ones(n_items, bool)
    item = {"i_item_sk": (np.arange(1, n_items + 1), ones),
            "i_category_id": (rng.integers(0, 10, n_items), ones),
            "i_brand_id": (rng.integers(1, 60, n_items), ones),
            "i_current_price": (rng.integers(0, 300_00, n_items), ones)}
    sones = np.ones(N_STORES, bool)
    store = {"s_store_sk": (np.arange(1, N_STORES + 1), sones),
             "s_state_id": (rng.integers(0, 50, N_STORES), sones)}
    return {"store_sales": sales, "item": [item], "store": [store]}


def _slices(part, batch):
    n = len(next(iter(part.values()))[0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, max(n, 1), batch)]


def _arrow(schema, cols):
    arrs = []
    for f in schema.fields:
        d, v = cols[f.name]
        if JT.DecimalType(38, 2) == f.dtype:  # (lo_raw, hi) words of a wide decimal
            vals = [(int(hi) << 64) + (int(lo) & ((1 << 64) - 1)) for lo, hi in d]
            arrs.append(pa.array([_EXACT.scaleb(decimal.Decimal(x), -2) if ok else None
                                  for x, ok in zip(vals, v)], type=pa.decimal128(38, 2)))
        elif isinstance(f.dtype, JT.DecimalType):
            arrs.append(pa.array([decimal.Decimal(int(x)).scaleb(-2) if ok else None
                                  for x, ok in zip(d, v)], type=pa.decimal128(7, 2)))
        else:
            arrs.append(pa.array(d, type=pa.int64(), mask=~v))
    return pa.record_batch(arrs, names=schema.names)


def _col(name):
    return JE.Column(name)


def _join(probe, dim, key, dim_key, cache_id, jt=JN.JoinType.INNER, condition=None):
    return JN.BroadcastJoin(probe, JN.BroadcastExchange(JN.FFIReader(SCHEMAS[dim], dim, 1)),
                            [(_col(key), _col(dim_key))], jt, JN.JoinSide.RIGHT,
                            cache_id, condition)


def _two_stage(child, keys, aggs):
    keys = [(k, _col(k)) for k in keys]
    partial = JN.Agg(child, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, n) for n, a in aggs],
                     supports_partial_skipping=True)
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([e for _, e in keys], PARTS))
    return JN.Agg(ex, JE.AggExecMode.HASH_AGG, keys,
                  [JN.AggColumn(a, JE.AggMode.FINAL, n) for n, a in aggs])


def _sales_scan():
    return JN.FFIReader(SALES, "store_sales", PARTS)


def _q06(cache_id="bench_items"):
    """bench.py:227 plan_q06 over FFIReader sources."""
    join = _join(_sales_scan(), "item", "ss_item_sk", "i_item_sk", cache_id)
    agg = _two_stage(join, ["i_category_id"], [
        ("qty", JE.AggExpr(F.SUM, [_col("ss_quantity")])),
        ("revenue", JE.AggExpr(F.SUM, [_col("ss_sales_price")], JT.DecimalType(17, 2)))])
    return JN.Sort(JN.ShuffleExchange(agg, JN.SinglePartitioning(1)),
                   [JE.SortOrder(_col("i_category_id"))])


def _q47():
    """bench.py:319 plan_q47: the q06 join -> (category, brand) agg ->
    sort (category ASC, qty DESC) -> rank by category -> rk <= 5."""
    join = _join(_sales_scan(), "item", "ss_item_sk", "i_item_sk", "bench_items47")
    agg = _two_stage(join, ["i_category_id", "i_brand_id"],
                     [("qty", JE.AggExpr(F.SUM, [_col("ss_quantity")]))])
    srt = JN.Sort(JN.ShuffleExchange(agg, JN.SinglePartitioning(1)),
                  [JE.SortOrder(_col("i_category_id")),
                   JE.SortOrder(_col("qty"), ascending=False)])
    win = JN.Window(srt, [JN.WindowExpr("rank", "rk")], [_col("i_category_id")],
                    [JE.SortOrder(_col("qty"), ascending=False)])
    return JN.Filter(win, [JE.BinaryExpr(JE.BinaryOp.LTEQ, _col("rk"),
                                         JE.Literal(5, JT.I32))])


WCOST = JT.DecimalType(38, 2)
SALES17 = JT.Schema.of(*[(f.name, f.dtype) for f in SALES.fields],
                       ("ss_ext_wholesale_cost", WCOST))
_EXACT = decimal.Context(prec=80)


def _tables_wcost(seed):
    """``_tables`` with bench.py's decimal(38,2) ss_ext_wholesale_cost on
    store_sales, from its own stream, some nulls, as the port's (lo_raw,
    hi) words. Unscaled values are uniform [10^16, 9 * 10^18) (bench.py
    draws [10^14, 9 * 10^16) over 28.8M rows), so the ~20 rows of a group
    here still sum past int64."""
    tables = _tables(seed)
    rng = np.random.default_rng(seed + 421)
    for part in tables["store_sales"]:
        x = rng.integers(10 ** 16, 9 * 10 ** 18, ROWS_PER_PART)
        v = rng.random(ROWS_PER_PART) >= 0.03
        part["ss_ext_wholesale_cost"] = (wide_words(x.tolist(), v), v)
    return tables


def _q17():
    """bench.py:265 plan_q17 whole: the item and store joins, then COUNT,
    SUM(ss_quantity) and the wide SUM(ss_ext_wholesale_cost) by (state,
    category), a single exchange and the sort."""
    j1 = _join(JN.FFIReader(SALES17, "store_sales", PARTS), "item", "ss_item_sk",
               "i_item_sk", "bench_items17")
    j2 = _join(j1, "store", "ss_store_sk", "s_store_sk", "bench_stores17")
    agg = _two_stage(j2, ["s_state_id", "i_category_id"], [
        ("n", JE.AggExpr(F.COUNT, [])),
        ("qty", JE.AggExpr(F.SUM, [_col("ss_quantity")])),
        ("wcost", JE.AggExpr(F.SUM, [_col("ss_ext_wholesale_cost")]))])
    return JN.Sort(JN.ShuffleExchange(agg, JN.SinglePartitioning(1)),
                   [JE.SortOrder(_col("s_state_id")), JE.SortOrder(_col("i_category_id"))])


def _q17_joins():
    """bench.py:265 plan_q17's two joins (item, then store) under its
    (state, category) agg, without the wide-decimal wcost sum."""
    j1 = _join(_sales_scan(), "item", "ss_item_sk", "i_item_sk", "bench_items17")
    j2 = _join(j1, "store", "ss_store_sk", "s_store_sk", "bench_stores17")
    agg = _two_stage(j2, ["s_state_id", "i_category_id"], [
        ("n", JE.AggExpr(F.COUNT, [])),
        ("qty", JE.AggExpr(F.SUM, [_col("ss_quantity")]))])
    return JN.Sort(JN.ShuffleExchange(agg, JN.SinglePartitioning(1)),
                   [JE.SortOrder(_col("s_state_id")), JE.SortOrder(_col("i_category_id"))])


def _reference(plan, tables, fused, schemas=None):
    JBHJ.clear_build_cache()
    conf = JaxConfig(batch_size=BATCH) if fused else \
        JaxConfig(batch_size=BATCH, fused_filter_agg=False)
    schemas = schemas or SCHEMAS
    with JaxSession(conf=_jax_conf(conf)) as s:
        for name, parts in tables.items():
            s.resources[name] = lambda p, _n=name, _parts=parts: [
                _arrow(schemas[_n], b) for b in _slices(_parts[p], BATCH)]
        return s.execute_to_pydict(plan)


def _serve(port, tables):
    for name, parts in tables.items():
        port.resources[name] = lambda p, _parts=parts: _slices(_parts[p], BATCH)


def _port(plan, tables):
    port = blaze_tpu_torch.Session(conf=Config(batch_size=BATCH), device="cpu")
    _serve(port, tables)
    return port.execute_to_pydict(from_foreign(plan))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("query", ["q06", "q47", "q17_joins"])
def test_join_paths_match_jax(query, fused):
    """Probe keys outside the dimension and null, many 1024-row probe
    batches; q47 with narrow quantities so rank ties occur."""
    plan = {"q06": _q06, "q47": _q47, "q17_joins": _q17_joins}[query]()
    tables = _tables(seed=len(query), qty_hi=4 if query == "q47" else 100)
    want = _reference(plan, tables, fused)
    got = _port(plan, tables)
    assert got == want
    if query == "q06":
        assert got["i_category_id"] == list(range(10))
        assert all(isinstance(r, decimal.Decimal) for r in got["revenue"])
    if query == "q47":
        assert len(got["rk"]) >= 50
        assert any(a == b for a, b in zip(got["rk"], got["rk"][1:]))  # ties


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_q17_with_wcost_matches_jax(fused):
    """q17 whole: the decimal(38,2) column rides through both joins (K8)
    as three limb planes, its SUM crosses the exchange as three-limb
    states (sum3) and comes out exact, against both reference modes and a
    Python oracle."""
    tables = _tables_wcost(seed=17)
    want = _reference(_q17(), tables, fused, dict(SCHEMAS, store_sales=SALES17))
    got = _port(_q17(), tables)
    assert got == want
    item, store = tables["item"][0], tables["store"][0]
    cat = dict(zip(item["i_item_sk"][0].tolist(), item["i_category_id"][0].tolist()))
    state = dict(zip(store["s_store_sk"][0].tolist(), store["s_state_id"][0].tolist()))
    sums = {}
    for part in tables["store_sales"]:
        (it, iv), (st, sv) = part["ss_item_sk"], part["ss_store_sk"]
        words, wv = part["ss_ext_wholesale_cost"]
        for i, ok_i, s_, ok_s, w, ok_w in zip(it, iv, st, sv, words[:, 0], wv):
            if ok_i and ok_s and int(i) in cat and int(s_) in state and ok_w:
                g = (state[int(s_)], cat[int(i)])
                sums[g] = sums.get(g, 0) + int(w)
    keys = list(zip(got["s_state_id"], got["i_category_id"]))
    assert got["wcost"] == [_EXACT.scaleb(decimal.Decimal(sums[g]), -2) if g in sums else None
                            for g in keys]
    assert any(s >= 1 << 63 for s in sums.values())


def test_empty_dimension_gives_no_rows():
    """An empty item table: the port's empty sorted map (nk = 0) goes
    through K8 and q06 returns no rows, as an inner join with an empty
    side must. The reference builds an empty generic map instead, whose
    probe indexes past its one offset (blaze_tpu/ops/joins/keymap.py:394)
    and raises IndexError (ROADMAP.md Queue 3)."""
    tables = _tables(seed=9)
    tables["item"] = [{k: (d[:0], v[:0]) for k, (d, v) in tables["item"][0].items()}]
    with pytest.raises(IndexError):
        _reference(_q06(), tables, fused=False)
    assert _port(_q06(), tables) == {"i_category_id": [], "qty": [], "revenue": []}


def test_build_cache_is_scoped_to_the_query():
    """One port Session runs q06 twice, with another item table under the
    same cached_build_hash_map_id; each result equals its own reference
    run. The JAX package's process-wide cache would hand the second run
    the first run's map: that is the difference this test pins."""
    first, second = _tables(seed=21), _tables(seed=22)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=BATCH), device="cpu")
    plan = from_foreign(_q06())
    results = []
    for tables in (first, second):
        _serve(port, tables)
        results.append(port.execute_to_pydict(plan))
        assert port.resources.get("broadcast_build_maps") is None
    assert results[0] == _reference(_q06(), first, fused=False)
    assert results[1] == _reference(_q06(), second, fused=False)
    assert results[0] != results[1]
    # the reference without clearing its cache between the two runs
    JBHJ.clear_build_cache()
    stale = []
    for tables in (first, second):
        with JaxSession(conf=_jax_conf(JaxConfig(batch_size=BATCH,
                                                 fused_filter_agg=False))) as s:
            for name, parts in tables.items():
                s.resources[name] = lambda p, _n=name, _parts=parts: [
                    _arrow(SCHEMAS[_n], b) for b in _slices(_parts[p], BATCH)]
            stale.append(s.execute_to_pydict(_q06()))
    JBHJ.clear_build_cache()
    assert stale[0] == results[0] and stale[1] != results[1]
