"""The port's fourth slice against the JAX package: the generic hash-join
probe (K9), the build map with duplicate and multi-column keys, every
join type on ``BroadcastJoinExec`` and ``HashJoinExec``, and TPC-DS q69's
path (semi and anti hash joins between broadcast joins).

The same numpy inputs, drawn from a seed, go through the JAX function
(on the CPU, as the JAX package's own tests run it) and the port's plain
PyTorch twin; the plans go through ``blaze_tpu.Session`` and
``blaze_tpu_torch.Session(device="cpu")``.

Tolerance: none. Every plane is an integer, bool or float compared by
its bytes, and the plan results must be equal, order included. The JAX
package keeps its build-map cache process-wide, so every reference run
starts with ``clear_build_cache()``. Where the reference raises on an
empty build side (its empty map indexes past its one offset), the port
is held against the join's definition instead.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins import bhj as JBHJ
from blaze_tpu.ops.joins import keymap as JKM
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import columns_from_numpy, from_foreign
from blaze_tpu_torch.ops.joins import keymap as KM

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- K9: the generic probe --------------------------------------------------------

_NP = {"i64": np.int64, "i32": np.int32, "f32": np.float32, "f64": np.float64}


def _float_pool(kind):
    """Values whose canonical words collide: +-0.0, NaN payloads of both
    signs (quiet and signalling), +-inf, ordinary values."""
    if kind == "f64":
        nans = np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                         0x7FF0000000000001], np.uint64).view(np.float64)
    else:
        nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001],
                        np.uint32).view(np.float32)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.25, -1e30, 7.0, 3.0],
                    _NP[kind])
    return np.concatenate([vals, nans])


def _probe_inputs(kind, cap, n, nk, nulls, seed):
    """The sorted unique words of ``nk`` build keys, and a probe key plane
    of capacity ``cap`` with ``n`` live rows: hits, misses inside the
    build's range and below and above it, nulls; padding rows past n
    (validity False, data 0)."""
    rng = np.random.default_rng(seed)
    if kind in ("f32", "f64"):
        pool = _float_pool(kind)
        _, first = np.unique(JKM._canon_words(pool), return_index=True)
        distinct = pool[np.sort(first)]
        bvals = distinct[rng.permutation(len(distinct))[:nk]]
        probe_pool = np.concatenate([pool, np.array([5.0, -7.5, 1e-3, -1e38, 1e38],
                                                    _NP[kind])])
    else:
        bvals = rng.choice(np.arange(-5000, 5000), nk, replace=False).astype(_NP[kind])
        if nk > 2:
            bvals[0] = np.iinfo(_NP[kind]).min
            bvals[1] = np.iinfo(_NP[kind]).max
        outside = np.array([-9000, 9000, np.iinfo(_NP[kind]).min + 1,
                            np.iinfo(_NP[kind]).max - 1], _NP[kind])
        probe_pool = np.concatenate([np.tile(bvals, max(1, 64 // max(nk, 1))),
                                     rng.integers(-5000, 5000, 64).astype(_NP[kind]),
                                     outside])
    uniq = np.unique(JKM._canon_words(bvals)) if nk else np.zeros(0, np.int64)
    live = np.arange(cap) < n
    valid = live & (rng.random(cap) >= nulls)
    key = np.where(valid, probe_pool[rng.integers(0, len(probe_pool), cap)],
                   0).astype(_NP[kind])
    return uniq, key, valid


@pytest.mark.parametrize("kind,cap,n,nk,nulls", [
    ("i64", 256, 200, 60, 0.1),      # misses below/above, int64 min/max keys
    ("i64", 4096, 4096, 700, 0.05),  # a full batch
    ("i64", 256, 180, 0, 0.0),       # an empty build (nk = 0)
    ("i64", 256, 200, 1, 0.1),       # nk = 1
    ("i32", 4096, 3000, 300, 0.1),
    ("f32", 256, 250, 8, 0.1),       # +-0.0, NaN payloads, +-inf
    ("f64", 4096, 3500, 10, 0.1),
    ("f64", 256, 100, 1, 0.0),
])
def test_probe_codes_match_jax(kind, cap, n, nk, nulls):
    uniq, key, valid = _probe_inputs(kind, cap, n, nk, nulls, seed=cap + n + nk)
    assert len(uniq) == nk
    padded = uniq if nk else np.zeros(1, np.int64)
    want = np.asarray(JKM._probe_fn(np.dtype(_NP[kind]).name, nk)(
        jnp.asarray(padded), jnp.asarray(key), jnp.asarray(valid)))
    got = K.probe_codes(_t(padded), nk, _t(key), _t(valid))
    assert got.dtype == torch.int64 and got.shape == (cap,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~valid] == -1).all()
    if nk > 1:
        assert 0 < (want >= 0).sum() < valid.sum()  # hits and misses


# -- the build map and key interning ------------------------------------------------


def _jbatch(schema, cols):
    arrs = []
    for f in schema.fields:
        d, v = cols[f.name]
        arrs.append(pa.array(d, type=T_ARROW[type(f.dtype).__name__], mask=~v))
    return JBatch.from_arrow(pa.record_batch(arrs, names=schema.names))


T_ARROW = {"Int64Type": pa.int64(), "Int32Type": pa.int32(), "Float64Type": pa.float64(),
           "Float32Type": pa.float32(), "BooleanType": pa.bool_()}


def _split(cols, cuts):
    n = len(next(iter(cols.values()))[0])
    return [{k: (d[s:e], v[s:e]) for k, (d, v) in cols.items()}
            for s, e in zip([0] + cuts, cuts + [n])]


def _assert_same_map(port, ref):
    assert port.num_codes == ref.num_codes
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    if ref.sorted_keys is None:
        assert port.sorted_keys is None and port.key_map == ref.key_map
    else:
        np.testing.assert_array_equal(port.sorted_keys, ref.sorted_keys)
    assert port.unique_single_key == ref.unique_single_key
    n = ref.batch.num_rows
    assert port.batch.num_rows == n
    for jc, tc in zip(ref.batch.columns, port.batch.columns):
        np.testing.assert_array_equal(np.asarray(jc.data)[:n].view(np.uint8),
                                      tc.data[:n].numpy().view(np.uint8))
        np.testing.assert_array_equal(np.asarray(jc.validity)[:n], tc.validity[:n].numpy())


@pytest.mark.parametrize("keys", [["k"], ["k", "f"]], ids=["one_key", "two_keys"])
def test_build_map_with_duplicate_keys_matches_jax(keys):
    """Duplicate and null build keys over three batches: the CSR offsets,
    the sorted words (one key) or the interned key map (two keys) and the
    build rows re-ordered by code (null-keyed rows at the tail) equal the
    reference's."""
    rng = np.random.default_rng(len(keys))
    n = 300
    cols = {"k": (rng.integers(-20, 20, n), rng.random(n) >= 0.1),
            "f": (rng.choice(_float_pool("f64"), n), rng.random(n) >= 0.1),
            "pay": (rng.integers(-10**9, 10**9, n), np.ones(n, bool))}
    cols = {k: (np.where(v, d, d.dtype.type(0)), v) for k, (d, v) in cols.items()}
    jschema = JT.Schema.of(("k", JT.I64), ("f", JT.F64), ("pay", JT.I64))
    parts = _split(cols, [90, 200])
    ref = JKM.JoinHashMap.build([_jbatch(jschema, p) for p in parts],
                                [JE.Column(k) for k in keys], jschema)
    port = KM.JoinHashMap.build([columns_from_numpy(jschema, p) for p in parts],
                                [E.Column(k) for k in keys], from_foreign(jschema), CPU)
    assert not ref.unique_single_key
    _assert_same_map(port, ref)


def test_key_codes_two_keys_with_nulls_and_floats_match_jax():
    """Build-side interning (insert) and probe-side lookups (no insert) of
    an (int32, f32) key: -0.0 and every NaN payload match their canonical
    value, a null in either column gives -1."""
    rng = np.random.default_rng(11)
    n = 400
    pool = _float_pool("f32")
    schema = JT.Schema.of(("a", JT.I32), ("b", JT.F32))
    cols = {"a": (rng.integers(0, 6, n).astype(np.int32), rng.random(n) >= 0.1),
            "b": (rng.choice(pool, n).astype(np.float32), rng.random(n) >= 0.1)}
    cols = {k: (np.where(v, d, d.dtype.type(0)), v) for k, (d, v) in cols.items()}
    build, probe = _split(cols, [250])
    jmap, tmap = {}, {}
    for part, insert in ((build, True), (probe, False)):
        jb = _jbatch(schema, part)
        tb = columns_from_numpy(schema, part)
        want = JKM.key_codes(jb, jb.columns, jmap, insert)
        got = KM.key_codes(tb, tb.columns, tmap, insert)
        np.testing.assert_array_equal(got, want)
    assert tmap == jmap and len(tmap) > 10
    assert (want == -1).any() and (want >= 0).any()


def test_take_nullable_and_empty_match_jax():
    """Index -1 gives an all-null row (K6's masked form); an empty batch
    keeps ``min_capacity`` rows of zero planes, so null-extending from it
    gathers no row past its planes; a BOOL column comes from numpy."""
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.F64), ("c", JT.BOOL))
    cols = {"a": (np.arange(5), np.array([1, 1, 0, 1, 1], bool)),
            "b": (np.array([0.5, -0.0, 2.0, np.nan, 1.0]), np.ones(5, bool)),
            "c": (np.array([True, False, True, True, False]), np.ones(5, bool))}
    idx = np.array([4, -1, 0, 2, -1, 3, 3])
    ref = _jbatch(schema, cols).take_nullable(idx)
    got = columns_from_numpy(schema, cols).take_nullable(idx)
    assert got.num_rows == ref.num_rows == 7 and got.capacity == ref.capacity
    for jc, tc in zip(ref.columns, got.columns):
        np.testing.assert_array_equal(np.asarray(jc.data).view(np.uint8),
                                      tc.data.numpy().view(np.uint8))
        np.testing.assert_array_equal(np.asarray(jc.validity), tc.validity.numpy())
    assert [f.nullable for f in got.schema.fields] == \
        [f.nullable for f in ref.schema.fields] == [True] * 3
    empty = ColumnarBatch.empty(from_foreign(schema), CPU)
    assert empty.num_rows == 0 and empty.capacity == Config().min_capacity
    assert empty.take_nullable(np.full(3, -1)).to_pydict() == \
        {"a": [None] * 3, "b": [None] * 3, "c": [None] * 3}
    flags = np.array([True, False, True])
    want = JDeviceColumn.from_numpy(JT.BOOL, flags, None, 256)
    col = DeviceColumn.from_numpy(T.BOOL, flags, None, 256, CPU)
    np.testing.assert_array_equal(col.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(col.validity.numpy(), np.asarray(want.validity))


# -- every join type through both Sessions -------------------------------------------

BATCH = 64
J = JN.JoinType
LSCHEMA = JT.Schema.of(("lk", JT.I64), ("lv", JT.I64))
RSCHEMA = JT.Schema.of(("rk", JT.I64), ("rv", JT.I64))


def _side(rng, parts, rows, lo, hi, names):
    """``parts`` partitions of int64 (key, value) rows: keys in [lo, hi)
    with duplicates, 10% null keys; values in [0, 100)."""
    out = []
    for _ in range(parts):
        v = rng.random(rows) >= 0.1
        out.append({names[0]: (np.where(v, rng.integers(lo, hi, rows), 0), v),
                    names[1]: (rng.integers(0, 100, rows), np.ones(rows, bool))})
    return out


def _join_tables(seed=5, parts=2):
    """int-only versions of tests/test_joins.py's LEFT and RIGHT: keys that
    match on both sides several times, keys on one side only, nulls."""
    rng = np.random.default_rng(seed)
    return {"l": _side(rng, parts, 120, 0, 30, ("lk", "lv")),
            "r": _side(rng, parts, 80, 10, 45, ("rk", "rv"))}


def _arrow(schema, part):
    return pa.record_batch([pa.array(part[f.name][0], type=pa.int64(), mask=~part[f.name][1])
                            for f in schema.fields], names=schema.names)


def _slices(part, batch):
    n = len(next(iter(part.values()))[0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, n, batch)]


def _reference(plan, tables, schemas, conf=None, batch=BATCH):
    JBHJ.clear_build_cache()
    with JaxSession(conf=conf or JaxConfig(batch_size=batch)) as s:
        for name, parts in tables.items():
            s.resources[name] = lambda p, _n=name, _parts=parts: [
                _arrow(schemas[_n], b) for b in _slices(_parts[p], batch)]
        return s.execute_to_pydict(plan)


def _port(plan, tables, conf=None, batch=BATCH, session=None):
    port = session or blaze_tpu_torch.Session(conf=conf or Config(batch_size=batch),
                                              device="cpu")
    for name, parts in tables.items():
        port.resources[name] = lambda p, _parts=parts: _slices(_parts[p], batch)
    return port.execute_to_pydict(from_foreign(plan))


def _join_plan(op, jt, build, condition=None, parts=2):
    on = [(JE.Column("lk"), JE.Column("rk"))]
    left = JN.FFIReader(LSCHEMA, "l", parts)
    right = JN.FFIReader(RSCHEMA, "r", parts)
    if op == "hash":
        return JN.HashJoin(left, right, on, jt, build, condition)
    if build == JN.JoinSide.LEFT:
        left = JN.BroadcastExchange(left)
    else:
        right = JN.BroadcastExchange(right)
    return JN.BroadcastJoin(left, right, on, jt, build, f"map_{jt.value}", condition)


LV_GT_RV = JE.BinaryExpr(JE.BinaryOp.GT, JE.Column("lv"), JE.Column("rv"))
SCHEMAS = {"l": LSCHEMA, "r": RSCHEMA}


@pytest.mark.parametrize("cond", [None, LV_GT_RV], ids=["no_cond", "lv_gt_rv"])
@pytest.mark.parametrize("build", [JN.JoinSide.LEFT, JN.JoinSide.RIGHT],
                         ids=["build_left", "build_right"])
@pytest.mark.parametrize("op", ["broadcast", "hash"])
@pytest.mark.parametrize("jt", list(J), ids=[j.value for j in J])
def test_join_types_match_jax(jt, op, build, cond):
    """Duplicate keys on both sides, null keys, two partitions of two
    probe batches each: pairs in probe order with the build rows in CSR
    order, unmatched probe rows after each batch's pairs, the build tail
    last; a condition turns key matches into non-matches. The broadcast
    join's cached map is shared by both partitions' tasks, each with its
    own matched flags."""
    plan = _join_plan(op, jt, build, cond)
    tables = _join_tables()
    want = _reference(plan, tables, SCHEMAS)
    got = _port(plan, tables)
    assert got == want
    assert len(next(iter(got.values()))) > 0


def _empty_build_oracle(jt, left_parts):
    """The join of the left partitions with an empty right side, by the
    join's definition: nothing matches."""
    rows = [(lk if ok else None, lv) for part in left_parts
            for lk, ok, lv in zip(part["lk"][0].tolist(), part["lk"][1].tolist(),
                                  part["lv"][0].tolist())]
    cols = {"lk": [r[0] for r in rows], "lv": [r[1] for r in rows]}
    none = [None] * len(rows)
    if jt in (J.LEFT, J.FULL):
        return {**cols, "rk": none, "rv": none}
    if jt == J.LEFT_ANTI:
        return cols
    if jt == J.EXISTENCE:
        return {**cols, "exists#0": [False] * len(rows)}
    names = ["lk", "lv", "rk", "rv"] if jt == J.INNER or jt == J.RIGHT else \
        (["rk", "rv"] if jt in (J.RIGHT_SEMI, J.RIGHT_ANTI) else ["lk", "lv"])
    return {k: [] for k in names}


@pytest.mark.parametrize("empty", ["probe", "build"])
@pytest.mark.parametrize("jt", list(J), ids=[j.value for j in J])
def test_join_types_with_an_empty_side(jt, empty):
    """A hash join (build right) whose probe or build side has no rows.
    An empty probe side equals the reference; with an empty build side
    the reference raises IndexError (ROADMAP.md Queue 3), so the port is
    held against the join's definition."""
    tables = _join_tables(seed=8)
    side = "l" if empty == "probe" else "r"
    tables[side] = [{k: (d[:0], v[:0]) for k, (d, v) in p.items()} for p in tables[side]]
    plan = _join_plan("hash", jt, JN.JoinSide.RIGHT, LV_GT_RV)
    got = _port(plan, tables)
    if empty == "probe":
        assert got == _reference(plan, tables, SCHEMAS)
    else:
        assert got == _empty_build_oracle(jt, tables["l"])


def test_broadcast_outer_join_tails_are_per_task():
    """A broadcast RIGHT and FULL join, build right, over two probe
    partitions: each task emits the build rows that its own partition
    did not match, so a build row matched only in partition 0 still comes
    null-extended from partition 1's tail. One set of matched flags
    shared by both tasks would drop it."""
    tables = _join_tables(seed=13)
    build = [(k if ok else None) for p in tables["r"]
             for k, ok in zip(p["rk"][0].tolist(), p["rk"][1].tolist())]
    probe_keys = [set(p["lk"][0][p["lk"][1]].tolist()) for p in tables["l"]]
    per_task = sum(sum(k not in keys for k in build) for keys in probe_keys)
    overall = sum(all(k not in keys for keys in probe_keys) for k in build)
    assert per_task > 2 * overall
    for jt in (J.RIGHT, J.FULL):
        plan = _join_plan("broadcast", jt, JN.JoinSide.RIGHT)
        got = _port(plan, tables)
        assert got == _reference(plan, tables, SCHEMAS)
        tails = sum(lk is None and lv is None for lk, lv in zip(got["lk"], got["lv"]))
        assert tails == per_task


def test_hash_join_partitions_stay_zipped():
    """A hash join over two hash exchanges whose reducers would coalesce
    differently (the small side's four reducers fit the advisory size
    together, the large side's do not): below the join no reducer
    merges, so partition i meets partition i, as in the reference."""
    rng = np.random.default_rng(17)
    tables = {"l": _side(rng, 2, 2000, 0, 300, ("lk", "lv")),
              "r": _side(rng, 2, 100, 0, 300, ("rk", "rv"))}
    on = [(JE.Column("lk"), JE.Column("rk"))]

    def exchange(schema, rid, key):
        return JN.ShuffleExchange(JN.FFIReader(schema, rid, 2),
                                  JN.HashPartitioning([JE.Column(key)], 4))

    plan = JN.HashJoin(exchange(LSCHEMA, "l", "lk"), exchange(RSCHEMA, "r", "rk"),
                       on, J.INNER, JN.JoinSide.RIGHT)
    advisory = 4096
    conf = Config(batch_size=1024, advisory_partition_bytes=advisory)
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    got = _port(plan, tables, batch=1024, session=port)
    want = _reference(plan, tables, SCHEMAS, batch=1024,
                      conf=JaxConfig(batch_size=1024, advisory_partition_bytes=advisory))
    assert got == want
    pairs = sorted((a, b, c, d) for a, b, c, d in zip(*got.values()))
    lrows = [(k, v) for p in tables["l"] for k, v, ok in zip(p["lk"][0], p["lv"][0], p["lk"][1]) if ok]
    rrows = [(k, v) for p in tables["r"] for k, v, ok in zip(p["rk"][0], p["rv"][0], p["rk"][1]) if ok]
    assert pairs == sorted((a, b, c, d) for a, b in lrows for c, d in rrows if a == c)
    # outside a join the same exchanges coalesce differently
    port.resources.update({k: (lambda p, _t=t: _slices(_t[p], 1024)) for k, t in tables.items()})
    counts = [port._lower(from_foreign(exchange(s, rid, key))).child.num_partitions
              for s, rid, key in ((LSCHEMA, "l", "lk"), (RSCHEMA, "r", "rk"))]
    assert counts[0] == 4 and counts[1] < 4


# -- TPC-DS q69 at a small size ---------------------------------------------------

Q69_PARTS = 4
Q69_BATCH = 1024
STATES = (2, 5, 7)  # the three ca_state codes of the IN list
CD_DIMS = (2, 5, 7, 20, 4)  # gender, marital, education, purchase estimate, credit
SALES_DATES = (2_450_816, 2_452_642)  # first and last d_date_sk of the sales
Q69_KEYS = ["cd_gender", "cd_marital_status", "cd_education_status", "cd_credit_rating"]
# the five grouping keys TPC-DS q69 names
Q69_KEYS5 = ["cd_gender", "cd_marital_status", "cd_education_status", "cd_purchase_estimate",
             "cd_credit_rating"]
C = JE.Column


def _sch(*names):
    return JT.Schema.of(*[(n, JT.I64) for n in names])


Q69_SCHEMAS = {
    "customer": _sch("c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk"),
    "customer_address": _sch("ca_address_sk", "ca_state_id"),
    "customer_demographics": _sch("cd_demo_sk", "cd_gender", "cd_marital_status",
                                  "cd_education_status", "cd_purchase_estimate",
                                  "cd_credit_rating"),
    "date_dim": _sch("d_date_sk", "d_year", "d_moy"),
    "store_sales": _sch("ss_sold_date_sk", "ss_customer_sk"),
    "web_sales": _sch("ws_sold_date_sk", "ws_bill_customer_sk"),
    "catalog_sales": _sch("cs_sold_date_sk", "cs_ship_customer_sk"),
}
SALES = (("store_sales", "ss_sold_date_sk", "ss_customer_sk", J.LEFT_SEMI),
         ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", J.LEFT_ANTI),
         ("catalog_sales", "cs_sold_date_sk", "cs_ship_customer_sk", J.LEFT_ANTI))


def _q69_tables(seed, customers=2000, addresses=1000, n_states=8,
                sales=(40_000, 10_000, 20_000)):
    """q69's tables as chip_smoke.py draws them at SF10, cut to a small
    size: the demographics cross product without its three dependant
    counts (5,600 rows), the date dimension to the sales' 1,827 days,
    ca_state_id over 8 codes (51 at SF10) so that the three chosen states
    keep enough customers. 4% of each foreign key is null."""
    rng = np.random.default_rng(seed)

    def fk(hi, n):
        v = rng.random(n) >= 0.04
        return np.where(v, rng.integers(1, hi + 1, n), 0), v

    def ones(*cols):
        return {k: (d, np.ones(len(d), bool)) for k, d in cols}

    def parts(cols):
        n = len(next(iter(cols.values()))[0])
        cuts = [n * i // Q69_PARTS for i in range(1, Q69_PARTS)]
        return _split(cols, cuts)

    n_cd = int(np.prod(CD_DIMS))
    code = np.arange(n_cd)
    attrs = []
    for d in CD_DIMS:
        attrs.append(code % d)
        code = code // d
    days = np.arange(SALES_DATES[0], SALES_DATES[1] + 1)
    date = np.datetime64("1900-01-02") + (days - 2_415_022)
    cust = {"c_customer_sk": (np.arange(1, customers + 1), np.ones(customers, bool)),
            "c_current_addr_sk": fk(addresses, customers),
            "c_current_cdemo_sk": fk(n_cd, customers)}
    tables = {
        "customer": parts(cust),
        "customer_address": [ones(("ca_address_sk", np.arange(1, addresses + 1)),
                                  ("ca_state_id", rng.integers(0, n_states, addresses)))],
        "customer_demographics": [ones(("cd_demo_sk", np.arange(1, n_cd + 1)),
                                       ("cd_gender", attrs[0]), ("cd_marital_status", attrs[1]),
                                       ("cd_education_status", attrs[2]),
                                       ("cd_purchase_estimate", attrs[3] * 500 + 500),
                                       ("cd_credit_rating", attrs[4]))],
        "date_dim": [ones(("d_date_sk", days),
                          ("d_year", date.astype("datetime64[Y]").astype(np.int64) + 1970),
                          ("d_moy", date.astype("datetime64[M]").astype(np.int64) % 12 + 1))],
    }
    for (name, dcol, ccol, _), n in zip(SALES, sales):
        tables[name] = parts({dcol: (rng.integers(SALES_DATES[0], SALES_DATES[1] + 1, n),
                                     np.ones(n, bool)),
                              ccol: fk(customers, n)})
    return tables


def _q69_plan(group_keys=Q69_KEYS):
    """TPC-DS q69 as Spark plans it, in 4 partitions: customer JOIN
    address (three states, broadcast) -> exchange by customer -> LEFT
    SEMI store window, LEFT ANTI web window, LEFT ANTI catalog window
    (shuffled hash joins; each window is sales JOIN broadcast date_dim of
    April-June 2001, projected to the customer key and exchanged by it)
    -> JOIN broadcast demographics -> two-stage COUNT(*) by the
    demographics ``group_keys`` -> single exchange -> sort, top 100."""
    eq = lambda c, v: JE.BinaryExpr(JE.BinaryOp.EQ, C(c), JE.Literal(v, JT.I64))  # noqa: E731
    OR = JE.BinaryOp.OR
    states = JE.BinaryExpr(OR, JE.BinaryExpr(OR, eq("ca_state_id", STATES[0]),
                                             eq("ca_state_id", STATES[1])),
                           eq("ca_state_id", STATES[2]))

    def scan(name, parts=Q69_PARTS):
        return JN.FFIReader(Q69_SCHEMAS[name], name, parts)

    def by(child, key):
        return JN.ShuffleExchange(child, JN.HashPartitioning([C(key)], Q69_PARTS))

    addr = JN.Filter(scan("customer_address", 1), [states])
    cust = JN.BroadcastJoin(scan("customer"), JN.BroadcastExchange(addr),
                            [(C("c_current_addr_sk"), C("ca_address_sk"))],
                            J.INNER, JN.JoinSide.RIGHT, "q69_address")
    out = by(JN.Projection(cust, [C("c_customer_sk"), C("c_current_cdemo_sk")],
                           ["c_customer_sk", "c_current_cdemo_sk"]), "c_customer_sk")
    dates = JN.Filter(scan("date_dim", 1), [
        eq("d_year", 2001),
        JE.BinaryExpr(JE.BinaryOp.GTEQ, C("d_moy"), JE.Literal(4, JT.I64)),
        JE.BinaryExpr(JE.BinaryOp.LTEQ, C("d_moy"), JE.Literal(6, JT.I64))])
    for name, dcol, ccol, jt in SALES:
        window = JN.BroadcastJoin(scan(name), JN.BroadcastExchange(dates),
                                  [(C(dcol), C("d_date_sk"))], J.INNER,
                                  JN.JoinSide.RIGHT, f"q69_dates_{name}")
        window = by(JN.Projection(window, [C(ccol)], [ccol]), ccol)
        out = JN.HashJoin(out, window, [(C("c_customer_sk"), C(ccol))], jt,
                          JN.JoinSide.RIGHT)
    out = JN.BroadcastJoin(out, JN.BroadcastExchange(scan("customer_demographics", 1)),
                           [(C("c_current_cdemo_sk"), C("cd_demo_sk"))], J.INNER,
                           JN.JoinSide.RIGHT, "q69_demographics")
    keys = [(k, C(k)) for k in group_keys]
    count = JE.AggExpr(JE.AggFunction.COUNT, [])
    partial = JN.Agg(out, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(count, JE.AggMode.PARTIAL, "cnt")],
                     supports_partial_skipping=True)
    final = JN.Agg(JN.ShuffleExchange(partial, JN.HashPartitioning(
        [e for _, e in keys], Q69_PARTS)), JE.AggExecMode.HASH_AGG, keys,
        [JN.AggColumn(count, JE.AggMode.FINAL, "cnt")])
    return JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                   [JE.SortOrder(C(k)) for k in group_keys], fetch_limit=100)


def _q69_oracle(tables, group_keys=Q69_KEYS):
    """q69 by set operations on the host copies."""
    def cat(name, *cols):
        return [np.concatenate([p[c][0] for p in tables[name]]) for c in cols] + \
            [np.concatenate([p[c][1] for p in tables[name]]) for c in cols]

    ca_sk, ca_state = tables["customer_address"][0]["ca_address_sk"][0], \
        tables["customer_address"][0]["ca_state_id"][0]
    in_states = set(ca_sk[np.isin(ca_state, STATES)].tolist())
    c_sk, c_addr, c_cd, _, addr_ok, cd_ok = cat(
        "customer", "c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk")
    dd = tables["date_dim"][0]
    window = set(dd["d_date_sk"][0][(dd["d_year"][0] == 2001) & (dd["d_moy"][0] >= 4)
                                    & (dd["d_moy"][0] <= 6)].tolist())
    keep = addr_ok & np.isin(c_addr, list(in_states)) & cd_ok
    for name, dcol, ccol, jt in SALES:
        d, k, _, kv = cat(name, dcol, ccol)
        buyers = set(k[kv & np.isin(d, list(window))].tolist())
        hit = np.isin(c_sk, list(buyers))
        keep &= hit if jt == J.LEFT_SEMI else ~hit
    cd = tables["customer_demographics"][0]
    rows = c_cd[keep] - 1
    groups = {}
    for r in rows:
        g = tuple(int(cd[k][0][r]) for k in group_keys)
        groups[g] = groups.get(g, 0) + 1
    top = sorted(groups.items())[:100]
    out = {k: [g[i] for g, _ in top] for i, k in enumerate(group_keys)}
    out["cnt"] = [n for _, n in top]
    return out


def test_q69_matches_jax_and_the_oracle():
    """q69 at ~2,000 customers and 40k/10k/20k sales rows in 4 partitions:
    K8 on the address, date and demographics joins, K9 on the semi and
    anti joins (duplicate customer keys on every build side, null keys on
    both sides), partitions zipped below each hash join."""
    tables = _q69_tables(seed=69)
    plan = _q69_plan()
    want = _q69_oracle(tables)
    assert 50 <= len(want["cnt"]) <= 100 and sum(want["cnt"]) > 100
    got = _port(plan, tables, batch=Q69_BATCH)
    assert got == want
    assert _reference(plan, tables, Q69_SCHEMAS, batch=Q69_BATCH) == want


def test_q69_five_keys_matches_jax_and_the_oracle():
    """q69 grouped by the five demographics TPC-DS names: with
    cd_purchase_estimate (500..10,000) the slot table is 4 * 8 * 8 *
    16384 * 8 slots, past radix_agg_max_slots, so the partial and the
    merge take the sort route (K10) in both packages under the default
    config."""
    from blaze_tpu_torch.ops.agg_device import plan_slot_table

    tables = _q69_tables(seed=69)
    plan = _q69_plan(Q69_KEYS5)
    want = _q69_oracle(tables, Q69_KEYS5)
    assert 50 <= len(want["cnt"]) <= 100 and sum(want["cnt"]) > 100
    got = _port(plan, tables, batch=Q69_BATCH)
    assert got == want
    assert _reference(plan, tables, Q69_SCHEMAS, batch=Q69_BATCH) == want
    probe = np.array([[1, 0, 1], [1, 0, 4], [1, 0, 6], [1, 500, 10_000], [1, 0, 3]])
    assert plan_slot_table(probe, 1024, None, Config().radix_agg_max_slots, Config()) is None
