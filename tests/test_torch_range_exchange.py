"""The port's range and round-robin exchange (slice 10) against the JAX
package: K14's plain twin, the partitioners, the Session's bound sampling,
and q98 and a sort10M-shaped global sort.

- Kernel level: chip_smoke.py's K14 battery (``RANGE_CASES``: one to five
  keys of int64/int32/int16/int8/bool/float32/float64/decimal, ASC and
  DESC, nulls first and last, NaN and +-0.0 on both sides, int64 min and
  max, null bounds, 1 to 1,200 bounds, padding rows, capacities 256 to
  262,144) goes through the reference's ``range_partition_ids`` /
  ``range_partition_order`` (its jitted ``_range_pids`` / ``_range_order``
  on the CPU, over the bounds as its key pass gives them, in draw order)
  and the port's (the twin, over the bounds ``range_bound_operands``
  sorts).
- K14's bound table (``range_bound_words``: one int64 word and one rank
  a key of a node of the search tree, a float as its order-preserving
  integer) against the sorted operands, and the range partitioner's key
  dtypes (the
  card's ``RangePack`` checks each batch's planes against them) against
  the planes it evaluates, for every key type.
- The reference's test_shuffle.py cases on the port: round robin, the
  range partitioner over given bounds, and the sampled global sort.
- ``Session._sample_range_bounds`` of both packages on the same batches.
- Plan level: q98 (chip_smoke.py's plan, with its cuts) and a
  sort10M-shaped plan, built with ``blaze_tpu.ir`` and carried across with
  ``from_foreign``, through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")`` over the same batches; the
  results must be equal, order included.

Tolerance: none. Ids, orders and bounds compare exactly (floats by
``repr``, so -0.0 and NaN count); plan results compare floats by ``repr``.
"""

import datetime
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
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ops.shuffle.repartitioner import (RangePartitioner, RoundRobinPartitioner,
                                                       create_repartitioner)
from chip_smoke import RANGE_CASES, range_case, range_run

torch.set_num_threads(1)
# the reference's float64 probe must run outside a trace, or its fused
# closures take f64 literals down its host path
supports_f64()

CPU = torch.device("cpu")


# -- K14: the twin against the reference's _range_pids / _range_order ------------------


def _reference_ids(case):
    j = [[jnp.asarray(x) for x in case[k]] for k in ("datas", "valids", "bdatas", "bvalids")]
    exists = jnp.asarray(case["exists"])
    bound_ops = JK.sort_key_operands(j[2], j[3], jnp.ones(len(case["bdatas"][0]), bool),
                                     case["spec"])
    pids = JK.range_partition_ids(j[0], j[1], exists, bound_ops, case["spec"])
    spids, order = JK.range_partition_order(j[0], j[1], exists, bound_ops, case["spec"])
    return np.asarray(pids), np.asarray(spids), np.asarray(order)


@pytest.mark.parametrize("case", RANGE_CASES, ids=[c[0] for c in RANGE_CASES])
def test_range_ids_twin_matches_reference(case):
    data = range_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    want, want_spids, want_order = _reference_ids(data)
    got = range_run(data, K.range_partition_ids, CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    spids, order = range_run(data, K.range_partition_order, CPU)
    np.testing.assert_array_equal(spids.numpy(), want_spids)
    np.testing.assert_array_equal(order.numpy(), want_order)
    # padding rows park past the last partition
    nb = case[4]
    assert (got.numpy()[~data["exists"]] == nb + 1).all()
    assert (got.numpy()[data["exists"]] <= nb).all()


def test_range_bound_operands_ascend():
    """The bounds K14 searches come out of range_bound_operands in
    ascending order of their operand tuples, -0.0 beside 0.0."""
    data = range_case(RANGE_CASES[6], np.random.default_rng(3))
    ops = K.range_bound_operands([torch.from_numpy(x) for x in data["bdatas"]],
                                 [torch.from_numpy(x) for x in data["bvalids"]], data["spec"])
    rows = list(zip(*[o.tolist() for o in ops]))
    assert rows == sorted(rows)


def test_signed_zero_bound_equals_a_zero_row():
    """A 0.0 row against a -0.0 bound is equal (IEEE), so the row lands
    after the bound, as in the reference; K5's radix words would order
    them apart."""
    case = {"label": "zero", "datas": [np.array([0.0, -0.0, 0.5, -0.5], np.float64)],
            "valids": [np.ones(4, bool)], "exists": np.ones(4, bool),
            "bdatas": [np.array([-0.0])], "bvalids": [np.ones(1, bool)],
            "spec": ((True, True),)}
    want, _s, _o = _reference_ids(case)
    got = range_run(case, K.range_partition_ids, CPU).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 1, 0])


def test_range_words_keep_the_float_order_and_equality():
    """The words K14 compares: a float as its double's order-preserving
    integer, so signed order is the float order over every non-NaN value,
    -0.0 and 0.0 one word, and float32 as its double; integers and bools
    as they are."""
    vals = np.array([-np.inf, -1e300, -2.5, -1e-310, -0.0, 0.0, 1e-310, 0.5, 1e300, np.inf])
    for dt in (np.float64, np.float32):
        with np.errstate(over="ignore"):
            x = vals.astype(dt)
        w = K._range_words(torch.from_numpy(x)).numpy()
        for i in range(len(x)):
            for j in range(len(x)):
                assert (w[i] < w[j]) == (x[i] < x[j]) and (w[i] == w[j]) == (x[i] == x[j])
    ints = torch.tensor([-128, -1, 0, 127], dtype=torch.int8)
    assert K._range_words(ints).tolist() == [-128, -1, 0, 127]
    assert K._range_words(torch.tensor([0, 1], dtype=torch.uint8)).tolist() == [0, 1]


@pytest.mark.parametrize("nb", [0, 1, 5, 31])
def test_range_bound_words_hold_the_search_tree(nb):
    """K14's table: key c of node e at c * (2^d - 1) + e, node 2^L - 1 + p
    of level L holding sorted bound p * 2^(d-L) + 2^(d-1-L) - 1 (an
    in-order walk of the tree is the ascending order), nodes past the
    bounds rank 5 with word 0."""
    data = range_case(RANGE_CASES[4], np.random.default_rng(5))  # 5 keys, 31 bounds
    ops = K.range_bound_operands([torch.from_numpy(x) for x in data["bdatas"]],
                                 [torch.from_numpy(x) for x in data["bvalids"]], data["spec"])
    ops = [o[:nb] for o in ops]
    words, ranks = K.range_bound_words(ops)
    k, d = len(data["bdatas"]), nb.bit_length()
    ne = (1 << d) - 1
    assert words.dtype == torch.int64 and ranks.dtype == torch.uint8
    assert words.shape == ranks.shape == (k * ne,)
    w, r = words.view(k, ne), ranks.view(k, ne)

    def in_order(e, level):  # the tree's nodes, left subtree first
        if level == d:
            return []
        return in_order(2 * e + 1, level + 1) + [e] + in_order(2 * e + 2, level + 1)

    nodes = in_order(0, 0)
    assert sorted(nodes) == list(range(ne))
    for j, e in enumerate(nodes):
        for c in range(k):
            if j < nb:
                assert r[c, e] == ops[2 * c][j]
                assert w[c, e] == K._range_words(ops[2 * c + 1])[j]
            else:
                assert (r[c, e], w[c, e]) == (5, 0)


@pytest.mark.parametrize("dt", [T.I8, T.I16, T.I32, T.I64, T.BOOL, T.F32, T.F64, T.DATE,
                                T.TIMESTAMP, T.DecimalType(7, 2), T.DecimalType(18, 2)],
                         ids=repr)
def test_range_partitioner_key_dtypes_are_the_evaluated_planes(dt):
    """The dtypes the partitioner gives K14's pack (its bound batch's) are
    those of the key planes it evaluates from a batch of the key's type."""
    schema = T.Schema.of(("k", dt))
    plane = torch.zeros(4, dtype=T.torch_dtype(dt)).numpy()
    b = ColumnarBatch.from_numpy(schema, {"k": plane}, CPU)
    bound = {T.BOOL: True, T.DATE: datetime.date(1970, 1, 2),
             T.TIMESTAMP: datetime.datetime(1970, 1, 2)}.get(dt, 0)
    if isinstance(dt, T.DecimalType):
        bound = decimal.Decimal(0)
    p = RangePartitioner([E.SortOrder(E.Column("k"))], 2, [(bound,)], schema)
    p.partition_ids(b)
    datas, _valids = p._key_planes(b)
    assert p._key_dtypes == [d.dtype for d in datas]


# -- the reference's test_shuffle.py cases on the port ---------------------------------


def test_round_robin_deterministic():
    """test_shuffle.py:38: two partitioners give the same ids; ids continue
    across a task's batches."""
    b = ColumnarBatch.from_numpy(T.Schema.of(("k", T.I64)), {"k": np.arange(10)}, CPU)
    p1, p2 = RoundRobinPartitioner(3), RoundRobinPartitioner(3)
    np.testing.assert_array_equal(p1.partition_ids(b).numpy(), p2.partition_ids(b).numpy())
    assert p1.partition_ids(b)[0] == 10 % 3
    # a new task starts at 0 again
    part = create_repartitioner(N.RoundRobinPartitioning(3), b.schema)
    np.testing.assert_array_equal(part.partition_ids(b).numpy(), np.arange(10) % 3)


def test_range_partitioner():
    """test_shuffle.py:47: given bounds, bisect_right per row."""
    schema = T.Schema.of(("k", T.I64))
    b = ColumnarBatch.from_numpy(schema, {"k": np.array([5, 15, 25, 35])}, CPU)
    part = N.RangePartitioning([E.SortOrder(E.Column("k"))], 3, bounds=[(10,), (30,)])
    p = create_repartitioner(part, schema)
    assert isinstance(p, RangePartitioner)
    np.testing.assert_array_equal(p.partition_ids(b).numpy(), [0, 1, 1, 2])


def test_session_distributed_global_sort_range_sampling():
    """test_shuffle.py:229: a range exchange whose bounds the Session
    samples, then a per-partition sort, is a global sort."""
    rng = np.random.default_rng(9)
    vals = rng.integers(-(10**9), 10**9, 30_000)
    sess = blaze_tpu_torch.Session(device="cpu")
    third = 10_000
    sess.resources["src"] = lambda p: [{"v": vals[p * third:(p + 1) * third]}]
    scan = N.FFIReader(T.Schema.of(("v", T.I64)), "src", 3)
    ex = N.ShuffleExchange(scan, N.RangePartitioning([E.SortOrder(E.Column("v"))], 4, []))
    out = sess.execute_to_pydict(N.Sort(ex, [E.SortOrder(E.Column("v"))]))
    assert out["v"] == sorted(vals.tolist())


def test_session_normalises_range_bounds_once_an_exchange(monkeypatch):
    """One range partitioner serves every map task of an exchange, so its
    bounds go through the key pass and sort once, not once a task."""
    calls = []
    fn = K.range_bound_operands
    monkeypatch.setattr(K, "range_bound_operands", lambda *a: calls.append(1) or fn(*a))
    vals = np.random.default_rng(4).integers(0, 1000, 4000)
    sess = blaze_tpu_torch.Session(device="cpu")
    sess.resources["src"] = lambda p: [{"v": vals[p * 1000:(p + 1) * 1000]}]
    scan = N.FFIReader(T.Schema.of(("v", T.I64)), "src", 4)
    ex = N.ShuffleExchange(scan, N.RangePartitioning([E.SortOrder(E.Column("v"))], 3, []))
    out = sess.execute_to_pydict(N.Sort(ex, [E.SortOrder(E.Column("v"))]))
    assert out["v"] == sorted(vals.tolist())
    assert len(calls) == 1


def test_session_round_robin_starts_at_zero_in_each_map_task():
    """The Session's round-robin exchange: ids continue across a task's
    rows and start at 0 in each task (three tasks of three rows into two
    reducers, AQE off so each reducer is read alone)."""
    sess = blaze_tpu_torch.Session(conf=Config(coalesce_partitions_enable=False),
                                   device="cpu")
    sess.resources["src"] = lambda p: [{"v": np.arange(3 * p, 3 * p + 3)}]
    scan = N.FFIReader(T.Schema.of(("v", T.I64)), "src", 3)
    out = sess.execute_to_pydict(N.ShuffleExchange(scan, N.RoundRobinPartitioning(2)))
    assert out["v"] == [0, 2, 3, 5, 6, 8, 1, 4, 7]


@pytest.mark.parametrize("bounds,want", [
    ([], [(0, list(range(7)))]),
    ([(10,), (30,)], [(0, [1, 6]), (1, [2, 3, 4]), (2, [0, 5])]),
], ids=["no bounds", "two bounds"])
def test_range_bucketize_keeps_rows_in_partition_order(bounds, want):
    """bucketize: sub-batches in partition order, each partition's rows in
    input order, a row equal to a bound after it; empty bounds put every
    row in partition 0."""
    schema = T.Schema.of(("k", T.I64), ("v", T.I64))
    k = np.array([35, 5, 25, 15, 10, 30, 5])
    b = ColumnarBatch.from_numpy(schema, {"k": k, "v": np.arange(7)}, CPU)
    p = create_repartitioner(
        N.RangePartitioning([E.SortOrder(E.Column("k"))], 3, bounds=bounds), schema)
    assert [(pid, sub.to_pydict()["v"]) for pid, sub in p.bucketize(b)] == want


def test_decimal_and_null_bounds_land_at_the_keys_scale():
    """Bounds as a carried plan gives them: Decimal values at any exponent
    and None; a bound that the key's scale cannot hold raises."""
    schema = T.Schema.of(("p", T.DecimalType(7, 2)), ("f", T.F64))
    b = ColumnarBatch.from_numpy(schema, {"p": (np.array([100, 150, 151, 0, 999]),
                                                np.array([1, 1, 1, 0, 1], bool)),
                                          "f": np.array([0.0, 1.0, -1.0, 2.0, 0.0])}, CPU)
    orders = [E.SortOrder(E.Column("p")), E.SortOrder(E.Column("f"), ascending=False)]
    bounds = [(None, 1.0), (decimal.Decimal("1.5"), -0.0), (decimal.Decimal("1.510"), None)]
    p = create_repartitioner(N.RangePartitioning(orders, 4, bounds), schema)
    want_part = JN.RangePartitioning([JE.SortOrder(JE.Column("p")),
                                      JE.SortOrder(JE.Column("f"), ascending=False)], 4, bounds)
    from blaze_tpu.core import ColumnarBatch as JaxBatch
    from blaze_tpu.ops.shuffle.repartitioner import create_repartitioner as jax_create

    jb = JaxBatch.from_pydict(
        {"p": pa.array([decimal.Decimal("1.00"), decimal.Decimal("1.50"),
                        decimal.Decimal("1.51"), None, decimal.Decimal("9.99")],
                       type=pa.decimal128(7, 2)),
         "f": pa.array([0.0, 1.0, -1.0, 2.0, 0.0])})
    want = np.asarray(jax_create(want_part, jb.schema).partition_ids(jb))
    np.testing.assert_array_equal(p.partition_ids(b).numpy(), want)
    bad = create_repartitioner(N.RangePartitioning(orders, 2, [(decimal.Decimal("1.005"), 0.0)]),
                               schema)
    with pytest.raises(ValueError, match="does not fit"):
        bad.partition_ids(b)


# -- the Session's bound sampling -----------------------------------------------------

_SAMPLE_SCHEMA = (("f", "f64"), ("p", "dec"), ("i", "i32"), ("b", "bool"))


def _sample_batches(rng, nan=True):
    """Partitions of batches with NaN (unless ``nan`` is False), +-0.0,
    nulls and ties; partition 0 passes 5,000 rows inside its third batch,
    so its fourth is never sampled."""
    parts = []
    for sizes in ((3000, 1500, 2000, 800), (100,), (40, 7), ()):
        batches = []
        for n in sizes:
            f = rng.integers(-6, 7, n) * 0.5
            if nan:
                f[rng.random(n) < 0.05] = np.nan
            f[rng.random(n) < 0.05] = -0.0
            batches.append({"f": (f, rng.random(n) > 0.1),
                            "p": (rng.integers(0, 500, n), rng.random(n) > 0.05),
                            "i": (rng.integers(-50, 50, n).astype(np.int32),
                                  rng.random(n) > 0.1),
                            "b": (rng.random(n) < 0.5, rng.random(n) > 0.1)})
        parts.append(batches)
    return parts


def _jax_batch(schema, cols):
    arrs = []
    for f in schema.fields:
        d, v = cols[f.name]
        if isinstance(f.dtype, JT.DecimalType):
            arrs.append(pa.array([decimal.Decimal(int(x)).scaleb(-f.dtype.scale) if ok else None
                                  for x, ok in zip(d, v)],
                                 type=pa.decimal128(f.dtype.precision, f.dtype.scale)))
        else:
            arrs.append(pa.array(d, mask=~v))
    return pa.record_batch(arrs, names=schema.names)


def _canon_rows(rows):
    return [tuple(repr(x) if isinstance(x, float) else x for x in r) for r in rows]


def _spark_cmp(a, b, orders):
    """Spark's row order for the sample oracle, written out: per key nulls
    first or last, then NaN above every value and -0.0 equal to 0.0 (floats
    and decimals compared as numbers), reversed under DESC."""
    for x, y, (_c, asc, nulls_first) in zip(a, b, orders):
        if x is None or y is None:
            if x is None and y is None:
                continue
            return (-1 if x is None else 1) * (1 if nulls_first else -1)
        xn, yn = isinstance(x, float) and x != x, isinstance(y, float) and y != y
        c = (xn > yn) - (xn < yn) if xn or yn else (x > y) - (x < y)
        if c:
            return c if asc else -c
    return 0


def _spark_bounds(parts, orders, num_partitions):
    """The bounds sampled as the Session samples them (every max(1, rows //
    50)-th row of each batch until a partition has given 5,000 rows), sorted
    stably in Spark's order."""
    import functools

    samples = []
    for batches in parts:
        taken = 0
        for b in batches:
            n = len(b["f"][0])
            step = max(1, n // 50)
            for i in range(0, n, step):
                row = []
                for c, _asc, _nf in orders:
                    d, v = b[c]
                    x = d[i].item() if v[i] else None
                    if c == "p" and x is not None:
                        x = decimal.Decimal(x).scaleb(-2)
                    row.append(x)
                samples.append(tuple(row))
            taken += n
            if taken >= 5000:
                break
    samples.sort(key=functools.cmp_to_key(lambda a, b: _spark_cmp(a, b, orders)))
    return [samples[min(len(samples) - 1, i * len(samples) // num_partitions)]
            for i in range(1, num_partitions)]


_SAMPLE_ORDERS = [
    (("f", False, False), ("p", True, True)),
    (("i", True, True), ("b", False, False), ("f", True, True)),
    (("p", False, True),),
]


def _port_bounds(parts, orders, num_partitions=5):
    port = blaze_tpu_torch.Session(device="cpu")
    port.resources["src"] = lambda p: parts[p]
    schema = T.Schema.of(*[(n, {"f64": T.F64, "dec": T.DecimalType(7, 2), "i32": T.I32,
                                "bool": T.BOOL}[k]) for n, k in _SAMPLE_SCHEMA])
    node = N.ShuffleExchange(
        N.FFIReader(schema, "src", len(parts)),
        N.RangePartitioning([E.SortOrder(E.Column(c), asc, nf) for c, asc, nf in orders],
                            num_partitions, []))
    return port._sample_range_bounds(node).bounds


@pytest.mark.parametrize("orders", _SAMPLE_ORDERS, ids=["f DESC, p", "i, b DESC, f", "p DESC"])
def test_sample_range_bounds_matches_reference(orders, tmp_path):
    """On a NaN-free draw the port samples the reference's bounds; on the
    draw with 5% NaN it samples Spark's (the reference sorts NaN with
    ``<``, out of order: ROADMAP.md Queue 3, found and fixed)."""
    types = {"f64": JT.F64, "dec": JT.DecimalType(7, 2), "i32": JT.I32, "bool": JT.BOOL}
    schema = JT.Schema.of(*[(n, types[k]) for n, k in _SAMPLE_SCHEMA])
    parts = _sample_batches(np.random.default_rng(len(orders)), nan=False)
    node = JN.ShuffleExchange(
        JN.FFIReader(schema, "src", len(parts)),
        JN.RangePartitioning([JE.SortOrder(JE.Column(c), asc, nf) for c, asc, nf in orders],
                             5, []))
    with JaxSession(conf=JaxConfig(shm_dir=str(tmp_path))) as s:
        s.resources["src"] = lambda p: [_jax_batch(schema, b) for b in parts[p]]
        want = s._sample_range_bounds(node).bounds
    got = _port_bounds(parts, orders)
    assert len(want) == 4
    assert _canon_rows(got) == _canon_rows(want)
    nan_parts = _sample_batches(np.random.default_rng(len(orders)))
    assert _canon_rows(_port_bounds(nan_parts, orders)) == \
        _canon_rows(_spark_bounds(nan_parts, orders, 5))


@pytest.mark.parametrize("orders", [(("f", True, True),), (("f", False, False),),
                                    (("f", False, True), ("i", True, False))],
                         ids=["f", "f DESC", "f DESC nulls first, i"])
def test_sampled_bounds_ascend_in_spark_order(orders):
    """NaN and +-0.0 keys (a third of the rows NaN, a third +-0.0): the
    bounds come out ascending in Spark's order, so each partition is a
    quantile; NaN samples land after every value (before it under DESC)."""
    import functools

    rng = np.random.default_rng(31)
    parts = []
    for _p in range(3):
        n = 2000
        f = rng.choice([np.nan, 0.0, -0.0, 1.5, -2.5, 7.0], n)
        parts.append([{"f": (f, rng.random(n) > 0.05), "p": (np.zeros(n, np.int64), np.ones(n, bool)),
                       "i": (rng.integers(0, 4, n).astype(np.int32), np.ones(n, bool)),
                       "b": (np.zeros(n, bool), np.ones(n, bool))}])
    bounds = _port_bounds(parts, orders, 9)
    assert len(bounds) == 8
    assert any(isinstance(b[0], float) and b[0] != b[0] for b in bounds)
    assert bounds == sorted(bounds, key=functools.cmp_to_key(
        lambda a, b: _spark_cmp(a, b, orders)))
    assert _canon_rows(bounds) == _canon_rows(_spark_bounds(parts, orders, 9))


# -- plan level: q98 and sort10M's shape ----------------------------------------------

Q98_SMALL = {"store_sales": 200_000, "item": 2_000, "date_dim": 73_049}


def _canon(d):
    """Floats by repr (-0.0 and nan spelled out), everything else as is."""
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _arrow_batch(schema, cols):
    """A reference batch from the port's numpy planes: a decimal(19..38)
    column's planes are (lo_raw, hi) words."""
    arrs = []
    for f in schema.fields:
        d, v = cols[f.name]
        dt = f.dtype
        if isinstance(dt, JT.DecimalType):
            ints = [(int(hi) << 64) + (int(lo) & ((1 << 64) - 1)) for lo, hi in d] \
                if d.ndim == 2 else [int(x) for x in d]
            ctx = decimal.Context(prec=80)
            arrs.append(pa.array([ctx.scaleb(decimal.Decimal(x), -dt.scale) if ok else None
                                  for x, ok in zip(ints, v)],
                                 type=pa.decimal128(dt.precision, dt.scale)))
        else:
            arrs.append(pa.array(d, mask=~v))
    return pa.record_batch(arrs, names=schema.names)


def _run_both(plan, schemas, parts, tmp_path, **conf):
    """The plan's result in both packages over the same batches: ``parts``
    maps a resource to its partitions, each a list of {column: (data,
    validity)} batches; ``schemas`` maps it to its reference schema."""
    clear_build_cache()
    with JaxSession(conf=JaxConfig(shm_dir=str(tmp_path), **conf)) as s:
        for rid, plist in parts.items():
            s.resources[rid] = lambda p, _pl=plist, _s=schemas[rid]: [
                _arrow_batch(_s, b) for b in _pl[p]]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(**conf), device="cpu")
    for rid, plist in parts.items():
        port.resources[rid] = lambda p, _pl=plist: _pl[p]
    return want, port.execute_to_pydict(from_foreign(plan))


def _partitions(host, schemas, parts, batch):
    """{table: partitions of {column: (data, validity)} batches}: the fact
    table cut into ``parts`` partitions, each dimension one."""
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


def test_q98_matches_jax_and_numpy(tmp_path):
    """chip_smoke.py's q98 plan and data at 200,000 store_sales rows and
    2,000 items on the sort route: two broadcast joins, the five-key
    two-stage SUM, the window SUM over i_class, the ratio, the range
    exchange with sampled bounds and the sort; equal to the reference,
    order included, and to the numpy oracle."""
    from chip_smoke import q98_host, q98_oracle, q98_plan, q98_schemas

    host = q98_host(Q98_SMALL)
    check, info = q98_oracle(host)
    assert info["groups"] > 400
    schemas = q98_schemas(JT)
    want, got = _run_both(q98_plan(schemas, JE, JN, JT, parts=4), schemas,
                          _partitions(host, schemas, 4, 8192), tmp_path, batch_size=8192,
                          dense_agg=False, radix_agg=False)
    assert _canon(got) == _canon(want)
    check(got)


@pytest.mark.parametrize("ties", [False, True], ids=["bench ranges", "tied keys"])
def test_sort10m_shape_matches_jax_and_numpy(ties, tmp_path):
    """sort10M's plan (range exchange on ss_sales_price DESC, ss_item_sk
    with sampled bounds, then the sort) over bench.py's five columns, the
    decimal(38,2) one included, at 6,000 rows in 4 partitions of 512-row
    batches into 4 range partitions; with ``ties`` the keys are cut to a
    few values, so most rows tie and their order is the exchange's."""
    from chip_smoke import SORT10M_COLUMNS, sort10m_host, sort10m_oracle, sort10m_plan

    host = sort10m_host(rows=6000, parts=4, seed=5)
    if ties:
        host = [(item // 400, store, qty, price // 10_000, wcost)
                for item, store, qty, price, wcost in host]
    check, _info = sort10m_oracle(host)
    schema = JT.Schema.of(("ss_item_sk", JT.I64), ("ss_store_sk", JT.I64),
                          ("ss_quantity", JT.I64), ("ss_sales_price", JT.DecimalType(7, 2)),
                          ("ss_ext_wholesale_cost", JT.DecimalType(38, 2)))
    from blaze_tpu_torch.core.batch import wide_words

    parts = [[{c: (wide_words(x[s:s + 512].tolist()) if c == SORT10M_COLUMNS[4]
                   else x[s:s + 512], np.ones(len(x[s:s + 512]), bool))
               for c, x in zip(SORT10M_COLUMNS, cols)} for s in range(0, len(cols[0]), 512)]
             for cols in host]
    want, got = _run_both(sort10m_plan(schema, JE, JN, parts=4, range_parts=4),
                          {"store_sales": schema}, {"store_sales": parts}, tmp_path,
                          batch_size=1024)
    assert got == want
    ctx = decimal.Context(prec=80)
    check({c: np.array([int(ctx.scaleb(v, 2)) if isinstance(v, decimal.Decimal) else v
                        for v in got[c]]) for c in SORT10M_COLUMNS})


def test_date_and_timestamp_bounds():
    """Date and timestamp bounds (datetime values, as sampling gives them)
    land as days and microseconds since the epoch."""
    import datetime

    schema = T.Schema.of(("d", T.DATE), ("t", T.TIMESTAMP))
    days = np.array([0, 10, 11, 20], np.int32)
    micros = np.array([5, 0, 7, 3], np.int64)
    b = ColumnarBatch.from_numpy(schema, {"d": days, "t": micros}, CPU)
    epoch = datetime.datetime(1970, 1, 1)
    bounds = [(datetime.date(1970, 1, 11), epoch + datetime.timedelta(microseconds=6))]
    p = create_repartitioner(N.RangePartitioning(
        [E.SortOrder(E.Column("d")), E.SortOrder(E.Column("t"))], 2, bounds), schema)
    np.testing.assert_array_equal(p.partition_ids(b).numpy(), [0, 0, 1, 1])


# -- bucketize: K5's pid sort and K7's split against the reference -------------------


def _bucketize_batch(rng, n, keys=None):
    """A batch of ``n`` rows (capacity past n, so padding rows follow):
    an int64 key (with nulls where drawn here, not where given), an int32,
    a bool with nulls and a decimal(30,4) (the port's three limb planes,
    a wide column in both)."""
    k = rng.integers(0, 1000, n) if keys is None else np.asarray(keys, np.int64)
    cols = {"k": (k, rng.random(n) > 0.1 if keys is None else np.ones(n, bool)),
            "v": (rng.integers(-99, 99, n).astype(np.int32), np.ones(n, bool)),
            "b": (rng.random(n) < 0.5, rng.random(n) > 0.2),
            "w": (rng.integers(-10 ** 17, 10 ** 17, n) * 1000 + rng.integers(0, 999, n),
                  rng.random(n) > 0.1)}
    return cols


_BUCKET_SCHEMA = (("k", "i64"), ("v", "i32"), ("b", "bool"), ("w", "d304"))
_BUCKET_TYPES = {"i64": (T.I64, JT.I64), "i32": (T.I32, JT.I32), "bool": (T.BOOL, JT.BOOL),
                 "d304": (T.DecimalType(30, 4), JT.DecimalType(30, 4))}


def _bucketize_partitioning(kind, nparts, pkg):
    En, Nn = (E, N) if pkg == "port" else (JE, JN)
    if kind == "hash":
        return Nn.HashPartitioning([En.Column("k")], nparts)
    if kind == "round_robin":
        return Nn.RoundRobinPartitioning(nparts)
    bounds = [(int(x),) for x in np.linspace(100, 900, nparts - 1)]
    if nparts > 3:  # a repeated bound: the partition between the two is empty
        bounds[1] = bounds[2]
    return Nn.RangePartitioning([En.SortOrder(En.Column("k"))], nparts, bounds)


@pytest.mark.parametrize("kind", ["hash", "range", "round_robin"])
@pytest.mark.parametrize("shape", ["spread", "one_partition", "empty_partitions"])
def test_bucketize_matches_reference(kind, shape):
    """``Repartitioner.bucketize`` (K5's pid sort, its histogram as the
    counts, then K7's split form: here their plain versions) against the
    reference's bucketize (a stable argsort, a take, a slice a partition)
    on the same numpy batch: the same partitions in order, each with the
    same rows, capacity and planes, padding rows and validity included."""
    from blaze_tpu.core import ColumnarBatch as JaxBatch
    from blaze_tpu.ops.shuffle.repartitioner import create_repartitioner as jax_create
    from blaze_tpu_torch.ops.shuffle.repartitioner import create_repartitioner

    rng = np.random.default_rng(len(kind) * 7 + len(shape))
    n, nparts, keys = 3000, 5, None
    if shape == "one_partition":
        n, keys = (1, None) if kind == "round_robin" else (3000, [5] * 3000)
    elif shape == "empty_partitions":
        nparts = 64
        if kind == "round_robin":
            n = 40
        else:
            keys = rng.integers(0, 10, n) * 97
    cols = _bucketize_batch(rng, n, keys)
    schema = T.Schema.of(*[(c, _BUCKET_TYPES[t][0]) for c, t in _BUCKET_SCHEMA])
    jschema = JT.Schema.of(*[(c, _BUCKET_TYPES[t][1]) for c, t in _BUCKET_SCHEMA])
    d, v = cols["w"]
    port_cols = dict(cols, w=(np.stack([d, np.where(d < 0, -1, 0)], 1), v))
    got = create_repartitioner(_bucketize_partitioning(kind, nparts, "port"), schema).bucketize(
        ColumnarBatch.from_numpy(schema, port_cols, CPU))
    want = jax_create(_bucketize_partitioning(kind, nparts, "jax"), jschema).bucketize(
        JaxBatch.from_arrow(_jax_batch(jschema, cols), jschema))
    assert [p for p, _ in got] == [p for p, _ in want]
    if shape == "empty_partitions":
        assert len(got) < nparts
    if shape == "one_partition":
        assert len(got) == 1
    for (_, a), (_, b) in zip(got, want):
        assert a.num_rows == b.num_rows and a.capacity == b.capacity
        assert a.to_pydict() == b.to_pydict()
        for ca, cb in zip(a.columns[:3], b.columns[:3]):
            np.testing.assert_array_equal(ca.data.numpy(), np.asarray(cb.data))
            np.testing.assert_array_equal(ca.validity.numpy(), np.asarray(cb.validity))
