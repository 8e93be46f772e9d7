"""The port's slice end to end: TPC-DS q01 (filter -> partial agg ->
murmur3 hash exchange -> final agg -> top-k), built once with the JAX
package's IR, carried across with ``ir/carry.py``, and run through
``blaze_tpu.runtime.session.Session`` (CPU, as the JAX tests run it) and
``blaze_tpu_torch.Session(device="cpu")``. ``execute_to_pydict`` must be
equal: same keys, ``Decimal`` totals, counts and order.

Tolerance: exact (integers and int64-backed decimals only).
"""

import dataclasses
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir.carry import columns_from_numpy, from_foreign

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


PARTS = 3
ROWS_PER_PART = 12_000
BATCH = 4096
F = JE.AggFunction
AMT_T = JT.DecimalType(7, 2)
SCHEMA = JT.Schema.of(("sr_store_sk", JT.I64), ("sr_customer_sk", JT.I64),
                      ("sr_return_amt", AMT_T))


def _data(seed, nulls=0.0):
    """Per partition {column: (data, validity)} drawn as bench.py draws
    store_returns: amt unscaled in [0, 1e6), store in [1, 400), customer
    in [1, 100000)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(PARTS):
        cols = {"sr_return_amt": rng.integers(0, 10_000_00, ROWS_PER_PART),
                "sr_store_sk": rng.integers(1, 400, ROWS_PER_PART),
                "sr_customer_sk": rng.integers(1, 100_000, ROWS_PER_PART)}
        out = {}
        for name in SCHEMA.names:
            v = rng.random(ROWS_PER_PART) >= nulls if name != "sr_customer_sk" \
                else np.ones(ROWS_PER_PART, bool)
            out[name] = (np.where(v, cols[name], 0), v)
        parts.append(out)
    return parts


def _arrow_batches(part):
    out = []
    for s in range(0, ROWS_PER_PART, BATCH):
        arrs = []
        for f in SCHEMA.fields:
            d, v = part[f.name]
            d, v = d[s:s + BATCH], v[s:s + BATCH]
            if isinstance(f.dtype, JT.DecimalType):
                vals = [decimal.Decimal(int(x)).scaleb(-2) if ok else None
                        for x, ok in zip(d, v)]
                arrs.append(pa.array(vals, type=pa.decimal128(7, 2)))
            else:
                arrs.append(pa.array(d, type=pa.int64(), mask=~v))
        out.append(pa.record_batch(arrs, names=SCHEMA.names))
    return out


def _numpy_batches(part):
    return [{k: (d[s:s + BATCH], v[s:s + BATCH]) for k, (d, v) in part.items()}
            for s in range(0, ROWS_PER_PART, BATCH)]


def _two_stage(child, key, aggs):
    keys = [(key, JE.Column(key))]
    partial = JN.Agg(child, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, n) for n, a in aggs],
                     supports_partial_skipping=True)
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([JE.Column(key)], PARTS))
    return JN.Agg(ex, JE.AggExecMode.HASH_AGG, keys,
                  [JN.AggColumn(a, JE.AggMode.FINAL, n) for n, a in aggs])


def _q01(key="sr_store_sk", aggs=None, sort=None, limit=100):
    """bench.py:plan_q01 over an FFIReader source."""
    scan = JN.FFIReader(SCHEMA, "store_returns", PARTS)
    filt = JN.Filter(scan, [JE.BinaryExpr(JE.BinaryOp.GT, JE.Column("sr_return_amt"),
                                          JE.Literal("500.00", AMT_T))])
    aggs = aggs or [
        ("total", JE.AggExpr(F.SUM, [JE.Column("sr_return_amt")], JT.DecimalType(17, 2))),
        ("cnt", JE.AggExpr(F.COUNT, []))]
    final = _two_stage(filt, key, aggs)
    sort = sort or [JE.SortOrder(JE.Column("total"), ascending=False)]
    return JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)), sort,
                   fetch_limit=limit)


def _run_both(plan, parts, conf=None):
    with JaxSession(conf=_jax_conf()) as s:
        s.resources["store_returns"] = lambda p: _arrow_batches(parts[p])
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    port.resources["store_returns"] = lambda p: _numpy_batches(parts[p])
    got = port.execute_to_pydict(from_foreign(plan))
    return want, got


def test_q01_matches_jax():
    want, got = _run_both(_q01(), _data(seed=1))
    assert len(want["sr_store_sk"]) == 100
    assert all(isinstance(t, decimal.Decimal) for t in got["total"])
    assert got == want


def test_q01_with_nulls_matches_jax():
    """Null store keys form one group (null key first in slot order);
    null amounts drop out of the filter."""
    plan = _q01(limit=500)
    want, got = _run_both(plan, _data(seed=2, nulls=0.1))
    assert None in got["sr_store_sk"]
    assert got == want


def test_q01_radix_plan_customer_keys_matches_jax():
    """Grouped by sr_customer_sk (100k key space): past
    dense_agg_max_buckets, so the radix slot plan and its bucket
    histogram run. Sorted by (total desc, key asc): no ties."""
    plan = _q01(key="sr_customer_sk",
                sort=[JE.SortOrder(JE.Column("total"), ascending=False),
                      JE.SortOrder(JE.Column("sr_customer_sk"))])
    want, got = _run_both(plan, _data(seed=3))
    assert got == want


def test_q01_avg_min_max_matches_jax():
    aggs = [("avg_amt", JE.AggExpr(F.AVG, [JE.Column("sr_return_amt")])),
            ("min_amt", JE.AggExpr(F.MIN, [JE.Column("sr_return_amt")])),
            ("max_amt", JE.AggExpr(F.MAX, [JE.Column("sr_return_amt")])),
            ("max_cust", JE.AggExpr(F.MAX, [JE.Column("sr_customer_sk")])),
            ("n_amt", JE.AggExpr(F.COUNT, [JE.Column("sr_return_amt")]))]
    plan = _q01(aggs=aggs, sort=[JE.SortOrder(JE.Column("avg_amt"), ascending=False),
                                 JE.SortOrder(JE.Column("sr_store_sk"))],
                limit=1000)
    want, got = _run_both(plan, _data(seed=4, nulls=0.05))
    assert got == want


def test_carry_round_trip_and_columns():
    plan = _q01()
    port_plan = from_foreign(plan)
    assert isinstance(port_plan, N.Sort)
    assert port_plan.output_schema.names == plan.output_schema.names
    assert repr(port_plan.output_schema.types) == repr(plan.output_schema.types)
    part = _data(seed=5, nulls=0.2)[0]
    batch = columns_from_numpy(SCHEMA, part)
    assert batch.num_rows == ROWS_PER_PART and batch.capacity == 16384
    for name, (d, v) in part.items():
        col = batch.columns[batch.schema.index_of(name)]
        np.testing.assert_array_equal(col.validity.numpy()[:ROWS_PER_PART], v)
        np.testing.assert_array_equal(col.data.numpy()[:ROWS_PER_PART], np.where(v, d, 0))
        assert not col.validity.numpy()[ROWS_PER_PART:].any()
        assert not col.data.numpy()[ROWS_PER_PART:].any()


def _store_join(join_type, condition=None):
    """store_returns joined with a store dimension (unique keys)."""
    dim = JT.Schema.of(("s_store_sk", JT.I64), ("s_state_id", JT.I64))
    return JN.BroadcastJoin(
        JN.FFIReader(SCHEMA, "store_returns", PARTS),
        JN.BroadcastExchange(JN.FFIReader(dim, "stores", 1)),
        [(JE.Column("sr_store_sk"), JE.Column("s_store_sk"))], join_type,
        JN.JoinSide.RIGHT, "stores", condition)


@pytest.mark.parametrize("variant", ["string_key", "float_sum", "wide_decimal",
                                     "left_join", "left_semi_join", "join_condition"])
def test_out_of_slice_plans_raise(variant):
    """Plans the slice does not cover raise NotImplementedError naming the
    ROADMAP item; there is no hidden host path."""
    conf = None
    parts = _data(seed=6)
    if variant == "string_key":
        schema = from_foreign(JT.Schema.of(("s", JT.STRING)))
        port = blaze_tpu_torch.Session(device="cpu")
        port.resources["src"] = lambda p: [{"s": np.array(["a", "b"])}]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.execute_to_pydict(N.FFIReader(schema, "src", 1))
        return
    if variant == "float_sum":
        # a decimal summed into a float
        plan = _q01(aggs=[("total", JE.AggExpr(F.SUM, [JE.Column("sr_return_amt")],
                                               JT.F64))])
    elif variant == "wide_decimal":
        plan = _q01(aggs=[("total", JE.AggExpr(F.SUM, [JE.Column("sr_return_amt")],
                                               JT.DecimalType(25, 2)))])
    elif variant == "left_join":
        # the sort-merge join is not ported (the hash joins are)
        join = _store_join(JN.JoinType.LEFT)
        plan = JN.SortMergeJoin(join.left, join.right.child, join.on, join.join_type)
    elif variant == "left_semi_join":
        # a shuffled hash join past its SMJ fallback threshold
        join = _store_join(JN.JoinType.LEFT_SEMI)
        plan = JN.HashJoin(join.left, join.right.child, join.on, join.join_type)
        conf = Config(smj_fallback_rows_threshold=100)
    elif variant == "join_condition":
        # a condition whose expression is not ported (Cast)
        plan = _store_join(JN.JoinType.INNER, JE.BinaryExpr(
            JE.BinaryOp.EQ, JE.Cast(JE.Column("s_state_id"), JT.I32), JE.Literal(3, JT.I32)))
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    port.resources["store_returns"] = lambda p: _numpy_batches(parts[p])
    port.resources["stores"] = lambda p: [
        {"s_store_sk": np.arange(1, 400), "s_state_id": np.arange(1, 400) % 50}]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.execute_to_pydict(from_foreign(plan))
