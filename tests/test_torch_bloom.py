"""The bloom runtime filter in the port against the JAX package.

- Blob bytes: ``SparkBloomFilter`` ``create``, ``put_longs``,
  ``serialize`` and ``deserialize`` against the reference's, for several
  (expected items, bits) pairs, 64 and 130 bits included; one put of all
  keys equals the reference's merge of two puts; blobs round-trip in both
  directions. ``murmur3_int64`` against the reference's hashLong.
- Probe bits: K16's twin (``ops/bloom.py might_contain_long_plain``)
  against the reference's device probe ``might_contain_long`` (jax on the
  CPU) and its ``might_contain_longs_np``, over the whole capacity, on
  chip_smoke.py's K16 battery (``BLOOM_CASES``, ``bloom_case``) and its
  numpy probe.
- The aggregate: tests/test_agg.py's test_bloom_filter_agg_and_probe on
  the port; the port's COMPLETE filter against the reference's COMPLETE
  and 4-partition PARTIAL -> FINAL filters; empty input (the empty
  filter, as the reference gives it) and null arguments; PARTIAL, FINAL
  and grouping keys raise.
- The expression: ``BloomFilterMightContain`` in a Filter and in a
  Projection, with a Literal and with a ScalarSubquery, over
  xxhash64(col) and over a bare int64 column, with null keys and a null
  filter, both packages through ``from_foreign``; the null check, not
  the probe, drops null keys; one deserialize per evaluator; a Filter
  holding the probe is not fused, in both packages alike.
- The BINARY host column the aggregate emits: the plane movers, an
  exchange and an expression refuse it naming ROADMAP.md item 6b.
- q69_bloom (chip_smoke.py ``q69_plan`` with Spark's runtime filter on
  the store side, ``q69_bloom_subquery`` the filter's subquery) at ~2,000
  customers in 4 partitions: both packages equal the q69 oracle, order
  included, and both compute the same filter.

Tolerance: exact everywhere (filter bytes, probe bits, query results).
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.exprs import spark_hash as JH
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ir.fusion import fuse_plan as jax_fuse_plan
from blaze_tpu.ops.bloom import SparkBloomFilter as JBloom
from blaze_tpu.ops.joins import bhj as JBHJ
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import BytesColumn, ColumnarBatch, DeviceColumn, column_planes
from blaze_tpu_torch.exprs import spark_hash as H
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ir.fusion import fuse_plan
from blaze_tpu_torch.ops import bloom as B
from chip_smoke import (BLOOM_CASES, Q69_KEYS, bloom_case, bloom_np_probe, q69_bloom_subquery,
                        q69_plan)
from tests.test_torch_generic_joins import Q69_BATCH, Q69_SCHEMAS, STATES, _q69_oracle, \
    _q69_tables
from tests.test_torch_generic_joins import _port as _port_tables
from tests.test_torch_generic_joins import _reference as _reference_tables

torch.set_num_threads(1)

C = JE.Column
SIZES = [(1_000_000, 8_388_608), (3, 64), (10, 130), (1_000, 4_096), (50_000, 1 << 20)]


@pytest.fixture
def shm(tmp_path):
    """Each reference session's shm root goes under the test's tmp_path, not
    /dev/shm, where tests/test_zero_copy.py's glob would see it."""
    return str(tmp_path)


def _values(rng, n):
    v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64, endpoint=True)
    v[:4] = [-(1 << 63), (1 << 63) - 1, 0, -1]
    return v


# -- the filter itself ---------------------------------------------------------------


@pytest.mark.parametrize("seeds", [0, 42, None], ids=["seed0", "seed42", "per_row"])
def test_murmur3_int64_matches_the_reference(seeds):
    rng = np.random.default_rng(3)
    v = _values(rng, 4096)
    s = rng.integers(0, 1 << 32, 4096).astype(np.uint32) if seeds is None \
        else np.full(4096, seeds, np.uint32)
    want = np.asarray(JH.murmur3_int64(jnp.asarray(v), jnp.asarray(s)))
    got = H.murmur3_int64(torch.from_numpy(v), torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("size", SIZES, ids=[f"{e}_{b}" for e, b in SIZES])
def test_blob_bytes_match_the_reference(size):
    items, bits = size
    rng = np.random.default_rng(bits)
    port, ref = B.SparkBloomFilter.create(items, bits), JBloom.create(items, bits)
    assert (port.num_hash_functions, port.bit_size) == (ref.num_hash_functions, ref.bit_size)
    assert port.serialize() == ref.serialize()
    vals = _values(rng, 500)
    port.put_longs(vals[:300])
    ref.put_longs(vals[:300])
    port.put_longs(np.zeros(0, np.int64))
    ref.put_longs(np.zeros(0, np.int64))
    assert port.serialize() == ref.serialize()
    # the rest of the keys: one more put equals the reference's merge of a
    # second filter of the same shape (the OR of the bitmaps)
    r2 = JBloom.create(items, bits)
    r2.put_longs(vals[300:])
    ref.merge(r2)
    port.put_longs(vals[300:])
    blob = ref.serialize()
    assert port.serialize() == blob
    # round trips, both ways
    assert B.SparkBloomFilter.deserialize(blob).serialize() == blob
    assert JBloom.deserialize(port.serialize()).serialize() == blob
    assert B.SparkBloomFilter.deserialize(ref.serialize()).num_hash_functions == \
        ref.num_hash_functions


def test_oversized_filters_and_other_versions_raise():
    with pytest.raises(ValueError, match="2\\^31"):
        B.SparkBloomFilter(np.zeros(1 << 25, np.uint64), 3)
    blob = B.SparkBloomFilter.create(100, 1024).serialize()
    with pytest.raises(ValueError, match="version"):
        B.SparkBloomFilter.deserialize(b"\x00\x00\x00\x02" + blob[4:])


@pytest.mark.parametrize("case", BLOOM_CASES, ids=[c[0] for c in BLOOM_CASES])
def test_probe_twin_matches_the_reference(case):
    """K16's twin over the whole capacity, padding included, against the
    reference's device probe (jax on the CPU), its numpy probe and
    chip_smoke.py's numpy probe."""
    vals, words, k, bits = bloom_case(case, np.random.default_rng(len(case[0])))
    ref = JBloom(words.copy(), k)
    want = np.asarray(ref.might_contain_long(jnp.asarray(vals)))
    np.testing.assert_array_equal(ref.might_contain_longs_np(vals), want)
    np.testing.assert_array_equal(bloom_np_probe(words, k, vals), want)
    got = B.might_contain_long_plain(torch.from_numpy(vals),
                                     torch.from_numpy(words.view(np.int64)), k, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    port = B.SparkBloomFilter(words.copy(), k)
    np.testing.assert_array_equal(port.might_contain_long(torch.from_numpy(vals)).numpy(),
                                  want)
    if case[5] == 0.0 and case[4] == case[3] and case[4] >= 4096:
        assert 0 < want.sum() < len(want)  # hits and misses


def test_probe_on_a_cpu_tensor_never_launches():
    from blaze_tpu_torch.utils import cuda_lib

    bf = B.SparkBloomFilter.create(100, 4096)
    bf.put_longs(np.arange(10))
    cuda_lib.reset_launch_counts()
    got = bf.might_contain_long(torch.arange(20))
    assert got[:10].all() and cuda_lib.launch_counts()["bloom_probe"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        B.bloom_probe_cuda(torch.arange(20), bf.device_words(torch.device("cpu")),
                           bf.num_hash_functions, bf.bit_size)


# -- the aggregate ----------------------------------------------------------------------


SCHEMA = JT.Schema.of(("g", JT.I64), ("k", JT.I64))


def _parts(seed, n=3000, parts=4, nulls=0.15):
    rng = np.random.default_rng(seed)
    k = rng.integers(-5_000, 5_000, n)
    v = rng.random(n) >= nulls
    g = rng.integers(0, 3, n)
    cuts = np.linspace(0, n, parts + 1).astype(int)
    return [{"g": (g[a:b], np.ones(b - a, bool)), "k": (np.where(v, k, 0)[a:b], v[a:b])}
            for a, b in zip(cuts, cuts[1:])]


def _arrow(part):
    return pa.record_batch([pa.array(part[f.name][0], type=pa.int64(), mask=~part[f.name][1])
                            for f in SCHEMA.fields], names=SCHEMA.names)


def _slices(part, batch=512):
    n = len(part["k"][0])
    return [{c: (d[s:s + batch], v[s:s + batch]) for c, (d, v) in part.items()}
            for s in range(0, n, batch)] or [part]


def _reference(plan, parts, shm_dir):
    JBHJ.clear_build_cache()
    with JaxSession(conf=dataclasses.replace(JaxConfig(batch_size=512), shm_dir=shm_dir)) as s:
        s.resources["t"] = lambda p: [_arrow(b) for b in _slices(parts[p])]
        return s.execute_to_pydict(plan)


def _port(plan, parts):
    s = blaze_tpu_torch.Session(conf=Config(batch_size=512), device="cpu")
    s.resources["t"] = lambda p: _slices(parts[p])
    return s.execute_to_pydict(from_foreign(plan))


def _complete(arg):
    return JN.Agg(JN.ShuffleExchange(JN.FFIReader(SCHEMA, "t", 4), JN.SinglePartitioning(1)),
                  JE.AggExecMode.HASH_AGG, [],
                  [JN.AggColumn(JE.AggExpr(JE.AggFunction.BLOOM_FILTER, [arg]),
                                JE.AggMode.COMPLETE, "bf")])


def _two_stage(arg):
    agg = JE.AggExpr(JE.AggFunction.BLOOM_FILTER, [arg])
    partial = JN.Agg(JN.FFIReader(SCHEMA, "t", 4), JE.AggExecMode.HASH_AGG, [],
                     [JN.AggColumn(agg, JE.AggMode.PARTIAL, "bf")])
    return JN.Agg(JN.ShuffleExchange(partial, JN.SinglePartitioning(1)),
                  JE.AggExecMode.HASH_AGG, [], [JN.AggColumn(agg, JE.AggMode.FINAL, "bf")])


def test_bloom_filter_agg_and_probe():
    """tests/test_agg.py:211 on the port."""
    port = blaze_tpu_torch.Session(device="cpu")
    port.resources["t"] = lambda p: [{"v": np.array([10, 20, 30])}]
    plan = N.Agg(N.FFIReader(T.Schema.of(("v", T.I64)), "t", 1), E.AggExecMode.HASH_AGG, [],
                 [N.AggColumn(E.AggExpr(E.AggFunction.BLOOM_FILTER, [E.Column("v")]),
                              E.AggMode.COMPLETE, "bf")])
    blob = port.execute_to_pydict(plan)["bf"][0]
    bf = B.SparkBloomFilter.deserialize(blob)
    assert bf.might_contain_long(torch.tensor([10, 20, 30])).all()
    assert not bf.might_contain_long(torch.arange(1000, 1100)).any()
    ref = JBloom.deserialize(blob)
    assert ref.might_contain_longs_np(np.array([10, 20, 30])).all()
    assert not ref.might_contain_longs_np(np.arange(1000, 1100)).any()


def _hashes(keys, valid):
    """Spark's xxhash64 of int64 keys by the reference's hash (a null key
    hashes to the seed, 42)."""
    h = JH.xxhash64_int64(jnp.asarray(keys), jnp.full(len(keys), 42, jnp.uint64))
    return np.where(valid, np.asarray(h).view(np.int64), 42)


def test_complete_filter_equals_the_reference_complete_and_two_stage(shm):
    """The port's COMPLETE filter over 3,000 rows (15% null keys) in 4
    partitions is byte for byte the reference's COMPLETE filter and its
    PARTIAL -> FINAL filter (the OR of the partial bitmaps)."""
    parts = _parts(7)
    got = _port(_complete(C("k")), parts)
    assert len(got["bf"]) == 1
    assert got == _reference(_complete(C("k")), parts, shm)
    assert got == _reference(_two_stage(C("k")), parts, shm)
    valid = np.concatenate([p["k"][1] for p in parts])
    keys = np.concatenate([p["k"][0] for p in parts])
    assert JBloom.deserialize(got["bf"][0]).might_contain_longs_np(keys[valid]).all()


def test_filter_of_xxhash64_equals_the_reference_hash_and_put(shm):
    """bloom_filter(xxhash64(k)): the port's filter is the reference's put
    of the reference's hashes of every row (a null key hashes to 42, which
    is not null, so it is put, as Spark puts it). The reference's own
    aggregate is wrong here: its host table evaluates the argument through
    the evaluator's common-subexpression cache without resetting it a
    batch (blaze_tpu/ops/agg.py:859, compiler.py:228), so every batch after
    a task's first puts the first batch's hashes again (and a batch of
    another capacity raises); ROADMAP.md Queue 3."""
    parts = _parts(7)
    expr = JE.ScalarFunction("xxhash64", [C("k")])
    keys = np.concatenate([p["k"][0] for p in parts])
    valid = np.concatenate([p["k"][1] for p in parts])
    want = JBloom.create(1_000_000, 8_388_608)
    want.put_longs(_hashes(keys, valid))
    assert _port(_complete(expr), parts) == {"bf": [want.serialize()]}
    assert _reference(_two_stage(expr), parts, shm) != {"bf": [want.serialize()]}


def test_empty_input_gives_the_empty_filter(shm):
    """No rows: the reference emits the empty filter (Spark gives null), so
    nothing passes its probe; the port mirrors it."""
    parts = [{"g": (np.zeros(0, np.int64), np.zeros(0, bool)),
              "k": (np.zeros(0, np.int64), np.zeros(0, bool))}] * 4
    got = _port(_complete(C("k")), parts)
    assert got == _reference(_complete(C("k")), parts, shm)
    assert got["bf"][0] == JBloom.create(1_000_000, 8_388_608).serialize()
    bf = B.SparkBloomFilter.deserialize(got["bf"][0])
    assert not bf.might_contain_long(torch.arange(-500, 500)).any()


def test_all_null_arguments_put_nothing(shm):
    parts = _parts(8, nulls=1.0)
    got = _port(_complete(C("k")), parts)
    assert got == _reference(_complete(C("k")), parts, shm)
    assert got["bf"][0] == JBloom.create(1_000_000, 8_388_608).serialize()


@pytest.mark.parametrize("mode", ["PARTIAL", "FINAL", "keys"])
def test_partial_final_and_keyed_bloom_aggregates_raise(mode):
    agg = JE.AggExpr(JE.AggFunction.BLOOM_FILTER, [C("k")])
    scan = JN.FFIReader(SCHEMA, "t", 4)
    if mode == "PARTIAL":
        plan, match = JN.Agg(scan, JE.AggExecMode.HASH_AGG, [],
                             [JN.AggColumn(agg, JE.AggMode.PARTIAL, "bf")]), "6b"
    elif mode == "FINAL":
        plan, match = _two_stage(C("k")), "6b"
    else:
        plan, match = JN.Agg(scan, JE.AggExecMode.HASH_AGG, [("g", C("g"))],
                             [JN.AggColumn(agg, JE.AggMode.COMPLETE, "bf")]), "does not mirror"
    with pytest.raises(NotImplementedError, match=match):
        _port(plan, _parts(9))


# -- the expression -----------------------------------------------------------------


def _filter_blob(members, hashed, extra=()):
    ref = JBloom.create(2_000, 1 << 15)
    vals = np.asarray(members, np.int64)
    if hashed:
        vals = np.asarray(JH.xxhash64_int64(jnp.asarray(vals),
                                            jnp.full(len(vals), 42, jnp.uint64))).view(np.int64)
    ref.put_longs(np.concatenate([vals, np.asarray(extra, np.int64)]))
    return ref.serialize()


def _probe(blob, hashed, subquery):
    holder = (JE.ScalarSubquery if subquery else JE.Literal)(blob, JT.BINARY)
    value = JE.ScalarFunction("xxhash64", [C("k")]) if hashed else C("k")
    return JE.BloomFilterMightContain(holder, value)


@pytest.mark.parametrize("subquery", [False, True], ids=["literal", "scalar_subquery"])
@pytest.mark.parametrize("hashed", [True, False], ids=["xxhash64", "bare_column"])
@pytest.mark.parametrize("where", ["filter", "projection"])
def test_probe_expression_matches_the_reference(where, hashed, subquery, shm):
    """The probe over 3,000 rows with 15% null keys, 300 of 10,000 key
    values in the filter: the same rows kept (a Filter) or the same
    nullable bools (a Projection) in both packages."""
    parts = _parts(11)
    blob = _filter_blob(np.arange(-5_000, -4_700), hashed)
    probe = _probe(blob, hashed, subquery)
    scan = JN.FFIReader(SCHEMA, "t", 4)
    plan = JN.Filter(scan, [probe]) if where == "filter" else \
        JN.Projection(scan, [C("k"), probe], ["k", "hit"])
    got = _port(plan, parts)
    assert got == _reference(plan, parts, shm)
    if where == "filter":
        assert 0 < len(got["k"]) < 3000
    else:
        # xxhash64 is never null, so neither is its probe
        assert (None in got["hit"]) == (not hashed) and True in got["hit"] and \
            False in got["hit"]


@pytest.mark.parametrize("where", ["filter", "projection"])
def test_null_filter_gives_null(where, shm):
    parts = _parts(12)
    probe = JE.BloomFilterMightContain(JE.Literal(None, JT.BINARY),
                                       JE.ScalarFunction("xxhash64", [C("k")]))
    scan = JN.FFIReader(SCHEMA, "t", 4)
    plan = JN.Filter(scan, [probe]) if where == "filter" else \
        JN.Projection(scan, [probe], ["hit"])
    got = _port(plan, parts)
    assert got == _reference(plan, parts, shm)
    assert got == ({"g": [], "k": []} if where == "filter" else {"hit": [None] * 3000})


def test_null_keys_are_dropped_by_the_null_check_not_the_probe(shm):
    """xxhash64 of a null key is the seed, 42, and never null: with 42 in
    the filter (a null key on the creation side) the probe alone keeps the
    null-key rows; Spark's merged filter drops them through isnotnull."""
    parts = _parts(13)
    blob = _filter_blob(np.arange(-5_000, -4_700), True, extra=[42])
    scan = JN.FFIReader(SCHEMA, "t", 4)
    probe = _probe(blob, True, True)
    alone = _port(JN.Filter(scan, [probe]), parts)
    merged_plan = JN.Filter(scan, [JE.IsNotNull(C("k")), probe])
    merged = _port(merged_plan, parts)
    nulls = sum(int((~p["k"][1]).sum()) for p in parts)
    assert nulls > 300 and alone["k"].count(None) == nulls
    assert None not in merged["k"] and len(merged["k"]) == len(alone["k"]) - nulls
    assert alone == _reference(JN.Filter(scan, [probe]), parts, shm)
    assert merged == _reference(merged_plan, parts, shm)


def test_filter_is_deserialized_once_per_evaluator(monkeypatch):
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator

    calls = []
    real = B.SparkBloomFilter.deserialize
    monkeypatch.setattr(B.SparkBloomFilter, "deserialize",
                        staticmethod(lambda blob: calls.append(1) or real(blob)))
    probe = from_foreign(_probe(_filter_blob(np.arange(10), True), True, True))
    schema = from_foreign(SCHEMA)
    ev = ExprEvaluator([probe], schema)
    for part in _parts(14):
        ev.evaluate_predicate(ColumnarBatch.from_numpy(schema, part, torch.device("cpu")))
    assert len(calls) == 1


def test_filter_from_a_column_raises_naming_6b():
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator

    schema = T.Schema.of(("k", T.I64))
    probe = E.BloomFilterMightContain(E.Column("k"), E.Column("k"))
    batch = ColumnarBatch.from_numpy(schema, {"k": np.arange(4)}, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="6b"):
        ExprEvaluator([probe], schema).evaluate(batch)


def test_scalar_subquery_of_a_device_type_is_a_literal():
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator

    schema = T.Schema.of(("k", T.I64))
    batch = ColumnarBatch.from_numpy(schema, {"k": np.arange(4)}, torch.device("cpu"))
    plus = E.BinaryExpr(E.BinaryOp.ADD, E.Column("k"), E.ScalarSubquery(10, T.I64))
    (col,) = ExprEvaluator([plus], schema).evaluate(batch)
    assert col.data[:4].tolist() == [10, 11, 12, 13]


def test_binary_literal_and_subquery_carry_across():
    blob = _filter_blob([1, 2, 3], True)
    for cls in (JE.Literal, JE.ScalarSubquery):
        got = from_foreign(JE.BloomFilterMightContain(cls(blob, JT.BINARY), C("k")))
        holder = got.bloom_filter
        assert type(holder).__name__ == cls.__name__ and isinstance(holder.dtype, T.BinaryType)
        assert holder.value is blob


def test_a_filter_with_the_probe_is_not_fused_in_either_package():
    """The probe is not fusable (blaze_tpu/exprs/compiler.py:966): its
    Filter breaks the chain in both packages, the same fusion decision."""
    scan = JN.FFIReader(SCHEMA, "t", 4)
    probe = _probe(_filter_blob([1], True), True, True)
    notnull = JE.IsNotNull(C("k"))
    plan = JN.Projection(JN.Filter(JN.Filter(scan, [notnull]), [notnull, probe]),
                         [C("k")], ["k"])
    want = from_foreign(jax_fuse_plan(plan, JaxConfig()))
    got = fuse_plan(from_foreign(plan), Config())
    assert got == want
    assert isinstance(got.child, N.Filter) and len(got.child.predicates) == 2
    assert isinstance(got.child.child, N.FusedStage)


# -- the BINARY host column --------------------------------------------------------------


def _bytes_batch():
    schema = T.Schema.of(("n", T.I64), ("bf", T.BINARY))
    n = DeviceColumn.from_numpy(T.I64, np.arange(2), None, 16, torch.device("cpu"))
    return ColumnarBatch(schema, [n, BytesColumn.from_values(T.BINARY, [b"ab", None], 16)], 2)


def test_bytes_column_reads_back_and_movers_raise_naming_6b():
    b = _bytes_batch()
    assert b.to_pydict() == {"n": [0, 1], "bf": [b"ab", None]}
    assert b.device == torch.device("cpu") and b.capacity == 16
    for move in (lambda: b.take(torch.tensor([1, 0])), lambda: b.slice(0, 1),
                 lambda: ColumnarBatch.concat([b, b]),
                 lambda: K.compact_planes(*column_planes(b.columns),
                                          torch.ones(16, dtype=torch.bool))):
        with pytest.raises(NotImplementedError, match="6b"):
            move()


@pytest.mark.parametrize("node", ["exchange", "hash_exchange", "broadcast", "expression",
                                  "sort"])
def test_bytes_column_in_a_plan_raises_naming_6b(node):
    b = _bytes_batch()
    s = blaze_tpu_torch.Session(device="cpu")
    s.resources["src"] = lambda p: [b]
    src = N.BatchSource(b.schema, "src", 1)
    plan = {
        "exchange": lambda: N.ShuffleExchange(src, N.SinglePartitioning(1)),
        "hash_exchange": lambda: N.ShuffleExchange(src, N.HashPartitioning([E.Column("n")], 2)),
        "broadcast": lambda: N.BroadcastJoin(
            N.FFIReader(T.Schema.of(("m", T.I64)), "m", 1), N.BroadcastExchange(src),
            [(E.Column("m"), E.Column("n"))], N.JoinType.INNER, N.JoinSide.RIGHT, "bf"),
        "expression": lambda: N.Projection(src, [E.IsNull(E.Column("bf"))], ["x"]),
        "sort": lambda: N.Sort(src, [E.SortOrder(E.Column("n"), ascending=False)]),
    }[node]()
    s.resources["m"] = lambda p: [{"m": np.arange(3)}]
    with pytest.raises(NotImplementedError, match="6b"):
        s.execute_to_pydict(plan)


# -- q69_bloom at a small size ---------------------------------------------------------


def test_q69_bloom_matches_jax_and_the_oracle(shm):
    """q69 at ~2,000 customers in 4 partitions with Spark's runtime filter
    on the store side: the subquery's filter is the reference's put of the
    reference's hashes of the creation side's customers (the reference's
    own aggregate over xxhash64 is wrong past a task's first batch:
    test_filter_of_xxhash64_equals_the_reference_hash_and_put), and
    q69_bloom with it equals the q69 oracle, the JAX package's result and
    q69 without the filter, order included."""
    tables = _q69_tables(seed=69)
    want = _q69_oracle(tables, list(Q69_KEYS))
    sub = q69_bloom_subquery(Q69_SCHEMAS, JE, JN, JT, states=STATES, parts=4)
    blob = _port_tables(sub, tables, batch=Q69_BATCH)["bf"][0]
    # the creation side: customers with both foreign keys, in the states
    addr = tables["customer_address"][0]
    in_states = addr["ca_address_sk"][0][np.isin(addr["ca_state_id"][0], STATES)]
    (c_sk, _), (c_addr, addr_ok), (_, cd_ok) = (
        (np.concatenate([p[c][0] for p in tables["customer"]]),
         np.concatenate([p[c][1] for p in tables["customer"]]))
        for c in ("c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk"))
    creation = c_sk[addr_ok & cd_ok & np.isin(c_addr, in_states)]
    want_bf = JBloom.create(1_000_000, 8_388_608)
    want_bf.put_longs(_hashes(creation, np.ones(len(creation), bool)))
    assert blob == want_bf.serialize() and 100 < len(creation) < 2_000
    plan = q69_plan(Q69_SCHEMAS, JE, JN, JT, states=STATES, parts=4, bloom=blob)
    got = _port_tables(plan, tables, batch=Q69_BATCH)
    assert 50 <= len(got["cnt"]) <= 100 and got == want
    assert _reference_tables(plan, tables, Q69_SCHEMAS, batch=Q69_BATCH, shm_dir=shm) == want
    plain = q69_plan(Q69_SCHEMAS, JE, JN, JT, states=STATES, parts=4)
    assert _port_tables(plain, tables, batch=Q69_BATCH) == want
    # the store filter is the one Filter the probe keeps out of fusion
    stages = [n for n in _walk(fuse_plan(from_foreign(plan), Config()))
              if isinstance(n, N.FusedStage)]
    assert len(stages) == 7
    assert from_foreign(jax_fuse_plan(plan, JaxConfig())) == \
        fuse_plan(from_foreign(plan), Config())


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)
