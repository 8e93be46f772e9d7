"""Adaptive partial skipping on the port against the JAX package: K19's
plain twin (``core/kernels.passthrough_states_plain``) against
``_passthrough_kernel``, the skipper's decisions against
``_PartialSkipper``, the radix histogram against ``radix_histogram``, and
plans that skip (or must not) through both Sessions.

- Kernel level: chip_smoke.py's battery (``PASS_CASES``: every partial
  kind, int64/int32/float64/float32/decimal arguments with a rescale that
  wraps int64, one to three int32/int64 keys and a float key, nulls,
  padding, -0.0, NaN, +-inf, 38-digit limbs, capacities 256 and 4,096)
  drawn from a seed with numpy goes through the jitted reference kernel on
  the CPU and through the twin; every output plane must be equal bit for
  bit. ``DevicePartialAgger.passthrough`` of both packages on the same
  batch, and an empty batch (None in both).
- Plan level: plans built with ``blaze_tpu.ir`` and carried across with
  ``from_foreign`` run through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")``; results equal, order
  included (the host table's FINAL over another table's output compares
  rows as a set: its slot order follows the partial table's), and the
  skipped batch counts equal where the reference counts them.

Tolerance: none. Float planes compare by their bits (NaN inputs are the
quiet NaN on both sides); results compare floats by repr. Inputs hold no
subnormal floats: the JAX package flushes them on the CPU (ROADMAP.md
Queue 3).
"""

import collections
import dataclasses
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.config import config_override
from blaze_tpu.core import ColumnarBatch as JBatch
from blaze_tpu.core import kernels as JK
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops import agg_device as JA
from blaze_tpu.ops.agg import AggExec as JAggExec
from blaze_tpu.ops.agg import _PartialSkipper as JSkipper
from blaze_tpu.ops.base import ExecContext as JExecContext
from blaze_tpu.runtime.metrics import MetricNode
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ops import agg_device as A
from blaze_tpu_torch.ops.agg import AggExec, _PartialSkipper, _SchemaSource
from chip_smoke import (PASS_CASES, cust_spend_host, cust_spend_oracle, cust_spend_plan,
                        cust_spend_schema, cust_table_plan, pass_case, pass_inputs)
from tests.util import mem_scan

torch.set_num_threads(1)

F = JE.AggFunction
M = JE.AggMode
HASH = JE.AggExecMode.HASH_AGG
C = JE.Column

_SHM = {}


@pytest.fixture(autouse=True)
def _shm_in_tmp_path(tmp_path):
    """Each reference session's shm root goes under the test's tmp_path, not
    /dev/shm, where tests/test_zero_copy.py's glob would see it."""
    _SHM["dir"] = str(tmp_path)
    yield
    del _SHM["dir"]


def _jax_conf(**kw):
    return JaxConfig(shm_dir=_SHM["dir"], **kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.kind in "fb" else a


def _same(j, t):
    """Equal planes: dtype, shape and bits (so -0.0 is not 0.0)."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    bad = np.nonzero(_bits(j) != _bits(t))[0]
    assert not len(bad), (bad[:8], j.ravel()[bad[:8] // max(1, j.itemsize)])


# -- kernel level: K19's twin against _passthrough_kernel ------------------------


def _jax_passthrough(keys, kvalids, specs, args, exists):
    cap = len(exists)
    jk = JA._passthrough_kernel(
        tuple(str(k.dtype) for k in keys), specs,
        tuple("wide3" if isinstance(d, tuple) else str(d.dtype) for d, _ in args), cap)
    flat = []
    for d, v in zip(keys, kvalids):
        flat += [jnp.asarray(d), jnp.asarray(v & exists)]
    for d, v in args:
        planes = d if isinstance(d, tuple) else (d,)
        flat += [jnp.asarray(p) for p in planes] + [jnp.asarray(v & exists)]
    return jk(jnp.asarray(exists), *flat)


@pytest.mark.parametrize("case", PASS_CASES, ids=[c[0] for c in PASS_CASES])
def test_passthrough_twin_matches_jax(case):
    """Every output of ``_passthrough_kernel`` against the twin: the group
    count (the row count), the row mask, each key zeroed where null with
    its validity, each aggregate's state planes."""
    host = pass_case(case, np.random.default_rng(sum(map(ord, case[0]))), subnormals=False)
    keys, kvalids, specs, args = host
    cap, n = case[2], case[3]
    jouts = _jax_passthrough(keys, kvalids, specs, args, np.arange(cap) < n)
    touts = K.passthrough_states_plain(*pass_inputs(host, n, "cpu"))
    assert len(jouts) == len(touts) and int(jouts[0]) == touts[0] == n
    for j, t in zip(jouts[1:], touts[1:]):
        _same(j, t)


def _pass_words_point_at(w, args, key_out, outs):
    """The words of one batch point at its planes and its outputs."""
    keys, kvalids, _exists, n, ops, _emits = args
    assert w[K._PW_ROWS] == n and w[K._PW_K] == len(keys)
    for j, (d, v, o) in enumerate(zip(keys, kvalids, key_out)):
        b = K._PASS_HEAD + j * K._PASS_KEY_WORDS
        assert (w[b], w[b + 1], w[b + 2]) == (d.data_ptr(), v.data_ptr(), o.data_ptr())
    for o, op in enumerate(ops):
        b = K._PASS_OPS_AT + o * K._PASS_OP_WORDS
        assert w[b + 3] == (0 if op.src is None else op.src.data_ptr())
        assert w[b + 4] == (0 if op.src0 is None else op.src0.data_ptr())
        assert [w[b + 5 + q] for q in range(len(op.valids))] == [v.data_ptr()
                                                                 for v in op.valids]
        assert w[b + 9] == K._bits(op)  # the init's bits, a float's from struct
    for c, out in enumerate(outs):
        assert w[K._PASS_EMITS_AT + c * K._PASS_EMIT_WORDS + 6] == out.data_ptr()


@pytest.mark.parametrize("case", PASS_CASES[:5], ids=[c[0] for c in PASS_CASES[:5]])
def test_passthrough_pack_reuses_the_program_across_a_tasks_batches(case):
    """K19's argument words, one pack a task: three batches of one program
    pack it once, each batch writing only its planes' and outputs'
    pointers (CPU tensors' data_ptr stand in for the card's); the outputs
    are the twin's dtypes and shapes."""
    rng = np.random.default_rng(len(case[0]))
    pack = K.PassthroughPack()
    words = []
    for _ in range(3):
        args = pass_inputs(pass_case(case, rng), case[3], "cpu")
        w, key_out, outs = pack.bind(*args)
        words.append(w)
        _pass_words_point_at(w, args, key_out, outs)
        want = K.passthrough_states_plain(*args)
        got = [o for d, _v in zip(key_out, args[1]) for o in (d, None)] + outs
        for g, t in zip(got, want[2:]):
            if g is not None:
                assert (g.dtype, g.shape) == (t.dtype, t.shape)
    assert words[0] is words[1] is words[2]


def test_passthrough_pack_repacks_when_the_program_changes():
    """Another program packs anew: other ops (another case), the same ops
    at another capacity, a float init, and a key of another width; a
    plane of the wrong dtype or length is refused on every batch."""
    rng = np.random.default_rng(11)
    pack = K.PassthroughPack()
    first = pass_inputs(pass_case(PASS_CASES[0], rng), PASS_CASES[0][3], "cpu")
    w0, _, _ = pack.bind(*first)
    for case in (PASS_CASES[1], PASS_CASES[2], PASS_CASES[0]):
        args = pass_inputs(pass_case(case, rng), case[3], "cpu")
        w, key_out, outs = pack.bind(*args)
        assert w is not w0 and w[K._PW_CAP] == case[2] and w[K._PW_NOPS] == len(args[4])
        _pass_words_point_at(w, args, key_out, outs)
        w0 = w
    keys, kvalids, exists, n, ops, emits = args
    w, _, _ = pack.bind([keys[0].to(torch.int32)], kvalids, exists, n, ops, emits)
    assert w is not w0 and w[K._PASS_HEAD + 3] == 4
    ops[0].src = ops[0].src.to(torch.int32)
    with pytest.raises(TypeError, match="passthrough_states"):
        pack.bind(keys, kvalids, exists, n, ops, emits)
    with pytest.raises(TypeError, match="passthrough_states"):
        pack.bind([keys[0][:8]], kvalids, exists, n, ops, emits)


def test_passthrough_state_semantics():
    """The traps of a one-row segment: a float sum starts from +0.0 (-0.0
    sums to +0.0, NaN stays NaN), a rescaled int64 sum wraps, float32
    MIN keeps its type, COUNT of a null is 0, padding is 0 and invalid."""
    cap, n = 256, 5
    exists = torch.arange(cap) < n
    x = torch.zeros(cap, dtype=torch.float64)
    x[:5] = torch.tensor([-0.0, float("nan"), float("inf"), 2.5, -1.0])
    xv = exists & (torch.arange(cap) != 4)
    e = torch.zeros(cap, dtype=torch.int64)
    e[:5] = torch.tensor([(1 << 62) + 1, -1, 3, 0, 7])
    y = x.to(torch.float32)
    key = torch.arange(cap, dtype=torch.int32)
    specs = (("sum", 0, "float64"), ("sum", 2, "int64"), ("min", 0, ""), ("count", 0, ""))
    ops, emits = A._partial_program(specs, [(x, xv), (e, exists), (y, xv), (x, xv)])
    outs = K.passthrough_states_plain([key], [exists], exists, n, ops, emits)
    s, has, esum, _ehas, mn, mhas, cnt = outs[4:]
    assert s[:5].view(torch.int64).tolist()[0] == 0  # +0.0
    assert torch.isnan(s[1]) and s[2] == float("inf") and s[3] == 2.5 and s[4] == 0.0
    assert has[:6].tolist() == [True, True, True, True, False, False]
    assert esum[0] == ((((1 << 62) + 1) * 100 + (1 << 63)) % (1 << 64)) - (1 << 63)
    assert mn.dtype == torch.float32 and torch.signbit(mn[0]) and mn[4] == 0.0
    assert cnt[:6].tolist() == [1, 1, 1, 1, 0, 0]
    assert outs[2][5:].eq(0).all() and not outs[3][5:].any()


def _agg_batches(rng, cap, n):
    """One batch of every argument type for ``DevicePartialAgger``: keys
    int32 and int64, int64/int32/float64/float32 and a decimal(12,2)
    argument (its SUM and AVG are two-limb states), nulls, padding."""
    floats = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -2.25, 1e300, 7.0])
    cols = {"k1": rng.integers(-30, 30, n).astype(np.int32),
            "k2": rng.integers(0, 1 << 40, n),
            "a": rng.integers(-(1 << 62), 1 << 62, n),
            "b": rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int32),
            "x": floats[rng.integers(0, len(floats), n)],
            "d": rng.integers(-(10 ** 12) + 1, 10 ** 12, n)}
    with np.errstate(over="ignore"):
        cols["y"] = floats[rng.integers(0, len(floats), n)].astype(np.float32)
    valid = {k: rng.random(n) >= 0.15 for k in cols}
    schema = JT.Schema.of(("k1", JT.I32), ("k2", JT.I64), ("a", JT.I64), ("b", JT.I32),
                          ("x", JT.F64), ("d", JT.DecimalType(12, 2)), ("y", JT.F32))
    arrays = []
    for f in schema.fields:
        d, v = cols[f.name], valid[f.name]
        if isinstance(f.dtype, JT.DecimalType):
            d = [decimal.Decimal(int(z)).scaleb(-2) for z in d]
        arrays.append(pa.array(d, type=JT.to_arrow_type(f.dtype), mask=~v))
    jbatch = JBatch.from_arrow(pa.record_batch(arrays, names=schema.names), schema, cap)
    port_schema = from_foreign(schema)
    tbatch = ColumnarBatch.from_numpy(port_schema, {k: (cols[k], valid[k]) for k in cols},
                                      torch.device("cpu"), capacity=cap)
    return schema, jbatch, tbatch


def _aggs(cols):
    out = [("cnt", JE.AggExpr(F.COUNT, []))]
    for c in cols:
        out += [(f"s_{c}", JE.AggExpr(F.SUM, [C(c)])), (f"a_{c}", JE.AggExpr(F.AVG, [C(c)])),
                (f"c_{c}", JE.AggExpr(F.COUNT, [C(c)]))]
        if c != "d":
            out += [(f"mn_{c}", JE.AggExpr(F.MIN, [C(c)])),
                    (f"mx_{c}", JE.AggExpr(F.MAX, [C(c)]))]
    return out


@pytest.mark.parametrize("cap,n", [(256, 200), (4096, 4096), (256, 0)])
def test_agger_passthrough_matches_jax(cap, n):
    """``DevicePartialAgger.passthrough`` of both packages on the same
    batch: every column's data and validity, capacity-long (an empty
    batch: None in both)."""
    schema, jbatch, tbatch = _agg_batches(np.random.default_rng(cap + n), cap, n)
    node = JN.Agg(JN.FFIReader(schema, "src", 1), HASH, [("k1", C("k1")), ("k2", C("k2"))],
                  [JN.AggColumn(a, M.PARTIAL, name) for name, a in _aggs("abxyd")],
                  supports_partial_skipping=True)
    jop = JAggExec(mem_scan({f.name: [] for f in schema.fields}, schema), HASH,
                   node.groupings, node.aggs, True)
    pnode = from_foreign(node)
    top = AggExec(_SchemaSource(pnode.child.schema), pnode.exec_mode, pnode.groupings,
                  pnode.aggs, True)
    want = JA.DevicePartialAgger(jop, schema, conf=_jax_conf()).passthrough(jbatch)
    got = A.DevicePartialAgger(top, pnode.child.schema, Config()).passthrough(tbatch)
    if n == 0:
        assert want is None and got is None
        return
    assert want.num_rows == got.num_rows == n
    assert [f.name for f in want.schema.fields] == [f.name for f in got.schema.fields]
    for jc, tc in zip(want.columns, got.columns):
        _same(jc.data, tc.data)
        _same(jc.validity, tc.validity)


# -- the skipper's decisions ---------------------------------------------------------


def _skippers(min_rows, ratio):
    with config_override(partial_agg_skipping_min_rows=min_rows,
                         partial_agg_skipping_ratio=ratio):
        ref = JSkipper(None, JExecContext())
    return ref, _PartialSkipper(Config(partial_agg_skipping_min_rows=min_rows,
                                       partial_agg_skipping_ratio=ratio))


@pytest.mark.parametrize("rows,groups,nb", [(60, 5, 256), (60, 59, 256), (10, 10, 4)])
def test_skipper_bucket_cases_match_jax(rows, groups, nb):
    """test_radix_agg.py:135's three cases: few groups a bucket, near-unique
    buckets, and under min_rows with no table."""
    ref, port = _skippers(10_000, 0.9)
    for sk in (ref, port):
        sk.observe_buckets(np.full(nb, rows, np.int64), np.full(nb, groups, np.int64))
    assert ref.should_skip() == port.should_skip()
    assert port.should_skip() == (groups == 59)


@pytest.mark.parametrize("seed", range(6))
def test_skipper_random_histograms_match_jax(seed):
    """Random per-bucket histograms batch after batch (groups past rows in
    some buckets: min() caps them): the same decision after each batch."""
    rng = np.random.default_rng(seed)
    ref, port = _skippers(int(rng.integers(1_000, 40_000)), float(rng.uniform(0.5, 0.99)))
    decisions = []
    for _ in range(8):
        rows = rng.integers(0, 200, 256).astype(np.int64)
        groups = (rows * rng.uniform(0.3, 1.2, 256)).astype(np.int64)
        ref.observe_buckets(rows, groups)
        port.observe_buckets(rows, groups)
        assert ref.should_skip() == port.should_skip()
        decisions.append(port.should_skip())
    assert len(set(decisions)) >= 1


@pytest.mark.parametrize("processed,slots,observed", [
    (40_000, 39_000, 0), (60_000, 59_000, 0), (60_000, 30_000, 0), (60_000, 59_000, 2_000)])
def test_skipper_table_fallback_matches_jax(processed, slots, observed):
    """The whole-table ratio when the histograms saw fewer than min_rows
    rows (and none when the table took fewer)."""
    table = collections.namedtuple("T", "rows_processed num_slots")(processed, slots)
    ref, port = _skippers(50_000, 0.9)
    for sk in (ref, port):
        if observed:
            sk.observe_buckets(np.array([observed], np.int64), np.array([observed], np.int64))
    assert ref.should_skip(table) == port.should_skip(table)
    assert port.should_skip(table) == (processed >= 50_000 and slots / processed > 0.9)


# -- K3's histogram against radix_histogram (repair 0b) --------------------------------


@pytest.mark.parametrize("n,ka,kb", [(4000, 2000, 400), (4096, 300, 7), (100, 50_000, 3)])
def test_slot_histogram_matches_radix_histogram(n, ka, kb):
    """K3's twin with a histogram against ``_dense_partial_kernel``'s and
    against ``radix_histogram`` over the reference's ``radix_pack``."""
    rng = np.random.default_rng(n + ka)
    cap = 4096
    exists = np.arange(cap) < n
    keys = [np.where(exists, rng.integers(0, ka, cap), 0),
            np.where(exists, rng.integers(-kb, kb, cap), 0)]
    kvalids = [exists & (rng.random(cap) >= 0.05) for _ in keys]
    specs = (("count", 0, ""), ("sum", 0, "int64"))
    vals = rng.integers(-100, 100, cap)
    args = [(np.zeros(cap, np.int64), exists), (vals, exists & (rng.random(cap) >= 0.1))]
    t = [torch.from_numpy(k) for k in keys]
    tv = [torch.from_numpy(v) for v in kvalids]
    conf = Config()
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(t, tv), cap, None,
                                              conf.radix_agg_max_slots, conf)
    nbuck = conf.radix_agg_buckets
    touts = A.slot_agg_partial_plain(t, tv, [torch.int64] * 2, n, bases, sizes, specs,
                                     [(torch.from_numpy(d), torch.from_numpy(v))
                                      for d, v in args], out_cap, nbuck)
    jk = JA._dense_partial_kernel(("int64", "int64"), specs, ("int64", "int64"), cap, sizes,
                                  out_cap, nbuck)
    flat = []
    for d, v in zip(keys, kvalids):
        flat += [jnp.asarray(d), jnp.asarray(v)]
    for d, v in args:
        flat += [jnp.asarray(d), jnp.asarray(v)]
    jouts = jk(jnp.asarray(exists), jnp.asarray(np.asarray(bases, np.int64)), *flat)
    _same(jouts[-2], touts[-2])
    _same(jouts[-1], touts[-1])
    S = int(np.prod(sizes))
    seg, _fits = JK.radix_pack([jnp.asarray(k) for k in keys],
                               [jnp.asarray(v) for v in kvalids], jnp.asarray(exists),
                               jnp.asarray(np.asarray(bases, np.int64)), sizes,
                               JK.radix_strides(sizes))
    present = jnp.zeros(S, bool).at[seg].max(jnp.asarray(exists), mode="drop")
    rows, groups = JK.radix_histogram(seg, jnp.asarray(exists), present, S, nbuck)
    _same(rows, touts[-2])
    _same(groups, touts[-1])
    head = A.slot_agg_partial(t, tv, [torch.int64] * 2, n, bases, sizes, (), (), out_cap,
                              nbuck, host_head=True)
    assert head[0] == int(touts[0])
    _same(rows, head[-2])
    _same(groups, head[-1])


# -- plans through both Sessions -------------------------------------------------------


def _arrow(schema, batch):
    arrays = []
    for f in schema.fields:
        d, v = batch[f.name]
        if isinstance(f.dtype, JT.DecimalType):
            d = [decimal.Decimal(int(z)).scaleb(-f.dtype.scale) for z in d]
        arrays.append(pa.array(d, type=JT.to_arrow_type(f.dtype), mask=~v))
    return pa.record_batch(arrays, names=schema.names)


def _canon(d):
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _run_both(plan, schema, parts, jconf, conf, rid="src"):
    """(reference result, port result, reference skipped batches, port
    skipped batches): ``parts`` is per partition a list of {column: (data,
    validity)} batches, the source ``rid``."""
    with JaxSession(conf=dataclasses.replace(jconf, shm_dir=_SHM["dir"])) as s:
        s.resources[rid] = lambda p: [_arrow(schema, b) for b in parts[p]]
        want = s.execute_to_pydict(plan)
        jskipped = s.metrics.total("partial_skipped_batches")
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    port.resources[rid] = lambda p: parts[p]
    got = port.execute_to_pydict(from_foreign(plan))
    return _canon(want), _canon(got), jskipped, port.counters["partial_skipped_batches"]


def _parts(rng, nparts, nbatch, rows, cols):
    """``cols`` maps a column to a draw (rng, n) -> (data, validity)."""
    return [[{c: draw(rng, rows) for c, draw in cols.items()} for _ in range(nbatch)]
            for _ in range(nparts)]


def _ints(lo, hi, nulls=0.0, dtype=np.int64):
    return lambda rng, n: (rng.integers(lo, hi, n).astype(dtype), rng.random(n) >= nulls)


def _floats(nulls=0.1):
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf])

    def draw(rng, n):
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)
        pick = rng.random(n) < 0.05
        x[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
        return x, rng.random(n) >= nulls
    return draw


def _two_stage(schema, keys, aggs, reducers=4, nparts=2, skipping=True, filt=None):
    src = JN.FFIReader(schema, "src", nparts)
    if filt is not None:
        src = JN.Filter(src, [filt])
    kcols = [(k, C(k)) for k in keys]
    partial = JN.Agg(src, HASH, kcols, [JN.AggColumn(a, M.PARTIAL, n) for n, a in aggs],
                     supports_partial_skipping=skipping)
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([C(k) for k in keys], reducers))
    return JN.Agg(ex, HASH, kcols, [JN.AggColumn(a, M.FINAL, n) for n, a in aggs])


# radix on small key ranges: the dense route's cap below them (both packages)
_RADIX = dict(batch_size=4096, dense_agg=True, radix_agg=True, dense_agg_max_buckets=1024,
              partial_agg_skipping_min_rows=5_000)


def _confs(**kw):
    return JaxConfig(**{**_RADIX, **kw}), Config(**{**_RADIX, **kw})


def test_near_unique_keys_skip_as_the_reference():
    """test_radix_agg.py:122 test_partial_skipping_near_unique_keys on the
    port: 120,000 rows of (a, b) in 2,000 x 400 keys, 10 batches, one
    partition, PARTIAL (skipping) straight into FINAL; the reference runs
    its own operators as that test does. Equal results, order included,
    and equal skipped batch counts, both above 0."""
    rng = np.random.default_rng(3)
    n = 120_000
    a, b, v = rng.integers(0, 2000, n), rng.integers(0, 400, n), rng.integers(0, 100, n)
    keys = [("a", C("a")), ("b", C("b"))]
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, [C("v")]))]
    scan = mem_scan({"a": pa.array(a, type=pa.int64()), "b": pa.array(b, type=pa.int64()),
                     "v": pa.array(v, type=pa.int64())}, num_batches=10)
    root = MetricNode("root")
    with config_override(radix_agg=True, partial_agg_skipping_min_rows=20_000):
        partial = JAggExec(scan, HASH, keys, [JN.AggColumn(x, M.PARTIAL, nm) for nm, x in aggs],
                           supports_partial_skipping=True)
        final = JAggExec(partial, HASH, keys, [JN.AggColumn(x, M.FINAL, nm) for nm, x in aggs])
        want = collections.defaultdict(list)
        for batch in final.execute(0, JExecContext(), root):
            for k, col in batch.to_arrow().to_pydict().items():
                want[k].extend(col)
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I64), ("v", JT.I64))
    node = JN.Agg(JN.Agg(JN.FFIReader(schema, "src", 1), HASH, keys,
                         [JN.AggColumn(x, M.PARTIAL, nm) for nm, x in aggs],
                         supports_partial_skipping=True),
                  HASH, keys, [JN.AggColumn(x, M.FINAL, nm) for nm, x in aggs])
    port = blaze_tpu_torch.Session(Config(radix_agg=True, partial_agg_skipping_min_rows=20_000),
                                   device="cpu")
    cuts = np.linspace(0, n, 11).astype(int)
    port.resources["src"] = lambda p: [{"a": a[x:y], "b": b[x:y], "v": v[x:y]}
                                       for x, y in zip(cuts, cuts[1:])]
    got = port.execute_to_pydict(from_foreign(node))
    assert got == dict(want)
    skipped = port.counters["partial_skipped_batches"]
    assert skipped == root.total("partial_skipped_batches") > 0


def test_near_unique_float_sum_skips_as_the_reference():
    """Repair 0a: a near-unique float SUM/AVG on a radix plan (K10 folds
    it in slot order) publishes its histogram, from K3 without
    aggregates, so it skips exactly where the reference skips; the FINAL
    folds the same singleton states in the same order, bit for bit."""
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I32), ("x", JT.F64))
    parts = _parts(np.random.default_rng(1), 2, 6, 4000,
                   {"a": _ints(0, 3000, 0.02), "b": _ints(0, 300, 0.0, np.int32),
                    "x": _floats()})
    aggs = [("s", JE.AggExpr(F.SUM, [C("x")])), ("av", JE.AggExpr(F.AVG, [C("x")])),
            ("mn", JE.AggExpr(F.MIN, [C("x")])), ("c", JE.AggExpr(F.COUNT, []))]
    want, got, jskipped, skipped = _run_both(_two_stage(schema, ["a", "b"], aggs), schema,
                                             parts, *_confs())
    assert got == want and len(got["s"]) > 40_000
    assert skipped == jskipped == 2 * (6 - 2)


def test_q67_shaped_plan_does_not_skip():
    """A q67-shaped aggregate at the partial's ~0.85 estimate (rows a batch
    a third of the keys): neither package skips; equal results."""
    schema = JT.Schema.of(("item", JT.I64), ("store", JT.I64), ("qty", JT.I64))
    parts = _parts(np.random.default_rng(67), 2, 4, 2624,
                   {"item": _ints(1, 201), "store": _ints(1, 41), "qty": _ints(1, 100)})
    aggs = [("qty", JE.AggExpr(F.SUM, [C("qty")]))]
    want, got, jskipped, skipped = _run_both(_two_stage(schema, ["item", "store"], aggs),
                                             schema, parts, *_confs())
    assert got == want and skipped == jskipped == 0


def test_fused_filter_keeps_the_skipper_off():
    """A Filter under the near-unique partial fuses (K18 on the port, the
    traced input in the reference): the skipper stays off in both."""
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I64), ("v", JT.I64))
    parts = _parts(np.random.default_rng(5), 2, 5, 4000,
                   {"a": _ints(0, 3000), "b": _ints(0, 300), "v": _ints(0, 1000)})
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, []))]
    plan = _two_stage(schema, ["a", "b"], aggs,
                      filt=JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(10, JT.I64)))
    jconf, conf = _confs(fused_filter_agg=True)
    want, got, jskipped, skipped = _run_both(plan, schema, parts, jconf, conf)
    assert got == want and skipped == jskipped == 0
    # unfused, the same plan skips in both
    jconf, conf = _confs(fused_filter_agg=False)
    want, got, jskipped, skipped = _run_both(plan, schema, parts, jconf, conf)
    assert got == want and skipped == jskipped > 0


def test_first_on_the_host_table_skips_as_the_reference():
    """FIRST takes the host table; near-unique keys flip its whole-table
    ratio after min_rows, and every later batch aggregates alone
    (``AggTable.passthrough_batch``). The FINAL table reads the partial
    table's output, so rows compare as a set."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64), ("w", JT.F64))
    parts = _parts(np.random.default_rng(11), 2, 5, 4000,
                   {"k": _ints(0, 50_000, 0.02), "v": _ints(-1000, 1000, 0.1),
                    "w": _floats()})
    aggs = [("f", JE.AggExpr(F.FIRST, [C("v")])), ("fw", JE.AggExpr(F.FIRST, [C("w")])),
            ("c", JE.AggExpr(F.COUNT, [C("v")])), ("s", JE.AggExpr(F.SUM, [C("v")]))]
    want, got, _jskipped, skipped = _run_both(_two_stage(schema, ["k"], aggs), schema,
                                              parts, *_confs())

    def rows(d):
        return sorted(zip(*[d[c] for c in ("k", "f", "fw", "c", "s")]), key=repr)

    assert rows(got) == rows(want) and len(got["k"]) > 25_000
    assert skipped == 2 * (5 - 2)


def test_cust_spend_small_matches_reference_and_oracle():
    """chip_smoke.py's cust_spend at 4 x 8 batches of 2,621 rows over
    20,000 customers (a batch a tenth of the domain, the path's ~0.93
    estimate): skipping after each partition's first batch in both
    packages, the top 100 equal to the reference's in order, to the oracle,
    and to the port without skipping."""
    rows, customers = 4 * 8 * 2621, 20_000
    (cust, qty, price), (cv, _q, _p) = cust_spend_host(rows=rows, seed=7, customers=customers)
    check, groups = cust_spend_oracle(((cust, qty, price), (cv, None, None)))
    ones = np.ones(rows, bool)
    cols = {"ss_customer_sk": (cust, cv), "ss_quantity": (qty, ones),
            "ss_sales_price": (price, ones)}
    parts = [[{c: (d[s:s + 2621], v[s:s + 2621]) for c, (d, v) in cols.items()}
              for s in range(p * 8 * 2621, (p + 1) * 8 * 2621, 2621)] for p in range(4)]
    schema = cust_spend_schema(JT)
    plan = cust_spend_plan(schema, JE, JN, JT)
    conf = dict(partial_agg_skipping_min_rows=2_000)
    want, got, jskipped, skipped = _run_both(plan, schema, parts, *_confs(**conf),
                                             rid="store_sales")
    assert got == want and skipped == jskipped == 4 * 7
    check(got)
    _w, noskip, _j, none = _run_both(plan, schema, parts,
                                     *_confs(partial_agg_skipping_enable=False, **conf),
                                     rid="store_sales")
    assert noskip == got and none == 0 and groups > 15_000


def test_cust_table_plan_skips_on_the_port():
    """chip_smoke.py's host-table skip check at a small scale: FIRST and
    COUNT by customer, near-unique batches; the port skips every batch
    after the first and equals the reference (rows as a set)."""
    (cust, qty, price), (cv, _q, _p) = cust_spend_host(rows=4 * 6000, seed=3, customers=500_000)
    ones = np.ones(len(cust), bool)
    cols = {"ss_customer_sk": (cust, cv), "ss_quantity": (qty, ones),
            "ss_sales_price": (price, ones)}
    parts = [[{c: (d[s:s + 6000], v[s:s + 6000]) for c, (d, v) in cols.items()}
              for s in range(0, 4 * 6000, 6000)]]
    schema = cust_spend_schema(JT)
    want, got, _j, skipped = _run_both(cust_table_plan(schema, JE, JN, JT), schema, parts,
                                       *_confs(), rid="store_sales")

    def rows(d):
        return sorted(zip(d["ss_customer_sk"], d["cnt"], d["first_sk"]), key=repr)

    assert rows(got) == rows(want) and skipped == 3
    assert all(f == k for k, _c, f in rows(got))


@pytest.mark.parametrize("ascending,nulls_first,limit", [
    (False, False, 100), (True, True, 100), (False, True, None), (True, False, None)])
def test_wide_decimal_sort_key_matches_jax(ascending, nulls_first, limit):
    """cust_spend's ORDER BY sorts a decimal(28,2) SUM: a bare
    decimal(19..38) sort key sorts by its limbs (l2, then l1 and l0). Keys
    of both signs past 2^64 and near 10^38, ties and nulls, a second key
    after it, top-k and full sort, against the reference's host sort."""
    from blaze_tpu_torch.core.batch import wide_words

    rng = np.random.default_rng(int(ascending) * 4 + int(nulls_first) * 2 + (limit is None))
    n = 3000
    pool = [0, 1, -1, 2 ** 64, -(2 ** 64), 2 ** 64 - 1, 2 ** 63, -(2 ** 63) - 1,
            10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 27, -(10 ** 27)]
    big = [int(x) * int(y) for x, y in zip(rng.integers(-(2 ** 62), 2 ** 62, n),
                                             rng.integers(-(2 ** 40), 2 ** 40, n))]
    vals = [pool[i % len(pool)] if r < 0.3 else b
            for i, (r, b) in enumerate(zip(rng.random(n), big))]
    valid = rng.random(n) >= 0.05
    k = rng.integers(0, 5, n)
    schema = JT.Schema.of(("w", JT.DecimalType(38, 2)), ("k", JT.I64))
    ctx = decimal.Context(prec=80)
    rb = pa.record_batch([pa.array([decimal.Decimal(v).scaleb(-2, ctx) for v in vals],
                                   type=pa.decimal128(38, 2), mask=~valid),
                          pa.array(k, type=pa.int64())], names=["w", "k"])
    plan = JN.Sort(JN.FFIReader(schema, "src", 1),
                   [JE.SortOrder(C("w"), ascending=ascending, nulls_first=nulls_first),
                    JE.SortOrder(C("k"))], fetch_limit=limit)
    with JaxSession(conf=_jax_conf(batch_size=1024)) as s:
        s.resources["src"] = lambda p: [rb.slice(a, 1024) for a in range(0, n, 1024)]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=1024), device="cpu")
    words = wide_words(vals, valid)
    port.resources["src"] = lambda p: [{"w": (words[a:a + 1024], valid[a:a + 1024]),
                                        "k": k[a:a + 1024]} for a in range(0, n, 1024)]
    got = port.execute_to_pydict(from_foreign(plan))
    assert got == want and len(got["w"]) == (limit or n)
