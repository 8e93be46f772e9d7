"""The port's host aggregation table (``ops/agg.py AggTable``, K12's plain
twin) against the JAX package's ``AggTable`` and its ``.at[]`` scatters.

- Kernel level: chip_smoke.py's K12 battery (every aggregate of the
  table in update and merge mode, nulls, padding, growth, int64 wrap,
  order-sensitive float sums, FIRST with tied orders) drawn from a seed
  with numpy goes through the reference's ``update``/``merge`` (eager
  ``.at[slots]`` scatters on the CPU) and the port's K12 ops through
  ``slot_update_plain``; the states must be equal.
- Plan level: plans built with ``blaze_tpu.ir`` and carried across with
  ``from_foreign`` run through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")``; the results must be equal,
  order included (the table emits groups in slot order, so this pins the
  port's slot numbering to the reference's).
- The JAX package's host-table tests (tests/test_agg.py) re-run on the
  port.

Tolerance: none. Integer and bool planes are compared by value, float
planes bit for bit (so -0.0 is not 0.0), except that any NaN equals any
NaN: a NaN's payload is the hardware's, not part of the result. Float sums
are left folds in row order on both sides, so they agree to the bit.
Inputs hold no subnormal floats: the JAX package flushes them to zero on
the CPU and the port keeps them (ROADMAP.md Queue 3).

Every reference session puts its shm root under the test's ``tmp_path``
(``shm_dir``), never in /dev/shm, where another test's glob would see it.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops import aggfns as JF
from blaze_tpu.ops.joins.bhj import clear_build_cache
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.ir.carry import from_foreign
from chip_smoke import UPD_CASES, UPD_FNS, upd_arg_type, upd_case, upd_fns, upd_run

torch.set_num_threads(1)

F = JE.AggFunction
M = JE.AggMode
HASH = JE.AggExecMode.HASH_AGG
C = JE.Column


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


# -- kernel level: K12's plain twin against the reference's scatters ------------


def _jax_fns():
    fns = []
    for fn, arg in UPD_FNS:
        agg = JE.AggExpr(F[fn.upper()], [] if arg is None else [C("v")])
        fns.append(JF.create_agg_function(agg, JT.Schema.of(("v", upd_arg_type(JT, arg)))))
    return fns


def _jax_run(case, fns):
    """The reference functions' states after the case's batches, through
    their own ``update``/``merge`` (eager ``.at[]`` scatters)."""
    caps = case["caps"]
    states = [fn.init_state(caps[0]) for fn in fns]
    for b, batch in enumerate(case["batches"]):
        if b == 1:
            states = [fn.grow(st, caps[1]) for fn, st in zip(fns, states)]
        slots, mask = jnp.asarray(batch["slots"]), jnp.asarray(batch["mask"])
        n = int(batch["mask"].sum())
        for i, (fn, planes) in enumerate(zip(fns, batch["planes"])):
            if case["mode"] == "merge":
                cols = [JDeviceColumn(JT.I64, jnp.asarray(d), jnp.asarray(v)) for d, v in planes]
                states[i] = fn.merge(states[i], slots, cols, mask, n)
            elif planes is None:
                states[i] = fn.update(states[i], slots, None, None, mask)
            else:
                order = jnp.asarray(batch["order"]) if isinstance(fn, JF.FirstAgg) else None
                states[i] = fn.update(states[i], slots, jnp.asarray(planes[0]),
                                      jnp.asarray(planes[1]), mask, order)
    return states


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _columns(fn, state, cap, final):
    """A function's state columns (or its final column) over ``cap`` slots
    as numpy (data, validity) pairs, data 0 where not valid."""
    cols = [fn.final_column(state, cap, cap)] if final else fn.state_columns(state, cap, cap)
    out = []
    for c in cols:
        d, v = _np(c.data), _np(c.validity)
        out.append((np.where(v, d, np.zeros((), d.dtype)), v))
    return out


@pytest.mark.parametrize("case", UPD_CASES, ids=[c[0] for c in UPD_CASES])
def test_slot_update_plain_matches_reference_scatters(case):
    """Every aggregate's states (state columns and final values) after the
    case's batches: the reference's scatters against K12's plain twin."""
    data = upd_case(case, np.random.default_rng(sum(map(ord, case[0]))), subnormals=False)
    cap = data["caps"][1]
    jfns, fns = _jax_fns(), upd_fns()
    jstates = _jax_run(data, jfns)
    states = upd_run(data, fns, K.slot_update_plain, torch.device("cpu"))
    for (name, arg), jfn, fn, jst, st in zip(UPD_FNS, jfns, fns, jstates, states):
        for final in (False, True):
            want = _columns(jfn, jst, cap, final)
            got = _columns(fn, st, cap, final)
            assert len(want) == len(got), (name, arg)
            for (jd, jv), (td, tv) in zip(want, got):
                _same(jv, tv)
                _same(jd, td)


def test_float_sum_folds_from_the_table_value():
    """1e16, 1.0, -1e16 into one slot over two batches, then 1.0: the
    fold starts from the slot's value in row order (XLA's scatter-add on
    the CPU), so the 1.0 added to 1e16 is lost and the last one is not."""
    table = torch.zeros(4, dtype=torch.float64)
    mask = torch.ones(2, dtype=torch.bool)
    for vals in ([1e16, 1.0], [-1e16, 1.0]):
        src = torch.tensor(vals, dtype=torch.float64)
        K.slot_update_plain(torch.zeros(2, dtype=torch.int64), mask,
                            [K.SlotUpdate(K.UPD_ADD, table, src)])
    want = jnp.zeros(4).at[jnp.zeros(4, jnp.int32)].add(jnp.array([1e16, 1.0, -1e16, 1.0]))
    assert table.tolist() == np.asarray(want).tolist() == [1.0, 0.0, 0.0, 0.0]


def test_first_ties_take_the_last_row():
    """Merged FIRST states of two map tasks share row orders; of the rows
    tied on the least order the last one in row order wins, as the
    reference's set scatter leaves it (its last writer wins)."""
    val = torch.zeros(2, dtype=torch.int64)
    valid = torch.zeros(2, dtype=torch.bool)
    best = torch.full((2,), K.I64_MAX, dtype=torch.int64)
    slots = torch.tensor([0, 0, 0, 1])
    src = torch.tensor([5, 6, 7, 8])
    order = torch.tensor([3, 1, 1, 0])
    K.slot_update_plain(slots, torch.ones(4, dtype=torch.bool), [K.SlotUpdate(
        K.UPD_FIRST, val, src, order=order, wvalids=[torch.tensor([True, True, False, True])],
        valid_table=valid, order_table=best)])
    assert val.tolist() == [7, 8] and valid.tolist() == [False, True]
    assert best.tolist() == [1, 0]


def test_slot_update_pack_repacks_only_when_a_table_changes():
    """K12's argument pack, one a launch in the host table: the words that
    stay the same pack once while the tables stay, each call points the
    row arrays at its own batch's planes, a grown table packs anew, and
    the rows are still checked on every call."""
    fn = upd_fns()[0]  # SUM of int64: an ADD and a FLAG, gated by validity
    pack = K.SlotUpdatePack()
    st = fn.init_state(1024, torch.device("cpu"))
    packed = []
    for _ in range(2):
        v, ok = torch.arange(8), torch.ones(8, dtype=torch.bool)
        static, (src, valid, order, wvalid) = pack.args(fn.update_ops(st, v, ok), 8, 1024)
        packed.append(static)
        assert src[0] == v.data_ptr() and src[1] is None and order[0] is None
        assert valid[0] == valid[3] == ok.data_ptr() and valid[1] is None
    assert packed[1] is packed[0] and packed[0][3][0] == st[0].data_ptr()
    st = fn.grow(st, 2048)
    static, _ = pack.args(fn.update_ops(st, v, ok), 8, 2048)
    assert static is not packed[0] and static[3][0] == st[0].data_ptr()
    with pytest.raises(TypeError):
        pack.args([K.SlotUpdate(K.UPD_ADD, st[0], v.double(), [ok])], 8, 2048)
    with pytest.raises(ValueError):
        pack.args(fn.update_ops(st, v[:4], ok[:4]), 8, 2048)


# -- plan level -----------------------------------------------------------------

PARTS = 3
BATCH = 256
_JTYPES = {"i64": JT.I64, "i32": JT.I32, "f64": JT.F64, "f32": JT.F32, "bool": JT.BOOL,
           "dec": JT.DecimalType(7, 2)}
_FLOATS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -2.25, 1e300, -1e300, 7.0,
                    3.0, 0.1])


def _plane(kind, n, rng, nulls, lo, hi):
    if kind in ("f64", "f32"):
        d = _FLOATS[rng.integers(0, len(_FLOATS), n)]
        with np.errstate(over="ignore"):  # +-1e300 is +-inf in float32
            d = d.astype(np.float64 if kind == "f64" else np.float32)
    elif kind == "bool":
        d = rng.random(n) < 0.5
    else:
        d = rng.integers(lo, hi, n).astype(np.int32 if kind == "i32" else np.int64)
    v = rng.random(n) >= nulls
    return np.where(v, d, np.zeros((), d.dtype)), v


def _cols(seed, spec, rows=(700, 0, 900)):
    """Per partition {column: (data, validity)}: ``spec`` maps a column to
    (kind, lo, hi, null share); ``rows`` per partition."""
    rng = np.random.default_rng(seed)
    return [{c: _plane(kind, n, rng, nulls, lo, hi) for c, (kind, lo, hi, nulls) in spec.items()}
            for n in rows]


def _schema(spec):
    return JT.Schema.of(*[(c, _JTYPES[kind]) for c, (kind, *_r) in spec.items()])


def _arrow_col(dt, data, valid):
    if isinstance(dt, JT.DecimalType):
        vals = [decimal.Decimal(int(x)).scaleb(-dt.scale) for x in data]
        return pa.array(vals, type=pa.decimal128(dt.precision, dt.scale), mask=~valid)
    return pa.array(data, mask=~valid)


def _slices(part, batch=BATCH):
    n = len(next(iter(part.values()))[0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, n, batch)]


def _canon(d):
    """Floats by repr (-0.0 and nan spelled out), everything else as is."""
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _run_both(plan, schema, parts, tmp_path, batch=BATCH, **conf):
    """The plan's result in the JAX package and in the port (CPU), each as
    a pydict with floats spelled out."""
    clear_build_cache()
    jconf = JaxConfig(batch_size=batch, shm_dir=str(tmp_path), **conf)
    with JaxSession(conf=jconf) as s:
        s.resources["src"] = lambda p: [
            pa.record_batch([_arrow_col(f.dtype, *b[f.name]) for f in schema.fields],
                            names=schema.names) for b in _slices(parts[p], batch)]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=batch, **conf), device="cpu")
    port.resources["src"] = lambda p: _slices(parts[p], batch)
    got = port.execute_to_pydict(from_foreign(plan))
    return _canon(want), _canon(got)


def _aggs(value_cols, first=False):
    out = [("cnt", JE.AggExpr(F.COUNT, []))]
    for c in value_cols:
        out += [(f"s_{c}", JE.AggExpr(F.SUM, [C(c)])),
                (f"a_{c}", JE.AggExpr(F.AVG, [C(c)])),
                (f"mn_{c}", JE.AggExpr(F.MIN, [C(c)])),
                (f"mx_{c}", JE.AggExpr(F.MAX, [C(c)])),
                (f"c_{c}", JE.AggExpr(F.COUNT, [C(c)]))]
        if first:
            out += [(f"f_{c}", JE.AggExpr(F.FIRST, [C(c)])),
                    (f"fi_{c}", JE.AggExpr(F.FIRST_IGNORES_NULL, [C(c)]))]
    return out


def _agg(child, keys, aggs, mode):
    return JN.Agg(child, HASH, [(k, C(k)) for k in keys],
                  [JN.AggColumn(a, mode, n) for n, a in aggs])


def _two_stage(keys, aggs, schema, exchange=None):
    partial = _agg(JN.FFIReader(schema, "src", PARTS), keys, aggs, M.PARTIAL)
    part = exchange or (JN.HashPartitioning([C(k) for k in keys], PARTS) if keys
                        else JN.SinglePartitioning(1))
    return _agg(JN.ShuffleExchange(partial, part), keys, aggs, M.FINAL)


_VALUES = {"i64": ("i64", -10 ** 6, 10 ** 6, 0.1), "i32": ("i32", -1000, 1000, 0.1),
           "f64": ("f64", 0, 1, 0.1), "f32": ("f32", 0, 1, 0.1),
           "dec": ("dec", 0, 10 ** 6, 0.1)}


@pytest.mark.parametrize("kind", sorted(_VALUES))
def test_global_two_stage_matches_jax(kind, tmp_path):
    """PARTIAL without keys (the table's one slot per task) -> single
    exchange -> FINAL (the table's merge): COUNT(*), SUM, AVG, MIN, MAX
    and COUNT of a column, one row."""
    spec = {"v": _VALUES[kind]}
    schema = _schema(spec)
    want, got = _run_both(_two_stage([], _aggs(["v"]), schema), schema, _cols(1, spec),
                          tmp_path)
    assert got == want and len(got["cnt"]) == 1 and got["cnt"] == [1600]


@pytest.mark.parametrize("stages", ["complete", "two_stage"])
def test_global_over_empty_input(stages, tmp_path):
    """A global aggregate over no rows is one row of initial state: COUNT 0,
    everything else null; without an exchange, one such row a partition."""
    spec = {"v": _VALUES["i64"], "x": _VALUES["f64"]}
    schema = _schema(spec)
    aggs = _aggs(["v", "x"], first=True)
    plan = _agg(JN.FFIReader(schema, "src", PARTS), [], aggs, M.COMPLETE) \
        if stages == "complete" else _two_stage([], aggs, schema)
    want, got = _run_both(plan, schema, _cols(2, spec, rows=(0, 0, 0)), tmp_path)
    rows = PARTS if stages == "complete" else 1
    assert got == want and got["cnt"] == [0] * rows and got["s_v"] == [None] * rows


_TABLE_DATA = {
    # columns: (kind, lo, hi, null share); the grouping keys; the value columns
    "int_key": ({"k": ("i64", -20, 60, 0.1), "v": _VALUES["i64"], "x": _VALUES["f64"],
                 "d": _VALUES["dec"]}, ["k"], ["v", "x", "d"]),
    "two_keys": ({"k": ("i32", 0, 7, 0.1), "j": ("i64", -3, 3, 0.1), "y": _VALUES["f32"],
                  "b": _VALUES["i32"]}, ["k", "j"], ["y", "b"]),
    "no_keys": ({"v": _VALUES["i64"], "x": _VALUES["f64"]}, [], ["v", "x"]),
}


@pytest.mark.parametrize("data", sorted(_TABLE_DATA))
def test_complete_matches_jax(data, tmp_path):
    """Single-stage COMPLETE aggregation, FIRST and FIRST_IGNORES_NULL
    included, in slot order (first seen first)."""
    spec, keys, values = _TABLE_DATA[data]
    schema = _schema(spec)
    plan = _agg(JN.FFIReader(schema, "src", PARTS), keys, _aggs(values, first=True),
                M.COMPLETE)
    want, got = _run_both(plan, schema, _cols(3, spec), tmp_path)
    assert got == want and len(got["cnt"]) >= (1 if not keys else 10)


def _rows(d):
    """A pydict's rows, sorted (None and NaN spelled out by repr)."""
    return sorted(zip(*[[repr(x) for x in v] for v in d.values()]))


@pytest.mark.parametrize("data", ["int_key", "two_keys"])
def test_first_two_stage_matches_jax(data, tmp_path):
    """FIRST and FIRST_IGNORES_NULL through PARTIAL (the table: FIRST is
    outside the device aggregates) -> hash exchange -> FINAL (the table's
    merge of orders that map tasks share): the same rows. Not the same
    order: the reference's table emits its keys as host (pyarrow)
    columns, which the FINAL table interns by dictionary code (first seen
    first); the port has no host columns and interns the device keys by
    ``np.unique`` (ROADMAP.md Queue 3)."""
    spec, keys, values = _TABLE_DATA[data]
    schema = _schema(spec)
    aggs = [(f"f_{c}", JE.AggExpr(F.FIRST, [C(c)])) for c in values] + \
        [(f"fi_{c}", JE.AggExpr(F.FIRST_IGNORES_NULL, [C(c)])) for c in values] + \
        [("cnt", JE.AggExpr(F.COUNT, []))]
    want, got = _run_both(_two_stage(keys, aggs, schema), schema, _cols(4, spec), tmp_path)
    assert _rows(got) == _rows(want) and len(got["cnt"]) >= 10


@pytest.mark.parametrize("data", ["int_key", "two_keys"])
def test_final_past_device_merge_max_bytes(data, tmp_path):
    """FINAL over partial states past ``device_merge_max_bytes``: the
    staged batches and the rest of the stream go to the host table (the
    reference's :389), in both packages."""
    spec, keys, values = _TABLE_DATA[data]
    schema = _schema(spec)
    plan = _two_stage(keys, _aggs(values), schema)
    want, got = _run_both(plan, schema, _cols(5, spec), tmp_path, device_merge_max_bytes=1)
    assert got == want and len(got["cnt"]) >= 10


def test_more_than_1024_groups(tmp_path):
    """~3,000 groups: the slot tables double past their first 1,024 rows
    with the identity fill (SUM 0, MIN/MAX sentinels, FIRST's order)."""
    spec = {"k": ("i64", 0, 3000, 0.0), "v": _VALUES["i64"], "x": _VALUES["f64"]}
    schema = _schema(spec)
    plan = _agg(JN.FFIReader(schema, "src", PARTS), ["k"], _aggs(["v", "x"], first=True),
                M.COMPLETE)
    want, got = _run_both(plan, schema, _cols(6, spec, rows=(2000, 1500, 2500)), tmp_path)
    assert got == want and len(got["k"]) > 2048


def test_float_keys_keep_signed_zeros_and_nan_payloads_apart(tmp_path):
    """The table groups float keys by their bits, as the reference's packed
    key words do: -0.0 and 0.0 are two groups, and so are two NaNs with
    different payloads (Spark would make one of each; the sort route folds
    them). Pinned in both packages."""
    nan2 = np.array([0x7FF8000000000001], np.int64).view(np.float64)[0]
    keys = np.array([0.0, -0.0, np.nan, nan2, 1.0, -0.0, np.nan, 0.0] * 40)
    v = np.arange(len(keys), dtype=np.int64)
    ones = np.ones(len(keys), bool)
    empty = {"f": (keys[:0], ones[:0]), "v": (v[:0], ones[:0])}
    parts = [{"f": (keys, ones), "v": (v, ones)}] + [empty] * (PARTS - 1)
    schema = JT.Schema.of(("f", JT.F64), ("v", JT.I64))
    plan = _agg(JN.FFIReader(schema, "src", PARTS), ["f"],
                [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, []))],
                M.COMPLETE)
    want, got = _run_both(plan, schema, parts, tmp_path)
    assert got == want
    # slot order: np.unique's order of the packed little-endian words
    assert got["f"] == ["0.0", "-0.0", "1.0", "nan", "nan"]
    assert got["c"] == [80, 80, 40, 80, 40]


def _table_calls(monkeypatch):
    """Counts of merge batches each package's host table takes."""
    import blaze_tpu.ops.agg as JA

    import blaze_tpu_torch.ops.agg as PA

    calls = {"jax": 0, "port": 0}
    for mod, key in ((JA, "jax"), (PA, "port")):
        orig = mod.AggTable.process_batch

        def counted(self, batch, _orig=orig, _key=key):
            if self.op.input_is_partial and batch.num_rows:
                calls[_key] += 1
            return _orig(self, batch)

        monkeypatch.setattr(mod.AggTable, "process_batch", counted)
    return calls


def test_q96_matches_jax_and_numpy(tmp_path, monkeypatch):
    """chip_smoke.py's q96 plan and data at 200,000 store_sales rows (its
    dimensions whole): PARTIAL COUNT(1) without keys after three broadcast
    joins, FINAL through the table's merge; equal to the reference and to
    the numpy count."""
    from chip_smoke import Q96_ROWS, q96_host, q96_oracle, q96_plan, q96_schemas

    rows = dict(Q96_ROWS, store_sales=200_000)
    host = q96_host(rows)
    want_np = q96_oracle(host)
    schemas = q96_schemas(JT)
    plan = q96_plan(schemas, JE, JN, JT, parts=PARTS)
    parts = {}
    for name, (cols, valids) in host.items():
        valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
        planes = {f.name: (c, v) for f, c, v in zip(schemas[name].fields, cols, valids)}
        n = len(cols[0])
        cuts = [n * p // PARTS for p in range(PARTS + 1)] if name == "store_sales" else [0, n]
        parts[name] = [{k: (d[a:b], v[a:b]) for k, (d, v) in planes.items()}
                       for a, b in zip(cuts, cuts[1:])]
    calls = _table_calls(monkeypatch)
    batch = 8192
    clear_build_cache()
    with JaxSession(conf=JaxConfig(batch_size=batch, shm_dir=str(tmp_path))) as s:
        for name, plist in parts.items():
            schema = schemas[name]
            s.resources[name] = lambda p, _pl=plist, _s=schema: [
                pa.record_batch([pa.array(b[f.name][0], mask=~b[f.name][1])
                                 for f in _s.fields], names=_s.names)
                for b in _slices(_pl[p], batch)]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=batch), device="cpu")
    for name, plist in parts.items():
        port.resources[name] = lambda p, _pl=plist: _slices(_pl[p], batch)
    got = port.execute_to_pydict(from_foreign(plan))
    assert got == want == want_np and want_np["cnt"][0] > 10
    assert calls["jax"] >= 1 and calls["port"] >= 1


def _q67_plan(schema):
    """bench.py:380 plan_q67 in the reference's IR (chip_smoke.py:q67_plan)."""
    keys = ["ss_item_sk", "ss_store_sk"]
    aggs = [("qty", JE.AggExpr(F.SUM, [C("ss_quantity")]))]
    final = _two_stage(keys, aggs, schema)
    srt = JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                  [JE.SortOrder(C("ss_item_sk")), JE.SortOrder(C("qty"), ascending=False)])
    win = JN.Window(srt, [JN.WindowExpr("rank", "rk")], [C("ss_item_sk")],
                    [JE.SortOrder(C("qty"), ascending=False)])
    return JN.Filter(win, [JE.BinaryExpr(JE.BinaryOp.LTEQ, C("rk"), JE.Literal(3, JT.I32))])


def test_q67_final_takes_the_table_past_the_merge_budget(tmp_path, monkeypatch):
    """q67 scaled down (bench.py's draw, 3 x 20,000 rows) with the merge
    budget scaled below one reducer's partial states: in both packages
    the FINAL merge falls to the host table, and the answers are equal,
    order included (the stable sort sees the groups in slot order)."""
    rng = np.random.default_rng(67)
    ones = np.ones(20_000, bool)
    parts = [{"ss_item_sk": (rng.integers(1, 2000, 20_000), ones),
              "ss_store_sk": (rng.integers(1, 400, 20_000), ones),
              "ss_quantity": (rng.integers(1, 100, 20_000), ones)} for _ in range(PARTS)]
    schema = JT.Schema.of(("ss_item_sk", JT.I64), ("ss_store_sk", JT.I64),
                          ("ss_quantity", JT.I64))
    calls = _table_calls(monkeypatch)
    want, got = _run_both(_q67_plan(schema), schema, parts, tmp_path, batch=4096,
                          device_merge_max_bytes=64 << 10)
    assert got == want and len(got["rk"]) > 1000
    assert calls["jax"] >= 4 and calls["port"] == calls["jax"]


# -- the JAX package's host-table tests (tests/test_agg.py) on the port ----------


def _port(plan, batches, **conf):
    """The plan's result on the port (CPU) over one partition of
    ``batches`` ({column: (data, validity)} each)."""
    port = blaze_tpu_torch.Session(conf=Config(**conf), device="cpu")
    port.resources["src"] = lambda p: batches
    return port.execute_to_pydict(from_foreign(plan))


def _split(cols, num_batches):
    n = len(next(iter(cols.values()))[0])
    cuts = np.linspace(0, n, num_batches + 1).astype(int)
    return [{k: (d[a:b], v[a:b]) for k, (d, v) in cols.items()} for a, b in zip(cuts, cuts[1:])]


def _by_key(out, key):
    order = sorted(range(len(out[key])), key=lambda i: (out[key][i] is None, out[key][i]))
    return {k: [v[i] for i in order] for k, v in out.items()}


def test_global_agg_no_groups():
    schema = JT.Schema.of(("v", JT.I64))
    plan = _agg(JN.FFIReader(schema, "src", 1), [],
                [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, []))],
                M.COMPLETE)
    cols = {"v": (np.array([1, 2, 3]), np.ones(3, bool))}
    assert _port(plan, _split(cols, 1)) == {"s": [6], "c": [3]}


def test_global_agg_empty_input():
    schema = JT.Schema.of(("v", JT.I64))
    plan = _agg(JN.FFIReader(schema, "src", 1), [],
                [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, []))],
                M.COMPLETE)
    cols = {"v": (np.zeros(0, np.int64), np.zeros(0, bool))}
    assert _port(plan, _split(cols, 1)) == {"s": [None], "c": [0]}


def test_final_agg_basic():
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    cols = {"k": (np.array([1, 2, 1, 2, 1]), np.ones(5, bool)),
            "v": (np.array([10, 20, 30, 0, 50]), np.array([1, 1, 1, 0, 1], bool))}
    plan = _agg(JN.FFIReader(schema, "src", 1), ["k"],
                [("s", JE.AggExpr(F.SUM, [C("v")])), ("c", JE.AggExpr(F.COUNT, [C("v")])),
                 ("mn", JE.AggExpr(F.MIN, [C("v")])), ("mx", JE.AggExpr(F.MAX, [C("v")])),
                 ("a", JE.AggExpr(F.AVG, [C("v")]))], M.COMPLETE)
    out = _by_key(_port(plan, _split(cols, 2)), "k")
    assert out == {"k": [1, 2], "s": [90, 20], "c": [3, 1], "mn": [10, 20], "mx": [50, 20],
                   "a": [30.0, 20.0]}


def test_first_and_collect():
    """Its FIRST half (COLLECT_LIST/SET need host list columns: ROADMAP.md
    Queue 1 item 3, and raise on the port)."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    cols = {"k": (np.array([1, 1, 2, 2]), np.ones(4, bool)),
            "v": (np.array([0, 7, 8, 9]), np.array([0, 1, 1, 1], bool))}
    plan = _agg(JN.FFIReader(schema, "src", 1), ["k"],
                [("f", JE.AggExpr(F.FIRST, [C("v")])),
                 ("fi", JE.AggExpr(F.FIRST_IGNORES_NULL, [C("v")]))], M.COMPLETE)
    out = _by_key(_port(plan, _split(cols, 2)), "k")
    assert out["f"] == [None, 8] and out["fi"] == [7, 8]
    collect = _agg(JN.FFIReader(schema, "src", 1), ["k"],
                   [("cl", JE.AggExpr(F.COLLECT_LIST, [C("v")]))], M.COMPLETE)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        _port(collect, _split(cols, 2))


def test_device_final_merge_matches_host_table(monkeypatch):
    """The port's device FINAL merge against its host table
    (``device_merge_max_bytes=0``) over the same partial states: decimal
    sum/avg, min/max, count and null group keys, equal by key."""
    rng = np.random.default_rng(71)
    n = 5000
    kv = np.arange(n) % 50 != 0
    cols = {"k": (np.where(kv, rng.integers(0, 40, n), 0), kv),
            "amt": (rng.integers(0, 10000, n), np.ones(n, bool)),
            "v": (rng.integers(-100, 100, n), np.ones(n, bool))}
    schema = JT.Schema.of(("k", JT.I64), ("amt", JT.DecimalType(7, 2)), ("v", JT.I64))
    aggs = [("s", JE.AggExpr(F.SUM, [C("amt")], JT.DecimalType(17, 2))),
            ("a", JE.AggExpr(F.AVG, [C("amt")], JT.DecimalType(11, 6))),
            ("mn", JE.AggExpr(F.MIN, [C("v")])), ("mx", JE.AggExpr(F.MAX, [C("v")])),
            ("c", JE.AggExpr(F.COUNT, []))]
    partial = _agg(JN.FFIReader(schema, "src", 1), ["k"], aggs, M.PARTIAL)
    plan = _agg(partial, ["k"], aggs, M.FINAL)
    calls = _table_calls(monkeypatch)
    device = _by_key(_port(plan, _split(cols, 4)), "k")
    assert calls["port"] == 0, "the device merge was not taken"
    table = _by_key(_port(plan, _split(cols, 4), device_merge_max_bytes=0), "k")
    assert calls["port"] >= 1 and device == table and None in table["k"]
