"""The port's second slice against the JAX package: the key sort (K5),
the gathers (K6), slice and concat (K7), the window counters and the
q67 path (two-key agg -> full sort -> rank window -> filter).

The same numpy inputs, drawn from a seed, go through the JAX function
(on the CPU, as the JAX package's own tests run it) and the port's plain
PyTorch twin; q67 and its window variants go through
``blaze_tpu.Session`` and ``blaze_tpu_torch.Session(device="cpu")``.

Tolerance: none. Every plane is an integer, bool or float compared by
its bytes, and the plan results must be equal, order included.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.core import kernels as JK
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins import keymap as JKM
from blaze_tpu.ops.sort import _device_sort_indices
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
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


# -- K5: key operands + stable sort -------------------------------------------

_F64_SPECIALS = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5])


def _key_plane(kind, cap, n, rng, nulls):
    """One sort-key plane honouring the padding contract, with ties."""
    d = np.zeros(cap, {"i64": np.int64, "i32": np.int32, "bool": np.bool_,
                       "f64": np.float64, "f32": np.float32}[kind])
    if kind == "i64":
        vals = rng.integers(-3, 4, n)
        vals[rng.random(n) < 0.1] = np.iinfo(np.int64).min
        vals[rng.random(n) < 0.1] = np.iinfo(np.int64).max
        d[:n] = vals
    elif kind == "i32":
        d[:n] = rng.integers(-5, 5, n)
    elif kind == "bool":
        d[:n] = rng.random(n) < 0.5
    else:
        d[:n] = rng.choice(_F64_SPECIALS, n)
    v = np.zeros(cap, bool)
    v[:n] = rng.random(n) >= nulls
    d[~v] = 0
    return d, v


def _words(op: np.ndarray) -> np.ndarray:
    """Order-preserving uint64 words of csrc/sort.cu:blz_sort_word."""
    size = op.dtype.itemsize
    bits = op.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[size])
    w = bits.astype(np.uint64)
    sign = np.uint64(1 << (8 * size - 1))
    if op.dtype.kind == "i":
        return w ^ sign
    if op.dtype.kind == "f":
        allb = np.uint64((1 << (8 * size)) - 1)
        inf = np.uint64(0x7ff0000000000000 if size == 8 else 0x7f800000)
        nan = (w & ~sign) > inf
        w = np.where(w == sign, np.uint64(0), w)
        w = np.where(w & sign, ~w & allb, w | sign)
        return np.where(nan, allb, w)
    return w


def _radix_model(ops, num_rows):
    """csrc/sort.cu's algorithm in numpy: the digit passes that
    ``K.radix_passes`` keeps, each a stable counting sort."""
    words = [_words(o.numpy()[:num_rows]) for o in ops]
    and_or = []
    for w in words:
        and_or += [np.bitwise_and.reduce(w), np.bitwise_or.reduce(w)]
    idx = np.arange(num_rows)
    for o, shift in K.radix_passes(np.array(and_or, np.uint64),
                                   [x.element_size() for x in ops]):
        digit = (words[o][idx] >> np.uint64(shift)) & np.uint64(0xff)
        idx = idx[np.argsort(digit, kind="stable")]
    n = ops[0].shape[0]
    return np.concatenate([idx, np.arange(num_rows, n)])


@pytest.mark.parametrize("keys,cap,n,nulls", [
    ((("i64", True, True),), 256, 200, 0.1),
    ((("i64", False, False),), 4096, 4096, 0.05),       # int64 min/max, DESC
    ((("i64", True, True), ("i32", False, True)), 4096, 3000, 0.1),
    ((("bool", True, False), ("f64", False, True), ("i64", True, False)), 256, 250, 0.2),
    ((("f64", True, True),), 4096, 4000, 0.1),           # NaN, +-0.0, +-inf
    ((("f32", False, False),), 256, 256, 0.0),
    ((("bool", False, False),), 256, 100, 0.3),
    ((("i32", True, False), ("i64", False, False), ("f64", True, False)), 4096, 1, 0.0),
])
def test_key_sort_matches_jax(keys, cap, n, nulls):
    rng = np.random.default_rng(cap + n + len(keys))
    planes = [_key_plane(kind, cap, n, rng, nulls) for kind, _, _ in keys]
    spec = tuple((asc, nf) for _, asc, nf in keys)
    exists = np.arange(cap) < n
    jops = JK._key_ops(tuple(jnp.asarray(d) for d, _ in planes),
                       tuple(jnp.asarray(v) for _, v in planes),
                       jnp.asarray(exists), spec)
    tops = K.sort_key_operands([_t(d) for d, _ in planes],
                               [_t(v) for _, v in planes], _t(exists), spec)
    assert len(jops) == len(tops)
    for a, b in zip(jops, tops):
        _same_bytes(a, b)
    want = np.asarray(_device_sort_indices(list(jops), cap)).astype(np.int64)
    # the twin sorts the live rows only, or every row
    np.testing.assert_array_equal(K.lexsort_indices(tops, n).numpy(), want)
    np.testing.assert_array_equal(K.lexsort_indices(tops).numpy(), want)
    # the kernel's algorithm (word mapping, skipped digits) gives the same
    np.testing.assert_array_equal(_radix_model(tops, n), want)
    np.testing.assert_array_equal(_radix_model(tops, cap), want)


def test_key_sort_signed_zero_and_nan_keep_input_order():
    """-0.0 and +0.0 are one key; NaN keys are one rank; ties keep row
    order -- as lax.sort and torch.sort order them."""
    d = np.array([0.0, -0.0, 1.0, -0.0, 0.0, np.nan, -1.0, np.nan])
    v = np.ones(8, bool)
    exists = np.ones(8, bool)
    for asc in (True, False):
        spec = ((asc, True),)
        jops = JK._key_ops((jnp.asarray(d),), (jnp.asarray(v),), jnp.asarray(exists), spec)
        want = np.asarray(_device_sort_indices(list(jops), 8)).astype(np.int64)
        tops = K.sort_key_operands([_t(d)], [_t(v)], _t(exists), spec)
        np.testing.assert_array_equal(K.lexsort_indices(tops).numpy(), want)
        np.testing.assert_array_equal(_radix_model(tops, 8), want)
    assert want.tolist() == [5, 7, 2, 0, 1, 3, 4, 6]


def test_bucketize_sort_is_one_operand_pass():
    """The exchange's pid sort: int32 ids in [0, 4) need one digit pass."""
    pids = _t(np.random.default_rng(3).integers(0, 4, 1000).astype(np.int32))
    want = torch.sort(pids, stable=True).indices
    assert torch.equal(K.lexsort_indices([pids]), want)
    w = _words(pids.numpy())
    passes = K.radix_passes(np.array([np.bitwise_and.reduce(w),
                                      np.bitwise_or.reduce(w)], np.uint64), [4])
    assert passes == [(0, 0)]


# -- K6: gather ------------------------------------------------------------------


_MIX4 = (np.int64, np.int32, np.bool_, np.float64)
_ALL_SIZES = (np.int8, np.int16, np.int32, np.float32, np.int64, np.float64, np.bool_)


def _mixed_planes(rng, caps, n_live, dtypes=_MIX4):
    datas, valids = [], []
    for i, dt in enumerate(dtypes):
        cap = caps[i % len(caps)]
        d = np.zeros(cap, dt)
        v = np.zeros(cap, bool)
        m = min(n_live, cap)
        lim = 100 if dt == np.int8 else 1000
        d[:m] = rng.integers(-lim, lim, m) if dt != np.bool_ else rng.random(m) < 0.5
        v[:m] = rng.random(m) >= 0.2
        d[~v] = 0
        datas.append(d)
        valids.append(v)
    return datas, valids


@pytest.mark.parametrize("rows", [1, 256, 333, 4096])
def test_k6_output_planes_are_aligned_views_a_dtype(rows):
    """K6's output planes (``_alloc_planes``): each plane its dtype and
    ``rows`` long, contiguous, at the address given for it, 16-byte
    aligned, the planes of one dtype views of one allocation."""
    dtypes = [torch.int64, torch.bool, torch.int32, torch.bool, torch.int8, torch.float64,
              torch.int16, torch.bool]
    outs, ptrs = K._alloc_planes(dtypes, rows, torch.device("cpu"))
    for p, dt, at in zip(outs, dtypes, ptrs):
        assert p.dtype == dt and p.shape == (rows,) and p.is_contiguous()
        assert p.data_ptr() == at and at % 16 == 0
    bools = [p for p, dt in zip(outs, dtypes) if dt == torch.bool]
    assert len({p.untyped_storage().data_ptr() for p in bools}) == 1
    spans = sorted((p.data_ptr(), p.data_ptr() + p.nbytes) for p in outs)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("out_cap,n_out,masked,dtypes", [
    pytest.param(256, 200, False, _MIX4, id="256-200-False"),
    pytest.param(4096, 4096, False, _MIX4, id="4096-4096-False"),
    pytest.param(256, 0, False, _MIX4, id="256-0-False"),
    pytest.param(1024, 700, True, _MIX4, id="1024-700-True"),
    pytest.param(256, 256, True, _MIX4, id="256-256-True"),
    pytest.param(8192, 2999, True, _ALL_SIZES, id="8192-2999-True-every-element-size"),
])
def test_gather_matches_jax(out_cap, n_out, masked, dtypes):
    rng = np.random.default_rng(out_cap + n_out)
    # planes of one batch at different capacities: indices clip per plane
    datas, valids = _mixed_planes(rng, (4096, 4096, 1024, 4096), 3000, dtypes)
    idx = rng.integers(0, 3000, n_out)
    buf = np.zeros(out_cap, np.int64)
    buf[:n_out] = idx
    jd = tuple(jnp.asarray(x) for x in datas)
    jv = tuple(jnp.asarray(x) for x in valids)
    if masked:
        live = rng.random(n_out) < 0.7
        lbuf = np.zeros(out_cap, bool)
        lbuf[:n_out] = live
        want = JK._gather(jd, jv, jnp.asarray(buf), jnp.asarray(lbuf))
        got = K.gather_planes([_t(x) for x in datas], [_t(x) for x in valids],
                              _t(idx), out_cap, n_out, live=_t(live))
    else:
        want = JK._gather_n(jd, jv, jnp.asarray(buf), jnp.int64(n_out))
        got = K.gather_planes([_t(x) for x in datas], [_t(x) for x in valids],
                              _t(idx), out_cap, n_out)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        _same_bytes(a, b)


# -- K7: slice and concat ----------------------------------------------------------


@pytest.mark.parametrize("cap,num_rows,offset,length,out_cap", [
    (4096, 3000, 0, 256, 256),
    (4096, 3000, 2900, 256, 256),     # cut at the end
    (4096, 3000, 3000, 256, 256),     # offset at the end: empty
    (4096, 3000, 5000, 256, 256),     # offset past the capacity: empty
    (256, 256, 10, 200, 256),
])
def test_slice_matches_jax(cap, num_rows, offset, length, out_cap):
    rng = np.random.default_rng(offset + length)
    datas, valids = _mixed_planes(rng, (cap,) * 4, num_rows)
    length = max(0, min(length, num_rows - offset))  # ColumnarBatch.slice
    want = JK._dyn_slice(tuple(jnp.asarray(x) for x in datas),
                         tuple(jnp.asarray(x) for x in valids),
                         jnp.int64(offset), jnp.int64(length), out_cap=out_cap)
    got = K.slice_planes([_t(x) for x in datas], [_t(x) for x in valids],
                         offset, length, out_cap)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        _same_bytes(a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_concat_matches_jax(k):
    rng = np.random.default_rng(k)
    caps = [256, 1024, 256, 512, 256][:k]
    rows = [200, 0, 256, 37, 0][:k]            # empty batches included
    per_batch = [_mixed_planes(rng, (c,) * 4, n) for c, n in zip(caps, rows)]
    per_field_d = [[b[0][f] for b in per_batch] for f in range(4)]
    per_field_v = [[b[1][f] for b in per_batch] for f in range(4)]
    out_cap = JaxConfig().capacity_for(sum(rows))
    want = JK.concat_planes([[jnp.asarray(x) for x in p] for p in per_field_d],
                            [[jnp.asarray(x) for x in p] for p in per_field_v],
                            rows, out_cap)
    got = K.concat_planes([[_t(x) for x in p] for p in per_field_d],
                          [[_t(x) for x in p] for p in per_field_v], rows, out_cap)
    for a, b in zip(list(want[0]) + list(want[1]), got[0] + got[1]):
        _same_bytes(a, b)


# -- window units --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restarting_counters_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 500
    part = rng.random(n) < 0.05
    peer = part | (rng.random(n) < 0.3)
    carry = (int(rng.integers(0, 9)), int(rng.integers(1, 9)), int(rng.integers(0, 9)))
    for args in ((part, peer), (part, peer) + carry):
        for a, b in zip(JK.restarting_counters(*args), K.restarting_counters(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JK.seg_start_index(part), K.seg_start_index(part))


def test_running_key_codes_match_jax_across_batches():
    """Key rows of float and int keys (nulls, -0.0, NaN payloads) pushed
    batch by batch: the same run starts, carries included."""
    rng = np.random.default_rng(11)
    n = 600
    f = rng.choice(np.array([0.0, -0.0, np.nan, 1.0, 2.0]), n)
    f[::7] = np.float64(np.frombuffer(np.uint64(0x7ff8000000000123).tobytes(), np.float64)[0])
    i = np.repeat(rng.integers(0, 5, n // 6), 6)
    fv = rng.random(n) >= 0.1
    iv = rng.random(n) >= 0.1
    schema = JT.Schema.of(("f", JT.F64), ("i", JT.I64))
    ref, port = JKM.RunningKeyCodes(), KM.RunningKeyCodes()
    for s in range(0, n, 128):
        cols = {"f": (f[s:s + 128], fv[s:s + 128]), "i": (i[s:s + 128], iv[s:s + 128])}
        jb = JBatch.from_arrow(pa.record_batch(
            [pa.array(d, mask=~v) for d, v in cols.values()], names=["f", "i"]))
        tb = columns_from_numpy(schema, cols)
        jrows = JKM.key_rows(jb, jb.columns)
        trows = KM.key_rows(tb, tb.columns)
        np.testing.assert_array_equal(jrows, trows)
        np.testing.assert_array_equal(ref.push_rows(jrows), port.push_rows(trows))


# -- q67 -------------------------------------------------------------------------------

PARTS = 3
ROWS_PER_PART = 3000
F = JE.AggFunction
SALES = JT.Schema.of(("ss_item_sk", JT.I64), ("ss_store_sk", JT.I64),
                     ("ss_quantity", JT.I64))


def _sales(seed, items, stores, qty, nulls):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(PARTS):
        cols = {"ss_item_sk": rng.integers(1, items, ROWS_PER_PART),
                "ss_store_sk": rng.integers(1, stores, ROWS_PER_PART),
                "ss_quantity": rng.integers(1, qty, ROWS_PER_PART)}
        part = {}
        for name, d in cols.items():
            v = rng.random(ROWS_PER_PART) >= nulls
            part[name] = (np.where(v, d, 0), v)
        parts.append(part)
    return parts


def _col(name):
    return JE.Column(name)


def _q67(kind="rank", group_limit=None):
    """bench.py:plan_q67 over an FFIReader source; ``kind`` and
    ``group_limit`` give the window variants."""
    keys = [("ss_item_sk", _col("ss_item_sk")), ("ss_store_sk", _col("ss_store_sk"))]
    aggs = [("qty", JE.AggExpr(F.SUM, [_col("ss_quantity")]))]
    scan = JN.FFIReader(SALES, "store_sales", PARTS)
    partial = JN.Agg(scan, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(a, JE.AggMode.PARTIAL, n) for n, a in aggs],
                     supports_partial_skipping=True)
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([e for _, e in keys], PARTS))
    final = JN.Agg(ex, JE.AggExecMode.HASH_AGG, keys,
                   [JN.AggColumn(a, JE.AggMode.FINAL, n) for n, a in aggs])
    srt = JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                  [JE.SortOrder(_col("ss_item_sk")),
                   JE.SortOrder(_col("qty"), ascending=False)])
    win = JN.Window(srt, [JN.WindowExpr(kind, "rk")], [_col("ss_item_sk")],
                    [JE.SortOrder(_col("qty"), ascending=False)],
                    group_limit=group_limit)
    lit = JE.Literal(3, JT.I64 if kind == "row_number" else JT.I32)
    return JN.Filter(win, [JE.BinaryExpr(JE.BinaryOp.LTEQ, _col("rk"), lit)])


def _arrow_batches(part, batch):
    return [pa.record_batch([pa.array(d[s:s + batch], type=pa.int64(), mask=~v[s:s + batch])
                             for d, v in part.values()], names=SALES.names)
            for s in range(0, ROWS_PER_PART, batch)]


def _run_both(plan, parts, batch_size):
    with JaxSession(conf=_jax_conf(JaxConfig(batch_size=batch_size))) as s:
        s.resources["store_sales"] = lambda p: _arrow_batches(parts[p], 1024)
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=batch_size), device="cpu")
    port.resources["store_sales"] = lambda p: [
        {k: (d[s:s + 1024], v[s:s + 1024]) for k, (d, v) in parts[p].items()}
        for s in range(0, ROWS_PER_PART, 1024)]
    got = port.execute_to_pydict(from_foreign(plan))
    return want, got


@pytest.mark.parametrize("case", ["ties", "null_keys", "radix_slots"])
def test_q67_matches_jax(case):
    """Items split across window batches (batch_size 256 over ~900
    groups), narrow quantities for rank ties; null item, store and
    quantity values; a key space past the dense slot plan."""
    data = {"ties": (1, 50, 20, 4, 0.0),
            "null_keys": (2, 30, 20, 4, 0.05),
            "radix_slots": (3, 300, 400, 3, 0.0)}[case]
    want, got = _run_both(_q67(), _sales(*data), batch_size=256)
    assert len(got["rk"]) > 50
    assert got == want
    if case == "null_keys":
        assert None in got["ss_item_sk"] and None in got["ss_store_sk"]


@pytest.mark.parametrize("kind,limit", [("row_number", 2), ("dense_rank", 2),
                                        ("rank", 1)])
def test_q67_window_variants_with_group_limit_match_jax(kind, limit):
    want, got = _run_both(_q67(kind, group_limit=limit),
                          _sales(4, 40, 20, 4, 0.02), batch_size=256)
    assert got == want
    assert len(got["rk"]) >= 39 and max(got["rk"]) == limit  # 39 items


def test_window_aggregate_raises_naming_roadmap():
    """Window aggregates run on the port since K13; one whose result is a
    decimal wider than 18 digits still raises, naming the ROADMAP item."""
    plan = _q67()
    win = plan.child
    agg = JN.WindowExpr("agg", "s", JE.AggExpr(F.SUM, [_col("qty")], JT.DecimalType(25, 2)))
    plan = JN.Window(win.child, [agg], win.partition_spec, win.order_spec)
    port = blaze_tpu_torch.Session(device="cpu")
    parts = _sales(5, 10, 5, 4, 0.0)
    port.resources["store_sales"] = lambda p: [parts[p]]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.execute_to_pydict(from_foreign(plan))
