"""The port's sort route of the grouped aggregation (K10 with K5's sort)
against the JAX package's ``_partial_kernel`` and ``_merge_kernel``, the
routing between it and the slot routes (K3/K4), and the device-route
cases of the JAX package's aggregation tests re-run on the port.

- Kernel level: the same numpy inputs, drawn from a seed, go through the
  jitted JAX kernels (on the CPU, as the JAX package's own tests call
  them) and the port's twins, output by output.
- Plan level: plans built with ``blaze_tpu.ir`` and carried across with
  ``from_foreign`` run through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")`` under the same
  ``dense_agg``/``radix_agg`` settings; the results must be equal, order
  included.

Tolerance: none. Integer and bool planes are compared by value, float
planes bit for bit (so -0.0 is not 0.0), except that any NaN equals any
NaN: a NaN's payload is the hardware's (x86 and the H100 give different
ones for inf - inf), not part of the result. Float sums are left folds in
row order on both sides, so they agree to the bit. Inputs hold no
subnormal floats: the JAX package flushes them to zero on the CPU and the
port keeps them (ROADMAP.md Queue 3); ``test_subnormal_floats_are_kept``
shows both answers.
"""

import dataclasses
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
from blaze_tpu.ops import agg_device as JA
from blaze_tpu.ops import sort as JS
from blaze_tpu.ops.joins import keymap as JKM
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.ir.carry import columns_from_numpy, from_foreign
from blaze_tpu_torch.ops import agg_device as A
from blaze_tpu_torch.runtime.executor import build_operator

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


F = JE.AggFunction
M = JE.AggMode
HASH = JE.AggExecMode.HASH_AGG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(j, t):
    """Equal planes: dtype, shape, values; floats by their bits, NaN = NaN."""
    j, t = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    if j.dtype.kind == "f":
        bits = {4: np.int32, 8: np.int64}[j.dtype.itemsize]
        ok = (np.isnan(j) & np.isnan(t)) | (j.view(bits) == t.view(bits))
        assert ok.all(), (np.nonzero(~ok)[0][:8], j[~ok][:8], t[~ok][:8])
    else:
        np.testing.assert_array_equal(j, t)


def _same_outputs(jouts, touts):
    assert len(jouts) == len(touts)
    assert int(jouts[0]) == int(touts[0])
    for j, t in zip(jouts[1:], touts[1:]):
        _same(j, t)


# -- kernel level: _partial_kernel and _merge_kernel -----------------------------

_FLOATS = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -2.25, 1e300, -1e300,
                    7.0, 3.0, -1e-300, 0.1])


def _plane(kind, cap, n, rng, nulls, lo=-40, hi=40):
    """(data, validity) of one column: ``n`` live rows of ``cap``, padding
    rows data 0 and validity False, ``nulls`` of the live rows null (their
    data left as drawn: the kernels must not read it)."""
    live = np.arange(cap) < n
    if kind in ("f64", "f32"):
        d = _FLOATS[rng.integers(0, len(_FLOATS), cap)]
        with np.errstate(over="ignore"):  # +-1e300 is +-inf in float32
            d = d.astype(np.float64 if kind == "f64" else np.float32)
    else:
        d = rng.integers(lo, hi, cap).astype({"i64": np.int64, "i32": np.int32}[kind])
    v = live & (rng.random(cap) >= nulls)
    return np.where(live, d, 0).astype(d.dtype), v


_PARTIAL_SPECS = {
    # aggregate kind, rescale, accumulator; the argument column it reads
    "ints": ((("sum", 0, "int64"), "a"), (("count", 0, ""), "*"),
             (("avg", 4, "int64"), "a"), (("min", 0, ""), "b"), (("max", 0, ""), "b"),
             (("count", 0, ""), "a")),
    "floats": ((("sum", 0, "float64"), "x"), (("min", 0, ""), "x"), (("max", 0, ""), "x"),
               (("avg", 0, "float64"), "x"), (("sum", 0, "float64"), "y"),
               (("min", 0, ""), "y"), (("max", 0, ""), "y"), (("avg", 0, "float64"), "a"),
               (("count", 0, ""), "x")),
}


def _partial_case(keys, cap, n, specs_name, nulls, seed, key_range=(-40, 40)):
    rng = np.random.default_rng(seed)
    exists = np.arange(cap) < n
    kcols = [_plane(k, cap, n, rng, nulls, *key_range) for k in keys]
    cols = {"a": _plane("i64", cap, n, rng, nulls, -10 ** 6, 10 ** 6),
            "b": _plane("i32", cap, n, rng, nulls, -1000, 1000),
            "x": _plane("f64", cap, n, rng, nulls),
            "y": _plane("f32", cap, n, rng, nulls),
            "*": (np.zeros(cap, np.int64), exists)}
    specs = tuple(s for s, _ in _PARTIAL_SPECS[specs_name])
    args = [cols[c] for _, c in _PARTIAL_SPECS[specs_name]]
    return exists, kcols, specs, args


def _jax_partial(exists, kcols, specs, args):
    cap = len(exists)
    jk = JA._partial_kernel(tuple(str(d.dtype) for d, _ in kcols), specs,
                            tuple(str(d.dtype) for d, _ in args), cap)
    flat = []
    for d, v in kcols:
        flat += [jnp.asarray(d), jnp.asarray(v & exists)]
    for d, v in args:
        flat += [jnp.asarray(d), jnp.asarray(v & exists)]
    return jk(jnp.asarray(exists), *flat)


def _port_partial(exists, kcols, specs, args, n):
    return A.seg_agg_partial([_t(d) for d, _ in kcols], [_t(v & exists) for _, v in kcols],
                             n, specs, [(_t(d), _t(v & exists)) for d, v in args])


@pytest.mark.parametrize("keys,cap,n,specs,nulls,key_range", [
    (["i64"], 256, 200, "ints", 0.2, (-40, 40)),           # negative keys: sorted
    (["i64"], 256, 256, "floats", 0.1, (0, 255)),          # direct: keys in [0, cap-1)
    (["i64"], 256, 230, "ints", 0.1, (0, 256)),            # a key at cap-1: sorted
    (["i32"], 1024, 1000, "floats", 0.0, (0, 20)),         # direct, no nulls
    (["f64"], 256, 240, "ints", 0.1, (0, 1)),              # NaN, +-0.0, +-inf keys
    (["f32"], 256, 200, "floats", 0.1, (0, 1)),
    (["i64", "f64"], 1024, 900, "floats", 0.1, (-3, 3)),
    (["i64", "i32", "i64"], 1024, 1000, "ints", 0.05, (-4, 4)),
    (["i64", "i64", "i64", "i64"], 4096, 4000, "floats", 0.1, (0, 4)),
    (["i64", "i32", "f64", "i64", "i64"], 4096, 3000, "ints", 0.1, (0, 3)),
    (["i64"], 256, 200, "floats", 1.0, (0, 10)),           # every key null
    (["i64", "i64"], 256, 1, "ints", 0.0, (0, 5)),         # one row
])
def test_partial_kernel_matches_jax(keys, cap, n, specs, nulls, key_range):
    exists, kcols, specs_t, args = _partial_case(keys, cap, n, specs, nulls,
                                                 cap + n + len(keys), key_range)
    _same_outputs(_jax_partial(exists, kcols, specs_t, args),
                  _port_partial(exists, kcols, specs_t, args, n))


def _states_of(kinds, touts, k, live, rng):
    """The partial outputs as merge-input state columns, with the validity
    planes drawn at random so every gate of ``_merge_reduce`` is taken."""
    nstate = {"sum": 2, "count": 1, "avg": 2, "min": 2, "max": 2}
    states, pos = [], 2 + 2 * k
    for kind in kinds:
        cols = []
        for j in range(nstate[kind]):
            d = touts[pos + j]
            cols.append((d, live & (rng.random(len(live)) >= 0.1)))
        states.append(cols)
        pos += nstate[kind]
    return states


@pytest.mark.parametrize("keys,specs,key_range", [
    (["i64"], "ints", (-30, 30)),
    (["i64"], "floats", (0, 50)),        # direct merge
    (["f64"], "floats", (0, 1)),
    (["i64", "i32"], "floats", (-5, 5)),
    (["i64", "i32", "f64", "i64", "i64"], "ints", (0, 3)),
])
def test_merge_kernel_matches_jax(keys, specs, key_range):
    """Three 'maps' of partial states (the port's partial outputs,
    concatenated, validity redrawn), merged by ``_merge_kernel`` and by
    the port's twin."""
    rng = np.random.default_rng(len(keys) * 7 + len(specs))
    parts = []
    for m in range(3):
        cap, n = 1024, 900 - 200 * m
        exists, kcols, specs_t, args = _partial_case(keys, cap, n, specs, 0.1,
                                                     m + 100, key_range)
        outs = _port_partial(exists, kcols, specs_t, args, n)
        g = int(outs[0])
        parts.append([o[:g].numpy() for o in outs[2:]])
    total = sum(len(p[0]) for p in parts)
    cap = 4096
    live = np.arange(cap) < total
    cols = [np.concatenate([np.concatenate([p[i] for p in parts]),
                            np.zeros(cap - total, parts[0][i].dtype)])
            for i in range(len(parts[0]))]
    k = len(keys)
    kinds = tuple(s[0] for s in specs_t)
    kd = [cols[2 * i] for i in range(k)]
    kv = [cols[2 * i + 1] & live for i in range(k)]
    states = _states_of(kinds, [None, None] + cols, k, live, rng)
    jk = JA._merge_kernel(tuple(str(d.dtype) for d in kd), kinds,
                          tuple(tuple(str(d.dtype) for d, _ in sc) for sc in states), cap)
    flat = []
    for d, v in zip(kd, kv):
        flat += [jnp.asarray(d), jnp.asarray(v)]
    for sc in states:
        for d, v in sc:
            flat += [jnp.asarray(d), jnp.asarray(v)]
    jouts = jk(jnp.asarray(live), *flat)
    touts = A.seg_agg_merge([_t(d) for d in kd], [_t(v) for v in kv], total, kinds,
                            [[(_t(d), _t(v & live)) for d, v in sc] for sc in states])
    _same_outputs(jouts, touts)


def test_null_order_of_the_two_segmentations():
    """One int key with nulls: the direct segmentation (keys in [0, cap-1))
    puts the null group last, the sorted one first; each equals the
    reference, and the slot order (``direct=False``) is the sorted one."""
    cap, n = 256, 200
    rng = np.random.default_rng(5)
    exists = np.arange(cap) < n
    for lo, hi, null_last in ((0, 100, True), (-5, 100, False)):
        kd, kv = _plane("i64", cap, n, rng, 0.1, lo, hi)
        specs = (("count", 0, ""),)
        args = [(np.zeros(cap, np.int64), exists)]
        jouts = _jax_partial(exists, [(kd, kv)], specs, args)
        touts = _port_partial(exists, [(kd, kv)], specs, args, n)
        _same_outputs(jouts, touts)
        g = int(touts[0])
        assert bool(touts[3][g - 1]) is not null_last and bool(touts[3][0]) is null_last
        slot = A.seg_agg_partial([_t(kd)], [_t(kv & exists)], n, specs,
                                 [(_t(a), _t(v)) for a, v in args], direct=False)
        assert not bool(slot[3][0]) and bool(slot[3][g - 1])


def test_nan_in_float_min_max_propagates():
    """XLA's scatter min/max propagate NaN: a group holding a NaN gives NaN
    (Spark would order NaN largest); -0.0 is below 0.0."""
    cap, n = 256, 6
    exists = np.arange(cap) < n
    kd = np.array([1, 1, 2, 2, 3, 3] + [0] * (cap - n), np.int64)
    x = np.array([1.0, np.nan, 0.0, -0.0, -0.0, 0.0] + [0.0] * (cap - n))
    specs = (("min", 0, ""), ("max", 0, ""), ("sum", 0, "float64"))
    args = [(x, exists)] * 3
    jouts = _jax_partial(exists, [(kd, exists)], specs, args)
    touts = _port_partial(exists, [(kd, exists)], specs, args, n)
    _same_outputs(jouts, touts)
    mn, mx, s = touts[4].numpy()[:3], touts[6].numpy()[:3], touts[8].numpy()[:3]
    assert np.isnan(mn[0]) and np.isnan(mx[0]) and np.isnan(s[0])
    assert np.signbit(mn[1]) and not np.signbit(mx[1]) and not np.signbit(s[1])


def test_float_sum_is_a_left_fold_in_row_order():
    """A float sum over 60,000 rows of four groups equals numpy's left fold
    in row order bit for bit (and not a pairwise sum)."""
    cap = n = 65536
    rng = np.random.default_rng(9)
    exists = np.ones(cap, bool)
    kd = rng.integers(0, 4, cap) * 1000 - 1500   # sorted route
    x = rng.standard_normal(cap) * 10.0 ** rng.integers(-8, 16, cap)
    touts = _port_partial(exists, [(kd, exists)], (("sum", 0, "float64"),),
                          [(x, exists)], n)
    for g, key in enumerate(sorted(set(kd.tolist()))):
        acc = 0.0
        for v in x[kd == key].tolist():
            acc += v
        assert touts[4][g].item() == acc
    assert any(touts[4][g].item() != float(np.sum(x[kd == key]))
               for g, key in enumerate(sorted(set(kd.tolist()))))


def test_canonical_keys_match_jax():
    rng = np.random.default_rng(4)
    for kind in ("f64", "f32", "i64"):
        d, v = _plane(kind, 256, 250, rng, 0.2)
        want = JA._canonical_keys([jnp.asarray(d)], [jnp.asarray(v)])[0]
        _same(want, K.canonical_keys([_t(d)], [_t(v)])[0])


def test_segment_twins_on_their_own():
    """``segment_ids`` and ``segment_reduce`` as the wrappers compose them:
    dense starts, num_rows past the count, first rows, zeros past the
    count."""
    kd = _t(np.array([3, 1, 3, 2, 1, 0, 0, 0], np.int64))
    kv = _t(np.array([1, 1, 1, 1, 1, 0, 0, 0], bool))
    exists = _t(np.arange(8) < 5)
    order, starts, count = K.segment_ids([kd], [kv], exists, 5, direct=False)
    assert order[:5].tolist() == [1, 4, 3, 0, 2] and int(count) == 3
    assert starts.tolist() == [0, 2, 3, 5, 5, 5, 5, 5, 5]
    ops = [K.AggOp(K.OP_COUNT, None, [kv])]
    emits = [K.AggEmit(K.EMIT_RAW, 0, torch.int64)]
    outs, first = K.segment_reduce("seg_agg_partial", order, starts, count, 5, ops, emits)
    assert outs[0].tolist() == [2, 1, 2, 0, 0, 0, 0, 0]
    assert first.tolist() == [1, 3, 0, 0, 0, 0, 0, 0]


def test_slot_kernels_refuse_float_states():
    """K3/K4 add with atomics: a float state never reaches them."""
    cap = 256
    d = _t(np.zeros(cap, np.int64))
    v = _t(np.ones(cap, bool))
    with pytest.raises(TypeError, match="sort route"):
        A.slot_agg_partial([d], [v], [torch.int64], cap, (0,), (2,),
                           (("sum", 0, "float64"),), [(d.double(), v)], 2)


# -- plan level -----------------------------------------------------------------

PARTS = 3
ROWS = 1200
BATCH = 256


def _cols(seed, spec):
    """Per partition {column: (data, validity)}: ``spec`` maps a column to
    (kind, lo, hi, null share)."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(PARTS):
        part = {}
        for name, (kind, lo, hi, nulls) in spec.items():
            d, v = _plane(kind, ROWS, ROWS, rng, nulls, lo, hi)
            part[name] = (np.where(v, d, 0).astype(d.dtype), v)
        parts.append(part)
    return parts


_ARROW = {np.dtype(np.int64): pa.int64(), np.dtype(np.int32): pa.int32(),
          np.dtype(np.float64): pa.float64(), np.dtype(np.float32): pa.float32()}
_JT = {"i64": JT.I64, "i32": JT.I32, "f64": JT.F64, "f32": JT.F32}


def _arrow(schema, part):
    return pa.record_batch([pa.array(part[f.name][0], type=_ARROW[part[f.name][0].dtype],
                                     mask=~part[f.name][1]) for f in schema.fields],
                           names=schema.names)


def _slices(part, batch=BATCH):
    n = len(next(iter(part.values()))[0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, n, batch)]


def _canon(d):
    """Floats by repr (-0.0 and nan spelled out), everything else as is."""
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _run_both(plan, schema, parts, jconf, conf):
    with JaxSession(conf=_jax_conf(jconf)) as s:
        s.resources["src"] = lambda p: [_arrow(schema, b) for b in _slices(parts[p])]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    port.resources["src"] = lambda p: _slices(parts[p])
    got = port.execute_to_pydict(from_foreign(plan))
    return _canon(want), _canon(got)


def _two_stage(keys, aggs, schema, partitions=PARTS, scan_parts=PARTS):
    scan = JN.FFIReader(schema, "src", scan_parts)
    kcols = [(k, JE.Column(k)) for k in keys]
    partial = JN.Agg(scan, HASH, kcols, [JN.AggColumn(a, M.PARTIAL, n) for n, a in aggs])
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([JE.Column(k) for k in keys],
                                                         partitions))
    return JN.Agg(ex, HASH, kcols, [JN.AggColumn(a, M.FINAL, n) for n, a in aggs])


def _aggs(value_cols):
    out = [("cnt", JE.AggExpr(F.COUNT, []))]
    for c in value_cols:
        out += [(f"s_{c}", JE.AggExpr(F.SUM, [JE.Column(c)])),
                (f"a_{c}", JE.AggExpr(F.AVG, [JE.Column(c)])),
                (f"mn_{c}", JE.AggExpr(F.MIN, [JE.Column(c)])),
                (f"mx_{c}", JE.AggExpr(F.MAX, [JE.Column(c)])),
                (f"c_{c}", JE.AggExpr(F.COUNT, [JE.Column(c)]))]
    return out


_DATA = {
    # columns: (kind, lo, hi, null share); the grouping keys; the value columns
    "int_key_float_values": ({"k": ("i64", -20, 60, 0.1), "x": ("f64", 0, 1, 0.1),
                              "w": ("i64", -1000, 1000, 0.1)}, ["k"], ["x", "w"]),
    "direct_key": ({"k": ("i64", 0, 200, 0.1), "w": ("i64", -50, 50, 0.0)}, ["k"], ["w"]),
    "float_keys": ({"f": ("f64", 0, 1, 0.1), "k": ("i32", 0, 3, 0.1),
                    "y": ("f32", 0, 1, 0.1)}, ["f", "k"], ["y"]),
    "five_keys": ({"k1": ("i64", 0, 2, 0.05), "k2": ("i64", 0, 5, 0.05),
                   "k3": ("i32", 0, 7, 0.05), "k4": ("i64", 500, 10_000, 0.0),
                   "k5": ("i64", 0, 4, 0.05), "w": ("i64", 0, 100, 0.1)},
                  ["k1", "k2", "k3", "k4", "k5"], ["w"]),
}
_ROUTES = {
    # name: (JAX config, port config)
    "sort": (JaxConfig(batch_size=BATCH, dense_agg=False, radix_agg=False),
             Config(batch_size=BATCH, dense_agg=False, radix_agg=False)),
    "slots": (JaxConfig(batch_size=BATCH, dense_agg=True, radix_agg=True),
              Config(batch_size=BATCH, dense_agg=True, radix_agg=True)),
    "default": (JaxConfig(batch_size=BATCH, dense_agg=True, radix_agg=True),
                Config(batch_size=BATCH)),
}


@pytest.mark.parametrize("data,route", [
    ("int_key_float_values", "sort"), ("int_key_float_values", "slots"),
    ("int_key_float_values", "default"), ("direct_key", "sort"),
    ("direct_key", "default"), ("float_keys", "sort"), ("float_keys", "default"),
    ("five_keys", "sort"), ("five_keys", "default"),
])
def test_two_stage_agg_matches_jax(data, route):
    """Partial -> hash exchange -> final, no sort: the groups' order is each
    route's emission order. Float values (NaN, +-0.0, +-inf) under the slot
    routes take K10 in the slot order; five keys are past
    radix_agg_max_slots (4 * 8 * 8 * 16384 * 8 slots), so every route
    sorts."""
    spec, keys, values = _DATA[data]
    schema = JT.Schema.of(*[(c, _JT[kind]) for c, (kind, *_r) in spec.items()])
    plan = _two_stage(keys, _aggs(values), schema)
    want, got = _run_both(plan, schema, _cols(len(data), spec), *_ROUTES[route])
    assert len(want["cnt"]) > 10
    assert got == want


def test_key_range_past_radix_agg_max_slots_matches_jax():
    """The default config on a key range wider than radix_agg_max_slots
    (100,000 customer keys against 1,024 slots): the slot plan is None, so
    partial and merge sort, as the reference does."""
    schema = JT.Schema.of(("cust", JT.I64), ("amt", JT.I64))
    parts = _cols(11, {"cust": ("i64", 1, 100_000, 0.05), "amt": ("i64", 0, 10 ** 6, 0.0)})
    plan = JN.Sort(JN.ShuffleExchange(
        _two_stage(["cust"], [("total", JE.AggExpr(F.SUM, [JE.Column("amt")])),
                              ("cnt", JE.AggExpr(F.COUNT, []))], schema),
        JN.SinglePartitioning(1)), [JE.SortOrder(JE.Column("total"), ascending=False),
                                    JE.SortOrder(JE.Column("cust"))], fetch_limit=100)
    want, got = _run_both(plan, schema, parts,
                          JaxConfig(batch_size=BATCH, radix_agg_max_slots=1024),
                          Config(batch_size=BATCH, radix_agg_max_slots=1024))
    assert len(got["cust"]) == 100 and got == want


# -- the JAX package's device-route aggregation tests, re-run on the port -------


def _port_rows(plan, schema, rows, conf, batches=1):
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    n = len(next(iter(rows.values()))[0])
    cuts = np.linspace(0, n, batches + 1).astype(int)
    port.resources["src"] = lambda p: [{k: (d[a:b], v[a:b]) for k, (d, v) in rows.items()}
                                       for a, b in zip(cuts, cuts[1:])]
    return port.execute_to_pydict(from_foreign(plan))


_BOTH = [Config(dense_agg=False, radix_agg=False), Config(dense_agg=True, radix_agg=True)]


@pytest.mark.parametrize("conf", _BOTH, ids=["sort", "slots"])
def test_device_partial_widening_sum_i32(conf):
    """tests/test_agg.py: sum(int32) accumulates in int64; avg(int32) is a
    float64 average."""
    schema = JT.Schema.of(("k", JT.I32), ("v", JT.I32))
    n = 3000
    rows = {"k": (np.ones(n, np.int32), np.ones(n, bool)),
            "v": (np.full(n, 2_000_000, np.int32), np.ones(n, bool))}
    aggs = [("s", JE.AggExpr(F.SUM, [JE.Column("v")])),
            ("a", JE.AggExpr(F.AVG, [JE.Column("v")]))]
    out = _port_rows(_two_stage(["k"], aggs, schema, 1, 1), schema, rows, conf)
    assert out["s"] == [2_000_000 * n] and out["a"] == [2_000_000.0]


@pytest.mark.parametrize("conf", _BOTH, ids=["sort", "slots"])
def test_device_partial_expr_keys_multi_batch(conf):
    """tests/test_agg.py: a computed grouping key (k + 0) over two batches."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    rows = {"k": (np.array([1, 1, 2, 5, 5, 6]), np.ones(6, bool)),
            "v": (np.ones(6, np.int64), np.ones(6, bool))}
    g = JE.BinaryExpr(JE.BinaryOp.ADD, JE.Column("k"), JE.Literal(0, JT.I64))
    scan = JN.FFIReader(schema, "src", 1)
    count = JE.AggExpr(F.COUNT, [])
    partial = JN.Agg(scan, HASH, [("g", g)], [JN.AggColumn(count, M.PARTIAL, "c")])
    final = JN.Agg(partial, HASH, [("g", JE.Column("g"))],
                   [JN.AggColumn(count, M.FINAL, "c")])
    out = _port_rows(final, schema, rows, conf, batches=2)
    assert out == {"g": [1, 2, 5, 6], "c": [2, 1, 2, 1]}


@pytest.mark.parametrize("route", ["sort", "slots"])
def test_device_final_merge_matches_host_table(route):
    """tests/test_agg.py, its device half: decimal sum/avg, min/max, count
    and null group keys through partial and final, equal to the JAX
    package under the same route."""
    rng = np.random.default_rng(71)
    n = 5000
    kv = np.arange(n) % 50 != 0
    rows = {"k": (np.where(kv, rng.integers(0, 40, n), 0), kv),
            "amt": (rng.integers(0, 10000, n), np.ones(n, bool)),
            "v": (rng.integers(-100, 100, n), np.ones(n, bool))}
    schema = JT.Schema.of(("k", JT.I64), ("amt", JT.DecimalType(7, 2)), ("v", JT.I64))
    aggs = [("s", JE.AggExpr(F.SUM, [JE.Column("amt")], JT.DecimalType(17, 2))),
            ("a", JE.AggExpr(F.AVG, [JE.Column("amt")], JT.DecimalType(11, 6))),
            ("mn", JE.AggExpr(F.MIN, [JE.Column("v")])),
            ("mx", JE.AggExpr(F.MAX, [JE.Column("v")])),
            ("c", JE.AggExpr(F.COUNT, []))]
    plan = _two_stage(["k"], aggs, schema, 1, 1)
    jconf, conf = _ROUTES[route]
    with JaxSession(conf=_jax_conf(jconf)) as s:
        cuts = np.linspace(0, n, 5).astype(int)

        def batches(p):
            out = []
            for a, b in zip(cuts, cuts[1:]):
                amt = [decimal.Decimal(int(x)).scaleb(-2) for x in rows["amt"][0][a:b]]
                out.append(pa.record_batch(
                    [pa.array(rows["k"][0][a:b], mask=~rows["k"][1][a:b]),
                     pa.array(amt, type=pa.decimal128(7, 2)), pa.array(rows["v"][0][a:b])],
                    names=["k", "amt", "v"]))
            return out

        s.resources["src"] = batches
        want = s.execute_to_pydict(plan)
    got = _port_rows(plan, schema, rows, conf, batches=4)
    assert got == want and None in got["k"]


@pytest.mark.parametrize("conf", _BOTH, ids=["sort", "slots"])
def test_partial_consolidation_single_output_batch(conf):
    """tests/test_agg.py: a task's partials over five batches consolidate
    into one state batch of 23 groups, and finalize to the totals."""
    rng = np.random.default_rng(3)
    n = 9000
    k, v = rng.integers(0, 23, n), rng.integers(0, 100, n)
    rows = {"k": (k, np.ones(n, bool)), "v": (v, np.ones(n, bool))}
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.I64))
    aggs = [("s", JE.AggExpr(F.SUM, [JE.Column("v")], JT.I64)),
            ("a", JE.AggExpr(F.AVG, [JE.Column("v")], JT.F64))]
    scan = JN.FFIReader(schema, "src", 1)
    partial = JN.Agg(scan, HASH, [("k", JE.Column("k"))],
                     [JN.AggColumn(a, M.PARTIAL, nm) for nm, a in aggs])
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    cuts = np.linspace(0, n, 6).astype(int)
    port.resources["src"] = lambda p: [{c: (d[a:b], m[a:b]) for c, (d, m) in rows.items()}
                                       for a, b in zip(cuts, cuts[1:])]
    outs = [b for b in port.execute(from_foreign(partial)) if b.num_rows]
    assert len(outs) == 1 and outs[0].num_rows == 23
    final = JN.Agg(partial, HASH, [("k", JE.Column("k"))],
                   [JN.AggColumn(a, M.FINAL, nm) for nm, a in aggs])
    out = _port_rows(final, schema, rows, conf, batches=5)
    keys = sorted(set(k.tolist()))
    got = dict(zip(out["k"], zip(out["s"], out["a"])))
    for key in keys:
        assert got[key][0] == int(v[k == key].sum())
        assert got[key][1] == pytest.approx(v[k == key].mean())


# tests/test_dense_agg.py and tests/test_radix_agg.py: the partial agger's
# routing edges on int keys, each also run with the slot routes off.


def _agger(conf, groupings=("k1",)):
    schema = JT.Schema.of(("k1", JT.I64), ("k2", JT.I64), ("v", JT.I64))
    node = JN.Agg(JN.FFIReader(schema, "src", 1), HASH,
                  [(g, JE.Column(g)) for g in groupings],
                  [JN.AggColumn(JE.AggExpr(F.SUM, [JE.Column("v")]), M.PARTIAL, "s")])
    op = build_operator(from_foreign(node))
    return A.DevicePartialAgger(op, op.children[0].schema, conf)


def _batch(ks, vs):
    n = len(ks)
    kv = np.array([k is not None for k in ks])
    kd = np.array([k if k is not None else 0 for k in ks], np.int64)
    schema = from_foreign(JT.Schema.of(("k1", JT.I64), ("k2", JT.I64), ("v", JT.I64)))
    return columns_from_numpy(schema, {"k1": (kd, kv), "k2": (np.zeros(n, np.int64),
                                                              np.ones(n, bool)),
                                       "v": (np.array(vs, np.int64), np.ones(n, bool))})


def _sums(out):
    d = out.to_pydict()
    return dict(zip(d["k1"], d["s#sum"]))


_SLOTS = Config(dense_agg=True, radix_agg=True)
_SORT = Config(dense_agg=False, radix_agg=False)


@pytest.mark.parametrize("conf", [_SORT, _SLOTS], ids=["sort", "slots"])
def test_dense_engages_and_anchors_far_from_zero(conf):
    agger = _agger(conf)
    out = agger.process(_batch([9_000_001, 9_000_002] * 50, [1] * 100))
    assert _sums(out) == {9_000_001: 50, 9_000_002: 50}
    if conf is _SLOTS:
        kind, bases, sizes, _ = agger._bucket_state
        assert kind == "dense" and bases == (9_000_001,) and sizes[0] <= 4
    else:
        assert agger._bucket_state is None and agger._dense_ok is False


@pytest.mark.parametrize("conf", [_SORT, _SLOTS], ids=["sort", "slots"])
@pytest.mark.parametrize("second,table", [([50, 51], "dense"), ([10005, 10006], "radix"),
                                          ([9_000_005, 9_000_006], None)])
def test_range_overflow_replans_or_sorts(conf, second, table):
    """A second batch outside the first plan: re-planned over the union
    (dense, radix past the dense cap), or, past radix_agg_max_slots, every
    table off and the sort route for the rest of the stream."""
    agger = _agger(conf)
    o1 = agger.process(_batch([5, 6, 7] * 100, [1] * 300))
    o2 = agger.process(_batch(second * 100, [2] * 200))
    assert o1.num_rows == 3 and _sums(o2) == {second[0]: 200, second[1]: 200}
    if conf is _SLOTS:
        if table is None:
            assert agger._dense_ok is False and agger._radix_ok is False
            assert agger._bucket_state is None
        else:
            assert agger._bucket_state[0] == table


@pytest.mark.parametrize("conf", [_SORT, _SLOTS], ids=["sort", "slots"])
def test_all_null_key_batches(conf):
    """An all-null batch after a plan keeps the plan's anchor; as the first
    batch it defers the plan (the sort route for it) and the next batch
    plans from its own keys."""
    agger = _agger(conf)
    agger.process(_batch([9_000_001, 9_000_002] * 50, [1] * 100))
    st = agger._bucket_state
    onull = agger.process(_batch([None] * 64, [3] * 64))
    assert _sums(onull) == {None: 192} and agger._bucket_state == st
    agger = _agger(conf)
    assert _sums(agger.process(_batch([None] * 64, [3] * 64))) == {None: 192}
    assert agger._bucket_state is None
    o2 = agger.process(_batch([9_000_001, 9_000_002] * 50, [1] * 100))
    assert _sums(o2) == {9_000_001: 50, 9_000_002: 50}
    if conf is _SLOTS:
        assert agger._bucket_state[1] == (9_000_001,)


@pytest.mark.parametrize("conf", [_SORT, _SLOTS], ids=["sort", "slots"])
def test_key_edges_stay_exact(conf):
    """A key just below the plan's anchor stays a real group, and keys near
    opposite int64 extremes never mis-bucket."""
    agger = _agger(conf)
    agger.process(_batch([10, 11] * 50, [1] * 100))
    o2 = agger.process(_batch([9] * 100, [2] * 100))
    assert o2.to_pydict()["k1"] == [9] and _sums(o2) == {9: 200}
    hi, lo = 2 ** 63 - 2, -(2 ** 63)
    agger = _agger(conf)
    assert sorted(_sums(agger.process(_batch([hi, hi + 1] * 50, [1] * 100)))) == [hi, hi + 1]
    assert _sums(agger.process(_batch([lo] * 100, [2] * 100))) == {lo: 200}


@pytest.mark.parametrize("conf", [_SORT, _SLOTS], ids=["sort", "slots"])
def test_dense_matches_oracle_multikey_nulls(conf):
    """tests/test_dense_agg.py's oracle case at 12,000 rows: two nullable
    int keys, SUM/MIN/MAX/COUNT/AVG, partial -> exchange -> final ->
    sort (nulls first)."""
    rng = np.random.default_rng(3)
    n = 12_000
    k1v, k2v = rng.random(n) >= 0.01, rng.random(n) >= 0.006
    k1 = np.where(k1v, rng.integers(1_000_000, 1_000_050, n), 0)
    k2 = np.where(k2v, rng.integers(0, 7, n), 0)
    v = rng.integers(-1000, 1000, n)
    rows = {"k1": (k1, k1v), "k2": (k2, k2v), "v": (v, np.ones(n, bool))}
    schema = JT.Schema.of(("k1", JT.I64), ("k2", JT.I64), ("v", JT.I64))
    aggs = [("s", JE.AggExpr(F.SUM, [JE.Column("v")])), ("mn", JE.AggExpr(F.MIN, [JE.Column("v")])),
            ("mx", JE.AggExpr(F.MAX, [JE.Column("v")])), ("c", JE.AggExpr(F.COUNT, [])),
            ("a", JE.AggExpr(F.AVG, [JE.Column("v")]))]
    plan = JN.Sort(JN.ShuffleExchange(_two_stage(["k1", "k2"], aggs, schema),
                                      JN.SinglePartitioning(1)),
                   [JE.SortOrder(JE.Column("k1")), JE.SortOrder(JE.Column("k2"))])
    port = blaze_tpu_torch.Session(conf=Config(batch_size=4096, dense_agg=conf.dense_agg,
                                               radix_agg=conf.radix_agg), device="cpu")
    cuts = [n * p // PARTS for p in range(PARTS + 1)]
    port.resources["src"] = lambda p: [{c: (d[cuts[p]:cuts[p + 1]], m[cuts[p]:cuts[p + 1]])
                                        for c, (d, m) in rows.items()}]
    out = port.execute_to_pydict(from_foreign(plan))
    groups = {}
    for a, b, x in zip(np.where(k1v, k1, -1).tolist(), np.where(k2v, k2, -1).tolist(),
                       v.tolist()):
        groups.setdefault((None if a < 0 else a, None if b < 0 else b), []).append(x)
    keys = sorted(groups, key=lambda g: tuple((x is not None, x or 0) for x in g))
    assert list(zip(out["k1"], out["k2"])) == keys
    assert out["s"] == [sum(groups[g]) for g in keys]
    assert out["mn"] == [min(groups[g]) for g in keys]
    assert out["mx"] == [max(groups[g]) for g in keys]
    assert out["c"] == [len(groups[g]) for g in keys]
    assert out["a"] == pytest.approx([np.mean(groups[g]) for g in keys])


@pytest.mark.parametrize("conf", _BOTH, ids=["sort", "slots"])
def test_radix_matches_sort_path(conf):
    """tests/test_radix_agg.py: ~50k (a, b) groups (a 2048 x 128 slot
    space, past dense_agg_max_buckets) through partial and merge, exact
    against a host oracle on either route."""
    rng = np.random.default_rng(9)
    n = 60_000
    a, b, v = rng.integers(0, 2000, n), rng.integers(0, 100, n), rng.integers(0, 100, n)
    rows = {"a": (a, np.ones(n, bool)), "b": (b, np.ones(n, bool)), "v": (v, np.ones(n, bool))}
    schema = JT.Schema.of(("a", JT.I64), ("b", JT.I64), ("v", JT.I64))
    aggs = [("s", JE.AggExpr(F.SUM, [JE.Column("v")])), ("c", JE.AggExpr(F.COUNT, [JE.Column("v")]))]
    out = _port_rows(_two_stage(["a", "b"], aggs, schema, 1, 1), schema, rows,
                     Config(batch_size=8192, dense_agg=conf.dense_agg,
                            radix_agg=conf.radix_agg), batches=8)
    key = a * 100 + b
    s = np.bincount(key, weights=v, minlength=200_000)
    c = np.bincount(key, minlength=200_000)
    got_key = np.array(out["a"]) * 100 + np.array(out["b"])
    assert len(got_key) == int((c > 0).sum())
    assert np.array_equal(np.array(out["s"]), s[got_key].astype(np.int64))
    assert np.array_equal(np.array(out["c"]), c[got_key])
    assert np.all(np.diff(got_key) > 0)  # key order on both routes


# -- subnormal floats: the port keeps them (ROADMAP.md Queue 3) -------------------


def test_subnormal_floats_are_kept():
    """The JAX package runs on XLA, which flushes subnormal floats to zero
    on the CPU; Spark keeps them, and so does the port. Each pair below is
    the reference's answer beside the port's."""
    import jax

    from blaze_tpu_torch.exprs.compiler import ExprEvaluator
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    sub = np.array([5e-324, 0.0, -5e-324, 1e-310, -0.0, 2.0, -1e-310, 0.0])
    # the filter: x > 0.0
    jgt = np.asarray(jax.jit(lambda x: x > 0.0)(jnp.asarray(sub)))
    schema = T.Schema.of(("x", T.F64))
    batch = columns_from_numpy(schema, {"x": (sub, np.ones(8, bool))})
    pred = E.BinaryExpr(E.BinaryOp.GT, E.Column("x"), E.Literal(0.0, T.F64))
    tgt = ExprEvaluator([pred], schema).evaluate_predicate(batch).numpy()[:8]
    assert jgt.tolist() == [False, False, False, False, False, True, False, False]
    assert tgt.tolist() == [True, False, False, True, False, True, False, False]
    # the K5 sort: the reference ties all seven near-zero keys
    ones = jnp.ones(8, bool)
    jops = JK._key_ops((jnp.asarray(sub),), (ones,), ones, ((True, True),))
    jorder = np.asarray(JS._device_sort_indices(list(jops), 8))
    live = _t(np.ones(8, bool))
    ops = K.sort_key_operands([_t(sub)], [live], live, [(True, True)])
    torder = K.lexsort_indices(ops, 8).numpy()
    assert jorder.tolist() == [0, 1, 2, 3, 4, 6, 7, 5]
    assert torder.tolist() == [6, 2, 1, 4, 7, 0, 3, 5]
    # the K9 probe against build keys {0.0, 5e-324, 1e-310, 3.0}
    build = np.array([0.0, 5e-324, 1e-310, 3.0])
    uniq = np.unique(JKM._canon_words(build))
    probe = np.array([5e-324, 1e-310, -5e-324, 3.0])
    tcodes = K.probe_codes(_t(uniq), len(uniq), _t(probe), _t(np.ones(4, bool))).numpy()
    jcodes = np.asarray(JKM._probe_fn("float64", len(uniq))(
        jnp.asarray(uniq), jnp.asarray(probe), jnp.ones(4, bool)))
    assert jcodes.tolist() == [0, 0, 0, 3] and tcodes.tolist() == [1, 2, -1, 3]
    # the float-key grouping: the reference folds the subnormals into 0.0
    cap = 256
    exists = np.arange(cap) < 8
    kd = np.concatenate([sub, np.zeros(cap - 8)])
    specs, args = (("count", 0, ""),), [(np.zeros(cap, np.int64), exists)]
    jouts = _jax_partial(exists, [(kd, exists)], specs, args)
    touts = _port_partial(exists, [(kd, exists)], specs, args, 8)
    assert int(jouts[0]) == 2 and np.asarray(jouts[4])[:2].tolist() == [7, 1]
    assert int(touts[0]) == 6 and touts[4][:6].tolist() == [1, 1, 3, 1, 1, 1]
