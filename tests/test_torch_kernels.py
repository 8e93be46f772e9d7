"""Plain PyTorch versions of the port's kernels K1-K4 against the JAX
package's functions, on the same numpy planes.

Tolerance: exact. Every plane on this slice is an integer, bool or
int64-backed decimal, so data, validity and counts must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.core import kernels as JK
from blaze_tpu.core.batch import DeviceColumn as JDeviceColumn
from blaze_tpu.exprs import spark_hash as JH
from blaze_tpu.ir import types as JT
from blaze_tpu.ops import agg_device as JA

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.exprs import spark_hash as H
from blaze_tpu_torch.ops import agg_device as A

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy() if isinstance(torch_out, torch.Tensor) else np.asarray(torch_out)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    np.testing.assert_array_equal(j, t)


def _planes(rng, cap, n, null_frac):
    """int64, int32, bool and decimal-unscaled int64 planes honouring the
    padding contract (data 0 and validity False past n and on nulls)."""
    datas, valids = [], []
    for dt in (np.int64, np.int32, np.bool_, np.int64):
        d = np.zeros(cap, dt)
        v = np.zeros(cap, bool)
        if dt == np.bool_:
            d[:n] = rng.random(n) < 0.5
        else:
            d[:n] = rng.integers(np.iinfo(dt).min // 2, np.iinfo(dt).max // 2, n)
        v[:n] = rng.random(n) >= null_frac
        d[~v] = 0
        datas.append(d)
        valids.append(v)
    return datas, valids


# -- K1 compact_planes ---------------------------------------------------------


@pytest.mark.parametrize("cap,n,keep,nulls", [
    (1024, 1024, 0.5, 0.2),
    (1024, 700, 0.0, 0.1),    # all-false mask, padding rows
    (1024, 1024, 1.0, 0.0),   # all-true mask
    (1024, 300, 0.9, 0.5),
    (262144, 262144, 0.95, 0.0),
    (262144, 150000, 0.4, 0.3),
])
def test_compact_planes_matches_jax(cap, n, keep, nulls):
    rng = np.random.default_rng(cap + n)
    datas, valids = _planes(rng, cap, n, nulls)
    mask = np.zeros(cap, bool)
    mask[:n] = rng.random(n) < keep
    jc, jd, jv = JK._compact(tuple(jnp.asarray(d) for d in datas),
                             tuple(jnp.asarray(v) for v in valids),
                             jnp.asarray(mask))
    tc, td, tv = K.compact_planes_plain([_t(d) for d in datas],
                                        [_t(v) for v in valids], _t(mask))
    assert int(jc) == int(tc)
    for a, b in zip(jd + jv, td + tv):
        _assert_same(a, b)
    # the wrapper takes the plain version for a CPU tensor
    count, wd, _wv = K.compact_planes([_t(d) for d in datas],
                                      [_t(v) for v in valids], _t(mask))
    assert count == int(jc)
    _assert_same(jd[0], wd[0])


@pytest.mark.parametrize("cap,n,keep,dtypes", [
    (4096, 4000, 0.4, ("int8", "int16", "int32", "int64") * 9),  # 72 planes
    (1025, 1025, 0.0, ("int8", "int16", "int32", "int64")),     # all false
    (1024, 1000, 1.0, ("int8", "uint8", "float32", "float64")),
    (1023, 900, 0.6, ("int16",) * 3 + ("bool",)),
])
def test_compact_planes_sizes_and_many_planes_match_jax(cap, n, keep, dtypes):
    """K1's twin against the reference on 1-, 2-, 4- and 8-byte planes,
    more than 32 planes (the 32 a launch of K1's first kernel), an all-false
    mask and sizes at a 1,024-row tile's edges."""
    rng = np.random.default_rng(cap + len(dtypes))
    datas, valids = [], []
    for dt in dtypes:
        d = np.zeros(cap, dt)
        if np.dtype(dt).kind in "iu":
            info = np.iinfo(dt)
            d[:n] = rng.integers(info.min, info.max, n, endpoint=True)
        elif dt == "bool":
            d[:n] = rng.random(n) < 0.5
        else:
            d[:n] = rng.normal(size=n) * 1e3
        v = np.zeros(cap, bool)
        v[:n] = rng.random(n) >= 0.1
        d[~v] = 0
        datas.append(d)
        valids.append(v)
    mask = np.zeros(cap, bool)
    mask[:n] = rng.random(n) < keep
    jc, jd, jv = JK._compact(tuple(jnp.asarray(d) for d in datas),
                             tuple(jnp.asarray(v) for v in valids), jnp.asarray(mask))
    tc, td, tv = K.compact_planes_plain([_t(d) for d in datas], [_t(v) for v in valids],
                                        _t(mask))
    assert int(jc) == int(tc) == int(mask.sum())
    for a, b in zip(jd + jv, td + tv):
        _assert_same(a, b)


# -- K2 murmur3_pmod -----------------------------------------------------------


_KEY_TYPES = {"i32": JT.I32, "i64": JT.I64, "dec": JT.DecimalType(7, 2)}


@pytest.mark.parametrize("cap,n,keys,nulls", [
    (1024, 1024, ("i64",), 0.0),
    (1024, 900, ("i32",), 0.3),
    (1024, 1000, ("dec",), 0.1),
    (1024, 512, ("i64", "i32"), 0.2),
    (262144, 262144, ("dec", "i64"), 0.05),
])
def test_murmur3_pmod_matches_jax(cap, n, keys, nulls):
    rng = np.random.default_rng(n + len(keys))
    jcols, words, valids, kinds = [], [], [], []
    for k in keys:
        dt = _KEY_TYPES[k]
        npdt = np.int32 if k == "i32" else np.int64
        d = np.zeros(cap, npdt)
        v = np.zeros(cap, bool)
        d[:n] = rng.integers(-(10 ** 7) if k == "dec" else np.iinfo(npdt).min,
                             10 ** 7 if k == "dec" else np.iinfo(npdt).max, n)
        v[:n] = rng.random(n) >= nulls
        d[~v] = 0
        jcols.append(JDeviceColumn(dt, jnp.asarray(d), jnp.asarray(v)))
        kind = H.hash_kind(_port_type(dt))
        kinds.append(kind)
        words.append(H.hash_words(_t(d), kind))
        valids.append(_t(v))
    jh = JH.hash_batch(jcols, n, cap, seed=42)
    for nparts in (1, 4, 200):
        th, tp = H.murmur3_pmod_plain(words, valids, kinds, n, nparts)
        np.testing.assert_array_equal(jh, th.numpy())
        jp = (((jh.astype(np.int64) % nparts) + nparts) % nparts).astype(np.int32)
        np.testing.assert_array_equal(jp, tp.numpy())


def _port_type(jdt):
    from blaze_tpu_torch.ir.carry import from_foreign

    return from_foreign(jdt)


def test_murmur3_spark_golden_vectors():
    """Spark-generated vectors (the JAX package's tests/test_spark_hash.py)."""
    v64 = torch.tensor([1, 0, -1, 2**63 - 1, -(2**63)], dtype=torch.int64)
    h, _ = H.murmur3_pmod_plain([v64], [torch.ones(5, dtype=torch.bool)],
                                ["i64"], 5, 4)
    expect = np.array([0x99F0149D, 0x9C67B85D, 0xC8008529, 0xA05B5D7B,
                       0xCD1E64FB], dtype=np.uint32).view(np.int32)
    np.testing.assert_array_equal(h.numpy(), expect)
    v32 = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    h, _ = H.murmur3_pmod_plain([v32], [torch.ones(4, dtype=torch.bool)],
                                ["i32"], 4, 4)
    np.testing.assert_array_equal(
        h.numpy(), [-559580957, 1765031574, -1823081949, -397064898])


# -- K3 slot_agg_partial -------------------------------------------------------


def _slot_inputs(rng, cap, n, k, lo, hi, nulls, key_dtype=np.int64):
    keys, kvalids = [], []
    exists = np.arange(cap) < n
    for _ in range(k):
        d = np.zeros(cap, key_dtype)
        v = np.zeros(cap, bool)
        d[:n] = rng.integers(lo, hi, n)
        v[:n] = rng.random(n) >= nulls
        d[~v] = 0
        keys.append(d)
        kvalids.append(v)
    amt = np.zeros(cap, np.int64)
    av = np.zeros(cap, bool)
    amt[:n] = rng.integers(0, 1_000_000, n)
    av[:n] = rng.random(n) >= nulls
    amt[~av] = 0
    small = np.zeros(cap, np.int32)
    small[:n] = rng.integers(-1000, 1000, n)
    return keys, kvalids, exists, (amt, av), (small, exists.copy())


_SPECS = {
    "q01": (("sum", 0, "int64"), ("count", 0, "")),
    "all": (("sum", 0, "int64"), ("count", 0, ""), ("avg", 4, "int64"),
            ("min", 0, ""), ("max", 0, ""), ("min", 0, ""), ("max", 0, "")),
}


def _args_for(spec_name, amt, small, exists, cap):
    count_arg = (np.zeros(cap, np.int64), exists)
    if spec_name == "q01":
        return [amt, count_arg]
    return [amt, count_arg, amt, amt, amt, small, small]


def _run_both_partial(keys, kvalids, exists, n, specs, args, bases, sizes,
                      out_cap, nbuck):
    cap = len(exists)
    kdt = tuple(str(k.dtype) for k in keys)
    jk = JA._dense_partial_kernel(kdt, specs, tuple(str(a[0].dtype) for a in args),
                                  cap, sizes, out_cap, nbuck)
    flat = []
    for d, v in zip(keys, kvalids):
        flat += [jnp.asarray(d), jnp.asarray(v & exists)]
    for d, v in args:
        flat += [jnp.asarray(d), jnp.asarray(v)]
    jouts = jk(jnp.asarray(exists), jnp.asarray(np.asarray(bases, np.int64)), *flat)
    touts = A.slot_agg_partial_plain(
        [_t(d) for d in keys], [_t(v & exists) for v in kvalids],
        [_t(d).dtype for d in keys], n, bases, sizes, specs,
        [(_t(d), _t(v & exists)) for d, v in args], out_cap, nbuck)
    return jouts, touts


@pytest.mark.parametrize("case", [
    # cap, n, keys, lo, hi, nulls, specs, slot table
    (1024, 1024, 1, 1, 400, 0.0, "q01", "dense"),
    (1024, 800, 1, 1, 400, 0.2, "all", "dense"),
    (1024, 1000, 2, -20, 20, 0.1, "all", "radix"),
    (4096, 4000, 1, 1, 100_000, 0.05, "all", "radix"),
    (262144, 262144, 1, 1, 400, 0.0, "q01", "dense"),
])
def test_slot_agg_partial_matches_jax(case):
    cap, n, k, lo, hi, nulls, spec_name, table = case
    rng = np.random.default_rng(cap + n + k)
    keys, kvalids, exists, amt, small = _slot_inputs(rng, cap, n, k, lo, hi, nulls)
    specs = _SPECS[spec_name]
    args = _args_for(spec_name, amt, small, exists, cap)
    from blaze_tpu_torch.config import Config

    conf = Config()
    probe = A.probe_ranges([_t(d) for d in keys],
                           [_t(v & exists) for v in kvalids])
    jprobe = np.array([[v.any(), d[v].min(), d[v].max()]
                       for d, v in zip(keys, [v & exists for v in kvalids])])
    np.testing.assert_array_equal(probe, jprobe)
    max_slots = min(conf.dense_agg_max_buckets, cap) if table == "dense" \
        else conf.radix_agg_max_slots
    bases, sizes, out_cap = A.plan_slot_table(probe, cap, None, max_slots, conf)
    assert (bases, sizes, out_cap) == JA._plan_slot_table(jprobe, cap, None,
                                                          max_slots, conf)
    nbuck = conf.radix_agg_buckets if table == "radix" else 0
    jouts, touts = _run_both_partial(keys, kvalids, exists, n, specs, args,
                                     bases, sizes, out_cap, nbuck)
    assert len(jouts) == len(touts)
    assert int(jouts[0]) == int(touts[0]) > 0
    for j, t in zip(jouts[1:], touts[1:]):
        _assert_same(j, t)


@pytest.mark.parametrize("case", [
    # cap, n, lo, hi, specs: the card's slot designs (csrc/slot_agg.cu)
    (16384, 16384, 0, 1, "all"),     # every row in one group
    (16384, 16000, 0, 10, "all"),    # q06's ten categories
    (4096, 4000, 0, 2047, "q01"),    # 2,048 slots: q01's three ops in shared memory
    (8192, 8000, 0, 4095, "q01"),    # 4,096 slots: past the shared-memory budget
    (1024, 1000, 0, 511, "all"),     # 512 slots: the 13 ops in shared memory
    (2048, 2000, 0, 1023, "all"),    # 1,024 slots: past it
])
def test_slot_agg_partial_matches_jax_where_the_card_branches(case):
    """A few groups over many rows, and slot tables on both sides of the
    card's shared-memory switch (96 KB of tables), through
    ``_dense_partial_kernel`` and K3's plain version."""
    from blaze_tpu_torch.config import Config

    cap, n, lo, hi, spec_name = case
    conf = Config()
    rng = np.random.default_rng(cap + hi)
    keys, kvalids, exists, amt, small = _slot_inputs(rng, cap, n, 1, lo, hi, 0.02)
    if hi > lo + 1:
        keys[0][:2], kvalids[0][:2] = (lo, hi - 1), True  # the plan spans the range
    specs = _SPECS[spec_name]
    args = _args_for(spec_name, amt, small, exists, cap)
    probe = A.probe_ranges([_t(d) for d in keys], [_t(v & exists) for v in kvalids])
    bases, sizes, out_cap = A.plan_slot_table(probe, cap, None, conf.radix_agg_max_slots,
                                              conf)
    jouts, touts = _run_both_partial(keys, kvalids, exists, n, specs, args, bases, sizes,
                                     out_cap, conf.radix_agg_buckets)
    assert int(jouts[0]) == int(touts[0]) > 0
    for j, t in zip(jouts[1:], touts[1:]):
        _assert_same(j, t)


def test_slot_agg_partial_overflow_at_base_minus_one():
    """radix_pack's overflow rule: a key at base - 1 (which would alias the
    null slot) and an int64-wrapping far key both flag the plan (count -1);
    a key just inside the range does not."""
    cap, n = 1024, 1000
    rng = np.random.default_rng(3)
    base = np.iinfo(np.int64).max - 100
    keys, kvalids, exists, amt, small = _slot_inputs(rng, cap, n, 1, base, base + 30, 0.0)
    specs = _SPECS["q01"]
    args = _args_for("q01", amt, small, exists, cap)
    bases, sizes = (base,), (64,)
    for bad, overflow in ((base - 1, True), (np.iinfo(np.int64).min, True),
                          (base + 62, False)):
        keys[0][5] = bad
        jouts, touts = _run_both_partial(keys, kvalids, exists, n, specs, args,
                                         bases, sizes, 64, 0)
        assert int(jouts[0]) == int(touts[0])
        assert (int(touts[0]) == -1) == overflow
        for j, t in zip(jouts[1:], touts[1:]):
            _assert_same(j, t)


def test_slot_agg_partial_int32_keys_and_values():
    cap, n = 1024, 1000
    rng = np.random.default_rng(11)
    keys, kvalids, exists, amt, small = _slot_inputs(rng, cap, n, 1, -5, 60, 0.1,
                                                     key_dtype=np.int32)
    specs = _SPECS["all"]
    args = _args_for("all", amt, small, exists, cap)
    jouts, touts = _run_both_partial(keys, kvalids, exists, n, specs, args,
                                     (-5,), (128,), 128, 0)
    for j, t in zip(jouts, touts):
        _assert_same(j, t)


# -- K4 slot_agg_merge ---------------------------------------------------------


@pytest.mark.parametrize("k,spec_name,table", [(1, "q01", "dense"),
                                               (2, "all", "dense"),
                                               (1, "all", "radix")])
def test_slot_agg_merge_matches_jax(k, spec_name, table):
    """Partial states of three 'maps' (K3 outputs, concatenated) merged by
    the JAX radix merge kernel and by K4's plain version."""
    from blaze_tpu_torch.config import Config

    conf = Config()
    rng = np.random.default_rng(k + len(spec_name))
    specs = _SPECS[spec_name]
    hi = 100_000 if table == "radix" else 50
    parts = []
    for m in range(3):
        cap, n = 2048, 2000 - 300 * m
        keys, kvalids, exists, amt, small = _slot_inputs(rng, cap, n, k, 1, hi, 0.1)
        args = _args_for(spec_name, amt, small, exists, cap)
        probe = A.probe_ranges([_t(d) for d in keys], [_t(v & exists) for v in kvalids])
        bases, sizes, out_cap = A.plan_slot_table(probe, cap, None,
                                                  conf.radix_agg_max_slots, conf)
        outs = A.slot_agg_partial_plain(
            [_t(d) for d in keys], [_t(v & exists) for v in kvalids],
            [torch.int64] * k, n, bases, sizes, specs,
            [(_t(d), _t(v & exists)) for d, v in args], out_cap)
        parts.append((int(outs[0]), [o.numpy() for o in outs[1:]]))
    total = sum(g for g, _ in parts)
    cap = conf.capacity_for(total)
    out_valid_cols = [np.concatenate([o[0][:g] for g, o in parts])]
    cols = [np.concatenate([o[i][:g] for g, o in parts])
            for i in range(1, len(parts[0][1]))]
    live = np.arange(cap) < total

    def pad(x):
        return np.concatenate([x, np.zeros(cap - len(x), x.dtype)])

    cols = [pad(c) for c in cols]
    keys = [cols[2 * i] for i in range(k)]
    kvalids = [cols[2 * i + 1] & live for i in range(k)]
    kinds = tuple(s[0] for s in specs)
    nstate = {"sum": 2, "count": 1, "avg": 2, "min": 2, "max": 2}
    states, pos = [], 2 * k
    for kind in kinds:
        sc = []
        for j in range(nstate[kind]):
            d = cols[pos + j]
            if kind in ("sum", "min", "max") and j == 0:
                v = cols[pos + 1] & live    # value valid where 'has'
            elif kind == "avg" and j == 0:
                v = (cols[pos + 1] > 0) & live
            else:
                v = live.copy()
            sc.append((d, v))
        states.append(sc)
        pos += nstate[kind]
    assert out_valid_cols[0].all()
    probe = A.probe_ranges([_t(d) for d in keys], [_t(v) for v in kvalids])
    bases, sizes, out_cap = A.plan_slot_table(probe, cap, None,
                                              conf.radix_agg_max_slots, conf)
    jk = JA._radix_merge_kernel(tuple(str(d.dtype) for d in keys), kinds,
                                tuple(tuple(str(d.dtype) for d, _ in sc) for sc in states),
                                cap, sizes, out_cap)
    flat = []
    for d, v in zip(keys, kvalids):
        flat += [jnp.asarray(d), jnp.asarray(v)]
    for sc in states:
        for d, v in sc:
            flat += [jnp.asarray(d), jnp.asarray(v)]
    jouts = jk(jnp.asarray(live), jnp.asarray(np.asarray(bases, np.int64)), *flat)
    touts = A.slot_agg_merge_plain(
        [_t(d) for d in keys], [_t(v) for v in kvalids], [torch.int64] * k,
        total, bases, sizes, kinds, [[(_t(d), _t(v)) for d, v in sc] for sc in states],
        out_cap)
    assert len(jouts) == len(touts)
    assert int(jouts[0]) == int(touts[0]) > 0
    for j, t in zip(jouts[1:], touts[1:]):
        _assert_same(j, t)


# -- K5's pass selection: known widths and the rank-6 tail ------------------------


def _reference_order(ops, cap):
    from blaze_tpu.ops.sort import _device_sort_indices

    return np.asarray(_device_sort_indices([jnp.asarray(o.numpy()) for o in ops],
                                           cap)).astype(np.int64)


@pytest.mark.parametrize("nparts,n", [(4, 1000), (32, 262144), (256, 5000), (300, 5000),
                                      (70_000, 70_000), (1, 10)])
def test_pid_sort_from_known_widths_matches_reference(nparts, n):
    """The exchange's pid sort passes only the id's known width (one byte
    up to 256 partitions): lexsort_indices_plain's passes over those
    digits give the reference's stable order, and partition_order's counts
    are the ids' histogram."""
    pids = np.random.default_rng(nparts).integers(0, nparts, n).astype(np.int32)
    width = K.pid_width(nparts)
    assert width == (1 if nparts <= 256 else 2 if nparts <= 65536 else 3)
    assert K.radix_digits([4], [width]) == [(0, 8 * b) for b in range(width)]
    want = _reference_order([_t(pids)], n)
    np.testing.assert_array_equal(K.lexsort_indices_plain([_t(pids)], None, [width]).numpy(),
                                  want)
    order, counts = K.partition_order(_t(pids), nparts)
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(pids, minlength=nparts))
    with pytest.raises(ValueError, match="widths"):
        K.radix_digits([4], [5])


@pytest.mark.parametrize("cap,n,live_share,keys", [
    (4096, 3000, 0.6, ("i64", "i32")), (4096, 4096, 0.0, ("i64",)),
    (256, 200, 0.995, ("bool", "i64")), (4096, 3000, 1.0, ("i64",)),
    (4096, 3000, 0.001, ("i32", "i64")), (256, 256, 0.5, ("f64",)),
])
def test_dead_rows_sort_last_in_row_order_as_the_reference(cap, n, live_share, keys):
    """Rows whose rank is 6 (padding, or a fused aggregate's dead rows
    below num_rows) go after the live rows in row order and take no part
    in the digit passes: the same permutation as the reference's sort of
    every row (``_device_sort_indices`` over ``_key_ops``)."""
    rng = np.random.default_rng(cap + n + len(keys))
    datas, valids = [], []
    for kind in keys:
        d = {"i64": lambda: rng.integers(-60, 60, cap),
             "i32": lambda: rng.integers(-9, 9, cap).astype(np.int32),
             "bool": lambda: rng.random(cap) < 0.5,
             "f64": lambda: rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.inf, np.nan]),
                                       cap)}[kind]()
        v = rng.random(cap) > 0.1
        datas.append(np.where(v, d, np.zeros((), d.dtype)))
        valids.append(v)
    exists = np.zeros(cap, bool)
    exists[:n] = rng.random(n) < live_share
    spec = tuple((True, True) for _ in keys)
    jops = JK._key_ops(tuple(jnp.asarray(d) for d in datas), tuple(jnp.asarray(v) for v in valids),
                       jnp.asarray(exists), spec)
    ops = K.sort_key_operands([_t(d) for d in datas], [_t(v) for v in valids], _t(exists), spec)
    for a, b in zip(jops, ops):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = _reference_order(ops, cap)
    for rows in (n, None):
        np.testing.assert_array_equal(
            K.lexsort_indices_plain(ops, rows, dead_last=True).numpy(), want)
    live = int(exists.sum())
    assert sorted(want[live:n].tolist()) == want[live:n].tolist()  # dead rows in row order
    # the passes the kernel keeps are the digits that vary over the live
    # rows: never more than over every row below n, dead ones included
    def passes(rows):
        words = [K._sort_words(o[:n][_t(rows)]).numpy().view(np.uint64) for o in ops]
        and_or = np.array([f(w) for w in words
                           for f in (np.bitwise_and.reduce, np.bitwise_or.reduce)]
                          if rows.any() else [0, 0] * len(ops), np.uint64)
        return K.radix_passes(and_or, [o.element_size() for o in ops])

    live_passes, all_passes = passes(exists[:n]), passes(np.ones(n, bool))
    assert set(live_passes) <= set(all_passes)
    if 0 < live < n:
        assert (0, 0) in all_passes  # the ranks 6 would have cost a pass
