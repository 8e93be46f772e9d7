"""The port's wide-decimal (limb) aggregates against the JAX package: the
limb halves of K3/K4 (``_dense_partial_kernel``, ``_radix_merge_kernel``),
K10 (``_partial_kernel``, ``_merge_kernel``) and K12 (the limb branches of
``aggfns``' updates and merges), the decimal(19..38) column and its
final values.

- Kernel level: chip_smoke.py's limb battery (``WIDE_CASES``,
  ``WIDE_UPD_CASES``: negative values, 38-digit extremes and values past
  2^64, all-negative extremes, single rows, cancellation near the
  extremes, nulls, padding, empty segments) drawn from a seed with numpy
  goes through the jitted JAX kernels and the reference's eager helpers
  (``_segment_lex3``, ``_limb_renorm``, ``_limb3_renorm``,
  ``_lex_scatter_minmax``, the limb ``update``/``merge``) on the CPU, and
  through the port's plain twins; every output plane must be equal.
- Plan level: the cases of the JAX package's tests/test_wide_decimal.py
  and tests/test_agg.py ``test_wide_decimal_host_exact`` over in-memory
  sources (arrow decimal128 batches for the reference, ``(lo_raw, hi)``
  words for the port), through ``blaze_tpu.Session`` and
  ``blaze_tpu_torch.Session(device="cpu")`` on the slot routes, the sort
  route and the host table, two-stage and COMPLETE; results must be
  equal, order included, and equal a Python ``Decimal`` oracle.

Tolerance: none; every plane is an integer or a bool, every result a
``Decimal``. Each reference session keeps its shm root under the test's
``tmp_path``.
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
from blaze_tpu.ops import agg_device as JA
from blaze_tpu.ops import aggfns as JF
from blaze_tpu.ops.joins.bhj import clear_build_cache
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, WideColumn, wide_words
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ops import agg_device as A
from blaze_tpu_torch.ops import aggfns
from chip_smoke import (WIDE_CASES, WIDE_UPD_CASES, WIDE_UPD_FNS, ints_of, limbs_of,
                        wide_case, wide_torch, wide_upd_case, wide_upd_fns, wide_upd_run,
                        wide_upd_types)

torch.set_num_threads(1)

F = JE.AggFunction
M = JE.AggMode
HASH = JE.AggExecMode.HASH_AGG
C = JE.Column
D = decimal.Decimal


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    np.testing.assert_array_equal(j, t)


def _same_outputs(jouts, touts):
    assert len(jouts) == len(touts)
    assert int(jouts[0]) == int(touts[0])
    for j, t in zip(jouts[1:], touts[1:]):
        _same(j, t)


# -- kernel level: K10 and K3/K4 --------------------------------------------------


def _case(case):
    return wide_case(case, np.random.default_rng(sum(map(ord, case[0]))))


def _jax_flat(kcols, args, exists):
    flat = []
    for d, v in kcols:
        flat += [jnp.asarray(d), jnp.asarray(v & exists)]
    for d, v in args:
        planes = d if isinstance(d, tuple) else (d,)
        flat += [jnp.asarray(p) for p in planes] + [jnp.asarray(v & exists)]
    return flat


def _arg_dtypes(args):
    return tuple("wide3" if isinstance(d, tuple) else str(d.dtype) for d, _ in args)


def _port_args(args, exists):
    return [(tuple(_t(p) for p in d) if isinstance(d, tuple) else _t(d), _t(v & exists))
            for d, v in args]


def _slot_plan(keys, kvalids, cap):
    conf = Config()
    st = A.plan_slot_table(A.probe_ranges([_t(k) for k in keys], [_t(v) for v in kvalids]),
                           cap, None, conf.radix_agg_max_slots, conf)
    assert st is not None and st is not A._DEFER_PLAN
    return st


_IDS = [c[0] for c in WIDE_CASES]


@pytest.mark.parametrize("case", WIDE_CASES, ids=_IDS)
def test_partial_kernel_wide_matches_jax(case):
    """``_partial_kernel``'s wide branches of ``_reduce_aggs`` (sum2, avg2,
    sum3, avg3, minw, maxw) against K10's twin on the sort route."""
    keys, kvalids, specs, args = _case(case)
    cap, n = case[2], case[3]
    exists = np.arange(cap) < n
    jk = JA._partial_kernel(tuple(str(k.dtype) for k in keys), specs, _arg_dtypes(args), cap)
    jouts = jk(jnp.asarray(exists), *_jax_flat(list(zip(keys, kvalids)), args, exists))
    touts = A.seg_agg_partial([_t(k) for k in keys], [_t(v) for v in kvalids], n, specs,
                              _port_args(args, exists))
    _same_outputs(jouts, touts)


@pytest.mark.parametrize("case", WIDE_CASES, ids=_IDS)
def test_dense_partial_kernel_wide_matches_jax(case):
    """``_dense_partial_kernel``'s wide arguments against K3's twin over the
    same slot plan."""
    keys, kvalids, specs, args = _case(case)
    cap, n = case[2], case[3]
    exists = np.arange(cap) < n
    bases, sizes, out_cap = _slot_plan(keys, kvalids, cap)
    jk = JA._dense_partial_kernel(tuple(str(k.dtype) for k in keys), specs, _arg_dtypes(args),
                                  cap, sizes, out_cap)
    jouts = jk(jnp.asarray(exists), jnp.asarray(np.asarray(bases, np.int64)),
               *_jax_flat(list(zip(keys, kvalids)), args, exists))
    touts = A.slot_agg_partial([_t(k) for k in keys], [_t(v) for v in kvalids],
                               [torch.int64] * len(keys), n, bases, sizes, specs,
                               _port_args(args, exists), out_cap)
    _same_outputs(jouts, touts)


_NSTATE = {"sum2": 3, "avg2": 3, "sum3": 4, "avg3": 4, "minw": 4, "maxw": 4, "count": 1}


def _merge_input(case):
    """Three 'maps' of the port's partial outputs for the case, concatenated
    into one state batch, each state plane's validity redrawn so every gate
    of ``_merge_reduce`` is taken."""
    rng = np.random.default_rng(len(case[0]))
    parts = []
    for m in range(3):
        keys, kvalids, specs, args = wide_case(case, np.random.default_rng(m + 40))
        cap, n = case[2], case[3]
        exists = np.arange(cap) < n
        outs = A.seg_agg_partial([_t(k) for k in keys], [_t(v) for v in kvalids], n, specs,
                                 _port_args(args, exists))
        g = int(outs[0])
        parts.append([o[:g].numpy() for o in outs[2:]])
    total = sum(len(p[0]) for p in parts)
    cap = Config().capacity_for(total)
    live = np.arange(cap) < total
    cols = [np.concatenate([np.concatenate([p[i] for p in parts]),
                            np.zeros(cap - total, parts[0][i].dtype)])
            for i in range(len(parts[0]))]
    k = len(case[1])
    kinds = tuple(s[0] for s in specs)
    kd = [cols[2 * i] for i in range(k)]
    kv = [cols[2 * i + 1] & live for i in range(k)]
    states, pos = [], 2 * k
    for kind in kinds:
        sc = []
        for j in range(_NSTATE[kind]):
            sc.append((cols[pos + j], live & (rng.random(cap) >= 0.1)))
        states.append(sc)
        pos += _NSTATE[kind]
    return kd, kv, kinds, states, total, cap, live


def _merge_flat(kd, kv, states):
    flat = []
    for d, v in zip(kd, kv):
        flat += [jnp.asarray(d), jnp.asarray(v)]
    for sc in states:
        for d, v in sc:
            flat += [jnp.asarray(d), jnp.asarray(v)]
    return flat


def _state_dtypes(states):
    return tuple(tuple(str(d.dtype) for d, _ in sc) for sc in states)


_MERGE_CASES = [c for c in WIDE_CASES if c[3] > 1]


@pytest.mark.parametrize("case", _MERGE_CASES, ids=[c[0] for c in _MERGE_CASES])
def test_merge_kernel_wide_matches_jax(case):
    """``_merge_kernel``'s wide branches of ``_merge_reduce`` against K10's
    merge twin."""
    kd, kv, kinds, states, total, cap, live = _merge_input(case)
    jk = JA._merge_kernel(tuple(str(d.dtype) for d in kd), kinds, _state_dtypes(states), cap)
    jouts = jk(jnp.asarray(live), *_merge_flat(kd, kv, states))
    touts = A.seg_agg_merge([_t(d) for d in kd], [_t(v) for v in kv], total, kinds,
                            [[(_t(d), _t(v & live)) for d, v in sc] for sc in states])
    _same_outputs(jouts, touts)


@pytest.mark.parametrize("case", _MERGE_CASES, ids=[c[0] for c in _MERGE_CASES])
def test_radix_merge_kernel_wide_matches_jax(case):
    """``_radix_merge_kernel`` against K4's twin over the same slot plan."""
    kd, kv, kinds, states, total, cap, live = _merge_input(case)
    bases, sizes, out_cap = _slot_plan(kd, kv, cap)
    jk = JA._radix_merge_kernel(tuple(str(d.dtype) for d in kd), kinds, _state_dtypes(states),
                                cap, sizes, out_cap)
    jouts = jk(jnp.asarray(live), jnp.asarray(np.asarray(bases, np.int64)),
               *_merge_flat(kd, kv, states))
    touts = A.slot_agg_merge([_t(d) for d in kd], [_t(v) for v in kv],
                             [torch.int64] * len(kd), total, bases, sizes, kinds,
                             [[(_t(d), _t(v & live)) for d, v in sc] for sc in states], out_cap)
    _same_outputs(jouts, touts)


def _lex_planes(values, n, seed):
    from chip_smoke import wide_plane

    rng = np.random.default_rng(seed)
    l0, l1, l2, valid = wide_plane(values, n, n, rng, 0.15)
    return l0, l1, l2, valid, rng


@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
@pytest.mark.parametrize("values", ["mixed", "negative", "extremes", "cancel"])
def test_segment_lex3_matches_jax(values, is_max):
    """``_segment_lex3`` (b0, b1, b2, has; zeros where a segment has no
    valid row) against the port's pair of lexicographic ops and their
    emits, ties included (the pools repeat values)."""
    n, nseg = 2000, 300
    l0, l1, l2, valid, rng = _lex_planes(values, n, 7 + is_max)
    seg = rng.integers(0, nseg - 20, n)  # the last 20 segments stay empty
    want = JA._segment_lex3(jnp.asarray(l0), jnp.asarray(l1), jnp.asarray(l2),
                            jnp.asarray(valid), jnp.asarray(seg), nseg, is_max)
    s, ok = _t(seg), _t(valid)
    hi, word = K.lex_tables_plain(s, ok, _t(l2), _t(l1), _t(l0), nseg, is_max)
    count = torch.zeros(nseg, dtype=torch.int64).index_add_(0, s, ok.to(torch.int64))
    tables = [hi, word, count]
    got = [K.emit_plain(e, tables) for e in K.lex_emits(0, 2)] + [count != 0]
    for j, t in zip(want, got):
        _same(j, t)


def test_limb_renorm_matches_jax():
    """``_limb_renorm`` and ``_limb3_renorm`` over accumulated limb sums
    (l0, l1 up to 2^55, l2 anywhere, wrapping) against the port's limb
    emits (K3/K4/K10) and K12's renormalisation of touched slots."""
    rng = np.random.default_rng(3)
    n = 1000
    l0, l1 = rng.integers(0, 1 << 55, n), rng.integers(0, 1 << 55, n)
    l2 = rng.integers(-(1 << 63), (1 << 63) - 1, n)
    w3 = JF._limb3_renorm(jnp.asarray(l0), jnp.asarray(l1), jnp.asarray(l2))
    w2 = JF._limb_renorm(jnp.asarray(l0), jnp.asarray(l1))
    tables = [_t(l0), _t(l1), _t(l2)]
    for j, e in zip(w3, K.limb_emits(0, 3)):
        _same(j, K.emit_plain(e, tables))
    for j, e in zip(w2, K.limb_emits(0, 2)):
        _same(j, K.emit_plain(e, tables))
    touched = torch.ones(n, dtype=torch.bool)
    for want, limbs in ((w3, [t.clone() for t in tables]), (w2, [t.clone() for t in tables[:2]])):
        K._renorm_plain(limbs, touched)
        for j, t in zip(want, limbs):
            _same(j, t)


@pytest.mark.parametrize("is_max", [False, True], ids=["min", "max"])
@pytest.mark.parametrize("values", ["mixed", "negative", "extremes"])
def test_lex_scatter_minmax_matches_jax(values, is_max):
    """``_lex_scatter_minmax`` over three batches into one state (slots
    tied, padding rows at the capacity, nulls) against K12's twin of the
    lexicographic op."""
    cap = 64
    state_j = [jnp.zeros(cap, jnp.int64)] * 3 + [jnp.zeros(cap, bool)]
    state_t = [torch.zeros(cap, dtype=torch.int64) for _ in range(3)] + \
        [torch.zeros(cap, dtype=torch.bool)]
    for b in range(3):
        l0, l1, l2, valid, rng = _lex_planes(values, 500, 11 * b + is_max)
        slots = np.where(np.arange(500) < 450, rng.integers(0, 50, 500), cap)
        state_j = JF._lex_scatter_minmax(state_j, jnp.asarray(slots), jnp.asarray(l0),
                                         jnp.asarray(l1), jnp.asarray(l2), jnp.asarray(valid),
                                         is_max)
        kind = K.UPD_LEXMAX if is_max else K.UPD_LEXMIN
        op = K.SlotUpdate(kind, state_t[2], _t(l2), [_t(valid)], valid_table=state_t[3],
                          srcs=[_t(l1), _t(l0)], tables=[state_t[1], state_t[0]])
        K.slot_update_plain(_t(slots), _t(np.ones(500, bool)), [op])
    for j, t in zip(state_j, state_t):
        _same(j, t)


# -- kernel level: K12 against the reference's limb updates and merges ------------


def _decimal128(dt, limbs, valid):
    """The limb planes as the arrow decimal128 array the reference's host
    column holds."""
    l0, l1, l2 = limbs
    words = np.empty((len(l0), 2), np.int64)
    words[:, 0] = (l1 << 32) | l0
    words[:, 1] = l2
    return pa.Array.from_buffers(pa.decimal128(dt.precision, dt.scale), len(l0),
                                 [pa.py_buffer(np.packbits(valid, bitorder="little")),
                                  pa.py_buffer(words.tobytes())])


def _jax_upd_run(case, fns):
    caps = case["caps"]
    states = [fn.init_state(caps[0]) for fn in fns]
    for b, batch in enumerate(case["batches"]):
        if b == 1:
            states = [fn.grow(st, caps[1]) for fn, st in zip(fns, states)]
        slots, mask = batch["slots"], jnp.asarray(batch["mask"])
        n = int(batch["mask"].sum())
        for i, ((name, arg), fn, planes) in enumerate(zip(WIDE_UPD_FNS, fns, batch["planes"])):
            if case["mode"] == "merge":
                cols = [JDeviceColumn(JT.I64, jnp.asarray(d), jnp.asarray(v)) for d, v in planes]
                states[i] = fn.merge(states[i], jnp.asarray(slots), cols, mask, n)
            elif arg == "d":
                states[i] = fn.update(states[i], jnp.asarray(slots), jnp.asarray(planes[0]),
                                      jnp.asarray(planes[1]), mask)
            else:
                arr = _decimal128(wide_upd_types(JT, arg), planes[0], planes[1])
                states[i] = fn.update(states[i], slots, arr, None, batch["mask"])
    return states


_CTX28 = decimal.Context(prec=28)


def _r28(values):
    """Decimals rounded to 28 significant digits, as the reference's
    ``_host_col_out`` builds them under the default context (ROADMAP.md
    Queue 3: the port keeps every digit, as Spark does)."""
    return [_CTX28.plus(v) if isinstance(v, D) else v for v in values]


def _py(col, n):
    """A final column's first ``n`` values as Python objects (reference:
    a host arrow column or a device column; port: a device or wide column)."""
    if hasattr(col, "array"):
        return col.array.to_pylist()[:n]
    if isinstance(col, (WideColumn,)) or isinstance(col.data, torch.Tensor):
        b = ColumnarBatch(T.Schema.of(("x", col.dtype)), [col], n)
        return b.to_pydict()["x"]
    d, v = np.asarray(col.data)[:n], np.asarray(col.validity)[:n]
    return [D(int(x)).scaleb(-col.dtype.scale) if ok else None for x, ok in zip(d, v)]


@pytest.mark.parametrize("case", WIDE_UPD_CASES, ids=[c[0] for c in WIDE_UPD_CASES])
def test_slot_update_limbs_match_reference(case):
    """The limb states (sum2, avg2, sum3, avg3, minw, maxw) after the case's
    batches, the reference's ``update``/``merge`` against K12's plain twin
    of the port's ops: every state plane, and the final values."""
    data = wide_upd_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    cap = data["caps"][1]
    jfns = [JF.create_agg_function(JE.AggExpr(F[fn.upper()], [C("v")]),
                                   JT.Schema.of(("v", wide_upd_types(JT, arg))))
            for fn, arg in WIDE_UPD_FNS]
    assert [f.limbs for f in jfns] == ["2", "2", "3", "3", "w", "w"]
    jstates = _jax_upd_run(data, jfns)
    states = wide_upd_run(data, wide_upd_fns(), K.slot_update_plain, torch.device("cpu"))
    for (name, arg), jfn, fn, jst, st in zip(WIDE_UPD_FNS, jfns, wide_upd_fns(), jstates,
                                               states):
        want = jfn.state_columns(jst, cap, cap)
        got = fn.state_columns(st, cap, cap)
        assert len(want) == len(got), (name, arg)
        for j, t in zip(want, got):
            _same(np.asarray(j.data), t.data)
            _same(np.asarray(j.validity), t.validity)
        got = _py(fn.final_column(st, cap, cap), cap)
        try:
            ref = _py(jfn.final_column(jst, cap, cap), cap)
        except pa.ArrowInvalid:
            # the reference's 28-digit Decimal of a 38-digit total does not
            # fit its own arrow type (ROADMAP.md Queue 3); the exact totals
            # below still hold the port
            assert name != "avg"
        else:
            assert _r28(ref) == _r28(got), (name, arg)
        if name != "avg":  # the exact totals (extremes) of the state planes
            p = [np.asarray(x.data) for x in want]
            ints = ints_of(p[0], p[1], p[2]) if len(p) == 4 else \
                [(int(h) << 32) + int(lo) for lo, h in zip(p[0], p[1])]
            bound = 10 ** fn.result_type.precision
            assert got == [_dec(v, 2) if ok and -bound < v < bound else None
                           for v, ok in zip(ints, p[-1])], (name, arg)


# one slot, many rows: every row of two batches into slot 0, the wide
# extremes' l2 tied across most rows (int64-sized values: l2 is 0 or -1)
_ONE_SLOT_UPD = [("update, one slot of 16,000 rows, tied l2", "update", (16384, 16000), 2, 1,
                  (1024, 1024), 0.1, "mixed"),
                 ("merge, one slot of 16,000 rows, tied l2", "merge", (16384, 16000), 2, 1,
                  (1024, 1024), 0.1, "extremes")]


@pytest.mark.parametrize("case", _ONE_SLOT_UPD, ids=[c[1] for c in _ONE_SLOT_UPD])
def test_slot_update_limbs_one_slot_of_many_rows(case):
    """K12's limb ops where every row of a batch hits one slot (a global
    wide SUM and the wide extremes over tied l2): the twin against the
    reference's scatters, as ``test_slot_update_limbs_match_reference``."""
    test_slot_update_limbs_match_reference(case)


@pytest.mark.parametrize("at", range(len(WIDE_UPD_FNS)),
                         ids=[f"{f}-{a}" for f, a in WIDE_UPD_FNS])
def test_slot_update_pack_never_sorts_a_limb_op(at):
    """No limb op asks K12's pack for K5's sort: the limb sums and their
    renormalisation are atomics and a pass a slot, the wide extremes a
    best-l2 pass, a tiebreak pass and a pass a slot."""
    data = wide_upd_case(WIDE_UPD_CASES[0], np.random.default_rng(at))["batches"][0]
    fn = wide_upd_fns()[at]
    cpu = torch.device("cpu")
    d, v = wide_torch(data["planes"][at], cpu)
    ops = fn.update_ops(fn.init_state(1024, cpu), d, v)
    pack = K.SlotUpdatePack()
    pack.bind(*wide_torch((data["slots"], data["mask"]), cpu), ops)
    assert pack.sort is False and not any(op.folds for op in ops)


def test_limb_final_overflow_nulls():
    """The reference's ``test_limb_final_overflow_nulls`` on the port: a
    decimal(19,0) two-limb total past its precision is null."""
    d19 = T.DecimalType(19, 0)
    fn = aggfns.SumAgg(None, T.DecimalType(9, 0), d19)
    assert fn.limbs == "2"
    big, ok = 10 ** 19 + 5, 10 ** 19 - 1
    state = [torch.tensor([big & 0xFFFFFFFF, ok & 0xFFFFFFFF, 7]),
             torch.tensor([big >> 32, ok >> 32, 0]), torch.tensor([True, True, False])]
    col = fn.final_column(state, 3, 256)
    assert isinstance(col, WideColumn) and col.capacity == 256
    assert _py(col, 3) == [None, D(ok), None]
    assert not col.validity[3:].any() and not any(p[3:].any() for p in col.planes())


def test_wide_column_round_trip():
    """``from_numpy`` takes (lo_raw, hi) words; ``take``, ``slice``,
    ``concat``, ``to_numpy`` and ``to_pydict`` keep the exact values, and
    every plane is 0 with validity False past num_rows."""
    vals = [10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, -(2 ** 64) - 1, 0, -1, 12345]
    valid = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    dt = T.DecimalType(38, 2)
    schema = T.Schema.of(("k", T.I64), ("w", dt))
    b = ColumnarBatch.from_numpy(schema, {"k": np.arange(7), "w": (wide_words(vals, valid),
                                                                    valid)},
                                 torch.device("cpu"))
    want = [_dec(v, 2) if ok else None for v, ok in zip(vals, valid)]
    assert b.to_pydict()["w"] == want
    w = b.columns[1]
    assert ints_of(*(p[:7].numpy() for p in w.planes()))[:4] == vals[:4]
    assert all(((p[:7] >= 0) & (p[:7] < 2 ** 32)).all() for p in (w.l0, w.l1))
    assert not w.validity[7:].any() and not any(p[7:].any() for p in w.planes())
    np.testing.assert_array_equal(b.to_numpy()["w"][0], wide_words(vals, valid))
    assert b.take(torch.tensor([6, 0, 3])).to_pydict()["w"] == [want[6], want[0], want[3]]
    assert b.slice(2, 3).to_pydict()["w"] == want[2:5]
    cat = ColumnarBatch.concat([b.slice(5, 2), b])
    assert cat.to_pydict()["w"] == want[5:] + want
    assert limbs_of([vals[1]])[2][0] == vals[1] >> 64


# -- plan level -------------------------------------------------------------------

_EXACT = decimal.Context(prec=80)


def _dec(unscaled, scale):
    """An exact Decimal (the default context would round past 28 digits)."""
    return D(unscaled).scaleb(-scale, _EXACT)


ROUTES = {"slot": dict(dense_agg=True, radix_agg=True),
          "sort": dict(dense_agg=False, radix_agg=False),
          "table": dict(dense_agg=True, radix_agg=True, device_merge_max_bytes=1)}
BATCH = 512


def _arrow(dt, vals):
    if isinstance(dt, JT.DecimalType):
        return pa.array([None if v is None else _dec(int(v), dt.scale) for v in vals],
                        type=pa.decimal128(dt.precision, dt.scale))
    return pa.array(vals, type=pa.int64())


def _numpy(dt, vals):
    valid = np.array([v is not None for v in vals], bool)
    if T.is_wide_decimal(dt):
        return wide_words([0 if v is None else v for v in vals], valid), valid
    return np.array([0 if v is None else int(v) for v in vals], np.int64), valid


def _run_both(plan, schema, table, nparts, route, tmp_path):
    """``table``: {column: Python values (unscaled ints for decimals, None
    for null)} split into ``nparts`` partitions of BATCH-row batches."""
    n = len(next(iter(table.values())))
    cuts = np.linspace(0, n, nparts + 1).astype(int)

    def batches(p, convert):
        out = []
        for s in range(cuts[p], cuts[p + 1], BATCH):
            e = min(s + BATCH, cuts[p + 1])
            out.append({f.name: convert(f.dtype, table[f.name][s:e]) for f in schema.fields})
        return out

    clear_build_cache()
    with JaxSession(conf=JaxConfig(batch_size=BATCH, shm_dir=str(tmp_path),
                                   **ROUTES[route])) as s:
        s.resources["src"] = lambda p: [
            pa.record_batch([b[f] for f in schema.names], names=schema.names)
            for b in batches(p, _arrow)]
        want = s.execute_to_pydict(plan)
    port = blaze_tpu_torch.Session(conf=Config(batch_size=BATCH, **ROUTES[route]),
                                   device="cpu")
    port.resources["src"] = lambda p: batches(p, lambda dt, v: _numpy(from_foreign(dt), v))
    got = port.execute_to_pydict(from_foreign(plan))
    return want, got


def _plan(schema, aggs, nparts, two_stage, key="k"):
    scan = JN.FFIReader(schema, "src", nparts)
    keys = [(key, C(key))]
    if two_stage:
        partial = JN.Agg(scan, HASH, keys, [JN.AggColumn(a, M.PARTIAL, n) for n, a in aggs])
        ex = JN.ShuffleExchange(partial, JN.HashPartitioning([C(key)], 3))
        agg = JN.Agg(ex, HASH, keys, [JN.AggColumn(a, M.FINAL, n) for n, a in aggs])
    else:
        agg = JN.Agg(scan, HASH, keys, [JN.AggColumn(a, M.COMPLETE, n) for n, a in aggs])
    return JN.Sort(JN.ShuffleExchange(agg, JN.SinglePartitioning(1)), [JE.SortOrder(C(key))])


def _narrow_table(n, seed):
    """test_wide_decimal.py's ``_table``: decimal(17,2) values near
    int64/100, so a few thousand rows' totals pass int64."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(1, 1 + max(2, n // 400), n).tolist(),
            "v": rng.integers(7 * 10 ** 16, 9 * 10 ** 16, n).tolist()}


def _wide_table(n, seed, nulls=0.0):
    """test_wide_decimal.py's ``_wide_table``: values far past int64, both
    signs."""
    rng = np.random.default_rng(seed)
    hi, lo = rng.integers(10 ** 4, 10 ** 8, n), rng.integers(0, 10 ** 16, n)
    signs = rng.choice([-1, 1], n)
    vals = [int(s) * (int(h) * 10 ** 16 + int(x)) for s, h, x in zip(signs, hi, lo)]
    if nulls:
        vals = [None if rng.random() < nulls else v for v in vals]
    return {"k": rng.integers(1, 9, n).tolist(), "v": vals}


def _oracle(table, fn, scale, result_t):
    groups = {}
    for k, v in zip(table["k"], table["v"]):
        g = groups.setdefault(k, [])
        if v is not None:
            g.append(v)
    return [fn(groups[k], scale, result_t) for k in sorted(groups)]


def _sum(vals, scale, result_t):
    if not vals or abs(sum(vals)) >= 10 ** result_t.precision:
        return None  # past the result precision: null (Spark's check_overflow)
    return _dec(sum(vals), scale)


def _min(vals, scale, result_t):
    return _dec(min(vals), scale) if vals else None


def _max(vals, scale, result_t):
    return _dec(max(vals), scale) if vals else None


def _avg(vals, scale, result_t):
    """HALF_UP into the result scale, as the reference's ``_decimal_divide``."""
    if not vals:
        return None
    with decimal.localcontext() as ctx:
        ctx.prec = 80
        return (_dec(sum(vals), scale) / D(len(vals))).quantize(
            D(1).scaleb(-result_t.scale), rounding=decimal.ROUND_HALF_UP)


# (label, value type, table maker, aggregates [(name, fn, result type, oracle)])
PLAN_CASES = {
    "sum2 into decimal(27,2)": (
        JT.DecimalType(17, 2), lambda: _narrow_table(4000, 5),
        [("total", F.SUM, JT.DecimalType(27, 2), _sum), ("cnt", F.COUNT, None, None)]),
    "sum2 of negative values": (
        JT.DecimalType(17, 2),
        lambda: {"k": [1, 1, 2, 2, 3], "v": [-99999999999999999, 88888888888888888, -1,
                                              12345, None]},
        [("total", F.SUM, JT.DecimalType(27, 2), _sum)]),
    "avg2 into decimal(21,6), nulls": (
        JT.DecimalType(17, 2),
        lambda: {"k": np.random.default_rng(17).integers(1, 9, 3000).tolist(),
                 "v": [None if i % 11 == 0 else int(u) for i, u in enumerate(
                     np.random.default_rng(18).integers(-9 * 10 ** 16, 9 * 10 ** 16, 3000))]},
        [("a", F.AVG, JT.DecimalType(21, 6), _avg)]),
    "sum3, minw, maxw of decimal(38,2)": (
        JT.DecimalType(38, 2), lambda: _wide_table(3000, 11, nulls=0.05),
        [("s", F.SUM, None, _sum), ("mn", F.MIN, None, _min), ("mx", F.MAX, None, _max)]),
    "avg3 of decimal(30,3)": (
        JT.DecimalType(30, 3), lambda: _wide_table(3000, 13),
        [("a", F.AVG, None, _avg)]),
    "sum3 of decimal(19,2) into decimal(28,2)": (
        JT.DecimalType(19, 2),
        lambda: {"k": [1, 1, 1, 2], "v": [9 * 10 ** 18, 8 * 10 ** 18, -10 ** 18, 10 ** 18 + 7]},
        [("total", F.SUM, JT.DecimalType(28, 2), _sum)]),
    "minw, maxw all negative, single rows": (
        JT.DecimalType(31, 2),
        lambda: {"k": [1, 1, 1, 1, 2, 3], "v": [-10 ** 25, -3, -10 ** 30, -10 ** 25 - 1,
                                                   -7, 10 ** 30]},
        [("mn", F.MIN, None, _min), ("mx", F.MAX, None, _max)]),
    "sum3 cancellation near the extremes": (
        JT.DecimalType(38, 2),
        lambda: {"k": [1] * 5 + [2, 2], "v": [10 ** 37, -10 ** 37, 10 ** 37, -10 ** 37, 12345,
                                             -(10 ** 38 - 1), 10 ** 38 - 1]},
        [("s", F.SUM, None, _sum)]),
    "avg3 of 10^30-scale values keeps its type": (
        JT.DecimalType(38, 2), lambda: {"k": [1, 1], "v": [10 ** 30, 10 ** 30 + 4]},
        [("a", F.AVG, None, _avg)]),
    "sum3 past the precision is null": (
        JT.DecimalType(38, 0),
        lambda: {"k": [1, 1, 2, 2], "v": [6 * 10 ** 37, 6 * 10 ** 37, 10 ** 20, 1]},
        [("s", F.SUM, None, _sum)]),
}


def _check_plan(label, route, two_stage, tmp_path):
    vt, make, aggs = PLAN_CASES[label]
    schema = JT.Schema.of(("k", JT.I64), ("v", vt))
    table = make()
    nparts = 2 if two_stage else 1  # COMPLETE aggregates each partition on its own
    plan = _plan(schema, [(n, JE.AggExpr(fn, [] if fn == F.COUNT else [C("v")], rt))
                          for n, fn, rt, _ in aggs], nparts, two_stage)
    want, got = _run_both(plan, schema, table, nparts, route, tmp_path)
    assert {k: _r28(v) for k, v in got.items()} == {k: _r28(v) for k, v in want.items()}
    assert got["k"] == sorted(set(table["k"]))
    for name, fn, _rt, oracle in aggs:
        if oracle is not None:
            result_t = plan.output_schema[plan.output_schema.index_of(name)].dtype
            assert got[name] == _oracle(table, oracle, vt.scale, result_t), name
    if label == "sum3 past the precision is null":
        assert got["s"][0] is None and got["s"][1] is not None


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("label", sorted(PLAN_CASES))
def test_two_stage_wide_plans_match_jax(label, route, tmp_path):
    """PARTIAL (K3 or K10) -> hash exchange of the limb states -> FINAL (K4,
    K10 or, past the merge budget, the host table's K12) -> sort."""
    _check_plan(label, route, True, tmp_path)


@pytest.mark.parametrize("label", sorted(PLAN_CASES))
def test_complete_wide_plans_match_jax(label, tmp_path):
    """COMPLETE mode: the host table updates limb states from raw rows (K12)."""
    _check_plan(label, "slot", False, tmp_path)


def test_wide_decimal_host_exact(tmp_path):
    """tests/test_agg.py ``test_wide_decimal_host_exact`` on the port: SUM,
    AVG, MIN and MAX of a decimal(20,2) in COMPLETE mode."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.DecimalType(20, 2)))
    table = {"k": [1, 1, 2], "v": [125, 325, 12345678901234567899]}
    aggs = [("s", JE.AggExpr(F.SUM, [C("v")], JT.DecimalType(30, 2))),
            ("a", JE.AggExpr(F.AVG, [C("v")], JT.DecimalType(24, 6))),
            ("mn", JE.AggExpr(F.MIN, [C("v")])), ("mx", JE.AggExpr(F.MAX, [C("v")]))]
    want, got = _run_both(_plan(schema, aggs, 1, False), schema, table, 1, "slot", tmp_path)
    assert got == want
    assert got["s"] == [D("4.50"), D("123456789012345678.99")]
    assert got["a"] == [D("2.250000"), D("123456789012345678.990000")]
    assert got["mn"] == [D("1.25"), D("123456789012345678.99")]
    assert got["mx"] == [D("3.25"), D("123456789012345678.99")]


def test_partial_state_schema_matches_jax():
    """The wire schema of the limb states: field names (the limb tags the
    FINAL side reads) and types equal the reference's."""
    schema = JT.Schema.of(("k", JT.I64), ("n", JT.DecimalType(17, 2)),
                          ("w", JT.DecimalType(38, 2)))
    aggs = [JN.AggColumn(JE.AggExpr(fn, [C(c)], rt), M.PARTIAL, f"{fn.value}_{c}")
            for fn, c, rt in ((F.SUM, "n", JT.DecimalType(27, 2)), (F.AVG, "n", None),
                              (F.SUM, "w", None), (F.AVG, "w", None), (F.MIN, "w", None),
                              (F.MAX, "w", None))]
    plan = JN.Agg(JN.FFIReader(schema, "src", 1), HASH, [("k", C("k"))], aggs)
    port = from_foreign(plan)
    assert port.output_schema.names == plan.output_schema.names
    assert repr(port.output_schema.types) == repr(plan.output_schema.types)
    assert any("sum_l0@" in n for n in port.output_schema.names)


def test_filter_and_exchange_carry_the_wide_column(tmp_path):
    """A wide column rides through a filter (K1), a hash exchange (K2, K5-K7)
    and a sort (K5, K6) as payload."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.DecimalType(38, 2)))
    table = _wide_table(2000, 21, nulls=0.1)
    scan = JN.FFIReader(schema, "src", 2)
    filt = JN.Filter(scan, [JE.BinaryExpr(JE.BinaryOp.GT, C("k"), JE.Literal(3, JT.I64))])
    ex = JN.ShuffleExchange(filt, JN.HashPartitioning([C("k")], 3))
    plan = JN.Sort(JN.ShuffleExchange(ex, JN.SinglePartitioning(1)), [JE.SortOrder(C("k"))])
    want, got = _run_both(plan, schema, table, 2, "slot", tmp_path)
    assert sorted(zip(got["k"], map(str, got["v"]))) == sorted(zip(want["k"], map(str, want["v"])))
    assert got["k"] == sorted(got["k"]) and len(got["k"]) == sum(k > 3 for k in table["k"])


@pytest.mark.parametrize("what", ["group key", "sort key", "partition key", "join key",
                                  "arithmetic", "isnull", "window result"])
def test_unported_wide_uses_raise(what):
    """A wide group, partition or join key, or a sort key computed from a
    wide column, raises naming Queue 1 item 6b (the reference keeps such
    keys on host columns; a bare wide column sorts by its limbs); an
    expression over a wide column, or a window result wider than 18
    digits, item 18."""
    schema = JT.Schema.of(("k", JT.I64), ("v", JT.DecimalType(38, 2)))
    scan = JN.FFIReader(schema, "src", 1)
    one = JN.AggColumn(JE.AggExpr(F.COUNT, []), M.COMPLETE, "n")
    item = "6b"
    if what == "group key":
        plan = JN.Agg(scan, HASH, [("v", C("v"))], [one])
    elif what == "sort key":
        plan = JN.Sort(scan, [JE.SortOrder(JE.BinaryExpr(JE.BinaryOp.ADD, C("v"), C("v")))])
    elif what == "partition key":
        plan = JN.ShuffleExchange(scan, JN.HashPartitioning([C("v")], 2))
    elif what == "join key":
        plan = JN.BroadcastJoin(scan, JN.BroadcastExchange(JN.FFIReader(schema, "src", 1)),
                                [(C("v"), C("v"))], JN.JoinType.INNER, JN.JoinSide.RIGHT, "w")
    elif what == "arithmetic":
        item = "18"
        plan = JN.Agg(scan, HASH, [("k", C("k"))], [JN.AggColumn(
            JE.AggExpr(F.SUM, [JE.BinaryExpr(JE.BinaryOp.ADD, C("v"), C("v"))]), M.COMPLETE,
            "s")])
    elif what == "isnull":
        item = "18"
        plan = JN.Filter(scan, [JE.IsNull(C("v"))])
    else:
        item = "18"
        plan = JN.Window(JN.Sort(scan, [JE.SortOrder(C("k"))]),
                         [JN.WindowExpr("agg", "s", JE.AggExpr(F.SUM, [C("v")]))],
                         [C("k")], [])
    port = blaze_tpu_torch.Session(device="cpu")
    port.resources["src"] = lambda p: [{"k": np.array([1, 2]),
                                        "v": wide_words([5, 10 ** 30], None)}]
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        port.execute_to_pydict(from_foreign(plan))
