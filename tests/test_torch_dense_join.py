"""K8's two search routes against the JAX package: the plain twin of the
unique-key inner join (``core/kernels.inner_join_planes_plain``) against
``blaze_tpu.ops.joins.bhj._inner_fast_kernel`` on the build words where
K8 takes its dense route (consecutive keys, negative ones included) and
where it searches (one gap, float keys with -0.0 and NaN payloads), with
no row hitting, every row hitting and rows past ``num_rows``; the host's
route decision (``ops/joins/keymap.dense_key_words``) as a pure function
of the sorted words; and a q96-shaped plan (three broadcast joins to a
global COUNT) with dense and with sparse dimension keys through
``blaze_tpu_torch.Session(device="cpu")`` and ``blaze_tpu.Session``.

On the CPU the wrapper takes the plain version, so the routes themselves
run on the card (tests/test_torch_cuda.py); here the same inputs hold the
function both routes must compute.

Tolerance: none. Planes compare by their bytes, plan results exactly.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins import bhj as JBHJ
from blaze_tpu.ops.joins import keymap as JKM
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ops.joins import keymap as KM
from chip_smoke import q96_oracle, q96_plan, q96_schemas

torch.set_num_threads(1)

_NP = {"i64": np.int64, "i32": np.int32, "f32": np.float32, "f64": np.float64}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_bytes(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, (j.dtype, t.dtype, j.shape, t.shape)
    np.testing.assert_array_equal(j.view(np.uint8), t.view(np.uint8))


def _floats(kind):
    """Float keys whose canonical words collide: +-0.0, NaN payloads of
    both signs, +-inf and ordinary values."""
    if kind == "f64":
        nans = np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                         0x7FF0000000000001], np.uint64).view(np.float64)
    else:
        nans = np.array([0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001],
                        np.uint32).view(np.float32)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.25, 7.0], _NP[kind])
    return np.concatenate([vals, nans])


def _inputs(kind, build_keys, probe_keys, cap_p, n, nulls, seed):
    """A build batch of the unique keys ``build_keys`` (sorted by canonical
    word: code c owns row c; one null-keyed row after them) and a probe
    batch of ``cap_p`` rows, ``n`` of them live, keys drawn from
    ``probe_keys``, ``nulls`` of them null; int32, int64 and bool planes
    on both sides."""
    rng = np.random.default_rng(seed)
    dt = _NP[kind]
    words = JKM._canon_words(build_keys)
    uniq = np.unique(words)
    nk = len(uniq)
    cap_b = max(256, nk + 1)
    order = np.argsort(words, kind="stable")
    bkey = np.zeros(cap_b, dt)
    bkey[:nk] = build_keys[order]
    live_b = np.arange(cap_b) < nk + 1
    bpay = np.where(live_b, rng.integers(-10**12, 10**12, cap_b), 0)
    bflag = (rng.random(cap_b) < 0.5) & live_b
    build = [(bkey, np.arange(cap_b) < nk), (bpay, live_b), (bflag, live_b)]
    live = np.arange(cap_p) < n
    pk_v = live & (rng.random(cap_p) >= nulls)
    pk = np.where(pk_v, probe_keys[rng.integers(0, len(probe_keys), cap_p)], 0).astype(dt)
    pi32 = np.where(live, rng.integers(-99, 99, cap_p), 0).astype(np.int32)
    pbool = (rng.random(cap_p) < 0.5) & live
    probe = [(pk, pk_v), (pi32, live), (pbool, live)]
    return uniq, nk, probe, build


def _run(kind, uniq, nk, n, probe, build):
    """The JAX kernel and the port's twin on the same planes, byte for
    byte; returns the hit count."""
    cap_p, cap_b = len(probe[0][0]), len(build[0][0])
    jker = JBHJ._inner_fast_kernel(
        np.dtype(_NP[kind]).name, tuple(str(d.dtype) for d, _ in probe),
        tuple(str(d.dtype) for d, _ in build), cap_p, cap_b, nk)
    words = uniq if nk else np.zeros(1, np.int64)
    flat = [jnp.asarray(x) for pair in probe + build for x in pair]
    jouts = jker(jnp.asarray(words), jnp.int64(n), jnp.asarray(probe[0][0]),
                 jnp.asarray(probe[0][1]), *flat)
    count, pd, pv, bd, bv = K.inner_join_planes_plain(
        _t(words), nk, n, _t(probe[0][0]), _t(probe[0][1]),
        [_t(d) for d, _ in probe], [_t(v) for _, v in probe],
        [_t(d) for d, _ in build], [_t(v) for _, v in build])
    assert int(jouts[0]) == int(count)
    mine = [x for pair in zip(pd, pv) for x in pair] + [x for pair in zip(bd, bv) for x in pair]
    assert len(mine) == len(jouts) - 1
    for a, b in zip(jouts[1:], mine):
        _same_bytes(a, b)
    return int(count)


# (label, key kind, build keys, probe keys, capacity, live rows, null share,
#  dense, expected hits: "some", "none" or "all")
_CASES = {
    "dense, negative keys": ("i64", np.arange(-40, 60), np.arange(-90, 110), 1024, 1000,
                             0.1, True, "some"),
    "dense int32 from int32 min": ("i32", np.arange(-2**31, -2**31 + 300).astype(np.int32),
                                   np.arange(-2**31, -2**31 + 600).astype(np.int32), 512,
                                   500, 0.05, True, "some"),
    "dense, one gap": ("i64", np.delete(np.arange(-40, 60), 50), np.arange(-90, 110), 1024,
                       1000, 0.1, False, "some"),
    "float keys, -0.0 and NaN (f64)": ("f64", _floats("f64")[[0, 2, 4, 6, 8]],
                                       _floats("f64"), 512, 480, 0.1, False, "some"),
    "float keys, -0.0 and NaN (f32)": ("f32", _floats("f32")[[1, 3, 5, 9]], _floats("f32"),
                                       512, 500, 0.0, False, "some"),
    "every row missing": ("i64", np.arange(1000, 1100), np.arange(-500, 999), 1024, 1024,
                          0.0, True, "none"),
    "every row hitting": ("i64", np.arange(1, 257), np.arange(1, 257), 1024, 1024, 0.0,
                          True, "all"),
    "rows past num_rows": ("i64", np.arange(5, 105), np.arange(5, 105), 1024, 300, 0.0,
                           True, "all"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_inner_join_twin_matches_jax_on_both_routes_inputs(case):
    kind, bkeys, pkeys, cap_p, n, nulls, dense, hits = _CASES[case]
    uniq, nk, probe, build = _inputs(kind, bkeys, pkeys, cap_p, n, nulls, seed=len(case))
    assert KM.dense_key_words(uniq) == dense
    if case == "rows past num_rows":  # hitting keys marked valid past num_rows
        probe[0][0][n:] = bkeys[0]
        probe[0][1][n:] = True
    count = _run(kind, uniq, nk, n, probe, build)
    live = int(probe[0][1][:n].sum())
    assert {"none": count == 0, "all": count == live, "some": 0 < count < live}[hits]


@pytest.mark.parametrize("words,dense", [
    ([], False),
    ([7], True),
    ([-3, -2, -1, 0, 1, 2], True),
    ([-3, -2, 0, 1], False),                      # one gap
    ([1, 3, 5], False),
    ([-(2**63), -(2**63) + 1], True),             # int64's low end
    ([2**63 - 2, 2**63 - 1], True),               # and its high end
    ([-(2**63), 2**63 - 1], False),               # the span past int64: no wrap
    ([73_800 + i for i in range(1800)], True),    # q96's time_dim keys
])
def test_dense_key_words_is_a_function_of_the_sorted_words(words, dense):
    arr = np.array(words, dtype=np.int64)
    assert KM.dense_key_words(arr) == dense
    # as the build map holds them: the sorted unique canonical words
    assert KM.dense_key_words(np.unique(KM._canon_words(arr))) == dense


def test_dense_key_words_of_built_maps():
    """The decision over a built map's words: the dense keys of a filtered
    dimension, the same keys with one left out, float keys."""
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    def built(keys, dtype):
        schema = T.Schema.of(("k", dtype))
        col = DeviceColumn(dtype, _t(keys), torch.ones(len(keys), dtype=torch.bool))
        return KM.JoinHashMap.build([ColumnarBatch(schema, [col], len(keys))],
                                    [E.Column("k")], schema, torch.device("cpu"))

    rng = np.random.default_rng(0)
    keys = rng.permutation(np.arange(-30, 70))
    assert KM.dense_key_words(built(keys, T.I64).sorted_keys)
    assert not KM.dense_key_words(built(keys[keys != 12], T.I64).sorted_keys)
    assert not KM.dense_key_words(built(np.array([0.0, -0.0, 1.0]), T.F64).sorted_keys)


@pytest.mark.parametrize("nprobe,nbuild", [(8, 6), (100, 28), (100, 29), (142, 140), (300, 2)])
@pytest.mark.parametrize("words,search", [(np.arange(10, 20), False), (np.arange(10, 20), True),
                                          (np.arange(0, 20_000, 2), False)])
def test_join_pack_words_one_launch_for_each_128_planes(monkeypatch, nprobe, nbuild, words,
                                                        search):
    """K8's argument words as the pack writes them for a probe batch
    (``JoinPack.bind``; the launch itself needs the card): one word array
    a launch, each over the next 128 planes at most, probe planes first,
    with its probe count, the batch's and the outputs' pointers, the
    element sizes, the count's pointer and a tag of its own; the route and
    the search top from the host words, decided once a pack."""
    from blaze_tpu_torch.utils import cuda_lib

    monkeypatch.setattr(cuda_lib, "require_cuda", lambda *_a: None)
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda _i: 7)
    cap_p, cap_b = 3000, 64
    dtypes = (torch.int64, torch.int32, torch.bool, torch.float64, torch.int16)
    build = [torch.zeros(cap_b, dtype=dtypes[i % 5]) for i in range(nbuild)]
    pack = K.JoinPack(_t(words), words, build[:nbuild // 2], build[nbuild // 2:], search)
    dense = not search and len(words) == 10
    assert pack.dense == dense
    key, kv = torch.zeros(cap_p, dtype=torch.int32), torch.zeros(cap_p, dtype=torch.bool)
    probe = [torch.zeros(cap_p, dtype=dtypes[(i + 2) % 5]) for i in range(nprobe)]
    planes = probe + build
    for batch in range(2):
        outs, count, launches = pack.bind(2000 + batch, key, kv, probe)
        assert [o.dtype for o in outs] == [p.dtype for p in planes]
        assert len(launches) == -(-len(planes) // 128)
        done, tags = 0, set()
        for w in launches:
            n = w[K._JW_NPLANES]
            assert 0 < n <= 128 and w[K._JW_NPROBE] == min(max(nprobe - done, 0), n)
            for j in range(n):
                src, dst, size = w[K._JW_PLANES + 3 * j:K._JW_PLANES + 3 * j + 3]
                assert (src, dst, size) == (planes[done + j].data_ptr(),
                                            outs[done + j].data_ptr(),
                                            planes[done + j].element_size())
            assert (w[K._JW_ROWS], w[K._JW_CAP_P], w[K._JW_CAP_B]) == (2000 + batch, cap_p, cap_b)
            assert (w[K._JW_KEY], w[K._JW_KVALID]) == (key.data_ptr(), kv.data_ptr())
            assert (w[K._JW_KSIZE], w[K._JW_KKIND], w[K._JW_STREAM]) == (4, 0, 7)
            assert w[K._JW_COUNT] == count.data_ptr() and w[K._JW_NK] == len(words)
            assert (w[K._JW_DENSE], w[K._JW_LO], w[K._JW_HI]) == \
                ((1, 10, 19) if dense else (0, 0, len(words) - 1))
            # the staged top: every word up to 4,096, else every step-th
            assert (w[K._JW_TOP], w[K._JW_STEP]) == ((10, 1) if len(words) == 10 else (3334, 3))
            assert w[K._JW_TILES] >= -(-cap_p // 1024)
            tags.add(w[K._JW_TAG])
            done += n
        assert done == len(planes) and len(tags) == len(launches) and 0 not in tags


# -- a q96-shaped plan with dense and with sparse dimension keys ------------------

_ROWS = {"store_sales": 60_000, "time_dim": 86_400, "household_demographics": 7_200,
         "store": 102}
_PARTS = 3
_BATCH = 8192


def _q96_host(stride, seed=96):
    """q96's tables (chip_smoke.py's schemas and plan) with the dimensions'
    filters choosing one run of keys each: time_dim's t_hour = 20 AND
    t_minute >= 30 the keys 73,800..75,599, hd_dep_count = 7 the 720 keys
    5,041..5,760, s_store_name = 'ese' the stores 31..40; every dimension
    key and store_sales foreign key times ``stride`` (1: the runs are
    dense; 3: every build map searches). A third of each foreign key falls
    in its filter's run, so all three joins hit; 4% of each is null."""
    rng = np.random.default_rng(seed)
    sk = np.arange(_ROWS["time_dim"])
    hd = np.arange(1, _ROWS["household_demographics"] + 1)
    st = np.arange(1, _ROWS["store"] + 1)
    host = {"time_dim": ((sk * stride, sk // 3600, sk // 60 % 60), None),
            "household_demographics": ((hd * stride, (hd - 1) // 720 % 10), None),
            "store": ((st * stride, (st - 1) // 10 % 10), None)}
    n = _ROWS["store_sales"]
    cols, valids = [], []
    for lo, hi, run, width in ((0, _ROWS["time_dim"], 73_800, 1800),
                               (1, _ROWS["household_demographics"] + 1, 5_041, 720),
                               (1, _ROWS["store"] + 1, 31, 10)):
        v = rng.random(n) >= 0.04
        keys = np.where(rng.random(n) < 1 / 3, rng.integers(run, run + width, n),
                        rng.integers(lo, hi, n))
        cols.append(np.where(v, keys * stride, 0))
        valids.append(v)
    host["store_sales"] = (tuple(cols), tuple(valids))
    return host


def _slices(part, batch):
    n = len(next(iter(part.values()))[0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, max(n, 1), batch)]


def _parts(host, schemas):
    parts = {}
    for name, (cols, valids) in host.items():
        valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
        planes = {f.name: (c, v) for f, c, v in zip(schemas[name].fields, cols, valids)}
        n = len(cols[0])
        cuts = [n * p // _PARTS for p in range(_PARTS + 1)] if name == "store_sales" \
            else [0, n]
        parts[name] = [{k: (d[a:b], v[a:b]) for k, (d, v) in planes.items()}
                       for a, b in zip(cuts, cuts[1:])]
    return parts


@pytest.mark.parametrize("stride,dense", [(1, True), (3, False)])
def test_q96_shape_with_dense_and_sparse_keys_matches_jax(tmp_path, monkeypatch, stride,
                                                          dense):
    """q96's plan (chip_smoke.py) through both Sessions and the numpy
    oracle: every join is an unconditioned unique-key inner broadcast join
    (K8's), and its three build maps take the dense route or search, as
    ``dense_key_words`` decides over each map's sorted words."""
    host = _q96_host(stride)
    want_np = q96_oracle(host)
    schemas = q96_schemas(JT)
    plan = q96_plan(schemas, JE, JN, JT, parts=_PARTS)
    parts = _parts(host, schemas)
    JBHJ.clear_build_cache()
    with JaxSession(conf=JaxConfig(batch_size=_BATCH, shm_dir=str(tmp_path))) as s:
        for name, plist in parts.items():
            schema = schemas[name]
            s.resources[name] = lambda p, _pl=plist, _s=schema: [
                pa.record_batch([pa.array(b[f.name][0], mask=~b[f.name][1])
                                 for f in _s.fields], names=_s.names)
                for b in _slices(_pl[p], _BATCH)]
        want = s.execute_to_pydict(plan)
    maps, joins = [], []
    built = KM.JoinHashMap._build_sorted
    monkeypatch.setattr(KM.JoinHashMap, "_build_sorted", staticmethod(
        lambda *a, **k: maps.append(built(*a, **k)) or maps[-1]))
    plain = K.inner_join_planes_plain
    monkeypatch.setattr(K, "inner_join_planes_plain",
                        lambda *a, **k: joins.append(a[1]) or plain(*a, **k))
    port = blaze_tpu_torch.Session(conf=Config(batch_size=_BATCH), device="cpu")
    for name, plist in parts.items():
        port.resources[name] = lambda p, _pl=plist: _slices(_pl[p], _BATCH)
    got = port.execute_to_pydict(from_foreign(plan))
    assert got == want == want_np and want_np["cnt"][0] > 50
    assert sorted(len(m.sorted_keys) for m in maps) == [10, 720, 1800]
    assert all(m.unique_single_key for m in maps)
    assert [KM.dense_key_words(m.sorted_keys) for m in maps] == [dense] * 3
    assert sorted(set(joins)) == [10, 720, 1800]
