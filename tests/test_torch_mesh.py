"""The port's device mesh (slice 13) against the JAX package's, on the CPU.

The reference runs its mesh as 8 virtual CPU devices in one process (the
``eight_devices`` fixture); the port's mesh is n slots on one device.

- K17: the twin (``core/kernels.mesh_all_to_all_plain``) against the
  reference's pack (MeshBatchExchange.run's take/where) and
  ``_exchange_compact_step`` at 1, 2 and 8 devices, on chip_smoke.py's
  battery (``MESH_CASES``, ``mesh_case``): every plane dtype, null and
  padding rows, empty slots, more reducers than slots and skewed reducers
  over several rounds.
- ``MeshBatchExchange.run`` reducer by reducer against the reference's
  on the same shard batches and ids, on both sides of the resident budget.
- ``run_distributed_sum`` and ``run_broadcast_join`` on test_mesh.py's
  cases at 1, 2 and 8 slots.
- The stacked K11's twin against per-batch ``fused_chain_plain``.

Plans through both Sessions are in tests/test_torch_mesh_plans.py.

Tolerance: none. Planes compare by their bytes; batches by their values,
floats by ``repr``.
"""

import collections
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from blaze_tpu.config import config_override
from blaze_tpu.core.batch import ColumnarBatch as JBatch
from blaze_tpu.core.batch import HostBatch as JHostBatch
from blaze_tpu.ir import types as JT
from blaze_tpu.parallel import mesh as JM

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import BytesColumn, ColumnarBatch
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.parallel import mesh as M
from chip_smoke import MESH_CASES, fused_cases, fused_planes, mesh_case, mesh_run, mesh_torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
SLOTS = (1, 2, 8)


# -- K17: the twin against the reference's pack and _exchange_compact_step -----------


def _reference_rounds(case, jmesh):
    """Every round of a mesh case through the reference's pack (its rows
    by stable reducer order into (n * chunk,) send planes, dead positions
    0) and ``_exchange_compact_step``: per round the numpy output planes,
    the live plane first."""
    n, G, scap, chunk = case["n"], case["G"], case["scap"], case["chunk"]
    seg_len = n * chunk
    devs = list(jmesh.devices.flat)
    sharding = NamedSharding(jmesh, P("data"))
    kinds = case["kinds"]
    rounds = []
    for t in range(case["rounds"]):
        shard_planes = [[] for _ in range(1 + len(kinds))]
        for s in range(n):
            pids = case["pids"][s]
            if pids is None:
                shard_planes[0].append(jnp.zeros(seg_len, bool))
                for p, plane in enumerate(kinds):
                    shard_planes[1 + p].append(jnp.zeros(seg_len, case_dtype(plane)))
                continue
            counts = np.bincount(pids, minlength=n * G)
            order = np.argsort(pids, kind="stable")
            starts = np.zeros(n * G, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            psort = pids[order]
            rank = np.arange(len(pids)) - starts[psort]
            sel = (rank >= t * scap) & (rank < (t + 1) * scap)
            src = np.full(seg_len, -1, np.int64)
            src[psort[sel] * scap + (rank[sel] - t * scap)] = order[sel]
            live = src >= 0
            sidx = jnp.asarray(np.where(live, src, 0).astype(np.int32))
            lv = jnp.asarray(live)
            shard_planes[0].append(lv)
            for p, plane in enumerate(case["slots"][s]):
                d = jnp.asarray(plane)
                shard_planes[1 + p].append(jnp.where(lv, jnp.take(d, sidx, mode="clip"),
                                                     jnp.zeros((), d.dtype)))
        gplanes = [jax.make_array_from_single_device_arrays(
            (n * seg_len,), sharding, [jax.device_put(x, devs[s]) for s, x in enumerate(ps)])
            for ps in shard_planes]
        with jmesh:
            outs = JM._exchange_compact_step(jmesh, "data", len(gplanes), chunk, *gplanes)
        rounds.append([np.asarray(o) for o in outs])
    return rounds


def case_dtype(kind):
    return {"bool": np.bool_, "i8": np.int8, "i16": np.int16, "i32": np.int32,
            "i64": np.int64, "f32": np.float32, "f64": np.float64}[kind]


def _bytes(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


_EXCHANGE_CASES = [c for c in MESH_CASES if c[2] is not None and c[1] in SLOTS]


@pytest.mark.parametrize("spec", _EXCHANGE_CASES, ids=[c[0] for c in _EXCHANGE_CASES])
def test_k17_twin_matches_reference_exchange(spec, eight_devices):
    case = mesh_case(spec, np.random.default_rng(sum(map(ord, spec[0]))))
    want = _reference_rounds(case, JM.make_mesh(case["n"]))
    got = mesh_run(case, K.mesh_all_to_all_plain, CPU)
    assert len(got) == len(want) == case["rounds"]
    for t, ((outs, live, recv), ref) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(live.numpy(), ref[0], err_msg=f"round {t} live")
        for p, (o, r) in enumerate(zip(outs, ref[1:])):
            assert o.numpy().dtype == r.dtype, (p, o.dtype, r.dtype)
            np.testing.assert_array_equal(_bytes(o), _bytes(r), err_msg=f"round {t} plane {p}")
        seg_len = case["n"] * case["chunk"]
        assert recv.tolist() == [int(ref[0][d * seg_len:(d + 1) * seg_len].sum())
                                 for d in range(case["n"])]


@pytest.mark.parametrize("spec", [c for c in MESH_CASES if c[2] is None],
                         ids=[c[0] for c in MESH_CASES if c[2] is None])
def test_k17_tile_mode_is_the_masked_tiles(spec):
    """Tile mode against exchange_and_aggregate's (n, capacity) tiles
    written out in numpy: slot d receives, from each slot s, every row of s
    routed to d at its own position, 0 elsewhere."""
    case = mesh_case(spec, np.random.default_rng(5))
    (outs, live, recv), = mesh_run(case, K.mesh_all_to_all_plain, CPU)
    n, cap = case["n"], case["chunk"]
    for p in range(len(case["kinds"])):
        want = np.zeros((n, n, cap), case_dtype(case["kinds"][p]))
        for s in range(n):
            pid = case["routes"][s]
            for d in range(n):
                want[d, s] = np.where(pid == d, case["slots"][s][p], 0)
        np.testing.assert_array_equal(_bytes(outs[p]), _bytes(want.ravel()))
    want_live = np.stack([[case["routes"][s] == d for s in range(n)] for d in range(n)])
    np.testing.assert_array_equal(live.numpy(), want_live.ravel())
    assert recv.tolist() == want_live.reshape(n, -1).sum(1).tolist()


def test_k17_raises_on_mismatched_inputs():
    case = mesh_case(MESH_CASES[1], np.random.default_rng(1))
    planes, routes, dtypes = mesh_torch(case, CPU)
    with pytest.raises(ValueError, match="counts"):
        K.mesh_all_to_all_plain(planes, routes, case["chunk"], CPU, dtypes,
                                case["counts"][:, :1], case["G"], case["scap"])
    with pytest.raises(ValueError, match="CUDA"):
        K.mesh_all_to_all_cuda(planes, routes, case["chunk"], CPU, dtypes, case["counts"],
                               case["G"], case["scap"])


# -- MeshBatchExchange.run against the reference's ----------------------------------

_SCHEMA = (("k", "i64"), ("v", "f64"), ("i", "i32"), ("f", "f32"), ("b", "bool"),
           ("d", "dec"))


def _shard_data(rng, rows, nulls=0.1):
    out = {"k": rng.integers(-(1 << 40), 1 << 40, rows),
           "v": rng.standard_normal(rows) * 100,
           "i": rng.integers(-1000, 1000, rows).astype(np.int32),
           "f": rng.standard_normal(rows).astype(np.float32),
           "b": rng.random(rows) < 0.5,
           "d": rng.integers(-10 ** 8, 10 ** 8, rows)}
    out["v"][rng.random(rows) < 0.05] = np.nan
    out["f"][rng.random(rows) < 0.05] = -0.0
    return {c: (x, rng.random(rows) >= nulls) for c, x in out.items()}


def _schemas():
    jt = {"i64": JT.I64, "f64": JT.F64, "i32": JT.I32, "f32": JT.F32, "bool": JT.BOOL,
          "dec": JT.DecimalType(9, 2)}
    pt = {"i64": T.I64, "f64": T.F64, "i32": T.I32, "f32": T.F32, "bool": T.BOOL,
          "dec": T.DecimalType(9, 2)}
    return (JT.Schema.of(*[(c, jt[k]) for c, k in _SCHEMA]),
            T.Schema.of(*[(c, pt[k]) for c, k in _SCHEMA]))


def _jbatch(jschema, cols):
    arrs = []
    for f in jschema.fields:
        d, v = cols[f.name]
        if isinstance(f.dtype, JT.DecimalType):
            arrs.append(pa.array([decimal.Decimal(int(x)).scaleb(-2) if ok else None
                                  for x, ok in zip(d, v)], type=pa.decimal128(9, 2)))
        else:
            arrs.append(pa.array(d, mask=~v))
    return JBatch.from_arrow(pa.record_batch(arrs, names=jschema.names), jschema)


def _canon(d):
    return {k: [repr(x) if isinstance(x, float) else x for x in v] for k, v in d.items()}


def _exchange_inputs(n, rows, R, seed, empty=(), skew=0.0):
    rng = np.random.default_rng(seed)
    jschema, schema = _schemas()
    data, pids = [], []
    for s in range(n):
        if s in empty:
            data.append(None)
            pids.append(None)
            continue
        data.append(_shard_data(rng, rows))
        p = rng.integers(0, R, rows).astype(np.int32)
        p[rng.random(rows) < skew] = 0
        pids.append(p)
    jb = [None if d is None else _jbatch(jschema, d) for d in data]
    pb = [None if d is None else ColumnarBatch.from_numpy(schema, d, CPU) for d in data]
    return jschema, schema, jb, pb, pids


@pytest.mark.parametrize("n,rows,R,empty,skew,round_bytes,resident", [
    (1, 3000, 4, (), 0.0, None, True),
    (2, 2500, 2, (), 0.0, None, False),
    (8, 700, 13, (0, 5), 0.0, None, True),
    (8, 2000, 3, (2,), 0.9, 1 << 14, True),
    (8, 2000, 11, (), 0.5, 1 << 14, False),
    (2, 0, 4, (0, 1), 0.0, None, True),
], ids=["n1 R4", "n2 R2 host", "n8 R13 empty slots", "n8 R3 skewed rounds",
        "n8 R11 skewed rounds host", "n2 every slot empty"])
def test_mesh_batch_exchange_matches_reference(n, rows, R, empty, skew, round_bytes, resident,
                                               eight_devices):
    """Reducer by reducer, the port's exchange returns the reference's rows
    in the reference's order, device-resident where the reference is and
    in host memory where it is; the wire bytes are the reference's."""
    jschema, schema, jb, pb, pids = _exchange_inputs(n, rows, R, seed=n * 100 + R,
                                                     empty=empty, skew=skew)
    budget = None if resident else 1
    over = {} if round_bytes is None else {"mesh_exchange_round_bytes": round_bytes}
    jex = JM.MeshBatchExchange(JM.make_mesh(n))
    with config_override(**over):
        want = jex.run(jschema, jb, [None if p is None else p for p in pids], R,
                       device_resident_budget=budget)
    from blaze_tpu_torch.config import Config

    ex = M.MeshBatchExchange(M.make_mesh(n, "cpu"))
    got = ex.run(schema, pb, pids, R, device_resident_budget=budget, conf=Config(**over))
    assert len(got) == len(want) == R
    assert ex.last_device_resident == jex.last_device_resident == resident
    assert ex.last_wire_bytes == jex.last_wire_bytes
    assert ex.last_wire_bytes_uncompacted == jex.last_wire_bytes_uncompacted
    assert ex.last_payload_bytes == jex.last_payload_bytes
    if round_bytes is not None:
        assert ex.last_rounds > 1
    for r, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, r
            continue
        assert isinstance(g, M.HostBatch) == isinstance(w, JHostBatch), r
        gb = g.to_columnar(CPU) if isinstance(g, M.HostBatch) else g
        wb = w.to_columnar() if isinstance(w, JHostBatch) else w
        assert gb.num_rows == wb.num_rows
        assert _canon(gb.to_pydict()) == _canon(wb.to_arrow().to_pydict()), r
    # the live counts K17 emits are the rows each slot received
    total = sum(int(c.sum()) for c in ex.last_recv_counts)
    assert total == sum(len(p) for p in pids if p is not None)


def test_mesh_exchange_wire_bytes_compacted():
    """test_mesh.py's done-bar on the port: compacted segments carry >= 5x
    less than the (n, capacity) masked tiles at 8 slots, and the outputs
    stay device columns."""
    _js, schema, _jb, pb, pids = _exchange_inputs(8, 6000, 8, seed=13)
    ex = M.MeshBatchExchange(M.make_mesh(8, "cpu"))
    results = ex.run(schema, pb, pids, 8)
    assert sum(r.num_rows for r in results if r is not None) == 8 * 6000
    assert ex.last_wire_bytes * 5 <= ex.last_wire_bytes_uncompacted
    assert all(isinstance(r, ColumnarBatch) for r in results)


def test_wide_decimal_crosses_as_limb_planes():
    """A decimal(38,2) column crosses the mesh as its three limb planes
    (the reference dictionary-encodes it on the host), rows exact."""
    from blaze_tpu_torch.core.batch import WideColumn, wide_words

    rng = np.random.default_rng(3)
    schema = T.Schema.of(("k", T.I64), ("w", T.DecimalType(38, 2)))
    vals, batches, pids = [], [], []
    for _s in range(4):
        x = [int(a) * 10 ** 20 + int(b) for a, b in zip(rng.integers(-10 ** 6, 10 ** 6, 500),
                                                        rng.integers(0, 10 ** 18, 500))]
        v = rng.random(500) > 0.1
        k = rng.integers(0, 50, 500)
        batches.append(ColumnarBatch.from_numpy(schema, {"k": k, "w": (wide_words(x, v), v)},
                                                CPU))
        vals += [(int(a), b if ok else None) for a, b, ok in zip(k, x, v)]
        pids.append((k % 3).astype(np.int32))
    for budget in (None, 1):
        out = M.MeshBatchExchange(M.make_mesh(4, "cpu")).run(schema, batches, pids, 3,
                                                             device_resident_budget=budget)
        rows = []
        for r in out:
            b = r.to_columnar(CPU) if isinstance(r, M.HostBatch) else r
            assert isinstance(b.columns[1], WideColumn)
            d = b.to_pydict()
            rows += [(k, None if w is None else int(w.scaleb(2))) for k, w in zip(d["k"], d["w"])]
        assert sorted(rows, key=repr) == sorted(vals, key=repr)


def test_binary_column_raises_naming_item_6b():
    schema = T.Schema.of(("k", T.I64), ("bf", T.BINARY))
    b = ColumnarBatch(schema, [ColumnarBatch.from_numpy(T.Schema.of(("k", T.I64)),
                                                        {"k": np.arange(3)}, CPU).columns[0],
                               BytesColumn.from_values(T.BINARY, [b"x", None, b"y"], 256)], 3)
    with pytest.raises(NotImplementedError, match="item 6b"):
        M.MeshBatchExchange(M.make_mesh(2, "cpu")).run(schema, [b, None],
                                                       [np.zeros(3, np.int32), None], 2)


def test_mesh_across_devices_raises_naming_item_15():
    with pytest.raises(NotImplementedError, match="item 15"):
        M.DeviceMesh([torch.device("cpu"), torch.device("cuda", 1)])
    assert M.make_mesh(8, "cpu").n == 8
    assert M.make_mesh(None, "cpu").n == 1
    np.testing.assert_array_equal(M.pmod(torch.tensor([-7, 7, 0, -1], dtype=torch.int32), 4),
                                  [1, 3, 0, 3])


# -- 18b and 18c: run_distributed_sum and run_broadcast_join --------------------------


def _sum_cases():
    rng = np.random.default_rng(0)
    return {"groupby": (rng.integers(0, 300, 4000).astype(np.int64),
                        rng.integers(0, 1000, 4000).astype(np.int64)),
            "locality": (np.arange(100, dtype=np.int64), np.ones(100, dtype=np.int64)),
            "odd sizes": (rng.integers(-5, 5, 37).astype(np.int64),
                          rng.integers(-(1 << 40), 1 << 40, 37).astype(np.int64))}


@pytest.mark.parametrize("case", ["groupby", "locality", "odd sizes"])
def test_run_distributed_sum_matches_reference(case, eight_devices):
    keys, vals = _sum_cases()[case]
    exp = collections.defaultdict(lambda: [0, 0])
    for k, v in zip(keys.tolist(), vals.tolist()):
        exp[k][0] += v
        exp[k][1] += 1
    for n in SLOTS:
        want = JM.run_distributed_sum(keys, vals, JM.make_mesh(n))
        got = M.run_distributed_sum(keys, vals, M.make_mesh(n, "cpu"))
        assert got == want
        assert got == {k: tuple(v) for k, v in exp.items()}


@pytest.mark.parametrize("n", SLOTS)
def test_exchange_and_aggregate_step_matches_reference(n, eight_devices):
    """The SPMD step's raw planes, invalid segments included, against the
    reference's jitted step: keys with int64 minimum and maximum (a valid
    key equal to the dead rows' sort key), invalid and padding rows."""
    rng = np.random.default_rng(n)
    cap = 256
    keys = rng.integers(-50, 50, n * cap)
    keys[rng.random(n * cap) < 0.05] = np.iinfo(np.int64).max
    keys[rng.random(n * cap) < 0.05] = np.iinfo(np.int64).min
    vals = rng.integers(-(1 << 40), 1 << 40, n * cap)
    valid = rng.random(n * cap) >= 0.2
    valid[-37:] = False
    jmesh = JM.make_mesh(n)
    with jmesh:
        want = JM.exchange_and_aggregate(jmesh, cap)(jnp.asarray(keys), jnp.asarray(vals),
                                                      jnp.asarray(valid))
    got = M.exchange_and_aggregate(M.make_mesh(n, "cpu"), cap)(
        *(torch.from_numpy(x) for x in (keys, vals, valid)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["even keys", "duplicate build keys", "empty build"])
def test_run_broadcast_join_matches_reference(case, eight_devices):
    rng = np.random.default_rng(2)
    probe = rng.integers(0, 200, 1000).astype(np.int64)
    if case == "even keys":
        bk = np.arange(0, 200, 2, dtype=np.int64)
    elif case == "duplicate build keys":
        bk = rng.integers(0, 150, 300).astype(np.int64)
    else:
        bk = np.zeros(0, np.int64)
    bv = np.arange(len(bk), dtype=np.int64) * 10 + 7
    for n in SLOTS:
        want = JM.run_broadcast_join(probe, bk, bv, JM.make_mesh(n))
        got = M.run_broadcast_join(probe, bk, bv, M.make_mesh(n, "cpu"))
        assert got == want
    if case == "even keys":
        assert got[0] == [int(k) * 5 + 7 if k % 2 == 0 else None for k in probe]


# -- the stacked K11's twin -----------------------------------------------------------


def _flat_bytes(result):
    groups, counts = result
    out = []
    for (ds, vs), c in zip(groups, counts):
        out += [_bytes(x).tobytes() for x in list(ds) + list(vs)] + [int(c)]
    return out


@pytest.mark.parametrize("k", range(1, 9))
def test_stacked_k11_twin_matches_per_batch(k):
    """Every chain of chip_smoke.py's K11 battery over a stack of k batches
    of one capacity (row counts from full to empty) equals the single-batch
    plain version on each batch, plane bytes and counts."""
    from blaze_tpu_torch.ir import exprs as E

    rng = np.random.default_rng(k)
    rows = (256, 200, 0, 17, 256, 129, 1, 255)[:k]
    for name, schema, steps in fused_cases(E, T):
        host = [fused_planes(256, rows[b], rng) for b in range(k)]
        datas = [[torch.from_numpy(x) for x in d] for d, _v in host]
        valids = [[torch.from_numpy(x) for x in v] for _d, v in host]
        got = K.fused_chain_stacked(schema, steps, datas, valids, rows)
        assert len(got) == k
        for b in range(k):
            want = K.fused_chain_plain(schema, steps, datas[b], valids[b], rows[b])
            assert _flat_bytes(got[b]) == _flat_bytes(want), (name, b)
