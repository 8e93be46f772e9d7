"""Plans on the device mesh through both Sessions, at 1, 2 and 8 slots.

The reference runs ``blaze_tpu.Session(mesh=make_mesh(k))`` over its 8
virtual CPU devices (the ``eight_devices`` fixture) with
``multichip_enabled``; the port runs ``blaze_tpu_torch.Session(device=
"cpu", mesh=make_mesh(k, "cpu"), conf=Config(multichip_enabled=True))``.
Each result must equal the reference's and the port's own run without a
mesh, order included, with the mesh counters above 0:

- test_multichip.py's two-stage plan, with more reducers than slots, and
  its fused-sharding variant (a filter and projection fused over batches
  that stack);
- q01, q06, q17 (with its decimal(38,2) sum), q47 and q67 at small sizes
  from in-memory sources (the plans and draws of test_torch_slice.py,
  test_torch_joins.py and test_torch_agg_table.py);
- a range exchange with sampled bounds over tied keys, and empty input.

Also: a BINARY column crossing the mesh raises naming item 6b, a failed
stacked dispatch raises, and a config-built mesh clamps to the visible
devices.

Tolerance: none.
"""

import numpy as np
import pytest
import torch

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ops.joins.bhj import clear_build_cache
from blaze_tpu.parallel import mesh as JM
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_agg_table import _q67_plan
from tests.test_torch_joins import SALES17, SCHEMAS, _arrow, _q06, _q17, _q47, _slices, \
    _tables, _tables_wcost
from tests.test_torch_slice import SCHEMA as Q01_SCHEMA
from tests.test_torch_slice import _data as q01_data
from tests.test_torch_slice import _q01

torch.set_num_threads(1)

SLOTS = (1, 2, 8)
F = JE.AggFunction
C = JE.Column


def _serve(session, tables, batch):
    for rid, parts in tables.items():
        session.resources[rid] = lambda p, _parts=parts: _slices(_parts[p], batch)


def _run(plan, schemas, tables, tmp_path, batch, **conf):
    """The plan on the port without a mesh, then at every slot count on
    the reference's mesh and the port's: returns (the port's plain result,
    [(k, reference, port, port counters)]). The run without a mesh reads
    every reducer alone, as the mesh does (no AQE coalescing: merged
    reducers would hand a FINAL aggregate its groups in another order)."""
    plain = blaze_tpu_torch.Session(conf=Config(batch_size=batch, coalesce_partitions_enable=False,
                                                **conf), device="cpu")
    _serve(plain, tables, batch)
    port_plan = from_foreign(plan)
    base = plain.execute_to_pydict(port_plan)
    out = []
    for k in SLOTS:
        clear_build_cache()
        jconf = JaxConfig(batch_size=batch, shm_dir=str(tmp_path), multichip_enabled=True,
                          **conf)
        with JaxSession(conf=jconf, mesh=JM.make_mesh(k)) as s:
            for rid, parts in tables.items():
                s.resources[rid] = lambda p, _parts=parts, _s=schemas[rid]: [
                    _arrow(_s, b) for b in _slices(_parts[p], batch)]
            want = s.execute_to_pydict(plan)
        port = blaze_tpu_torch.Session(conf=Config(batch_size=batch, multichip_enabled=True,
                                                   **conf), device="cpu",
                                       mesh=make_mesh(k, "cpu"))
        _serve(port, tables, batch)
        out.append((k, want, port.execute_to_pydict(port_plan), dict(port.counters)))
    return base, out


def _check(base, runs, fused=False):
    for k, want, got, counters in runs:
        assert got == want, f"{k} slots: the port differs from the reference"
        assert got == base, f"{k} slots: the port differs from its run without a mesh"
        assert counters["sharded_stages"] > 0 and counters["collective_bytes"] > 0, counters
        if fused and k > 1:
            assert counters["sharded_batches"] > 0, counters


# -- test_multichip.py's two-stage plan ----------------------------------------------

KV = JT.Schema.of(("k", JT.I64), ("v", JT.I64))


def _kv_parts(seed, n, nparts):
    rng = np.random.default_rng(seed)
    k, v = rng.integers(0, 300, n), rng.integers(0, 1000, n)
    ones = np.ones(n // nparts, bool)
    per = n // nparts
    return [{"k": (k[i * per:(i + 1) * per], ones), "v": (v[i * per:(i + 1) * per], ones)}
            for i in range(nparts)]


def _two_stage_plan(nparts, reducers=4, child=None):
    scan = child or JN.FFIReader(KV, "src", nparts)
    partial = JN.Agg(scan, JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                     [JN.AggColumn(JE.AggExpr(F.SUM, [C("v")], JT.I64), JE.AggMode.PARTIAL, "s")])
    ex = JN.ShuffleExchange(partial, JN.HashPartitioning([C("k")], reducers))
    final = JN.Agg(ex, JE.AggExecMode.HASH_AGG, [("k", C("k"))],
                   [JN.AggColumn(JE.AggExpr(F.SUM, [C("v")], JT.I64), JE.AggMode.FINAL, "s")])
    return JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)), [JE.SortOrder(C("k"))])


@pytest.mark.parametrize("reducers", [4, 13], ids=["4 reducers", "13 reducers"])
def test_two_stage_plan_across_meshes(reducers, eight_devices, tmp_path):
    base, runs = _run(_two_stage_plan(4, reducers), {"src": KV},
                      {"src": _kv_parts(21, 20_000, 4)}, tmp_path, 4096)
    assert len(base["k"]) == 300
    _check(base, runs)


def test_fused_sharding_composes_with_the_mesh_exchange(eight_devices, tmp_path):
    """test_multichip.py's fused-sharding variant: 8 partitions of eight
    1,024-row batches through a fused filter and projection (stacked up to
    the slot count) into the two-stage plan. Filter -> agg fusion is off in
    both packages: by default the partial aggregate absorbs the stage (its
    steps run in the aggregate's input kernel) and nothing stacks."""
    scan = JN.FFIReader(KV, "src", 8)
    filt = JN.Filter(scan, [JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(100, JT.I64))])
    proj = JN.Projection(filt, [C("k"), JE.BinaryExpr(JE.BinaryOp.MUL, C("v"),
                                                      JE.Literal(3, JT.I64))], ["k", "v"])
    base, runs = _run(_two_stage_plan(8, child=proj), {"src": KV},
                      {"src": _kv_parts(24, 65_536, 8)}, tmp_path, 1024,
                      fused_filter_agg=False)
    _check(base, runs, fused=True)


# -- the bench shapes ----------------------------------------------------------------


def test_q01_across_meshes(eight_devices, tmp_path):
    base, runs = _run(_q01(), {"store_returns": Q01_SCHEMA},
                      {"store_returns": q01_data(seed=3)}, tmp_path, 4096)
    assert len(base["sr_store_sk"]) == 100
    _check(base, runs)


@pytest.mark.parametrize("query", ["q06", "q47", "q17"])
def test_join_shapes_across_meshes(query, eight_devices, tmp_path):
    if query == "q17":
        plan, tables, schemas = _q17(), _tables_wcost(seed=17), dict(SCHEMAS,
                                                                       store_sales=SALES17)
    else:
        plan = _q06() if query == "q06" else _q47()
        tables, schemas = _tables(seed=len(query), qty_hi=4 if query == "q47" else 100), SCHEMAS
    base, runs = _run(plan, schemas, tables, tmp_path, 1024)
    assert len(next(iter(base.values()))) > 5
    _check(base, runs)


def test_q67_across_meshes(eight_devices, tmp_path):
    rng = np.random.default_rng(67)
    ones = np.ones(8000, bool)
    parts = [{"ss_item_sk": (rng.integers(1, 500, 8000), ones),
              "ss_store_sk": (rng.integers(1, 40, 8000), ones),
              "ss_quantity": (rng.integers(1, 100, 8000), ones)} for _ in range(3)]
    schema = JT.Schema.of(("ss_item_sk", JT.I64), ("ss_store_sk", JT.I64),
                          ("ss_quantity", JT.I64))
    base, runs = _run(_q67_plan(schema), {"src": schema}, {"src": parts}, tmp_path, 2048)
    assert len(base["rk"]) > 500
    _check(base, runs)


def test_range_exchange_over_tied_keys_across_meshes(eight_devices, tmp_path):
    """A range exchange with sampled bounds into 5 reducers, then a sort
    on its key alone: tied rows keep the exchange's row order, which must
    be the same at every slot count."""
    rng = np.random.default_rng(98)
    ones = np.ones(3000, bool)
    parts = [{"k": (rng.integers(0, 40, 3000), ones), "v": (rng.integers(0, 10 ** 6, 3000),
                                                           ones)} for _ in range(3)]
    plan = JN.Sort(JN.ShuffleExchange(JN.FFIReader(KV, "src", 3), JN.RangePartitioning(
        [JE.SortOrder(C("k"), ascending=False)], 5, [])), [JE.SortOrder(C("k"), ascending=False)])
    base, runs = _run(plan, {"src": KV}, {"src": parts}, tmp_path, 1024)
    assert base["k"] == sorted(base["k"], reverse=True) and len(base["k"]) == 9000
    _check(base, runs)


def test_empty_input_across_meshes(eight_devices, tmp_path):
    filt = JN.Filter(JN.FFIReader(KV, "src", 4),
                     [JE.BinaryExpr(JE.BinaryOp.GT, C("k"), JE.Literal(10 ** 6, JT.I64))])
    base, runs = _run(_two_stage_plan(4, child=filt), {"src": KV},
                      {"src": _kv_parts(5, 4000, 4)}, tmp_path, 1024)
    assert base == {"k": [], "s": []}
    _check(base, runs)


# -- what raises ------------------------------------------------------------------------


def test_binary_column_crossing_the_mesh_raises_naming_item_6b():
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    schema = T.Schema.of(("k", T.I64))
    bf = N.Agg(N.FFIReader(schema, "src", 2), E.AggExecMode.HASH_AGG, [],
               [N.AggColumn(E.AggExpr(E.AggFunction.BLOOM_FILTER, [
                   E.ScalarFunction("xxhash64", [E.Column("k")])]), E.AggMode.COMPLETE, "bf")])
    plan = N.ShuffleExchange(bf, N.HashPartitioning([E.Literal(1, T.I64)], 2))
    port = blaze_tpu_torch.Session(conf=Config(multichip_enabled=True), device="cpu",
                                   mesh=make_mesh(2, "cpu"))
    port.resources["src"] = lambda p: [{"k": np.arange(10)}]
    with pytest.raises(NotImplementedError, match="item 6b"):
        port.execute_to_pydict(plan)


def test_failed_stacked_dispatch_raises(monkeypatch):
    """The port does not retry a failed stacked dispatch batch by batch (the
    reference does): the error reaches the caller. Filter -> agg fusion is
    off, so the stage under the partial aggregate stacks rather than being
    absorbed into it."""
    def broken(*args, **kwargs):
        raise RuntimeError("stacked dispatch failed")

    monkeypatch.setattr(K, "fused_chain_stacked", broken)
    port = blaze_tpu_torch.Session(conf=Config(multichip_enabled=True, batch_size=1024,
                                               fused_filter_agg=False),
                                   device="cpu", mesh=make_mesh(4, "cpu"))
    _serve(port, {"src": _kv_parts(1, 16_384, 2)}, 1024)
    scan = JN.FFIReader(KV, "src", 2)
    filt = JN.Filter(scan, [JE.BinaryExpr(JE.BinaryOp.GT, C("v"), JE.Literal(100, JT.I64))])
    proj = JN.Projection(filt, [C("k"), C("v")], ["k", "v"])
    with pytest.raises(RuntimeError, match="stacked dispatch failed"):
        port.execute_to_pydict(from_foreign(_two_stage_plan(2, child=proj)))


def test_config_built_mesh_clamps_to_the_visible_devices():
    from blaze_tpu_torch.ops.fused import SHARDED_FUSED

    s = blaze_tpu_torch.Session(conf=Config(multichip_enabled=True, multichip_devices=8),
                                device="cpu")
    assert s.mesh.n == 1 and s.resources[SHARDED_FUSED].n == 1
    assert blaze_tpu_torch.Session(device="cpu").mesh is None
    given = blaze_tpu_torch.Session(device="cpu", mesh=make_mesh(8, "cpu"))
    assert given.mesh.n == 8 and SHARDED_FUSED not in given.resources


def test_config_built_mesh_over_several_cards_raises(monkeypatch):
    # one slot per visible device, as the JAX package builds it: on a host
    # of several cards that mesh spans them, which is not ported
    from blaze_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.setattr(port_mesh, "visible_devices", lambda device: 4)
    conf = Config(multichip_enabled=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        blaze_tpu_torch.Session(conf=conf, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        blaze_tpu_torch.Session(conf=Config(multichip_enabled=True, multichip_devices=2),
                                device="cpu")
    s = blaze_tpu_torch.Session(conf=Config(multichip_enabled=True, multichip_devices=1),
                                device="cpu")
    assert s.mesh.n == 1 and s.mesh.device == torch.device("cpu")
