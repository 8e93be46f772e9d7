"""Whole-stage fusion in the port against the JAX package: the fusion pass,
the fused chain's plain twin (K11's plain version), and plans with
fusion on and off.

- The pass: ``blaze_tpu_torch.ir.fusion.fuse_plan`` gives the fused tree
  the JAX package's ``fuse_plan`` gives, compared as dataclass trees
  after ``from_foreign``, on tests/test_fusion.py's chains and on the
  q01, q06, q47, q67 and q69 plans; fingerprints are stable, equal across
  the packages and change with a literal; fusion off returns the very
  node given.
- The twin: ``core/kernels.fused_chain_plain`` against the jitted
  ``blaze_tpu.exprs.compiler.build_fused_closure`` on chip_smoke.py's K11
  battery (every step kind; i32, i64, f32, f64, bool and decimal planes;
  every ported operator; nulls, padding, empty batches), drawn without
  subnormals (ROADMAP.md Queue 3), run both eagerly and jitted. Under
  jit, XLA on the CPU contracts a float ``a*b + c`` into an FMA, which the
  eager path does not; the port rounds as the eager path does, and those
  columns are held against it alone (ROADMAP.md Queue 3, with a test
  showing both answers).
- Plans: the same plan with fusion on and off in the port, and in the
  JAX package with fusion on, give equal results, order included; q69 in
  the shape Spark plans it (null filters on the scans) equals a numpy
  oracle at ~2,000 customers.
- K11's generated source for every battery case parses as Python.

Tolerance: none; planes compare by their bytes.
"""

import ast
import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.exprs.compiler import build_fused_closure
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.ir.fusion import fuse_plan as jax_fuse_plan
from blaze_tpu.ir.fusion import fused_fingerprint as jax_fingerprint
from blaze_tpu.ops.joins import bhj as JBHJ
from blaze_tpu.runtime.session import Session as JaxSession
from blaze_tpu.utils.device import supports_f64

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.exprs.fused_triton import FusedKernel
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ir.fusion import chain_steps, fuse_plan, fused_fingerprint
from blaze_tpu_torch.ops import fused as fused_ops
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime.executor import build_operator
from chip_smoke import fused_cases, fused_planes
from tests.test_torch_generic_joins import Q69_BATCH, Q69_KEYS5, Q69_PARTS, Q69_SCHEMAS, SALES, \
    STATES, _q69_oracle, _q69_tables
from tests.test_torch_generic_joins import _port as _port_tables
from tests.test_torch_generic_joins import _reference as _reference_tables
from tests.test_torch_joins import _q06, _q47
from tests.test_torch_slice import _q01
from tests.test_torch_sort_window import _q67

torch.set_num_threads(1)
# the JAX package probes float64 support once per platform; the first probe
# must not run inside a trace, where it reads False and sends f64 literals
# down the host path
supports_f64()

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


C, L, B = JE.Column, JE.Literal, JE.BinaryOp
T4 = JT.Schema.of(("a", JT.I64), ("b", JT.F64), ("c", JT.I64), ("d", JT.I64))


def _scan(parts=2):
    return JN.FFIReader(T4, "t", parts)


# -- tests/test_fusion.py's chains, over an in-memory scan -------------------------


def _chain_plan():
    return JN.Projection(
        JN.Filter(
            JN.Projection(
                JN.Filter(_scan(), [JE.BinaryExpr(B.GT, C("a"), L(10, JT.I64))]),
                [C("a"), JE.BinaryExpr(B.MUL, C("b"), L(2.0, JT.F64)), C("c")],
                ["a", "b2", "c"]),
            [JE.BinaryExpr(B.LT, C("c"), L(7, JT.I64))]),
        [JE.BinaryExpr(B.ADD, C("a"), C("c")), C("b2")], ["ac", "b2"])


def _trivial_plan():
    return JN.Projection(_scan(), [C("a")], ["a"])


def _agg_filter_plan():
    proj = JN.Projection(_scan(), [C("a"), JE.BinaryExpr(B.MUL, C("d"), L(3, JT.I64)),
                                   JE.BinaryExpr(B.ADD, C("c"), L(1, JT.I64))],
                         ["a", "d3", "c1"])
    filt = JN.Filter(proj, [JE.BinaryExpr(B.GT, C("d3"), L(100, JT.I64))])
    return JN.Agg(filt, JE.AggExecMode.HASH_AGG, [("a", C("a"))],
                  [JN.AggColumn(JE.AggExpr(JE.AggFunction.SUM, [C("d3")], JT.I64),
                                JE.AggMode.PARTIAL, "s")])


def _expand_rename_plan():
    schema = JT.Schema.of(("a", JT.I64), ("v", JT.I64), ("tag", JT.I64))
    return JN.RenameColumns(
        JN.Filter(
            JN.Expand(
                JN.Filter(_scan(), [JE.BinaryExpr(B.LT, C("c"), L(8, JT.I64))]),
                [[C("a"), C("d"), L(0, JT.I64)],
                 [C("a"), JE.BinaryExpr(B.MUL, C("d"), L(10, JT.I64)), L(1, JT.I64)]],
                schema),
            [JE.BinaryExpr(B.GT, C("v"), L(50, JT.I64))]),
        ["g_a", "g_v", "g_tag"])


def _udf_plan():
    udf = JE.PyUDF(lambda a: a, [C("a")], JT.I64, "ident")
    return JN.Filter(
        JN.Projection(JN.Filter(_scan(), [JE.BinaryExpr(B.GT, C("a"), L(20, JT.I64))]),
                      [udf, C("c")], ["a2", "c"]),
        [JE.BinaryExpr(B.LT, C("c"), L(5, JT.I64))])


def _filters_plan():
    """test_fused_dispatch_count_guard's filter-heavy chain, with a
    coalesce between two segments."""
    return JN.Filter(
        JN.CoalesceBatches(
            JN.Filter(
                JN.Projection(JN.Filter(_scan(), [JE.BinaryExpr(B.GT, C("a"), L(5, JT.I64))]),
                              [C("a"), C("c"), C("d")], ["a", "c", "d"]),
                [JE.BinaryExpr(B.LT, C("c"), L(9, JT.I64))]),
            4096),
        [JE.BinaryExpr(B.GT, C("d"), L(3, JT.I64)),
         JE.BinaryExpr(B.LT, C("d"), L(990, JT.I64))])


CHAINS = {"chain": _chain_plan, "trivial": _trivial_plan, "agg_filter": _agg_filter_plan,
          "expand_rename": _expand_rename_plan, "pyudf": _udf_plan, "filters": _filters_plan}


def _q69_spark_plan(group_keys=Q69_KEYS5):
    """chip_smoke.py q69_plan at the test's size: the null filters Spark
    infers on the scans, ca_state_id IN (...)."""
    J = JN.JoinType

    def scan(name, parts=Q69_PARTS):
        return JN.FFIReader(Q69_SCHEMAS[name], name, parts)

    def by(child, key):
        return JN.ShuffleExchange(child, JN.HashPartitioning([C(key)], Q69_PARTS))

    def both(a, b):
        return JE.BinaryExpr(B.AND, a, b)

    def notnull(a, b):
        return both(JE.IsNotNull(C(a)), JE.IsNotNull(C(b)))

    address = JN.Filter(scan("customer_address", 1), [both(
        JE.InList(C("ca_state_id"), [L(s, JT.I64) for s in STATES]),
        JE.IsNotNull(C("ca_address_sk")))])
    customer = JN.Filter(scan("customer"), [notnull("c_current_addr_sk", "c_current_cdemo_sk")])
    cust = JN.BroadcastJoin(customer, JN.BroadcastExchange(address),
                            [(C("c_current_addr_sk"), C("ca_address_sk"))], J.INNER,
                            JN.JoinSide.RIGHT, "q69_address")
    out = by(JN.Projection(cust, [C("c_customer_sk"), C("c_current_cdemo_sk")],
                           ["c_customer_sk", "c_current_cdemo_sk"]), "c_customer_sk")
    dates = JN.Filter(scan("date_dim", 1), [
        JE.BinaryExpr(B.EQ, C("d_year"), L(2001, JT.I64)),
        JE.BinaryExpr(B.GTEQ, C("d_moy"), L(4, JT.I64)),
        JE.BinaryExpr(B.LTEQ, C("d_moy"), L(6, JT.I64)), JE.IsNotNull(C("d_date_sk"))])
    for name, dcol, ccol, jt in SALES:
        window = JN.BroadcastJoin(JN.Filter(scan(name), [notnull(dcol, ccol)]),
                                  JN.BroadcastExchange(dates), [(C(dcol), C("d_date_sk"))],
                                  J.INNER, JN.JoinSide.RIGHT, f"q69_dates_{name}")
        window = by(JN.Projection(window, [C(ccol)], [ccol]), ccol)
        out = JN.HashJoin(out, window, [(C("c_customer_sk"), C(ccol))], jt, JN.JoinSide.RIGHT)
    out = JN.BroadcastJoin(out, JN.BroadcastExchange(scan("customer_demographics", 1)),
                           [(C("c_current_cdemo_sk"), C("cd_demo_sk"))], J.INNER,
                           JN.JoinSide.RIGHT, "q69_demographics")
    keys = [(k, C(k)) for k in group_keys]
    count = JE.AggExpr(JE.AggFunction.COUNT, [])
    partial = JN.Agg(out, JE.AggExecMode.HASH_AGG, keys,
                     [JN.AggColumn(count, JE.AggMode.PARTIAL, "cnt")],
                     supports_partial_skipping=True)
    final = JN.Agg(JN.ShuffleExchange(partial, JN.HashPartitioning(
        [e for _, e in keys], Q69_PARTS)), JE.AggExecMode.HASH_AGG, keys,
        [JN.AggColumn(count, JE.AggMode.FINAL, "cnt")])
    return JN.Sort(JN.ShuffleExchange(final, JN.SinglePartitioning(1)),
                   [JE.SortOrder(C(k)) for k in group_keys], fetch_limit=100)


QUERIES = {"q01": _q01, "q06": _q06, "q47": _q47, "q67": _q67, "q69": _q69_spark_plan}


def _fused_stages(node, out=None):
    out = [] if out is None else out
    if isinstance(node, N.FusedStage):
        out.append(node)
        _fused_stages(node.child, out)
    else:
        for c in node.children():
            _fused_stages(c, out)
    return out


# -- the pass -------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_fuse_plan_matches_the_reference_on_test_fusion_chains(name):
    plan = CHAINS[name]()
    want = from_foreign(jax_fuse_plan(plan, JaxConfig()))
    got = fuse_plan(from_foreign(plan), Config())
    assert got == want
    stages = _fused_stages(got)
    assert len(stages) == {"chain": 1, "trivial": 0, "agg_filter": 1, "expand_rename": 1,
                           "pyudf": 2, "filters": 1}[name]
    if name == "agg_filter":
        assert isinstance(got.child, N.Filter) and isinstance(got.child.child, N.FusedStage)
    if name == "filters":
        assert [s[0] for s in chain_steps(stages[0].ops)] == \
            ["filter", "project", "filter", "coalesce", "filter"]
    assert fuse_plan(got, Config()) is got  # idempotent


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_fuse_plan_matches_the_reference_on_the_query_plans(query):
    plan = QUERIES[query]()
    want = from_foreign(jax_fuse_plan(plan, JaxConfig()))
    got = fuse_plan(from_foreign(plan), Config())
    assert got == want
    stages = _fused_stages(got)
    # q01's filter feeds its partial agg (the agg-filter guard); q06 has no
    # narrow chain; q47's and q67's root rank filter fuses; q69 fuses its
    # address, customer and three sales scan filters and the date filter
    # under each of its three broadcasts
    assert len(stages) == {"q01": 0, "q06": 0, "q47": 1, "q67": 1, "q69": 8}[query]
    for st in stages:
        assert [type(o).__name__ for o in st.ops] == ["Filter"]


def test_fingerprints_are_stable_equal_across_packages_and_literal_sensitive():
    plan = _chain_plan()
    port = from_foreign(plan)
    st1 = fuse_plan(port, Config())
    st2 = fuse_plan(from_foreign(plan), Config())
    schema = st1.child.output_schema
    fp1 = fused_fingerprint(schema, chain_steps(st1.ops))
    assert fp1 == fused_fingerprint(st2.child.output_schema, chain_steps(st2.ops))
    ref = jax_fuse_plan(plan, JaxConfig())
    from blaze_tpu.ir.fusion import chain_steps as jax_chain_steps

    assert fp1 == jax_fingerprint(ref.child.output_schema, jax_chain_steps(ref.ops))
    other = fuse_plan(from_foreign(JN.Projection(
        JN.Filter(plan.child.child, [JE.BinaryExpr(B.LT, C("c"), L(8, JT.I64))]),
        plan.exprs, plan.names)), Config())
    assert fused_fingerprint(other.child.output_schema, chain_steps(other.ops)) != fp1


def _op_names(op):
    names = [type(op).__name__]
    for c in op.children:
        names.extend(_op_names(c))
    return names


def test_escape_hatch_builds_the_unfused_tree():
    plan = from_foreign(_chain_plan())
    off = Config(fusion_enabled=False)
    assert fuse_plan(plan, off) is plan
    names = _op_names(build_operator(plan, off))
    assert "FusedStageExec" not in names
    assert names.count("ProjectExec") == 2 and names.count("FilterExec") == 2
    on = _op_names(build_operator(plan, Config()))
    assert "FusedStageExec" in on and "ProjectExec" not in on
    expand = from_foreign(_expand_rename_plan())
    assert _op_names(build_operator(expand, off))[:3] == \
        ["RenameColumnsExec", "FilterExec", "ExpandExec"]


# -- K11's plain version against the jitted closure ----------------------------------

CASES = {name: (schema, steps) for name, schema, steps in fused_cases(JE, JT)}
# capacity, live rows: padding, a full bucket, empty
CPU_CAPS = ((256, 200), (4096, 4096), (256, 0))


def _same_bytes(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _fma_shaped(expr) -> bool:
    """A float ``a*b + c`` (or MOD, which is ``a - trunc(a/b)*b``): XLA on
    the CPU contracts it into an FMA inside a jit, and the JAX package's
    eager path does not."""
    return isinstance(expr, JE.BinaryExpr) and (
        expr.op == B.MOD or (expr.op in (B.ADD, B.SUB) and any(
            isinstance(x, JE.BinaryExpr) and x.op == B.MUL for x in (expr.left, expr.right))))


# the cases whose float expressions XLA contracts under jit (ROADMAP.md
# Queue 3): their FMA-shaped columns are held against the eager closure only
FMA_CASES = ("floats", "fma shapes")


def _run_closure(fn, datas, valids, n):
    return fn(tuple(jnp.asarray(x) for x in datas), tuple(jnp.asarray(x) for x in valids),
              jnp.int64(n))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_chain_plain_matches_jax(case):
    """Every plane, bit for bit, against the closure run eagerly and
    jitted (the eager run first: the JAX package reads an InList's literal
    validity with bool(), which a trace refuses unless the literal is
    already in its literal cache)."""
    schema, steps = CASES[case]
    port_schema, port_steps = from_foreign(schema), from_foreign(steps)
    closure = build_fused_closure(schema, steps)
    jitted = jax.jit(closure)
    skip_jit = {k for k, e in enumerate(steps[0][1])
                if case in FMA_CASES and _fma_shaped(e)}
    rng = np.random.default_rng(sorted(CASES).index(case))
    for cap, n in CPU_CAPS:
        datas, valids = fused_planes(cap, n, rng, subnormals=False)
        got_groups, got_counts = K.fused_chain_plain(
            port_schema, port_steps, [torch.from_numpy(x) for x in datas],
            [torch.from_numpy(x) for x in valids], n)
        for fn, skip in ((closure, set()), (jitted, skip_jit)):
            want_groups, want_counts = _run_closure(fn, datas, valids, n)
            assert len(got_groups) == len(want_groups)
            assert [int(c) for c in got_counts] == [int(c) for c in want_counts]
            for (jd, jv), (pd, pv) in zip(want_groups, got_groups):
                assert len(jd) == len(pd)
                for k, (x, y) in enumerate(zip(jd + jv, pd + pv)):
                    if k % len(jd) not in skip:
                        _same_bytes(x, y)


def test_jitted_closure_contracts_float_mul_add():
    """XLA on the CPU contracts a float ``a*b + c`` into an FMA inside the
    jitted closure, so it rounds once where the JAX package's eager path
    (and Spark) round twice. The port rounds twice, on the CPU and in K11
    (``enable_fp_fusion=False``): it equals the eager closure, not the
    jitted one."""
    schema = JT.Schema.of(("d", JT.F64), ("e", JT.F64))
    steps = (("project", (JE.BinaryExpr(B.ADD, JE.BinaryExpr(B.MUL, C("d"), C("e")), C("d")),
                          JE.BinaryExpr(B.MOD, C("e"), L(0.1, JT.F64))), ("fma", "mod")),)
    datas = [np.array([406.3264472423496, 0.0] + [0.0] * 254),
             np.array([-0.925018182156823, -1e300] + [0.0] * 254)]
    valids = [np.ones(256, bool), np.ones(256, bool)]
    closure = build_fused_closure(schema, steps)
    eager = _run_closure(closure, datas, valids, 2)[0][0][0]
    jitted = _run_closure(jax.jit(closure), datas, valids, 2)[0][0][0]
    got = K.fused_chain_plain(from_foreign(schema), from_foreign(steps),
                              [torch.from_numpy(x) for x in datas],
                              [torch.from_numpy(x) for x in valids], 2)[0][0][0]
    assert float(eager[0][0]) == 30.467095651991144 == float(got[0][0])
    assert float(jitted[0][0]) == 30.46709565199114
    assert float(eager[1][1]) == 0.0 == float(got[1][1])
    assert float(jitted[1][1]) == 5.551115123125783e+283


def _read_before_bound(tree: ast.Module):
    """The names ``fused_chain`` reads before it binds them (its arguments,
    the module's functions and imports and Python's builtins count as
    bound), in statement order: a store of an unloaded plane shows here."""
    import builtins

    bound = set(dir(builtins))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            bound.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom, ast.Try)):
            bound |= {a.asname or a.name.split(".")[0] for n in ast.walk(node)
                      if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    fn = tree.body[-1]
    bound |= {a.arg for a in fn.args.args}
    unbound = []
    for stmt in fn.body:
        unbound += [n.id for n in ast.walk(stmt)
                    if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                    and n.id not in bound]
        bound |= {n.id for n in ast.walk(stmt)
                  if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
    return unbound


@pytest.mark.parametrize("case", sorted(CASES))
def test_generated_source_parses(case):
    schema, steps = CASES[case]
    kernel = FusedKernel(from_foreign(schema), from_foreign(steps))
    tree = ast.parse(kernel.source)
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert names[-1] == "fused_chain" and "_floordiv" in names
    assert _read_before_bound(tree) == []
    gen = kernel.gen
    assert len(gen.groups) == len(fused_ops.fused_group_flags(steps))
    assert kernel.path.endswith(f"fused/{kernel.fingerprint}.py")


def test_filter_only_segment_stores_just_its_mask():
    """q69's scan filter reads two validity planes and writes one mask;
    K1 compacts the input planes themselves."""
    schema, steps = CASES["q69 scan filter"]
    gen = FusedKernel(from_foreign(schema), from_foreign(steps)).gen
    assert gen.stores and [t for _, t in gen.stores] == [torch.bool]
    assert gen.used_d == [] and gen.used_v == [1, 2]
    dspec, vspec, mask = gen.groups[0]
    assert dspec == [("in_d", k) for k in range(len(schema))] and mask == 0


# -- plans ----------------------------------------------------------------------------


def _table(seed=11, parts=2, rows=3000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(parts):
        part = {"a": rng.integers(0, 100, rows), "b": rng.standard_normal(rows),
                "c": rng.integers(0, 10, rows), "d": rng.integers(0, 1000, rows)}
        out.append({k: (v, rng.random(rows) >= 0.05) for k, v in part.items()})
    return out


def _arrow(part, batch=1024):
    n = len(part["a"][0])
    types = {"a": pa.int64(), "b": pa.float64(), "c": pa.int64(), "d": pa.int64()}
    return [pa.record_batch([pa.array(np.where(v, d, 0)[s:s + batch], type=types[k],
                                      mask=~v[s:s + batch]) for k, (d, v) in part.items()],
                            names=list(part)) for s in range(0, n, batch)]


def _slices(part, batch=1024):
    n = len(part["a"][0])
    return [{k: (np.where(v, d, 0)[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, n, batch)]


def _port_run(plan, parts, conf):
    port = blaze_tpu_torch.Session(conf=conf, device="cpu")
    port.resources["t"] = lambda p: _slices(parts[p])
    return port.execute_to_pydict(from_foreign(plan))


@pytest.mark.parametrize("name", ["chain", "expand_rename", "filters"])
def test_chain_plans_fused_equal_unfused_and_the_reference(name):
    plan = CHAINS[name]()
    parts = _table()
    with JaxSession(conf=_jax_conf(JaxConfig(batch_size=1024))) as s:
        s.resources["t"] = lambda p: _arrow(parts[p])
        want = s.execute_to_pydict(plan)
    assert len(next(iter(want.values()))) > 100
    assert _port_run(plan, parts, Config(batch_size=1024)) == want
    assert _port_run(plan, parts, Config(batch_size=1024, fusion_enabled=False)) == want


def test_q69_in_spark_shape_matches_jax_and_the_oracle():
    """q69 at ~2,000 customers with the null filters on the scans: the port
    with fusion on (each scan filter a fused stage) and off, the JAX
    package, and the oracle agree, order included."""
    tables = _q69_tables(seed=69)
    plan = _q69_spark_plan()
    want = _q69_oracle(tables, Q69_KEYS5)
    assert 50 <= len(want["cnt"]) <= 100
    assert _port_tables(plan, tables, batch=Q69_BATCH) == want
    assert _port_tables(plan, tables, conf=Config(batch_size=Q69_BATCH, fusion_enabled=False),
                        batch=Q69_BATCH) == want
    JBHJ.clear_build_cache()
    assert _reference_tables(plan, tables, Q69_SCHEMAS, batch=Q69_BATCH,
                             shm_dir=_SHM["dir"]) == want


def test_kernel_cache_is_shared_across_queries():
    fused_ops.clear_fused_cache()
    plan = from_foreign(_chain_plan())
    parts = _table(parts=1)
    metrics = []
    for _ in range(2):
        op = build_operator(plan, Config(batch_size=1024))
        ctx = ExecContext(Config(batch_size=1024), torch.device("cpu"),
                          {"t": lambda p: _slices(parts[p])})
        list(op.execute(0, ctx))
        metrics.append(op.metrics)
    assert metrics[0]["jit_cache_misses"] == 1 and metrics[0]["fused_stages"] == 1
    assert metrics[1]["jit_cache_misses"] == 0 and metrics[1]["jit_cache_hits"] == 3
    assert metrics[1]["fused_ops"] == 4


def test_fused_stage_rejects_mixed_capacities():
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
    from blaze_tpu_torch.ops.fused import FusedStageExec

    plan = fuse_plan(from_foreign(_chain_plan()), Config())
    schema = plan.child.output_schema
    cols = [DeviceColumn(f.dtype, torch.zeros(256 if k else 512, dtype=dt),
                         torch.zeros(256 if k else 512, dtype=torch.bool))
            for k, (f, dt) in enumerate(zip(schema.fields, (torch.int64, torch.float64,
                                                               torch.int64, torch.int64)))]

    class One:
        children = []

        def __init__(self):
            self.schema = schema

        def execute(self, p, ctx):
            return iter([ColumnarBatch(schema, cols, 10)])

    op = FusedStageExec(One(), plan)
    with pytest.raises(ValueError, match="one capacity"):
        list(op.execute(0, ExecContext(Config(), torch.device("cpu"))))
