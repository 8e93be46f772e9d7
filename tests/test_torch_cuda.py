"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, and the q01, q67 (on both aggregation routes), q06 and q96
paths and every hash-join type on the card against the same plans on the
CPU. K9's, K10's, K11's and K12's cases come from chip_smoke.py.

Marked ``cuda``: each test skips here (no GPU) and runs on a machine with
one, where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer, bool and int64-backed decimal planes, and
float sort keys compared bit for bit).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (FUSED_CAPS, PROBE_CASES, Q96_ROWS, SEG_CASES, UPD_CASES,
                        customer_probe, fused_cases, fused_flat, fused_planes, merge_states,
                        probe_case, q67_batch, q67_merge_input, q67_table_merge_batch,
                        q96_host, q96_oracle, q96_plan, q96_schemas, seg_case, to_dev,
                        upd_case, upd_fns, upd_run)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():  # bit for bit: -0.0 is not +0.0 here
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    assert torch.equal(a, b)


@pytest.mark.parametrize("cap,n,keep", [(1024, 1000, 0.0), (1024, 1024, 1.0),
                                        (262144, 262144, 0.95), (262144, 9000, 0.5)])
def test_compact_planes_kernel(dev, cap, n, keep):
    from blaze_tpu_torch.core import kernels as K

    g = torch.Generator(device="cpu").manual_seed(cap + n)
    datas = [torch.randint(-2**40, 2**40, (cap,), generator=g),
             torch.randint(-2**20, 2**20, (cap,), generator=g).to(torch.int32),
             torch.rand(cap, generator=g) < 0.5]
    valids = [torch.rand(cap, generator=g) < 0.8 for _ in datas]
    mask = (torch.rand(cap, generator=g) < keep) & (torch.arange(cap) < n)
    args = ([d.to(dev) for d in datas], [v.to(dev) for v in valids], mask.to(dev))
    _equal(K.compact_planes_cuda(*args), K.compact_planes_plain(*args))


@pytest.mark.parametrize("kinds", [("i64",), ("i32",), ("i64", "i32")])
def test_murmur3_pmod_kernel(dev, kinds):
    from blaze_tpu_torch.exprs import spark_hash as H

    n = 5000
    g = torch.Generator(device="cpu").manual_seed(len(kinds))
    words = [torch.randint(-2**62, 2**62, (n,), generator=g) if k == "i64"
             else torch.randint(-2**31, 2**31, (n,), generator=g).to(torch.int32)
             for k in kinds]
    valids = [torch.rand(n, generator=g) < 0.9 for _ in kinds]
    args = ([w.to(dev) for w in words], [v.to(dev) for v in valids], list(kinds), n, 4)
    _equal(H.murmur3_pmod_cuda(*args), H.murmur3_pmod_plain(*args))


@pytest.mark.parametrize("hi,nbuck", [(400, 0), (100_000, 256)])
def test_slot_agg_kernels(dev, hi, nbuck):
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    cap, n = 16384, 15000
    g = torch.Generator(device="cpu").manual_seed(hi)
    key = torch.randint(1, hi, (cap,), generator=g).to(dev)
    kv = ((torch.rand(cap, generator=g) < 0.95) & (torch.arange(cap) < n)).to(dev)
    amt = torch.randint(0, 10**6, (cap,), generator=g).to(dev)
    av = ((torch.rand(cap, generator=g) < 0.9) & (torch.arange(cap) < n)).to(dev)
    exists = (torch.arange(cap) < n).to(dev)
    specs = [("sum", 0, "int64"), ("count", 0, ""), ("avg", 4, "int64"),
             ("min", 0, ""), ("max", 0, "")]
    args = [(amt, av), (torch.zeros_like(amt), exists), (amt, av), (amt, av), (amt, av)]
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges([key], [kv]), cap, None,
                                              conf.radix_agg_max_slots, conf)
    call = ([key], [kv], [torch.int64], n, bases, sizes, specs, args, out_cap, nbuck)
    part = A.slot_agg_partial(*call)
    _equal(part, A.slot_agg_partial_plain(*call))
    gcount = int(part[0])
    outs = part[:-2] if nbuck else part
    live = torch.arange(out_cap, device=dev) < gcount
    states = [[(outs[4], outs[5] & live), (outs[5], live)], [(outs[6], live)],
              [(outs[7], (outs[8] > 0) & live), (outs[8], live)],
              [(outs[9], outs[10] & live), (outs[10], live)],
              [(outs[11], outs[12] & live), (outs[12], live)]]
    kinds = ("sum", "count", "avg", "min", "max")
    mcall = ([outs[2]], [outs[3] & live], [torch.int64], gcount, bases, sizes, kinds,
             states, out_cap)
    _equal(A.slot_agg_merge(*mcall), A.slot_agg_merge_plain(*mcall))


def test_q01_on_the_card_equals_the_cpu(dev):
    import blaze_tpu_torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(0)
    schema = T.Schema.of(("k", T.I64), ("amt", T.DecimalType(7, 2)))
    parts = [[{"k": rng.integers(1, 400, 50_000),
               "amt": rng.integers(0, 10**6, 50_000)}] for _ in range(3)]
    F = E.AggFunction
    keys = [("k", E.Column("k"))]
    aggs = [("total", E.AggExpr(F.SUM, [E.Column("amt")], T.DecimalType(17, 2))),
            ("cnt", E.AggExpr(F.COUNT, []))]
    filt = N.Filter(N.FFIReader(schema, "src", 3), [E.BinaryExpr(
        E.BinaryOp.GT, E.Column("amt"), E.Literal("500.00", T.DecimalType(7, 2)))])
    partial = N.Agg(filt, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in aggs])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([E.Column("k")], 3)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in aggs])
    plan = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                  [E.SortOrder(E.Column("total"), ascending=False)], fetch_limit=100)
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(device=device)
        s.resources["src"] = lambda p: parts[p]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(plan)
    assert out[None] == out["cpu"]
    # every kernel but the joins', the sort route's, K11 and the host
    # table's K12, which q01 does not reach (its filter feeds the partial
    # aggregate, so it is not fused; both aggregates take the slot route)
    assert all(v > 0 for k, v in cuda_lib.launch_counts().items()
               if k not in ("inner_join_planes", "probe_codes", "segment_ids",
                            "seg_agg_partial", "seg_agg_merge", "fused_chain",
                            "slot_update"))


def _key_planes(kinds, cap, n, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    datas, valids = [], []
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5])
    for kind in kinds:
        if kind == "f64":
            d = specials[torch.randint(0, 6, (cap,), generator=g)]
        elif kind == "bool":
            d = torch.rand(cap, generator=g) < 0.5
        else:
            d = torch.randint(-4, 4, (cap,), generator=g)
            d[torch.rand(cap, generator=g) < 0.1] = torch.iinfo(torch.int64).min
            d = d.to(torch.int32) if kind == "i32" else d
        v = (torch.rand(cap, generator=g) < 0.85) & (torch.arange(cap) < n)
        datas.append(torch.where(v, d, torch.zeros((), dtype=d.dtype)).to(dev))
        valids.append(v.to(dev))
    return datas, valids


@pytest.mark.parametrize("kinds,spec,cap,n", [
    (("i64",), ((True, True),), 256, 200),
    (("i64", "i32"), ((True, False), (False, True)), 4096, 3000),
    (("bool", "f64", "i64"), ((False, True), (False, False), (True, True)), 4096, 4096),
    (("i64", "i64"), ((True, True), (False, True)), 1 << 20, 797_601),
])
def test_key_sort_kernels(dev, kinds, spec, cap, n):
    from blaze_tpu_torch.core import kernels as K

    datas, valids = _key_planes(kinds, cap, n, cap + n, dev)
    exists = torch.arange(cap, device=dev) < n
    ops = K.sort_key_operands_cuda(datas, valids, exists, spec)
    _equal(ops, K.sort_key_operands_plain(datas, valids, exists, spec))
    for rows in (n, None):
        _equal(K.lexsort_indices_cuda(ops, rows), K.lexsort_indices_plain(ops, rows))


@pytest.mark.parametrize("masked", [False, True])
def test_gather_kernel(dev, masked):
    from blaze_tpu_torch.core import kernels as K

    g = torch.Generator(device="cpu").manual_seed(int(masked))
    datas = [torch.randint(-2**40, 2**40, (4096,), generator=g),
             torch.randint(-100, 100, (1024,), generator=g).to(torch.int32)]
    valids = [torch.rand(4096, generator=g) < 0.8, torch.rand(1024, generator=g) < 0.8]
    idx = torch.randint(0, 3000, (2500,), generator=g).to(dev)
    live = (torch.rand(2500, generator=g) < 0.7).to(dev) if masked else None
    args = ([d.to(dev) for d in datas], [v.to(dev) for v in valids], idx, 4096, 2500, live)
    _equal(K.gather_planes_cuda(*args), K.gather_planes_plain(*args))


def test_slice_and_concat_kernels(dev):
    from blaze_tpu_torch.core import kernels as K

    g = torch.Generator(device="cpu").manual_seed(5)
    d = torch.randint(-2**40, 2**40, (4096,), generator=g).to(dev)
    v = (torch.rand(4096, generator=g) < 0.8).to(dev)
    for offset, length in ((0, 256), (3900, 100), (3000, 0), (5000, 0)):
        _equal(K.slice_planes_cuda([d], [v], offset, length, 256),
               K.slice_planes_plain([d], [v], offset, length, 256))
    rows = [200, 0, 4096, 37]
    parts = [(torch.randint(-9, 9, (4096,), generator=g).to(dev),
              (torch.rand(4096, generator=g) < 0.8).to(dev)) for _ in rows]
    args = ([[p[0] for p in parts]], [[p[1] for p in parts]], rows, 8192)
    _equal(K.concat_planes_cuda(*args), K.concat_planes_plain(*args))


def test_q67_on_the_card_equals_the_cpu(dev):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    rng = np.random.default_rng(1)
    schema = T.Schema.of(("item", T.I64), ("store", T.I64), ("q", T.I64))
    parts = [[{"item": rng.integers(1, 300, 40_000), "store": rng.integers(1, 50, 40_000),
               "q": rng.integers(1, 5, 40_000)}] for _ in range(3)]
    keys = [("item", E.Column("item")), ("store", E.Column("store"))]
    agg = [("qty", E.AggExpr(E.AggFunction.SUM, [E.Column("q")]))]
    partial = N.Agg(N.FFIReader(schema, "src", 3), E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in agg])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([e for _, e in keys], 3)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in agg])
    srt = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                 [E.SortOrder(E.Column("item")), E.SortOrder(E.Column("qty"), ascending=False)])
    win = N.Window(srt, [N.WindowExpr("rank", "rk")], [E.Column("item")],
                   [E.SortOrder(E.Column("qty"), ascending=False)])
    plan = N.Filter(win, [E.BinaryExpr(E.BinaryOp.LTEQ, E.Column("rk"), E.Literal(3, T.I32))])
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=4096),
                                    device=device)
        s.resources["src"] = lambda p: parts[p]
        out[device] = s.execute_to_pydict(plan)
    assert len(out["cpu"]["rk"]) > 300
    assert out[None] == out["cpu"]


def _join_case(key_dtype, cap_p, n, nk, cap_b, ncols, seed, dev):
    """Sorted unique build words, the probe key and ncols probe / build
    columns (int64 and int32 planes with nulls) for K8."""
    from blaze_tpu_torch.core import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed)
    if key_dtype.is_floating_point:
        pool = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5,
                             -2.5, 3.0, 1e30], dtype=key_dtype)
        nans = torch.tensor([0x7FF8000000000123, -0x0008000000000000],
                            dtype=torch.int64).view(torch.float64).to(key_dtype)
        pool = torch.cat([pool, nans])
        words = torch.unique(K.canon_words(pool))
        uniq = words[torch.randperm(len(words), generator=g)[:nk]].sort().values
    else:
        keys = (torch.randperm(3 * nk + 64, generator=g)[:nk] - nk).to(key_dtype)
        misses = torch.randint(-4 * nk - 64, 4 * nk + 64, (64,), generator=g)
        pool = torch.cat([keys, misses.to(key_dtype)])
        uniq = torch.unique(K.canon_words(keys))
    key = pool[torch.randint(0, len(pool), (cap_p,), generator=g)]
    kv = (torch.rand(cap_p, generator=g) < 0.9) & (torch.arange(cap_p) < n)
    key = torch.where(kv, key, torch.zeros((), dtype=key_dtype))
    probe = [torch.randint(-2**40, 2**40, (cap_p,), generator=g) if i % 2 == 0 else
             torch.randint(-99, 99, (cap_p,), generator=g).to(torch.int32)
             for i in range(ncols)]
    build = [torch.randint(-2**40, 2**40, (cap_b,), generator=g) if i % 2 else
             torch.rand(cap_b, generator=g) < 0.5 for i in range(ncols)]
    pv = [torch.rand(cap_p, generator=g) < 0.8 for _ in probe]
    bv = [torch.rand(cap_b, generator=g) < 0.8 for _ in build]
    uniq = uniq if nk else torch.zeros(1, dtype=torch.int64)
    on = [t.to(dev) for t in (uniq, key, kv)]
    return (on[0], nk, n, on[1], on[2], [key.to(dev)] + [p.to(dev) for p in probe],
            [kv.to(dev)] + [v.to(dev) for v in pv], [b.to(dev) for b in build],
            [v.to(dev) for v in bv])


@pytest.mark.parametrize("key_dtype,cap_p,n,nk,cap_b,ncols", [
    (torch.int64, 256, 200, 60, 256, 3),
    (torch.int64, 4096, 4096, 1, 256, 3),
    (torch.int64, 256, 100, 0, 256, 3),
    (torch.int32, 4096, 3000, 500, 1024, 3),
    (torch.float32, 256, 250, 6, 256, 3),
    (torch.float64, 4096, 4000, 8, 16, 3),
    (torch.int64, 262144, 262144, 102_000, 131072, 3),
    (torch.int64, 4096, 3000, 700, 1024, 20),   # 42 planes: two scatter launches
])
def test_inner_join_kernel(dev, key_dtype, cap_p, n, nk, cap_b, ncols):
    from blaze_tpu_torch.core import kernels as K

    args = _join_case(key_dtype, cap_p, n, nk, cap_b, ncols, cap_p + nk + ncols, dev)
    _equal(K.inner_join_planes_cuda(*args), K.inner_join_planes_plain(*args))


def test_q06_on_the_card_equals_the_cpu(dev):
    import blaze_tpu_torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(2)
    sales = T.Schema.of(("item", T.I64), ("q", T.I64))
    dim = T.Schema.of(("i_item", T.I64), ("cat", T.I64))
    parts = [[{"item": rng.integers(1, 1100, 40_000), "q": rng.integers(1, 100, 40_000)}]
             for _ in range(3)]
    items = [{"i_item": np.arange(1, 1001), "cat": rng.integers(0, 10, 1000)}]
    join = N.BroadcastJoin(N.FFIReader(sales, "sales", 3),
                           N.BroadcastExchange(N.FFIReader(dim, "items", 1)),
                           [(E.Column("item"), E.Column("i_item"))], N.JoinType.INNER,
                           N.JoinSide.RIGHT, "items")
    keys = [("cat", E.Column("cat"))]
    agg = [("qty", E.AggExpr(E.AggFunction.SUM, [E.Column("q")]))]
    partial = N.Agg(join, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in agg])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([E.Column("cat")], 3)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in agg])
    plan = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                  [E.SortOrder(E.Column("cat"))])
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(device=device)
        s.resources["sales"] = lambda p: parts[p]
        s.resources["items"] = lambda p: items
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(plan)
    assert out[None] == out["cpu"]
    assert len(out["cpu"]["cat"]) == 10
    assert cuda_lib.launch_counts()["inner_join_planes"] == 3


@pytest.mark.parametrize("case", [*PROBE_CASES, "q69 partition", "262144 customer keys"])
def test_probe_codes_kernel(dev, case):
    """K9 against its twin on chip_smoke.py's cases: the CPU parity
    tests' (tests/test_torch_generic_joins.py) and q69's shapes."""
    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(9)
    if case == "q69 partition":
        args = customer_probe(rng, dev, 8192, 7100, 359_000, 0.0, 125_000)
    elif case == "262144 customer keys":
        args = customer_probe(rng, dev, 262144, 262144, 1_434_000, 0.04, 500_000)
    else:
        args = probe_case(*case, rng, dev)
    got = K.probe_codes_cuda(*args)
    _equal(got, K.probe_codes_plain(*args))
    assert (got >= 0).any() or args[1] == 0


@pytest.mark.parametrize("build", ["left", "right"])
def test_hash_joins_on_the_card_equal_the_cpu(dev, build):
    """Every join type, as a shuffled hash join with duplicate and null
    keys and a condition, on the card and on the CPU: the generic probe
    (K9) on the card, equal results."""
    import blaze_tpu_torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(4)
    ls = T.Schema.of(("lk", T.I64), ("lv", T.I64))
    rs = T.Schema.of(("rk", T.I64), ("rv", T.I64))

    def side(k, v, hi):
        valid = rng.random(3000) >= 0.1
        return [{k: (np.where(valid, rng.integers(0, hi, 3000), 0), valid),
                 v: rng.integers(0, 100, 3000)} for _ in range(2)]

    tables = {"l": side("lk", "lv", 900), "r": side("rk", "rv", 1200)}
    cond = E.BinaryExpr(E.BinaryOp.GT, E.Column("lv"), E.Column("rv"))
    for jt in N.JoinType:
        plan = N.HashJoin(N.FFIReader(ls, "l", 2), N.FFIReader(rs, "r", 2),
                          [(E.Column("lk"), E.Column("rk"))], jt, N.JoinSide[build.upper()],
                          cond)
        out = {}
        for device in ("cpu", None):
            s = blaze_tpu_torch.Session(device=device)
            for name, parts in tables.items():
                s.resources[name] = lambda p, _parts=parts: [_parts[p]]
            cuda_lib.reset_launch_counts()
            out[device] = s.execute_to_pydict(plan)
        assert out[None] == out["cpu"], jt
        assert cuda_lib.launch_counts()["probe_codes"] == 2


def _seg_route(fn, args_cuda, args_cpu):
    got, want = fn(*args_cuda), fn(*args_cpu)
    assert int(got[0]) == int(want[0])
    _equal([g.cpu() for g in got[1:]], list(want[1:]))
    return got


@pytest.mark.parametrize("case", SEG_CASES, ids=[str(i) for i in range(len(SEG_CASES))])
def test_seg_agg_kernels(dev, case):
    """K10's segmentation and reduction against their plain versions on the
    same planes, and the whole sort route (K5, K10, K6) on the card against
    it on the CPU, partial then merge, both segmentations."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    kinds, cap, n, nulls, key_range = case
    rng = np.random.default_rng(cap + n)
    keys, kvalids, specs, args = seg_case(kinds, cap, n, nulls, key_range, rng)
    dkeys, dvalids, dargs = to_dev(keys, dev), to_dev(kvalids, dev), to_dev(args, dev)
    exists = torch.arange(cap, device=dev) < n
    planes = K._segment_planes(dkeys, dvalids, exists, True)
    order = K.lexsort_indices(K.sort_key_operands(*planes, exists, [(True, True)] *
                                                  len(planes[0])), n)
    starts = K.segment_starts_cuda(*planes, order, n)
    _equal(starts, K.segment_starts_plain(*planes, order, n))
    ops, emits = A._partial_program(specs, dargs)
    _equal(K.segment_reduce_cuda("seg_agg_partial", order, *starts, n, ops, emits),
           K.segment_reduce_plain(order, *starts, n, ops, emits))
    for direct in (True, False):
        outs = _seg_route(A.seg_agg_partial, (dkeys, dvalids, n, specs, dargs, direct),
                          (keys, kvalids, n, specs, args, direct))
    g = int(outs[0])
    if g:
        k = len(kinds)
        mkinds = tuple(sp[0] for sp in specs)
        states = merge_states(outs, k, mkinds, g, rng)
        mk, mv = list(outs[2:2 + 2 * k:2]), list(outs[3:3 + 2 * k:2])
        _seg_route(A.seg_agg_merge, (mk, mv, g, mkinds, states),
                   (to_dev(mk, "cpu"), to_dev(mv, "cpu"), g, mkinds, to_dev(states, "cpu")))


def test_seg_agg_at_the_main_paths_shapes(dev):
    """One q67 batch (262,144 rows, ~223,000 groups) through the partial
    and a merge of 1,000,000 state rows, on the card against the CPU."""
    from blaze_tpu_torch.ops import agg_device as A

    rng = np.random.default_rng(67)
    keys, kvalids, specs, args = q67_batch(rng, dev)
    n = keys[0].shape[0]
    outs = _seg_route(A.seg_agg_partial, (keys, kvalids, n, specs, args),
                      to_dev((keys, kvalids, n, specs, args), "cpu"))
    assert int(outs[0]) > 200_000
    keys, kvalids, kinds, states, n = q67_merge_input(rng, dev, rows=1_000_000,
                                                      groups=150_000, cap=1 << 20)
    _seg_route(A.seg_agg_merge, (keys, kvalids, n, kinds, states),
               to_dev((keys, kvalids, n, kinds, states), "cpu"))


def test_seg_agg_never_runs_its_twin_on_the_card(dev, monkeypatch):
    """On CUDA planes the sort route launches its kernels; the plain
    versions are never called."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A
    from blaze_tpu_torch.utils import cuda_lib

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on CUDA planes")

    for name in ("segment_starts_plain", "segment_reduce_plain", "sort_key_operands_plain",
                 "lexsort_indices_plain", "gather_planes_plain"):
        monkeypatch.setattr(K, name, refuse)
    rng = np.random.default_rng(3)
    keys, kvalids, specs, args = seg_case(("i64", "f64"), 1024, 900, 0.1, (-3, 3), rng)
    keys, kvalids, args = to_dev(keys, dev), to_dev(kvalids, dev), to_dev(args, dev)
    cuda_lib.reset_launch_counts()
    outs = A.seg_agg_partial(keys, kvalids, 900, specs, args)
    g = int(outs[0])
    mk, mv = list(outs[2:6:2]), list(outs[3:7:2])
    A.seg_agg_merge(mk, mv, g, tuple(sp[0] for sp in specs),
                    merge_states(outs, 2, tuple(sp[0] for sp in specs), g, rng))
    counts = cuda_lib.launch_counts()
    assert counts["segment_ids"] == 2 and counts["seg_agg_partial"] == 1
    assert counts["seg_agg_merge"] == 1 and counts["slot_agg_partial"] == 0


def _q67_plan(schema):
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    keys = [("item", E.Column("item")), ("store", E.Column("store"))]
    agg = [("qty", E.AggExpr(E.AggFunction.SUM, [E.Column("q")])),
           ("avg_p", E.AggExpr(E.AggFunction.AVG, [E.Column("p")])),
           ("max_p", E.AggExpr(E.AggFunction.MAX, [E.Column("p")]))]
    partial = N.Agg(N.FFIReader(schema, "src", 3), E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in agg])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([e for _, e in keys], 3)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in agg])
    srt = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                 [E.SortOrder(E.Column("item")), E.SortOrder(E.Column("qty"), ascending=False)])
    win = N.Window(srt, [N.WindowExpr("rank", "rk")], [E.Column("item")],
                   [E.SortOrder(E.Column("qty"), ascending=False)])
    return N.Filter(win, [E.BinaryExpr(E.BinaryOp.LTEQ, E.Column("rk"), E.Literal(3, T.I32))])


@pytest.mark.parametrize("route", ["default", "sort"])
def test_q67_sort_on_the_card_equals_the_cpu(dev, route):
    """q67 with a float64 price column (AVG and MAX of it beside the
    quantity sum), on the card and on the CPU: with the slot routes off
    every aggregate sorts (K10); on the default route the float states
    still take K10 (in the slot order), never K3's atomics."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(2)
    schema = T.Schema.of(("item", T.I64), ("store", T.I64), ("q", T.I64), ("p", T.F64))
    parts = [[{"item": rng.integers(1, 300, 40_000), "store": rng.integers(1, 50, 40_000),
               "q": rng.integers(1, 5, 40_000),
               "p": np.round(rng.random(40_000) * 100, 2)}] for _ in range(3)]
    conf = Config(batch_size=4096) if route == "default" else \
        Config(batch_size=4096, dense_agg=False, radix_agg=False)
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(conf, device=device)
        s.resources["src"] = lambda p: parts[p]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(_q67_plan(schema))
    assert len(out["cpu"]["rk"]) > 300
    assert out[None] == out["cpu"]
    counts = cuda_lib.launch_counts()
    assert counts["seg_agg_partial"] > 0 and counts["seg_agg_merge"] > 0
    assert counts["slot_agg_partial"] == counts["slot_agg_merge"] == 0


def _fused_case_names():
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    return [name for name, _s, _st in fused_cases(E, T)]


@pytest.mark.parametrize("case", _fused_case_names())
def test_fused_chain_kernel(dev, case):
    """K11 (and K1 after it) against the plain version on the same CUDA
    planes, bit for bit, at every battery capacity; subnormals included."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_cuda
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    _, schema, steps = next(c for c in fused_cases(E, T) if c[0] == case)
    kern = FusedKernel(schema, steps)
    rng = np.random.default_rng(len(case))
    for cap, n in FUSED_CAPS:
        datas, valids = fused_planes(cap, n, rng)
        datas = [torch.from_numpy(x).to(dev) for x in datas]
        valids = [torch.from_numpy(x).to(dev) for x in valids]
        _equal([x.cpu() for x in fused_flat(fused_chain_cuda(kern, datas, valids, n))],
               [x.cpu() for x in fused_flat(K.fused_chain_plain(schema, steps, datas,
                                                                valids, n))])


def test_fused_chain_failures_raise_and_never_take_the_twin(dev, monkeypatch):
    """A source that does not import, or that Triton cannot compile, raises
    from the call; on CUDA planes the plain version is never called."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on CUDA planes")

    monkeypatch.setattr(K, "fused_chain_plain", refuse)
    _, schema, steps = fused_cases(E, T)[0]
    datas, valids = fused_planes(256, 200, np.random.default_rng(0))
    datas = [torch.from_numpy(x).to(dev) for x in datas]
    valids = [torch.from_numpy(x).to(dev) for x in valids]
    groups, counts = K.fused_chain(schema, steps, datas, valids, 200)
    assert int(counts[0]) <= 200
    broken = FusedKernel(schema, steps)
    broken.source = "def fused_chain(:\n"
    with pytest.raises(SyntaxError):
        K.fused_chain(schema, steps, datas, valids, 200, kernel=broken)
    bad = FusedKernel(schema, steps)
    bad.source = bad.source.replace("    inb = offs < cap", "    inb = offs < no_such_name")
    with pytest.raises(Exception, match="no_such_name"):
        K.fused_chain(schema, steps, datas, valids, 200, kernel=bad)
    good = FusedKernel(schema, steps)
    K.fused_chain(schema, steps, datas, valids, 200, kernel=good)


def test_decimal_to_double_divides_on_the_card(dev):
    """A decimal compared with a double converts as unscaled / 10^scale,
    divided exactly as on the CPU and in the JAX package: 0.35 (decimal)
    equals 0.35 (double) on the card too. CUDA torch's division by a
    Python scalar multiplies by its reciprocal (35 * 0.01 is
    0.35000000000000003), which the port no longer uses."""
    from blaze_tpu_torch.core.batch import ColumnarBatch
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    schema = T.Schema.of(("m", T.DecimalType(9, 2)))
    unscaled = np.arange(1, 100_000)
    pred = E.BinaryExpr(E.BinaryOp.EQ, E.Column("m"), E.Literal(0.35, T.F64))
    out = {}
    for where in ("cpu", dev):
        batch = ColumnarBatch.from_numpy(schema, {"m": unscaled}, torch.device(where))
        out[str(where)] = ExprEvaluator([pred], schema).evaluate_predicate(batch).cpu()
    assert out["cpu"][34] and int(out["cpu"].sum()) == 1
    _equal(out[str(dev)], out["cpu"])


@pytest.mark.parametrize("case", UPD_CASES, ids=[c[0] for c in UPD_CASES])
def test_slot_update_kernel(dev, case):
    """K12 against its plain version on the same CUDA tables: every
    aggregate of the host table in the case's mode, subnormals included."""
    from blaze_tpu_torch.core import kernels as K

    data = upd_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    fns = upd_fns()
    want = upd_run(data, fns, K.slot_update_plain, dev)
    _equal(upd_run(data, fns, K.slot_update_cuda, dev), want)
    _equal(upd_run(data, fns, K.slot_update_cuda, dev, packed=True), want)


def test_slot_update_float_sum_folds_in_row_order(dev):
    """1e16, 1.0, -1e16, 1.0 into one slot over two batches, with other
    slots' rows between them: the fold starts from the slot's value and
    follows the rows' order, so the first 1.0 is lost, on every run."""
    from blaze_tpu_torch.core import kernels as K

    slots = torch.tensor([0, 5, 0, 7], device=dev)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    tables = []
    for _ in range(3):
        t = torch.zeros(8, dtype=torch.float64, device=dev)
        for vals in ([1e16, 2.0, 1.0, 3.0], [-1e16, 2.0, 1.0, 3.0]):
            src = torch.tensor(vals, dtype=torch.float64, device=dev)
            K.slot_update_cuda(slots, mask, [K.SlotUpdate(K.UPD_ADD, t, src)])
        tables.append(t.cpu())
    assert tables[0].tolist() == [1.0, 0, 0, 0, 0, 4.0, 0, 6.0]
    assert all(torch.equal(t.view(torch.int64), tables[0].view(torch.int64)) for t in tables)


def test_slot_update_at_the_main_paths_shape(dev):
    """A q67_table merge batch (262,144 state rows into ~200,000 slots)."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import aggfns

    slots, live, s, has = q67_table_merge_batch(np.random.default_rng(67), dev)
    fn = aggfns.create_agg_function(E.AggExpr(E.AggFunction.SUM, [E.Column("v")]),
                                    T.Schema.of(("v", T.I64)))
    cols = [DeviceColumn(T.I64, s, has), DeviceColumn(T.BOOL, has, live)]
    states = []
    for update in (K.slot_update_cuda, K.slot_update_plain):
        st = fn.init_state(262144, dev)
        update(slots, live, fn.merge_ops(st, cols))
        states.append(st)
    _equal(states[0], states[1])


def test_q96_on_the_card_equals_the_cpu(dev, monkeypatch):
    """chip_smoke.py's q96 at 300,000 store_sales rows on the card and on
    the CPU: the same count as numpy; K12 launched on every joined batch
    of the partial and once in the final; its plain version never ran."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    host = q96_host(dict(Q96_ROWS, store_sales=300_000))
    schemas = q96_schemas(T)
    plan = q96_plan(schemas, E, N, T, parts=3)
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=8192), device=device)
        for name, (cols, valids) in host.items():
            valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
            n = len(cols[0])
            cuts = [n * p // 3 for p in range(4)] if name == "store_sales" else [0, n]
            parts = [[{f.name: (c[a:b], v[a:b])
                       for f, c, v in zip(schemas[name].fields, cols, valids)}]
                     for a, b in zip(cuts, cuts[1:])]
            s.resources[name] = lambda p, _parts=parts: _parts[p]
        if device is None:
            monkeypatch.setattr(K, "slot_update_plain", None)
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(plan)
    assert out[None] == out["cpu"] == q96_oracle(host)
    assert cuda_lib.launch_counts()["slot_update"] >= 4
