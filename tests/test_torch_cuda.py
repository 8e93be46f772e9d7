"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, and the q01, q67 (on both aggregation routes), q06, q96,
q89, q17, q98, sort10M and hash_sample paths, every hash-join type, an
explicit-frame window, the scalar functions, the bloom runtime filter
and a plan on the device mesh (1, 2 and 8 slots) on the card against the
same plans and expressions on the CPU; K18, the fused aggregate input,
on its battery; K19, the passthrough of a skipped partial, on its
battery and cust_spend at a small scale. K9's to K19's cases come from
chip_smoke.py.

Marked ``cuda``: each test skips here (no GPU) and runs on a machine with
one, where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer, bool and int64-backed decimal planes, and
float sort keys compared bit for bit).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BLOOM_CASES, FUSED_CAPS, GATHER_CASES, K17_EDGE_CASES, K18_CASES,
                        MESH_CASES, PASS_CASES, PROBE_CASES,
                        SEG_FLOATS, SPLIT_CASES, dead_rows_case, gather_case,
                        k3_plan_growth_check, k6_shapes, split_case,
                        Q89_ROWS, cust_spend_batch, cust_spend_host, cust_spend_oracle,
                        narrow_plane, wide_plane,
                        cust_spend_plan, cust_spend_schema, pass_case, pass_inputs,
                        Q96_ROWS, Q98_ROWS, k18_case, k18_flat, k18_torch,
                        RANGE_CASES, SCAN_CASES, SEG_CASES, SEG_LENGTHS, SEG_PROGRAMS,
                        SORT10M_COLUMNS, UPD_CASES, WIDE_CASES,
                        WIDE_UPD_CASES, XXH_CASES, XXH_HASH_SAMPLE, bloom_case, bloom_np_probe,
                        customer_probe, range_routes, range_tensors, xxh_spark_doc,
                        doubled, fused_cases,
                        fused_flat, hash_sample_host, hash_sample_oracle, hash_sample_plan,
                        hash_sample_schema, xxh64_np, xxh_case, fused_schema,
                        fused_planes, merge_states, one_nan, probe_case, q17_oracle, q17_plan,
                        q67_batch, q67_merge_input, q67_table_merge_batch, q89_host,
                        q89_oracle, q89_plan, q89_schemas, q96_host, q96_oracle, q96_plan,
                        q96_schemas, q98_host, q98_oracle, q98_plan, q98_schemas, range_case,
                        range_run, scan_case, scan_run, seg_case, seg_fold_order_case,
                        seg_length_check, slot_case, slot_switch_check, sort10m_collect,
                        sort10m_host, sort10m_oracle, sort10m_plan, sort10m_schema, to_dev,
                        upd_case, upd_fns, upd_run, wide_case, wide_states, wide_torch,
                        wide_upd_case, wide_upd_fns, wide_upd_run)

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


@pytest.mark.parametrize("cap,n", [(4096, 1023), (4096, 1024), (4096, 1025), (1023, 1023),
                                   (1024, 1024), (1025, 1025), (10000, 6143)])
def test_compact_planes_tile_edges_kernel(dev, cap, n):
    """K1 at a 1,024-row tile's edges (live rows one below, at and one above
    a tile, the mask longer than the live rows), with planes of every
    element size, more than 128 planes (the table in device memory) and a
    mask that is not 16-byte aligned, against its plain version; one launch
    a call."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    g = torch.Generator(device="cpu").manual_seed(cap * 7 + n)
    datas = [torch.randint(-2**40, 2**40, (cap,), generator=g),
             torch.randint(-2**20, 2**20, (cap,), generator=g).to(torch.int32),
             torch.randint(-2**14, 2**14, (cap,), generator=g).to(torch.int16),
             torch.randint(-100, 100, (cap,), generator=g).to(torch.int8)]
    valids = [torch.rand(cap, generator=g) < 0.8 for _ in datas]
    mask = (torch.rand(cap, generator=g) < 0.6) & (torch.arange(cap) < n)
    for planes in (1, 40):
        args = ([d.to(dev) for d in datas] * planes, [v.to(dev) for v in valids] * planes,
                mask.to(dev))
        before = cuda_lib.launch_counts()["compact_planes"]
        _equal(K.compact_planes_cuda(*args), K.compact_planes_plain(*args))
        assert cuda_lib.launch_counts()["compact_planes"] == before + 1
    odd = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    odd[1:] = mask.to(dev)
    args = ([d.to(dev) for d in datas], [v.to(dev) for v in valids])
    _equal(K.compact_planes_cuda(*args, odd[1:]), K.compact_planes_plain(*args, mask.to(dev)))


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


@pytest.mark.parametrize("n", [1, 3, 4, 5, 255, 1023, 262145])
@pytest.mark.parametrize("k", [1, 2, 8, 32])
def test_murmur3_pmod_native_widths_kernel(dev, n, k):
    """K2 against its twin with every element size read at its own width
    (bool, int8, int16, int32, int64 in turn), the planes views at element
    offsets 0, 1 and 2 (odd addresses: the scalar loads), tails of 1 to 3
    rows, 1 to 32 columns, with and without the hash output."""
    from blaze_tpu_torch.exprs import spark_hash as H
    from chip_smoke import k2_case

    kinds = tuple(("bool", "i8", "i16", "i32", "i64")[c % 5] for c in range(k))
    words, valids, hkinds = [], [], []
    rng = np.random.default_rng(n * 64 + k)
    for c, kind in enumerate(kinds):
        w, v, hk, _n, _p = k2_case((n, (kind,), 0.2, c % 3, ()), rng, dev)
        words += w
        valids += v
        hkinds += hk
    for nparts in (1, 4, 7, 200):
        want = H.murmur3_pmod_plain(words, valids, hkinds, n, nparts)
        _equal(H.murmur3_pmod_cuda(words, valids, hkinds, n, nparts), want)
        got = H.murmur3_pmod_cuda(words, valids, hkinds, n, nparts, False)
        assert got[0] is None
        _equal(got[1], want[1])


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
    # every kernel but the joins', the sort route's, K1, K11, the host
    # table's K12, the window aggregates' K13, the range exchange's K14,
    # the xxhash64 function's K15, the bloom probe's K16, the mesh's K17
    # and stacked K11 and the skipped partial's K19, which q01 does not
    # reach (its filter fuses into the partial aggregate: K18 once a batch,
    # no K1 and no fused stage; both aggregates take the slot route; it has
    # no window, no range exchange, no xxhash64, no runtime filter, no mesh
    # and no partial skipping); nor K7's slice: its hash exchange's
    # bucketize, its only slicer, is one K7 split a batch
    counts = cuda_lib.launch_counts()
    assert counts["fused_agg_input"] == 3 and counts["compact_planes"] == 0
    assert counts["split_planes"] == 3
    zero = [k for k, v in counts.items() if v <= 0 and k not in (
        "inner_join_planes", "probe_codes", "segment_ids", "seg_agg_partial",
        "seg_agg_merge", "fused_chain", "slot_update", "segment_scan", "range_partition",
        "xxhash64", "bloom_probe", "mesh_all_to_all", "fused_chain_stacked",
        "compact_planes", "passthrough_states", "slice_planes")]
    assert not zero, counts


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


@pytest.mark.parametrize("case", [False, True, *GATHER_CASES],
                         ids=["False", "True", *[c[0] for c in GATHER_CASES]])
def test_gather_kernel(dev, case):
    """K6 against its plain version: two batches' planes at mixed
    capacities, plain and masked, then chip_smoke.py's battery (every
    element size in one call, 33 planes, no row, a masked take, out_cap
    above n_out with mixed source capacities, an index that is not 16-byte
    aligned, an out_cap that is not a multiple of four)."""
    from blaze_tpu_torch.core import kernels as K

    if isinstance(case, tuple):
        args = gather_case(case, np.random.default_rng(len(case[0])), dev)
        _equal(K.gather_planes_cuda(*args), K.gather_planes_plain(*args))
        return
    masked = case
    g = torch.Generator(device="cpu").manual_seed(int(masked))
    datas = [torch.randint(-2**40, 2**40, (4096,), generator=g),
             torch.randint(-100, 100, (1024,), generator=g).to(torch.int32)]
    valids = [torch.rand(4096, generator=g) < 0.8, torch.rand(1024, generator=g) < 0.8]
    idx = torch.randint(0, 3000, (2500,), generator=g).to(dev)
    live = (torch.rand(2500, generator=g) < 0.7).to(dev) if masked else None
    args = ([d.to(dev) for d in datas], [v.to(dev) for v in valids], idx, 4096, 2500, live)
    _equal(K.gather_planes_cuda(*args), K.gather_planes_plain(*args))


def test_gather_kernel_at_the_main_paths_takes(dev):
    """K6 at the q67 sort's take, a sort10M reducer's and the sort route's
    key take, against its plain version; the output planes are 16-byte
    aligned, and a plane passed three times (sort10M's wide validity) is
    gathered once."""
    from blaze_tpu_torch.core import kernels as K

    for label, datas, valids, idx, cap, n in k6_shapes(dev, np.random.default_rng(6)):
        got = K.gather_planes_cuda(datas, valids, idx, cap, n)
        _equal(got, K.gather_planes_plain(datas, valids, idx, cap, n))
        assert all(p.data_ptr() % 16 == 0 for p in got[0] + got[1])
        if label.startswith("sort10M"):
            assert got[1][4] is got[1][5] is got[1][6]


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


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[str(c) for c in SPLIT_CASES])
def test_split_planes_kernel(dev, case):
    """K7's split form against its twin at the bucketize shapes and edges
    (an empty partition, one row, more than 64 and 256 partitions, uneven
    source capacities, more than 32 planes)."""
    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(sum(case))
    datas, valids, order, counts, caps = split_case(*case, rng, dev)
    got = K.split_planes_cuda(datas, valids, order, counts, caps)
    want = K.split_planes_plain(datas, valids, order, counts, caps)
    assert [x is None for x in got] == [c == 0 for c in counts]
    _equal([x for x in got if x], [x for x in want if x])


@pytest.mark.parametrize("nparts", [2, 32, 300])
def test_bucketize_is_one_sort_and_one_split(dev, nparts):
    """``Repartitioner.bucketize`` of a CUDA batch into more than one
    partition: one K5 launch, one K7 split, no K6 and no K7 slice; the
    partitions equal the CPU's, padding and validity included."""
    from blaze_tpu_torch.core.batch import ColumnarBatch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops.shuffle.repartitioner import HashPartitioner
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(nparts)
    schema = T.Schema.of(("k", T.I64), ("v", T.I32), ("b", T.BOOL))
    n = 5000
    cols = {"k": (rng.integers(0, 1000, n), rng.random(n) > 0.1),
            "v": (rng.integers(-99, 99, n).astype(np.int32), rng.random(n) > 0.2),
            "b": (rng.random(n) < 0.5, None)}
    cuda_lib.reset_launch_counts()
    got = HashPartitioner([E.Column("k")], nparts, schema).bucketize(
        ColumnarBatch.from_numpy(schema, cols, dev))
    counts = cuda_lib.launch_counts()
    assert counts["lexsort_indices"] == 1 and counts["split_planes"] == 1
    assert counts["gather_planes"] == 0 and counts["slice_planes"] == 0
    want = HashPartitioner([E.Column("k")], nparts, schema).bucketize(
        ColumnarBatch.from_numpy(schema, cols, torch.device("cpu")))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 1
    for (_, a), (_, b) in zip(got, want):
        assert a.num_rows == b.num_rows and a.capacity == b.capacity
        for ca, cb in zip(a.columns, b.columns):
            _equal([ca.data.cpu(), ca.validity.cpu()], [cb.data, cb.validity])


def test_sort_makes_no_host_sync_and_bucketize_one(dev):
    """K5's wrapper copies nothing to the host: under
    ``set_sync_debug_mode("error")`` any ``.cpu()``, ``.item()`` or
    ``.tolist()`` inside it fails. The pid sort with its counts and the
    split sync nowhere either; bucketize's one sync is the counts pull."""
    import warnings

    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(5)
    ops = dead_rows_case(rng, dev, 262144, 262144, 0.5)
    pids = torch.from_numpy(rng.integers(0, 32, 262144).astype(np.int32)).to(dev)
    datas, valids, order, counts, caps = split_case(262144, 32, 3, 262144, rng, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.lexsort_indices_cuda(ops, 262144, dead_last=True)
        got_all = K.lexsort_indices_cuda(ops)
        porder, pcounts = K.partition_order(pids, 32)
        K.split_planes_cuda(datas, valids, order, counts, caps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _equal(got, K.lexsort_indices_plain(ops, 262144, dead_last=True))
    _equal(got_all, K.lexsort_indices_plain(ops))
    _equal([porder, pcounts], [K.lexsort_indices_plain([pids]),
                               torch.bincount(pids.to(torch.int64), minlength=32)])
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            porder, pcounts = K.partition_order(pids, 32)
            host = pcounts.tolist()
            K.split_planes_cuda(datas, valids, porder, host, [16384] * 32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len([w for w in caught if "synchroniz" in str(w.message)]) == 1


@pytest.mark.parametrize("cap,n,share", [(262144, 262144, 0.25), (4096, 3000, 0.0),
                                         (4096, 3000, 0.0004), (1 << 20, 797_601, 0.9)])
def test_key_sort_dead_rows_kernel(dev, cap, n, share):
    """Rank-6 rows (a fused aggregate's dead rows) among live ones: the
    kernel leaves them out of its passes and puts them last in row order,
    as the sort of every row does."""
    from blaze_tpu_torch.core import kernels as K

    ops = dead_rows_case(np.random.default_rng(cap + n), dev, cap, n, share)
    for rows in (n, None):
        _equal(K.lexsort_indices_cuda(ops, rows, dead_last=True),
               K.lexsort_indices_plain(ops, rows))


def test_slot_plan_output_grows_with_the_batch_on_the_card(dev):
    """ROADMAP.md Queue 3's fixed fault on the card: a slot plan made on a
    100-row batch and kept for a 1,024-row batch of 1,000 groups. K3
    writes nothing past its planes (64 guard rows each) and the groups
    are the numpy oracle's."""
    assert "untouched" in k3_plan_growth_check(dev)


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
    from blaze_tpu_torch.ops.joins import keymap as KM

    g = torch.Generator(device="cpu").manual_seed(seed)
    if key_dtype.is_floating_point:
        pool = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.5,
                             -2.5, 3.0, 1e30], dtype=key_dtype)
        nans = torch.tensor([0x7FF8000000000123, -0x0008000000000000],
                            dtype=torch.int64).view(torch.float64).to(key_dtype)
        pool = torch.cat([pool, nans])
        words = torch.unique(KM.canon_words(pool))
        uniq = words[torch.randperm(len(words), generator=g)[:nk]].sort().values
    else:
        keys = (torch.randperm(3 * nk + 64, generator=g)[:nk] - nk).to(key_dtype)
        misses = torch.randint(-4 * nk - 64, 4 * nk + 64, (64,), generator=g)
        pool = torch.cat([keys, misses.to(key_dtype)])
        uniq = torch.unique(KM.canon_words(keys))
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
    (torch.int64, 4096, 3000, 700, 1024, 20),   # 82 planes in one launch
    (torch.int64, 4096, 3000, 700, 1024, 32),   # 130 planes: two launches
    (torch.float64, 20_000, 19_000, 8, 16, 70),  # 282 planes: three, the last all build
])
def test_inner_join_kernel(dev, key_dtype, cap_p, n, nk, cap_b, ncols):
    """K8 through a pack against the plain version, one launch for each
    128 planes."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    args = _join_case(key_dtype, cap_p, n, nk, cap_b, ncols, cap_p + nk + ncols, dev)
    before = cuda_lib.LAUNCHES["inner_join_planes"]
    _equal(_k8(args), K.inner_join_planes_plain(*args))
    planes = sum(len(p) for p in args[5:])
    assert cuda_lib.LAUNCHES["inner_join_planes"] - before == -(-planes // 128)


def _k8(args, search=False, pack=None):
    """K8 on the plain version's ``args`` through ``pack``, or a pack made
    for the call (the route from the words, or the search forced)."""
    from blaze_tpu_torch.core import kernels as K

    uniq, nk, _n, _k, _v, _pd, _pv, bd, bv = args
    pack = pack or K.JoinPack(uniq, uniq[:nk].cpu().numpy(), bd, bv, search)
    return K.inner_join_planes_cuda(pack, *args[2:7])


def _dense_join_case(lo, nk, gap, cap_p, n, cap_b, seed, dev):
    """K8's arguments over the build keys lo .. lo + nk (one of them left
    out when ``gap``), negative ones included where lo < 0; probe keys
    on both sides of the range, 10% null, rows past ``n`` padding."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    keys = torch.arange(lo, lo + nk + (1 if gap else 0), dtype=torch.int64)
    if gap:
        keys = torch.cat([keys[:nk // 2], keys[nk // 2 + 1:]])
    key = torch.randint(lo - nk, lo + 2 * nk, (cap_p,), generator=g)
    kv = (torch.rand(cap_p, generator=g) < 0.9) & (torch.arange(cap_p) < n)
    key = torch.where(kv, key, 0)
    pay = torch.randint(-2**40, 2**40, (cap_p,), generator=g)
    bpay = torch.zeros(cap_b, dtype=torch.int64)
    bpay[:nk] = torch.randint(-2**40, 2**40, (nk,), generator=g)
    live_b = torch.arange(cap_b) < nk
    bkey = torch.zeros(cap_b, dtype=torch.int64)
    bkey[:nk] = keys
    on = lambda ts: [t.to(dev) for t in ts]  # noqa: E731
    return (keys.to(dev), nk, n, key.to(dev), kv.to(dev), on([key, pay]), on([kv, kv]),
            on([bkey, bpay]), on([live_b, live_b]))


@pytest.mark.parametrize("lo,nk,gap,cap_p,n", [
    (-50, 100, False, 4096, 3000),        # dense, negative keys
    (-50, 100, True, 4096, 3000),         # one gap: the search route only
    (73_800, 1800, False, 262144, 232_116),  # q96's time_dim probe
    (1, 5000, True, 20_000, 19_999),      # past the 4,096-word shared top
    (7, 1, False, 256, 256),              # one key
])
def test_inner_join_kernel_routes(dev, lo, nk, gap, cap_p, n):
    """K8 on its dense route (only where the words are dense) and on its
    search route, each against the plain version, through one pack kept
    over three batches (the launch tags and the tickets' counter carry
    over)."""
    from blaze_tpu_torch.core import kernels as K

    args = _dense_join_case(lo, nk, gap, cap_p, n, max(nk, 256), lo + nk, dev)
    want = K.inner_join_planes_plain(*args)
    packs = {search: K.JoinPack(args[0], args[0].cpu().numpy(), args[7], args[8], search)
             for search in (False, True)}
    assert packs[False].dense == (not gap) and not packs[True].dense
    for pack in packs.values():
        for _ in range(3):
            _equal(_k8(args, pack=pack), want)


def test_inner_join_q96_probes(dev):
    """chip_smoke.py's three q96 probes (each the last one's output) on
    both routes where the words are dense, and q69's date probe."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops.joins.keymap import dense_key_words
    from chip_smoke import q69_dates_probe, q96_join_probes

    probes = q96_join_probes(dev) + [q69_dates_probe(dev, np.random.default_rng(69))]
    assert [dense_key_words(w) for _label, _a, w in probes] == [True, False, False, True]
    for _label, args, words in probes:
        want = K.inner_join_planes_plain(*args)
        for search in {True, not dense_key_words(words)}:
            _equal(_k8(args, search), want)


def _device_kernels(fn, calls=5):
    """The device kernels and memsets that ``calls`` calls of ``fn`` run
    (torch.profiler): {name: launches}. The profiler can keep none of a
    window's kernels: a window that recorded nothing is taken again (three
    at most)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if names:
            break
    return names


def test_inner_join_is_one_launch(dev):
    """A probe batch is one kernel and no memset, at q96's first probe
    (where 98% of the output is padding)."""
    from blaze_tpu_torch.core import kernels as K
    from chip_smoke import q96_join_probes

    _label, args, words = q96_join_probes(dev)[0]
    pack = K.JoinPack(args[0], words, args[7], args[8])
    assert pack.dense
    names = _device_kernels(lambda: _k8(args, pack=pack))
    assert len(names) == 1 and next(iter(names)).startswith("blz_inner_join_kernel"), names
    assert next(iter(names.values())) <= 5


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
    from blaze_tpu_torch.config import Config

    # the join fuses into the partial aggregate by default (K18 once a
    # probe batch); with fused_filter_agg=False it runs through K8
    for fused in (None, False):
        out = {}
        for device in ("cpu", None):
            s = blaze_tpu_torch.Session(Config(fused_filter_agg=fused), device=device)
            s.resources["sales"] = lambda p: parts[p]
            s.resources["items"] = lambda p: items
            cuda_lib.reset_launch_counts()
            out[device] = s.execute_to_pydict(plan)
        assert out[None] == out["cpu"]
        assert len(out["cpu"]["cat"]) == 10
        counts = cuda_lib.launch_counts()
        assert (counts["inner_join_planes"], counts["fused_agg_input"]) == \
            ((0, 3) if fused is None else (3, 0))


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
    for direct in (False, True):
        planes = K._segment_planes(dkeys, dvalids, exists, direct)
        order = K.lexsort_indices(K.sort_key_operands(*planes, exists, [(True, True)] *
                                                      len(planes[0])), n)
        got = K.segment_keys_cuda(*planes, order, n, dkeys, dvalids)
        _equal(got, K.segment_keys_plain(*planes, order, n, dkeys, dvalids))
    ops, emits = A._partial_program(specs, dargs)
    _equal(K.segment_reduce_cuda("seg_agg_partial", order, *got[:2], n, ops, emits),
           K.segment_reduce_plain(order, *got[:2], n, ops, emits))
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

    for name in ("segment_starts_plain", "segment_keys_plain", "segment_reduce_plain",
                 "sort_key_operands_plain", "lexsort_indices_plain", "gather_planes_plain"):
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
    # the segmentation emits each group's keys: no K6 take on the route
    assert counts["gather_planes"] == 0


# K10's segmentation: (label, key kinds, cap, n, live rows (None: n),
# direct, values: "random" (integers over about sqrt(cap) values, floats
# over SEG_FLOATS, 10% null), "one" (one segment
# across every tile), "unique" (every row a segment))
SEGK_CASES = (
    ("one row", ("i64",), 256, 1, None, False, "random"),
    ("2,047 rows", ("i64", "i32"), 4096, 2047, None, False, "random"),
    ("2,048 rows", ("i64", "i32"), 2048, 2048, None, False, "random"),
    ("2,049 rows", ("i64", "i32"), 4096, 2049, None, False, "random"),
    ("several tiles", ("i64", "f64"), 16384, 15000, None, False, "random"),
    ("q67_sort batch", ("i64", "i64"), 262144, 262144, None, False, "random"),
    ("one segment", ("i64", "i32"), 16384, 16000, None, False, "one"),
    ("every row a segment", ("i64",), 16384, 16384, None, False, "unique"),
    ("NaN, -0.0, 0.0 and null keys", ("f64", "f32"), 8192, 8000, None, False, "random"),
    ("int8, int16, int32, float32, bool", ("i8", "i16", "i32", "f32", "bool"), 8192, 7000,
     None, False, "random"),
    ("16 keys", ("i64", "i32", "i8", "f64", "bool", "i16", "i64", "f32") * 2, 8192, 8192,
     None, False, "random"),
    ("direct, int32", ("i32",), 8192, 8000, None, True, "random"),
    ("direct, int32, one segment", ("i32",), 8192, 8000, None, True, "one"),
    ("live rows below num_rows", ("i64", "i32"), 8192, 8000, 5000, False, "random"),
    ("four positions a thread", ("i64", "i32"), 1 << 21, 1_500_000, None, False, "random"),
    ("four positions a thread, five keys", ("i64", "i32", "f64", "i8", "bool"), 1 << 21,
     1 << 21, None, False, "random"),
    ("four positions a thread, live rows", ("i64",), 1 << 21, 2_000_000, 1_100_000, False,
     "random"),
    ("no row", ("i64",), 256, 0, None, False, "random"),
)


def _segk_planes(case, rng, dev):
    """(keys, validities, exists, num_rows, live_rows) of a SEGK_CASES
    entry; the validities are masked with exists."""
    _label, kinds, cap, n, live_rows, direct, values = case
    if live_rows is None:
        exists = np.arange(cap) < n
    else:
        exists = np.zeros(cap, bool)
        exists[rng.choice(n, live_rows, replace=False)] = True
    dtypes = {"i8": np.int8, "i16": np.int16, "i32": np.int32, "i64": np.int64,
              "f32": np.float32, "f64": np.float64, "bool": np.bool_}
    keys, valids = [], []
    for j, kind in enumerate(kinds):
        dt = dtypes[kind]
        if values == "one":
            d, v = np.full(cap, 7, dt), np.ones(cap, bool)
        elif values == "unique" and j == 0:
            d, v = rng.permutation(cap).astype(dt), np.ones(cap, bool)
        elif kind.startswith("f"):
            with np.errstate(over="ignore"):
                d = np.array(SEG_FLOATS, dt)[rng.integers(0, len(SEG_FLOATS), cap)]
            v = rng.random(cap) >= 0.1
        elif kind == "bool":
            d, v = rng.random(cap) < 0.5, rng.random(cap) >= 0.1
        else:  # about cap distinct pairs of two such keys; [0, cap - 1) when direct
            hi = 100 if kind == "i8" else max(6, int(cap ** 0.5))
            lo = 0 if direct else -hi // 2
            d, v = rng.integers(lo, lo + hi, cap).astype(dt), rng.random(cap) >= 0.1
        v &= exists
        keys.append(torch.from_numpy(np.where(v, d, np.zeros((), dt))).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    return keys, valids, torch.from_numpy(exists).to(dev), n, live_rows


@pytest.mark.parametrize("case", SEGK_CASES, ids=[c[0] for c in SEGK_CASES])
def test_segment_keys_kernel(dev, case):
    """K10's segmentation (one launch: the starts and each segment's keys
    from its first row) against its plain version, on the order K5 gives
    the planes it compares; the count where the case fixes it."""
    from blaze_tpu_torch.core import kernels as K

    keys, valids, exists, n, live_rows = _segk_planes(case, np.random.default_rng(len(case[0])),
                                                      dev)
    planes = K._segment_planes(keys, valids, exists, case[5])
    order = K.lexsort_indices(K.sort_key_operands(*planes, exists,
                                                  [(True, True)] * len(planes[0])),
                              n, dead_last=True)
    rows = n if live_rows is None else live_rows
    got = K.segment_keys_cuda(*planes, order, rows, keys, valids)
    want = K.segment_keys_plain(*[[p.cpu() for p in ps] for ps in planes], order.cpu(), rows,
                                [k.cpu() for k in keys], [v.cpu() for v in valids])
    _equal([g.cpu() for g in got[:2]], list(want[:2]))
    _equal([[p.cpu() for p in ps] for ps in got[2:]], list(want[2:]))
    if case[6] == "one" and rows:
        assert int(got[1]) == 1
    if case[6] == "unique":
        assert int(got[1]) == rows


def test_segment_keys_across_calls_of_every_size(dev):
    """Calls of every size on one scratch, growing and shrinking: each
    equals its plain version (the look-back words of an earlier call, under
    another tag, are never read as this call's)."""
    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(11)
    for cap, n in ((256, 200), (65536, 65536), (4096, 3000), (262144, 100_000), (256, 0),
                   (16384, 16383)):
        keys = [torch.from_numpy(rng.integers(0, 50, cap)).to(dev)]
        valids = [torch.from_numpy(np.arange(cap) < n).to(dev)]
        exists = valids[0].clone()
        order = K.lexsort_indices(K.sort_key_operands(keys, valids, exists, [(True, True)]), n)
        got = K.segment_keys_cuda(keys, valids, order, n, keys, valids)
        _equal(got, K.segment_keys_plain(keys, valids, order, n, keys, valids))


# -- K10's reduction and K3/K4 where their designs branch -------------------------


@pytest.mark.parametrize("prog", SEG_PROGRAMS)
@pytest.mark.parametrize("length", SEG_LENGTHS)
def test_seg_reduce_at_every_segment_length(dev, length, prog):
    """K10's reduction, partial then a merge, against its plain version bit
    for bit with segments of 1, 31, 32, 33, 524, 2,048, 2,049 and 4,096
    rows and one of 262,144 (a thread, a warp, a warp a piece): int64,
    int32, float64 and float32 arguments with NaN, +-0.0, +-inf and
    subnormals, 10% nulls, or every limb kind."""
    seg_length_check(length, prog, np.random.default_rng(length), dev,
                     lambda _name, _label, got, want: _equal(got, want))


@pytest.mark.parametrize("length", [20, 100, 5000])
def test_seg_reduce_float_sum_is_the_left_fold(dev, length):
    """A float SUM whose value depends on the order of its adds (1.0 as a
    sequential fold, another value pairwise or lane by lane) equals the
    left fold in sorted order: folded by one thread, by one warp, and by
    one warp after three pieces were folded apart."""
    from blaze_tpu_torch.core import kernels as K

    args, fold = seg_fold_order_case(length, dev)
    got = K.segment_reduce_cuda("seg_agg_partial", *args)
    _equal(got, K.segment_reduce_plain(*args))
    assert got[0][0][0].item() == fold == 1.0


@pytest.mark.parametrize("cap,n,length", [(4096, 4096, 33), (262144, 262144, 262144),
                                          (256, 1, 1)])
def test_seg_reduce_every_value_null_and_one_row(dev, cap, n, length):
    """Every argument null (segments of 33 rows, and one of 262,144), and a
    batch of one row, against the plain version."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    rng = np.random.default_rng(cap + n)
    keys, kvalids, specs, args = seg_case(("i64",), cap, n, 1.0 if n > 1 else 0.0, (0, 1), rng)
    keys = [(torch.arange(cap) // length).to(dev)]
    kvalids = [(torch.arange(cap) < n).to(dev)]
    args = to_dev(args, dev)
    exists = torch.arange(cap, device=dev) < n
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
    ops, emits = A._partial_program(specs, args)
    _equal(K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n, ops, emits),
           K.segment_reduce_plain(order, starts, count, n, ops, emits))


@pytest.mark.parametrize("nbuck", [0, 256])
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("groups", [1, 10, 400])
def test_slot_agg_few_groups(dev, groups, live, nbuck):
    """K3 over 262,144 rows into 1, 10 (q06) and 400 (q01) groups, with and
    without a live mask and the radix histogram, against its plain
    version."""
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    rng = np.random.default_rng(groups)
    cap = 262144
    keys, kvalids, specs, args = slot_case(rng, dev, cap, cap, 0, groups, 1, 0.02, True)
    exists = torch.from_numpy(rng.random(cap) < 0.7).to(dev) if live else None
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                              conf.radix_agg_max_slots, conf)
    call = (keys, kvalids, [torch.int64], cap, bases, sizes, specs, args, out_cap, nbuck)
    _equal(A.slot_agg_partial(*call, exists=exists), A.slot_agg_partial_plain(*call, exists))


@pytest.mark.parametrize("rows", [2000, 262144])
@pytest.mark.parametrize("side", ["below", "above"])
def test_slot_agg_at_the_shared_memory_switch(dev, side, rows):
    """K3, then K4 over its outputs, with every limb kind (the LEX pairs
    included) at the largest slot count of the shared-memory design and
    at twice it, over one block's rows and many blocks'."""
    from blaze_tpu_torch.utils import cuda_lib

    slot_switch_check(side, rows, np.random.default_rng(rows), dev,
                      lambda _name, _label, got, want: _equal(got, want), cuda_lib.library())


def test_slot_agg_merge_at_q01s_shape_is_one_launch(dev):
    """K4 at q01's final merge (4 maps x 399 store states) equals its plain
    version and runs as one kernel launch."""
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    rng = np.random.default_rng(1)
    cap = 262144
    keys, kvalids, specs, args = slot_case(rng, dev, cap, cap, 1, 400, 1, 0.0, False)
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                              conf.dense_agg_max_buckets, conf)
    part = A.slot_agg_partial_plain(keys, kvalids, [torch.int64], cap, bases, sizes, specs,
                                    args, out_cap)
    g = int(part[0])
    n4 = 4 * g
    cap4 = conf.capacity_for(n4)
    cat = [torch.nn.functional.pad(torch.cat([x[:g]] * 4), (0, cap4 - n4)) for x in part[2:]]
    live = torch.arange(cap4, device=dev) < n4
    states = [[(cat[2], cat[3] & live), (cat[3], live)], [(cat[4], live)]]
    b4, s4, o4 = A.plan_slot_table(A.probe_ranges([cat[0]], [cat[1] & live]), cap4, None,
                                   conf.radix_agg_max_slots, conf)
    call = ([cat[0]], [cat[1] & live], [torch.int64], n4, b4, s4, ("sum", "count"), states, o4)
    _equal(A.slot_agg_merge(*call), A.slot_agg_merge_plain(*call))
    # one launch a call, over five calls (the profiler can lose a window's
    # first launch: 4 or 5 records; two launches a call would leave 9 or 10)
    ours = {k: n for k, n in _device_kernels(lambda: A.slot_agg_merge(*call), calls=5).items()
            if k.startswith("blz_")}
    assert len(ours) == 1 and round(sum(ours.values()) / 5) == 1, ours


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
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    _, schema, steps = next(c for c in fused_cases(E, T) if c[0] == case)
    kern = FusedKernel(schema, steps)
    rng = np.random.default_rng(len(case))
    for cap, n in FUSED_CAPS:
        datas, valids = fused_planes(cap, n, rng)
        datas = [torch.from_numpy(x).to(dev) for x in datas]
        valids = [torch.from_numpy(x).to(dev) for x in valids]
        _equal([x.cpu() for x in fused_flat(K.fused_chain(schema, steps, datas, valids, n,
                                                          kernel=kern))],
               [x.cpu() for x in fused_flat(K.fused_chain_plain(schema, steps, datas,
                                                                valids, n))])


@pytest.mark.parametrize("case", ["none kept", "all kept", "expand rename", "chain"])
@pytest.mark.parametrize("cap,n", [(3000, 2999), (1024, 1024), (262144, 100_000), (5, 0)])
def test_fused_chain_compacts_in_one_launch(dev, case, cap, n):
    """The compacting K11 against its plain version at capacities that are
    not a multiple of its 1,024-row tile (and one that is), a filter that
    keeps nothing or everything and an expand with two filtered groups;
    three batches in a row through one kernel (its tags and tickets carry
    over), each one Triton launch with no K1 kernel."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_cuda
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    _, schema, steps = next(c for c in fused_cases(E, T) if c[0] == case)
    kern = FusedKernel(schema, steps)
    assert kern.gen.filtered
    rng = np.random.default_rng(cap + n)
    for _ in range(3):
        datas, valids = fused_planes(cap, n, rng)
        datas = [torch.from_numpy(x).to(dev) for x in datas]
        valids = [torch.from_numpy(x).to(dev) for x in valids]
        _equal([x.cpu() for x in fused_flat(K.fused_chain(schema, steps, datas, valids, n,
                                                          kernel=kern))],
               [x.cpu() for x in fused_flat(K.fused_chain_plain(schema, steps, datas,
                                                                valids, n))])
    before = cuda_lib.launch_counts()
    names = _device_kernels(lambda: fused_chain_cuda(kern, datas, valids, n))
    after = cuda_lib.launch_counts()
    assert list(names) == ["fused_chain"] and names["fused_chain"] <= 5, names
    assert after["fused_chain"] - before["fused_chain"] >= 6
    assert after["compact_planes"] == before["compact_planes"]


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


# (label, table capacity, slots the rows draw from, sums only): one slot
# and 100 slots of 512 (whole warps on one slot; sums only: the
# renormalisation the only pass-3 op), 1,000 of 1,024 (a few lanes a
# slot), 6,000 of 8,192 (scattered slots: no warp match)
_BIG_UPD = [("one slot", 512, 1, False), ("one slot, sums only", 512, 1, True),
            ("100 slots, sums only", 512, 100, True), ("1,000 slots", 1024, 1000, False),
            ("6,000 slots", 8192, 6000, False)]


def _big_upd_ops(states, planes, dev):
    """The ops of one 262,144-row batch: COUNT(*), SUM int64, FIRST over
    tied orders, SUM of decimal(18,2) (two limbs), SUM and MAX of
    decimal(38,2) (three limbs, the wide extreme), SUM float64."""
    from blaze_tpu_torch.core import kernels as K

    fns = upd_fns()
    wide = wide_upd_fns()
    count, isum, first, dsum, wsum, wmax, fsum = states
    (a, av), (order, fv, fw, x), (d, dv), (w, wv) = planes
    val, valid, best = first
    return (fns[4].update_ops(count, None, None) + fns[0].update_ops(isum, a, av)
            + [K.SlotUpdate(K.UPD_FIRST, val, a, [fv], order=order, wvalids=[fw],
                            valid_table=valid, order_table=best)]
            + wide[0].update_ops(dsum, d, dv) + wide[2].update_ops(wsum, w, wv)
            + wide[5].update_ops(wmax, w, wv) + fns[1].update_ops(fsum, x, av))


@pytest.mark.parametrize("label,cap,nslots,sums", _BIG_UPD, ids=[c[0] for c in _BIG_UPD])
def test_slot_update_kernel_at_262144_rows(dev, label, cap, nslots, sums):
    """K12 against its twin over two batches of 262,144 rows (the last 100
    padding; the live rows passed as ``num_rows``) into ``nslots`` slots:
    every pass (the atoms with warp aggregation, FIRST's and LEX's
    tiebreak, the renormalisation a slot) and the float fold (one run of ~262,000 rows for one
    slot); one K12 launch a call, K5 only for the float SUM."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(cap + nslots)
    rows, n = 262144, 262044
    drop = (K.UPD_FIRST, K.UPD_LEXMIN, K.UPD_LEXMAX) if sums else ()
    fns, wide = upd_fns(), wide_upd_fns()
    makers = [fns[4], fns[0], fns[16], wide[0], wide[2], wide[5], fns[1]]
    tables = {}
    for name, update in (("kernel", K.slot_update_cuda), ("plain", K.slot_update_plain)):
        tables[name] = [f.init_state(cap, dev) for f in makers]
    batch_rng = np.random.default_rng(rng.integers(1 << 30))
    for _ in range(2):
        live = np.arange(rows) < n
        slots = np.where(live, batch_rng.integers(0, nslots, rows), cap)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
        a = np.where(batch_rng.random(rows) < 0.3, batch_rng.integers(-(1 << 62), 1 << 62, rows),
                     batch_rng.integers(-1000, 1000, rows))
        dec = narrow_plane("mixed", rows, n, batch_rng, 0.1)
        wid = wide_plane("mixed", rows, n, batch_rng, 0.1)
        planes = [(t(a), t(live & (batch_rng.random(rows) >= 0.1))),
                  (t(batch_rng.integers(0, 3, rows)), t(live & (batch_rng.random(rows) >= 0.2)),
                   t(batch_rng.random(rows) >= 0.5), t(batch_rng.normal(size=rows) * 1e6)),
                  (t(dec[0]), t(dec[1])), (tuple(t(x) for x in wid[:3]), t(wid[3]))]
        for name, update in (("kernel", K.slot_update_cuda), ("plain", K.slot_update_plain)):
            ops = [op for op in _big_upd_ops(tables[name], planes, dev) if op.kind not in drop]
            cuda_lib.reset_launch_counts()
            update(t(slots), t(live), ops, num_rows=n)
            if name == "kernel":
                counts = cuda_lib.launch_counts()
                assert counts["slot_update"] == 1 and counts["lexsort_indices"] == 1
                update(t(slots), t(live), ops[:-2], num_rows=n)  # no float SUM: no sort
                assert cuda_lib.launch_counts()["lexsort_indices"] == 1
            else:
                update(t(slots), t(live), ops[:-2], num_rows=n)
    torch.cuda.synchronize()
    _equal(tables["kernel"], tables["plain"])


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


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_segment_scan_kernel(dev, case):
    """K13 against its twin on the card, bit for bit (any NaN = any NaN)."""
    from blaze_tpu_torch.core import kernels as K

    data = scan_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    got = scan_run(data, K.segment_scan_cuda, dev)
    want = scan_run(data, K.segment_scan_plain, dev)
    _equal([one_nan(x) for x in got], [one_nan(x) for x in want])


def _sessions_over(host, schemas, parts, device):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    s = blaze_tpu_torch.Session(Config(batch_size=8192), device=device)
    for name, (cols, valids) in host.items():
        valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
        n = len(cols[0])
        cuts = [n * p // parts for p in range(parts + 1)] if name == "store_sales" else [0, n]
        plist = [[{f.name: (c[a:b], v[a:b])
                   for f, c, v in zip(schemas[name].fields, cols, valids)}]
                 for a, b in zip(cuts, cuts[1:])]
        s.resources[name] = lambda p, _pl=plist: _pl[p]
    return s


def test_q89_on_the_card_equals_the_cpu(dev, monkeypatch):
    """chip_smoke.py's q89 at 300,000 store_sales rows on the card and on
    the CPU: equal, order included, and to the numpy oracle; K13 launched
    and its twin never ran on the card."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    host = q89_host(dict(Q89_ROWS, store_sales=300_000))
    check, _info, _window = q89_oracle(host)
    schemas = q89_schemas(T)
    plan = q89_plan(schemas, E, N, T, parts=3)
    out = {}
    for device in ("cpu", None):
        s = _sessions_over(host, schemas, 3, device)
        if device is None:
            monkeypatch.setattr(K, "segment_scan_plain", None)
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(plan)
    assert out[None] == out["cpu"]
    check(out[None])
    assert cuda_lib.launch_counts()["segment_scan"] >= 1


def test_explicit_frame_window_on_the_card_equals_the_cpu(dev):
    """A ROWS and a RANGE frame over partitions that span batches: the
    buffered path (K7's concat, K6's takes) on the card equals the CPU."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    rng = np.random.default_rng(13)
    n = 5000
    g = np.sort(rng.integers(0, 40, n))
    o = np.concatenate([np.sort(rng.integers(0, 500, c)) for c in np.bincount(g, minlength=40)])
    v = rng.standard_normal(n) * 100
    valid = rng.random(n) >= 0.1
    schema = T.Schema.of(("g", T.I64), ("o", T.I64), ("v", T.F64))
    C, F = E.Column, E.AggFunction
    wexprs = [N.WindowExpr("row_number", "rn"),
              N.WindowExpr("agg", "s", E.AggExpr(F.SUM, [C("v")]), frame=("rows", -3, 1)),
              N.WindowExpr("agg", "mx", E.AggExpr(F.MAX, [C("v")]), frame=("range", -20, 20))]
    plan = N.Window(N.FFIReader(schema, "src", 1), wexprs, [C("g")], [E.SortOrder(C("o"))],
                    group_limit=50)
    batches = [{"g": g[a:a + 1024], "o": o[a:a + 1024],
                "v": (np.where(valid, v, 0.0)[a:a + 1024], valid[a:a + 1024])}
               for a in range(0, n, 1024)]
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=1024), device=device)
        s.resources["src"] = lambda p: batches
        out[device] = s.execute_to_pydict(plan)
    assert out[None] == out["cpu"] and len(out["cpu"]["rn"]) > 1000


# -- the limb halves: wide-decimal states ----------------------------------------


def _limb_kernel_case(dev, case):
    keys, kvalids, specs, args = wide_torch(
        wide_case(case, np.random.default_rng(sum(map(ord, case[0])))), dev)
    return keys, kvalids, specs, args, case[2], case[3]


@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_slot_agg_limb_kernels(dev, case):
    """K3 and K4 with every limb kind (sum2, avg2, sum3, avg3, minw, maxw)
    against their plain versions on the card."""
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    keys, kvalids, specs, args, cap, n = _limb_kernel_case(dev, case)
    kd = [torch.int64] * len(keys)
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                              conf.radix_agg_max_slots, conf)
    want = A.slot_agg_partial_plain(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap)
    _equal(A.slot_agg_partial(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap), want)
    g = int(want[0])
    cap2 = conf.capacity_for(2 * g)
    cat = doubled(want, g, cap2, dev)
    live = torch.arange(cap2, device=dev) < 2 * g
    mk = [cat[2 * i] for i in range(len(keys))]
    mv = [cat[2 * i + 1] & live for i in range(len(keys))]
    kinds = tuple(sp[0] for sp in specs)
    states = wide_states([None, None] + cat, len(keys), kinds, live, np.random.default_rng(2))
    b2, s2, o2 = A.plan_slot_table(A.probe_ranges(mk, mv), cap2, None,
                                   conf.radix_agg_max_slots, conf)
    _equal(A.slot_agg_merge(mk, mv, kd, 2 * g, b2, s2, kinds, states, o2),
           A.slot_agg_merge_plain(mk, mv, kd, 2 * g, b2, s2, kinds, states, o2))


@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_seg_agg_limb_kernels(dev, case):
    """K10's reduction with every limb kind, partial and merge, against
    its plain version over the same sorted rows on the card."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    keys, kvalids, specs, args, cap, n = _limb_kernel_case(dev, case)
    kinds = tuple(sp[0] for sp in specs)
    exists = torch.arange(cap, device=dev) < n
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
    ops, emits = A._partial_program(specs, args)
    _equal(K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n, ops, emits),
           K.segment_reduce_plain(order, starts, count, n, ops, emits))
    outs = A.seg_agg_partial(keys, kvalids, n, specs, args)
    g = int(outs[0])
    live = torch.arange(cap, device=dev) < g
    states = wide_states(outs, len(keys), kinds, live, np.random.default_rng(3))
    mk, mv = list(outs[2:2 + 2 * len(keys):2]), list(outs[3:3 + 2 * len(keys):2])
    morder, mstarts, mcount, _keys = K.segment_ids(mk, mv, live, g)
    mops, memits = A._merge_program(kinds, states)
    _equal(K.segment_reduce_cuda("seg_agg_merge", morder, mstarts, mcount, g, mops, memits),
           K.segment_reduce_plain(morder, mstarts, mcount, g, mops, memits))


@pytest.mark.parametrize("case", WIDE_UPD_CASES, ids=[c[0] for c in WIDE_UPD_CASES])
def test_slot_update_limb_kernel(dev, case):
    """K12's limb ops (two-limb splits, the renormalisation of touched
    slots, limb merges and the lexicographic fold) against its plain
    version on the card."""
    from blaze_tpu_torch.core import kernels as K

    data = wide_upd_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    fns = wide_upd_fns()
    _equal(wide_upd_run(data, fns, K.slot_update_cuda, dev),
           wide_upd_run(data, fns, K.slot_update_plain, dev))


@pytest.mark.parametrize("route", ["default", "sort", "table", "unfused"])
def test_q17_on_the_card_equals_the_cpu(dev, route):
    """q17 at 200,000 store_sales rows on the card and on the CPU: equal to
    each other and to chip_smoke.py's exact oracle, the wide totals past
    int64; the route's limb kernels launched, K18 once a sales batch where
    the joins fuse (K8 never), K8 twice a batch where they do not."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(17)
    n, n_items, n_stores = 200_000, 2000, 400
    host = [(rng.integers(1, n_items + 1, n), rng.integers(1, n_stores, n),
             rng.integers(1, 100, n), rng.integers(10 ** 14, 9 * 10 ** 16, n))]
    item_cols = (np.arange(1, n_items + 1), rng.integers(0, 10, n_items),
                 rng.integers(1, 60, n_items), rng.integers(0, 30000, n_items))
    store_cols = (np.arange(1, n_stores + 1), rng.integers(0, 50, n_stores))
    price = T.DecimalType(7, 2)
    sales = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                        ("ss_quantity", T.I64), ("ss_ext_wholesale_cost", T.DecimalType(38, 2)))
    item = T.Schema.of(("i_item_sk", T.I64), ("i_category_id", T.I64),
                       ("i_brand_id", T.I64), ("i_current_price", price))
    store = T.Schema.of(("s_store_sk", T.I64), ("s_state_id", T.I64))
    from blaze_tpu_torch.core.batch import wide_words

    it, st, q, w = host[0]
    parts = [[{"ss_item_sk": it[a:b], "ss_store_sk": st[a:b], "ss_quantity": q[a:b],
               "ss_ext_wholesale_cost": wide_words(w[a:b].tolist())}]
             for a, b in ((0, n // 4), (n // 4, n // 2), (n // 2, 3 * n // 4), (3 * n // 4, n))]
    conf = {"default": Config(batch_size=8192),
            "sort": Config(batch_size=8192, dense_agg=False, radix_agg=False),
            "table": Config(batch_size=8192, device_merge_max_bytes=1),
            "unfused": Config(batch_size=8192, fused_filter_agg=False)}[route]
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(conf, device=device)
        s.resources["store_sales"] = lambda p: parts[p]
        s.resources["item"] = lambda p: [dict(zip(item.names, item_cols))]
        s.resources["store"] = lambda p: [dict(zip(store.names, store_cols))]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(q17_plan(sales, item, store))
    want = q17_oracle(host, item_cols, store_cols)
    assert out[None] == out["cpu"] == want
    assert any(int(x.scaleb(2)) >= 2 ** 63 for x in want["wcost"])
    limbs = cuda_lib.limb_launch_counts()
    key = {"default": "slot_agg_merge:sum3", "sort": "seg_agg_merge:sum3",
           "table": "slot_update:renorm3", "unfused": "slot_agg_merge:sum3"}[route]
    assert limbs.get(key, 0) > 0, limbs
    batches = sum(len(p) for p in parts)
    launches = cuda_lib.launch_counts()
    if route == "unfused":
        assert launches["inner_join_planes"] == 2 * batches and not launches["fused_agg_input"]
    else:
        assert launches["fused_agg_input"] == batches and not launches["inner_join_planes"]


@pytest.mark.parametrize("case", K18_CASES, ids=[c[0] for c in K18_CASES])
def test_fused_agg_input_kernel(dev, case):
    """K18 against its plain version on the card, bit for bit: every key
    and argument plane (stored or passed through), every validity plane
    and the live mask."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    d = k18_case(case, np.random.default_rng(sum(map(ord, case[0]))), E, T)
    spec, cols, n, joins = k18_torch(d, dev)
    _equal(k18_flat(K.fused_agg_input(spec, cols, n, joins)),
           k18_flat(K.fused_agg_input_plain(spec, cols, n, joins)))


@pytest.mark.parametrize("route", ["dense", "bitmap", "search"])
def test_fused_agg_input_routes_kernel(dev, route):
    """K18 on each rank route against its plain version, bit for bit:
    every battery case with a join that takes the route."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs import fused_triton as FT
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    checked = 0
    for case in K18_CASES[:-1]:
        d = k18_case(case, np.random.default_rng(sum(map(ord, case[0]))), E, T)
        spec, cols, n, joins = k18_torch(d, dev)
        if route not in [j[3].route for j in joins]:
            continue
        want = k18_flat(K.fused_agg_input_plain(spec, cols, n, joins))
        _equal(k18_flat(K.fused_agg_input(spec, cols, n, joins, FT.fused_agg_kernel(spec))), want)
        checked += 1
    assert checked


def test_fused_agg_input_launches_or_raises_and_never_takes_the_twin(dev, monkeypatch):
    """A CUDA batch launches K18 or raises (a build column left on the CPU,
    sorted keys of the wrong length); the plain version is never called."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    case = next(c for c in K18_CASES if c[3] == "q17")
    d = k18_case(case, np.random.default_rng(3), E, T)
    spec, cols, n, joins = k18_torch(d, dev)
    want = k18_flat(K.fused_agg_input_plain(spec, cols, n, joins))
    monkeypatch.setattr(K, "fused_agg_input_plain", None)
    cuda_lib.reset_launch_counts()
    _equal(k18_flat(K.fused_agg_input(spec, cols, n, joins)), want)
    assert cuda_lib.launch_counts()["fused_agg_input"] == 1
    (uniq, nk, bcols, rank), second = joins
    with pytest.raises(ValueError, match="fused_agg_input"):
        K.fused_agg_input(spec, cols, n, [(uniq, nk, [c.__class__(c.dtype, c.data.cpu(),
                                                                   c.validity.cpu())
                                                        for c in bcols], rank), second])
    with pytest.raises(ValueError, match="fused_agg_input"):
        K.fused_agg_input(spec, cols, n, [(uniq[:-1], nk, bcols, rank), second])
    # a join without its rank route
    with pytest.raises(ValueError, match="fused_agg_input"):
        K.fused_agg_input(spec, cols, n, [(uniq, nk, bcols), second])


@pytest.mark.parametrize("case", RANGE_CASES, ids=[c[0] for c in RANGE_CASES])
def test_range_partition_kernel(dev, case):
    """K14 against its twin on the card, on every route the bounds allow
    (the count and the search over staged bounds, the search in global
    memory), and range_partition_order's K5 sort of its ids against the
    twin's."""
    from blaze_tpu_torch.core import kernels as K

    data = range_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    _equal(range_run(data, K.range_partition_ids_cuda, dev),
           range_run(data, K.range_partition_ids_plain, dev))
    routes, twin = range_routes(data, dev)
    assert "global" in routes
    for got in routes.values():
        _equal(got, twin)
    _equal(range_run(data, K.range_partition_order, dev),
           [x.to(dev) for x in range_run(data, K.range_partition_order, torch.device("cpu"))])


def test_range_pack_serves_batches_of_any_size(dev):
    """One RangePack (an exchange's) over batches of 1 to 262,145 rows,
    views at odd offsets among them: each launch equals the twin, one
    launch a batch; a batch of another key dtype, or off the card, is
    refused."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    keys = (("i64", False, True), ("f64", True, False))
    rng = np.random.default_rng(8)
    bounds = range_case(("bounds", keys, 64, 64, 31, 0.1, 0.1), rng)
    _d, _v, _e, bdatas, bvalids = range_tensors(bounds, dev)
    spec = bounds["spec"]
    ops = K.range_bound_operands(bdatas, bvalids, spec)
    pack = K.RangePack(ops, spec, [torch.int64, torch.float64])
    cuda_lib.reset_launch_counts()
    sizes = (1, 3, 4, 5, 255, 1023, 262145)
    for n in sizes:
        data = range_case((f"n={n}", keys, n, n - n // 7, 31, 0.1, 0.1, n % 2), rng)
        datas, valids, exists, _bd, _bv = range_tensors(data, dev)
        _equal(K.range_partition_ids(datas, valids, exists, ops, spec, pack=pack),
               K.range_partition_ids_plain(datas, valids, exists, ops, spec))
    assert cuda_lib.launch_counts()["range_partition"] == len(sizes)
    with pytest.raises(TypeError, match="range_partition_ids"):
        pack.launch([datas[0].to(torch.int32), datas[1]], valids, exists)
    with pytest.raises(TypeError, match="range_partition_ids"):
        pack.launch([datas[0].cpu(), datas[1]], valids, exists)


def test_two_range_partitioners_keep_their_own_bounds(dev):
    """Two range exchanges' partitioners in one process, over the same
    batch with other bounds, each through its own pack: each gives the
    ids of its own bounds, as the same partitioner on the CPU does."""
    from blaze_tpu_torch.core.batch import ColumnarBatch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops.shuffle.repartitioner import RangePartitioner

    schema = T.Schema.of(("k", T.I64), ("f", T.F64))
    rng = np.random.default_rng(9)
    cols = {"k": rng.integers(-50, 50, 5000), "f": rng.integers(-8, 9, 5000) * 0.5}
    orders = [E.SortOrder(E.Column("k"), ascending=False), E.SortOrder(E.Column("f"))]
    bounds = ([(30, 0.0), (0, -1.5), (-20, 2.0)], [(10, None), (-45, 0.5)])
    for bs in bounds:
        got, want = [], []
        for device, out in ((dev, got), (torch.device("cpu"), want)):
            p = RangePartitioner(orders, len(bs) + 1, bs, schema)
            b = ColumnarBatch.from_numpy(schema, cols, device)
            out.append(p.partition_ids(b))
            out.append(p.partition_ids(b))
            assert (p._pack is not None) == (device.type == "cuda")
        for g, w in zip(got, want):
            _equal(g.cpu(), w)


def test_range_partition_raises_on_bad_bounds_and_never_takes_the_twin(dev, monkeypatch):
    """A CUDA batch launches K14 or raises: bound planes of another dtype
    than the key's are refused, and the twin is never called."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    data = range_case(RANGE_CASES[2], np.random.default_rng(2))
    monkeypatch.setattr(K, "range_partition_ids_plain", None)
    cuda_lib.reset_launch_counts()
    range_run(data, K.range_partition_ids, dev)
    assert cuda_lib.launch_counts()["range_partition"] == 1
    t = [[torch.from_numpy(x).to(dev) for x in data[k]]
         for k in ("datas", "valids", "bdatas", "bvalids")]
    ops = K.range_bound_operands(t[2], t[3], data["spec"])
    ops[1] = ops[1].to(torch.int64)  # the int32 key's bound values as int64
    with pytest.raises(TypeError, match="bounds"):
        K.range_partition_ids(t[0], t[1], torch.from_numpy(data["exists"]).to(dev), ops,
                              data["spec"])


def test_q98_on_the_card_equals_the_cpu(dev):
    """chip_smoke.py's q98 at 300,000 store_sales rows on the card and on
    the CPU, on the sort route: equal, order included, and to the numpy
    oracle; K14, K13 and K10 launched."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    host = q98_host(dict(Q98_ROWS, store_sales=300_000, item=4_000))
    check, _info = q98_oracle(host)
    schemas = q98_schemas(T)
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=8192, dense_agg=False, radix_agg=False),
                                    device=device)
        for name, (cols, valids) in host.items():
            valids = valids or [np.ones(len(cols[0]), bool)] * len(cols)
            n = len(cols[0])
            cuts = [n * p // 3 for p in range(4)] if name == "store_sales" else [0, n]
            plist = [[{f.name: (c[a:b], v[a:b])
                       for f, c, v in zip(schemas[name].fields, cols, valids)}]
                     for a, b in zip(cuts, cuts[1:])]
            s.resources[name] = lambda p, _pl=plist: _pl[p]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(q98_plan(schemas, E, N, T, parts=3))
    assert out[None] == out["cpu"]
    check(out[None])
    counts = cuda_lib.launch_counts()
    assert counts["range_partition"] >= 1 and counts["segment_scan"] >= 1
    assert counts["seg_agg_partial"] >= 1


def test_sort10m_on_the_card_equals_the_cpu(dev):
    """sort10M's plan at 300,000 rows in 4 partitions into 8 range
    partitions on the card and on the CPU: equal, and the keys in numpy's
    order; one K14 launch a map-side bucketize pass."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core.batch import wide_words
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    host = sort10m_host(rows=300_000, parts=4, seed=3)
    check, _info = sort10m_oracle(host)
    schema = sort10m_schema(T)
    parts = [[{c: wide_words(x[s:s + 16384].tolist()) if c == SORT10M_COLUMNS[4]
               else x[s:s + 16384] for c, x in zip(SORT10M_COLUMNS, cols)}
              for s in range(0, len(cols[0]), 16384)] for cols in host]
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=16384), device=device)
        s.resources["store_sales"] = lambda p: parts[p]
        cuda_lib.reset_launch_counts()
        out[device] = sort10m_collect(s, sort10m_plan(schema, E, N, parts=4, range_parts=8))
    for c in SORT10M_COLUMNS:
        np.testing.assert_array_equal(out[None][c], out["cpu"][c])
    check(out[None])
    assert cuda_lib.launch_counts()["range_partition"] == sum(len(p) for p in parts)


@pytest.mark.parametrize("case", XXH_CASES, ids=[c[0] for c in XXH_CASES])
def test_xxhash64_kernel(dev, case):
    """K15 against its twin on the card and against the numpy XXH64."""
    from blaze_tpu_torch.exprs import spark_hash as H

    args = xxh_case(case, np.random.default_rng(sum(map(ord, case[0]))), dev)
    got = H.xxhash64_rows_cuda(*args)
    _equal(got, H.xxhash64_rows_plain(*args))
    words, valids, _kinds, n, _cap = args
    if n:
        want = xxh64_np([w[:n].cpu().numpy() for w in words],
                        [v[:n].cpu().numpy() for v in valids])
        assert np.array_equal(got[:n].cpu().numpy(), want)
    assert not got[n:].any()


def test_xxhash64_launches_or_raises_and_never_takes_the_twin(dev, monkeypatch):
    """A CUDA column launches K15 or raises: a word of the wrong width is
    refused, and the twin is never called."""
    from blaze_tpu_torch.exprs import spark_hash as H
    from blaze_tpu_torch.utils import cuda_lib

    words, valids, kinds, n, cap = xxh_case(XXH_HASH_SAMPLE, np.random.default_rng(5), dev)
    monkeypatch.setattr(H, "xxhash64_rows_plain", None)
    cuda_lib.reset_launch_counts()
    H.xxhash64_rows(words, valids, kinds, n, cap)
    assert cuda_lib.launch_counts()["xxhash64"] == 1
    with pytest.raises(TypeError, match="xxhash64"):
        H.xxhash64_rows([w.to(torch.int64) for w in words], valids, kinds, n, cap)


def test_xxhash64_spark_documented_example_and_packs_per_signature(dev):
    """Spark's xxhash64('Spark', array(123), 2) on K15 with the row as a
    byte and a short (and the two other mixes of widths); one pack a
    signature, so columns of another width or kind in the same process
    hash as their own twin; a plane off the card or a validity that is
    not bool is refused."""
    from blaze_tpu_torch.exprs import spark_hash as H

    assert len(xxh_spark_doc(H.xxhash64_rows_cuda, dev)) == 3
    rng = np.random.default_rng(12)
    for case in XXH_CASES[:4] + (XXH_HASH_SAMPLE,):
        args = xxh_case(case, rng, dev)
        _equal(H.xxhash64_rows_cuda(*args), H.xxhash64_rows_plain(*args))
    words, valids, kinds, n, cap = args
    with pytest.raises(ValueError, match="xxhash64"):
        H.xxhash64_rows_cuda([words[0].cpu(), words[1]], valids, kinds, n, cap)
    with pytest.raises(ValueError, match="xxhash64"):
        H.xxhash64_rows_cuda(words, [valids[0].to(torch.uint8), valids[1]], kinds, n, cap)


def test_hash_sample_on_the_card_equals_the_cpu(dev):
    """chip_smoke.py's hash_sample at 300,000 rows in 4 partitions on the
    card and on the CPU: equal, order included, and to the numpy oracle;
    K15 once a sales batch, K14 on the range exchange."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    cols, valids = hash_sample_host(rows=300_000)
    want, _info = hash_sample_oracle((cols, valids))
    schema = hash_sample_schema(T)
    cuts = [300_000 * p // 4 for p in range(5)]
    plist = [[{f.name: (c[s:min(s + 8192, b)],
                        np.ones(min(s + 8192, b) - s, bool) if v is None
                        else v[s:min(s + 8192, b)])
               for f, c, v in zip(schema.fields, cols, valids)} for s in range(a, b, 8192)]
             for a, b in zip(cuts, cuts[1:])]
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=8192), device=device)
        s.resources["store_sales"] = lambda p: plist[p]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(hash_sample_plan(schema, E, N, T))
    assert out[None] == out["cpu"] == want
    counts = cuda_lib.launch_counts()
    assert counts["xxhash64"] == sum(len(p) for p in plist)
    assert counts["range_partition"] >= 1


@pytest.mark.parametrize("name", ["year", "round", "greatest", "murmur3", "xxhash64", "abs",
                                  "sqrt", "exp", "sin", "cbrt", "pow"])
def test_scalar_functions_on_the_card_equal_the_cpu(dev, name):
    """The device functions on the card against the CPU, over
    chip_smoke.py's fused-chain planes: exact, except the transcendental
    functions (CUDA's and the CPU's libm), at most 2 ulp apart."""
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
    from blaze_tpu_torch.exprs.compiler import ExprEvaluator
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    C, L = E.Column, E.Literal
    schema = fused_schema(T)
    exprs = {
        "year": [E.ScalarFunction("year", [E.Cast(C("i"), T.DATE)]),
                 E.ScalarFunction("quarter", [E.Cast(C("l"), T.TIMESTAMP)])],
        "round": [E.ScalarFunction("round", [C("d"), L(2, T.I32)]),
                  E.ScalarFunction("round", [C("m"), L(1, T.I32)]),
                  E.ScalarFunction("round", [C("l"), L(-3, T.I32)])],
        "greatest": [E.ScalarFunction("greatest", [C("d"), C("e")]),
                     E.ScalarFunction("least", [C("f"), C("g")])],
        "murmur3": [E.ScalarFunction("murmur3_hash", [C("i"), C("l"), C("d"), C("m"), C("b")])],
        "xxhash64": [E.ScalarFunction("xxhash64", [C("i"), C("l"), C("f"), C("d"), C("m"),
                                                   C("b")])],
        "abs": [E.ScalarFunction("abs", [C(x)]) for x in "ilfdm"],
        "sqrt": [E.ScalarFunction("sqrt", [C("d")]), E.ScalarFunction("sqrt", [C("m")])],
        "exp": [E.ScalarFunction("exp", [C("e")]), E.ScalarFunction("ln", [C("d")])],
        "sin": [E.ScalarFunction(fn, [C("d")]) for fn in ("sin", "cos", "tan", "atan")],
        "cbrt": [E.ScalarFunction("cbrt", [C("d")])],
        "pow": [E.ScalarFunction("pow", [C("e"), C("e")]),
                E.ScalarFunction("atan2", [C("d"), C("e")])],
    }[name]
    ulps = 2 if name in ("sqrt", "exp", "sin", "cbrt", "pow") else 0
    datas, valids = fused_planes(4096, 4000, np.random.default_rng(len(name)),
                                 subnormals=False)
    outs = {}
    for d in ("cpu", dev):
        cols = [DeviceColumn(f.dtype, torch.from_numpy(x).to(d), torch.from_numpy(v).to(d))
                for f, x, v in zip(schema.fields, datas, valids)]
        batch = ColumnarBatch(schema, cols, 4000)
        outs[str(d)] = [(c.data.cpu(), c.validity.cpu())
                        for c in ExprEvaluator(exprs, schema).evaluate(batch)]
    for (gd, gv), (wd, wv) in zip(outs[str(dev)], outs["cpu"]):
        assert torch.equal(gv, wv)
        gd, wd = gd[wv], wd[wv]
        if not gd.is_floating_point():
            assert torch.equal(gd, wd)
            continue
        bits = {4: torch.int32, 8: torch.int64}[gd.element_size()]
        gb, wb = gd.view(bits).to(torch.int64), wd.view(bits).to(torch.int64)
        nan = torch.isnan(gd) & torch.isnan(wd)
        near = (torch.signbit(gd) == torch.signbit(wd)) & ((gb - wb).abs() <= ulps)
        assert bool((nan | (gb == wb) | near).all()), name


@pytest.mark.parametrize("case", BLOOM_CASES, ids=[c[0] for c in BLOOM_CASES])
def test_bloom_probe_kernel(dev, case):
    """K16 against its twin on the card and against chip_smoke.py's numpy
    probe, over the whole capacity."""
    from blaze_tpu_torch.ops import bloom as B

    vals, words, k, bits = bloom_case(case, np.random.default_rng(sum(map(ord, case[0]))))
    v = torch.from_numpy(vals).to(dev)
    w = torch.from_numpy(words.view(np.int64)).to(dev)
    got = B.bloom_probe_cuda(v, w, k, bits)
    _equal(got, B.might_contain_long_plain(v, w, k, bits))
    assert np.array_equal(got.cpu().numpy(), bloom_np_probe(words, k, vals))


def test_bloom_probe_launches_or_raises_and_never_takes_the_twin(dev, monkeypatch):
    """A CUDA column launches K16 or raises (int32 values, a bitmap of
    another size are refused); the twin is never called."""
    from blaze_tpu_torch.ops import bloom as B
    from blaze_tpu_torch.utils import cuda_lib

    vals, words, k, bits = bloom_case(BLOOM_CASES[3], np.random.default_rng(5))
    bf = B.SparkBloomFilter(words.copy(), k)
    monkeypatch.setattr(B, "might_contain_long_plain", None)
    cuda_lib.reset_launch_counts()
    got = bf.might_contain_long(torch.from_numpy(vals).to(dev))
    assert cuda_lib.launch_counts()["bloom_probe"] == 1
    assert np.array_equal(got.cpu().numpy(), bloom_np_probe(words, k, vals))
    w = bf.device_words(dev)
    with pytest.raises(TypeError, match="bloom_probe"):
        B.bloom_probe_cuda(torch.from_numpy(vals).to(dev).to(torch.int32), w, k, bits)
    with pytest.raises(ValueError, match="bloom_probe"):
        B.bloom_probe_cuda(torch.from_numpy(vals).to(dev), w[:-1], k, bits)


def test_bloom_runtime_filter_on_the_card_equals_the_cpu(dev):
    """The bloom aggregate's filter and the probe in a Filter merged with
    its null check, over 200,000 rows in 4 partitions of 8,192-row batches:
    the same filter bytes and rows on the card as on the CPU; K16 once a
    probed batch."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(15)
    schema = T.Schema.of(("k", T.I64))
    keys = rng.integers(0, 1_000_000, 200_000)
    valid = rng.random(200_000) >= 0.04
    parts = [[{"k": (keys[s:s + 8192], valid[s:s + 8192])}
              for s in range(p * 50_000, (p + 1) * 50_000, 8192)] for p in range(4)]
    small = [[{"k": np.arange(p * 10_000, p * 10_000 + 5_000)}] for p in range(4)]
    hashed = E.ScalarFunction("xxhash64", [E.Column("k")])
    agg = N.Agg(N.ShuffleExchange(N.FFIReader(schema, "small", 4), N.SinglePartitioning(1)),
                E.AggExecMode.HASH_AGG, [],
                [N.AggColumn(E.AggExpr(E.AggFunction.BLOOM_FILTER, [hashed]),
                             E.AggMode.COMPLETE, "bf")])
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=8192), device=device)
        s.resources["small"] = lambda p: small[p]
        s.resources["big"] = lambda p: parts[p]
        blob = s.execute_to_pydict(agg)["bf"][0]
        probe = E.BloomFilterMightContain(E.ScalarSubquery(blob, T.BINARY), hashed)
        cuda_lib.reset_launch_counts()
        rows = s.execute_to_pydict(N.Filter(N.FFIReader(schema, "big", 4),
                                            [E.IsNotNull(E.Column("k")), probe]))
        out[device] = (blob, rows)
    assert out[None] == out["cpu"]
    assert 0 < len(out[None][1]["k"]) < 200_000
    assert cuda_lib.launch_counts()["bloom_probe"] == sum(len(p) for p in parts)


# -- K17 and the stacked K11: the device mesh ------------------------------------------


@pytest.mark.parametrize("spec", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_mesh_all_to_all_kernel(dev, spec):
    """K17 against its twin on chip_smoke.py's battery, every round; the
    live counts are the rows each slot receives."""
    from blaze_tpu_torch.core import kernels as K
    from chip_smoke import mesh_case, mesh_recv_counts, mesh_run

    case = mesh_case(spec, np.random.default_rng(17))
    got = mesh_run(case, K.mesh_all_to_all_cuda, dev)
    _equal(got, mesh_run(case, K.mesh_all_to_all_plain, dev))
    if case["counts"] is not None:
        assert [r[2].tolist() for r in got] == mesh_recv_counts(case)


@pytest.mark.parametrize("spec,offset", K17_EDGE_CASES, ids=[e[0][0] for e in K17_EDGE_CASES])
def test_mesh_all_to_all_edges_kernel(dev, spec, offset):
    """K17 against its twin at its segments' edges (segments of 7 and 1,030
    rows over several rounds, wholly dead segments, 80 planes past the
    by-value table, 300 planes in two launches, tile mode), the slot
    planes views at odd element offsets, every round; the receive counts
    against the count matrix's."""
    from blaze_tpu_torch.core import kernels as K
    from chip_smoke import mesh_case, mesh_recv_counts, mesh_run

    case = mesh_case(spec, np.random.default_rng(23))
    got = mesh_run(case, K.mesh_all_to_all_cuda, dev, offset)
    _equal(got, mesh_run(case, K.mesh_all_to_all_plain, dev))
    if case["counts"] is not None:
        assert [r[2].tolist() for r in got] == mesh_recv_counts(case)


def test_mesh_all_to_all_raises_on_bad_inputs(dev):
    from blaze_tpu_torch.core import kernels as K
    from chip_smoke import mesh_case, mesh_torch

    case = mesh_case(MESH_CASES[2], np.random.default_rng(3))
    planes, routes, dtypes = mesh_torch(case, dev)
    with pytest.raises(TypeError, match="mesh_all_to_all"):
        K.mesh_all_to_all_cuda(planes, routes, case["chunk"], dev, dtypes[::-1],
                               case["counts"], case["G"], case["scap"])
    with pytest.raises(ValueError, match="mesh_all_to_all"):
        K.mesh_all_to_all_cuda(planes, [r.to(torch.int32) for r in routes], case["chunk"], dev,
                               dtypes, case["counts"], case["G"], case["scap"])


@pytest.mark.parametrize("k", [1, 3, 8])
def test_stacked_fused_chain_kernel(dev, k):
    """The stacked K11 (with K1 per batch) against the single-batch plain
    version on every chain of K11's battery, batch by batch."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    rng = np.random.default_rng(k)
    rows = (4096, 4000, 0, 17, 4096, 2049, 1, 3000)[:k]
    for name, schema, steps in fused_cases(E, T):
        host = [fused_planes(4096, rows[b], rng) for b in range(k)]
        datas = [[torch.from_numpy(x).to(dev) for x in d] for d, _v in host]
        valids = [[torch.from_numpy(x).to(dev) for x in v] for _d, v in host]
        got = K.fused_chain_stacked(schema, steps, datas, valids, rows)
        for b in range(k):
            want = K.fused_chain_plain(schema, steps, datas[b], valids[b], rows[b])
            _equal([x.to(dev) for x in fused_flat(got[b])],
                   [x.to(dev) for x in fused_flat(want)])


@pytest.mark.parametrize("slots", [1, 2, 8])
def test_mesh_paths_on_the_card_equal_the_cpu(dev, slots):
    """A fused filter and projection over 8 partitions of eight 4,096-row
    batches, a two-stage SUM through a hash exchange into 13 reducers, a
    single exchange and a sort, on a mesh of ``slots`` slots: the card's
    result equals the CPU's; K17 once an exchange, the stacked K11 where
    batches stack (filter -> agg fusion off: by default the partial
    aggregate absorbs the stage and nothing stacks)."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.parallel.mesh import make_mesh
    from blaze_tpu_torch.utils import cuda_lib

    rng = np.random.default_rng(slots)
    schema = T.Schema.of(("k", T.I64), ("v", T.I64))
    parts = [[{"k": rng.integers(0, 5000, 4096), "v": rng.integers(0, 1000, 4096)}
              for _b in range(8)] for _p in range(8)]
    C = E.Column
    filt = N.Filter(N.FFIReader(schema, "src", 8),
                    [E.BinaryExpr(E.BinaryOp.GT, C("v"), E.Literal(100, T.I64))])
    proj = N.Projection(filt, [C("k"), C("v")], ["k", "v"])
    agg = E.AggExpr(E.AggFunction.SUM, [C("v")], T.I64)
    partial = N.Agg(proj, E.AggExecMode.HASH_AGG, [("k", C("k"))],
                    [N.AggColumn(agg, E.AggMode.PARTIAL, "s")])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([C("k")], 13)),
                  E.AggExecMode.HASH_AGG, [("k", C("k"))],
                  [N.AggColumn(agg, E.AggMode.FINAL, "s")])
    plan = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)), [E.SortOrder(C("k"))])
    out = {}
    for device in ("cpu", dev):
        s = blaze_tpu_torch.Session(Config(batch_size=4096, multichip_enabled=True,
                                           fused_filter_agg=False),
                                    device=device, mesh=make_mesh(slots, device))
        s.resources["src"] = lambda p: parts[p]
        cuda_lib.reset_launch_counts()
        out[str(device)] = s.execute_to_pydict(plan)
    assert out["cpu"] == out[str(dev)] and len(out["cpu"]["k"]) > 4000
    counts = cuda_lib.launch_counts()
    assert counts["mesh_all_to_all"] == 2
    assert counts["fused_chain_stacked"] == (0 if slots == 1 else 8 * (8 // slots))


@pytest.mark.parametrize("case", PASS_CASES + (("cust_spend batch",),),
                         ids=[c[0] for c in PASS_CASES] + ["cust_spend batch"])
def test_passthrough_kernel(dev, case):
    """K19 against its twin on the card, bit for bit, on chip_smoke.py's
    battery (subnormals included) and cust_spend's 262,144-row batch."""
    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(len(case[0]))
    if len(case) == 1:
        args = pass_inputs(cust_spend_batch(rng), 262144, dev)
    else:
        args = pass_inputs(pass_case(case, rng), case[3], dev)
    _equal(K.passthrough_states_cuda(*args)[1:], K.passthrough_states_plain(*args)[1:])


def test_passthrough_kernel_across_a_tasks_batches(dev):
    """K19 through one pack over three batches of a task (cust_spend's
    program; the last batch partial, as a partition's last is), each bit
    for bit its twin: the pack's words point at each batch's planes."""
    from blaze_tpu_torch.core import kernels as K

    rng = np.random.default_rng(19)
    pack = K.PassthroughPack()
    for n in (262144, 262144, 100_003):
        args = pass_inputs(cust_spend_batch(rng), n, dev)
        _equal(K.passthrough_states_cuda(*args, pack=pack)[1:],
               K.passthrough_states_plain(*args)[1:])
    assert pack.words[K._PW_ROWS] == 100_003


def test_passthrough_launches_or_raises_and_never_takes_the_twin(dev, monkeypatch):
    """A CUDA batch launches K19 or raises: a state source that is not
    int64 or float64 is refused, and the twin is never called."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    keys, kvalids, exists, n, ops, emits = pass_inputs(
        pass_case(PASS_CASES[0], np.random.default_rng(1)), PASS_CASES[0][3], dev)
    monkeypatch.setattr(K, "passthrough_states_plain", None)
    cuda_lib.reset_launch_counts()
    K.passthrough_states(keys, kvalids, exists, n, ops, emits)
    assert cuda_lib.launch_counts()["passthrough_states"] == 1
    ops[0].src = ops[0].src.to(torch.int32)
    with pytest.raises(TypeError, match="passthrough_states"):
        K.passthrough_states(keys, kvalids, exists, n, ops, emits)


def test_cust_spend_on_the_card_equals_the_cpu(dev):
    """chip_smoke.py's cust_spend at 4 x 8 batches of 8,192 rows over
    60,000 customers (a batch ~0.14 of the domain) on the card and on the
    CPU: equal, order included, and to the oracle; K3 on each partition's
    first batch, K19 on every other, as many batches skipped."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.utils import cuda_lib

    rows, bs = 4 * 8 * 8192, 8192
    (cust, qty, price), (cv, _q, _p) = cust_spend_host(rows=rows, seed=5, customers=60_000)
    check, _groups = cust_spend_oracle(((cust, qty, price), (cv, None, None)))
    ones = np.ones(rows, bool)
    cols = {"ss_customer_sk": (cust, cv), "ss_quantity": (qty, ones),
            "ss_sales_price": (price, ones)}
    parts = [[{c: (d[s:s + bs], v[s:s + bs]) for c, (d, v) in cols.items()}
              for s in range(p * 8 * bs, (p + 1) * 8 * bs, bs)] for p in range(4)]
    out = {}
    for device in ("cpu", None):
        s = blaze_tpu_torch.Session(Config(batch_size=bs, partial_agg_skipping_min_rows=5_000),
                                    device=device)
        s.resources["store_sales"] = lambda p: parts[p]
        cuda_lib.reset_launch_counts()
        out[device] = s.execute_to_pydict(cust_spend_plan(cust_spend_schema(T), E, N, T))
        assert s.counters["partial_skipped_batches"] == 4 * 7
    assert out[None] == out["cpu"]
    check(out[None])
    counts = cuda_lib.launch_counts()
    assert counts["slot_agg_partial"] == 4 and counts["passthrough_states"] == 4 * 7
