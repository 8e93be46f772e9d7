#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blaze_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and the last line is printed
only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the kernel library from blaze_tpu_torch/csrc (nvcc, sm_90a),
   with its build seconds;
3. kernels: K1-K4 held against their plain PyTorch versions on the card,
   exactly, at the main path's shapes and at edge cases (nulls, all-false
   and all-true masks, padding rows, keys next to the slot range, one and
   two keys, int32/int64/decimal words, capacities 1024 and 262144); then
   each timed with CUDA events beside its plain version, one PyTorch
   library call where one computes the same function, and its bound (bytes
   moved over 3.35 TB/s);
4. slice: TPC-DS q01 (filter -> partial agg -> murmur3 hash exchange ->
   final agg -> top 100) through ``Session().execute_to_pydict`` over
   28,795,080 store_returns rows (the SF100 row count) in 4 partitions,
   drawn with numpy as bench.py draws them and staged on the card; the
   result is checked exactly against a numpy oracle, and the launch count
   of every kernel over that run must be above 0;
5. one JSON line per kernel (shape, times, bound, launches in the q01
   run), the kernels' summary JSON line, the card line, and the device
   JSON line.

``--profile`` adds one q01 run under torch.profiler (device busy share,
launch and sync counts, the top kernels); ``--trace=PATH`` also writes
that run's Chrome trace to PATH.

Needs one CUDA device; exits 2 without one, or when run outside a checkout
of the repository.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 28_795_080
PARTS = 4
N_STORES = 400
N_CUSTOMERS = 100_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
WARMUP, ITERS = 3, 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=ITERS):
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two (nested) tuples of tensors; raises on a
    shape or dtype mismatch."""
    import torch

    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{len(a)} outputs vs {len(b)}")
        return max([max_abs_err(x, y) for x, y in zip(a, b)] or [0.0])
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/{b.dtype}")
    if a.dtype == torch.bool:
        return float((a != b).sum().item())
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item()) \
        if a.numel() else 0.0


MAX_ERR = {}


def check_equal(name, case, got, want):
    err = max_abs_err(got, want)
    MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err)
    if err != 0.0:
        raise AssertionError(f"{name} [{case}] differs from its plain version: "
                             f"max abs err {err}")
    return err


# -- phase 3: kernels against their plain versions ----------------------------


def planes(n, cap, k_int64, rng, dev, null_frac=0.0):
    import numpy as np
    import torch

    datas, valids = [], []
    for _ in range(k_int64):
        d = np.zeros(cap, np.int64)
        v = np.zeros(cap, bool)
        d[:n] = rng.integers(-(1 << 40), 1 << 40, n)
        v[:n] = rng.random(n) >= null_frac
        d[~v] = 0
        datas.append(torch.from_numpy(d).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    return datas, valids


def kernel_k1(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for cap, n, frac, nulls in ((262144, 262144, 0.95, 0.0), (262144, 200000, 0.5, 0.1),
                                (1024, 1000, 0.0, 0.2), (1024, 1024, 1.0, 0.0),
                                (1024, 300, 0.3, 0.5)):
        datas, valids = planes(n, cap, 3, rng, dev, nulls)
        datas.append(torch.from_numpy(rng.integers(0, 1 << 30, cap).astype(np.int32)).to(dev))
        valids.append(torch.ones(cap, dtype=torch.bool, device=dev))
        mask = torch.from_numpy(np.concatenate(
            [rng.random(n) < frac, np.zeros(cap - n, bool)])).to(dev)
        got = K.compact_planes_cuda(datas, valids, mask)
        want = K.compact_planes_plain(datas, valids, mask)
        check_equal("compact_planes", f"cap={cap} n={n} keep={frac}", got, want)
        cases.append(f"cap={cap},n={n},keep={frac},nulls={nulls}")
    # main path: FilterExec on a 262144-row q01 batch (3 int64 planes + 3
    # validity planes, ~95% kept)
    cap = 262144
    datas, valids = planes(cap, cap, 3, rng, dev)
    mask = torch.from_numpy(rng.random(cap) < 0.95).to(dev)
    ms = time_ms(lambda: K.compact_planes_cuda(datas, valids, mask))
    plain_ms = time_ms(lambda: K.compact_planes_plain(datas, valids, mask))
    lib_ms = time_ms(lambda: [x[mask] for x in datas + valids])
    nbytes = cap + 2 * sum(x.numel() * x.element_size() for x in datas + valids)
    results.append(dict(
        name="compact_planes", route="cuda", source="blaze_tpu_torch/csrc/compact.cu",
        replaces="blaze_tpu/core/kernels.py:212", shape="262144 rows x 6 planes",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="x[mask] per plane", bytes=nbytes))


def kernel_k2(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.exprs import spark_hash as H

    cases = []
    for n, kinds, nulls in ((262144, ("i64",), 0.0), (1024, ("i32",), 0.3),
                            (1000, ("i64", "i32"), 0.2), (400, ("i64",), 0.0)):
        words, valids = [], []
        for kind in kinds:
            w = rng.integers(-(1 << 62), 1 << 62, n) if kind == "i64" \
                else rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
            words.append(torch.from_numpy(w).to(dev))
            valids.append(torch.from_numpy(rng.random(n) >= nulls).to(dev))
        for nparts in (4, 7):
            got = H.murmur3_pmod_cuda(words, valids, kinds, n, nparts)
            want = H.murmur3_pmod_plain(words, valids, kinds, n, nparts)
            check_equal("murmur3_pmod", f"n={n} kinds={kinds} parts={nparts}", got, want)
        cases.append(f"n={n},kinds={'+'.join(kinds)},nulls={nulls}")
    # Spark's golden vectors (tests/test_spark_hash.py): hashLong and
    # hashInt with seed 42
    golden = ((("i64",), [1, 0, -1, 2**63 - 1, -(2**63)],
               [0x99F0149D, 0x9C67B85D, 0xC8008529, 0xA05B5D7B, 0xCD1E64FB]),
              (("i32",), [1, 2, 3, 4], [-559580957, 1765031574, -1823081949, -397064898]))
    for kinds, vals, expect in golden:
        dt = torch.int64 if kinds[0] == "i64" else torch.int32
        w = torch.tensor(vals, dtype=dt, device=dev)
        v = torch.ones(len(vals), dtype=torch.bool, device=dev)
        h, _ = H.murmur3_pmod_cuda([w], [v], list(kinds), len(vals), 4)
        want = np.array(expect, dtype=np.int64).astype(np.uint32).view(np.int32).tolist()
        if h.tolist() != want:
            raise AssertionError(f"murmur3 {kinds[0]} golden: {h.tolist()} != {want}")
    # main path: the q01 hash exchange routes each map's consolidated
    # partial states (~400 store keys, int64) to 4 reducers
    n = 400
    words = [torch.from_numpy(rng.integers(1, N_STORES, n)).to(dev)]
    valids = [torch.ones(n, dtype=torch.bool, device=dev)]
    ms = time_ms(lambda: H.murmur3_pmod_cuda(words, valids, ["i64"], n, PARTS, False))
    plain_ms = time_ms(lambda: H.murmur3_pmod_plain(words, valids, ["i64"], n, PARTS))
    big = [torch.from_numpy(rng.integers(1, N_STORES, 262144)).to(dev)]
    bigv = [torch.ones(262144, dtype=torch.bool, device=dev)]
    big_ms = time_ms(lambda: H.murmur3_pmod_cuda(big, bigv, ["i64"], 262144, PARTS, False))
    results.append(dict(
        name="murmur3_pmod", route="cuda", source="blaze_tpu_torch/csrc/murmur3.cu",
        replaces="blaze_tpu/exprs/spark_hash.py:429", shape="400 rows x 1 int64 key",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=None, library_call=None,
        bytes=n * (8 + 1 + 4), ms_262144_rows=big_ms))


def slot_case(rng, dev, cap, n, key_lo, key_hi, k, nulls, with_minmax):
    import numpy as np
    import torch

    keys, kvalids = [], []
    for _ in range(k):
        kd = np.zeros(cap, np.int64)
        kv = np.zeros(cap, bool)
        kd[:n] = rng.integers(key_lo, key_hi, n)
        kv[:n] = rng.random(n) >= nulls
        kd[~kv] = 0
        keys.append(torch.from_numpy(kd).to(dev))
        kvalids.append(torch.from_numpy(kv).to(dev))
    amt = np.zeros(cap, np.int64)
    av = np.zeros(cap, bool)
    amt[:n] = rng.integers(0, 1_000_000, n)
    av[:n] = rng.random(n) >= nulls
    amt[~av] = 0
    a = (torch.from_numpy(amt).to(dev), torch.from_numpy(av).to(dev))
    exists = torch.from_numpy(np.arange(cap) < n).to(dev)
    specs = [("sum", 0, "int64"), ("count", 0, "")]
    args = [a, (torch.zeros(cap, dtype=torch.int64, device=dev), exists)]
    if with_minmax:
        specs += [("avg", 4, "int64"), ("min", 0, ""), ("max", 0, "")]
        args += [a, a, a]
    return keys, kvalids, specs, args


def kernel_k3_k4(dev, rng, results):
    import torch
    from blaze_tpu_torch.ops import agg_device as A
    from blaze_tpu_torch.ops.agg_device import plan_slot_table, probe_ranges
    from blaze_tpu_torch.config import Config

    conf = Config()
    cases3, cases4 = [], []
    merged_inputs = []
    for cap, n, lo, hi, k, nulls, mm, nbuck in (
            (262144, 262144, 1, N_STORES, 1, 0.0, False, 0),
            (262144, 200000, 1, N_CUSTOMERS, 1, 0.05, True, 256),
            (1024, 1000, -50, 50, 2, 0.2, True, 0),
            (1024, 700, 1 << 62, (1 << 62) + 30, 1, 0.0, True, 0)):
        keys, kvalids, specs, args = slot_case(rng, dev, cap, n, lo, hi, k, nulls, mm)
        probe = probe_ranges(keys, kvalids)
        bases, sizes, out_cap = plan_slot_table(probe, cap, None, conf.radix_agg_max_slots, conf)
        kd = [torch.int64] * k
        got = A.slot_agg_partial(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap, nbuck)
        want = A.slot_agg_partial_plain(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap, nbuck)
        check_equal("slot_agg_partial", f"cap={cap} n={n} k={k}", got, want)
        good = want[:-2] if nbuck else want
        cases3.append(f"cap={cap},n={n},k={k},keys=[{lo},{hi}),nulls={nulls},"
                      f"minmax={mm},buckets={nbuck}")
        # a key at base - 1 must flag the overflow (radix_pack's rule)
        bad = [x.clone() for x in keys]
        bad[0][0] = bases[0] - 1
        kv0 = [x.clone() for x in kvalids]
        kv0[0][0] = True
        got = A.slot_agg_partial(bad, kv0, kd, n, bases, sizes, specs, args, out_cap, nbuck)
        want = A.slot_agg_partial_plain(bad, kv0, kd, n, bases, sizes, specs, args, out_cap, nbuck)
        check_equal("slot_agg_partial", f"overflow cap={cap}", got, want)
        if int(got[0]) != -1:
            raise AssertionError("slot_agg_partial: key at base-1 did not flag overflow")
        # K4 over this partial output, twice concatenated (two maps' states)
        g = int(good[0])
        if g > 0:
            merged_inputs.append((k, specs, good, g))
    for k, specs, outs, g in merged_inputs:
        kinds = tuple(s[0] for s in specs)
        cap2 = conf.capacity_for(2 * g)
        cat = [torch.nn.functional.pad(torch.cat([x[:g], x[:g]]), (0, cap2 - 2 * g))
               for x in outs[2:]]
        keys = [cat[2 * i] for i in range(k)]
        kvalids = [cat[2 * i + 1] for i in range(k)]
        states, pos = [], 2 * k
        for kind in kinds:
            nst = {"sum": 2, "count": 1, "avg": 2, "min": 2, "max": 2}[kind]
            cols = []
            for j in range(nst):
                d = cat[pos + j]
                v = torch.ones_like(kvalids[0]) if d.dtype != torch.bool else d
                cols.append((d, v & (torch.arange(cap2, device=dev) < 2 * g)))
            states.append(cols)
            pos += nst
        probe = probe_ranges(keys, kvalids)
        bases, sizes, out_cap = plan_slot_table(probe, cap2, None, conf.radix_agg_max_slots, conf)
        kd = [torch.int64] * k
        got = A.slot_agg_merge(keys, kvalids, kd, 2 * g, bases, sizes, kinds, states, out_cap)
        want = A.slot_agg_merge_plain(keys, kvalids, kd, 2 * g, bases, sizes, kinds, states, out_cap)
        check_equal("slot_agg_merge", f"rows={2 * g} k={k}", got, want)
        cases4.append(f"rows={2 * g},k={k},aggs={'+'.join(kinds)}")

    # main path K3: one 262144-row q01 batch, store key (400 values ->
    # 512 dense slots), SUM(decimal) + COUNT
    cap = 262144
    keys, kvalids, specs, args = slot_case(rng, dev, cap, cap, 1, N_STORES, 1, 0.0, False)
    bases, sizes, out_cap = plan_slot_table(probe_ranges(keys, kvalids), cap, None,
                                            conf.dense_agg_max_buckets, conf)
    kd = [torch.int64]
    ms = time_ms(lambda: A.slot_agg_partial(keys, kvalids, kd, cap, bases, sizes, specs, args, out_cap))
    plain_ms = time_ms(lambda: A.slot_agg_partial_plain(keys, kvalids, kd, cap, bases, sizes, specs, args, out_cap))
    seg = (keys[0] - bases[0] + 1)
    S = sizes[0]
    t_sum = torch.zeros(S, dtype=torch.int64, device=dev)
    t_cnt = torch.zeros(S, dtype=torch.int64, device=dev)
    ones = torch.ones(cap, dtype=torch.int64, device=dev)

    def lib3():
        t_sum.index_add_(0, seg, args[0][0])
        t_cnt.index_add_(0, seg, ones)

    lib_ms = time_ms(lib3)
    nbytes = cap * (8 + 1 + 8 + 1) + out_cap * (8 + 1 + 8 + 1 + 8 + 1)
    results.append(dict(
        name="slot_agg_partial", route="cuda", source="blaze_tpu_torch/csrc/slot_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1255", shape=f"262144 rows -> {S} slots",
        cases=cases3, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="2x index_add_ into the slot tables (slot ids given)",
        bytes=nbytes))

    # main path K4: the final merge of 4 maps' partial states (~400 store
    # keys each): key, sum, has, count planes
    want = A.slot_agg_partial_plain(keys, kvalids, kd, cap, bases, sizes, specs, args, out_cap)
    g = int(want[0])
    n4 = PARTS * g
    cap4 = conf.capacity_for(n4)
    cat = [torch.nn.functional.pad(torch.cat([x[:g]] * PARTS), (0, cap4 - n4))
           for x in want[2:]]
    live = torch.arange(cap4, device=dev) < n4
    keys4, kv4 = [cat[0]], [cat[1] & live]
    states = [[(cat[2], cat[3] & live), (cat[3], live)], [(cat[4], live)]]
    bases4, sizes4, out4 = plan_slot_table(probe_ranges(keys4, kv4), cap4, None,
                                           conf.radix_agg_max_slots, conf)
    kinds = ("sum", "count")
    ms = time_ms(lambda: A.slot_agg_merge(keys4, kv4, kd, n4, bases4, sizes4, kinds, states, out4))
    plain_ms = time_ms(lambda: A.slot_agg_merge_plain(keys4, kv4, kd, n4, bases4, sizes4, kinds, states, out4))
    seg4 = keys4[0] - bases4[0] + 1
    S4 = sizes4[0]
    m_sum = torch.zeros(S4, dtype=torch.int64, device=dev)
    m_has = torch.zeros(S4, dtype=torch.int64, device=dev)
    m_cnt = torch.zeros(S4, dtype=torch.int64, device=dev)
    has64 = cat[3].to(torch.int64)

    def lib4():
        m_sum.index_add_(0, seg4, cat[2])
        m_has.index_add_(0, seg4, has64)
        m_cnt.index_add_(0, seg4, cat[4])

    lib_ms = time_ms(lib4)
    nbytes = n4 * (8 + 1 + 8 + 1 + 1 + 8) + out4 * (8 + 1 + 8 + 1 + 8)
    results.append(dict(
        name="slot_agg_merge", route="cuda", source="blaze_tpu_torch/csrc/slot_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1421",
        shape=f"{n4} state rows ({PARTS} maps) -> {S4} slots",
        cases=cases4, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="3x index_add_ into the slot tables (slot ids given)",
        bytes=nbytes))


# -- phase 4: q01 on the card -------------------------------------------------


def make_data(dev):
    """store_returns as bench.py:make_data draws it (seed 42, amt first),
    staged on the card as 262144-row batches per partition."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
    from blaze_tpu_torch.ir import types as T

    schema = T.Schema.of(("sr_store_sk", T.I64), ("sr_customer_sk", T.I64),
                         ("sr_return_amt", T.DecimalType(7, 2)))
    rng = np.random.default_rng(42)
    per = ROWS // PARTS
    host, parts = [], []
    bs = 262144
    for _ in range(PARTS):
        amt = rng.integers(0, 10_000_00, per)
        store = rng.integers(1, N_STORES, per)
        cust = rng.integers(1, N_CUSTOMERS, per)
        host.append((store, amt))
        cols = [torch.from_numpy(x).to(dev) for x in (store, cust, amt)]
        batches = []
        for s in range(0, per, bs):
            n = min(bs, per - s)
            cap = bs if n == bs else 1 << max(8, (n - 1).bit_length())
            dcols = []
            for f, c in zip(schema.fields, cols):
                d = torch.zeros(cap, dtype=torch.int64, device=dev)
                d[:n] = c[s:s + n]
                v = torch.zeros(cap, dtype=torch.bool, device=dev)
                v[:n] = True
                dcols.append(DeviceColumn(f.dtype, d, v))
            batches.append(ColumnarBatch(schema, dcols, n))
        parts.append(batches)
        del cols
    torch.cuda.synchronize()
    return schema, parts, host


def q01_plan(schema):
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    F = E.AggFunction
    scan = N.FFIReader(schema, "store_returns", PARTS)
    filt = N.Filter(scan, [E.BinaryExpr(E.BinaryOp.GT, E.Column("sr_return_amt"),
                                        E.Literal("500.00", T.DecimalType(7, 2)))])
    keys = [("sr_store_sk", E.Column("sr_store_sk"))]
    aggs = [("total", E.AggExpr(F.SUM, [E.Column("sr_return_amt")], T.DecimalType(17, 2))),
            ("cnt", E.AggExpr(F.COUNT, []))]
    partial = N.Agg(filt, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in aggs],
                    supports_partial_skipping=True)
    ex = N.ShuffleExchange(partial, N.HashPartitioning([E.Column("sr_store_sk")], PARTS))
    final = N.Agg(ex, E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in aggs])
    return N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                  [E.SortOrder(E.Column("total"), ascending=False)], fetch_limit=100)


def q01_oracle(host):
    import decimal

    import numpy as np

    store = np.concatenate([s for s, _ in host])
    amt = np.concatenate([a for _, a in host])
    keep = amt > 500_00
    s, a = store[keep], amt[keep]
    totals = np.bincount(s, weights=a, minlength=N_STORES).astype(np.float64)
    if totals.max() >= 2 ** 53:  # float64 sums of int64 are exact below 2^53
        raise AssertionError("q01 oracle: a total reached 2^53")
    totals = totals.astype(np.int64)
    counts = np.bincount(s, minlength=N_STORES)
    present = np.nonzero(counts)[0]
    order = np.lexsort((present, -totals[present]))[:100]
    top = present[order]
    return {"sr_store_sk": top.tolist(),
            "total": [decimal.Decimal(int(t)).scaleb(-2) for t in totals[top]],
            "cnt": counts[top].tolist()}


def run_slice(dev, profile=False, trace_path=None):
    import torch
    import blaze_tpu_torch
    from blaze_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    schema, parts, host = make_data(dev)
    setup_s = time.perf_counter() - t0
    plan = q01_plan(schema)
    want = q01_oracle(host)
    session = blaze_tpu_torch.Session()
    session.resources["store_returns"] = lambda p: parts[p]
    t0 = time.perf_counter()
    warm = session.execute_to_pydict(plan)
    warm_s = time.perf_counter() - t0
    if warm != want:
        raise AssertionError("q01 (warm-up run) differs from the numpy oracle")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    got = session.execute_to_pydict(plan)
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    if got != want:
        raise AssertionError("q01 differs from the numpy oracle")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by q01: {missing}")
    if profile:
        profile_q01(session, plan, want, trace_path)
    log(json.dumps({"phase": "slice", "query": "q01", "rows": ROWS, "partitions": PARTS,
                    "groups": len(got["sr_store_sk"]), "setup_s": setup_s,
                    "first_run_s": warm_s, "wall_s": wall, "rows_per_s": ROWS / wall,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "launches": launches, "exact": True}))
    return launches


def profile_q01(session, plan, want, trace_path=None):
    """One more q01 run under torch.profiler: the device's busy time (the
    kernels' and copies' own device time — one stream, so they do not
    overlap) against the run's wall, the launch/copy/sync counts, and the
    kernels that take the time; the Chrome trace to ``trace_path`` when
    given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = session.execute_to_pydict(plan)
        wall = time.perf_counter() - t0
    if got != want:
        raise AssertionError("q01 (profiled run) differs from the numpy oracle")
    avgs = prof.key_averages()
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    calls = {e.key: e.count for e in avgs
             if e.key in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    log(json.dumps({"phase": "profile", "query": "q01", "wall_s": wall,
                    "device_busy_s": busy_us / 1e6,
                    "device_busy_share": busy_us / 1e6 / wall,
                    "host_calls": calls,
                    "top_device": [{"name": e.key[:80], "calls": e.count,
                                    "device_ms": e.self_device_time_total / 1e3}
                                   for e in top]}))
    torch.cuda.synchronize()


def main(device: str = "cuda") -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import blaze_tpu_torch  # noqa: F401
        from blaze_tpu_torch.utils import cuda_lib
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    import numpy as np

    # 1. device
    card = card_line()
    dev = torch.device(device)
    log(json.dumps({"phase": "device", "nvidia_smi": card,
                    "name": torch.cuda.get_device_name(0),
                    "torch": torch.__version__, "cuda": torch.version.cuda}))
    # 2. build
    t0 = time.perf_counter()
    cuda_lib.library()
    regs = [ln.strip() for ln in str(cuda_lib.BUILD_INFO.get("ptxas", "")).splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    log(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                    "nvcc_seconds": cuda_lib.BUILD_INFO.get("seconds"),
                    "ptxas": regs}))
    # 3. kernels
    rng = np.random.default_rng(7)
    results = []
    kernel_k1(dev, rng, results)
    kernel_k2(dev, rng, results)
    kernel_k3_k4(dev, rng, results)
    # 4. slice
    args = sys.argv[1:]
    trace = [a.split("=", 1)[1] for a in args if a.startswith("--trace=")]
    launches = run_slice(dev, profile="--profile" in args,
                         trace_path=trace[0] if trace else None)
    # 5. summary lines
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in results:
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = MAX_ERR[r["name"]]
        log(json.dumps({"phase": "kernel", "name": r["name"], "shape": r["shape"],
                        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"], "library_call": r["library_call"],
                        "bound_ms": r["bound_ms"], "bytes": r["bytes"],
                        "launches": r["launches"], "exact_cases": r["cases"],
                        **({"ms_262144_rows": r["ms_262144_rows"]}
                           if "ms_262144_rows" in r else {})}))
        kernels.append({k: r[k] for k in keys})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
