#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blaze_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and the last line is printed
only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the kernel library from blaze_tpu_torch/csrc (nvcc, sm_90a),
   with its build seconds;
3. kernels: K1-K12 held against their plain PyTorch versions on the
   card, exactly (float planes bit for bit), at the main paths' shapes and
   at edge cases (nulls, all-false and all-true masks, padding rows, keys
   next to the slot range, one to three sort keys ASC/DESC with nulls
   first/last, int64 min/max, bools, f64 NaN, +-0.0 and subnormals, mixed plane
   capacities, offsets past the end, empty batches in a concat; for the
   join: misses, null probe keys, an empty build, one build key, a
   null-keyed build row, int32/f32/f64 keys with +-0.0 and NaN payloads,
   and q06's batch all hitting and half missing; for the generic probe:
   the same key kinds, keys below and above the build's range, an empty
   build, one build key, q69's probe batch and a 262,144-row batch of
   customer keys against the store window's keys; for the segmented
   aggregate: one to five int/float keys, direct and sorted segmentation,
   nulls, padding, all-null keys, int64/int32/f64/f32 arguments with NaN,
   +-0.0, +-inf and subnormals, partial and merge, a q67 batch and a
   q67_sort reducer's merge; for the fused chain, K11 (a Triton kernel
   generated per chain) with K1 after it: every step kind (project,
   filter, rename, expand, and a coalesce between two segments through
   FusedStageExec), i32/i64/f32/f64/bool/decimal planes, every ported
   operator, InList with a null item and negated, the FMA shapes, division
   by zero and by -1, int64 and f64 literals, capacities 256, 4,096 and
   262,144, batches all kept, none kept and empty; for the host table's
   slot update, K12: every aggregate the table updates (SUM, COUNT, AVG,
   MIN, MAX, FIRST, FIRST_IGNORES_NULL over int64, int32, float64,
   float32, bool and decimal arguments) in update and merge mode, nulls,
   padding, table growth, int64 wrap, NaN, +-0.0 and subnormals, a float
   sum whose value depends on the fold's order, FIRST with tied orders,
   an empty batch, and a q67_table merge batch); then each timed with
   CUDA events beside its plain version, one PyTorch library call (or a
   chain of them, said so) where one computes the same function, and its
   bound (bytes moved over 3.35 TB/s);
4. paths, each checked against a numpy oracle, with the launch counts
   set to 0 just before its measured run and read just after:
   - TPC-DS q01 (filter -> partial agg -> murmur3 hash exchange -> final
     agg -> top 100) over 28,795,080 store_returns rows (the SF100 row
     count) drawn as bench.py draws them;
   - q67 (two-key partial agg -> hash exchange -> final agg -> full sort
     -> rank window -> rank <= 3) over 28,800,991 store_sales rows (the
     SF10 row count) drawn as bench.py draws them (seed 67), order
     included; then q67_sort, the same plan and data with
     ``Config(dense_agg=False, radix_agg=False)``: the JAX package's
     route on a TPU, K10 in the partial and the merge;
   - q06 (store_sales JOIN broadcast item -> partial agg by category ->
     hash exchange -> final agg -> sort) and q47 (the same join -> agg by
     (category, brand) -> sort -> rank window -> rank <= 5) over one draw
     of 28,800,991 store_sales rows and SF10's 102,000 items (seed 6);
     q06 exact in order, q47's rows in order with the oracle's ranks
     (rows tied on quantity in any order);
   - q69 (customer JOIN broadcast address in three states -> exchange ->
     LEFT SEMI store window, LEFT ANTI web window, LEFT ANTI catalog
     window, each a shuffled hash join against sales JOIN broadcast
     date_dim of April-June 2001 -> JOIN broadcast demographics -> COUNT(*)
     by the five demographics TPC-DS names (sort route: K10) -> sort, top
     100) over TPC-DS SF10's row counts (seed 69), with the null filters
     Spark infers on its scans (each a fused stage: K11 + K1), exact in
     order against set operations in numpy;
   - q67_table: q67's plan and data under the default Config, whose 256
     MiB merge budget each reducer's partial states pass, so the FINAL
     merge is the host table's (K12 a state batch); groups leave the table
     in slot order, so rows tied on (item, qty) are checked as sets;
   - q96 (store_sales JOIN broadcast time_dim JOIN broadcast
     household_demographics JOIN broadcast store -> PARTIAL COUNT(1)
     without keys (the host table, K12 a batch) -> single exchange ->
     FINAL COUNT (the table's merge) -> top 100) over TPC-DS SF10's row
     counts (seed 96), with Spark's scan filters, exact against a numpy
     count;
   all through ``Session().execute_to_pydict`` in 4 partitions staged on
   the card; every kernel must have launched over the eight runs, the
   unique-key join kernel on each join path, the generic probe on q69,
   K10's three launches on q69 and q67_sort, K11 on every q69 sales
   batch (196) and on the root rank filter of q67, q67_sort and q47, and
   K12 on q96 and q67_table;
5. one JSON line per kernel (shape, times, bound, launches per path), the
   kernels' summary JSON line, the card line, and the device JSON line.

``--profile`` adds one run of each path under torch.profiler (device busy
share, launch and sync counts, the top kernels); ``--trace=PATH`` also
writes q01's Chrome trace to PATH and the other paths' beside it
(``_q67.json``, ``_q67_sort.json``, ``_q67_table.json``, ``_q06.json``,
``_q47.json``, ``_q69.json``, ``_q96.json``).

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
N_ITEMS = 2000
Q67_ROWS = 28_800_991
Q67_SEED = 67
Q67_GROUPS = 797_601  # (item, store) groups of q67 at Q67_ROWS: the kernels' shapes
# q67's final merge holds ~6.2M partial-state rows per reducer (~330 MB
# at their capacity buckets), past the 256 MB default beyond which the
# merge is the host table's (q67_table runs that route); q67 and q67_sort
# keep the device merge (K4, K10) with a budget the card holds
Q67_MERGE_BYTES = 2 << 30
Q06_ROWS = 28_800_991  # q06 and q47 share one store_sales draw
Q06_ITEMS = 102_000   # TPC-DS SF10's item row count
Q06_SEED = 6
Q69_SEED = 69
# TPC-DS SF10 row counts of q69's tables
Q69_ROWS = {"customer": 500_000, "customer_address": 250_000,
            "customer_demographics": 1_920_800, "date_dim": 73_049,
            "store_sales": 28_800_991, "web_sales": 7_197_566,
            "catalog_sales": 14_401_261}
Q69_STATES = (4, 17, 42)  # the ca_state codes of the IN list, of 51
Q69_SALES_DATES = (2_450_816, 2_452_642)  # the sales' first and last d_date_sk
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
    if not a.numel():
        return 0.0
    if a.is_floating_point():
        # bit for bit: -0.0 against +0.0, or one NaN payload against
        # another, counts as a difference
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        if torch.equal(a.view(bits), b.view(bits)):
            return 0.0
        diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
        return float(torch.nan_to_num(diff, nan=float("inf")).max().clamp(min=1e-300).item())
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item())


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
    # float planes with NaN, +-0.0, +-inf and subnormals move bit for bit
    cap = 1024
    floats = np.array(SEG_FLOATS)[rng.integers(0, len(SEG_FLOATS), cap)]
    with np.errstate(over="ignore"):
        datas = [torch.from_numpy(floats).to(dev), torch.from_numpy(floats[::-1].astype(
            np.float32)).to(dev)]
    valids = [torch.ones(cap, dtype=torch.bool, device=dev)] * 2
    mask = torch.from_numpy(rng.random(cap) < 0.6).to(dev)
    check_equal("compact_planes", "f64/f32 subnormals",
                K.compact_planes_cuda(datas, valids, mask),
                K.compact_planes_plain(datas, valids, mask))
    cases.append("cap=1024,f64+f32 planes with subnormals")
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


# K5-K7 cases: the CPU parity tests' shapes (tests/test_torch_sort_window.py)
# and the main path's
SORT_KEY_CASES = (
    ((("i64", True, True),), 256, 200, 0.1),
    ((("i64", False, False),), 4096, 4096, 0.05),
    ((("i64", True, True), ("i32", False, True)), 4096, 3000, 0.1),
    ((("bool", True, False), ("f64", False, True), ("i64", True, False)), 256, 250, 0.2),
    ((("f64", True, True),), 4096, 4000, 0.1),
    ((("f32", False, False),), 256, 256, 0.0),
    ((("bool", False, False),), 256, 100, 0.3),
    ((("i64", True, True), ("i64", False, True)), 1 << 20, 797_601, 0.0),
)
F64_SPECIALS = (0.0, -0.0, float("nan"), float("-nan"), float("inf"), float("-inf"), 1.5, -1.5,
                5e-324, -5e-324, 1e-310, 1e-40, -1e-45)  # subnormals (f64; f32 last two)


def key_plane(kind, cap, n, rng, nulls, dev):
    import numpy as np
    import torch

    npdt = {"i64": np.int64, "i32": np.int32, "bool": np.bool_, "f64": np.float64,
            "f32": np.float32}[kind]
    d = np.zeros(cap, npdt)
    if kind in ("i64", "i32"):
        hi = 1 << 13 if n > 100_000 else 4
        vals = rng.integers(-hi, hi, n)
        if kind == "i64" and n <= 100_000:
            vals[rng.random(n) < 0.1] = np.iinfo(np.int64).min
            vals[rng.random(n) < 0.1] = np.iinfo(np.int64).max
        d[:n] = vals
    elif kind == "bool":
        d[:n] = rng.random(n) < 0.5
    else:
        d[:n] = rng.choice(np.array(F64_SPECIALS), n)
    v = np.zeros(cap, bool)
    v[:n] = rng.random(n) >= nulls
    d[~v] = 0
    return torch.from_numpy(d).to(dev), torch.from_numpy(v).to(dev)


def q67_sort_keys(rng, dev):
    """The q67 full sort's input: ~797,601 (item, store) groups in a
    1,048,576-row bucket, item ASC then the quantity sum DESC (sums of ~36
    quantities in [1, 100))."""
    import numpy as np
    import torch

    cap, n = 1 << 20, Q67_GROUPS
    item = np.zeros(cap, np.int64)
    qty = np.zeros(cap, np.int64)
    item[:n] = rng.integers(1, N_ITEMS, n)
    qty[:n] = rng.poisson(36.1, n) * 50 + rng.integers(-49, 50, n)
    v = np.arange(cap) < n
    return ([torch.from_numpy(x).to(dev) for x in (item, qty)],
            [torch.from_numpy(v).to(dev)] * 2, torch.from_numpy(v).to(dev), n)


def kernel_k5(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for keys, cap, n, nulls in SORT_KEY_CASES:
        planes = [key_plane(kind, cap, n, rng, nulls, dev) for kind, _, _ in keys]
        spec = tuple((asc, nf) for _, asc, nf in keys)
        exists = torch.arange(cap, device=dev) < n
        datas, valids = [p[0] for p in planes], [p[1] for p in planes]
        got = K.sort_key_operands_cuda(datas, valids, exists, spec)
        want = K.sort_key_operands_plain(datas, valids, exists, spec)
        label = f"keys={'+'.join(k for k, _, _ in keys)},cap={cap},n={n},nulls={nulls}"
        check_equal("sort_key_operands", label, got, want)
        for rows in (n, None):
            check_equal("lexsort_indices", f"{label},num_rows={rows}",
                        K.lexsort_indices_cuda(want, rows),
                        K.lexsort_indices_plain(want, rows))
        cases.append(label)
    # the exchange's pid sort (one int32 operand) and a raw f64 operand
    # with signed zeros and infinities (the sort's own word mapping; the
    # key pass never hands it a NaN)
    pids = torch.randint(0, PARTS, (229_000,), dtype=torch.int32, device=dev)
    check_equal("lexsort_indices", "pids", K.lexsort_indices_cuda([pids]),
                K.lexsort_indices_plain([pids]))
    raw, _ = key_plane("f64", 4096, 4096, rng, 0.0, dev)
    raw = torch.nan_to_num(raw, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
    check_equal("lexsort_indices", "raw f64", K.lexsort_indices_cuda([raw]),
                K.lexsort_indices_plain([raw]))
    cases += ["pids int32 n=229000", "raw f64 +-0.0 +-inf n=4096"]

    # main path: the q67 full sort
    datas, valids, exists, n = q67_sort_keys(rng, dev)
    spec = ((True, True), (False, True))
    cap = exists.shape[0]
    ops = K.sort_key_operands_cuda(datas, valids, exists, spec)
    ms = time_ms(lambda: K.sort_key_operands_cuda(datas, valids, exists, spec))
    plain_ms = time_ms(lambda: K.sort_key_operands_plain(datas, valids, exists, spec))
    results.append(dict(
        name="sort_key_operands", route="cuda", source="blaze_tpu_torch/csrc/sort.cu",
        replaces="blaze_tpu/core/kernels.py:293", shape=f"{cap} rows x 2 int64 keys",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=None, library_call=None,
        bytes=cap * (1 + 2 * (8 + 1) + 2 * (1 + 8))))
    ms = time_ms(lambda: K.lexsort_indices_cuda(ops, n))
    plain_ms = time_ms(lambda: K.lexsort_indices_plain(ops, n))

    def chained_sort():
        idx = torch.arange(n, device=dev)
        for op in reversed(ops):
            key = op[idx]
            idx = idx[torch.sort(key.to(torch.int16) if key.dtype == torch.uint8 else key,
                                 stable=True).indices]
        return idx

    lib_ms = time_ms(chained_sort)
    passes = K.radix_passes(_and_or(ops, n), [op.element_size() for op in ops])
    results.append(dict(
        name="lexsort_indices", route="cuda", source="blaze_tpu_torch/csrc/sort.cu",
        replaces="blaze_tpu/ops/sort.py:46", shape=f"{n} of {cap} rows, 4 operands, "
        f"{len(passes)} digit passes", cases=cases, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library_call="torch.sort(stable=True) chained per operand",
        bytes=n * (1 + 8 + 1 + 8) + cap * 8, digit_passes=len(passes)))


def _and_or(ops, n):
    """Per operand the AND and the OR of its sort words over rows [0, n)
    (what the kernel's bits pass computes, for integer operands), for the
    pass count."""
    import numpy as np

    out = []
    for op in ops:
        x = op[:n].cpu().numpy()
        size = x.dtype.itemsize
        w = x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[size]).astype(np.uint64)
        if x.dtype.kind == "i":
            w = w ^ np.uint64(1 << (8 * size - 1))
        out += [np.bitwise_and.reduce(w), np.bitwise_or.reduce(w)]
    return np.array(out, np.uint64)


def mixed_planes(rng, caps, n_live, dev):
    import numpy as np
    import torch

    datas, valids = [], []
    for cap, dt in zip(caps, (np.int64, np.int32, np.bool_, np.float64)):
        d = np.zeros(cap, dt)
        v = np.zeros(cap, bool)
        m = min(n_live, cap)
        d[:m] = rng.integers(-1000, 1000, m) if dt != np.bool_ else rng.random(m) < 0.5
        v[:m] = rng.random(m) >= 0.2
        d[~v] = 0
        datas.append(torch.from_numpy(d).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    return datas, valids


def kernel_k6(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    datas, valids = mixed_planes(rng, (4096, 4096, 1024, 4096), 3000, dev)
    for out_cap, n_out, masked in ((256, 200, False), (4096, 4096, False), (256, 0, False),
                                   (1024, 700, True), (256, 256, True)):
        idx = torch.randint(0, 3000, (n_out,), device=dev)
        live = (torch.rand(n_out, device=dev) < 0.7) if masked else None
        got = K.gather_planes_cuda(datas, valids, idx, out_cap, n_out, live)
        want = K.gather_planes_plain(datas, valids, idx, out_cap, n_out, live)
        check_equal("gather_planes", f"out_cap={out_cap} n_out={n_out} masked={masked}",
                    got, want)
        cases.append(f"out_cap={out_cap},n_out={n_out},masked={masked},mixed caps")
    # main path: the q67 sort's take of 797,601 of 1,048,576 rows
    cap, n = 1 << 20, Q67_GROUPS
    datas, valids = planes(n, cap, 3, rng, dev)
    idx = torch.randperm(n, device=dev)
    check_equal("gather_planes", "q67 take", K.gather_planes_cuda(datas, valids, idx, cap, n),
                K.gather_planes_plain(datas, valids, idx, cap, n))
    cases.append(f"out_cap={cap},n_out={n},3 int64 + 3 bool planes")
    ms = time_ms(lambda: K.gather_planes_cuda(datas, valids, idx, cap, n))
    plain_ms = time_ms(lambda: K.gather_planes_plain(datas, valids, idx, cap, n))
    lib_ms = time_ms(lambda: [torch.index_select(x, 0, idx) for x in datas + valids])
    results.append(dict(
        name="gather_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:181", shape=f"{n} of {cap} rows x 6 planes",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="torch.index_select per plane",
        bytes=n * 8 + n * 3 * (8 + 1) + cap * 3 * (8 + 1)))


def kernel_k7(dev, rng, results):
    import torch
    import torch.nn.functional as Fn
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for cap, num_rows, offset, length, out_cap in (
            (4096, 3000, 0, 256, 256), (4096, 3000, 2900, 256, 256),
            (4096, 3000, 3000, 256, 256), (4096, 3000, 5000, 256, 256),
            (256, 256, 10, 200, 256)):
        datas, valids = mixed_planes(rng, (cap,) * 4, num_rows, dev)
        length = max(0, min(length, num_rows - offset))
        check_equal("slice_planes", f"offset={offset} length={length}",
                    K.slice_planes_cuda(datas, valids, offset, length, out_cap),
                    K.slice_planes_plain(datas, valids, offset, length, out_cap))
        cases.append(f"cap={cap},offset={offset},length={length}")
    ccases = []
    for k in range(1, 6):
        caps = [256, 1024, 256, 512, 256][:k]
        rows = [200, 0, 256, 37, 0][:k]
        per = [mixed_planes(rng, (c,) * 4, n, dev) for c, n in zip(caps, rows)]
        pd = [[b[0][f] for b in per] for f in range(4)]
        pv = [[b[1][f] for b in per] for f in range(4)]
        out_cap = max(256, 1 << (sum(rows) - 1).bit_length())
        check_equal("concat_planes", f"k={k}",
                    K.concat_planes_cuda(pd, pv, rows, out_cap),
                    K.concat_planes_plain(pd, pv, rows, out_cap))
        ccases.append(f"k={k},rows={rows}")
    # main path: the full sort's 262144-row output slices of the sorted
    # 1,048,576-row batch, and its concat of the four reducers' outputs
    cap, n, bs = 1 << 20, Q67_GROUPS, 262144
    datas, valids = planes(n, cap, 3, rng, dev)
    off = 3 * bs
    length = n - off
    check_equal("slice_planes", "q67 last slice", K.slice_planes_cuda(datas, valids, off, length, bs),
                K.slice_planes_plain(datas, valids, off, length, bs))
    cases.append(f"cap={cap},offset={off},length={length} (q67)")
    ms = time_ms(lambda: K.slice_planes_cuda(datas, valids, 0, bs, bs))
    plain_ms = time_ms(lambda: K.slice_planes_plain(datas, valids, 0, bs, bs))
    lib_ms = time_ms(lambda: [torch.cat([x[0:bs]]) for x in datas + valids])
    results.append(dict(
        name="slice_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:233", shape=f"{bs} of {cap} rows x 6 planes",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="torch.cat of the live prefix + pad per plane (k = 1: a copy)",
        bytes=2 * bs * 3 * (8 + 1)))
    rows = [n // 4 + (1 if i < n % 4 else 0) for i in range(4)]
    parts = [planes(r, bs, 3, rng, dev) for r in rows]
    pd = [[p[0][f] for p in parts] for f in range(3)]
    pv = [[p[1][f] for p in parts] for f in range(3)]
    check_equal("concat_planes", "q67 concat", K.concat_planes_cuda(pd, pv, rows, cap),
                K.concat_planes_plain(pd, pv, rows, cap))
    ccases.append(f"k=4,rows={rows} (q67)")
    ms = time_ms(lambda: K.concat_planes_cuda(pd, pv, rows, cap))
    plain_ms = time_ms(lambda: K.concat_planes_plain(pd, pv, rows, cap))
    lib_ms = time_ms(lambda: [Fn.pad(torch.cat([x[:r] for x, r in zip(p, rows)]), (0, cap - n))
                              for p in pd + pv])
    results.append(dict(
        name="concat_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:354", shape=f"4 x ~{n // 4} rows -> {cap} x 6 planes",
        cases=ccases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="torch.cat of the live prefixes + pad per plane",
        bytes=n * 3 * (8 + 1) + cap * 3 * (8 + 1)))


# K8 cases: the CPU parity tests' (tests/test_torch_joins.py): key kind,
# probe capacity, live rows, build keys, build capacity, null probe keys
JOIN_CASES = (
    ("i64", 256, 200, 60, 256, 0.0),
    ("i64", 256, 256, 60, 64, 0.2),
    ("i64", 4096, 3000, 700, 1024, 0.05),
    ("i64", 256, 180, 0, 256, 0.0),
    ("i64", 256, 200, 1, 256, 0.1),
    ("i64", 256, 200, 40, 41, 0.0),
    ("i32", 4096, 4000, 300, 512, 0.1),
    ("f32", 256, 250, 8, 256, 0.1),
    ("f64", 4096, 3500, 10, 256, 0.1),
)


def join_case(kind, cap_p, n, nk, cap_b, nulls, rng, dev):
    """K8's arguments: the sorted unique words of nk build keys (code c
    is build row c; one null-keyed build row after them), and a probe
    batch whose key misses about a third of the time and, for float keys,
    carries +-0.0 and several NaN payloads; int32, decimal and bool probe
    planes beside it."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ops.joins.keymap import _canon_words

    npdt = {"i64": np.int64, "i32": np.int32, "f32": np.float32, "f64": np.float64}[kind]
    if kind in ("f32", "f64"):
        nans = (np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                          0x7FF0000000000001], np.uint64).view(np.float64)
                if kind == "f64" else
                np.array([0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001],
                         np.uint32).view(np.float32))
        subnormal = (np.array([5e-324, -5e-324, 1e-310], np.float64) if kind == "f64"
                     else np.array([1e-40, -1e-45, 1e-39], np.float32))
        pool = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.25,
                                         -1e30, 7.0, 3.0], npdt), nans, subnormal])
        _, first = np.unique(_canon_words(pool), return_index=True)
        distinct = pool[np.sort(first)]
        bvals = distinct[rng.permutation(len(distinct))[:nk]]
        probe_pool = np.concatenate([pool, np.array([5.0, -7.5, 1e-3], npdt)])
    else:
        bvals = rng.choice(np.arange(-5000, 5000), nk, replace=False).astype(npdt)
        if nk:
            bvals[0] = np.iinfo(npdt).min
        probe_pool = np.concatenate([np.tile(bvals, max(1, 64 // max(nk, 1))),
                                     rng.integers(-5000, 5000, 64).astype(npdt)])
    words = _canon_words(bvals)
    uniq = np.unique(words) if nk else np.zeros(1, np.int64)
    live_b = np.arange(cap_b) < min(nk + 1, cap_b)
    bkey = np.zeros(cap_b, npdt)
    bkey[:nk] = bvals[np.argsort(words, kind="stable")]
    bpay = np.where(live_b, rng.integers(-10**12, 10**12, cap_b), 0)
    build = [(bkey, np.arange(cap_b) < nk), (bpay, live_b),
             ((rng.random(cap_b) < 0.5) & live_b, live_b)]
    live = np.arange(cap_p) < n
    pk_v = live & (rng.random(cap_p) >= nulls)
    pk = np.where(pk_v, probe_pool[rng.integers(0, len(probe_pool), cap_p)], 0).astype(npdt)
    pdec_v = live & (rng.random(cap_p) >= 0.1)
    probe = [(pk, pk_v), (np.where(live, rng.integers(-99, 99, cap_p), 0).astype(np.int32), live),
             (np.where(pdec_v, rng.integers(0, 10**6, cap_p), 0), pdec_v),
             ((rng.random(cap_p) < 0.5) & live, live)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(uniq), nk, n, t(pk), t(pk_v), [t(d) for d, _ in probe], [t(v) for _, v in probe],
            [t(d) for d, _ in build], [t(v) for _, v in build])


def q06_join_batch(rng, dev, miss, nulls):
    """One q06 probe batch (262,144 store_sales rows: item, store,
    quantity, price) against the SF10 item dimension (102,000 rows,
    keys 1..102,000, in a 131,072-row bucket). ``miss`` of the item keys
    fall past the dimension, ``nulls`` are null."""
    import numpy as np
    import torch

    cap, nk, cap_b = 262144, Q06_ITEMS, 131072
    item = rng.integers(1, nk + 1, cap)
    out = rng.random(cap) < miss
    item[out] = rng.integers(nk + 1, 2 * nk, int(out.sum()))
    kv = rng.random(cap) >= nulls
    item[~kv] = 0
    probe = [item, rng.integers(1, N_STORES, cap), rng.integers(1, 100, cap),
             rng.integers(0, 500_00, cap)]
    live_b = np.arange(cap_b) < nk
    build = [np.where(live_b, np.arange(1, cap_b + 1), 0)] + [
        np.where(live_b, rng.integers(lo, hi, cap_b), 0)
        for lo, hi in ((0, 10), (1, 60), (0, 300_00))]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ones_p = torch.ones(cap, dtype=torch.bool, device=dev)
    return (t(np.arange(1, nk + 1)), nk, cap, t(item), t(kv),
            [t(x) for x in probe], [t(kv)] + [ones_p] * 3,
            [t(x) for x in build], [t(live_b)] * 4)


def kernel_k8(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for kind, cap_p, n, nk, cap_b, nulls in JOIN_CASES:
        args = join_case(kind, cap_p, n, nk, cap_b, nulls, rng, dev)
        label = f"key={kind},cap_p={cap_p},n={n},nk={nk},cap_b={cap_b},nulls={nulls}"
        check_equal("inner_join_planes", label, K.inner_join_planes_cuda(*args),
                    K.inner_join_planes_plain(*args))
        cases.append(label)
    # the main path's shape: all hit, then ~50% misses with 5% null keys
    for miss, nulls in ((0.5, 0.05), (0.0, 0.0)):
        args = q06_join_batch(rng, dev, miss, nulls)
        got = K.inner_join_planes_cuda(*args)
        check_equal("inner_join_planes", f"q06 miss={miss} nulls={nulls}", got,
                    K.inner_join_planes_plain(*args))
        cases.append(f"q06 262144 x 4 cols vs 102000 x 4 cols, miss={miss},nulls={nulls}")
    uniq, nk, n, key, kv, pd, pv, bd, bv = args

    def library():
        idx = torch.searchsorted(uniq, key)
        cidx = idx.clamp(max=nk - 1)
        rows = torch.nonzero(kv & (idx < nk) & (uniq[cidx] == key)).squeeze(1)
        brow = cidx.index_select(0, rows)
        return ([p.index_select(0, rows) for p in list(pd) + list(pv)] +
                [p.index_select(0, brow) for p in list(bd) + list(bv)])

    ms = time_ms(lambda: K.inner_join_planes_cuda(*args))
    plain_ms = time_ms(lambda: K.inner_join_planes_plain(*args))
    lib_ms = time_ms(library)
    hits = int(got[0])
    row_p = sum(x.element_size() for x in list(pd) + list(pv))
    row_b = sum(x.element_size() for x in list(bd) + list(bv))
    touched = int(torch.unique(key[:n][kv[:n]]).numel())  # build rows the hits read
    nbytes = (n * (key.element_size() + 1) + hits * (row_p - key.element_size() - 1)
              + nk * 8 + touched * row_b + n * (row_p + row_b))
    results.append(dict(
        name="inner_join_planes", route="cuda", source="blaze_tpu_torch/csrc/join.cu",
        replaces="blaze_tpu/ops/joins/bhj.py:38",
        shape=f"{n} probe rows x 4 cols (all hit) vs {nk} build rows x 4 cols",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="torch.searchsorted + torch.nonzero + index_select per plane "
                     "(a chain of calls)",
        bytes=nbytes, build_rows_touched=touched, hits=hits))


# K9 cases: the CPU parity tests' (tests/test_torch_generic_joins.py): key
# kind, capacity, live rows, build keys, null probe keys
PROBE_CASES = (
    ("i64", 256, 200, 60, 0.1),
    ("i64", 4096, 4096, 700, 0.05),
    ("i64", 256, 180, 0, 0.0),
    ("i64", 256, 200, 1, 0.1),
    ("i32", 4096, 3000, 300, 0.1),
    ("f32", 256, 250, 8, 0.1),
    ("f64", 4096, 3500, 10, 0.1),
    ("f64", 256, 100, 1, 0.0),
)


def probe_case(kind, cap, n, nk, nulls, rng, dev):
    """K9's arguments: the sorted unique words of nk build keys and a probe
    key plane whose keys hit, miss inside the build's range and below and
    above it, or are null (float keys: +-0.0 and several NaN payloads);
    padding rows past n."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ops.joins.keymap import _canon_words

    npdt = {"i64": np.int64, "i32": np.int32, "f32": np.float32, "f64": np.float64}[kind]
    if kind in ("f32", "f64"):
        nans = (np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                          0x7FF0000000000001], np.uint64).view(np.float64)
                if kind == "f64" else
                np.array([0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001],
                         np.uint32).view(np.float32))
        subnormal = (np.array([5e-324, -5e-324, 1e-310], np.float64) if kind == "f64"
                     else np.array([1e-40, -1e-45, 1e-39], np.float32))
        pool = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 2.25,
                                         -1e30, 7.0, 3.0], npdt), nans, subnormal])
        _, first = np.unique(_canon_words(pool), return_index=True)
        bvals = pool[np.sort(first)][rng.permutation(len(first))[:nk]]
        probe_pool = np.concatenate([pool, np.array([5.0, -7.5, 1e-3, -1e38, 1e38], npdt)])
    else:
        info = np.iinfo(npdt)
        bvals = rng.choice(np.arange(-5000, 5000), nk, replace=False).astype(npdt)
        if nk > 2:
            bvals[:2] = (info.min, info.max)
        probe_pool = np.concatenate([
            np.tile(bvals, max(1, 64 // max(nk, 1))),
            rng.integers(-5000, 5000, 64).astype(npdt),
            np.array([-9000, 9000, info.min + 1, info.max - 1], npdt)])
    uniq = np.unique(_canon_words(bvals)) if nk else np.zeros(1, np.int64)
    valid = (np.arange(cap) < n) & (rng.random(cap) >= nulls)
    key = np.where(valid, probe_pool[rng.integers(0, len(probe_pool), cap)], 0).astype(npdt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(uniq), nk, t(key), t(valid)


def customer_probe(rng, dev, cap, n, build_rows, nulls, keys):
    """A probe batch of customer keys (uniform over ``keys`` customers, a
    ``nulls`` share null) against the sorted distinct customer keys of
    ``build_rows`` sales rows (uniform over the same customers)."""
    import numpy as np
    import torch

    uniq = np.unique(rng.integers(1, keys + 1, build_rows))
    valid = (np.arange(cap) < n) & (rng.random(cap) >= nulls)
    key = np.where(valid, rng.integers(1, keys + 1, cap), 0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(uniq), len(uniq), t(key), t(valid)


def kernel_k9(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for kind, cap, n, nk, nulls in PROBE_CASES:
        args = probe_case(kind, cap, n, nk, nulls, rng, dev)
        label = f"key={kind},cap={cap},n={n},nk={nk},nulls={nulls}"
        check_equal("probe_codes", label, K.probe_codes_cuda(*args),
                    K.probe_codes_plain(*args))
        cases.append(label)
    # q69's shapes: one partition's probe (~7,100 customers against the
    # ~118,000 distinct keys of its store window, both drawn from the
    # 125,000 customer keys that hash to one of 4 partitions) and one
    # 262,144-row batch (4% null) against all ~470,000 window keys
    window = Q69_ROWS["store_sales"] * 91 // 1827
    customers = Q69_ROWS["customer"]
    main = customer_probe(rng, dev, 8192, 7100, window // 4, 0.0, customers // 4)
    big = customer_probe(rng, dev, 262144, 262144, window, 0.04, customers)
    for label, args in (("q69 partition probe", main), ("262144 customer keys", big)):
        check_equal("probe_codes", label, K.probe_codes_cuda(*args),
                    K.probe_codes_plain(*args))
        cases.append(f"{label}: cap={args[2].shape[0]}, nk={args[1]}")

    def library(uniq, nk, key, valid):
        idx = torch.searchsorted(uniq, key)
        cidx = idx.clamp(max=nk - 1)
        return torch.where(valid & (idx < nk) & (uniq[cidx] == key), cidx, -1)

    def nbytes(uniq, nk, key, valid):
        # validity and codes for every row, the key of each valid row, the
        # sorted keys once
        cap = key.shape[0]
        return cap * (1 + 8) + int(valid.sum()) * key.element_size() + nk * 8

    timed = {}
    for name, args in (("main", main), ("big", big)):
        timed[name] = (time_ms(lambda: K.probe_codes_cuda(*args)),
                       time_ms(lambda: K.probe_codes_plain(*args)),
                       time_ms(lambda: library(*args)), nbytes(*args))
    ms, plain_ms, lib_ms, nb = timed["main"]
    results.append(dict(
        name="probe_codes", route="cuda", source="blaze_tpu_torch/csrc/join.cu",
        replaces="blaze_tpu/ops/joins/keymap.py:226",
        shape=f"{int(main[3].sum())} customer keys in an 8192-row plane vs "
              f"{main[1]} sorted build keys (a q69 partition's store window)",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="torch.searchsorted + compare + torch.where (a chain of calls)",
        bytes=nb, ms_262144_rows=timed["big"][0],
        big_batch={"nk": big[1], "kernel_ms": timed["big"][0],
                   "plain_ms": timed["big"][1], "library_ms": timed["big"][2],
                   "bound_ms": timed["big"][3] / HBM_BYTES_PER_S * 1e3}))


# K10 cases: the CPU parity tests' (tests/test_torch_sort_agg.py): key kinds,
# capacity, live rows, null share, key range
SEG_CASES = (
    (("i64",), 256, 200, 0.2, (-40, 40)),               # sorted (negative keys)
    (("i64",), 256, 256, 0.1, (0, 255)),                # direct: keys in [0, cap-1)
    (("i64",), 256, 230, 0.1, (0, 256)),                # a key at cap-1: sorted
    (("i32",), 1024, 1000, 0.0, (0, 20)),               # direct, no nulls
    (("f64",), 4096, 4000, 0.1, (0, 1)),                # float keys
    (("f32", "i64"), 1024, 900, 0.1, (-3, 3)),
    (("i64", "i32", "i64"), 4096, 4000, 0.05, (-4, 4)),
    (("i64", "i64", "i64", "i64"), 4096, 4000, 0.1, (0, 4)),
    (("i64", "i32", "f64", "i64", "i64"), 4096, 3000, 0.1, (0, 3)),
    (("i64",), 256, 200, 1.0, (0, 10)),                 # every key null
    (("i64", "i64"), 256, 1, 0.0, (0, 5)),              # one row
)
# NaN, +-0.0, +-inf, normal values and subnormals (which the port keeps)
SEG_FLOATS = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"), 1.5, -2.25, 1e300,
              -1e300, 7.0, 3.0, 0.1, 5e-324, -5e-324, 1e-310, -1e-310, 1e-40, -1e-45)
# aggregate (kind, rescale, accumulator) and the column it reads: int64 a,
# int32 b, float64 x, float32 y, * for COUNT(*)
SEG_SPECS = ((("sum", 0, "int64"), "a"), (("count", 0, ""), "*"), (("avg", 4, "int64"), "a"),
             (("min", 0, ""), "b"), (("max", 0, ""), "b"), (("sum", 0, "float64"), "x"),
             (("min", 0, ""), "x"), (("max", 0, ""), "x"), (("avg", 0, "float64"), "a"),
             (("sum", 0, "float64"), "y"), (("min", 0, ""), "y"))


def seg_plane(kind, cap, n, rng, nulls, lo, hi):
    import numpy as np

    live = np.arange(cap) < n
    if kind in ("f64", "f32"):
        d = np.array(SEG_FLOATS)[rng.integers(0, len(SEG_FLOATS), cap)]
        with np.errstate(over="ignore"):
            d = d.astype(np.float64 if kind == "f64" else np.float32)
    else:
        d = rng.integers(lo, hi, cap).astype(np.int64 if kind == "i64" else np.int32)
    return np.where(live, d, 0).astype(d.dtype), live & (rng.random(cap) >= nulls)


def seg_case(kinds, cap, n, nulls, key_range, rng):
    """K10's partial arguments on the host: key planes (validity masked
    with the live rows), SEG_SPECS and their (data, valid) columns."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    keys = [seg_plane(k, cap, n, rng, nulls, *key_range) for k in kinds]
    cols = {"a": seg_plane("i64", cap, n, rng, nulls, -10 ** 6, 10 ** 6),
            "b": seg_plane("i32", cap, n, rng, nulls, -1000, 1000),
            "x": seg_plane("f64", cap, n, rng, nulls, 0, 0),
            "y": seg_plane("f32", cap, n, rng, nulls, 0, 0),
            "*": (np.zeros(cap, np.int64), np.arange(cap) < n)}
    return ([t(d) for d, _ in keys], [t(v) for _, v in keys], tuple(s for s, _ in SEG_SPECS),
            [(t(cols[c][0]), t(cols[c][1])) for _, c in SEG_SPECS])


def merge_states(outs, k, kinds, n, rng):
    """Partial outputs as merge-input state columns (validity redrawn so
    every gate of the merge is taken), on the outputs' device."""
    import numpy as np
    import torch

    live = torch.arange(outs[1].shape[0], device=outs[1].device) < n
    states, pos = [], 2 + 2 * k
    for kind in kinds:
        cols = []
        for _ in range({"sum": 2, "count": 1, "avg": 2, "min": 2, "max": 2}[kind]):
            keep = torch.from_numpy(rng.random(live.shape[0]) >= 0.1).to(live.device)
            cols.append((outs[pos], keep & live))
            pos += 1
        states.append(cols)
    return states


def check_seg_pipeline(name, fn, args_cuda, args_cpu, label):
    """K10's route on the card against the same route on CPU copies (the
    plain versions of K5, K10 and K6)."""
    got = fn(*args_cuda)
    want = fn(*args_cpu)
    if int(got[0]) != int(want[0]):
        raise AssertionError(f"{name} [{label}]: {int(got[0])} groups vs {int(want[0])}")
    check_equal(name, label, [g.cpu() for g in got[1:]], list(want[1:]))
    return got


def to_dev(x, dev):
    if isinstance(x, (list, tuple)):
        return type(x)(to_dev(y, dev) for y in x)
    return x.to(dev) if hasattr(x, "to") else x


def q67_batch(rng, dev, cap=262144):
    """One q67 partial batch: 262,144 store_sales rows, (item, store) keys,
    SUM(quantity) -- about 223,000 groups."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ones = t(np.ones(cap, bool))
    keys = [t(rng.integers(1, N_ITEMS, cap)), t(rng.integers(1, N_STORES, cap))]
    return keys, [ones, ones], (("sum", 0, "int64"),), [(t(rng.integers(1, 100, cap)), ones)]


def q67_merge_input(rng, dev, rows=6_200_000, groups=200_000, cap=1 << 23):
    """One q67_sort reducer's merge: ~6.2M (item, store) partial-state rows
    (sum, has) of ~200,000 groups in an 8,388,608-row bucket."""
    import numpy as np
    import torch

    g = rng.integers(0, groups, rows) * 4
    live = np.arange(cap) < rows

    def pad(x, dt):
        out = np.zeros(cap, dt)
        out[:rows] = x
        return torch.from_numpy(out).to(dev)

    keys = [pad(1 + g // N_STORES, np.int64), pad(1 + g % N_STORES, np.int64)]
    lv = torch.from_numpy(live).to(dev)
    s = pad(rng.integers(1, 3000, rows), np.int64)
    has = pad(rng.random(rows) < 0.999, np.bool_)
    return keys, [lv, lv], ("sum",), [[(s, has & lv), (has, lv)]], rows


def kernel_k10(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    cpu = torch.device("cpu")
    cases = []
    for kinds, cap, n, nulls, key_range in SEG_CASES:
        keys, kvalids, specs, args = seg_case(kinds, cap, n, nulls, key_range, rng)
        label = f"keys={'+'.join(kinds)},cap={cap},n={n},nulls={nulls},range={key_range}"
        dkeys, dvalids, dargs = to_dev(keys, dev), to_dev(kvalids, dev), to_dev(args, dev)
        # the two passes against their plain versions on the same planes
        exists = torch.arange(cap, device=dev) < n
        planes = K._segment_planes(dkeys, dvalids, exists, True)
        ops = K.sort_key_operands(*planes, exists, [(True, True)] * len(planes[0]))
        order = K.lexsort_indices(ops, n)
        got = K.segment_starts_cuda(*planes, order, n)
        check_equal("segment_ids", label, got, K.segment_starts_plain(*planes, order, n))
        ops_, emits = A._partial_program(specs, dargs)
        check_equal("seg_agg_partial", label,
                    K.segment_reduce_cuda("seg_agg_partial", order, *got, n, ops_, emits),
                    K.segment_reduce_plain(order, *got, n, ops_, emits))
        # the whole route, both segmentations
        for direct in (True, False):
            outs = check_seg_pipeline("seg_agg_partial", A.seg_agg_partial,
                                      (dkeys, dvalids, n, specs, dargs, direct),
                                      (keys, kvalids, n, specs, args, direct),
                                      f"{label},direct={direct}")
        g = int(outs[0])
        if g:
            kinds_m = tuple(s[0] for s in specs)
            states = merge_states(outs, len(kinds), kinds_m, g, rng)
            check_seg_pipeline("seg_agg_merge", A.seg_agg_merge,
                               (list(outs[2:2 + 2 * len(kinds):2]),
                                list(outs[3:3 + 2 * len(kinds):2]), g, kinds_m, states),
                               (to_dev(list(outs[2:2 + 2 * len(kinds):2]), cpu),
                                to_dev(list(outs[3:3 + 2 * len(kinds):2]), cpu), g, kinds_m,
                                to_dev(states, cpu)), label)
        cases.append(label)
    # main path, partial: one q67 batch through the sort route
    keys, kvalids, specs, args = q67_batch(rng, dev)
    cap = n = keys[0].shape[0]
    check_seg_pipeline("seg_agg_partial", A.seg_agg_partial, (keys, kvalids, n, specs, args),
                       to_dev((keys, kvalids, n, specs, args), cpu), "q67 batch")
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    order, starts, count = K.segment_ids(keys, kvalids, exists, n)
    groups = int(count)
    ops, emits = A._partial_program(specs, args)
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    new[starts[:groups]] = True
    seg_row = torch.empty(n, dtype=torch.int64, device=dev)
    seg_row[order] = torch.cumsum(new.to(torch.int64), 0) - 1
    t_sum = torch.zeros(cap, dtype=torch.int64, device=dev)
    t_cnt = torch.zeros(cap, dtype=torch.int64, device=dev)
    ones = torch.ones(cap, dtype=torch.int64, device=dev)

    def lib_partial():
        t_sum.index_add_(0, seg_row, args[0][0])
        t_cnt.index_add_(0, seg_row, ones)

    ids_ms = time_ms(lambda: K.segment_starts_cuda(keys, kvalids, order, n))
    ids_plain = time_ms(lambda: K.segment_starts_plain(keys, kvalids, order, n))
    red_ms = time_ms(lambda: K.segment_reduce_cuda("seg_agg_partial", order, starts, count,
                                                   n, ops, emits))
    red_plain = time_ms(lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits))
    lib_ms = time_ms(lib_partial)
    route_ms = time_ms(lambda: A.seg_agg_partial(keys, kvalids, n, specs, args))
    # segment_ids: each key plane (8 + 1 bytes a row) and the permutation
    # read once, the starts written; the reduction: the permutation, the
    # starts, the sum's source and validity read once, per group the sum,
    # has flag and first row written
    ids_bytes = n * (2 * 9 + 8) + (groups + 1) * 8
    red_bytes = n * (8 + 8 + 1) + groups * 8 + groups * (8 + 1 + 8)
    shape = f"262144 rows -> {groups} segments (q67 batch, 2 int64 keys, SUM)"
    results.append(dict(
        name="segment_ids", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1082", shape=shape, cases=cases,
        ms=ids_ms, plain_ms=ids_plain, library_ms=None, library_call=None,
        bytes=ids_bytes, route_ms=route_ms))
    results.append(dict(
        name="seg_agg_partial", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1749", shape=shape, cases=cases,
        ms=red_ms, plain_ms=red_plain, library_ms=lib_ms,
        library_call="2x index_add_ into the segment tables (segment ids given: a chain)",
        bytes=red_bytes, route_ms=route_ms))
    # main path, merge: one q67_sort reducer's ~6.2M state rows
    keys, kvalids, kinds, states, n = q67_merge_input(rng, dev)
    cap = keys[0].shape[0]
    exists = torch.arange(cap, device=dev) < n
    order, starts, count = K.segment_ids(keys, kvalids, exists, n)
    groups = int(count)
    ops, emits = A._merge_program(kinds, states)
    got = K.segment_reduce_cuda("seg_agg_merge", order, starts, count, n, ops, emits)
    check_equal("seg_agg_merge", "q67_sort merge", got,
                K.segment_reduce_plain(order, starts, count, n, ops, emits))
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    new[starts[:groups]] = True
    seg_row = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    seg_row[order[:n]] = torch.cumsum(new.to(torch.int64), 0) - 1
    (sd, sv), (hd, hv) = states[0]
    m = sv & hd & hv
    msum = torch.where(m, sd, 0)
    mcnt = m.to(torch.int64)
    t_sum = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    t_cnt = torch.zeros(cap + 1, dtype=torch.int64, device=dev)

    def lib_merge():
        t_sum.index_add_(0, seg_row, msum)
        t_cnt.index_add_(0, seg_row, mcnt)

    ms = time_ms(lambda: K.segment_reduce_cuda("seg_agg_merge", order, starts, count, n,
                                               ops, emits))
    plain_ms = time_ms(lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits))
    lib_ms = time_ms(lib_merge)
    ids_merge_ms = time_ms(lambda: K.segment_starts_cuda(keys, kvalids, order, n))
    results.append(dict(
        name="seg_agg_merge", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1477",
        shape=f"{n} state rows -> {groups} segments (a q67_sort reducer)", cases=cases,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="2x index_add_ into the segment tables (segment ids and the "
                     "gate given: a chain)",
        bytes=n * (8 + 8 + 1 + 1 + 1) + groups * 8 + groups * (8 + 1 + 8),
        segment_ids_ms=ids_merge_ms))


# -- K11: the fused chain ------------------------------------------------------------

# (capacity, rows): padding, a full bucket, the main path's batch size, empty
FUSED_CAPS = ((256, 200), (4096, 4096), (262144, 262139), (256, 0))
I32_MIN, I64_MIN = -(1 << 31), -(1 << 63)


def fused_schema(T):
    return T.Schema.of(("i", T.I32), ("l", T.I64), ("j", T.I64), ("f", T.F32), ("g", T.F32),
                       ("d", T.F64), ("e", T.F64), ("b", T.BOOL),
                       ("m", T.DecimalType(9, 2)), ("n", T.DecimalType(7, 3)))


def fused_cases(E, T):
    """K11's battery over ``fused_schema``: (name, input schema, steps), built
    with the IR modules given (this package's, or another package's whose IR
    it copies). Every step kind, every ported operator on i32, i64, f32,
    f64, bool and decimal(<=18), the FMA shapes (float MOD, a*b + c,
    decimal from a float), division by zero and by -1, int64 and f64
    literals Triton would type i32/fp32 (2**40 + 1, 0.1), null literals,
    InList with a null item and negated, a projected isnotnull(column)
    (its data is the input's validity plane) with and without a filter."""
    C, L, B = E.Column, E.Literal, E.BinaryOp
    D92, D73 = T.DecimalType(9, 2), T.DecimalType(7, 3)

    def bx(op, a, b, rt=None):
        return E.BinaryExpr(op, a, b, rt)

    def proj(*exprs):
        return ("project", tuple(exprs), tuple(f"c{k}" for k in range(len(exprs))))

    i, l, j, f, g, d, e, b, m, n = (C(x) for x in "iljfgdebmn")
    schema = fused_schema(T)
    out = [
        ("q69 scan filter", (("filter", (bx(B.AND, E.IsNotNull(l), E.IsNotNull(j)),)),)),
        ("integers", (proj(
            bx(B.ADD, i, i), bx(B.SUB, i, l), bx(B.MUL, i, i), bx(B.MUL, l, j), bx(B.DIV, l, j),
            bx(B.MOD, l, j), bx(B.DIV, i, L(0, T.I32)), bx(B.MOD, i, i), bx(B.DIV, l, L(-1, T.I64)),
            bx(B.MOD, l, L(-1, T.I64)), bx(B.DIV, i, L(-1, T.I32)), bx(B.SHIFT_LEFT, i, i),
            bx(B.SHIFT_RIGHT, l, j), bx(B.BIT_AND, i, L(0x0F0F, T.I32)), bx(B.BIT_OR, l, j),
            bx(B.BIT_XOR, i, L(-1, T.I32)), bx(B.LT, l, j), bx(B.GTEQ, i, l),
            bx(B.EQ, l, L(2 ** 40 + 1, T.I64)), bx(B.ADD, l, L(2 ** 40 + 1, T.I64))),)),
        ("floats", (proj(
            bx(B.ADD, f, g), bx(B.MUL, f, L(0.1, T.F32)), bx(B.DIV, f, g), bx(B.MOD, f, g),
            bx(B.DIV, d, e), bx(B.MOD, d, e), bx(B.MUL, d, L(0.1, T.F64)),
            bx(B.ADD, d, L(2.0 ** 40 + 1, T.F64)), bx(B.SUB, d, f), bx(B.LT, f, g),
            bx(B.EQ, d, e), bx(B.NEQ, d, e), bx(B.LTEQ, d, L(0.0, T.F64)), bx(B.GT, f, d),
            bx(B.ADD, i, f), bx(B.MUL, l, d)),)),
        ("fma shapes", (proj(
            bx(B.ADD, bx(B.MUL, d, e), d), bx(B.SUB, bx(B.MUL, f, g), f),
            bx(B.ADD, bx(B.MUL, d, L(0.1, T.F64)), e), bx(B.MOD, e, L(0.1, T.F64)),
            bx(B.MUL, m, d, T.DecimalType(18, 4)), bx(B.DIV, d, m, T.DecimalType(18, 6)),
            bx(B.ADD, f, m, T.DecimalType(12, 3))),)),
        ("decimals", (proj(
            bx(B.ADD, m, n), bx(B.SUB, m, n), bx(B.MUL, m, n, T.DecimalType(17, 5)),
            bx(B.DIV, m, n, T.DecimalType(18, 6)), bx(B.MOD, m, n, T.DecimalType(10, 3)),
            bx(B.ADD, m, l, T.DecimalType(18, 2)), bx(B.DIV, m, L("0.00", D92), T.DecimalType(18, 6)),
            bx(B.GT, m, n), bx(B.EQ, m, L("12.50", D92)), bx(B.LT, m, d),
            bx(B.MUL, n, L("1.005", D73), T.DecimalType(15, 6)),
            bx(B.DIV, m, L("-3", T.DecimalType(1, 0)), T.DecimalType(18, 1))),)),
        ("bool logic", (proj(
            bx(B.AND, b, bx(B.GT, i, L(0, T.I32))), bx(B.OR, b, E.IsNull(l)), E.Not(b),
            bx(B.EQ, b, bx(B.GT, l, L(0, T.I64))), bx(B.LT, b, bx(B.GT, f, L(0.0, T.F32))),
            bx(B.AND, L(None, T.BOOL), b), bx(B.OR, L(True, T.BOOL), b),
            bx(B.OR, L(None, T.BOOL), b), E.Not(bx(B.NEQ, d, d))),)),
        ("inlist", (proj(
            E.InList(i, [L(3, T.I32), L(7, T.I32)]), E.InList(i, [L(3, T.I32), L(7, T.I32)], True),
            E.InList(l, [L(2 ** 40 + 1, T.I64), j]), E.InList(d, [L(0.1, T.F64), e], True),
            E.InList(m, [L("1.50", D92), n]), E.InList(f, [L(0.5, T.F32), d])),)),
        ("inlist null item", (proj(
            E.InList(i, [L(3, T.I32), L(None, T.I32), L(7, T.I32)]),
            E.InList(i, [L(3, T.I32), L(None, T.I32), L(7, T.I32)], True),
            E.InList(l, [L(None, T.I64), j], True)),
            ("filter", (E.InList(C("c0"), [L(True, T.BOOL), L(None, T.BOOL)]),)))),
        ("literals and nulls", (proj(
            L(2 ** 40 + 1, T.I64), L(0.1, T.F64), L(0.1, T.F32), L(None, T.I64), L(None, T.F64),
            L(True, T.BOOL), L(None, D92), L("-3.25", D92), E.IsNull(L(None, T.I32)),
            bx(B.ADD, l, L(None, T.I64)), E.IsNotNull(bx(B.DIV, d, L(0.0, T.F64))), l),)),
        ("chain", (
            ("filter", (bx(B.OR, bx(B.GT, l, j), E.IsNull(j)),)),
            ("project", (l, bx(B.MUL, i, L(2, T.I32)), d, m), ("l", "i2", "d", "m")),
            ("filter", (E.Not(bx(B.LT, C("i2"), L(0, T.I32))),)),
            ("project", (bx(B.ADD, C("l"), C("i2")), bx(B.MUL, C("d"), L(0.5, T.F64)), C("m")),
             ("li", "dh", "m")))),
        ("expand rename", (
            ("filter", (bx(B.LT, i, L(8, T.I32)),)),
            ("expand", ((l, j, L(0, T.I64)), (l, bx(B.MUL, l, L(10, T.I64)), L(1, T.I64))),
             T.Schema.of(("a", T.I64), ("v", T.I64), ("tag", T.I64))),
            ("filter", (bx(B.GT, C("v"), L(50, T.I64)),)),
            ("rename", ("g_a", "g_v", "g_tag")))),
        ("rename project", (
            ("rename", tuple(f"r{k}" for k in range(len(schema)))),
            ("project", (C("r1"), bx(B.ADD, C("r0"), L(1, T.I32)), C("r7")), ("x", "y", "z")))),
        ("isnotnull project", (proj(E.IsNotNull(j), bx(B.ADD, i, L(1, T.I32))),)),
        ("isnotnull after filter", (
            ("filter", (bx(B.GT, i, L(0, T.I32)),)),
            proj(E.IsNotNull(j), E.IsNotNull(b), l))),
        ("none kept", (("filter", (L(False, T.BOOL),)),)),
        ("all kept", (("filter", (bx(B.OR, E.IsNull(l), E.IsNotNull(l)),)),)),
    ]
    return [(name, schema, steps) for name, steps in out]


def fused_planes(cap, n, rng, subnormals=True, nulls=0.15):
    """numpy (datas, valids) for ``fused_schema`` at ``cap`` rows, ``n``
    live: random values with the edge values mixed in (int64/int32 minimum
    and maximum, -1, 0, zero divisors, NaN, +-0.0, +-inf, 0.1, and with
    ``subnormals`` f32/f64 subnormals), ``nulls`` of each column null,
    padding data 0 and validity False."""
    import numpy as np

    def mix(vals, special):
        pick = rng.random(cap) < 0.2
        vals[pick] = np.asarray(special, dtype=vals.dtype)[rng.integers(0, len(special),
                                                                        int(pick.sum()))]
        return vals

    f_spec = [np.nan, 0.0, -0.0, np.inf, -np.inf, 0.1, 1.0, -3.0, 0.5]
    d_spec = f_spec + [1e300, -1e300]
    if subnormals:
        f_spec = f_spec + [1e-40, -1e-41]
        d_spec = d_spec + [5e-324, -1e-310]
    with np.errstate(over="ignore"):
        datas = [
            mix(rng.integers(-100, 100, cap).astype(np.int32), [I32_MIN, (1 << 31) - 1, -1, 0]),
            mix(rng.integers(-(1 << 40), 1 << 40, cap), [I64_MIN, (1 << 63) - 1, -1, 0,
                                                         2 ** 40 + 1]),
            mix(rng.integers(-5, 6, cap), [-1, 0, I64_MIN]),
            mix((rng.standard_normal(cap) * 100).astype(np.float32), f_spec),
            mix((rng.standard_normal(cap) * 10).astype(np.float32), f_spec),
            mix(rng.standard_normal(cap) * 1e3, d_spec),
            mix(rng.standard_normal(cap), d_spec),
            rng.random(cap) < 0.5,
            mix(rng.integers(-10 ** 8, 10 ** 8, cap), [0, 10 ** 9 - 1, -(10 ** 9 - 1), 150, 1250]),
            mix(rng.integers(-10 ** 6, 10 ** 6, cap), [0, 1, -1000]),
        ]
    valids = []
    for k, dat in enumerate(datas):
        v = rng.random(cap) >= nulls
        v[n:] = False
        dat[~v] = 0
        valids.append(v)
    return datas, valids


def fused_flat(result):
    """(groups, counts) of a fused chain as one flat list of tensors."""
    import torch

    groups, counts = result
    out = []
    for (ds, vs), c in zip(groups, counts):
        out += list(ds) + list(vs)
        out.append(c if torch.is_tensor(c) else torch.tensor(c, dtype=torch.int64))
    return out


def kernel_k11(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_cuda, launch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    cases = []
    for name, schema, steps in fused_cases(E, T):
        kern = FusedKernel(schema, steps)
        for cap, n in FUSED_CAPS:
            datas, valids = fused_planes(cap, n, rng)
            datas = [torch.from_numpy(x).to(dev) for x in datas]
            valids = [torch.from_numpy(x).to(dev) for x in valids]
            got = fused_chain_cuda(kern, datas, valids, n)
            want = K.fused_chain_plain(schema, steps, datas, valids, n)
            check_equal("fused_chain", f"{name} cap={cap} n={n}", fused_flat(got),
                        [x.to(dev) for x in fused_flat(want)])
        cases.append(name)
    check_fused_stage_coalesce(dev, rng)
    cases.append("project+filter | coalesce | project through FusedStageExec")
    battery_s = time.perf_counter() - t0
    # main path: the null filter Spark infers on a q69 store_sales scan, one
    # 262,144-row batch (4% of ss_customer_sk null)
    sch = T.Schema.of(("ss_sold_date_sk", T.I64), ("ss_customer_sk", T.I64))
    steps = (("filter", (E.BinaryExpr(E.BinaryOp.AND, E.IsNotNull(E.Column("ss_sold_date_sk")),
                                      E.IsNotNull(E.Column("ss_customer_sk"))),)),)
    cap = 262144
    cust_v = rng.random(cap) >= 0.04
    datas = [torch.from_numpy(rng.integers(*Q69_SALES_DATES, cap)).to(dev),
             torch.from_numpy(np.where(cust_v, rng.integers(1, 500_001, cap), 0)).to(dev)]
    valids = [torch.ones(cap, dtype=torch.bool, device=dev), torch.from_numpy(cust_v).to(dev)]
    kern = FusedKernel(sch, steps)
    check_equal("fused_chain", "q69 store_sales batch",
                fused_flat(fused_chain_cuda(kern, datas, valids, cap)),
                fused_flat(K.fused_chain_plain(sch, steps, datas, valids, cap)))
    ms = time_ms(lambda: fused_chain_cuda(kern, datas, valids, cap))
    plain_ms = time_ms(lambda: K.fused_chain_plain(sch, steps, datas, valids, cap))
    k11_ms = time_ms(lambda: launch(kern, datas, valids, cap))
    plane_bytes = sum(x.numel() * x.element_size() for x in datas + valids)
    results.append(dict(
        name="fused_chain", route="triton", source="blaze_tpu_torch/exprs/fused_triton.py",
        replaces="blaze_tpu/exprs/compiler.py:1042",
        shape="a q69 store_sales batch, 262,144 rows x 2 int64 columns, "
              "isnotnull(ss_sold_date_sk) AND isnotnull(ss_customer_sk): K11 + K1",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=None,
        library_call="none: no single PyTorch call computes a fused chain",
        # the segment reads each input plane once and writes its compacted
        # planes and the count
        bytes=2 * plane_bytes + 8, k11_only_ms=k11_ms, k11_only_bytes=3 * cap,
        battery_s=battery_s))


def check_fused_stage_coalesce(dev, rng):
    """A fused stage of two segments split by a coalesce (project + filter,
    coalesce to 4,096 rows, project) over 256-row batches: FusedStageExec
    on the card against the same operator over CPU copies (the plain
    versions of K11, K1 and K7)."""
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.fused import FusedStageExec
    from blaze_tpu_torch.ops.shuffle.reader import BatchSourceExec

    schema = fused_schema(T)
    B, C, L = E.BinaryOp, E.Column, E.Literal
    leaf = N.BatchSource(schema, "unused", 1)
    p1 = N.Projection(leaf, [C("l"), E.BinaryExpr(B.MUL, C("d"), L(0.1, T.F64)), C("m")],
                      ["l", "d1", "m"])
    f1 = N.Filter(p1, [E.BinaryExpr(B.GT, C("d1"), L(0.0, T.F64))])
    co = N.CoalesceBatches(f1, 4096)
    p2 = N.Projection(co, [E.BinaryExpr(B.ADD, C("l"), L(2 ** 40 + 1, T.I64)), C("d1")],
                      ["l1", "d1"])
    node = N.FusedStage(child=leaf, ops=(p1, f1, co, p2))
    host = [(256 - k % 3 * 40, fused_planes(256, 256 - k % 3 * 40, rng)) for k in range(40)]
    outs = []
    for where in (dev, torch.device("cpu")):
        batches = [ColumnarBatch(schema, [
            DeviceColumn(fld.dtype, torch.from_numpy(dd).to(where), torch.from_numpy(vv).to(where))
            for fld, dd, vv in zip(schema.fields, datas, valids)], n)
            for n, (datas, valids) in host]
        op = FusedStageExec(BatchSourceExec(schema, "src", 1), node)
        ctx = ExecContext(Config(), where, {"src": lambda p, _b=batches: _b})
        outs.append([(b.num_rows, [c.data.cpu() for c in b.columns],
                      [c.validity.cpu() for c in b.columns]) for b in op.execute(0, ctx)])
    got, want = outs
    if [g[0] for g in got] != [w[0] for w in want]:
        raise AssertionError(f"fused stage batches {[g[0] for g in got]} vs {[w[0] for w in want]}")
    for g, w in zip(got, want):
        check_equal("fused_chain", "coalesce between segments", g[1:], w[1:])


# -- K12: the host table's slot update -------------------------------------------

# every aggregate the host table updates through K12, and its argument: i64,
# i32, f64, f32, bool, dec (decimal(7,2)); None for COUNT(*)
UPD_FNS = (("sum", "i64"), ("sum", "f64"), ("sum", "f32"), ("sum", "dec"), ("count", None),
           ("count", "f64"), ("avg", "i64"), ("avg", "f64"), ("avg", "dec"), ("min", "i64"),
           ("max", "i32"), ("min", "f64"), ("max", "f64"), ("min", "f32"), ("max", "f32"),
           ("min", "dec"), ("first", "i64"), ("first_ignores_null", "f64"), ("first", "f32"),
           ("first_ignores_null", "bool"), ("first", "i32"), ("first_ignores_null", "dec"))
# (label, mode, (capacity, live rows) a batch, batches, slots drawn from,
# (table capacity at the start, after the first batch), null share, value
# range, floats): floats "mixed" (NaN, +-0.0, +-inf, normal values,
# subnormals unless the caller drops them) or "order" (1e16, 1.0, -1e16:
# a sum that depends on the fold's order)
UPD_CASES = (
    ("update", "update", (256, 200), 3, 40, (1024, 1024), 0.2, (-50, 50), "mixed"),
    ("merge", "merge", (256, 230), 3, 40, (1024, 1024), 0.2, (-50, 50), "mixed"),
    ("update, growth", "update", (4096, 4000), 2, 3000, (1024, 4096), 0.1,
     (-10 ** 6, 10 ** 6), "mixed"),
    ("merge, growth", "merge", (4096, 3500), 2, 3000, (1024, 4096), 0.1,
     (-10 ** 6, 10 ** 6), "mixed"),
    ("update, one slot", "update", (1024, 1000), 2, 1, (1024, 1024), 0.1, (-50, 50), "mixed"),
    ("update, float order", "update", (256, 256), 2, 3, (1024, 1024), 0.0, (-5, 5), "order"),
    ("merge, float order", "merge", (256, 256), 2, 3, (1024, 1024), 0.0, (-5, 5), "order"),
    ("update, int64 wrap", "update", (256, 256), 2, 4, (1024, 1024), 0.0,
     (2 ** 62, 2 ** 63 - 1), "mixed"),
    ("merge, all null", "merge", (256, 200), 2, 40, (1024, 1024), 1.0, (-50, 50), "mixed"),
    ("update, empty batch", "update", (256, 0), 2, 40, (1024, 1024), 0.1, (-50, 50), "mixed"),
)
UPD_ORDER_FLOATS = (1e16, 1.0, -1e16, 3.0, -1.0)


def upd_arg_type(T, arg):
    """The argument type of an UPD_FNS entry under the IR module ``T`` of
    either package."""
    return {"i64": T.I64, "i32": T.I32, "f64": T.F64, "f32": T.F32, "bool": T.BOOL,
            "dec": T.DecimalType(7, 2), None: T.I64}[arg]


def upd_plane(kind, cap, n, rng, nulls, lo, hi, floats, subnormals):
    """(data, validity) of one value plane: ``n`` live rows of ``cap``."""
    import numpy as np

    live = np.arange(cap) < n
    if kind in ("f64", "f32"):
        pool = UPD_ORDER_FLOATS if floats == "order" else \
            SEG_FLOATS if subnormals else SEG_FLOATS[:12]
        d = np.array(pool)[rng.integers(0, len(pool), cap)]
        with np.errstate(over="ignore"):
            d = d.astype(np.float64 if kind == "f64" else np.float32)
    elif kind == "bool":
        d = rng.random(cap) < 0.5
    elif kind in ("i32", "dec"):  # int32, or decimal(7,2) unscaled
        top = 2 ** 31 - 1 if kind == "i32" else 10 ** 7 - 1
        if not -top <= lo < hi <= top:
            lo, hi = -top, top
        d = rng.integers(lo, hi, cap).astype(np.int32 if kind == "i32" else np.int64)
    else:
        d = rng.integers(lo, hi, cap, dtype=np.int64)
    return np.where(live, d, 0).astype(d.dtype), live & (rng.random(cap) >= nulls)


def upd_state_planes(fn, arg, cap, n, rng, nulls, lo, hi, floats, subnormals):
    """A batch of partial states of ``fn`` (merge input): one (data,
    validity) pair per state field, every gate of the merge taken."""
    import numpy as np

    live = np.arange(cap) < n

    def flag():
        return (rng.random(cap) < 0.8) & live, live & (rng.random(cap) >= nulls)

    def val(kind):
        return upd_plane(kind, cap, n, rng, nulls, lo, hi, floats, subnormals)

    def widened(kind):
        d, v = val(kind)
        return (d.astype(np.float64) if kind in ("f64", "f32") else d.astype(np.int64)), v

    counts = rng.integers(0, 100, cap).astype(np.int64) * live, live & (rng.random(cap) >= nulls)
    if fn == "sum":
        return [widened(arg), flag()]
    if fn == "count":
        return [counts]
    if fn == "avg":
        return [widened(arg), counts]
    if fn in ("min", "max"):
        return [val(arg), flag()]
    # first: value, valid flag, and orders with ties (states of several
    # map tasks share orders) and the "no row" order
    order = np.where(rng.random(cap) < 0.1, 2 ** 63 - 1, rng.integers(0, 20, cap)) * live
    return [val(arg), flag(), (order.astype(np.int64), live & (rng.random(cap) >= nulls))]


def upd_case(case, rng, subnormals=True):
    """K12's inputs of one UPD_CASES entry on the host: per batch the
    slots (padding rows at the table's capacity then), the row mask, the
    global row orders and per UPD_FNS entry its planes (update: the
    argument, None for COUNT(*); merge: the state fields)."""
    import numpy as np

    label, mode, (cap, n), nbatch, nslots, caps, nulls, (lo, hi), floats = case
    batches, order = [], 0
    for b in range(nbatch):
        table_cap = caps[0] if b == 0 else caps[1]
        live = np.arange(cap) < n
        slots = np.where(live, rng.integers(0, min(nslots, table_cap), cap), table_cap)
        planes = []
        for fn, arg in UPD_FNS:
            if mode == "merge":
                planes.append(upd_state_planes(fn, arg, cap, n, rng, nulls, lo, hi, floats,
                                               subnormals))
            else:
                planes.append(None if arg is None else
                              upd_plane(arg, cap, n, rng, nulls, lo, hi, floats, subnormals))
        batches.append({"slots": slots.astype(np.int64), "mask": live,
                        "order": np.arange(cap, dtype=np.int64) + order, "planes": planes})
        order += n
    return {"label": label, "mode": mode, "caps": caps, "batches": batches}


def upd_fns():
    """The port's aggregate functions of UPD_FNS."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import aggfns

    fns = []
    for fn, arg in UPD_FNS:
        agg = E.AggExpr(E.AggFunction[fn.upper()], [] if arg is None else [E.Column("v")])
        fns.append(aggfns.create_agg_function(agg, T.Schema.of(("v", upd_arg_type(T, arg)))))
    return fns


def upd_run(case, fns, update, dev, packed=False):
    """The functions' tables after the case's batches, each batch's ops of
    every function through ``update`` (K12 or its plain version);
    ``packed``: K12 keeps one argument pack a launch across the batches,
    as the host table does."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import types as T

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    caps = case["caps"]
    states = [fn.init_state(caps[0], dev) for fn in fns]
    packs = {}
    for b, batch in enumerate(case["batches"]):
        if b == 1:
            states = [fn.grow(st, caps[1]) for fn, st in zip(fns, states)]
        ops = []
        for fn, st, planes in zip(fns, states, batch["planes"]):
            if case["mode"] == "merge":
                ops += fn.merge_ops(st, [DeviceColumn(T.I64, t(d), t(v)) for d, v in planes])
            elif planes is None:
                ops += fn.update_ops(st, None, None)
            else:
                ops += fn.update_ops(st, t(planes[0]), t(planes[1]), t(batch["order"]))
        slots, mask = t(batch["slots"]), t(batch["mask"])
        for at in range(0, len(ops), K._MAX_UPD_OPS):
            chunk = ops[at:at + K._MAX_UPD_OPS]
            if packed:
                update(slots, mask, chunk, packs.setdefault(at, K.SlotUpdatePack()))
            else:
                update(slots, mask, chunk)
    return states


def q67_table_merge_batch(rng, dev, rows=262144, groups=200_000):
    """One q67_table merge batch: 262,144 (item, store) partial-state rows
    (sum, has) interned into ~200,000 slots of a 262,144-slot table."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    slots = t(rng.integers(0, groups, rows))
    live = torch.ones(rows, dtype=torch.bool, device=dev)
    s = t(rng.integers(1, 3000, rows))
    has = t(rng.random(rows) < 0.999)
    return slots, live, s, has


def kernel_k12(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import aggfns

    cases = []
    fns = upd_fns()
    for spec in UPD_CASES:
        case = upd_case(spec, rng)
        got = upd_run(case, fns, K.slot_update_cuda, dev, packed=True)
        want = upd_run(case, fns, K.slot_update_plain, dev)
        check_equal("slot_update", case["label"], got, want)
        cases.append(case["label"])
    # main path: a q67_table merge batch, FINAL SUM(qty) states (sum, has)
    slots, live, s, has = q67_table_merge_batch(rng, dev)
    rows = slots.shape[0]
    fn = aggfns.create_agg_function(E.AggExpr(E.AggFunction.SUM, [E.Column("v")]),
                                    T.Schema.of(("v", T.I64)))
    cols = [DeviceColumn(T.I64, s, has), DeviceColumn(T.BOOL, has, live)]
    tables = {}
    for name, update in (("kernel", K.slot_update_cuda), ("plain", K.slot_update_plain)):
        st = fn.init_state(262144, dev)
        update(slots, live, fn.merge_ops(st, cols))
        tables[name] = st
    check_equal("slot_update", "q67_table merge batch", tables["kernel"], tables["plain"])
    cases.append("q67_table merge batch")
    st = fn.init_state(262144, dev)
    ops = fn.merge_ops(st, cols)
    # as the host table calls it: its argument arrays kept in a pack; and
    # without one, packing them anew each call
    pack = K.SlotUpdatePack()
    ms = time_ms(lambda: K.slot_update_cuda(slots, live, ops, pack))
    unpacked_ms = time_ms(lambda: K.slot_update_cuda(slots, live, ops))
    plain_ms = time_ms(lambda: K.slot_update_plain(slots, live, ops))
    acc, flag = st
    gate = has & live
    contrib = torch.where(gate, s, 0)
    flags = gate.to(torch.uint8)
    flag8 = torch.zeros(262144, dtype=torch.uint8, device=dev)

    def library():
        acc.index_add_(0, slots, contrib)
        flag8.scatter_reduce_(0, slots, flags, "amax")

    lib_ms = time_ms(library)
    touched = int(torch.unique(slots[gate]).numel())
    # the rows' slot, mask, sum and has planes (has: data and validity)
    # read once; each touched slot's sum read and written once, its flag
    # written once (nothing reads the flag table)
    nbytes = rows * (8 + 1 + 8 + 1 + 1) + touched * (8 * 2 + 1)
    # the fold route at the same shape: a float64 SUM of 262,144 raw rows
    # (K5's sort by slot, then one thread a run)
    ffn = aggfns.create_agg_function(E.AggExpr(E.AggFunction.SUM, [E.Column("v")]),
                                     T.Schema.of(("v", T.F64)))
    fst = ffn.init_state(262144, dev)
    fvals = torch.from_numpy(rng.random(rows)).to(dev)
    fops = ffn.update_ops(fst, fvals, live)
    fold_ms = time_ms(lambda: K.slot_update_cuda(slots, live, fops))
    results.append(dict(
        name="slot_update", route="cuda", source="blaze_tpu_torch/csrc/slot_update.cu",
        replaces="blaze_tpu/ops/aggfns.py:362", shape=f"{rows} state rows -> {touched} "
        "touched slots of 262,144 (a q67_table merge batch: SUM int64 + has flag)",
        cases=cases, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="index_add_ + scatter_reduce_(amax) into the slot tables (a chain)",
        bytes=nbytes, fold_ms=fold_ms, unpacked_ms=unpacked_ms))


# -- phase 4: the paths on the card ------------------------------------------------


def stage_batches(schema, columns, dev, bs=262144, valids=None):
    """Host int64 columns -> device batches of ``bs`` rows (the last one in
    its own capacity bucket); ``valids`` (None: all valid) gives a
    validity array, or None, per column (null rows carry data 0)."""
    import torch
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn

    n_all = len(columns[0])
    cols = [torch.from_numpy(x).to(dev) for x in columns]
    vcols = [None if v is None else torch.from_numpy(v).to(dev)
             for v in (valids or [None] * len(columns))]
    batches = []
    for s in range(0, n_all, bs):
        n = min(bs, n_all - s)
        cap = bs if n == bs else 1 << max(8, (n - 1).bit_length())
        dcols = []
        for f, c, vc in zip(schema.fields, cols, vcols):
            v = torch.zeros(cap, dtype=torch.bool, device=dev)
            v[:n] = True if vc is None else vc[s:s + n]
            d = torch.zeros(cap, dtype=torch.int64, device=dev)
            d[:n] = c[s:s + n]
            d[~v] = 0
            dcols.append(DeviceColumn(f.dtype, d, v))
        batches.append(ColumnarBatch(schema, dcols, n))
    return batches


def make_q67_data(dev):
    """store_sales' q67 columns drawn as bench.py:make_data draws them
    (ss_item_sk uniform [1, 2000), ss_store_sk uniform [1, 400),
    ss_quantity uniform [1, 100); seed 67), 28,800,991 rows (TPC-DS
    SF10's store_sales row count) in 4 partitions, staged on the card."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ir import types as T

    schema = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                         ("ss_quantity", T.I64))
    rng = np.random.default_rng(Q67_SEED)
    host, parts = [], []
    for p in range(PARTS):
        per = Q67_ROWS // PARTS + (1 if p < Q67_ROWS % PARTS else 0)
        cols = (rng.integers(1, N_ITEMS, per), rng.integers(1, N_STORES, per),
                rng.integers(1, 100, per))
        host.append(cols)
        parts.append(stage_batches(schema, cols, dev))
    torch.cuda.synchronize()
    return schema, parts, host


def q67_plan(schema):
    """bench.py:380 plan_q67 over an in-memory source: top-3 stores per item
    by quantity over the (item, store) aggregate."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    col = E.Column
    keys = [("ss_item_sk", col("ss_item_sk")), ("ss_store_sk", col("ss_store_sk"))]
    aggs = [("qty", E.AggExpr(E.AggFunction.SUM, [col("ss_quantity")]))]
    scan = N.FFIReader(schema, "store_sales", PARTS)
    partial = N.Agg(scan, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in aggs],
                    supports_partial_skipping=True)
    ex = N.ShuffleExchange(partial, N.HashPartitioning([e for _, e in keys], PARTS))
    final = N.Agg(ex, E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in aggs])
    srt = N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                 [E.SortOrder(col("ss_item_sk")), E.SortOrder(col("qty"), ascending=False)])
    win = N.Window(srt, [N.WindowExpr("rank", "rk")], [col("ss_item_sk")],
                   [E.SortOrder(col("qty"), ascending=False)])
    return N.Filter(win, [E.BinaryExpr(E.BinaryOp.LTEQ, col("rk"), E.Literal(3, T.I32))])


def _u32(x):
    import numpy as np

    return np.uint32(x)


def spark_pmod_two_longs(a, b, n):
    """Spark's HashPartitioning of two non-null int64 keys in numpy:
    Murmur3_x86_32 hashLong(a, 42), then hashLong(b, that), pmod n."""
    import numpy as np

    def rotl(x, r):
        return (x << _u32(r)) | (x >> _u32(32 - r))

    def mix_k1(k):
        return rotl(k * _u32(0xcc9e2d51), 15) * _u32(0x1b873593)

    def mix_h1(h, k):
        return rotl(h ^ k, 13) * _u32(5) + _u32(0xe6546b64)

    def hash_long(v, seed):
        u = v.astype(np.int64).view(np.uint64)
        h = mix_h1(seed, mix_k1((u & np.uint64(0xffffffff)).astype(np.uint32)))
        h = mix_h1(h, mix_k1((u >> np.uint64(32)).astype(np.uint32)))
        h = h ^ _u32(8)
        h = h ^ (h >> _u32(16))
        h = h * _u32(0x85ebca6b)
        h = h ^ (h >> _u32(13))
        h = h * _u32(0xc2b2ae35)
        return h ^ (h >> _u32(16))

    h = hash_long(b, hash_long(a, np.full(len(a), 42, np.uint32)))
    return np.mod(h.view(np.int32).astype(np.int64), n)


def q67_oracle(host):
    """The q67 answer in numpy, order included: group sums by (item,
    store); the sort's input is the final aggregate's reducers in order,
    each in (item, store) order, and the sort is stable, so rows tied on
    (item, qty) come in (reducer, store) order; rank as bench.py:acero_q67
    computes it; rows with rank <= 3."""
    import numpy as np

    item = np.concatenate([h[0] for h in host])
    store = np.concatenate([h[1] for h in host])
    qty = np.concatenate([h[2] for h in host])
    key = item * N_STORES + store
    sums = np.bincount(key, weights=qty, minlength=N_ITEMS * N_STORES)
    present = np.nonzero(np.bincount(key, minlength=N_ITEMS * N_STORES))[0]
    del key, item, store, qty
    if sums.max() >= 2 ** 53:  # float64 sums of int64 are exact below 2^53
        raise AssertionError("q67 oracle: a sum reached 2^53")
    g_item, g_store = present // N_STORES, present % N_STORES
    g_qty = sums[present].astype(np.int64)
    pid = spark_pmod_two_longs(g_item, g_store, PARTS)
    order = np.lexsort((g_store, pid, -g_qty, g_item))
    k, q = g_item[order], g_qty[order]
    idx = np.arange(len(k))
    new_key = np.concatenate([[True], k[1:] != k[:-1]])
    new_val = np.concatenate([[True], (q[1:] != q[:-1]) | new_key[1:]])
    grp_start = np.maximum.accumulate(np.where(new_key, idx, 0))
    val_start = np.maximum.accumulate(np.where(new_val, idx, 0))
    rk = val_start - grp_start + 1
    keep = rk <= 3
    return {"ss_item_sk": k[keep].tolist(), "ss_store_sk": g_store[order][keep].tolist(),
            "qty": q[keep].tolist(), "rk": rk[keep].tolist()}, len(present)


def q67_table_check(want):
    """A check of q67 on the host table's route: the FINAL aggregate emits
    its groups in slot order (first seen first), not in key order, so rows
    tied on (item, qty) reach the stable sort in another order than on the
    slot and sort routes. Every (item, qty, rank) must be the oracle's, in
    order, and each tie group must hold the oracle's stores."""
    def check(got):
        keys = ("ss_item_sk", "qty", "rk")
        if [list(got[k]) for k in keys] != [want[k] for k in keys]:
            raise AssertionError("q67_table: (item, qty, rank) rows differ from the oracle")
        rows = lambda d: sorted(zip(d["ss_item_sk"], d["qty"], d["ss_store_sk"]))  # noqa: E731
        if rows(got) != rows(want):
            raise AssertionError("q67_table: the stores of tied rows differ from the oracle")

    return check


def make_data(dev):
    """store_returns as bench.py:make_data draws it (seed 42, amt first),
    staged on the card as 262144-row batches per partition."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ir import types as T

    schema = T.Schema.of(("sr_store_sk", T.I64), ("sr_customer_sk", T.I64),
                         ("sr_return_amt", T.DecimalType(7, 2)))
    rng = np.random.default_rng(42)
    per = ROWS // PARTS
    host, parts = [], []
    for _ in range(PARTS):
        amt = rng.integers(0, 10_000_00, per)
        store = rng.integers(1, N_STORES, per)
        cust = rng.integers(1, N_CUSTOMERS, per)
        host.append((store, amt))
        parts.append(stage_batches(schema, (store, cust, amt), dev))
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


def run_q01(dev, profile=False, trace_path=None):
    import blaze_tpu_torch

    t0 = time.perf_counter()
    schema, parts, host = make_data(dev)
    setup_s = time.perf_counter() - t0
    session = blaze_tpu_torch.Session()
    session.resources["store_returns"] = lambda p: parts[p]
    want = q01_oracle(host)
    return run_query("q01", ROWS, session, q01_plan(schema), want, setup_s,
                     {"groups": len(want["sr_store_sk"])}, profile, trace_path)


def run_q67(dev, profile=False, trace_path=None):
    """q67 on the port's default route (K3/K4) and, over the same staged
    data, q67_sort: the route the JAX package takes on a TPU, with both
    slot routes off (K10's partial on each of the 112 batches, its merge
    on each reducer's ~6.2M state rows). Group emission is key order on
    both routes, so both meet the same oracle. Then q67_table: the default
    Config, whose 256 MiB merge budget each reducer's states pass, so the
    FINAL merge is the host table's (K12), checked as q67_table_check
    says."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    t0 = time.perf_counter()
    schema, parts, host = make_q67_data(dev)
    want, groups = q67_oracle(host)
    del host
    setup_s = time.perf_counter() - t0
    info = {"groups": groups, "out_rows": len(want["rk"])}
    out = {}
    for name, conf, check in (
            ("q67", Config(device_merge_max_bytes=Q67_MERGE_BYTES), want),
            ("q67_sort", Config(device_merge_max_bytes=Q67_MERGE_BYTES, dense_agg=False,
                                radix_agg=False), want),
            ("q67_table", Config(), q67_table_check(want))):
        session = blaze_tpu_torch.Session(conf)
        session.resources["store_sales"] = lambda p: parts[p]
        out[name] = run_query(name, Q67_ROWS, session, q67_plan(schema), check, setup_s,
                              info, profile, trace_path and
                              trace_path.replace(".json", f"_{name}.json"))
    return out


def make_join_data(dev):
    """q06's and q47's tables: store_sales drawn as bench.py:make_data
    draws it, but with ss_item_sk uniform over the SF10 item keys
    [1, 102,001) so every row has its item (seed 6; ss_store_sk uniform
    [1, 400), ss_quantity [1, 100), ss_sales_price decimal(7,2) unscaled
    [0, 50,000)), 28,800,991 rows in 4 partitions; the item dimension as
    bench.py draws it at SF10's 102,000 rows (i_item_sk 1..102,000,
    i_category_id [0, 10), i_brand_id [1, 60), i_current_price [0,
    30,000) unscaled) in one batch. The wide ss_ext_wholesale_cost is
    left out: neither query reads it. Both tables are staged on the card."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ir import types as T

    price = T.DecimalType(7, 2)
    sales = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                        ("ss_quantity", T.I64), ("ss_sales_price", price))
    item = T.Schema.of(("i_item_sk", T.I64), ("i_category_id", T.I64),
                       ("i_brand_id", T.I64), ("i_current_price", price))
    rng = np.random.default_rng(Q06_SEED)
    host, parts = [], []
    for p in range(PARTS):
        per = Q06_ROWS // PARTS + (1 if p < Q06_ROWS % PARTS else 0)
        cols = (rng.integers(1, Q06_ITEMS + 1, per), rng.integers(1, N_STORES, per),
                rng.integers(1, 100, per), rng.integers(0, 500_00, per))
        host.append((cols[0], cols[2], cols[3]))
        parts.append(stage_batches(sales, cols, dev))
    n = Q06_ITEMS
    item_cols = (np.arange(1, n + 1), rng.integers(0, 10, n), rng.integers(1, 60, n),
                 rng.integers(0, 300_00, n))
    items = stage_batches(item, item_cols, dev)
    torch.cuda.synchronize()
    return sales, item, parts, items, host, item_cols


def two_stage_agg(child, keys, aggs):
    """bench.py:_two_stage_agg: PARTIAL -> murmur3 hash exchange -> FINAL."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N

    keys = [(k, E.Column(k)) for k in keys]
    partial = N.Agg(child, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in aggs],
                    supports_partial_skipping=True)
    ex = N.ShuffleExchange(partial, N.HashPartitioning([e for _, e in keys], PARTS))
    return N.Agg(ex, E.AggExecMode.HASH_AGG, keys,
                 [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in aggs])


def item_join(sales, item, cache_id):
    """store_sales JOIN BroadcastExchange(item) ON ss_item_sk = i_item_sk
    (INNER, build right), as bench.py:227 and :319 build it."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N

    return N.BroadcastJoin(N.FFIReader(sales, "store_sales", PARTS),
                           N.BroadcastExchange(N.FFIReader(item, "item", 1)),
                           [(E.Column("ss_item_sk"), E.Column("i_item_sk"))],
                           N.JoinType.INNER, N.JoinSide.RIGHT, cache_id)


def q06_plan(sales, item):
    """bench.py:227 plan_q06: quantity and revenue per item category."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    F = E.AggFunction
    agg = two_stage_agg(item_join(sales, item, "bench_items"), ["i_category_id"], [
        ("qty", E.AggExpr(F.SUM, [E.Column("ss_quantity")])),
        ("revenue", E.AggExpr(F.SUM, [E.Column("ss_sales_price")], T.DecimalType(17, 2)))])
    return N.Sort(N.ShuffleExchange(agg, N.SinglePartitioning(1)),
                  [E.SortOrder(E.Column("i_category_id"))])


def q47_plan(sales, item):
    """bench.py:319 plan_q47: the top 5 brands by quantity per category
    (rank, ties kept)."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    col = E.Column
    agg = two_stage_agg(item_join(sales, item, "bench_items47"),
                        ["i_category_id", "i_brand_id"],
                        [("qty", E.AggExpr(E.AggFunction.SUM, [col("ss_quantity")]))])
    srt = N.Sort(N.ShuffleExchange(agg, N.SinglePartitioning(1)),
                 [E.SortOrder(col("i_category_id")), E.SortOrder(col("qty"), ascending=False)])
    win = N.Window(srt, [N.WindowExpr("rank", "rk")], [col("i_category_id")],
                   [E.SortOrder(col("qty"), ascending=False)])
    return N.Filter(win, [E.BinaryExpr(E.BinaryOp.LTEQ, col("rk"), E.Literal(5, T.I32))])


def q06_oracle(host, item_cols):
    """The q06 answer in numpy: the join by i_item_sk - 1 indexing, sums
    accumulated in int64."""
    import decimal

    import numpy as np

    cat = item_cols[1]
    qty = np.zeros(10, np.int64)
    rev = np.zeros(10, np.int64)
    cnt = np.zeros(10, np.int64)
    for it, q, pr in host:
        c = cat[it - 1]
        np.add.at(qty, c, q)
        np.add.at(rev, c, pr)
        cnt += np.bincount(c, minlength=10)
    present = np.nonzero(cnt)[0]
    return {"i_category_id": present.tolist(), "qty": qty[present].tolist(),
            "revenue": [decimal.Decimal(int(r)).scaleb(-2) for r in rev[present]]}


def q47_oracle(host, item_cols):
    """q47's rows in numpy (the join by index, int64 sums per (category,
    brand), rank by quantity within the category) and a check of a
    result: rows in (category ASC, qty DESC) order, each rk the oracle's
    rank of its (category, qty), and the same rows as the oracle's. Rows
    tied on qty may come in any order. Returns (check, groups, rows)."""
    import numpy as np

    gid = item_cols[1] * 60 + item_cols[2]
    qty = np.zeros(600, np.int64)
    cnt = np.zeros(600, np.int64)
    for it, q, _ in host:
        g = gid[it - 1]
        np.add.at(qty, g, q)
        cnt += np.bincount(g, minlength=600)
    present = np.nonzero(cnt)[0]
    cat, brand, s = present // 60, present % 60, qty[present]
    order = np.lexsort((brand, -s, cat))
    cat, brand, s = cat[order], brand[order], s[order]
    idx = np.arange(len(cat))
    new_cat = np.concatenate([[True], cat[1:] != cat[:-1]])
    new_val = np.concatenate([[True], (s[1:] != s[:-1]) | new_cat[1:]])
    rk = (np.maximum.accumulate(np.where(new_val, idx, 0))
          - np.maximum.accumulate(np.where(new_cat, idx, 0)) + 1)
    keep = rk <= 5
    want = sorted(zip(cat[keep].tolist(), brand[keep].tolist(), s[keep].tolist(),
                      rk[keep].tolist()))
    rank_of = {(c, q): r for c, _b, q, r in want}

    def check(got):
        rows = list(zip(got["i_category_id"], got["i_brand_id"], got["qty"], got["rk"]))
        for (c1, _, q1, _), (c2, _, q2, _) in zip(rows, rows[1:]):
            if not (c1 < c2 or (c1 == c2 and q1 >= q2)):
                raise AssertionError(f"q47 rows out of order: {(c1, q1)} before {(c2, q2)}")
        for c, _b, q, r in rows:
            if rank_of.get((c, q)) != r:
                raise AssertionError(f"q47 rank {r} for {(c, q)}, oracle {rank_of.get((c, q))}")
        if sorted(rows) != want:
            raise AssertionError("q47 rows differ from the numpy oracle")

    return check, len(present), len(want)


def run_join_paths(dev, profile=False, trace_path=None):
    """q06 and q47 over one staged draw of store_sales and item."""
    import blaze_tpu_torch

    t0 = time.perf_counter()
    sales, item, parts, items, host, item_cols = make_join_data(dev)
    want06 = q06_oracle(host, item_cols)
    check47, groups47, rows47 = q47_oracle(host, item_cols)
    del host
    setup_s = time.perf_counter() - t0
    out = {}
    for name, plan, want, info in (
            ("q06", q06_plan(sales, item), want06, {"groups": len(want06["qty"])}),
            ("q47", q47_plan(sales, item), check47, {"groups": groups47, "out_rows": rows47})):
        session = blaze_tpu_torch.Session()
        session.resources["store_sales"] = lambda p: parts[p]
        session.resources["item"] = lambda p: items
        path_trace = trace_path.replace(".json", "") + f"_{name}.json" if trace_path else None
        out[name] = run_query(name, Q06_ROWS, session, plan, want, setup_s,
                              {"items": Q06_ITEMS, **info}, profile, path_trace)
    return out


Q69_SALES = (("store_sales", "ss_sold_date_sk", "ss_customer_sk", "LEFT_SEMI"),
             ("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", "LEFT_ANTI"),
             ("catalog_sales", "cs_sold_date_sk", "cs_ship_customer_sk", "LEFT_ANTI"))
Q69_CD = (("cd_gender", 2), ("cd_marital_status", 5), ("cd_education_status", 7),
          ("cd_purchase_estimate", 20), ("cd_credit_rating", 4), ("cd_dep_count", 7),
          ("cd_dep_employed_count", 7), ("cd_dep_college_count", 7))
Q69_KEYS = ("cd_gender", "cd_marital_status", "cd_education_status", "cd_purchase_estimate",
            "cd_credit_rating")


def q69_schemas():
    from blaze_tpu_torch.ir import types as T

    def sch(*names):
        return T.Schema.of(*[(n, T.I64) for n in names])

    out = {"customer": sch("c_customer_sk", "c_current_addr_sk", "c_current_cdemo_sk"),
           "customer_address": sch("ca_address_sk", "ca_state_id"),
           "customer_demographics": sch("cd_demo_sk", *[c for c, _ in Q69_CD]),
           "date_dim": sch("d_date_sk", "d_year", "d_moy")}
    for name, dcol, ccol, _ in Q69_SALES:
        out[name] = sch(dcol, ccol)
    return out


def make_q69_data(dev):
    """q69's tables at TPC-DS SF10's row counts (seed 69): customer keys
    1..500,000 with c_current_addr_sk uniform [1, 250,000] and
    c_current_cdemo_sk uniform [1, 1,920,800]; customer_address with
    ca_state_id uniform over 51 codes; customer_demographics as the
    mixed-radix cross product TPC-DS defines, decoded from cd_demo_sk - 1
    (gender 2, marital 5, education 7, purchase estimate 20 (500..10,000),
    credit 4, three dependant counts 7 each); date_dim from 2,415,022
    (1900-01-02), 73,049 days, d_year and d_moy from the date; the three
    sales tables with the sale date uniform over 2,450,816..2,452,642 and
    the customer uniform [1, 500,000]. 4% of every foreign key is null.
    Facts and customers in 4 partitions, dimensions in one, all staged on
    the card as 262,144-row batches. Returns the schemas, the staged
    batches and the host copies."""
    import numpy as np
    import torch

    rng = np.random.default_rng(Q69_SEED)
    schemas = q69_schemas()
    host = {}

    def fk(hi, n):
        valid = rng.random(n) >= 0.04
        return np.where(valid, rng.integers(1, hi + 1, n), 0), valid

    n = Q69_ROWS["customer"]
    addr, addr_v = fk(Q69_ROWS["customer_address"], n)
    cdemo, cdemo_v = fk(Q69_ROWS["customer_demographics"], n)
    host["customer"] = ((np.arange(1, n + 1), addr, cdemo), (None, addr_v, cdemo_v))
    n = Q69_ROWS["customer_address"]
    host["customer_address"] = ((np.arange(1, n + 1), rng.integers(0, 51, n)), None)
    n = Q69_ROWS["customer_demographics"]
    code, attrs = np.arange(n), []
    for _, radix in Q69_CD:
        attrs.append(code % radix)
        code = code // radix
    attrs[3] = attrs[3] * 500 + 500
    host["customer_demographics"] = ((np.arange(1, n + 1), *attrs), None)
    days = np.arange(2_415_022, 2_415_022 + Q69_ROWS["date_dim"])
    date = np.datetime64("1900-01-02") + (days - 2_415_022)
    host["date_dim"] = ((days, date.astype("datetime64[Y]").astype(np.int64) + 1970,
                         date.astype("datetime64[M]").astype(np.int64) % 12 + 1), None)
    for name, _d, _c, _ in Q69_SALES:
        n = Q69_ROWS[name]
        cust, cust_v = fk(Q69_ROWS["customer"], n)
        host[name] = ((rng.integers(Q69_SALES_DATES[0], Q69_SALES_DATES[1] + 1, n), cust),
                      (None, cust_v))
    staged = {}
    for name, (cols, valids) in host.items():
        if name in ("customer", "store_sales", "web_sales", "catalog_sales"):
            cuts = [len(cols[0]) * p // PARTS for p in range(PARTS + 1)]
            staged[name] = [stage_batches(
                schemas[name], [c[a:b] for c in cols], dev,
                valids=None if valids is None else
                [None if v is None else v[a:b] for v in valids])
                for a, b in zip(cuts, cuts[1:])]
        else:
            staged[name] = [stage_batches(schemas[name], cols, dev, valids=valids)]
    torch.cuda.synchronize()
    return schemas, staged, host


def q69_plan(schemas):
    """TPC-DS q69 (v3.2.0) as Spark plans it, in 4 partitions, with the
    null filters Spark's InferFiltersFromConstraints puts on the scans:
    customer (isnotnull on both foreign keys) JOIN broadcast
    customer_address (ca_state IN (...) AND isnotnull(ca_address_sk)) ->
    exchange by c_customer_sk -> LEFT SEMI store window, LEFT ANTI web
    window, LEFT ANTI catalog window, each a shuffled hash join (build
    right) against sales (isnotnull on the date and customer keys) JOIN
    broadcast date_dim (d_year = 2001 AND d_moy BETWEEN 4 AND 6 AND
    isnotnull(d_date_sk)), projected to the customer key and exchanged by
    it -> JOIN broadcast customer_demographics -> COUNT(*) by (gender,
    marital status, education, purchase estimate, credit rating),
    two-stage (a slot table of 4 * 8 * 8 * 16384 * 8 slots is past
    radix_agg_max_slots, so both stages take the sort route, K10) ->
    single exchange -> sort on the five keys, top 100. Each scan filter is
    a fused stage (K11 + K1); the answer is the one without them, since no
    join matches a null key."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    C = E.Column
    J = N.JoinType

    def lit(op, c, v):
        return E.BinaryExpr(op, C(c), E.Literal(v, T.I64))

    def scan(name, parts=PARTS):
        return N.FFIReader(schemas[name], name, parts)

    def by(child, keys):
        return N.ShuffleExchange(child, N.HashPartitioning([C(k) for k in keys], PARTS))

    def both(a, b):
        return E.BinaryExpr(E.BinaryOp.AND, a, b)

    def notnull(a, b):
        return both(E.IsNotNull(C(a)), E.IsNotNull(C(b)))

    eq = E.BinaryOp.EQ
    states = E.InList(C("ca_state_id"), [E.Literal(s, T.I64) for s in Q69_STATES])
    address = N.Filter(scan("customer_address", 1),
                       [both(states, E.IsNotNull(C("ca_address_sk")))])
    customer = N.Filter(scan("customer"), [notnull("c_current_addr_sk", "c_current_cdemo_sk")])
    cust = N.BroadcastJoin(customer, N.BroadcastExchange(address),
                           [(C("c_current_addr_sk"), C("ca_address_sk"))], J.INNER,
                           N.JoinSide.RIGHT, "q69_address")
    out = by(N.Projection(cust, [C("c_customer_sk"), C("c_current_cdemo_sk")],
                          ["c_customer_sk", "c_current_cdemo_sk"]), ["c_customer_sk"])
    dates = N.Filter(scan("date_dim", 1), [lit(eq, "d_year", 2001),
                                           lit(E.BinaryOp.GTEQ, "d_moy", 4),
                                           lit(E.BinaryOp.LTEQ, "d_moy", 6),
                                           E.IsNotNull(C("d_date_sk"))])
    for name, dcol, ccol, jt in Q69_SALES:
        window = N.BroadcastJoin(N.Filter(scan(name), [notnull(dcol, ccol)]),
                                 N.BroadcastExchange(dates),
                                 [(C(dcol), C("d_date_sk"))], J.INNER, N.JoinSide.RIGHT,
                                 f"q69_dates_{name}")
        window = by(N.Projection(window, [C(ccol)], [ccol]), [ccol])
        out = N.HashJoin(out, window, [(C("c_customer_sk"), C(ccol))], J[jt],
                         N.JoinSide.RIGHT)
    out = N.BroadcastJoin(out, N.BroadcastExchange(scan("customer_demographics", 1)),
                          [(C("c_current_cdemo_sk"), C("cd_demo_sk"))], J.INNER,
                          N.JoinSide.RIGHT, "q69_demographics")
    agg = two_stage_agg(out, list(Q69_KEYS), [("cnt", E.AggExpr(E.AggFunction.COUNT, []))])
    return N.Sort(N.ShuffleExchange(agg, N.SinglePartitioning(1)),
                  [E.SortOrder(C(k)) for k in Q69_KEYS], fetch_limit=100)


def q69_oracle(host):
    """q69 by set operations in numpy on the host copies: the customers in
    the three states who bought in a store in April-June 2001 and on
    neither the web nor the catalog then, counted by their five
    demographics, the first 100 groups in key order. Also returns the
    customers left after each step."""
    import numpy as np

    (c_sk, c_addr, c_cd), (_, addr_v, cd_v) = host["customer"]
    (ca_sk, ca_state), _ = host["customer_address"]
    in_states = np.zeros(Q69_ROWS["customer_address"] + 1, bool)
    in_states[ca_sk[np.isin(ca_state, Q69_STATES)]] = True
    keep = addr_v & in_states[c_addr]
    steps = {"address": int(keep.sum())}
    (d_sk, d_year, d_moy), _ = host["date_dim"]
    window = np.zeros(d_sk[-1] + 1, bool)
    window[d_sk[(d_year == 2001) & (d_moy >= 4) & (d_moy <= 6)]] = True
    for name, _d, _c, jt in Q69_SALES:
        (date, cust), (_, cust_v) = host[name]
        bought = np.zeros(Q69_ROWS["customer"] + 1, bool)
        bought[cust[cust_v & window[date]]] = True
        keep &= bought[c_sk] if jt == "LEFT_SEMI" else ~bought[c_sk]
        steps[name] = int(keep.sum())
    keep &= cd_v
    cd_cols = dict(zip(["cd_demo_sk"] + [c for c, _ in Q69_CD],
                       host["customer_demographics"][0]))
    rows = c_cd[keep] - 1
    keys = np.stack([cd_cols[k][rows] for k in Q69_KEYS], axis=1)
    groups, counts = np.unique(keys, axis=0, return_counts=True)
    groups, counts = groups[:100], counts[:100]  # np.unique sorts rows lexically
    want = {k: groups[:, i].tolist() for i, k in enumerate(Q69_KEYS)}
    want["cnt"] = counts.tolist()
    return want, steps, len(rows)


def run_q69(dev, profile=False, trace_path=None):
    import blaze_tpu_torch

    t0 = time.perf_counter()
    schemas, staged, host = make_q69_data(dev)
    want, steps, agg_rows = q69_oracle(host)
    del host
    setup_s = time.perf_counter() - t0
    session = blaze_tpu_torch.Session()
    for name, parts in staged.items():
        session.resources[name] = lambda p, _parts=parts: _parts[p]
    return run_query("q69", sum(Q69_ROWS.values()), session, q69_plan(schemas), want,
                     setup_s, {"customers_after": steps, "agg_rows": agg_rows,
                               "groups": len(want["cnt"])}, profile, trace_path)


# -- q96: a global COUNT through the host table (K12) ----------------------------

Q96_SEED = 96
# TPC-DS SF10 row counts of q96's tables
Q96_ROWS = {"store_sales": 28_800_991, "time_dim": 86_400, "household_demographics": 7_200,
            "store": 102}
# s_store_name as a code of the ten names TPC-DS's store generator draws
# from ("ought", "able", "pri", "ese", "anti", "cally", "ation", "eing",
# "bar", "n st"); the query asks for 'ese'
Q96_NAMES = 10
Q96_ESE = 3


def q96_schemas(T):
    def sch(*names):
        return T.Schema.of(*[(n, T.I64) for n in names])

    return {"store_sales": sch("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"),
            "time_dim": sch("t_time_sk", "t_hour", "t_minute"),
            "household_demographics": sch("hd_demo_sk", "hd_dep_count"),
            "store": sch("s_store_sk", "s_store_name")}


def q96_host(rows, seed=Q96_SEED, null_share=0.04):
    """q96's tables on the host, at ``rows``' row counts: time_dim one row a
    second of the day (t_time_sk 0..86,399, t_hour = sk // 3600, t_minute
    = sk // 60 % 60); household_demographics as TPC-DS's cross product,
    hd_dep_count decoded from hd_demo_sk - 1 (income band 20, buy
    potential 6, then dep count 10); store names uniform over Q96_NAMES
    codes; store_sales' three foreign keys uniform over their dimension's
    keys, ``null_share`` of each null (data 0). Returns {table: (columns,
    validities or None)}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sk = np.arange(rows["time_dim"])
    hd = np.arange(1, rows["household_demographics"] + 1)
    st = np.arange(1, rows["store"] + 1)
    host = {"time_dim": ((sk, sk // 3600, sk // 60 % 60), None),
            "household_demographics": ((hd, (hd - 1) // 120 % 10), None),
            "store": ((st, rng.integers(0, Q96_NAMES, len(st))), None)}
    n = rows["store_sales"]
    cols, valids = [], []
    for lo, hi in ((0, rows["time_dim"]), (1, rows["household_demographics"] + 1),
                   (1, rows["store"] + 1)):
        v = rng.random(n) >= null_share
        cols.append(np.where(v, rng.integers(lo, hi, n), 0))
        valids.append(v)
    host["store_sales"] = (tuple(cols), tuple(valids))
    return host


def q96_plan(schemas, E, N, T, parts=PARTS):
    """TPC-DS q96 (v3.2.0) as Spark plans it (tests/tpcds/queries.py:309),
    with the null filters Spark infers on the scans, in the IR modules
    ``E``, ``N``, ``T`` of either package: store_sales (isnotnull on its
    three keys) JOIN broadcast time_dim (t_hour = 20 AND t_minute >= 30)
    JOIN broadcast household_demographics (hd_dep_count = 7) JOIN
    broadcast store (s_store_name = 'ese') -> PARTIAL COUNT(1) without
    keys -> single exchange -> FINAL COUNT -> ORDER BY count LIMIT 100."""
    C, B = E.Column, E.BinaryOp
    J = N.JoinType

    def scan(name, p=1):
        return N.FFIReader(schemas[name], name, p)

    def all_of(*preds):
        out = preds[0]
        for p in preds[1:]:
            out = E.BinaryExpr(B.AND, out, p)
        return out

    def cmp(op, c, v):
        return E.BinaryExpr(op, C(c), E.Literal(v, T.I64))

    def nn(*cols):
        return [E.IsNotNull(C(c)) for c in cols]

    sales = N.Filter(scan("store_sales", parts),
                     [all_of(*nn("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"))])
    time = N.Filter(scan("time_dim"), [all_of(*nn("t_hour", "t_minute", "t_time_sk"),
                                              cmp(B.EQ, "t_hour", 20),
                                              cmp(B.GTEQ, "t_minute", 30))])
    hd = N.Filter(scan("household_demographics"),
                  [all_of(*nn("hd_dep_count", "hd_demo_sk"), cmp(B.EQ, "hd_dep_count", 7))])
    store = N.Filter(scan("store"), [all_of(*nn("s_store_name", "s_store_sk"),
                                            cmp(B.EQ, "s_store_name", Q96_ESE))])
    out = sales
    for dim, fk, pk in ((time, "ss_sold_time_sk", "t_time_sk"),
                        (hd, "ss_hdemo_sk", "hd_demo_sk"),
                        (store, "ss_store_sk", "s_store_sk")):
        out = N.BroadcastJoin(out, N.BroadcastExchange(dim), [(C(fk), C(pk))], J.INNER,
                              N.JoinSide.RIGHT, f"q96_{pk}")
    count = E.AggExpr(E.AggFunction.COUNT, [E.Literal(1, T.I32)])
    partial = N.Agg(out, E.AggExecMode.HASH_AGG, [],
                    [N.AggColumn(count, E.AggMode.PARTIAL, "cnt")])
    final = N.Agg(N.ShuffleExchange(partial, N.SinglePartitioning(1)),
                  E.AggExecMode.HASH_AGG, [], [N.AggColumn(count, E.AggMode.FINAL, "cnt")])
    return N.Sort(final, [E.SortOrder(C("cnt"))], fetch_limit=100)


def q96_oracle(host):
    """q96's count in numpy: the sales rows whose three keys are valid and
    whose time, household and store pass the dimension filters."""
    import numpy as np

    (t_sk, t_hour, t_minute), _ = host["time_dim"]
    (hd_sk, dep), _ = host["household_demographics"]
    (s_sk, name), _ = host["store"]
    (time, hdemo, store), (tv, hv, sv) = host["store_sales"]
    t_ok = np.zeros(t_sk.max() + 1, bool)
    t_ok[t_sk[(t_hour == 20) & (t_minute >= 30)]] = True
    h_ok = np.zeros(hd_sk.max() + 1, bool)
    h_ok[hd_sk[dep == 7]] = True
    s_ok = np.zeros(s_sk.max() + 1, bool)
    s_ok[s_sk[name == Q96_ESE]] = True
    keep = tv & hv & sv & t_ok[time] & h_ok[hdemo] & s_ok[store]
    return {"cnt": [int(keep.sum())]}


def run_q96(dev, profile=False, trace_path=None):
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schemas = q96_schemas(T)
    host = q96_host(Q96_ROWS)
    want = q96_oracle(host)
    session = blaze_tpu_torch.Session()
    for name, (cols, valids) in host.items():
        if name == "store_sales":
            cuts = [len(cols[0]) * p // PARTS for p in range(PARTS + 1)]
            parts = [stage_batches(schemas[name], [c[a:b] for c in cols], dev,
                                   valids=[v[a:b] for v in valids])
                     for a, b in zip(cuts, cuts[1:])]
        else:
            parts = [stage_batches(schemas[name], cols, dev)]
        session.resources[name] = lambda p, _parts=parts: _parts[p]
    del host
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    return run_query("q96", sum(Q96_ROWS.values()), session, q96_plan(schemas, E, N, T),
                     want, setup_s, {"count": want["cnt"][0]}, profile, trace_path)


def check_result(name, got, want):
    """``want`` is the oracle's result (equal, order included) or a
    function that raises when ``got`` is wrong."""
    if callable(want):
        want(got)
    elif got != want:
        raise AssertionError(f"{name} differs from the numpy oracle")


def run_query(name, rows, session, plan, want, setup_s, info, profile, trace_path):
    """A first run, then one run with the launch counts set to 0 just before
    and read just after; both exact against the oracle."""
    import torch
    from blaze_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    warm = session.execute_to_pydict(plan)
    warm_s = time.perf_counter() - t0
    check_result(f"{name} (first run)", warm, want)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    got = session.execute_to_pydict(plan)
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    check_result(name, got, want)
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_query(name, session, plan, want, trace_path)
    log(json.dumps({"phase": "slice", "query": name, "rows": rows, "partitions": PARTS,
                    **info, "setup_s": setup_s, "first_run_s": warm_s, "wall_s": wall,
                    "rows_per_s": rows / wall, "max_memory_allocated": peak,
                    "launches": launches, "exact": True}))
    return launches


def profile_query(name, session, plan, want, trace_path=None):
    """One more run under torch.profiler: the device's busy time (the
    kernels' and copies' own device time -- one stream, so they do not
    overlap) against the run's wall, the launch/copy/sync counts, and the
    kernels that take the time; the Chrome trace to ``trace_path`` when
    given. Then one run under cProfile: the package's functions that hold
    the host longest (cumulative seconds, inflated by the profiler's own
    cost)."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = session.execute_to_pydict(plan)
        wall = time.perf_counter() - t0
    check_result(f"{name} (profiled run)", got, want)
    avgs = prof.key_averages()
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    calls = {e.key: e.count for e in avgs
             if e.key in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    k11 = [e for e in device if e.key.startswith("fused_chain")]
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    log(json.dumps({"phase": "profile", "query": name, "wall_s": wall,
                    "device_busy_s": busy_us / 1e6,
                    "device_busy_share": busy_us / 1e6 / wall,
                    "host_calls": calls,
                    "k11_device": {"calls": sum(e.count for e in k11),
                                   "device_ms": sum(e.self_device_time_total
                                                    for e in k11) / 1e3},
                    "top_device": [{"name": e.key[:80], "calls": e.count,
                                    "device_ms": e.self_device_time_total / 1e3}
                                   for e in top]}))
    torch.cuda.synchronize()
    host = cProfile.Profile()
    t0 = time.perf_counter()
    host.enable()
    got = session.execute_to_pydict(plan)
    torch.cuda.synchronize()
    host.disable()
    wall = time.perf_counter() - t0
    check_result(f"{name} (host-profiled run)", got, want)
    stats = pstats.Stats(host).stats  # {(file, line, function): (cc, calls, tt, ct, _)}
    ours = [(f"{os.path.relpath(f, ROOT)}:{line} {fn}", v[1], v[3])
            for (f, line, fn), v in stats.items() if "blaze_tpu_torch" in f]
    top_host = sorted(ours, key=lambda x: x[2], reverse=True)[:25]
    log(json.dumps({"phase": "host_profile", "query": name, "wall_s": wall,
                    "top_cumulative": [{"function": f, "calls": c, "cum_s": t}
                                       for f, c, t in top_host]}))


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
    kernel_k5(dev, rng, results)
    kernel_k6(dev, rng, results)
    kernel_k7(dev, rng, results)
    kernel_k8(dev, rng, results)
    kernel_k9(dev, rng, results)
    kernel_k10(dev, rng, results)
    kernel_k11(dev, rng, results)
    kernel_k12(dev, rng, results)
    # 4. the paths: q01, q67 (slot, sort and table routes), q06 and q47,
    # q69, then q96
    args = sys.argv[1:]
    profile = "--profile" in args
    trace = [a.split("=", 1)[1] for a in args if a.startswith("--trace=")]
    per_path = {
        "q01": run_q01(dev, profile, trace[0] if trace else None),
        **run_q67(dev, profile, trace[0] if trace else None),
        **run_join_paths(dev, profile, trace[0] if trace else None),
        "q69": run_q69(dev, profile, trace[0].replace(".json", "") + "_q69.json"
                       if trace else None),
        "q96": run_q96(dev, profile, trace[0].replace(".json", "") + "_q96.json"
                       if trace else None),
    }
    launches = {k: sum(p[k] for p in per_path.values()) for k in per_path["q01"]}
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels launched by no path: {missing}")
    for q in ("q06", "q47", "q69"):
        if per_path[q]["inner_join_planes"] <= 0:
            raise AssertionError(f"{q} did not go through the join kernel")
    if per_path["q69"]["probe_codes"] <= 0:
        raise AssertionError("q69 did not go through the generic probe kernel")
    for q in ("q69", "q67_sort"):
        for k in ("segment_ids", "seg_agg_partial", "seg_agg_merge"):
            if per_path[q][k] <= 0:
                raise AssertionError(f"{q} did not go through K10 ({k})")
    # K11: every sales batch of q69 (112 + 28 + 56), and the root rank
    # filters of q67, q67_sort and q47
    for q, least in (("q69", 196), ("q67", 1), ("q67_sort", 1), ("q47", 1)):
        if per_path[q]["fused_chain"] < least:
            raise AssertionError(f"{q} launched K11 {per_path[q]['fused_chain']} times, "
                                 f"fewer than {least}")
    # K12: q96's partial (a launch per joined sales batch, 112) and its
    # final table (1); q67_table's FINAL merge on every reducer (a launch
    # per state batch), none of them on the device merge
    if per_path["q96"]["slot_update"] != 113:
        raise AssertionError(f"q96 launched K12 {per_path['q96']['slot_update']} times, "
                             "not 112 partial batches and 1 final")
    if per_path["q67_table"]["slot_update"] < PARTS or per_path["q67_table"]["slot_agg_merge"]:
        raise AssertionError("q67_table's FINAL merge did not take the host table (K12) "
                             "on every reducer")
    # 5. summary lines
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in results:
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        r["launches"] = launches[r["name"]]
        r["launches_per_path"] = {q: per_path[q][r["name"]] for q in per_path}
        r["max_abs_err"] = MAX_ERR[r["name"]]
        log(json.dumps({"phase": "kernel", "name": r["name"], "shape": r["shape"],
                        "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"], "library_call": r["library_call"],
                        "bound_ms": r["bound_ms"], "bytes": r["bytes"],
                        "launches": r["launches"],
                        "launches_per_path": r["launches_per_path"],
                        "exact_cases": r["cases"],
                        **{k: r[k] for k in ("ms_262144_rows", "digit_passes", "hits",
                                             "build_rows_touched", "big_batch", "route_ms",
                                             "segment_ids_ms", "k11_only_ms", "k11_only_bytes",
                                             "battery_s", "fold_ms", "unpacked_ms")
                           if k in r}}))
        kernels.append({k: r[k] for k in keys})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
