#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (blaze_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and the last line is printed
only when every phase passed:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the kernel library from blaze_tpu_torch/csrc (nvcc, sm_90a),
   with its build seconds;
3. kernels: K1-K19 held against their plain PyTorch versions on the
   card, exactly (float planes bit for bit), at the main paths' shapes and
   at edge cases (nulls, all-false and all-true masks, padding rows, keys
   next to the slot range, one to three sort keys ASC/DESC with nulls
   first/last, int64 min/max, bools, f64 NaN, +-0.0 and subnormals, mixed plane
   capacities, offsets past the end, empty batches in a concat; for the
   gather (K6): every element size in one call, 33 planes, no row, masked
   takes, out_cap past n_out, an index not 16-byte aligned, timed with
   device and host ms at the q67 sort's, a sort10M reducer's and the sort
   route's key take; for the
   join: misses, null probe keys, an empty build, one build key, a
   null-keyed build row, int32/f32/f64 keys with +-0.0 and NaN payloads,
   and q06's batch all hitting and half missing, on both search routes
   where the build words are dense, then q96's three chained probes and
   q69's date probe of a store_sales batch; for the generic probe:
   the same key kinds, keys below and above the build's range, an empty
   build, one build key, q69's probe batch and a 262,144-row batch of
   customer keys against the store window's keys; for the segmented
   aggregate: the segmentation with each group's keys (one launch, held
   to the starts and a gather of the keys at the groups' first rows;
   its kernels a call listed by torch.profiler: one, no memset), one to
   five int/float keys, direct and sorted segmentation,
   nulls, padding, all-null keys, int64/int32/f64/f32 arguments with NaN,
   +-0.0, +-inf and subnormals, partial and merge, a q67 batch and a
   q67_sort reducer's merge, segments of 1, 31, 32, 33, 524, 2,048,
   2,049, 4,096 and 262,144 rows (a thread, a warp, a warp a piece) with
   every limb kind too, and a float sum whose value depends on the order
   of its adds; for K3/K4 also both sides of the shared-memory switch
   with the LEX pairs, one block and many; for the fused chain, K11 (a Triton kernel
   generated per chain, compacting its filtered groups itself): every
   step kind (project,
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
   an empty batch, and K12's main paths' shapes, each held to the plain
   version and timed with device ms beside a library chain: a q67_table
   merge batch, q96's COUNT(1) batch, q17_table's FINAL merge of wide
   sums, the lexicographic fold of a q17 batch, a float64 SUM into
   q67_table's slots and into one slot; for the window
   aggregates' segmented scan, K13: int64, int32, float64 and float32
   planes, magnitudes 1e-5..1e16 with +-inf, -0.0 and NaN, nulls,
   padding, capacities 16, 4,096 and 262,144 with live rows not a
   multiple of 16, carries, segments of one row, of ~4 rows, one spanning
   the batch and none; for the limb halves of K3/K4, K10 and K12 (the
   wide-decimal states): sum2/avg2/sum3/avg3/minw/maxw in partial and
   merge mode on K3, K4 and K10 (K12's limb update, merge and
   lexicographic-fold ops in K12's phase), over negative values, 38-digit
   extremes and values past 2^64, all-negative extremes, cancellation near the
   extremes, single rows, one row, nulls, padding and every value null,
   then timed at q17's shapes); for the range exchange's partition ids,
   K14: one to five and sixteen keys of int64/int32/int16/int8/bool/
   float32/float64/decimal, ASC and DESC, nulls first and last, NaN and
   +-0.0 in rows and bounds, int64 min and max, null bounds, 0, 1, 3, 7,
   31, 199, 400 and 1,200 bounds (the last two past the shared-memory
   stage), padding rows, 1 to 262,145 rows, planes as views at odd
   element offsets, sort10M's map batch, each on every route its bounds
   allow (count, search, search in global memory), then timed at 31 and
   199 bounds, on one key beside torch.searchsorted and at hash_sample's
   store exchange with the wrapper's host ms, and each route's device ms
   at 3 to 199 bounds (and every K14 launch of q98's and sort10M's first
   runs held to the twin on that batch); for the XXH64 row hash, K15:
   every lane at its own width (int8, int16, int32, int64, date,
   timestamp, bool, float32 and float64 bits with -0.0, +-inf and four
   NaN payloads, decimal(7,2) and decimal(18,0) unscaled), nulls at 0%,
   4%, 15% and 100%, 1 to 32 columns, 1 to 262,145 rows with padding
   rows and none live, planes as views at odd element offsets, each also
   against a numpy XXH64, Spark's golden longs and its documented
   xxhash64('Spark', array(123), 2) with a byte and a short, timed at
   hash_sample's and q69_bloom's batches with the wrapper's host ms (and
   every K15 launch of hash_sample's first run held to the twin);
   for the bloom filter's probe, K16: k = 1, 2, 6 and 8 hash functions,
   64, 192 (three words: the modulo is not a mask), 8,388,608 and
   67,108,864 bits, int64 min and max, 0 and -1, combined hashes that go
   negative, 0% and 15% nulls, padding rows and none live, each also
   against a numpy probe, timed at a q69_bloom store batch (262,144 rows,
   the path's 1 MiB filter, k = 6) (and every K16 launch of q69_bloom's
   first run held to the twin);
   for the device mesh's all-to-all, K17: 1, 2 and 8 slots, 1 to 40
   reducers (more reducers than slots), bool/int8/int16/int32/int64/
   float32/float64 planes with NaN, +-0.0, +-inf, subnormals and int
   extremes, null and padding rows, empty slots and every slot empty, a
   skewed reducer over many rounds, tile mode (exchange_and_aggregate's
   masked tiles), and sort10M_mesh's exchange (8 slots of 1,250,000 rows,
   32 reducers, 12 planes), timed there beside the library chain
   (index_select per plane and slot, the block permute copy) (and every
   K17 launch of the mesh paths' first runs held to the twin, the first
   exchange of each timed); for the stacked K11 (ShardedFusedRunner):
   nine chains of K11's battery (every step kind and expression family)
   over stacks of 1 to 8 batches, each batch held to the single-batch
   plain version, and 8 q96 store batches of 262,144 rows held to it and
   to the single-batch K11, timed against 8 single K11 dispatches (and
   every stacked launch of the mesh paths' first runs held batch by batch
   to the stacked plain version); (after phase 4) the mesh's demo steps,
   exchange_and_aggregate and broadcast_join_sum at 8 slots of 262,144
   rows, each held to the same step on the plain versions and to numpy and
   timed beside it, and run_distributed_sum end to end;
   K11's battery also covers CASE and Cast/TryCast; for the fused
   aggregate input, K18 (a Triton kernel generated per fused aggregate):
   one to three chained joins, the second keyed by the first's build
   column, int64/int32/float32/float64 keys with +-0.0, NaN payloads and
   +-inf, null and padding probe rows, an empty build and one build key,
   the build on the left, predicates over the joined schema, absorbed
   project/filter/rename steps, q01's decimal predicate, every row
   filtered, an empty batch, q17's wide-decimal argument and each rank
   route (dense words with misses on both sides, a bitmap range of 256 x
   nk, a search range one past it and over the int64 ends), each then
   through K3 and K10 over K18's live mask against their plain versions,
   timed (device and host ms) at q17's path batch (262,144 rows, items
   1..102,000 and stores 1..400: dense), q17's probe batch (102,000 of
   408,010 item words: bitmap), q89's (items sparse, dates and stores
   dense) and q01's (no join) beside the library chain (searchsorted +
   index_select + where per plane) (and every K18 launch of q01's, q17's
   and q89's first runs held to the plain version; each fused path logs
   its joins' routes, a ``k18_routes`` line); for the stable compaction, K1: a 1,024-row
   tile's edges, every element size, 40 and 130 planes, a mask at an odd
   address, timed (device and host ms, one kernel a call) at
   hash_sample's, q69_bloom's and q96_mesh's batches; for the passthrough of a skipped partial, K19:
   every partial kind (SUM, AVG, COUNT, MIN, MAX and the limb kinds
   sum2/avg2/sum3/avg3/minw/maxw) over int64, int32, float64 and float32
   arguments with NaN, +-0.0, +-inf and subnormals, a decimal rescale that
   wraps int64, 38-digit limbs, one to three int32/int64 keys and a float
   key, nulls, padding, one row and every value null, capacities 256 and
   4,096, each with a fresh argument pack and then all through one pack
   (a task's batches), and cust_spend's batch (262,144 rows, an int32
   customer key, a sum2 state), timed there beside the library chain
   (torch.where and bit ops per plane), with the wrapper's host time
   alone; then each timed with
   CUDA events beside its plain version, one PyTorch library call (or a
   chain of them, said so) where one computes the same function, and its
   bound (bytes moved over 3.35 TB/s); K3, K4 and K10 also by device ms
   (torch.profiler), and at q06's batch (10 groups) and one group (K3),
   cust_spend_noskip's batch with and without its null keys and one
   segment of 262,144 rows (K10);
4. paths, each checked against a numpy oracle, with the launch counts
   set to 0 just before its measured run and read just after:
   - TPC-DS q01 (filter -> partial agg -> murmur3 hash exchange -> final
     agg -> top 100) over 28,795,080 store_returns rows (the SF100 row
     count) drawn as bench.py draws them; the filter fuses into the
     partial aggregate (K18 a batch, no K1);
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
     (rows tied on quantity in any order); the join fuses into the
     partial aggregate (K18 a sales batch, no K8);
   - q69 (customer JOIN broadcast address in three states -> exchange ->
     LEFT SEMI store window, LEFT ANTI web window, LEFT ANTI catalog
     window, each a shuffled hash join against sales JOIN broadcast
     date_dim of April-June 2001 -> JOIN broadcast demographics -> COUNT(*)
     by the five demographics TPC-DS names (sort route: K10) -> sort, top
     100) over TPC-DS SF10's row counts (seed 69), with the null filters
     Spark infers on its scans (each a fused stage: K11 + K1), exact in
     order against set operations in numpy; then q69_bloom on the same
     data, with Spark's runtime bloom filter on the store side: the scalar
     subquery (customer JOIN address -> single exchange ->
     bloom_filter(xxhash64(c_customer_sk)) on the host table, K15) runs
     first and its filter is shipped into the store scan's filter,
     might_contain(filter, xxhash64(ss_customer_sk)) merged with the null
     checks (unfused: K15 + K16 + K1 a store batch, 112); exact against
     q69's oracle, the filter byte for byte against a numpy bloom filter,
     the store side's kept rows against the numpy probe's (1,513,707 of
     28,800,991), wall = subquery + query;
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
   - q89 (store_sales JOIN broadcast item (q89's category/class lists)
     JOIN broadcast date_dim (d_year = 1999) JOIN broadcast store -> SUM
     by six keys, two-stage -> hash exchange by the four window keys ->
     sort -> Window avg(sum_sales) over the whole partition (K13) ->
     Spark's own filter, CASE WHEN avg <> 0 THEN abs(CAST(sum AS DOUBLE)
     - avg) / avg ELSE NULL END > 0.1 (unfused: K1) -> top 100) over
     TPC-DS SF10's row counts (seed 89), exact against numpy (rows tied
     on the sort key as sets), K13 on every reducer that holds rows and
     K18 on every sales batch (its three joins fused, no K8);
   - q17 (store_sales JOIN broadcast item JOIN broadcast store -> COUNT,
     SUM(ss_quantity) and SUM(ss_ext_wholesale_cost), decimal(38,2), by
     (state, category), two-stage -> single exchange -> sort) over q06's
     store_sales draw with bench.py's wcost stream (seed 421), SF10's
     items and 400 stores: the wide sum crosses the exchange as
     three-limb states; on the default route (K18 over both joins, K3,
     K4), as q17_sort (K18, K10), as q17_table (the host table's FINAL
     merge, K12) and as q17_unfused (``fused_filter_agg=False``: both
     joins through K8, then K3), each exact in order against numpy;
   - q98 (store_sales JOIN broadcast item (Sports, Books, Home) JOIN
     broadcast date_dim (February 1999) -> SUM(ss_quantity) by five
     keys on the sort route (K10), two-stage -> hash exchange by i_class
     -> sort -> Window sum over i_class (K13) -> the revenue ratio ->
     range exchange on the five ORDER BY keys, bounds sampled by the
     Session (K14) -> sort) over TPC-DS SF10's row counts (seed 98),
     exact in order against numpy (rows tied on all five keys as sets);
   - sort10M, the soak's global sort (scripts/scale_soak.py:98): bench.py's
     five store_sales columns, the decimal(38,2) one as limbs, 10,000,000
     rows in 32 partitions (seed 1010) -> range exchange on
     (ss_sales_price DESC, ss_item_sk) into 32, bounds sampled (K14 on
     every map-side bucketize pass) -> sort; the keys exact in order
     against numpy's stable sort, the rows as multisets within tied keys
     (collected as numpy planes through ``Session().execute``);
   - hash_sample, a stable 10% hash sample of store_sales (SELECT
     ss_store_sk, count(*), sum(ss_quantity), sum(ss_sales_price) WHERE
     abs(xxhash64(ss_item_sk, ss_ticket_number)) % 100 < 10 GROUP BY
     ss_store_sk ORDER BY ss_store_sk: the filter K15 + K1 a batch ->
     partial agg -> hash exchange -> final agg -> range exchange, bounds
     sampled (K14) -> sort) over 28,800,991 rows typed as Spark's TPC-DS
     schema (int32 keys, decimal(7,2) price; seed 1115), exact in order
     against a numpy XXH64 and ``np.bincount`` sums, K15 once a sales
     batch (112);
   - cust_spend, TPC-DS q23's best_ss_customer aggregate (SELECT
     ss_customer_sk, SUM(ss_quantity * ss_sales_price) GROUP BY
     ss_customer_sk, the sum a decimal(28,2) two-limb state; PARTIAL with
     partial skipping -> hash exchange into 16 reducers -> FINAL -> single
     exchange -> top 100 by the sum DESC, a decimal(28,2) sort key) over
     28,800,991 store_sales rows whose customer keys are SF100's
     2,000,000 (1% null; seed 2323): each partition's first batch runs
     K3's radix pass, the skipper flips (its per-bucket estimate ~0.93)
     and the other 108 batches run K19; and cust_spend_noskip, the same
     with ``partial_agg_skipping_enable=False`` (no K19); both exact
     against numpy sums (the top 100 in order, tied rows as sets) and
     equal; then a host-table skip check (FIRST and COUNT by customer over
     4 batches of 65,536 rows: three skipped batches, exact);
   - the device mesh (``Session(device, mesh=make_mesh(k, dev),
     conf=Config(multichip_enabled=True))``, every slot on the one card):
     q01_mesh1, q01_mesh2 and q01_mesh8 (q01 on 1, 2 and 8 slots: K17
     once on its hash exchange and once on its single one), q96_mesh
     (q96 on 8 slots: the store_sales filter's batches in stacks of 8
     through the stacked K11, counted against the stacking of the staged
     batches' capacities, and K11 q96's count less the stacked batches)
     and sort10M_mesh (sort10M on 8 slots: 32 maps fold 4 a slot, one K17
     exchange round, the payload past the 128 MiB resident budget so the
     reducers wait in host memory), each exact against its path's oracle;
   all through ``Session().execute_to_pydict`` (sort10M: ``execute``) in
   partitions staged on the card; every kernel must have launched over
   the runs, K18 on every path whose partial aggregate sits on a Filter
   or a unique-key inner broadcast join (q01 and its mesh paths, q06,
   q47, q17, q17_sort, q17_table, q89, q98, q69, q69_bloom) and on no
   other, every
   limb op over the runs or the battery, the
   unique-key join kernel on q69 and q17_unfused, the generic probe on q69,
   K10's three launches on q69 and q67_sort, K11 on every q69 sales
   batch (196) and on the root rank filter of q67, q67_sort and q47,
   K12 on q96 and q67_table, K13 on q89 and q98, K14 on q98, on
   hash_sample and on sort10M once a map-side bucketize pass, K15 on
   every hash_sample sales batch, and K16 on every q69_bloom store batch
   (112), with K11 there q69's count less those 112 plus the subquery's
   five; K19 on cust_spend only, and no other path skipping a partial;
5. one JSON line per kernel (shape, times, bound, launches per path; the
   limb halves as ``name:limbs``), the limb ops' launch counts, the
   kernels' summary JSON line, the card line, and the device JSON line.

``--profile`` adds one run of each path under torch.profiler (device busy
share, launch and sync counts, the top kernels); ``--trace=PATH`` also
writes q01's Chrome trace to PATH and the other paths' beside it
(``_q67.json``, ``_q67_sort.json``, ``_q67_table.json``, ``_q06.json``,
``_q47.json``, ``_q69.json``, ``_q69_bloom.json``, ``_q96.json``,
``_q89.json``, ``_q17.json``,
``_q17_sort.json``, ``_q17_table.json``, ``_q17_unfused.json``, ``_q98.json``,
``_sort10m.json``,
``_hash_sample.json``, ``_cust_spend.json``, ``_cust_spend_noskip.json``,
and the mesh paths' ``_q01_mesh1.json``,
``_q01_mesh2.json``, ``_q01_mesh8.json``, ``_q96_mesh.json``,
``_sort10m_mesh.json``).

Needs one CUDA device; exits 2 without one, or when run outside a checkout
of the repository.
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS = 28_795_080
PARTS = 4
N_STORES = 400
HS_STORES = 102  # SF10's stores (hash_sample's, the K14 shape of its ORDER BY)
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
    if not a.is_floating_point():
        # exact: int64 limbs differing by one can round to one float64
        b = b.to(a.device)
        if torch.equal(a, b):
            return 0.0
        return max(1.0, float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item()))
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


# the device time of a hand-written kernel's call: every kernel of the port's
# CUDA sources (all named blz_*) and the memsets its wrapper issues, not the
# torch ops around them
OURS = ("blz_", "Memset")


def shape_times(fn, plain, lib, nbytes, prefix=OURS):
    """One more shape of a kernel: CUDA events and device ms of the call,
    its plain version's events, a library chain's events and device ms
    (None without one), and the bound of ``nbytes`` over the HBM rate."""
    return dict(ms=time_ms(fn), device_ms=kernel_device_ms(fn, prefix),
                plain_ms=time_ms(plain), library_ms=time_ms(lib) if lib else None,
                library_device_ms=kernel_device_ms(lib, "") if lib else None,
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def seg_reduce_bytes(n, groups, ops, emits):
    """K10's reduction moves at least: the permutation and each distinct
    source or validity plane read once over the n rows, the starts read
    once, and per group each emit and the first row written once."""
    planes = {}
    for op in ops:
        for t in [op.src, op.src0, *op.valids]:
            if t is not None:
                planes[t.data_ptr()] = t.element_size()
    out = sum(1 if e.kind == 1 else 8 for e in emits) + 8
    return n * (8 + sum(planes.values())) + (groups + 1) * 8 + groups * out


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


# K1's path shapes: (label, rows, kept share, the planes' dtypes, their
# null share): hash_sample's FilterExec batch (store_sales as Spark types
# it: four int32 columns and a decimal(7,2), 10% kept by the hash),
# q69_bloom's store_sales batch after the bloom probe (~5.4% of the rows:
# the non-null customers of the three states' 28,000 of 500,000), and
# q96_mesh's per-batch compaction after the stacked K11 (isnotnull on
# three keys, each 4% null: 88.5% kept; the mask a row of the stack's
# (k, capacity) plane)
K1_SHAPES = (
    ("hash_sample's FilterExec batch: 262,144 rows x (4 int32 + 1 int64 + 5 bool), "
     "10% kept", 262144, 0.10, ("int32",) * 4 + ("int64",), 0.04),
    ("q69_bloom's store_sales batch after the bloom probe: 262,144 rows x (2 int64 + "
     "2 bool), 5.4% kept", 262144, 0.054, ("int64",) * 2, 0.04),
    ("q96_mesh's compaction after the stacked K11: 262,144 rows x (3 int64 + 3 bool), "
     "88.5% kept", 262144, 0.885, ("int64",) * 3, 0.04),
)
# K1's battery: (rows, live rows, kept share, planes' dtypes, null share):
# a tile's edges (1,024 rows), every element size, more than 32 and more
# than 128 planes (the table in device memory), none and all kept
K1_CASES = (
    (262144, 200000, 0.5, ("int64",) * 3 + ("int32",), 0.1),
    (1024, 1000, 0.0, ("int64",) * 3 + ("int32",), 0.2),
    (1024, 1024, 1.0, ("int64",) * 3 + ("int32",), 0.0),
    (1024, 300, 0.3, ("int64",) * 3 + ("int32",), 0.5),
    (1023, 1023, 0.6, ("int8", "int16", "int32", "int64"), 0.1),
    (1025, 1025, 0.6, ("int8", "int16", "int32", "int64"), 0.1),
    (2049, 2049, 0.6, ("int8", "int16", "int32", "int64"), 0.1),
    (6145, 6000, 0.97, ("float64", "float32", "bool"), 0.1),
    (4096, 4000, 0.4, ("int64", "int32", "int16", "int8") * 5, 0.1),
    (4096, 4096, 0.5, ("int32",) * 65, 0.1),
    (300, 300, 1.0, ("int64",), 0.0),
    (1, 1, 1.0, ("int64",), 0.0),
)


def k1_batch(rows, n, keep, dtypes, nulls, rng, dev):
    """K1's inputs: a data plane of each dtype and its validity plane,
    ``rows`` long, rows past ``n`` padding; the mask keeps ``keep`` of the
    live rows."""
    import numpy as np
    import torch

    datas, valids = [], []
    for dt in dtypes:
        info = np.iinfo(dt) if np.dtype(dt).kind in "iu" else None
        d = np.zeros(rows, dt)
        if info is not None:
            d[:n] = rng.integers(max(info.min, -(1 << 40)), min(info.max, 1 << 40), n)
        elif dt == "bool":
            d[:n] = rng.random(n) < 0.5
        else:
            d[:n] = np.array(SEG_FLOATS, dt)[rng.integers(0, len(SEG_FLOATS), n)]
        v = np.zeros(rows, bool)
        v[:n] = rng.random(n) >= nulls
        d[~v] = 0
        datas.append(torch.from_numpy(d).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    mask = np.zeros(rows, bool)
    mask[:n] = rng.random(n) < keep
    return datas, valids, torch.from_numpy(mask).to(dev)


def k1_bytes(datas, valids, mask):
    """Bytes K1 must move on this mask: the mask read once, each output
    plane written whole (its kept rows, then its zeroed padding), and of
    each input plane only the 32-byte sectors that hold a kept row (a
    dropped row need not be read)."""
    import torch

    kept = torch.nonzero(mask).flatten()
    read = sum(32 * torch.unique_consecutive((x.data_ptr() + kept * x.element_size()) // 32)
               .numel() for x in datas + valids)
    return mask.numel() + sum(x.numel() * x.element_size() for x in datas + valids) + read


def kernel_k1(dev, rng, results):
    """K1 against its plain version on its battery (``K1_CASES``: a tile's
    edges, every element size, float planes with NaN, +-0.0, +-inf and
    subnormals moved bit for bit, more than 32 and more than 128 planes,
    none and all kept) and with a mask that is not 16-byte aligned; timed
    at its paths' shapes (``K1_SHAPES``): CUDA events, device ms, the
    wrapper's host ms and the kernels of one call."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for rows, n, keep, dtypes, nulls in K1_CASES:
        with np.errstate(over="ignore"):
            datas, valids, mask = k1_batch(rows, n, keep, dtypes, nulls, rng, dev)
        label = f"rows={rows},n={n},keep={keep},planes={2 * len(dtypes)}"
        check_equal("compact_planes", label, K.compact_planes_cuda(datas, valids, mask),
                    K.compact_planes_plain(datas, valids, mask))
        cases.append(label)
    # a mask one byte into its allocation (not 16-byte aligned)
    datas, valids, mask = k1_batch(4097, 4097, 0.5, ("int64", "int32"), 0.1, rng, dev)
    odd = torch.zeros(4098, dtype=torch.bool, device=dev)
    odd[1:] = mask
    check_equal("compact_planes", "unaligned mask", K.compact_planes_cuda(datas, valids, odd[1:]),
                K.compact_planes_plain(datas, valids, mask))
    cases.append("rows=4097, the mask at an odd address")
    shapes = {}
    for label, rows, keep, dtypes, nulls in K1_SHAPES:
        datas, valids, mask = k1_batch(rows, rows, keep, dtypes, nulls, rng, dev)
        check_equal("compact_planes", label, K.compact_planes_cuda(datas, valids, mask),
                    K.compact_planes_plain(datas, valids, mask))
        cases.append(label)

        def k1(datas=datas, valids=valids, mask=mask):
            return K.compact_planes_cuda(datas, valids, mask)

        def lib(datas=datas, valids=valids, mask=mask):
            return [x[mask] for x in datas + valids]

        shapes[label] = dict(shape_times(k1, lambda: K.compact_planes_plain(datas, valids, mask),
                                         lib, k1_bytes(datas, valids, mask)),
                             host_ms=host_ms(k1), call_kernels=call_kernels(k1))
    main = shapes[K1_SHAPES[0][0]]
    results.append(dict(
        name="compact_planes", route="cuda", source="blaze_tpu_torch/csrc/compact.cu",
        replaces="blaze_tpu/core/kernels.py:212", shape=K1_SHAPES[0][0], cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library_device_ms=main["library_device_ms"], call_kernels=main["call_kernels"],
        library_call="x[mask] per plane", bytes=main["bytes"], shapes=shapes))


# K2's battery: (rows, plane kinds, null share, element offset of every
# plane (a view that far into its allocation), partition counts); kinds
# as MESH_NP names them, each hashed at its own width
K2_CASES = (
    (262144, ("i64",), 0.0, 0, (4, 7)),
    (1024, ("i32",), 0.3, 0, (4, 7)),
    (1000, ("i64", "i32"), 0.2, 0, (4, 7)),
    (400, ("i64",), 0.0, 0, (4, 7)),
    (4099, ("bool", "i8", "i16"), 0.2, 0, (1, 4, 7, 200)),
    (4099, ("i8", "i16", "i32", "i64", "bool"), 0.1, 1, (1, 4, 7, 200)),
    (5, ("i16", "i64"), 0.0, 3, (4, 200)),
    (1023, ("i64",) * 9, 0.1, 0, (4, 7)),
    (255, ("i8", "i16", "i32", "i64") * 8, 0.1, 1, (7, 200)),
)
# Spark's golden vectors (the JAX package's tests/test_spark_hash.py):
# hashLong and hashInt with seed 42; a byte hashes as hashInt of its value,
# and so does a short
K2_GOLDEN = ((("i64",), [1, 0, -1, 2**63 - 1, -(2**63)],
              [0x99F0149D, 0x9C67B85D, 0xC8008529, 0xA05B5D7B, 0xCD1E64FB]),
             (("i32",), [1, 2, 3, 4], [-559580957, 1765031574, -1823081949, -397064898]),
             (("i8",), [1, 0, -1, 127, -128],
              [0xDEA578E3, 0x379FAE8F, 0xA0590E3D, 0x43B4D8ED, 0x422A1365]),
             (("i16",), [1, 0, -1, 127, -128],
              [0xDEA578E3, 0x379FAE8F, 0xA0590E3D, 0x43B4D8ED, 0x422A1365]))


def k2_case(case, rng, dev):
    """One K2_CASES entry as the kernel takes it: (hash words at their own
    width, validities, hash kinds, rows, partition counts); null rows carry
    data 0."""
    import numpy as np
    import torch

    n, kinds, nulls, off, parts = case
    words, valids = [], []
    for kind in kinds:
        w = np.zeros(n + off, MESH_NP[kind])
        v = np.zeros(n + off, bool)
        v[off:] = rng.random(n) >= nulls
        w[off:] = np.where(v[off:], mesh_values(kind, n, rng), 0)
        words.append(torch.from_numpy(w).to(dev)[off:])
        valids.append(torch.from_numpy(v).to(dev)[off:])
    return words, valids, ["i64" if k == "i64" else "i32" for k in kinds], n, parts


def k2_shapes(rng, dev):
    """K2's timed shapes, as the exchanges give them: (label, words,
    validities, kinds, rows, nparts, bytes). cust_spend's batch: the
    passthrough's 262,144 rows of ss_customer_sk (int32, as the port types
    it; 1% null) into 16 reducers; q67's: the (item, store) groups of one
    262,144-row partial batch (q67_batch's draw: its distinct pairs, two
    int64 keys) into 4; q01's: ~400 store keys (int64) into 4. Bytes: each
    key plane and validity read once, the pids written once."""
    import numpy as np
    import torch

    out = []
    n = 262144
    key = rng.integers(1, CUST_SKS + 1, n).astype(np.int32)
    kv = rng.random(n) >= 0.01
    out.append(("cust_spend's exchange batch", [np.where(kv, key, 0).astype(np.int32)], [kv],
                CS_REDUCERS))
    item, store = rng.integers(1, N_ITEMS, n), rng.integers(1, N_STORES, n)
    pairs = rng.permutation(np.unique(item * N_STORES + store))
    out.append(("q67's exchange batch", [pairs // N_STORES, pairs % N_STORES],
                [np.ones(len(pairs), bool)] * 2, PARTS))
    out.append(("q01's 400 keys", [rng.integers(1, N_STORES, 400)], [np.ones(400, bool)],
                PARTS))
    shapes = []
    for label, ws, vs, nparts in out:
        rows = len(ws[0])
        words = [torch.from_numpy(w).to(dev) for w in ws]
        valids = [torch.from_numpy(v).to(dev) for v in vs]
        kinds = ["i64" if w.dtype == np.int64 else "i32" for w in ws]
        nbytes = rows * (sum(w.itemsize + 1 for w in ws) + 4)
        shapes.append((f"{label}: {rows:,} rows x {'+'.join(str(w.dtype) for w in ws)} "
                       f"into {nparts}", words, valids, kinds, rows, nparts, nbytes))
    return shapes


def kernel_k2(dev, rng, results):
    """K2 against its twin on K2_CASES (every element size, nulls, planes
    at odd element offsets, 1 to 32 columns, tails of 1 to 3 rows) with
    and without the hash output, on Spark's golden vectors, then timed at
    k2_shapes with device ms and the wrapper's host ms."""
    import numpy as np
    import torch
    from blaze_tpu_torch.exprs import spark_hash as H

    cases = []
    for case in K2_CASES:
        words, valids, kinds, n, parts = k2_case(case, rng, dev)
        for nparts in parts:
            want = H.murmur3_pmod_plain(words, valids, kinds, n, nparts)
            label = f"n={n} kinds={'+'.join(case[1])} offset={case[3]} parts={nparts}"
            check_equal("murmur3_pmod", label, H.murmur3_pmod_cuda(words, valids, kinds, n,
                                                                   nparts), want)
            check_equal("murmur3_pmod", label + " (pids only)",
                        H.murmur3_pmod_cuda(words, valids, kinds, n, nparts, False)[1],
                        want[1])
        cases.append(f"n={n},kinds={'+'.join(case[1])},nulls={case[2]},offset={case[3]}")
    for kinds, vals, expect in K2_GOLDEN:
        w = torch.tensor(vals, dtype=getattr(torch, MESH_NP[kinds[0]]), device=dev)
        v = torch.ones(len(vals), dtype=torch.bool, device=dev)
        h, _ = H.murmur3_pmod_cuda([w], [v], ["i64" if kinds[0] == "i64" else "i32"],
                                   len(vals), 4)
        want = np.array(expect, dtype=np.int64).astype(np.uint32).view(np.int32).tolist()
        if h.tolist() != want:
            raise AssertionError(f"murmur3 {kinds[0]} golden: {h.tolist()} != {want}")
        cases.append(f"golden {kinds[0]}")
    # the host ms first, before this phase's profiler sessions (a process
    # that has run torch.profiler launches slower from then on)
    shapes, fns = {}, {}
    for label, words, valids, kinds, n, nparts, nbytes in k2_shapes(rng, dev):
        check_equal("murmur3_pmod", label, H.murmur3_pmod_cuda(words, valids, kinds, n, nparts,
                                                               False)[1],
                    H.murmur3_pmod_plain(words, valids, kinds, n, nparts)[1])

        def k2(words=words, valids=valids, kinds=kinds, n=n, nparts=nparts):
            return H.murmur3_pmod_cuda(words, valids, kinds, n, nparts, False)

        def plain(words=words, valids=valids, kinds=kinds, n=n, nparts=nparts):
            return H.murmur3_pmod_plain(words, valids, kinds, n, nparts)

        fns[label] = (k2, plain, nbytes)
        shapes[label] = dict(host_ms=host_ms(k2), rows=n)
    for label, (k2, plain, nbytes) in fns.items():
        shapes[label].update(shape_times(k2, plain, None, nbytes), call_kernels=call_kernels(k2))
        log(json.dumps({"phase": "k2_shape", "shape": label, **shapes[label]}))
    label = next(iter(shapes))
    main = shapes[label]
    results.append(dict(
        name="murmur3_pmod", route="cuda", source="blaze_tpu_torch/csrc/murmur3.cu",
        replaces="blaze_tpu/exprs/spark_hash.py:429", shape=label, cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=None, library_call=None,
        call_kernels=main["call_kernels"], bytes=main["bytes"], shapes=shapes))


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
    cases3, cases4 = [k3_plan_growth_check(dev)], []
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
    # both sides of the shared-memory switch, with the LEX pairs: one block
    # (2,000 rows) and many (262,144), then K4 over the outputs
    from blaze_tpu_torch.utils import cuda_lib
    for side in ("below", "above"):
        for rows in (2000, 262144):
            label = slot_switch_check(side, rows, rng, dev, check_equal, cuda_lib.library())
            cases3.append(label)
            cases4.append(label)

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
    k3 = lambda: A.slot_agg_partial(keys, kvalids, kd, cap, bases, sizes, specs, args,  # noqa: E731
                                    out_cap)
    results.append(dict(
        name="slot_agg_partial", route="cuda", source="blaze_tpu_torch/csrc/slot_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1255", shape=f"262144 rows -> {S} slots",
        cases=cases3, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="2x index_add_ into the slot tables (slot ids given)",
        bytes=nbytes, device_ms=kernel_device_ms(k3, OURS),
        library_device_ms=kernel_device_ms(lib3, ""),
        shapes=k3_few_group_shapes(dev, rng, conf)))

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
        bytes=nbytes,
        device_ms=kernel_device_ms(lambda: A.slot_agg_merge(keys4, kv4, kd, n4, bases4, sizes4,
                                                            kinds, states, out4), OURS),
        library_device_ms=kernel_device_ms(lib4, "")))


def k3_plan_growth_check(dev):
    """K3 at the shape of ROADMAP.md Queue 3's fixed fault (a slot plan
    kept past its output capacity): one partial aggregate, SUM and COUNT
    by an int64 key, over a 100-row batch of keys spread over 0..999 (a
    radix plan of 1,024 slots, sized for 256 output rows) and then a
    1,024-row batch of keys ``arange(1024) % 1000`` (1,000 groups under
    that plan). Every K3 output plane gets 64 guard rows past its out_cap,
    filled with 0x5A; the guards must come back untouched and the second
    batch must give the numpy oracle's 1,000 groups. Returns a case label."""
    import numpy as np
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core.batch import ColumnarBatch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import agg_device as A
    from blaze_tpu_torch.runtime.executor import build_operator

    schema = T.Schema.of(("k", T.I64), ("v", T.I64))
    node = N.Agg(N.FFIReader(schema, "src", 1), E.AggExecMode.HASH_AGG, [("k", E.Column("k"))],
                 [N.AggColumn(E.AggExpr(E.AggFunction.SUM, [E.Column("v")]),
                              E.AggMode.PARTIAL, "s"),
                  N.AggColumn(E.AggExpr(E.AggFunction.COUNT, []), E.AggMode.PARTIAL, "c")])
    op = build_operator(node)
    agger = A.DevicePartialAgger(op, op.children[0].schema, Config(batch_size=1024))
    guards, real = [], A._planes

    def guarded(dev_, n, dtypes):
        views = []
        for d in dtypes:
            buf = torch.full(((n + 64) * d.itemsize,), 0x5A, dtype=torch.uint8, device=dev_)
            guards.append((buf, n * d.itemsize))
            views.append(buf[:n * d.itemsize].view(d))
        return views

    rng = np.random.default_rng(21)
    batches = [np.linspace(0, 999, 100).astype(np.int64), np.arange(1024) % 1000]
    A._planes = guarded
    try:
        outs = []
        for keys in batches:
            v = rng.integers(-1000, 1000, len(keys))
            batch = ColumnarBatch.from_numpy(schema, {"k": keys, "v": v}, dev)
            outs.append((keys, v, agger.process(batch).to_pydict()))
        torch.cuda.synchronize()
    finally:
        A._planes = real
    plan = agger._bucket_state
    if plan is None or plan[0] != "radix" or plan[3] != 256 or not guards:
        raise AssertionError(f"K3 plan growth: plan {plan}, {len(guards)} planes")
    for buf, at in guards:
        if not bool((buf[at:] == 0x5A).all()):
            raise AssertionError("K3 wrote past its out_cap-row planes")
    keys, v, got = outs[1]
    uniq, inv = np.unique(keys, return_inverse=True)
    want = dict(zip(uniq.tolist(), zip(np.bincount(inv, weights=v).astype(np.int64).tolist(),
                                       np.bincount(inv).tolist())))
    if dict(zip(got["k"], zip(got["s#sum"], got["c#count"]))) != want or len(want) != 1000:
        raise AssertionError(f"K3 plan growth: {len(got['k'])} groups, not the oracle's 1000")
    return "plan kept from a 100-row batch (out_cap 256) for 1,024 rows of 1,000 groups, " \
        f"{len(guards)} planes' guard rows untouched"


def slot_switch_sizes(nops, lib):
    """(the largest slot count whose tables the shared-memory design of K3
    takes at 262,144 rows for ``nops`` ops, the next power of two), read
    from the library's scratch rule (that design's scratch has no
    compaction offsets)."""
    S = 2
    while lib.blz_slot_agg_scratch(2 * S, nops, 262144, 0) == nops * 2 * S + (2 * S + 7) // 8 + 1:
        S *= 2
    return S, 2 * S


def slot_switch_check(side, rows, rng, dev, check, lib):
    """K3 with the LEX pairs (minw, maxw) and every limb sum (WIDE_SPECS)
    at the slot count just below or just above the shared-memory switch,
    over ``rows`` rows (one block up to 65,536 row-ops, 3,120 rows of its
    21 ops; many above), then K4 over its outputs twice, each against its
    plain version through ``check(name, label, got, want)``."""
    import numpy as np
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    cap = 1 << (rows - 1).bit_length()
    keys, kvalids, specs, args = wide_torch(wide_case(
        ("switch", ("i64",), cap, rows, 0.02, 0.1, (0, 2), "mixed"), rng), dev)
    below, above = slot_switch_sizes(len(A._partial_program(specs, args)[0]), lib)
    S = below if side == "below" else above
    key = rng.integers(0, S - 1, cap)
    key[:2] = (0, S - 2)  # the plan spans S slots
    keys[0] = torch.from_numpy(np.where(np.arange(cap) < rows, key, 0)).to(dev)
    kvalids[0][:2] = True
    kd = [torch.int64]
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                              conf.radix_agg_max_slots, conf)
    if sizes != (S,):
        raise AssertionError(f"slot plan {sizes}, not ({S},)")
    label = f"S={S} ({side} the switch), {rows} rows"
    want = A.slot_agg_partial_plain(keys, kvalids, kd, rows, bases, sizes, specs, args, out_cap)
    check("slot_agg_partial:limbs", label,
          A.slot_agg_partial(keys, kvalids, kd, rows, bases, sizes, specs, args, out_cap), want)
    g = int(want[0])
    kinds = tuple(sp[0] for sp in specs)
    cap2 = conf.capacity_for(2 * g)
    cat = doubled(want, g, cap2, dev)
    live = torch.arange(cap2, device=dev) < 2 * g
    mk, mv = [cat[0]], [cat[1] & live]
    states = wide_states([None, None] + cat, 1, kinds, live, rng)
    b2, s2, o2 = A.plan_slot_table(A.probe_ranges(mk, mv), cap2, None,
                                   conf.radix_agg_max_slots, conf)
    check("slot_agg_merge:limbs", label,
          A.slot_agg_merge(mk, mv, kd, 2 * g, b2, s2, kinds, states, o2),
          A.slot_agg_merge_plain(mk, mv, kd, 2 * g, b2, s2, kinds, states, o2))
    return label


def q06_slot_batch(rng, dev, groups, cap=262144):
    """K3's input on q06's path: a probe batch of 262,144 sales rows, every
    row live in K18's mask (each has its item), i_category_id over
    ``groups`` values (q06: 10), SUM(ss_quantity) and SUM(ss_sales_price)
    as int64 states."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    ones = t(np.ones(cap, bool))
    keys = [t(rng.integers(0, groups, cap))]
    args = [(t(rng.integers(1, 100, cap)), ones), (t(rng.integers(0, 500_00, cap)), ones)]
    return keys, [ones], [("sum", 0, "int64"), ("sum", 0, "int64")], args, ones


def k3_few_group_shapes(dev, rng, conf):
    """K3 where few slots take every row: q06's batch (10 category groups,
    over K18's live mask) and one group; each held to its plain version and
    timed beside its index_add_ chain."""
    import torch
    from blaze_tpu_torch.ops import agg_device as A

    shapes = {}
    for label, groups in (("q06 batch: 262144 rows -> 10 groups, K18's live mask", 10),
                          ("262144 rows -> 1 group", 1)):
        keys, kvalids, specs, args, live = q06_slot_batch(rng, dev, groups)
        cap = keys[0].shape[0]
        bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                                  conf.dense_agg_max_buckets, conf)
        kd = [torch.int64]

        def k3():
            return A.slot_agg_partial(keys, kvalids, kd, cap, bases, sizes, specs, args,
                                      out_cap, exists=live)

        check_equal("slot_agg_partial", label, k3(),
                    A.slot_agg_partial_plain(keys, kvalids, kd, cap, bases, sizes, specs,
                                             args, out_cap, exists=live))
        seg = keys[0] - bases[0] + 1
        tabs = torch.zeros((3, sizes[0]), dtype=torch.int64, device=dev)
        ones = torch.ones(cap, dtype=torch.int64, device=dev)
        srcs = [args[0][0], args[1][0], ones]

        def lib():
            for t, x in zip(tabs, srcs):
                t.index_add_(0, seg, x)

        shapes[label] = shape_times(
            k3, lambda: A.slot_agg_partial_plain(keys, kvalids, kd, cap, bases, sizes, specs,
                                                 args, out_cap, exists=live),
            lib, cap * (8 + 1 + 1 + 2 * 9) + out_cap * (8 + 1 + 2 * 9))
        shapes[label]["library_call"] = "3x index_add_ into the slot tables (slot ids given)"
    return shapes


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


# the device time of K5's and K7's calls: their kernels, memsets and the
# copies their wrappers issue (a pageable table upload counts)
OURS_COPIES = ("blz_", "Memset", "Memcpy")


def chain_times(fn, plain, lib, nbytes, prefix=OURS_COPIES):
    """:func:`shape_times` with the plain version's device ms beside its
    events (every kernel and copy of its chain)."""
    out = shape_times(fn, plain, lib, nbytes, prefix)
    out["plain_device_ms"] = kernel_device_ms(plain, "")
    return out


def q67_sort_batch_keys(rng, dev, cap=262144):
    """A q67_sort partial batch's K5 input: the key pass of its (item,
    store) keys, as ``segment_ids`` sorts them (262,144 rows, every row
    live)."""
    import torch
    from blaze_tpu_torch.core import kernels as K

    keys, kvalids, _specs, _args = q67_batch(rng, dev, cap)
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    return K.sort_key_operands(keys, kvalids, exists, [(True, True)] * 2), cap


def bucketize_pids(rng, dev, rows, nparts):
    """A map batch's partition ids (int32, ``rows`` rows, uniform over
    ``nparts``: sort10M's range ids, cust_spend's hash ids)."""
    import torch

    return torch.from_numpy(rng.integers(0, nparts, rows).astype("int32")).to(dev)


def dead_rows_case(rng, dev, cap, n, live_share, keys=2):
    """Key-pass operands of ``n`` rows of ``cap`` where only ``live_share``
    of the rows below n exist (a fused aggregate's dead rows: rank 6)."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    datas = [torch.from_numpy(rng.integers(-50, 50, cap)).to(dev) for _ in range(keys)]
    valids = [torch.from_numpy(rng.random(cap) >= 0.1).to(dev) for _ in range(keys)]
    ex = np.zeros(cap, bool)
    ex[:n] = rng.random(n) < live_share
    return K.sort_key_operands(datas, valids, torch.from_numpy(ex).to(dev),
                               [(True, True)] * keys)


def k5_phases(ops, rows, dev, calls=5):
    """Where one K5 launch's device time goes: csrc/sort.cu's phase stamps
    (``blz_rs_stamp``), microseconds from the launch's start, median of
    ``calls`` launches, for block 0 ("b0_<i>") and the last block
    ("last_<i>"); empty where the kernel writes none."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    trace = torch.zeros(64, dtype=torch.int64, device=dev)
    stamps = []
    for _ in range(calls):
        trace.zero_()
        K.lexsort_indices_cuda(ops, rows, dead_last=True, trace=trace)
        torch.cuda.synchronize()
        stamps.append(trace.cpu().numpy().astype(np.float64))
    st = np.median(np.array(stamps), axis=0)
    return {f"{'b0' if i < 32 else 'last'}_{i % 32}": (st[i] - st[0]) / 1e3
            for i in range(64) if st[i] > 0 and st[0] > 0}


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
            for dead_last in (False, True):
                check_equal("lexsort_indices", f"{label},num_rows={rows},dead_last={dead_last}",
                            K.lexsort_indices_cuda(want, rows, dead_last=dead_last),
                            K.lexsort_indices_plain(want, rows, dead_last=dead_last))
        cases.append(label)
    # the exchange's pid sort (one int32 operand: one byte, two, or every
    # byte; the histogram is the counts), a raw f64 operand with signed
    # zeros and infinities (the sort's own word mapping; the key pass never
    # hands it a NaN), and dead rows (rank 6) among live ones: a quarter,
    # none live, one live
    for rows, nparts in ((229_000, PARTS), (262_144, 32), (1000, 1), (5000, 300),
                         (70_000, 70_000), (1, 4)):
        pids = bucketize_pids(rng, dev, rows, nparts)
        order, counts = K.partition_order(pids, nparts)
        want_order, want_counts = K.partition_order(pids.cpu(), nparts)
        check_equal("lexsort_indices", f"pids n={rows} partitions={nparts}",
                    (order, counts), (want_order.to(dev), want_counts.to(dev)))
        check_equal("lexsort_indices", f"pids n={rows} all bytes",
                    K.lexsort_indices_cuda([pids]), want_order.to(dev))
        cases.append(f"pids int32 n={rows} partitions={nparts} (counts from the histogram)")
    raw, _ = key_plane("f64", 4096, 4096, rng, 0.0, dev)
    raw = torch.nan_to_num(raw, nan=0.0, posinf=float("inf"), neginf=float("-inf"))
    check_equal("lexsort_indices", "raw f64", K.lexsort_indices_cuda([raw]),
                K.lexsort_indices_plain([raw]))
    for cap, n, share in ((262144, 262144, 0.25), (4096, 3000, 0.0), (4096, 3000, 0.0004),
                          (256, 200, 0.9)):
        ops = dead_rows_case(rng, dev, cap, n, share)
        for rows in (n, None):
            check_equal("lexsort_indices", f"dead rows cap={cap} n={n} live={share}",
                        K.lexsort_indices_cuda(ops, rows, dead_last=True),
                        K.lexsort_indices_plain(ops, rows, dead_last=True))
        cases.append(f"dead rows (rank 6) cap={cap},n={n},live share={share}")
    cases.append("raw f64 +-0.0 +-inf n=4096")

    def chained_sort(ops, n):
        def run():
            idx = torch.arange(n, device=dev)
            for op in reversed(ops):
                key = op[idx]
                idx = idx[torch.sort(key.to(torch.int16) if key.dtype == torch.uint8 else key,
                                     stable=True).indices]
            return idx
        return run

    # the key pass: the q67 full sort (PR 3's shape) and a q67_sort batch
    datas, valids, exists, n = q67_sort_keys(rng, dev)
    spec = ((True, True), (False, True))
    cap = exists.shape[0]
    ops = K.sort_key_operands_cuda(datas, valids, exists, spec)
    keys, kvalids, _s, _a = q67_batch(rng, dev)
    ones = torch.ones(262144, dtype=torch.bool, device=dev)
    batch = chain_times(lambda: K.sort_key_operands_cuda(keys, kvalids, ones, [(True, True)] * 2),
                        lambda: K.sort_key_operands_plain(keys, kvalids, ones, [(True, True)] * 2),
                        None, 262144 * (2 * (8 + 1) + 2 * (1 + 8)) + 262144)
    full = chain_times(lambda: K.sort_key_operands_cuda(datas, valids, exists, spec),
                       lambda: K.sort_key_operands_plain(datas, valids, exists, spec), None,
                       cap * (1 + 2 * (8 + 1) + 2 * (1 + 8)))
    results.append(dict(
        name="sort_key_operands", route="cuda", source="blaze_tpu_torch/csrc/sort.cu",
        replaces="blaze_tpu/core/kernels.py:293", shape=f"{cap} rows x 2 int64 keys",
        cases=cases, library_call=None, **full,
        shapes={"q67_sort batch: 262144 rows x 2 int64 keys": batch}))
    # the sort: a q67_sort batch's key sort (segment_ids: rank first, dead
    # rows last), the bucketize pid sorts of sort10M (32 partitions) and
    # cust_spend (16) with their histogram, and the q67 full sort
    bops, bn = q67_sort_batch_keys(rng, dev)
    shapes = {}
    for label, rows, nparts in (("sort10M bucketize pids: 262144 rows into 32", 262144, 32),
                                ("cust_spend bucketize pids: 262144 rows into 16", 262144, 16)):
        pids = bucketize_pids(rng, dev, rows, nparts)
        shapes[label] = chain_times(
            lambda: K.partition_order(pids, nparts),
            lambda: (K.lexsort_indices_plain([pids], None, [K.pid_width(nparts)]),
                     torch.bincount(pids.to(torch.int64), minlength=nparts)),
            lambda: torch.sort(pids, stable=True), rows * (4 + 8) + nparts * 8)
        shapes[label]["library_call"] = "torch.sort(stable=True)"
    shapes[f"q67 full sort: {n} of {cap} rows, 4 operands"] = chain_times(
        lambda: K.lexsort_indices_cuda(ops, n, dead_last=True),
        lambda: K.lexsort_indices_plain(ops, n, dead_last=True), chained_sort(ops, n),
        n * (1 + 8 + 1 + 8) + cap * 8)
    main = chain_times(lambda: K.lexsort_indices_cuda(bops, bn, dead_last=True),
                       lambda: K.lexsort_indices_plain(bops, bn, dead_last=True),
                       chained_sort(bops, bn), bn * (1 + 8 + 1 + 8) + bn * 8)
    passes = K.radix_passes(_and_or(bops, bn), [op.element_size() for op in bops])
    main["phases_us"] = k5_phases(bops, bn, dev)
    results.append(dict(
        name="lexsort_indices", route="cuda", source="blaze_tpu_torch/csrc/sort.cu",
        replaces="blaze_tpu/ops/sort.py:46", shape=f"q67_sort batch: {bn} rows, 4 operands, "
        f"{len(passes)} digit passes", cases=cases, library_call="torch.sort(stable=True) "
        "chained per operand", digit_passes=len(passes), shapes=shapes, **main))


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


def mixed_planes(rng, caps, n_live, dev, dtypes=("int64", "int32", "bool", "float64")):
    """A (data, validity) plane of each dtype, its capacity from ``caps``
    (cycled), ``n_live`` rows drawn (20% null, data 0 there)."""
    import numpy as np
    import torch

    datas, valids = [], []
    for i, dt in enumerate(dtypes):
        cap = caps[i % len(caps)]
        d = np.zeros(cap, dt)
        v = np.zeros(cap, bool)
        m = min(n_live, cap)
        if dt == "bool":
            d[:m] = rng.random(m) < 0.5
        elif dt.startswith("float"):
            with np.errstate(over="ignore"):
                d[:m] = np.array(SEG_FLOATS, dt)[rng.integers(0, len(SEG_FLOATS), m)]
        else:
            lim = 100 if dt == "int8" else 1000
            d[:m] = rng.integers(-lim, lim, m)
        v[:m] = rng.random(m) >= 0.2
        d[~v] = 0
        datas.append(torch.from_numpy(d).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    return datas, valids


# K6's battery: (label, source capacities (cycled over the planes), live
# source rows, plane dtypes, out_cap, n_out, masked, an index not 16-byte
# aligned): the old mixed-capacity cases, every element size in one call,
# 33 planes (two launches), no row, out_cap past n_out with mixed source
# capacities, an out_cap that is not a multiple of a thread's four rows
MIX4 = ("int64", "int32", "bool", "float64")
ALL_SIZES = ("int8", "int16", "int32", "float32", "int64", "float64", "bool")
GATHER_CASES = (
    ("mixed caps, a part", (4096, 4096, 1024, 4096), 3000, MIX4, 256, 200, False, False),
    ("mixed caps, whole", (4096, 4096, 1024, 4096), 3000, MIX4, 4096, 4096, False, False),
    ("no row", (4096, 4096, 1024, 4096), 3000, MIX4, 256, 0, False, False),
    ("masked", (4096, 4096, 1024, 4096), 3000, MIX4, 1024, 700, True, False),
    ("masked, whole", (4096, 4096, 1024, 4096), 3000, MIX4, 256, 256, True, False),
    ("every element size", (4096, 2048, 1000), 3000, ALL_SIZES, 8192, 5000, False, False),
    ("every element size, masked", (4096, 2048), 3000, ALL_SIZES, 4096, 3001, True, True),
    ("33 planes", (2048, 1024), 2000, ("int64", "bool", "int32") * 11, 4096, 2500, False,
     False),
    ("33 planes, no row", (2048,), 2000, ("int16", "bool", "int64") * 11, 1024, 0, False,
     False),
    ("out_cap past n_out", (300, 70000, 5000), 4000, ALL_SIZES, 65536, 9001, False, True),
    ("out_cap not a multiple of 4", (500,), 500, MIX4, 1023, 1021, False, True),
    ("n_out = out_cap, odd", (700,), 700, ALL_SIZES, 333, 333, True, False),
)


def gather_case(case, rng, dev):
    """(datas, valids, idx, out_cap, n_out, live) of a GATHER_CASES entry;
    the indices cover each source's live rows and run past some planes'
    capacities (the kernel clips them)."""
    import torch

    _label, caps, n_live, dtypes, out_cap, n_out, masked, unaligned = case
    datas, valids = mixed_planes(rng, caps, n_live, dev, dtypes)
    idx = torch.from_numpy(rng.integers(0, n_live, n_out + 1)).to(dev)
    idx = idx[1:] if unaligned else idx[:n_out]
    live = torch.from_numpy(rng.random(n_out) < 0.7).to(dev) if masked else None
    return datas, valids, idx, out_cap, n_out, live


def gather_bytes(datas, valids, n_out, out_cap):
    """K6 moves at least: the index and each distinct plane's gathered
    rows read once, its output written over out_cap."""
    row = sum(p.element_size() for p in {id(p): p for p in [*datas, *valids]}.values())
    return n_out * (8 + row) + out_cap * row


def k6_shapes(dev, rng):
    """K6 at the main path's takes: (label, datas, valids, idx, out_cap,
    n_out). The q67 full sort's take of 797,601 of 1,048,576 rows (3 int64
    and 3 bool planes); a sort10M reducer's sort take (~312,500 of its
    524,288 rows; 5 columns: 7 int64 planes with the wide cost's limbs,
    and 7 bool planes, the limbs' three one plane); the sort route's take of each group's keys by its first row
    (a q67_sort batch, 262,144 rows, 2 int64 and 2 bool key planes)."""
    import torch
    from blaze_tpu_torch.core import kernels as K

    out = []
    cap, n = 1 << 20, Q67_GROUPS
    datas, valids = planes(n, cap, 3, rng, dev)
    out.append(("q67 sort take", datas, valids, torch.randperm(n, device=dev), cap, n))
    cap, n = 1 << 19, SORT10M_ROWS // SORT10M_PARTS
    datas, valids = planes(n, cap, 7, rng, dev)
    valids[5:] = [valids[4]] * 2  # the wide cost's three limbs share its validity
    out.append(("sort10M reducer's sort take", datas, valids, torch.randperm(n, device=dev),
                cap, n))
    keys, kvalids, _specs, _args = q67_batch(rng, dev)
    cap = n = keys[0].shape[0]
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    order = K.lexsort_indices(K.sort_key_operands(keys, kvalids, exists, [(True, True)] * 2),
                              n)
    starts, count = K.segment_starts_plain(keys, kvalids, order, n)
    g = int(count)
    out.append(("q67_sort batch's key take", keys, kvalids, order[starts[:g]], cap, g))
    return out


def kernel_k6(dev, rng, results):
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for case in GATHER_CASES:
        args = gather_case(case, rng, dev)
        check_equal("gather_planes", case[0], K.gather_planes_cuda(*args),
                    K.gather_planes_plain(*args))
        cases.append(case[0])
    shapes = {}
    for label, datas, valids, idx, cap, n in k6_shapes(dev, rng):
        check_equal("gather_planes", label, K.gather_planes_cuda(datas, valids, idx, cap, n),
                    K.gather_planes_plain(datas, valids, idx, cap, n))
        cases.append(f"{label}: {n} of {cap} rows x {len(datas) + len(valids)} planes")

        def k6(datas=datas, valids=valids, idx=idx, cap=cap, n=n):
            return K.gather_planes_cuda(datas, valids, idx, cap, n)

        def lib(datas=datas, valids=valids, idx=idx):
            return [torch.index_select(x, 0, idx) for x in datas + valids]

        shapes[label] = dict(
            shape_times(k6, lambda: K.gather_planes_plain(datas, valids, idx, cap, n), lib,
                        gather_bytes(datas, valids, n, cap)),
            host_ms=host_ms(k6), library_host_ms=host_ms(lib), rows=n, out_cap=cap,
            planes=len(datas) + len(valids))
    main = shapes.pop("q67 sort take")
    results.append(dict(
        name="gather_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:181",
        shape=f"{main['rows']} of {main['out_cap']} rows x 6 planes (the q67 sort's take)",
        cases=cases, ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library_device_ms=main["library_device_ms"], library_host_ms=main["library_host_ms"],
        library_call="torch.index_select per plane", bytes=main["bytes"], shapes=shapes))


# K7's split form: (rows, partitions, planes: int64 data / bool validity
# pairs, source capacity of every other plane), the bucketize shapes and
# the edges: an empty partition, every row in one, past 64 (the staged
# table) and past 256 partitions, uneven source capacities, past 32
# planes (two launches)
SPLIT_CASES = (
    (3000, 4, 4, 4096), (3000, 5, 3, 3000), (1, 3, 2, 256), (4096, 1, 2, 4096),
    (5000, 300, 3, 8192), (2000, 100, 2, 2048), (262_144, 32, 7, 262_144),
    (262_144, 16, 3, 262_144), (1500, 8, 18, 1536),
)


def split_case(rows, nparts, nplanes, cap, rng, dev, empty=True):
    """A bucketize split's input: ``nplanes`` int64 data planes and their
    bool validity planes (every other pair of capacity ``cap``, the rest
    of ``rows``), ids over ``nparts`` with partition 1 empty where there
    are three or more, and the order and counts of K5's pid sort."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    datas, valids = [], []
    for j in range(nplanes):
        c = cap if j % 2 == 0 else max(rows, 1)
        d = np.zeros(c, np.int64)
        v = np.zeros(c, bool)
        d[:rows] = rng.integers(-(1 << 40), 1 << 40, rows)
        v[:rows] = rng.random(rows) >= 0.1
        d[~v] = 0
        datas.append(torch.from_numpy(d).to(dev))
        valids.append(torch.from_numpy(v).to(dev))
    pids = rng.integers(0, nparts, rows).astype(np.int32)
    if empty and nparts >= 3:
        pids[pids == 1] = 0
    order, counts = K.partition_order(torch.from_numpy(pids).to(dev), nparts)
    counts = counts.tolist()
    caps = [max(256, 1 << max(c - 1, 0).bit_length()) for c in counts]
    return datas, valids, order, counts, caps


def split_bytes(datas, valids, counts, caps):
    """K7's split moves at least: each plane's live rows read once and
    every output row written once, and the order read once."""
    n = sum(counts)
    out_rows = sum(c for c, k in zip(caps, counts) if k)
    return n * 8 + sum((n + out_rows) * t.element_size() for t in list(datas) + list(valids))


def kernel_k7(dev, rng, results):
    import torch
    import torch.nn.functional as Fn
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for cap, num_rows, offset, length, out_cap in (
            (4096, 3000, 0, 256, 256), (4096, 3000, 2900, 256, 256),
            (4096, 3000, 3000, 256, 256), (4096, 3000, 5000, 256, 256),
            (256, 256, 10, 200, 256), (4096, 3000, 3, 1000, 1000), (4096, 3000, 1, 5, 7)):
        datas, valids = mixed_planes(rng, (cap,) * 4, num_rows, dev)
        length = max(0, min(length, num_rows - offset))
        check_equal("slice_planes", f"offset={offset} length={length} out_cap={out_cap}",
                    K.slice_planes_cuda(datas, valids, offset, length, out_cap),
                    K.slice_planes_plain(datas, valids, offset, length, out_cap))
        cases.append(f"cap={cap},offset={offset},length={length},out_cap={out_cap}")
    ccases = []
    for k in range(1, 12):
        caps = ([256, 1024, 256, 512, 256] * 3)[:k]
        rows = ([200, 0, 256, 37, 0] * 3)[:k]
        per = [mixed_planes(rng, (c,) * 4, n, dev) for c, n in zip(caps, rows)]
        pd = [[b[0][f] for b in per] for f in range(4)]
        pv = [[b[1][f] for b in per] for f in range(4)]
        out_cap = max(256, 1 << (sum(rows) - 1).bit_length())
        check_equal("concat_planes", f"k={k}",
                    K.concat_planes_cuda(pd, pv, rows, out_cap),
                    K.concat_planes_plain(pd, pv, rows, out_cap))
        ccases.append(f"k={k},rows={rows}" + (" (staged table)" if k > 8 else ""))
    scases = []
    for rows, nparts, nplanes, cap in SPLIT_CASES:
        datas, valids, order, counts, caps = split_case(rows, nparts, nplanes, cap, rng, dev)
        check_equal("split_planes", f"rows={rows} partitions={nparts} planes={2 * nplanes}",
                    [x for x in K.split_planes_cuda(datas, valids, order, counts, caps) if x],
                    [x for x in K.split_planes_plain(datas, valids, order, counts, caps) if x])
        scases.append(f"rows={rows},partitions={nparts},planes={2 * nplanes},"
                      f"caps={cap}/{rows},empty={counts.count(0)}")
    # every row in one partition
    datas, valids, _o, _c, _p = split_case(3000, 1, 2, 4096, rng, dev)
    one = torch.zeros(3000, dtype=torch.int32, device=dev)
    order, counts = K.partition_order(one, 5)
    counts = counts.tolist()
    caps = [max(256, 1 << max(c - 1, 0).bit_length()) for c in counts]
    check_equal("split_planes", "every row in partition 0 of 5",
                [x for x in K.split_planes_cuda(datas, valids, order, counts, caps) if x],
                [x for x in K.split_planes_plain(datas, valids, order, counts, caps) if x])
    scases.append("rows=3000,partitions=5,every row in one")
    # main path: the full sort's 262144-row output slices of the sorted
    # 1,048,576-row batch, and its concat of the four reducers' outputs
    cap, n, bs = 1 << 20, Q67_GROUPS, 262144
    datas, valids = planes(n, cap, 3, rng, dev)
    off = 3 * bs
    length = n - off
    check_equal("slice_planes", "q67 last slice", K.slice_planes_cuda(datas, valids, off, length, bs),
                K.slice_planes_plain(datas, valids, off, length, bs))
    cases.append(f"cap={cap},offset={off},length={length} (q67)")
    t = chain_times(lambda: K.slice_planes_cuda(datas, valids, 0, bs, bs),
                    lambda: K.slice_planes_plain(datas, valids, 0, bs, bs),
                    lambda: [torch.cat([x[0:bs]]) for x in datas + valids],
                    2 * bs * 3 * (8 + 1))
    results.append(dict(
        name="slice_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:233", shape=f"{bs} of {cap} rows x 6 planes",
        cases=cases, library_call="torch.cat of the live prefix + pad per plane (k = 1: a "
        "copy)", **t))
    rows = [n // 4 + (1 if i < n % 4 else 0) for i in range(4)]
    parts = [planes(r, bs, 3, rng, dev) for r in rows]
    pd = [[p[0][f] for p in parts] for f in range(3)]
    pv = [[p[1][f] for p in parts] for f in range(3)]
    check_equal("concat_planes", "q67 concat", K.concat_planes_cuda(pd, pv, rows, cap),
                K.concat_planes_plain(pd, pv, rows, cap))
    ccases.append(f"k=4,rows={rows} (q67)")
    t = chain_times(lambda: K.concat_planes_cuda(pd, pv, rows, cap),
                    lambda: K.concat_planes_plain(pd, pv, rows, cap),
                    lambda: [Fn.pad(torch.cat([x[:r] for x, r in zip(p, rows)]), (0, cap - n))
                             for p in pd + pv],
                    n * 3 * (8 + 1) + cap * 3 * (8 + 1))
    results.append(dict(
        name="concat_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:354", shape=f"4 x ~{n // 4} rows -> {cap} x 6 planes",
        cases=ccases, library_call="torch.cat of the live prefixes + pad per plane", **t))
    # the split at the bucketize shapes: a sort10M map batch (its five
    # columns, the decimal(38,2) as three limbs: 7 data + 7 validity planes)
    # into 32 range partitions, and a cust_spend batch (3 + 3) into 16
    shapes = {}
    for label, (rows, nparts, nplanes) in (
            ("sort10M bucketize: 262144 rows x 14 planes into 32", (262_144, 32, 7)),
            ("cust_spend bucketize: 262144 rows x 6 planes into 16", (262_144, 16, 3))):
        datas, valids, order, counts, caps = split_case(rows, nparts, nplanes, rows, rng, dev,
                                                        empty=False)
        shapes[label] = chain_times(
            lambda: K.split_planes_cuda(datas, valids, order, counts, caps),
            lambda: K.split_planes_plain(datas, valids, order, counts, caps),
            None, split_bytes(datas, valids, counts, caps))
    main = shapes.pop("sort10M bucketize: 262144 rows x 14 planes into 32")
    results.append(dict(
        name="split_planes", route="cuda", source="blaze_tpu_torch/csrc/gather.cu",
        replaces="blaze_tpu/core/kernels.py:233", shape="sort10M bucketize: 262144 rows x "
        "14 planes into 32 partitions (the take by the order, _gather_n :181, and a "
        "_dyn_slice a partition)", cases=scases, library_ms=None, library_device_ms=None,
        library_call=None, shapes=shapes,
        **{k: v for k, v in main.items() if not k.startswith("library")}))


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


def k8_dim(keys, attrs, cap_b, t):
    """A broadcast side as the build map holds it: its rows sorted by key
    (code c owns row c), the key and ``attrs`` as int64 planes of ``cap_b``
    rows, rows past the keys padding; with the sorted words."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    nk = len(keys)
    live = np.arange(cap_b) < nk
    planes = []
    for col in (keys,) + tuple(attrs):
        d = np.zeros(cap_b, np.int64)
        d[:nk] = col[order]
        planes.append(d)
    return (t(np.sort(keys) if nk else np.zeros(1, np.int64)), nk,
            [t(d) for d in planes], [t(live)] * len(planes))


def k8_probe(cols, n, cap, t):
    """A probe batch after Spark's scan filter: ``cols`` (int64, all
    valid) compacted to the front of ``cap`` rows."""
    import numpy as np

    live = np.arange(cap) < n
    planes = []
    for c in cols:
        d = np.zeros(cap, np.int64)
        d[:n] = c[:n]
        planes.append(d)
    return [t(d) for d in planes], [t(live)] * len(planes)


def q96_join_probes(dev, cap=262144):
    """K8's three probes of one q96 store_sales batch as the main path
    chains them: 262,144 rows drawn as ``q96_host`` draws them (seed 96),
    Spark's isnotnull filter on the three keys compacting the live rows to
    the front; probe 1 against time_dim under t_hour = 20 AND t_minute >=
    30 (1,800 dense keys 73,800..75,599, capacity 131,072); its plain output
    against household_demographics under hd_dep_count = 7 (720 keys in six
    runs of 120, capacity 8,192); that output against store under
    s_store_name = 'ese' (capacity 128). Returns [(label, args, dense
    words)], args as ``inner_join_planes_plain`` takes them."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    host = q96_host(dict(Q96_ROWS, store_sales=cap))
    (t_sk, t_hour, t_minute), _ = host["time_dim"]
    (hd_sk, dep), _ = host["household_demographics"]
    (s_sk, name), _ = host["store"]
    (time, hdemo, store), (tv, hv, sv) = host["store_sales"]
    keep = tv & hv & sv
    n = int(keep.sum())
    pd, pv = k8_probe([time[keep], hdemo[keep], store[keep]], n, cap, t)
    sel = (t_hour == 20) & (t_minute >= 30)
    dims = [("time_dim", 0, k8_dim(t_sk[sel], (t_hour[sel], t_minute[sel]), 131072, t)),
            ("household_demographics", 1, k8_dim(hd_sk[dep == 7], ((dep[dep == 7]),), 8192, t)),
            ("store", 2, k8_dim(s_sk[name == Q96_ESE], (name[name == Q96_ESE],), 128, t))]
    out = []
    for table, col, (uniq, nk, bd, bv) in dims:
        args = (uniq, nk, n, pd[col], pv[col], pd, pv, bd, bv)
        label = (f"q96 probe {len(out) + 1}: {n} of {cap} rows x {len(pd)} cols vs {table} "
                 f"({nk} keys, {len(bd)} cols)")
        out.append((label, args, uniq[:max(nk, 1)].cpu().numpy()))
        count, od, ov, obd, obv = K.inner_join_planes_plain(*args)
        n = int(count)
        pd, pv = list(od) + list(obd), list(ov) + list(obv)
    return out


def q69_dates_probe(dev, rng, cap=262144):
    """K8 at q69: one store_sales batch after Spark's scan filter
    (isnotnull on the date and customer keys: 4% of the customers null,
    the live rows compacted to the front) against date_dim under d_year =
    2001 AND d_moy BETWEEN 4 AND 6 (91 dense keys, capacity 131,072)."""
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    date = rng.integers(Q69_SALES_DATES[0], Q69_SALES_DATES[1] + 1, cap)
    cust_v = rng.random(cap) >= 0.04
    cust = rng.integers(1, Q69_ROWS["customer"] + 1, cap)
    n = int(cust_v.sum())
    pd, pv = k8_probe([date[cust_v], cust[cust_v]], n, cap, t)
    days = np.arange(2_415_022, 2_415_022 + Q69_ROWS["date_dim"])
    d = np.datetime64("1900-01-02") + (days - 2_415_022)
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    sel = (year == 2001) & (moy >= 4) & (moy <= 6)
    uniq, nk, bd, bv = k8_dim(days[sel], (year[sel], moy[sel]), 131072, t)
    label = (f"q69 store_sales probe: {n} of {cap} rows x 2 cols vs date_dim "
             f"({nk} keys, 3 cols)")
    return label, (uniq, nk, n, pd[0], pv[0], pd, pv, bd, bv), uniq[:nk].cpu().numpy()


def k8_bytes(args, dense):
    """The bytes K8 must move for one probe: each live row's key and
    validity read, the other probe planes of the hit rows read, every build
    word read once by a search (two by the dense route), the hit build rows'
    planes read once, and every output plane written over the probe's
    capacity (hit rows, then padding)."""
    import torch
    from blaze_tpu_torch.core import kernels as K

    uniq, nk, n, key, kv, pd, pv, bd, bv = args
    count = int(K.inner_join_planes_plain(*args)[0])
    row_p = sum(x.element_size() for x in list(pd) + list(pv))
    row_b = sum(x.element_size() for x in list(bd) + list(bv))
    hit_keys = key[:n][kv[:n]]
    touched = int(torch.unique(hit_keys[torch.isin(hit_keys, uniq[:nk])]).numel()) if nk else 0
    return (n * (key.element_size() + 1) + count * (row_p - key.element_size() - 1)
            + (16 if dense else nk * 8) + touched * row_b
            + key.shape[0] * (row_p + row_b)), count


def k8_library(args):
    """The library chain of one probe: searchsorted, the hit rows by
    nonzero, index_select per plane (no padding)."""
    import torch

    uniq, nk, n, key, kv, pd, pv, bd, bv = args

    def chain():
        idx = torch.searchsorted(uniq, key)
        cidx = idx.clamp(max=max(nk - 1, 0))
        rows = torch.nonzero(kv & (idx < nk) & (uniq[cidx] == key)).squeeze(1)
        brow = cidx.index_select(0, rows)
        return ([p.index_select(0, rows) for p in list(pd) + list(pv)] +
                [p.index_select(0, brow) for p in list(bd) + list(bv)])
    return chain


def k8_pack(args, search=False):
    """K8's pack over the build map of the plain version's ``args``: the
    route decided from the sorted words, or the search forced."""
    from blaze_tpu_torch.core import kernels as K

    uniq, nk, _n, _k, _v, _pd, _pv, bd, bv = args
    return K.JoinPack(uniq, uniq[:nk].cpu().numpy(), bd, bv, search)


def k8_call(pack, args):
    """K8 through ``pack`` on the probe side of the plain version's
    ``args``."""
    from blaze_tpu_torch.core import kernels as K

    return K.inner_join_planes_cuda(pack, *args[2:7])


def k8_shape(label, args, route):
    """One K8 shape: held to the plain version on the route (``dense``
    from the words, or the search forced with ``route="search"``), then
    timed through a pack, as the main path calls it (events, device ms,
    the wrapper's host ms) beside the plain version and the library
    chain."""
    from blaze_tpu_torch.core import kernels as K

    pack = k8_pack(args, route == "search")
    dense = pack.dense
    want = K.inner_join_planes_plain(*args)
    check_equal("inner_join_planes", f"{label} ({'dense' if dense else 'search'})",
                k8_call(pack, args), want)
    nbytes, count = k8_bytes(args, dense)

    def k8():
        return k8_call(pack, args)

    out = shape_times(k8, lambda: K.inner_join_planes_plain(*args), k8_library(args), nbytes)
    return dict(out, host_ms=host_ms(k8), route="dense" if dense else "search", hits=count,
                probe_rows=int(args[2]))


def kernel_k8(dev, rng, results):
    """K8 against its plain version on JOIN_CASES (both search routes where
    the build words are dense), q06's batch half missing and all hitting,
    and at the main paths' probes (``q96_join_probes``, ``q69_dates_probe``);
    timed at q96's three probes (the first also on the search route), q69's
    and q06's."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    cases = []
    for kind, cap_p, n, nk, cap_b, nulls in JOIN_CASES:
        args = join_case(kind, cap_p, n, nk, cap_b, nulls, rng, dev)
        label = f"key={kind},cap_p={cap_p},n={n},nk={nk},cap_b={cap_b},nulls={nulls}"
        want = K.inner_join_planes_plain(*args)
        # the route the words give, and the search where that is the dense one
        routes = {p.dense: p for p in (k8_pack(args, search) for search in (False, True))}
        for dense, pack in routes.items():
            check_equal("inner_join_planes", f"{label} dense={dense}", k8_call(pack, args), want)
        cases.append(label)
    # a join wider than one launch's 128 planes: 25 copies of the probe
    # side of the 4,096-row case (200 probe planes and 6 build planes), two
    # launches, each against the plain version
    args = join_case(*JOIN_CASES[2], rng, dev)
    wide = args[:5] + (list(args[5]) * 25, list(args[6]) * 25) + args[7:]
    before = cuda_lib.LAUNCHES["inner_join_planes"]
    check_equal("inner_join_planes", "206 planes", k8_call(k8_pack(wide), wide),
                K.inner_join_planes_plain(*wide))
    if cuda_lib.LAUNCHES["inner_join_planes"] - before != 2:
        raise AssertionError("K8 on 206 planes did not take two launches")
    cases.append("key=i64,cap_p=4096: 25 copies of the probe side, 206 planes in 2 launches")
    # q06's batch: ~50% misses with 5% null keys, then all hitting
    for miss, nulls in ((0.5, 0.05), (0.0, 0.0)):
        q06 = q06_join_batch(rng, dev, miss, nulls)
        want = K.inner_join_planes_plain(*q06)
        for search in (False, True):
            check_equal("inner_join_planes", f"q06 miss={miss} nulls={nulls} search={search}",
                        k8_call(k8_pack(q06, search), q06), want)
        cases.append(f"q06 262144 x 4 cols vs 102000 x 4 cols, miss={miss},nulls={nulls}")
    probes = q96_join_probes(dev)
    probes.append(q69_dates_probe(dev, rng))
    shapes = {}
    main = None
    for label, args, _words in probes:
        got = k8_shape(label, args, "dense")
        main = main or got
        shapes[label] = got
        cases.append(label)
    label, args, _words = probes[0]
    shapes[label + " (search route)"] = k8_shape(label, args, "search")
    shapes["q06 262144 x 4 cols vs 102000 x 4 cols, all hit"] = k8_shape(
        "q06 all hit", q06, "dense")
    results.append(dict(
        name="inner_join_planes", route="cuda", source="blaze_tpu_torch/csrc/join.cu",
        replaces="blaze_tpu/ops/joins/bhj.py:38", shape=probes[0][0], cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library_device_ms=main["library_device_ms"],
        library_call="torch.searchsorted + torch.nonzero + index_select per plane "
                     "(a chain of calls)",
        bytes=main["bytes"], hits=main["hits"], shapes=shapes))


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
        # the two passes against their plain versions on the same planes,
        # both segmentations (the direct one compares a plane of its own
        # and still emits the keys)
        exists = torch.arange(cap, device=dev) < n
        for direct in (True, False):
            planes = K._segment_planes(dkeys, dvalids, exists, direct)
            ops = K.sort_key_operands(*planes, exists, [(True, True)] * len(planes[0]))
            order = K.lexsort_indices(ops, n)
            got = K.segment_keys_cuda(*planes, order, n, dkeys, dvalids)
            check_equal("segment_ids", f"{label},direct={direct}", got,
                        K.segment_keys_plain(*planes, order, n, dkeys, dvalids))
        ops_, emits = A._partial_program(specs, dargs)
        check_equal("seg_agg_partial", label,
                    K.segment_reduce_cuda("seg_agg_partial", order, *got[:2], n, ops_, emits),
                    K.segment_reduce_plain(order, *got[:2], n, ops_, emits))
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
    # the reduction at the segment lengths its design branches on, and a
    # float sum whose value depends on the order of its adds (one thread,
    # one warp, then one warp after four pieces)
    for length in SEG_LENGTHS:
        for prog in SEG_PROGRAMS:
            cases.append(seg_length_check(length, prog, rng, dev, check_equal))
    for length in (20, 100, 5000):
        args, fold = seg_fold_order_case(length, dev)
        got = K.segment_reduce_cuda("seg_agg_partial", *args)
        check_equal("seg_agg_partial", f"fold order, {length} rows", got,
                    K.segment_reduce_plain(*args))
        if got[0][0][0].item() != fold:
            raise AssertionError(f"float sum of {length} rows {got[0][0][0].item()}, "
                                 f"not the left fold's {fold}")
        cases.append(f"a float sum's left fold over {length} rows")
    # main path, partial: one q67 batch through the sort route
    keys, kvalids, specs, args = q67_batch(rng, dev)
    cap = n = keys[0].shape[0]
    check_seg_pipeline("seg_agg_partial", A.seg_agg_partial, (keys, kvalids, n, specs, args),
                       to_dev((keys, kvalids, n, specs, args), cpu), "q67 batch")
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
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

    def seg():
        return K.segment_keys_cuda(keys, kvalids, order, n, keys, kvalids)

    check_equal("segment_ids", "q67 batch", seg(),
                K.segment_keys_plain(keys, kvalids, order, n, keys, kvalids))
    ids_ms = time_ms(seg)
    ids_plain = time_ms(lambda: K.segment_keys_plain(keys, kvalids, order, n, keys, kvalids))
    red_ms = time_ms(lambda: K.segment_reduce_cuda("seg_agg_partial", order, starts, count,
                                                   n, ops, emits))
    red_plain = time_ms(lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits))
    lib_ms = time_ms(lib_partial)
    route_ms = time_ms(lambda: A.seg_agg_partial(keys, kvalids, n, specs, args))
    # segment_ids: each key plane (8 + 1 bytes a row) and the permutation
    # read once, the starts (cap + 1) and the count written, and the two
    # key planes emitted over the capacity; the reduction: the
    # permutation, the starts, the sum's source and validity read once,
    # per group the sum, has flag and first row written
    ids_bytes = n * (2 * 9 + 8) + (cap + 2) * 8 + cap * 2 * 9
    red_bytes = n * (8 + 8 + 1) + groups * 8 + groups * (8 + 1 + 8)
    shape = f"262144 rows -> {groups} segments (q67 batch, 2 int64 keys, SUM)"
    results.append(dict(
        name="segment_ids", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1082", shape=shape, cases=cases,
        ms=ids_ms, plain_ms=ids_plain, library_ms=None, library_call=None,
        bytes=ids_bytes, route_ms=route_ms, device_ms=kernel_device_ms(seg, OURS),
        host_ms=host_ms(seg), call_kernels=call_kernels(seg)))
    results.append(dict(
        name="seg_agg_partial", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1749", shape=shape, cases=cases,
        ms=red_ms, plain_ms=red_plain, library_ms=lib_ms,
        library_call="2x index_add_ into the segment tables (segment ids given: a chain)",
        bytes=red_bytes, route_ms=route_ms,
        device_ms=kernel_device_ms(lambda: K.segment_reduce_cuda(
            "seg_agg_partial", order, starts, count, n, ops, emits), OURS),
        library_device_ms=kernel_device_ms(lib_partial, ""),
        shapes={"one segment of 262144 rows (q67's SUM)": seg_one_segment(
            dev, rng, keys, kvalids, specs, args)}))
    # main path, merge: one q67_sort reducer's ~6.2M state rows
    keys, kvalids, kinds, states, n = q67_merge_input(rng, dev)
    cap = keys[0].shape[0]
    exists = torch.arange(cap, device=dev) < n
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
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

    k10 = lambda: K.segment_reduce_cuda("seg_agg_merge", order, starts, count, n,  # noqa: E731
                                        ops, emits)
    ms = time_ms(k10)
    plain_ms = time_ms(lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits))
    lib_ms = time_ms(lib_merge)
    ids_merge_ms = time_ms(lambda: K.segment_keys_cuda(keys, kvalids, order, n, keys,
                                                       kvalids))
    results.append(dict(
        name="seg_agg_merge", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1477",
        shape=f"{n} state rows -> {groups} segments (a q67_sort reducer)", cases=cases,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        library_call="2x index_add_ into the segment tables (segment ids and the "
                     "gate given: a chain)",
        bytes=n * (8 + 8 + 1 + 1 + 1) + groups * 8 + groups * (8 + 1 + 8),
        segment_ids_ms=ids_merge_ms, device_ms=kernel_device_ms(k10, OURS),
        library_device_ms=kernel_device_ms(lib_merge, "")))


# K10's reduction at the segment lengths its design branches on: one row,
# around a thread's 32, a warp's item (524: q17's batch), a piece's 2,048,
# several pieces, and one segment of 262,144 rows
SEG_LENGTHS = (1, 31, 32, 33, 524, 2048, 2049, 4096, 262144)
SEG_PROGRAMS = ("mixed", "wide")


def seg_length_case(length, prog, rng):
    """K10's partial arguments (CPU tensors) whose sorted segments hold
    ``length`` rows each, the last one fewer, the rows shuffled: max(3 *
    length + 7, 2,000) rows, or one segment of ``length`` rows from 262,144
    on; no null key, 10% null values. ``prog`` "mixed": SEG_SPECS
    (int64/int32/float64/float32 arguments with NaN, +-0.0, +-inf and
    subnormals), "wide": WIDE_SPECS (every limb kind). Returns (keys,
    their validity, specs, args, rows)."""
    import numpy as np
    import torch

    rows = length if length >= 262144 else max(3 * length + 7, 2000)
    cap = 1 << (rows - 1).bit_length()
    key = np.zeros(cap, np.int64)
    key[:rows] = (np.arange(rows) // length)[rng.permutation(rows)]
    if prog == "wide":
        _k, _v, specs, args = wide_torch(wide_case(
            ("lengths", ("i64",), cap, rows, 0.0, 0.1, (0, 1), "mixed"), rng),
            torch.device("cpu"))
    else:
        _k, _v, specs, args = seg_case(("i64",), cap, rows, 0.1, (0, 1), rng)
    return [torch.from_numpy(key)], [torch.arange(cap) < rows], specs, args, rows


def seg_length_check(length, prog, rng, dev, check):
    """K10's reduction over seg_length_case's rows against its plain
    version, then a merge of the partial's groups keyed three to a merged
    group, through ``check(name, label, got, want)``."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    keys, kvalids, specs, args, n = to_dev(seg_length_case(length, prog, rng), dev)
    cap = keys[0].shape[0]
    kinds = tuple(s[0] for s in specs)
    limbs = A._limb_kinds(kinds)
    tag = ":limbs" if limbs else ""
    label = f"segments of {length} rows, {prog}"
    exists = torch.arange(cap, device=dev) < n
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
    ops, emits = A._partial_program(specs, args)
    check("seg_agg_partial" + tag, label,
          K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n, ops, emits, limbs),
          K.segment_reduce_plain(order, starts, count, n, ops, emits))
    outs = A.seg_agg_partial(keys, kvalids, n, specs, args)
    g = int(outs[0])
    live = torch.arange(cap, device=dev) < g
    states = (wide_states(outs, 1, kinds, live, rng) if limbs
              else merge_states(outs, 1, kinds, g, rng))
    mk, mv = [torch.where(live, outs[2] // 3, 0)], [outs[3] & live]
    morder, mstarts, mcount, _keys = K.segment_ids(mk, mv, live, g)
    mops, memits = A._merge_program(kinds, states)
    check("seg_agg_merge" + tag, label,
          K.segment_reduce_cuda("seg_agg_merge", morder, mstarts, mcount, g, mops, memits,
                                limbs),
          K.segment_reduce_plain(morder, mstarts, mcount, g, mops, memits))
    return label


def seg_fold_order_case(length, dev):
    """One segment of ``length`` rows (a multiple of 4) whose float SUM
    depends on the order of its adds: 1e16, 1.0, -1e16, 1.0, ... is 1.0 as
    a left fold (each 1.0 added to 1e16 is lost) and length / 2 when the
    large values cancel first. Returns the reduction's arguments (order,
    starts, count, n, ops, emits) and the left fold's value."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    x = np.resize(np.array([1e16, 1.0, -1e16, 1.0]), length)
    cap = 1 << max(5, (length - 1).bit_length())
    d = np.zeros(cap)
    d[:length] = x
    live = torch.arange(cap, device=dev) < length
    keys = [torch.zeros(cap, dtype=torch.int64, device=dev)]
    order, starts, count, _keys = K.segment_ids(keys, [live], live, length)
    ops, emits = A._partial_program([("sum", 0, "float64")],
                                    [(torch.from_numpy(d).to(dev), live)])
    fold = 0.0
    for v in x:
        fold += float(v)
    return (order, starts, count, length, ops, emits), fold


def seg_one_segment(dev, rng, keys, kvalids, specs, args):
    """K10's partial over one segment: every key of a 262,144-row batch made
    equal (so every row folds into one group), the batch's program held to
    its plain version and timed beside an index_add_ chain into one slot."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    cap = n = keys[0].shape[0]
    one = [torch.full_like(k, 5) for k in keys]
    ones = [torch.ones_like(v) for v in kvalids]
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    order, starts, count, _keys = K.segment_ids(one, ones, exists, n)
    if int(count) != 1:
        raise AssertionError(f"one segment expected, {int(count)} found")
    ops, emits = A._partial_program(specs, args)
    kinds = A._limb_kinds(s[0] for s in specs)
    k10 = lambda: K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n,  # noqa: E731
                                        ops, emits, kinds)
    plain = lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits)  # noqa: E731
    check_equal("seg_agg_partial:limbs" if kinds else "seg_agg_partial", "one segment",
                k10(), plain())
    zero = torch.zeros(cap, dtype=torch.int64, device=dev)
    srcs = [op.src if op.src is not None else zero for op in ops]
    tabs = torch.zeros((len(srcs), 1), dtype=torch.int64, device=dev)

    def lib():
        for t, x in zip(tabs, srcs):
            t.index_add_(0, zero, x)

    out = shape_times(k10, plain, lib, seg_reduce_bytes(n, 1, ops, emits))
    out["library_call"] = f"{len(srcs)}x index_add_ into one slot (a chain)"
    return out


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
    (its data is the input's validity plane) with and without a filter,
    q89's old root filter (an int64 - float64 mix divided by a float64
    that may be zero: NULL there), CASE with and without ELSE (null and
    false conditions falling through, literal, column, decimal and null
    branches converted to the first branch's plane type) and Cast/TryCast
    over every device pair the chain meets (float -> int at NaN, +-inf and
    +-2^63, decimal rescales up and down with overflow, decimal -> double
    against a double literal, int/bool/float -> decimal, date <->
    timestamp on negative values, timestamp -> seconds, int narrowing)."""
    C, L, B = E.Column, E.Literal, E.BinaryOp
    D92, D73 = T.DecimalType(9, 2), T.DecimalType(7, 3)

    def bx(op, a, b, rt=None):
        return E.BinaryExpr(op, a, b, rt)

    def proj(*exprs):
        return ("project", tuple(exprs), tuple(f"c{k}" for k in range(len(exprs))))

    i, l, j, f, g, d, e, b, m, n = (C(x) for x in "iljfgdebmn")
    schema = fused_schema(T)
    cast, try_cast, case = E.Cast, E.TryCast, E.Case
    two63 = float(2 ** 63)
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
        ("q89 root filter", (
            ("filter", (bx(B.OR, bx(B.GT, bx(B.DIV, bx(B.SUB, l, d), d), L(0.1, T.F64)),
                           bx(B.GT, bx(B.DIV, bx(B.SUB, d, l), d), L(0.1, T.F64))),)),
            proj(bx(B.DIV, bx(B.SUB, l, d), d), bx(B.SUB, l, d), l, d))),
        ("case", (proj(
            case([(bx(B.GT, i, L(0, T.I32)), l), (E.IsNull(j), j)], bx(B.MUL, l, L(2, T.I64))),
            case([(b, i)]),
            case([(bx(B.LT, d, L(0.0, T.F64)), L(-1.0, T.F64)),
                  (bx(B.GT, d, L(0.0, T.F64)), L(1.0, T.F64))], L(None, T.F64)),
            case([(b, m), (bx(B.GT, i, L(0, T.I32)), n)]),
            case([(bx(B.GT, f, g), f)], g),
            case([(b, cast(i, T.I8)), (E.Not(b), cast(l, T.I8))], L(7, T.I8)),
            case([(bx(B.EQ, i, L(0, T.I32)), L(True, T.BOOL))], b),
            case([(L(None, T.BOOL), l)], L(None, T.I64))),)),
        ("case filter", (
            ("filter", (bx(B.GT, case([(E.Not(bx(B.EQ, e, L(0.0, T.F64))),
                                        bx(B.DIV, bx(B.SUB, cast(l, T.F64), d), e))],
                                      L(None, T.F64)), L(0.1, T.F64)),
                        case([(bx(B.LT, i, L(50, T.I32)), b)], L(True, T.BOOL)))),
            proj(l, case([(b, d)], e)))),
        ("casts", (proj(
            cast(d, T.I64), cast(d, T.I32), cast(f, T.I16), cast(f, T.I8), cast(d, T.I8),
            cast(bx(B.MUL, d, L(1e16, T.F64)), T.I64), cast(L(two63, T.F64), T.I64),
            cast(L(-two63, T.F64), T.I64), cast(L(9.223372036854774784e18, T.F64), T.I64),
            try_cast(L(float("nan"), T.F64), T.I32), try_cast(L(float("-inf"), T.F32), T.I64),
            cast(m, T.DecimalType(12, 4)), cast(m, T.DecimalType(5, 1)),
            cast(n, T.DecimalType(7, 0)), cast(m, T.DecimalType(18, 12)),
            try_cast(n, T.DecimalType(9, 3)), cast(m, T.F64), cast(n, T.F32),
            bx(B.EQ, cast(m, T.F64), L(0.35, T.F64)), cast(m, T.I32), cast(n, T.I8),
            cast(m, T.BOOL), cast(i, T.DecimalType(5, 2)), cast(l, T.DecimalType(18, 2)),
            cast(b, T.DecimalType(3, 1)), cast(j, T.DecimalType(2, 0))),)),
        ("casts dates and narrowing", (proj(
            cast(cast(i, T.DATE), T.TIMESTAMP), cast(cast(l, T.TIMESTAMP), T.DATE),
            cast(cast(l, T.TIMESTAMP), T.I64), cast(cast(j, T.TIMESTAMP), T.I32),
            cast(cast(bx(B.MUL, l, L(997, T.I64)), T.TIMESTAMP), T.DATE), cast(i, T.DATE),
            cast(l, T.I16), cast(l, T.I32), cast(i, T.I8), cast(i, T.I64), cast(b, T.I32),
            cast(f, T.F64), cast(d, T.F32), cast(l, T.F32), cast(l, T.F64), cast(d, T.BOOL),
            cast(i, T.BOOL), try_cast(j, T.F32)),)),
        ("cast float to decimal", (proj(
            cast(d, T.DecimalType(18, 2)), cast(f, T.DecimalType(9, 3)),
            cast(e, T.DecimalType(4, 2)), try_cast(bx(B.MUL, d, L(1e14, T.F64)),
                                                   T.DecimalType(18, 0))),)),
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
            mix(rng.integers(-10 ** 8, 10 ** 8, cap), [0, 10 ** 9 - 1, -(10 ** 9 - 1), 150, 1250,
                                                       35]),
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
    """K11 against its plain version on the battery (``fused_cases`` at
    every ``FUSED_CAPS`` entry, a coalesce between two segments) and at the
    main paths' scan filters (q69's and q96's store_sales batches); timed at
    both: events, device ms (the segment's kernels and memsets), the
    generated kernel's own device ms and the wrapper's host ms."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel, fused_chain_cuda
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
            got = K.fused_chain(schema, steps, datas, valids, n, kernel=kern)
            want = K.fused_chain_plain(schema, steps, datas, valids, n)
            check_equal("fused_chain", f"{name} cap={cap} n={n}", fused_flat(got),
                        [x.to(dev) for x in fused_flat(want)])
        cases.append(name)
    check_fused_stage_coalesce(dev, rng)
    cases.append("project+filter | coalesce | project through FusedStageExec")
    battery_s = time.perf_counter() - t0
    shapes = {}
    for label, sch, steps, datas, valids, n in (q69_filter_batch(rng, dev, E, T),
                                                 q96_filter_batch(dev, E, T)):
        kern = FusedKernel(sch, steps)
        check_equal("fused_chain", label,
                    fused_flat(K.fused_chain(sch, steps, datas, valids, n, kernel=kern)),
                    fused_flat(K.fused_chain_plain(sch, steps, datas, valids, n)))
        cases.append(label)

        def chain(kern=kern, datas=datas, valids=valids, n=n):
            return fused_chain_cuda(kern, datas, valids, n)

        # the segment reads each input plane once and writes every output
        # plane over the capacity (live rows, then padding) and the count
        plane_bytes = sum(x.numel() * x.element_size() for x in datas + valids)
        out = shape_times(chain, lambda sch=sch, steps=steps, datas=datas, valids=valids, n=n:
                          K.fused_chain_plain(sch, steps, datas, valids, n), None,
                          2 * plane_bytes + 8, prefix=OURS + ("fused_chain",))
        shapes[label] = dict(out, host_ms=host_ms(chain),
                             k11_device_ms=kernel_device_ms(chain, "fused_chain"))
    main = shapes[cases[-2]]
    results.append(dict(
        name="fused_chain", route="triton", source="blaze_tpu_torch/exprs/fused_triton.py",
        replaces="blaze_tpu/exprs/compiler.py:1042", shape=cases[-2], cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        k11_device_ms=main["k11_device_ms"], plain_ms=main["plain_ms"], library_ms=None,
        library_call="none: no single PyTorch call computes a fused chain",
        bytes=main["bytes"], battery_s=battery_s, shapes=shapes))


def q69_filter_batch(rng, dev, E, T, cap=262144):
    """K11's main path at q69: the null filter Spark infers on a
    store_sales scan over one 262,144-row batch (4% of ss_customer_sk
    null). Returns (label, schema, steps, datas, valids, live rows)."""
    import numpy as np
    import torch

    sch = T.Schema.of(("ss_sold_date_sk", T.I64), ("ss_customer_sk", T.I64))
    steps = (("filter", (E.BinaryExpr(E.BinaryOp.AND, E.IsNotNull(E.Column("ss_sold_date_sk")),
                                      E.IsNotNull(E.Column("ss_customer_sk"))),)),)
    cust_v = rng.random(cap) >= 0.04
    datas = [torch.from_numpy(rng.integers(*Q69_SALES_DATES, cap)).to(dev),
             torch.from_numpy(np.where(cust_v, rng.integers(1, 500_001, cap), 0)).to(dev)]
    valids = [torch.ones(cap, dtype=torch.bool, device=dev), torch.from_numpy(cust_v).to(dev)]
    return ("q69 store_sales batch, 262,144 rows x 2 int64 columns, "
            "isnotnull(ss_sold_date_sk) AND isnotnull(ss_customer_sk)", sch, steps, datas,
            valids, cap)


def q96_filter_batch(dev, E, T, cap=262144):
    """K11's main path at q96: Spark's isnotnull filter on store_sales'
    three keys over one 262,144-row batch drawn as ``q96_host`` draws it
    (4% of each key null)."""
    import torch

    (cols, vals) = q96_host(dict(Q96_ROWS, store_sales=cap))["store_sales"]
    names = ("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk")
    sch = T.Schema.of(*[(c, T.I64) for c in names])
    pred = E.IsNotNull(E.Column(names[0]))
    for c in names[1:]:
        pred = E.BinaryExpr(E.BinaryOp.AND, pred, E.IsNotNull(E.Column(c)))
    return ("q96 store_sales batch, 262,144 rows x 3 int64 columns, isnotnull on all three",
            sch, (("filter", (pred,)),), [torch.from_numpy(c).to(dev) for c in cols],
            [torch.from_numpy(v).to(dev) for v in vals], cap)


FUSED_STACK_ROWS = (4096, 4000, 0, 17, 4096, 2049, 1, 3000)
# the chains of K11's battery the stacked form is held to here: every step
# kind and expression family (tests/test_torch_cuda.py takes all of them)
FUSED_STACK_CASES = ("q69 scan filter", "floats", "decimals", "chain", "expand rename",
                     "isnotnull project", "case filter", "casts", "none kept")


def kernel_k11_stacked(dev, rng, results):
    """The stacked K11 (ShardedFusedRunner's dispatch): the battery chains
    of FUSED_STACK_CASES over stacks of k = 1..8 batches of 4,096 rows
    (live rows from FUSED_STACK_ROWS), each batch held to the single-batch
    plain version; then q96's store_sales filter over 8 batches of
    262,144 rows, each held to the plain version and to the single-batch
    K11, and timed against 8 single K11 dispatches of the same batches."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import FusedKernel, launch_stacked
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    cases = []
    for name, schema, steps in fused_cases(E, T):
        if name not in FUSED_STACK_CASES:
            continue
        kern = FusedKernel(schema, steps)
        for k in range(1, 9):
            host = [fused_planes(4096, FUSED_STACK_ROWS[b], rng) for b in range(k)]
            datas = [[torch.from_numpy(x).to(dev) for x in d] for d, _v in host]
            valids = [[torch.from_numpy(x).to(dev) for x in v] for _d, v in host]
            got = K.fused_chain_stacked(schema, steps, datas, valids, FUSED_STACK_ROWS[:k],
                                        kernel=kern)
            for b in range(k):
                want = K.fused_chain_plain(schema, steps, datas[b], valids[b],
                                           FUSED_STACK_ROWS[b])
                check_equal("fused_chain_stacked", f"{name} k={k} batch {b}",
                            fused_flat(got[b]), [x.to(dev) for x in fused_flat(want)])
        cases.append(f"{name}, k = 1..8")
    battery_s = time.perf_counter() - t0
    # main path: q96's store_sales filter (isnotnull on its three keys, 4%
    # of each null) over 8 batches of 262,144 rows
    names = ("ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk")
    sch = T.Schema.of(*[(c, T.I64) for c in names])
    pred = E.IsNotNull(E.Column(names[0]))
    for c in names[1:]:
        pred = E.BinaryExpr(E.BinaryOp.AND, pred, E.IsNotNull(E.Column(c)))
    steps = (("filter", (pred,)),)
    kern = FusedKernel(sch, steps)
    cap = 262144
    datas, valids = [], []
    for _b in range(8):
        vs = [rng.random(cap) >= 0.04 for _c in names]
        datas.append([torch.from_numpy(np.where(v, rng.integers(1, 86_400, cap), 0)).to(dev)
                      for v in vs])
        valids.append([torch.from_numpy(v).to(dev) for v in vs])
    rows = [cap] * 8
    got = K.fused_chain_stacked(sch, steps, datas, valids, rows, kernel=kern)
    for b in range(8):
        check_equal("fused_chain_stacked", f"q96 store_sales batch {b} of 8", fused_flat(got[b]),
                    [x.to(dev) for x in fused_flat(K.fused_chain_plain(sch, steps, datas[b],
                                                                      valids[b], cap))])
        check_equal("fused_chain_stacked", f"q96 store_sales batch {b} of 8 against K11",
                    fused_flat(got[b]),
                    fused_flat(K.fused_chain(sch, steps, datas[b], valids[b], cap, kernel=kern)))

    def stacked():
        per = K.fused_chain_stacked(sch, steps, datas, valids, rows, kernel=kern)
        return [c for _g, cs in per for c in cs]

    def single8():
        return [c for b in range(8)
                for c in K.fused_chain(sch, steps, datas[b], valids[b], cap, kernel=kern)[1]]

    if stacked() != single8():
        raise AssertionError("stacked K11's counts differ from 8 single K11 dispatches")
    plane_bytes = sum(x.numel() * x.element_size() for x in datas[0] + valids[0])
    results.append(dict(
        name="fused_chain_stacked", route="triton",
        source="blaze_tpu_torch/exprs/fused_triton.py",
        replaces="blaze_tpu/parallel/mesh.py:671",
        shape="8 stacked q96 store_sales batches, 262,144 rows x 3 int64 columns, "
              "isnotnull on all three: stacked K11 + 8 K1 + one count sync",
        cases=cases, ms=time_ms(stacked),
        plain_ms=time_ms(lambda: K.fused_chain_stacked_plain(sch, steps, datas, valids, rows)),
        library_ms=None,
        library_call="none: no single PyTorch call computes a fused chain",
        eight_single_ms=time_ms(single8),
        k11_only_ms=time_ms(lambda: launch_stacked(kern, datas, valids, rows)),
        device_ms=kernel_device_ms(lambda: launch_stacked(kern, datas, valids, rows),
                                   "fused_chain_stacked"),
        # the stacked K11 alone reads the three validity planes and writes
        # the live mask, a byte a row each, per batch
        k11_only_bytes=8 * 4 * cap,
        # each batch reads its planes once and writes its compacted planes
        # and its count
        bytes=8 * (2 * plane_bytes + 8), battery_s=battery_s))


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


def q96_count_batch(dev, cap=262144):
    """One q96 PARTIAL batch as the host table takes it: the rows of a
    262,144-row store_sales batch that pass the three joins (q96_host's
    draw at one batch's size, counted by q96_oracle) are the batch's first
    rows, each into slot 0 of the global aggregate's 1,024-slot table; the
    padding rows carry the table capacity and drop. COUNT(1)'s op: an ADD
    counting the rows its literal's all-true validity keeps. Returns
    (slots, row mask, the literal's validity, live rows)."""
    import torch

    n = q96_oracle(q96_host(dict(Q96_ROWS, store_sales=cap)))["cnt"][0]
    slots = torch.full((cap,), 1024, dtype=torch.int64, device=dev)
    slots[:n] = 0
    live = torch.arange(cap, device=dev) < n
    return slots, live, torch.ones(cap, dtype=torch.bool, device=dev), n


def k12_limb_inputs(rng, dev):
    """K12's limb shapes of q17: the reducer's FINAL merge of every partial
    batch's states into q17_table's 1,024-slot table (slots, row mask and
    the wide SUM's state columns), and a 262,144-row q17 batch's
    decimal(38,2) argument with its slots (the lexicographic fold's MIN and
    MAX input)."""
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    keys, kvalids, _specs, args = q17_partial_batch(rng, dev)
    bases, sizes, _cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), keys[0].shape[0],
                                           None, conf.dense_agg_max_buckets, conf)
    lslots = (keys[0] - bases[0] + 1) * sizes[1] + (keys[1] - bases[1] + 1)
    fk, _fv, _kinds, fstates = q17_merge_input(rng, dev, Q17_FINAL_ROWS)
    fexists = torch.arange(fk[0].shape[0], device=dev) < Q17_FINAL_ROWS
    slots = torch.where(fexists, fk[0] * 10 + fk[1], 1024)
    cols = [DeviceColumn(T.I64, d, v) for d, v in fstates[2]]
    return (slots, fexists, cols, fstates[2]), (lslots, kvalids[0], args[2][0])


def k12_shape(spec, timed=True):
    """One of K12's shapes (a ``k12_shapes`` entry): its functions' ops
    into fresh tables through K12 and its plain version, equal bit for bit;
    then, where ``timed``, timed on one set of tables beside the library
    chain (where there is one), with the launches of K5's sort one call
    makes."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    label, fns, planes, slots, mask, lib, nbytes, table_cap, num_rows = spec

    def k12_launch(slots, mask, ops, pack):  # as the host table calls it
        K.slot_update_cuda(slots, mask, ops, pack, num_rows=num_rows)

    tables = {}
    for name, update in (("kernel", lambda s_, m_, o_: k12_launch(s_, m_, o_, None)),
                         ("plain", K.slot_update_plain)):
        states = [fn.init_state(table_cap, slots.device) for fn in fns]
        update(slots, mask, [op for fn, st, pl in zip(fns, states, planes)
                             for op in pl(fn, st)])
        tables[name] = states
    check_equal("slot_update", label, tables["kernel"], tables["plain"])
    states = [fn.init_state(table_cap, slots.device) for fn in fns]
    ops = [op for fn, st, pl in zip(fns, states, planes) for op in pl(fn, st)]
    pack = K.SlotUpdatePack()
    k12_launch(slots, mask, ops, pack)
    before = cuda_lib.launch_counts()["lexsort_indices"]
    k12_launch(slots, mask, ops, pack)
    sorts = cuda_lib.launch_counts()["lexsort_indices"] - before
    if not timed:
        return dict(device_ms=kernel_device_ms(lambda: k12_launch(slots, mask, ops, pack), OURS),
                    k5_launches=sorts)
    out = shape_times(lambda: k12_launch(slots, mask, ops, pack),
                      lambda: K.slot_update_plain(slots, mask, ops), lib, nbytes)
    return dict(out, k5_launches=sorts, rows=int(slots.shape[0]))


def k12_shapes(dev, rng):
    """K12's shapes at its main paths, the row's own first: (label,
    functions, each one's ops over its state, slots, row mask, a library
    chain computing the same sums or None, the bytes the call must move,
    table capacity, the live rows the host table passes or None). A q67_table merge batch, q96's COUNT(1) batch,
    q17_table's FINAL merge of wide sums, the lexicographic fold of a q17
    batch, a float64 SUM into q67_table's slots (K5's sort, then the fold)
    and into one slot."""
    import torch
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import aggfns

    def agg(fn, arg_type, args=None):
        return aggfns.create_agg_function(
            E.AggExpr(E.AggFunction[fn], [E.Column("v")] if args is None else args),
            T.Schema.of(("v", arg_type)))

    out = []
    # main path: a q67_table merge batch, FINAL SUM(qty) states (sum, has)
    slots, live, s, has = q67_table_merge_batch(rng, dev)
    rows = slots.shape[0]
    cols = [DeviceColumn(T.I64, s, has), DeviceColumn(T.BOOL, has, live)]
    gate = has & live
    touched = int(torch.unique(slots[gate]).numel())
    acc = torch.zeros(262144, dtype=torch.int64, device=dev)
    contrib = torch.where(gate, s, 0)
    flags = gate.to(torch.uint8)
    flag8 = torch.zeros(262144, dtype=torch.uint8, device=dev)

    def library():
        acc.index_add_(0, slots, contrib)
        flag8.scatter_reduce_(0, slots, flags, "amax")

    # the rows' slot, mask, sum and has planes (has: data and validity)
    # read once; each touched slot's sum read and written once, its flag
    # written once (nothing reads the flag table)
    out.append((f"{rows} state rows -> {touched} touched slots of 262,144 (a q67_table merge "
                "batch: SUM int64 + has flag)", [agg("SUM", T.I64)],
                [lambda fn, st: fn.merge_ops(st, cols)], slots, live, library,
                rows * (8 + 1 + 8 + 1 + 1) + touched * (8 * 2 + 1), 262144, rows))
    # q96's COUNT(1) batch: every live row into slot 0
    qslots, qlive, qvalid, qn = q96_count_batch(dev)
    ones = torch.ones(rows, dtype=torch.int32, device=dev)
    qacc = torch.zeros(1024, dtype=torch.int64, device=dev)
    qidx = torch.where(qlive, qslots, 0)
    qcontrib = (qlive & qvalid).to(torch.int64)
    out.append((f"q96 COUNT(1) batch: {qn} live rows of 262,144 into slot 0",
                [agg("COUNT", T.I64, [E.Literal(1, T.I32)])],
                [lambda fn, st: fn.update_ops(st, ones, qvalid)], qslots, qlive,
                lambda: qacc.index_add_(0, qidx, qcontrib), qn * (8 + 1 + 1) + 16, 1024, qn))
    # q17_table's FINAL merge: three limb adds, the renormalisation, has
    (fslots, fexists, fcols, fstates), (lslots, lvalid, lex_arg) = k12_limb_inputs(rng, dev)
    wide = wide_upd_fns()
    fgate = fstates[3][0] & fstates[3][1]
    ltabs = torch.zeros((3, 1024), dtype=torch.int64, device=dev)
    lsrc = [torch.where(fgate, fstates[q][0], 0) for q in range(3)]
    fidx = fslots.clamp(max=1023)

    def limb_chain():
        for t, x in zip(ltabs, lsrc):
            t.index_add_(0, fidx, x)

    # a row's slot, mask, three limbs and the has flag's data and validity
    # read once; a touched slot's three limbs read and written once, its
    # flag written
    out.append((f"q17_table FINAL: {Q17_FINAL_ROWS} state rows into 500 of 1,024 slots "
                "(three-limb SUM + renormalisation + has)", [wide[2]],
                [lambda fn, st: fn.merge_ops(st, fcols)], fslots, fexists, limb_chain,
                Q17_FINAL_ROWS * (8 + 1 + 24 + 2) + Q17_GROUPS * (2 * 24 + 1), 1024,
                Q17_FINAL_ROWS))
    # the lexicographic fold: MIN and MAX of a q17 batch's decimal(38,2)
    out.append(("lexicographic fold: 262,144 rows into <= 500 of 1,024 slots (MIN and MAX "
                "of decimal(38,2))", wide[4:],
                [lambda fn, st: fn.update_ops(st, lex_arg, lvalid)] * 2, lslots, lvalid, None,
                int(lslots.shape[0]) * (8 + 1 + 24 + 1) + Q17_GROUPS * 2 * (24 + 24 + 1),
                1024, None))
    # the fold route: a float64 SUM of 262,144 raw rows into q67_table's
    # slots, and into one slot
    sum_f64 = agg("SUM", T.F64)
    fvals = torch.from_numpy(rng.random(rows)).to(dev)
    ftouched = int(torch.unique(slots).numel())
    facc = torch.zeros(262144, dtype=torch.float64, device=dev)
    out.append(("float fold route: a float64 SUM of 262,144 rows into q67_table's slots",
                [sum_f64], [lambda fn, st: fn.update_ops(st, fvals, live)], slots, live,
                lambda: facc.index_add_(0, slots, fvals),
                rows * (8 + 1 + 8 + 1) + ftouched * (8 * 2 + 1), 262144, rows))
    zeros = torch.zeros(rows, dtype=torch.int64, device=dev)
    zacc = torch.zeros(1024, dtype=torch.float64, device=dev)
    out.append(("one-slot float SUM: a float64 SUM of 262,144 rows into one slot", [sum_f64],
                [lambda fn, st: fn.update_ops(st, fvals, live)], zeros, live,
                lambda: zacc.index_add_(0, zeros, fvals), rows * (8 + 1 + 8 + 1) + 17, 1024,
                rows))
    return out


def kernel_k12(dev, rng, results):
    """K12 against its plain version on every UPD_CASES and WIDE_UPD_CASES
    entry and at its main paths' shapes (``k12_shapes``), each timed (CUDA
    events and device ms, a library chain's beside them where one
    exists)."""
    from blaze_tpu_torch.core import kernels as K

    cases = []
    fns = upd_fns()
    for spec in UPD_CASES:
        case = upd_case(spec, rng)
        got = upd_run(case, fns, K.slot_update_cuda, dev, packed=True)
        want = upd_run(case, fns, K.slot_update_plain, dev)
        check_equal("slot_update", case["label"], got, want)
        cases.append(case["label"])
    limb_cases = kernel_limbs_k12(dev, rng)
    specs = k12_shapes(dev, rng)
    main = k12_shape(specs[0])
    cases.append("q67_table merge batch")
    shapes = {spec[0]: k12_shape(spec) for spec in specs[1:]}
    results.append(dict(
        name="slot_update", route="cuda", source="blaze_tpu_torch/csrc/slot_update.cu",
        replaces="blaze_tpu/ops/aggfns.py:362", shape=specs[0][0], cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], library_device_ms=main["library_device_ms"],
        library_call="index_add_ + scatter_reduce_(amax) into the slot tables (a chain)",
        bytes=main["bytes"], shapes=shapes))
    final = next(v for k, v in shapes.items() if k.startswith("q17_table FINAL"))
    fold = next(v for k, v in shapes.items() if k.startswith("lexicographic"))
    results.append(dict(
        name="slot_update:limbs", route="cuda", source="blaze_tpu_torch/csrc/slot_update.cu",
        replaces="blaze_tpu/ops/aggfns.py:320",
        shape=f"{Q17_FINAL_ROWS} state rows -> 500 of 1,024 slots (q17_table's FINAL merge: "
              "three-limb SUM + renormalisation + has)",
        cases=limb_cases, ms=final["ms"], device_ms=final["device_ms"],
        plain_ms=final["plain_ms"], library_ms=final["library_ms"],
        library_device_ms=final["library_device_ms"],
        library_call="3x index_add_ of the gated limbs into the slot tables (no "
                     "renormalisation; a chain)",
        bytes=final["bytes"], fold_ms=fold["ms"], fold_device_ms=fold["device_ms"],
        fold_replaces="blaze_tpu/ops/aggfns.py:161",
        fold_shape="262144 rows -> <= 500 of 1,024 slots (MIN and MAX of decimal(38,2))"))


# K13's battery: (label, data kind, capacity, live rows, segment shape, null
# share, carry). Segment shapes: "q89" starts a segment every ~4.5 rows (as
# q89's window partitions do), "one" every row, "span" once at row 0, "none"
# never (the whole batch continues the carried segment). Float planes draw
# magnitudes 1e-5..1e16 with +-inf, -0.0 and NaN; integer planes hold
# values next to int64's ends, so sums wrap. "i64 q89 window" is the batch
# q89's main path gives K13: the window's 70,421 input rows (q89_oracle's
# count at SF10, seed 89) in one int64 plane of capacity_for(70,421) =
# 131,072 rows, no nulls, no carry.
SCAN_Q89_STARTS = 15_720 / 70_421     # q89's window partitions a row, SF10
SCAN_Q89 = ("i64 q89 window", "i64", 131072, 70421, "q89", 0.0, False)
SCAN_CASES = (
    SCAN_Q89,
    ("i64 q89 segments", "i64", 4096, 4001, "q89", 0.05, True),
    ("i64 wrap, one segment", "i64", 4096, 4096, "span", 0.0, False),
    ("i32 promoted", "i32", 4096, 4090, "q89", 0.1, True),
    ("f64 q89 segments", "f64", 262144, 262139, "q89", 0.05, True),
    ("f32 q89 segments", "f32", 262144, 262139, "q89", 0.05, True),
    ("f64 one-row segments", "f64", 4096, 4093, "one", 0.1, False),
    ("f64 one segment spanning", "f64", 262144, 262144, "span", 0.02, True),
    ("f64 carry only", "f64", 4096, 3001, "none", 0.05, True),
    ("f32 carry only", "f32", 4096, 4095, "none", 0.0, True),
    ("i64 capacity 16", "i64", 16, 13, "q89", 0.2, True),
    ("f64 capacity 16", "f64", 16, 11, "q89", 0.2, True),
    ("f32 capacity 16, carry only", "f32", 16, 16, "none", 0.0, True),
)
SCAN_FLOATS = (0.0, -0.0, float("inf"), float("-inf"), float("nan"))


def scan_case(case, rng):
    """numpy planes of one SCAN_CASES entry, honouring the padding contract:
    {label, data, validity, exists, seg_start (live rows only), carry_sum,
    carry_cnt}."""
    import numpy as np

    label, kind, cap, n, shape, nulls, carry = case
    npdt = {"i64": np.int64, "i32": np.int32, "f64": np.float64, "f32": np.float32}[kind]
    data = np.zeros(cap, npdt)
    if kind.startswith("f"):
        mag = 10.0 ** rng.uniform(-5, 16, n) * rng.choice([-1.0, 1.0], n)
        special = rng.random(n) < 0.002
        mag[special] = rng.choice(SCAN_FLOATS, int(special.sum()))
        data[:n] = mag
    elif kind == "i64":
        big = np.iinfo(np.int64).max // 3
        data[:n] = rng.integers(big - 1000, big, n) * rng.choice([-1, 1], n)
    else:
        data[:n] = rng.integers(-(1 << 31), (1 << 31) - 1, n)
    valid = np.zeros(cap, bool)
    valid[:n] = rng.random(n) >= nulls
    data[~valid] = 0
    exists = np.arange(cap) < n
    seg = {"q89": rng.random(n) < SCAN_Q89_STARTS, "one": np.ones(n, bool),
           "span": np.arange(n) == 0, "none": np.zeros(n, bool)}[shape]
    if carry:
        carry_sum = npdt(12345.5) if kind.startswith("f") else np.int64(1 << 40)
        carry_cnt = 17
    else:
        carry_sum, carry_cnt = 0, 0
    return {"label": label, "data": data, "validity": valid, "exists": exists,
            "seg_start": seg, "carry_sum": carry_sum, "carry_cnt": carry_cnt}


def scan_run(case, fn, dev):
    """One battery case through ``fn`` (K13's wrapper or its plain twin) on
    ``dev``: the (sum, count) planes over the capacity."""
    import numpy as np
    import torch

    seg = np.zeros(len(case["data"]), bool)
    seg[:len(case["seg_start"])] = case["seg_start"]
    t = [torch.from_numpy(case[k]).to(dev) for k in ("data", "validity", "exists")]
    return fn(*t, torch.from_numpy(seg).to(dev), case["carry_sum"], case["carry_cnt"])


def one_nan(x):
    """``x`` with every NaN as one NaN: a NaN's payload is the hardware's."""
    import torch

    if not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def kernel_k13(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.core.batch import iota

    cases = []
    for spec in SCAN_CASES:
        case = scan_case(spec, rng)
        got = scan_run(case, K.segment_scan_cuda, dev)
        want = scan_run(case, K.segment_scan_plain, dev)
        check_equal("segment_scan", case["label"], [one_nan(x) for x in got],
                    [one_nan(x) for x in want])
        cases.append(case["label"])
    # timed: the main path's batch (SCAN_Q89), and a full 262,144-row
    # float64 batch with q89-shaped segments and a carry
    def timed(spec):
        case = scan_case(spec, rng)
        d, v, ex = (torch.from_numpy(case[k]).to(dev) for k in ("data", "validity", "exists"))
        seg = torch.zeros(len(case["data"]), dtype=torch.bool, device=dev)
        seg[:len(case["seg_start"])] = torch.from_numpy(case["seg_start"]).to(dev)
        cs0, cc0 = case["carry_sum"], case["carry_cnt"]
        cap = d.shape[0]
        idx = iota(cap, dev)
        neg = torch.full((), -1, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64 if not d.is_floating_point() else d.dtype,
                           device=dev)

        def library():
            si = torch.cummax(torch.where(seg, idx, neg), dim=0).values
            live = v & ex
            cs = torch.cumsum(torch.where(live, d, zero), dim=0)
            cc = torch.cumsum(live.to(torch.int64), dim=0)
            prev = (si - 1).clamp(min=0)
            return cs - torch.where(si >= 1, cs[prev], zero), cc - torch.where(si >= 1, cc[prev], 0)

        # data, validity, exists and seg_start read once; an 8-byte sum and
        # an 8-byte count written, over the capacity
        return {"kernel_ms": time_ms(lambda: K.segment_scan_cuda(d, v, ex, seg, cs0, cc0)),
                "plain_ms": time_ms(lambda: K.segment_scan_plain(d, v, ex, seg, cs0, cc0)),
                "library_ms": time_ms(library),
                "bytes": cap * (d.element_size() + 1 + 1 + 1 + 8 + 8),
                "rows": int(case["exists"].sum()), "capacity": cap,
                "segment_starts": int(seg.sum())}

    main = timed(SCAN_Q89)
    big = timed(("f64 timed", "f64", 262144, 262144, "q89", 0.05, True))
    big["bound_ms"] = big["bytes"] / HBM_BYTES_PER_S * 1e3
    results.append(dict(
        name="segment_scan", route="cuda", source="blaze_tpu_torch/csrc/seg_scan.cu",
        replaces="blaze_tpu/core/kernels.py:469",
        shape=f"q89's window batch: {main['rows']} int64 rows in a {main['capacity']}-row "
              f"plane, {main['segment_starts']} segment starts (~4.5-row partitions), no "
              "nulls, no carry",
        cases=cases, ms=main["kernel_ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"],
        library_call="cummax + cumsum + gather + subtract, for the sums and the counts "
        "(a chain)",
        bytes=main["bytes"], big_batch=big))


# -- the limb halves: wide-decimal states in K3/K4, K10 and K12 ------------------

# |l2| below this keeps |value| < 10^38: 5e18 * 2^64 < 10^38
L2_SPAN = 5 * 10 ** 18
# values a case draws from besides uniform limbs: decimal(38)'s ends, 2^64's
# and 2^63's neighbours, cancellation pairs near the extremes; the
# decimal(18) pools for the two-limb sums
WIDE_POOLS = {
    "extremes": (10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 64, 2 ** 64 - 1, -(2 ** 64),
                 -(2 ** 64) - 1, 2 ** 63, -(2 ** 63), 1, -1, 0),
    "cancel": (10 ** 37, -(10 ** 37), 10 ** 37, -(10 ** 37), 12345, -12345),
}
NARROW_POOLS = {
    "extremes": (10 ** 18 - 1, -(10 ** 18 - 1), 2 ** 32, -(2 ** 32), 2 ** 31 - 1, 1, -1, 0),
    "cancel": (10 ** 18 - 1, -(10 ** 18 - 1), 12345),
}
# aggregate (kind, rescale, accumulator) and its argument: d a decimal(18,2)
# plane (two-limb sums), w a decimal(38,2) plane as limbs, * COUNT(*)
WIDE_SPECS = ((("sum2", 0, "int64"), "d"), (("avg2", 0, "int64"), "d"),
              (("sum3", 0, "int64"), "w"), (("avg3", 0, "int64"), "w"),
              (("minw", 0, "int64"), "w"), (("maxw", 0, "int64"), "w"),
              (("count", 0, ""), "*"))
# (label, key kinds, capacity, live rows, key null share, value null share,
# key range, values): values "mixed" (both signs: uniform limbs up to ~10^38
# and int64 magnitudes), "negative", "extremes", "cancel" (pools above), or
# "q17" (q17's wcost: uniform [10^14, 9*10^16))
WIDE_CASES = (
    ("mixed signs, nulls, padding", ("i64",), 4096, 4000, 0.05, 0.1, (-20, 20), "mixed"),
    ("all negative", ("i64",), 256, 200, 0.0, 0.1, (0, 8), "negative"),
    ("38-digit extremes, past 2^64", ("i64", "i64"), 1024, 1000, 0.05, 0.05, (0, 4),
     "extremes"),
    ("cancellation near the extremes", ("i64",), 256, 256, 0.0, 0.0, (0, 3), "cancel"),
    ("single rows", ("i64",), 256, 60, 0.0, 0.1, (0, 50_000), "mixed"),
    ("every value null", ("i64",), 256, 200, 0.0, 1.0, (0, 10), "mixed"),
    ("one row", ("i64",), 256, 1, 0.0, 0.0, (0, 5), "extremes"),
    ("q17 values", ("i64", "i64"), 4096, 4096, 0.0, 0.0, (0, 10), "q17"),
)
LO32 = 0xFFFFFFFF


def limbs_of(values):
    """Python ints within 128 bits -> (l0, l1, l2) int64 arrays."""
    import numpy as np

    lo = np.array([int(v) & ((1 << 64) - 1) for v in values], dtype=np.uint64).view(np.int64)
    return lo & LO32, (lo >> 32) & LO32, np.array([int(v) >> 64 for v in values], np.int64)


def ints_of(l0, l1, l2):
    """The exact Python ints of limb planes."""
    return [(int(c) << 64) + (int(b) << 32) + int(a) for a, b, c in zip(l0, l1, l2)]


def wide_plane(kind, cap, n, rng, nulls):
    """(l0, l1, l2, validity) of a decimal(38) plane with ``n`` live rows of
    ``cap``: padding rows 0, null rows keep their drawn limbs (the kernels
    must not read them)."""
    import numpy as np

    live = np.arange(cap) < n
    if kind in ("mixed", "negative"):
        top = 0 if kind == "negative" else L2_SPAN
        l0, l1 = rng.integers(0, 1 << 32, cap), rng.integers(0, 1 << 32, cap)
        l2 = rng.integers(-L2_SPAN, top, cap)
        x = rng.integers(-(1 << 62), 0 if kind == "negative" else 1 << 62, cap)
        small = rng.random(cap) < 0.3  # int64 magnitudes: l2 is 0 or -1
        l0, l1, l2 = (np.where(small, x & LO32, l0), np.where(small, (x >> 32) & LO32, l1),
                      np.where(small, x >> 63, l2))
    elif kind == "q17":
        x = rng.integers(10 ** 14, 9 * 10 ** 16, cap)
        l0, l1, l2 = x & LO32, x >> 32, np.zeros(cap, np.int64)
    else:
        p0, p1, p2 = limbs_of(WIDE_POOLS[kind])
        i = rng.integers(0, len(p0), cap)
        l0, l1, l2 = p0[i], p1[i], p2[i]
    valid = live & (rng.random(cap) >= nulls)
    return tuple(np.where(live, x, 0).astype(np.int64) for x in (l0, l1, l2)) + (valid,)


def narrow_plane(kind, cap, n, rng, nulls):
    """(data, validity) of a decimal(18) plane (the two-limb sums'
    argument), drawn as ``wide_plane`` draws its kind."""
    import numpy as np

    live = np.arange(cap) < n
    if kind in NARROW_POOLS:
        pool = np.array(NARROW_POOLS[kind], np.int64)
        d = pool[rng.integers(0, len(pool), cap)]
    elif kind == "q17":
        d = rng.integers(10 ** 14, 9 * 10 ** 16, cap)
    else:
        d = rng.integers(-(10 ** 18) + 1, 0 if kind == "negative" else 10 ** 18, cap)
    return np.where(live, d, 0).astype(np.int64), live & (rng.random(cap) >= nulls)


def wide_case(case, rng):
    """The partial arguments of one WIDE_CASES entry on the host: key planes
    (validity masked with the live rows), the specs and per aggregate its
    (data, valid): data a (l0, l1, l2) tuple for a wide argument."""
    import numpy as np

    _label, kinds, cap, n, knulls, vnulls, (lo, hi), values = case
    live = np.arange(cap) < n
    keys, kvalids = [], []
    for _ in kinds:
        d = rng.integers(lo, hi, cap)
        keys.append(np.where(live, d, 0).astype(np.int64))
        kvalids.append(live & (rng.random(cap) >= knulls))
    w = wide_plane(values, cap, n, rng, vnulls)
    cols = {"d": narrow_plane(values, cap, n, rng, vnulls), "w": (w[:3], w[3]),
            "*": (np.zeros(cap, np.int64), live)}
    return keys, kvalids, tuple(s for s, _ in WIDE_SPECS), [cols[c] for _, c in WIDE_SPECS]


def wide_torch(x, dev):
    """numpy planes (nested in tuples and lists) as tensors on ``dev``."""
    import numpy as np
    import torch

    if isinstance(x, (list, tuple)):
        return type(x)(wide_torch(y, dev) for y in x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev) if isinstance(x, np.ndarray) else x


def wide_states(outs, k, kinds, live, rng):
    """The partial outputs as merge-input state columns (validity redrawn,
    so every gate of the merge is taken)."""
    import numpy as np
    import torch

    nstate = {"sum2": 3, "avg2": 3, "sum3": 4, "avg3": 4, "minw": 4, "maxw": 4, "count": 1}
    states, pos = [], 2 + 2 * k
    for kind in kinds:
        cols = []
        for _ in range(nstate[kind]):
            keep = torch.from_numpy(rng.random(live.shape[0]) >= 0.1).to(live.device)
            cols.append((outs[pos], keep & live))
            pos += 1
        states.append(cols)
    return states


def doubled(outs, g, cap2, dev):
    """Partial outputs' first ``g`` rows twice (two maps' states), padded to
    ``cap2``."""
    import torch

    return [torch.nn.functional.pad(torch.cat([x[:g], x[:g]]), (0, cap2 - 2 * g))
            for x in outs[2:]]


def kernel_limbs(dev, rng, results):
    """The limb ops of K3/K4 and K10 against their plain versions on every
    WIDE_CASES entry, partial and merge, then each timed at q17's shapes
    (``time_limbs``; K12's limb ops are ``kernel_k12``'s)."""
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    cpu = torch.device("cpu")
    cases = []
    for case in WIDE_CASES:
        keys, kvalids, specs, args = wide_torch(wide_case(case, rng), dev)
        label, n, cap = case[0], case[3], case[2]
        kinds = tuple(s[0] for s in specs)
        k = len(keys)
        kd = [torch.int64] * k
        # K3 and K4
        st = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                               conf.radix_agg_max_slots, conf)
        if st is not None and st is not A._DEFER_PLAN:
            bases, sizes, out_cap = st
            got = A.slot_agg_partial(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap)
            want = A.slot_agg_partial_plain(keys, kvalids, kd, n, bases, sizes, specs, args,
                                            out_cap)
            check_equal("slot_agg_partial:limbs", label, got, want)
            g = int(want[0])
            cap2 = conf.capacity_for(2 * g)
            cat = doubled(want, g, cap2, dev)
            live = torch.arange(cap2, device=dev) < 2 * g
            mk = [cat[2 * i] for i in range(k)]
            mv = [cat[2 * i + 1] & live for i in range(k)]
            states = wide_states([None, None] + cat, k, kinds, live, rng)
            st2 = A.plan_slot_table(A.probe_ranges(mk, mv), cap2, None,
                                    conf.radix_agg_max_slots, conf)
            if st2 is not None and st2 is not A._DEFER_PLAN:
                b2, s2, o2 = st2
                check_equal("slot_agg_merge:limbs", label,
                            A.slot_agg_merge(mk, mv, kd, 2 * g, b2, s2, kinds, states, o2),
                            A.slot_agg_merge_plain(mk, mv, kd, 2 * g, b2, s2, kinds, states,
                                                   o2))
        # K10: its reduction against the twin on the same sorted rows, then
        # the whole route on the card against the route on CPU copies
        exists = torch.arange(cap, device=dev) < n
        order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
        ops, emits = A._partial_program(specs, args)
        check_equal("seg_agg_partial:limbs", label,
                    K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n, ops,
                                          emits, kinds),
                    K.segment_reduce_plain(order, starts, count, n, ops, emits))
        for direct in (True, False):
            outs = check_seg_pipeline("seg_agg_partial:limbs", A.seg_agg_partial,
                                      (keys, kvalids, n, specs, args, direct),
                                      to_dev((keys, kvalids, n, specs, args, direct), cpu),
                                      f"{label},direct={direct}")
        g = int(outs[0])
        if g:
            live = torch.arange(cap, device=dev) < g
            states = wide_states(outs, k, kinds, live, rng)
            mk, mv = list(outs[2:2 + 2 * k:2]), list(outs[3:3 + 2 * k:2])
            check_seg_pipeline("seg_agg_merge:limbs", A.seg_agg_merge,
                               (mk, mv, g, kinds, states),
                               (to_dev(mk, cpu), to_dev(mv, cpu), g, kinds,
                                to_dev(states, cpu)), label)
        cases.append(label)
    time_limbs(dev, rng, results, cases)


# K12's limb battery: the limb aggregates of the host table and their
# argument (d decimal(18,2), w decimal(38,2)); cases (label, mode, (capacity,
# live rows) a batch, batches, slots drawn from, (table capacity at the
# start, after the first batch), null share, values)
WIDE_UPD_FNS = (("sum", "d"), ("avg", "d"), ("sum", "w"), ("avg", "w"), ("min", "w"),
                ("max", "w"))
WIDE_UPD_CASES = (
    ("update, mixed signs", "update", (256, 200), 3, 40, (1024, 1024), 0.1, "mixed"),
    ("merge, mixed signs", "merge", (256, 230), 3, 40, (1024, 1024), 0.1, "mixed"),
    ("update, all negative, growth", "update", (4096, 4000), 2, 3000, (1024, 4096), 0.1,
     "negative"),
    ("merge, extremes, growth", "merge", (4096, 3500), 2, 3000, (1024, 4096), 0.05,
     "extremes"),
    ("update, one slot, cancellation", "update", (1024, 1000), 2, 1, (1024, 1024), 0.0,
     "cancel"),
    ("merge, all null", "merge", (256, 200), 2, 40, (1024, 1024), 1.0, "mixed"),
    ("update, empty batch", "update", (256, 0), 2, 40, (1024, 1024), 0.1, "mixed"),
)


def wide_upd_types(T, arg):
    return T.DecimalType(18, 2) if arg == "d" else T.DecimalType(38, 2)


def wide_upd_fns():
    """The port's aggregate functions of WIDE_UPD_FNS (limb layouts)."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import aggfns

    fns = []
    for fn, arg in WIDE_UPD_FNS:
        agg = E.AggExpr(E.AggFunction[fn.upper()], [E.Column("v")])
        fns.append(aggfns.create_agg_function(agg, T.Schema.of(("v", wide_upd_types(T, arg)))))
    assert all(f.limbs for f in fns)
    return fns


def wide_upd_state_planes(fn, arg, cap, n, rng, nulls, values):
    """A batch of partial states of ``fn`` (merge input), one (data,
    validity) pair per state field: limbs normalised, as partial states
    are, with every gate of the merge taken."""
    import numpy as np

    live = np.arange(cap) < n

    def flag():
        return (rng.random(cap) < 0.8) & live, live & (rng.random(cap) >= nulls)

    if arg == "d":
        d, v = narrow_plane(values, cap, n, rng, nulls)
        limbs = [(d & LO32, v), (d >> 32, v)]
    else:
        w = wide_plane(values, cap, n, rng, nulls)
        limbs = [(x, w[3]) for x in w[:3]]
    if fn == "avg":
        counts = rng.integers(0, 100, cap).astype(np.int64) * live
        return limbs + [(counts, live & (rng.random(cap) >= nulls))]
    return limbs + [flag()]


def wide_upd_case(case, rng):
    """K12's inputs of one WIDE_UPD_CASES entry on the host: per batch the
    slots (padding rows at the table's capacity), the row mask and per
    WIDE_UPD_FNS entry its planes (update: the argument's (data, validity),
    data a limb tuple for w; merge: the state fields)."""
    import numpy as np

    label, mode, (cap, n), nbatch, nslots, caps, nulls, values = case
    batches = []
    for b in range(nbatch):
        table_cap = caps[0] if b == 0 else caps[1]
        live = np.arange(cap) < n
        slots = np.where(live, rng.integers(0, min(nslots, table_cap), cap), table_cap)
        planes = []
        for fn, arg in WIDE_UPD_FNS:
            if mode == "merge":
                planes.append(wide_upd_state_planes(fn, arg, cap, n, rng, nulls, values))
            elif arg == "d":
                planes.append(narrow_plane(values, cap, n, rng, nulls))
            else:
                w = wide_plane(values, cap, n, rng, nulls)
                planes.append((w[:3], w[3]))
        batches.append({"slots": slots.astype(np.int64), "mask": live, "planes": planes})
    return {"label": label, "mode": mode, "caps": caps, "batches": batches}


def wide_upd_run(case, fns, update, dev):
    """The functions' tables after the case's batches, each batch's ops of
    every function through ``update`` (K12 or its plain version)."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.core.batch import DeviceColumn
    from blaze_tpu_torch.ir import types as T

    caps = case["caps"]
    states = [fn.init_state(caps[0], dev) for fn in fns]
    for b, batch in enumerate(case["batches"]):
        if b == 1:
            states = [fn.grow(st, caps[1]) for fn, st in zip(fns, states)]
        ops = []
        for fn, st, planes in zip(fns, states, batch["planes"]):
            if case["mode"] == "merge":
                ops += fn.merge_ops(st, [DeviceColumn(T.I64, *wide_torch((d, v), dev))
                                         for d, v in planes])
            else:
                d, v = wide_torch(planes, dev)
                ops += fn.update_ops(st, d, v)
        slots, mask = wide_torch((batch["slots"], batch["mask"]), dev)
        for at in range(0, len(ops), K._MAX_UPD_OPS):
            update(slots, mask, ops[at:at + K._MAX_UPD_OPS])
    return states


def kernel_limbs_k12(dev, rng):
    """K12's limb ops (update, merge, lex fold) against their plain version
    on every WIDE_UPD_CASES entry."""
    from blaze_tpu_torch.core import kernels as K

    fns = wide_upd_fns()
    cases = []
    for spec in WIDE_UPD_CASES:
        case = wide_upd_case(spec, rng)
        check_equal("slot_update:limbs", case["label"],
                    wide_upd_run(case, fns, K.slot_update_cuda, dev),
                    wide_upd_run(case, fns, K.slot_update_plain, dev))
        cases.append(case["label"])
    return cases


# q17's partial batch: 262,144 joined store_sales rows, keys (s_state_id
# [0, 50), i_category_id [0, 10)), COUNT(*), SUM(ss_quantity) and the wide
# SUM(ss_ext_wholesale_cost). Its merges: on the default route each map
# task consolidates its 28 partial batches' states (K4); on the sort and
# table routes a partial batch's states pass the merge budget, so nothing
# consolidates and the reducer's FINAL merges all 112 batches' states at
# once (K10 on q17_sort, K12 on q17_table). Each partial batch emits its
# 500 groups in key order. ``run_q17`` holds the paths' merge inputs to
# these shapes.
Q17_SPECS = (("count", 0, ""), ("sum", 0, "int64"), ("sum3", 0, "int64"))
Q17_GROUPS = 500
Q17_TASK_BATCHES = (Q06_ROWS // PARTS + 262143) // 262144  # 28
Q17_MERGE_ROWS = Q17_TASK_BATCHES * Q17_GROUPS
Q17_FINAL_ROWS = PARTS * Q17_MERGE_ROWS


def q17_partial_batch(rng, dev, cap=262144):
    import numpy as np
    import torch

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    keys = [t(rng.integers(0, 50, cap)), t(rng.integers(0, 10, cap))]
    x = rng.integers(10 ** 14, 9 * 10 ** 16, cap)
    limbs = (t(x & LO32), t(x >> 32), t(np.zeros(cap, np.int64)))
    args = [(torch.zeros(cap, dtype=torch.int64, device=dev), ones),
            (t(rng.integers(1, 100, cap)), ones), (limbs, ones)]
    return keys, [ones, ones], Q17_SPECS, args


def q17_merge_input(rng, dev, rows):
    """A q17 merge input of ``rows`` state rows (``rows / 500`` partial
    batches' states, each batch's 500 groups in key order) in its capacity
    bucket: count, qty sum + has, wcost limbs + has."""
    import numpy as np
    import torch
    from blaze_tpu_torch.config import Config

    cap = Config().capacity_for(rows)
    live = np.arange(cap) < rows

    def pad(x, dt=np.int64):
        out = np.zeros(cap, dt)
        out[:rows] = x
        return torch.from_numpy(out).to(dev)

    g = np.tile(np.arange(Q17_GROUPS), rows // Q17_GROUPS)
    lv = torch.from_numpy(live).to(dev)
    keys = [pad(g // 10), pad(g % 10)]
    has = pad(np.ones(rows, bool), np.bool_)
    # a batch's group sum of wcost: ~524 rows of < 9 * 10^16, past int64
    states = [[(pad(rng.integers(1, 1000, rows)), lv)],
              [(pad(rng.integers(1, 50_000, rows)), lv), (has, lv)],
              [(pad(rng.integers(0, 1 << 32, rows)), lv),
               (pad(rng.integers(0, 1 << 32, rows)), lv), (pad(rng.integers(0, 3, rows)), lv),
               (has, lv)]]
    return keys, [lv, lv], ("count", "sum", "sum3"), states


def seg_cust_shapes(dev, rng):
    """K10's limb partial at cust_spend_noskip's sorted batches: 262,144
    rows of an int32 customer key over SF100's 2,000,000 customers (~1.07
    rows a group), a sum2 state; with the 1% null keys, which sort into one
    segment of ~2,600 rows, and without them."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    shapes = {}
    kd_np, kv_np, specs, args_np = cust_spend_batch(rng)
    for label, nulls in (("cust_spend_noskip batch: 262144 rows, 1% null keys", True),
                         ("cust_spend_noskip batch without null keys", False)):
        kv = kv_np[0] if nulls else np.ones_like(kv_np[0])
        kd = kd_np[0] if nulls else np.where(
            kv_np[0], kd_np[0], rng.integers(1, CUST_SKS + 1, len(kv))).astype(np.int32)
        keys = [torch.from_numpy(kd).to(dev)]
        kvalids = [torch.from_numpy(kv).to(dev)]
        args = [(torch.from_numpy(d).to(dev), torch.from_numpy(v).to(dev))
                for d, v in args_np]
        cap = n = keys[0].shape[0]
        exists = torch.ones(cap, dtype=torch.bool, device=dev)
        order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
        g = int(count)
        ops, emits = A._partial_program(specs, args)
        k10 = lambda: K.segment_reduce_cuda("seg_agg_partial", order, starts,  # noqa: E731
                                            count, n, ops, emits, ("sum2",))
        plain = lambda: K.segment_reduce_plain(order, starts, count, n, ops,  # noqa: E731
                                               emits)
        check_equal("seg_agg_partial:limbs", label, k10(), plain())
        new = torch.zeros(n, dtype=torch.bool, device=dev)
        new[starts[:g]] = True
        seg_row = torch.empty(n, dtype=torch.int64, device=dev)
        seg_row[order] = torch.cumsum(new.to(torch.int64), 0) - 1
        src = args[0][0]
        srcs = [src & LO32, src >> 32, torch.ones(cap, dtype=torch.int64, device=dev)]
        tabs = torch.zeros((3, cap), dtype=torch.int64, device=dev)

        def lib():
            for t, x in zip(tabs, srcs):
                t.index_add_(0, seg_row, x)

        lens = (starts[1:g + 1] - starts[:g])
        shapes[label] = dict(shape_times(k10, plain, lib, seg_reduce_bytes(n, g, ops, emits)),
                             segments=g, longest_segment=int(lens.max()),
                             library_call="3x index_add_ into the segment tables (segment "
                                          "ids and the limb split given: a chain)")
    return shapes


def time_limbs(dev, rng, results, cases):
    """The limb halves timed at q17's shapes beside their plain versions,
    a chain of PyTorch library calls computing the same sums (slot or
    segment ids given) and the bytes they must move."""
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.ops import agg_device as A

    conf = Config()
    keys, kvalids, specs, args = q17_partial_batch(rng, dev)
    cap = n = keys[0].shape[0]
    kd = [torch.int64, torch.int64]
    bases, sizes, out_cap = A.plan_slot_table(A.probe_ranges(keys, kvalids), cap, None,
                                              conf.dense_agg_max_buckets, conf)
    check_equal("slot_agg_partial:limbs", "q17 batch",
                A.slot_agg_partial(keys, kvalids, kd, n, bases, sizes, specs, args, out_cap),
                A.slot_agg_partial_plain(keys, kvalids, kd, n, bases, sizes, specs, args,
                                         out_cap))
    S = sizes[0] * sizes[1]
    slot = (keys[0] - bases[0] + 1) * sizes[1] + (keys[1] - bases[1] + 1)
    planes = [torch.ones(cap, dtype=torch.int64, device=dev), args[1][0], *args[2][0]]
    tabs = torch.zeros((len(planes), S), dtype=torch.int64, device=dev)

    def chain(tables, ids, srcs):
        for t, s in zip(tables, srcs):
            t.index_add_(0, ids, s)

    # the rows' keys (8 + 1 bytes each), qty and the three limbs (8 bytes
    # each + one validity byte a column) read once; a group's two keys, its
    # count, qty sum + has, three limbs + has written once
    row_bytes, group_bytes = 2 * 9 + 9 + 25, 2 * 9 + 8 + 9 + 25
    groups = Q17_GROUPS
    six = wide_case(("six limb kinds", ("i64", "i64"), cap, cap, 0.0, 0.0, (0, 10), "q17"),
                    rng)
    sk, sv, sspecs, sargs = wide_torch(six, dev)
    sb, ss, so = A.plan_slot_table(A.probe_ranges(sk, sv), cap, None,
                                   conf.dense_agg_max_buckets, conf)
    results.append(dict(
        name="slot_agg_partial:limbs", route="cuda", source="blaze_tpu_torch/csrc/slot_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1288",
        shape=f"262144 rows -> {S} slots, <= 500 groups (a q17 batch: COUNT, SUM int64, "
              "SUM decimal(38,2) as three limbs)",
        cases=cases, ms=time_ms(lambda: A.slot_agg_partial(keys, kvalids, kd, n, bases, sizes,
                                                            specs, args, out_cap)),
        plain_ms=time_ms(lambda: A.slot_agg_partial_plain(keys, kvalids, kd, n, bases, sizes,
                                                          specs, args, out_cap)),
        library_ms=time_ms(lambda: chain(tabs, slot, planes)),
        library_call="5x index_add_ into the slot tables (slot ids given; a chain)",
        bytes=n * row_bytes + groups * group_bytes,
        six_kinds_ms=time_ms(lambda: A.slot_agg_partial(sk, sv, kd, cap, sb, ss, sspecs,
                                                         sargs, so)),
        device_ms=kernel_device_ms(lambda: A.slot_agg_partial(
            keys, kvalids, kd, n, bases, sizes, specs, args, out_cap), OURS),
        library_device_ms=kernel_device_ms(lambda: chain(tabs, slot, planes), "")))
    # K10 over the same batch (its reduction: the permutation read too)
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    order, starts, count, _keys = K.segment_ids(keys, kvalids, exists, n)
    ops, emits = A._partial_program(specs, args)
    check_equal("seg_agg_partial:limbs", "q17 batch",
                K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n, ops, emits,
                                      ("sum3",)),
                K.segment_reduce_plain(order, starts, count, n, ops, emits))
    new = torch.zeros(n, dtype=torch.bool, device=dev)
    g10 = int(count)
    new[starts[:g10]] = True
    seg_row = torch.empty(n, dtype=torch.int64, device=dev)
    seg_row[order] = torch.cumsum(new.to(torch.int64), 0) - 1
    stabs = torch.zeros((len(planes), cap), dtype=torch.int64, device=dev)
    results.append(dict(
        name="seg_agg_partial:limbs", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1173",
        shape=f"262144 rows -> {g10} segments (a q17 batch on the sort route: COUNT, SUM "
              "int64, SUM decimal(38,2) as three limbs)",
        cases=cases,
        ms=time_ms(lambda: K.segment_reduce_cuda("seg_agg_partial", order, starts, count, n,
                                                 ops, emits, ("sum3",))),
        plain_ms=time_ms(lambda: K.segment_reduce_plain(order, starts, count, n, ops, emits)),
        library_ms=time_ms(lambda: chain(stabs, seg_row, planes)),
        library_call="5x index_add_ into the segment tables (segment ids given; a chain)",
        bytes=n * (row_bytes - 18 + 8) + (g10 + 1) * 8 + g10 * (group_bytes - 18 + 8),
        route_ms=time_ms(lambda: A.seg_agg_partial(keys, kvalids, n, specs, args)),
        device_ms=kernel_device_ms(lambda: K.segment_reduce_cuda(
            "seg_agg_partial", order, starts, count, n, ops, emits, ("sum3",)), OURS),
        library_device_ms=kernel_device_ms(lambda: chain(stabs, seg_row, planes), ""),
        shapes={**seg_cust_shapes(dev, rng),
                "one segment of 262144 rows (q17's program)": seg_one_segment(
                    dev, rng, keys, kvalids, specs, args)}))
    # a state row's keys, count, qty sum + has, three limbs + has (each with
    # its validity byte) read once; a group written once
    mrow_bytes = 2 * 9 + 9 + 9 + 2 + 27 + 2
    # K4: q17's consolidation of a map task's partial batches
    mk, mv, kinds, states = q17_merge_input(rng, dev, Q17_MERGE_ROWS)
    rows, mcap = Q17_MERGE_ROWS, mk[0].shape[0]
    mb, ms_, mo = A.plan_slot_table(A.probe_ranges(mk, mv), mcap, None,
                                    conf.radix_agg_max_slots, conf)
    check_equal("slot_agg_merge:limbs", "q17 consolidation",
                A.slot_agg_merge(mk, mv, kd, rows, mb, ms_, kinds, states, mo),
                A.slot_agg_merge_plain(mk, mv, kd, rows, mb, ms_, kinds, states, mo))
    mslot = (mk[0] - mb[0] + 1) * ms_[1] + (mk[1] - mb[1] + 1)
    msrc = [states[0][0][0], states[1][0][0], states[2][0][0], states[2][1][0],
            states[2][2][0]]
    mtabs = torch.zeros((5, ms_[0] * ms_[1]), dtype=torch.int64, device=dev)
    results.append(dict(
        name="slot_agg_merge:limbs", route="cuda", source="blaze_tpu_torch/csrc/slot_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1421",
        shape=f"{rows} state rows -> {groups} groups (q17's consolidation of a map task's "
              f"{Q17_TASK_BATCHES} partial batches: COUNT, SUM, three-limb SUM)",
        cases=cases, ms=time_ms(lambda: A.slot_agg_merge(mk, mv, kd, rows, mb, ms_, kinds,
                                                         states, mo)),
        plain_ms=time_ms(lambda: A.slot_agg_merge_plain(mk, mv, kd, rows, mb, ms_, kinds,
                                                        states, mo)),
        library_ms=time_ms(lambda: chain(mtabs, mslot, msrc)),
        library_call="5x index_add_ into the slot tables (slot ids given; a chain)",
        bytes=rows * mrow_bytes + groups * group_bytes,
        device_ms=kernel_device_ms(lambda: A.slot_agg_merge(mk, mv, kd, rows, mb, ms_, kinds,
                                                            states, mo), OURS),
        library_device_ms=kernel_device_ms(lambda: chain(mtabs, mslot, msrc), "")))
    # K10 and K12: the reducer's FINAL merge of every partial batch's states
    # (q17_sort's and q17_table's; neither consolidates)
    fk, fv, kinds, fstates = q17_merge_input(rng, dev, Q17_FINAL_ROWS)
    frows, fcap = Q17_FINAL_ROWS, fk[0].shape[0]
    fexists = torch.arange(fcap, device=dev) < frows
    forder, fstarts, fcount, _keys = K.segment_ids(fk, fv, fexists, frows)
    fops, femits = A._merge_program(kinds, fstates)
    check_equal("seg_agg_merge:limbs", "q17 FINAL",
                K.segment_reduce_cuda("seg_agg_merge", forder, fstarts, fcount, frows, fops,
                                      femits, ("sum3",)),
                K.segment_reduce_plain(forder, fstarts, fcount, frows, fops, femits))
    fnew = torch.zeros(frows, dtype=torch.bool, device=dev)
    fnew[fstarts[:int(fcount)]] = True
    fseg = torch.full((fcap,), fcap, dtype=torch.int64, device=dev)
    fseg[forder[:frows]] = torch.cumsum(fnew.to(torch.int64), 0) - 1
    fsrc = [fstates[0][0][0], fstates[1][0][0], fstates[2][0][0], fstates[2][1][0],
            fstates[2][2][0]]
    fstabs = torch.zeros((5, fcap + 1), dtype=torch.int64, device=dev)
    results.append(dict(
        name="seg_agg_merge:limbs", route="cuda", source="blaze_tpu_torch/csrc/seg_agg.cu",
        replaces="blaze_tpu/ops/agg_device.py:1355",
        shape=f"{frows} state rows -> {int(fcount)} segments (q17_sort's FINAL merge of "
              f"{PARTS * Q17_TASK_BATCHES} partial batches' states: COUNT, SUM, three-limb "
              "SUM)",
        cases=cases,
        ms=time_ms(lambda: K.segment_reduce_cuda("seg_agg_merge", forder, fstarts, fcount,
                                                 frows, fops, femits, ("sum3",))),
        plain_ms=time_ms(lambda: K.segment_reduce_plain(forder, fstarts, fcount, frows, fops,
                                                        femits)),
        library_ms=time_ms(lambda: chain(fstabs, fseg, fsrc)),
        library_call="5x index_add_ into the segment tables (segment ids given; a chain)",
        bytes=frows * (mrow_bytes - 18 + 8) + groups * (8 + group_bytes - 18 + 8),
        device_ms=kernel_device_ms(lambda: K.segment_reduce_cuda(
            "seg_agg_merge", forder, fstarts, fcount, frows, fops, femits, ("sum3",)), OURS),
        library_device_ms=kernel_device_ms(lambda: chain(fstabs, fseg, fsrc), "")))


# -- K14: range-partition ids -------------------------------------------------------

# the sort10M map batch's keys: ss_sales_price DESC (decimal(7,2), unscaled
# [0, 50,000)) and ss_item_sk ASC ([1, 2,000)), as bench.py draws them
SORT10M_KEYS = (("price", False, True), ("item", True, True))
RANGE_CASES = (
    # label, keys ((kind, ascending, nulls_first), ...), capacity, live rows,
    # bounds, null share of the rows, null share of the bounds
    ("i64, 1 bound", (("i64", True, True),), 256, 200, 1, 0.1, 0.0),
    ("i64 DESC nulls last, 3 bounds", (("i64", False, False),), 256, 256, 3, 0.2, 0.3),
    ("i32 + f64 DESC, 31 bounds", (("i32", True, False), ("f64", False, True)), 4096, 4000,
     31, 0.1, 0.1),
    ("i16, bool DESC, f32 nulls last: 3 keys, 199 bounds",
     (("i16", True, True), ("bool", False, True), ("f32", True, False)), 4096, 4090, 199, 0.1,
     0.05),
    ("dec, i64 DESC, bool, f64, i32 DESC: 5 keys, 31 bounds",
     (("dec", True, True), ("i64", False, False), ("bool", True, False), ("f64", True, True),
      ("i32", False, True)), 4096, 4096, 31, 0.05, 0.05),
    ("f64 NaN and +-0.0, 3 bounds", (("f64", True, True),), 4096, 4000, 3, 0.05, 0.0),
    ("f64 DESC NaN and +-0.0 nulls last, 31 bounds", (("f64", False, False),), 4096, 4093, 31,
     0.05, 0.1),
    ("f32 NaN and +-0.0 + i8 DESC, 31 bounds", (("f32", True, True), ("i8", False, False)),
     4096, 4096, 31, 0.05, 0.1),
    ("int64 min/max, ASC and DESC, 31 bounds", (("wide", True, True), ("wide", False, True)),
     4096, 4090, 31, 0.05, 0.05),
    ("every bound null, 3 bounds", (("i64", True, True), ("f64", False, False)), 256, 250, 3,
     0.1, 1.0),
    ("dec + i8: 2 keys, 199 bounds", (("dec", False, True), ("i8", True, True)), 262144,
     262100, 199, 0.02, 0.0),
    ("sort10M map batch: price DESC, item, 31 bounds", SORT10M_KEYS, 262144, 262144, 31, 0.0,
     0.0),
    ("5 keys, 1,200 bounds: bounds read from global memory",
     (("i64", True, True), ("f64", False, True), ("i32", True, False), ("bool", False, False),
      ("dec", True, True)), 4096, 4000, 1200, 0.05, 0.05),
    ("padding only: no live row, 3 bounds", (("i64", True, True),), 256, 0, 3, 0.0, 0.0),
    # K14's tails, views and key counts (a last element: every plane a view
    # that many elements into its allocation)
    ("n = 1: i8, 3 bounds, offset 1", (("i8", True, True),), 1, 1, 3, 0.0, 0.0, 1),
    ("n = 3: i32 DESC + f32, 7 bounds, offset 1",
     (("i32", False, True), ("f32", True, False)), 3, 3, 7, 0.2, 0.1, 1),
    ("n = 4: bool + i16 DESC + f64, 31 bounds, offset 1",
     (("bool", True, True), ("i16", False, False), ("f64", True, True)), 4, 3, 31, 0.2, 0.1,
     1),
    ("n = 5: 5 keys, no bound, offset 3",
     (("i64", True, True), ("f64", False, True), ("i32", True, False), ("bool", False, False),
      ("dec", True, True)), 5, 5, 0, 0.2, 0.0, 3),
    ("n = 255: f64 DESC nulls last, 199 bounds, offset 1", (("f64", False, False),), 255, 250,
     199, 0.1, 0.05, 1),
    ("n = 1,023: i64 + dec DESC, 31 bounds, offset 1",
     (("i64", True, True), ("dec", False, False)), 1023, 1000, 31, 0.1, 0.1, 1),
    ("n = 262,145: sort10M's keys, 31 bounds, offset 1", SORT10M_KEYS, 262145, 262145, 31, 0.0,
     0.0, 1),
    ("16 keys, 400 bounds: bounds read from global memory",
     tuple((kind, c % 2 == 0, c % 3 != 0) for c, kind in enumerate(
         ("i64", "f64", "i32", "bool", "dec", "f32", "i16", "i8", "wide", "i64", "f64", "i32",
          "bool", "dec", "f32", "i16"))), 1024, 1000, 400, 0.1, 0.1),
)
RANGE_FLOAT_SPECIALS = (0.0, -0.0, float("nan"), float("inf"), float("-inf"))
RANGE_NPDT = {"i64": "int64", "wide": "int64", "dec": "int64", "price": "int64",
              "item": "int64", "i32": "int32", "i16": "int16", "i8": "int8", "bool": "bool",
              "f32": "float32", "f64": "float64"}


def range_values(kind, n, rng):
    """``n`` values of a key kind, with ties: small integers, bools, floats
    on a 0.5 grid with NaN, +-0.0 and +-inf mixed in, decimal(7,2)
    unscaled, int64 near both extremes, or sort10M's price and item."""
    import numpy as np

    npdt = np.dtype(RANGE_NPDT[kind])
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind in ("f32", "f64"):
        v = rng.integers(-8, 9, n) * 0.5
        special = rng.random(n) < 0.1
        v[special] = rng.choice(RANGE_FLOAT_SPECIALS, int(special.sum()))
        return v.astype(npdt)
    if kind == "wide":
        lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
        return rng.choice(np.array([lo, lo + 1, lo + 2, -1, 0, 1, hi - 2, hi - 1, hi]), n)
    lo, hi = {"i64": (-40, 40), "i32": (-1000, 1000), "i16": (-300, 300), "i8": (-128, 128),
              "dec": (0, 50_000), "price": (0, 50_000), "item": (1, 2_000)}[kind]
    return rng.integers(lo, hi, n).astype(npdt)


def range_case(case, rng):
    """numpy planes of one RANGE_CASES entry, honouring the padding
    contract: {label, datas, valids, exists (capacity-long), bdatas,
    bvalids (one row a bound, in draw order), spec}."""
    import numpy as np

    label, keys, cap, n, nb, nulls, bnulls, *offset = case
    datas, valids, bdatas, bvalids = [], [], [], []
    for kind, _asc, _nf in keys:
        d = np.zeros(cap, RANGE_NPDT[kind])
        v = np.zeros(cap, bool)
        d[:n] = range_values(kind, n, rng)
        v[:n] = rng.random(n) >= nulls
        d[~v] = 0
        bv = rng.random(nb) >= bnulls
        bd = np.where(bv, range_values(kind, nb, rng), np.zeros((), d.dtype))
        datas.append(d)
        valids.append(v)
        bdatas.append(bd)
        bvalids.append(bv)
    return {"label": label, "datas": datas, "valids": valids, "exists": np.arange(cap) < n,
            "bdatas": bdatas, "bvalids": bvalids,
            "spec": tuple((asc, nf) for _k, asc, nf in keys),
            "offset": offset[0] if offset else 0}


def range_tensors(case, dev):
    """A battery case's (datas, valids, exists, bound datas, bound valids)
    on ``dev``; the row planes views ``offset`` elements into their
    allocations."""
    import numpy as np
    import torch

    off = case.get("offset", 0)

    def view(x):
        return torch.from_numpy(np.concatenate([np.zeros(off, x.dtype), x])).to(dev)[off:]

    return ([view(x) for x in case["datas"]], [view(x) for x in case["valids"]],
            view(case["exists"]), [torch.from_numpy(x).to(dev) for x in case["bdatas"]],
            [torch.from_numpy(x).to(dev) for x in case["bvalids"]])


def range_run(case, fn, dev, bound_ops=None):
    """One battery case through ``fn`` (K14's wrapper or its twin, or
    ``range_partition_order``) on ``dev``, over the bounds as
    ``range_bound_operands`` sorts them (or ``bound_ops``)."""
    from blaze_tpu_torch.core import kernels as K

    datas, valids, exists, bdatas, bvalids = range_tensors(case, dev)
    if bound_ops is None:
        bound_ops = K.range_bound_operands(bdatas, bvalids, case["spec"])
    return fn(datas, valids, exists, bound_ops, case["spec"])


def range_routes(case, dev):
    """K14's ids of a battery case on every route its bounds allow (the
    count and the search over the staged tree where it fits in
    RANGE_SMEM_BYTES, the search in global memory always), each through a
    pack of its own, and the twin's ids: ({route: ids}, twin ids)."""
    from blaze_tpu_torch.core import kernels as K

    datas, valids, exists, bdatas, bvalids = range_tensors(case, dev)
    ops = K.range_bound_operands(bdatas, bvalids, case["spec"])
    staged = K.range_tree_staged(len(datas), int(ops[0].shape[0]))
    out = {}
    for name, route in (("count", K.RANGE_COUNT), ("search", K.RANGE_SEARCH),
                        ("global", K.RANGE_GLOBAL)):
        if staged or route == K.RANGE_GLOBAL:
            pack = K.RangePack(ops, case["spec"], [d.dtype for d in datas], route=route)
            out[name] = pack.launch(datas, valids, exists)
    return out, K.range_partition_ids_plain(datas, valids, exists, ops, case["spec"])


def kernel_device_ms(fn, prefix, iters=ITERS):
    """The device time of one call's kernels whose names hold ``prefix``
    (or any of a tuple of them; "" takes every kernel, copy and memset)
    (torch.profiler over ``iters`` calls after a warm-up): the
    kernel alone, without the host's time between launches that CUDA
    events over back-to-back calls also count; None when the profiler
    recorded no time for such a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prefixes = (prefix,) if isinstance(prefix, str) else tuple(prefix)
    fn()
    torch.cuda.synchronize()
    total = 0
    # the profiler can lose a kernel's records: a window whose every
    # kernel's count is not a multiple of the calls is taken again (three
    # windows at most; a lost record only lowers a window's sum)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ours = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and any(p in e.key for p in prefixes)]
        window = sum(e.self_device_time_total for e in ours)
        total = max(total, window)
        if ours and all(e.count % iters == 0 for e in ours):
            total = window
            break
    # no kernel time recorded (torch.profiler sometimes keeps none of a
    # session's kernels): not measured, rather than 0
    return total / 1e3 / iters if total > 0 else None


def call_kernels(fn, calls=10):
    """The device kernels and memsets of one call of ``fn``, by name with
    their launches a call: torch.profiler over ``calls`` calls after a
    warm-up, each name's count over the calls, rounded. The profiler can
    lose records (on the card's machine often the window's first launch),
    which the rounding absorbs; a window that recorded nothing is taken
    again (five windows at most; {} when every one was empty)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: round(e.count / calls) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0}
        if counts:
            return {k: c for k, c in counts.items() if c > 0}
    return {}


# K14's bound counts timed on both routes at sort10M's map batch (the
# crossover RANGE_COUNT_MAX_BOUNDS is chosen from them)
K14_ROUTE_BOUNDS = (3, 7, 15, 31, 63, 199)
# K14's timed shapes: (keys, bounds, live rows, capacity, one row a value):
# sort10M's map batch at 31 and 199 bounds, one ascending key (beside
# torch.searchsorted), hash_sample's ORDER BY ss_store_sk (the range
# exchange over its ~102 aggregated rows, one int32 store key a row, into
# 4 partitions)
K14_SHAPES = ((SORT10M_KEYS, 31, 262144, 262144, False),
              (SORT10M_KEYS, 199, 262144, 262144, False),
              ((("item", True, True),), 31, 262144, 262144, False),
              ((("i32", True, True),), PARTS - 1, HS_STORES, 256, True))


def k14_shape(keys, nb, rows, cap, distinct, rng, dev):
    """One timed K14 shape on ``dev``: bounds drawn as the path samples
    them (quantiles of the rows), a pack made once as the partitioner
    makes it, K14's call through it and the twin's; a dict of both calls,
    the bound bytes (each key's data and validity and the exists byte read
    once, a 4-byte id written), the planes, bound operands and spec."""
    import numpy as np
    from blaze_tpu_torch.core import kernels as K

    case = range_case(("timed", keys, cap, rows, 0, 0.0, 0.0), rng)
    if distinct:  # one row a value, as after a GROUP BY of the key
        case["datas"][0][:rows] = rng.permutation(np.arange(1, rows + 1))
    live = np.lexsort([d[:rows] if asc else -d[:rows] for d, (_k, asc, _nf) in
                       zip(case["datas"][::-1], keys[::-1])])
    picks = live[(np.arange(1, nb + 1) * len(live)) // (nb + 1)]
    case["bdatas"] = [d[picks] for d in case["datas"]]
    case["bvalids"] = [np.ones(nb, bool) for _ in keys]
    datas, valids, ex, bdatas, bvalids = range_tensors(case, dev)
    ops = K.range_bound_operands(bdatas, bvalids, case["spec"])
    pack = K.RangePack(ops, case["spec"], [d.dtype for d in datas])

    def k14():
        return K.range_partition_ids_cuda(datas, valids, ex, ops, case["spec"], pack)

    def plain():
        return K.range_partition_ids_plain(datas, valids, ex, ops, case["spec"])

    check_equal("range_partition", f"timed, {len(keys)} keys, {nb} bounds", k14(), plain())
    return dict(k14=k14, plain=plain, datas=datas, valids=valids, ex=ex, ops=ops,
                spec=case["spec"], rows=rows,
                nbytes=cap * (sum(d.element_size() + 1 for d in datas) + 1 + 4))


def kernel_k14(dev, rng, results):
    """K14 against its twin on RANGE_CASES, on every route the bounds allow
    (views at odd element offsets, tails of 1 to 3 rows, 1 to 16 keys,
    0 to 1,200 bounds), then timed at four shapes (sort10M's map batch at
    31 and 199 bounds, one ascending key against torch.searchsorted,
    hash_sample's store exchange) through one pack a shape, as the
    partitioner calls it, with device ms and the wrapper's host ms; and
    each route's device ms at K14_ROUTE_BOUNDS bounds."""
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for spec in RANGE_CASES:
        case = range_case(spec, rng)
        want = range_run(case, K.range_partition_ids_plain, dev)
        check_equal("range_partition", case["label"],
                    range_run(case, K.range_partition_ids_cuda, dev), want)
        routes, twin = range_routes(case, dev)
        for route, got in routes.items():
            check_equal("range_partition", f"{case['label']} ({route})", got, twin)
        cases.append(case["label"])

    labels = ("sort10M's map batch: 262,144 rows, ss_sales_price DESC and ss_item_sk ASC "
              "(two int64 keys, no nulls), 31 bounds (32 partitions)",
              "the same batch, 199 bounds", "262,144 rows, ss_item_sk ASC, 31 bounds",
              "hash_sample's ORDER BY: 102 of 256 rows, ss_store_sk (int32) ASC, 3 bounds")
    made = dict(zip(labels, [k14_shape(*args, rng, dev) for args in K14_SHAPES]))
    # the host ms first, before this phase's profiler sessions (a process
    # that has run torch.profiler launches slower from then on)
    shapes = {label: dict(host_ms=host_ms(m["k14"]), rows=m["rows"])
              for label, m in made.items()}
    for label, m in made.items():
        shapes[label].update(shape_times(m["k14"], m["plain"], None, m["nbytes"]),
                             call_kernels=call_kernels(m["k14"]))
    # one valid ascending key: bisect_right is torch.searchsorted over the
    # sorted bound values
    one = made[labels[2]]
    bvals = one["ops"][1].contiguous()
    keys0 = one["datas"][0][:one["rows"]]
    got = torch.searchsorted(bvals, keys0, right=True).to(torch.int32)
    if not torch.equal(got, one["k14"]()[:one["rows"]]):
        raise AssertionError("torch.searchsorted differs from K14 on one valid key")
    shapes[labels[2]].update(
        library_call="torch.searchsorted(bounds, keys, right=True)",
        library_ms=time_ms(lambda: torch.searchsorted(bvals, keys0, right=True)),
        library_device_ms=kernel_device_ms(
            lambda: torch.searchsorted(bvals, keys0, right=True), ""))
    for label in shapes:
        log(json.dumps({"phase": "k14_shape", "shape": label, **shapes[label]}))
    # each route's device ms at sort10M's map batch, by bound count
    route_ms = {}
    for nb in K14_ROUTE_BOUNDS:
        m = k14_shape(SORT10M_KEYS, nb, 262144, 262144, False, rng, dev)
        for name, route in (("count", K.RANGE_COUNT), ("search", K.RANGE_SEARCH)):
            pack = K.RangePack(m["ops"], m["spec"], [d.dtype for d in m["datas"]], route=route)
            check_equal("range_partition", f"timed, {nb} bounds ({name})",
                        pack.launch(m["datas"], m["valids"], m["ex"]), m["plain"]())
            route_ms[f"{name}, {nb} bounds"] = kernel_device_ms(
                lambda pack=pack, m=m: pack.launch(m["datas"], m["valids"], m["ex"]),
                "blz_range_partition")
    log(json.dumps({"phase": "k14_routes", "device_ms": route_ms,
                    "count_max_bounds": K.RANGE_COUNT_MAX_BOUNDS}))
    main = shapes[labels[0]]
    results.append(dict(
        name="range_partition", route="cuda", source="blaze_tpu_torch/csrc/range_part.cu",
        replaces="blaze_tpu/core/kernels.py:321", shape=labels[0], cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=None,
        library_call="none for two keys: torch.searchsorted takes one sorted key "
                     f"({labels[2]}, in shapes)",
        call_kernels=main["call_kernels"], bytes=main["bytes"], shapes=shapes,
        route_ms=route_ms))


# -- K15: the XXH64 row hash ------------------------------------------------------

XXH_LANES = ("i8", "i16", "i32", "i64", "date", "ts", "bool", "f32", "f64", "d72", "d180")
# K15's timed shapes: hash_sample's batch (ss_item_sk, ss_ticket_number:
# two int32 keys, no nulls) and q69_bloom's store_sales batch
# (ss_customer_sk: int64, 4% null, as make_q69_data stages it)
XXH_HASH_SAMPLE = ("hash_sample's two int32 keys", ("i32", "i32"), 262144, 262144, 0.0, 0)
XXH_Q69_BLOOM = ("q69_bloom's ss_customer_sk: one int64, 4% null", ("i64",), 262144, 262144,
                 0.04, 0)
XXH_CASES = tuple(
    # label, lanes, capacity, live rows, null share, element offset of
    # every plane (a view that far into its allocation); each lane's plane
    # at its own width
    [(f"{lane}, padding, 15% null", (lane,), 16, 13, 0.15, 0) for lane in XXH_LANES] + [
        ("eight columns, 15% null", XXH_LANES[:8], 262144, 262144, 0.15, 0),
        ("f64 + decimals + i32, no nulls, padding", ("f64", "d72", "d180", "i32"), 262144,
         262000, 0.0, 0),
        ("floats, every value null, padding", ("f64", "f32"), 262144, 200000, 1.0, 0),
        XXH_HASH_SAMPLE,
        ("one i64, no live row", ("i64",), 16, 0, 0.0, 0),
        ("one i8, n = 1, offset 1", ("i8",), 4, 1, 0.0, 1),
        ("i32 + d72, n = 3, offset 1", ("i32", "d72"), 8, 3, 0.3, 1),
        ("f32, n = cap = 4, offset 1", ("f32",), 4, 4, 0.1, 1),
        ("i16 + bool + d182, n = cap = 5, offset 3", ("i16", "bool", "d182"), 5, 5, 0.2, 3),
        ("every lane (11 columns), n = 255, offset 1", XXH_LANES, 256, 255, 0.1, 1),
        ("nine columns, n = 1,023, offset 1", XXH_LANES[:8] + ("d182",), 1024, 1023, 0.15,
         1),
        ("32 columns, n = 1,023 of 1,030, offset 1", (XXH_LANES * 3)[:32], 1030, 1023, 0.1,
         1),
        ("two i32, n = cap = 262,145, offset 1", ("i32", "i32"), 262145, 262145, 0.0, 1),
        XXH_Q69_BLOOM,
    ])
# Spark's documented example (the SQL reference of xxhash64): xxhash64('Spark',
# array(123), 2) = 5602566077635097486. Spark hashes a string's UTF-8 bytes,
# then each array element, then the int, each seeding the next; a byte and a
# short hash as hashInt of the value, so the row [123, 2] as int8 + int16,
# as int32 + int16 or as int8 + int32 from the bytes' hash gives the same
XXH_SPARK_DOC = (b"Spark", (123, 2), 5602566077635097486)
XXH_F32_BITS = (0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001)  # NaN payloads
XXH_F64_BITS = (0x7FF8000000000000, 0x7FF8000000000001, 0xFFF8000000000000,
                0x7FF0000000000001)


def xxh_lane_type(T, lane):
    return {"i8": T.I8, "i16": T.I16, "i32": T.I32, "i64": T.I64, "date": T.DATE,
            "ts": T.TIMESTAMP, "bool": T.BOOL, "f32": T.F32, "f64": T.F64,
            "d72": T.DecimalType(7, 2), "d180": T.DecimalType(18, 0),
            "d182": T.DecimalType(18, 2)}[lane]


def xxh_values(lane, cap, rng):
    """``cap`` numpy values of one lane, the lane's edge values mixed in
    (integer extremes, -1 and 0; -0.0, +-inf and NaNs of four payloads for
    the floats)."""
    import numpy as np

    def mix(vals, special):
        pick = rng.random(cap) < 0.2
        vals[pick] = np.asarray(special, dtype=vals.dtype)[
            rng.integers(0, len(special), int(pick.sum()))]
        return vals

    if lane in ("i8", "i16", "i32", "i64"):
        info = np.iinfo(lane.replace("i", "int"))
        vals = rng.integers(info.min, info.max, cap, dtype=info.dtype, endpoint=True)
        return mix(vals, [info.min, info.max, -1, 0])
    if lane == "date":
        return mix(rng.integers(-100_000, 100_000, cap).astype(np.int32), [0, -1])
    if lane == "ts":
        return mix(rng.integers(-10 ** 16, 10 ** 16, cap), [0, -1, 1])
    if lane == "bool":
        return rng.random(cap) < 0.5
    if lane in ("f32", "f64"):
        dt, it = (np.float32, np.uint32) if lane == "f32" else (np.float64, np.uint64)
        bits = XXH_F32_BITS if lane == "f32" else XXH_F64_BITS
        special = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -2.5], dt),
                                  np.array(bits, it).view(dt)])
        return mix((rng.standard_normal(cap) * 1e3).astype(dt), special)
    bound = 10 ** (7 if lane == "d72" else 18)  # decimal(7,2), decimal(18,0 or 2)
    return mix(rng.integers(-bound + 1, bound, cap), [bound - 1, -bound + 1, 0])


def xxh_case(case, rng, dev):
    """One battery case as the kernel takes it: (words, validities, kinds,
    n, cap), each column's values in its own plane type turned into hash
    words as ``exprs/spark_hash.py hash_words`` turns them (a bool, int8 or
    int16 plane at its own width), each plane a view ``offset`` elements
    into its allocation; null and padding rows carry data 0."""
    import numpy as np
    import torch
    from blaze_tpu_torch.exprs import spark_hash as H
    from blaze_tpu_torch.ir import types as T

    _label, lanes, cap, n, nulls, off = case
    words, valids, kinds = [], [], []
    for lane in lanes:
        vals = xxh_values(lane, cap, rng)
        v = rng.random(cap) >= nulls
        v[n:] = False
        vals[~v] = 0
        kind = H.hash_kind(xxh_lane_type(T, lane))
        w = H.hash_words(torch.from_numpy(np.concatenate([np.zeros(off, vals.dtype), vals])),
                         kind)
        words.append(w.to(dev)[off:])
        valids.append(torch.from_numpy(np.concatenate([np.zeros(off, bool), v])).to(dev)[off:])
        kinds.append(kind)
    return words, valids, kinds, n, cap


def xxh64_bytes(data: bytes, seed: int) -> int:
    """XXH64 of a short byte string (under 32 bytes, XXH64's tail rounds)
    as Spark's XXH64.hashUnsafeBytes takes it, in Python ints: uint64."""
    m = (1 << 64) - 1
    p1, p2, p3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    p4, p5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    if len(data) >= 32:
        raise ValueError("xxh64_bytes: 32 bytes or more")
    acc, i = (seed + p5 + len(data)) & m, 0
    while i + 8 <= len(data):
        k1 = rotl(int.from_bytes(data[i:i + 8], "little") * p2 & m, 31) * p1 & m
        acc = (rotl(acc ^ k1, 27) * p1 + p4) & m
        i += 8
    if i + 4 <= len(data):
        acc ^= int.from_bytes(data[i:i + 4], "little") * p1 & m
        acc = (rotl(acc, 23) * p2 + p3) & m
        i += 4
    for b in data[i:]:
        acc = rotl(acc ^ (b * p5 & m), 11) * p1 & m
    acc = (acc ^ (acc >> 33)) * p2 & m
    acc = (acc ^ (acc >> 29)) * p3 & m
    return acc ^ (acc >> 32)


def xxh_spark_doc(fn, dev):
    """Spark's documented xxhash64('Spark', array(123), 2) through ``fn``
    (K15's wrapper or its twin, with a seed): the bytes' hash on the host
    seeds the row [123, 2] as int8 + int16, int32 + int16 and int8 +
    int32 planes. Returns the case labels; raises on a difference."""
    import torch

    text, vals, want = XXH_SPARK_DOC
    seed = xxh64_bytes(text, 42)
    ones = torch.ones(1, dtype=torch.bool, device=dev)
    cases = []
    for dts in ((torch.int8, torch.int16), (torch.int32, torch.int16),
                (torch.int8, torch.int32)):
        words = [torch.tensor([v], dtype=dt, device=dev) for v, dt in zip(vals, dts)]
        got = fn(words, [ones, ones], ["i32", "i32"], 1, 4, seed).tolist()
        if got != [want - (1 << 64) if want >= 1 << 63 else want, 0, 0, 0]:
            raise AssertionError(f"xxhash64 Spark's documented example as "
                                 f"{'+'.join(str(d) for d in dts)}: {got}")
        cases.append(f"Spark's xxhash64('Spark', array(123), 2) as "
                     f"{'+'.join(str(d).replace('torch.', '') for d in dts)}")
    return cases


def xxh64_np(words, valids, seed=42):
    """Spark's XXH64 row hash in numpy (uint64 arithmetic, wrapping), the
    4-byte and 8-byte rounds of XXH64 as Spark's hashInt and hashLong take
    them: ``words`` are int64 (8-byte) arrays or bool, int8, int16 or int32
    (4-byte: the value sign-extended to 32 bits) ones, folded in order; a
    null value leaves the running hash unchanged. Returns int64."""
    import numpy as np

    p1, p2, p3 = np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F), \
        np.uint64(0x165667B19E3779F9)
    p4, p5 = np.uint64(0x85EBCA77C2B2AE63), np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    h = np.full(len(words[0]), seed, np.uint64)
    with np.errstate(over="ignore"):
        for w, v in zip(words, valids):
            if w.dtype == np.int64:
                acc = h + p5 + np.uint64(8)
                acc ^= rotl(w.view(np.uint64) * p2, 31) * p1
                acc = rotl(acc, 27) * p1 + p4
            else:  # a bool's 0 / 1, a narrower integer sign-extended
                acc = h + p5 + np.uint64(4)
                acc ^= w.astype(np.int32).view(np.uint32).astype(np.uint64) * p1
                acc = rotl(acc, 23) * p2 + p3
            acc = (acc ^ (acc >> np.uint64(33))) * p2
            acc = (acc ^ (acc >> np.uint64(29))) * p3
            acc ^= acc >> np.uint64(32)
            h = acc if v is None else np.where(v, acc, h)
    return h.view(np.int64)


def kernel_k15(dev, rng, results):
    """K15 against its twin and the numpy XXH64 on XXH_CASES (every lane
    at its own width, nulls, padding, planes at odd element offsets, 1 to
    32 columns, tails of 1 to 3 rows), on Spark's golden longs and its
    documented example with a byte and a short; then timed at
    hash_sample's and q69_bloom's batches with device ms and the wrapper's
    host ms."""
    import numpy as np
    import torch
    from blaze_tpu_torch.exprs import spark_hash as H

    cases = []
    for case in XXH_CASES:
        args = xxh_case(case, rng, dev)
        got = H.xxhash64_rows_cuda(*args)
        check_equal("xxhash64", case[0], got, H.xxhash64_rows_plain(*args))
        words, valids, _kinds, n, _cap = args
        want = xxh64_np([w[:n].cpu().numpy() for w in words],
                        [v[:n].cpu().numpy() for v in valids])
        if n and not np.array_equal(got[:n].cpu().numpy(), want):
            raise AssertionError(f"xxhash64 [{case[0]}] differs from the numpy XXH64")
        cases.append(case[0])
    # Spark's golden vectors (tests/test_spark_hash.py:133): XXH64 of
    # longs, seed 42
    vals = torch.tensor([1, 0, -1, 2 ** 63 - 1, -(2 ** 63)], dtype=torch.int64, device=dev)
    ones = torch.ones(5, dtype=torch.bool, device=dev)
    golden = [-7001672635703045582, -5252525462095825812, 3858142552250413010,
              -3246596055638297850, -8619748838626508300]
    got = H.xxhash64_rows_cuda([vals], [ones], ["i64"], 5, 8).tolist()
    if got != golden + [0, 0, 0]:
        raise AssertionError(f"xxhash64 golden: {got}")
    cases.append("Spark's golden longs")
    cases += xxh_spark_doc(H.xxhash64_rows_cuda, dev)
    # the host ms first, before this phase's profiler sessions (a process
    # that has run torch.profiler launches slower from then on)
    shapes, fns = {}, {}
    for case in (XXH_HASH_SAMPLE, XXH_Q69_BLOOM):
        words, valids, kinds, n, cap = xxh_case(case, rng, dev)
        check_equal("xxhash64", case[0], H.xxhash64_rows_cuda(words, valids, kinds, n, cap),
                    H.xxhash64_rows_plain(words, valids, kinds, n, cap))

        def k15(words=words, valids=valids, kinds=kinds, n=n, cap=cap):
            return H.xxhash64_rows_cuda(words, valids, kinds, n, cap)

        def plain(words=words, valids=valids, kinds=kinds, n=n, cap=cap):
            return H.xxhash64_rows_plain(words, valids, kinds, n, cap)

        # per row each column's word and validity byte read, 8 bytes written
        nbytes = cap * (sum(w.element_size() + 1 for w in words) + 8)
        label = (f"{case[0]}: {cap:,} rows x "
                 f"{'+'.join(str(w.dtype).replace('torch.', '') for w in words)}")
        fns[label] = (k15, plain, nbytes)
        shapes[label] = dict(host_ms=host_ms(k15), rows=n)
    for label, (k15, plain, nbytes) in fns.items():
        shapes[label].update(shape_times(k15, plain, None, nbytes),
                             call_kernels=call_kernels(k15))
        log(json.dumps({"phase": "k15_shape", "shape": label, **shapes[label]}))
    label = next(iter(shapes))
    main = shapes[label]
    results.append(dict(
        name="xxhash64", route="cuda", source="blaze_tpu_torch/csrc/xxhash64.cu",
        replaces="blaze_tpu/exprs/spark_hash.py:230", shape=label, cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=None,
        library_call="none: no single PyTorch call computes Spark XXH64",
        call_kernels=main["call_kernels"], bytes=main["bytes"], shapes=shapes))


# -- K16: the bloom filter's probe -------------------------------------------------


def murmur3_long_np(v, seed):
    """Spark's Murmur3_x86_32 hashLong in numpy (uint32 arithmetic,
    wrapping): the 8 little-endian bytes of int64 ``v``, low word first,
    under uint32 ``seed``s. Returns uint32."""
    import numpy as np

    def rotl(x, r):
        return (x << _u32(r)) | (x >> _u32(32 - r))

    def mix_k1(k):
        return rotl(k * _u32(0xcc9e2d51), 15) * _u32(0x1b873593)

    def mix_h1(h, k):
        return rotl(h ^ k, 13) * _u32(5) + _u32(0xe6546b64)

    u = np.asarray(v).astype(np.int64).view(np.uint64)
    h = mix_h1(np.asarray(seed).astype(np.uint32),
               mix_k1((u & np.uint64(0xffffffff)).astype(np.uint32)))
    h = mix_h1(h, mix_k1((u >> np.uint64(32)).astype(np.uint32)))
    h = h ^ _u32(8)
    h = h ^ (h >> _u32(16))
    h = h * _u32(0x85ebca6b)
    h = h ^ (h >> _u32(13))
    h = h * _u32(0xc2b2ae35)
    return h ^ (h >> _u32(16))


def bloom_np_bits(values, k, bit_size):
    """Spark's bloom bit positions ((n, k) int64) of int64 ``values``:
    h1 = hashLong(v, 0), h2 = hashLong(v, h1); h1 + i*h2 for i = 1..k in
    int32 (wrapping), ~ where negative, mod ``bit_size``."""
    import numpy as np

    h1 = murmur3_long_np(values, np.zeros(len(values), np.uint32))
    h2 = murmur3_long_np(values, h1)
    i = np.arange(1, k + 1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        c = (h1[:, None] + i[None, :] * h2[:, None]).view(np.int32)
    c = np.where(c < 0, ~c, c)
    return c.astype(np.int64) % bit_size


def bloom_np_create(expected_items=1_000_000, num_bits=8_388_608):
    """An empty filter as Spark's BloomFilter.create sizes it: (uint64
    words, k)."""
    import numpy as np

    num_bits = max(64, num_bits)
    k = max(1, round(num_bits / max(expected_items, 1) * np.log(2.0)))
    return np.zeros((num_bits + 63) // 64, np.uint64), k


def bloom_np_put(words, k, values):
    import numpy as np

    if len(values):
        idx = bloom_np_bits(values, k, len(words) * 64).ravel()
        np.bitwise_or.at(words, idx >> 6, np.uint64(1) << (idx & 63).astype(np.uint64))
    return words


def bloom_np_probe(words, k, values):
    """mightContainLong of each value (bool)."""
    import numpy as np

    if not len(values):
        return np.zeros(0, bool)
    idx = bloom_np_bits(values, k, len(words) * 64)
    return ((words[idx >> 6] >> (idx & 63).astype(np.uint64)) & np.uint64(1)).all(axis=1)


def bloom_np_serialize(words, k):
    """Spark's wire format: big-endian version 1, k, word count, words."""
    import struct

    return struct.pack(">iii", 1, k, len(words)) + words.astype(">u8").tobytes()


BLOOM_CASES = (
    # label, k, bit size, capacity, live rows, null share, values put
    ("k=1, 64 bits, padding, 15% null", 1, 64, 4096, 4000, 0.15, 20),
    ("k=2, 192 bits (3 words), padding", 2, 192, 4096, 4001, 0.0, 10),
    ("k=8, 192 bits, padding, 15% null", 8, 192, 256, 200, 0.15, 4),
    ("k=6, 8,388,608 bits, q69's filter, no nulls", 6, 8_388_608, 262144, 262144, 0.0,
     27_389),
    ("k=6, 8,388,608 bits, 15% null, padding", 6, 8_388_608, 262144, 250_000, 0.15, 27_389),
    ("k=8, 67,108,864 bits, 15% null, padding", 8, 67_108_864, 262144, 200_000, 0.15,
     100_000),
    ("k=1, 67,108,864 bits", 1, 67_108_864, 4096, 4096, 0.0, 1_000),
    ("k=6, 8,388,608 bits, no live row", 6, 8_388_608, 16, 0, 0.0, 100),
)
BLOOM_SPECIAL = (-(1 << 63), (1 << 63) - 1, 0, -1)


def bloom_case(case, rng):
    """One battery case in numpy: (values (cap,) int64, words uint64, k,
    bit size). Half the live rows are values put into the filter (hits),
    the rest random int64 (mostly misses), int64 min and max, 0 and -1
    mixed in (and put); null and padding rows carry 0, as the padding
    contract has them, and are probed as any row."""
    import numpy as np

    _label, k, bits, cap, n, nulls, puts = case
    put = rng.integers(-(1 << 63), (1 << 63) - 1, puts, dtype=np.int64, endpoint=True)
    put[:len(BLOOM_SPECIAL)] = BLOOM_SPECIAL
    vals = rng.integers(-(1 << 63), (1 << 63) - 1, cap, dtype=np.int64, endpoint=True)
    members = rng.random(cap) < 0.5
    vals[members] = put[rng.integers(0, puts, int(members.sum()))]
    pick = rng.random(cap) < 0.05
    vals[pick] = np.array(BLOOM_SPECIAL)[rng.integers(0, 4, int(pick.sum()))]
    live = np.arange(cap) < n
    vals[~(live & (rng.random(cap) >= nulls))] = 0
    words = np.zeros(bits // 64, np.uint64)
    bloom_np_put(words, k, put)
    if n:  # values whose combined hash goes negative (flipped by ~)
        h1 = murmur3_long_np(vals[:n], np.zeros(n, np.uint32))
        h2 = murmur3_long_np(vals[:n], h1)
        with np.errstate(over="ignore"):
            neg = ((h1 + h2).view(np.int32) < 0).sum()
        if not neg:
            raise AssertionError(f"bloom case {case[0]}: no negative combined hash")
    return vals, words, k, bits


def kernel_k16(dev, rng, results):
    import numpy as np
    import torch
    from blaze_tpu_torch.ops import bloom as B

    cases = []
    for case in BLOOM_CASES:
        vals, words, k, bits = bloom_case(case, rng)
        v = torch.from_numpy(vals).to(dev)
        w = torch.from_numpy(words.view(np.int64)).to(dev)
        got = B.bloom_probe_cuda(v, w, k, bits)
        check_equal("bloom_probe", case[0], got, B.might_contain_long_plain(v, w, k, bits))
        if not np.array_equal(got.cpu().numpy(), bloom_np_probe(words, k, vals)):
            raise AssertionError(f"bloom_probe [{case[0]}] differs from the numpy probe")
        cases.append(case[0])
    # main path: a store_sales batch of q69_bloom, 262,144 rows probed
    # against the path's 1 MiB filter (k = 6) holding 27,389 keys
    vals, words, k, bits = bloom_case(BLOOM_CASES[3], rng)
    v = torch.from_numpy(vals).to(dev)
    w = torch.from_numpy(words.view(np.int64)).to(dev)

    def k16():
        return B.bloom_probe_cuda(v, w, k, bits)

    results.append(dict(
        name="bloom_probe", route="cuda", source="blaze_tpu_torch/csrc/bloom.cu",
        replaces="blaze_tpu/ops/bloom.py:93",
        shape="a q69_bloom store_sales batch: 262,144 int64 hashes against an "
              "8,388,608-bit (1 MiB) filter, k = 6, ~50% members",
        cases=cases, ms=time_ms(k16), device_ms=kernel_device_ms(k16, "blz_bloom_probe"),
        plain_ms=time_ms(lambda: B.might_contain_long_plain(v, w, k, bits)),
        library_ms=None,
        library_call="none: no single PyTorch call computes Spark's bloom probe",
        # per row 8 bytes of value read and 1 byte written (K16 never
        # reads the validity plane); the bitmap read once
        bytes=262144 * (8 + 1) + words.nbytes))


# -- K17: the device mesh's all-to-all ------------------------------------------------

MESH_NP = {"bool": "bool", "i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64",
           "f32": "float32", "f64": "float64"}
MESH_DTYPES = tuple(MESH_NP)
# sort10M_mesh's planes: item, store, quantity and price (int64 with their
# validity), then the decimal(38,2) cost's three limbs and its validity
SORT10M_MESH_PLANES = ("i64", "bool") * 4 + ("i64", "i64", "i64", "bool")
# (label, slots n, reducers R (None: tile mode), rows a slot, plane kinds,
# null share, empty slots, segment rows scap (0: as MeshBatchExchange sizes
# it), share of rows routed to reducer 0)
MESH_CASES = (
    ("n1 R4", 1, 4, 3000, MESH_DTYPES, 0.1, (), 0, 0.0),
    ("n2 R2", 2, 2, 2500, MESH_DTYPES, 0.1, (), 0, 0.0),
    ("n8 R8", 8, 8, 1000, MESH_DTYPES, 0.15, (), 0, 0.0),
    ("n8 R13, empty slots", 8, 13, 700, MESH_DTYPES, 0.15, (0, 5), 0, 0.0),
    ("n8 R3, skewed, many rounds", 8, 3, 4000, ("i64", "f64", "bool"), 0.05, (2,), 64, 0.9),
    ("n2 R40, rounds of 8 rows", 2, 40, 5000, ("i32", "bool"), 0.0, (), 8, 0.0),
    ("n8, every slot empty", 8, 4, 0, ("i64", "bool"), 0.0, (), 0, 0.0),
    ("tile n1", 1, None, 256, ("i64",) * 3, 0.2, (), 0, 0.0),
    ("tile n2", 2, None, 1, ("i64",) * 3, 0.0, (), 0, 0.0),
    ("tile n8", 8, None, 1024, MESH_DTYPES, 0.2, (), 0, 0.0),
)


# K17 at its segments' edges, each with the element offset of its slot
# planes (views at odd offsets): segments of 7 and 1,030 rows (not a
# multiple of 4; a tile's edge inside a segment) over several rounds,
# segments wholly dead (50 rows into 16 reducers), 80 planes (past the
# by-value pointer table: staged with the counts), 300 planes (a launch
# for each 256), tile mode
K17_EDGE_CASES = (
    (("scap 7, many rounds", 3, 5, 300, ("i64", "i8", "f32"), 0.1, (1,), 7, 0.3), 1),
    (("scap 1030, skewed", 2, 3, 5000, ("i16", "bool"), 0.1, (), 1030, 0.5), 3),
    (("dead segments", 4, 16, 50, ("i64", "i32"), 0.0, (2,), 512, 0.0), 1),
    (("80 planes", 4, 9, 2000, ("i64",) * 40, 0.1, (), 0, 0.0), 0),
    (("300 planes", 2, 3, 300, ("i64", "i8", "i16") * 50, 0.1, (), 0, 0.0), 1),
    (("tile n4, odd views", 4, None, 777, ("i16", "i64", "bool"), 0.2, (), 0, 0.0), 1),
)
# q01_mesh8's first exchange (8 slots, 4 maps of ~399 store keys on slots
# 0-3, 4 reducers: G = 1, Rpad = 8, scap 512): the partial's store key,
# decimal sum, its empty flag and count, each with its validity
Q01_MESH8_SPEC = ("q01_mesh8's exchange", 8, 4, 399, ("i64", "i64", "bool", "i64"), 0.0,
                  (4, 5, 6, 7), 0, 0.0)


def mesh_sectors(case, sizes):
    """The 32-byte sectors round 0's live gathers touch: over every slot and
    plane, the distinct sectors (each fetched once: the floor of a gather's
    reads) and the sectors a warp's gathers request (32 consecutive
    positions of a segment's part a warp instruction, as K17 issues them:
    P = ceil(scap / 992) parts of each segment's live rows; a reducer's
    rows are spread over its slot, so nearly one a row); with the planes'
    element ``sizes``."""
    import numpy as np

    counts, G, scap = case["counts"], case["G"], case["scap"]
    n = case["n"]
    parts = -(-scap // 992)
    starts = np.cumsum(counts, 1) - counts
    per_size = {z: sizes.count(z) for z in set(sizes)}
    distinct = requests = 0
    for s in range(n):
        order = case["routes"][s]
        if order is None:
            continue
        runs = []
        for r in range(n * G):
            live = min(int(counts[s, r]), scap)
            for p in range(parts):
                lo = 0 if p == 0 else live * p // parts // 32 * 32
                hi = live if p + 1 == parts else live * (p + 1) // parts // 32 * 32
                rows = np.full(-(-(hi - lo) // 32) * 32, -1, np.int64)
                rows[:hi - lo] = order[starts[s, r] + lo:starts[s, r] + hi]
                runs.append(rows)
        rows = np.concatenate(runs).reshape(-1, 32)
        for z, planes in per_size.items():
            sec = np.where(rows >= 0, rows * z // 32, -1)
            distinct += planes * np.unique(sec[sec >= 0]).size
            srt = np.sort(sec, axis=1)
            requests += planes * int(((np.diff(srt, axis=1) != 0) & (srt[:, 1:] >= 0)).sum()
                                     + (srt[:, 0] >= 0).sum())
    return {"distinct_sectors": distinct, "distinct_ms": distinct * 32 / HBM_BYTES_PER_S * 1e3,
            "sector_requests": requests,
            "requests_ms": requests * 32 / HBM_BYTES_PER_S * 1e3}


def mesh_values(kind, rows, rng):
    """numpy values of a plane kind: the edge values mixed in (int minimum
    and maximum, NaN, +-0.0, +-inf, subnormals)."""
    import numpy as np

    dt = np.dtype(MESH_NP[kind])
    if kind == "bool":
        return rng.random(rows) < 0.5
    if dt.kind == "f":
        x = (rng.standard_normal(rows) * 100).astype(dt)
        special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40 if kind == "f32"
                            else 5e-324], dtype=dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, rows, dtype=dt, endpoint=True)
        special = np.array([info.min, info.max, 0, -1], dtype=dt)
    pick = rng.random(rows) < 0.1
    x[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    return x


def mesh_case(case, rng):
    """K17's inputs for one MESH_CASES entry, as numpy: per slot its planes
    (each paired with a validity plane: null rows 0, capacity-bucket padding
    0) and route (exchange mode: the stable order of its reducer ids; tile
    mode: the id a row, n where it goes nowhere), and the geometry."""
    import numpy as np

    label, n, R, rows, kinds, nulls, empty, scap, skew = case
    tile = R is None
    kinds = tuple(kinds) if tile else tuple(k for kind in kinds for k in (kind, "bool"))
    slots, routes, pids = [], [], []
    for s in range(n):
        if s in empty or rows == 0:
            slots.append(None)
            routes.append(None)
            pids.append(None)
            continue
        cap = rows if tile else 1 << max(8, (rows - 1).bit_length())
        valid = rng.random(rows) >= nulls
        planes = []
        for i, kind in enumerate(kinds):
            buf = np.zeros(cap, dtype=MESH_NP[kind])
            if not tile and i % 2:      # the validity of the plane before it
                buf[:rows] = valid
            else:
                buf[:rows] = np.where(valid, mesh_values(kind, rows, rng), 0)
            planes.append(buf)
        slots.append(planes)
        if tile:
            pid = np.where(valid, rng.integers(0, n, rows), n).astype(np.int64)
            routes.append(pid)
            pids.append(pid)
        else:
            pid = rng.integers(0, R, rows).astype(np.int32)
            pid[rng.random(rows) < skew] = 0
            routes.append(np.argsort(pid, kind="stable").astype(np.int64))
            pids.append(pid)
    out = {"label": label, "n": n, "kinds": kinds, "slots": slots, "routes": routes,
           "pids": pids}
    if tile:
        out.update(chunk=rows, counts=None, G=1, scap=1, rounds=1)
        return out
    G = -(-R // n)
    counts = np.zeros((n, G * n), np.int64)
    for s, p in enumerate(pids):
        if p is not None:
            counts[s] = np.bincount(p, minlength=G * n)
    maxc = int(counts.max())
    if not scap:
        scap = max(512, -(-maxc // 512) * 512)
    out.update(chunk=G * scap, counts=counts, G=G, scap=scap,
               rounds=max(1, -(-maxc // scap)), R=R)
    return out


def mesh_torch(case, dev, offset=0):
    """(slot planes, routes, plane dtypes) of a mesh case as torch tensors
    on ``dev``; with ``offset``, each plane a view that many elements into
    its allocation."""
    import numpy as np
    import torch

    def plane(p):
        return torch.from_numpy(np.concatenate([np.zeros(offset, p.dtype), p])).to(dev)[offset:]

    planes = [None if sp is None else [plane(p) for p in sp] for sp in case["slots"]]
    routes = [None if r is None else torch.from_numpy(r).to(dev) for r in case["routes"]]
    dtypes = [getattr(torch, {"i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64",
                              "f32": "float32", "f64": "float64", "bool": "bool"}[k])
              for k in case["kinds"]]
    return planes, routes, dtypes


def mesh_run(case, fn, dev, offset=0):
    """Every round of a mesh case through ``fn`` (K17 or its twin): per
    round (planes, live plane, live counts)."""
    planes, routes, dtypes = mesh_torch(case, dev, offset)
    return [fn(planes, routes, case["chunk"], dev, dtypes, case["counts"], case["G"],
               case["scap"], t) for t in range(case["rounds"])]


def mesh_recv_counts(case):
    """The rows each destination slot receives each round, from the count
    matrix (exchange mode)."""
    import numpy as np

    n, G, scap = case["n"], case["G"], case["scap"]
    out = []
    for t in range(case["rounds"]):
        live = np.clip(case["counts"] - t * scap, 0, scap)
        out.append([int(live[:, d * G:(d + 1) * G].sum()) for d in range(n)])
    return out


def mesh_chain(planes, routes, counts, n, G, scap, dev, dtypes):
    """The library yardstick of one exchange round: each slot's send buffer
    of every plane by ``index_select`` and ``where`` over the pack's indices
    (computed once, outside the timing), then the all-to-all as one block
    permute copy a plane."""
    import numpy as np
    import torch

    seg_len = n * G * scap
    sidx, lv = [], []
    starts = np.cumsum(counts, 1) - counts
    for s in range(n):
        src = np.full(seg_len, -1, np.int64)
        if routes[s] is not None:
            order = routes[s].cpu().numpy()
            for r in range(n * G):
                c = min(int(counts[s, r]), scap)
                src[r * scap: r * scap + c] = order[starts[s, r]: starts[s, r] + c]
        sidx.append(torch.from_numpy(np.maximum(src, 0)).to(dev))
        lv.append(torch.from_numpy(src >= 0).to(dev))

    def run():
        outs = []
        for p, dt in enumerate(dtypes):
            zero = torch.zeros((), dtype=dt, device=dev)
            send = torch.stack([
                torch.where(lv[s], torch.index_select(planes[s][p], 0, sidx[s]), zero)
                if planes[s] is not None else torch.zeros(seg_len, dtype=dt, device=dev)
                for s in range(n)])
            outs.append(send.view(n, n, G * scap).transpose(0, 1).contiguous().view(-1))
        live = torch.stack(lv).view(n, n, G * scap).transpose(0, 1).contiguous().view(-1)
        return outs, live

    return run


def mesh_bytes(planes, dtypes, live_rows, total):
    """K17's bytes: each live row of every plane read once through its
    8-byte route entry, every output position of every plane and the live
    plane written once."""
    import torch

    sizes = sum(torch.empty((), dtype=dt).element_size() for dt in dtypes)
    return live_rows * (sizes + 8) + total * (sizes + 1)


MESH_PATH_TIMES = {}


@contextlib.contextmanager
def mesh_twin_check(name, stacks=0):
    """While open, every K17 launch is also held to its twin on the same
    inputs (``mesh_all_to_all:<name>``), and every stacked K11 launch,
    batch by batch, to the stacked plain version (``fused_chain_stacked:
    <name>``); the run must make ``stacks`` stacked launches. The first
    K17 launch is then timed (K17, its device time, its twin and the
    library chain) into ``MESH_PATH_TIMES[name]``."""
    import torch
    from blaze_tpu_torch.core import kernels as K

    fn, stacked_fn = K.mesh_all_to_all, K.fused_chain_stacked
    first, seen = [], []

    def checked_stacked(in_schema, steps, batch_datas, batch_valids, batch_nrows, kernel=None):
        got = stacked_fn(in_schema, steps, batch_datas, batch_valids, batch_nrows, kernel=kernel)
        want = K.fused_chain_stacked_plain(in_schema, steps, batch_datas, batch_valids,
                                           batch_nrows)
        if len(got) != len(want):
            raise AssertionError(f"fused_chain_stacked [{name}]: {len(got)} batches, "
                                 f"not {len(want)}")
        dev = batch_datas[0][0].device
        for b, (g, w) in enumerate(zip(got, want)):
            check_equal("fused_chain_stacked", f"{name} stack {len(seen)} batch {b}",
                        fused_flat(g), [x.to(dev) for x in fused_flat(w)])
        seen.append(len(got))
        return got

    def checked(slot_planes, routes, chunk, device, dtypes, counts=None, G=1, scap=1, rnd=0):
        got = fn(slot_planes, routes, chunk, device, dtypes, counts, G, scap, rnd)
        check_equal("mesh_all_to_all", name, got,
                    K.mesh_all_to_all_plain(slot_planes, routes, chunk, device, dtypes,
                                            counts, G, scap, rnd))
        if counts is not None and not first:
            first.append((slot_planes, routes, chunk, device, dtypes, counts, G, scap, rnd))
        return got

    K.mesh_all_to_all, K.fused_chain_stacked = checked, checked_stacked
    try:
        yield
    finally:
        K.mesh_all_to_all, K.fused_chain_stacked = fn, stacked_fn
    if not first:
        raise AssertionError(f"{name}'s first run launched no K17 exchange round")
    if len(seen) != stacks:
        raise AssertionError(f"{name}'s first run held {len(seen)} stacked K11 launches to "
                             f"the plain version, not {stacks}")
    args = first[0]
    slot_planes, routes, chunk, device, dtypes, counts, G, scap, rnd = args
    n = len(slot_planes)
    chain = mesh_chain(slot_planes, routes, counts, n, G, scap, device, dtypes)
    outs, live, _c = K.mesh_all_to_all_cuda(*args)
    c_outs, c_live = chain()
    check_equal("mesh_all_to_all", f"{name}: the library chain", (c_outs, c_live), (outs, live))
    live_rows = int(live.sum().item())
    MESH_PATH_TIMES[name] = {
        "slots": n, "reducers_padded": counts.shape[1], "scap": scap, "planes": len(dtypes),
        "rows": int(counts.sum()), "positions": int(live.shape[0]),
        "ms": time_ms(lambda: K.mesh_all_to_all_cuda(*args)),
        "device_ms": kernel_device_ms(lambda: K.mesh_all_to_all_cuda(*args), "blz_mesh"),
        "plain_ms": time_ms(lambda: K.mesh_all_to_all_plain(*args)),
        "library_ms": time_ms(chain),
        "bytes": mesh_bytes(slot_planes, dtypes, live_rows, int(live.shape[0]))}
    MESH_PATH_TIMES[name]["bound_ms"] = MESH_PATH_TIMES[name]["bytes"] / HBM_BYTES_PER_S * 1e3
    del outs, live, c_outs, c_live
    torch.cuda.synchronize()


def kernel_k17(dev, rng, results):
    """K17 against its twin on MESH_CASES and K17_EDGE_CASES, every round
    (the receive counts against the count matrix's too), then timed at
    sort10M_mesh's exchange and q01_mesh8's: events, device ms, the
    wrapper's host ms, the twin and the library chain, the kernels and
    copies of a call, and the 32-byte sectors of the live gathers beside
    the byte bound."""
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K

    cases = []
    for spec, offset in [(c, 0) for c in MESH_CASES] + list(K17_EDGE_CASES):
        case = mesh_case(spec, rng)
        got = mesh_run(case, K.mesh_all_to_all_cuda, dev, offset)
        check_equal("mesh_all_to_all", spec[0], got, mesh_run(case, K.mesh_all_to_all_plain, dev))
        if case["counts"] is not None:
            if [r[2].tolist() for r in got] != mesh_recv_counts(case):
                raise AssertionError(f"mesh_all_to_all [{spec[0]}]: live counts "
                                     f"{[r[2].tolist() for r in got]}")
        cases.append(f"{spec[0]} ({case['rounds']} rounds, offset {offset})")
    # main path: sort10M_mesh's exchange, 10,000,000 rows folded onto 8
    # slots, range ids into 32 reducers (G = 4), the soak's five columns
    spec = ("sort10M_mesh", 8, 32, 1_250_000, ("i64",) * 4 + ("i64", "i64", "i64"), 0.0,
            (), 0, 0.0)
    case = mesh_case(spec, rng)
    case["kinds"] = SORT10M_MESH_PLANES
    for sp in case["slots"]:       # the three limbs share the last validity
        del sp[11], sp[9]
    shapes, timed = {}, []
    for label, case in ((f"sort10M_mesh's exchange: 8 slots of 1,250,000 rows, 32 reducers "
                         f"(G = 4), scap = {case['scap']}, 12 planes (7 int64, 5 bool)", case),
                        ("q01_mesh8's exchange: 8 slots (4 of 399 rows), 4 reducers (G = 1), "
                         "scap = 512, 8 planes (3 int64, 5 bool)",
                         mesh_case(Q01_MESH8_SPEC, rng))):
        planes, routes, dtypes = mesh_torch(case, dev)
        args = (planes, routes, case["chunk"], dev, dtypes, case["counts"], case["G"],
                case["scap"], 0)
        got = K.mesh_all_to_all_cuda(*args)
        check_equal("mesh_all_to_all", label, got, K.mesh_all_to_all_plain(*args))
        n = case["n"]
        chain = mesh_chain(planes, routes, case["counts"], n, case["G"], case["scap"], dev,
                           dtypes)
        check_equal("mesh_all_to_all", f"{label}: the library chain", chain(), got[:2])
        live_rows = int(np.clip(case["counts"], 0, case["scap"]).sum())
        total = int(got[1].shape[0])
        del got

        def k17(args=args):
            return K.mesh_all_to_all_cuda(*args)

        nbytes = mesh_bytes(planes, dtypes, live_rows, total)
        # the host ms before this phase's profiler sessions; a few calls a
        # window at sort10M_mesh's, below the pinned ring's four, so no call
        # waits on an earlier one's table copy
        shapes[label] = dict(
            host_ms=host_ms(k17, iters=3 if total > 1 << 20 else 200),
            ms=time_ms(k17), plain_ms=time_ms(lambda: K.mesh_all_to_all_plain(*args)),
            library_ms=time_ms(chain), bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            positions=total, live_rows=live_rows,
            sectors=mesh_sectors(case, [dt.itemsize for dt in dtypes]))
        timed.append((label, k17))
        del planes, routes, chain
    for label, k17 in timed:
        shapes[label].update(device_ms=kernel_device_ms(k17, "blz_mesh"),
                             call_kernels=call_kernels(k17))
        log(json.dumps({"phase": "k17_shape", "shape": label, **shapes[label]}))
    del timed
    torch.cuda.synchronize()
    label = next(iter(shapes))
    main = shapes[label]
    results.append(dict(
        name="mesh_all_to_all", route="cuda", source="blaze_tpu_torch/csrc/mesh.cu",
        replaces="blaze_tpu/parallel/mesh.py:215", shape=label, cases=cases,
        ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library_call="index_select + where per plane and slot, stack, and the block "
                     "permute copy a plane (a chain)",
        call_kernels=main["call_kernels"], bytes=main["bytes"], shapes=shapes))


# -- K18: the fused aggregate input -----------------------------------------------------

K18_FLOATS = {"f64": (0.0, -0.0, float("inf"), float("-inf"), 1.5, -1.5, 2.25, -1e300, 7.0),
              "f32": (0.0, -0.0, float("inf"), float("-inf"), 1.5, -1.5, 2.25, -1e30, 7.0)}
# NaN payloads of both signs, quiet and signalling: each folds to the quiet NaN
K18_NANS = {"f64": (0x7FF8000000000000, 0xFFF8000000000000, 0x7FF8000000000123,
                    0x7FF0000000000001),
            "f32": (0x7FC00000, 0xFFC00000, 0x7FC00123, 0x7F800001)}
K18_NP = {"i64": "int64", "i32": "int32", "f64": "float64", "f32": "float32", "bool": "bool"}
# (label, capacity, live rows, the shape): the shapes are k18_case's; the
# last is the main path's batch
K18_CASES = (
    ("one join", 4096, 4000, "join"),
    ("null and padding probe rows", 4096, 1000, "join"),
    ("build on the left", 4096, 3000, "join_left"),
    ("f64 keys: +-0.0, NaN payloads, +-inf", 4096, 4096, "f64"),
    ("f32 keys: +-0.0, NaN payloads, +-inf", 4096, 4000, "f32"),
    ("int32 probe keys against an int64 build", 4096, 3500, "i32"),
    ("empty build (nk = 0)", 4096, 4000, "empty"),
    ("one build key", 256, 200, "one"),
    ("chained: the second key is the first join's build column", 4096, 4000, "chain"),
    ("q89: three chained joins, six keys", 4096, 4000, "q89"),
    ("predicates over the joined schema", 4096, 4000, "join_filter"),
    ("absorbed steps: project, filter, rename", 4096, 4000, "steps"),
    ("q01: a decimal predicate", 4096, 4096, "q01"),
    ("every row filtered", 4096, 4000, "none_kept"),
    ("empty batch", 256, 0, "join"),
    ("q17: two joins, a wide-decimal argument", 4096, 4000, "q17"),
    ("dense route: negative words, misses below and above", 4096, 4000, "dense"),
    ("bitmap route: a word range of exactly 256 x nk", 4096, 4000, "bitmap_edge"),
    ("search route: a word range one past 256 x nk", 4096, 4000, "span_past"),
    ("search route: words at the int64 ends", 4096, 4000, "int64_ends"),
    ("q17's probe batch", 262144, 262144, "q17_main"),
)
# the 262,144-row batches K18 is timed at besides q17's probe batch: q17's
# and q89's as their paths draw them (q17's items and stores dense, q89's
# items sparse, its dates and stores dense), and q01's (no join)
K18_BATCHES = (
    ("q17's path batch", 262144, 262144, "q17_path"),
    ("q89's batch", 262144, 262144, "q89_main"),
    ("q01's batch", 262144, 262144, "q01"),
)


def canon_np(x):
    """Numpy canonical join words (ops/joins/keymap.py canon_words)."""
    import numpy as np

    if x.dtype.kind == "f":
        d = np.where(x == 0, x.dtype.type(0), x)
        d = np.where(np.isnan(d), x.dtype.type(np.nan), d)
        return d.view(np.int32).astype(np.int64) if x.dtype == np.float32 else d.view(np.int64)
    return x.astype(np.int64)


def k18_keys(kind, n, rng):
    """n distinct build keys of ``kind`` (floats: one of each canonical word)."""
    import numpy as np

    if kind in K18_FLOATS:
        pool = np.concatenate([np.array(K18_FLOATS[kind], K18_NP[kind]),
                               np.array(K18_NANS[kind][:1], "uint64" if kind == "f64"
                                        else "uint32").view(K18_NP[kind])])
        _, first = np.unique(canon_np(pool), return_index=True)
        pool = pool[np.sort(first)]
        return pool[rng.permutation(len(pool))[:n]]
    return rng.choice(np.arange(1, 4 * n + 10), n, replace=False).astype(K18_NP[kind])


def k18_probe(kind, keys, cap, n, rng, nulls):
    """A probe key plane: mostly build keys, some misses, nulls, padding."""
    import numpy as np

    if kind in K18_FLOATS:
        nan_bits = np.array(K18_NANS[kind], "uint64" if kind == "f64" else "uint32")
        pool = np.concatenate([np.array(K18_FLOATS[kind], K18_NP[kind]),
                               nan_bits.view(K18_NP[kind]),
                               np.array([5.0, -7.5, 1e-3], K18_NP[kind])])
    else:
        hi = int(keys.max()) + 30 if len(keys) else 50
        pool = np.concatenate([np.repeat(keys, 3), np.arange(-5, hi).astype(K18_NP[kind])])
    d = np.zeros(cap, K18_NP[kind])
    v = np.zeros(cap, bool)
    d[:n] = pool[rng.integers(0, len(pool), n)]
    v[:n] = rng.random(n) >= nulls
    d[~v] = 0
    return d, v


def k18_route_words(shape, rng):
    """A route case's sorted unique build words and probe words that miss
    them below, inside and above their range."""
    import numpy as np

    if shape == "dense":
        keys, miss = np.arange(-30, 30), [-10 ** 6, -31, 30, 31, 10 ** 6]
    elif shape == "int64_ends":
        keys = np.array([-(1 << 63), -(1 << 63) + 1, -5, 0, 7, (1 << 63) - 2, (1 << 63) - 1])
        miss = [-(1 << 63) + 2, -4, 1, 8, (1 << 63) - 3]
    else:  # a word range of 256 x nk words, or one more
        nk, lo = 40, -5000
        span = 256 * nk + (shape == "span_past")
        keys = np.sort(np.r_[lo, lo + span - 1, rng.choice(np.arange(lo + 1, lo + span - 1),
                                                          nk - 2, replace=False)])
        miss = [lo - 10 ** 6, lo - 1, lo + span, lo + span + 10 ** 6] + \
            list(np.setdiff1d(rng.integers(lo, lo + span, 40), keys))
    return keys.astype(np.int64), np.array(miss, np.int64)


def k18_dim(kind, nk, cap_b, attrs, rng, keys=None):
    """A dimension of nk unique keys (drawn, or ``keys``) sorted by
    canonical word (code c at row c, as JoinHashMap sorts its build), a
    null-keyed row after them, and int64 attribute columns drawn from [0,
    attr): (keys, uniq words, columns as (data, valid) host pairs)."""
    import numpy as np

    keys = k18_keys(kind, nk, rng) if keys is None else keys
    keys = keys[np.argsort(canon_np(keys), kind="stable")]
    uniq = canon_np(keys) if nk else np.zeros(1, np.int64)
    kd = np.zeros(cap_b, K18_NP[kind])
    kv = np.zeros(cap_b, bool)
    kd[:nk] = keys
    kv[:nk] = True
    nrow = min(nk + 1, cap_b)
    cols = [(kd, kv)]
    for hi in attrs:
        a = np.zeros(cap_b, np.int64)
        a[:nrow] = rng.integers(0, hi, nrow)
        av = np.arange(cap_b) < nrow
        av[:nrow] &= rng.random(nrow) >= 0.05
        a[~av] = 0
        cols.append((a, av))
    return keys, uniq, cols


def k18_case(case, rng, E, T):
    """One battery case in the IR modules ``E``, ``T`` of either package:
    a dict of the input schema, the joins inner-first (probe key, probe on
    the left, probe schema, build schema), the absorbed steps, the
    predicates, the aggregate's child schema, its grouping expressions, its
    aggregates ((function name, argument or None), the argument K18
    computes) and the data: the input columns as host (data, valid) pairs
    of the capacity (a decimal(19..38)'s data its int64 values), the live
    rows, and per join (sorted unique words, nk, build columns as pairs)."""
    import numpy as np

    label, cap, n, shape = case
    C = E.Column
    TT = {"i64": T.I64, "i32": T.I32, "f64": T.F64, "f32": T.F32}
    nulls = 0.2 if "null" in label else 0.03
    price = T.DecimalType(7, 2)

    def col(d, v=None):
        v = np.arange(cap) < n if v is None else v
        return (np.where(v, d, 0).astype(d.dtype), v)

    def ints(lo, hi):
        return col(rng.integers(lo, hi, cap).astype(np.int64),
                   (np.arange(cap) < n) & (rng.random(cap) >= nulls))

    def dim(name, kind, nk, attrs, cap_b=None, keys=None):
        keys, uniq, cols = k18_dim(kind, nk, cap_b or max(256, 1 << nk.bit_length()), attrs,
                                   rng, keys)
        schema = T.Schema.of((f"{name}_sk", TT[kind]),
                             *[(f"{name}_a{i}", T.I64) for i in range(len(attrs))])
        return keys, (uniq, nk, cols), schema

    def joined(probe, build, left=True):
        return T.Schema(tuple(probe.fields) + tuple(build.fields) if left
                        else tuple(build.fields) + tuple(probe.fields))

    def case_dict(inp, joins, child, groupings, aggs, cols, builds, steps=(), preds=()):
        return dict(input=inp, joins=tuple(joins), steps=tuple(steps), preds=tuple(preds),
                    child=child, groupings=tuple(groupings), aggs=tuple(aggs), cols=cols,
                    n=n, builds=builds)

    if shape in ("join", "join_left", "join_filter", "empty", "one", "none_kept", "i32") \
            or shape in K18_FLOATS:
        kind = shape if shape in K18_FLOATS or shape == "i32" else "i64"
        bkind = "i64" if kind == "i32" else kind
        nk = {"empty": 0, "one": 1}.get(shape, 8 if kind in K18_FLOATS else 60)
        keys, build, bschema = dim("d", bkind, nk, (5, 1000))
        pd, pv = k18_probe(kind, keys.astype(K18_NP[kind]), cap, n, rng, nulls)
        probe = T.Schema.of(("fk", TT[kind]), ("v", T.I64), ("p", price))
        left = shape != "join_left"
        preds = ()
        if shape == "join_filter":
            preds = (E.BinaryExpr(E.BinaryOp.GT, C("v"), E.Literal(0, T.I64)),
                     E.BinaryExpr(E.BinaryOp.NEQ, C("d_a0"), E.Literal(3, T.I64)))
        if shape == "none_kept":
            preds = (E.BinaryExpr(E.BinaryOp.GT, C("v"), E.Literal(1000, T.I64)),)
        return case_dict(probe, [(C("fk"), left, probe, bschema)], joined(probe, bschema, left),
                         [C("d_a0")], [("count", None), ("sum", C("v")), ("sum", C("p")),
                                       ("max", C("d_a1"))],
                         [(pd, pv), ints(-100, 100), ints(0, 500_00)], [build], preds=preds)
    if shape in ("dense", "bitmap_edge", "span_past", "int64_ends"):
        keys, miss = k18_route_words(shape, rng)
        keys, build, bschema = dim("d", "i64", len(keys), (5, 1000), keys=keys)
        pool = np.concatenate([np.repeat(keys, 3), miss])
        pv = (np.arange(cap) < n) & (rng.random(cap) >= nulls)
        pd = np.where(pv, pool[rng.integers(0, len(pool), cap)], 0)
        probe = T.Schema.of(("fk", T.I64), ("v", T.I64), ("p", price))
        return case_dict(probe, [(C("fk"), True, probe, bschema)], joined(probe, bschema),
                         [C("d_a0")], [("count", None), ("sum", C("v")), ("max", C("d_a1"))],
                         [(pd, pv), ints(-100, 100), ints(0, 500_00)], [build])
    if shape == "q89_main":
        # the sales batch as q89_host draws it (each key 4% null) against
        # q89's builds: the 1.8% of SF10's 102,000 items its category and
        # class filter keeps, 1999's 365 dates, the 102 stores
        def fk(lo, hi):
            v = (np.arange(cap) < n) & (rng.random(cap) >= 0.04)
            return col(np.where(v, rng.integers(lo, hi + 1, cap), 0).astype(np.int64), v)

        items = np.sort(rng.choice(np.arange(1, Q89_ROWS["item"] + 1), 1_836, replace=False))
        _ki, bi, si = dim("i", "i64", len(items), (10, 100, 1000), keys=items)
        _kd, bd, sd = dim("dt", "i64", 365, (12,), keys=np.arange(2_451_180, 2_451_545))
        _ks, bs, ss = dim("s", "i64", 102, (7, 20), keys=np.arange(1, 103))
        probe = T.Schema.of(("item", T.I64), ("date", T.I64), ("store", T.I64), ("q", T.I64))
        j1 = joined(probe, si)
        j2 = joined(j1, sd)
        return case_dict(probe, [(C("item"), True, probe, si), (C("date"), True, j1, sd),
                                 (C("store"), True, j2, ss)], joined(j2, ss),
                         [C(x) for x in ("i_a0", "i_a1", "i_a2", "s_a0", "s_a1", "dt_a0")],
                         [("sum", C("q"))],
                         [fk(1, Q89_ROWS["item"]), fk(*Q89_SALES_DATES),
                          fk(1, Q89_ROWS["store"]), ints(1, 100)], [bi, bd, bs])
    if shape == "chain":
        k1, b1, s1 = dim("d1", "i64", 40, (20,))
        _k2, b2, s2 = dim("d2", "i64", 19, (3, 100))
        probe = T.Schema.of(("fk", T.I64), ("v", T.I64))
        j1 = joined(probe, s1)
        pd, pv = k18_probe("i64", k1, cap, n, rng, nulls)
        return case_dict(probe, [(C("fk"), True, probe, s1), (C("d1_a0"), True, j1, s2)],
                         joined(j1, s2), [C("d2_a0"), C("d1_a0")],
                         [("sum", C("v")), ("min", C("d2_a1")), ("count", None)],
                         [(pd, pv), ints(-50, 50)], [b1, b2])
    if shape == "q89":
        ki, bi, si = dim("i", "i64", 400, (10, 100, 1000))
        kd, bd, sd = dim("dt", "i64", 365, (12,))
        ks, bs, ss = dim("s", "i64", 102, (7, 20))
        probe = T.Schema.of(("item", T.I64), ("date", T.I64), ("store", T.I64), ("q", T.I64))
        j1 = joined(probe, si)
        j2 = joined(j1, sd)
        return case_dict(probe, [(C("item"), True, probe, si), (C("date"), True, j1, sd),
                                 (C("store"), True, j2, ss)], joined(j2, ss),
                         [C(x) for x in ("i_a0", "i_a1", "i_a2", "s_a0", "s_a1", "dt_a0")],
                         [("sum", C("q"))],
                         [k18_probe("i64", k, cap, n, rng, nulls) for k in (ki, kd, ks)] +
                         [ints(1, 100)], [bi, bd, bs])
    if shape == "steps":
        schema = T.Schema.of(("k", T.I64), ("v", T.I64), ("f", T.F64))
        twice = E.BinaryExpr(E.BinaryOp.MUL, C("v"), E.Literal(2, T.I64))
        steps = (("project", (C("k"), twice, C("f")), ("k", "w", "f")),
                 ("filter", (E.BinaryExpr(E.BinaryOp.GT, C("w"), E.Literal(10, T.I64)),)),
                 ("rename", ("key", "w2", "f2")))
        child = T.Schema.of(("key", T.I64), ("w2", T.I64), ("f2", T.F64))
        fv = (np.arange(cap) < n) & (rng.random(cap) >= 0.1)
        return case_dict(schema, [], child, [C("key")], [("sum", C("w2")), ("count", None)],
                         [ints(0, 30), ints(-40, 40), col(rng.normal(size=cap), fv)], [],
                         steps=steps, preds=(E.IsNotNull(C("f2")),))
    if shape == "q01":
        schema = T.Schema.of(("sr_store_sk", T.I64), ("sr_customer_sk", T.I64),
                             ("sr_return_amt", price))
        pred = E.BinaryExpr(E.BinaryOp.GT, C("sr_return_amt"), E.Literal("500.00", price))
        return case_dict(schema, [], schema, [C("sr_store_sk")],
                         [("sum", C("sr_return_amt")), ("count", None)],
                         [ints(1, 400), ints(1, 100_000), ints(0, 10_000_00)], [],
                         preds=(pred,))
    if shape in ("q17", "q17_main", "q17_path"):
        main, path = shape != "q17", shape == "q17_path"
        # q17's path: i_item_sk 1..102,000 and s_store_sk 1..400, dense
        ki, bi, si = dim("i", "i64", 102_000 if main else 2000, (10, 100, 1000),
                         cap_b=131072 if main else None,
                         keys=np.arange(1, 102_001) if path else None)
        ks, bs, ss = dim("s", "i64", 400, (50,), keys=np.arange(1, 401) if path else None)
        probe = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                            ("ss_quantity", T.I64), ("ss_ext_wholesale_cost",
                                                     T.DecimalType(38, 2)))
        j1 = joined(probe, si)
        # the probe batch misses ~2% of items (keys past the dimension), the
        # path's draw none (its items and stores uniform over the keys);
        # the small case adds null keys and costs
        if path:
            items, stores = rng.integers(1, 102_001, cap), rng.integers(1, N_STORES, cap)
        else:
            items = np.where(rng.random(cap) < 0.98, rng.choice(ki, cap),
                             rng.integers(1, 10 ** 6, cap))
        share = 0.0 if main else nulls

        def valid():
            return (np.arange(cap) < n) & (rng.random(cap) >= share)

        cols = [col(items.astype(np.int64), valid()),
                col((stores if path else rng.choice(ks, cap)).astype(np.int64)),
                ints(1, 100),
                col(rng.integers(10 ** 14, 9 * 10 ** 16, cap).astype(np.int64), valid())]
        return case_dict(probe, [(C("ss_item_sk"), True, probe, si),
                                 (C("ss_store_sk"), True, j1, ss)], joined(j1, ss),
                         [C("s_a0"), C("i_a0")],
                         [("count", None), ("sum", C("ss_quantity")),
                          ("sum", C("ss_ext_wholesale_cost"))], cols, [bi, bs])
    raise ValueError(shape)


def k18_spec(d):
    """The port's FusedAggSpec of a battery case (in either package's IR)."""
    from blaze_tpu_torch.exprs.fused_triton import FusedAggSpec, FusedJoin
    from blaze_tpu_torch.ir.carry import from_foreign

    f = from_foreign
    return FusedAggSpec(f(d["input"]), tuple(FusedJoin(*f(j)) for j in d["joins"]),
                        f(d["steps"]), f(d["preds"]), f(d["child"]), f(d["groupings"]),
                        tuple(f(a) for _fn, a in d["aggs"]))


def k18_torch(d, dev):
    """A battery case's tensors on ``dev``: (spec, columns, live rows, joins)."""
    import torch
    from blaze_tpu_torch.core.batch import DeviceColumn, WideColumn
    from blaze_tpu_torch.ir import types as T

    spec = k18_spec(d)

    def column(f, data, v):
        data, v = torch.from_numpy(data).to(dev), torch.from_numpy(v).to(dev)
        if T.is_wide_decimal(f.dtype):
            return WideColumn(f.dtype, data & LO32, (data >> 32) & LO32, data >> 63, v)
        return DeviceColumn(f.dtype, data, v)

    columns = [column(f, data, v) for f, (data, v) in zip(spec.input_schema.fields, d["cols"])]
    joins = []
    for js, (uniq, nk, bcols) in zip(spec.joins, d["builds"]):
        joins.append((torch.from_numpy(uniq).to(dev), nk,
                      [column(f, data, v) for f, (data, v) in zip(js.build_schema.fields, bcols)])
                     + k18_rank(uniq[:nk]))
    return spec, columns, d["n"], joins


def k18_rank(words):
    """K18's rank route of a build's sorted words, as a one-tuple to end a
    join's entry; empty for a checkout whose K18 has no routes (a parent
    timed at this checkout's shapes by ``chip_ab.py --shapes``)."""
    from blaze_tpu_torch.ops.joins import keymap

    rank = getattr(keymap, "JoinRank", None)
    return (rank(words),) if rank is not None else ()


def k18_flat(out):
    """(keys, args, live) as a flat list of tensors."""
    keys, args, live = out
    flat = [t for kv in keys for t in kv]
    for a in args:
        if a is not None:
            d, v = a
            flat += (list(d) if isinstance(d, tuple) else [d]) + [v]
    return flat + [live]


def k18_bytes(kernel, columns, joins):
    """Bytes K18 must move: each plane it reads once (the input planes its
    expressions read, each join's sorted words, and the build planes it
    gathers over the first max(nk, 1) rows, the only ones its clipped
    ranks reach), each plane it stores once."""
    import torch

    gen = kernel.gen
    cap = columns[0].capacity
    total = sum(columns[i].data.element_size() * cap for i in gen.used_d) + \
        len(gen.used_v) * cap
    for j, (uniq, nk, bcols, *_rank) in enumerate(joins):
        rows = [min(max(nk, 1), c.capacity) for c in bcols]
        total += uniq.numel() * 8 + \
            sum(rows[c] * bcols[c].data.element_size() for c in gen.join_used_d[j]) + \
            sum(rows[c] for c in gen.join_used_v[j])
    return total + sum(cap * torch.empty((), dtype=tdt).element_size() for _v, tdt in gen.stores)


def k18_library_chain(columns, joins, spec):
    """The joins' probes and gathers as PyTorch library calls (a chain):
    per join searchsorted over the canonical words, clamp, compare, and an
    index_select + where per gathered plane; then the live mask."""
    import torch
    from blaze_tpu_torch.ops.joins.keymap import canon_words

    def run():
        cols = list(columns)
        live = None
        for js, (uniq, nk, bcols, *_rank) in zip(spec.joins, joins):
            k = cols[js.probe_schema.index_of(js.key_expr.name)]
            w = canon_words(k.data)
            idx = torch.searchsorted(uniq, w)
            cidx = idx.clamp(0, max(nk - 1, 0))
            hit = k.validity & (idx < nk) & (uniq.index_select(0, cidx) == w)
            gathered = [type(c)(c.dtype, c.data.index_select(0, cidx),
                                torch.where(hit, c.validity.index_select(0, cidx), False))
                        for c in bcols]
            cols = cols + gathered if js.probe_on_left else gathered + cols
            live = hit if live is None else live & hit
        return live
    return run


def k18_routes(joins):
    """The rank route of each join (none in a checkout without routes)."""
    return [j[3].route for j in joins if len(j) == 4]


def k18_timed(spec, columns, n, joins, kernel, first_s):
    """One timed K18 batch: CUDA events, device ms, the wrapper's host ms,
    its plain version's events and the library chain of its joins (none
    without a join), with its routes and the first call's wall (the
    compile of a kernel new to its routes)."""
    from blaze_tpu_torch.core import kernels as K

    def k18():
        return K.fused_agg_input(spec, columns, n, joins, kernel)

    chain = k18_library_chain(columns, joins, spec) if joins else None
    return dict(shape_times(k18, lambda: K.fused_agg_input_plain(spec, columns, n, joins),
                            chain, k18_bytes(kernel, columns, joins), prefix="fused_agg_input"),
                host_ms=host_ms(k18), routes=k18_routes(joins), first_call_s=first_s)


def kernel_k18(dev, rng, results):
    """K18 against its plain version on every battery case (``K18_CASES``,
    each join on the route its words give, then ``K18_BATCHES``), bit for
    bit; then K3 and K10 over its live mask (the masked entry points)
    against their plain versions; timed at q17's path batch (the entry),
    q17's probe batch, q89's and q01's."""
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs.fused_triton import fused_agg_kernel
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import agg_device as A

    cases, timed = [], {}
    for case in K18_CASES + K18_BATCHES:
        spec, columns, n, joins = k18_torch(k18_case(case, rng, E, T), dev)
        kernel = fused_agg_kernel(spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = K.fused_agg_input(spec, columns, n, joins, kernel)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        want = K.fused_agg_input_plain(spec, columns, n, joins)
        check_equal("fused_agg_input", case[0], k18_flat(got), k18_flat(want))
        keys, args, live = got
        kd, kv = [d for d, _ in keys], [v for _, v in keys]
        if all(d.dtype == torch.int64 for d in kd) and spec.args[0] is None:
            # the masked K3 and K10 over K18's planes: COUNT(*) and SUM of
            # the first int64 argument, as the aggregate would run them
            a_ = [(torch.zeros_like(live, dtype=torch.int64), live)] + \
                [a for a in args[1:2] if a is not None and not isinstance(a[0], tuple)]
            specs = [("count", 0, "int64")] + [("sum", 0, "int64")] * (len(a_) - 1)
            probe = A.probe_ranges(kd, kv)
            st = A.plan_slot_table(probe, live.shape[0], None, 1 << 22, Config())
            if st is not None and st is not A._DEFER_PLAN:
                bases, sizes, out_cap = st
                check_equal("slot_agg_partial", f"{case[0]}: over K18's live mask",
                            A.slot_agg_partial(kd, kv, [d.dtype for d in kd], n, bases, sizes,
                                               specs, a_, out_cap, exists=live),
                            A.slot_agg_partial_plain(kd, kv, [d.dtype for d in kd], n, bases,
                                                     sizes, specs, a_, out_cap, exists=live))
            check_seg_pipeline("seg_agg_partial", A.seg_agg_partial,
                               (kd, kv, n, specs, a_, True, live),
                               to_dev((kd, kv, n, specs, a_, True, live), "cpu"),
                               f"{case[0]}: over K18's live mask")
        cases.append(f"{case[0]} ({'/'.join(k18_routes(joins)) or 'no join'})")
        if case[3] in ("q17_main", "q17_path", "q89_main") or case in K18_BATCHES:
            timed[case[0]] = k18_timed(spec, columns, n, joins, kernel, first_s)
        del spec, columns, joins, got, want
    main = timed[K18_BATCHES[0][0]]
    results.append(dict(
        name="fused_agg_input", route="triton",
        source="blaze_tpu_torch/exprs/fused_triton.py",
        replaces="blaze_tpu/ops/agg_device.py:587",
        shape="q17's path batch: 262,144 store_sales rows, two chained joins (102,000 items "
              "i_item_sk 1..102,000, 400 stores 1..400: both dense), keys (s_state_id, "
              "i_category_id), COUNT(*), SUM(ss_quantity), the decimal(38,2) wcost's "
              "validity (its limbs pass through)",
        cases=cases, ms=main["ms"], device_ms=main["device_ms"], host_ms=main["host_ms"],
        plain_ms=main["plain_ms"], library_ms=main["library_ms"],
        library_device_ms=main["library_device_ms"],
        library_call="searchsorted + index_select + where per join and gathered plane "
                     "(the joins' probes and gathers only: a chain)",
        bytes=main["bytes"], shapes=timed))
    torch.cuda.synchronize()


# -- K19: the passthrough of a skipped partial aggregate ------------------------------

# int64 values besides uniform draws: the ends, and values whose 10^2
# rescale wraps
PASS_INT_POOL = (-(1 << 63), (1 << 63) - 1, (1 << 62) + 12345, -(1 << 62) - 7, 0, -1, 1)
PASS_FLOATS = (float("nan"), 0.0, -0.0, float("inf"), float("-inf"), 1.5, -2.25, 1e300,
               -1e300, 7.0, 0.1)
PASS_SUBNORMALS = (5e-324, -5e-324, 1e-310, 1e-40, -1e-45)
# aggregate (kind, rescale, accumulator) and its column: a int64, b int32,
# e a decimal(18) int64 from PASS_INT_POOL and uniform (its 10^2 rescale
# wraps), x float64, y float32, d a decimal(18) plane (two-limb sums), w a
# decimal(38) plane as limbs, * COUNT(*)
PASS_SPECS = {
    "ints": ((("sum", 0, "int64"), "a"), (("sum", 2, "int64"), "e"), (("count", 0, ""), "*"),
             (("count", 0, ""), "b"), (("avg", 4, "int64"), "e"), (("min", 0, ""), "b"),
             (("max", 0, ""), "b"), (("sum", 0, "int64"), "b"), (("min", 0, ""), "a"),
             (("max", 0, ""), "a")),
    "floats": ((("sum", 0, "float64"), "x"), (("min", 0, ""), "x"), (("max", 0, ""), "x"),
               (("avg", 0, "float64"), "y"), (("sum", 0, "float64"), "y"),
               (("min", 0, ""), "y"), (("max", 0, ""), "y"), (("avg", 0, "float64"), "a"),
               (("count", 0, ""), "x")),
    "wide": WIDE_SPECS,
}
# (label, key kinds, capacity, live rows, key null share, value null share,
# specs, the wide values' kind as WIDE_CASES names them)
PASS_CASES = (
    ("one int64 key, integers", ("i64",), 256, 200, 0.1, 0.15, "ints", "mixed"),
    ("int32 and int64 keys, floats", ("i32", "i64"), 4096, 4000, 0.1, 0.15, "floats",
     "mixed"),
    ("three keys, 38-digit limbs", ("i64", "i32", "i64"), 4096, 3000, 0.05, 0.1, "wide",
     "extremes"),
    ("int32 key, limbs of both signs", ("i32",), 256, 256, 0.0, 0.1, "wide", "mixed"),
    ("float64 and int32 keys, floats", ("f64", "i32"), 256, 130, 0.1, 0.1, "floats",
     "mixed"),
    ("every value null", ("i64",), 256, 200, 0.0, 1.0, "ints", "mixed"),
    ("one row, cancelling limbs", ("i32",), 256, 1, 0.0, 0.0, "wide", "cancel"),
    ("three int32 keys, integers", ("i32", "i32", "i32"), 4096, 4096, 0.2, 0.05, "ints",
     "mixed"),
)
CUST_SKS = 2_000_000   # TPC-DS SF100's customer rows: ss_customer_sk in 1..2,000,000


def pass_case(case, rng, subnormals=True):
    """One PASS_CASES entry on the host: key planes, their validity (not yet
    masked with the live rows), the specs and per aggregate its (data,
    valid), data a (l0, l1, l2) tuple for a wide argument; padding rows 0,
    null rows keep their drawn values."""
    import numpy as np

    _label, kinds, cap, n, knulls, vnulls, specs, values = case
    live = np.arange(cap) < n
    floats = np.array(PASS_FLOATS + (PASS_SUBNORMALS if subnormals else ()))

    def plane(kind):
        if kind in ("f64", "f32"):
            with np.errstate(over="ignore"):  # +-1e300 is +-inf in float32
                d = floats[rng.integers(0, len(floats), cap)].astype(
                    np.float64 if kind == "f64" else np.float32)
        elif kind == "i32":
            d = rng.integers(-10 ** 6, 10 ** 6, cap).astype(np.int32)
        else:
            pool = np.array(PASS_INT_POOL, np.int64)
            d = np.where(rng.random(cap) < 0.3, pool[rng.integers(0, len(pool), cap)],
                         rng.integers(-(1 << 40), 1 << 40, cap))
        return np.where(live, d, 0).astype(d.dtype)

    def valid(share):
        return live & (rng.random(cap) >= share)

    keys, kvalids = [], []
    for k in kinds:
        keys.append(plane(k) if k != "i64" else
                    np.where(live, rng.integers(-50, 50, cap), 0).astype(np.int64))
        kvalids.append(valid(knulls))
    w = wide_plane(values, cap, n, rng, vnulls)
    cols = {"a": (plane("i64"), valid(vnulls)), "b": (plane("i32"), valid(vnulls)),
            "e": (plane("e"), valid(vnulls)), "x": (plane("f64"), valid(vnulls)),
            "y": (plane("f32"), valid(vnulls)), "d": narrow_plane(values, cap, n, rng, vnulls),
            "w": (w[:3], w[3]), "*": (np.zeros(cap, np.int64), live)}
    spec = PASS_SPECS[specs]
    return keys, kvalids, tuple(s for s, _ in spec), [cols[c] for _, c in spec]


def cust_spend_batch(rng, cap=262144):
    """One cust_spend store_sales batch as K19 takes it: ss_customer_sk
    int32 uniform over SF100's customers, 1% null; SUM(ss_quantity *
    ss_sales_price)'s decimal(18,2) argument (quantity 1..100 times a price
    of 0.00..200.00), as a two-limb sum (sum2)."""
    import numpy as np

    key = rng.integers(1, CUST_SKS + 1, cap).astype(np.int32)
    kvalid = rng.random(cap) >= 0.01
    arg = rng.integers(1, 101, cap) * rng.integers(0, 20_001, cap)
    return ([np.where(kvalid, key, 0).astype(np.int32)], [kvalid], (("sum2", 0, "int64"),),
            [(arg.astype(np.int64), np.ones(cap, bool))])


def pass_inputs(case_np, n, dev):
    """K19's arguments for a host case on ``dev``: (keys, their validity
    and the arguments' masked with the rows below ``n``, that row mask, n,
    and the program ``_partial_program`` builds)."""
    import torch
    from blaze_tpu_torch.ops import agg_device as A

    keys, kvalids, specs, args = wide_torch(case_np, dev)
    exists = torch.arange(keys[0].shape[0], device=keys[0].device) < n
    ops, emits = A._partial_program(specs, [(d, v & exists) for d, v in args])
    return keys, [v & exists for v in kvalids], exists, n, ops, emits


def k19_library_chain(kd, kv, ad, av):
    """cust_spend's passthrough in library calls: the key zeroed where null,
    the argument's two limbs where valid, the has flag (a chain: no single
    PyTorch call computes it)."""
    import torch

    return (torch.where(kv, kd, 0), torch.where(av, ad & LO32, 0),
            torch.where(av, ad >> 32, 0), av.clone())


def host_ms(fn, iters=200, windows=5):
    """The host's time of one call that only enqueues work: the clock
    around ``iters`` calls, synchronised before and after but not
    between; the median of ``windows`` such windows (the host's clock
    varies more than the device's)."""
    import statistics

    import torch

    for _ in range(WARMUP):
        fn()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out.append((t1 - t0) / iters * 1e3)
    return statistics.median(out)


def kernel_k19(dev, rng, results):
    """K19 against its plain version on every battery case and on
    cust_spend's batch, bit for bit, each battery case once with a fresh
    pack and then every case through one pack (a task's batches); timed at
    cust_spend's batch beside the plain version and the library chain, with
    the wrapper's host time alone."""
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.utils import cuda_lib

    shared = K.PassthroughPack()
    cases = []
    for case in PASS_CASES:
        args = pass_inputs(pass_case(case, rng), case[3], dev)
        want = K.passthrough_states_plain(*args)[1:]
        for pack in (K.PassthroughPack(), shared):
            check_equal("passthrough_states", case[0],
                        K.passthrough_states_cuda(*args, pack=pack)[1:], want)
        cases.append(case[0])
    cap = 262144
    host = cust_spend_batch(rng, cap)
    args = pass_inputs(host, cap, dev)
    pack = K.PassthroughPack()
    got = K.passthrough_states_cuda(*args, pack=pack)
    check_equal("passthrough_states", "cust_spend batch", got[1:],
                K.passthrough_states_plain(*args)[1:])
    cases.append("cust_spend batch")
    (kd,), (kv,), _specs, ((ad, av),) = wide_torch(host, dev)
    chain = k19_library_chain(kd, kv, ad, av)
    check_equal("passthrough_states", "cust_spend batch: the library chain",
                (got[2], got[4], got[5], got[6]), chain)

    def k19():
        return K.passthrough_states_cuda(*args, pack=pack)

    results.append(dict(
        name="passthrough_states", route="cuda", source="blaze_tpu_torch/csrc/passthrough.cu",
        replaces="blaze_tpu/ops/agg_device.py:1710",
        shape="a cust_spend store_sales batch: 262,144 rows, an int32 ss_customer_sk "
              "(1% null), SUM of a decimal(18,2) into decimal(28,2): the sum2 limbs and "
              "has flag",
        cases=cases, ms=time_ms(k19), device_ms=kernel_device_ms(k19, "blz_passthrough"),
        host_ms=host_ms(k19),
        plain_ms=time_ms(lambda: K.passthrough_states_plain(*args)),
        library_ms=time_ms(lambda: k19_library_chain(kd, kv, ad, av)),
        library_device_ms=kernel_device_ms(lambda: k19_library_chain(kd, kv, ad, av), ""),
        library_host_ms=host_ms(lambda: k19_library_chain(kd, kv, ad, av)),
        # the host ms of reading the current stream: a torch.cuda.Stream
        # object, and the raw handle the wrappers read
        stream_object_ms=host_ms(lambda: torch.cuda.current_stream(dev).cuda_stream),
        stream_raw_ms=host_ms(lambda: cuda_lib.stream_handle(0)),
        library_call="torch.where per key and limb plane, & and >> for the limbs, a copy "
                     "of the has flag (a chain: no single PyTorch call computes the "
                     "passthrough)",
        # read once: the key (4 B) and its validity, the argument (8 B) and
        # its validity; written once: the key, the two limbs, the has flag
        bytes=cap * ((4 + 1 + 8 + 1) + (4 + 8 + 8 + 1))))
    torch.cuda.synchronize()


@contextlib.contextmanager
def plain_kernels():
    """While open, the kernel dispatchers that the mesh's demo steps call
    (K1, K2, K5, K6, K9, K10 and K17) run their plain PyTorch versions, on
    whatever device their tensors are: the steps' plain time on the card."""
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs import spark_hash as H

    swaps = {(K, "mesh_all_to_all"): K.mesh_all_to_all_plain,
             (K, "compact_planes"): lambda d, v, m: (lambda c, od, ov: (int(c), od, ov))(
                 *K.compact_planes_plain(d, v, m)),
             (K, "sort_key_operands"): K.sort_key_operands_plain,
             (K, "lexsort_indices"): K.lexsort_indices_plain,
             (K, "segment_keys_cuda"): K.segment_keys_plain,
             (K, "segment_reduce"): lambda name, *a, kinds=(): K.segment_reduce_plain(*a),
             (K, "gather_planes"): K.gather_planes_plain,
             (K, "probe_codes"): K.probe_codes_plain,
             (H, "murmur3_pmod"): lambda w, v, k, n, p: H.murmur3_pmod_plain(w, v, k, n, p)[1]}
    old = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in old.items():
            setattr(mod, name, fn)


MESH_DEMOS = {}


def mesh_demos(dev, rng):
    """The JAX package's mesh demos on the card, 8 slots of 262,144 rows:
    exchange_and_aggregate's step (row 18b: K1 + K5 + K10 a slot, K2, K17
    in tile mode, K1 + K5 + K10 a destination) and broadcast_join_sum's (row 18c:
    K9 + K6 a slot against 102,000 sorted build keys with duplicates), each
    held to the same step with every kernel's plain version on the card
    and to numpy, then timed (CUDA events) beside that plain step; and
    run_distributed_sum (row 18e: the host driver of 18b, numpy in, a dict
    out) timed end to end. Into ``MESH_DEMOS``."""
    import numpy as np
    import torch
    from blaze_tpu_torch.parallel import mesh as M

    n, cap = 8, 262144
    mesh = M.make_mesh(n, dev)
    keys = torch.from_numpy(rng.integers(0, 200_000, n * cap)).to(dev)
    vals = torch.from_numpy(rng.integers(0, 1000, n * cap)).to(dev)
    valid = torch.from_numpy(rng.random(n * cap) >= 0.02).to(dev)
    step = M.exchange_and_aggregate(mesh, cap)
    got = step(keys, vals, valid)
    with plain_kernels():
        want = step(keys, vals, valid)
    check_equal("mesh_demo", "exchange_and_aggregate", list(got), list(want))
    uk, sums, counts, ok, total = (x.cpu().numpy() for x in got)
    kv, vv, mv = keys.cpu().numpy(), vals.cpu().numpy(), valid.cpu().numpy()
    exp_s = np.bincount(kv[mv], weights=vv[mv], minlength=200_000).astype(np.int64)
    exp_c = np.bincount(kv[mv], minlength=200_000)
    if not (np.array_equal(np.sort(uk[ok]), np.nonzero(exp_c)[0])
            and np.array_equal(sums[ok][np.argsort(uk[ok])], exp_s[exp_c > 0])
            and np.array_equal(counts[ok][np.argsort(uk[ok])], exp_c[exp_c > 0])
            and int(total) == int(mv.sum())):
        raise AssertionError("exchange_and_aggregate differs from numpy")
    out_rows = n * n * cap
    with plain_kernels():
        plain_ms = time_ms(lambda: step(keys, vals, valid), iters=3)
    MESH_DEMOS["exchange_and_aggregate"] = {
        "shape": f"{n} slots x {cap:,} int64 rows, keys in [0, 200,000), 2% invalid",
        "ms": time_ms(lambda: step(keys, vals, valid), iters=5), "plain_ms": plain_ms,
        "library_ms": None, "library_call": "none: no single PyTorch call",
        # keys, values and validity read once; four output planes of n * n *
        # cap rows and the psum written once
        "bytes": n * cap * 17 + out_rows * 25 + 8, "groups": int(ok.sum())}
    host_k, host_v = kv[mv], vv[mv]
    t0 = time.perf_counter()
    res = M.run_distributed_sum(host_k, host_v, mesh)
    MESH_DEMOS["run_distributed_sum"] = {"wall_s": time.perf_counter() - t0,
                                         "rows": len(host_k), "groups": len(res)}
    # 18c: the probe sharded, the build (SF10's 102,000 items with keys
    # drawn with repeats) replicated and sorted
    bk_host = np.sort(rng.integers(0, 150_000, 102_000))
    bcap = 131072
    bk = torch.full((bcap,), np.iinfo(np.int64).max, dtype=torch.int64)
    bk[:len(bk_host)] = torch.from_numpy(bk_host)
    bk = bk.to(dev)
    bv = torch.arange(bcap, dtype=torch.int64, device=dev) * 7
    pk = torch.from_numpy(rng.integers(0, 160_000, n * cap)).to(dev)
    pv = torch.from_numpy(rng.random(n * cap) >= 0.04).to(dev)
    join = M.broadcast_join_sum(mesh, cap, bcap)
    got = join(pk, pv, bk, bv, len(bk_host))
    with plain_kernels():
        want = join(pk, pv, bk, bv, len(bk_host))
    check_equal("mesh_demo", "broadcast_join_sum", list(got), list(want))
    idx = np.searchsorted(bk_host, pk.cpu().numpy())
    hit = pv.cpu().numpy() & (idx < len(bk_host)) & \
        (bk_host[np.minimum(idx, len(bk_host) - 1)] == pk.cpu().numpy())
    if not (np.array_equal(got[0].cpu().numpy(), hit) and int(got[2]) == int(hit.sum())
            and np.array_equal(got[1].cpu().numpy(), np.where(hit, idx * 7, 0))):
        raise AssertionError("broadcast_join_sum differs from numpy")

    def chain():
        i = torch.searchsorted(bk[:len(bk_host)], pk).clamp(max=len(bk_host) - 1)
        h = pv & (bk[i] == pk)
        return h, torch.where(h, bv[i], 0), h.sum()

    if any(not torch.equal(a, b) for a, b in zip(chain(), got)):
        raise AssertionError("the library chain differs from broadcast_join_sum")
    with plain_kernels():
        plain_ms = time_ms(lambda: join(pk, pv, bk, bv, len(bk_host)))
    MESH_DEMOS["broadcast_join_sum"] = {
        "shape": f"{n} slots x {cap:,} int64 probe rows, 4% null, against 102,000 sorted "
                 "build keys with repeats",
        "ms": time_ms(lambda: join(pk, pv, bk, bv, len(bk_host))), "plain_ms": plain_ms,
        "library_ms": time_ms(chain),
        "library_call": "torch.searchsorted + a take + compare + where + sum (a chain)",
        # probe keys and validity read once, the build's keys and payload
        # once, the hit and payload planes and the psum written once
        "bytes": n * cap * 9 + len(bk_host) * 16 + n * cap * 9 + 8, "hits": int(hit.sum())}
    for v in MESH_DEMOS.values():
        if "bytes" in v:
            v["bound_ms"] = v["bytes"] / HBM_BYTES_PER_S * 1e3
    log(json.dumps({"phase": "mesh_demos", **MESH_DEMOS}))
    torch.cuda.synchronize()


# -- phase 4: the paths on the card ------------------------------------------------


def stage_star(session, schemas, host, dev):
    """A star schema's host tables (``{name: (columns, valids)}``) on the
    card as ``session``'s resources: store_sales cut into PARTS
    partitions, its validity kept; each dimension one partition, all
    valid."""
    import torch

    for name, (cols, valids) in host.items():
        if name == "store_sales":
            cuts = [len(cols[0]) * p // PARTS for p in range(PARTS + 1)]
            parts = [stage_batches(schemas[name], [c[a:b] for c in cols], dev,
                                   valids=[v[a:b] for v in valids])
                     for a, b in zip(cuts, cuts[1:])]
        else:
            parts = [stage_batches(schemas[name], cols, dev)]
        session.resources[name] = lambda p, _parts=parts: _parts[p]
    torch.cuda.synchronize()


def stage_batches(schema, columns, dev, bs=262144, valids=None):
    """Host integer columns -> device batches of ``bs`` rows (the last one
    in its own capacity bucket), each in its field's plane type (a decimal
    as its int64 unscaled values); ``valids`` (None: all valid) gives a
    validity array, or None, per column (null rows carry data 0). A
    decimal(19..38) field's int64 values become a WideColumn's limbs."""
    import torch
    from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn, WideColumn
    from blaze_tpu_torch.ir import types as T

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
            d = torch.zeros(cap, dtype=T.torch_dtype(f.dtype) or torch.int64, device=dev)
            d[:n] = c[s:s + n]
            d[~v] = 0
            if T.is_wide_decimal(f.dtype):  # int64 values as the three limbs
                dcols.append(WideColumn(f.dtype, d & LO32, (d >> 32) & LO32, d >> 63, v))
            else:
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

    h = murmur3_long_np(b, murmur3_long_np(a, np.full(len(a), 42, np.uint32)))
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


MESH_SLOTS = (1, 2, 8)


def runs_of(profile):
    """How many times ``run_query`` runs a path: a first run and the
    measured one, and with ``--profile`` a torch.profiler and a cProfile
    run."""
    return 4 if profile else 2


def mesh_session(dev, k):
    """A session on a mesh of ``k`` slots on the card, with the fused
    stages' stacking runner: ``Session(device, mesh=make_mesh(k, dev),
    conf=Config(multichip_enabled=True))``."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.parallel.mesh import make_mesh

    return blaze_tpu_torch.Session(conf=Config(multichip_enabled=True), device=dev,
                                   mesh=make_mesh(k, dev))


def run_q01(dev, profile=False, trace_path=None):
    """q01, then q01_mesh1, q01_mesh2 and q01_mesh8 over the same staged
    data: every exchange on a mesh of 1, 2 and 8 slots (K17 once on the
    hash exchange and once on the single one, each launch of the first run
    held to its twin), each exact against the same oracle as q01."""
    import blaze_tpu_torch

    t0 = time.perf_counter()
    schema, parts, host = make_data(dev)
    setup_s = time.perf_counter() - t0
    session = blaze_tpu_torch.Session()
    session.resources["store_returns"] = lambda p: parts[p]
    want = q01_oracle(host)
    out = {"q01": run_query("q01", ROWS, session, q01_plan(schema), want, setup_s,
                            {"groups": len(want["sr_store_sk"])}, profile, trace_path,
                            first_run=k18_twin_check("q01"))}
    batches = sum(len(p) for p in parts)
    for k in MESH_SLOTS:
        name = f"q01_mesh{k}"
        session = mesh_session(dev, k)
        session.resources["store_returns"] = lambda p: parts[p]
        out[name] = run_query(name, ROWS, session, q01_plan(schema), want, setup_s,
                              {"groups": len(want["sr_store_sk"]), "slots": k}, profile,
                              trace_path.replace(".json", f"_{name}.json") if trace_path
                              else None, first_run=mesh_twin_check(name))
        if out[name]["mesh_all_to_all"] != 2:
            raise AssertionError(f"{name} launched K17 {out[name]['mesh_all_to_all']} times, "
                                 "not once for each of its two exchanges")
        if session.counters["sharded_stages"] != 2 * runs_of(profile):  # two exchanges a run
            raise AssertionError(f"{name}: {dict(session.counters)}")
    # the filter fuses into the partial aggregate: K18 a batch, no K1
    for name, launches in out.items():
        if launches["fused_agg_input"] != batches or launches["compact_planes"]:
            raise AssertionError(f"{name} launched K18 {launches['fused_agg_input']} and K1 "
                                 f"{launches['compact_planes']} times for {batches} batches")
    return out


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


def draw_join_tables(stage):
    """store_sales drawn as bench.py:make_data draws it, but with
    ss_item_sk uniform over the SF10 item keys [1, 102,001) so every row
    has its item (seed 6; ss_store_sk uniform [1, 400), ss_quantity [1,
    100), ss_sales_price decimal(7,2) unscaled [0, 50,000)), 28,800,991
    rows in 4 partitions, each partition's columns handed to ``stage`` as
    drawn; then the item dimension as bench.py draws it at SF10's 102,000
    rows (i_item_sk 1..102,000, i_category_id [0, 10), i_brand_id [1, 60),
    i_current_price [0, 30,000) unscaled). Returns (the ``stage`` results,
    the item columns, the generator, whose next draw is bench.py's store
    dimension)."""
    import numpy as np

    rng = np.random.default_rng(Q06_SEED)
    staged = []
    for p in range(PARTS):
        per = Q06_ROWS // PARTS + (1 if p < Q06_ROWS % PARTS else 0)
        staged.append(stage(p, (rng.integers(1, Q06_ITEMS + 1, per),
                                rng.integers(1, N_STORES, per), rng.integers(1, 100, per),
                                rng.integers(0, 500_00, per))))
    n = Q06_ITEMS
    item_cols = (np.arange(1, n + 1), rng.integers(0, 10, n), rng.integers(1, 60, n),
                 rng.integers(0, 300_00, n))
    return staged, item_cols, rng


def make_join_data(dev):
    """q06's and q47's tables (``draw_join_tables``), both staged on the
    card, the item dimension in one batch. The wide ss_ext_wholesale_cost
    is left out: neither query reads it."""
    import torch
    from blaze_tpu_torch.ir import types as T

    price = T.DecimalType(7, 2)
    sales = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                        ("ss_quantity", T.I64), ("ss_sales_price", price))
    item = T.Schema.of(("i_item_sk", T.I64), ("i_category_id", T.I64),
                       ("i_brand_id", T.I64), ("i_current_price", price))
    host = []

    def stage(p, cols):
        host.append((cols[0], cols[2], cols[3]))
        return stage_batches(sales, cols, dev)

    parts, item_cols, _ = draw_join_tables(stage)
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
        batches = sum(len(p) for p in parts)
        if out[name]["fused_agg_input"] != batches or out[name]["inner_join_planes"]:
            raise AssertionError(f"{name}'s join did not fuse into its partial aggregate: "
                                 f"K18 {out[name]['fused_agg_input']}, K8 "
                                 f"{out[name]['inner_join_planes']} for {batches} batches")
    return out


# q17: bench.py's own stream for ss_ext_wholesale_cost (bench.py:128-139)
Q17_WIDE_SEED = 421
Q17_STATES, Q17_CATEGORIES = 50, 10
# q17_table's merge budget: below one partial state batch of q17 (~500
# groups in a 512-row bucket, ~34 KB), so no map task consolidates and
# every reducer's FINAL merge is the host table's (K12 with limb merges)
Q17_TABLE_MERGE_BYTES = 16 << 10


def make_q17_data(dev):
    """q17's tables: ``draw_join_tables``' store_sales (q06's draw) with
    ss_sales_price left out and ss_ext_wholesale_cost added, decimal(38,2)
    drawn as bench.py draws it (its own stream, seed 421: unscaled uniform
    [10^14, 9 * 10^16)), staged on the card as three limb planes; the item
    dimension; the store dimension as bench.py:156 draws it (400 rows,
    s_state_id uniform [0, 50), the next draw of the same generator).
    Returns (schemas, sales partitions, item batches, store batches, the
    host columns the oracle reads)."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ir import types as T

    price = T.DecimalType(7, 2)
    sales = T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64),
                        ("ss_quantity", T.I64), ("ss_ext_wholesale_cost", T.DecimalType(38, 2)))
    item = T.Schema.of(("i_item_sk", T.I64), ("i_category_id", T.I64),
                       ("i_brand_id", T.I64), ("i_current_price", price))
    store = T.Schema.of(("s_store_sk", T.I64), ("s_state_id", T.I64))
    rng_wide = np.random.default_rng(Q17_WIDE_SEED)
    host = []

    def stage(p, cols):
        wcost = rng_wide.integers(10 ** 14, 9 * 10 ** 16, len(cols[0]))
        cols = (cols[0], cols[1], cols[2], wcost)
        host.append(cols)
        return stage_batches(sales, cols, dev)

    parts, item_cols, rng = draw_join_tables(stage)
    store_cols = (np.arange(1, N_STORES + 1), rng.integers(0, Q17_STATES, N_STORES))
    items = stage_batches(item, item_cols, dev)
    stores = stage_batches(store, store_cols, dev)
    torch.cuda.synchronize()
    return (sales, item, store), parts, items, stores, (host, item_cols, store_cols)


def q17_plan(sales, item, store):
    """bench.py:265 plan_q17: store_sales JOIN item JOIN store -> COUNT(*),
    SUM(ss_quantity), SUM(ss_ext_wholesale_cost) (decimal(38,2): three-limb
    states across the exchange) by (s_state_id, i_category_id) -> single
    exchange -> sort."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N

    F = E.AggFunction
    j2 = N.BroadcastJoin(item_join(sales, item, "bench_items17"),
                         N.BroadcastExchange(N.FFIReader(store, "store", 1)),
                         [(E.Column("ss_store_sk"), E.Column("s_store_sk"))],
                         N.JoinType.INNER, N.JoinSide.RIGHT, "bench_stores17")
    agg = two_stage_agg(j2, ["s_state_id", "i_category_id"], [
        ("n", E.AggExpr(F.COUNT, [])), ("qty", E.AggExpr(F.SUM, [E.Column("ss_quantity")])),
        ("wcost", E.AggExpr(F.SUM, [E.Column("ss_ext_wholesale_cost")]))])
    return N.Sort(N.ShuffleExchange(agg, N.SinglePartitioning(1)),
                  [E.SortOrder(E.Column("s_state_id")), E.SortOrder(E.Column("i_category_id"))])


def q17_oracle(host, item_cols, store_cols):
    """q17's answer in numpy, exact: each row's group id (state * 10 +
    category, by index into the dimensions), then per group the row count
    and ``np.bincount`` sums of the quantity and of each wcost value's low
    32 bits and high part. Every per-group chunk total stays below 2^53
    (at most ~230,000 rows of < 2^32), so the float64 sums are exact; the
    <= 500 group totals combine into Python ints."""
    import decimal

    import numpy as np

    groups = Q17_STATES * Q17_CATEGORIES
    cnt = np.zeros(groups, np.int64)
    qty, lo, hi = (np.zeros(groups) for _ in range(3))
    for it, st, q, w in host:
        g = store_cols[1][st - 1] * Q17_CATEGORIES + item_cols[1][it - 1]
        cnt += np.bincount(g, minlength=groups)
        qty += np.bincount(g, weights=q, minlength=groups)
        lo += np.bincount(g, weights=w & LO32, minlength=groups)
        hi += np.bincount(g, weights=w >> 32, minlength=groups)
    present = np.nonzero(cnt)[0]
    ctx = decimal.Context(prec=80)
    return {"s_state_id": (present // Q17_CATEGORIES).tolist(),
            "i_category_id": (present % Q17_CATEGORIES).tolist(),
            "n": cnt[present].tolist(), "qty": [int(x) for x in qty[present]],
            "wcost": [decimal.Decimal((int(h) << 32) + int(x)).scaleb(-2, ctx)
                      for h, x in zip(hi[present], lo[present])]}


@contextlib.contextmanager
def merge_inputs(seen):
    """While open, adds (kind, rows, capacity) of each merge's input to
    ``seen``: a device merge's concatenated state batches ("device"), a
    state batch the host table merges ("table")."""
    from blaze_tpu_torch.ops import agg as G
    from blaze_tpu_torch.ops import agg_device as A

    run, process = A.DeviceMergeAgger.run, G.AggTable.process_batch

    def run_seen(self, batches):
        live = [b for b in batches if b.num_rows]
        rows = sum(b.num_rows for b in live)
        if live:
            seen.add(("device", rows, live[0].capacity if len(live) == 1
                      else self.conf.capacity_for(rows)))
        return run(self, batches)

    def process_seen(self, batch):
        if self.op.input_is_partial and batch.num_rows:
            seen.add(("table", batch.num_rows, batch.capacity))
        return process(self, batch)

    A.DeviceMergeAgger.run, G.AggTable.process_batch = run_seen, process_seen
    try:
        yield
    finally:
        A.DeviceMergeAgger.run, G.AggTable.process_batch = run, process


def run_q17(dev, profile=False, trace_path=None):
    """q17 whole over one staged draw on four routes: the default Config
    (K18 over both joins, then K3's dense partial with the three-limb sum
    over its live mask, K4's merges), the sort route (``dense_agg=False,
    radix_agg=False``: K18, then K10), the host table's FINAL merge
    (``Q17_TABLE_MERGE_BYTES``: K12's limb merges), and q17_unfused
    (``fused_filter_agg=False``: the joins through K8, then K3); each
    exact in order against ``q17_oracle``, the wide totals past int64;
    every K18 launch of q17's first run held to its plain version."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    t0 = time.perf_counter()
    (sales, item, store), parts, items, stores, host = make_q17_data(dev)
    want = q17_oracle(*host)
    del host
    if not any(w >= 2 ** 63 for w in (int(x.scaleb(2)) for x in want["wcost"])):
        raise AssertionError("q17's wcost totals stay within int64: no limb state is needed")
    setup_s = time.perf_counter() - t0
    sales_batches = sum(len(p) for p in parts)
    if sales_batches != PARTS * Q17_TASK_BATCHES:
        raise AssertionError(f"{sales_batches} sales batches, not {PARTS} x {Q17_TASK_BATCHES}")
    # each route's merge inputs (kind, rows, capacity), held to the shapes
    # at which time_limbs compared and timed the limb merges
    fcap = Config().capacity_for(Q17_FINAL_ROWS)
    merges = {"q17": {("device", Q17_MERGE_ROWS, Config().capacity_for(Q17_MERGE_ROWS)),
                      ("device", PARTS * Q17_GROUPS, Config().capacity_for(PARTS * Q17_GROUPS))},
              "q17_sort": {("device", Q17_FINAL_ROWS, fcap)},
              "q17_table": {("table", Q17_FINAL_ROWS, fcap)}}
    merges["q17_unfused"] = merges["q17"]
    out = {}
    for name, conf in (("q17", Config()), ("q17_sort", Config(dense_agg=False, radix_agg=False)),
                       ("q17_table", Config(device_merge_max_bytes=Q17_TABLE_MERGE_BYTES)),
                       ("q17_unfused", Config(fused_filter_agg=False))):
        session = blaze_tpu_torch.Session(conf=conf)
        session.resources["store_sales"] = lambda p: parts[p]
        session.resources["item"] = lambda p: items
        session.resources["store"] = lambda p: stores
        path_trace = trace_path.replace(".json", "") + f"_{name}.json" if trace_path else None
        seen = set()
        with merge_inputs(seen):
            out[name] = run_query(name, Q06_ROWS, session, q17_plan(sales, item, store), want,
                                  setup_s, {"groups": len(want["n"]), "items": Q06_ITEMS,
                                            "stores": N_STORES}, profile, path_trace,
                                  first_run=k18_twin_check(name) if name == "q17"
                                  else contextlib.nullcontext())
        if seen != merges[name]:
            raise AssertionError(f"{name}'s merge inputs {sorted(seen)} are not the shapes "
                                 f"the limb merges were held at, {sorted(merges[name])}")
        k8, k18 = out[name]["inner_join_planes"], out[name]["fused_agg_input"]
        if (name == "q17_unfused" and (k8 < 2 * sales_batches or k18)) or \
                (name != "q17_unfused" and (k8 or k18 != sales_batches)):
            raise AssertionError(f"{name} launched K8 {k8} and K18 {k18} times for "
                                 f"{sales_batches} sales batches and two joins")
    routes = {"q17": ("slot_agg_partial:sum3", "slot_agg_merge:sum3"),
              "q17_unfused": ("slot_agg_partial:sum3", "slot_agg_merge:sum3"),
              "q17_sort": ("seg_agg_partial:sum3", "seg_agg_merge:sum3"),
              "q17_table": ("slot_agg_partial:sum3", "slot_update:renorm3")}
    for name, keys in routes.items():
        missing = [k for k in keys if out[name].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{name} did not launch the limb ops {missing}")
    if out["q17_table"]["slot_agg_merge"] or out["q17_table"]["seg_agg_merge"]:
        raise AssertionError("q17_table merged on the device, not in the host table")
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


def q69_customers(schemas, E, N, T, states=Q69_STATES, parts=PARTS):
    """q69's customer side as Spark plans it: customer (isnotnull on both
    foreign keys) JOIN broadcast customer_address (ca_state IN (...) AND
    isnotnull(ca_address_sk)), built with the IR modules ``E``, ``N``,
    ``T`` of either package."""
    C = E.Column

    def both(a, b):
        return E.BinaryExpr(E.BinaryOp.AND, a, b)

    address = N.Filter(N.FFIReader(schemas["customer_address"], "customer_address", 1),
                       [both(E.InList(C("ca_state_id"), [E.Literal(s, T.I64) for s in states]),
                             E.IsNotNull(C("ca_address_sk")))])
    customer = N.Filter(N.FFIReader(schemas["customer"], "customer", parts),
                        [both(E.IsNotNull(C("c_current_addr_sk")),
                              E.IsNotNull(C("c_current_cdemo_sk")))])
    return N.BroadcastJoin(customer, N.BroadcastExchange(address),
                           [(C("c_current_addr_sk"), C("ca_address_sk"))], N.JoinType.INNER,
                           N.JoinSide.RIGHT, "q69_address")


def q69_plan(schemas, E=None, N=None, T=None, states=Q69_STATES, parts=PARTS, bloom=None):
    """TPC-DS q69 (v3.2.0) as Spark plans it, in ``parts`` partitions, with
    the null filters Spark's InferFiltersFromConstraints puts on the scans:
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
    join matches a null key.

    ``bloom``, a serialized bloom filter of xxhash64(c_customer_sk) (the
    scalar subquery ``q69_bloom_subquery`` computes), adds Spark's runtime
    filter on the store side, merged into its scan filter as CombineFilters
    leaves it: [isnotnull(ss_sold_date_sk) AND isnotnull(ss_customer_sk),
    might_contain(bloom, xxhash64(ss_customer_sk))]; the probe is not
    fusable, so that filter runs eagerly (K15, K16, K1). The web and
    catalog windows are LEFT ANTI, which Spark does not prune. ``E``,
    ``N``, ``T``: the IR modules (default: this package's)."""
    if E is None:
        from blaze_tpu_torch.ir import exprs as E
        from blaze_tpu_torch.ir import nodes as N
        from blaze_tpu_torch.ir import types as T

    C = E.Column
    J = N.JoinType

    def lit(op, c, v):
        return E.BinaryExpr(op, C(c), E.Literal(v, T.I64))

    def scan(name, n=parts):
        return N.FFIReader(schemas[name], name, n)

    def by(child, keys):
        return N.ShuffleExchange(child, N.HashPartitioning([C(k) for k in keys], parts))

    def notnull(a, b):
        return E.BinaryExpr(E.BinaryOp.AND, E.IsNotNull(C(a)), E.IsNotNull(C(b)))

    eq = E.BinaryOp.EQ
    cust = q69_customers(schemas, E, N, T, states, parts)
    out = by(N.Projection(cust, [C("c_customer_sk"), C("c_current_cdemo_sk")],
                          ["c_customer_sk", "c_current_cdemo_sk"]), ["c_customer_sk"])
    dates = N.Filter(scan("date_dim", 1), [lit(eq, "d_year", 2001),
                                           lit(E.BinaryOp.GTEQ, "d_moy", 4),
                                           lit(E.BinaryOp.LTEQ, "d_moy", 6),
                                           E.IsNotNull(C("d_date_sk"))])
    for name, dcol, ccol, jt in Q69_SALES:
        preds = [notnull(dcol, ccol)]
        if bloom is not None and name == "store_sales":
            preds.append(E.BloomFilterMightContain(
                E.ScalarSubquery(bloom, T.BINARY), E.ScalarFunction("xxhash64", [C(ccol)])))
        window = N.BroadcastJoin(N.Filter(scan(name), preds),
                                 N.BroadcastExchange(dates),
                                 [(C(dcol), C("d_date_sk"))], J.INNER, N.JoinSide.RIGHT,
                                 f"q69_dates_{name}")
        window = by(N.Projection(window, [C(ccol)], [ccol]), [ccol])
        out = N.HashJoin(out, window, [(C("c_customer_sk"), C(ccol))], J[jt],
                         N.JoinSide.RIGHT)
    out = N.BroadcastJoin(out, N.BroadcastExchange(scan("customer_demographics", 1)),
                          [(C("c_current_cdemo_sk"), C("cd_demo_sk"))], J.INNER,
                          N.JoinSide.RIGHT, "q69_demographics")
    keys = [(k, C(k)) for k in Q69_KEYS]
    count = E.AggExpr(E.AggFunction.COUNT, [])
    partial = N.Agg(out, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(count, E.AggMode.PARTIAL, "cnt")],
                    supports_partial_skipping=True)
    agg = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([e for _, e in keys], parts)),
                E.AggExecMode.HASH_AGG, keys, [N.AggColumn(count, E.AggMode.FINAL, "cnt")])
    return N.Sort(N.ShuffleExchange(agg, N.SinglePartitioning(1)),
                  [E.SortOrder(C(k)) for k in Q69_KEYS], fetch_limit=100)


def q69_bloom_subquery(schemas, E, N, T, states=Q69_STATES, parts=PARTS):
    """The scalar subquery of Spark's runtime filter on q69's store side
    (InjectRuntimeFilter): q69's customer side projected to c_customer_sk
    -> single exchange -> bloom_filter(xxhash64(c_customer_sk)) as "bf",
    COMPLETE without keys (Spark runs it as a partial before the exchange
    and a final after it; OR-ing the partial bitmaps gives the same
    filter)."""
    C = E.Column
    keys = N.ShuffleExchange(
        N.Projection(q69_customers(schemas, E, N, T, states, parts), [C("c_customer_sk")],
                     ["c_customer_sk"]), N.SinglePartitioning(1))
    bf = E.AggExpr(E.AggFunction.BLOOM_FILTER,
                   [E.ScalarFunction("xxhash64", [C("c_customer_sk")])])
    return N.Agg(keys, E.AggExecMode.HASH_AGG, [], [N.AggColumn(bf, E.AggMode.COMPLETE, "bf")])


def q69_bloom_collect(session, subquery, schemas, blobs):
    """q69_bloom as the frontend runs it: the subquery first, its one value
    shipped as a ScalarSubquery into q69's store filter, then the query;
    each run's filter goes to ``blobs``."""
    blob = session.execute_to_pydict(subquery)["bf"][0]
    blobs.append(blob)
    return session.execute_to_pydict(q69_plan(schemas, bloom=blob))


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


def find_node(plan, pred):
    """The first node of ``plan`` (depth first) for which ``pred`` holds."""
    if pred(plan):
        return plan
    for child in plan.children():
        hit = find_node(child, pred)
        if hit is not None:
            return hit
    return None


def q69_bloom_oracle(host):
    """Spark's runtime filter on q69's store side in numpy (xxh64_np and
    this file's bloom, not the port's code): the filter of xxhash64 of the
    creation side's customers (non-null address and demographics keys,
    address in the three states) at Spark's defaults (1,000,000 items,
    8,388,608 bits, k = 6), its serialized bytes, and the store rows the
    merged filter keeps (non-null customer whose hash passes the probe),
    with the false positives among them and the members it missed (0 for
    any bloom filter). The probe depends only on the customer key, so it
    is taken once a key."""
    import numpy as np

    (c_sk, c_addr, _c_cd), (_, addr_v, cd_v) = host["customer"]
    (ca_sk, ca_state), _ = host["customer_address"]
    in_states = np.zeros(Q69_ROWS["customer_address"] + 1, bool)
    in_states[ca_sk[np.isin(ca_state, Q69_STATES)]] = True
    creation = c_sk[addr_v & cd_v & in_states[c_addr]]
    words, k = bloom_np_create()
    bloom_np_put(words, k, xxh64_np([creation], [None]))
    keys = np.arange(Q69_ROWS["customer"] + 1)
    passes = bloom_np_probe(words, k, xxh64_np([keys], [None]))
    member = np.zeros(len(keys), bool)
    member[creation] = True
    (_date, cust), (_, cust_v) = host["store_sales"]
    kept = cust_v & passes[cust]
    return {"blob": bloom_np_serialize(words, k), "k": k, "creation_rows": int(len(creation)),
            "bits_set": int(np.unpackbits(words.view(np.uint8)).sum()),
            "store_rows": int(len(cust)), "kept_rows": int(kept.sum()),
            "false_positive_rows": int((kept & ~member[cust]).sum()),
            "false_positive_keys": int((passes & ~member)[1:].sum()),
            "missed_rows": int((cust_v & member[cust] & ~passes[cust]).sum())}


BLOOM_PATH_TIMES = {}


@contextlib.contextmanager
def bloom_twin_check(name):
    """While open, every K16 launch through ``SparkBloomFilter.
    might_contain_long`` is also held to its twin on the same values and
    bitmap (``bloom_probe:<name> batch``); the first such batch is then
    timed (K16 by events and on the device, its twin) into
    ``BLOOM_PATH_TIMES[name]``."""
    from blaze_tpu_torch.ops import bloom as B

    fn = B.SparkBloomFilter.might_contain_long
    first, checked_batches = [], [0]

    def checked(bf, values):
        got = fn(bf, values)
        args = (values, bf.device_words(values.device), bf.num_hash_functions, bf.bit_size)
        check_equal("bloom_probe", f"{name} batch", got, B.might_contain_long_plain(*args))
        if not first:
            first.append(args)
        checked_batches[0] += 1
        return got

    B.SparkBloomFilter.might_contain_long = checked
    try:
        yield
    finally:
        B.SparkBloomFilter.might_contain_long = fn
    if not first:
        raise AssertionError(f"{name}'s first run launched no K16")
    args = first[0]
    BLOOM_PATH_TIMES[name] = {
        "checked_batches": checked_batches[0], "rows": int(args[0].shape[0]),
        "k": args[2], "bit_size": args[3],
        "ms": time_ms(lambda: B.bloom_probe_cuda(*args)),
        "device_ms": kernel_device_ms(lambda: B.bloom_probe_cuda(*args), "blz_bloom_probe"),
        "plain_ms": time_ms(lambda: B.might_contain_long_plain(*args))}


def run_q69(dev, profile=False, trace_path=None):
    """q69 and q69_bloom on one draw of q69's tables at SF10: q69 as Spark
    plans it, then with Spark's runtime bloom filter on the store side
    (the subquery and the query, both timed), exact against the same
    oracle; the bloom path's filter byte for byte against the numpy one,
    its store side's kept rows against the numpy probe's, every K16
    launch of its first run held to the twin, and K16 once a store batch."""
    import blaze_tpu_torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schemas, staged, host = make_q69_data(dev)
    want, steps, agg_rows = q69_oracle(host)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bloom = q69_bloom_oracle(host)
    bloom_setup_s = time.perf_counter() - t0
    del host
    session = blaze_tpu_torch.Session()
    for name, parts in staged.items():
        session.resources[name] = lambda p, _parts=parts: _parts[p]
    info = {"customers_after": steps, "agg_rows": agg_rows, "groups": len(want["cnt"])}
    out = {"q69": run_query("q69", sum(Q69_ROWS.values()), session, q69_plan(schemas), want,
                            setup_s, info, profile, trace_path)}
    # q69_bloom: the frontend runs the subquery, then ships its value
    blob = bloom.pop("blob")
    blobs = []
    subquery = q69_bloom_subquery(schemas, E, N, T)
    store_batches = len(staged["store_sales"][0]) * PARTS
    out["q69_bloom"] = run_query(
        "q69_bloom", sum(Q69_ROWS.values()) + Q69_ROWS["customer"] +
        Q69_ROWS["customer_address"], session, subquery, want, setup_s + bloom_setup_s,
        {**info, "bloom": bloom, "numpy_bloom_s": bloom_setup_s}, profile,
        trace_path[:-len(".json")] + "_bloom.json" if trace_path else None,
        collect=lambda s, plan: q69_bloom_collect(s, plan, schemas, blobs),
        first_run=bloom_twin_check("q69_bloom"))
    if any(b != blob for b in blobs):
        raise AssertionError("q69_bloom's filter differs from the numpy filter")
    checked = BLOOM_PATH_TIMES["q69_bloom"]["checked_batches"]
    if checked != store_batches:
        raise AssertionError(f"q69_bloom's first run held {checked} K16 launches to the "
                             f"twin, not one a store batch ({store_batches})")
    # the store side alone: the rows its merged filter keeps
    store = find_node(q69_plan(schemas, bloom=blob), lambda n: isinstance(n, N.Filter) and
                      getattr(n.child, "resource_id", None) == "store_sales")
    kept = sum(b.num_rows for b in session.execute(store))
    log(json.dumps({"phase": "q69_bloom_store_side", "kept_rows": kept,
                    "numpy_kept_rows": bloom["kept_rows"],
                    "false_positive_rows": bloom["false_positive_rows"],
                    "missed_rows": bloom["missed_rows"], "store_rows": bloom["store_rows"]}))
    if kept != bloom["kept_rows"] or bloom["missed_rows"]:
        raise AssertionError(f"q69_bloom's store side kept {kept} rows, the numpy probe "
                             f"{bloom['kept_rows']} (missed {bloom['missed_rows']})")
    return out


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
    stage_star(session, schemas, host, dev)
    del host
    setup_s = time.perf_counter() - t0
    out = {"q96": run_query("q96", sum(Q96_ROWS.values()), session, q96_plan(schemas, E, N, T),
                            want, setup_s, {"count": want["cnt"][0]}, profile, trace_path)}
    # q96_mesh: the same data on a mesh of 8 slots; the store_sales filter's
    # batches stack 8 at a time within each run of one capacity (a stack of
    # one runs alone), the single exchange rides K17
    mesh = mesh_session(dev, 8)
    for name in q96_schemas(T):
        mesh.resources[name] = session.resources[name]
    stacks = stacked = 0
    for p in range(PARTS):
        caps = [b.capacity for b in session.resources["store_sales"](p)]
        runs = [len(list(g)) for _c, g in itertools.groupby(caps)]
        stacks += sum(L // 8 + (L % 8 >= 2) for L in runs)
        stacked += sum(L - (L % 8 == 1) for L in runs)
    launches = run_query("q96_mesh", sum(Q96_ROWS.values()), mesh, q96_plan(schemas, E, N, T),
                         want, setup_s, {"count": want["cnt"][0], "slots": 8,
                                         "stacks": stacks, "stacked_batches": stacked},
                         profile, trace_path.replace(".json", "_mesh.json") if trace_path
                         else None, first_run=mesh_twin_check("q96_mesh", stacks))
    if launches["fused_chain_stacked"] != stacks or \
            launches["fused_chain"] != out["q96"]["fused_chain"] - stacked:
        raise AssertionError(
            f"q96_mesh launched the stacked K11 {launches['fused_chain_stacked']} times and K11 "
            f"{launches['fused_chain']} times, not {stacks} stacks of {stacked} batches and "
            f"q96's {out['q96']['fused_chain']} less them")
    if launches["mesh_all_to_all"] != 1 or \
            mesh.counters["sharded_batches"] != runs_of(profile) * stacked:
        raise AssertionError(f"q96_mesh: K17 {launches['mesh_all_to_all']} times, "
                             f"{dict(mesh.counters)}")
    out["q96_mesh"] = launches
    return out


# -- q89: a window AVG over an aggregate (K13) -----------------------------------

Q89_SEED = 89
# TPC-DS SF10 row counts of q89's tables
Q89_ROWS = {"store_sales": 28_800_991, "item": 102_000, "date_dim": 73_049, "store": 102}
# i_category as a code of TPC-DS's ten categories in this order: Books,
# Children, Electronics, Home, Jewelry, Men, Music, Shoes, Sports, Women;
# i_class as a code of 100 classes, the query's class01..class06 codes 1..6;
# i_brand as TPC-DS builds i_brand_id, category * 10^6 + class * 10^3 + a
# brand index (1..Q89_BRANDS); s_store_name of Q96_NAMES names and
# s_company_name of Q89_COMPANIES names, uniform over the stores
Q89_CATS_A, Q89_CLASSES_A = (0, 2, 8), (1, 2, 3)    # Books, Electronics, Sports
Q89_CATS_B, Q89_CLASSES_B = (5, 4, 9), (4, 5, 6)    # Men, Jewelry, Women
Q89_CLASSES = 100
Q89_BRANDS = 20
Q89_COMPANIES = 6
# d_date_sk of 1998-01-01 and 2002-12-31: TPC-DS's five sales years
Q89_SALES_DATES = (2_450_815, 2_452_640)
Q89_KEYS = ("i_category_id", "i_class_id", "i_brand_id", "s_store_name",
            "s_company_name", "d_moy")
Q89_PARTITION = ("i_category_id", "i_brand_id", "s_store_name", "s_company_name")


def q89_schemas(T):
    def sch(*names):
        return T.Schema.of(*[(n, T.I64) for n in names])

    return {"store_sales": sch("ss_item_sk", "ss_sold_date_sk", "ss_store_sk", "ss_quantity"),
            "item": sch("i_item_sk", "i_category_id", "i_class_id", "i_brand_id"),
            "date_dim": sch("d_date_sk", "d_year", "d_moy"),
            "store": sch("s_store_sk", "s_store_name", "s_company_name")}


def q89_host(rows, seed=Q89_SEED, null_share=0.04):
    """q89's tables on the host, at ``rows``' row counts: items with
    category, class and brand drawn as Q89_* says; date_dim from
    2,415,022 (1900-01-02), d_year and d_moy from the date; stores with a
    name and a company; store_sales with its item and store uniform over
    their keys, its sale date uniform over the five sales years, ``null_share``
    of each foreign key null (data 0), ss_quantity uniform [1, 100].
    Returns {table: (columns, validities or None)}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = rows["item"]
    cat = rng.integers(0, 10, n)
    cls = rng.integers(0, Q89_CLASSES, n)
    brand = cat * 1_000_000 + cls * 1_000 + rng.integers(1, Q89_BRANDS + 1, n)
    host = {"item": ((np.arange(1, n + 1), cat, cls, brand), None)}
    days = np.arange(2_415_022, 2_415_022 + rows["date_dim"])
    date = np.datetime64("1900-01-02") + (days - 2_415_022)
    host["date_dim"] = ((days, date.astype("datetime64[Y]").astype(np.int64) + 1970,
                         date.astype("datetime64[M]").astype(np.int64) % 12 + 1), None)
    n = rows["store"]
    host["store"] = ((np.arange(1, n + 1), rng.integers(0, Q96_NAMES, n),
                      rng.integers(0, Q89_COMPANIES, n)), None)
    n = rows["store_sales"]
    cols, valids = [], []
    for lo, hi in ((1, rows["item"] + 1), (Q89_SALES_DATES[0], Q89_SALES_DATES[1] + 1),
                   (1, rows["store"] + 1)):
        v = rng.random(n) >= null_share
        cols.append(np.where(v, rng.integers(lo, hi, n), 0))
        valids.append(v)
    cols.append(rng.integers(1, 101, n))
    valids.append(np.ones(n, bool))
    host["store_sales"] = (tuple(cols), tuple(valids))
    return host


def q89_plan(schemas, E, N, T, parts=PARTS):
    """TPC-DS q89 (v3.2.0) as Spark plans it (tests/tpcds/queries.py:1203),
    with the null filters Spark infers on the scans, in the IR modules
    ``E``, ``N``, ``T`` of either package: store_sales (isnotnull on its
    three keys) JOIN broadcast item ((i_category IN (Books, Electronics,
    Sports) AND i_class IN (class01..03)) OR (i_category IN (Men, Jewelry,
    Women) AND i_class IN (class04..06))) JOIN broadcast date_dim (d_year =
    1999) JOIN broadcast store -> PARTIAL SUM(ss_quantity) by (category,
    class, brand, store name, company name, month) -> hash exchange ->
    FINAL -> hash exchange by (category, brand, store name, company name)
    -> sort on them -> Window avg(sum_sales) over that partition (no order:
    the whole partition) -> filter |sum - avg| / avg > 0.1 -> single
    exchange -> ORDER BY sum_sales - avg_monthly_sales, s_store_name LIMIT
    100. The filter is Spark's own: CASE WHEN NOT (avg_monthly_sales = 0.0)
    THEN abs(CAST(sum_sales AS DOUBLE) - avg_monthly_sales) /
    avg_monthly_sales ELSE CAST(NULL AS DOUBLE) END > 0.1 (a ScalarFunction,
    so it runs unfused: K1 compacts it). Strings are int codes; ss_quantity
    stands for ss_sales_price, so sum_sales is a bigint (PERF.md section 4)."""
    C, B = E.Column, E.BinaryOp
    J = N.JoinType

    def scan(name, p=1):
        return N.FFIReader(schemas[name], name, p)

    def all_of(*preds):
        out = preds[0]
        for p in preds[1:]:
            out = E.BinaryExpr(B.AND, out, p)
        return out

    def nn(*cols):
        return [E.IsNotNull(C(c)) for c in cols]

    def among(c, codes):
        return E.InList(C(c), [E.Literal(v, T.I64) for v in codes])

    sales = N.Filter(scan("store_sales", parts),
                     [all_of(*nn("ss_item_sk", "ss_sold_date_sk", "ss_store_sk"))])
    lists = [all_of(among("i_category_id", cats), among("i_class_id", classes))
             for cats, classes in ((Q89_CATS_A, Q89_CLASSES_A), (Q89_CATS_B, Q89_CLASSES_B))]
    item = N.Filter(scan("item"), [all_of(E.BinaryExpr(B.OR, *lists), *nn("i_item_sk"))])
    date = N.Filter(scan("date_dim"), [all_of(
        *nn("d_year"), E.BinaryExpr(B.EQ, C("d_year"), E.Literal(1999, T.I64)),
        *nn("d_date_sk"))])
    store = N.Filter(scan("store"), nn("s_store_sk"))
    out = sales
    for dim, fk, pk in ((item, "ss_item_sk", "i_item_sk"),
                        (date, "ss_sold_date_sk", "d_date_sk"),
                        (store, "ss_store_sk", "s_store_sk")):
        out = N.BroadcastJoin(out, N.BroadcastExchange(dim), [(C(fk), C(pk))], J.INNER,
                              N.JoinSide.RIGHT, f"q89_{pk}")
    keys = [(k, C(k)) for k in Q89_KEYS]
    total = E.AggExpr(E.AggFunction.SUM, [C("ss_quantity")])
    partial = N.Agg(out, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(total, E.AggMode.PARTIAL, "sum_sales")],
                    supports_partial_skipping=True)
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([c for _, c in keys], parts)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(total, E.AggMode.FINAL, "sum_sales")])
    pkeys = [C(k) for k in Q89_PARTITION]
    srt = N.Sort(N.ShuffleExchange(final, N.HashPartitioning(pkeys, parts)),
                 [E.SortOrder(k) for k in pkeys])
    win = N.Window(srt, [N.WindowExpr("agg", "avg_monthly_sales",
                                      E.AggExpr(E.AggFunction.AVG, [C("sum_sales")]))],
                   pkeys, [])
    s, a = C("sum_sales"), C("avg_monthly_sales")
    ratio = E.BinaryExpr(B.DIV, E.ScalarFunction(
        "abs", [E.BinaryExpr(B.SUB, E.Cast(s, T.F64), a)]), a)
    case = E.Case([(E.Not(E.BinaryExpr(B.EQ, a, E.Literal(0.0, T.F64))), ratio)],
                  E.Literal(None, T.F64))
    kept = N.Filter(win, [E.BinaryExpr(B.GT, case, E.Literal(0.1, T.F64))])
    return N.Sort(N.ShuffleExchange(kept, N.SinglePartitioning(1)),
                  [E.SortOrder(E.BinaryExpr(B.SUB, s, a)), E.SortOrder(C("s_store_name"))],
                  fetch_limit=100)


def q89_window_input(host):
    """The window's input rows in numpy, from the host copies: the joined
    sales summed by q89's six keys. Returns (keys as six int64 arrays,
    sum_sales)."""
    import numpy as np

    (i_sk, cat, cls, brand), _ = host["item"]
    (d_sk, year, moy), _ = host["date_dim"]
    (s_sk, sname, cname), _ = host["store"]
    (item, date, store, qty), (iv, dv, sv, _qv) = host["store_sales"]
    i_ok = np.zeros(i_sk.max() + 1, bool)
    i_ok[i_sk[(np.isin(cat, Q89_CATS_A) & np.isin(cls, Q89_CLASSES_A))
              | (np.isin(cat, Q89_CATS_B) & np.isin(cls, Q89_CLASSES_B))]] = True
    d_ok = np.zeros(d_sk.max() + 1, bool)
    d_ok[d_sk[year == 1999]] = True
    keep = iv & dv & sv & i_ok[item] & d_ok[np.clip(date, 0, d_sk.max())]
    item, date, store, qty = item[keep], date[keep], store[keep], qty[keep]
    ii, di, si = item - 1, date - d_sk[0], store - 1
    cols = (cat[ii], cls[ii], brand[ii], sname[si], cname[si], moy[di])
    uniq, inv = np.unique(np.stack(cols), axis=1, return_inverse=True)
    return tuple(uniq), _group_sums(inv.reshape(-1), qty, uniq.shape[1])


def _group_sums(inv, vals, groups):
    import numpy as np

    out = np.zeros(groups, np.int64)
    np.add.at(out, inv, vals)
    return out


def q89_oracle(host):
    """q89 in numpy: the window input's average per (category, brand,
    store name, company name) as float64(sum) / float64(count), the rows
    whose sum differs from it by more than 10% (Spark's CASE form), ordered by (sum - avg,
    store name). Returns (the check for the result, the window's input
    rows and partitions, the window's rows as eight planes: the six keys,
    sum_sales and the partition's average)."""
    import numpy as np

    keys, sums = q89_window_input(host)
    part = np.stack([keys[Q89_KEYS.index(k)] for k in Q89_PARTITION])
    _u, pinv = np.unique(part, axis=1, return_inverse=True)
    pinv = pinv.reshape(-1)
    npart = int(pinv.max()) + 1 if len(pinv) else 0
    psum = _group_sums(pinv, sums, npart)
    pcnt = np.bincount(pinv, minlength=npart)
    avg = psum.astype(np.float64) / pcnt.astype(np.float64)
    a = avg[pinv]
    s = sums.astype(np.float64)
    # Spark's form, as the plan carries it: CASE WHEN avg <> 0 THEN
    # abs(sum - avg) / avg ELSE null END > 0.1
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = (a != 0) & (np.abs(s - a) / a > 0.1)
    order = np.lexsort((keys[3][keep], (s - a)[keep]))
    rows = list(zip(*[x[keep][order].tolist() for x in (*keys, sums, a)]))
    names = Q89_KEYS + ("sum_sales", "avg_monthly_sales")

    def key(r):
        return (r[6] - r[7], r[3])

    tied = {}
    for r in rows:
        tied.setdefault(key(r), []).append(r)

    def check(got):
        if list(got) != list(names):
            raise AssertionError(f"q89 columns {list(got)}")
        got_rows = list(zip(*[got[c] for c in names]))
        if len(got_rows) != min(100, len(rows)):
            raise AssertionError(f"q89 returned {len(got_rows)} rows, not "
                                 f"{min(100, len(rows))}")

        want_keys = [key(r) for r in rows[:len(got_rows)]]
        if [key(r) for r in got_rows] != want_keys:
            raise AssertionError("q89's sort keys differ from the numpy oracle")
        # rows tied on the sort key may come in any order: compare each tie
        # group as a set; a group cut by the limit must be a subset
        for k in set(want_keys):
            g = sorted(r for r in got_rows if key(r) == k)
            w = sorted(tied[k])
            if g != w and not (k == want_keys[-1] and set(g) <= set(w)):
                raise AssertionError(f"q89 rows tied on {k} differ from the oracle")

    window = (*keys, sums, a)
    return check, {"window_rows": int(len(sums)), "window_partitions": npart,
                   "result_rows": min(100, len(rows)), "kept_rows": len(rows)}, window


def run_q89(dev, profile=False, trace_path=None):
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T
    from blaze_tpu_torch.ops import window as W
    from blaze_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    schemas = q89_schemas(T)
    host = q89_host(Q89_ROWS)
    want, info, window = q89_oracle(host)
    session = blaze_tpu_torch.Session()
    stage_star(session, schemas, host, dev)
    del host
    setup_s = time.perf_counter() - t0
    # each reducer's window: its rows and its K13 launches, every run, and
    # the window's output batches, held to the oracle after the runs
    reducers, window_out = [], []
    segmented = W.WindowExec._execute_segmented

    def counted(self, partition, ctx):
        before = cuda_lib.LAUNCHES["segment_scan"]
        rows = 0
        for b in segmented(self, partition, ctx):
            rows += b.num_rows
            window_out.append(b)
            yield b
        reducers.append((partition, rows, cuda_lib.LAUNCHES["segment_scan"] - before))

    sales_batches = sum(len(session.resources["store_sales"](p)) for p in range(PARTS))
    W.WindowExec._execute_segmented = counted
    try:
        launches = run_query("q89", sum(Q89_ROWS.values()), session,
                             q89_plan(schemas, E, N, T), want, setup_s, info, profile,
                             trace_path, first_run=k18_twin_check("q89"))
    finally:
        W.WindowExec._execute_segmented = segmented
    idle = [(p, r) for p, r, k in reducers if k < 1 and r > 0]
    if idle or not reducers:
        raise AssertionError(f"q89 reducers whose window did not launch K13: {idle}")
    if launches["fused_agg_input"] != sales_batches or launches["inner_join_planes"]:
        raise AssertionError(f"q89 launched K18 {launches['fused_agg_input']} and K8 "
                             f"{launches['inner_join_planes']} times for {sales_batches} "
                             "sales batches: its three joins did not fuse into K18")
    q89_window_check(window_out, window)
    return launches


def q89_window_check(batches, want):
    """Every row the window emitted, in every run, against the oracle's
    window rows (``q89_oracle``'s ``window``): the same rows, each with its
    partition's average bit for bit, however many runs there were."""
    import numpy as np

    cols = [[] for _ in want]
    for b in batches:
        n = b.num_rows
        for out, c in zip(cols, b.columns):
            if not bool(c.validity[:n].all()):
                raise AssertionError("q89's window emitted a null")
            out.append(c.data[:n].cpu().numpy())
    got = [np.concatenate(c) if c else np.zeros(0, w.dtype) for c, w in zip(cols, want)]
    runs, rest = divmod(len(got[0]), len(want[0]))
    if rest or not runs:
        raise AssertionError(f"q89's window emitted {len(got[0])} rows, not a multiple of "
                             f"{len(want[0])}")
    order = np.lexsort(got[::-1])
    want_order = np.repeat(np.lexsort(want[::-1]), runs)
    for name, g, w in zip(Q89_KEYS + ("sum_sales", "avg_monthly_sales"), got, want):
        if not np.array_equal(g[order], w[want_order]):
            raise AssertionError(f"q89's window column {name} differs from the oracle")


Q98_SEED = 98
# TPC-DS SF10 row counts of q98's tables
Q98_ROWS = {"store_sales": 28_800_991, "item": 102_000, "date_dim": 73_049}
Q98_CATS = (8, 0, 3)  # Sports, Books, Home (Q89_CATS_A's category codes)
Q98_DESCS = 10_000    # i_item_desc codes
Q98_GROUPS = ("i_item_id", "i_item_desc", "i_category_id", "i_class_id", "i_current_price")
Q98_ORDER = ("i_category_id", "i_class_id", "i_item_id", "i_item_desc", "revenueratio")
Q98_COLUMNS = Q98_GROUPS + ("itemrevenue", "revenueratio")


def q98_schemas(T):
    def sch(*names):
        return T.Schema.of(*[(n, T.I64) for n in names])

    return {"store_sales": sch("ss_item_sk", "ss_sold_date_sk", "ss_quantity"),
            "item": T.Schema.of(*[(n, T.I64) for n in ("i_item_sk",) + Q98_GROUPS[:4]],
                                ("i_current_price", T.DecimalType(7, 2))),
            "date_dim": sch("d_date_sk", "d_year", "d_moy")}


def q98_host(rows, seed=Q98_SEED, null_share=0.04):
    """q98's tables on the host: ``q89_host``'s generator (its own seed)
    for store_sales (without ss_store_sk), date_dim and the items'
    category and class; then, from a second stream, i_item_id (two
    item_sk an id, as TPC-DS's revised items), an i_item_desc code an id,
    and i_current_price, decimal(7,2) unscaled [9, 10,000) an item_sk."""
    import numpy as np

    base = q89_host({**rows, "store": Q89_ROWS["store"]}, seed, null_share)
    (i_sk, cat, cls, _brand), _ = base["item"]
    rng = np.random.default_rng(seed + 1)
    item_id = (i_sk + 1) // 2
    desc = rng.integers(0, Q98_DESCS, int(item_id.max()) + 1)[item_id]
    price = rng.integers(9, 10_000, len(i_sk))
    (item, date, _store, qty), (iv, dv, _sv, qv) = base["store_sales"]
    return {"item": ((i_sk, item_id, desc, cat, cls, price), None),
            "date_dim": base["date_dim"],
            "store_sales": ((item, date, qty), (iv, dv, qv))}


def q98_plan(schemas, E, N, T, parts=PARTS):
    """TPC-DS q98 (v3.2.0) as Spark plans it (tests/tpcds/queries.py:1120),
    in the IR modules ``E``, ``N``, ``T`` of either package: store_sales
    JOIN broadcast item (i_category IN (Sports, Books, Home)) JOIN
    broadcast date_dim (d_year = 1999 AND d_moy = 2) -> PARTIAL
    SUM(ss_quantity) by (i_item_id, i_item_desc, i_category, i_class,
    i_current_price) -> hash exchange -> FINAL -> hash exchange by i_class
    -> sort on it -> Window sum(itemrevenue) over i_class (the whole
    partition) -> itemrevenue * 100.0 / that sum -> range exchange on
    (i_category, i_class, i_item_id, i_item_desc, revenueratio), bounds
    sampled by the Session -> sort. Strings are int codes; ss_quantity
    stands for ss_ext_sales_price; revenueratio is a double (PERF.md
    section 4)."""
    C, B = E.Column, E.BinaryOp

    def scan(name, p=1):
        return N.FFIReader(schemas[name], name, p)

    def eq(c, v):
        return E.BinaryExpr(B.EQ, C(c), E.Literal(v, T.I64))

    item = N.Filter(scan("item"), [E.InList(C("i_category_id"),
                                            [E.Literal(v, T.I64) for v in Q98_CATS])])
    date = N.Filter(scan("date_dim"), [E.BinaryExpr(B.AND, eq("d_year", 1999), eq("d_moy", 2))])
    out = scan("store_sales", parts)
    for dim, fk, pk in ((item, "ss_item_sk", "i_item_sk"),
                        (date, "ss_sold_date_sk", "d_date_sk")):
        out = N.BroadcastJoin(out, N.BroadcastExchange(dim), [(C(fk), C(pk))],
                              N.JoinType.INNER, N.JoinSide.RIGHT, f"q98_{pk}")
    keys = [(k, C(k)) for k in Q98_GROUPS]
    total = E.AggExpr(E.AggFunction.SUM, [C("ss_quantity")])
    partial = N.Agg(out, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(total, E.AggMode.PARTIAL, "itemrevenue")],
                    supports_partial_skipping=True)
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([c for _, c in keys], parts)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(total, E.AggMode.FINAL, "itemrevenue")])
    cls = C("i_class_id")
    srt = N.Sort(N.ShuffleExchange(final, N.HashPartitioning([cls], parts)), [E.SortOrder(cls)])
    win = N.Window(srt, [N.WindowExpr("agg", "_we0",
                                      E.AggExpr(E.AggFunction.SUM, [C("itemrevenue")]))],
                   [cls], [])
    ratio = E.BinaryExpr(B.DIV, E.BinaryExpr(B.MUL, C("itemrevenue"), E.Literal(100.0, T.F64)),
                         C("_we0"))
    proj = N.Projection(win, [C(k) for k in Q98_GROUPS] + [C("itemrevenue"), ratio],
                        list(Q98_COLUMNS))
    orders = [E.SortOrder(C(k)) for k in Q98_ORDER]
    return N.Sort(N.ShuffleExchange(proj, N.RangePartitioning(orders, parts, [])), orders)


def q98_oracle(host):
    """q98 in numpy: the joined sales summed by the five group keys, each
    group's revenueratio as float64(sum) * 100.0 / float64(its class's
    total), ordered by (category, class, id, desc, ratio). Returns the
    check for the result (rows tied on all five sort keys as sets) and
    the sizes."""
    import decimal

    import numpy as np

    (i_sk, iid, desc, cat, cls, price), _ = host["item"]
    (d_sk, year, moy), _ = host["date_dim"]
    (item, date, qty), (iv, dv, _qv) = host["store_sales"]
    i_ok = np.zeros(i_sk.max() + 1, bool)
    i_ok[i_sk[np.isin(cat, Q98_CATS)]] = True
    d_ok = np.zeros(d_sk.max() + 1, bool)
    d_ok[d_sk[(year == 1999) & (moy == 2)]] = True
    keep = iv & dv & i_ok[item] & d_ok[np.clip(date, 0, d_sk.max())]
    ii = item[keep] - 1
    uniq, inv = np.unique(np.stack([iid[ii], desc[ii], cat[ii], cls[ii], price[ii]]), axis=1,
                          return_inverse=True)
    sums = _group_sums(inv.reshape(-1), qty[keep], uniq.shape[1])
    _c, cinv = np.unique(uniq[3], return_inverse=True)
    wsum = _group_sums(cinv.reshape(-1), sums, int(cinv.max()) + 1)[cinv.reshape(-1)]
    ratio = sums.astype(np.float64) * 100.0 / wsum.astype(np.float64)
    order = np.lexsort((ratio, uniq[1], uniq[0], uniq[3], uniq[2]))
    ctx = decimal.Context(prec=80)
    want = {"i_item_id": uniq[0][order].tolist(), "i_item_desc": uniq[1][order].tolist(),
            "i_category_id": uniq[2][order].tolist(), "i_class_id": uniq[3][order].tolist(),
            "i_current_price": [decimal.Decimal(int(v)).scaleb(-2, ctx)
                                for v in uniq[4][order]],
            "itemrevenue": sums[order].tolist(), "revenueratio": ratio[order].tolist()}
    rows = list(zip(*[want[c] for c in Q98_COLUMNS]))

    def key(r):
        return (r[2], r[3], r[0], r[1], r[6])

    def check(got):
        if list(got) != list(Q98_COLUMNS):
            raise AssertionError(f"q98 columns {list(got)}")
        got_rows = list(zip(*[got[c] for c in Q98_COLUMNS]))
        if len(got_rows) != len(rows):
            raise AssertionError(f"q98 returned {len(got_rows)} rows, not {len(rows)}")
        if [key(r) for r in got_rows] != [key(r) for r in rows]:
            raise AssertionError("q98's sort keys differ from the numpy oracle")
        # rows tied on all five sort keys may come in any order
        if got_rows != rows:
            starts = [0] + [i for i in range(1, len(rows)) if key(rows[i]) != key(rows[i - 1])]
            for a, b in zip(starts, starts[1:] + [len(rows)]):
                if sorted(got_rows[a:b]) != sorted(rows[a:b]):
                    raise AssertionError(f"q98 rows tied on {key(rows[a])} differ from the "
                                         "oracle")

    ties = len(rows) - len({key(r) for r in rows})
    return check, {"groups": len(rows), "classes": int(cinv.max()) + 1 if len(cinv) else 0,
                   "rows_tied_on_the_sort_keys": ties, "joined_rows": int(keep.sum())}


@contextlib.contextmanager
def range_twin_check(name):
    """While open, every K14 launch is also held to its twin on the same
    batch and bounds (``range_partition:<name> batch``); the first such
    batch is then timed (K14, its device time, its twin) into
    ``RANGE_PATH_TIMES[name]``."""
    from blaze_tpu_torch.core import kernels as K

    fn = K.range_partition_ids
    first = []

    def checked(datas, valids, exists, bound_ops, spec, pack=None):
        got = fn(datas, valids, exists, bound_ops, spec, pack=pack)
        check_equal("range_partition", f"{name} batch", got,
                    K.range_partition_ids_plain(datas, valids, exists, bound_ops, spec))
        if not first:
            first.append(((datas, valids, exists, bound_ops, spec), pack))
        return got

    K.range_partition_ids = checked
    try:
        yield
    finally:
        K.range_partition_ids = fn
    if not first:
        raise AssertionError(f"{name}'s first run launched no K14")
    args, pack = first[0]
    if pack is None:
        raise AssertionError(f"{name}'s range partitioner passed K14 no pack")
    n = int(args[2].shape[0])
    RANGE_PATH_TIMES[name] = {
        "rows": int(args[2].sum().item()), "capacity": n, "keys": len(args[0]),
        "bounds": int(args[3][0].shape[0]),
        "ms": time_ms(lambda: K.range_partition_ids_cuda(*args, pack)),
        "device_ms": kernel_device_ms(lambda: K.range_partition_ids_cuda(*args, pack),
                                      "blz_range_partition"),
        "plain_ms": time_ms(lambda: K.range_partition_ids_plain(*args)),
        "bytes": n * (sum(d.element_size() + 1 for d in args[0]) + 1 + 4)}


RANGE_PATH_TIMES = {}


def run_q98(dev, profile=False, trace_path=None):
    """q98 at SF10 on the reference's TPU route (the sort route: K5 + K10),
    exact against ``q98_oracle``; K14 on the range exchange (held to its
    twin on every batch of the first run), K13 on the window, K8 on every
    sales batch."""
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schemas = q98_schemas(T)
    host = q98_host(Q98_ROWS)
    want, info = q98_oracle(host)
    session = blaze_tpu_torch.Session(conf=Config(dense_agg=False, radix_agg=False))
    stage_star(session, schemas, host, dev)
    del host
    setup_s = time.perf_counter() - t0
    sales_batches = sum(len(session.resources["store_sales"](p)) for p in range(PARTS))
    launches = run_query("q98", sum(Q98_ROWS.values()), session, q98_plan(schemas, E, N, T),
                         want, setup_s, info, profile, trace_path,
                         first_run=range_twin_check("q98"))
    for k, least in (("range_partition", 1), ("segment_scan", 1), ("seg_agg_partial", 1),
                     ("seg_agg_merge", 1), ("fused_agg_input", sales_batches)):
        if launches[k] < least:
            raise AssertionError(f"q98 launched {k} {launches[k]} times, fewer than {least}")
    if launches["inner_join_planes"]:
        raise AssertionError("q98's joins did not all fuse into its partial aggregate (K18)")
    return launches


SORT10M_ROWS = 10_000_000
SORT10M_PARTS = 32
SORT10M_SEED = 1010
SORT10M_COLUMNS = ("ss_item_sk", "ss_store_sk", "ss_quantity", "ss_sales_price",
                   "ss_ext_wholesale_cost")


def sort10m_schema(T):
    return T.Schema.of(("ss_item_sk", T.I64), ("ss_store_sk", T.I64), ("ss_quantity", T.I64),
                       ("ss_sales_price", T.DecimalType(7, 2)),
                       ("ss_ext_wholesale_cost", T.DecimalType(38, 2)))


def sort10m_host(rows=SORT10M_ROWS, parts=SORT10M_PARTS, seed=SORT10M_SEED):
    """The soak's store_sales (scripts/scale_soak.py:98, bench.py:130-140's
    five columns and ranges, a seed of its own) as int64 columns a
    partition: item [1, 2,000), store [1, 400), quantity [1, 100), the
    price's unscaled cents [0, 50,000), and from a second stream the
    decimal(38,2) wholesale cost's unscaled [10^14, 9 * 10^16)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rng_wide = np.random.default_rng(seed + 1)
    out = []
    for p in range(parts):
        n = rows * (p + 1) // parts - rows * p // parts
        out.append((rng.integers(1, 2_000, n), rng.integers(1, 400, n), rng.integers(1, 100, n),
                    rng.integers(0, 50_000, n), rng_wide.integers(10 ** 14, 9 * 10 ** 16, n)))
    return out


def sort10m_plan(schema, E, N, parts=SORT10M_PARTS, range_parts=SORT10M_PARTS):
    """The soak's sort10M (scripts/scale_soak.py:107): the scan ->
    RangePartitioning on (ss_sales_price DESC, ss_item_sk ASC), bounds
    sampled by the Session -> sort on the same keys."""
    orders = [E.SortOrder(E.Column("ss_sales_price"), ascending=False),
              E.SortOrder(E.Column("ss_item_sk"))]
    scan = N.FFIReader(schema, "store_sales", parts)
    return N.Sort(N.ShuffleExchange(scan, N.RangePartitioning(orders, range_parts, [])),
                  orders)


def sort10m_collect(session, plan):
    """The result's columns as numpy arrays (the wide column as its int64
    values), every row valid."""
    import numpy as np

    cols = {c: [] for c in SORT10M_COLUMNS}
    for b in session.execute(plan):
        for name, (data, valid) in b.to_numpy().items():
            if not valid.all():
                raise AssertionError(f"sort10M returned a null {name}")
            if data.ndim == 2:  # (lo_raw, hi) words of values in [0, 2^63)
                if (data[:, 1] != 0).any():
                    raise AssertionError("sort10M's wholesale cost came back past int64")
                data = data[:, 0]
            cols[name].append(data)
    return {c: np.concatenate(v) if v else np.zeros(0, np.int64) for c, v in cols.items()}


def sort10m_oracle(host):
    """The check of a collected sort10M result: the key columns equal
    numpy's stable sort in order; the whole rows equal it as a multiset
    within each run of tied keys (both sides sorted by the other columns
    inside those runs, which hold about a tenth of the rows)."""
    import numpy as np

    cols = [np.concatenate(c) for c in zip(*host)]
    item, _store, _qty, price, _wcost = cols

    def packed(price, item):
        # (price DESC, item ASC) as one word: price < 2^16, item < 2^11
        return ((2 ** 16 - 1 - price) << 11) | item

    order = np.argsort(packed(price, item), kind="stable")
    keys = packed(price[order], item[order])
    new_key = np.concatenate([[True], np.diff(keys) != 0])
    run = np.cumsum(new_key) - 1  # the run of tied keys each output row is in
    tied = np.flatnonzero(~(new_key & np.concatenate([new_key[1:], [True]])))

    def full_sort(c):
        # the rows in runs of two or more, by (run, store, quantity,
        # wholesale cost); store < 2^9 and quantity < 2^7 pack beside the
        # run id. The runs are contiguous, so each keeps its positions.
        rows = np.arange(len(c[0]))
        rows[tied] = tied[np.lexsort((c[4][tied], (run[tied] << 16) | (c[1][tied] << 7)
                                      | c[2][tied]))]
        return rows

    want_rows = [c[order] for c in cols]
    want_rows = [c[full_sort(want_rows)] for c in want_rows]
    ties = int(len(item) - new_key.sum())

    def check(got):
        g = [got[c] for c in SORT10M_COLUMNS]
        if len(g[0]) != len(item):
            raise AssertionError(f"sort10M returned {len(g[0])} rows, not {len(item)}")
        if not np.array_equal(packed(g[3], g[0]), keys):
            raise AssertionError("sort10M's keys are not in numpy's stable sort order")
        rows = full_sort(g)
        for name, x, w in zip(SORT10M_COLUMNS, g, want_rows):
            if not np.array_equal(x[rows], w):
                raise AssertionError(f"sort10M's rows tied on the keys differ ({name})")

    return check, {"rows_tied_with_the_previous_key": ties}


def run_sort10m(dev, profile=False, trace_path=None):
    """The soak's sort10M at full size: 10,000,000 rows in 32 partitions
    of staged batches -> range exchange into 32 (K14 on every map-side
    bucketize pass, held to its twin on every batch of the first run) ->
    sort (K5, K6, K7); the keys exact in order against numpy, the rows as
    multisets within tied keys."""
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schema = sort10m_schema(T)
    host = sort10m_host()
    want, info = sort10m_oracle(host)
    parts = [stage_batches(schema, cols, dev) for cols in host]
    del host
    session = blaze_tpu_torch.Session()
    session.resources["store_sales"] = lambda p: parts[p]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    map_batches = sum(len(p) for p in parts)
    info.update(partitions=SORT10M_PARTS, map_batches=map_batches)
    launches = run_query("sort10m", SORT10M_ROWS, session, sort10m_plan(schema, E, N), want,
                         setup_s, info, profile, trace_path, collect=sort10m_collect,
                         first_run=range_twin_check("sort10m"))
    # every map batch (50,356 rows or more) passes the map side's
    # 32,768-row coalescing alone into one bucketize, the only K14 caller
    if launches["range_partition"] != map_batches:
        raise AssertionError(f"sort10M launched K14 {launches['range_partition']} times over "
                             f"{map_batches} map batches")
    # the exchange's bucketize is K14, K5 and one K7 split a map batch
    # (the take and 32 slices a batch before), the sort K5 and K6
    if launches["split_planes"] != map_batches:
        raise AssertionError(f"sort10M launched K7's split {launches['split_planes']} times "
                             f"over {map_batches} map batches")
    for k in ("sort_key_operands", "lexsort_indices", "gather_planes"):
        if launches[k] < 1:
            raise AssertionError(f"sort10M did not launch {k}")
    # sort10M_mesh: the same staged partitions on a mesh of 8 slots (32 maps
    # fold 4 a slot, 32 reducers 4 a slot); its payload passes the 128 MiB
    # resident budget, so the reducers' rows wait in host memory
    mesh = mesh_session(dev, 8)
    mesh.resources["store_sales"] = lambda p: parts[p]
    mesh_launches = run_query("sort10m_mesh", SORT10M_ROWS, mesh, sort10m_plan(schema, E, N),
                              want, setup_s, dict(info, slots=8), profile,
                              trace_path.replace(".json", "_mesh.json") if trace_path
                              else None, collect=sort10m_collect,
                              first_run=mesh_twin_check("sort10m_mesh"))
    if mesh_launches["mesh_all_to_all"] != 1 or \
            mesh_launches["range_partition"] != SORT10M_PARTS or \
            mesh.counters["mesh_host_exchanges"] != runs_of(profile):
        raise AssertionError(f"sort10M_mesh: K17 {mesh_launches['mesh_all_to_all']} times, "
                             f"K14 {mesh_launches['range_partition']} times (one a map), "
                             f"{dict(mesh.counters)}")
    return {"sort10m": launches, "sort10m_mesh": mesh_launches}


# -- hash_sample: a stable XXH64 sample of store_sales (K15) --------------------------

HS_SEED = 1115
HS_ROWS = 28_800_991   # TPC-DS SF10's store_sales row count
HS_ITEMS = 102_000     # SF10's items
HS_TICKET = 10         # rows (distinct items) a ticket
HS_BUCKETS, HS_KEEP = 100, 10
HS_COLUMNS = ("ss_item_sk", "ss_ticket_number", "ss_store_sk", "ss_quantity",
              "ss_sales_price")
XXH_PATH_TIMES = {}


def hash_sample_schema(T):
    """store_sales' five columns as Spark's TPC-DS schema types them."""
    return T.Schema.of(("ss_item_sk", T.I32), ("ss_ticket_number", T.I32),
                       ("ss_store_sk", T.I32), ("ss_quantity", T.I32),
                       ("ss_sales_price", T.DecimalType(7, 2)))


def hash_sample_host(rows=HS_ROWS, seed=HS_SEED, null_share=0.04):
    """store_sales for the hash sample on the host: ss_ticket_number = row
    // 10 + 1, its ten rows ten distinct items (a ticket's first item
    uniform, the rest at a stride of 10,201 modulo the items), so that
    (ss_item_sk, ss_ticket_number) is unique and neither is null;
    ss_store_sk uniform over the stores, ss_quantity uniform [1, 100],
    ss_sales_price decimal(7,2) unscaled uniform [0, 20,000], each of the
    three ``null_share`` null (data 0). Returns (columns, validities)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    row = np.arange(rows, dtype=np.int64)
    ticket = row // HS_TICKET
    first = rng.integers(0, HS_ITEMS, int(ticket[-1]) + 1)
    item = ((first[ticket] + (row % HS_TICKET) * 10_201) % HS_ITEMS + 1).astype(np.int32)
    del row, first
    cols, valids = [item, (ticket + 1).astype(np.int32)], [None, None]
    del ticket
    for lo, hi, dt in ((1, HS_STORES + 1, np.int32), (1, 101, np.int32),
                       (0, 20_001, np.int64)):
        v = rng.random(rows) >= null_share
        cols.append(np.where(v, rng.integers(lo, hi, rows), 0).astype(dt))
        valids.append(v)
    return tuple(cols), tuple(valids)


def hash_sample_plan(schema, E, N, T, parts=PARTS):
    """A stable 10% hash sample of store_sales as Spark plans it, in the IR
    modules ``E``, ``N``, ``T`` of either package: SELECT ss_store_sk,
    count(*), sum(ss_quantity), sum(ss_sales_price) FROM store_sales WHERE
    abs(xxhash64(ss_item_sk, ss_ticket_number)) % 100 < 10 GROUP BY
    ss_store_sk ORDER BY ss_store_sk: the filter (a ScalarFunction, so
    unfused: K15 + K1 a batch) -> PARTIAL -> hash exchange -> FINAL ->
    range exchange on ss_store_sk, bounds sampled (K14) -> sort."""
    C, B, L = E.Column, E.BinaryOp, E.Literal
    xxh = E.ScalarFunction("xxhash64", [C("ss_item_sk"), C("ss_ticket_number")])
    bucket = E.BinaryExpr(B.MOD, E.ScalarFunction("abs", [xxh]), L(HS_BUCKETS, T.I64))
    kept = N.Filter(N.FFIReader(schema, "store_sales", parts),
                    [E.BinaryExpr(B.LT, bucket, L(HS_KEEP, T.I64))])
    keys = [("ss_store_sk", C("ss_store_sk"))]
    aggs = (("cnt", E.AggExpr(E.AggFunction.COUNT, [L(1, T.I32)])),
            ("sum_qty", E.AggExpr(E.AggFunction.SUM, [C("ss_quantity")])),
            ("sum_price", E.AggExpr(E.AggFunction.SUM, [C("ss_sales_price")])))
    partial = N.Agg(kept, E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, name) for name, a in aggs])
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([C("ss_store_sk")], parts)),
                  E.AggExecMode.HASH_AGG, keys,
                  [N.AggColumn(a, E.AggMode.FINAL, name) for name, a in aggs])
    order = [E.SortOrder(C("ss_store_sk"))]
    return N.Sort(N.ShuffleExchange(final, N.RangePartitioning(order, parts, [])), order)


def hash_sample_oracle(host):
    """The sample in numpy: ``xxh64_np`` over the two keys, Java's abs and
    %, then counts and sums by store with ``np.bincount`` (exact: every
    sum stays below 2^53); the null store first, then ascending. Returns
    (the result as ``execute_to_pydict`` gives it, its sizes)."""
    import decimal

    import numpy as np

    (item, ticket, store, qty, price), (_iv, _tv, sv, qv, pv) = host
    h = xxh64_np([item, ticket], [None, None])
    with np.errstate(over="ignore"):
        keep = np.fmod(np.abs(h), HS_BUCKETS) < HS_KEEP
    del h
    group = np.where(sv, store, 0)[keep].astype(np.int64)
    n = HS_STORES + 1
    cnt = np.bincount(group, minlength=n)
    qn = np.bincount(group, weights=qv[keep], minlength=n)
    pn = np.bincount(group, weights=pv[keep], minlength=n)
    qsum = np.bincount(group, weights=np.where(qv, qty, 0)[keep], minlength=n)
    psum = np.bincount(group, weights=np.where(pv, price, 0)[keep], minlength=n)
    present = [g for g in range(n) if cnt[g]]
    out = {"ss_store_sk": [g or None for g in present],
           "cnt": [int(cnt[g]) for g in present],
           "sum_qty": [int(qsum[g]) if qn[g] else None for g in present],
           "sum_price": [decimal.Decimal(int(psum[g])).scaleb(-2) if pn[g] else None
                         for g in present]}
    return out, {"kept_rows": int(keep.sum()), "groups": len(present)}


@contextlib.contextmanager
def xxhash_twin_check(name):
    """While open, every K15 launch through ``xxhash64_rows`` is also held
    to its twin on the same columns (``xxhash64:<name> batch``); the first
    such batch is then timed (K15 by events and on the device, its twin)
    into ``XXH_PATH_TIMES[name]``."""
    from blaze_tpu_torch.exprs import spark_hash as H

    fn = H.xxhash64_rows
    first, checked_batches = [], [0]

    def checked(words, valids, kinds, n, cap):
        got = fn(words, valids, kinds, n, cap)
        check_equal("xxhash64", f"{name} batch", got,
                    H.xxhash64_rows_plain(words, valids, kinds, n, cap))
        if not first:
            first.append((list(words), list(valids), list(kinds), n, cap))
        checked_batches[0] += 1
        return got

    H.xxhash64_rows = checked
    try:
        yield
    finally:
        H.xxhash64_rows = fn
    if not first:
        raise AssertionError(f"{name}'s first run launched no K15")
    args = first[0]
    XXH_PATH_TIMES[name] = {
        "checked_batches": checked_batches[0], "rows": args[3], "capacity": args[4],
        "columns": len(args[0]),
        "ms": time_ms(lambda: H.xxhash64_rows_cuda(*args)),
        "device_ms": kernel_device_ms(lambda: H.xxhash64_rows_cuda(*args), "blz_xxhash64"),
        "plain_ms": time_ms(lambda: H.xxhash64_rows_plain(*args))}


K18_PATH_BATCHES = {}


@contextlib.contextmanager
def k18_twin_check(name):
    """While open, every K18 launch through ``fused_agg_input`` is also held
    to its plain version on the same batch (``fused_agg_input:<name>
    batch``); the count of batches held goes to ``K18_PATH_BATCHES``."""
    from blaze_tpu_torch.core import kernels as K

    fn = K.fused_agg_input
    checked = [0]

    def held(spec, columns, num_rows, joins, kernel=None):
        got = fn(spec, columns, num_rows, joins, kernel)
        check_equal("fused_agg_input", f"{name} batch", k18_flat(got),
                    k18_flat(K.fused_agg_input_plain(spec, columns, num_rows, joins)))
        checked[0] += 1
        return got

    K.fused_agg_input = held
    try:
        yield
    finally:
        K.fused_agg_input = fn
    if not checked[0]:
        raise AssertionError(f"{name}'s first run launched no K18")
    K18_PATH_BATCHES[name] = checked[0]


def run_hash_sample(dev, profile=False, trace_path=None):
    """The hash sample at SF10 (28,800,991 store_sales rows, 4 partitions
    of 262,144-row batches staged on the card), exact in order against
    ``hash_sample_oracle``; K15 once a sales batch (every launch of the
    first run held to its twin), K14 on the ORDER BY's range exchange."""
    import blaze_tpu_torch
    import torch
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schema = hash_sample_schema(T)
    cols, valids = hash_sample_host()
    want, info = hash_sample_oracle((cols, valids))
    session = blaze_tpu_torch.Session()
    cuts = [HS_ROWS * p // PARTS for p in range(PARTS + 1)]
    parts = [stage_batches(schema, [c[a:b] for c in cols], dev,
                           valids=[None if v is None else v[a:b] for v in valids])
             for a, b in zip(cuts, cuts[1:])]
    del cols, valids
    session.resources["store_sales"] = lambda p: parts[p]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = sum(len(p) for p in parts)
    launches = run_query("hash_sample", HS_ROWS, session,
                         hash_sample_plan(schema, E, N, T), want, setup_s, info, profile,
                         trace_path, first_run=xxhash_twin_check("hash_sample"))
    if XXH_PATH_TIMES["hash_sample"]["checked_batches"] != batches:
        raise AssertionError(f"hash_sample's first run held "
                             f"{XXH_PATH_TIMES['hash_sample']['checked_batches']} K15 "
                             f"launches to the twin, not one a sales batch ({batches})")
    if launches["xxhash64"] != batches or launches["range_partition"] < 1:
        raise AssertionError(f"hash_sample launched K15 {launches['xxhash64']} times for "
                             f"{batches} sales batches, K14 {launches['range_partition']}")
    return launches


CS_SEED = 2323
CS_ROWS = 28_800_991   # store_sales rows: a tenth of SF100's 288,009,942
CS_REDUCERS = 16       # Spark's 200 shuffle partitions after AQE's 64 MB coalescing
CS_TOP = 100
CS_TABLE_ROWS, CS_TABLE_BATCH = 262_144, 65_536  # the host-table skip check's input


def cust_spend_schema(T):
    """store_sales' three q23 columns as Spark's TPC-DS schema types them."""
    return T.Schema.of(("ss_customer_sk", T.I32), ("ss_quantity", T.I32),
                       ("ss_sales_price", T.DecimalType(7, 2)))


def cust_spend_host(rows=CS_ROWS, seed=CS_SEED, customers=CUST_SKS, null_share=0.01):
    """store_sales for cust_spend on the host: ss_customer_sk uniform over
    1..customers (SF100's 2,000,000), ``null_share`` null (data 0);
    ss_quantity uniform [1, 100]; ss_sales_price decimal(7,2) unscaled
    uniform [0, 20,000]. Returns (columns, validities)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cv = rng.random(rows) >= null_share
    cust = np.where(cv, rng.integers(1, customers + 1, rows), 0).astype(np.int32)
    qty = rng.integers(1, 101, rows).astype(np.int32)
    price = rng.integers(0, 20_001, rows).astype(np.int64)
    return (cust, qty, price), (cv, None, None)


def cust_spend_plan(schema, E, N, T, parts=PARTS, reducers=CS_REDUCERS, top=CS_TOP):
    """TPC-DS q23's best_ss_customer aggregate, in the IR modules ``E``,
    ``N``, ``T`` of either package: SELECT ss_customer_sk,
    SUM(ss_quantity * ss_sales_price) ssales FROM store_sales GROUP BY
    ss_customer_sk (PARTIAL on the scan with partial skipping -> hash
    exchange on the key -> FINAL), its HAVING as the top ``top`` by ssales
    DESC (single exchange -> sort). The argument is Spark's: the int
    quantity cast to decimal(10,0) times the decimal(7,2) price,
    decimal(18,2); its SUM decimal(28,2), a two-limb (sum2) state."""
    C = E.Column
    arg = E.BinaryExpr(E.BinaryOp.MUL, E.Cast(C("ss_quantity"), T.DecimalType(10, 0)),
                       C("ss_sales_price"))
    agg = E.AggExpr(E.AggFunction.SUM, [arg], T.DecimalType(28, 2))
    keys = [("ss_customer_sk", C("ss_customer_sk"))]
    partial = N.Agg(N.FFIReader(schema, "store_sales", parts), E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(agg, E.AggMode.PARTIAL, "ssales")],
                    supports_partial_skipping=True)
    final = N.Agg(N.ShuffleExchange(partial, N.HashPartitioning([C("ss_customer_sk")],
                                                                reducers)),
                  E.AggExecMode.HASH_AGG, keys, [N.AggColumn(agg, E.AggMode.FINAL, "ssales")])
    return N.Sort(N.ShuffleExchange(final, N.SinglePartitioning(1)),
                  [E.SortOrder(C("ssales"), ascending=False, nulls_first=False)],
                  fetch_limit=top)


def cust_spend_oracle(host, top=CS_TOP):
    """Exact per-customer sums of quantity * price in int64 cents
    (``np.bincount``, every sum below 2^53), the null customer one group;
    returns (a check of ``execute_to_pydict``'s result: the top ``top``
    sums in order, each row's customer holding its sum, customers distinct
    (rows tied on ssales in any order), the number of groups)."""
    import decimal

    import numpy as np

    (cust, qty, price), (cv, _qv, _pv) = host
    group = np.where(cv, cust, 0).astype(np.int64)
    sums = np.bincount(group, weights=qty.astype(np.int64) * price)
    present = np.bincount(group) > 0
    if sums.max() >= 2 ** 53:
        raise AssertionError("cust_spend oracle: a sum reached 2^53")
    sums = sums.astype(np.int64)
    keys = np.nonzero(present)[0]
    order = np.argsort(-sums[keys], kind="stable")[:top]
    want_sums = [decimal.Decimal(int(v)).scaleb(-2) for v in sums[keys[order]]]

    def check(got):
        if list(got["ssales"]) != want_sums:
            raise AssertionError("cust_spend: the top sums differ from the oracle")
        custs = [0 if c is None else c for c in got["ss_customer_sk"]]
        if len(set(custs)) != len(custs) or any(
                not present[c] or decimal.Decimal(int(sums[c])).scaleb(-2) != s
                for c, s in zip(custs, got["ssales"])):
            raise AssertionError("cust_spend: a customer does not hold its oracle sum")

    return check, int(present.sum())


def cust_table_plan(schema, E, N, T, parts=1):
    """The host table's skip check (TPC-DS's customer keys through the table
    route): PARTIAL COUNT(1), FIRST(ss_customer_sk) by ss_customer_sk with
    partial skipping (FIRST takes the host table) -> single exchange ->
    FINAL."""
    C = E.Column
    aggs = (("cnt", E.AggExpr(E.AggFunction.COUNT, [E.Literal(1, T.I32)])),
            ("first_sk", E.AggExpr(E.AggFunction.FIRST, [C("ss_customer_sk")])))
    keys = [("ss_customer_sk", C("ss_customer_sk"))]
    partial = N.Agg(N.FFIReader(schema, "store_sales", parts), E.AggExecMode.HASH_AGG, keys,
                    [N.AggColumn(a, E.AggMode.PARTIAL, n) for n, a in aggs],
                    supports_partial_skipping=True)
    return N.Agg(N.ShuffleExchange(partial, N.SinglePartitioning(1)), E.AggExecMode.HASH_AGG,
                 keys, [N.AggColumn(a, E.AggMode.FINAL, n) for n, a in aggs])


def cust_table_check(dev, host):
    """The host table's skip (``AggTable.passthrough_batch``) on the card:
    cust_spend's first 262,144 rows in batches of 65,536 through
    ``cust_table_plan``; the first batch's ~64,500 slots of 65,536 rows
    pass the 0.9 ratio, so the next three batches skip. Exact against
    numpy counts (groups in the table's slot order: compared as a dict)."""
    import blaze_tpu_torch
    import numpy as np
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    (cust, qty, price), (cv, _qv, _pv) = host
    n = CS_TABLE_ROWS
    cols = (cust[:n], qty[:n], price[:n])
    session = blaze_tpu_torch.Session()
    batches = stage_batches(cust_spend_schema(T), cols, dev, bs=CS_TABLE_BATCH,
                            valids=[cv[:n], None, None])
    session.resources["store_sales"] = lambda p: batches
    t0 = time.perf_counter()
    got = session.execute_to_pydict(cust_table_plan(cust_spend_schema(T), E, N, T))
    wall = time.perf_counter() - t0
    group = np.where(cv[:n], cust[:n], 0).astype(np.int64)
    counts = np.bincount(group)
    want = {(int(k) or None): (int(counts[k]), int(k) or None) for k in np.nonzero(counts)[0]}
    have = {k: (c, f) for k, c, f in zip(got["ss_customer_sk"], got["cnt"], got["first_sk"])}
    skipped = session.counters["partial_skipped_batches"]
    if have != want or len(have) != len(got["cnt"]):
        raise AssertionError("cust_table: the host table's skipped partials differ from numpy")
    if skipped != n // CS_TABLE_BATCH - 1:
        raise AssertionError(f"cust_table: {skipped} batches skipped, not "
                             f"{n // CS_TABLE_BATCH - 1}")
    log(json.dumps({"phase": "host_table_skip", "rows": n, "batch_rows": CS_TABLE_BATCH,
                    "groups": len(have), "partial_skipped_batches": skipped,
                    "wall_s": wall, "exact": True}))


def make_cust_spend_data(dev):
    """cust_spend's store_sales (``cust_spend_host``) in PARTS partitions of
    262,144-row batches staged on the card, with its oracle: (schema,
    partitions, host columns, the oracle's check, the group count)."""
    import torch
    from blaze_tpu_torch.ir import types as T

    schema = cust_spend_schema(T)
    host = cust_spend_host()
    check, groups = cust_spend_oracle(host)
    (cust, qty, price), (cv, _qv, _pv) = host
    cuts = [CS_ROWS * p // PARTS for p in range(PARTS + 1)]
    parts = [stage_batches(schema, [c[a:b] for c in (cust, qty, price)], dev,
                           valids=[cv[a:b], None, None]) for a, b in zip(cuts, cuts[1:])]
    torch.cuda.synchronize()
    return schema, parts, host, check, groups


def run_cust_spend(dev, profile=False, trace_path=None):
    """cust_spend (q23's per-customer aggregate with partial skipping) and
    cust_spend_noskip (``partial_agg_skipping_enable=False``) over one draw
    of 28,800,991 store_sales rows in 4 partitions of 262,144-row batches
    staged on the card, each exact against ``cust_spend_oracle`` and equal
    to the other. Each partition's first batch runs K3's radix pass (2^21
    slots; its per-bucket estimate ~0.93), then the skipper flips and the
    other batches run K19; without skipping every batch aggregates (K3,
    then K10 once two range overflows widen the plan past
    radix_agg_max_slots). Then the host table's skip check."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    t0 = time.perf_counter()
    schema, parts, host, check, groups = make_cust_spend_data(dev)
    setup_s = time.perf_counter() - t0
    batches = sum(len(p) for p in parts)
    plan = cust_spend_plan(schema, E, N, T)
    out, results = {}, {}

    def collect(session, plan):
        got = session.execute_to_pydict(plan)
        results.setdefault(session, got)
        return got

    for name, conf in (("cust_spend", Config()),
                       ("cust_spend_noskip", Config(partial_agg_skipping_enable=False))):
        session = blaze_tpu_torch.Session(conf)
        session.resources["store_sales"] = lambda p: parts[p]
        out[name] = run_query(name, CS_ROWS, session, plan, check, setup_s,
                              {"groups": groups, "reducers": CS_REDUCERS}, profile,
                              trace_path and trace_path.replace(".json", f"_{name}.json"),
                              collect=collect)
    skip, noskip = results.values()
    if skip != noskip:
        raise AssertionError("cust_spend and cust_spend_noskip differ")
    # each partition's first batch through K3, the rest through K19
    got = tuple(out["cust_spend"][k] for k in ("slot_agg_partial", "passthrough_states",
                                               "partial_skipped_batches"))
    if got != (PARTS, batches - PARTS, batches - PARTS):
        raise AssertionError(f"cust_spend: K3 {got[0]}, K19 {got[1]} and {got[2]} skipped "
                             f"batches, not {PARTS}, {batches - PARTS} and {batches - PARTS}")
    # without skipping every batch aggregates: K3 while the radix plan
    # holds, K10 once a range overflow widens it past radix_agg_max_slots
    # (the reference's union rule); a batch whose K3 overflowed retries
    ns = out["cust_spend_noskip"]
    if ns["passthrough_states"] or ns["partial_skipped_batches"] or \
            ns["seg_agg_partial"] + ns["slot_agg_partial"] < batches:
        raise AssertionError(f"cust_spend_noskip: K3 {ns['slot_agg_partial']}, K10 "
                             f"{ns['seg_agg_partial']}, K19 {ns['passthrough_states']} for "
                             f"{batches} batches")
    cust_table_check(dev, host)
    return out


def check_result(name, got, want):
    """``want`` is the oracle's result (equal, order included) or a
    function that raises when ``got`` is wrong."""
    if callable(want):
        want(got)
    elif got != want:
        raise AssertionError(f"{name} differs from the numpy oracle")


def pydict_of(session, plan):
    return session.execute_to_pydict(plan)


@contextlib.contextmanager
def k18_route_log(name):
    """While open, the join routes of every K18 launch through
    ``fused_agg_input`` are gathered; a path that launched K18 then logs
    them (a line ``k18_routes``: each distinct tuple of routes, inner join
    first, with its launches)."""
    from blaze_tpu_torch.core import kernels as K

    fn = K.fused_agg_input
    seen = {}

    def logged(spec, columns, num_rows, joins, kernel=None):
        key = "/".join(k18_routes(joins)) or "no join"
        seen[key] = seen.get(key, 0) + 1
        return fn(spec, columns, num_rows, joins, kernel)

    K.fused_agg_input = logged
    try:
        yield
    finally:
        K.fused_agg_input = fn
    if seen:
        log(json.dumps({"phase": "k18_routes", "query": name, "routes": seen}))


def run_query(name, rows, session, plan, want, setup_s, info, profile, trace_path,
              collect=pydict_of, first_run=contextlib.nullcontext()):
    """A first run (inside the context ``first_run``), then one run with
    the launch counts set to 0 just before and read just after; both exact
    against the oracle. ``collect(session, plan)`` runs the plan and
    returns what the oracle reads."""
    import torch
    from blaze_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    with first_run, k18_route_log(name):
        warm = collect(session, plan)
    warm_s = time.perf_counter() - t0
    check_result(f"{name} (first run)", warm, want)
    del warm
    torch.cuda.reset_peak_memory_stats()
    before = {k: session.counters[k] for k in SKIP_COUNTERS}
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    got = collect(session, plan)
    wall = time.perf_counter() - t0
    launches = {**cuda_lib.launch_counts(), **cuda_lib.limb_launch_counts()}
    skip = {k: session.counters[k] - before[k] for k in SKIP_COUNTERS}
    check_result(name, got, want)
    del got
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_query(name, session, plan, want, trace_path, collect)
    mesh = {"mesh_exchanges": session.mesh_exchanges} if session.mesh is not None else {}
    rows_seen = skip["partial_skip_histogram_rows"]
    log(json.dumps({"phase": "slice", "query": name, "rows": rows, "partitions": PARTS,
                    **info, "setup_s": setup_s, "first_run_s": warm_s, "wall_s": wall,
                    "rows_per_s": rows / wall, "max_memory_allocated": peak,
                    "launches": launches, **mesh,
                    "partial_skipped_batches": skip["partial_skipped_batches"],
                    "skip_estimate_ratio": skip["partial_skip_estimate_rows"] / rows_seen
                    if rows_seen else None, "exact": True}))
    return {**launches, "partial_skipped_batches": skip["partial_skipped_batches"]}


# the partial skipper's counters (Session.counters): batches skipped, and
# the rows its histograms covered with the partial output they estimate
SKIP_COUNTERS = ("partial_skipped_batches", "partial_skip_histogram_rows",
                 "partial_skip_estimate_rows")


def profile_query(name, session, plan, want, trace_path=None, collect=pydict_of):
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
        got = collect(session, plan)
        wall = time.perf_counter() - t0
    check_result(f"{name} (profiled run)", got, want)
    avgs = prof.key_averages()
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    calls = {e.key: e.count for e in avgs
             if e.key in ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize")}
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    k11 = [e for e in device if e.key.startswith("fused_chain")]
    k18 = [e for e in device if e.key.startswith("fused_agg_input")]
    # K8's kernels (one now; the probe and scatter before), K1's and the
    # block-count scan they shared
    k8_k1 = {e.key[:60]: {"calls": e.count, "device_ms": e.self_device_time_total / 1e3}
             for e in device if e.key.startswith(("blz_inner_join", "blz_join_", "blz_flag_count",
                                                  "blz_compact_", "blz_offsets_scan"))}
    # K6's kernel and the segmentation's (one launch; an older tree's flag
    # and start kernels are matched too, for an A/B against it)
    k6_k10s = {e.key[:60]: {"calls": e.count, "device_ms": e.self_device_time_total / 1e3}
               for e in device if any(k in e.key for k in (
                   "blz_gather_kernel", "blz_segment_keys", "blz_seg_flags", "blz_seg_starts"))}
    # K14's and K15's kernels (the same names in an older tree)
    k14_k15 = {e.key[:60]: {"calls": e.count, "device_ms": e.self_device_time_total / 1e3}
               for e in device if any(k in e.key for k in (
                   "blz_range_partition", "blz_xxhash64"))}
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
                    "k18_device": {"calls": sum(e.count for e in k18),
                                   "device_ms": sum(e.self_device_time_total
                                                    for e in k18) / 1e3},
                    "k8_k1_device": k8_k1, "k6_k10_segmentation_device": k6_k10s,
                    "k14_k15_device": k14_k15,
                    "top_device": [{"name": e.key[:80], "calls": e.count,
                                    "device_ms": e.self_device_time_total / 1e3}
                                   for e in top]}))
    torch.cuda.synchronize()
    host = cProfile.Profile()
    t0 = time.perf_counter()
    host.enable()
    got = collect(session, plan)
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
    kernel_k11_stacked(dev, rng, results)
    kernel_k12(dev, rng, results)
    kernel_k13(dev, rng, results)
    kernel_limbs(dev, rng, results)
    battery_limbs = cuda_lib.limb_launch_counts()
    kernel_k14(dev, rng, results)
    kernel_k15(dev, rng, results)
    kernel_k16(dev, rng, results)
    kernel_k17(dev, rng, results)
    kernel_k18(dev, rng, results)
    kernel_k19(dev, rng, results)
    # the segmentation is one kernel a call and no memset
    seg = next(r for r in results if r["name"] == "segment_ids")
    ours = {k: c for k, c in seg["call_kernels"].items() if any(p in k for p in OURS)}
    if sum(ours.values()) != 1 or any(k.startswith("Memset") for k in ours):
        raise AssertionError(f"a segment_ids call ran {seg['call_kernels']}, not one "
                             "kernel and no memset")
    # K1 is one kernel a call and no memset, at each of its paths' shapes
    for label, sh in next(r for r in results if r["name"] == "compact_planes")["shapes"].items():
        ours = {k: c for k, c in sh["call_kernels"].items() if any(p in k for p in OURS)}
        if sum(ours.values()) != 1 or any(k.startswith("Memset") for k in ours):
            raise AssertionError(f"a compact_planes call at {label} ran {sh['call_kernels']}, "
                                 "not one kernel and no memset")
    # K2, K17, K15 and K14 are one kernel a call at each timed shape, with no
    # memset and no pageable upload (K17's table goes through a pinned copy)
    for name in ("murmur3_pmod", "mesh_all_to_all", "xxhash64", "range_partition"):
        for label, sh in next(r for r in results if r["name"] == name)["shapes"].items():
            ours = {k: c for k, c in sh["call_kernels"].items() if any(p in k for p in OURS)}
            if sum(ours.values()) != 1 or any(k.startswith("Memset") for k in ours) or \
                    any("Pageable" in k for k in sh["call_kernels"]):
                raise AssertionError(f"a {name} call at {label} ran {sh['call_kernels']}, not "
                                     "one kernel, no memset and no pageable copy")
    # 4. the paths: q01 (and on the mesh: q01_mesh1, q01_mesh2, q01_mesh8),
    # q67 (slot, sort and table routes), q06 and q47, q69 and q69_bloom, q96
    # (and q96_mesh), q89, q17 (slot, sort and table routes), q98, sort10M
    # (and sort10M_mesh), hash_sample, cust_spend and cust_spend_noskip
    args = sys.argv[1:]
    profile = "--profile" in args
    trace = [a.split("=", 1)[1] for a in args if a.startswith("--trace=")]
    per_path = {
        **run_q01(dev, profile, trace[0] if trace else None),
        **run_q67(dev, profile, trace[0] if trace else None),
        **run_join_paths(dev, profile, trace[0] if trace else None),
        **run_q69(dev, profile, trace[0].replace(".json", "") + "_q69.json"
                  if trace else None),
        **run_q96(dev, profile, trace[0].replace(".json", "") + "_q96.json"
                  if trace else None),
        "q89": run_q89(dev, profile, trace[0].replace(".json", "") + "_q89.json"
                       if trace else None),
        **run_q17(dev, profile, trace[0] if trace else None),
        "q98": run_q98(dev, profile, trace[0].replace(".json", "") + "_q98.json"
                       if trace else None),
        **run_sort10m(dev, profile, trace[0].replace(".json", "") + "_sort10m.json"
                      if trace else None),
        "hash_sample": run_hash_sample(dev, profile, trace[0].replace(".json", "")
                                       + "_hash_sample.json" if trace else None),
        **run_cust_spend(dev, profile, trace[0] if trace else None),
    }
    # the mesh's demo steps (rows 18b, 18c, 18e), after the paths: their
    # plain versions' cached index planes would count in the paths' peaks
    mesh_demos(dev, rng)
    launches = {k: sum(p.get(k, 0) for p in per_path.values())
                for k in set().union(*per_path.values())}
    missing = [k for k in cuda_lib.LAUNCHES if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels launched by no path: {missing}")
    # every limb op of K3/K4, K10 and K12, launched by a path or the battery
    limb_ops = [f"{k}:{kind}" for k in ("slot_agg_partial", "slot_agg_merge",
                                        "seg_agg_partial", "seg_agg_merge")
                for kind in ("sum2", "avg2", "sum3", "avg3", "minw", "maxw")] + \
        [f"slot_update:{op}" for op in ("add_lo32", "add_hi32", "renorm2", "renorm3",
                                         "lexmin", "lexmax")]
    missing = [k for k in limb_ops if launches.get(k, 0) + battery_limbs.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"limb ops launched by no path and not by the battery: {missing}")
    # K8: the joins no aggregate absorbs (q69's address and date joins) and
    # q17_unfused's; K18: every path whose partial aggregate sits on a
    # Filter or a unique-key inner broadcast join
    for q in ("q69", "q17_unfused"):
        if per_path[q]["inner_join_planes"] <= 0:
            raise AssertionError(f"{q} did not go through the join kernel")
    fused = ("q01", "q01_mesh1", "q01_mesh2", "q01_mesh8", "q06", "q47", "q17", "q17_sort",
             "q17_table", "q89", "q98", "q69", "q69_bloom")
    missing = [q for q in fused if per_path[q]["fused_agg_input"] <= 0]
    unfused = [q for q in per_path if q not in fused and per_path[q]["fused_agg_input"]]
    if missing or unfused:
        raise AssertionError(f"K18 did not launch on {missing}, or launched on {unfused}")
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
    # K13: q89's window AVG (run_q89 also holds each reducer with rows to a
    # launch, and K8 to every joined sales batch)
    if per_path["q89"]["segment_scan"] < 1:
        raise AssertionError("q89 did not go through K13")
    # K14: q98's and sort10M's range exchanges (run_sort10m also holds it
    # to one launch a map-side bucketize pass, and both paths hold every
    # launch of their first run to the twin)
    for q in ("q98", "sort10m", "hash_sample"):
        if per_path[q]["range_partition"] < 1:
            raise AssertionError(f"{q} did not go through K14")
    # K15: hash_sample's filter, once a sales batch (4 partitions x 28);
    # the range exchange's sampling reruns only the FINAL above the hash
    # exchange, so the filter runs once (run_hash_sample also holds every
    # launch of its first run to the twin)
    hs_batches = PARTS * ((HS_ROWS // PARTS + 262143) // 262144)
    if per_path["hash_sample"]["xxhash64"] != hs_batches:
        raise AssertionError(f"hash_sample launched K15 {per_path['hash_sample']['xxhash64']}"
                             f" times, not once a sales batch ({hs_batches})")
    # K16: q69_bloom's store filter, once a store batch (4 partitions x
    # 28), and nowhere else; that filter is eager, so K11 runs on every q69
    # batch but those, plus the subquery's fused customer and address
    # filters (one a customer batch, one) (run_q69 also holds every K16
    # launch of the first run to the twin, the filter to the numpy filter
    # and the store side's kept rows to the numpy probe's)
    store_batches = PARTS * ((Q69_ROWS["store_sales"] // PARTS + 262143) // 262144)
    subquery_k11 = PARTS * ((Q69_ROWS["customer"] // PARTS + 262143) // 262144) + 1
    if per_path["q69_bloom"]["bloom_probe"] != store_batches:
        raise AssertionError(f"q69_bloom launched K16 {per_path['q69_bloom']['bloom_probe']}"
                             f" times, not once a store batch ({store_batches})")
    want_k11 = per_path["q69"]["fused_chain"] - store_batches + subquery_k11
    if per_path["q69_bloom"]["fused_chain"] != want_k11:
        raise AssertionError(f"q69_bloom launched K11 {per_path['q69_bloom']['fused_chain']} "
                             f"times, not q69's {per_path['q69']['fused_chain']} less the "
                             f"{store_batches} store batches plus the subquery's "
                             f"{subquery_k11} ({want_k11})")
    if per_path["q69_bloom"]["xxhash64"] <= store_batches:
        raise AssertionError("q69_bloom's subquery did not hash its customers with K15")
    # K19: cust_spend only (run_cust_spend holds it to every batch after
    # each partition's first); no other path skips a partial
    skipping = [q for q, p in per_path.items()
                if q != "cust_spend" and (p.get("partial_skipped_batches", 0) or
                                          p["passthrough_states"])]
    if skipping:
        raise AssertionError(f"partial skipping engaged on {skipping}")
    # 5. summary lines
    for r in results:
        if r["name"] == "range_partition":
            r["path_batches"] = RANGE_PATH_TIMES
        if r["name"] == "xxhash64":
            r["path_batches"] = XXH_PATH_TIMES
        if r["name"] == "bloom_probe":
            r["path_batches"] = BLOOM_PATH_TIMES
        if r["name"] == "mesh_all_to_all":
            r["path_batches"] = MESH_PATH_TIMES
        if r["name"] == "fused_agg_input":
            r["path_batches"] = K18_PATH_BATCHES
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for r in results:
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        r["launches"] = launches.get(r["name"], 0)
        r["launches_per_path"] = {q: per_path[q].get(r["name"], 0) for q in per_path}
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
                                             "battery_s", "fold_ms", "unpacked_ms",
                                             "six_kinds_ms", "fold_replaces", "fold_shape",
                                             "device_ms",
                                             "path_batches", "eight_single_ms", "phases_us",
                                             "library_device_ms",
                                             "host_ms", "k11_device_ms", "shapes",
                                             "call_kernels")
                           if k in r}}))
        kernels.append({k: r[k] for k in keys})
    log(json.dumps({"phase": "limb_ops", "paths": {
        q: {k: v for k, v in p.items() if ":" in k} for q, p in per_path.items()},
        "battery": battery_limbs}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
