#!/usr/bin/env python3
"""Path walls of one checkout of the PyTorch/CUDA port, for same-call A/B
comparisons on one NVIDIA GPU.

    python3 chip_ab.py [--tree DIR] [--label NAME] [--paths q67,q67_sort,q69]
                       [--runs N] [--no-fusion] [--no-fused-agg] [--profile]
                       [--trace=DIR]
    python3 chip_ab.py [--tree DIR] [--label NAME] --kernels=k3_k4,k10,limbs,k12,k19,k5,k7,k8,k11
                       [--shapes DIR]
    python3 chip_ab.py [--tree DIR] [--label NAME] --kernels=k2,k17 [--shapes DIR]
    python3 chip_ab.py [--tree DIR] [--label NAME] --kernels=k15,k14 [--shapes DIR]
    python3 chip_ab.py [--tree DIR] --resources=murmur3,mesh,xxhash64,range_partition
    python3 chip_ab.py [--tree DIR] --variants=k15,k14

Paths: q01, q01_mesh1, q01_mesh2, q01_mesh8, q67, q67_sort, q67_table,
q69, q69_bloom, q06, q47, q96, q96_mesh, q17, q17_sort, q17_table, q89,
q98, sort10m, sort10m_mesh, hash_sample, cust_spend and cust_spend_noskip
(a checkout from before a path has no data to stage for it; each stages
and checks its data as chip_smoke.py does: sort10m collects numpy
planes, q69_bloom runs its subquery in each run).

``--kernels`` runs, in place of paths, the named kernel phases of that
checkout's chip_smoke.py (``kernel_<name>``: each holds its kernels to
their plain versions and times them) and prints one JSON line per timed
kernel: its shape, CUDA-event ms, device ms, the wrapper's host ms, plain
ms (and the plain chain's device ms), library ms, bound and extra shapes,
whichever the checkout's phase records (``k8``: q96's three probes, q69's
date probe and q06's all-hit batch; ``k11``: q69's and q96's scan filters,
with the generated kernel's own device ms; ``k2``: cust_spend's, q67's and
q01's exchange batches; ``k17``: sort10M_mesh's and q01_mesh8's exchanges
with the 32-byte sectors of their gathers; ``k15``: hash_sample's and
q69_bloom's batches; ``k14``: sort10M's map batch at 31 and 199 bounds,
one key beside torch.searchsorted's events and device ms, and
hash_sample's store exchange, with each route's device ms at 3 to 199
bounds in ``route_ms``). A process that has run torch.profiler launches
slower from then on, so the k2, k17, k15 and k14 phases take the
wrapper's host ms first; give each phase its own process to keep its host
ms clear of an earlier phase's profiler.

``--shapes=DIR`` imports ``chip_smoke`` from the checkout at DIR in place
of ``--tree``'s (the package still from ``--tree``): an older tree's
kernels at a newer tree's shapes and cases (its ``kernel_k1`` and
``kernel_k18`` run against a tree from before K18's routes).

``--resources=NAME,...`` builds DIR's kernels and prints, for each kernel
whose name holds one of the names, ptxas's registers, stack frame and
spills and the local-memory loads and stores (LDL, STL) in its SASS
(``cuobjdump``), one JSON line a kernel.

``--variants=k15,k14`` builds design variants of K15's and K14's sources
(each a copy of csrc/ with one edit, built with nvcc into its own library
under the build directory: K15 at 128 threads a block as committed, at
256, and at 128 with its XXH64 rounds left out, the loads' and stores'
own floor; K14 at 256 threads as committed and at 512), launches each
through the checkout's packs at chip_smoke.py's shapes (XXH_HASH_SAMPLE,
XXH_Q69_BLOOM, K14_SHAPES) held to the twin, and prints each variant's
torch.profiler device ms, one JSON line a shape.

Imports ``chip_smoke`` and ``blaze_tpu_torch`` from the checkout at DIR
(default: this one) and, for each named path, stages its data once (as
chip_smoke.py does, same seeds and sizes), makes a first run (kernel
builds and Triton compiles), then N timed runs; every run must equal the
path's numpy oracle. Prints one JSON line per path with every wall and the
launch counts of the last run. ``--no-fusion`` runs with
``Config(fusion_enabled=False)`` (only in a checkout that has the knob),
``--no-fused-agg`` with ``Config(fused_filter_agg=False)`` (the partial
aggregates take their input unfused); ``--profile`` adds that checkout's
``chip_smoke.profile_query`` run of each path (torch.profiler busy share,
then cProfile's top host functions), and ``--trace=DIR`` with it writes
that run's Chrome trace to DIR/<label>_<path>.json and prints the run's
copies by kind (count, bytes, device ms) beside a probe of this
process's pageable host-to-device rate (a 2 MiB copy, CUDA events). The
peak device memory is taken over the timed runs (staged data included).

Clocks and the host's load drift between processes and between calls:
compare two checkouts only within one call, alternating processes (A, B,
B, A, A, B, ...). Needs one CUDA device; exits 2 without one.
"""

import json
import os
import statistics
import sys
import time


def _args(argv):
    opts = {"tree": os.path.dirname(os.path.abspath(__file__)), "label": "",
            "paths": "q67_sort,q69", "runs": "5", "kernels": "", "trace": "", "shapes": "",
            "resources": "", "variants": ""}
    flags = set()
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            if k not in opts:
                raise SystemExit(f"chip_ab: unknown option --{k}")
            opts[k] = v
        elif a in ("--no-fusion", "--no-fused-agg", "--profile"):
            flags.add(a[2:])
        else:
            raise SystemExit(f"chip_ab: unknown argument {a}")
    return opts, flags


def _q01_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    schema, parts, host = cs.make_data(dev)
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    session.resources["store_returns"] = lambda p: parts[p]
    return session, cs.q01_plan(schema), cs.q01_oracle(host)


def _q67_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    schema, parts, host = cs.make_q67_data(dev)
    want, _groups = cs.q67_oracle(host)
    # q67_table: the default merge budget, past which the FINAL is the host
    # table's (K12)
    kw = dict(conf_kw) if name == "q67_table" else \
        dict(conf_kw, device_merge_max_bytes=cs.Q67_MERGE_BYTES)
    if name == "q67_sort":
        kw.update(dense_agg=False, radix_agg=False)
    session = blaze_tpu_torch.Session(Config(**kw))
    session.resources["store_sales"] = lambda p: parts[p]
    return session, cs.q67_plan(schema), \
        cs.q67_table_check(want) if name == "q67_table" else want


def _q01_mesh_setup(cs, dev, name, conf_kw):
    """q01_mesh1/2/8: q01's data and plan on a mesh of 1, 2 or 8 slots."""
    session, plan, want = _q01_setup(cs, dev, name, conf_kw)
    mesh = cs.mesh_session(dev, int(name[len("q01_mesh"):]))
    mesh.resources["store_returns"] = session.resources["store_returns"]
    return mesh, plan, want


def _q47_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    sales, item, parts, items, host, item_cols = cs.make_join_data(dev)
    check, _groups, _rows = cs.q47_oracle(host, item_cols)
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    session.resources["store_sales"] = lambda p: parts[p]
    session.resources["item"] = lambda p: items
    return session, cs.q47_plan(sales, item), check


def _q69_bloom_setup(cs, dev, name, conf_kw):
    """q69_bloom as chip_smoke.py runs it: the bloom subquery, then q69
    with its filter, both in each run."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    session, _plan, want = _q69_setup(cs, dev, name, conf_kw)
    schemas = cs.q69_schemas()
    blobs = []
    return session, cs.q69_bloom_subquery(schemas, E, N, T), want, \
        lambda s, plan: cs.q69_bloom_collect(s, plan, schemas, blobs)


def _hash_sample_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    schema = cs.hash_sample_schema(T)
    cols, valids = cs.hash_sample_host()
    want, _info = cs.hash_sample_oracle((cols, valids))
    cuts = [cs.HS_ROWS * p // cs.PARTS for p in range(cs.PARTS + 1)]
    parts = [cs.stage_batches(schema, [c[a:b] for c in cols], dev,
                              valids=[None if v is None else v[a:b] for v in valids])
             for a, b in zip(cuts, cuts[1:])]
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    session.resources["store_sales"] = lambda p: parts[p]
    return session, cs.hash_sample_plan(schema, E, N, T), want


def _sort10m_setup(cs, dev, name, conf_kw):
    """sort10M (or sort10M_mesh, on 8 slots), collected as numpy planes."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    schema = cs.sort10m_schema(T)
    host = cs.sort10m_host()
    want, _info = cs.sort10m_oracle(host)
    parts = [cs.stage_batches(schema, cols, dev) for cols in host]
    session = cs.mesh_session(dev, 8) if name == "sort10m_mesh" else \
        blaze_tpu_torch.Session(Config(**conf_kw))
    session.resources["store_sales"] = lambda p: parts[p]
    return session, cs.sort10m_plan(schema, E, N), want, cs.sort10m_collect


def _q96_setup(cs, dev, name, conf_kw):
    """q96: three broadcast joins to a global COUNT(1) through the host
    table (K12), as chip_smoke.py runs it."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    schemas, host = cs.q96_schemas(T), cs.q96_host(cs.Q96_ROWS)
    want = cs.q96_oracle(host)
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    cs.stage_star(session, schemas, host, dev)
    return session, cs.q96_plan(schemas, E, N, T), want


def _q96_mesh_setup(cs, dev, name, conf_kw):
    """q96_mesh: q96's data and plan on a mesh of 8 slots (the stacked K11,
    K17 for its exchange, K12 for the count), as chip_smoke.py runs it."""
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    session, plan, want = _q96_setup(cs, dev, name, conf_kw)
    mesh = cs.mesh_session(dev, 8)
    for table in cs.q96_schemas(T):
        mesh.resources[table] = session.resources[table]
    return mesh, cs.q96_plan(cs.q96_schemas(T), E, N, T), want


def _copies(trace_path):
    """The copies of a Chrome trace by kind: count, bytes, device ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            c = out.setdefault(e["name"], {"count": 0, "bytes": 0, "device_ms": 0.0})
            c["count"] += 1
            c["bytes"] += int(e.get("args", {}).get("bytes", 0))
            c["device_ms"] += e.get("dur", 0) / 1e3
    return out


def _pageable_probe(dev, nbytes=1 << 21, iters=100):
    """This process's pageable host-to-device rate in GB/s: the median of
    ``iters`` copies of ``nbytes`` from a numpy array, by CUDA events."""
    import numpy as np
    import torch

    src = torch.from_numpy(np.ones(nbytes // 8, np.int64))
    dst = torch.empty(nbytes // 8, dtype=torch.int64, device=dev)
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return nbytes / (statistics.median(times) / 1e3) / 1e9


def _q69_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    schemas, staged, host = cs.make_q69_data(dev)
    want, _steps, _rows = cs.q69_oracle(host)
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    for table, parts in staged.items():
        session.resources[table] = lambda p, _parts=parts: _parts[p]
    return session, cs.q69_plan(schemas), want


def _q06_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    sales, item, parts, items, host, item_cols = cs.make_join_data(dev)
    want = cs.q06_oracle(host, item_cols)
    session = blaze_tpu_torch.Session(Config(**conf_kw))
    session.resources["store_sales"] = lambda p: parts[p]
    session.resources["item"] = lambda p: items
    return session, cs.q06_plan(sales, item), want


def _q17_setup(cs, dev, name, conf_kw):
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config

    (sales, item, store), parts, items, stores, host = cs.make_q17_data(dev)
    want = cs.q17_oracle(*host)
    kw = dict(conf_kw)
    if name == "q17_sort":
        kw.update(dense_agg=False, radix_agg=False)
    elif name == "q17_table":
        kw.update(device_merge_max_bytes=cs.Q17_TABLE_MERGE_BYTES)
    session = blaze_tpu_torch.Session(Config(**kw))
    session.resources["store_sales"] = lambda p: parts[p]
    session.resources["item"] = lambda p: items
    session.resources["store"] = lambda p: stores
    return session, cs.q17_plan(sales, item, store), want


def _star_setup(cs, dev, name, conf_kw):
    """q89 (the default routes) or q98 (the sort route, as chip_smoke.py
    runs it)."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    if name == "q89":
        schemas, host = cs.q89_schemas(T), cs.q89_host(cs.Q89_ROWS)
        want, _info, _window = cs.q89_oracle(host)
        plan, kw = cs.q89_plan(schemas, E, N, T), dict(conf_kw)
    else:
        schemas, host = cs.q98_schemas(T), cs.q98_host(cs.Q98_ROWS)
        want, _info = cs.q98_oracle(host)
        plan, kw = cs.q98_plan(schemas, E, N, T), dict(conf_kw, dense_agg=False,
                                                       radix_agg=False)
    session = blaze_tpu_torch.Session(Config(**kw))
    cs.stage_star(session, schemas, host, dev)
    return session, plan, want


def _cust_setup(cs, dev, name, conf_kw):
    """cust_spend (partial skipping on) or cust_spend_noskip."""
    import blaze_tpu_torch
    from blaze_tpu_torch.config import Config
    from blaze_tpu_torch.ir import exprs as E
    from blaze_tpu_torch.ir import nodes as N
    from blaze_tpu_torch.ir import types as T

    schema, parts, _host, check, _groups = cs.make_cust_spend_data(dev)
    kw = dict(conf_kw)
    if name == "cust_spend_noskip":
        kw.update(partial_agg_skipping_enable=False)
    session = blaze_tpu_torch.Session(Config(**kw))
    session.resources["store_sales"] = lambda p: parts[p]
    return session, cs.cust_spend_plan(schema, E, N, T), check


def _kernels(cs, dev, opts) -> int:
    import numpy as np

    rng = np.random.default_rng(7)
    for phase in opts["kernels"].split(","):
        results = []
        t0 = time.perf_counter()
        getattr(cs, f"kernel_{phase}")(dev, rng, results)
        for r in results:
            line = {k: r.get(k) for k in ("name", "shape", "ms", "device_ms", "host_ms",
                                          "plain_ms", "plain_device_ms", "library_ms",
                                          "library_device_ms",
                                          "library_host_ms", "library_call", "bytes",
                                          "shapes", "stream_object_ms", "stream_raw_ms",
                                          "phases_us", "k11_device_ms", "hits",
                                          "call_kernels", "route_ms", "segment_ids_ms")}
            line["bound_ms"] = r["bytes"] / cs.HBM_BYTES_PER_S * 1e3
            print(json.dumps({"phase": "ab_kernel", "label": opts["label"], "tree":
                              os.path.abspath(opts["tree"]), "shapes": cs.__file__,
                              "kernels": phase,
                              "seconds": time.perf_counter() - t0, **line}), flush=True)
    return 0


def _resources(names) -> int:
    """ptxas's report and the SASS local-memory accesses of the kernels
    whose (mangled) names hold one of ``names``."""
    import re
    import subprocess

    from blaze_tpu_torch.utils import cuda_lib

    lib = cuda_lib.build()
    report = str(cuda_lib.BUILD_INFO.get("ptxas", ""))
    if not report:  # a cached build: its log sits beside the library
        with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
            report = f.read()
    ptxas, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "stack frame" in ln):
            ptxas.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    sass = subprocess.run([os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump"),
                           "-sass", lib], capture_output=True, text=True).stdout
    local, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            local[fn] = [0, 0]
        elif fn:
            local[fn][0] += bool(re.search(r"\bLDL\b", ln))
            local[fn][1] += bool(re.search(r"\bSTL\b", ln))
    for fn in sorted(set(ptxas) | set(local)):
        if any(n in fn for n in names):
            print(json.dumps({"phase": "resources", "kernel": fn, "ptxas": ptxas.get(fn),
                              "sass_ldl": local.get(fn, [None])[0],
                              "sass_stl": local.get(fn, [None, None])[1]}), flush=True)
    return 0


# --variants: (kernel, variant) -> (source, {file: [(text, replacement)]});
# the rounds-free K15 returns the seed xor the word from both XXH64 rounds
_NO_ROUNDS = (r"(unsigned long long v,\s+unsigned long long seed\) \{)",
              r"\1\n  return seed ^ v;")
VARIANTS = {
    ("k15", "128 threads (committed)"): ("xxhash64.cu", {}),
    ("k15", "256 threads"): ("xxhash64.cu", {"xxhash64.cu": [(
        "#define BLZ_XXH_THREADS 128", "#define BLZ_XXH_THREADS 256")]}),
    ("k15", "128 threads, no XXH64 rounds"): ("xxhash64.cu", {"xxhash64.cu": [_NO_ROUNDS]}),
    ("k14", "256 threads (committed)"): ("range_part.cu", {}),
    ("k14", "512 threads"): ("range_part.cu", {"common.cuh": [(
        "#define BLZ_H_THREADS 256", "#define BLZ_H_THREADS 512")]}),
}


def _variant_lib(name, source, edits):
    """A variant of one kernel source built into its own library."""
    import ctypes
    import re
    import subprocess

    from blaze_tpu_torch.utils import cuda_lib

    d = os.path.join(cuda_lib.build_dir(), "variants", re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in (source, "common.cuh"):
        with open(os.path.join(cuda_lib.CSRC, f)) as fh:
            text = fh.read()
        for a, b in edits.get(f, ()):
            new = re.sub(a, b, text) if a.startswith("(") else text.replace(a, b)
            if new == text:
                raise SystemExit(f"chip_ab: variant {name}: {a!r} not in {f}")
            text = new
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, "lib.so")
    out = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", lib,
                          os.path.join(d, source)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"chip_ab: variant {name}: {out.stderr[-2000:]}")
    fn = getattr(ctypes.CDLL(lib), "blz_xxhash64" if source == "xxhash64.cu"
                 else "blz_range_partition_ids")
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def _variants(cs, dev, names) -> int:
    import numpy as np
    import torch
    from blaze_tpu_torch.core import kernels as K
    from blaze_tpu_torch.exprs import spark_hash as H

    rng = np.random.default_rng(7)
    fns = {key: _variant_lib(" ".join(key), *spec) for key, spec in VARIANTS.items()
           if key[0] in names}
    if "k15" in names:
        for case in (cs.XXH_HASH_SAMPLE, cs.XXH_Q69_BLOOM):
            words, valids, kinds, n, cap = cs.xxh_case(case, rng, dev)
            want = H.xxhash64_rows_plain(words, valids, kinds, n, cap)
            out = {}
            for (kernel, label), fn in fns.items():
                if kernel != "k15":
                    continue
                pack = H.Xxh64Pack(valids[0].get_device(), words, valids, kinds)
                pack.fn = fn
                got = pack.launch(words, valids, n, cap)
                if "no XXH64" not in label and not torch.equal(got, want):
                    raise SystemExit(f"chip_ab: K15 variant {label} differs from the twin")
                out[label] = cs.kernel_device_ms(lambda: pack.launch(words, valids, n, cap),
                                                 "blz_xxhash64")
            print(json.dumps({"phase": "variants", "kernel": "k15", "shape": case[0],
                              "device_ms": out}), flush=True)
    if "k14" in names:
        for keys, nb, rows, cap, distinct in cs.K14_SHAPES:
            m = cs.k14_shape(keys, nb, rows, cap, distinct, rng, dev)
            want = m["plain"]()
            out = {}
            for (kernel, label), fn in fns.items():
                if kernel != "k14":
                    continue
                for route in (K.RANGE_COUNT, K.RANGE_SEARCH):
                    pack = K.RangePack(m["ops"], m["spec"], [d.dtype for d in m["datas"]],
                                       route=route)
                    pack.fn = fn
                    if not torch.equal(pack.launch(m["datas"], m["valids"], m["ex"]), want):
                        raise SystemExit(f"chip_ab: K14 variant {label} differs from the twin")
                    out[f"{label}, {'count' if route == K.RANGE_COUNT else 'search'}"] = \
                        cs.kernel_device_ms(lambda pack=pack: pack.launch(
                            m["datas"], m["valids"], m["ex"]), "blz_range_partition")
            print(json.dumps({"phase": "variants", "kernel": "k14", "keys": len(keys),
                              "bounds": nb, "rows": rows, "device_ms": out}), flush=True)
    return 0


SETUPS = {"q01": _q01_setup, "q01_mesh1": _q01_mesh_setup, "q01_mesh2": _q01_mesh_setup,
          "q01_mesh8": _q01_mesh_setup, "q67": _q67_setup, "q67_sort": _q67_setup,
          "q67_table": _q67_setup, "q69": _q69_setup, "q69_bloom": _q69_bloom_setup,
          "q06": _q06_setup, "q47": _q47_setup, "q96": _q96_setup,
          "q96_mesh": _q96_mesh_setup,
          "q17": _q17_setup, "q17_sort": _q17_setup, "q17_table": _q17_setup,
          "q89": _star_setup, "q98": _star_setup, "sort10m": _sort10m_setup,
          "sort10m_mesh": _sort10m_setup, "hash_sample": _hash_sample_setup,
          "cust_spend": _cust_setup, "cust_spend_noskip": _cust_setup}


def main(argv) -> int:
    opts, flags = _args(argv)
    try:
        import torch
    except ImportError:
        print("chip_ab: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(opts["tree"])
    shapes = os.path.abspath(opts["shapes"] or tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(shapes, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import blaze_tpu_torch
    from blaze_tpu_torch.utils import cuda_lib

    if not os.path.samefile(os.path.dirname(os.path.dirname(blaze_tpu_torch.__file__)), tree):
        raise SystemExit(f"chip_ab: imported blaze_tpu_torch from {blaze_tpu_torch.__file__}, "
                         f"not {tree}")
    if opts["resources"]:
        return _resources(opts["resources"].split(","))
    cuda_lib.library()
    dev = torch.device("cuda")
    if opts["variants"]:
        return _variants(cs, dev, opts["variants"].split(","))
    conf_kw = {}
    if "no-fusion" in flags:
        conf_kw["fusion_enabled"] = False
    if "no-fused-agg" in flags:
        conf_kw["fused_filter_agg"] = False
    if opts["kernels"]:
        return _kernels(cs, dev, opts)
    runs = int(opts["runs"])
    for name in opts["paths"].split(","):
        t0 = time.perf_counter()
        session, plan, want, *collect = SETUPS[name](cs, dev, name, conf_kw)
        collect = collect[0] if collect else cs.pydict_of
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs.check_result(f"{name} (first run)", collect(session, plan), want)
        first_s = time.perf_counter() - t0
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(runs):
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            got = collect(session, plan)
            walls.append(time.perf_counter() - t0)
            cs.check_result(name, got, want)
        print(json.dumps({"phase": "ab", "label": opts["label"], "tree": tree,
                          "query": name, "fusion": "no-fusion" not in flags,
                          "fused_agg": "no-fused-agg" not in flags,
                          "setup_s": setup_s, "first_run_s": first_s, "walls_s": walls,
                          "median_s": statistics.median(walls),
                          "max_memory_allocated": torch.cuda.max_memory_allocated(),
                          "launches": cuda_lib.launch_counts()}), flush=True)
        if "profile" in flags:
            trace = os.path.join(opts["trace"], f"{opts['label']}_{name}.json") \
                if opts["trace"] else None
            cs.profile_query(name, session, plan, want, trace, collect)
            if trace:
                print(json.dumps({"phase": "copies", "label": opts["label"], "query": name,
                                  "copies": _copies(trace),
                                  "pageable_htod_gb_s": _pageable_probe(dev)}), flush=True)
        del session, plan, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
