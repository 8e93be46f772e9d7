"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the q01 slice on the card against the same plan on the CPU.

Marked ``cuda``: each test skips here (no GPU) and runs on a machine with
one, where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (integer, bool and int64-backed decimal planes only).
"""

import numpy as np
import pytest
import torch

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
    assert all(v > 0 for v in cuda_lib.launch_counts().values())
