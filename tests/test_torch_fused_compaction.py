"""K11 compacting its own filtered groups, against the JAX package: fused
chains whose filter keeps no row, keeps every row, an expand with two
filtered groups and batches whose capacity is not a multiple of K11's
1,024-row tile, through ``blaze_tpu_torch.Session(device="cpu")`` (fusion
on and off) and ``blaze_tpu.Session``; and the generated source of a
filtered chain: it parses, binds every name before reading it, and holds
the look-back, the stores of every plane of the group at its offset plus
rank, the count and the zeroing of the padding.

On the CPU the segment takes K11's plain version; the generated kernel
runs on the card (tests/test_torch_cuda.py), held there to that version.

Tolerance: none; plan results compare exactly, order included.
"""

import ast
import dataclasses
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.config import Config as JaxConfig
from blaze_tpu.ir import exprs as JE
from blaze_tpu.ir import nodes as JN
from blaze_tpu.ir import types as JT
from blaze_tpu.runtime.session import Session as JaxSession

import blaze_tpu_torch
from blaze_tpu_torch.config import Config
from blaze_tpu_torch.exprs.fused_triton import FusedKernel
from blaze_tpu_torch.ir.carry import from_foreign
from blaze_tpu_torch.ir.fusion import chain_steps, fuse_plan
from blaze_tpu_torch.ir import nodes as N
from tests.test_torch_fusion import _read_before_bound

torch.set_num_threads(1)

C, L, B = JE.Column, JE.Literal, JE.BinaryOp
SCHEMA = JT.Schema.of(("a", JT.I64), ("b", JT.F64), ("c", JT.I64), ("d", JT.I64))


def _table(seed, parts=2, rows=2500):
    """Column a non-null (so a filter can keep every row); b, c, d with 5%
    nulls (data 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(parts):
        part = {"a": (rng.integers(0, 100, rows), np.ones(rows, bool))}
        for k, draw in (("b", rng.standard_normal), ("c", lambda n: rng.integers(0, 10, n)),
                        ("d", lambda n: rng.integers(0, 1000, n))):
            v = rng.random(rows) >= 0.05
            part[k] = (np.where(v, draw(rows), 0), v)
        out.append(part)
    return out


def _scan():
    return JN.FFIReader(SCHEMA, "t", 2)


def _keeps_none():
    return JN.Projection(JN.Filter(_scan(), [JE.BinaryExpr(B.GT, C("a"), L(10**9, JT.I64))]),
                         [C("a"), JE.BinaryExpr(B.ADD, C("c"), C("d"))], ["a", "cd"])


def _keeps_all():
    return JN.Projection(JN.Filter(_scan(), [JE.IsNotNull(C("a"))]),
                         [C("a"), C("b"), JE.BinaryExpr(B.MUL, C("d"), L(3, JT.I64))],
                         ["a", "b", "d3"])


def _expand_two_filtered():
    """A filter, an expand into two groups (both filtered), a filter on
    each: two filtered output groups a batch."""
    schema = JT.Schema.of(("a", JT.I64), ("v", JT.I64), ("tag", JT.I64))
    return JN.Filter(
        JN.Expand(JN.Filter(_scan(), [JE.BinaryExpr(B.LT, C("c"), L(6, JT.I64))]),
                  [[C("a"), C("d"), L(0, JT.I64)],
                   [C("a"), JE.BinaryExpr(B.MUL, C("d"), L(10, JT.I64)), L(1, JT.I64)]],
                  schema),
        [JE.BinaryExpr(B.GT, C("v"), L(300, JT.I64))])


PLANS = {"keeps none": _keeps_none, "keeps all": _keeps_all,
         "expand, two filtered groups": _expand_two_filtered}


def _arrow(part, batch):
    n = len(part["a"][0])
    types = {"a": pa.int64(), "b": pa.float64(), "c": pa.int64(), "d": pa.int64()}
    return [pa.record_batch([pa.array(d[s:s + batch], type=types[k], mask=~v[s:s + batch])
                             for k, (d, v) in part.items()], names=list(part))
            for s in range(0, n, batch)]


def _slices(part, batch):
    n = len(part["a"][0])
    return [{k: (d[s:s + batch], v[s:s + batch]) for k, (d, v) in part.items()}
            for s in range(0, n, batch)]


def _port(plan, parts, batch, fusion=True):
    port = blaze_tpu_torch.Session(conf=Config(batch_size=batch, fusion_enabled=fusion),
                                   device="cpu")
    port.resources["t"] = lambda p: _slices(parts[p], batch)
    return port.execute_to_pydict(from_foreign(plan))


# batch sizes whose capacities (256, 512, 4096 with a 2500-row last batch
# in a 4096 bucket) are not multiples of the tile, and one that is (1024)
@pytest.mark.parametrize("batch", [200, 300, 1024, 4096])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_filtered_chains_match_jax(tmp_path, name, batch):
    plan = PLANS[name]()
    parts = _table(seed=len(name) + batch)
    fused = fuse_plan(from_foreign(plan), Config())
    assert isinstance(fused, N.FusedStage)
    with JaxSession(conf=dataclasses.replace(JaxConfig(batch_size=batch),
                                             shm_dir=str(tmp_path))) as s:
        s.resources["t"] = lambda p: _arrow(parts[p], batch)
        want = s.execute_to_pydict(plan)
    rows = len(next(iter(want.values())))
    assert {"keeps none": rows == 0, "keeps all": rows == 5000,
            "expand, two filtered groups": 0 < rows < 10_000}[name], rows
    assert _port(plan, parts, batch) == want
    assert _port(plan, parts, batch, fusion=False) == want


def test_filtered_source_holds_the_look_back_and_its_stores():
    """The expand's kernel: two filtered groups, each stored at its
    offset plus rank and zeroed past its count; one look-back and one
    total a group, reading state words of its own."""
    plan = fuse_plan(from_foreign(_expand_two_filtered()), Config())
    steps = [st for st in chain_steps(plan.ops) if st[0] != "coalesce"]
    kernel = FusedKernel(plan.child.output_schema, steps)
    src = kernel.source
    tree = ast.parse(src)
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)]
    assert names[-1] == "fused_chain" and {"_look_back", "_group_total"} <= set(names)
    assert _read_before_bound(tree) == []
    gen = kernel.gen
    assert len(gen.filtered) == 2
    for f, (_mask, planes) in enumerate(gen.filtered):
        assert f"e{f} = _look_back(state + 1 + {f}, ticket, 2, tag, c{f}, is_tile)" in src
        assert f"tl.cumsum(m{f}.to(tl.int64), axis=0)" in src
        assert f"n{f} = _group_total(state + 1 + (ntiles - 1) * 2 + {f}, tag" in src
        assert f"tl.store(counts + {f}, e{f} + c{f}, mask=last)" in src
        for j in range(len(planes)):
            assert re.search(rf"tl\.store\(g{f}_{j} \+ p{f}, .*mask=m{f}\)", src)
            assert re.search(rf"tl\.store\(g{f}_{j} \+ zoffs, .*mask=z{f}\)", src)
    # release and acquire on the status words; the tickets' counter reset
    assert 'sem="release"' in src and 'sem="acquire"' in src
    assert "tl.atomic_xchg(state, 0, mask=ticket == 2 * ntiles - 1)" in src
    # no mask plane is stored: the groups compact in the kernel
    assert src.count("tl.store(") == sum(2 * len(p) + 1 for _m, p in gen.filtered) + \
        len(gen.full_stores)


def test_unfiltered_source_takes_no_tickets():
    """A chain without a filter stores its planes in place, one program a
    tile: no tickets, no look-back."""
    ac = from_foreign(JE.BinaryExpr(B.ADD, C("a"), C("c")))
    kernel = FusedKernel(from_foreign(SCHEMA), (("project", (ac,), ("ac",)),))
    assert not kernel.gen.filtered
    assert "_look_back" not in kernel.source and "ticket" not in kernel.source
    assert "tl.program_id(0)" in kernel.source
