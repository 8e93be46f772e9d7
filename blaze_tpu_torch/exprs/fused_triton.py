"""K11: one generated Triton kernel per fused chain segment.

Replaces blaze_tpu/exprs/compiler.py:1042 ``build_fused_closure``, which
the JAX package jits once per chain fingerprint (blaze_tpu/ops/fused.py).
The counterpart of a program specialised per chain is a kernel generated
per chain: ``FusedKernel`` turns a segment (input schema plus project /
filter / rename / expand steps) into the source of one ``@triton.jit``
kernel, writes it to ``build_kernels/fused/<fingerprint>.py`` (or under
``$BLAZE_TORCH_KERNEL_DIR``) and imports it from there, since
``@triton.jit`` reads its source with ``inspect``. Triton compiles it at
its first launch; ``triton`` is imported only then, so the package imports
where there is none.

One program takes 1,024 rows. For each row the kernel loads the data and
validity planes the chain reads, evaluates every expression with the
semantics of ``exprs/compiler.py`` and ``exprs/decimal.py`` (op for op,
in the same types) and keeps one live mask per output group (filters only
narrow it). An unfiltered group's new planes are stored in place, rows
past ``num_rows`` carrying what the plain version gives them (the value,
validity False); a column that passes an input data plane through is not
stored, the group shares it.

A segment with a filtered group compacts every such group in the same
launch (``_Gen._compacting_source``), stable, padding zeroed:
- programs take tickets (``tl.atomic_add`` on a counter the last ticket
  resets), so a program waits only on programs that started before it;
  the first ntiles tickets are the batch's tiles, the rest zero padding;
- a tile counts each filtered group's live rows (``tl.sum``) and takes
  the group's exclusive prefix from a decoupled look-back over a
  per-group status array (``_look_back``: words published with release
  and read with acquire atomics, 256 earlier tiles a round, tagged by
  the launch so the array is never zeroed); ranks within the tile come
  from ``tl.cumsum``; every plane of the group (the input planes it
  passes through, loaded for it, and its new ones) is stored at prefix +
  rank; the last tile writes the group counts into one small array that
  the segment's one count sync reads;
- a zeroing program clears its 1,024 rows of every filtered plane past
  the group's count: at once for rows at or past ``num_rows``, else once
  the last tile's inclusive word is published (``_group_total``; every
  tile has started by then, and none waits on a zeroing program).
The stacked form (below) keeps the mask store and compacts with K1
(csrc/compact.cu) a batch.

Bound: device memory. A chain reads a few planes and writes a few, with
a handful of integer or float operations a row; nothing is reused, so no
shared memory and no tensor cores. Triton's blocked loads and stores
serve that as well as CUDA C++ would, and need no nvcc at run time. The
compaction's stores go to computed offsets, which Triton issues an
element a thread (its loads and in-place stores are vectors).

Bit-equality with the plain version (``core/kernels.fused_chain_plain``),
which the generator guards:

- launches pass ``enable_fp_fusion=False``: no ``a*b + c`` becomes an FMA
  (float MOD, decimal-from-float rounding);
- f32 division and truncation are inline PTX ``div.rn.f32`` and
  ``cvt.rzi.f32.f32`` (IEEE, subnormals kept); f64 ``/`` is IEEE already;
- Triton's ``//`` truncates, so floor division, Java division and HALF_UP
  division are written out as ``exprs/decimal.py`` writes them, with
  ``a // -1 = -a``;
- every literal and constant is an int64 word in a small device table
  (floats as their bit patterns) and is cast or bitcast in the kernel, so
  no Python scalar is typed i32 or fp32 by Triton;
- bool planes load as ``i1`` and widen through ``tl.where(b, 1, 0)``;
  int8/int16 results are cast back to their type after every operation;
- a float -> int cast masks the out-of-range lanes before the convert
  (Java's NaN -> 0 and saturation); decimal -> double is a float64 divide;
  timestamp -> date and -> seconds use ``_floordiv``.

The stacked form (``stacked_source``, ``launch_stacked``; the device
mesh's ShardedFusedRunner, parallel/mesh.py) is generated from the same
body: k <= n batches of one capacity in one launch, the batch on the
grid's second axis, each batch's planes read through an int64 table of
their addresses (no stacking copy) and its row count from the same
table; each output plane is (k, capacity), a filtered group's live mask
among them, and K1 compacts each filtered group of each batch. It
replaces the JAX package's closure under ``shard_map``
(blaze_tpu/parallel/mesh.py:671), which runs one batch a device; here the
k batches share one launch. The single-batch kernel's source is
unchanged by it.

K18 (``FusedAggKernel``, the section at the end) is generated by the
same code: a fused partial aggregate's input (its broadcast joins'
probes and gathers, its absorbed steps and predicates, its keys and
arguments) over one batch, with a live mask for K3/K10.

A build or launch failure raises; nothing falls back to the plain
version on a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import linecache
import math
import os
import re
import sys
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.core.kernels import _alloc_planes
from blaze_tpu_torch.exprs.cast import US_PER_DAY, US_PER_SECOND
from blaze_tpu_torch.exprs.cast import is_int as _is_int
from blaze_tpu_torch.exprs.compiler import ExprError, fused_chain_schemas, make_literal, \
    not_ported
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops.joins.keymap import RANK_DENSE, RANK_SEARCH, JoinRank
from blaze_tpu_torch.utils import cuda_lib

BLOCK = 1024
NUM_WARPS = 4
# a compacting launch's look-back tags: 1 .. 2^30 - 1, so a status word
# (tag << 33 | flag << 32 | count) stays a positive int64
_TAGS = (1 << 30) - 1

_TL = {torch.bool: "tl.int1", torch.int8: "tl.int8", torch.int16: "tl.int16",
       torch.int32: "tl.int32", torch.int64: "tl.int64", torch.float32: "tl.float32",
       torch.float64: "tl.float64"}
_NARROW = (torch.int8, torch.int16)
_B = E.BinaryOp
_CMP = {_B.EQ: "==", _B.NEQ: "!=", _B.LT: "<", _B.LTEQ: "<=", _B.GT: ">", _B.GTEQ: ">="}
_ARITH = {_B.ADD: "+", _B.SUB: "-", _B.MUL: "*", _B.BIT_AND: "&", _B.BIT_OR: "|",
          _B.BIT_XOR: "^"}

_PRELUDE = '''"""{what} (fingerprint {fp}), generated by
blaze_tpu_torch/exprs/fused_triton.py; rewritten whenever it differs."""
import triton
import triton.language as tl

try:
    from triton.language.extra import libdevice
except ImportError:
    from triton.language.extra.cuda import libdevice


@triton.jit
def _floordiv(a, b):
    # exprs/decimal.py floordiv: floor division for b != 0, a // -1 = -a
    m1 = b == -1
    bs = tl.where(m1, 1, b)
    q = a // bs
    r = a - q * bs
    q = tl.where((r != 0) & ((r < 0) != (bs < 0)), q - 1, q)
    return tl.where(m1, 0 - a, q)


@triton.jit
def _java_div(a, b):
    # exprs/compiler.py _java_int_div: truncating division
    q = _floordiv(a, b)
    r = a - q * b
    return tl.where((r != 0) & ((a < 0) != (b < 0)), q + 1, q)


@triton.jit
def _div_half_up(num, den):
    # exprs/decimal.py _div_half_up (den > 0)
    q = _floordiv(num, den)
    r = num - q * den
    neg = num < 0
    q_trunc = tl.where(neg & (r != 0), q + 1, q)
    r_trunc = num - q_trunc * den
    bump = (2 * tl.abs(r_trunc)) >= den
    return tl.where(bump, q_trunc + tl.where(neg, -1, 1), q_trunc)


@triton.jit
def _mul_ovf(a, b):
    # exprs/decimal.py _mul_overflows: the wrapped product and its overflow
    p = a * b
    return p, (a != 0) & (_floordiv(p, tl.where(a == 0, 1, a)) != b)


@triton.jit
def _div_f32(a, b):
    return tl.inline_asm_elementwise("div.rn.f32 $0, $1, $2;", "=f,f,f", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


@triton.jit
def _trunc_f32(x):
    return tl.inline_asm_elementwise("cvt.rzi.f32.f32 $0, $1;", "=f,f", [x],
                                     dtype=tl.float32, is_pure=True, pack=1)

'''


# the compacting kernel's scan helpers (a filtered group's look-back and the
# zeroing programs' wait for its total); a status word is (tag << 33) |
# (flag << 32) | count, flag 1 for an inclusive prefix, and a word of another
# tag is not yet published in this launch
_LOOK_BACK = '''

@triton.jit
def _look_back(status, tile, groups, tag, count, active):
    # a filtered group's decoupled look-back (Merrill and Garland): tile k's
    # word at status + k * groups. Publishes the tile's count, sums the
    # earlier tiles' words back to the nearest inclusive one (256 tiles a
    # round, one vector of acquire loads: the tiles of a batch run at
    # once, and each publishes its count before it looks back), publishes
    # its inclusive prefix and returns the exclusive one.
    excl = count * 0
    if active:
        tagw = tag.to(tl.int64) << 33
        tl.atomic_xchg(status + tile * groups, tagw | count, sem="release")
        lane = tl.arange(0, 256)
        k = tile - 1
        while k >= 0:
            kk = k - lane
            inr = kk >= 0
            v = tl.atomic_add(status + tl.where(inr, kk, 0) * groups, 0, mask=inr,
                              sem="acquire")
            ready = inr & ((v >> 33) == tag)
            incl = ready & (((v >> 32) & 1) == 1)
            nr = tl.min(tl.where(inr & (ready == 0), lane, 256), axis=0)
            fi = tl.min(tl.where(incl, lane, 256), axis=0)
            take = ready & (lane < nr) & (lane <= fi)
            excl += tl.sum(tl.where(take, v & 0xFFFFFFFF, 0), axis=0)
            k = tl.where(fi < nr, -1, k - nr)
        tl.atomic_xchg(status + tile * groups, tagw | 0x100000000 | (excl + count),
                       sem="release")
    return excl


@triton.jit
def _group_total(word, tag, active):
    # a zeroing program's wait for the launch's last tile's inclusive word:
    # the group's row count
    total = tag.to(tl.int64) * 0
    if active:
        want = tag.to(tl.int64) * 2 + 1
        w = tl.atomic_add(word, 0, sem="acquire")
        while (w >> 32) != want:
            w = tl.atomic_add(word, 0, sem="acquire")
        total = w & 0xFFFFFFFF
    return total
'''


@dataclasses.dataclass
class _V:
    """A value in the kernel: its data and validity blocks (variable names),
    the data's torch dtype, its logical type, whether the plain version
    holds it as a 0-d tensor (a literal), and the input column whose data
    plane it is, if any."""

    data: str
    valid: str
    tdt: torch.dtype
    dtype: T.DataType
    scalar: bool = False
    src: Optional[int] = None


@dataclasses.dataclass
class _Col:
    data: str
    valid: str
    tdt: torch.dtype
    src: Optional[int]       # input column whose data plane this is
    valid_src: bool          # validity still the input plane itself


class _Gen:
    """Generates one segment's kernel body, mirroring ExprEvaluator."""

    def __init__(self, in_schema: T.Schema, steps):
        self.in_schema = in_schema
        self.steps = tuple(steps)
        self.body: List[str] = []
        self.pool: Dict[int, int] = {}
        self.stores: List[Tuple[str, torch.dtype]] = []
        # per output group: (data plane specs, validity plane specs, mask
        # store or None); a spec is ("in_d" | "in_v" | "out", index)
        self.groups: List[tuple] = []
        self._n = 0
        self._generate()

    # -- emission helpers ---------------------------------------------------------

    def let(self, expr: str) -> str:
        name = f"t{self._n}"
        self._n += 1
        self.body.append(f"    {name} = {expr}")
        return name

    def let2(self, expr: str) -> Tuple[str, str]:
        a, b = f"t{self._n}", f"t{self._n + 1}"
        self._n += 2
        self.body.append(f"    {a}, {b} = {expr}")
        return a, b

    def word(self, v: int) -> str:
        """An int64 block of one constant from the segment's table."""
        v = int(v)
        if not -(1 << 63) <= v < (1 << 63):
            raise RuntimeError(f"fused chain constant {v} does not fit in int64")
        return f"w{self.pool.setdefault(v, len(self.pool))}"

    def fconst(self, x: float) -> str:
        bits = int(np.array(x, dtype=np.float64).view(np.int64))
        return self.let(f"{self.word(bits)}.to(tl.float64, bitcast=True)")

    def cast(self, name: str, src: torch.dtype, dst: torch.dtype) -> str:
        if src == dst:
            return name
        if src == torch.bool:
            return self.let(f"tl.where({name}, 1, 0).to({_TL[dst]})")
        if dst == torch.bool:
            return self.let(f"{name} != 0")
        return self.let(f"{name}.to({_TL[dst]})")

    def narrow(self, name: str, tdt: torch.dtype) -> str:
        return self.let(f"{name}.to({_TL[tdt]})") if tdt in _NARROW else name

    def to_bool(self, v: _V) -> str:
        return self.cast(v.data, v.tdt, torch.bool)

    # -- the chain ----------------------------------------------------------------

    def _generate(self):
        schemas = fused_chain_schemas(self.in_schema, self.steps)
        cols = [_Col(f"x{i}", f"xv{i}", _require_tdt(f.dtype), i, True)
                for i, f in enumerate(self.in_schema.fields)]
        groups = [(cols, "exists", False)]
        for si, st in enumerate(self.steps):
            kind, schema = st[0], schemas[si]
            out = []
            for cols, live, filtered in groups:
                if kind == "project":
                    out.append((self._project(st[1], schema, cols, live), live, filtered))
                elif kind == "filter":
                    out.append((cols, self._predicate(st[1], schema, cols, live), True))
                elif kind == "rename":
                    out.append((cols, live, filtered))
                elif kind == "expand":
                    for proj in st[1]:
                        out.append((self._project(proj, schema, cols, live), live, filtered))
                else:
                    raise ExprError(f"unknown fused step {kind!r}")
            groups = out
        for cols, live, filtered in groups:
            dspec, vspec = [], []
            for c in cols:
                if c.src is not None and (filtered or c.valid_src):
                    dspec.append(("in_d", c.src))
                    vspec.append(("in_v", c.src))
                    continue
                dspec.append(("in_d", c.src) if c.src is not None
                             else ("out", self._store(c.data, c.tdt)))
                vspec.append(("out", self._store(c.valid, torch.bool)))
            mask = self._store(live, torch.bool) if filtered else None
            self.groups.append((dspec, vspec, mask))
        # the input planes the kernel loads: those its expressions or its
        # stores read (a projected isnotnull(column) stores the column's
        # validity plane itself)
        read = "\n".join(self.body + [v for v, _tdt in self.stores])
        n = len(self.in_schema.fields)
        self.used_d = [i for i in range(n) if re.search(rf"\bx{i}\b", read)]
        self.used_v = [i for i in range(n) if re.search(rf"\bxv{i}\b", read)]
        # the compacting kernel (``source``) also loads the input planes a
        # filtered group passes through, and stores only the unfiltered
        # groups' planes in place
        filt = [(d, v) for d, v, mask in self.groups if mask is not None]
        self.load_d = sorted(set(self.used_d) | {i for d, _v in filt for k, i in d
                                                 if k == "in_d"})
        self.load_v = sorted(set(self.used_v) | {i for _d, v in filt for k, i in v
                                                 if k == "in_v"})
        self.full_stores = sorted({i for d, v, mask in self.groups if mask is None
                                   for k, i in d + v if k == "out"})
        # per filtered group: (live mask variable, [(variable, torch dtype)]
        # of its data planes, then its validity planes)
        self.filtered = [(self.stores[mask][0], [self.plane_value(sp) for sp in d + v])
                         for d, v, mask in self.groups if mask is not None]

    def plane_value(self, spec) -> Tuple[str, torch.dtype]:
        """A group plane's variable in the kernel and its torch dtype."""
        kind, i = spec
        if kind == "in_d":
            return f"x{i}", _require_tdt(self.in_schema[i].dtype)
        if kind == "in_v":
            return f"xv{i}", torch.bool
        return self.stores[i]


    def _store(self, var: str, tdt: torch.dtype) -> int:
        self.stores.append((var, tdt))
        return len(self.stores) - 1

    def _project(self, exprs, schema, cols, live) -> List[_Col]:
        out = []
        for e in exprs:
            v = self.eval(e, schema, cols)
            out.append(_Col(v.data, self.let(f"{v.valid} & {live}"), v.tdt, v.src, False))
        return out

    def _predicate(self, exprs, schema, cols, live) -> str:
        mask = None
        for e in exprs:
            v = self.eval(e, schema, cols)
            keep = self.let(f"{self.to_bool(v)} & {v.valid}")
            mask = keep if mask is None else self.let(f"{mask} & {keep}")
        return self.let(f"{mask} & {live}")

    # -- expressions (exprs/compiler.py ExprEvaluator, as device code) ------------

    def eval(self, expr: E.Expr, schema: T.Schema, cols: List[_Col]) -> _V:
        method = getattr(self, "_eval_" + type(expr).__name__, None)
        if method is None:
            raise not_ported(expr)
        return method(expr, schema, cols)

    def _eval_Column(self, expr, schema, cols) -> _V:
        return self._eval_BoundReference(E.BoundReference(schema.index_of(expr.name)),
                                         schema, cols)

    def _eval_BoundReference(self, expr, schema, cols) -> _V:
        c = cols[expr.index]
        return _V(c.data, c.valid, c.tdt, schema[expr.index].dtype, src=c.src)

    def _eval_SortOrder(self, expr, schema, cols) -> _V:
        return self.eval(expr.child, schema, cols)

    def _eval_Literal(self, expr, schema, cols) -> _V:
        lit = make_literal(expr.value, expr.dtype, torch.device("cpu"))
        tdt = lit.data.dtype
        if tdt.is_floating_point:
            bits = lit.data.view(torch.int32 if tdt == torch.float32 else torch.int64)
            w = self.word(bits.item())
        else:
            w = self.word(lit.data.to(torch.int64).item())
        if tdt == torch.int64:
            data = w
        elif tdt == torch.bool:
            data = self.let(f"{w} != 0")
        elif tdt == torch.float64:
            data = self.let(f"{w}.to(tl.float64, bitcast=True)")
        elif tdt == torch.float32:
            data = self.let(f"{w}.to(tl.int32).to(tl.float32, bitcast=True)")
        else:
            data = self.let(f"{w}.to({_TL[tdt]})")
        return _V(data, "tt" if bool(lit.validity) else "ff", tdt, expr.dtype, scalar=True)

    def _eval_ScalarSubquery(self, expr, schema, cols) -> _V:
        return self._eval_Literal(E.Literal(expr.value, expr.dtype), schema, cols)

    def _eval_IsNull(self, expr, schema, cols) -> _V:
        v = self.eval(expr.child, schema, cols)
        return _V(self.let(f"{v.valid} == 0"), "tt", torch.bool, T.BOOL)

    def _eval_IsNotNull(self, expr, schema, cols) -> _V:
        v = self.eval(expr.child, schema, cols)
        return _V(v.valid, "tt", torch.bool, T.BOOL)

    def _eval_Not(self, expr, schema, cols) -> _V:
        v = self.eval(expr.child, schema, cols)
        return _V(self.let(f"{self.to_bool(v)} == 0"), v.valid, torch.bool, T.BOOL,
                  v.scalar)

    def _eval_InList(self, expr, schema, cols) -> _V:
        v = self.eval(expr.child, schema, cols)
        eq_any, has_null = "ff", "ff"
        for item in expr.values:
            x = self.eval(item, schema, cols)
            if x.scalar:
                has_null = self.let(f"{has_null} | ({x.valid} == 0)")
            ld, rd, _ = self.align(v, x)
            eq_any = self.let(f"{eq_any} | (({ld} == {rd}) & {x.valid})")
        valid = self.let(f"{v.valid} & ({eq_any} | ({has_null} == 0))")
        data = self.let(f"{eq_any} == 0") if expr.negated else eq_any
        return _V(data, valid, torch.bool, T.BOOL)

    def _eval_BinaryExpr(self, expr, schema, cols) -> _V:
        l = self.eval(expr.left, schema, cols)
        r = self.eval(expr.right, schema, cols)
        scalar = l.scalar and r.scalar
        op = expr.op
        if op in (_B.AND, _B.OR):
            ld, rd, lv, rv = self.to_bool(l), self.to_bool(r), l.valid, r.valid
            if op == _B.AND:
                dfalse = self.let(f"({lv} & ({ld} == 0)) | ({rv} & ({rd} == 0))")
                dtrue = self.let(f"{lv} & {ld} & {rv} & {rd}")
            else:
                dtrue = self.let(f"({lv} & {ld}) | ({rv} & {rd})")
                dfalse = self.let(f"{lv} & ({ld} == 0) & {rv} & ({rd} == 0)")
            return _V(dtrue, self.let(f"{dtrue} | {dfalse}"), torch.bool, T.BOOL, scalar)
        if op in _CMP:
            ld, rd, tdt = self.align(l, r)
            if tdt == torch.bool and op not in (_B.EQ, _B.NEQ):
                ld, rd = self.cast(ld, tdt, torch.int32), self.cast(rd, tdt, torch.int32)
            return _V(self.let(f"{ld} {_CMP[op]} {rd}"), self.let(f"{l.valid} & {r.valid}"),
                      torch.bool, T.BOOL, scalar)
        res_t = expr.result_type or E.infer_type(
            E.BinaryExpr(op, E.Literal(None, l.dtype), E.Literal(None, r.dtype)), T.Schema(()))
        valid = self.let(f"{l.valid} & {r.valid}")
        if isinstance(res_t, T.DecimalType):
            if not res_t.fits_int64:
                raise NotImplementedError(
                    f"decimal arithmetic into {res_t!r} (wider than 18 digits) "
                    "is not ported yet (ROADMAP.md Queue 1 item 18)")
            if _is_float(l.dtype) or _is_float(r.dtype):
                return self._float_into_decimal(op, l, r, res_t, valid, scalar)
            return self._decimal_arith(op, self.coerce_decimal(l), self.coerce_decimal(r),
                                       res_t, scalar)
        ld, rd, tdt = self.align(l, r, res_t)
        if tdt == torch.bool:  # arithmetic on bools: in int32, then back
            ld, rd = self.cast(ld, tdt, torch.int32), self.cast(rd, tdt, torch.int32)
        wt = torch.int32 if tdt == torch.bool else tdt
        if op in _ARITH:
            out = self.let(f"{ld} {_ARITH[op]} {rd}")
        elif op in (_B.DIV, _B.MOD):
            zero = self.let(f"{rd} == 0")
            valid = self.let(f"{valid} & ({zero} == 0)")
            den = self.let(f"tl.where({zero}, 1, {rd})")
            if wt.is_floating_point:
                q = self.fdiv(ld, den, wt)
                out = q if op == _B.DIV else \
                    self.let(f"{ld} - {self.ftrunc(q, wt)} * {den}")
            else:
                q = self.narrow(self.let(f"_java_div({ld}, {den})"), wt)
                out = q if op == _B.DIV else self.let(f"{ld} - {q} * {den}")
        elif op in (_B.SHIFT_LEFT, _B.SHIFT_RIGHT):
            bits = torch.empty((), dtype=wt).element_size() * 8
            rem = self.let(f"{rd} % {bits}")
            sh = self.let(f"tl.where({rem} < 0, {rem} + {bits}, {rem})")
            out = self.let(f"{ld} {'<<' if op == _B.SHIFT_LEFT else '>>'} {sh}")
        else:
            raise ExprError(f"unsupported device binary op {op}")
        out = self.narrow(out, wt)
        if tdt == torch.bool:
            out = self.cast(out, torch.int32, torch.bool)
        return _V(out, valid, tdt, res_t, scalar)

    def _eval_Case(self, expr, schema, cols) -> _V:
        """ExprEvaluator._eval_Case: the first definitely-true condition
        picks its branch; later branches and ELSE convert to the first
        branch's plane type (no decimal rescale); no ELSE: untaken -> NULL."""
        taken = "ff"
        out = None
        for cond_e, val_e in expr.branches:
            c = self.eval(cond_e, schema, cols)
            v = self.eval(val_e, schema, cols)
            cmask = self.let(f"{self.to_bool(c)} & {c.valid} & ({taken} == 0)")
            if out is None:
                out = _V(self.let(f"tl.where({cmask}, {v.data}, {self.zero(v.tdt)})"),
                         self.let(f"{cmask} & {v.valid}"), v.tdt, v.dtype)
            else:
                vd = self.cast(v.data, v.tdt, out.tdt)
                out = _V(self.let(f"tl.where({cmask}, {vd}, {out.data})"),
                         self.let(f"tl.where({cmask}, {v.valid}, {out.valid})"),
                         out.tdt, out.dtype)
            taken = self.let(f"{taken} | {cmask}")
        if expr.else_expr is not None:
            e = self.eval(expr.else_expr, schema, cols)
            ed = self.cast(e.data, e.tdt, out.tdt)
            return _V(self.let(f"tl.where({taken}, {out.data}, {ed})"),
                      self.let(f"tl.where({taken}, {out.valid}, {e.valid})"),
                      out.tdt, out.dtype)
        return _V(out.data, self.let(f"{out.valid} & {taken}"), out.tdt, out.dtype)

    def _eval_Cast(self, expr, schema, cols) -> _V:
        return self._cast(self.eval(expr.child, schema, cols), expr.dtype)

    def _eval_TryCast(self, expr, schema, cols) -> _V:
        return self._cast(self.eval(expr.child, schema, cols), expr.dtype)

    def _cast(self, v: _V, to: T.DataType) -> _V:
        """exprs/cast.py cast_dev, as device code."""
        frm = v.dtype
        if frm == to:
            return v
        tdt = _require_tdt(to)
        data, valid = v.data, v.valid
        if isinstance(frm, T.DecimalType):
            if isinstance(to, T.DecimalType):
                data, valid = self._rescale(data, valid, frm.scale, to.scale, to.precision)
            elif _is_int(to):
                m = self.word(10 ** frm.scale)
                q = self.let(f"_floordiv({data}, {m})")
                r = self.let(f"{data} - {q} * {m}")
                data = self.let(f"tl.where(({r} != 0) & ({data} < 0), {q} + 1, {q})"
                                f".to({_TL[tdt]})")
            elif _is_float(to):
                data = self.cast(self.dec_to_f64(v), torch.float64, tdt)
            elif isinstance(to, T.BooleanType):
                data = self.let(f"{data} != 0")
            else:
                raise NotImplementedError(f"cast decimal -> {to!r}")
        elif isinstance(to, T.DecimalType):
            if _is_int(frm) or isinstance(frm, T.BooleanType):
                data = self.cast(data, v.tdt, torch.int64)
                if to.scale > 0:
                    data, bad = self.let2(f"_mul_ovf({data}, {self.word(10 ** to.scale)})")
                    valid = self.let(f"{valid} & ({bad} == 0)")
                data, valid = self._check_overflow(data, valid, to.precision)
            elif _is_float(frm):
                x = self.cast(data, v.tdt, torch.float64)
                scaled = self.let(f"{x} * {self.fconst(float(10 ** to.scale))}")
                rounded = self.let(f"tl.where({scaled} >= 0, libdevice.floor({scaled} + 0.5), "
                                   f"libdevice.ceil({scaled} - 0.5))")
                ok = self.let(f"(tl.abs({scaled}) < {self.fconst(math.inf)}) & "
                              f"(tl.abs({rounded}) < {self.fconst(float(2 ** 63))})")
                data = self.let(f"tl.where({ok}, {rounded}, 0.0).to(tl.int64)")
                data, valid = self._check_overflow(data, self.let(f"{valid} & {ok}"),
                                                   to.precision)
            else:
                raise NotImplementedError(f"cast {frm!r} -> decimal")
        elif _is_float(frm) and _is_int(to):
            # Java semantics: NaN -> 0, saturation; out-of-range lanes are
            # masked before the convert (an infinity compares as the
            # reference's nan_to_num makes it, past either bound)
            info = torch.iinfo(tdt)
            xf = self.cast(data, v.tdt, torch.float64)
            x = self.let(f"libdevice.trunc(tl.where({xf} != {xf}, 0.0, {xf}))")
            max_f, min_f = self.fconst(float(info.max)), self.fconst(float(info.min))
            inb = self.let(f"({x} > {min_f}) & ({x} < {max_f})")
            xi = self.let(f"tl.where({inb}, {x}, 0.0).to({_TL[tdt]})")
            hi = self.let(f"{self.word(info.max)}.to({_TL[tdt]})")
            lo = self.let(f"{self.word(info.min)}.to({_TL[tdt]})")
            data = self.let(f"tl.where({x} >= {max_f}, {hi}, tl.where({x} <= {min_f}, "
                            f"{lo}, {xi}))")
        elif isinstance(to, T.BooleanType):
            data = self.let(f"{data} != 0")
        elif isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
            data = self.let(f"{self.cast(data, v.tdt, torch.int64)} * "
                            f"{self.word(US_PER_DAY)}")
        elif isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
            data = self.let(f"_floordiv({data}, {self.word(US_PER_DAY)}).to(tl.int32)")
        elif isinstance(frm, T.TimestampType) and _is_int(to):
            data = self.let(f"_floordiv({data}, {self.word(US_PER_SECOND)})"
                            f".to({_TL[tdt]})")
        elif _is_int(frm) and isinstance(to, T.TimestampType):
            data = self.let(f"{self.cast(data, v.tdt, torch.int64)} * "
                            f"{self.word(US_PER_SECOND)}")
        else:
            data = self.cast(data, v.tdt, tdt)
        return _V(data, valid, tdt, to, v.scalar)

    # -- numeric helpers ------------------------------------------------------------

    def zero(self, tdt: torch.dtype) -> str:
        return "ff" if tdt == torch.bool else self.let(f"tl.zeros([BLOCK], dtype={_TL[tdt]})")

    def coerce_decimal(self, v: _V) -> _V:
        """ExprEvaluator._coerce_decimal: an integer operand as decimal(18, 0)."""
        if isinstance(v.dtype, T.DecimalType):
            return v
        return _V(self.cast(v.data, v.tdt, torch.int64), v.valid, torch.int64,
                  T.DecimalType(18, 0), v.scalar)

    def fdiv(self, a: str, b: str, tdt: torch.dtype) -> str:
        return self.let(f"_div_f32({a}, {b})" if tdt == torch.float32 else f"{a} / {b}")

    def ftrunc(self, x: str, tdt: torch.dtype) -> str:
        return self.let(f"_trunc_f32({x})" if tdt == torch.float32
                        else f"libdevice.trunc({x})")

    def align(self, l: _V, r: _V, res_t: Optional[T.DataType] = None):
        """ExprEvaluator._numeric_align: (left, right, their dtype)."""
        ldec, rdec = isinstance(l.dtype, T.DecimalType), isinstance(r.dtype, T.DecimalType)
        if ldec and rdec:
            s = max(l.dtype.scale, r.dtype.scale)
            return (self._rescale_data(l.data, l.dtype.scale, s),
                    self._rescale_data(r.data, r.dtype.scale, s), torch.int64)
        if ldec or rdec:
            return self.dec_to_f64(l), self.dec_to_f64(r), torch.float64
        tdt = T.torch_dtype(res_t) if res_t is not None else None
        if tdt is None:
            tdt = torch.promote_types(l.tdt, r.tdt)
        return self.cast(l.data, l.tdt, tdt), self.cast(r.data, r.tdt, tdt), tdt

    def dec_to_f64(self, v: _V) -> str:
        if isinstance(v.dtype, T.DecimalType):
            return self.let(f"{v.data}.to(tl.float64) / "
                            f"{self.fconst(float(10 ** v.dtype.scale))}")
        return self.cast(v.data, v.tdt, torch.float64)

    def _float_op(self, op, ld: str, rd: str) -> str:
        """compiler.py _float_op over f64 blocks."""
        if op in (_B.ADD, _B.SUB, _B.MUL):
            return self.let(f"{ld} {_ARITH[op]} {rd}")
        zero = self.let(f"{rd} == 0")
        den = self.let(f"tl.where({zero}, 1.0, {rd})")
        nan = self.fconst(float("nan"))
        if op == _B.DIV:
            return self.let(f"tl.where({zero}, {nan}, {ld} / {den})")
        if op == _B.MOD:
            q = self.let(f"libdevice.trunc({ld} / {den})")
            return self.let(f"tl.where({zero}, {nan}, {ld} - {q} * {rd})")
        raise ExprError(f"unsupported float/decimal op {op}")

    def _float_into_decimal(self, op, l: _V, r: _V, res_t, valid: str, scalar) -> _V:
        out = self._float_op(op, self.dec_to_f64(l), self.dec_to_f64(r))
        scaled = self.let(f"{out} * {self.fconst(float(10 ** res_t.scale))}")
        rounded = self.let(f"tl.where({scaled} >= 0, libdevice.floor({scaled} + 0.5), "
                           f"libdevice.ceil({scaled} - 0.5))")
        ok = self.let(f"(tl.abs({scaled}) < {self.fconst(math.inf)}) & "
                      f"(tl.abs({rounded}) < {self.fconst(float(2 ** 62))})")
        data = self.let(f"tl.where({ok}, {rounded}, 0.0).to(tl.int64)")
        data, valid = self._check_overflow(data, self.let(f"{valid} & {ok}"),
                                           res_t.precision)
        return _V(data, valid, torch.int64, res_t, scalar)

    # -- exprs/decimal.py, as device code -------------------------------------------

    def _check_overflow(self, data: str, valid: str, precision: int):
        if precision >= 19:
            return data, valid
        bound = 10 ** precision
        ok = self.let(f"({data} < {self.word(bound)}) & ({data} > {self.word(-bound)})")
        return data, self.let(f"{valid} & {ok}")

    def _rescale_data(self, data: str, frm: int, to: int) -> str:
        if to > frm:
            return self.let2(f"_mul_ovf({data}, {self.word(10 ** (to - frm))})")[0]
        if to < frm:
            return self.let(f"_div_half_up({data}, {self.word(10 ** (frm - to))})")
        return data

    def _rescale(self, data: str, valid: str, frm: int, to: int, precision: int):
        if to > frm:
            data, bad = self.let2(f"_mul_ovf({data}, {self.word(10 ** (to - frm))})")
            valid = self.let(f"{valid} & ({bad} == 0)")
        elif to < frm:
            data = self.let(f"_div_half_up({data}, {self.word(10 ** (frm - to))})")
        return self._check_overflow(data, valid, precision)

    def _decimal_arith(self, op, l: _V, r: _V, res_t: T.DecimalType, scalar) -> _V:
        ls, rs = l.dtype.scale, r.dtype.scale
        if op in (_B.ADD, _B.SUB, _B.MOD):
            s = max(ls, rs)
            ld, lv = self._rescale(l.data, l.valid, ls, s, 19)
            rd, rv = self._rescale(r.data, r.valid, rs, s, 19)
            if op == _B.MOD:
                zero = self.let(f"{rd} == 0")
                den = self.let(f"tl.where({zero}, 1, {rd})")
                out = self.let(f"{ld} - _java_div({ld}, {den}) * {den}")
                valid = self.let(f"{lv} & {rv} & ({zero} == 0)")
            else:
                if op == _B.SUB:
                    rd = self.let(f"0 - {rd}")
                out = self.let(f"{ld} + {rd}")
                ovf = self.let(f"(({ld} >= 0) == ({rd} >= 0)) & (({out} >= 0) != ({ld} >= 0)) "
                               f"& ({ld} != 0)")
                valid = self.let(f"{lv} & {rv} & ({ovf} == 0)")
            out, valid = self._rescale(out, valid, s, res_t.scale, res_t.precision)
        elif op == _B.MUL:
            out, bad = self.let2(f"_mul_ovf({l.data}, {r.data})")
            valid = self.let(f"{l.valid} & {r.valid} & ({bad} == 0)")
            down = ls + rs - res_t.scale
            if down > 0:
                out = self.let(f"_div_half_up({out}, {self.word(10 ** down)})")
            out, valid = self._check_overflow(out, valid, res_t.precision)
        elif op == _B.DIV:
            sa = res_t.scale - ls + rs
            num, bad = self.let2(f"_mul_ovf({l.data}, {self.word(10 ** sa if sa >= 0 else 1)})")
            if sa < 0:
                num = self.let(f"_div_half_up({l.data}, {self.word(10 ** (-sa))})")
                bad = "ff"
            zero = self.let(f"{r.data} == 0")
            den = self.let(f"tl.where({zero}, 1, {r.data})")
            out = self.let(f"_div_half_up({num} * tl.where({den} < 0, -1, 1), tl.abs({den}))")
            valid = self.let(f"{l.valid} & {r.valid} & ({bad} == 0) & ({zero} == 0)")
            out, valid = self._check_overflow(out, valid, res_t.precision)
        else:
            raise ExprError(f"unsupported decimal op {op}")
        return _V(out, valid, torch.int64, res_t, scalar)

    # -- the module -----------------------------------------------------------------

    def source(self, fingerprint: str) -> str:
        if self.filtered:
            return self._compacting_source(fingerprint)
        params = ([f"x{i}_ptr" for i in self.used_d] + [f"xv{i}_ptr" for i in self.used_v]
                  + [f"o{k}" for k in range(len(self.stores))]
                  + ["consts", "num_rows", "cap", "BLOCK: tl.constexpr"])
        lines = [_PRELUDE.format(what="K11 for one fused chain segment", fp=fingerprint),
                 '@triton.jit(do_not_specialize=["num_rows", "cap"])',
                 f"def fused_chain({', '.join(params)}):",
                 "    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)",
                 "    inb = offs < cap",
                 "    exists = offs < num_rows",
                 "    tt = offs >= 0",
                 "    ff = offs < 0",
                 "    zi64 = tl.zeros([BLOCK], dtype=tl.int64)"]
        lines += [f"    w{k} = zi64 + tl.load(consts + {k})" for k in range(len(self.pool))]
        lines += [f"    x{i} = tl.load(x{i}_ptr + offs, mask=inb, other=0)" for i in self.used_d]
        lines += [f"    xv{i} = tl.load(xv{i}_ptr + offs, mask=inb, other=0)"
                  for i in self.used_v]
        lines += self.body
        lines += [f"    tl.store(o{k} + offs, {v}.to({_TL[tdt]}), mask=inb)"
                  for k, (v, tdt) in enumerate(self.stores)]
        return "\n".join(lines) + "\n"

    def _compacting_source(self, fingerprint: str) -> str:
        """One launch of 2 * ntiles programs, each taking a ticket: the
        first ntiles are the batch's tiles (the chain's body, the unfiltered
        groups' stores in place, then per filtered group its live count, a
        look-back for its offset and its planes stored at offset + rank,
        the last tile writing the counts); the others zero the filtered
        groups' padding, tile by tile, once the last tile's inclusive words
        give the counts. ``state``: the tickets' counter, then ntiles words
        a filtered group; ``tag``: this launch's."""
        filt = self.filtered
        ng = len(filt)
        params = ([f"x{i}_ptr" for i in self.load_d] + [f"xv{i}_ptr" for i in self.load_v]
                  + [f"o{k}" for k in self.full_stores]
                  + [f"g{f}_{j}" for f, (_m, planes) in enumerate(filt)
                     for j in range(len(planes))]
                  + ["consts", "state", "counts", "num_rows", "cap", "ntiles", "tag",
                     "BLOCK: tl.constexpr"])
        lines = [_PRELUDE.format(what="K11 for one fused chain segment", fp=fingerprint)
                 + _LOOK_BACK,
                 '@triton.jit(do_not_specialize=["num_rows", "cap", "ntiles", "tag"])',
                 f"def fused_chain({', '.join(params)}):",
                 "    ticket = tl.atomic_add(state, 1)",
                 "    tl.atomic_xchg(state, 0, mask=ticket == 2 * ntiles - 1)",
                 "    is_tile = ticket < ntiles",
                 "    offs = ticket * BLOCK + tl.arange(0, BLOCK)",
                 "    inb = offs < cap",
                 "    exists = offs < num_rows",
                 "    tt = offs >= 0",
                 "    ff = offs < 0",
                 "    zi64 = tl.zeros([BLOCK], dtype=tl.int64)"]
        lines += [f"    w{k} = zi64 + tl.load(consts + {k})" for k in range(len(self.pool))]
        lines += [f"    x{i} = tl.load(x{i}_ptr + offs, mask=inb, other=0)" for i in self.load_d]
        lines += [f"    xv{i} = tl.load(xv{i}_ptr + offs, mask=inb, other=0)"
                  for i in self.load_v]
        lines += self.body
        lines += [f"    tl.store(o{k} + offs, {self.stores[k][0]}.to({_TL[self.stores[k][1]]}), "
                  "mask=inb)" for k in self.full_stores]
        # the zeroing programs: rows at or past num_rows at once, the others
        # once the group's count is published
        lines += ["    zoffs = (ticket - ntiles) * BLOCK + tl.arange(0, BLOCK)",
                  "    last = ticket == ntiles - 1"]
        for f, (mask, planes) in enumerate(filt):
            lines += [f"    m{f} = {mask} & inb",
                      f"    c{f} = tl.sum(m{f}.to(tl.int64), axis=0)",
                      f"    e{f} = _look_back(state + 1 + {f}, ticket, {ng}, tag, c{f}, is_tile)",
                      f"    p{f} = e{f} + tl.cumsum(m{f}.to(tl.int64), axis=0) - "
                      f"m{f}.to(tl.int64)"]
            lines += [f"    tl.store(g{f}_{j} + p{f}, {var}.to({_TL[tdt]}), mask=m{f})"
                      for j, (var, tdt) in enumerate(planes)]
            lines += [f"    tl.store(counts + {f}, e{f} + c{f}, mask=last)",
                      f"    n{f} = _group_total(state + 1 + (ntiles - 1) * {ng} + {f}, tag, "
                      "(is_tile == 0) & ((ticket - ntiles) * BLOCK < num_rows))",
                      f"    z{f} = (is_tile == 0) & (zoffs >= n{f}) & (zoffs < cap)"]
            lines += [f"    tl.store(g{f}_{j} + zoffs, zi64.to({_TL[tdt]}), mask=z{f})"
                      for j, (_var, tdt) in enumerate(planes)]
        return "\n".join(lines) + "\n"

    def stacked_source(self, fingerprint: str) -> str:
        """The stacked form (ShardedFusedRunner): the same body over k
        same-shape batches, the batch on the grid's second axis. ``tab`` is
        an int64 table of k row counts, then per loaded plane the k batches'
        plane addresses (so no batch is copied into a stack); output plane
        o{k} is (k, cap), batch b at row b."""
        loads = ([(f"x{i}", _TL[_require_tdt(self.in_schema[i].dtype)]) for i in self.used_d]
                 + [(f"xv{i}", "tl.int1") for i in self.used_v])
        params = (["tab"] + [f"o{k}" for k in range(len(self.stores))]
                  + ["consts", "cap", "nb", "BLOCK: tl.constexpr"])
        lines = [_PRELUDE.format(what="K11 for one fused chain segment", fp=fingerprint),
                 '@triton.jit(do_not_specialize=["cap", "nb"])',
                 f"def fused_chain_stacked({', '.join(params)}):",
                 "    b = tl.program_id(1)",
                 "    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)",
                 "    inb = offs < cap",
                 "    exists = offs < tl.load(tab + b)",
                 "    tt = offs >= 0",
                 "    ff = offs < 0",
                 "    zi64 = tl.zeros([BLOCK], dtype=tl.int64)",
                 "    row0 = b.to(tl.int64) * cap"]
        lines += [f"    w{k} = zi64 + tl.load(consts + {k})" for k in range(len(self.pool))]
        for j, (name, tlt) in enumerate(loads):
            lines += [f"    {name}_ptr = tl.load(tab + {j + 1} * nb + b)"
                      f".to(tl.pointer_type({tlt}))",
                      f"    {name} = tl.load({name}_ptr + offs, mask=inb, other=0)"]
        lines += self.body
        lines += [f"    tl.store(o{k} + row0 + offs, {v}.to({_TL[tdt]}), mask=inb)"
                  for k, (v, tdt) in enumerate(self.stores)]
        return "\n".join(lines) + "\n"

    def constants(self) -> List[int]:
        words = [0] * max(1, len(self.pool))
        for v, k in self.pool.items():
            words[k] = v
        return words


def _require_tdt(dt: T.DataType) -> torch.dtype:
    tdt = T.torch_dtype(dt)
    if tdt is None:
        raise NotImplementedError(f"a fused chain over {dt!r} has no device plane")
    return tdt


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.Float32Type, T.Float64Type))


def kernel_dir() -> str:
    return os.path.join(cuda_lib.build_dir(), "fused")


class FusedKernel:
    """K11 for one fused chain segment: its generated source (made on first
    use, from the steps alone, so it can be read without triton), the
    compiled ``@triton.jit`` function (imported from the written source on
    the first CUDA call) and its constant table per device."""

    ENTRY = "fused_chain"  # the generated module's kernel function

    def __init__(self, in_schema: T.Schema, steps, fingerprint: Optional[str] = None):
        from blaze_tpu_torch.ir.fusion import fused_fingerprint

        self.in_schema = in_schema
        self.steps = tuple(steps)
        self.fingerprint = fingerprint or fused_fingerprint(in_schema, self.steps)
        self._gen: Optional[_Gen] = None
        self._source: Optional[str] = None
        self._fn = None
        self._stacked_source: Optional[str] = None
        self._stacked_fn = None
        self._consts: Dict[tuple, torch.Tensor] = {}
        self._state: Dict[str, torch.Tensor] = {}
        self._tag = 0
        self._plane_dtypes: Optional[List[Optional[torch.dtype]]] = None
        self._lock = threading.Lock()

    @property
    def gen(self) -> _Gen:
        if self._gen is None:
            self._gen = _Gen(self.in_schema, self.steps)
        return self._gen

    @property
    def plane_dtypes(self) -> List[Optional[torch.dtype]]:
        """The torch dtype of each input column's data plane."""
        if self._plane_dtypes is None:
            self._plane_dtypes = [T.torch_dtype(f.dtype) for f in self.in_schema.fields]
        return self._plane_dtypes

    @property
    def source(self) -> str:
        if self._source is None:
            self._source = self.gen.source(self.fingerprint)
        return self._source

    @source.setter
    def source(self, text: str) -> None:
        self._source = text
        self._fn = None

    @property
    def path(self) -> str:
        return os.path.join(kernel_dir(), f"{self.fingerprint}.py")

    @property
    def stacked_source(self) -> str:
        if self._stacked_source is None:
            self._stacked_source = self.gen.stacked_source(self.fingerprint)
        return self._stacked_source

    @property
    def stacked_path(self) -> str:
        return os.path.join(kernel_dir(), f"{self.fingerprint}_stacked.py")

    def compiled(self):
        """The ``@triton.jit`` kernel, from the source written to ``path``."""
        with self._lock:
            if self._fn is None:
                self._fn = _import_kernel(self.path, self.source,
                                          f"blaze_tpu_torch_fused_{self.fingerprint}",
                                          self.ENTRY)
            return self._fn

    def compiled_stacked(self):
        """The stacked form's ``@triton.jit`` kernel, from ``stacked_path``."""
        with self._lock:
            if self._stacked_fn is None:
                self._stacked_fn = _import_kernel(
                    self.stacked_path, self.stacked_source,
                    f"blaze_tpu_torch_fused_stacked_{self.fingerprint}", "fused_chain_stacked")
            return self._stacked_fn

    def scan_state(self, device: torch.device, words: int) -> Tuple[torch.Tensor, int]:
        """The compacting kernel's scratch on ``device`` (the tickets'
        counter, then the look-back words; zeroed once, grown to ``words``)
        and a tag of its own for the next launch: the kernel resets its
        counter and its words carry the tag, so the scratch is never zeroed
        again. The launches of one device go in stream order."""
        key = str(device)
        with self._lock:
            state = self._state.get(key)
            if state is None or state.shape[0] < words:
                state = self._state[key] = torch.zeros(words, dtype=torch.int64, device=device)
            self._tag = self._tag % _TAGS + 1
            return state, self._tag

    def constants_on(self, device: torch.device) -> torch.Tensor:
        key = (device.type, device.index)
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(self.gen.constants(), dtype=torch.int64, device=device)
            self._consts[key] = t
        return t


def _import_kernel(path: str, text: str, name: str, attr: str):
    """Write a generated kernel module to ``path`` (if it differs) and
    import it: ``@triton.jit`` reads its source with ``inspect``."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(cuda_lib.build_dir(), "triton_cache"))
    import triton  # noqa: F401  (K11 needs triton on the card)

    _write_if_changed(path, text)
    linecache.checkcache(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def _write_if_changed(path: str, text: str) -> None:
    try:
        with open(path) as f:
            if f.read() == text:
                return
    except FileNotFoundError:
        pass
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _check_batch(kernel: FusedKernel, name: str, datas, valids, cap: int) -> None:
    fields = kernel.in_schema.fields
    if len(datas) != len(fields) or len(valids) != len(fields):
        raise ValueError(f"{name}: {len(datas)} planes for {len(fields)} columns")
    cuda_lib.require_cuda(name, *datas, *valids)
    for f, tdt, d, v in zip(fields, kernel.plane_dtypes, datas, valids):
        if d.shape != (cap,) or v.shape != (cap,) or v.dtype != torch.bool or d.dtype != tdt:
            raise ValueError(f"{name}: column {f.name!r} planes {d.dtype}"
                             f"{tuple(d.shape)} / {v.dtype}{tuple(v.shape)}")


def fused_chain_cuda(kernel: FusedKernel, datas: Sequence[torch.Tensor],
                     valids: Sequence[torch.Tensor], num_rows: int):
    """K11 on the card, one launch that also compacts every filtered output
    group (none for a segment that computes nothing and filters nothing):
    the groups of ``core/kernels.fused_chain_plain``, and the filtered
    groups' counts in group order as one int64 device array (empty when
    no group is filtered), which ``core/kernels.fused_chain`` reads in its
    one sync."""
    gen = kernel.gen
    cap = int(datas[0].shape[0])
    _check_batch(kernel, "fused_chain", datas, valids, cap)
    if not 0 <= num_rows <= cap:
        raise ValueError(f"fused_chain: {num_rows} rows in a {cap}-row batch")
    dev = datas[0].device
    filt = gen.filtered
    full = {k: torch.empty(cap, dtype=gen.stores[k][1], device=dev) for k in gen.full_stores}
    packed = [[torch.empty(cap, dtype=tdt, device=dev) for _v, tdt in planes]
              for _m, planes in filt]
    counts = torch.empty(len(filt), dtype=torch.int64, device=dev)
    if full or filt:
        fn = kernel.compiled()
        ntiles = (cap + BLOCK - 1) // BLOCK
        args = ([datas[i] for i in gen.load_d] + [valids[i] for i in gen.load_v]
                + list(full.values()) + [t for planes in packed for t in planes]
                + [kernel.constants_on(dev)])
        if filt:
            state, tag = kernel.scan_state(dev, 1 + ntiles * len(filt))
            fn[(2 * ntiles,)](*args, state, counts, num_rows, cap, ntiles, tag, BLOCK=BLOCK,
                              num_warps=NUM_WARPS, enable_fp_fusion=False)
        else:
            fn[(ntiles,)](*args, num_rows, cap, BLOCK=BLOCK, num_warps=NUM_WARPS,
                          enable_fp_fusion=False)
        cuda_lib.LAUNCHES["fused_chain"] += 1

    def plane(spec):
        kind, i = spec
        return datas[i] if kind == "in_d" else valids[i] if kind == "in_v" else full[i]

    groups, f = [], 0
    for dspec, vspec, mask in gen.groups:
        if mask is None:
            groups.append((tuple(plane(s) for s in dspec), tuple(plane(s) for s in vspec)))
        else:
            planes = packed[f]
            groups.append((tuple(planes[:len(dspec)]), tuple(planes[len(dspec):])))
            f += 1
    return tuple(groups), counts


def _groups(gen: _Gen, datas, valids, outs, num_rows: int):
    """One batch's (groups, counts) from its input planes and the planes
    the stacked K11 stored for it: each filtered group compacted once with
    K1, its count a 0-d device tensor."""
    from blaze_tpu_torch.core.kernels import compact_planes_cuda

    def plane(spec):
        kind, i = spec
        return datas[i] if kind == "in_d" else valids[i] if kind == "in_v" else outs[i]

    groups, counts = [], []
    for dspec, vspec, mask in gen.groups:
        ds = [plane(s) for s in dspec]
        vs = [plane(s) for s in vspec]
        if mask is None:
            count = num_rows
        else:
            count, ds, vs = compact_planes_cuda(ds, vs, outs[mask])
        groups.append((tuple(ds), tuple(vs)))
        counts.append(count)
    return tuple(groups), tuple(counts)


def launch_stacked(kernel: FusedKernel, batch_datas, batch_valids,
                   batch_nrows: Sequence[int]) -> List[torch.Tensor]:
    """The stacked K11 alone: k same-shape batches in one launch (grid
    (blocks, k)); returns the stored planes, each (k, cap), batch b at row
    b (none, and no launch, for a segment that computes nothing)."""
    gen = kernel.gen
    k = len(batch_datas)
    cap = int(batch_datas[0][0].shape[0])
    if k == 0 or len(batch_valids) != k or len(batch_nrows) != k:
        raise ValueError(f"fused_chain_stacked: {k} batches")
    for datas, valids, nr in zip(batch_datas, batch_valids, batch_nrows):
        _check_batch(kernel, "fused_chain_stacked", datas, valids, cap)
        if not 0 <= int(nr) <= cap:
            raise ValueError(f"fused_chain_stacked: {nr} rows in a {cap}-row batch")
    dev = batch_datas[0][0].device
    if any(d.device != dev for datas in batch_datas for d in datas):
        raise ValueError("fused_chain_stacked: batches on different devices")
    outs = [torch.empty((k, cap), dtype=tdt, device=dev) for _v, tdt in gen.stores]
    if outs:
        fn = kernel.compiled_stacked()
        words = ([int(nr) for nr in batch_nrows]
                 + [bd[i].data_ptr() for i in gen.used_d for bd in batch_datas]
                 + [bv[i].data_ptr() for i in gen.used_v for bv in batch_valids])
        tab = torch.tensor(words, dtype=torch.int64).to(dev)
        fn[((cap + BLOCK - 1) // BLOCK, k)](tab, *outs, kernel.constants_on(dev), cap, k,
                                             BLOCK=BLOCK, num_warps=NUM_WARPS,
                                             enable_fp_fusion=False)
        cuda_lib.LAUNCHES["fused_chain_stacked"] += 1
    return outs


def fused_chain_stacked_cuda(kernel: FusedKernel, batch_datas, batch_valids,
                             batch_nrows: Sequence[int]):
    """The stacked K11 on the card, then K1 once per filtered output group
    per batch: per batch the (groups, counts) of
    ``core/kernels.fused_chain_plain``, every batch's filtered counts read
    in one sync."""
    outs = launch_stacked(kernel, batch_datas, batch_valids, batch_nrows)
    per_batch = [_groups(kernel.gen, datas, valids, [o[b] for o in outs], int(nr))
                 for b, (datas, valids, nr) in enumerate(zip(batch_datas, batch_valids,
                                                             batch_nrows))]
    filt = [mask is not None for _d, _v, mask in kernel.gen.groups]
    synced = iter(torch.stack([c for _g, counts in per_batch for c, f in zip(counts, filt) if f])
                  .tolist() if any(filt) else ())
    return [(groups, tuple(next(synced) if f else c for c, f in zip(counts, filt)))
            for groups, counts in per_batch]


# -- K18: the fused aggregate input ---------------------------------------------------
#
# Replaces the JAX package's fused partial-aggregate programs
# (blaze_tpu/ops/agg_device.py:587 _fused_fn, :690 _probe_fn, :748
# _dense_call), whose shared prologue is :518 _trace_tb_mask: the unique-key
# inner broadcast joins (:245 FusedJoinSpec.trace_join), the absorbed fused
# steps (exprs/compiler.py:1110 trace_fused_steps) and the filter's
# predicates, then the keys and arguments of the aggregate (:411 _flow). The
# reference composes that prologue with its aggregate kernels in one XLA
# program; here it is one generated kernel a batch, K18, whose planes feed
# K3 and K10 (ops/agg_device.py) over its live mask.
#
# One program takes 512 rows. For each fused join, inner-first, it
# evaluates the probe key, takes its canonical word (ops/joins/keymap.py
# canon_words: -0.0 -> 0.0, every NaN the quiet NaN, f32 as its int32 bits
# sign-extended) and its rank: clip(searchsorted-left, 0, nk - 1) in the
# build's sorted unique words, on the route the build map decided once
# (ops/joins/keymap.py rank_route, JoinRank):
#   - dense (the words one run lo..hi): w - lo behind a range check, with
#     no load;
#   - bitmap (a range of at most 256 words a key): the word's 64-word
#     block's mask and the keys before the block, interleaved in one
#     table and read by one 16-byte load, the rank the count plus the
#     popcount of the mask's bits below the word;
#   - search (float words spread over their bit patterns, wide ranges,
#     nk = 0): a binary search with a fixed trip count, S = bit_length(
#     max(nk, 1)), a tl.constexpr.
# The range check comes before the subtraction, so a word range past 2^63
# does not wrap. A row hits where the key is valid on a row below
# num_rows and its word is a key (nk = 0: the one-word placeholder, no
# hit). It gathers the build planes a later expression reads, valid only on
# a hit, and narrows the live mask by the hit. Then the steps (filters
# narrow the mask), the predicates, the keys and the arguments, with
# ``_Gen``'s expression code; it stores each key and argument plane (a
# plane that is an input data plane passes through unstored), each
# validity ANDed with the live mask, and the mask. A wide-decimal argument
# (a bare column) stores only its validity: K3/K10 read its limb planes
# from the batch.
#
# The source is generated for the joins' routes (``FusedAggKernel
# .source_for``), each route's code alone: a tl.constexpr a join in
# effect. (Measured on an H100 against one source with every route behind
# a branch on a runtime argument: device time within 3% at the timed
# batches, a compile of 0.27-0.50 s a tuple of routes against 2.2-2.4 s;
# PERF.md.)
#
# Bound: device memory. A bitmap table stays in L1/L2 (q89's items: 25
# KB), a search reads ~S words of a build table that stays in L2 (102,000
# keys: 816 KB); everything else is one pass over the planes the
# expressions read and a gather a build plane. No reuse for shared memory
# or tensor cores, and a kernel generated per expression tree at run time:
# Triton, as K11.

# K18's program: 512 rows, 4 warps (on an H100, against 1,024 rows with 4
# or 8 warps and 256 with 2, the fastest or level at q17's, q89's and q01's
# batches)
AGG_BLOCK = 512
AGG_NUM_WARPS = 4
# the quiet NaNs every float key folds to (torch's NaN on either device)
_QNAN64 = 0x7FF8000000000000
_QNAN32 = 0x7FC00000

_POPC = '''
@triton.jit
def _popc64(x):
    # the set bits of each int64 word
    return tl.inline_asm_elementwise("popc.b64 $0, $1;", "=r,l", [x], dtype=tl.int32,
                                     is_pure=True, pack=1)

'''


@dataclasses.dataclass(frozen=True)
class FusedJoin:
    """One unique-key inner broadcast join absorbed into the aggregate:
    its probe key over the probe schema, which side the probe is, and both
    schemas (ops/agg_device.py's DevicePartialAgger pairs it with its
    build map)."""

    key_expr: E.Expr
    probe_on_left: bool
    probe_schema: T.Schema
    build_schema: T.Schema

    @property
    def joined_schema(self) -> T.Schema:
        p, b = self.probe_schema.fields, self.build_schema.fields
        return T.Schema(tuple(p) + tuple(b) if self.probe_on_left else tuple(b) + tuple(p))


@dataclasses.dataclass(frozen=True)
class FusedAggSpec:
    """What K18 computes for one fused partial aggregate: batches of
    ``input_schema`` (the innermost probe side, the absorbed steps' input,
    or the aggregate's child), the joins inner-first, the absorbed steps
    (project / filter / rename), the filter's predicates and the
    aggregate's grouping expressions and arguments over ``child_schema``
    (None for COUNT(*)). Joins and steps never come together (the
    reference's peel order)."""

    input_schema: T.Schema
    joins: Tuple[FusedJoin, ...]
    steps: tuple
    predicates: tuple
    child_schema: T.Schema
    groupings: tuple
    args: tuple

    def wide_arg(self, e: Optional[E.Expr]) -> bool:
        """A bare decimal(19..38) column: its limb planes pass through."""
        return isinstance(e, (E.Column, E.BoundReference)) and \
            T.is_wide_decimal(E.infer_type(e, self.child_schema))

    def fingerprint(self) -> str:
        """Structural identity: the input schema, each join's key, build
        dtypes and probe side, the steps' fingerprint, the predicates, the
        groupings and the arguments. Keys the kernel cache and names the
        generated source."""
        import hashlib
        import json

        from blaze_tpu_torch.ir.fusion import _schema_sig, fused_fingerprint
        from blaze_tpu_torch.ir.serde import expr_to_json

        payload = [_schema_sig(self.input_schema),
                   [[expr_to_json(j.key_expr), int(j.probe_on_left),
                     _schema_sig(j.build_schema)] for j in self.joins],
                   fused_fingerprint(self.input_schema, self.steps) if self.steps else "",
                   [expr_to_json(p) for p in self.predicates],
                   _schema_sig(self.child_schema),
                   [expr_to_json(e) for e in self.groupings],
                   [None if e is None else expr_to_json(e) for e in self.args]]
        blob = json.dumps(payload, sort_keys=True, default=str)
        return "agg_" + hashlib.sha256(blob.encode()).hexdigest()[:24]


class _AggGen(_Gen):
    """Generates K18's body: joins, steps, predicates, keys, arguments."""

    def __init__(self, spec: FusedAggSpec):
        self.spec = spec
        self.rank_words: List[str] = []  # per join, its canonical word's variable
        super().__init__(spec.input_schema, spec.steps)

    def _generate(self):
        spec = self.spec
        cols = [_Col(f"x{i}", f"xv{i}", T.torch_dtype(f.dtype), i, True)
                for i, f in enumerate(spec.input_schema.fields)]
        live = "exists"
        gathers = []  # (body line index, variable, join, build column)
        for j, js in enumerate(spec.joins):
            key = self.eval(js.key_expr, js.probe_schema, cols)
            w = self._canon_word(key)
            self.rank_words.append(w)
            kvalid = self.let(f"{key.valid} & exists")
            # ``source`` puts the join's route here: ci{j}, its clipped
            # rank, and hf{j}, whether its word (named on the line, for the
            # loads' analysis below) is a key
            self.body.append(f"    #rank{j} {w}")
            cidx = f"ci{j}"
            hit = self.let(f"{kvalid} & hf{j}")
            bcols = []
            for c, f in enumerate(js.build_schema.fields):
                d, v = f"g{j}_{c}", f"gv{j}_{c}"
                gathers.append((len(self.body), d, j, c))
                self.body.append(f"    {d} = tl.load(b{j}_{c}_ptr + {cidx}, mask=inb, other=0)")
                gathers.append((len(self.body), v, j, c))
                self.body.append(f"    {v} = tl.load(bv{j}_{c}_ptr + {cidx}, mask=inb, "
                                 f"other=0) & {hit}")
                bcols.append(_Col(d, v, _require_tdt(f.dtype), None, False))
            cols = cols + bcols if js.probe_on_left else bcols + cols
            live = self.let(f"{live} & {hit}")
        if spec.steps:
            schemas = fused_chain_schemas(spec.input_schema, spec.steps)
            for si, st in enumerate(spec.steps):
                if st[0] == "project":
                    cols = self._project(st[1], schemas[si], cols, live)
                elif st[0] == "filter":
                    live = self._predicate(st[1], schemas[si], cols, live)
                elif st[0] != "rename":
                    raise ExprError(f"fused step {st[0]!r} cannot be absorbed")
        if spec.predicates:
            live = self._predicate(spec.predicates, spec.child_schema, cols, live)
        self.key_specs = [self._out(self.eval(e, spec.child_schema, cols), live)
                          for e in spec.groupings]
        self.arg_specs = []
        for e in spec.args:
            if e is None:
                self.arg_specs.append(None)
                continue
            v = self.eval(e, spec.child_schema, cols)
            if spec.wide_arg(e):
                self.arg_specs.append((("wide", v.src),
                                       self._store(self.let(f"{v.valid} & {live}"), torch.bool)))
            else:
                self.arg_specs.append(self._out(v, live))
        self.live_store = self._store(live, torch.bool)
        # drop the gathers no later line reads (a gather reads only the
        # join's rank and hit, never another gather)
        stored = "".join(f"\n{v}" for v, _ in self.stores)
        dead = {k for k, var, _j, _c in gathers
                if not re.search(rf"\b{var}\b", "\n".join(self.body[k + 1:]) + stored)}
        self.body = [ln for k, ln in enumerate(self.body) if k not in dead]
        read = "\n".join(self.body) + stored
        n = len(spec.input_schema.fields)
        self.used_d = [i for i in range(n) if re.search(rf"\bx{i}\b", read)]
        self.used_v = [i for i in range(n) if re.search(rf"\bxv{i}\b", read)]
        # per join: the build columns whose data and validity planes it loads
        cols_of = [range(len(j.build_schema.fields)) for j in spec.joins]
        self.join_used_d = [[c for c in cs if re.search(rf"\bg{j}_{c}\b", read)]
                            for j, cs in enumerate(cols_of)]
        self.join_used_v = [[c for c in cs if re.search(rf"\bgv{j}_{c}\b", read)]
                            for j, cs in enumerate(cols_of)]
        self.join_used = [sorted(set(d) | set(v))
                          for d, v in zip(self.join_used_d, self.join_used_v)]

    def _out(self, v: _V, live: str):
        """(data spec, validity store) of a key or argument: an input data
        plane passes through, anything else is stored."""
        if v.src is not None and not v.scalar:
            data = ("in_d", v.src)
        else:
            data = ("out", self._store(v.data, v.tdt))
        return data, self._store(self.let(f"{v.valid} & {live}"), torch.bool)

    def _canon_word(self, v: _V) -> str:
        """ops/joins/keymap.py canon_words, as device code."""
        if v.tdt == torch.float64:
            bits = self.let(f"{v.data}.to(tl.int64, bitcast=True)")
            return self.let(f"tl.where({v.data} == 0, zi64, tl.where({v.data} != {v.data}, "
                            f"{self.word(_QNAN64)}, {bits}))")
        if v.tdt == torch.float32:
            bits = self.let(f"{v.data}.to(tl.int32, bitcast=True).to(tl.int64)")
            return self.let(f"tl.where({v.data} == 0, zi64, tl.where({v.data} != {v.data}, "
                            f"{self.word(_QNAN32)}, {bits}))")
        return self.cast(v.data, v.tdt, torch.int64)

    def _rank_lines(self, j: int, route: str) -> List[str]:
        """Join j's rank on ``route``: ci{j} = clip(searchsorted-left, 0,
        nk - 1) of its word and hf{j}, whether the word is a key, in
        ops/joins/keymap.py rank_probe_plain's arithmetic. The dense route
        loads nothing; the bitmap route reads its block's (mask, count)
        pair in one 16-byte load; the search takes S{j} dependent loads.
        The range check comes before the subtraction (no int64 wrap)."""
        w = self.rank_words[j]
        if route == RANK_SEARCH:
            return [f"sl{j} = zi64",
                    f"sh{j} = zi64 + ulen{j}",
                    f"for _s in tl.static_range(S{j}):",
                    f"    act{j} = sl{j} < sh{j}",
                    f"    mid{j} = (sl{j} + sh{j}) >> 1",
                    f"    um{j} = tl.load(u{j}_ptr + mid{j}, mask=act{j} & inb, other=0)",
                    f"    rt{j} = act{j} & (um{j} < {w})",
                    f"    sl{j} = tl.where(rt{j}, mid{j} + 1, sl{j})",
                    f"    sh{j} = tl.where(act{j} & (rt{j} == 0), mid{j}, sh{j})",
                    f"ci{j} = tl.minimum(sl{j}, zi64 + nkm{j})",
                    f"hf{j} = (sl{j} < nk{j}) & "
                    f"(tl.load(u{j}_ptr + ci{j}, mask=inb, other=0) == {w})"]
        lines = [f"ir{j} = ({w} >= lo{j}) & ({w} <= hi{j})",
                 f"d{j} = tl.where(ir{j}, {w}, zi64 + lo{j}) - lo{j}",
                 f"ou{j} = tl.where({w} > hi{j}, zi64 + nkm{j}, zi64)"]
        if route == RANK_DENSE:
            return lines + [f"ci{j} = tl.where(ir{j}, d{j}, ou{j})", f"hf{j} = ir{j}"]
        return lines + [
            f"bt{j} = d{j} & 63",
            f"mw{j}, mp{j} = tl.split(tl.load(m{j}_ptr + ((d{j} >> 6) * 2)[:, None] "
            "+ tl.arange(0, 2)[None, :]))",
            f"ci{j} = tl.where(ir{j}, mp{j} + _popc64(mw{j} & ~((zi64 - 1) << bt{j})), ou{j})",
            f"hf{j} = ir{j} & (((mw{j} >> bt{j}) & 1) != 0)"]

    def source(self, fingerprint: str, routes) -> str:
        """K18's source with each join's route (``routes``, per join
        inner-first)."""
        nj = len(self.spec.joins)
        params = [f"x{i}_ptr" for i in self.used_d] + [f"xv{i}_ptr" for i in self.used_v]
        for j in range(nj):
            params += [f"u{j}_ptr", f"m{j}_ptr"] + [f"b{j}_{c}_ptr" for c in self.join_used_d[j]] + \
                [f"bv{j}_{c}_ptr" for c in self.join_used_v[j]]
        params += [f"o{k}" for k in range(len(self.stores))] + ["consts", "num_rows", "cap"]
        ints = [f"{p}{j}" for j in range(nj) for p in ("lo", "hi", "nk", "nkm", "ulen")]
        params += ints + [f"S{j}: tl.constexpr" for j in range(nj)] + ["BLOCK: tl.constexpr"]
        # the capacity is specialised: its divisibility by 16 lets the
        # planes' masked loads and stores go as vectors
        spec = ", ".join(f'"{p}"' for p in ["num_rows"] + ints)
        lines = [_PRELUDE.format(what="K18 for one fused aggregate", fp=fingerprint) + _POPC,
                 f"@triton.jit(do_not_specialize=[{spec}])",
                 f"def fused_agg_input({', '.join(params)}):",
                 "    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)",
                 "    inb = offs < cap",
                 "    exists = offs < num_rows",
                 "    tt = offs >= 0",
                 "    ff = offs < 0",
                 "    zi64 = tl.zeros([BLOCK], dtype=tl.int64)"]
        lines += [f"    w{k} = zi64 + tl.load(consts + {k})" for k in range(len(self.pool))]
        lines += [f"    x{i} = tl.load(x{i}_ptr + offs, mask=inb, other=0)" for i in self.used_d]
        lines += [f"    xv{i} = tl.load(xv{i}_ptr + offs, mask=inb, other=0)"
                  for i in self.used_v]
        for ln in self.body:
            m = re.fullmatch(r"    #rank(\d+) \w+", ln)
            if m is None:
                lines.append(ln)
            else:
                j = int(m.group(1))
                lines += ["    " + r for r in self._rank_lines(j, routes[j])]
        lines += [f"    tl.store(o{k} + offs, {v}.to({_TL[tdt]}), mask=inb)"
                  for k, (v, tdt) in enumerate(self.stores)]
        return "\n".join(lines) + "\n"


class FusedAggKernel(FusedKernel):
    """K18 for one fused aggregate, made, written and compiled as a
    segment's K11 is (``FusedKernel``), from its spec: one source and
    compiled kernel a tuple of join routes (``source_for``,
    ``compiled_for``); a segment's route-free ``source``, ``path`` and
    ``compiled`` refuse. It keeps the launch plan of the last inputs it
    checked."""

    ENTRY = "fused_agg_input"

    def __init__(self, spec: FusedAggSpec):
        super().__init__(spec.input_schema, spec.steps, spec.fingerprint())
        self.spec = spec
        self._routed: Dict[tuple, object] = {}
        self._store_dtypes: Optional[List[torch.dtype]] = None
        self.checked = None  # (signature, weak references to the builds, launch plan)

    @property
    def gen(self) -> _AggGen:
        if self._gen is None:
            self._gen = _AggGen(self.spec)
        return self._gen

    @property
    def store_dtypes(self) -> List[torch.dtype]:
        if self._store_dtypes is None:
            self._store_dtypes = [tdt for _v, tdt in self.gen.stores]
        return self._store_dtypes

    def _no_routes(self):
        raise TypeError(f"{self.fingerprint}: K18's source depends on its joins' routes "
                        "(source_for, compiled_for)")

    source = property(_no_routes)
    path = property(_no_routes)
    compiled = _no_routes

    def source_for(self, routes) -> str:
        """The source for the joins' ``routes`` (a rank route a join,
        inner-first)."""
        if len(routes) != len(self.spec.joins):
            raise ValueError(f"{self.fingerprint}: {len(routes)} routes for "
                             f"{len(self.spec.joins)} joins")
        return self.gen.source(self.fingerprint, routes)

    def compiled_for(self, routes: tuple):
        """The ``@triton.jit`` kernel for ``routes``, written to
        ``agg_<fingerprint>[_<routes' initials>].py``."""
        fn = self._routed.get(routes)
        if fn is not None:
            return fn
        with self._lock:
            if routes not in self._routed:
                name = self.fingerprint + ("_" + "".join(r[0] for r in routes) if routes else "")
                self._routed[routes] = _import_kernel(
                    os.path.join(kernel_dir(), f"{name}.py"), self.source_for(routes),
                    f"blaze_tpu_torch_fused_{name}", self.ENTRY)
            return self._routed[routes]


# process-wide K18 cache: spec fingerprint -> FusedAggKernel
_AGG_KERNELS: Dict[str, FusedAggKernel] = {}
_AGG_LOCK = threading.Lock()


def fused_agg_kernel(spec: FusedAggSpec) -> FusedAggKernel:
    """The process-wide cached K18 of a spec (by its fingerprint)."""
    fp = spec.fingerprint()
    with _AGG_LOCK:
        k = _AGG_KERNELS.get(fp)
        if k is None:
            k = _AGG_KERNELS[fp] = FusedAggKernel(spec)
        return k


def _triton_launcher(fn, grid, args, **options):
    """``fn`` compiled for its positional ``args`` (every parameter in the
    kernel's order, constexprs included) and ``options`` without a launch
    (``JITFunction.warmup``), as its compiled kernel's own runner over
    ``grid``, called with the same positional arguments and ``stream=``.
    Triton's per-call launcher binds and specialises every argument anew,
    tens of microseconds a call with K18's 40-odd. Both calls are Triton
    3's interface; another major version is refused."""
    import triton

    if triton.__version__.split(".")[0] != "3":
        raise RuntimeError(f"fused_agg_input: launched through Triton 3's compiled-kernel "
                           f"runner, not Triton {triton.__version__}'s")
    return fn.warmup(*args, grid=grid, **options)[grid]


def _agg_launch_plan(kernel: FusedAggKernel, columns, joins, cap: int, dev: torch.device,
                     batch, outs, num_rows: int):
    """K18's whole input check, then the launch's part that depends on the
    builds and the signature alone: (weak references to the joins' tensor
    arguments, the constant table, the arguments after the capacity (the
    joins' integers, the search trip counts, the block) and the launcher of
    the kernel for the joins' routes, compiled for this signature)."""
    spec, gen = kernel.spec, kernel.gen
    name = "fused_agg_input"
    fields = spec.input_schema.fields
    if len(columns) != len(fields) or len(joins) != len(spec.joins):
        raise ValueError(f"{name}: {len(columns)} columns for {len(fields)} fields, "
                         f"{len(joins)} builds for {len(spec.joins)} joins")
    for f, c in zip(fields, columns):
        planes = [c.validity] + (list(c.planes()) if T.is_wide_decimal(f.dtype) else [c.data])
        cuda_lib.require_cuda(name, *planes)
        if any(p.shape != (cap,) for p in planes) or c.validity.dtype != torch.bool or \
                (not T.is_wide_decimal(f.dtype) and c.data.dtype != T.torch_dtype(f.dtype)):
            raise ValueError(f"{name}: column {f.name!r} does not match {f.dtype!r} "
                             f"at capacity {cap}")
    tail, ints, steps, routes = [], [], [], []
    for j, (js, join) in enumerate(zip(spec.joins, joins)):
        if len(join) != 4 or not isinstance(join[3], JoinRank):
            raise ValueError(f"{name}: join {j} needs (sorted words, nk, build columns, "
                             "its JoinRank)")
        uniq, nk, bcols, rank = join
        table = rank.table(dev)
        cuda_lib.require_cuda(name, columns[0].validity, uniq,
                              *([table] if table is not None else []),
                              *[p for c in bcols for p in (c.data, c.validity)])
        if uniq.dtype != torch.int64 or uniq.shape != (max(nk, 1),) or nk < 0 or \
                rank.nk != nk:
            raise ValueError(f"{name}: sorted keys {uniq.dtype}{tuple(uniq.shape)} for {nk} "
                             f"keys (its route ranks {rank.nk})")
        if len(bcols) != len(js.build_schema.fields):
            raise ValueError(f"{name}: {len(bcols)} build columns for "
                             f"{len(js.build_schema.fields)} fields")
        cap_b = bcols[0].capacity if bcols else 0
        if cap_b < max(nk, 1) or any(c.capacity != cap_b for c in bcols):
            raise ValueError(f"{name}: build columns of capacity {cap_b} for {nk} keys")
        tail += [uniq, uniq if table is None else table] + \
            [bcols[c].data for c in gen.join_used_d[j]] + \
            [bcols[c].validity for c in gen.join_used_v[j]]
        ints += rank.ints
        routes.append(rank.route)
        # the search's trip count (a kernel of another route reads none)
        steps.append(max(nk, 1).bit_length() if rank.route == RANK_SEARCH else 0)
    consts = kernel.constants_on(dev)
    rest = ints + steps + [AGG_BLOCK]
    grid = ((cap + AGG_BLOCK - 1) // AGG_BLOCK, 1, 1)
    launcher = _triton_launcher(kernel.compiled_for(tuple(routes)), grid,
                                [*batch, *tail, *outs, consts, num_rows, cap, *rest],
                                num_warps=AGG_NUM_WARPS, enable_fp_fusion=False)
    return [weakref.ref(t) for t in tail], consts, rest, launcher


def launch_fused_agg(kernel: FusedAggKernel, columns, num_rows: int, joins) -> List[torch.Tensor]:
    """K18 alone: launches once and returns the planes it stored, one
    allocation a dtype. ``columns``: the batch's columns (DeviceColumn, or
    WideColumn for a decimal(19..38)); ``joins``: per fused join,
    inner-first, (sorted unique words on the device, nk, build columns, its
    ``ops/joins/keymap.JoinRank``). The inputs are checked whole once a
    kernel, signature of the planes it reads (dtype, shape, 16-byte
    alignment and device each) and set of builds (the same sorted words,
    rank routes and build columns as the last check, held weakly), which
    also fixes the launch's part that depends on the builds and the kernel
    it compiled to (``_triton_launcher``)."""
    gen = kernel.gen
    v0 = columns[0].validity
    cap = v0.shape[0]
    if not 0 <= num_rows <= cap:
        raise ValueError(f"fused_agg_input: {num_rows} rows in a {cap}-row batch")
    index = v0.get_device()
    batch = [columns[i].data for i in gen.used_d] + [columns[i].validity for i in gen.used_v]
    sig = (cap, index, [(p.dtype, p.shape, p.data_ptr() & 15, p.get_device()) for p in batch])
    builds = [o for j in joins for o in (j[0], j[3] if len(j) == 4 else None, *j[2])]
    outs, _ptrs = _alloc_planes(kernel.store_dtypes, cap, v0.device)
    last = kernel.checked
    tail = None
    if last is not None and last[0] == sig and len(last[1]) == len(builds) and \
            all(r() is o for r, o in zip(last[1], builds)):
        plan = last[2]
        tail = [r() for r in plan[0]]
    if tail is None or any(t is None for t in tail):
        plan = _agg_launch_plan(kernel, columns, joins, cap, v0.device, batch, outs, num_rows)
        kernel.checked = (sig, [weakref.ref(o) for o in builds], plan)
        tail = [r() for r in plan[0]]
    _refs, consts, rest, launcher = plan
    launcher(*batch, *tail, *outs, consts, num_rows, cap, *rest,
             stream=cuda_lib.stream_handle(index))
    cuda_lib.LAUNCHES["fused_agg_input"] += 1
    return outs


def fused_agg_input_cuda(kernel: FusedAggKernel, columns, num_rows: int, joins):
    """K18 on the card: the same contract as ``core/kernels.py
    fused_agg_input_plain``, (keys, args, live) from the batch's columns and
    the planes K18 stored."""
    gen = kernel.gen
    outs = launch_fused_agg(kernel, columns, num_rows, joins)

    def data(spec):
        kind, i = spec
        if kind == "in_d":
            return columns[i].data
        if kind == "wide":
            return tuple(columns[i].planes())
        return outs[i]

    keys = [(data(d), outs[v]) for d, v in gen.key_specs]
    args = [None if a is None else (data(a[0]), outs[a[1]]) for a in gen.arg_specs]
    return keys, args, outs[gen.live_store]
