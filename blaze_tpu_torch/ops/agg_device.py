"""Device slot aggregation: the partial (K3) and merge (K4) paths.

Counterpart of blaze_tpu/ops/agg_device.py's dense/radix paths
(``DevicePartialAgger._try_dense`` with ``_dense_partial_kernel``, and
``DeviceMergeAgger`` with ``_radix_merge_kernel``). Integer group keys are
probed for their range (one ``aminmax`` and one small sync per stream),
planned into a slot table (``_plan_slot_table``: per key a power-of-two
range whose code 0 is the null key), and every row scatters its
aggregate states straight into its slot. Groups come out in slot order
(keys ascending, nulls first), keys rebuilt from the slot index.

Both kernels run one program (csrc/slot_agg.cu) described by two lists:
*ops* (ADD / COUNT / MIN / MAX into a slot table, gated by up to three
validity planes) and *emits* (RAW table value, NONZERO flag, or the value
WHERE a companion count is nonzero). ``_partial_program`` and
``_merge_program`` spell SUM/COUNT/AVG/MIN/MAX with them, exactly as
``_reduce_aggs`` and ``_merge_reduce`` compute them in the JAX package;
``_run_plain`` is the plain PyTorch version of the same program.

Key ranges wider than ``radix_agg_max_slots``, non-integer keys and any
aggregate outside ops/aggfns.py raise NotImplementedError: the sort-path
kernels (``_partial_kernel``, ``_merge_kernel``) are not ported yet
(ROADMAP.md Queue 2 item 8).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn, iota
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops import aggfns
from blaze_tpu_torch.utils import cuda_lib

OP_ADD, OP_COUNT, OP_MIN, OP_MAX = 0, 1, 2, 3
EMIT_RAW, EMIT_NONZERO, EMIT_WHERE = 0, 1, 2

# "no valid key in this batch and no plan to anchor to"
_DEFER_PLAN = object()

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} needs the sort-path aggregate kernels, which are not ported "
        "to the PyTorch package yet (ROADMAP.md Queue 2 item 8)")


# -- the slot program ----------------------------------------------------------


class _Op:
    __slots__ = ("kind", "src", "valids", "mult", "init")

    def __init__(self, kind, src, valids, mult=1, init=0):
        self.kind, self.src, self.valids = kind, src, list(valids)
        self.mult, self.init = mult, init


class _Emit:
    __slots__ = ("kind", "table", "aux", "dtype")

    def __init__(self, kind, table, dtype, aux=-1):
        self.kind, self.table, self.aux, self.dtype = kind, table, aux, dtype


def _extreme(dtype: torch.dtype, which: str) -> int:
    info = torch.iinfo(dtype)
    return info.max if which == "min" else info.min


def _partial_program(specs, args):
    """Ops/emits of ``_reduce_aggs`` for the slice's kinds. ``args[i]`` is
    aggregate i's (data, valid) pair, valid already masked with exists."""
    ops: List[_Op] = []
    emits: List[_Emit] = []
    for (kind, rescale, _acc), (data, valid) in zip(specs, args):
        t = len(ops)
        if kind in ("sum", "avg"):
            ops += [_Op(OP_ADD, data, [valid], 10 ** rescale),
                    _Op(OP_COUNT, None, [valid])]
            emits += [_Emit(EMIT_RAW, t, torch.int64),
                      _Emit(EMIT_NONZERO, t + 1, torch.bool) if kind == "sum"
                      else _Emit(EMIT_RAW, t + 1, torch.int64)]
        elif kind == "count":
            ops.append(_Op(OP_COUNT, None, [valid]))
            emits.append(_Emit(EMIT_RAW, t, torch.int64))
        elif kind in ("min", "max"):
            ops += [_Op(OP_MIN if kind == "min" else OP_MAX, data, [valid],
                        init=_extreme(data.dtype, kind)),
                    _Op(OP_COUNT, None, [valid])]
            emits += [_Emit(EMIT_WHERE, t, data.dtype, aux=t + 1),
                      _Emit(EMIT_NONZERO, t + 1, torch.bool)]
        else:
            _not_ported(f"partial aggregate kind {kind!r}")
    return ops, emits


def _merge_program(kinds, states):
    """Ops/emits of ``_merge_reduce``. ``states[i]`` is aggregate i's list
    of (data, valid) state-column pairs, valid already masked with
    exists."""
    ops: List[_Op] = []
    emits: List[_Emit] = []
    for kind, scols in zip(kinds, states):
        t = len(ops)
        if kind == "sum":
            (sd, sv), (hd, hv) = scols
            gate = [sv, hd, hv]
            ops += [_Op(OP_ADD, sd, gate), _Op(OP_COUNT, None, gate)]
            emits += [_Emit(EMIT_RAW, t, sd.dtype),
                      _Emit(EMIT_NONZERO, t + 1, torch.bool)]
        elif kind == "count":
            (cd, cv), = scols
            ops.append(_Op(OP_ADD, cd, [cv]))
            emits.append(_Emit(EMIT_RAW, t, torch.int64))
        elif kind == "avg":
            (sd, sv), (cd, cv) = scols
            ops += [_Op(OP_ADD, sd, [sv]), _Op(OP_ADD, cd, [cv])]
            emits += [_Emit(EMIT_RAW, t, sd.dtype),
                      _Emit(EMIT_RAW, t + 1, torch.int64)]
        elif kind in ("min", "max"):
            (vd, vv), (hd, hv) = scols
            gate = [vv, hd, hv]
            ops += [_Op(OP_MIN if kind == "min" else OP_MAX, vd, gate,
                        init=_extreme(vd.dtype, kind)),
                    _Op(OP_COUNT, None, gate)]
            emits += [_Emit(EMIT_RAW, t, vd.dtype),
                      _Emit(EMIT_NONZERO, t + 1, torch.bool)]
        else:
            _not_ported(f"merge aggregate kind {kind!r}")
    return ops, emits


def _slots(sizes: Sequence[int]) -> int:
    S = 1
    for s in sizes:
        S *= s
    return S


def _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops, emits,
               out_cap, nbuck):
    """Plain PyTorch version of the slot program (the arithmetic of
    ``_dense_partial_kernel`` / ``_radix_merge_kernel``)."""
    dev = kvalids[0].device
    cap = kvalids[0].shape[0]
    S = _slots(sizes)
    strides = K.radix_strides(sizes)
    exists = iota(cap, dev) < num_rows
    seg, fits = K.radix_pack(keys, [v & exists for v in kvalids], exists,
                             bases, sizes, strides)
    tables = []
    for op in ops:
        ok = exists
        for v in op.valids:
            ok = ok & v.to(torch.bool)
        table = torch.full((S + 1,), op.init, dtype=torch.int64, device=dev)
        if op.kind == OP_COUNT:
            table.index_add_(0, seg, ok.to(torch.int64))
        else:
            src = op.src.to(torch.int64)
            if op.kind == OP_ADD:
                table.index_add_(0, seg, torch.where(ok, src * op.mult, 0))
            else:
                table.scatter_reduce_(0, seg, torch.where(ok, src, op.init),
                                      "amin" if op.kind == OP_MIN else "amax")
        tables.append(table[:S])
    present = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    present.index_add_(0, seg, exists.to(torch.int64))
    present = present[:S] > 0
    num_groups = present.sum()
    scat = torch.where(present, torch.cumsum(present, 0) - 1, out_cap)

    def compact(x):
        out = torch.zeros(out_cap + 1, dtype=x.dtype, device=dev)
        out[scat] = x
        return out[:out_cap]

    out_valid = iota(out_cap, dev) < num_groups
    results = [torch.where(fits, num_groups, -1), out_valid]
    iota_s = iota(S, dev)
    for i, kdt in enumerate(key_dtypes):
        code = torch.div(iota_s, strides[i], rounding_mode="floor") % sizes[i]
        kdata = (bases[i] + code - 1).to(kdt)
        results.append(torch.where(out_valid, compact(kdata), 0).to(kdt))
        results.append(compact(code > 0) & out_valid)
    for e in emits:
        t = tables[e.table]
        if e.kind == EMIT_NONZERO:
            results.append(compact(t != 0))
        elif e.kind == EMIT_WHERE:
            results.append(compact(torch.where(tables[e.aux] != 0, t, 0)).to(e.dtype))
        else:
            results.append(compact(t).to(e.dtype))
    if nbuck:
        shift, nb = K.radix_bucket_shift(S, nbuck)
        rows = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
        rows.index_add_(0, (seg >> shift).clamp(max=nb), exists.to(torch.int64))
        groups = torch.zeros(nb, dtype=torch.int64, device=dev)
        groups.index_add_(0, iota_s >> shift, present.to(torch.int64))
        results += [rows[:nb], groups]
    return tuple(results)


def _run_cuda(name, keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
              emits, out_cap, nbuck):
    """The slot program on the card (csrc/slot_agg.cu); same outputs as
    :func:`_run_plain`."""
    dev = kvalids[0].device
    keys64 = [k.to(torch.int64).contiguous() for k in keys]
    srcs = [op.src.to(torch.int64).contiguous() if op.src is not None else None
            for op in ops]
    cuda_lib.require_cuda(name, *keys64, *kvalids,
                          *[v for op in ops for v in op.valids],
                          *[s for s in srcs if s is not None])
    for v in list(kvalids) + [v for op in ops for v in op.valids]:
        if v.dtype != torch.bool:
            raise TypeError(f"{name}: validity plane of dtype {v.dtype}")
    if len(keys) > 8 or len(ops) > 24 or len(emits) > 24 or \
            any(len(op.valids) > 3 for op in ops):
        raise NotImplementedError(f"{name}: more keys/aggregates than one "
                                  "slot-kernel launch takes")
    S = _slots(sizes)
    strides = K.radix_strides(sizes)
    shift, nb = K.radix_bucket_shift(S, nbuck) if nbuck else (0, 0)
    if nb > cuda_lib.THREADS:
        raise ValueError(f"{name}: {nb} radix buckets, at most {cuda_lib.THREADS}")
    lib = cuda_lib.library()
    i64 = dict(dtype=torch.int64, device=dev)
    tables = torch.empty((max(1, len(ops)), S), **i64)
    present = torch.empty(S, dtype=torch.uint8, device=dev)
    offs = torch.empty(cuda_lib.blocks(S) + 1, **i64)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    count = torch.empty(2, **i64)  # [count or -1 on overflow, count]
    key_out = [torch.empty(out_cap, **i64) for _ in keys]
    kvalid_out = [torch.empty(out_cap, dtype=torch.bool, device=dev) for _ in keys]
    emit_out = [torch.empty(out_cap, dtype=torch.bool, device=dev)
                if e.kind == EMIT_NONZERO else torch.empty(out_cap, **i64)
                for e in emits]
    hist = torch.empty((2, nb), **i64) if nb else None

    P = cuda_lib.ptr_array
    Iv = cuda_lib.int_array
    keep = []  # the ctypes arrays behind the pointers, alive until the call returns

    def arg(pair):
        keep.append(pair[1])
        return pair[0]

    LL = cuda_lib.ctypes.c_longlong
    op_valid = []
    for op in ops:
        op_valid += list(op.valids) + [None] * (3 - len(op.valids))
    err = lib.blz_slot_agg(
        len(keys), arg(P(keys64)), arg(P(kvalids)),
        arg(Iv(bases, LL)), arg(Iv(sizes, LL)), arg(Iv(strides, LL)),
        num_rows, len(ops), arg(Iv([op.kind for op in ops])),
        arg(P(srcs)), arg(Iv([len(op.valids) for op in ops])), arg(P(op_valid)),
        arg(P([tables[i] for i in range(len(ops))])),
        arg(Iv([op.mult for op in ops], LL)), arg(Iv([op.init for op in ops], LL)),
        len(emits), arg(Iv([e.kind for e in emits])),
        arg(P([tables[e.table] for e in emits])),
        arg(P([tables[e.aux] if e.aux >= 0 else None for e in emits])),
        arg(P(emit_out)),
        S, present.data_ptr(), offs.data_ptr(), overflow.data_ptr(), out_cap,
        arg(P(key_out)), arg(P(kvalid_out)), count.data_ptr(),
        hist[0].data_ptr() if nb else None, hist[1].data_ptr() if nb else None,
        shift, nb, cuda_lib.stream_of(dev))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    out_valid = iota(out_cap, dev) < count[1]
    results = [count[0], out_valid]
    for kd, kv, kdt in zip(key_out, kvalid_out, key_dtypes):
        results += [kd.to(kdt), kv]
    for e, o in zip(emits, emit_out):
        results.append(o if e.kind == EMIT_NONZERO else o.to(e.dtype))
    if nb:
        results += [hist[0], hist[1]]
    return tuple(results)


def _run(name, *args):
    on_cuda = args[1][0].is_cuda  # key validity planes
    return _run_cuda(name, *args) if on_cuda else _run_plain(*args)


def slot_agg_partial(keys, kvalids, key_dtypes, num_rows, bases, sizes, specs,
                     args, out_cap, nbuck=0):
    """K3: rows -> partial states in slot order. Returns (group count, or
    -1 when a key fell outside the plan; out_valid; per key (data,
    valid); per aggregate its state arrays; [per-bucket rows, groups] when
    ``nbuck``) — the outputs of ``_dense_partial_kernel``."""
    ops, emits = _partial_program(specs, args)
    return _run("slot_agg_partial", keys, kvalids, key_dtypes, num_rows, bases,
                sizes, ops, emits, out_cap, nbuck)


def slot_agg_partial_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes,
                           specs, args, out_cap, nbuck=0):
    ops, emits = _partial_program(specs, args)
    return _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
                      emits, out_cap, nbuck)


def slot_agg_merge(keys, kvalids, key_dtypes, num_rows, bases, sizes, kinds,
                   states, out_cap):
    """K4: partial states -> merged states in slot order; the outputs of
    ``_radix_merge_kernel``."""
    ops, emits = _merge_program(kinds, states)
    return _run("slot_agg_merge", keys, kvalids, key_dtypes, num_rows, bases,
                sizes, ops, emits, out_cap, 0)


def slot_agg_merge_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes,
                         kinds, states, out_cap):
    ops, emits = _merge_program(kinds, states)
    return _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
                      emits, out_cap, 0)


# -- planning ------------------------------------------------------------------


def probe_ranges(key_data: Sequence[torch.Tensor],
                 key_valid: Sequence[torch.Tensor]) -> np.ndarray:
    """Per key (any valid, min, max) over the valid rows; one sync."""
    info = torch.iinfo(torch.int64)
    rows = []
    for d, v in zip(key_data, key_valid):
        d64 = d.to(torch.int64)
        lo, _ = torch.aminmax(torch.where(v, d64, info.max))
        _, hi = torch.aminmax(torch.where(v, d64, info.min))
        rows.append(torch.stack([v.any().to(torch.int64), lo, hi]))
    return torch.stack(rows).cpu().numpy()


def plan_slot_table(probe: np.ndarray, capacity: int, prev, max_slots: int,
                    conf):
    """(bases, sizes, out_cap) from probed key ranges, unioned with the
    previous plan on overflow; None when the table would exceed
    ``max_slots``; _DEFER_PLAN when no key was valid and nothing anchors
    the plan (blaze_tpu/ops/agg_device.py:_plan_slot_table)."""
    bases, sizes, S = [], [], 1
    for i, (anyv, kmin, kmax) in enumerate(probe):
        if not anyv:
            if prev is None:
                return _DEFER_PLAN
            lo = int(prev[0][i])
            hi = lo + prev[1][i] - 2
        else:
            lo, hi = int(kmin), int(kmax)
            if prev is not None:
                plo = int(prev[0][i])
                phi = plo + prev[1][i] - 2
                lo, hi = min(lo, plo), max(hi, phi)
        size = 2
        while size < hi - lo + 2:
            size <<= 1
        bases.append(lo)
        sizes.append(size)
        S *= size
    if S > max_slots:
        return None
    return tuple(bases), tuple(sizes), conf.capacity_for(min(S, capacity))


def _require_int_keys(key_data, what: str):
    for d in key_data:
        if d.dtype not in _INT_DTYPES:
            _not_ported(f"{what} over a {d.dtype} key")


# -- the operators' engines ----------------------------------------------------


class DevicePartialAgger:
    """Streams batches through K3: probe once per stream, re-plan once on a
    range overflow, one group-count sync per batch."""

    def __init__(self, op, child_schema: T.Schema, conf):
        self.op = op
        self.conf = conf
        self.group_ev = ExprEvaluator([e for _, e in op.groupings], child_schema)
        self.agg_evs = [ExprEvaluator(list(a.agg.args), child_schema)
                        if a.agg.args else None for a in op.aggs]
        self.fns = [aggfns.create_agg_function(a.agg, child_schema)
                    for a in op.aggs]
        self.specs = []
        for fn in self.fns:
            rescale = 0
            if isinstance(fn.arg_type, T.DecimalType):
                target = fn.sum_type if fn.kind == "avg" else fn.result_type
                if isinstance(target, T.DecimalType) and fn.kind in ("sum", "avg"):
                    rescale = target.scale - fn.arg_type.scale
            if rescale < 0:
                _not_ported(f"a {fn.kind} into a smaller decimal scale")
            self.specs.append((fn.kind, rescale, "int64"))
        self._bucket_state = None
        self.last_bucket_stats = None

    def _keys(self, batch: ColumnarBatch, exists: torch.Tensor):
        key_data, key_valid = [], []
        for _, e in self.op.groupings:
            d, v = broadcast(self.group_ev.eval(e, batch), batch)
            key_data.append(d)
            key_valid.append(v & exists)
        _require_int_keys(key_data, "a grouped aggregate")
        return key_data, key_valid

    def _args(self, batch: ColumnarBatch, exists: torch.Tensor):
        args = []
        for a, ev in zip(self.op.aggs, self.agg_evs):
            if ev is None:
                args.append((torch.zeros(batch.capacity, dtype=torch.int64,
                                         device=batch.device), exists))
            else:
                d, v = broadcast(ev.eval(a.agg.args[0], batch), batch)
                args.append((d, v & exists))
        return args

    def _plan(self, probe, capacity, prev):
        st = plan_slot_table(probe, capacity, prev,
                             min(self.conf.dense_agg_max_buckets, capacity),
                             self.conf)
        if st is _DEFER_PLAN:
            return st
        if st is not None:
            return ("dense",) + st
        st = plan_slot_table(probe, capacity, prev,
                             self.conf.radix_agg_max_slots, self.conf)
        if st is None:
            _not_ported(f"a key range beyond radix_agg_max_slots="
                        f"{self.conf.radix_agg_max_slots} slots")
        return ("radix",) + st

    def process(self, batch: ColumnarBatch) -> Optional[ColumnarBatch]:
        n = batch.num_rows
        if n == 0:
            return None
        exists = batch.row_exists_mask()
        key_data, key_valid = self._keys(batch, exists)
        args = self._args(batch, exists)
        key_dtypes = [d.dtype for d in key_data]
        self.last_bucket_stats = None
        st = self._bucket_state
        prev = None
        for _ in range(2):
            if st is None:
                st = self._plan(probe_ranges(key_data, key_valid),
                                batch.capacity, prev)
                if st is _DEFER_PLAN:
                    # every key of this batch is null: one null group, the
                    # next batch probes again
                    k = len(key_data)
                    st_once = ("dense", (0,) * k, (2,) * k,
                               self.conf.capacity_for(min(2 ** k, batch.capacity)))
                    outs = self._call(st_once, key_data, key_valid, key_dtypes,
                                      n, args)
                    return self._assemble(outs, int(outs[0]))
                self._bucket_state = st
            outs = self._call(st, key_data, key_valid, key_dtypes, n, args)
            num_groups = int(outs[0])  # the sync; -1 flags a range overflow
            if num_groups >= 0:
                if st[0] == "radix":
                    self.last_bucket_stats = (outs[-2], outs[-1])
                    outs = outs[:-2]
                return self._assemble(outs, num_groups) if num_groups else None
            prev, st = (st[1], st[2]), None
            self._bucket_state = None
        raise RuntimeError("slot plan overflowed after re-planning over the "
                           "union of the probed ranges")

    def _call(self, st, key_data, key_valid, key_dtypes, n, args):
        table, bases, sizes, out_cap = st
        nbuck = self.conf.radix_agg_buckets if table == "radix" else 0
        return slot_agg_partial(key_data, key_valid, key_dtypes, n, bases,
                                sizes, self.specs, args, out_cap, nbuck)

    def _assemble(self, outs, num_groups: int) -> ColumnarBatch:
        out_valid = outs[1]
        pos = 2
        schema = self.op.schema
        cols: List[DeviceColumn] = []
        for ci in range(len(self.op.groupings)):
            cols.append(DeviceColumn(schema[ci].dtype, outs[pos],
                                     outs[pos + 1] & out_valid))
            pos += 2
        for fn in self.fns:
            if fn.kind == "sum":
                s, has = outs[pos], outs[pos + 1]
                cols += [DeviceColumn(fn.result_type, s, has & out_valid),
                         DeviceColumn(T.BOOL, has, out_valid)]
                pos += 2
            elif fn.kind == "count":
                cols.append(DeviceColumn(T.I64, outs[pos], out_valid))
                pos += 1
            elif fn.kind == "avg":
                s, c = outs[pos], outs[pos + 1]
                cols += [DeviceColumn(fn.sum_type, s, (c > 0) & out_valid),
                         DeviceColumn(T.I64, c, out_valid)]
                pos += 2
            else:
                v, has = outs[pos], outs[pos + 1]
                cols += [DeviceColumn(fn.result_type, v, has & out_valid),
                         DeviceColumn(T.BOOL, has, out_valid)]
                pos += 2
        return ColumnarBatch(schema, cols, num_groups)


class DeviceMergeAgger:
    """Merges partial-state batches with K4: concatenate all input (states
    are small next to raw rows), one probe, one kernel call, then merged
    state columns (PARTIAL_MERGE) or final values (FINAL)."""

    def __init__(self, op, child_schema: T.Schema, conf):
        self.op = op
        self.child_schema = child_schema
        self.conf = conf
        self.fns = op.make_fns(child_schema)
        self.kinds = tuple(fn.kind for fn in self.fns)

    def run(self, batches: List[ColumnarBatch]) -> List[ColumnarBatch]:
        op = self.op
        batches = [b for b in batches if b.num_rows]
        if not batches:
            return []
        big = ColumnarBatch.concat(batches, self.child_schema, self.conf)
        exists = big.row_exists_mask()
        ev = ExprEvaluator([e for _, e in op.groupings], big.schema)
        key_data, key_valid = [], []
        for _, e in op.groupings:
            d, v = broadcast(ev.eval(e, big), big)
            key_data.append(d)
            key_valid.append(v & exists)
        _require_int_keys(key_data, "a merge aggregate")
        states = []
        pos = len(op.groupings)
        for fn in self.fns:
            cols = []
            for _ in fn.state_fields():
                c = big.columns[pos]
                cols.append((c.data, c.validity & exists))
                pos += 1
            states.append(cols)
        st = plan_slot_table(probe_ranges(key_data, key_valid), big.capacity,
                             None, self.conf.radix_agg_max_slots, self.conf)
        if st is None:
            _not_ported(f"a merge key range beyond radix_agg_max_slots="
                        f"{self.conf.radix_agg_max_slots} slots")
        if st is _DEFER_PLAN:
            k = len(key_data)
            st = ((0,) * k, (2,) * k, self.conf.capacity_for(2 ** k))
        bases, sizes, out_cap = st
        outs = slot_agg_merge(key_data, key_valid, [d.dtype for d in key_data],
                              big.num_rows, bases, sizes, self.kinds, states,
                              out_cap)
        num_groups = int(outs[0])
        if num_groups < 0:
            raise RuntimeError("merge slot plan overflowed on its own probe")
        if num_groups == 0:
            return []
        out_valid = outs[1]
        out_schema = op.schema
        cols: List[DeviceColumn] = []
        p = 2
        for gi in range(len(op.groupings)):
            cols.append(DeviceColumn(out_schema[gi].dtype, outs[p],
                                     outs[p + 1] & out_valid))
            p += 2
        final = not op.is_partial_output
        for fn in self.fns:
            nstate = len(fn.state_fields())
            state = list(outs[p:p + nstate])
            p += nstate
            if final:
                cols.append(fn.final_column(state, num_groups, out_cap))
            else:
                cols.extend(fn.state_columns(state, num_groups, out_cap))
        return [ColumnarBatch(out_schema, cols, num_groups)]
