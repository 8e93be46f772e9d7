"""Device grouped aggregation: the slot routes (K3, K4) and the sort
route (K10).

Counterpart of blaze_tpu/ops/agg_device.py's ``DevicePartialAgger`` and
``DeviceMergeAgger``.

- Slot routes (``_dense_partial_kernel``, ``_radix_merge_kernel``):
  integer group keys are probed for their range (one ``aminmax`` and one
  small sync per stream), planned into a slot table (``plan_slot_table``:
  per key a power-of-two range whose code 0 is the null key), and every
  row scatters its aggregate states straight into its slot. Groups come
  out in slot order (keys ascending, nulls first), keys rebuilt from the
  slot index. ``dense_agg`` gates the partial's small tables and
  ``radix_agg`` its large ones and the merge, as in the JAX package.
- Sort route (``_partial_kernel``, ``_merge_kernel``): K5 sorts the rows
  by key, K10 cuts them into segments and reduces each one, K6 takes each
  group's keys from its first row. It serves every aggregate whose keys
  are not integers, whose slot plan does not fit ``radix_agg_max_slots``,
  whose batch has no valid key to plan from, or whose route is switched
  off, as the reference routes them. A single integer key in [0,
  capacity - 1) is its own segment id there, nulls last (the reference's
  direct segmentation).
- Float aggregate states (float SUM/AVG sums, float MIN/MAX) never reach
  K3/K4, whose adds are atomics: where the reference would take a slot
  route they take K10 with the sorted segmentation, which gives the slot
  route's group order and its per-group fold order, bit for bit.

All kernels run one program described by two lists: *ops* (ADD / COUNT /
MIN / MAX into a table, gated by up to three validity planes, and the
limb ops of core/kernels.py) and *emits* (RAW table value, NONZERO flag,
the value WHERE a companion count is nonzero, and the limb emits).
``_partial_program`` and ``_merge_program`` spell SUM/COUNT/AVG/MIN/MAX
with them, exactly as ``_reduce_aggs`` and ``_merge_reduce`` compute them
in the JAX package, the wide-decimal kinds included: sum2/avg2 (a
decimal(9..18) argument summed into decimal(19..28) as two limbs),
sum3/avg3 (a decimal(19..38) argument as three limbs) and minw/maxw (its
extremes, compared lexicographically); ``_run_plain`` is the plain
PyTorch version of the slot kernels, and core/kernels.py holds K10's
twins.

Partial skipping (``DevicePartialAgger.passthrough``): once the skipper
of ops/agg.py decides that partials do not reduce, each further batch
becomes one singleton state a row through K19 (core/kernels.py
``passthrough_states``, csrc/passthrough.cu), the same program with the
slot equal to the row, with no sync. The skipper reads the radix pass's
per-bucket (rows, groups) histogram, which K3 writes beside its group
count and which comes to the host in the same copy while a skipper
listens (``histograms``); a float state's radix batch, which K10 folds,
gets it from a K3 launch without aggregates, which also checks the plan.

Not ported: any aggregate outside ops/aggfns.py (NotImplementedError
naming ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn, WideColumn, iota
from blaze_tpu_torch.core.kernels import (EMIT_NONZERO, EMIT_RAW, EMIT_WHERE,
                                          OP_ADD, OP_ADD_HI32, OP_ADD_LO32, OP_COUNT,
                                          OP_MAX, OP_MIN, AggEmit, AggOp, lex_emits,
                                          lex_ops, limb_emits)
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast, fusable_expr
from blaze_tpu_torch.exprs.fused_triton import FusedAggSpec, FusedJoin, fused_agg_kernel
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops import aggfns
from blaze_tpu_torch.utils import cuda_lib

# "no valid key in this batch and no plan to anchor to"
_DEFER_PLAN = object()

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not on the PyTorch port yet (ROADMAP.md Queue 1 item 3)")


# -- the slot program ----------------------------------------------------------


def _extreme(dtype: torch.dtype, which: str):
    if dtype.is_floating_point:
        return float("inf") if which == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if which == "min" else info.min


def _widen(x: torch.Tensor, to_float: bool = False) -> torch.Tensor:
    """A state source as the kernels take it: float64 for floats (or when
    the aggregate accumulates in float64), int64 otherwise."""
    return x.to(torch.float64 if to_float or x.is_floating_point() else torch.int64)


def _partial_program(specs, args):
    """Ops/emits of ``_reduce_aggs`` for the ported kinds. ``args[i]`` is
    aggregate i's (data, valid) pair, valid already masked with exists;
    ``specs[i]`` its (kind, rescale power, accumulator dtype)."""
    ops: List[AggOp] = []
    emits: List[AggEmit] = []
    for (kind, rescale, acc), (data, valid) in zip(specs, args):
        t = len(ops)
        if kind in ("sum2", "avg2"):
            src = _widen(data)
            ops += [AggOp(OP_ADD_LO32, src, [valid]), AggOp(OP_ADD_HI32, src, [valid]),
                    AggOp(OP_COUNT, None, [valid])]
            emits += limb_emits(t, 2) + [_has_or_count(kind, t + 2)]
        elif kind in ("sum3", "avg3"):
            ops += [AggOp(OP_ADD, limb, [valid]) for limb in data] + \
                [AggOp(OP_COUNT, None, [valid])]
            emits += limb_emits(t, 3) + [_has_or_count(kind, t + 3)]
        elif kind in ("minw", "maxw"):
            l0, l1, l2 = data
            ops += lex_ops(kind[:3], l0, l1, l2, [valid]) + [AggOp(OP_COUNT, None, [valid])]
            emits += lex_emits(t, t + 2) + [AggEmit(EMIT_NONZERO, t + 2, torch.bool)]
        elif kind in ("sum", "avg"):
            src = _widen(data, acc == "float64")  # widen BEFORE accumulating
            ops += [AggOp(OP_ADD, src, [valid], 10 ** rescale),
                    AggOp(OP_COUNT, None, [valid])]
            emits += [AggEmit(EMIT_RAW, t, src.dtype),
                      AggEmit(EMIT_NONZERO, t + 1, torch.bool) if kind == "sum"
                      else AggEmit(EMIT_RAW, t + 1, torch.int64)]
        elif kind == "count":
            ops.append(AggOp(OP_COUNT, None, [valid]))
            emits.append(AggEmit(EMIT_RAW, t, torch.int64))
        elif kind in ("min", "max"):
            ops += [AggOp(OP_MIN if kind == "min" else OP_MAX, _widen(data), [valid],
                          init=_extreme(data.dtype, kind)),
                    AggOp(OP_COUNT, None, [valid])]
            emits += [AggEmit(EMIT_WHERE, t, data.dtype, aux=t + 1),
                      AggEmit(EMIT_NONZERO, t + 1, torch.bool)]
        else:
            _not_ported(f"partial aggregate kind {kind!r}")
    return ops, emits


def _has_or_count(kind: str, table: int) -> AggEmit:
    """A SUM's has flag (NONZERO), an AVG's count (RAW)."""
    if kind.startswith("avg"):
        return AggEmit(EMIT_RAW, table, torch.int64)
    return AggEmit(EMIT_NONZERO, table, torch.bool)


def _merge_program(kinds, states):
    """Ops/emits of ``_merge_reduce``. ``states[i]`` is aggregate i's list
    of (data, valid) state-column pairs, valid already masked with
    exists."""
    ops: List[AggOp] = []
    emits: List[AggEmit] = []
    for kind, scols in zip(kinds, states):
        t = len(ops)
        if kind in aggfns.LIMB_KINDS:
            # limbs, then the has flag or count; the first limb's validity
            # and the flag or count gate the row (``_merge_reduce``)
            *limbs, (sd, sv) = scols
            gate = [limbs[0][1], sd if sd.dtype == torch.bool else sd != 0, sv]
            datas = [d for d, _ in limbs]
            if kind in ("minw", "maxw"):
                ops += lex_ops(kind[:3], *datas, gate) + [AggOp(OP_COUNT, None, gate)]
                emits += lex_emits(t, t + 2) + [AggEmit(EMIT_NONZERO, t + 2, torch.bool)]
                continue
            ops += [AggOp(OP_ADD, d, gate) for d in datas]
            ops.append(AggOp(OP_ADD, sd, gate) if kind.startswith("avg")
                       else AggOp(OP_COUNT, None, gate))
            emits += limb_emits(t, len(datas)) + [_has_or_count(kind, t + len(datas))]
        elif kind == "sum":
            (sd, sv), (hd, hv) = scols
            gate = [sv, hd, hv]
            ops += [AggOp(OP_ADD, _widen(sd), gate), AggOp(OP_COUNT, None, gate)]
            emits += [AggEmit(EMIT_RAW, t, sd.dtype),
                      AggEmit(EMIT_NONZERO, t + 1, torch.bool)]
        elif kind == "count":
            (cd, cv), = scols
            ops.append(AggOp(OP_ADD, _widen(cd), [cv]))
            emits.append(AggEmit(EMIT_RAW, t, torch.int64))
        elif kind == "avg":
            (sd, sv), (cd, cv) = scols
            ops += [AggOp(OP_ADD, _widen(sd), [sv]), AggOp(OP_ADD, _widen(cd), [cv])]
            emits += [AggEmit(EMIT_RAW, t, sd.dtype),
                      AggEmit(EMIT_RAW, t + 1, torch.int64)]
        elif kind in ("min", "max"):
            (vd, vv), (hd, hv) = scols
            gate = [vv, hd, hv]
            ops += [AggOp(OP_MIN if kind == "min" else OP_MAX, _widen(vd), gate,
                          init=_extreme(vd.dtype, kind)),
                    AggOp(OP_COUNT, None, gate)]
            emits += [AggEmit(EMIT_RAW, t, vd.dtype),
                      AggEmit(EMIT_NONZERO, t + 1, torch.bool)]
        else:
            _not_ported(f"merge aggregate kind {kind!r}")
    return ops, emits


def _slots(sizes: Sequence[int]) -> int:
    S = 1
    for s in sizes:
        S *= s
    return S


def _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops, emits,
               out_cap, nbuck, exists=None):
    """Plain PyTorch version of the slot program (the arithmetic of
    ``_dense_partial_kernel`` / ``_radix_merge_kernel``). The rows below
    ``num_rows`` exist, and of them, where ``exists`` is given (K18's live
    mask), only those it holds."""
    dev = kvalids[0].device
    cap = kvalids[0].shape[0]
    S = _slots(sizes)
    strides = K.radix_strides(sizes)
    live = exists
    exists = iota(cap, dev) < num_rows
    if live is not None:
        exists = exists & live
    seg, fits = K.radix_pack(keys, [v & exists for v in kvalids], exists,
                             bases, sizes, strides)
    tables = []
    for o, op in enumerate(ops):
        ok = exists
        for v in op.valids:
            ok = ok & v.to(torch.bool)
        if op.kind in (K.OP_LEXMIN, K.OP_LEXMAX):
            lo = ops[o + 1]
            tables += [t[:S] for t in K.lex_tables_plain(
                seg, ok, op.src, lo.src, lo.src0, S + 1, op.kind == K.OP_LEXMAX)]
            continue
        if op.kind == K.OP_LEXLO:
            continue
        table = torch.full((S + 1,), op.init, dtype=torch.int64, device=dev)
        if op.kind == OP_COUNT:
            table.index_add_(0, seg, ok.to(torch.int64))
        else:
            src = op.src.to(torch.int64)
            if op.kind in (OP_ADD, OP_ADD_LO32, OP_ADD_HI32):
                table.index_add_(0, seg, torch.where(ok, K.op_contrib(op, src), 0))
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
        x = compact(K.emit_plain(e, tables))
        results.append(x if e.kind == EMIT_NONZERO else x.to(e.dtype))
    if nbuck:
        shift, nb = K.radix_bucket_shift(S, nbuck)
        rows = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
        rows.index_add_(0, (seg >> shift).clamp(max=nb), exists.to(torch.int64))
        groups = torch.zeros(nb, dtype=torch.int64, device=dev)
        groups.index_add_(0, iota_s >> shift, present.to(torch.int64))
        results += [rows[:nb], groups]
    return tuple(results)


def _out_size(dtype: torch.dtype) -> int:
    """csrc/slot_agg.cu's code for an output plane's type: 0 for bool
    (value != 0), else the integer's bytes."""
    if dtype == torch.bool:
        return 0
    if dtype.is_floating_point or dtype.is_complex:
        raise TypeError(f"slot program output of dtype {dtype}")
    return dtype.itemsize


def _planes(dev, n: int, dtypes) -> List[torch.Tensor]:
    """Planes of n values of ``dtypes``, views of one buffer (each at an
    8-byte offset)."""
    nbytes = [-(-n * d.itemsize // 8) * 8 for d in dtypes]
    buf = torch.empty(max(sum(nbytes), 1), dtype=torch.uint8, device=dev)
    views, off = [], 0
    for d, b in zip(dtypes, nbytes):
        views.append(buf[off:off + n * d.itemsize].view(d))
        off += b
    return views


def _run_cuda(name, keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
              emits, out_cap, nbuck, exists=None, kinds=(), host_head=False):
    """The slot program on the card (csrc/slot_agg.cu); same outputs as
    :func:`_run_plain`, written by the kernel in their final types into
    three buffers: the counts, the groups' keys, their validity planes and
    states (a FINAL merge keeps the keys and drops the rest). ``kinds``:
    the program's limb aggregate kinds, counted per launch."""
    dev = kvalids[0].device
    K.check_limb_program(name, ops, emits)
    keys = [(k if k.dtype in _INT_DTYPES else k.to(torch.int64)).contiguous() for k in keys]
    srcs = [op.src.contiguous() if op.src is not None else None for op in ops]
    src0s = [op.src0.contiguous() if op.src0 is not None else None for op in ops]
    if exists is not None and (exists.dtype != torch.bool or
                               exists.shape != kvalids[0].shape):
        raise TypeError(f"{name}: exists plane {exists.dtype}{tuple(exists.shape)}")
    cuda_lib.require_cuda(name, *keys, *kvalids, *([exists] if exists is not None else []),
                          *[v for op in ops for v in op.valids],
                          *[s for s in srcs + src0s if s is not None])
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
    key_sizes = [_out_size(d) for d in key_dtypes]
    emit_dtypes = [torch.bool if e.kind == EMIT_NONZERO else e.dtype for e in emits]
    emit_sizes = [_out_size(d) for d in emit_dtypes]
    # meta: [count or -1 on overflow, count], then the histogram's rows and
    # groups planes (one copy brings all of it to the host)
    meta = torch.empty(2 + 2 * nb, dtype=torch.int64, device=dev)
    key_out = _planes(dev, out_cap, key_dtypes)
    rest = _planes(dev, out_cap, [torch.bool] * (len(keys) + 1) + emit_dtypes)
    kvalid_out, valid_out, emit_out = rest[:len(keys)], rest[len(keys)], rest[len(keys) + 1:]
    words = lib.blz_slot_agg_scratch(S, len(ops), num_rows, nb)
    scratch = torch.empty(words, dtype=torch.int64, device=dev) if words else None

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
        len(keys), arg(P(keys)), arg(P(kvalids)), arg(Iv([k.element_size() for k in keys])),
        arg(Iv(bases, LL)), arg(Iv(sizes, LL)), arg(Iv(strides, LL)),
        num_rows, exists.data_ptr() if exists is not None else None,
        len(ops), arg(Iv([op.kind for op in ops])),
        arg(P(srcs)), arg(P(src0s)), arg(Iv([len(op.valids) for op in ops])),
        arg(P(op_valid)), arg(Iv([op.mult for op in ops], LL)),
        arg(Iv([op.init for op in ops], LL)),
        len(emits), arg(Iv([e.kind for e in emits])), arg(Iv([e.table for e in emits])),
        arg(Iv([e.aux for e in emits])), arg(Iv([e.aux2 for e in emits])),
        arg(Iv(emit_sizes)), arg(P(emit_out)), S, out_cap,
        arg(P(key_out)), arg(Iv(key_sizes)), arg(P(kvalid_out)), valid_out.data_ptr(),
        meta.data_ptr(), shift, nb, scratch.data_ptr() if words else None, words,
        cuda_lib.stream_of(dev))
    cuda_lib.check(err, name)
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.count_limb_launch(name, kinds)
    results = [meta[0], valid_out]
    for kd, kv in zip(key_out, kvalid_out):
        results += [kd, kv]
    results += emit_out
    if nb:
        results += [meta[2:2 + nb], meta[2 + nb:]]
        if host_head:
            head = meta.cpu().numpy()
            results[0] = int(head[0])
            results[-2:] = [head[2:2 + nb], head[2 + nb:]]
    return tuple(results)


def _run(name, kinds, *args, exists=None, host_head=False):
    """K3/K4 on CUDA planes, the plain version on CPU ones. ``host_head``
    (with a histogram): the group count as an int and the histogram as
    numpy planes, pulled in one copy."""
    ops = args[6]
    if any(op.is_float for op in ops):
        # K3/K4 add with atomics: a float sum would depend on their order
        raise TypeError(f"{name}: float states take the sort route (K10)")
    if args[1][0].is_cuda:  # key validity planes
        return _run_cuda(name, *args, exists=exists, kinds=kinds, host_head=host_head)
    outs = _run_plain(*args, exists=exists)
    if host_head and args[-1]:
        outs = (int(outs[0]),) + outs[1:-2] + (outs[-2].numpy(), outs[-1].numpy())
    return outs


def _limb_kinds(kinds) -> tuple:
    return tuple(k for k in kinds if k in aggfns.LIMB_KINDS)


def slot_agg_partial(keys, kvalids, key_dtypes, num_rows, bases, sizes, specs,
                     args, out_cap, nbuck=0, exists=None, host_head=False):
    """K3: rows -> partial states in slot order. Returns (group count, or
    -1 when a key fell outside the plan; out_valid; per key (data,
    valid); per aggregate its state arrays; [per-bucket rows, groups] when
    ``nbuck``) — the outputs of ``_dense_partial_kernel``. ``exists``: a
    fused aggregate's live mask (K18), the rows below ``num_rows`` that
    exist; None: all of them. ``host_head`` (with ``nbuck``): the count and
    the histogram come back on the host, in one copy."""
    ops, emits = _partial_program(specs, args)
    return _run("slot_agg_partial", _limb_kinds(s[0] for s in specs), keys, kvalids,
                key_dtypes, num_rows, bases, sizes, ops, emits, out_cap, nbuck,
                exists=exists, host_head=host_head)


def slot_agg_partial_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes,
                           specs, args, out_cap, nbuck=0, exists=None):
    ops, emits = _partial_program(specs, args)
    return _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
                      emits, out_cap, nbuck, exists)


def slot_agg_merge(keys, kvalids, key_dtypes, num_rows, bases, sizes, kinds,
                   states, out_cap):
    """K4: partial states -> merged states in slot order; the outputs of
    ``_radix_merge_kernel``."""
    ops, emits = _merge_program(kinds, states)
    return _run("slot_agg_merge", _limb_kinds(kinds), keys, kvalids, key_dtypes,
                num_rows, bases, sizes, ops, emits, out_cap, 0)


def slot_agg_merge_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes,
                         kinds, states, out_cap):
    ops, emits = _merge_program(kinds, states)
    return _run_plain(keys, kvalids, key_dtypes, num_rows, bases, sizes, ops,
                      emits, out_cap, 0)


def _run_sorted(name, keys, kvalids, num_rows, ops, emits, direct, kinds=(),
                exists=None):
    """The sort route (K5 sort, K10 segments with each group's keys from its
    first row, and reduction); outputs as the slot program's, with
    capacity-long planes: (group count, out_valid, per key (data, valid),
    per emit its column). One sync, the group count, besides K5's. With
    ``exists`` (K18's live mask over the rows below num_rows) the dead rows
    sort last (K5's padding rank) and the segments cover the live rows
    only, whose count is one more sync; none live: (0,) and no launch."""
    dev = kvalids[0].device
    cap = kvalids[0].shape[0]
    live_rows = num_rows
    if exists is None:
        exists = iota(cap, dev) < num_rows
    else:
        live_rows = int(exists.sum())
        if live_rows == 0:
            return (0,)
    order, starts, count, (kd, kv) = K.segment_ids(keys, kvalids, exists, num_rows,
                                                   direct, live_rows)
    outs, _first = K.segment_reduce(name, order, starts, count, live_rows, ops, emits,
                                    _limb_kinds(kinds))
    num_groups = int(count)
    results = [num_groups, iota(cap, dev) < num_groups]
    for d, v in zip(kd, kv):
        results += [d, v]
    results += [o if e.kind == EMIT_NONZERO else K.narrow_float(o, e.dtype)
                for o, e in zip(outs, emits)]
    return tuple(results)


def seg_agg_partial(keys, kvalids, num_rows, specs, args, direct=True, exists=None):
    """K10 partial: rows -> partial states in key order; the outputs of
    ``_partial_kernel`` (keys' validity masked with exists: a prefix of
    num_rows rows, or a fused aggregate's live mask). ``direct`` allows the
    single-integer-key segmentation (nulls last); without it groups come
    in the slot routes' order."""
    ops, emits = _partial_program(specs, args)
    return _run_sorted("seg_agg_partial", keys, kvalids, num_rows, ops, emits,
                       direct, [s[0] for s in specs], exists)


def seg_agg_merge(keys, kvalids, num_rows, kinds, states, direct=True):
    """K10 merge: partial states -> merged states in key order; the outputs
    of ``_merge_kernel``."""
    ops, emits = _merge_program(kinds, states)
    return _run_sorted("seg_agg_merge", keys, kvalids, num_rows, ops, emits,
                       direct, kinds)


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


def _int_keys(key_data) -> bool:
    return bool(key_data) and all(d.dtype in _INT_DTYPES for d in key_data)


def _slot_fits(key_data, key_valid, num_rows, bases, sizes) -> bool:
    """Does every valid key lie in the plan (radix_pack's rule)? One sync."""
    exists = iota(key_valid[0].shape[0], key_valid[0].device) < num_rows
    return bool(K.radix_pack(key_data, key_valid, exists, bases, sizes,
                             K.radix_strides(sizes))[1])


# -- filter -> agg and join -> agg fusion (row 10) -----------------------------


def _device_or_wide(dt: T.DataType) -> bool:
    return T.torch_dtype(dt) is not None or T.is_wide_decimal(dt)


def fusable_join(op) -> Optional[FusedJoin]:
    """The join's structure when a partial aggregate may absorb it
    (blaze_tpu/ops/agg.py:121 _try_fuse_join, before its map loads): an
    INNER BroadcastJoinExec without a condition on one key, every build
    column a device plane, every probe column a device plane or a wide
    decimal, and a probe key K18 can generate (``fusable_expr``, which
    reads no wide column). Whether the map is unique is decided once it is
    loaded (its ``unique_single_key``)."""
    from blaze_tpu_torch.ir.nodes import JoinType
    from blaze_tpu_torch.ops.joins.bhj import BroadcastJoinExec

    if not isinstance(op, BroadcastJoinExec) or op.join_type != JoinType.INNER or \
            op.condition is not None:
        return None
    keys = op._key_exprs(for_build=False)
    probe = op.children[op._probe_child()].schema
    build = op.children[op._build_child()].schema
    if len(keys) != 1 or not all(T.torch_dtype(f.dtype) is not None for f in build.fields) \
            or not all(_device_or_wide(f.dtype) for f in probe.fields) \
            or not fusable_expr(keys[0], probe):
        return None
    return FusedJoin(keys[0], op._probe_child() == 0, probe, build)


def supports_fused_filter(filter_op, grandchild_schema: T.Schema) -> bool:
    """Can the filter's predicates run inside K18 (blaze_tpu/ops/
    agg_device.py:323)? Every column a device plane or a wide decimal, and
    every predicate one K18 generates (``fusable_expr``: no wide column,
    no ScalarFunction, no bloom probe), decided from the plan before the
    first batch."""
    return all(_device_or_wide(f.dtype) for f in grandchild_schema.fields) and \
        all(fusable_expr(p, grandchild_schema) for p in filter_op.predicates)


def fusable_aggregate(op, child_schema: T.Schema) -> bool:
    """May the partial aggregate's keys and arguments be K18's outputs
    (the reference's ``fuse_ok`` argument rules, blaze_tpu/ops/agg.py:
    193-216, with generable expressions only)? A bare wide-decimal
    argument passes its limb planes through."""
    for a in op.aggs:
        if not a.agg.args:
            continue
        arg = a.agg.args[0]
        if isinstance(arg, (E.Column, E.BoundReference)) and \
                T.is_wide_decimal(E.infer_type(arg, child_schema)):
            continue
        if not fusable_expr(arg, child_schema):
            return False
    return all(fusable_expr(e, child_schema) for _, e in op.groupings)


# -- the operators' engines ----------------------------------------------------


def _route_on(flag: Optional[bool]) -> bool:
    """A slot route's switch: True/False force it; None is the port's
    default, on (the JAX package's None reads its backend hint)."""
    return True if flag is None else bool(flag)


_ZEROS: Dict[tuple, torch.Tensor] = {}


def _zero_plane(capacity: int, device: torch.device) -> torch.Tensor:
    """A read-only int64 zero plane of ``capacity`` rows on ``device``, one
    a device and capacity: the data plane of a fused COUNT(*), which K3 and
    K10 never read or write (only its validity, the live mask, counts)."""
    key = (device.type, device.index, capacity)
    z = _ZEROS.get(key)
    if z is None:
        z = _ZEROS.setdefault(key, torch.zeros(capacity, dtype=torch.int64, device=device))
    return z


class DevicePartialAgger:
    """Streams batches through the slot routes (K3) or the sort route
    (K10), routed as ``_try_dense`` routes them: probe once per stream,
    re-plan once on a range overflow, the sort route for a batch without
    a valid key to plan from, and for the rest of the stream once no plan
    fits; one group-count sync per batch.

    With ``fused_predicates``, ``fused_joins`` (inner-first, each a
    (``FusedJoin``, build map) pair: K18 searches the map's sorted unique
    words, uploaded once by ``device_keys``, and gathers its build
    columns, code c at row c) or ``fused_steps`` (over
    ``fused_input_schema``) the batches are the
    absorbed operators' input, and one K18 launch a batch
    (``K.fused_agg_input``) gives the keys, the arguments and the live
    mask that K3 and K10 then read (blaze_tpu/ops/agg_device.py:518
    ``_trace_tb_mask`` composed with ``_dense_partial_kernel`` or
    ``_partial_kernel``); the range probe reads the same planes. The
    reference's per-batch ``materialize`` and eager-steps fallbacks for a
    batch with host columns have no counterpart: the port decides fusion
    from the plan, and a batch that is not all device and wide-decimal
    columns raises."""

    def __init__(self, op, child_schema: T.Schema, conf, fused_predicates=None,
                 fused_joins=(), fused_steps=None, fused_input_schema=None):
        self.op = op
        self.conf = conf
        self.fused_joins = list(fused_joins)
        self.fused = None
        if fused_predicates or self.fused_joins or fused_steps:
            in_schema = fused_input_schema if fused_steps else \
                self.fused_joins[0][0].probe_schema if self.fused_joins else child_schema
            self.fused = FusedAggSpec(
                in_schema, tuple(j for j, _ in self.fused_joins), tuple(fused_steps or ()),
                tuple(fused_predicates or ()), child_schema,
                tuple(e for _, e in op.groupings),
                tuple(a.agg.args[0] if a.agg.args else None for a in op.aggs))
            self._kernel = fused_agg_kernel(self.fused)
        self._joins = {}  # device -> the fused joins' K18 inputs
        self.group_ev = ExprEvaluator([e for _, e in op.groupings], child_schema)
        self.agg_evs = [ExprEvaluator(list(a.agg.args), child_schema)
                        if a.agg.args else None for a in op.aggs]
        self.fns = [aggfns.create_agg_function(a.agg, child_schema)
                    for a in op.aggs]
        # K19's argument words, packed once for the task's skipped batches
        self._pass_pack = K.PassthroughPack()
        self.specs = []
        for fn in self.fns:
            if fn.device_kind in aggfns.LIMB_KINDS:
                # the limb layouts keep the argument's scale (ir/aggstate.py)
                self.specs.append((fn.device_kind, 0, "int64"))
                continue
            rescale = 0
            if isinstance(fn.arg_type, T.DecimalType):
                target = fn.sum_type if fn.kind == "avg" else fn.result_type
                if isinstance(target, T.DecimalType) and fn.kind in ("sum", "avg"):
                    rescale = target.scale - fn.arg_type.scale
            if rescale < 0:
                _not_ported(f"a {fn.kind} into a smaller decimal scale")
            state_t = fn.sum_type if fn.kind == "avg" else fn.result_type
            acc = "float64" if aggfns.is_float(state_t) else "int64"
            self.specs.append((fn.kind, rescale, acc))
        self.float_states = any(acc == "float64" for _, _, acc in self.specs)
        # slot-route state: _dense_ok/_radix_ok None = undecided, False =
        # off for this stream; _bucket_state the active plan
        self._dense_ok = self._radix_ok = None
        self._bucket_state = None
        # while a partial skipper listens (ops/agg.py sets it), each radix
        # batch publishes its per-bucket (rows, groups) histogram as numpy
        # planes (the reference's ``_note_radix``); None for any other batch
        self.histograms = False
        self.last_bucket_stats = None

    def _keys(self, batch: ColumnarBatch, exists: torch.Tensor):
        key_data, key_valid = [], []
        for _, e in self.op.groupings:
            d, v = broadcast(self.group_ev.eval(e, batch), batch)
            key_data.append(d)
            key_valid.append(v & exists)
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
        """``_plan_bucketed``: ("dense"|"radix", bases, sizes, out_cap),
        _DEFER_PLAN, or None when no enabled table fits."""
        if self._dense_ok:
            st = plan_slot_table(probe, capacity, prev,
                                 min(self.conf.dense_agg_max_buckets, capacity),
                                 self.conf)
            if st is _DEFER_PLAN:
                return st
            if st is not None:
                return ("dense",) + st
        if self._radix_ok:
            st = plan_slot_table(probe, capacity, prev,
                                 self.conf.radix_agg_max_slots, self.conf)
            if st is _DEFER_PLAN:
                return st
            if st is not None:
                return ("radix",) + st
        return None

    def _fused_input(self, batch: ColumnarBatch):
        """K18 over the batch: (key data, key valid, args, live). The joins'
        build maps (sorted words on the device, nk, build columns, rank
        route) are gathered once a device; a COUNT(*) reads a shared zero
        plane (``_zero_plane``)."""
        if not all(isinstance(c, (DeviceColumn, WideColumn)) for c in batch.columns):
            raise ValueError("a fused aggregate takes batches of device and wide-decimal "
                             f"columns; got {[type(c).__name__ for c in batch.columns]}")
        dev = batch.device
        joins = self._joins.get(dev)
        if joins is None:
            joins = self._joins[dev] = [
                (bmap.device_keys(dev), len(bmap.sorted_keys), bmap.batch.columns,
                 bmap.join_rank()) for _, bmap in self.fused_joins]
        keys, args, live = K.fused_agg_input(self.fused, batch.columns, batch.num_rows,
                                             joins, self._kernel)
        args = [(_zero_plane(batch.capacity, dev), live) if a is None else a for a in args]
        return [d for d, _ in keys], [v for _, v in keys], args, live

    def process(self, batch: ColumnarBatch) -> Optional[ColumnarBatch]:
        n = batch.num_rows
        if n == 0:
            return None
        live = None  # the rows below n exist
        if self.fused is not None:
            key_data, key_valid, args, live = self._fused_input(batch)
        else:
            exists = batch.row_exists_mask()
            key_data, key_valid = self._keys(batch, exists)
            args = self._args(batch, exists)
        if self._dense_ok is None:
            ints = _int_keys(key_data)
            self._dense_ok = ints and _route_on(self.conf.dense_agg)
            self._radix_ok = ints and _route_on(self.conf.radix_agg)
        outs = self._try_slots(key_data, key_valid, args, n, batch.capacity, live)
        if outs is None:
            outs = seg_agg_partial(key_data, key_valid, n, self.specs, args, exists=live)
        num_groups = int(outs[0])
        return self._assemble(outs, num_groups) if num_groups else None

    def _try_slots(self, key_data, key_valid, args, n, capacity, live=None):
        """``_try_dense``: the slot route's outputs, or None for the sort
        route."""
        self.last_bucket_stats = None
        if not (self._dense_ok or self._radix_ok):
            return None
        st = self._bucket_state
        prev = None
        for _ in range(2):
            if st is None:
                st = self._plan(probe_ranges(key_data, key_valid), capacity, prev)
                if st is _DEFER_PLAN:
                    # no valid key to anchor a plan: the sort route for this
                    # batch, a fresh probe on the next one
                    self._bucket_state = None
                    return None
                if st is None:
                    # too wide for every enabled table: the sort route for
                    # the rest of the stream
                    self._dense_ok = self._radix_ok = False
                    self._bucket_state = None
                    return None
                self._bucket_state = st
            outs, hist = self._call(st, key_data, key_valid, n, capacity, args, live)
            if int(outs[0]) >= 0:  # the sync; -1 flags a range overflow
                self.last_bucket_stats = hist
                return outs
            prev, st = (st[1], st[2]), None
        self._bucket_state = None
        return None

    def _call(self, st, key_data, key_valid, n, capacity, args, live):
        """The slot route's outputs over the plan ``st`` and, while a skipper
        listens on a radix plan, the batch's (rows, groups) histogram on the
        host (else None). The plan's ``out_cap`` was sized from the batch
        that made it; a later batch of a larger capacity can hold more
        groups, so the outputs take this batch's bound where it is larger."""
        table, bases, sizes, out_cap = st
        out_cap = max(out_cap, self.conf.capacity_for(min(_slots(sizes), capacity)))
        nbuck = self.conf.radix_agg_buckets if table == "radix" else 0
        listen = self.histograms and nbuck > 0
        dtypes = [d.dtype for d in key_data]
        if self.float_states:
            # K10 in the slot order; the plan still decides the route. A
            # listener's histogram comes from K3 without aggregates, whose
            # count also says whether the keys fit the plan
            hist = None
            if listen:
                head = slot_agg_partial(key_data, key_valid, dtypes, n, bases, sizes, (), (),
                                        out_cap, nbuck, live, host_head=True)
                if head[0] < 0:
                    return (-1,), None
                hist = head[-2:]
            elif not _slot_fits(key_data, key_valid, n, bases, sizes):
                return (-1,), None
            return seg_agg_partial(key_data, key_valid, n, self.specs, args,
                                   direct=False, exists=live), hist
        outs = slot_agg_partial(key_data, key_valid, dtypes, n, bases, sizes, self.specs,
                                args, out_cap, nbuck, live, host_head=listen)
        if not nbuck:
            return outs, None
        return outs[:-2], (tuple(outs[-2:]) if listen else None)

    def passthrough(self, batch: ColumnarBatch) -> Optional[ColumnarBatch]:
        """A skipped partial's batch (blaze_tpu/ops/agg_device.py:933): one
        singleton partial-state group per existing row, keys and states in
        place, through K19; the group count is the row count, so no sync.
        Keys and arguments are evaluated as ``process`` evaluates them
        unfused: valid only when ``fused`` is None (the caller gates it)."""
        n = batch.num_rows
        if n == 0:
            return None
        exists = batch.row_exists_mask()
        key_data, key_valid = self._keys(batch, exists)
        ops, emits = _partial_program(self.specs, self._args(batch, exists))
        outs = K.passthrough_states(key_data, key_valid, exists, n, ops, emits,
                                    self._pass_pack)
        return self._assemble(outs, n)

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
            if fn.device_kind in aggfns.LIMB_KINDS:
                # every state plane valid on the groups (``_assemble``)
                for _, dt in fn.state_fields():
                    cols.append(DeviceColumn(dt, outs[pos], out_valid))
                    pos += 1
            elif fn.kind == "sum":
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
    """Merges partial-state batches: concatenate all input (states are small
    next to raw rows), then K4 over a radix plan where ``radix_agg`` is on
    and the integer keys fit one, else K10 (``DeviceMergeAgger.run`` and
    ``_radix_plan`` of the JAX package); merged state columns
    (PARTIAL_MERGE) or final values (FINAL)."""

    def __init__(self, op, child_schema: T.Schema, conf):
        self.op = op
        self.child_schema = child_schema
        self.conf = conf
        self.fns = op.make_fns(child_schema)
        self.kinds = tuple(fn.device_kind for fn in self.fns)

    def run(self, batches: List[ColumnarBatch]) -> List[ColumnarBatch]:
        op = self.op
        batches = [b for b in batches if b.num_rows]
        if not batches:
            return []
        big = ColumnarBatch.concat(batches, self.child_schema, self.conf)
        n = big.num_rows
        exists = big.row_exists_mask()
        ev = ExprEvaluator([e for _, e in op.groupings], big.schema)
        key_data, key_valid = [], []
        for _, e in op.groupings:
            d, v = broadcast(ev.eval(e, big), big)
            key_data.append(d)
            key_valid.append(v & exists)
        states = []
        pos = len(op.groupings)
        for fn in self.fns:
            cols = []
            for _ in fn.state_fields():
                c = big.columns[pos]
                cols.append((c.data, c.validity & exists))
                pos += 1
            states.append(cols)
        float_states = any(d.is_floating_point() for cols in states for d, _ in cols)
        outs = None
        st = None
        if _route_on(self.conf.radix_agg) and _int_keys(key_data):
            st = plan_slot_table(probe_ranges(key_data, key_valid), big.capacity,
                                 None, self.conf.radix_agg_max_slots, self.conf)
        if st is not None and st is not _DEFER_PLAN:
            bases, sizes, out_cap = st
            if float_states:
                outs = seg_agg_merge(key_data, key_valid, n, self.kinds, states,
                                     direct=False)
            else:
                outs = slot_agg_merge(key_data, key_valid,
                                      [d.dtype for d in key_data], n, bases, sizes,
                                      self.kinds, states, out_cap)
                if int(outs[0]) < 0:
                    # a probe/pack disagreement: the reference's sort fallback
                    outs = None
        if outs is None:
            outs = seg_agg_merge(key_data, key_valid, n, self.kinds, states)
        num_groups = int(outs[0])
        if num_groups == 0:
            return []
        out_valid = outs[1]
        out_cap = out_valid.shape[0]
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
