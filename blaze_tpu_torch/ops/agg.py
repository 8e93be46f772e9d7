"""Hash aggregation: ``AggExec`` and the host aggregation table.

Counterpart of blaze_tpu/ops/agg.py. ``AggExec._execute`` routes as the
reference does (``:164-400``):

- PARTIAL over raw rows, grouped, every function one of the device
  aggregates: per-batch partial states from the slot route (K3) or the
  sort route (K10), as ``DevicePartialAgger`` routes each batch, then
  per-task consolidation of the staged partials (PARTIAL_MERGE) when they
  are few and reducing, as the JAX package does before the exchange;
- FINAL / PARTIAL_MERGE over partial states, grouped, every function a
  device aggregate: one merge of every staged state batch
  (``DeviceMergeAgger``: K4 over a radix plan, else K10), unless the
  staged input passes ``device_merge_max_bytes``: then the staged batches
  and the rest of the stream go to the host table;
- everything else (no grouping keys, COMPLETE mode, FIRST, a grouping
  without aggregates): the host table, ``AggTable``.

``AggTable`` interns the group keys on the host (one pull of the key
planes a batch, ``np.unique`` over the packed (value, validity) words,
slot numbers in the reference's order) and keeps each aggregate's state
in slot tables on the device, which K12 (``core/kernels.py
slot_update``) updates once a batch for all aggregates. Groups come out in
slot order (first seen first), ``batch_size`` rows a batch.

Not ported (NotImplementedError, ROADMAP.md Queue 1): sort-mode
aggregation with grouping keys (``_execute_sorted_impl``), the table's
spill under the memory manager (item 11), its partial skipping (the
passthrough of ``AggTable.passthrough_batch``; the table never skips, and
``supports_partial_skipping`` is accepted and never engages on the device
route either: Queue 2 row 9), and host-resident key columns (item 6).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn, iota
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.aggstate import (_arg_type_from_state,
                                         agg_output_schema, parse_state_mode)
from blaze_tpu_torch.ops import aggfns
from blaze_tpu_torch.ops.agg_device import DeviceMergeAgger, DevicePartialAgger
from blaze_tpu_torch.ops.base import Operator

# the aggregates the device routes take (blaze_tpu/ops/agg_device.py:50)
_DEVICE_AGG_FNS = (E.AggFunction.SUM, E.AggFunction.COUNT, E.AggFunction.AVG,
                   E.AggFunction.MIN, E.AggFunction.MAX)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md {item})")


class _SchemaSource(Operator):
    def __init__(self, schema):
        super().__init__(schema, [])


class AggExec(Operator):
    def __init__(self, child: Operator, exec_mode: E.AggExecMode,
                 groupings: List[Tuple[str, E.Expr]], aggs: List,
                 supports_partial_skipping: bool = False):
        self.exec_mode = exec_mode
        self.groupings = groupings
        self.aggs = aggs  # list of nodes.AggColumn
        self.supports_partial_skipping = supports_partial_skipping
        schema = agg_output_schema(child.schema, groupings, aggs,
                                   self.input_is_partial, self.is_partial_output)
        super().__init__(schema, [child])

    @property
    def is_partial_output(self) -> bool:
        return bool(self.aggs) and all(
            a.mode in (E.AggMode.PARTIAL, E.AggMode.PARTIAL_MERGE) for a in self.aggs)

    @property
    def input_is_partial(self) -> bool:
        return bool(self.aggs) and all(
            a.mode in (E.AggMode.PARTIAL_MERGE, E.AggMode.FINAL) for a in self.aggs)

    def make_fns(self, child_schema: T.Schema) -> List[aggfns.AggFunction]:
        if not self.input_is_partial:
            return [aggfns.create_agg_function(a.agg, child_schema)
                    for a in self.aggs]
        # merge mode: the arg type comes back from the partial state
        # fields, which follow the groupings in declaration order
        fns = []
        pos = len(self.groupings)
        for a in self.aggs:
            if parse_state_mode(child_schema[pos].name) is not None:
                _not_ported("a wide-decimal (limb) aggregate state", "Queue 1 item 2")
            arg = _arg_type_from_state(a.agg, child_schema, pos)
            agg = a.agg
            if agg.args:
                agg = E.AggExpr(agg.fn, [E.Column("arg")], agg.return_type, agg.udaf)
            fn = aggfns.create_agg_function(
                agg, T.Schema((T.StructField("arg", arg),)))
            pos += len(fn.state_fields())
            fns.append(fn)
        return fns

    def _consolidation_op(self) -> "AggExec":
        """A PARTIAL_MERGE view of this PARTIAL agg over its own output."""
        return AggExec(
            _SchemaSource(self.schema), self.exec_mode,
            [(name, E.Column(name)) for name, _ in self.groupings],
            [dataclasses.replace(a, mode=E.AggMode.PARTIAL_MERGE)
             for a in self.aggs])

    def _device_fns(self) -> bool:
        return bool(self.groupings) and all(a.agg.fn in _DEVICE_AGG_FNS
                                            for a in self.aggs)

    def _execute(self, partition, ctx):
        child_schema = self.children[0].schema
        hash_agg = self.exec_mode == E.AggExecMode.HASH_AGG
        if hash_agg and self.is_partial_output and not self.input_is_partial \
                and self._device_fns():
            yield from self._execute_partial(partition, ctx, child_schema)
        elif hash_agg and self.input_is_partial and self._device_fns():
            yield from self._execute_merge(partition, ctx, child_schema)
        elif not hash_agg and self.groupings:
            _not_ported("sort-mode aggregation", "Queue 1 item 3")
        else:
            yield from self._execute_table(partition, ctx, child_schema)

    def _execute_partial(self, partition, ctx, child_schema):
        agger = DevicePartialAgger(self, child_schema, ctx.conf)
        staged: List[ColumnarBatch] = []
        staged_bytes = staged_rows = input_rows = 0
        gave_up = False
        for batch in self.execute_child(0, partition, ctx):
            input_rows += batch.num_rows
            out = agger.process(batch)
            if out is None or not out.num_rows:
                continue
            if gave_up:
                yield out
                continue
            staged.append(out)
            staged_bytes += out.nbytes()
            staged_rows += out.num_rows
            if staged_bytes > ctx.conf.device_merge_max_bytes:
                gave_up = True
                yield from staged
                staged = []
        # per-task consolidation (blaze_tpu/ops/agg.py): a few reducing
        # partials merge into one state batch before the exchange
        if len(staged) > 1 and staged_rows <= ctx.conf.batch_size and \
                input_rows and staged_rows < 0.9 * input_rows:
            merge_op = self._consolidation_op()
            staged = DeviceMergeAgger(merge_op, self.schema, ctx.conf).run(staged)
        for o in staged:
            if o.num_rows:
                yield o

    def _execute_merge(self, partition, ctx, child_schema):
        """One device merge of the staged state batches; past
        ``device_merge_max_bytes`` the staged batches and the rest of the
        stream go to the host table (the reference's ``:389``)."""
        staged = []
        staged_bytes = 0
        src = self.execute_child(0, partition, ctx)
        for b in src:
            staged.append(b)
            staged_bytes += b.nbytes()
            if staged_bytes > ctx.conf.device_merge_max_bytes:
                yield from self._execute_table(partition, ctx, child_schema,
                                               itertools.chain(staged, src))
                return
        for out in DeviceMergeAgger(self, child_schema, ctx.conf).run(staged):
            if out.num_rows:
                yield out

    def _execute_table(self, partition, ctx, child_schema, child_iter=None):
        table = AggTable(self, child_schema, ctx)
        if child_iter is None:
            child_iter = self.execute_child(0, partition, ctx)
        for batch in child_iter:
            table.process_batch(batch)
        yield from table.output()


class AggTable:
    """The host aggregation table (blaze_tpu/ops/agg.py:545), without spill:
    group keys interned on the host into dense slot ids, each aggregate's
    state in device slot tables of ``capacity`` rows (1024, doubling)."""

    def __init__(self, op: AggExec, child_schema: T.Schema, ctx):
        self.op = op
        self.ctx = ctx
        self.device = ctx.device
        self.fns = op.make_fns(child_schema)
        if op.input_is_partial:
            self.group_ev = None
            self.agg_evs = None
        else:
            self.group_ev = ExprEvaluator([e for _, e in op.groupings], child_schema)
            self.agg_evs = [ExprEvaluator(list(a.agg.args), child_schema)
                            if a.agg.args else None for a in op.aggs]
        self.state_pos = []
        pos = len(op.groupings)
        for fn in self.fns:
            k = len(fn.state_fields())
            self.state_pos.append((pos, pos + k))
            pos += k
        self.capacity = 1024
        self.states = [fn.init_state(self.capacity, self.device) for fn in self.fns]
        self.num_slots = 0
        self.row_order = 0
        # the known keys: their packed (value, validity) rows as np.void,
        # sorted, beside their slots; and each slot's key row, by slot
        self._known: Optional[np.ndarray] = None
        self._known_slot = np.zeros(0, np.int64)
        self._slot_keys: List[np.ndarray] = []
        # K12's argument arrays, one pack per launch's share of the op list
        self._packs: Dict[int, K.SlotUpdatePack] = {}

    # -- key interning ------------------------------------------------------------

    def _grouping_planes(self, batch: ColumnarBatch):
        if self.op.input_is_partial:
            cols = batch.columns[:len(self.op.groupings)]
            return [(c.data, c.validity) for c in cols]
        return [broadcast(self.group_ev.eval(e, batch), batch)
                for _, e in self.op.groupings]

    @staticmethod
    def _key_words(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """A key plane as the reference packs it (``_intern_keys`` :620-628):
        int64 words, null rows 0, floats as their bits (float32 bits
        sign-extended), so -0.0 and 0.0, and NaNs of different payloads,
        are different keys."""
        if data.dtype == torch.float64:
            return torch.where(valid, data, 0.0).view(torch.int64)
        if data.dtype == torch.float32:
            return torch.where(valid, data, 0.0).view(torch.int32).to(torch.int64)
        return torch.where(valid, data.to(torch.int64), 0)

    def _intern_keys(self, batch: ColumnarBatch) -> np.ndarray:
        """Each live row's slot id ((num_rows,) int64). The key planes come
        to the host in one pull; ``np.unique`` over their packed rows, as in
        the reference; the batch's distinct keys are looked up among the
        known ones with one ``searchsorted``, and the new ones get the next
        slots in ``np.unique``'s order, which is the reference's loop
        order (``:698-714``), so the slot numbers are the reference's."""
        n = batch.num_rows
        if not self.op.groupings:  # global aggregate: one slot
            if self.num_slots == 0:
                self.num_slots = 1
                self._ensure_capacity(1)
            return np.zeros(n, dtype=np.int64)
        words = []
        for data, valid in self._grouping_planes(batch):
            words += [self._key_words(data[:n], valid[:n]), valid[:n].to(torch.int64)]
        mat = np.ascontiguousarray(torch.stack(words, 1).cpu().numpy())
        view = mat.view(np.dtype((np.void, mat.dtype.itemsize * mat.shape[1]))).ravel()
        uniq, inverse = np.unique(view, return_inverse=True)
        lut = np.empty(len(uniq), dtype=np.int64)
        found = np.zeros(len(uniq), dtype=bool)
        if self._known is not None:
            pos = np.searchsorted(self._known, uniq)
            inb = pos < len(self._known)
            found[inb] = self._known[pos[inb]] == uniq[inb]
            lut[found] = self._known_slot[pos[found]]
        new = ~found
        k = int(new.sum())
        if k:
            slots = np.arange(self.num_slots, self.num_slots + k, dtype=np.int64)
            lut[new] = slots
            if self._known is None:
                self._known, self._known_slot = uniq[new], slots
            else:
                at = pos[new]
                self._known = np.insert(self._known, at, uniq[new])
                self._known_slot = np.insert(self._known_slot, at, slots)
            self._slot_keys.append(uniq[new].view(np.int64).reshape(k, mat.shape[1]))
            self.num_slots += k
            self._ensure_capacity(self.num_slots)
        return lut[inverse.reshape(-1)]

    def _ensure_capacity(self, n: int):
        if n <= self.capacity:
            return
        while self.capacity < n:
            self.capacity *= 2
        self.states = [fn.grow(st, self.capacity) for fn, st in zip(self.fns, self.states)]

    # -- accumulation -------------------------------------------------------------

    def process_batch(self, batch: ColumnarBatch):
        n = batch.num_rows
        if n == 0:
            return
        slots_np = self._intern_keys(batch)
        cap = batch.capacity
        slots = torch.full((cap,), self.capacity, dtype=torch.int64)
        slots[:n] = torch.from_numpy(slots_np)
        slots = slots.to(self.device)
        mask = batch.row_exists_mask()
        ops = []
        for i, fn in enumerate(self.fns):
            if self.op.input_is_partial:
                lo, hi = self.state_pos[i]
                ops += fn.merge_ops(self.states[i], batch.columns[lo:hi])
                continue
            ev, a = self.agg_evs[i], self.op.aggs[i]
            if ev is None:  # count(*)
                ops += fn.update_ops(self.states[i], None, None)
                continue
            data, validity = broadcast(ev.eval(a.agg.args[0], batch), batch)
            order = iota(cap, self.device) + self.row_order \
                if isinstance(fn, aggfns.FirstAgg) else None
            ops += fn.update_ops(self.states[i], data, validity, order)
        for at in range(0, len(ops), K._MAX_UPD_OPS):
            pack = self._packs.setdefault(at, K.SlotUpdatePack())
            K.slot_update(slots, mask, ops[at:at + K._MAX_UPD_OPS], pack)
        self.row_order += n

    # -- output -------------------------------------------------------------------

    def _key_columns(self, rows: np.ndarray, cap: int) -> List[DeviceColumn]:
        """Key columns of ``cap`` rows rebuilt from slots' packed words."""
        cols = []
        for ci in range(len(self.op.groupings)):
            dt = self.op.schema[ci].dtype
            data = np.ascontiguousarray(rows[:, 2 * ci])
            if isinstance(dt, T.Float64Type):
                data = data.view(np.float64)
            elif isinstance(dt, T.Float32Type):
                data = data.astype(np.int32).view(np.float32)
            cols.append(DeviceColumn.from_numpy(dt, data, rows[:, 2 * ci + 1].astype(bool),
                                                cap, self.device))
        return cols

    def _emit(self, partial: bool) -> Iterator[ColumnarBatch]:
        ns = self.num_slots
        if ns == 0:
            if not self.op.groupings and not partial:
                yield self._global_empty_row()
            return
        agg_cols: List[DeviceColumn] = []
        for fn, st in zip(self.fns, self.states):
            if partial:
                agg_cols.extend(fn.state_columns(st, ns, self.capacity))
            else:
                agg_cols.append(fn.final_column(st, ns, self.capacity))
        keys = np.concatenate(self._slot_keys) if self.op.groupings else None
        bs = self.ctx.conf.batch_size
        for off in range(0, ns, bs):
            length = min(bs, ns - off)
            yield self._assemble(keys, agg_cols, off, length)

    def _assemble(self, keys: Optional[np.ndarray], agg_cols: List[DeviceColumn],
                  off: int, length: int) -> ColumnarBatch:
        """Slots [off, off + length) as one batch (``_assemble`` :1191): key
        columns from the host, the state columns' rows by K7's slice."""
        cap = self.ctx.conf.capacity_for(length)
        cols = [] if keys is None else self._key_columns(keys[off:off + length], cap)
        if agg_cols:
            datas, valids = K.slice_planes([c.data for c in agg_cols],
                                           [c.validity for c in agg_cols], off, length, cap)
            cols += [DeviceColumn(c.dtype, d, v) for c, d, v in zip(agg_cols, datas, valids)]
        return ColumnarBatch(self.op.schema, cols, length)

    def _global_empty_row(self) -> ColumnarBatch:
        """A global aggregate over empty input: one row of initial state."""
        return self._assemble(None, [fn.final_column(st, 1, self.capacity)
                                     for fn, st in zip(self.fns, self.states)], 0, 1)

    def output(self) -> Iterator[ColumnarBatch]:
        yield from self._emit(partial=self.op.is_partial_output)
