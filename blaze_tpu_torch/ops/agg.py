"""Hash aggregation: the ``AggExec`` dispatch of the slice.

Counterpart of blaze_tpu/ops/agg.py ``AggExec._execute`` for its device
paths:

- PARTIAL over raw rows: per-batch partial states from K3
  (``DevicePartialAgger``), then per-task consolidation of the staged
  partials with K4 (PARTIAL_MERGE) when they are few and reducing, as the
  JAX package does before the exchange;
- FINAL / PARTIAL_MERGE over partial states: one K4 merge of every staged
  state batch (``DeviceMergeAgger``).

Not ported (NotImplementedError, ROADMAP.md Queue 2): the host ``AggTable``
with spill, sort-mode aggregation, aggregates without grouping keys,
single-stage COMPLETE mode and the passthrough kernel of partial skipping
(``supports_partial_skipping`` is accepted and never engages).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.aggstate import (_arg_type_from_state,
                                         agg_output_schema, parse_state_mode)
from blaze_tpu_torch.ops import aggfns
from blaze_tpu_torch.ops.agg_device import DeviceMergeAgger, DevicePartialAgger
from blaze_tpu_torch.ops.base import Operator


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md Queue 2 "
        "item 6)")


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
                _not_ported("a wide-decimal (limb) aggregate state")
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

    def _execute(self, partition, ctx):
        if self.exec_mode != E.AggExecMode.HASH_AGG:
            _not_ported("sort-mode aggregation")
        if not self.groupings:
            _not_ported("aggregation without grouping keys")
        child_schema = self.children[0].schema
        if self.input_is_partial:
            yield from self._execute_merge(partition, ctx, child_schema)
        elif self.is_partial_output:
            yield from self._execute_partial(partition, ctx, child_schema)
        else:
            _not_ported("single-stage (COMPLETE) aggregation")

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
        staged = []
        staged_bytes = 0
        for b in self.execute_child(0, partition, ctx):
            staged.append(b)
            staged_bytes += b.nbytes()
            if staged_bytes > ctx.conf.device_merge_max_bytes:
                _not_ported("a merge input beyond device_merge_max_bytes (the "
                            "spilling host table)")
        for out in DeviceMergeAgger(self, child_schema, ctx.conf).run(staged):
            if out.num_rows:
                yield out
