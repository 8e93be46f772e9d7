"""Streaming operators of the slice: project, filter, coalesce.

Counterparts of ProjectExec, FilterExec and CoalesceBatchesExec in
blaze_tpu/ops/basic.py. The filter compacts surviving rows with K1
(core/kernels.compact_planes): one kernel pass and one count sync per
batch.
"""

from __future__ import annotations

from typing import List, Optional

from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops.base import Operator


class ProjectExec(Operator):
    def __init__(self, child: Operator, exprs: List[E.Expr], names: List[str]):
        self.exprs = exprs
        self.names = names
        schema = T.Schema(tuple(
            T.StructField(n, E.infer_type(e, child.schema))
            for n, e in zip(names, exprs)))
        super().__init__(schema, [child])

    def _execute(self, partition, ctx):
        ev = ExprEvaluator(self.exprs, self.children[0].schema)
        for batch in self.execute_child(0, partition, ctx):
            yield ColumnarBatch(self.schema, ev.evaluate(batch), batch.num_rows)


class FilterExec(Operator):
    def __init__(self, child: Operator, predicates: List[E.Expr]):
        self.predicates = predicates
        super().__init__(child.schema, [child])

    def _execute(self, partition, ctx):
        pred_ev = ExprEvaluator(self.predicates, self.children[0].schema)
        for batch in self.execute_child(0, partition, ctx):
            mask = pred_ev.evaluate_predicate(batch)
            count, datas, valids = kernels.compact_planes(
                [c.data for c in batch.columns],
                [c.validity for c in batch.columns], mask)
            if count == 0:
                continue
            if count == batch.num_rows:
                yield batch
                continue
            cols = [DeviceColumn(c.dtype, d, v)
                    for c, d, v in zip(batch.columns, datas, valids)]
            yield ColumnarBatch(batch.schema, cols, count)


class CoalesceBatchesExec(Operator):
    """Merge small batches up to the batch size (0 = conf.batch_size)."""

    def __init__(self, child: Operator, batch_size: Optional[int] = None):
        self.batch_size = batch_size
        super().__init__(child.schema, [child])

    def _execute(self, partition, ctx):
        target = self.batch_size or ctx.conf.batch_size
        staged: List[ColumnarBatch] = []
        staged_rows = 0
        for batch in self.execute_child(0, partition, ctx):
            if batch.num_rows == 0:
                continue
            if batch.num_rows >= target and not staged:
                yield batch
                continue
            staged.append(batch)
            staged_rows += batch.num_rows
            if staged_rows >= target:
                yield ColumnarBatch.concat(staged, self.schema, ctx.conf)
                staged, staged_rows = [], 0
        if staged:
            yield ColumnarBatch.concat(staged, self.schema, ctx.conf)
