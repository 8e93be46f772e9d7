"""Streaming operators: project, filter, coalesce, rename, expand.

Counterparts of ProjectExec, FilterExec, CoalesceBatchesExec,
RenameColumnsExec and ExpandExec in blaze_tpu/ops/basic.py: the unfused
forms, which ``Config(fusion_enabled=False)`` builds and the fusion pass
leaves where a chain is not worth fusing. The filter compacts surviving
rows with K1 (core/kernels.compact_planes): one kernel pass and one count
sync per batch.
"""

from __future__ import annotations

from typing import List, Optional

from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import ColumnarBatch, column_planes, columns_from_planes
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
                *column_planes(batch.columns), mask)
            if count == 0:
                continue
            if count == batch.num_rows:
                yield batch
                continue
            yield ColumnarBatch(batch.schema,
                                columns_from_planes(batch.schema.types, datas, valids),
                                count)


class CoalesceBatchesExec(Operator):
    """Merge small batches up to the batch size (0 = conf.batch_size)."""

    def __init__(self, child: Operator, batch_size: Optional[int] = None):
        self.batch_size = batch_size
        super().__init__(child.schema, [child])

    def _execute(self, partition, ctx):
        yield from coalesce_stream(self.execute_child(0, partition, ctx), self.schema,
                                   self.batch_size or ctx.conf.batch_size, ctx.conf)


def coalesce_stream(stream, schema: T.Schema, target: int, conf):
    """Stage a stream's batches until they hold ``target`` rows, then emit
    their concatenation; a batch of ``target`` rows or more with nothing
    staged passes through, empty batches are dropped. Also the fused
    stage's coalesce between segments (ops/fused.py)."""
    staged: List[ColumnarBatch] = []
    staged_rows = 0
    for batch in stream:
        if batch.num_rows == 0:
            continue
        if batch.num_rows >= target and not staged:
            yield batch
            continue
        staged.append(batch)
        staged_rows += batch.num_rows
        if staged_rows >= target:
            yield ColumnarBatch.concat(staged, schema, conf)
            staged, staged_rows = [], 0
    if staged:
        yield ColumnarBatch.concat(staged, schema, conf)


class RenameColumnsExec(Operator):
    """Zero-copy schema rename."""

    def __init__(self, child: Operator, names: List[str]):
        self.names = names
        super().__init__(child.schema.rename(names), [child])

    def _execute(self, partition, ctx):
        for batch in self.execute_child(0, partition, ctx):
            yield ColumnarBatch(self.schema, batch.columns, batch.num_rows)


class ExpandExec(Operator):
    """Grouping-sets expansion: each input batch emits one output batch per
    projection list."""

    def __init__(self, child: Operator, projections: List[List[E.Expr]],
                 schema: T.Schema):
        self.projections = projections
        super().__init__(schema, [child])

    def _execute(self, partition, ctx):
        evs = [ExprEvaluator(p, self.children[0].schema) for p in self.projections]
        for batch in self.execute_child(0, partition, ctx):
            for ev in evs:
                yield ColumnarBatch(self.schema, ev.evaluate(batch), batch.num_rows)
