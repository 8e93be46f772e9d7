"""Sort: the in-memory full sort and the top-k (fetch limit).

Counterpart of blaze_tpu/ops/sort.py. The sort of a batch is K5 (the key
pass ``sort_key_operands`` and the stable radix sort ``lexsort_indices``,
where the JAX package uses ``lax.sort``) and one K6 gather (``take``).
``SortExec._execute_topk`` stages input until it holds max(4k,
batch_size) rows, then keeps the k first rows of a full sort of (kept
rows + staged rows). Without a fetch limit the partition is sorted whole
in memory and cut into ``batch_size`` slices with K7, as
``_SortState.output`` does when nothing spilled. The spill and the run
merge (``_SortState.spill``, ``_merge_runs_vectorized``) need the memory
manager, which is not ported (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

from typing import List, Optional

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs.compiler import require_narrow_key
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ops import sort_keys as SK
from blaze_tpu_torch.ops.base import Operator


def sort_batch(batch: ColumnarBatch, sort_orders: List[E.SortOrder],
               limit: Optional[int] = None, conf=None) -> ColumnarBatch:
    if batch.num_rows <= 1:
        return batch
    operands = SK.key_operands(batch, sort_orders)
    idx = K.lexsort_indices(operands, batch.num_rows, dead_last=True)[:batch.num_rows]
    if limit is not None:
        idx = idx[:limit]
    return batch.take(idx, conf)


class SortExec(Operator):
    def __init__(self, child: Operator, sort_orders: List[E.SortOrder],
                 fetch_limit: Optional[int] = None):
        self.sort_orders = sort_orders
        self.fetch_limit = fetch_limit
        for so in sort_orders:
            # a bare decimal(19..38) column sorts by its limbs (sort_keys.py);
            # nothing else reads a wide column
            if not (isinstance(so.child, (E.Column, E.BoundReference))):
                require_narrow_key(E.infer_type(so.child, child.schema), "sort key")
        super().__init__(child.schema, [child])

    def _execute(self, partition, ctx):
        if self.fetch_limit is not None:
            yield from self._execute_topk(partition, ctx)
            return
        staged = list(self.execute_child(0, partition, ctx))
        if not staged:
            return
        merged = sort_batch(ColumnarBatch.concat(staged, self.schema, ctx.conf),
                            self.sort_orders, conf=ctx.conf)
        bs = ctx.conf.batch_size
        for off in range(0, merged.num_rows, bs):
            yield merged.slice(off, bs, ctx.conf)

    def _execute_topk(self, partition, ctx):
        k = self.fetch_limit
        if k <= 0:
            return
        step = max(4 * k, ctx.conf.batch_size)
        current: Optional[ColumnarBatch] = None
        staged: List[ColumnarBatch] = []
        staged_rows = 0
        for batch in self.execute_child(0, partition, ctx):
            staged.append(batch)
            staged_rows += batch.num_rows
            if staged_rows >= step:
                current = self._merge(current, staged, k, ctx)
                staged, staged_rows = [], 0
        if staged:
            current = self._merge(current, staged, k, ctx)
        if current is not None and current.num_rows > 0:
            yield current

    def _merge(self, current, staged, k, ctx):
        parts = ([current] if current is not None else []) + staged
        merged = ColumnarBatch.concat(parts, self.schema, ctx.conf)
        return sort_batch(merged, self.sort_orders, limit=k, conf=ctx.conf)
