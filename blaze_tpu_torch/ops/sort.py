"""Sort with an optional fetch limit (top-k).

Counterpart of blaze_tpu/ops/sort.py: ``SortExec._execute_topk`` stages
input until it holds max(4k, batch_size) rows, then keeps the k first rows
of a full sort of (kept rows + staged rows). The sort of a batch is a
lexicographic stable sort over the normalised key operands
(``torch.sort(stable=True)`` per operand, least significant first), where
the JAX package leaves it to ``lax.sort``; a hand-written key sort is
queued (ROADMAP.md Queue 2). A sort without a fetch limit sorts all of
its partition in memory: the spilling run merge is not ported.
"""

from __future__ import annotations

from typing import List, Optional

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ops import sort_keys as SK
from blaze_tpu_torch.ops.base import Operator


def sort_batch(batch: ColumnarBatch, sort_orders: List[E.SortOrder],
               limit: Optional[int] = None, conf=None) -> ColumnarBatch:
    if batch.num_rows <= 1:
        return batch
    idx = K.lexsort_indices(SK.key_operands(batch, sort_orders))[:batch.num_rows]
    if limit is not None:
        idx = idx[:limit]
    return batch.take(idx, conf)


class SortExec(Operator):
    def __init__(self, child: Operator, sort_orders: List[E.SortOrder],
                 fetch_limit: Optional[int] = None):
        self.sort_orders = sort_orders
        self.fetch_limit = fetch_limit
        super().__init__(child.schema, [child])

    def _execute(self, partition, ctx):
        k = self.fetch_limit
        if k is not None and k <= 0:
            return
        step = max(4 * k, ctx.conf.batch_size) if k is not None else None
        current: Optional[ColumnarBatch] = None
        staged: List[ColumnarBatch] = []
        staged_rows = 0
        for batch in self.execute_child(0, partition, ctx):
            staged.append(batch)
            staged_rows += batch.num_rows
            if step is not None and staged_rows >= step:
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
