"""The driver session of the PyTorch port.

``Session(device=None)`` runs on the card (``cuda``); ``device="cpu"``
runs every kernel's plain PyTorch version on the CPU (the tests); with no
GPU and no explicit ``"cpu"`` it raises (utils/device.py).

``execute(plan)`` follows blaze_tpu/runtime/session.py for the slice:
exchanges are lowered bottom-up, each running its map stage eagerly and
in-process (map tasks in partition order on the driver thread), then the
remaining tree is built and its partitions streamed in order. The exchange
is the device tier of the JAX package (``_shuffle_tier`` = "device"):
mapped sub-batches stay on the device, referenced per reducer, with no
serialisation. Map outputs are coalesced like the JAX writer
(>= 32768 rows before a bucketize pass), adjacent small reducers merge
into one read task (AQE, ``advisory_partition_bytes``), and a
single-partition exchange is a collect in map order. A broadcast
exchange is the same collect, read by every task as one partition
(``_run_broadcast_collect``). Each query also gets the broadcast join's
build-map cache (ops/joins/bhj.py ``BUILD_MAPS``), dropped with the
query's other resources. Reducers never merge below a partition-
zipping node (a hash join pairs partition i of both sides): a top-down
flag carried through the lowering, as in the JAX package. A range
exchange without bounds (Spark's plan for a global ORDER BY) first runs
its child once to sample them (``_sample_range_bounds``), then again to
map it. The file and remote shuffle tiers and worker pools are not
ported (ROADMAP.md Queue 1 items 11, 12 and 13).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional

import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core.batch import ColumnarBatch, host_column_error
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.joins.bhj import BUILD_MAPS
from blaze_tpu_torch.ops.shuffle.repartitioner import create_repartitioner
from blaze_tpu_torch.ops.sort_keys import host_key_part
from blaze_tpu_torch.runtime.executor import build_operator
from blaze_tpu_torch.utils.device import resolve_device

# rows a map task accumulates before a bucketize pass (the JAX shuffle
# writer's small-batch coalescing)
_COALESCE_MIN_ROWS = 32768


class Session:
    def __init__(self, conf: Optional[Config] = None, device=None):
        self.conf = conf or Config()
        self.device: torch.device = resolve_device(device)
        self.resources: Dict[str, object] = {}
        self._stage_ids = itertools.count()
        self._query_rids: List[str] = []
        self._zip_ok = True

    # -- public API -----------------------------------------------------------

    def execute(self, plan: N.PlanNode) -> Iterator[ColumnarBatch]:
        """Run a plan, yielding the result batches (final-stage partitions in
        order). Exchange outputs are released when the stream ends."""
        self._query_rids = [BUILD_MAPS]
        self.resources[BUILD_MAPS] = {}
        try:
            op = build_operator(self._lower(plan), self.conf)
            for p in range(op.num_partitions()):
                yield from op.execute(p, self._ctx())
        finally:
            for rid in self._query_rids:
                self.resources.pop(rid, None)
            self._query_rids = []

    def execute_to_pydict(self, plan: N.PlanNode) -> dict:
        """Python values per output column, in the shape of the JAX
        package's ``Session.execute_to_pydict``."""
        out = {name: [] for name in plan.output_schema.names}
        for b in self.execute(plan):
            if b.num_rows:
                for name, vals in b.to_pydict().items():
                    out[name].extend(vals)
        return out

    def close(self):
        self.resources.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- lowering -------------------------------------------------------------

    def _ctx(self) -> ExecContext:
        return ExecContext(self.conf, self.device, self.resources)

    def _lower(self, node: N.PlanNode) -> N.PlanNode:
        # top-down flag: may the exchanges below merge reducers? Not under
        # a partition-zipping node (blaze_tpu/runtime/session.py _lower)
        prev_zip_ok = self._zip_ok
        self._zip_ok = _child_zip_ok(node, prev_zip_ok)
        try:
            node = N.map_children(node, self._lower)
        finally:
            self._zip_ok = prev_zip_ok
        if isinstance(node, N.Sort) and isinstance(node.child, N.CoalesceBatches):
            # Sort stages its whole input; a reducer coalesce below it
            # gathers the same rows twice
            node = dataclasses.replace(node, child=node.child.child)
        if isinstance(node, N.ShuffleExchange):
            return self._run_exchange(node)
        if isinstance(node, N.BroadcastExchange):
            return self._run_broadcast_collect(node)
        return node

    def _register(self, provider) -> str:
        rid = f"exchange_{next(self._stage_ids)}"
        self.resources[rid] = provider
        self._query_rids.append(rid)
        return rid

    def _collect(self, child: N.PlanNode) -> str:
        """Run every partition of ``child`` in partition order and register
        its batches as a one-partition resource; returns its id."""
        child_op = build_operator(child, self.conf)
        blocks = [b for m in range(child_op.num_partitions())
                  for b in child_op.execute(m, self._ctx())]
        return self._register(lambda p, _b=blocks: _b)

    def _run_broadcast_collect(self, node: N.BroadcastExchange) -> N.PlanNode:
        """The child's batches collected in partition order and read whole
        by every task (the device tier's counterpart of
        blaze_tpu/runtime/session.py:_run_broadcast_collect)."""
        _require_device_planes(node.child.output_schema)
        return N.BatchSource(node.child.output_schema, self._collect(node.child), 1)

    def _run_exchange(self, node: N.ShuffleExchange) -> N.PlanNode:
        schema = node.child.output_schema
        _require_device_planes(schema)
        part = node.partitioning
        if isinstance(part, N.RangePartitioning) and not part.bounds and \
                part.num_partitions > 1:
            part = self._sample_range_bounds(node)
        if isinstance(part, N.SinglePartitioning) and part.num_partitions == 1:
            # a single-reducer exchange is a collect, assembled in map order
            return N.CoalesceBatches(N.BatchSource(schema, self._collect(node.child), 1),
                                     batch_size=0)
        child_op = build_operator(node.child, self.conf)
        num_maps = child_op.num_partitions()
        num_reducers = part.num_partitions
        # one partitioner serves every map task, so a range exchange's
        # bounds are normalised once; round robin starts anew in each task
        shared = None if isinstance(part, N.RoundRobinPartitioning) else \
            create_repartitioner(part, schema)
        maps = [self._run_map(child_op, shared or create_repartitioner(part, schema),
                              schema, m) for m in range(num_maps)]
        sizes = [0] * num_reducers
        for staged in maps:
            for pid, subs in staged.items():
                sizes[pid] += sum(b.logical_nbytes() for b in subs)
        groups = self._coalesce_reducers(sizes)

        def provider(partition, _maps=maps, _groups=groups):
            pids = _groups[partition]
            return [b for staged in _maps for p in pids for b in staged.get(p, ())]

        rid = self._register(provider)
        return N.CoalesceBatches(N.BatchSource(schema, rid, len(groups)),
                                 batch_size=0)

    def _sample_range_bounds(self, node: N.ShuffleExchange) -> N.RangePartitioning:
        """num_partitions - 1 quantile bounds of the child's sort keys
        (blaze_tpu/runtime/session.py:_sample_range_bounds, the same
        procedure): every max(1, rows // 50)-th row of each batch, until a
        partition has given 5,000 rows; the samples sorted by their host
        keys, the bound i the sample at i * len // num_partitions."""
        part = node.partitioning
        child_op = build_operator(node.child, self.conf)
        exprs = [so.child for so in part.sort_orders]
        samples = []
        for p in range(child_op.num_partitions()):
            taken = 0
            for batch in child_op.execute(p, self._ctx()):
                cols = ExprEvaluator(exprs, batch.schema).evaluate(batch)
                keys = ColumnarBatch(
                    T.Schema.of(*[(f"k{i}", c.dtype) for i, c in enumerate(cols)]),
                    cols, batch.num_rows)
                step = max(1, batch.num_rows // 50)
                rows = torch.arange(0, batch.num_rows, step, device=batch.device)
                picked = keys.take(rows, self.conf).to_pydict()
                samples.extend(zip(*picked.values()))
                taken += batch.num_rows
                if taken >= 5000:
                    break
        if not samples:
            return dataclasses.replace(part, bounds=[])

        def keyf(row):
            return tuple(host_key_part(v, so) for v, so in zip(row, part.sort_orders))

        samples.sort(key=keyf)
        n = part.num_partitions
        return dataclasses.replace(part, bounds=[
            samples[min(len(samples) - 1, i * len(samples) // n)] for i in range(1, n)])

    def _run_map(self, child_op, repart, schema, m: int):
        """One map task: stream the child partition, coalesce small
        batches, bucketize by partition id with ``repart``; returns
        {pid: [sub-batches]}."""
        staged: Dict[int, List[ColumnarBatch]] = {}
        pending: List[ColumnarBatch] = []
        pending_rows = 0
        coalesce_min = min(self.conf.batch_size, _COALESCE_MIN_ROWS)

        def flush():
            batch = pending[0] if len(pending) == 1 else \
                ColumnarBatch.concat(pending, schema, self.conf)
            for pid, sub in repart.bucketize(batch, self.conf):
                staged.setdefault(pid, []).append(sub)

        for batch in child_op.execute(m, self._ctx()):
            pending.append(batch)
            pending_rows += batch.num_rows
            if pending_rows >= coalesce_min:
                flush()
                pending, pending_rows = [], 0
        if pending:
            flush()
        return staged

    def _coalesce_reducers(self, sizes: List[int]) -> List[List[int]]:
        """Greedy adjacent merge of reducers below the advisory size
        (blaze_tpu/runtime/session.py:_coalesce_reducers); none below a
        partition-zipping node."""
        n = len(sizes)
        if not self.conf.coalesce_partitions_enable or n <= 1 or not self._zip_ok:
            return [[r] for r in range(n)]
        target = self.conf.advisory_partition_bytes
        groups, cur, cur_bytes = [], [], 0
        for r in range(n):
            if cur and cur_bytes + sizes[r] > target:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(r)
            cur_bytes += sizes[r]
        if cur:
            groups.append(cur)
        return groups


def _child_zip_ok(node: N.PlanNode, own_zip_ok: bool) -> bool:
    """May a child's partition count change (whole partitions merged)?
    Only partition-zipping parents forbid it: a hash join pairs partition
    i of both children, a union maps partitions by position. An exchange
    re-partitions its child, so below it merging is free again; every
    other node passes its own freedom through (the JAX package's
    ``Session._child_zip_ok``)."""
    if isinstance(node, (N.ShuffleExchange, N.BroadcastExchange)):
        return True
    if isinstance(node, (N.SortMergeJoin, N.HashJoin, N.Union)):
        return False
    return own_zip_ok


def _require_device_planes(schema: T.Schema) -> None:
    """The device tier moves device planes only: a BINARY host column (the
    bloom_filter aggregate's result) cannot cross an exchange."""
    for f in schema.fields:
        if isinstance(f.dtype, T.BinaryType):
            raise host_column_error(f"an exchange of column {f.name!r}")
