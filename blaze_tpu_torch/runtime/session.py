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
single-partition exchange is a collect in map order. Worker pools, file
and remote shuffle tiers, broadcast and range exchanges are not ported
(ROADMAP.md Queue 1 items 7 and 12).
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional

import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.shuffle.repartitioner import create_repartitioner
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

    # -- public API -----------------------------------------------------------

    def execute(self, plan: N.PlanNode) -> Iterator[ColumnarBatch]:
        """Run a plan, yielding the result batches (final-stage partitions in
        order). Exchange outputs are released when the stream ends."""
        self._query_rids = []
        try:
            op = build_operator(self._lower(plan))
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
        node = N.map_children(node, self._lower)
        if isinstance(node, N.Sort) and isinstance(node.child, N.CoalesceBatches):
            # Sort stages its whole input; a reducer coalesce below it
            # gathers the same rows twice
            import dataclasses

            node = dataclasses.replace(node, child=node.child.child)
        if isinstance(node, N.ShuffleExchange):
            return self._run_exchange(node)
        if isinstance(node, N.BroadcastExchange):
            raise NotImplementedError(
                "broadcast exchanges are not ported to the PyTorch package yet "
                "(ROADMAP.md Queue 1 item 9)")
        return node

    def _register(self, provider) -> str:
        rid = f"exchange_{next(self._stage_ids)}"
        self.resources[rid] = provider
        self._query_rids.append(rid)
        return rid

    def _run_exchange(self, node: N.ShuffleExchange) -> N.PlanNode:
        child_op = build_operator(node.child)
        schema = node.child.output_schema
        part = node.partitioning
        num_maps = child_op.num_partitions()
        if isinstance(part, N.SinglePartitioning) and part.num_partitions == 1:
            # a single-reducer exchange is a collect, assembled in map order
            blocks = [b for m in range(num_maps)
                      for b in child_op.execute(m, self._ctx())]
            rid = self._register(lambda p, _b=blocks: _b)
            return N.CoalesceBatches(N.BatchSource(schema, rid, 1), batch_size=0)
        num_reducers = part.num_partitions
        maps = [self._run_map(child_op, part, schema, m) for m in range(num_maps)]
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

    def _run_map(self, child_op, partitioning, schema, m: int):
        """One map task: stream the child partition, coalesce small
        batches, bucketize by partition id; returns {pid: [sub-batches]}."""
        repart = create_repartitioner(partitioning, schema)
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
        (blaze_tpu/runtime/session.py:_coalesce_reducers)."""
        n = len(sizes)
        if not self.conf.coalesce_partitions_enable or n <= 1:
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
