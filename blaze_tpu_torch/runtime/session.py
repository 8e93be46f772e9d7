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

``Session(mesh=...)`` takes a device mesh (parallel/mesh.py): every
ShuffleExchange then runs on it (``_run_mesh_exchange``, the JAX
package's mesh lowering: map partitions folded onto the slots in
contiguous blocks, one K17 all-to-all a round, no reducer coalescing).
``Config(multichip_enabled=True)`` builds a mesh from the config when none
is given, as the JAX package does: one slot per visible device, at most
``multichip_devices`` (one slot on a single card, so the exchanges take
the mesh's code path unstacked; several cards raise, item 15), and
registers the fused stages' ``ShardedFusedRunner``. The JAX package's
placement model (runtime/placement.py, item 13) is not ported: under a
mesh every ShuffleExchange takes the mesh. ``counters`` counts
``sharded_stages``, ``collective_bytes`` and ``sharded_batches`` (the
JAX package's metrics that its tests read; the metrics tree is item 10),
``mesh_host_exchanges``, the exchanges whose reducers waited in host
memory, and the fusions a partial aggregate made (ops/agg.py):
``fused_stages`` and ``fused_ops`` for an absorbed fused stage,
``fused_join_stages`` for each absorbed broadcast join;
``mesh_exchanges`` describes the last query's mesh exchanges
(rounds, wire bytes, compacted and as masked tiles, payload, residency).
"""

from __future__ import annotations

import collections
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
from blaze_tpu_torch.ops.sort_keys import spark_key_part
from blaze_tpu_torch.runtime.executor import build_operator
from blaze_tpu_torch.utils.device import resolve_device

# rows a map task accumulates before a bucketize pass (the JAX shuffle
# writer's small-batch coalescing)
_COALESCE_MIN_ROWS = 32768


class Session:
    def __init__(self, conf: Optional[Config] = None, device=None, mesh=None):
        from blaze_tpu_torch.ops.fused import SHARDED_FUSED
        from blaze_tpu_torch.parallel.mesh import DeviceMesh, ShardedFusedRunner, make_mesh, \
            visible_devices

        self.conf = conf or Config()
        self.device: torch.device = resolve_device(device)
        self.resources: Dict[str, object] = {}
        self._stage_ids = itertools.count()
        self._query_rids: List[str] = []
        self._zip_ok = True
        self.counters: collections.Counter = collections.Counter()
        self.mesh_exchanges: List[dict] = []  # the last query's, one a mesh exchange
        self._mesh_pinned_bytes = 0
        self.mesh = mesh
        if mesh is None and self.conf.multichip_enabled:
            # the JAX package's config-built mesh: one slot per visible
            # device, at most multichip_devices of them; more than one
            # spans cards, which DeviceMesh refuses (item 15)
            nd = visible_devices(self.device)
            k = max(1, min(self.conf.multichip_devices or nd, nd))
            self.mesh = make_mesh(1, self.device) if k == 1 else \
                DeviceMesh([torch.device(self.device.type, i) for i in range(k)])
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"a mesh on {self.mesh.device} for a session on {self.device}")
        if self.mesh is not None and self.conf.multichip_enabled:
            self.resources[SHARDED_FUSED] = ShardedFusedRunner(self.mesh, self.counters)

    # -- public API -----------------------------------------------------------

    def execute(self, plan: N.PlanNode) -> Iterator[ColumnarBatch]:
        """Run a plan, yielding the result batches (final-stage partitions in
        order). Exchange outputs are released when the stream ends."""
        self._query_rids = [BUILD_MAPS]
        self.resources[BUILD_MAPS] = {}
        self.mesh_exchanges = []
        try:
            op = build_operator(self._lower(plan), self.conf)
            for p in range(op.num_partitions()):
                yield from op.execute(p, self._ctx())
        finally:
            for rid in self._query_rids:
                self.resources.pop(rid, None)
            self._query_rids = []
            self._mesh_pinned_bytes = 0  # the exchanges' outputs went with them

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
        return ExecContext(self.conf, self.device, self.resources, self.counters)

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
        if self.mesh is not None:
            return self._run_mesh_exchange(node, part)
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

    def _run_mesh_exchange(self, node: N.ShuffleExchange, part) -> N.PlanNode:
        """The exchange on the device mesh (blaze_tpu/runtime/session.py
        ``_run_mesh_exchange``): each map partition's batches concatenated
        (K7) with their reducer ids (K2, K14 or round robin, per task),
        partitions folded onto the n slots in contiguous blocks (slot =
        m * n // num_maps, so every reducer's rows keep the map order at
        every slot count), one ``MeshBatchExchange.run``, the outputs
        behind a BatchSource of ``num_partitions`` reducers (no coalescing).
        The resident budget is what the query's earlier exchanges left."""
        from blaze_tpu_torch.parallel.mesh import HostBatch, MeshBatchExchange

        schema = node.child.output_schema
        child_op = build_operator(node.child, self.conf)
        num_maps = child_op.num_partitions()
        num_reducers = part.num_partitions
        n = self.mesh.n
        shared = None if isinstance(part, N.RoundRobinPartitioning) else \
            create_repartitioner(part, schema)
        shard_batches: List[Optional[ColumnarBatch]] = [None] * n
        shard_pids: List = [None] * n
        for m in range(num_maps):
            batches = [b for b in child_op.execute(m, self._ctx()) if b.num_rows]
            if not batches:
                continue
            batch = ColumnarBatch.concat(batches, schema, self.conf)
            pids = (shared or create_repartitioner(part, schema)).partition_ids(batch)
            s = m * n // num_maps
            if shard_batches[s] is None:
                shard_batches[s], shard_pids[s] = batch, pids
            else:
                shard_batches[s] = ColumnarBatch.concat([shard_batches[s], batch], schema,
                                                        self.conf)
                shard_pids[s] = torch.cat([shard_pids[s], pids])
        exchange = MeshBatchExchange(self.mesh)
        remaining = max(0, self.conf.mesh_device_resident_max_bytes - self._mesh_pinned_bytes)
        reducers = exchange.run(schema, shard_batches, shard_pids, num_reducers,
                                device_resident_budget=remaining, conf=self.conf)
        if exchange.last_device_resident:
            self._mesh_pinned_bytes += exchange.last_payload_bytes
        self.counters["sharded_stages"] += 1
        self.counters["collective_bytes"] += int(exchange.last_wire_bytes)
        if not exchange.last_device_resident:
            self.counters["mesh_host_exchanges"] += 1
        self.mesh_exchanges.append({
            "reducers": num_reducers, "rounds": exchange.last_rounds,
            "wire_bytes": exchange.last_wire_bytes,
            "wire_bytes_uncompacted": exchange.last_wire_bytes_uncompacted,
            "payload_bytes": exchange.last_payload_bytes,
            "device_resident": exchange.last_device_resident})

        def provider(r, _out=reducers, _dev=self.device, _conf=self.conf):
            rb = _out[r]
            if rb is None:
                return []
            return [rb.to_columnar(_dev, _conf) if isinstance(rb, HostBatch) else rb]

        return N.CoalesceBatches(N.BatchSource(schema, self._register(provider),
                                               num_reducers), batch_size=0)

    def _sample_range_bounds(self, node: N.ShuffleExchange) -> N.RangePartitioning:
        """num_partitions - 1 quantile bounds of the child's sort keys
        (blaze_tpu/runtime/session.py:_sample_range_bounds, the same
        procedure): every max(1, rows // 50)-th row of each batch, until a
        partition has given 5,000 rows; the samples sorted by their host
        keys, the bound i the sample at i * len // num_partitions. Floats
        sort in Spark's order (NaN above every value, -0.0 equal to 0.0),
        where the JAX package's sort leaves NaN samples out of order; K14's
        ids do not depend on the bounds' order, only the balance does."""
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
            return tuple(spark_key_part(v, so) for v, so in zip(row, part.sort_orders))

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
