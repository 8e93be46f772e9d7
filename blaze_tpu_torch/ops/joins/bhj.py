"""Broadcast hash join: the unique-key inner join.

The counterpart of blaze_tpu/ops/joins/bhj.py's ``BroadcastJoinExec`` on
the path every bench join takes: an INNER, unconditioned join on one
fixed-width key whose build side is unique (a dimension table) — the
reference's ``_inner_fast`` branch of ``_probe_with_map``. Each probe
batch is one K8 call (core/kernels.py ``inner_join_planes``: probe,
stable compaction and the gathers of both sides) and one count sync; the
output has the probe batch's capacity, columns left + right.

The build map (ops/joins/keymap.py ``JoinHashMap``) is built once per
``cached_build_hash_map_id`` and query: the cache lives in the session's
per-query resource ``BUILD_MAPS`` and goes with the query's other
resources (runtime/session.py). The reference keeps it process-global,
so a later query with the same id and other dimension data would reuse
a stale map there.

Not ported yet (NotImplementedError naming ROADMAP.md): outer, semi,
anti and existence joins, join conditions, multi-key joins and duplicate
build keys (the generic probe), the shuffled hash join with its SMJ
fallback, and ``BroadcastJoinBuildHashMapExec``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir.nodes import JoinSide, JoinType, _join_output_schema
from blaze_tpu_torch.ops.base import Operator
from blaze_tpu_torch.ops.joins.keymap import JoinHashMap

# resource id of the per-query build-map cache ({cache id: JoinHashMap})
BUILD_MAPS = "broadcast_build_maps"

_GENERIC = "ROADMAP.md Queue 1 item 9: the generic probe, PERF.md row 14"


class BroadcastJoinExec(Operator):
    """Join against a broadcast build side; the built map is cached per
    query under ``cached_build_hash_map_id``."""

    def __init__(self, left: Operator, right: Operator,
                 on: List[Tuple[E.Expr, E.Expr]], join_type: JoinType,
                 broadcast_side: JoinSide = JoinSide.RIGHT,
                 cached_build_hash_map_id: str = "",
                 condition: Optional[E.Expr] = None):
        if join_type != JoinType.INNER:
            raise NotImplementedError(
                f"{join_type.value} broadcast joins are not ported to the "
                f"PyTorch package yet ({_GENERIC})")
        if condition is not None:
            raise NotImplementedError(
                f"broadcast joins with a join condition are not ported yet ({_GENERIC})")
        self.on = on
        self.join_type = join_type
        self.build_side = broadcast_side
        self.cached_build_hash_map_id = cached_build_hash_map_id
        schema = _join_output_schema(left.schema, right.schema, join_type)
        super().__init__(schema, [left, right])

    # -- orientation helpers --------------------------------------------------

    @property
    def _build_is_left(self) -> bool:
        return self.build_side == JoinSide.LEFT

    def _probe_child(self) -> int:
        return 1 if self._build_is_left else 0

    def _build_child(self) -> int:
        return 0 if self._build_is_left else 1

    def _key_exprs(self, for_build: bool) -> List[E.Expr]:
        if for_build:
            return [l if self._build_is_left else r for l, r in self.on]
        return [r if self._build_is_left else l for l, r in self.on]

    def num_partitions(self):
        return self.children[self._probe_child()].num_partitions()

    # -- build ----------------------------------------------------------------

    def _load_build_map(self, ctx) -> JoinHashMap:
        cache_id = self.cached_build_hash_map_id
        cache = ctx.resources.get(BUILD_MAPS) if cache_id else None
        if cache is not None and cache_id in cache:
            return cache[cache_id]
        child = self._build_child()
        # the broadcast side is one partition whatever the probe partition
        batches = list(self.execute_child(child, 0, ctx))
        built = JoinHashMap.build(batches, self._key_exprs(for_build=True),
                                  self.children[child].schema, ctx.device,
                                  ctx.conf)
        if cache is not None:
            cache[cache_id] = built
        return built

    # -- probe ----------------------------------------------------------------

    def _execute(self, partition, ctx):
        bmap = self._load_build_map(ctx)
        probe_child = self._probe_child()
        key_ev = ExprEvaluator(self._key_exprs(for_build=False),
                               self.children[probe_child].schema)
        for batch in self.execute_child(probe_child, partition, ctx):
            out = self._inner_fast(batch, bmap, key_ev.evaluate(batch),
                                   probe_on_left=probe_child == 0)
            if out is not None:
                yield out

    def _inner_fast(self, batch: ColumnarBatch, bmap: JoinHashMap,
                    cols: List[DeviceColumn], probe_on_left: bool):
        """One K8 call: the probe batch's hit rows beside their build rows,
        or None when no row hits."""
        bb = bmap.batch
        count, pd, pv, bd, bv = kernels.inner_join_planes(
            bmap.device_keys(batch.device), len(bmap.sorted_keys), batch.num_rows,
            cols[0].data, cols[0].validity,
            [c.data for c in batch.columns], [c.validity for c in batch.columns],
            [c.data for c in bb.columns], [c.validity for c in bb.columns])
        if count == 0:
            return None
        probe_cols = [DeviceColumn(c.dtype, d, v)
                      for c, d, v in zip(batch.columns, pd, pv)]
        build_cols = [DeviceColumn(c.dtype, d, v)
                      for c, d, v in zip(bb.columns, bd, bv)]
        left, right = ((probe_cols, build_cols) if probe_on_left
                       else (build_cols, probe_cols))
        return ColumnarBatch(self.schema, left + right, count)
