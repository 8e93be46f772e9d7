"""Broadcast and shuffled hash joins, all join types.

The counterpart of blaze_tpu/ops/joins/bhj.py: ``_HashJoinBase`` probes
a prebuilt ``JoinHashMap`` (ops/joins/keymap.py) with each batch of the
probe side; ``BroadcastJoinExec`` builds its map once per
``cached_build_hash_map_id`` and query from the broadcast side,
``HashJoinExec`` from its own partition of the build child. Join types:
inner, left/right/full outer, left/right semi and anti, existence, with
an optional condition over the pair of rows.

Per probe batch, as in the reference:

- an INNER, unconditioned join whose build keys are unique and single
  (a dimension table) takes K8 (core/kernels.py ``inner_join_planes_cuda``:
  probe, stable compaction and the gathers of both sides in one launch,
  its argument words packed once a build map, ``JoinHashMap.join_pack``;
  one count sync);
- every other join takes the generic probe: K9 (``probe_codes``) gives
  each probe key its build-map code, the codes come to the host, the
  map's CSR expands the matching pairs there (numpy), the condition
  filters the pairs, and K6 gathers the output rows (``take``, or
  ``take_nullable`` for the null-extended side). Unmatched probe rows of
  an outer join follow the batch's pairs; unmatched or matched build
  rows (outer joins, semi/anti/existence on the build side) come last,
  after the probe side is done, from the task's ``matched`` flags.

The build-map cache lives in the session's per-query resource
``BUILD_MAPS`` and goes with the query's other resources
(runtime/session.py); each task takes the cached map with its own
``matched`` flags (``JoinHashMap.for_task``). The reference keeps the
cache process-global, so a later query with the same id and other
dimension data would reuse a stale map there.

Not ported yet (NotImplementedError naming ROADMAP.md): the shuffled hash
join's fallback to a sort-merge join when its build side passes
``smj_fallback_rows_threshold`` or ``smj_fallback_mem_size_threshold``
(SMJ is not ported), and ``BroadcastJoinBuildHashMapExec``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import (ColumnarBatch, DeviceColumn, column_planes,
                                        columns_from_planes)
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, require_narrow_key
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.nodes import JoinSide, JoinType, _join_output_schema
from blaze_tpu_torch.ops.base import Operator
from blaze_tpu_torch.ops.joins.keymap import JoinHashMap

# resource id of the per-query build-map cache ({cache id: JoinHashMap})
BUILD_MAPS = "broadcast_build_maps"

_SEMI = (JoinType.LEFT_SEMI, JoinType.RIGHT_SEMI)
_ANTI = (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)


def _on(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(device)


class _HashJoinBase(Operator):
    """Common probe logic; subclasses load the build side and call
    ``_probe_with_map``."""

    def __init__(self, left: Operator, right: Operator,
                 on: List[Tuple[E.Expr, E.Expr]], join_type: JoinType,
                 build_side: JoinSide = JoinSide.RIGHT,
                 condition: Optional[E.Expr] = None):
        self.on = on
        self.join_type = join_type
        self.build_side = build_side
        # extra condition over left + right columns; matched pairs failing
        # it count as unmatched
        self.condition = condition
        self._pair_schema = left.schema + right.schema
        for lk, rk in on:
            require_narrow_key(E.infer_type(lk, left.schema), "join key")
            require_narrow_key(E.infer_type(rk, right.schema), "join key")
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

    def _semi_side_is_probe(self) -> bool:
        jt = self.join_type
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE):
            return self._probe_child() == 0
        if jt in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return self._probe_child() == 1
        return False

    def num_partitions(self):
        return self.children[self._probe_child()].num_partitions()

    def _build_map(self, batches: List[ColumnarBatch], ctx) -> JoinHashMap:
        return JoinHashMap.build(batches, self._key_exprs(for_build=True),
                                 self.children[self._build_child()].schema,
                                 ctx.device, ctx.conf)

    # -- probe ----------------------------------------------------------------

    def _probe_with_map(self, bmap: JoinHashMap, partition, ctx):
        jt = self.join_type
        probe_child = self._probe_child()
        probe_on_left = probe_child == 0
        # which side's unmatched rows must be emitted?
        emit_unmatched_probe = (
            jt == JoinType.FULL
            or (jt == JoinType.LEFT and probe_on_left)
            or (jt == JoinType.RIGHT and not probe_on_left))
        emit_unmatched_build = (
            jt == JoinType.FULL
            or (jt == JoinType.LEFT and not probe_on_left)
            or (jt == JoinType.RIGHT and probe_on_left))
        semi_anti_exist = jt in _SEMI + _ANTI + (JoinType.EXISTENCE,)
        track_build_matched = emit_unmatched_build or (
            semi_anti_exist and not self._semi_side_is_probe())

        key_ev = ExprEvaluator(self._key_exprs(for_build=False),
                               self.children[probe_child].schema)
        cond_ev = ExprEvaluator([self.condition], self._pair_schema) \
            if self.condition is not None else None
        inner_fast_ok = (jt == JoinType.INNER and cond_ev is None
                         and not track_build_matched and bmap.unique_single_key)
        for batch in self.execute_child(probe_child, partition, ctx):
            cols = key_ev.evaluate(batch)
            if inner_fast_ok:
                out = self._inner_fast(batch, bmap, cols, probe_on_left)
            else:
                codes = bmap.probe_codes(batch, cols)
                probe_idx, build_idx, _ = bmap.probe(codes)
                probe_idx, build_idx, counts = self._apply_condition(
                    batch, bmap, probe_idx, build_idx, probe_on_left, cond_ev,
                    ctx.conf)
                if track_build_matched and len(build_idx):
                    bmap.matched[build_idx] = True
                out = self._emit_probe_batch(batch, bmap, probe_idx, build_idx,
                                             counts, emit_unmatched_probe,
                                             probe_on_left, ctx.conf)
            if out is not None and out.num_rows:
                yield out
        # unmatched build rows (right/left-opposite/full), or the build side
        # of a semi/anti/existence join, after the whole probe side
        tail = self._emit_build_tail(bmap, probe_on_left, emit_unmatched_build,
                                     ctx)
        if tail is not None and tail.num_rows:
            yield tail

    def _inner_fast(self, batch: ColumnarBatch, bmap: JoinHashMap,
                    cols: List[DeviceColumn], probe_on_left: bool):
        """One K8 call: the probe batch's hit rows beside their build rows,
        or None when no row hits."""
        bb = bmap.batch
        dev = batch.device
        probe = (batch.num_rows, cols[0].data, cols[0].validity, *column_planes(batch.columns))
        if dev.type == "cuda":  # K8, packed once a build map
            count, pd, pv, bd, bv = kernels.inner_join_planes_cuda(bmap.join_pack(dev), *probe)
        else:
            count, pd, pv, bd, bv = kernels.inner_join_planes_plain(
                bmap.device_keys(dev), len(bmap.sorted_keys), *probe,
                *column_planes(bb.columns))
        count = int(count)  # the batch's one host sync
        if count == 0:
            return None
        probe_cols = columns_from_planes(batch.schema.types, pd, pv)
        build_cols = columns_from_planes(bb.schema.types, bd, bv)
        left, right = ((probe_cols, build_cols) if probe_on_left
                       else (build_cols, probe_cols))
        return ColumnarBatch(self.schema, left + right, count)

    def _apply_condition(self, batch, bmap, probe_idx, build_idx, probe_on_left,
                         cond_ev, conf):
        """Filter matching pairs by the extra condition; returns the
        surviving (probe_idx, build_idx, counts per probe row)."""
        n = batch.num_rows
        if cond_ev is not None and len(probe_idx):
            dev = batch.device
            probe_out = batch.take(_on(probe_idx, dev), conf)
            build_out = bmap.batch.take(_on(build_idx, dev), conf)
            left, right = ((probe_out, build_out) if probe_on_left
                           else (build_out, probe_out))
            pair = ColumnarBatch(self._pair_schema, left.columns + right.columns,
                                 len(probe_idx))
            keep = cond_ev.evaluate_predicate(pair)[: len(probe_idx)].cpu().numpy()
            probe_idx = probe_idx[keep]
            build_idx = build_idx[keep]
        counts = np.bincount(probe_idx, minlength=n) if len(probe_idx) else \
            np.zeros(n, dtype=np.int64)
        return probe_idx, build_idx, counts

    def _emit_probe_batch(self, batch, bmap, probe_idx, build_idx, counts,
                          emit_unmatched_probe, probe_on_left, conf):
        jt = self.join_type
        n = batch.num_rows
        dev = batch.device
        matched_mask = counts > 0
        if jt == JoinType.EXISTENCE:
            if not self._semi_side_is_probe():
                return None
            exists = DeviceColumn.from_numpy(T.BOOL, matched_mask, None,
                                             batch.capacity, dev)
            return ColumnarBatch(self.schema, batch.columns + [exists], n)
        if jt in _SEMI + _ANTI:
            if not self._semi_side_is_probe():
                return None
            keep = np.nonzero(matched_mask if jt in _SEMI else ~matched_mask)[0]
            return batch.take(_on(keep, dev), conf) if len(keep) else None
        # inner / outer: the pairs, then this batch's unmatched probe rows
        if emit_unmatched_probe:
            un = np.nonzero(~matched_mask)[0]
            probe_idx = np.concatenate([probe_idx, un])
            build_idx = np.concatenate([build_idx, np.full(len(un), -1, np.int64)])
        if len(probe_idx) == 0:
            return None
        probe_out = batch.take(_on(probe_idx, dev), conf)
        build_out = bmap.batch.take_nullable(build_idx, conf)
        left, right = ((probe_out, build_out) if probe_on_left
                       else (build_out, probe_out))
        return ColumnarBatch(self.schema, left.columns + right.columns,
                             len(probe_idx))

    def _emit_build_tail(self, bmap, probe_on_left, emit_unmatched_build, ctx):
        jt = self.join_type
        build = bmap.batch
        build_n = build.num_rows
        if build_n == 0:
            return None
        dev = build.device
        if jt in _SEMI + _ANTI and not self._semi_side_is_probe():
            keep = np.nonzero(bmap.matched if jt in _SEMI else ~bmap.matched)[0]
            return build.take(_on(keep, dev), ctx.conf) if len(keep) else None
        if jt == JoinType.EXISTENCE and not self._semi_side_is_probe():
            exists = DeviceColumn.from_numpy(T.BOOL, bmap.matched, None,
                                             build.capacity, dev)
            return ColumnarBatch(self.schema, build.columns + [exists], build_n)
        if not emit_unmatched_build:
            return None
        un = np.nonzero(~bmap.matched)[0]
        if len(un) == 0:
            return None
        build_out = build.take(_on(un, dev), ctx.conf)
        probe_schema = self.children[self._probe_child()].schema
        probe_nulls = ColumnarBatch.empty(probe_schema, dev, conf=ctx.conf) \
            .take_nullable(np.full(len(un), -1, np.int64), ctx.conf)
        left, right = ((build_out, probe_nulls) if not probe_on_left
                       else (probe_nulls, build_out))
        return ColumnarBatch(self.schema, left.columns + right.columns, len(un))


class HashJoinExec(_HashJoinBase):
    """Shuffled hash join: partition i of the probe child against a map
    built from partition i of the build child (the session keeps the two
    sides' partitions aligned: no reducer coalescing below a partition-
    zipping node). Past the SMJ fallback thresholds the reference re-plans
    the partition as a sort-merge join; SMJ is not ported, so the port
    raises there and takes no other path."""

    def _execute(self, partition, ctx):
        conf = ctx.conf
        batches = []
        rows = 0
        nbytes = 0
        for b in self.execute_child(self._build_child(), partition, ctx):
            batches.append(b)
            rows += b.num_rows
            nbytes += b.nbytes()
            if rows > conf.smj_fallback_rows_threshold or \
                    nbytes > conf.smj_fallback_mem_size_threshold:
                raise NotImplementedError(
                    f"the hash join's build side passed the SMJ fallback "
                    f"threshold ({rows} rows, {nbytes} bytes); the sort-merge "
                    "join it falls back to is not ported yet (ROADMAP.md "
                    "Queue 1 item 8: the sort-merge join and the SMJ fallback)")
        bmap = self._build_map(batches, ctx)
        yield from self._probe_with_map(bmap, partition, ctx)


class BroadcastJoinExec(_HashJoinBase):
    """Join against a broadcast build side; the built map is cached per
    query under ``cached_build_hash_map_id``."""

    def __init__(self, left, right, on, join_type, broadcast_side=JoinSide.RIGHT,
                 cached_build_hash_map_id="", condition=None):
        super().__init__(left, right, on, join_type, broadcast_side, condition)
        self.cached_build_hash_map_id = cached_build_hash_map_id

    def _load_build_map(self, ctx) -> JoinHashMap:
        """The query's map of the broadcast side (built on first use, then
        cached under ``cached_build_hash_map_id``), with this task's own
        ``matched`` flags. A partial aggregate that absorbs this join
        (ops/agg.py) loads it here too, and when the map turns out not to
        be unique drives ``_probe_with_map`` with it, built once."""
        cache_id = self.cached_build_hash_map_id
        cache = ctx.resources.get(BUILD_MAPS) if cache_id else None
        built = cache.get(cache_id) if cache is not None else None
        if built is None:
            # the broadcast side is one partition whatever the probe partition
            built = self._build_map(
                list(self.execute_child(self._build_child(), 0, ctx)), ctx)
            if cache is not None:
                cache[cache_id] = built
        return built.for_task()

    def _execute(self, partition, ctx):
        yield from self._probe_with_map(self._load_build_map(ctx), partition, ctx)
