"""Window functions over partition/order-sorted input: the rank family.

Counterpart of blaze_tpu/ops/window.py ``WindowExec`` for its counters-
only path: row_number, rank and dense_rank, with an optional
``group_limit`` (WindowGroupLimit). Input arrives sorted by (partition
spec, order spec), as Spark guarantees. Each batch is processed in one
shot over segment-boundary masks -- partition starts from carryable key
rows (ops/joins/keymap.py ``RunningKeyCodes``), peer starts from the
order keys (ops/sort_keys.py ``peer_key_rows``) -- fed to the restart-at-
segment counter scans (core/kernels.py ``restarting_counters``), with the
counters of the partition left open by the previous batch carried over.
Counters are final the moment they are computed, so nothing is withheld
or buffered. Like the JAX package, this is host numpy over the key planes
pulled from the card; the rows themselves stay on the card (a K6 gather
under a group limit, uploads of the counter columns).

Window aggregates (the segmented scans over ``_seg_scan``) and the
buffered path of explicit ROWS/RANGE frames are not ported: a plan with
either raises NotImplementedError (ROADMAP.md Queue 2 item 14, Queue 1
item 10).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import ExprEvaluator
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.nodes import WindowExpr
from blaze_tpu_torch.ops import sort_keys as SK
from blaze_tpu_torch.ops.base import Operator
from blaze_tpu_torch.ops.joins.keymap import RunningKeyCodes

_COUNTERS = ("row_number", "rank", "dense_rank")


class WindowExec(Operator):
    def __init__(self, child: Operator, window_exprs: List[WindowExpr],
                 partition_spec: List[E.Expr], order_spec: List[E.SortOrder],
                 group_limit: Optional[int] = None,
                 output_window_cols: bool = True):
        self.window_exprs = window_exprs
        self.partition_spec = partition_spec
        self.order_spec = order_spec
        self.group_limit = group_limit
        self.output_window_cols = output_window_cols
        if not self._segmentable():
            raise NotImplementedError(
                "window expressions over explicit ROWS/RANGE frames need the "
                "buffered window path, which is not ported to the PyTorch "
                "package yet (ROADMAP.md Queue 1 item 10)")
        if any(w.kind not in _COUNTERS for w in window_exprs):
            raise NotImplementedError(
                "window aggregates need the segmented scan kernel (_seg_scan), "
                "which is not ported to the PyTorch package yet (ROADMAP.md "
                "Queue 2 item 14)")
        super().__init__(self._output_schema(child.schema), [child])

    def _output_schema(self, child_schema: T.Schema) -> T.Schema:
        if not self.output_window_cols:
            return child_schema
        extra = [T.StructField(w.name, w.return_type or
                               (T.I32 if w.kind in ("rank", "dense_rank") else T.I64))
                 for w in self.window_exprs]
        return T.Schema(child_schema.fields + tuple(extra))

    def _segmentable(self) -> bool:
        """Rank-family counters and default-frame aggregates compute as
        restart-at-segment scans with only a carry across batches; explicit
        frames need random access within the partition."""
        return all(w.kind in _COUNTERS or (w.kind == "agg" and w.frame is None)
                   for w in self.window_exprs)

    def _execute(self, partition, ctx):
        child_schema = self.children[0].schema
        part_ev = ExprEvaluator(self.partition_spec, child_schema) \
            if self.partition_spec else None
        order_ev = ExprEvaluator([so.child for so in self.order_spec],
                                 child_schema) if self.order_spec else None
        part_keys = RunningKeyCodes()
        order_keys = RunningKeyCodes()
        started = False
        c_rn, c_rank, c_dense = 0, 1, 0
        for batch in self.execute_child(0, partition, ctx):
            n = batch.num_rows
            if n == 0:
                continue
            if part_ev is None:
                part_start = np.zeros(n, dtype=bool)
                part_start[0] = not started
            else:
                part_start = part_keys.change_mask(batch, part_ev.evaluate(batch))
            if order_ev is not None:
                new_peer = part_start | order_keys.push_rows(
                    SK.peer_key_rows(batch, self.order_spec, order_ev))
            else:
                new_peer = part_start.copy()
            started = True
            rn, rank, dense = K.restarting_counters(
                part_start, new_peer, c_rn, c_rank, c_dense)
            sel = self._limit_select(rn, rank, dense)
            if sel is None:
                yield self._emit_rows(batch, rn, rank, dense)
            elif len(sel):
                rows = batch.take(torch.from_numpy(sel).to(batch.device), ctx.conf)
                yield self._emit_rows(rows, rn[sel], rank[sel], dense[sel])
            c_rn, c_rank, c_dense = int(rn[-1]), int(rank[-1]), int(dense[-1])

    def _limit_vals(self, rn, rank, dense):
        """The plane group_limit filters on: rank() <= K and dense_rank() <=
        K keep boundary-tied rows; anything else limits by row number."""
        kinds = {w.kind for w in self.window_exprs}
        if kinds == {"rank"}:
            return rank
        if kinds == {"dense_rank"}:
            return dense
        return rn

    def _limit_select(self, rn, rank, dense) -> Optional[np.ndarray]:
        """Surviving-row indices under group_limit, or None for keep-all."""
        if self.group_limit is None:
            return None
        keep = np.nonzero(
            self._limit_vals(rn, rank, dense) <= self.group_limit)[0]
        return None if len(keep) == len(rn) else keep

    def _emit_rows(self, rows: ColumnarBatch, rn, rank, dense) -> ColumnarBatch:
        """Child rows + the counter columns -> one output batch (row_number
        I64, rank and dense_rank I32, as the JAX package emits them)."""
        if not self.output_window_cols:
            return rows
        out_cols = list(rows.columns)
        fields = list(rows.schema.fields)
        for w in self.window_exprs:
            if w.kind == "row_number":
                vals, dt = np.asarray(rn, np.int64), T.I64
            elif w.kind == "rank":
                vals, dt = np.asarray(rank).astype(np.int32), T.I32
            else:
                vals, dt = np.asarray(dense).astype(np.int32), T.I32
            out_cols.append(DeviceColumn.from_numpy(dt, vals, None, rows.capacity,
                                                    rows.device))
            fields.append(T.StructField(w.name, dt))
        return ColumnarBatch(T.Schema(tuple(fields)), out_cols, rows.num_rows)
