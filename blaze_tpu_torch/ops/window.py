"""Window functions over partition/order-sorted input.

Counterpart of blaze_tpu/ops/window.py ``WindowExec``: row_number, rank,
dense_rank and aggregates (SUM, AVG, COUNT, MIN, MAX) over a window,
with an optional ``group_limit`` (WindowGroupLimit). Input arrives sorted
by (partition spec, order spec), as Spark guarantees.

Rank-family counters and default-frame aggregates run SEGMENTED: each
batch is processed in one shot over segment-boundary masks -- partition
starts from carryable key rows (ops/joins/keymap.py ``RunningKeyCodes``),
peer starts from the order keys (ops/sort_keys.py ``peer_key_rows``) --
fed to the restart-at-segment scans of core/kernels.py, with a small carry
(counter bases, each aggregate's open sum, count and extremum) threaded
across batches. A SUM, AVG or COUNT of a device column scans on the card
in one K13 launch (``segment_scan_planes``); decimals, MIN/MAX and COUNT(*)
take the host numpy scans, exactly where the JAX package takes them. Only
the open tail group is withheld until its frame value is known, and only
when aggregates are present.

Explicit ROWS/RANGE frames need random access within the partition: each
partition is buffered whole, concatenated (K7) and computed on the host
over its planes pulled from the card. Unlike the JAX package's buffer, it
does not spill: the port has no memory manager yet (ROADMAP.md Queue 1
item 11), so a partition (or an open tail group) must fit on the card.

Like the JAX package, the frame arithmetic is host numpy; the rows stay
on the card (K6 gathers under a group limit, K7 slices and concats,
uploads of the window columns).
"""

from __future__ import annotations

from decimal import ROUND_HALF_UP, Decimal
from typing import Iterator, List, Optional

import numpy as np
import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, require_narrow_key
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
        for e in list(partition_spec) + [so.child for so in order_spec]:
            require_narrow_key(E.infer_type(e, child.schema), "window partition or order key")
        super().__init__(self._output_schema(child.schema), [child])

    def _output_schema(self, child_schema: T.Schema) -> T.Schema:
        if not self.output_window_cols:
            return child_schema
        extra = []
        for w in self.window_exprs:
            if w.kind == "agg":
                dt = self._agg_result_type(w, child_schema)
            else:
                dt = w.return_type or (T.I32 if w.kind in ("rank", "dense_rank") else T.I64)
            extra.append(T.StructField(w.name, dt))
        return T.Schema(child_schema.fields + tuple(extra))

    @staticmethod
    def _agg_result_type(w: WindowExpr, child_schema: T.Schema) -> T.DataType:
        agg = w.agg
        arg_t = E.infer_type(agg.args[0], child_schema) if agg.args else T.NULL
        dt = w.return_type or agg.return_type or E.agg_result_type(agg.fn, arg_t)
        if isinstance(dt, T.DecimalType) and \
                dt.precision > T.DecimalType.MAX_INT64_PRECISION:
            raise NotImplementedError(
                f"window aggregate {w.name!r} has the result type {dt!r}, a decimal "
                "wider than 18 digits, which the PyTorch port's window does not "
                "compute yet (ROADMAP.md Queue 1 item 18)")
        return dt

    def _segmentable(self) -> bool:
        """Rank-family counters and default-frame aggregates compute as
        restart-at-segment scans with only a carry across batches; explicit
        frames need random access within the partition."""
        return all(w.kind in _COUNTERS or (w.kind == "agg" and w.frame is None)
                   for w in self.window_exprs)

    def _execute(self, partition, ctx):
        if self._segmentable():
            yield from self._execute_segmented(partition, ctx)
        else:
            yield from self._execute_buffered(partition, ctx)

    # -- buffered execution (explicit ROWS/RANGE frames) -----------------------

    def _execute_buffered(self, partition, ctx):
        child_schema = self.children[0].schema
        part_ev = ExprEvaluator(self.partition_spec, child_schema) \
            if self.partition_spec else None
        part_keys = RunningKeyCodes()
        pending: List[ColumnarBatch] = []
        bs = ctx.conf.batch_size

        def process_partition() -> Iterator[ColumnarBatch]:
            if not pending:
                return
            part = ColumnarBatch.concat(pending, child_schema, ctx.conf)
            pending.clear()
            out = self._process_one_partition(part, ctx)
            for off in range(0, out.num_rows, bs):
                yield out.slice(off, bs, ctx.conf)

        started = False
        for batch in self.execute_child(0, partition, ctx):
            n = batch.num_rows
            if n == 0:
                continue
            if part_ev is None:
                ch = np.zeros(n, dtype=bool)
                ch[0] = not started
            else:
                ch = part_keys.change_mask(batch, part_ev.evaluate(batch))
            started = True
            bounds = np.nonzero(ch)[0]
            # a True at row 0 closes the pending partition; later Trues
            # close the piece before them
            if pending and len(bounds) and bounds[0] == 0:
                yield from process_partition()
            starts = [0] + [int(b) for b in bounds if b > 0]
            ends = starts[1:] + [n]
            for i, (s, e) in enumerate(zip(starts, ends)):
                if i > 0:
                    yield from process_partition()
                pending.append(batch.slice(s, e - s, ctx.conf))
        yield from process_partition()

    # -- segmented execution (counters + default-frame aggregates) ------------

    def _execute_segmented(self, partition, ctx):
        """One pass, one shot per batch: boundary masks + restart-at-segment
        scans. The carry across batches is O(1): counter bases, per-aggregate
        (sum, count, extremum) accumulators, and the last partition/order
        key row inside the RunningKeyCodes detectors."""
        child_schema = self.children[0].schema
        aggs = [w for w in self.window_exprs if w.kind == "agg"]
        has_order = bool(self.order_spec)
        part_ev = ExprEvaluator(self.partition_spec, child_schema) \
            if self.partition_spec else None
        order_ev = ExprEvaluator([so.child for so in self.order_spec],
                                 child_schema) if has_order else None
        part_keys = RunningKeyCodes()
        order_keys = RunningKeyCodes()
        started = False
        c_rn, c_rank, c_dense = 0, 1, 0
        acc = {id(w): [0, 0, None] for w in aggs}   # sum, count, extremum
        # the open tail group, withheld until its frame value is known: its
        # counters are degenerate (rank/dense constant, row_number
        # consecutive), so the buffer carries child rows + three scalars
        hold: List[ColumnarBatch] = []
        hold_rn0 = hold_rank = hold_dense = 1

        def flush_hold(close_vals):
            off = 0
            held = hold[:]
            hold.clear()
            for hb in held:
                m = hb.num_rows
                rn_h = hold_rn0 + off + np.arange(m, dtype=np.int64)
                off += m
                rank_h = np.full(m, hold_rank, np.int64)
                dense_h = np.full(m, hold_dense, np.int64)
                sel = self._limit_select(rn_h, rank_h, dense_h)
                if sel is not None:
                    if not len(sel):
                        continue
                    hb = self._take(hb, sel, ctx)
                    rn_h, rank_h, dense_h = rn_h[sel], rank_h[sel], dense_h[sel]
                m = hb.num_rows
                vals = {k: ([v[0]] * m, [v[1]] * m, [v[2]] * m)
                        for k, v in close_vals.items()}
                yield self._emit_rows(hb, rn_h, rank_h, dense_h, vals)

        for batch in self.execute_child(0, partition, ctx):
            n = batch.num_rows
            if n == 0:
                continue
            if part_ev is None:
                part_start = np.zeros(n, dtype=bool)
                part_start[0] = not started
            else:
                part_start = part_keys.change_mask(batch, part_ev.evaluate(batch))
            if has_order:
                new_peer = part_start | order_keys.push_rows(
                    SK.peer_key_rows(batch, self.order_spec, order_ev))
            else:
                new_peer = part_start.copy()
            started = True
            rn, rank, dense = K.restarting_counters(
                part_start, new_peer, c_rn, c_rank, c_dense)
            if not aggs:
                # counters are final the moment they're computed: emit the
                # whole batch, nothing withheld, nothing buffered
                sel = self._limit_select(rn, rank, dense)
                if sel is None:
                    yield self._emit_rows(batch, rn, rank, dense, {})
                elif len(sel):
                    yield self._emit_rows(self._take(batch, sel, ctx), rn[sel],
                                          rank[sel], dense[sel], {})
                c_rn, c_rank, c_dense = int(rn[-1]), int(rank[-1]), int(dense[-1])
                continue
            # default frames close at the row's boundary-segment END: the
            # peer group when ordered (RANGE unbounded..current row, peers
            # share the value), the whole partition otherwise
            bmask = new_peer if has_order else part_start
            scans = {id(w): self._seg_agg_scan(w, batch, part_start, acc[id(w)])
                     for w in aggs}
            bounds = np.nonzero(bmask)[0]
            if not len(bounds):
                # the entire batch continues the open group
                keep = self._trim_tail(rn, rank, dense)
                if keep:
                    hold.append(batch if keep == n else batch.slice(0, keep, ctx.conf))
                self._roll_carry(aggs, scans, acc)
                c_rn, c_rank, c_dense = int(rn[-1]), int(rank[-1]), int(dense[-1])
                continue
            b0 = int(bounds[0])
            hold_from = int(bounds[-1])
            # the boundary at b0 closes the withheld group: its frame value
            # is the carry-seeded cumulative just before it
            close_vals = {}
            for w in aggs:
                k = id(w)
                cs, cc, run = scans[k]
                if b0 > 0:
                    close_vals[k] = (cs[b0 - 1], int(cc[b0 - 1]),
                                     run[b0 - 1] if run is not None else None)
                else:
                    close_vals[k] = tuple(acc[k])
            yield from flush_hold(close_vals)
            if hold_from > 0:
                # rows before the last boundary close within this batch:
                # backfill each row's value from its segment end
                j = np.searchsorted(bounds, np.arange(hold_from), side="right")
                end_idx = bounds[j] - 1
                rn_e, rank_e, dense_e = rn[:hold_from], rank[:hold_from], dense[:hold_from]
                sel = self._limit_select(rn_e, rank_e, dense_e)
                if sel is None or len(sel):
                    if sel is None:
                        rows = batch.slice(0, hold_from, ctx.conf)
                        ei = end_idx
                    else:
                        rows = self._take(batch, sel, ctx)
                        rn_e, rank_e, dense_e = rn_e[sel], rank_e[sel], dense_e[sel]
                        ei = end_idx[sel]
                    vals = {}
                    for w in aggs:
                        k = id(w)
                        cs, cc, run = scans[k]
                        vals[k] = (list(cs[ei]), list(cc[ei]),
                                   list(run[ei]) if run is not None else [None] * len(ei))
                    yield self._emit_rows(rows, rn_e, rank_e, dense_e, vals)
            # withhold the open tail group (emits when it closes); rows that
            # can no longer survive the group limit never enter
            keep = self._trim_tail(rn[hold_from:], rank[hold_from:], dense[hold_from:])
            if keep:
                hold.append(batch.slice(hold_from, keep, ctx.conf))
                hold_rn0 = int(rn[hold_from])
                hold_rank = int(rank[hold_from])
                hold_dense = int(dense[hold_from])
            self._roll_carry(aggs, scans, acc)
            c_rn, c_rank, c_dense = int(rn[-1]), int(rank[-1]), int(dense[-1])
        yield from flush_hold({k: tuple(v) for k, v in acc.items()})

    @staticmethod
    def _take(batch: ColumnarBatch, sel: np.ndarray, ctx) -> ColumnarBatch:
        return batch.take(torch.from_numpy(sel).to(batch.device), ctx.conf)

    @staticmethod
    def _roll_carry(aggs, scans, acc):
        """Advance the open-partition accumulators to the batch's last row
        (the scans restart at partition starts, so the last value IS the
        open partition's running state)."""
        for w in aggs:
            k = id(w)
            cs, cc, run = scans[k]
            acc[k] = [cs[-1], int(cc[-1]), run[-1] if run is not None else acc[k][2]]

    def _seg_agg_scan(self, w: WindowExpr, batch: ColumnarBatch,
                      part_start: np.ndarray, a):
        """Carry-seeded within-partition cumulatives (sum, count[, running
        extremum]) for one aggregate over one batch. A SUM/AVG/COUNT of a
        non-decimal, non-bool device column at the batch's capacity scans
        in one K13 launch; everything else (decimals, COUNT(*), MIN/MAX)
        takes the numpy segmented scans -- the JAX package's routes, so
        float sums associate in the same order."""
        F = E.AggFunction
        agg = w.agg
        if agg.args and agg.fn in (F.SUM, F.AVG, F.COUNT):
            arg_t = E.infer_type(agg.args[0], batch.schema)
            if not isinstance(arg_t, T.DecimalType):
                col = ExprEvaluator(list(agg.args), batch.schema).evaluate(batch)[0]
                if col.data.shape[0] == batch.capacity and col.data.dtype != torch.bool:
                    cs, cc = K.segment_scan_planes(
                        col.data, col.validity, batch.row_exists_mask(),
                        part_start, a[0], a[1])
                    return cs, cc, None
        nv, valid = self._agg_arg(w, batch)
        cs, cc = K.segment_cumsum(nv, valid, part_start, a[0], a[1])
        run = None
        if agg.fn in (F.MIN, F.MAX):
            run = K.segment_running_reduce(nv, valid, part_start, agg.fn == F.MIN, a[2])
        return cs, cc, run

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

    def _trim_tail(self, rn, rank, dense) -> int:
        """How many leading rows of the open tail group can still survive
        the group limit. Limit values are nondecreasing within a partition,
        so survivors form a prefix: rows past rank k are dropped BEFORE the
        window columns are computed or buffered."""
        if self.group_limit is None:
            return len(rn)
        vals = self._limit_vals(rn, rank, dense)
        return int(np.searchsorted(vals, self.group_limit, side="right"))

    def _counter_col(self, w: WindowExpr, rn, rank, dense, cap, dev):
        """row_number I64, rank and dense_rank I32, as the JAX package
        emits them."""
        if w.kind == "row_number":
            return DeviceColumn.from_numpy(T.I64, np.asarray(rn, np.int64), None, cap, dev), T.I64
        vals = rank if w.kind == "rank" else dense
        return DeviceColumn.from_numpy(T.I32, np.asarray(vals).astype(np.int32), None,
                                       cap, dev), T.I32

    def _emit_rows(self, rows: ColumnarBatch, rn, rank, dense, agg_vals) -> ColumnarBatch:
        """Child rows + computed window columns -> one output batch. ``rows``
        is already group-limited, so aggregate finalization runs only on
        surviving rows."""
        if not self.output_window_cols:
            return rows
        out_cols = list(rows.columns)
        fields = list(rows.schema.fields)
        child_schema = self.children[0].schema
        for w in self.window_exprs:
            if w.kind == "agg":
                fsum, fcnt, fval = agg_vals[id(w)]
                col, dt = self._agg_result_col(w, child_schema, fsum, fcnt, fval,
                                               rows.capacity, rows.device)
            else:
                col, dt = self._counter_col(w, rn, rank, dense, rows.capacity, rows.device)
            out_cols.append(col)
            fields.append(T.StructField(w.name, dt))
        return ColumnarBatch(T.Schema(tuple(fields)), out_cols, rows.num_rows)

    # -- shared aggregate plumbing --------------------------------------------

    def _agg_arg(self, w: WindowExpr, batch: ColumnarBatch):
        """(masked_values, valid) numpy planes of one aggregate's argument
        over a batch, nulls as 0: decimals as exact ``Decimal`` objects of
        the unscaled values, everything else numeric."""
        n = batch.num_rows
        agg = w.agg
        if not agg.args:
            return np.zeros(n, dtype=np.int64), np.ones(n, bool)
        arg_t = E.infer_type(agg.args[0], batch.schema)
        col = ExprEvaluator(list(agg.args), batch.schema).evaluate(batch)[0]
        data = col.data[:n].cpu().numpy()
        valid = col.validity[:n].cpu().numpy()
        if isinstance(arg_t, T.DecimalType):
            nv = np.array([Decimal(int(u)).scaleb(-arg_t.scale) if ok else Decimal(0)
                           for u, ok in zip(data.tolist(), valid.tolist())], dtype=object)
        else:
            nv = np.where(valid, data, 0)
        return nv, valid

    def _agg_result_col(self, w: WindowExpr, child_schema: T.Schema,
                        fsum, fcnt, fval, cap: int, dev):
        """Finalize per-row (sum, count, min/max) frame values into the
        typed device column, shared by the segmented and buffered paths.
        The arithmetic is the JAX package's, on the same Python and numpy
        scalars: AVG divides the sum by the count as they come, decimals
        divide under the default context (28 digits, half-even) and are
        then quantized half-up to the result's scale."""
        agg = w.agg
        result_t = self._agg_result_type(w, child_schema)
        F = E.AggFunction
        if agg.fn == F.COUNT:
            out = list(fcnt)
        elif agg.fn == F.SUM:
            out = [s if c > 0 else None for s, c in zip(fsum, fcnt)]
        elif agg.fn == F.AVG:
            out = [(s / c if c > 0 else None) for s, c in zip(fsum, fcnt)]
        elif agg.fn in (F.MIN, F.MAX):
            out = [v if c > 0 else None for v, c in zip(fval, fcnt)]
        else:
            raise NotImplementedError(f"window agg {agg.fn}")
        valid = np.array([v is not None for v in out], dtype=bool)
        if isinstance(result_t, T.DecimalType):
            q = Decimal(1).scaleb(-result_t.scale)
            vals = [0 if v is None else
                    int(Decimal(v).quantize(q, rounding=ROUND_HALF_UP).scaleb(result_t.scale))
                    for v in out]
            data = np.array(vals, dtype=np.int64)
        elif result_t == T.F64:
            data = np.array([0.0 if v is None else float(v) for v in out], dtype=np.float64)
        else:
            npdt = result_t.np_dtype
            data = np.array([np.zeros((), npdt) if v is None else v for v in out], dtype=npdt)
        return DeviceColumn.from_numpy(result_t, data, valid, cap, dev), result_t

    # -- per-partition computation (explicit-frame path) ----------------------

    def _single_peer_mask(self, part: ColumnarBatch) -> np.ndarray:
        """Peer-boundary mask within ONE fully-buffered partition."""
        n = part.num_rows
        out = np.zeros(n, dtype=bool)
        if n == 0:
            return out
        if not self.order_spec:
            out[0] = True
            return out
        return RunningKeyCodes().push_rows(SK.peer_key_rows(part, self.order_spec))

    def _process_one_partition(self, part: ColumnarBatch, ctx) -> ColumnarBatch:
        n = part.num_rows
        new_peer = self._single_peer_mask(part)
        rn = np.arange(1, n + 1, dtype=np.int64)
        # rank: row number at each peer-group start, broadcast over the group
        rank = np.maximum.accumulate(np.where(new_peer, rn, 0))
        dense = np.cumsum(new_peer)
        out_cols = list(part.columns)
        fields = list(part.schema.fields)
        for w in self.window_exprs:
            if w.kind == "agg":
                col, dt = self._window_agg(w, part, new_peer)
            elif w.kind in _COUNTERS:
                col, dt = self._counter_col(w, rn, rank, dense, part.capacity, part.device)
            else:
                raise NotImplementedError(f"window function {w.kind}")
            out_cols.append(col)
            fields.append(T.StructField(w.name, dt))
        out = ColumnarBatch(T.Schema(tuple(fields)), out_cols, n) \
            if self.output_window_cols else part
        if self.group_limit is not None:
            keep = np.nonzero(self._limit_vals(rn, rank, dense) <= self.group_limit)[0]
            if len(keep) < n:
                out = self._take(out, keep, ctx)
        return out

    def _range_frame_bounds(self, part: ColumnarBatch, lo, hi, n: int):
        """Per-row [start, end) over a RANGE frame: searchsorted against the
        partition's single numeric order key (input is sorted by it). Null
        order keys form their own run whose frame is exactly that run
        (Spark: null peers). Descending orders negate the key axis."""
        if len(self.order_spec) != 1:
            raise NotImplementedError("RANGE frame needs a single order key")
        so = self.order_spec[0]
        col = ExprEvaluator([so.child], part.schema).evaluate(part)[0]
        dt = E.infer_type(so.child, part.schema)
        valid = col.validity[:n].cpu().numpy()
        keys = np.where(valid, col.data[:n].cpu().numpy(), 0)
        if isinstance(dt, T.DecimalType):
            # the JAX package reads decimal keys as Decimal objects and
            # casts them to float64
            keys = np.array([float(Decimal(int(u)).scaleb(-dt.scale)) for u in keys.tolist()],
                            dtype=np.float64)
        elif isinstance(dt, (T.DateType, T.TimestampType)):
            keys = keys.astype(np.int64)
        if not np.issubdtype(keys.dtype, np.integer):
            keys = keys.astype(np.float64)  # ints stay exact (2^53+ keys)
        if not so.ascending:
            keys = -keys
        start = np.zeros(n, np.int64)
        end_excl = np.full(n, n, np.int64)
        if valid.all():
            nn_lo, kk = 0, keys
        elif not valid.any():
            # whole partition is one null peer run: every frame is all of it
            return start, end_excl
        else:
            # the null run is contiguous (sorted input): its rows frame over
            # the run itself for offset bounds; UNBOUNDED sides span the
            # whole partition. Non-null rows search the non-null span for
            # offset bounds, partition edges for unbounded ones.
            nn_idx = np.nonzero(valid)[0]
            nn_lo, nn_hi = int(nn_idx[0]), int(nn_idx[-1]) + 1
            if not valid[nn_lo:nn_hi].all():
                raise NotImplementedError("non-contiguous null order keys")
            null_rows = ~valid
            run_lo = 0 if null_rows[0] else nn_hi
            run_hi = nn_lo if null_rows[0] else n
            start[null_rows] = 0 if lo is None else run_lo
            end_excl[null_rows] = n if hi is None else run_hi
            kk = keys[nn_lo:nn_hi]
        if lo is not None:
            s = np.searchsorted(kk, keys + _offset(keys, lo), side="left") + nn_lo
            start[valid] = s[valid]
        else:
            start[valid] = 0
        if hi is not None:
            e = np.searchsorted(kk, keys + _offset(keys, hi), side="right") + nn_lo
            end_excl[valid] = e[valid]
        else:
            end_excl[valid] = n
        return start, end_excl

    def _window_agg(self, w: WindowExpr, part: ColumnarBatch, new_peer: np.ndarray):
        n = part.num_rows
        agg = w.agg
        nv, valid = self._agg_arg(w, part)
        F = E.AggFunction
        masked = np.where(valid, nv, 0) if nv.dtype != object else nv
        frame = tuple(w.frame) if w.frame is not None else None
        if frame is not None and frame[0] in ("rows", "range"):
            # ROWS: per-row [i+lo, i+hi] index windows. RANGE: value windows
            # resolved by searchsorted over the partition's sorted single
            # order key; CURRENT ROW bounds include peers.
            lo, hi = frame[1], frame[2]
            idx = np.arange(n)
            if frame[0] == "rows":
                start = np.zeros(n, np.int64) if lo is None else np.clip(idx + int(lo), 0, n)
                end_excl = np.full(n, n, np.int64) if hi is None else \
                    np.clip(idx + int(hi) + 1, 0, n)
            else:
                start, end_excl = self._range_frame_bounds(part, lo, hi, n)
            end_excl = np.maximum(end_excl, start)
            zero = masked[0] * 0 if n else 0  # object-safe (Decimal) zero
            cs0 = np.concatenate([[zero], np.cumsum(masked)])
            cc0 = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
            fsum = cs0[end_excl] - cs0[start]
            fcnt = cc0[end_excl] - cc0[start]
            if agg.fn in (F.MIN, F.MAX):
                fval = _frame_minmax(nv, valid, lo, hi, start, end_excl, agg.fn == F.MIN,
                                     fcnt > 0, general=frame[0] == "range")
        elif self.order_spec:
            csum = np.cumsum(masked)
            ccnt = np.cumsum(valid.astype(np.int64))
            # frame value at each row = value at its peer-group END
            grp = np.cumsum(new_peer) - 1
            last_idx_of_grp = np.concatenate([np.nonzero(new_peer)[0][1:] - 1, [n - 1]])
            end_idx = last_idx_of_grp[grp]
            fsum = csum[end_idx]
            fcnt = ccnt[end_idx]
            if agg.fn in (F.MIN, F.MAX):
                accfn = np.minimum if agg.fn == F.MIN else np.maximum
                fval = _masked_running(nv, valid, accfn, agg.fn == F.MIN)[end_idx]
        else:
            fsum = np.full(n, masked.sum())
            fcnt = np.full(n, int(valid.sum()))
            if agg.fn in (F.MIN, F.MAX):
                vv = [v for v, ok in zip(nv.tolist(), valid.tolist()) if ok]
                m = (min(vv) if agg.fn == F.MIN else max(vv)) if vv else None
                fval = np.array([m] * n, dtype=object)
        fvals = fval.tolist() if agg.fn in (F.MIN, F.MAX) else [None] * n
        return self._agg_result_col(w, part.schema, fsum.tolist(), fcnt.tolist(), fvals,
                                    part.capacity, part.device)


def _offset(keys: np.ndarray, off) -> np.ndarray:
    """Frame offset in the key's dtype (integer keys keep exact int64
    arithmetic; float offsets on int keys promote)."""
    if np.issubdtype(keys.dtype, np.integer) and float(off) == int(off):
        return np.int64(int(off))
    return np.float64(off)


def _frame_minmax(vals, valid, lo, hi, start, end_excl, is_min: bool,
                  has: np.ndarray, general: bool = False) -> np.ndarray:
    """Per-row min/max over ROWS-frame windows [start, end); ``has`` marks
    rows whose frame holds at least one valid value. Numeric values
    vectorize: finite (lo, hi) via sentinel-padded sliding windows,
    half-unbounded via running accumulates; object (decimal) values and
    RANGE value windows (``general``) scan each row's slice."""
    n = len(vals)
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    if lo is not None:
        lo = max(int(lo), -n)  # clamp: a huge PRECEDING offset must not
    if hi is not None:
        hi = min(int(hi), n)   # allocate that much sentinel padding
    if vals.dtype != object and not general:
        if np.issubdtype(vals.dtype, np.floating):
            sent = np.array(np.inf if is_min else -np.inf, vals.dtype)
        else:
            info = np.iinfo(vals.dtype)
            sent = np.array(info.max if is_min else info.min, vals.dtype)
        x = np.where(valid, vals, sent)
        red = np.minimum if is_min else np.maximum
        if lo is not None and hi is not None:
            w = int(hi) - int(lo) + 1
            if w <= 0:
                out[:] = None
                return out
            pad_lo = max(0, -int(lo))
            pad_hi = max(0, int(hi))
            xp = np.concatenate([np.full(pad_lo, sent, vals.dtype), x,
                                 np.full(pad_hi, sent, vals.dtype)])
            sw = np.lib.stride_tricks.sliding_window_view(xp, w)
            got = (sw.min(axis=1) if is_min else sw.max(axis=1))[
                np.arange(n) + int(lo) + pad_lo]
        elif lo is None:
            run = red.accumulate(x)  # unbounded preceding .. i+hi
            got = run[np.clip(end_excl - 1, 0, n - 1)]
        else:
            run = red.accumulate(x[::-1])[::-1]  # i+lo .. unbounded following
            got = run[np.clip(start, 0, n - 1)]
        out[has] = got[has]
        out[~has] = None
        return out
    better = (lambda a, b: a < b) if is_min else (lambda a, b: a > b)
    for i in range(n):
        best = None
        for j in range(int(start[i]), int(end_excl[i])):
            if valid[j]:
                v = vals[j]
                if best is None or better(v, best):
                    best = v
        out[i] = best
    return out


def _masked_running(vals, valid, accfn, is_min: bool):
    """Running min/max ignoring invalid entries (numpy accumulate with
    sentinel substitution)."""
    if vals.dtype == object:
        out = np.empty(len(vals), dtype=object)
        cur = None
        better = (lambda a, b: a < b) if is_min else (lambda a, b: a > b)
        for i, (v, ok) in enumerate(zip(vals.tolist(), valid.tolist())):
            if ok and (cur is None or better(v, cur)):
                cur = v
            out[i] = cur
        return out
    if np.issubdtype(vals.dtype, np.floating):
        sent = np.inf if is_min else -np.inf
    else:
        info = np.iinfo(vals.dtype)
        sent = info.max if is_min else info.min
    return accfn.accumulate(np.where(valid, vals, sent))
