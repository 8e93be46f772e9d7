"""Row -> partition routing for the in-process exchange.

Counterpart of blaze_tpu/ops/shuffle/repartitioner.py:
``HashPartitioner`` is Spark's HashPartitioning (murmur3 seed 42, pmod n;
kernel K2, exprs/spark_hash.py), ``RoundRobinPartitioner`` deals rows out
in turn (ids continue across a map task's batches, from 0 in each task),
``RangePartitioner`` binary-searches the driver-sampled bounds (K14,
core/kernels.py ``range_partition_ids``), and ``SinglePartitioner`` is the
collapse to one partition. ``bucketize`` splits a batch into
per-partition device sub-batches as the JAX package's device tier does (a
stable sort by partition id, a gather by it, a slice per partition), in
two launches and one sync: K5's sort of the one-byte (or wider) ids,
whose histogram is the partition counts, the counts pulled to size the
outputs, then K7's split form, which writes every partition's planes
straight from the batch through the order.
"""

from __future__ import annotations

import datetime
import decimal
from typing import List, Tuple

import numpy as np
import torch

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch, column_planes
from blaze_tpu_torch.exprs import spark_hash
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, broadcast, require_narrow_key
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ops import sort_keys as SK

# scales a decimal bound without rounding
_EXACT = decimal.Context(prec=80)


class Repartitioner:
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        """(num_rows,) int32 partition id per row."""
        raise NotImplementedError

    def bucketize(self, batch: ColumnarBatch, conf=None
                  ) -> List[Tuple[int, ColumnarBatch]]:
        n = batch.num_rows
        if n == 0:
            return []
        if self.num_partitions == 1:
            return [(0, batch)]
        pids = self.partition_ids(batch)
        order, counts = K.partition_order(pids, self.num_partitions)
        counts = counts.tolist()  # the one sync: the outputs' sizes
        conf = conf or Config()
        parts = K.split_planes(*column_planes(batch.columns), order, counts,
                               [conf.capacity_for(c) for c in counts])
        return [(pid, ColumnarBatch(batch.schema, batch._rebuild(*planes), c))
                for pid, (c, planes) in enumerate(zip(counts, parts)) if c]


class SinglePartitioner(Repartitioner):
    def __init__(self):
        super().__init__(1)

    def partition_ids(self, batch):
        return torch.zeros(batch.num_rows, dtype=torch.int32, device=batch.device)


class HashPartitioner(Repartitioner):
    """murmur3(seed 42) pmod n — Spark's HashPartitioning routing."""

    def __init__(self, exprs: List[E.Expr], num_partitions: int, schema):
        super().__init__(num_partitions)
        for e in exprs:
            require_narrow_key(E.infer_type(e, schema), "hash partition key")
        self.ev = ExprEvaluator(exprs, schema)

    def partition_ids(self, batch):
        return spark_hash.partition_ids(self.ev.evaluate(batch), batch.num_rows,
                                        self.num_partitions)


class RoundRobinPartitioner(Repartitioner):
    """Round robin from a deterministic start, so a retried map task gives
    the same partitions; ids continue across the task's batches."""

    def __init__(self, num_partitions: int, start: int = 0):
        super().__init__(num_partitions)
        self.next_pid = start % max(num_partitions, 1)

    def partition_ids(self, batch):
        n = batch.num_rows
        pids = (torch.arange(n, dtype=torch.int64, device=batch.device)
                + self.next_pid) % self.num_partitions
        self.next_pid = int((self.next_pid + n) % self.num_partitions)
        return pids.to(torch.int32)


def _bound_value(dt: T.DataType, v):
    """A bound's Python value as its key plane's number (a decimal at the
    key's scale, which must hold it exactly)."""
    if isinstance(dt, T.DecimalType):
        scaled = decimal.Decimal(v).scaleb(dt.scale, _EXACT)
        if scaled != scaled.to_integral_value():
            raise ValueError(f"range bound {v!r} does not fit {dt!r}")
        return int(scaled)
    if isinstance(dt, T.DateType):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(dt, T.TimestampType):
        return (v - datetime.datetime(1970, 1, 1)) // datetime.timedelta(microseconds=1)
    return v


class RangePartitioner(Repartitioner):
    """bisect_right of each row's sort-key tuple over the sampled bounds
    (rows of the sort-key schema, Spark's RangePartitioning bounds). The
    bounds are normalised once per partitioner (the Session builds one an
    exchange), by the same key pass as the rows (K5), sorted, and kept on
    the device, on the card with K14's argument words and bound table (a
    ``RangePack``); each bucketize pass is one K14 launch, one K5 sort by
    id and one K7 split. Empty bounds put every row in partition 0."""

    def __init__(self, sort_orders: List[E.SortOrder], num_partitions: int,
                 bounds: List[tuple], schema):
        super().__init__(num_partitions)
        self.sort_orders = sort_orders
        self.bounds = bounds
        self.key_types = [E.infer_type(so.child, schema) for so in sort_orders]
        for t in self.key_types:
            require_narrow_key(t, "range partition key")
        self.spec = SK.key_spec(sort_orders)
        self.ev = ExprEvaluator([so.child for so in sort_orders], schema)
        self._dev_bounds = None
        self._key_dtypes = None
        self._pack = None

    def _device_bounds(self, device: torch.device) -> List[torch.Tensor]:
        """The bound rows as a batch of the sort-key schema, through K5's
        key pass and sort, sliced to the bound count (the batch pads to its
        capacity); on the card also K14's pack over them."""
        if self._dev_bounds is None:
            schema = T.Schema.of(*[(f"k{i}", t) for i, t in enumerate(self.key_types)])
            cols = {}
            for i, t in enumerate(self.key_types):
                vals = [b[i] for b in self.bounds]
                cols[f"k{i}"] = (np.array([0 if v is None else _bound_value(t, v)
                                           for v in vals]),
                                 np.array([v is not None for v in vals], bool))
            bb = ColumnarBatch.from_numpy(schema, cols, device)
            nb = len(self.bounds)
            self._dev_bounds = K.range_bound_operands(
                [c.data[:nb] for c in bb.columns], [c.validity[:nb] for c in bb.columns],
                self.spec)
            # the key planes' dtypes: the bound batch's, by the same schema
            self._key_dtypes = [c.data.dtype for c in bb.columns]
            if device.type == "cuda":
                self._pack = K.RangePack(self._dev_bounds, self.spec, self._key_dtypes)
        return self._dev_bounds

    def _key_planes(self, batch):
        datas, valids = [], []
        for so in self.sort_orders:
            d, v = broadcast(self.ev.eval(so.child, batch), batch)
            datas.append(d)
            valids.append(v)
        return datas, valids

    def partition_ids(self, batch):
        if not self.bounds:
            return torch.zeros(batch.num_rows, dtype=torch.int32, device=batch.device)
        datas, valids = self._key_planes(batch)
        bounds = self._device_bounds(batch.device)
        pids = K.range_partition_ids(datas, valids, batch.row_exists_mask(), bounds, self.spec,
                                     pack=self._pack)
        return pids[:batch.num_rows]


def create_repartitioner(partitioning, schema) -> Repartitioner:
    if isinstance(partitioning, N.SinglePartitioning) or \
            partitioning.num_partitions == 1:
        return SinglePartitioner()
    if isinstance(partitioning, N.HashPartitioning):
        return HashPartitioner(partitioning.exprs, partitioning.num_partitions,
                               schema)
    if isinstance(partitioning, N.RoundRobinPartitioning):
        return RoundRobinPartitioner(partitioning.num_partitions)
    if isinstance(partitioning, N.RangePartitioning):
        return RangePartitioner(partitioning.sort_orders, partitioning.num_partitions,
                                partitioning.bounds, schema)
    raise NotImplementedError(f"partitioning {partitioning!r}")
