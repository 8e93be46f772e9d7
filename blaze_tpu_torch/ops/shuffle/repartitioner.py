"""Row -> partition routing for the in-process exchange.

Counterpart of blaze_tpu/ops/shuffle/repartitioner.py for the slice:
``HashPartitioner`` is Spark's HashPartitioning (murmur3 seed 42, pmod n;
kernel K2, exprs/spark_hash.py), ``SinglePartitioner`` the collapse to one
partition. ``bucketize`` splits a batch into per-partition device
sub-batches with one stable sort by partition id (K5, one operand), one
gather (K6) and contiguous slices (K7), as the JAX package's device tier
does. Round-robin and
range partitioning are not ported (ROADMAP.md Queue 1 item 9, row 12).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from blaze_tpu_torch.core import kernels as K
from blaze_tpu_torch.core.batch import ColumnarBatch
from blaze_tpu_torch.exprs import spark_hash
from blaze_tpu_torch.exprs.compiler import ExprEvaluator, require_narrow_key
from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import nodes as N


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
        order = K.lexsort_indices([pids])
        counts = torch.bincount(pids.to(torch.int64),
                                minlength=self.num_partitions).tolist()
        gathered = batch.take(order, conf)
        out = []
        start = 0
        for pid, c in enumerate(counts):
            if c:
                out.append((pid, gathered.slice(start, c, conf)))
            start += c
        return out


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


def create_repartitioner(partitioning, schema) -> Repartitioner:
    if isinstance(partitioning, N.SinglePartitioning) or \
            partitioning.num_partitions == 1:
        return SinglePartitioner()
    if isinstance(partitioning, N.HashPartitioning):
        return HashPartitioner(partitioning.exprs, partitioning.num_partitions,
                               schema)
    raise NotImplementedError(
        f"{type(partitioning).__name__} is not ported to the PyTorch package "
        "yet (ROADMAP.md Queue 1 item 9, row 12)")
