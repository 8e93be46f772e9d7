"""Engine configuration: the ``Config`` fields the PyTorch port reads.

A copy of the fields of the JAX package's ``config.py`` that the ported
slice (scan -> filter -> partial agg -> hash exchange -> final agg ->
top-k) consults, with the same names and defaults, so a plan behaves the
same under both packages. Fields for subsystems not ported yet are left
out rather than accepted and ignored.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Rows per batch; powers of two match the capacity bucketing.
    batch_size: int = 262144

    # Device FINAL/PARTIAL_MERGE aggregation buffers all partial-state
    # batches before one merge kernel call. The host spill table the JAX
    # package falls back to beyond this is not ported: past it the merge
    # raises NotImplementedError (ROADMAP.md Queue 2).
    device_merge_max_bytes: int = 256 << 20

    # Upper bound on the dense slot-table size (product of per-key rounded
    # ranges) of the partial aggregate.
    dense_agg_max_buckets: int = 65536

    # Upper bound on the radix slot-table size; key spaces beyond it need
    # the sort-path aggregate, which is not ported (NotImplementedError).
    radix_agg_max_slots: int = 1 << 22

    # Number of radix buckets (power of two) of the per-bucket (rows,
    # groups) histogram the radix partial pass reports.
    radix_agg_buckets: int = 256

    # AQE reducer coalescing: adjacent reducer partitions below the
    # advisory size merge into one read task.
    coalesce_partitions_enable: bool = True
    advisory_partition_bytes: int = 8 << 20

    # Capacity bucketing: device buffers are padded up to the next power of
    # two >= min_capacity.
    min_capacity: int = 256

    def capacity_for(self, n: int) -> int:
        cap = self.min_capacity
        while cap < n:
            cap <<= 1
        return cap
