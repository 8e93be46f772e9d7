"""Engine configuration: the ``Config`` fields the PyTorch port reads.

A copy of the fields of the JAX package's ``config.py`` that the ported
slices consult, with the same names, so a plan behaves the same under
both packages; a None whose JAX meaning reads the backend is "on" here. Fields for subsystems not ported yet are left
out rather than accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # Rows per batch; powers of two match the capacity bucketing.
    batch_size: int = 262144

    # Device FINAL/PARTIAL_MERGE aggregation buffers all partial-state
    # batches before one merge kernel call. Past this many bytes the staged
    # batches and the rest of the stream go to the host aggregation table
    # (ops/agg.py ``AggTable``, ROADMAP.md Queue 1 item 3), as the JAX
    # package's spill table does.
    device_merge_max_bytes: int = 256 << 20

    # The slot-table routes of the grouped aggregation (K3/K4): dense_agg
    # for the partial aggregate's small tables, radix_agg for its large
    # ones and for the merge. True/False force a route, as in the JAX
    # package; None keeps the port's default, which takes them wherever an
    # integer-keyed plan fits (the JAX package's None means "on a CPU
    # backend only", and the port has no backend hint). Where a route is
    # off or no plan fits, the aggregate takes the sort route (K10).
    dense_agg: Optional[bool] = None
    radix_agg: Optional[bool] = None

    # Upper bound on the dense slot-table size (product of per-key rounded
    # ranges) of the partial aggregate.
    dense_agg_max_buckets: int = 65536

    # Upper bound on the radix slot-table size; key spaces beyond it take
    # the sort route.
    radix_agg_max_slots: int = 1 << 22

    # Number of radix buckets (power of two) of the per-bucket (rows,
    # groups) histogram the radix partial pass reports.
    radix_agg_buckets: int = 256

    # Adaptive partial skipping (the JAX package's config.py:168-172): a
    # PARTIAL aggregate that supports skipping stops aggregating once, after
    # ``partial_agg_skipping_min_rows`` rows, its estimated groups per row
    # pass ``partial_agg_skipping_ratio``; the rest of the task's batches
    # then pass through as one singleton state a row (K19, ops/agg.py).
    partial_agg_skipping_enable: bool = True
    partial_agg_skipping_ratio: float = 0.9
    partial_agg_skipping_min_rows: int = 50_000

    # AQE reducer coalescing: adjacent reducer partitions below the
    # advisory size merge into one read task.
    coalesce_partitions_enable: bool = True
    advisory_partition_bytes: int = 8 << 20

    # Shuffled hash join: a build side past either threshold falls back to
    # a sort-merge join in the JAX package. SMJ is not ported: past them
    # the port raises NotImplementedError (ROADMAP.md). The JAX package's
    # smj_fallback_enable switch is left out: the port has no fallback
    # to switch off.
    smj_fallback_rows_threshold: int = 10_000_000
    smj_fallback_mem_size_threshold: int = 1 << 30

    # Filter -> agg and join -> agg fusion (ops/agg.py, row 10): the
    # partial hash aggregate absorbs a Filter under it, else a one-segment
    # fused stage, else the unique-key inner broadcast joins under it, and
    # one generated kernel (K18, exprs/fused_triton.py) per batch probes
    # the joins, runs the steps and predicates and writes the aggregate's
    # keys and arguments with a live mask for K3/K10, with no compaction
    # and no joined batch. None is the port's default, on (the JAX
    # package's None means "on a CPU backend only", as for dense_agg);
    # False builds the unfused route exactly.
    fused_filter_agg: Optional[bool] = None

    # Whole-stage fusion (ir/fusion.py): maximal chains of project /
    # filter / rename / expand (with coalesce-batches as a staging point
    # between segments) run as one FusedStageExec, each segment one
    # generated Triton kernel (K11) per batch plus one K1 compaction per
    # filtered output group. False builds the exact unfused operator tree.
    fusion_enabled: bool = True

    # The device mesh (parallel/mesh.py). The reducer outputs of a mesh
    # exchange stay device-resident only while the total payload across
    # the session's live exchanges stays below this; the session debits
    # each resident exchange from it, and anything beyond it lands in host
    # memory and is uploaded when its reducer reads it.
    mesh_device_resident_max_bytes: int = 128 << 20

    # Per-slot, per-round byte budget of the compacted mesh exchange's send
    # buffers. The segment capacity is the largest per-(slot, reducer) row
    # count; one skewed reducer would pad every segment to its size, so past
    # this budget the exchange runs several bounded rounds instead.
    mesh_exchange_round_bytes: int = 256 << 20

    # Multichip execution: a Session without an explicit ``mesh=`` builds
    # one from this config (one slot per visible device, at most
    # multichip_devices of them, 0 = all; a mesh spanning several cards
    # raises, ROADMAP item 15), every ShuffleExchange rides
    # the mesh's all-to-all, and fused stages stack same-shape batches (the
    # stacked K11). Off by default.
    multichip_enabled: bool = False
    multichip_devices: int = 0

    # Capacity bucketing: device buffers are padded up to the next power of
    # two >= min_capacity.
    min_capacity: int = 256

    def capacity_for(self, n: int) -> int:
        cap = self.min_capacity
        while cap < n:
            cap <<= 1
        return cap
