"""Whole-stage fused operator: one generated kernel per chain segment.

The counterpart of blaze_tpu/ops/fused.py. ``ir/fusion.py`` decides what
to fuse; this operator runs it. A FusedStage's ops are lowered to steps
and split at coalesce-batches boundaries into segments. Each segment runs
per batch as one K11 launch (``exprs/fused_triton.py``: every project,
filter, rename and expand step of the segment in one kernel, filters
narrowing a live mask, and every filtered output group compacted by the
same launch), so a project-over-filter-over-project chain costs one
launch and one count sync a batch, as a lone FilterExec does. Kernels are cached
process-wide by segment fingerprint, shared across queries; each batch
counts a ``jit_cache_hits`` or ``jit_cache_misses`` against that cache.

Under a device mesh (``Config(multichip_enabled=True)`` and a
``ShardedFusedRunner`` of n > 1 slots in the session's resources under
``__sharded_fused__``, parallel/mesh.py) consecutive batches of one
capacity stack up to n and run as one stacked K11 launch with one count
sync for the stack; a capacity change or the stream's end flushes the
stack, and a stack of one runs alone (the JAX package's
``_fused_stream_sharded``). Each batch's result is the single-batch
kernel's.

A partial aggregate directly above a stage of one segment of project,
filter and rename steps absorbs it (``absorbable_segment``; ops/agg.py,
K18): the stage then never runs, and the aggregate counts its
``fused_stages`` and ``fused_ops`` on the session.

Not ported: the JAX package's per-batch eager fallback and its
``_BROKEN`` trip. The port has no host columns, so a batch that is not
all device columns of one capacity raises, and so does a kernel that
fails to build or launch. A failed stacked dispatch raises too, where the
JAX package retries the stack batch by batch.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

from blaze_tpu_torch.core import kernels
from blaze_tpu_torch.core.batch import ColumnarBatch, DeviceColumn
from blaze_tpu_torch.exprs.compiler import fused_chain_schemas, fused_group_flags
from blaze_tpu_torch.exprs.fused_triton import FusedKernel
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ir import types as T
from blaze_tpu_torch.ir.fusion import chain_steps, fused_fingerprint
from blaze_tpu_torch.ops.base import Operator
from blaze_tpu_torch.ops.basic import coalesce_stream

# the resource under which a session with a device mesh registers its
# ShardedFusedRunner (parallel/mesh.py)
SHARDED_FUSED = "__sharded_fused__"

# process-wide kernel cache: segment fingerprint -> FusedKernel, shared
# across batches, partitions and queries
_KERNELS: Dict[str, FusedKernel] = {}
_CACHE_LOCK = threading.Lock()


def clear_fused_cache() -> None:
    """Drop every cached segment kernel (tests)."""
    with _CACHE_LOCK:
        _KERNELS.clear()


class _FusedSegment:
    """One run of non-coalesce steps: one kernel."""

    def __init__(self, steps, in_schema: T.Schema):
        self.steps = steps
        self.in_schema = in_schema
        self.out_schema = fused_chain_schemas(in_schema, steps)[-1]
        self.group_flags = fused_group_flags(steps)
        self.fingerprint = fused_fingerprint(in_schema, steps)

    def kernel(self) -> Tuple[FusedKernel, bool]:
        """The segment's cached kernel and whether the cache held it."""
        with _CACHE_LOCK:
            k = _KERNELS.get(self.fingerprint)
            if k is not None:
                return k, True
            k = _KERNELS[self.fingerprint] = FusedKernel(self.in_schema, self.steps,
                                                         self.fingerprint)
            return k, False


class FusedStageExec(Operator):
    """Runs a fused chain: segments and coalesce staging in chain order.
    ``metrics`` counts fused_stages, fused_ops and the kernel cache's hits
    and misses."""

    def __init__(self, child: Operator, node: N.FusedStage):
        super().__init__(node.output_schema, [child])
        self.node = node
        self.metrics = collections.Counter()
        self.pipeline: list = []  # ("coalesce", batch_size) | _FusedSegment
        schema = child.schema
        run: list = []
        for st in chain_steps(node.ops):
            if st[0] == "coalesce":
                if run:
                    seg = _FusedSegment(tuple(run), schema)
                    self.pipeline.append(seg)
                    schema = seg.out_schema
                    run = []
                self.pipeline.append(("coalesce", st[1]))
            else:
                run.append(st)
        if run:
            self.pipeline.append(_FusedSegment(tuple(run), schema))

    def absorbable_segment(self) -> Optional[_FusedSegment]:
        """The stage's one segment, when a partial aggregate above it may
        absorb it into its input kernel (ops/agg.py, K18): no coalesce, only
        project / filter / rename steps, and every input column a device
        plane (blaze_tpu/ops/agg.py:220-248); else None."""
        if len(self.pipeline) != 1 or not isinstance(self.pipeline[0], _FusedSegment):
            return None
        seg = self.pipeline[0]
        if any(st[0] not in ("project", "filter", "rename") for st in seg.steps) or \
                any(T.torch_dtype(f.dtype) is None for f in seg.in_schema.fields):
            return None
        return seg

    def _execute(self, partition, ctx):
        segs = [p for p in self.pipeline if isinstance(p, _FusedSegment)]
        self.metrics["fused_stages"] += len(segs)
        self.metrics["fused_ops"] += len(self.node.ops)
        stream = self.execute_child(0, partition, ctx)
        schema = self.children[0].schema
        runner = ctx.resources.get(SHARDED_FUSED) if ctx.conf.multichip_enabled else None
        for part in self.pipeline:
            if isinstance(part, _FusedSegment):
                stream = self._fused_stream(stream, part) if runner is None or runner.n <= 1 \
                    else self._fused_stream_sharded(stream, part, runner)
                schema = part.out_schema
            else:
                stream = coalesce_stream(stream, schema, part[1] or ctx.conf.batch_size,
                                         ctx.conf)
        yield from stream

    @staticmethod
    def _check_fusable(batch: ColumnarBatch) -> None:
        cols = batch.columns
        if not all(isinstance(c, DeviceColumn) for c in cols) or \
                len({c.capacity for c in cols}) != 1:
            raise ValueError(
                "a fused stage takes batches of one-plane device columns of one "
                f"capacity; got {[(c.dtype, c.capacity) for c in cols]}")

    def _fused_stream(self, stream, seg: _FusedSegment):
        for batch in stream:
            self._check_fusable(batch)
            cols = batch.columns
            kernel, hit = seg.kernel()
            self.metrics["jit_cache_hits" if hit else "jit_cache_misses"] += 1
            groups, counts = kernels.fused_chain(
                seg.in_schema, seg.steps, [c.data for c in cols],
                [c.validity for c in cols], batch.num_rows, kernel=kernel)
            yield from self._emit_groups(seg, groups, counts)

    def _fused_stream_sharded(self, stream, seg: _FusedSegment, runner):
        """Stacks of up to ``runner.n`` consecutive batches of one capacity,
        each one stacked dispatch; a lone batch runs alone."""
        staged: list = []
        seen = False

        def flush():
            nonlocal seen
            stack, staged[:] = list(staged), []
            if len(stack) == 1:
                yield from self._fused_stream(iter(stack), seg)
                return
            kernel, hit = seg.kernel()
            self.metrics["jit_cache_hits" if hit else "jit_cache_misses"] += 1
            outs = runner.dispatch(kernel, [[c.data for c in b.columns] for b in stack],
                                   [[c.validity for c in b.columns] for b in stack],
                                   [b.num_rows for b in stack])
            if not seen:
                seen = True
                self.metrics["sharded_stages"] += 1
                runner.counters["sharded_stages"] += 1
            self.metrics["sharded_batches"] += len(stack)
            for b, (groups, counts) in zip(stack, outs):
                yield from self._emit_groups(seg, groups, counts)

        for batch in stream:
            self._check_fusable(batch)
            if staged and batch.capacity != staged[0].capacity:
                yield from flush()
            staged.append(batch)
            if len(staged) >= runner.n:
                yield from flush()
        if staged:
            yield from flush()

    @staticmethod
    def _emit_groups(seg: _FusedSegment, groups, counts):
        """One batch's output groups; ``counts`` per group, host ints (a
        filtered group that kept no row is left out)."""
        for g, ((datas, valids), count) in enumerate(zip(groups, counts)):
            if seg.group_flags[g] and count == 0:
                continue
            cols = [DeviceColumn(f.dtype, d, v)
                    for f, d, v in zip(seg.out_schema.fields, datas, valids)]
            yield ColumnarBatch(seg.out_schema, cols, count)
