"""Plan IR -> operator tree (blaze_tpu/runtime/executor.py's ``_build``).

Whole-stage fusion (``ir/fusion.py``) is not ported: ``fusion_enabled=
False`` gives the JAX package this same tree, and q01 forms no fused
stage. A node outside the ported slices raises NotImplementedError naming
the ROADMAP item that ports it.
"""

from __future__ import annotations

from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ops.base import Operator


def build_operator(node: N.PlanNode) -> Operator:
    if isinstance(node, N.Projection):
        from blaze_tpu_torch.ops.basic import ProjectExec

        return ProjectExec(build_operator(node.child), node.exprs, node.names)
    if isinstance(node, N.Filter):
        from blaze_tpu_torch.ops.basic import FilterExec

        return FilterExec(build_operator(node.child), node.predicates)
    if isinstance(node, N.CoalesceBatches):
        from blaze_tpu_torch.ops.basic import CoalesceBatchesExec

        return CoalesceBatchesExec(build_operator(node.child), node.batch_size)
    if isinstance(node, N.Sort):
        from blaze_tpu_torch.ops.sort import SortExec

        return SortExec(build_operator(node.child), node.sort_orders,
                        node.fetch_limit)
    if isinstance(node, N.Agg):
        from blaze_tpu_torch.ops.agg import AggExec

        return AggExec(build_operator(node.child), node.exec_mode,
                       node.groupings, node.aggs, node.supports_partial_skipping)
    if isinstance(node, N.Window):
        from blaze_tpu_torch.ops.window import WindowExec

        return WindowExec(build_operator(node.child), node.window_exprs,
                          node.partition_spec, node.order_spec,
                          node.group_limit, node.output_window_cols)
    if isinstance(node, N.BroadcastJoin):
        from blaze_tpu_torch.ops.joins.bhj import BroadcastJoinExec

        return BroadcastJoinExec(build_operator(node.left), build_operator(node.right),
                                 node.on, node.join_type, node.broadcast_side,
                                 node.cached_build_hash_map_id, node.condition)
    if isinstance(node, N.HashJoin):
        from blaze_tpu_torch.ops.joins.bhj import HashJoinExec

        return HashJoinExec(build_operator(node.left), build_operator(node.right),
                            node.on, node.join_type, node.build_side,
                            node.condition)
    if isinstance(node, N.FFIReader):
        from blaze_tpu_torch.ops.shuffle.reader import FFIReaderExec

        return FFIReaderExec(node.schema, node.resource_id, node.num_partitions)
    if isinstance(node, N.BatchSource):
        from blaze_tpu_torch.ops.shuffle.reader import BatchSourceExec

        return BatchSourceExec(node.schema, node.resource_id, node.num_partitions)
    raise NotImplementedError(
        f"plan node {type(node).__name__} is not ported to the PyTorch package "
        "yet (ROADMAP.md Queue 1 items 9-11)")
