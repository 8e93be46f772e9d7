"""Plan IR -> operator tree (blaze_tpu/runtime/executor.py).

Whole-stage fusion (``ir/fusion.py``) runs here, once at the root of every
build, as in the JAX package: the session builds each stage's tree after
lowering its exchanges, so the pass sees the lowered tree (the
CoalesceBatches over an exchange's reader included). The recursion below
uses ``_build``, so the agg-filter guard sees each node's parent. With
``Config(fusion_enabled=False)`` the pass returns the very node it was
given and the tree is the unfused one. A node outside the ported slices
raises NotImplementedError naming the ROADMAP items that port it.
"""

from __future__ import annotations

from typing import Optional

from blaze_tpu_torch.config import Config
from blaze_tpu_torch.ir import nodes as N
from blaze_tpu_torch.ops.base import Operator


def build_operator(node: N.PlanNode, conf: Optional[Config] = None) -> Operator:
    from blaze_tpu_torch.ir.fusion import fuse_plan

    return _build(fuse_plan(node, conf or Config()))


def _build(node: N.PlanNode) -> Operator:
    if isinstance(node, N.FusedStage):
        from blaze_tpu_torch.ops.fused import FusedStageExec

        return FusedStageExec(_build(node.child), node)
    if isinstance(node, N.RenameColumns):
        from blaze_tpu_torch.ops.basic import RenameColumnsExec

        return RenameColumnsExec(_build(node.child), node.renamed_names)
    if isinstance(node, N.Expand):
        from blaze_tpu_torch.ops.basic import ExpandExec

        return ExpandExec(_build(node.child), node.projections, node.schema)
    if isinstance(node, N.Projection):
        from blaze_tpu_torch.ops.basic import ProjectExec

        return ProjectExec(_build(node.child), node.exprs, node.names)
    if isinstance(node, N.Filter):
        from blaze_tpu_torch.ops.basic import FilterExec

        return FilterExec(_build(node.child), node.predicates)
    if isinstance(node, N.CoalesceBatches):
        from blaze_tpu_torch.ops.basic import CoalesceBatchesExec

        return CoalesceBatchesExec(_build(node.child), node.batch_size)
    if isinstance(node, N.Sort):
        from blaze_tpu_torch.ops.sort import SortExec

        return SortExec(_build(node.child), node.sort_orders,
                        node.fetch_limit)
    if isinstance(node, N.Agg):
        from blaze_tpu_torch.ops.agg import AggExec

        return AggExec(_build(node.child), node.exec_mode,
                       node.groupings, node.aggs, node.supports_partial_skipping)
    if isinstance(node, N.Window):
        from blaze_tpu_torch.ops.window import WindowExec

        return WindowExec(_build(node.child), node.window_exprs,
                          node.partition_spec, node.order_spec,
                          node.group_limit, node.output_window_cols)
    if isinstance(node, N.BroadcastJoin):
        from blaze_tpu_torch.ops.joins.bhj import BroadcastJoinExec

        return BroadcastJoinExec(_build(node.left), _build(node.right),
                                 node.on, node.join_type, node.broadcast_side,
                                 node.cached_build_hash_map_id, node.condition)
    if isinstance(node, N.HashJoin):
        from blaze_tpu_torch.ops.joins.bhj import HashJoinExec

        return HashJoinExec(_build(node.left), _build(node.right),
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
        "yet (ROADMAP.md Queue 1 items 6c, 8, 11, 12 and 17)")
