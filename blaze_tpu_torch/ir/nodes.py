"""Physical plan IR — one node per operator.

Equivalent coverage to the reference's ``PhysicalPlanNode`` oneof
(``native-engine/auron-serde/proto/auron.proto:27-55``, 25 operators):
debug, shuffle_writer, ipc_reader, ipc_writer, parquet_scan, projection,
sort, filter, union, sort_merge_join, hash_join, broadcast_join_build_hash_map,
broadcast_join, rename_columns, empty_partitions, agg, limit, ffi_reader,
coalesce_batches, expand, rss_shuffle_writer, window, generate, parquet_sink,
orc_scan.

Each node computes its output schema; the executor (runtime/executor.py) maps
nodes to operators the way ``from_proto.rs:118-735`` maps proto nodes to
DataFusion ExecutionPlans.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch.ir import exprs as E
from blaze_tpu_torch.ir import types as T


class PlanNode:
    def children(self) -> List["PlanNode"]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, PlanNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(x for x in v if isinstance(x, PlanNode))
        return out

    @property
    def output_schema(self) -> T.Schema:
        raise NotImplementedError


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"
    EXISTENCE = "existence"


class JoinSide(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


# --- partitioning (reference: PhysicalRepartition oneof, auron.proto:629-656) --


@dataclasses.dataclass
class SinglePartitioning:
    num_partitions: int = 1


@dataclasses.dataclass
class HashPartitioning:
    exprs: List[E.Expr]
    num_partitions: int


@dataclasses.dataclass
class RoundRobinPartitioning:
    num_partitions: int


@dataclasses.dataclass
class RangePartitioning:
    sort_orders: List[E.SortOrder]
    num_partitions: int
    # sampled upper bounds per partition, shipped by the driver as rows of the
    # sort-key schema (reference: list literal in proto :650-655)
    bounds: List[tuple]


Partitioning = Any  # union of the four above


# --- scan sources -------------------------------------------------------------


@dataclasses.dataclass
class FileRange:
    start: int
    end: int


@dataclasses.dataclass
class PartitionedFile:
    path: str
    size: int
    range: Optional[FileRange] = None
    # partition-directory values, one per partition column
    partition_values: Tuple[Any, ...] = ()


@dataclasses.dataclass
class FileGroup:
    files: List[PartitionedFile]


@dataclasses.dataclass
class FileScanConf:
    """Reference: FileScanExecConf in auron.proto — file groups (one per
    output partition), file schema, projection, partition schema."""

    file_groups: List[FileGroup]
    file_schema: T.Schema
    projection: List[int]
    partition_schema: T.Schema = dataclasses.field(default_factory=lambda: T.Schema(()))

    @property
    def output_schema(self) -> T.Schema:
        proj = self.file_schema.select(self.projection)
        return proj + self.partition_schema


# --- leaf nodes ---------------------------------------------------------------


@dataclasses.dataclass
class ParquetScan(PlanNode):
    conf: FileScanConf
    predicate: Optional[E.Expr] = None

    @property
    def output_schema(self):
        return self.conf.output_schema


@dataclasses.dataclass
class OrcScan(PlanNode):
    conf: FileScanConf
    predicate: Optional[E.Expr] = None
    force_positional_evolution: bool = False

    @property
    def output_schema(self):
        return self.conf.output_schema


@dataclasses.dataclass
class IpcReader(PlanNode):
    """Reads shuffle/broadcast blocks from a block provider registered in the
    resource map (reference: IpcReaderExecNode + JNI BlockObject iterator)."""

    schema: T.Schema
    resource_id: str
    num_partitions: int = 1

    @property
    def output_schema(self):
        return self.schema


@dataclasses.dataclass
class BatchSource(PlanNode):
    """Serves pre-materialized ColumnarBatches from the resource map (the
    session-internal landing node for the ICI mesh exchange — the reducer
    side's analogue of IpcReader when rows arrived over a collective instead
    of shuffle files). The resource is ``partition -> list[ColumnarBatch]``
    or an indexable of per-partition batch lists."""

    schema: T.Schema
    resource_id: str
    num_partitions: int = 1

    @property
    def output_schema(self):
        return self.schema


@dataclasses.dataclass
class FFIReader(PlanNode):
    """Imports host-produced batches (reference: FFIReaderExecNode, the
    ConvertToNative path). In this package the resource is a callable
    partition -> iterable of numpy column mappings or ColumnarBatches
    (ops/shuffle/reader.py)."""

    schema: T.Schema
    resource_id: str
    num_partitions: int = 1

    @property
    def output_schema(self):
        return self.schema


@dataclasses.dataclass
class EmptyPartitions(PlanNode):
    schema: T.Schema
    num_partitions: int

    @property
    def output_schema(self):
        return self.schema


# --- unary nodes --------------------------------------------------------------


@dataclasses.dataclass
class Projection(PlanNode):
    child: PlanNode
    exprs: List[E.Expr]
    names: List[str]

    @property
    def output_schema(self):
        ischema = self.child.output_schema
        return T.Schema(
            tuple(
                T.StructField(n, E.infer_type(e, ischema))
                for n, e in zip(self.names, self.exprs)
            )
        )


@dataclasses.dataclass
class Filter(PlanNode):
    child: PlanNode
    predicates: List[E.Expr]

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class Sort(PlanNode):
    child: PlanNode
    sort_orders: List[E.SortOrder]
    fetch_limit: Optional[int] = None

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class Limit(PlanNode):
    child: PlanNode
    limit: int

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class CoalesceBatches(PlanNode):
    child: PlanNode
    batch_size: int

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class RenameColumns(PlanNode):
    child: PlanNode
    renamed_names: List[str]

    @property
    def output_schema(self):
        return self.child.output_schema.rename(self.renamed_names)


@dataclasses.dataclass
class Debug(PlanNode):
    child: PlanNode
    debug_id: str = ""

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class Expand(PlanNode):
    child: PlanNode
    projections: List[List[E.Expr]]
    schema: T.Schema

    @property
    def output_schema(self):
        return self.schema


@dataclasses.dataclass
class FusedStage(PlanNode):
    """A maximal chain of narrow batch-local operators collapsed by the
    whole-stage fusion pass (``ir/fusion.py``) into one operator whose body
    is a single jitted XLA computation. ``ops`` holds the original chain
    nodes innermost-first (each still linked to its original child, so
    per-op schemas stay derivable); the executor evaluates their expressions
    inside one trace instead of building one operator per node."""

    child: PlanNode
    ops: Tuple[PlanNode, ...]

    def children(self) -> List["PlanNode"]:
        # ops are absorbed, not children: traversals must not walk the
        # original chain again (the base class would pick the tuple up)
        return [self.child]

    @property
    def output_schema(self):
        return self.ops[-1].output_schema


@dataclasses.dataclass
class AggColumn:
    """One output aggregate: expression + mode (reference: AggExprNode with
    per-agg AggMode in proto :672-686)."""

    agg: E.AggExpr
    mode: E.AggMode
    name: str


@dataclasses.dataclass
class Agg(PlanNode):
    """Hash/sort aggregation. Partial mode outputs grouping columns plus
    *typed* per-agg state columns (named ``<agg>#<field>``) — a columnar
    re-design of the reference's single opaque binary state column
    ``#9223372036854775807`` (agg/mod.rs:37, agg_ctx.rs:140); see
    ops/aggfns.py for why."""

    child: PlanNode
    exec_mode: E.AggExecMode
    groupings: List[Tuple[str, E.Expr]]  # (output name, grouping expr)
    aggs: List[AggColumn]
    supports_partial_skipping: bool = False

    @property
    def is_partial_output(self) -> bool:
        return all(a.mode in (E.AggMode.PARTIAL, E.AggMode.PARTIAL_MERGE) for a in self.aggs) and (
            len(self.aggs) > 0
        )

    @property
    def input_is_partial(self) -> bool:
        return bool(self.aggs) and all(
            a.mode in (E.AggMode.PARTIAL_MERGE, E.AggMode.FINAL) for a in self.aggs
        )

    @property
    def output_schema(self):
        from blaze_tpu_torch.ir.aggstate import agg_output_schema

        return agg_output_schema(self.child.output_schema, self.groupings,
                                 self.aggs, self.input_is_partial,
                                 self.is_partial_output)


@dataclasses.dataclass
class WindowExpr:
    """rank/dense_rank/row_number or an agg over the window frame
    (reference: WindowExprNode, window/mod.rs:49-84)."""

    kind: str  # "row_number" | "rank" | "dense_rank" | "agg"
    name: str
    agg: Optional[E.AggExpr] = None
    return_type: Optional[T.DataType] = None
    # explicit frame ("rows", lower, upper): offsets relative to the current
    # row, None = unbounded (reference: SpecifiedWindowFrame). None frame =
    # Spark's default (whole partition / RANGE unbounded..current).
    frame: Optional[tuple] = None


@dataclasses.dataclass
class Window(PlanNode):
    child: PlanNode
    window_exprs: List[WindowExpr]
    partition_spec: List[E.Expr]
    order_spec: List[E.SortOrder]
    group_limit: Optional[int] = None  # WindowGroupLimit pushdown
    output_window_cols: bool = True

    @property
    def output_schema(self):
        ischema = self.child.output_schema
        if not self.output_window_cols:
            return ischema
        extra = []
        for w in self.window_exprs:
            if w.kind == "agg":
                dt = w.return_type or E.infer_type(w.agg, ischema)
            else:
                dt = T.I32 if w.kind in ("rank", "dense_rank") else T.I64
                dt = w.return_type or dt
            extra.append(T.StructField(w.name, dt))
        return T.Schema(ischema.fields + tuple(extra))


@dataclasses.dataclass
class Generate(PlanNode):
    """explode/posexplode/json_tuple/UDTF (reference: GenerateExecNode)."""

    child: PlanNode
    generator: str  # "explode" | "pos_explode" | "json_tuple" | "udtf"
    generator_args: List[E.Expr]
    required_child_output: List[int]  # child column indices carried through
    generator_output: T.Schema
    outer: bool = False
    udtf: Any = None

    @property
    def output_schema(self):
        child_schema = self.child.output_schema.select(self.required_child_output)
        return child_schema + self.generator_output


# --- joins --------------------------------------------------------------------

def _join_output_schema(left: T.Schema, right: T.Schema, jt: JoinType,
                        existence_col: str = "exists#0") -> T.Schema:
    if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        return left
    if jt in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
        return right
    if jt == JoinType.EXISTENCE:
        return left + T.Schema((T.StructField(existence_col, T.BOOL, False),))

    def nullable(s: T.Schema) -> T.Schema:
        return T.Schema(tuple(T.StructField(f.name, f.dtype, True) for f in s.fields))

    # outer joins null-extend a side: its fields become nullable
    if jt == JoinType.LEFT:
        return left + nullable(right)
    if jt == JoinType.RIGHT:
        return nullable(left) + right
    if jt == JoinType.FULL:
        return nullable(left) + nullable(right)
    return left + right


@dataclasses.dataclass
class SortMergeJoin(PlanNode):
    left: PlanNode
    right: PlanNode
    on: List[Tuple[E.Expr, E.Expr]]
    join_type: JoinType
    sort_options: List[Tuple[bool, bool]] = None  # (ascending, nulls_first) per key
    # extra non-equi join condition evaluated over left+right columns
    # (reference: SMJ inequality-join option / join filters)
    condition: Optional[E.Expr] = None

    @property
    def output_schema(self):
        return _join_output_schema(
            self.left.output_schema, self.right.output_schema, self.join_type
        )


@dataclasses.dataclass
class HashJoin(PlanNode):
    """Shuffled hash join (reference routes this through BroadcastJoinExec
    with PartitionMode; we keep an explicit node)."""

    left: PlanNode
    right: PlanNode
    on: List[Tuple[E.Expr, E.Expr]]
    join_type: JoinType
    build_side: JoinSide = JoinSide.RIGHT
    condition: Optional[E.Expr] = None

    @property
    def output_schema(self):
        return _join_output_schema(
            self.left.output_schema, self.right.output_schema, self.join_type
        )


@dataclasses.dataclass
class BroadcastJoinBuildHashMap(PlanNode):
    child: PlanNode
    keys: List[E.Expr]

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class BroadcastJoin(PlanNode):
    left: PlanNode
    right: PlanNode
    on: List[Tuple[E.Expr, E.Expr]]
    join_type: JoinType
    broadcast_side: JoinSide = JoinSide.RIGHT
    # executor-level cache key for the built hash map (reference:
    # cached_build_hash_map_id, broadcast_join_exec.rs:87-116)
    cached_build_hash_map_id: str = ""
    condition: Optional[E.Expr] = None

    @property
    def output_schema(self):
        return _join_output_schema(
            self.left.output_schema, self.right.output_schema, self.join_type
        )


# --- set ops ------------------------------------------------------------------


@dataclasses.dataclass
class Union(PlanNode):
    """Multi-input union with partition mapping (reference: UnionExecNode
    carries num_partitions + per-input partition offsets)."""

    inputs: List[PlanNode]
    # None = resolved at build time to the stacked count of the inputs'
    # partitions (what the frontend emits for UnionExec: Spark unions
    # concatenate child partitions)
    num_partitions: Optional[int] = None
    # (input index, input partition) for each output partition; empty = stack
    # inputs' partitions in order
    in_partitions: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def output_schema(self):
        return self.inputs[0].output_schema


# --- driver-level exchange nodes ---------------------------------------------
# In the reference these boundaries are orchestrated by Spark
# (NativeShuffleExchangeBase / NativeBroadcastExchangeBase): the IR only
# carries shuffle_writer / ipc_reader / ipc_writer. Our standalone driver
# (runtime/session.py) accepts these higher-level nodes and lowers them to
# exactly those primitives: a map stage of ShuffleWriter tasks + an IpcReader
# over the produced file segments, or an IpcWriter collect + broadcast.


@dataclasses.dataclass
class ShuffleExchange(PlanNode):
    child: PlanNode
    partitioning: "Partitioning"

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class BroadcastExchange(PlanNode):
    child: PlanNode

    @property
    def output_schema(self):
        return self.child.output_schema


def map_children(node: PlanNode, fn):
    """Rebuild a node with fn applied to each child plan node."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            changes[f.name] = fn(v)
        elif isinstance(v, list) and v and all(isinstance(x, PlanNode) for x in v):
            changes[f.name] = [fn(x) for x in v]
    if not changes:
        return node
    return dataclasses.replace(node, **changes)


# --- sinks / exchanges --------------------------------------------------------


@dataclasses.dataclass
class ShuffleWriter(PlanNode):
    child: PlanNode
    partitioning: Partitioning
    output_data_file: str
    output_index_file: str

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class RssShuffleWriter(PlanNode):
    """Push-style shuffle into a remote-shuffle-service writer registered in
    the resource map (reference: RssShuffleWriterExecNode)."""

    child: PlanNode
    partitioning: Partitioning
    rss_writer_resource_id: str

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class IpcWriter(PlanNode):
    """Streams compressed batches to a host consumer callback (reference:
    IpcWriterExecNode — the broadcast collect path)."""

    child: PlanNode
    consumer_resource_id: str

    @property
    def output_schema(self):
        return self.child.output_schema


@dataclasses.dataclass
class ParquetSink(PlanNode):
    child: PlanNode
    fs_path: str
    num_dyn_parts: int = 0
    props: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def output_schema(self):
        return self.child.output_schema
