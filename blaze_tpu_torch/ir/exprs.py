"""Expression IR.

Equivalent coverage to the reference's ``PhysicalExprNode`` oneof
(``native-engine/auron-serde/proto/auron.proto:58-119``): column refs,
literals, binary ops, null checks, case/cast/try_cast, in-list, like,
short-circuit and/or, scalar functions, string fast paths, row_num,
get_indexed_field / get_map_value / named_struct, bloom-filter probe,
python-UDF wrapper, scalar subquery, and aggregate expressions
(``AggFunction``/``AggMode`` enums, proto ``:127-141,687-700``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Tuple

from blaze_tpu_torch.ir import types as T


class Expr:
    """Base expression node."""

    def children(self) -> List["Expr"]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Expr):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(x for x in v if isinstance(x, Expr))
        return out


@dataclasses.dataclass
class Column(Expr):
    """By-name column reference (reference: PhysicalColumn)."""

    name: str


@dataclasses.dataclass
class BoundReference(Expr):
    """By-index column reference (reference: BoundReference)."""

    index: int


@dataclasses.dataclass
class Literal(Expr):
    """Typed literal; value None means typed NULL. The reference ships
    literals as single-row Arrow IPC (auron.proto:824-826); we carry the
    python value + IR type."""

    value: Any
    dtype: T.DataType


class BinaryOp(str, enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    EQ = "=="
    NEQ = "!="
    LT = "<"
    LTEQ = "<="
    GT = ">"
    GTEQ = ">="
    AND = "and"
    OR = "or"
    BIT_AND = "&"
    BIT_OR = "|"
    BIT_XOR = "^"
    SHIFT_LEFT = "<<"
    SHIFT_RIGHT = ">>"


_COMPARISON_OPS = {BinaryOp.EQ, BinaryOp.NEQ, BinaryOp.LT, BinaryOp.LTEQ,
                   BinaryOp.GT, BinaryOp.GTEQ}
_LOGICAL_OPS = {BinaryOp.AND, BinaryOp.OR}


@dataclasses.dataclass
class BinaryExpr(Expr):
    op: BinaryOp
    left: Expr
    right: Expr
    # Spark decimal arithmetic promotes precision/scale; the converter records
    # the result type here (reference: NativeConverters.scala:521-697).
    result_type: Optional[T.DataType] = None

    def __post_init__(self):
        if isinstance(self.op, str):
            self.op = BinaryOp(self.op)


@dataclasses.dataclass
class IsNull(Expr):
    child: Expr


@dataclasses.dataclass
class IsNotNull(Expr):
    child: Expr


@dataclasses.dataclass
class Not(Expr):
    child: Expr


@dataclasses.dataclass
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END (searched form; the optional
    case-operand form is desugared by the converter into equality whens)."""

    branches: List[Tuple[Expr, Expr]]
    else_expr: Optional[Expr] = None

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.else_expr is not None:
            out.append(self.else_expr)
        return out


@dataclasses.dataclass
class Cast(Expr):
    """Spark-semantics cast (reference: spark-compatible cast in
    datafusion-ext-commons/src/arrow/cast.rs)."""

    child: Expr
    dtype: T.DataType


@dataclasses.dataclass
class TryCast(Expr):
    """Cast that yields NULL on conversion failure instead of erroring."""

    child: Expr
    dtype: T.DataType


@dataclasses.dataclass
class InList(Expr):
    child: Expr
    values: List[Expr]
    negated: bool = False


@dataclasses.dataclass
class Like(Expr):
    child: Expr
    pattern: str
    negated: bool = False
    escape_char: str = "\\"
    case_insensitive: bool = False


@dataclasses.dataclass
class ScalarFunction(Expr):
    """Named scalar function with Spark semantics (reference:
    datafusion-ext-functions crate + DataFusion built-ins)."""

    name: str
    args: List[Expr]
    return_type: Optional[T.DataType] = None


@dataclasses.dataclass
class StringStartsWith(Expr):
    child: Expr
    prefix: str


@dataclasses.dataclass
class StringEndsWith(Expr):
    child: Expr
    suffix: str


@dataclasses.dataclass
class StringContains(Expr):
    child: Expr
    infix: str


@dataclasses.dataclass
class RowNum(Expr):
    """Stateful monotonically-increasing row number across a partition's
    stream (reference: datafusion-ext-exprs RowNum)."""


@dataclasses.dataclass
class GetIndexedField(Expr):
    child: Expr
    ordinal: Expr  # array index (0-based after converter adjustment) or struct field ordinal


@dataclasses.dataclass
class GetMapValue(Expr):
    child: Expr
    key: Expr


@dataclasses.dataclass
class NamedStruct(Expr):
    names: List[str]
    exprs: List[Expr]
    dtype: Optional[T.StructType] = None


@dataclasses.dataclass
class BloomFilterMightContain(Expr):
    bloom_filter: Expr  # binary column/literal holding a serialized SparkBloomFilter
    value: Expr


@dataclasses.dataclass
class PyUDF(Expr):
    """Host-callback UDF: the analogue of the reference's SparkUDFWrapperExpr
    JNI round-trip — here a python callable invoked per batch on host."""

    fn: Any  # Callable[..., np.ndarray] over host arrays
    args: List[Expr]
    return_type: T.DataType = None
    name: str = "pyudf"


@dataclasses.dataclass
class ScalarSubquery(Expr):
    """Pre-evaluated scalar subquery result (the frontend evaluates and ships
    the value, as the reference does)."""

    value: Any
    dtype: T.DataType


# --- sort / aggregate ---------------------------------------------------------


@dataclasses.dataclass
class SortOrder(Expr):
    child: Expr
    ascending: bool = True
    nulls_first: bool = True


class AggFunction(enum.Enum):
    MIN = "min"
    MAX = "max"
    SUM = "sum"
    AVG = "avg"
    COUNT = "count"
    COLLECT_LIST = "collect_list"
    COLLECT_SET = "collect_set"
    FIRST = "first"
    FIRST_IGNORES_NULL = "first_ignores_null"
    BLOOM_FILTER = "bloom_filter"
    # brickhouse UDAFs the reference ships natively (auron.proto AggFunction
    # BRICKHOUSE_COLLECT / BRICKHOUSE_COMBINE_UNIQUE, agg/brickhouse.rs)
    BRICKHOUSE_COLLECT = "brickhouse_collect"
    BRICKHOUSE_COMBINE_UNIQUE = "brickhouse_combine_unique"
    UDAF = "udaf"


class AggMode(enum.Enum):
    PARTIAL = "partial"          # raw input -> state output
    PARTIAL_MERGE = "partial_merge"  # state input -> state output
    FINAL = "final"              # state input -> value output
    COMPLETE = "complete"        # raw input -> value output (single stage)


class AggExecMode(enum.Enum):
    HASH_AGG = "hash_agg"
    SORT_AGG = "sort_agg"


@dataclasses.dataclass
class AggExpr(Expr):
    fn: AggFunction
    args: List[Expr]
    # result type recorded by the converter (e.g. spark sum/avg decimal
    # promotion rules)
    return_type: Optional[T.DataType] = None
    udaf: Any = None  # python UDAF object when fn == UDAF

    def children(self):
        return list(self.args)


# --- type inference -----------------------------------------------------------

def infer_type(expr: Expr, schema: T.Schema) -> T.DataType:
    """Output type of an expression against an input schema."""
    if isinstance(expr, Column):
        return schema[expr.name].dtype
    if isinstance(expr, BoundReference):
        return schema[expr.index].dtype
    if isinstance(expr, Literal):
        return expr.dtype
    if isinstance(expr, (Cast, TryCast)):
        return expr.dtype
    if isinstance(expr, BinaryExpr):
        if expr.result_type is not None:
            return expr.result_type
        if expr.op in _COMPARISON_OPS or expr.op in _LOGICAL_OPS:
            return T.BOOL
        lt = infer_type(expr.left, schema)
        rt = infer_type(expr.right, schema)
        return common_type(lt, rt)
    if isinstance(expr, (IsNull, IsNotNull, Not, InList, Like, StringStartsWith,
                         StringEndsWith, StringContains, BloomFilterMightContain)):
        return T.BOOL
    if isinstance(expr, Case):
        for _, v in expr.branches:
            return infer_type(v, schema)
        return infer_type(expr.else_expr, schema)
    if isinstance(expr, ScalarFunction):
        if expr.return_type is not None:
            return expr.return_type
        raise NotImplementedError(
            f"scalar function {expr.name!r} without a return type: "
            "exprs/functions.py is not ported yet (ROADMAP.md Queue 1 item 4)")
    if isinstance(expr, RowNum):
        return T.I64
    if isinstance(expr, GetIndexedField):
        ct = infer_type(expr.child, schema)
        if isinstance(ct, T.ArrayType):
            return ct.element_type
        if isinstance(ct, T.StructType):
            assert isinstance(expr.ordinal, Literal)
            return ct.fields[expr.ordinal.value].dtype
        raise TypeError(f"get_indexed_field on {ct!r}")
    if isinstance(expr, GetMapValue):
        ct = infer_type(expr.child, schema)
        assert isinstance(ct, T.MapType)
        return ct.value_type
    if isinstance(expr, NamedStruct):
        if expr.dtype is not None:
            return expr.dtype
        return T.StructType(
            tuple(
                T.StructField(n, infer_type(e, schema))
                for n, e in zip(expr.names, expr.exprs)
            )
        )
    if isinstance(expr, PyUDF):
        return expr.return_type
    if isinstance(expr, ScalarSubquery):
        return expr.dtype
    if isinstance(expr, SortOrder):
        return infer_type(expr.child, schema)
    if isinstance(expr, AggExpr):
        if expr.return_type is not None:
            return expr.return_type
        arg_t = infer_type(expr.args[0], schema) if expr.args else T.NULL
        return agg_result_type(expr.fn, arg_t)
    raise NotImplementedError(f"infer_type: {type(expr).__name__}")


_NUMERIC_RANK = [T.I8, T.I16, T.I32, T.I64, T.F32, T.F64]


def common_type(lt: T.DataType, rt: T.DataType) -> T.DataType:
    if lt == rt:
        return lt
    if isinstance(lt, T.DecimalType) and isinstance(rt, T.DecimalType):
        # widest; exact promotion comes from the converter's result_type
        scale = max(lt.scale, rt.scale)
        intd = max(lt.precision - lt.scale, rt.precision - rt.scale)
        return T.DecimalType(min(intd + scale, T.DecimalType.MAX_PRECISION), scale)
    if lt in _NUMERIC_RANK and rt in _NUMERIC_RANK:
        return max(lt, rt, key=_NUMERIC_RANK.index)
    if isinstance(lt, T.NullType):
        return rt
    if isinstance(rt, T.NullType):
        return lt
    raise TypeError(f"no common type for {lt!r} and {rt!r}")


def agg_result_type(fn: AggFunction, arg_t: T.DataType) -> T.DataType:
    if fn == AggFunction.COUNT:
        return T.I64
    if fn == AggFunction.AVG:
        if isinstance(arg_t, T.DecimalType):
            # Spark: avg(decimal(p,s)) -> decimal(p+4, s+4) bounded
            return T.DecimalType(
                min(arg_t.precision + 4, 38), min(arg_t.scale + 4, 38)
            )
        return T.F64
    if fn == AggFunction.SUM:
        if isinstance(arg_t, T.DecimalType):
            # Spark: sum(decimal(p,s)) -> decimal(p+10, s) bounded
            return T.DecimalType(min(arg_t.precision + 10, 38), arg_t.scale)
        if arg_t in (T.I8, T.I16, T.I32, T.I64):
            return T.I64
        return T.F64
    if fn in (AggFunction.COLLECT_LIST, AggFunction.COLLECT_SET,
              AggFunction.BRICKHOUSE_COLLECT):
        return T.ArrayType(arg_t)
    if fn == AggFunction.BRICKHOUSE_COMBINE_UNIQUE:
        # array in, array out; a scalar argument still yields an array of
        # its deduped values (matches CombineUniqueAgg/agg_state_fields)
        return arg_t if isinstance(arg_t, T.ArrayType) else T.ArrayType(arg_t)
    return arg_t
